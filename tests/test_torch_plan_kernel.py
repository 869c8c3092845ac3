"""The planner's scenario-batched solve in kueue_tpu_torch (kernel B14's
plain versions: what plan_quota_tree, plan_phase1 and plan_phase2 are
held to on the card) against kueue_tpu's ``solve_scenarios_jit``,
exactly (int64, tolerance 0), on the same seeded numpy inputs
(kueue_tpu_torch.perf.cases.plan_batch) carried over by
``interop.plan_inputs``.

The batches carry depth-3 cohort forests, borrowing and lending limits
set and lifted per scenario, nominal and leaf-usage deltas, priorities
that differ per scenario (the entry order moves), nonzero scores in odd
scenarios, pad rows, no-fit heads, heads whose only candidate is a
preempt-mode one (reserving when no_reclaim), and dropped ranks. Every
field of ``per_head`` (over Wp, pads included) and the usage tree are
compared; a coverage test guards against a vacuous sweep.
"""

import numpy as np
import pytest
import torch

from kueue_tpu._jax import jnp
from kueue_tpu.ops import assign_kernel as jak
from kueue_tpu.ops.plan_kernel import solve_scenarios_jit
from kueue_tpu_torch import interop
from kueue_tpu_torch.ops import plan_kernel as pk
from kueue_tpu_torch.perf.cases import plan_batch

STACKS = ("nominal_s", "lending_s", "borrowing_s", "usage_s", "priority_s", "score_s")
CASES = [(seed, s) for seed in range(4) for s in (1, 5, 17)]


def _jax(b):
    heads = jak.HeadsBatch(**{f: jnp.asarray(b["heads"][f]) for f in interop.HEADS_DTYPES})
    per_head, usage = solve_scenarios_jit(
        jnp.asarray(b["parent"]), jnp.asarray(b["level_mask"]),
        *(jnp.asarray(b[k]) for k in STACKS),
        heads, jnp.asarray(b["paths"]), jnp.asarray(b["seg_id"]),
        n_segments=b["n_segments"], n_steps=b["n_steps"],
    )
    return np.asarray(per_head), np.asarray(usage)


def _steps(b):
    return dict(n_segments=b["n_segments"], n_steps=b["n_steps"])


@pytest.mark.parametrize("seed,s", CASES)
def test_solve_scenarios_matches_jax(seed, s):
    b = plan_batch(seed, s)
    want_ph, want_u = _jax(b)
    inp = interop.plan_inputs(b, "cpu")
    per_head, usage = pk.solve_scenarios(**inp, **_steps(b))
    w = b["heads"]["cq_row"].shape[0]
    n, fr = b["nominal_s"].shape[1:]
    assert per_head.dtype == torch.int64 and tuple(per_head.shape) == (s, 6, w)
    assert tuple(usage.shape) == (s, n, fr)
    for row in range(6):
        np.testing.assert_array_equal(per_head[:, row].numpy(), want_ph[:, row], err_msg=str(row))
    np.testing.assert_array_equal(usage.numpy(), want_u)
    # the plain entry is the same function
    ph2, u2 = pk.solve_scenarios_plain(**inp, **_steps(b))
    assert torch.equal(ph2, per_head) and torch.equal(u2, usage)


@pytest.mark.parametrize("seed", (1, 2))
def test_dropped_ranks_match_jax(seed):
    b = plan_batch(seed, 5, drop_steps=True)
    want_ph, want_u = _jax(b)
    per_head, usage = pk.solve_scenarios(**interop.plan_inputs(b, "cpu"), **_steps(b))
    np.testing.assert_array_equal(per_head.numpy(), want_ph)
    np.testing.assert_array_equal(usage.numpy(), want_u)


def test_packed_buffer_is_per_head_then_usage():
    b = plan_batch(0, 3)
    inp = interop.plan_inputs(b, "cpu")
    buf = pk.solve_scenarios_packed(**inp, **_steps(b))
    per_head, usage = pk.solve_scenarios(**inp, **_steps(b))
    w = b["heads"]["cq_row"].shape[0]
    n, fr = b["nominal_s"].shape[1:]
    assert buf.shape == (3 * 6 * w + 3 * n * fr,)
    ph, u = pk.unpack(buf.numpy(), 3, w, n, fr)
    np.testing.assert_array_equal(ph, per_head.numpy())
    np.testing.assert_array_equal(u, usage.numpy())


def test_each_scenario_equals_the_cycle_solver():
    """A scenario of the batch solves as the one-scenario cycle solve
    (B2/B3's plain versions) of its own quota state, priority and
    scores: no scenario's state leaks into another's."""
    from kueue_tpu_torch.ops import assign_kernel as tak
    from kueue_tpu_torch.ops.quota import QuotaTree

    b = plan_batch(3, 5)
    inp = interop.plan_inputs(b, "cpu")
    per_head, usage = pk.solve_scenarios(**inp, **_steps(b))
    for si in range(5):
        tree = QuotaTree(inp["parent"], inp["level_mask"], inp["nominal_s"][si],
                         inp["lending_s"][si], inp["borrowing_s"][si])
        heads = inp["heads"]._replace(priority=inp["priority_s"][si], score=inp["score_s"][si])
        r = tak.solve_cycle_segmented(tree, inp["usage_s"][si], heads, inp["paths"],
                                      b["seg_id"], **_steps(b))
        np.testing.assert_array_equal(per_head[si, 0].numpy(), r.chosen.numpy())
        np.testing.assert_array_equal(per_head[si, 1].numpy(), r.admitted.numpy())
        np.testing.assert_array_equal(per_head[si, 4].numpy(), r.order.numpy())
        np.testing.assert_array_equal(usage[si].numpy(), r.usage.numpy())


def test_the_sweep_covers_every_branch():
    pads = nofit = preempt_only = reserved = admitted = moved = 0
    for seed, s in CASES:
        b = plan_batch(seed, s)
        ph, _ = _jax(b)
        cq_row = b["heads"]["cq_row"]
        pads += int((cq_row < 0).sum())
        nofit += int(((ph[:, 0] < 0) & (ph[:, 5] < 0) & (cq_row >= 0)).sum())
        preempt_only += int(((ph[:, 0] < 0) & (ph[:, 5] >= 0)).sum())
        reserved += int(ph[:, 3].sum())
        admitted += int(ph[:, 1].sum())
        moved += int(sum(not np.array_equal(ph[i, 4], ph[0, 4]) for i in range(s)))
    assert pads and nofit and preempt_only and reserved and admitted and moved


def test_the_card_is_the_default():
    """Without a CPU tensor the wrappers launch their kernels: on a
    host without a card the inputs cannot even be placed there."""
    b = plan_batch(0, 2)
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py runs the kernels")
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.plan_inputs(b)
