"""The plain drain of kueue_tpu_torch (the plain torch versions kernels
1-4 are held to on the card) against kueue_tpu's solve_drain, exactly
(int64, tolerance 0), on the same numpy inputs carried across by
kueue_tpu_torch.interop:

- the whole packed result vector (solve_drain_packed_jit) on plans of
  tests.test_solver_path.random_spec seeds, multi-podset seeds,
  mixed-cluster seeds with nonzero candidate scores and stuck queues;
- one cycle (_plain_cycle) from mid-drain states, which covers what
  kernels 2-4 replace: nomination, the entry-order phase 2 and queue
  motion;
- the pieces: cell_masks, _group_walk, _avail_along_path and
  segmented_rank on seeded random inputs.
"""

import numpy as np
import pytest
import torch

from kueue_tpu._jax import jax, jnp
from kueue_tpu.core.drain import plan_drain as jax_plan_drain
from kueue_tpu.core.encode import encode_snapshot
from kueue_tpu.core.snapshot import take_snapshot
from kueue_tpu.ops import assign_kernel as jak
from kueue_tpu.ops import drain_kernel as jdk
from kueue_tpu.ops.quota import potential_available_all, subtree_quota
from kueue_tpu_torch import interop
from kueue_tpu_torch.ops import assign_kernel as tak
from kueue_tpu_torch.ops import drain_kernel as tdk

from tests.test_drain import multi_podset_spec
from tests.test_solver_path import build_env, random_spec
from tests.test_torch_quota import _jax_tree, random_forest
from tests.test_torch_drain import jax_env_of, mixed_spec


def _plan_inputs(spec, score_seed=None):
    """(enc dict, queues_np, plan) of the JAX package's plan for a spec."""
    _, mgr, cache, _ = build_env(jax_env_of(spec), use_solver=False)
    pending = [
        (wl, cq) for cq, pq in mgr.cluster_queues.items() for wl in pq.snapshot_sorted()
    ]
    snap = take_snapshot(cache)
    plan = jax_plan_drain(snap, pending, cache.flavors)
    if score_seed is not None:
        rng = np.random.default_rng(score_seed)
        plan.queues_np["score"] = rng.integers(-2, 3, size=plan.queues_np["score"].shape)
    e = encode_snapshot(snap)
    enc = {
        "parent": e.parent,
        "level_mask": e.level_mask,
        "nominal": e.nominal,
        "lending_limit": e.lending_limit,
        "borrowing_limit": e.borrowing_limit,
        "local_usage": e.local_usage,
        "max_depth": e.max_depth,
    }
    return enc, plan.queues_np, plan


def _jax_inputs(enc, queues_np):
    tree = _jax_tree(enc)
    queues = jdk.DrainQueues(**{k: jnp.asarray(v) for k, v in queues_np.items()})
    paths = jnp.asarray(jak.build_paths(enc["parent"], enc["max_depth"]))
    return tree, jnp.asarray(enc["local_usage"]), queues, paths


CASES = (
    [("random", s, None) for s in (0, 3, 5, 8)]
    + [("multi_podset", s, None) for s in (0, 2, 4)]
    + [("mixed", s, s) for s in (4, 7, 8)]
)


def _spec(kind, seed):
    if kind == "random":
        return random_spec(seed, workloads_per_cq=8)
    if kind == "multi_podset":
        return multi_podset_spec(seed)
    return mixed_spec(seed, workloads_per_cq=4)


@pytest.mark.parametrize("kind,seed,score_seed", CASES)
def test_packed_drain_matches_jax(kind, seed, score_seed):
    enc, queues_np, plan = _plan_inputs(_spec(kind, seed), score_seed)
    j_flat = np.asarray(
        jdk.solve_drain_packed_jit(
            *_jax_inputs(enc, queues_np),
            n_segments=plan.n_segments,
            n_steps=plan.n_steps,
            max_cycles=plan.max_cycles,
        )
    )
    tree, queues, local, paths = interop.drain_inputs(enc, queues_np, "cpu")
    t_flat = tdk._solve_drain_packed(
        tree, local, queues, paths, plan.n_segments, plan.n_steps, plan.max_cycles
    )
    assert t_flat.dtype == torch.int64
    np.testing.assert_array_equal(t_flat.numpy(), j_flat)
    assert j_flat[-1] > 0  # cycles


def test_cases_cover_scores_podsets_and_stuck_queues():
    """Guard against a vacuous sweep: the mixed cases carry P=3,
    nonzero scores, depth-3 paths and stuck queues."""
    enc, queues_np, plan = _plan_inputs(mixed_spec(8, workloads_per_cq=4), 8)
    assert queues_np["cells"].shape[2] == 3
    assert np.any(queues_np["score"] != 0)
    assert enc["max_depth"] == 3
    tree, queues, local, paths = interop.drain_inputs(enc, queues_np, "cpu")
    r = tdk.solve_drain(
        tree, local, queues, paths, plan.n_segments, plan.n_steps, plan.max_cycles
    )
    assert bool(r.stuck.any())
    assert bool((r.admitted_k >= 0).any())


def test_check_interval_does_not_change_the_result(monkeypatch):
    """Cycles enqueued past the end are no-ops: checking the done flag
    every 1 or every 7 cycles gives the same drain."""
    enc, queues_np, plan = _plan_inputs(random_spec(2, workloads_per_cq=8))
    tree, queues, local, paths = interop.drain_inputs(enc, queues_np, "cpu")
    args = (tree, local, queues, paths, plan.n_segments, plan.n_steps, plan.max_cycles)
    a = tdk.solve_drain(*args)
    monkeypatch.setattr(tdk, "CHECK_EVERY_CPU", 7)
    b = tdk.solve_drain(*args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


_plain_cycle_jit = jax.jit(jdk._plain_cycle, static_argnums=(6, 7))


def _jax_state(state):
    """The port's loop state as the JAX 9-tuple. Copies: a JAX array
    made from a numpy view may alias the torch buffer on the CPU, and
    the port updates that buffer in place."""
    def arr(t):
        return jnp.array(t.numpy().copy())

    return (
        arr(state.local),
        arr(state.cursor),
        arr(state.g_start),
        arr(state.retries),
        arr(state.stuck),
        jnp.int32(int(state.no_prog.item())),
        arr(state.adm_k),
        arr(state.adm_cycle),
        jnp.int32(int(state.cycle.item())),
    )


@pytest.mark.parametrize(
    "kind,seed,score_seed,warm",
    [("random", 1, None, 0), ("random", 4, None, 3), ("multi_podset", 1, None, 2),
     ("mixed", 5, 5, 4), ("mixed", 7, 7, 9)],
)
def test_one_cycle_matches_jax_plain_cycle(kind, seed, score_seed, warm):
    """From a mid-drain state, one cycle of the port (usage tree,
    availability, nomination, phase 2, queue motion) equals one
    _plain_cycle of the JAX package."""
    enc, queues_np, plan = _plan_inputs(_spec(kind, seed), score_seed)
    tree, queues, local, paths = interop.drain_inputs(enc, queues_np, "cpu")
    ctx = tdk.DrainContext.build(
        tree, queues, paths, plan.n_segments, plan.n_steps, plan.max_cycles
    )
    state = tdk.DrainState.initial(local, queues, plan.max_cycles)
    buf = tdk.CycleBuffers.empty(local, queues)
    for _ in range(warm):
        tdk.drain_cycle(ctx, state, buf)
    assert not bool(state.done.item())

    j_tree, _, j_queues, j_paths = _jax_inputs(enc, queues_np)
    sub, g = subtree_quota(j_tree)
    pot = potential_available_all(j_tree, sub, g)
    j_next = _plain_cycle_jit(
        j_tree, sub, g, pot, j_queues, j_paths, plan.n_segments, plan.n_steps,
        _jax_state(state),
    )
    jax.block_until_ready(j_next)
    tdk.drain_cycle(ctx, state, buf)
    names = ["local", "cursor", "g_start", "retries", "stuck", "no_prog", "adm_k",
             "adm_cycle", "cycle"]
    for name, j in zip(names, j_next):
        t = getattr(state, name)
        np.testing.assert_array_equal(
            t.numpy().reshape(np.shape(j)), np.asarray(j), err_msg=name
        )


def _random_cells(rng, w, k, c, n_fr):
    cells = rng.integers(-1, n_fr, size=(w, k, c)).astype(np.int32)
    qty = rng.integers(0, 30, size=(w, k, c)).astype(np.int64)
    return cells, qty


@pytest.mark.parametrize("seed", range(4))
def test_cell_masks_match(seed):
    enc = random_forest(seed, 1 + seed % 3)
    rng = np.random.default_rng(seed)
    n, fr = enc["nominal"].shape
    w, k, c = 9, 5, 3
    cells, qty = _random_cells(rng, w, k, c, fr)
    cq_row = rng.integers(-1, 12, size=w).astype(np.int32)
    jt = _jax_tree(enc)
    js, jg = subtree_quota(jt)
    jm = jak.cell_masks(
        jt, js, jg, jnp.asarray(enc["local_usage"]), jnp.asarray(cq_row),
        jnp.asarray(cells), jnp.asarray(qty),
    )
    tt = interop.quota_tree(enc, "cpu")
    from kueue_tpu_torch.ops.quota import subtree_quota as t_subtree

    ts, tg = t_subtree(tt)
    tm = tak.cell_masks(
        tt, ts, tg, torch.as_tensor(enc["local_usage"]), torch.as_tensor(cq_row),
        torch.as_tensor(cells), torch.as_tensor(qty),
    )
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("seed", range(4))
def test_avail_along_path_matches(seed):
    enc = random_forest(seed + 40, 3)
    rng = np.random.default_rng(seed)
    n, fr = enc["nominal"].shape
    d = enc["max_depth"]
    jt = _jax_tree(enc)
    js, jg = subtree_quota(jt)
    usage = enc["local_usage"] + rng.integers(0, 20, size=(n, fr))
    paths = jak.build_paths(enc["parent"], d)
    rows = rng.integers(0, n, size=7)
    cells = rng.integers(0, fr, size=(7, 3)).astype(np.int32)
    j = jax.vmap(jak._avail_along_path, in_axes=(0, 0, None, None, None, None, None))(
        jnp.asarray(paths[rows]), jnp.asarray(cells), jnp.asarray(usage), js, jg,
        jt.borrowing_limit, d,
    )
    t = tak._avail_along_path(
        torch.as_tensor(paths[rows]), torch.as_tensor(cells), torch.as_tensor(usage),
        torch.as_tensor(np.array(js)), torch.as_tensor(np.array(jg)),
        torch.as_tensor(enc["borrowing_limit"]), d,
    )
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("seed", range(4))
def test_segmented_rank_matches(seed):
    rng = np.random.default_rng(seed)
    w = 40
    seg = rng.integers(0, 6, size=w).astype(np.int32)
    valid = rng.random(w) < 0.6
    j = jak.segmented_rank(jnp.asarray(seg), jnp.asarray(valid))
    t = tak.segmented_rank(torch.as_tensor(seg), torch.as_tensor(valid))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("seed", range(4))
def test_group_walk_matches(seed):
    rng = np.random.default_rng(seed)
    q, k, c, g = 16, 6, 4, 2
    gid = rng.integers(0, 4, size=(q, k, g)).astype(np.int32)
    gl = rng.random((q, k, g)) < 0.3
    cg = rng.integers(-1, g, size=(q, k, c)).astype(np.int8)
    gmask = cg[..., None] == np.arange(g)
    valid = rng.random((q, k)) < 0.8
    masks = [rng.random((q, k, c)) < p for p in (0.5, 0.7, 0.5, 0.3)]
    ffb = rng.random(q) < 0.6
    ffp = rng.random(q) < 0.5
    score = rng.integers(-2, 3, size=(q, k)).astype(np.int64)
    for sc in (None, score):
        j = jdk._group_walk(
            jnp.asarray(gid), jnp.asarray(gl), jnp.asarray(gmask), jnp.asarray(valid),
            *[jnp.asarray(m) for m in masks], jnp.asarray(ffb), jnp.asarray(ffp),
            score=None if sc is None else jnp.asarray(sc),
        )
        t = tdk._group_walk(
            torch.as_tensor(gid), torch.as_tensor(gl), torch.as_tensor(gmask),
            torch.as_tensor(valid), *[torch.as_tensor(m) for m in masks],
            torch.as_tensor(ffb), torch.as_tensor(ffp),
            score=None if sc is None else torch.as_tensor(sc),
        )
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_lockstep_harness_catches_a_difference():
    """A plain step that disagrees with its kernel step is reported by
    name and cycle, with its difference recorded, although the harness
    reads the differences once a cycle."""
    from kueue_tpu_torch.ops import drain_kernel as dk
    from kueue_tpu_torch.perf import lockstep as ls

    enc, queues_np, plan = _plan_inputs(mixed_spec(8, workloads_per_cq=4), 8)
    tree, queues, local, paths = interop.drain_inputs(enc, queues_np, "cpu")
    ctx = dk.DrainContext.build(tree, queues, paths, plan.n_segments, plan.n_steps,
                                plan.max_cycles)
    state = dk.DrainState.initial(local, queues, plan.max_cycles)
    buf = dk.CycleBuffers.empty(local, queues)

    def off_by_one(ctx, s, b):
        dk.drain_phase2_plain(ctx, s, b)
        s.cycle.add_(1)

    at = [step[0] for step in ls.STEPS].index("drain_phase2")
    name, kern, _ = ls.STEPS[at]
    steps = ls.STEPS[:at] + ((name, kern, off_by_one),) + ls.STEPS[at + 1:]
    errs = {}
    with pytest.raises(ls.LockstepMismatch, match="drain_phase2 differs from its plain "
                                                  "version by 1 at cycle 0"):
        ls.run_lockstep(ctx, state, buf, steps, plan.max_cycles, errs)
    assert errs == {"quota_tree": 0, "drain_nominate": 0, "drain_phase2": 1}


def test_lockstep_harness_runs_on_cpu():
    """The harness chip_smoke.py holds the kernels with: on the CPU both
    sides are the plain versions, so it must report zero everywhere."""
    from kueue_tpu_torch.perf.lockstep import DRAIN_KERNELS, lockstep

    enc, queues_np, plan = _plan_inputs(mixed_spec(8, workloads_per_cq=4), 8)
    tree, queues, local, paths = interop.drain_inputs(enc, queues_np, "cpu")
    errs = {}
    _, state, cycles = lockstep(
        tree, local, queues, paths, plan.n_segments, plan.n_steps, plan.max_cycles, errs
    )
    assert cycles == int(state.cycle.item()) > 0
    assert errs == {name: 0 for name in DRAIN_KERNELS}
