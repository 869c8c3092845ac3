"""The cycle solver's plain versions in kueue_tpu_torch (what kernels
cycle_phase1, cycle_phase2 and scatter_rows are held to on the card)
against kueue_tpu's jitted entry points, exactly (int64, tolerance 0),
on the same seeded numpy inputs (kueue_tpu_torch.perf.cases.cycle_batch):

- B2: phase1_classify (chosen, per-candidate borrows, preempt_k);
- B3: the packed int64[5, W] of solve_cycle_segmented_packed_jit
  (chosen, admitted, borrows, reserved and the entry order) and the
  final usage tree of solve_cycle_segmented, including batches whose
  n_steps drops ranks; _bubble_usage on single paths;
- B6: the resident row scatter, with the repeated-row padding.

The batches carry pad rows, zero-quantity cells, NO_LIMIT limits,
all-zero and nonzero scores, no_reclaim reservations and depth-3
cohorts; a coverage test guards against a vacuous sweep.
"""

import numpy as np
import pytest
import torch

from kueue_tpu._jax import jnp
from kueue_tpu.core.solver import _scatter_rows as jax_scatter_rows
from kueue_tpu.ops import assign_kernel as jak
from kueue_tpu.ops import quota as jq
from kueue_tpu_torch import interop
from kueue_tpu_torch.ops import assign_kernel as tak
from kueue_tpu_torch.ops import quota as tq
from kueue_tpu_torch.ops.resident import scatter_rows
from kueue_tpu_torch.perf.cases import cycle_batch

HEAD_FIELDS = tuple(interop.HEADS_DTYPES)
SEEDS = range(10)


def _jax_inputs(b):
    tree = jq.QuotaTree(
        parent=jnp.asarray(b["parent"]),
        level_mask=jnp.asarray(b["level_mask"]),
        nominal=jnp.asarray(b["nominal"]),
        lending_limit=jnp.asarray(b["lending_limit"]),
        borrowing_limit=jnp.asarray(b["borrowing_limit"]),
    )
    heads = jak.HeadsBatch(**{f: jnp.asarray(b[f]) for f in HEAD_FIELDS})
    return tree, jnp.asarray(b["local_usage"]), heads, jnp.asarray(b["paths"])


def _port_inputs(b):
    tree = interop.quota_tree(b, "cpu")
    heads = interop.heads_batch(b, "cpu")
    local = torch.as_tensor(b["local_usage"].copy())
    return tree, local, heads, torch.as_tensor(b["paths"])


def _batch(seed, drop=False, **kw):
    return cycle_batch(seed, drop_steps=drop, **kw)


@pytest.mark.parametrize("seed", SEEDS)
def test_phase1_matches_jax(seed):
    b = _batch(seed)
    jtree, jlocal, jheads, _ = _jax_inputs(b)
    jsub, jg = jq.subtree_quota(jtree)
    want = jak.phase1_classify(jtree, jsub, jg, jlocal, jheads)
    tree, local, heads, _ = _port_inputs(b)
    sub, g = tq.subtree_quota(tree)
    got = tak.phase1_classify(tree, sub, g, local, heads)
    assert [t.dtype for t in got] == [torch.int32, torch.bool, torch.int32]
    for t, j in zip(got, want):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("seed,drop", [(s, False) for s in SEEDS] + [(s, True) for s in (1, 4, 7)])
def test_packed_cycle_matches_jax(seed, drop):
    b = _batch(seed, drop)
    args = dict(n_segments=b["n_segments"], n_steps=b["n_steps"])
    j = _jax_inputs(b)
    want = np.asarray(jak.solve_cycle_segmented_packed_jit(*j, jnp.asarray(b["seg_id"]), **args))
    want_r = jak.solve_cycle_segmented_jit(*j, jnp.asarray(b["seg_id"]), **args)
    t = _port_inputs(b)
    local_before = t[1].clone()
    got = tak.solve_cycle_segmented_packed(*t, b["seg_id"], **args)
    assert got.dtype == torch.int64 and tuple(got.shape) == (5, b["cq_row"].shape[0])
    np.testing.assert_array_equal(got.numpy(), want)
    got_r = tak.solve_cycle_segmented(*t, b["seg_id"], **args)
    np.testing.assert_array_equal(got_r.usage.numpy(), np.asarray(want_r.usage))
    # phase 2 never writes the caller's leaf usage
    assert torch.equal(t[1], local_before)


@pytest.mark.parametrize("seed", range(4))
def test_bubble_usage_matches_jax(seed):
    b = _batch(seed)
    jtree, _, _, jpaths = _jax_inputs(b)
    _, jg = jq.subtree_quota(jtree)
    tree, local, _, paths = _port_inputs(b)
    _, g = tq.subtree_quota(tree)
    usage_p = tq.usage_tree(tree, g, local)
    usage_j = jnp.asarray(usage_p.numpy())
    rng = np.random.default_rng(seed)
    max_depth = b["max_depth"]
    for i in range(b["cq_row"].shape[0]):
        cq = max(int(b["cq_row"][i]), 0)
        cells = b["cells"][i, 0]
        qty = rng.integers(-5, 30, size=cells.shape).astype(np.int64)
        cell_valid = (cells >= 0) & (qty > 0)
        usage_j = jak._bubble_usage(
            jpaths[cq], jnp.asarray(cells), jnp.asarray(cell_valid), jnp.asarray(qty),
            usage_j, jg, max_depth, jnp.asarray(True),
        )
        tak._bubble_usage(
            paths[cq][None], torch.as_tensor(cells)[None],
            torch.as_tensor(np.where(cell_valid, qty, 0))[None], usage_p, g, max_depth,
        )
        np.testing.assert_array_equal(usage_p.numpy(), np.asarray(usage_j))


@pytest.mark.parametrize("seed", range(3))
def test_scatter_rows_matches_jax(seed):
    rng = np.random.default_rng(seed)
    usage = rng.integers(0, 1 << 40, size=(30, 7)).astype(np.int64)
    changed = np.sort(rng.choice(30, size=5, replace=False))
    idx = np.concatenate([changed, np.full(3, changed[0])]).astype(np.int32)
    rows = rng.integers(0, 1 << 40, size=(30, 7)).astype(np.int64)[idx]
    rows[5:] = rows[0]  # the padding repeats the first changed row
    want = np.asarray(jax_scatter_rows(jnp.asarray(usage), jnp.asarray(idx), jnp.asarray(rows)))
    got = torch.as_tensor(usage.copy())
    scatter_rows(got, torch.as_tensor(idx), torch.as_tensor(rows))
    np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_rows_index_rules_match_jax():
    """A negative index counts from the end; one still out of range is
    dropped, as in the JAX scatter."""
    usage = np.arange(12, dtype=np.int64).reshape(6, 2)
    idx = np.array([-1, 7, -9, 2], dtype=np.int32)
    rows = -np.arange(8, dtype=np.int64).reshape(4, 2) - 1
    want = np.asarray(jax_scatter_rows(jnp.asarray(usage), jnp.asarray(idx), jnp.asarray(rows)))
    got = torch.as_tensor(usage.copy())
    scatter_rows(got, torch.as_tensor(idx), torch.as_tensor(rows))
    np.testing.assert_array_equal(got.numpy(), want)


def test_batches_cover_the_cases():
    """Guard against a vacuous sweep: across the seeds the batches hold
    pads, zero cells, NO_LIMIT, depth 3, both score kinds, admissions,
    phase-1 rejections re-checked away, reservations and dropped ranks."""
    seen = set()
    for seed in SEEDS:
        for drop in (False, True):
            b = _batch(seed, drop)
            t = _port_inputs(b)
            r = tak.solve_cycle_segmented(
                *t, b["seg_id"], n_segments=b["n_segments"], n_steps=b["n_steps"]
            )
            chosen = r.chosen.numpy()
            admitted = r.admitted.numpy()
            live = (b["cq_row"] >= 0) & (chosen >= 0)
            if (b["cq_row"] < 0).any():
                seen.add("pads")
            if ((b["cells"] >= 0) & (b["qty"] == 0)).any():
                seen.add("zero cells")
            if (b["borrowing_limit"] >= tq.NO_LIMIT).any():
                seen.add("no limit")
            if b["max_depth"] == 3:
                seen.add("depth 3")
            seen.add("scores" if b["score"].any() else "zero scores")
            if admitted.any():
                seen.add("admitted")
            if (live & ~admitted).any():
                seen.add("fit then rejected")
            if r.reserved.numpy().any():
                seen.add("reserved")
            if r.borrows.numpy().any():
                seen.add("borrows")
            if drop and (live & ~admitted).sum() > (live & ~admitted & (b["seg_id"] < 0)).sum():
                seen.add("dropped")
    assert seen >= {
        "pads", "zero cells", "no limit", "depth 3", "scores", "zero scores",
        "admitted", "fit then rejected", "reserved", "borrows", "dropped",
    }
