"""The plain versions the two redesigned kernels are held to on the card
(drain_nominate, B4's nomination; cycle_phase2, B3) against the JAX
package at the shapes that reach the new designs' edges, exactly
(int64, tolerance 0), on the same seeded numpy inputs:

- one nomination (``drain_nominate_plain`` against ``_nominate_multi``)
  on random batches (``perf.cases.nominate_batch``) with K*C above one
  warp of pairs (folded lanes), P = 4 podsets repeating cells, G up to 8
  groups with tied flavor indices and scores, retired queues and
  queues past their end;
- the packed cycle (``solve_cycle_segmented_packed``) on batches with one
  segment beyond cycle_phase2's shared-memory rows beside small ones,
  W not a multiple of 32, pads, dropped ranks, candidates repeating
  a cell and paths of 7 levels;
- cycle_phase2's shared-memory reckoning (``segment_bytes``,
  ``phase2_layout``) at the headline shape and its edges.
"""

import numpy as np
import pytest
import torch

from kueue_tpu._jax import jnp
from kueue_tpu.ops import assign_kernel as jak
from kueue_tpu.ops import drain_kernel as jdk
from kueue_tpu.ops import quota as jq
from kueue_tpu_torch import interop
from kueue_tpu_torch.ops import assign_kernel as tak
from kueue_tpu_torch.ops import drain_kernel as tdk
from kueue_tpu_torch.ops import quota as tq
from kueue_tpu_torch.perf.cases import cycle_batch, nominate_batch, nominate_inputs

from tests.test_torch_quota import _jax_tree

# (k, c, p, g): K*C = 64, 96, 128 pairs (two to four folds); P = 4; G = 8
NOMINATE_SHAPES = {
    "fold-2": dict(k=16, c=4, p=1, g=2),
    "fold-3": dict(k=12, c=8, p=2, g=3),
    "fold-4": dict(k=16, c=8, p=1, g=4, fr=10),
    "podsets-4": dict(k=4, c=3, p=4, g=2, fr=4),
    "groups-8": dict(k=8, c=8, p=2, g=8, fr=9),
    "headline": dict(k=8, c=3, p=1, g=2, scored=False),
}


def _port_nomination(b):
    """The port's plain nomination on the batch, its availability from
    the usage tree as the drain's quota_tree pass builds it."""
    tree = interop.quota_tree(b, "cpu")
    sub, g = tq.subtree_quota(tree)
    local = torch.as_tensor(b["local"])
    avail = tq.available_all(tree, sub, g, tq.usage_tree(tree, g, local))
    ctx, state, buf = nominate_inputs(b, "cpu", avail=avail)
    tdk.drain_nominate_plain(ctx, state, buf)
    return buf


def _jax_nomination(b):
    qn = b["queues_np"]
    tree = _jax_tree(b)
    sub, g = jq.subtree_quota(tree)
    pot = jq.potential_available_all(tree, sub, g)
    local = jnp.asarray(b["local"])
    usage0 = jq.usage_tree(tree, g, local)
    queues = jdk.DrainQueues(**{k: jnp.asarray(v) for k, v in qn.items() if v is not None})
    q, l = qn["qlen"].shape[0], qn["cells"].shape[1]
    cursor = jnp.asarray(b["cursor"])
    active = (cursor < jnp.asarray(qn["qlen"])) & jnp.asarray(b["alive"])
    return jdk._nominate_multi(
        tree, sub, g, local, usage0, queues, jnp.arange(q), jnp.minimum(cursor, l - 1),
        active, jnp.asarray(b["g_start"]), pot,
    )


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("shape", sorted(NOMINATE_SHAPES))
def test_nomination_matches_jax_at_the_edges(shape, seed):
    b = nominate_batch(seed, **NOMINATE_SHAPES[shape])
    buf = _port_nomination(b)
    want = _jax_nomination(b)
    names = ("is_fit", "is_pre", "pend", "head_borrow", "rep_k", "walk_next", "cells_eff",
             "qty_eff")
    for name, j in zip(names, want):
        np.testing.assert_array_equal(getattr(buf, name).numpy(), np.asarray(j), err_msg=name)


def test_nominate_batches_cover_the_edges():
    """Guard against a vacuous sweep: the batches nominate fits and
    preempt-mode heads, resume group walks, hold retired and exhausted
    queues, fold pairs onto the lanes and tie scores."""
    seen = set()
    for shape, kw in NOMINATE_SHAPES.items():
        for seed in range(3):
            b = nominate_batch(seed, **kw)
            qn = b["queues_np"]
            buf = _port_nomination(b)
            if buf.is_fit.any():
                seen.add("fit")
            if buf.is_pre.any():
                seen.add("preempt")
            if (buf.walk_next > 0).any():
                seen.add("resumed walk")
            if (~torch.as_tensor(b["alive"])).any():
                seen.add("retired")
            if (b["cursor"] >= qn["qlen"]).any():
                seen.add("exhausted")
            if qn["cells"].shape[3] * qn["cells"].shape[4] > 32:
                seen.add("folded")
            if qn["score"] is not None and (qn["score"] == 1).any():
                seen.add("scores")
    assert seen >= {"fit", "preempt", "resumed walk", "retired", "exhausted", "folded",
                    "scores"}


WIDE_CASES = [(1, 400, False), (6, 477, True), (1, 477, False)]


def _wide_batch(seed, w, drop=False):
    """cycle_batch with one root cohort holding most ClusterQueues (depth
    1, few cohorts), so one segment outgrows the shared rows while the
    parentless ClusterQueues make small segments."""
    return cycle_batch(seed, w=w, k=4, c=8, depth=1, n_cq=w, fr=17, drop_steps=drop)


def _segment_walks(b):
    """Walked heads a segment: members with a ClusterQueue and an
    effective candidate after phase 1, at most n_steps."""
    tree = interop.quota_tree(b, "cpu")
    sub, g = tq.subtree_quota(tree)
    chosen, _, pk = tak.phase1_classify(tree, sub, g, torch.as_tensor(b["local_usage"]),
                                        interop.heads_batch(b, "cpu"))
    walked = (b["cq_row"] >= 0) & ((chosen >= 0) | (pk >= 0)).numpy()
    counts = np.bincount(b["seg_id"][walked], minlength=b["n_segments"])
    return np.minimum(counts, b["n_steps"])


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("seed,w,drop", WIDE_CASES)
def test_packed_cycle_matches_jax_beyond_shared_rows(seed, w, drop, dup):
    """With ``dup`` every third head's candidates repeat a cell."""
    b = _wide_batch(seed, w, drop)
    if dup:
        b["cells"][::3, :, 1] = np.where(b["cells"][::3, :, 1] >= 0, b["cells"][::3, :, 0], -1)
    members = np.bincount(b["seg_id"][b["seg_id"] >= 0]).max()
    lay = tak.phase2_layout(w, int(members), 8, 17, b["max_depth"])
    need = [tak.segment_bytes(int(n), 17, b["max_depth"]) for n in _segment_walks(b)]
    assert max(need) > lay["rows_bytes"] >= min(need)  # both of the kernel's paths
    args = dict(n_segments=b["n_segments"], n_steps=b["n_steps"])
    tree = jq.QuotaTree(**{f: jnp.asarray(b[f]) for f in (
        "parent", "level_mask", "nominal", "lending_limit", "borrowing_limit")})
    heads = jak.HeadsBatch(**{f: jnp.asarray(b[f]) for f in interop.HEADS_DTYPES})
    want = np.asarray(jak.solve_cycle_segmented_packed_jit(
        tree, jnp.asarray(b["local_usage"]), heads, jnp.asarray(b["paths"]),
        jnp.asarray(b["seg_id"]), **args))
    got = tak.solve_cycle_segmented_packed(
        interop.quota_tree(b, "cpu"), torch.as_tensor(b["local_usage"].copy()),
        interop.heads_batch(b, "cpu"), torch.as_tensor(b["paths"]), b["seg_id"], **args)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[1].any()  # something was admitted


@pytest.mark.parametrize("seed,w,drop", [(0, 200, False), (2, 40, True)])
def test_packed_cycle_matches_jax_on_deep_forests(seed, w, drop):
    """Paths of 7 levels, beyond the kernel's unrolled levels."""
    b = cycle_batch(seed, w=w, k=4, c=8, depth=6, n_cq=w // 3, fr=17, drop_steps=drop)
    assert b["max_depth"] == 6
    args = dict(n_segments=b["n_segments"], n_steps=b["n_steps"])
    tree = jq.QuotaTree(**{f: jnp.asarray(b[f]) for f in (
        "parent", "level_mask", "nominal", "lending_limit", "borrowing_limit")})
    heads = jak.HeadsBatch(**{f: jnp.asarray(b[f]) for f in interop.HEADS_DTYPES})
    want = np.asarray(jak.solve_cycle_segmented_packed_jit(
        tree, jnp.asarray(b["local_usage"]), heads, jnp.asarray(b["paths"]),
        jnp.asarray(b["seg_id"]), **args))
    got = tak.solve_cycle_segmented_packed(
        interop.quota_tree(b, "cpu"), torch.as_tensor(b["local_usage"].copy()),
        interop.heads_batch(b, "cpu"), torch.as_tensor(b["paths"]), b["seg_id"], **args)
    np.testing.assert_array_equal(got.numpy(), want)


def test_segment_bytes_counts_path_entries():
    # per (head, level): a node id, a slot, four int64 rows of FR cells
    assert tak.segment_bytes(1, 1, 0) == 8 + 32
    assert tak.segment_bytes(20, 17, 1) == 20 * 2 * (8 + 32 * 17)
    assert tak.segment_bytes(0, 17, 3) == 0


def test_phase2_layout_at_the_headline_and_its_edges():
    # the headline cycle: W=1024, ~20 heads a root cohort, C=16, FR=17, D=1
    lay = tak.phase2_layout(1024, 24, 16, 17, 1)
    assert lay["keys"] and lay["win"] == tak.PHASE2_WINDOW
    assert lay["rows_bytes"] == tak.segment_bytes(24, 17, 1)  # every segment on shared rows
    assert lay["total"] <= tak.PHASE2_SHARED_BYTES
    # a segment of all 1024 heads keeps its rows in device memory
    wide = tak.phase2_layout(1024, 1024, 16, 17, 1)
    assert wide["rows_bytes"] < tak.segment_bytes(1024, 17, 1)
    assert wide["total"] == tak.PHASE2_SHARED_BYTES
    # too wide for the staged keys: they stay in device memory
    assert not tak.phase2_layout(12000, 8, 16, 17, 1)["keys"]
    # windows shrink before the shape is refused
    assert tak.phase2_layout(200000, 64, 32, 17, 7)["win"] < tak.PHASE2_WINDOW
    assert tak.phase2_layout(232448, 8, 16, 17, 1) is None


def test_trap_anchors_are_in_the_kernel_sources(tmp_path):
    """perf/trap.py plants its trap after a fixed line of each kernel it
    traps (drain_nominate, global_rescore): the line must be there."""
    from kueue_tpu_torch.perf import trap

    for kernel in trap.TRAP_AT:
        body = (trap.trapped_csrc(tmp_path / kernel, kernel) / f"{kernel}.cu").read_text()
        assert "__trap()" in body
