"""The plain versions the two kernels redesigned for the card are held to
(quota_tree, B1: one launch a call site; drain_phase2, B4's phase 2)
against the JAX package, exactly (int64, tolerance 0), on seeded numpy
inputs at the shapes that reach the designs' edges:

- ``usage_and_available`` (the drain cycle's call site) and
  ``quota_all`` (the interactive cycle's) against kueue_tpu.ops.quota's
  four functions, on random forests of depth 1-7 with NO_LIMIT lending
  and borrowing limits, one root subtree beyond the kernel's shared rows
  beside small ones, and FR not a multiple of 32;
- the forest's packing (``build_forest``): whole root subtrees a bin,
  levels as runs, children as runs of the next level; the recurrences
  walked over it bin by bin as the kernel walks them (children
  gathered, no scatter) equal the plain versions;
- one plain drain cycle (``drain_cycle``: the fused quota pass, the
  nomination, phase 2, the queue motion) against the JAX
  ``_plain_cycle`` on ``perf.cases.phase2_batch``: a segment beyond
  phase 2's shared rows, dropped ranks, preempt-mode reserves with
  reclaimWithinCohort Never, podsets repeating cells, priority and
  timestamp ties, paths of 7 levels;
- phase 2's shared-memory reckoning (``phase2_layout``) at the headline
  and its edges.
"""

import numpy as np
import pytest
import torch

from kueue_tpu._jax import jnp
from kueue_tpu.ops import drain_kernel as jdk
from kueue_tpu.ops import quota as jq
from kueue_tpu_torch import interop
from kueue_tpu_torch.ops import drain_kernel as tdk
from kueue_tpu_torch.ops import quota as tq
from kueue_tpu_torch.perf import cases

TREE_FIELDS = ("parent", "level_mask", "nominal", "lending_limit", "borrowing_limit")
ALL = tq.SUBTREE | tq.USAGE | tq.AVAIL | tq.POTENTIAL

# (seed, depth): a 300-node root subtree beside 40 small ones, FR = 37
FORESTS = [(seed, depth) for depth in range(1, 8) for seed in (0, 1)]


def _jax_quota(f):
    tree = jq.QuotaTree(**{k: jnp.asarray(f[k]) for k in TREE_FIELDS})
    sub, g = jq.subtree_quota(tree)
    usage = jq.usage_tree(tree, g, jnp.asarray(f["local_usage"]))
    avail = jq.available_all(tree, sub, g, usage)
    pot = jq.potential_available_all(tree, sub, g)
    return tuple(np.asarray(x) for x in (sub, g, usage, avail, pot))


@pytest.mark.parametrize("seed,depth", FORESTS)
def test_usage_and_available_matches_jax(seed, depth):
    f = cases.quota_forest(seed, depth=depth)
    _, _, want_u, want_a, _ = _jax_quota(f)
    tree = interop.quota_tree(f, "cpu")
    sub, g = tq.subtree_quota(tree)
    out_u, out_a = torch.full_like(sub, -7), torch.full_like(sub, -7)
    u, a = tq.usage_and_available(tree, sub, g, torch.as_tensor(f["local_usage"]), out_u, out_a)
    assert u is out_u and a is out_a
    np.testing.assert_array_equal(u.numpy(), want_u)
    np.testing.assert_array_equal(a.numpy(), want_a)
    # and without buffers
    u2, a2 = tq.usage_and_available(tree, sub, g, torch.as_tensor(f["local_usage"]))
    assert torch.equal(u2, u) and torch.equal(a2, a)


@pytest.mark.parametrize("seed,depth", FORESTS)
def test_quota_all_matches_jax(seed, depth):
    f = cases.quota_forest(seed, depth=depth)
    want = _jax_quota(f)
    tree = interop.quota_tree(f, "cpu")
    out_u = torch.zeros_like(tree.nominal)
    got = tq.quota_all(tree, torch.as_tensor(f["local_usage"]), out_usage=out_u)
    assert got[2] is out_u
    for name, x, y in zip(("subtree", "guaranteed", "usage", "avail", "potential"), got, want):
        np.testing.assert_array_equal(x.numpy(), y, err_msg=name)
    for x, y in zip(tq.quota_all_plain(tree, torch.as_tensor(f["local_usage"])), got):
        assert torch.equal(x, y)


def test_usage_and_available_honours_done():
    f = cases.quota_forest(3, depth=2, big=20, n_small=5, fr=5)
    tree = interop.quota_tree(f, "cpu")
    sub, g = tq.subtree_quota(tree)
    out_u, out_a = torch.full_like(sub, -7), torch.full_like(sub, -9)
    done = torch.ones(1, dtype=torch.int32)
    u, a = tq.usage_and_available(tree, sub, g, torch.as_tensor(f["local_usage"]), out_u,
                                  out_a, done=done)
    assert u is out_u and a is out_a
    assert bool((u == -7).all()) and bool((a == -9).all())


def test_the_big_subtree_outgrows_the_shared_rows():
    """quota_forest's big root subtree is a bin beyond a block's shared
    memory at FR = 37 for both call sites, so blocks split its columns
    (the small bins fit whole); a subtree of thousands of nodes is too
    large for even one column and runs on the device rows; the headline
    (21-node bins, FR = 17) keeps every column in one block."""
    f = cases.quota_forest(0, depth=3)
    forest = tq.build_forest(f["parent"])
    sizes = (forest.bins[:, -1] - forest.bins[:, 0]).numpy()
    for mask in (tq.USAGE | tq.AVAIL, ALL):
        assert tq.bin_shared_bytes(int(sizes.max()), 37, mask) > tq.QUOTA_SHARED_BYTES
        assert tq.bin_shared_bytes(int(sizes.min()), 37, mask) <= tq.QUOTA_SHARED_BYTES
        cw = tq.column_chunk(forest.max_bin, 37, mask, forest.bins.shape[0])
        assert 1 <= cw < 37
        assert tq.bin_shared_bytes(forest.max_bin, cw, mask) <= tq.QUOTA_SHARED_BYTES
        # the headline's 50 bins: 3 blocks a bin, 6 columns a block
        assert tq.column_chunk(21, 17, mask, 50) == 6
        assert tq.column_chunk(21, 17, mask, 200) == 17
        assert tq.column_chunk(5000, 37, mask, 1) == 1
        assert tq.bin_shared_bytes(5000, 1, mask) > tq.QUOTA_SHARED_BYTES
    assert 37 % 32 != 0


def _check_forest(parent, forest):
    """build_forest's invariants: every node once; a bin holds whole root
    subtrees; levels are runs of positions in breadth-first order; a
    node's children are the run [first, end) of the next level."""
    parent = np.asarray(parent)
    meta = forest.meta.numpy()
    bins = forest.bins.numpy()
    n = parent.shape[0]
    assert sorted(meta[:, 0].tolist()) == list(range(n))
    assert bins[0, 0] == 0 and bins[-1, -1] == n
    assert (bins[1:, 0] == bins[:-1, -1]).all() and (np.diff(bins, axis=1) >= 0).all()
    for b in range(bins.shape[0]):
        lo, hi = bins[b, 0], bins[b, -1]
        nodes = set(meta[lo:hi, 0].tolist())
        for pos in range(lo, hi):
            node, par, first, end = meta[pos]
            d = int(np.searchsorted(bins[b, 1:-1], pos, side="right"))
            if par < 0:
                assert parent[node] < 0 and d == 0
            else:
                assert meta[lo + par, 0] == parent[node]
            kids = [int(meta[lo + x, 0]) for x in range(first, end)]
            assert sorted(kids) == sorted(np.nonzero(parent == node)[0].tolist())
            assert all(bins[b, d + 1] <= lo + x < bins[b, d + 2] for x in range(first, end))
            assert all(meta[lo + x, 1] == pos - lo for x in range(first, end))
        assert all(parent[x] < 0 or parent[x] in nodes for x in nodes)
    assert forest.max_bin == int((bins[:, -1] - bins[:, 0]).max())


@pytest.mark.parametrize("seed,depth", [(0, 1), (1, 3), (2, 7)])
def test_the_forest_packs_whole_root_subtrees(seed, depth):
    f = cases.quota_forest(seed, depth=depth)
    forest = tq.build_forest(f["parent"])
    _check_forest(f["parent"], forest)
    assert forest.depth == f["max_depth"]


def test_the_headline_forest_is_a_bin_a_cohort():
    """1000 ClusterQueues in 50 cohorts (the headline): 50 bins of 21
    nodes, each a cohort and its 20 ClusterQueues."""
    parent = np.concatenate([1000 + np.arange(1000) // 20, np.full(50, -1)])
    forest = tq.build_forest(parent)
    _check_forest(parent, forest)
    sizes = (forest.bins[:, -1] - forest.bins[:, 0]).numpy()
    assert forest.bins.shape[0] == 50 and (sizes == 21).all() and forest.depth == 1
    # parentless ClusterQueues pack several to a bin, up to N / 132
    alone = tq.build_forest(np.full(2000, -1))
    assert alone.bins.shape[0] == 125 and alone.max_bin == 16


def _walk_forest(f):
    """The four recurrences as kernel 1 runs them: bin by bin over
    build_forest's packing, bottom-up from the deepest level (children
    gathered), then top-down from the roots; numpy, int64."""
    from kueue_tpu_torch.ops.quota import NO_LIMIT

    forest = tq.build_forest(f["parent"])
    meta, bins = forest.meta.numpy(), forest.bins.numpy()
    sub = f["nominal"].copy()
    g = f["lending_limit"].copy()
    usage = f["local_usage"].copy()
    bl = f["borrowing_limit"]
    avail, pot = np.zeros_like(sub), np.zeros_like(sub)
    for b in range(bins.shape[0]):
        lo = bins[b, 0]
        for d in range(forest.depth, -1, -1):
            for pos in range(bins[b, d], bins[b, d + 1]):
                node, _, first, end = meta[pos]
                kids = meta[lo + first:lo + end, 0]
                sub[node] += (sub[kids] - g[kids]).sum(axis=0)
                g[node] = np.where(g[node] < NO_LIMIT, np.maximum(0, sub[node] - g[node]), 0)
                usage[node] += np.maximum(0, usage[kids] - g[kids]).sum(axis=0)
        for d in range(forest.depth + 1):
            for pos in range(bins[b, d], bins[b, d + 1]):
                node, par, _, _ = meta[pos]
                s, gg, u, lim = sub[node], g[node], usage[node], bl[node]
                if par < 0:
                    avail[node], pot[node] = s - u, s
                    continue
                up = meta[lo + par, 0]
                with_max = (s - gg) - np.maximum(0, u - gg) + lim
                has = lim < NO_LIMIT
                avail[node] = np.maximum(0, gg - u) + np.where(
                    has, np.minimum(with_max, avail[up]), avail[up])
                pv = gg + pot[up]
                pot[node] = np.where(has, np.minimum(s + lim, pv), pv)
    return sub, g, usage, avail, pot


@pytest.mark.parametrize("seed,depth", [(0, 1), (1, 4), (2, 7)])
def test_the_forest_walk_equals_the_plain_recurrences(seed, depth):
    f = cases.quota_forest(seed, depth=depth, big=120, n_small=30, fr=7)
    tree = interop.quota_tree(f, "cpu")
    want = tq.quota_all_plain(tree, torch.as_tensor(f["local_usage"]))
    for name, x, y in zip(("subtree", "guaranteed", "usage", "avail", "potential"),
                          _walk_forest(f), want):
        np.testing.assert_array_equal(x, y.numpy(), err_msg=name)


# one plain drain cycle against the JAX _plain_cycle

PHASE2_CASES = {
    "wide": dict(q=160, big=0.9, fr=40),
    "wide-drop": dict(q=160, big=0.9, fr=40, drop=True),
    "deep": dict(q=40, depth=6),
    "deep-drop": dict(q=40, depth=6, drop=True),
    "podsets-3": dict(q=48, p=3, c=3, fr=5),
}
STATE = ("local", "cursor", "g_start", "retries", "stuck", "no_prog", "adm_k", "adm_cycle",
         "cycle")


def _port_cycle(b):
    """(ctx, state, buffers) after one drain_cycle of the port on the CPU."""
    qn = b["queues_np"]
    tree, queues, local, paths = interop.drain_inputs(b, qn, "cpu")
    ctx = tdk.DrainContext.build(tree, queues, paths, b["n_segments"], b["n_steps"], 8,
                                 seg_id=qn["seg_id"])
    state = tdk.DrainState.initial(local, queues, 8)
    for name in ("local", "cursor", "g_start", "alive"):
        getattr(state, name).copy_(torch.as_tensor(b[name]))
    state.done.zero_()
    buf = tdk.CycleBuffers.empty(local, queues)
    tdk.drain_cycle(ctx, state, buf)
    return ctx, state, buf


def _jax_cycle(b):
    qn = b["queues_np"]
    tree = jq.QuotaTree(**{k: jnp.asarray(b[k]) for k in TREE_FIELDS})
    sub, g = jq.subtree_quota(tree)
    pot = jq.potential_available_all(tree, sub, g)
    queues = jdk.DrainQueues(**{k: jnp.asarray(v) for k, v in qn.items() if v is not None})
    q, l, pmax = qn["cells"].shape[:3]
    init = (
        jnp.asarray(b["local"]), jnp.asarray(b["cursor"]), jnp.asarray(b["g_start"]),
        jnp.zeros(q, dtype=jnp.int32), jnp.zeros(q, dtype=bool), jnp.int32(0),
        jnp.full((q, l, pmax), -1, dtype=jnp.int32), jnp.full((q, l), -1, dtype=jnp.int32),
        jnp.int32(0),
    )
    return jdk._plain_cycle(tree, sub, g, pot, queues, jnp.asarray(b["paths"]),
                            b["n_segments"], b["n_steps"], init, alive=jnp.asarray(b["alive"]))


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("case", sorted(PHASE2_CASES))
def test_drain_cycle_matches_jax_at_phase2_edges(case, seed):
    b = cases.phase2_batch(seed, **PHASE2_CASES[case])
    _, state, buf = _port_cycle(b)
    want = _jax_cycle(b)
    for name, j in zip(STATE, want):
        np.testing.assert_array_equal(getattr(state, name).numpy().reshape(np.shape(j)),
                                      np.asarray(j), err_msg=name)
    assert bool(buf.admitted.any())


def _coverage(b, ctx, buf):
    """What a case reaches: the largest segment's walked heads beyond the
    shared rows, dropped ranks, walked reserves, podsets repeating a
    cell, tied keys, paths of 7 levels."""
    qn = b["queues_np"]
    q, l, p, k, c = qn["cells"].shape
    seg = qn["seg_id"]
    nominated = (buf.is_fit | buf.is_pre).numpy()
    counts = np.bincount(seg[nominated], minlength=b["n_segments"])
    walked = np.minimum(counts, b["n_steps"])
    fr = b["nominal"].shape[1]
    lay = tdk.phase2_layout(ctx.segments.max_size, b["n_steps"], p * c, fr, b["max_depth"])
    need = [tdk.phase2_segment_bytes(int(n), fr, b["max_depth"]) for n in walked]
    seen = set()
    if max(need) > lay["rows_bytes"]:
        seen.add("device rows")
    if min(x for x in need if x) <= lay["rows_bytes"]:
        seen.add("shared rows")
    if (counts > b["n_steps"]).any():
        seen.add("dropped ranks")
    if (buf.is_pre.numpy() & qn["no_reclaim"]).any():
        seen.add("reserve")
    cur = np.minimum(b["cursor"], l - 1)
    for i in np.nonzero(nominated)[0]:
        flat = qn["cells"][i, cur[i]].reshape(p, -1)
        sets = [set(r[r >= 0].tolist()) for r in flat[: qn["n_podsets"][i, cur[i]]]]
        if len(sets) > 1 and set.intersection(*sets):
            seen.add("repeated cells")
    keys = {}
    for i in np.nonzero(nominated)[0]:
        key = (seg[i], bool(buf.head_borrow[i]), qn["priority"][i, cur[i]],
               qn["timestamp"][i, cur[i]])
        keys[key] = keys.get(key, 0) + 1
    if max(keys.values()) > 1:
        seen.add("ties")
    if b["max_depth"] == 6:
        seen.add("7 levels")
    return seen


def test_phase2_batches_cover_the_edges():
    """Guard against a vacuous sweep: the cases walk a segment on device
    rows beside small ones on shared rows, drop ranks, reserve, repeat
    cells across podsets, tie keys and walk paths of 7 levels."""
    seen = set()
    for case, kw in PHASE2_CASES.items():
        for seed in range(2):
            b = cases.phase2_batch(seed, **kw)
            ctx, _, buf = _port_cycle(b)
            seen |= _coverage(b, ctx, buf)
    assert seen >= {"device rows", "shared rows", "dropped ranks", "reserve",
                    "repeated cells", "ties", "7 levels"}


def test_phase2_layout_at_the_headline_and_its_edges():
    # the headline drain: segments of 20 queues, P*C = 3, FR = 17, D = 1
    lay = tdk.phase2_layout(20, 64, 3, 17, 1)
    assert lay["keys"] and lay["win"] == tdk.PHASE2_WINDOW
    assert lay["rows_bytes"] == tdk.phase2_segment_bytes(20, 17, 1)
    assert lay["total"] <= tdk.PHASE2_SHARED_BYTES
    # a segment of 1000 queues, all walked, keeps its rows in device memory
    wide = tdk.phase2_layout(1000, 1024, 3, 17, 1)
    assert wide["keys"] and wide["rows_bytes"] < tdk.phase2_segment_bytes(1000, 17, 1)
    assert wide["total"] == tdk.PHASE2_SHARED_BYTES
    # n_steps caps the walk the rows are sized for
    assert tdk.phase2_layout(1000, 8, 3, 17, 1)["rows_bytes"] == tdk.phase2_segment_bytes(
        8, 17, 1)
    # too wide for the staged keys: they stay in device memory
    assert not tdk.phase2_layout(12000, 64, 3, 17, 1)["keys"]
    # windows shrink before the shape is refused
    assert tdk.phase2_layout(45000, 64, 32, 17, 7)["win"] < tdk.PHASE2_WINDOW
    assert tdk.phase2_layout(60000, 64, 32, 17, 1) is None
    assert tdk.phase2_segment_bytes(20, 17, 1) == 20 * 2 * (8 + 40 * 17)
