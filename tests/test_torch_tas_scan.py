"""The plain versions the two redesigned serial kernels are held to on the
card (the TAS drain's step scan, ``drain_tas_phase2``, B13; the
unsegmented cycle's walk, ``cycle_global``, B3') against the JAX package
at the shapes that reach the new designs' edges, exactly (int64,
tolerance 0), on the same seeded numpy inputs:

- the TAS drain (``run_drain_tas``, device="cpu") against the JAX
  package's on ``perf.cases.tas_scan_spec``: four topology resources,
  gangs spread over more than 64 leaves, two heads of one cycle
  nominating the same leaves (the later one's re-validation fails on the
  live usage), plain heads mixed in, ties on priority and timestamp,
  preempt-mode reserves; a guard that the cycles really reach those
  edges;
- the TAS drain's packed solve (``_solve_drain_tas_packed``) with
  n_steps below the ranked heads of a cycle, so ranks are dropped;
- the unsegmented cycle (``solve_cycle``) against the JAX package's
  ``solve_cycle`` on a tree beyond one block's shared memory, one root
  holding most heads, ClusterQueues without a cohort, paths of 8
  levels, pads and no-fit heads, W not a multiple of 32;
- ``global_layout``, the grid and shared memory cycle_global takes, at
  the headline and its edges.
"""

import numpy as np
import pytest
import torch

from kueue_tpu._jax import jnp
from kueue_tpu.core.drain import run_drain_tas as jax_run_drain_tas
from kueue_tpu.core.snapshot import take_snapshot as jax_take_snapshot
from kueue_tpu.ops import assign_kernel as jak
from kueue_tpu.ops import drain_kernel as jdk
from kueue_tpu.ops import quota as jq
from kueue_tpu_torch import interop
from kueue_tpu_torch.core import drain as pd
from kueue_tpu_torch.core.snapshot import take_snapshot
from kueue_tpu_torch.ops import assign_kernel as tak
from kueue_tpu_torch.ops import drain_kernel as tdk
from kueue_tpu_torch.perf import cases
from kueue_tpu_torch.perf import tas as pt
from kueue_tpu_torch.perf.lockstep import TAS_STEPS

from tests.test_torch_tas import JAX
from tests.test_torch_tas_drain import view

TREE_FIELDS = ("parent", "level_mask", "nominal", "lending_limit", "borrowing_limit")
CYCLE_FIELDS = ("chosen", "admitted", "borrows", "reserved", "usage", "order")


# ---- the TAS drain's step scan (B13, drain_tas_phase2) --------------------


def _inputs(spec):
    env = pt.build_tas_env(spec)
    return pd.tas_drain_inputs(take_snapshot(env.cache), env.pending, env.cache.flavors,
                               env.tas, "cpu", timestamp_fn=env.ts_fn)


@pytest.mark.parametrize("seed", range(4))
def test_tas_drain_matches_jax_at_the_scan_edges(seed):
    spec = cases.tas_scan_spec(seed)
    je, pe = pt.build_tas_env(spec, JAX), pt.build_tas_env(spec)
    jo = jax_run_drain_tas(jax_take_snapshot(je.cache), je.pending, je.cache.flavors, je.tas,
                           timestamp_fn=je.ts_fn)
    po = pd.run_drain_tas(take_snapshot(pe.cache), pe.pending, pe.cache.flavors, pe.tas,
                          timestamp_fn=pe.ts_fn, device="cpu")
    assert view(po) == view(jo)
    assert po.admitted and not po.fallback


def _scan_edges(inp) -> set:
    """The edges the plain step scan meets over a drain's cycles."""
    ctx = tdk.tas_context(inp.tree, inp.queues, inp.paths, inp.topo.free, inp.topo.seg_ids,
                          inp.theads, inp.n_domains, inp.n_steps, inp.plan.max_cycles)
    state = tdk.TASState.initial_tas(inp.local, inp.queues, inp.plan.max_cycles,
                                     inp.topo.tas_usage)
    buf = tdk.TASBuffers.empty_tas(inp.local, inp.queues, inp.topo.free.shape[0])
    q = inp.queues
    th = inp.theads
    free = inp.topo.free
    seen = {"Rt > 2"} if free.shape[1] > 2 else set()
    while not bool(state.done):
        for name, kern, _ in TAS_STEPS:
            if name != "drain_tas_phase2":
                kern(ctx, state, buf)
                continue
            cur = state.cursor.clamp_max(q.priority.shape[1] - 1).long()
            rows = torch.arange(q.qlen.shape[0])
            walked = ((buf.is_fit | buf.is_pre) & (state.cursor < q.qlen) & state.alive
                      & (q.cq_rows >= 0))
            before = state.tas_u.clone()
            taken = buf.taken0.clone()
            kern(ctx, state, buf)
            spread = (taken > 0).sum(dim=1)
            if ((spread > 32) & walked & th.t_is).any():
                seen.add("spread > 32")
            if ((spread > 64) & walked & th.t_is).any():
                seen.add("spread > 64")
            if (walked & ~th.t_is).any():
                seen.add("plain heads")
            if (walked & buf.is_pre & q.no_reclaim).any():
                seen.add("reserve")
            keys = torch.stack([buf.head_borrow.long(), q.priority[rows, cur],
                                q.timestamp[rows, cur]], dim=1)[walked]
            if len(torch.unique(keys, dim=0)) < len(keys):
                seen.add("ties")
            # a quota-Fit TAS head whose nominated leaves held at the cycle's
            # start and no longer hold after earlier steps' charges
            req = th.t_req[rows, cur]
            for h in torch.nonzero(walked & buf.is_fit & th.t_is & ~buf.admitted).flatten():
                on = taken[h] > 0
                need = (req[h][None, :] * taken[h][:, None])[on]
                if ((free[on] - state.tas_u[on]) < need).any() and not (
                        (free[on] - before[on]) < need).any():
                    seen.add("re-validation fails")
    return seen


def test_tas_scan_spec_reaches_the_edges():
    """Guard against a vacuous sweep."""
    seen = set()
    for seed in range(4):
        seen |= _scan_edges(_inputs(cases.tas_scan_spec(seed)))
    assert seen >= {"Rt > 2", "spread > 32", "spread > 64", "plain heads", "reserve", "ties",
                    "re-validation fails"}


def _jax_array(x):
    return jnp.asarray(x.numpy()) if isinstance(x, torch.Tensor) else x


@pytest.mark.parametrize("n_steps", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 2])
def test_tas_solve_matches_jax_with_dropped_ranks(seed, n_steps):
    """n_steps below a cycle's ranked heads: the scan walks the first
    n_steps of the global order, as the JAX scatter's mode="drop"
    keeps them."""
    inp = _inputs(cases.tas_scan_spec(seed))
    tree, local, queues, paths, free, usage0, seg_ids, theads, n_domains, _, _ = (
        inp.solve_args())
    max_cycles = 48
    jtree = jq.QuotaTree(**{f: _jax_array(getattr(tree, f)) for f in TREE_FIELDS})
    jqueues = jdk.DrainQueues(**{f: None if v is None else _jax_array(v)
                                 for f, v in queues._asdict().items()})
    jheads = jdk.TASHeads(**{f: _jax_array(v) for f, v in theads._asdict().items()})
    want = np.asarray(jdk._solve_drain_tas_packed(
        jtree, _jax_array(local), jqueues, _jax_array(paths), _jax_array(free),
        _jax_array(usage0), _jax_array(seg_ids), jheads, n_domains, n_steps, max_cycles))
    got = tdk._solve_drain_tas_packed(
        tree, local.clone(), queues, paths, free, usage0, seg_ids, theads, n_domains, n_steps,
        max_cycles, seg_id=inp.plan.queues_np["seg_id"])
    np.testing.assert_array_equal(got.numpy(), want)
    q, l = queues.priority.shape
    assert (got[q * l:2 * q * l] >= 0).any()  # something was admitted


# ---- the unsegmented cycle's walk (B3', cycle_global) ---------------------


def _root_heads(b) -> np.ndarray:
    """Heads a root cohort (pads left out)."""
    roots = tak.build_roots(b["parent"])
    cq = b["cq_row"]
    return np.bincount(roots[cq[cq >= 0]], minlength=len(b["parent"]))


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("edge", cases.GLOBAL_EDGES)
def test_solve_cycle_matches_jax_at_the_edges(edge, seed):
    b = cases.global_batch(edge, seed)
    jtree = jq.QuotaTree(**{f: jnp.asarray(b[f]) for f in TREE_FIELDS})
    jheads = jak.HeadsBatch(**{f: jnp.asarray(b[f]) for f in interop.HEADS_DTYPES})
    want = jak.solve_cycle_jit(jtree, jnp.asarray(b["local_usage"]), jheads,
                               jnp.asarray(b["paths"]))
    args = (interop.quota_tree(b, "cpu"), torch.tensor(b["local_usage"]),
            interop.heads_batch(b, "cpu"), torch.tensor(b["paths"]))
    got = tak.solve_cycle(*args)
    seg = tak.solve_cycle_segmented(*args, b["seg_id"], max(b["n_segments"], 1),
                                    max(int(np.bincount(b["seg_id"][b["seg_id"] >= 0],
                                                        minlength=1).max()), 1))
    for f in CYCLE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
                                      err_msg=f)
        assert torch.equal(getattr(got, f), getattr(seg, f)), f
    heads = _root_heads(b)
    if edge == "beyond-shared-memory":
        assert 8 * b["nominal"].size > tak.PHASE2_SHARED_BYTES
    if edge == "one-root":
        assert heads.max() > 0.9 * (b["cq_row"] >= 0).sum()
    if edge == "cohortless":
        assert (b["parent"][: len(b["cq_row"])] < 0).sum() > 20
    if edge == "depth-7":
        assert b["max_depth"] == 7
    if edge == "pads-and-no-fit":
        assert (b["cq_row"] < 0).any() and (np.asarray(want.chosen) < 0).sum() >= 8


def test_global_layout_at_the_headline_and_its_edges():
    # the headline cycle: W=1024, C=16, FR=17, depth 1, 50 bins of 21 nodes
    lay = tak.global_layout(1024, 16, 17, 1, 50, 21)
    assert lay["grid"] == 50 and lay["keys"] and lay["mem"] >= 0
    assert lay["win"] == tak.PHASE2_WINDOW
    assert lay["rows_bytes"] == 21 * 17 * 32  # every group on shared rows
    assert lay["total"] <= tak.PHASE2_SHARED_BYTES
    offsets = [lay[f] for f in tak.GLOBAL_LAYOUT_FIELDS if f in ("prio", "ts", "stage", "cls",
                                                                  "rows")]
    assert all(o % 8 == 0 for o in offsets) and offsets == sorted(offsets)
    # a bin of 2800 nodes outgrows the rows: that group walks on device rows
    big = tak.global_layout(8, 5, 12, 3, 20, 2800)
    assert big["rows_bytes"] < 2800 * 12 * 32 and big["total"] == tak.PHASE2_SHARED_BYTES
    # more bins than blocks: a group of consecutive bins a block
    many = tak.global_layout(1024, 16, 17, 1, 1000, 3)
    assert many["grid"] == tak.GLOBAL_BLOCKS
    assert many["rows_bytes"] == -(-1000 // tak.GLOBAL_BLOCKS) * 3 * 17 * 32
    # W too wide for the keys: they stay in device memory
    wide = tak.global_layout(12000, 16, 17, 3, 132, 60)
    assert not wide["keys"] and wide["total"] <= tak.PHASE2_SHARED_BYTES
    # W too wide for the member lists: the shape is refused
    assert tak.global_layout(20000, 16, 17, 1, 50, 21) is None


def test_forest_positions_invert_its_packing():
    """The node -> position map cycle_global groups heads by: the inverse
    of the forest's node column, every bin one run of positions."""
    from kueue_tpu_torch.ops.quota import build_forest

    b = cases.cycle_batch(3, n_cq=300, fr=4)
    f = build_forest(b["parent"])
    node = f.meta[:, 0].numpy()
    assert (node[f.pos.numpy()] == np.arange(len(node))).all()
    roots = tak.build_roots(b["parent"])
    starts, ends = f.bins[:, 0].numpy(), f.bins[:, -1].numpy()
    assert (starts[1:] == ends[:-1]).all()
    for lo, hi in zip(starts, ends):
        members = set(node[lo:hi].tolist())
        assert all(int(roots[x]) in members for x in members)
