"""The plain versions the two kernels redesigned for the card are held to
(the classic preempt drain's step scan, ``drain_preempt_phase2``, B10b;
the planner's entry order and walk, ``plan_phase2``, B14's phase 2)
against the JAX package at the shapes that reach the new designs'
branches, exactly (int64, tolerance 0), on the same seeded inputs:

- the preempt drain (``run_drain_preempt``, device="cpu") against the
  JAX package's on ``perf.cases.preempt_spec`` (a depth-3 forest) with
  the org's segment widened to 16 ClusterQueues (8 and 16, with other
  seeds, under ``-m slow``), and with 600 workloads a ClusterQueue,
  whose within-queue segment's pool (1203 slots of 12 cells: its
  victims and its pending entries, under a max_victims of 2048) is wider
  than one block's shared memory holds (that drain cut at 4 cycles);
  under ``-m slow`` also a segment of 64 nodes over 64 cells, whose rows
  are past it too; a guard that these step scans meet a later preempter
  whose targets overlap an earlier eviction, a preempter that no longer
  fits once its victims are out (its rows restored), reserves under a
  borrowing cap and under NO_LIMIT, victims of other queues of the
  cohort at Cv >= 4 cells a slot, and depth 3;
- the scenario-batched solve (``solve_scenarios``, the plain
  ``plan_phase2`` last) against ``solve_scenarios_jit`` on
  ``perf.cases.plan_batch`` at W = 1, at a W that is no power of two
  and above a sorted tile (2048 heads), with every priority and
  timestamp tied (the index orders), with priority rows shared by some
  scenarios beside their own, with every head in one class, with
  dropped ranks and pads, and with a root whose walked paths hold more
  nodes than a walk block stages; the order row equals the lexsort's in
  every scenario.
"""

import numpy as np
import pytest
import torch

from kueue_tpu._jax import jnp
from kueue_tpu.ops import assign_kernel as jak
from kueue_tpu.ops.plan_kernel import solve_scenarios_jit
from kueue_tpu_torch import interop
from kueue_tpu_torch.core import drain as pd
from kueue_tpu_torch.core.snapshot import take_snapshot
from kueue_tpu_torch.ops import drain_kernel as tdk
from kueue_tpu_torch.ops import plan_kernel as pk
from kueue_tpu_torch.ops.quota import NO_LIMIT
from kueue_tpu_torch.perf import cases
from kueue_tpu_torch.perf.cases import build_cache, plan_batch
from kueue_tpu_torch.perf.lockstep import PREEMPT_STEPS

from tests.test_torch_preempt_drain import both_drains, view

# the preempt specs of the step edges: (seed, ClusterQueues a team); the
# first reaches every edge, the wider sweep is slow
STEP_SPECS = [(4, 4)]
SLOW_STEP_SPECS = [(6, 2), (9, 4)]
# shared memory a drain_preempt_phase2 block may take (csrc, kSmemLimit)
SMEM_LIMIT = 232448 - 1024

# ---- the preempt drain's step scan (B10b) -------------------------------------


def _step_edges_drain(seed, per_team):
    spec = cases.preempt_spec(seed, cqs_per_team=per_team)
    jout, pout, _, _ = both_drains(spec, names=True, search_width=32)
    assert view(pout) == view(jout)
    assert pout.admitted and pout.preempted


@pytest.mark.parametrize("seed,per_team", STEP_SPECS)
def test_preempt_drain_matches_jax_at_the_step_edges(seed, per_team):
    _step_edges_drain(seed, per_team)


@pytest.mark.slow
@pytest.mark.parametrize("seed,per_team", SLOW_STEP_SPECS)
def test_preempt_drain_matches_jax_at_the_step_edges_wider(seed, per_team):
    _step_edges_drain(seed, per_team)


def test_preempt_drain_matches_jax_past_the_pool_room():
    """A within-queue segment whose pool (its victims and its pending
    entries) is wider than one block's shared memory holds: the kernel
    keeps that pool in device memory."""
    spec_kw, drain_kw = cases.PREEMPT_EDGES["wide pool"]
    spec = cases.preempt_spec(**spec_kw)
    cache, pending = build_cache(spec)
    _, _, _, _, _, queues, victims = pd.preempt_drain_inputs(
        take_snapshot(cache), pending, cache.flavors, "cpu", max_victims=drain_kw["max_victims"])
    v, cv = victims.scells.shape[1:]
    assert v * (12 * cv + 4) > SMEM_LIMIT
    jout, pout, _, _ = both_drains(spec, names=True, search_width=32, **drain_kw)
    assert view(pout) == view(jout)
    assert pout.admitted and pout.preempted


@pytest.mark.slow
def test_preempt_drain_matches_jax_past_the_rows_room():
    """A segment of 64 nodes over 64 cells (56 flavors of a resource no
    workload requests): its rows exceed one block's shared memory, so
    the kernel walks on device rows."""
    spec_kw, drain_kw = cases.PREEMPT_EDGES["wide rows"]
    spec = cases.preempt_spec(**spec_kw)
    cache, pending = build_cache(spec)
    _, _, tree, _, _, _, victims = pd.preempt_drain_inputs(take_snapshot(cache), pending,
                                                           cache.flavors, "cpu")
    assert victims.seg_nodes.shape[1] * tree.nominal.shape[1] * 64 > SMEM_LIMIT
    jout, pout, _, _ = both_drains(spec, names=True, search_width=32, **drain_kw)
    assert view(pout) == view(jout)
    assert pout.admitted and pout.preempted


def step_edges(spec, max_cycles: int = 400) -> set:
    """The edges the plain step scan meets over a drain's cycles, read
    from each call's inputs and outputs: each segment's walked heads in
    entry order (the plain version's lexsort), the evictions of the
    heads before each one, its targets, its flags and its cells."""
    cache, pending = build_cache(spec)
    plan, _, tree, paths, local, queues, victims = pd.preempt_drain_inputs(
        take_snapshot(cache), pending, cache.flavors, "cpu")
    ctx = tdk.DrainContext.build(tree, queues, paths, plan.n_segments, plan.n_steps,
                                 plan.max_cycles,
                                 preempt=tdk.PreemptInputs(victims=victims, search_width=32))
    state = tdk.PreemptState.initial_preempt(local, queues, plan.max_cycles, victims)
    buf = tdk.PreemptBuffers.empty_preempt(local, queues, victims)
    seen = set()
    if tree.max_depth == 3:
        seen.add("depth 3")
    q, l = queues.priority.shape
    cq = queues.cq_rows.numpy()
    seg = queues.seg_id.numpy()
    owner = victims.sowner.numpy()
    cycles = 0
    while not bool(state.done) and cycles < max_cycles:
        for name, _, plain in PREEMPT_STEPS:
            if name != "drain_preempt_phase2":
                plain(ctx, state, buf)
                continue
            active = ((state.cursor < queues.qlen) & state.alive).numpy()
            cur = state.cursor.clamp_max(l - 1).long()
            prio = queues.priority[torch.arange(q), cur].numpy()
            ts = queues.timestamp[torch.arange(q), cur].numpy()
            is_fit, is_pre = buf.is_fit.numpy().copy(), buf.is_pre.numpy().copy()
            ps, borrow = buf.psuccess.numpy().copy(), buf.head_borrow.numpy().copy()
            targets = buf.targets.numpy().copy()
            cells, qty = buf.cells_eff.numpy().copy(), buf.qty_eff.numpy().copy()
            pcells = state.pcells.numpy().copy()
            plain(ctx, state, buf)
            pre_ok = buf.preempt_ok.numpy()
            no_reclaim = queues.no_reclaim.numpy()
            bl = tree.borrowing_limit.numpy()
            for g in np.unique(seg[seg >= 0]):
                heads = [x for x in np.nonzero((seg == g) & active & (is_fit | is_pre))[0]]
                heads.sort(key=lambda x: (borrow[x], -prio[x], ts[x], x))
                evicted = np.zeros(targets.shape[1], dtype=bool)
                for x in heads[:plan.n_steps]:
                    if ps[x]:
                        if (targets[x] & evicted).any():
                            seen.add("overlap")
                        elif not pre_ok[x]:
                            seen.add("restored")
                    if pre_ok[x]:
                        evicted |= targets[x]
                        slots = np.nonzero(targets[x])[0]
                        if pcells.shape[2] >= 4 and (owner[g, slots] != cq[x]).any():
                            seen.add("other queue's victim, Cv >= 4")
                    valid = (cells[x] >= 0) & (qty[x] > 0)
                    if is_pre[x] and not ps[x] and no_reclaim[x] and valid.any() and borrow[x]:
                        lim = bl[cq[x], cells[x][valid]]
                        seen.add("reserve, capped" if (lim < NO_LIMIT).any()
                                 else "reserve, NO_LIMIT")
        cycles += 1
    return seen


def test_preempt_specs_reach_the_step_edges():
    """Guard against a vacuous sweep: the drains above (and the card's
    twins) meet every edge the new design branches on."""
    spec_kw, _ = cases.PREEMPT_EDGES["step edges"]
    seen = step_edges(cases.preempt_spec(**spec_kw))
    assert (spec_kw["seed"], spec_kw["cqs_per_team"]) == STEP_SPECS[0]
    assert seen >= {"overlap", "restored", "reserve, capped", "reserve, NO_LIMIT",
                    "other queue's victim, Cv >= 4", "depth 3"}


# ---- the planner's entry order and walk (B14's phase 2) -----------------------

STACKS = ("nominal_s", "lending_s", "borrowing_s", "usage_s", "priority_s", "score_s")
PLAN_EDGES = cases.PLAN_EDGES


def _jax(b):
    heads = jak.HeadsBatch(**{f: jnp.asarray(b["heads"][f]) for f in interop.HEADS_DTYPES})
    per_head, usage = solve_scenarios_jit(
        jnp.asarray(b["parent"]), jnp.asarray(b["level_mask"]),
        *(jnp.asarray(b[k]) for k in STACKS),
        heads, jnp.asarray(b["paths"]), jnp.asarray(b["seg_id"]),
        n_segments=b["n_segments"], n_steps=b["n_steps"],
    )
    return np.asarray(per_head), np.asarray(usage)


def _lexsort_order(b, per_head) -> np.ndarray:
    """Each scenario's entry order as np.lexsort gives it from the keys:
    no-fit last, non-borrowing first, priority desc, timestamp asc."""
    s, w = b["priority_s"].shape
    out = np.empty((s, w), dtype=np.int64)
    for si in range(s):
        chosen, borrows, pk_ = per_head[si, 0], per_head[si, 2], per_head[si, 5]
        nofit = (chosen < 0) & (pk_ < 0)
        out[si] = np.lexsort((b["heads"]["timestamp"], -b["priority_s"][si], borrows, nofit))
    return out


@pytest.mark.parametrize("edge", sorted(PLAN_EDGES))
def test_plan_matches_jax_at_the_order_edges(edge):
    b = plan_batch(**PLAN_EDGES[edge])
    want_ph, want_u = _jax(b)
    per_head, usage = pk.solve_scenarios(**interop.plan_inputs(b, "cpu"),
                                         n_segments=b["n_segments"], n_steps=b["n_steps"])
    np.testing.assert_array_equal(per_head.numpy(), want_ph)
    np.testing.assert_array_equal(usage.numpy(), want_u)
    np.testing.assert_array_equal(per_head[:, 4].numpy(), _lexsort_order(b, want_ph))


def test_plan_edges_reach_their_branches():
    """Guard: each case holds the shape its name promises."""
    b = {name: plan_batch(**kw) for name, kw in PLAN_EDGES.items()}
    assert b["W=1"]["heads"]["cq_row"].shape == (1,) and b["W=1"]["heads"]["cq_row"][0] >= 0
    assert b["W=4099, tiles and merges"]["heads"]["cq_row"].shape[0] > 2 * 2048
    ties = b["ties"]
    assert (ties["priority_s"] == 0).all() and (ties["heads"]["timestamp"] == 0).all()
    rows = b["shared and own priority rows"]["priority_s"]
    same = [bool((rows[si] == rows[0]).all()) for si in range(rows.shape[0])]
    assert same == [True, True, False, True, True, False]
    ph, _ = _jax(b["one class"])
    assert ((ph[:, 0] < 0) & (ph[:, 5] < 0)).all()
    drop = b["dropped ranks and pads"]
    assert drop["n_steps"] < np.bincount(drop["seg_id"][drop["seg_id"] >= 0]).max()
    assert (drop["heads"]["cq_row"] < 0).any()
    wide = b["past the walk's rows"]
    paths, seg = wide["paths"], wide["seg_id"]
    cq = wide["heads"]["cq_row"]
    nodes = max(len(np.unique(paths[cq[seg == g]][paths[cq[seg == g]] >= 0]))
                for g in range(wide["n_segments"]))
    # a slot's rows take 32 B a cell: at FR = 64 a walk block stages
    # fewer than 14 nodes
    assert wide["nominal_s"].shape[2] == 64 and nodes >= 24
