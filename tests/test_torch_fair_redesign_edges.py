"""The plain versions the two kernels redesigned for the card are held to
(the fair-preempt drain's victim search, ``drain_fair_preempt_search``,
B11a; the fair drain's step scan, ``drain_fair_phase2``, B7) against the
JAX package at the shapes that reach the new designs' branches, exactly
(int64, tolerance 0), on the same seeded inputs:

- the fair-preempt drain (``run_drain_fair_preempt``, device="cpu")
  against the JAX package's on ``perf.cases.fair_preempt_spec`` seeds 1
  and 8 under stacks tests/test_torch_fair_preempt_drain.py leaves out
  (both strategies at 8, LessThanOrEqualToFinalShare alone at 1), and at
  the panel caps with one root (V = 512 slots, M = 64 nodes, Cu = 64
  cells); a guard that these searches meet a weight-0 node (DRS_MAX),
  DRS ties between sibling queues, the second strategy's pruning,
  own-queue victims, fill-backs that keep victims and a rootless head;
- the fair drain (``run_drain(fair_sharing=True)``) against the JAX
  package's on ``perf.cases.fair_spec`` (depth 3) with three
  ClusterQueues a team, PrioritySortingWithinCohort on and off, and with
  70 a team, where the org's segment's rows outgrow one block's shared
  memory (that drain cut at 2 cycles; the card's twins also drain 150 a
  team, beyond it with the heads' tables); a guard that the step scans
  meet a parent whose every proposal is DRS_MAX (none below INF) and
  admissions that charge a non-root cohort.
"""

import numpy as np
import pytest
import torch

from kueue_tpu import features as jax_features
from kueue_tpu import models as jax_models
from kueue_tpu.core import flavor_assigner as jax_fa
from kueue_tpu.core import preempt_batch as jax_pb
from kueue_tpu.core import snapshot as jax_snapshot
from kueue_tpu.core.drain import run_drain as jax_run_drain
from kueue_tpu.core.drain import run_drain_fair_preempt as jax_run_fair_preempt
from kueue_tpu.core.preemption import LESS_THAN_OR_EQUAL_TO_FINAL_SHARE
from kueue_tpu_torch import features as port_features
from kueue_tpu_torch.core import drain as pd
from kueue_tpu_torch.core.snapshot import take_snapshot
from kueue_tpu_torch.ops import drain_kernel as tdk
from kueue_tpu_torch.ops import fair_preempt_kernel as fpk
from kueue_tpu_torch.perf import cases
from kueue_tpu_torch.perf import fairpreempt as fp
from kueue_tpu_torch.perf.cases import build_cache, fair_spec
from kueue_tpu_torch.perf.lockstep import FAIR_PREEMPT_STEPS, FAIR_STEPS

from tests.test_torch_drain import _view
from tests.test_torch_fair_drain import _envs
from tests.test_torch_fair_preempt_drain import BOTH, SMALL_CYCLES, both_drains
from tests.test_torch_preempt_drain import jax_api, view

CAPS_CYCLES = 2  # the caps drain's cut: its first cycles search the most heads
WIDE_CYCLES = 2  # the wide fair_spec drains' cut (both packages truncate alike)
INF = 1 << 62

# ---- the fair-preempt drain's victim search (B11a) ---------------------------


@pytest.mark.parametrize("seed,strategies", [
    (8, BOTH), (1, [LESS_THAN_OR_EQUAL_TO_FINAL_SHARE]),
])
def test_fair_preempt_drain_matches_jax_at_the_search_edges(seed, strategies):
    jout, pout = both_drains(cases.fair_preempt_spec(seed), names=True,
                             fs_strategies=strategies, max_cycles=SMALL_CYCLES)
    assert view(pout) == view(jout)
    assert pout.admitted and pout.preempted


def test_fair_preempt_drain_matches_jax_at_the_caps():
    """One root of the panel caps: the search's widest shapes (V = 512
    pool slots, M = 64 nodes, Cu = 64 cells over two resources, depth
    3), over the first cycles (the drain at all 8 roots is held to
    FAIR_WIDE_EXPECT in both packages by test_torch_fair_preempt_drain)."""
    rng = lambda: np.random.default_rng(fp.WIDE_SEED)  # noqa: E731
    jenv = fp.build_fair_wide(rng(), 1, api=fp.fair_api(jax_api(), jax_models, jax_fa,
                                                          jax_snapshot, jax_pb))
    penv = fp.build_fair_wide(rng(), 1)
    psnap = take_snapshot(penv.cache)
    _, _, tree, _, _, _, victims, panels, _ = pd.fair_preempt_drain_inputs(
        psnap, penv.pending, penv.cache.flavors, "cpu", timestamp_fn=penv.ts_fn)
    assert victims.perm.shape[1] == 512 and tree.max_depth == 3
    assert tuple(victims.seg_nodes.shape[1:]) == tuple(panels.seg_cells.shape[1:]) == (64,)
    jout = jax_run_fair_preempt(jax_snapshot.take_snapshot(jenv.cache), jenv.pending,
                                jenv.cache.flavors, timestamp_fn=jenv.ts_fn,
                                max_cycles=CAPS_CYCLES)
    pout = pd.run_drain_fair_preempt(psnap, penv.pending, penv.cache.flavors,
                                     timestamp_fn=penv.ts_fn, device="cpu",
                                     max_cycles=CAPS_CYCLES)
    assert view(pout) == view(jout)
    assert pout.admitted and len(pout.evictions) > 8


def _search_edges(spec) -> set:
    """The edges the plain search meets over a drain's cycles, read from
    each search's problem, its trace and its result."""
    cache, pending = build_cache(spec)
    plan, _, tree, paths, local, queues, victims, panels, fair = pd.fair_preempt_drain_inputs(
        take_snapshot(cache), pending, cache.flavors, "cpu")
    ctx = tdk.fair_preempt_context(tree, queues, victims, panels, paths, fair,
                                   plan.n_segments, plan.n_steps, SMALL_CYCLES, 0, True)
    state = tdk.FairPreemptState.initial_fair(local, queues, SMALL_CYCLES, victims, panels)
    buf = tdk.PreemptBuffers.empty_preempt(local, queues, victims)
    seen = set()
    real_solve, real_tour = tdk.solve_fair, fpk._tournament

    def tournament(p, drs, avail_v, pruned2, *args):
        if pruned2.any():  # the second strategy's queues already dropped
            seen.add("pruned2")
        return real_tour(p, drs, avail_v, pruned2, *args)

    def solve(p, depth, n_cand, n_local, n_res, *args):
        trace = {}
        r = real_solve(p, depth, n_cand, n_local, n_res, *args, trace=trace)
        rows = p.row_valid
        hrow = p.hrow.clamp_min(0).long()
        drs = fpk._drs_panel(p, p.usage0, fpk._lendable(p, depth, n_res), n_res)
        valid = p.svalid & rows[:, None]
        if ((drs == fpk.DRS_MAX) & valid).any():
            seen.add("weight 0")
        for i in torch.nonzero(rows).flatten().tolist():
            qs = torch.nonzero(valid[i] & p.is_cq[i] & (drs[i] > 0)).flatten().tolist()
            if any(p.parent_loc[i, x] == p.parent_loc[i, y] and drs[i, x] == drs[i, y]
                   for x in qs for y in qs if x < y):
                seen.add("DRS tie")
            if p.parent_loc[i, hrow[i]] < 0:
                seen.add("rootless head")
        if (r.targets & (p.crow.long() == hrow[:, None])).any():
            seen.add("own victim")
        if ((trace["removed"] > r.targets.sum(dim=1)) & r.fits).any():
            seen.add("fill-back keeps")
        return r

    tdk.solve_fair, fpk._tournament = solve, tournament
    try:
        cycles = 0
        while not bool(state.done) and cycles < SMALL_CYCLES:
            for _, _, plain in FAIR_PREEMPT_STEPS:
                plain(ctx, state, buf)
            cycles += 1
    finally:
        tdk.solve_fair, fpk._tournament = real_solve, real_tour
    return seen


def test_fair_preempt_specs_reach_the_search_edges():
    """Guard against a vacuous sweep: the searches of the drains above
    (and of the card's twins) meet every edge the new design branches
    on."""
    seen = _search_edges(cases.fair_preempt_spec(1)) | _search_edges(cases.fair_preempt_spec(8))
    assert seen >= {"weight 0", "DRS tie", "pruned2", "own victim", "fill-back keeps",
                    "rootless head"}


# ---- the fair drain's step scan (B7) -----------------------------------------


@pytest.mark.parametrize("seed,per_team,prio_tie", [
    (2, 3, True), (2, 3, False), (4, 70, True),
])
def test_fair_drain_matches_jax_at_the_step_edges(seed, per_team, prio_tie):
    wide = per_team > 3
    spec = fair_spec(seed, workloads_per_cq=1 if wide else 6, cqs_per_team=per_team)
    jsnap, jpending, jcache, psnap, ppending, pcache, ts = _envs(spec)
    cut = {"max_cycles": WIDE_CYCLES} if wide else {}
    gate = "PrioritySortingWithinCohort"
    with jax_features.override(gate, prio_tie), port_features.override(gate, prio_tie):
        j = jax_run_drain(jsnap, jpending, jcache.flavors, timestamp_fn=ts, fair_sharing=True,
                          **cut)
        p = pd.run_drain(psnap, ppending, pcache.flavors, timestamp_fn=ts, fair_sharing=True,
                         device="cpu", **cut)
    assert _view(p) == _view(j)
    np.testing.assert_array_equal(p.final_usage, j.final_usage)
    assert p.admitted


def _step_edges(spec) -> set:
    """The edges the plain step scan meets over a drain's cycles: a
    parent whose proposals are all at or above INF (the DRS of the first
    of each level's four segment minima), and a charge on a path of three
    or more nodes (a non-root cohort between the queue and its root)."""
    cache, pending = build_cache(spec)
    snap = take_snapshot(cache)
    plan = pd.plan_drain(snap, pending, cache.flavors, max_cells=4)
    pd._route_preempt_capable(snap, plan)
    tree, paths, local, queues = pd._drain_device_inputs(snap, plan, "cpu")
    fair = pd.fair_inputs(snap, tree.max_depth, "cpu")
    ctx = tdk.DrainContext.build(tree, queues, paths, plan.n_segments, plan.n_steps,
                                 plan.max_cycles, seg_id=plan.queues_np["seg_id"], fair=fair)
    state = tdk.DrainState.initial(local, queues, plan.max_cycles)
    buf = tdk.CycleBuffers.empty(local, queues)
    seen = set()
    real_min, real_charge = tdk._segment_min, tdk._charge_paths
    calls = [0]

    def segment_min(vals, seg, num):
        out = real_min(vals, seg, num)
        calls[0] += 1
        if calls[0] % 4 == 1:  # a level's DRS minima
            got = torch.zeros(num, dtype=torch.bool)
            got[seg[seg < num - 1]] = True
            if (got[:-1] & (out[:-1] >= INF)).any():
                seen.add("no proposal below INF")
        return out

    def charge(usage, g, paths_q, cells, delta, depth):
        charged = (delta != 0).any(dim=1)
        if (charged & ((paths_q >= 0).sum(dim=1) >= 3)).any():
            seen.add("non-root cohort charged")
        return real_charge(usage, g, paths_q, cells, delta, depth)

    tdk._segment_min, tdk._charge_paths = segment_min, charge
    try:
        while not bool(state.done):
            for _, _, plain in FAIR_STEPS:
                plain(ctx, state, buf)
    finally:
        tdk._segment_min, tdk._charge_paths = real_min, real_charge
    assert tree.max_depth >= 3
    return seen


def test_fair_specs_reach_the_step_edges():
    """Guard against a vacuous sweep (fair_spec 2 and 4, as
    tests/test_torch_fair_drain.py and the card's twins drain them)."""
    seen = _step_edges(fair_spec(2)) | _step_edges(fair_spec(4))
    assert seen >= {"no proposal below INF", "non-root cohort charged"}
