"""The plain versions the two kernels redesigned for the card are held to
(the TAS drain's placement, ``drain_tas_place``, B13a; the fair-preempt
drain's step scan, ``drain_fair_preempt_phase2``, B11b) against the JAX
package at the shapes that reach the new designs' edges, exactly (int64,
tolerance 0), on the same seeded inputs:

- the TAS drain (``run_drain_tas``, device="cpu") against the JAX
  package's on ``perf.cases.tas_edge_spec``: hosts overcommitted by
  non-TAS pods (split entries totalling -1 and below), an Unconstrained
  gang that fits no single host, Preferred gangs relaxing to their
  flavor's top, two flavors of unequal depth, a gang larger than its
  flavor; a guard that the drains reach those edges;
- the leaf grouping the placement kernel reads (``tas_leaf_groups``):
  each domain's run holds exactly the leaves carrying its id, each
  parent's children are exactly the domains naming it, and a forest that
  is not nested has none;
- the fair-preempt drain (``run_drain_fair_preempt``) against the JAX
  package's on ``perf.cases.fair_preempt_edge_spec``, with
  PrioritySortingWithinCohort on and off: weight-0 queues, ties in the
  DRS, a preempter whose targets overlap an earlier eviction, a blocked
  no-reclaim head that reserves, a one-queue segment; a guard that the
  drains reach those edges;
- the second usage tree the B11b kernel keeps: bubbling a run of int64
  charges and removals up their paths gives the JAX package's usage
  tree rebuilt from the final leaf rows.
"""

import numpy as np
import pytest
import torch

from kueue_tpu import features as jax_features
from kueue_tpu._jax import jnp
from kueue_tpu.core.drain import run_drain_tas as jax_run_drain_tas
from kueue_tpu.core.snapshot import take_snapshot as jax_take_snapshot
from kueue_tpu.ops import quota as jq
from kueue_tpu_torch import features as port_features
from kueue_tpu_torch import interop
from kueue_tpu_torch.core import drain as pd
from kueue_tpu_torch.core.snapshot import take_snapshot
from kueue_tpu_torch.ops import drain_kernel as tdk
from kueue_tpu_torch.ops import quota as tq
from kueue_tpu_torch.perf import cases
from kueue_tpu_torch.perf import tas as pt
from kueue_tpu_torch.perf.cases import build_cache
from kueue_tpu_torch.perf.lockstep import FAIR_PREEMPT_STEPS, TAS_STEPS

from tests.test_torch_fair_preempt_drain import SMALL_CYCLES, both_drains
from tests.test_torch_preempt_drain import view as preempt_view
from tests.test_torch_tas import JAX
from tests.test_torch_tas_drain import view as tas_view

TREE_FIELDS = ("parent", "level_mask", "nominal", "lending_limit", "borrowing_limit")


# ---- the TAS drain's placement (B13a, drain_tas_place) ---------------------


def _tas_drains(spec):
    je, pe = pt.build_tas_env(spec, JAX), pt.build_tas_env(spec)
    jo = jax_run_drain_tas(jax_take_snapshot(je.cache), je.pending, je.cache.flavors, je.tas,
                           timestamp_fn=je.ts_fn)
    po = pd.run_drain_tas(take_snapshot(pe.cache), pe.pending, pe.cache.flavors, pe.tas,
                          timestamp_fn=pe.ts_fn, device="cpu")
    return jo, po


@pytest.mark.parametrize("seed", range(4))
def test_tas_drain_matches_jax_at_the_placement_edges(seed):
    jo, po = _tas_drains(cases.tas_edge_spec(seed))
    assert tas_view(po) == tas_view(jo)
    assert po.admitted and po.parked and not po.fallback


def _tas_inputs(spec):
    env = pt.build_tas_env(spec)
    return pd.tas_drain_inputs(take_snapshot(env.cache), env.pending, env.cache.flavors,
                               env.tas, "cpu", timestamp_fn=env.ts_fn)


def _placement_edges(spec) -> set:
    """The edges the plain placement meets over a drain's cycles: split
    entries at -1 and below -1, and what the placed gangs took."""
    seen = set()
    real = tdk._tas_split

    def spy(s, child_ok, cnt):
        keys = s[child_ok]
        if (keys == -1).any():
            seen.add("ok total -1")
        if (keys < -1).any():
            seen.add("ok total below -1")
        return real(s, child_ok, cnt)

    inp = _tas_inputs(spec)
    ctx = tdk.tas_context(inp.tree, inp.queues, inp.paths, inp.topo.free, inp.topo.seg_ids,
                          inp.theads, inp.n_domains, inp.n_steps, inp.plan.max_cycles)
    state = tdk.TASState.initial_tas(inp.local, inp.queues, inp.plan.max_cycles,
                                     inp.topo.tas_usage)
    buf = tdk.TASBuffers.empty_tas(inp.local, inp.queues, inp.topo.free.shape[0])
    if ((inp.topo.free - inp.topo.tas_usage) < 0).any():
        seen.add("negative headroom")
    tdk._tas_split = spy
    try:
        while not bool(state.done):
            for _, _, plain in TAS_STEPS:
                plain(ctx, state, buf)
    finally:
        tdk._tas_split = real
    return seen


def test_tas_edge_spec_reaches_the_edges():
    """Guard against a vacuous sweep: the negative totals reach the
    splits, and the gangs take what the spec says they take."""
    spec = cases.tas_edge_spec(0)
    assert _placement_edges(spec) >= {"negative headroom", "ok total -1", "ok total below -1"}
    po = _tas_drains(spec)[1]
    # each gang's hosts: ha-<block>-<rack>-<host> on tas-a, hb-<rack>-<host> on tas-b
    taken = {name: [values[-1] for values, _ in domains]
             for name, _, domains in pt.placements(po)}
    # Preferred 20 at the host level: over both blocks of tas-a
    assert len({host.split("-")[1] for host in taken["wl-0"]}) == 2
    # Unconstrained 6: over several hosts, none holds it
    assert len(taken["wl-2"]) > 1
    # Preferred 7 on tas-b: the take at its top, over two racks
    assert len({host.split("-")[1] for host in taken["wl-6"]}) == 2
    # Unconstrained 6 on tas-b: every host with room left
    assert len(taken["wl-7"]) >= 3
    assert "wl-4" in {wl.name for wl, _ in po.parked}  # 200 pods: larger than tas-a


@pytest.mark.parametrize("spec", ["tas_spec", "tas_scan_spec", "tas_edge_spec"])
def test_leaf_groups_are_the_domains(spec):
    inp = _tas_inputs(getattr(cases, spec)(0))
    seg = inp.topo.seg_ids.numpy()
    pm = inp.theads.parent_map.numpy()
    g = tdk.tas_leaf_groups(seg, inp.n_domains, pm, "cpu")
    order = g.leaf_order.numpy()
    assert sorted(order.tolist()) == list(range(seg.shape[1]))
    for d, n in enumerate(inp.n_domains):
        for j in range(pm.shape[1]):
            run = order[int(g.dom_beg[d, j]):int(g.dom_end[d, j])]
            assert sorted(run.tolist()) == np.flatnonzero(seg[d] == j).tolist()
        if d:
            for p in range(pm.shape[1]):
                kids = g.child_list[d, int(g.child_off[d, p]):int(g.child_off[d, p + 1])]
                assert kids.tolist() == [j for j in range(n) if max(int(pm[d, j]), 0) == p]


def test_leaf_groups_refuse_a_forest_that_is_not_nested():
    # level 1's domain 0 holds leaves of both level-0 domains
    seg = np.array([[0, 0, 1, 1], [0, 1, 1, 0]], dtype=np.int32)
    pm = np.zeros((2, 2), dtype=np.int32)
    assert tdk.tas_leaf_groups(seg, (2, 2), pm, "cpu") is None
    nested = np.array([[1, 0, 1, 0], [3, 0, 2, 1]], dtype=np.int32)
    g = tdk.tas_leaf_groups(nested, (2, 4), np.zeros((2, 4), dtype=np.int32), "cpu")
    assert g.leaf_order.tolist() == [1, 3, 2, 0]


# ---- the fair-preempt drain's step scan (B11b, drain_fair_preempt_phase2) --


@pytest.mark.parametrize("prio_tie", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_fair_preempt_drain_matches_jax_at_the_scan_edges(seed, prio_tie):
    gate = "PrioritySortingWithinCohort"
    with jax_features.override(gate, prio_tie), port_features.override(gate, prio_tie):
        jout, pout = both_drains(cases.fair_preempt_edge_spec(seed), names=True,
                                 max_cycles=SMALL_CYCLES)
    assert preempt_view(pout) == preempt_view(jout)
    assert pout.admitted and pout.preempted


def _scan_edges(spec) -> set:
    """The edges the plain step scan meets over a drain's cycles (read
    from each phase 2's inputs)."""
    cache, pending = build_cache(spec)
    snap = take_snapshot(cache)
    plan, _, tree, paths, local, queues, victims, panels, fair = pd.fair_preempt_drain_inputs(
        snap, pending, cache.flavors, "cpu")
    ctx = tdk.fair_preempt_context(tree, queues, victims, panels, paths, fair,
                                   plan.n_segments, plan.n_steps, SMALL_CYCLES, 0, True)
    state = tdk.FairPreemptState.initial_fair(local, queues, SMALL_CYCLES, victims, panels)
    buf = tdk.PreemptBuffers.empty_preempt(local, queues, victims)
    seg = queues.seg_id
    seen = set()
    cycles = 0
    while not bool(state.done) and cycles < SMALL_CYCLES:
        for name, _, plain in FAIR_PREEMPT_STEPS:
            if name == "drain_fair_preempt_phase2":
                rem = ((state.cursor < queues.qlen) & state.alive & (buf.is_fit | buf.is_pre)
                       & (queues.cq_rows >= 0))
                cq = queues.cq_rows.clamp_min(0).long()
                if (rem & (fair.weight[cq] == 0)).any():
                    seen.add("weight 0")
                if (rem & buf.is_pre & ~buf.psuccess & queues.no_reclaim).any():
                    seen.add("reserve")
                pre = torch.nonzero(rem & buf.is_pre & buf.psuccess).flatten().tolist()
                if any(seg[x] == seg[y] and bool((buf.targets[x] & buf.targets[y]).any())
                       for x in pre for y in pre if x < y):
                    seen.add("overlapping targets")
                counts = torch.bincount(seg[rem].long(), minlength=plan.n_segments)
                if (counts == 1).any():
                    seen.add("one-queue segment")
            plain(ctx, state, buf)
        cycles += 1
    return seen


def test_fair_preempt_edge_spec_reaches_the_edges():
    """Guard against a vacuous sweep."""
    seen = set()
    for seed in (0, 1):
        seen |= _scan_edges(cases.fair_preempt_edge_spec(seed))
    assert seen >= {"weight 0", "reserve", "overlapping targets", "one-queue segment"}
    _, pout = both_drains(cases.fair_preempt_edge_spec(0), names=True, max_cycles=SMALL_CYCLES)
    ovl = [e for e in pout.evictions if e.victim.name == "ovl-hog-v"]
    assert len(ovl) == 1  # the second reclaimer's overlapping targets were skipped


def _paths_of(parent: np.ndarray, max_depth: int) -> np.ndarray:
    n = parent.shape[0]
    paths = np.full((n, max_depth + 1), -1, dtype=np.int32)
    for i in range(n):
        node, d = i, 0
        while node >= 0:
            paths[i, d] = node
            node, d = int(parent[node]), d + 1
    return paths


@pytest.mark.parametrize("seed,depth", [(0, 1), (1, 3), (2, 5)])
def test_bubbled_tree_equals_the_rebuilt_one(seed, depth):
    """The B11b kernel keeps its fit tree by bubbling each charge, each
    committed victim's removal and each own-target removal and put-back
    up its node's path (int64, the guaranteed max formula); after any run
    of them the tree equals the JAX package's usage_tree of the final
    leaf rows."""
    f = cases.quota_forest(seed, depth=depth, big=60, n_small=8, fr=5)
    rng = np.random.default_rng(seed)
    tree = interop.quota_tree(f, "cpu")
    _, g = tq.subtree_quota(tree)
    leaf = torch.as_tensor(f["local_usage"]).clone()
    usage = tq.usage_tree_plain(tree, g, leaf)
    paths = torch.as_tensor(_paths_of(f["parent"], f["max_depth"]))
    n, fr = leaf.shape
    for _ in range(200):
        node = int(rng.integers(0, n))
        cell = int(rng.integers(0, fr))
        delta = int(rng.integers(-(1 << 34), 1 << 34))
        for sign in ((1,) if rng.random() < 0.7 else (1, -1)):  # some put back at once
            leaf[node, cell] += sign * delta
            tdk._charge_paths(usage, g, paths[node:node + 1], torch.tensor([[cell]]),
                              torch.tensor([[sign * delta]]), f["max_depth"])
    jtree = jq.QuotaTree(**{k: jnp.asarray(f[k]) for k in TREE_FIELDS})
    _, jg = jq.subtree_quota(jtree)
    want = np.asarray(jq.usage_tree(jtree, jg, jnp.asarray(leaf.numpy())))
    np.testing.assert_array_equal(usage.numpy(), want)
