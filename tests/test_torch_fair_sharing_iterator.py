"""The fair-sharing admission iterator (core/fair_sharing_iterator.py,
host only) in both packages, exactly:

- ``path_drs`` against the JAX module's and against the port's full-tree
  DRS (``Snapshot.all_node_drs`` with the vector added) on the depth-3
  weighted cohort forests of ``perf.cases.fair_preempt_spec``;
- the pop order of ``fair_sharing_iter`` against the JAX module's on
  the same pending heads, with every pop's usage added to the snapshot
  before the next pop (the interleaving that makes the order lazy), with
  and without the PrioritySortingWithinCohort tiebreak.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from kueue_tpu.core.fair_sharing_iterator import fair_sharing_iter as jax_iter
from kueue_tpu.core.fair_sharing_iterator import path_drs as jax_path_drs
from kueue_tpu.core.flavor_assigner import FlavorAssigner as JaxAssigner
from kueue_tpu.core.snapshot import take_snapshot as jax_take_snapshot
from kueue_tpu.ops.quota_np import potential_available_all_np as jax_pot
from kueue_tpu_torch.core.fair_sharing_iterator import fair_sharing_iter, path_drs
from kueue_tpu_torch.core.flavor_assigner import FlavorAssigner
from kueue_tpu_torch.core.snapshot import take_snapshot
from kueue_tpu_torch.ops.quota_np import potential_available_all_np
from kueue_tpu_torch.perf import cases

from tests.test_drain import build_preempt_env
from tests.test_torch_scheduler import jax_spec


def _both(seed):
    """(JAX snapshot, cache, pending), (port snapshot, cache, pending) of
    perf.cases.fair_preempt_spec(seed): weighted depth-3 cohorts with
    admitted victims, so some nodes borrow."""
    spec = cases.fair_preempt_spec(seed)
    _, mgr, jcache, _ = build_preempt_env(jax_spec(spec))
    jpending = [(wl, cq) for cq, pq in mgr.cluster_queues.items() for wl in pq.snapshot_sorted()]
    pcache, ppending = cases.build_cache(spec)
    by_name = {wl.name: (wl, cq) for wl, cq in ppending}
    ppending = [by_name[wl.name] for wl, _ in jpending]
    return ((jax_take_snapshot(jcache), jcache, jpending),
            (take_snapshot(pcache), pcache, ppending))


def _pot(snap, fn):
    return fn(snap.flat.parent, snap.flat.level_masks(), snap.subtree, snap.guaranteed,
              snap.borrowing_limit)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_path_drs_matches_jax_and_the_full_tree(seed):
    (jsnap, _, _), (psnap, _, _) = _both(seed)
    assert [(f.flavor, f.resource) for f in jsnap.fr_list] == [
        (f.flavor, f.resource) for f in psnap.fr_list
    ]
    rng = np.random.default_rng(seed)
    jpot, ppot = _pot(jsnap, jax_pot), _pot(psnap, potential_available_all_np)
    checked = 0
    for name in sorted(psnap.cq_models):
        row = psnap.row(name)
        assert row == jsnap.row(name)
        vec = np.zeros(len(psnap.fr_list), dtype=np.int64)
        for j in rng.choice(len(vec), size=min(2, len(vec)), replace=False):
            vec[j] = int(rng.integers(0, 12000))
        chain = path_drs(psnap, psnap.usage(), ppot, row, vec)
        assert chain == jax_path_drs(jsnap, jsnap.usage(), jpot, row, vec)
        psnap.add_usage(name, vec)
        full = psnap.all_node_drs()
        psnap.remove_usage(name, vec)
        for node, dws in chain:
            assert dws == int(full[node]), (name, node)
        checked += len(chain)
    assert checked > len(psnap.cq_models)  # paths above the leaves were read


def _entries(snap, cache, pending, assigner_cls):
    """The first pending workload of every ClusterQueue as an entry with
    its fair-sharing flavor assignment."""
    assigner = assigner_cls(snap, cache.flavors, enable_fair_sharing=True)
    out, seen = [], set()
    for wl, cq in pending:
        if cq in seen:
            continue
        seen.add(cq)
        out.append(SimpleNamespace(workload=wl, cq_name=cq, assignment=assigner.assign(wl, cq)))
    return out


def _pop_order(snap, entries, it, prio_tie: bool):
    def tie(e):
        key = (-e.workload.priority,) if prio_tie else ()
        return key + (int(e.workload.creation_time * 1e9),)

    order = []
    for e in it(entries, snap, tie):
        order.append(e.workload.name)
        if e.assignment is not None:
            # the admission the cycle makes before the next pop
            snap.add_usage(e.cq_name, snap.vector_of(e.assignment.usage))
    return order


@pytest.mark.parametrize("seed,prio_tie", [(0, True), (1, False), (2, True), (3, True)])
def test_pop_order_matches_jax(seed, prio_tie):
    (jsnap, jcache, jpending), (psnap, pcache, ppending) = _both(seed)
    jent = _entries(jsnap, jcache, jpending, JaxAssigner)
    pent = _entries(psnap, pcache, ppending, FlavorAssigner)
    order = _pop_order(psnap, pent, fair_sharing_iter, prio_tie)
    assert order == _pop_order(jsnap, jent, jax_iter, prio_tie)
    assert sorted(order) == sorted(e.workload.name for e in pent)
    assert order != [e.workload.name for e in pent]  # the tournament reordered them
