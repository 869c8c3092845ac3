"""The drain's scope routing and the round-chaining contract of
kueue_tpu_torch against kueue_tpu's, on the same inputs (exact):

- ``classify_drain_scope`` over plain, preempt-capable, fair and TAS
  backlogs (kind and the backlog it keeps);
- ``launch_drain_for_scope``: a launch for the plain scope equal to
  ``run_drain`` and to the JAX package's, None for every other scope,
  as the JAX package returns;
- ``speculative_snapshot``, ``drain_inputs_match``, ``pending_matches``
  and ``outcome_signature``;
- the refusals: the preempt, fair-preempt and TAS drains raise
  NotImplementedError.
"""

import numpy as np
import pytest

from kueue_tpu.core import drain as jd
from kueue_tpu.core import pipeline as jp
from kueue_tpu_torch.core import drain as pd
from kueue_tpu_torch.core import pipeline as pp
from kueue_tpu_torch.perf.cases import mixed_spec

from tests.test_solver_path import random_spec
from tests.test_torch_drain import _both, _view


def _spec(kind, seed):
    if kind == "random":
        return random_spec(seed, workloads_per_cq=4)
    return mixed_spec(seed, workloads_per_cq=3)


@pytest.mark.parametrize("kind,seed", [("random", 0), ("random", 3), ("mixed", 1), ("mixed", 2)])
@pytest.mark.parametrize("fair", [False, True])
@pytest.mark.parametrize("tas", [False, True])
def test_classify_drain_scope_matches_jax(kind, seed, fair, tas):
    jsnap, jpending, _, psnap, ppending, _, _ = _both(_spec(kind, seed))
    tas_flavors = {"fa", "gpu-a"} if tas else None
    jk, jp2 = jd.classify_drain_scope(jsnap, jpending, tas_flavors, fair)
    pk, pp2 = pd.classify_drain_scope(psnap, ppending, tas_flavors, fair)
    assert pk == jk
    assert [(w.name, c) for w, c in pp2] == [(w.name, c) for w, c in jp2]


def test_classify_covers_every_kind():
    kinds = set()
    for kind, seed in [("random", 0), ("mixed", 1)]:
        _, _, _, psnap, ppending, _, _ = _both(_spec(kind, seed))
        for fair in (False, True):
            for tas in (None, {"fa", "gpu-a"}):
                kinds.add(pd.classify_drain_scope(psnap, ppending, tas, fair)[0])
    assert kinds == {"plain", "fair", "preempt", "fair_preempt", "tas"}


@pytest.mark.parametrize("seed", range(3))
def test_launch_drain_for_scope_matches_jax(seed):
    jsnap, jpending, jcache, psnap, ppending, pcache, ts = _both(random_spec(seed, workloads_per_cq=6))
    for kind in ("fair", "preempt", "fair_preempt", "tas"):
        assert jd.launch_drain_for_scope(kind, jsnap, jpending, jcache.flavors) is None
        assert pd.launch_drain_for_scope(kind, psnap, ppending, pcache.flavors, device="cpu") is None
    j = jd.launch_drain_for_scope("plain", jsnap, jpending, jcache.flavors,
                                  timestamp_fn=ts, max_cycles=3)
    p = pd.launch_drain_for_scope("plain", psnap, ppending, pcache.flavors,
                                  timestamp_fn=ts, max_cycles=3, device="cpu")
    assert p.max_cycles == j.max_cycles == 3
    assert [w.name for w, _ in p.pending] == [w.name for w, _ in j.pending]
    jo, po = j.fetch(), p.fetch()
    assert _view(po) == _view(jo)
    np.testing.assert_array_equal(po.final_usage, jo.final_usage)
    assert jp.outcome_signature(jo) == pp.outcome_signature(po)
    full = pd.run_drain(psnap, ppending, pcache.flavors, timestamp_fn=ts, max_cycles=3,
                        device="cpu")
    assert _view(full) == _view(po)


def test_speculation_contract_matches_jax():
    jsnap, jpending, jcache, psnap, ppending, pcache, ts = _both(random_spec(4, workloads_per_cq=6))
    jo = jd.run_drain(jsnap, jpending, jcache.flavors, timestamp_fn=ts, max_cycles=2)
    po = pd.run_drain(psnap, ppending, pcache.flavors, timestamp_fn=ts, max_cycles=2,
                      device="cpu")
    assert pp.outcome_signature(po) == jp.outcome_signature(jo)
    assert po.undecided and jo.undecided

    jspec = jp.speculative_snapshot(jsnap, jo.final_usage)
    pspec = pp.speculative_snapshot(psnap, po.final_usage)
    np.testing.assert_array_equal(pspec.local_usage, jspec.local_usage)
    assert pspec.local_usage is not po.final_usage
    assert pspec._usage_version == psnap._usage_version + 1
    assert (pspec._usage_cache, pspec._avail_cache, pspec._drs_cache, pspec._tree_usage) == (
        None, None, None, None)
    # the real post-apply state equals the speculation: both commit
    preal = pp.speculative_snapshot(psnap, po.final_usage.copy())
    assert pp.drain_inputs_match(pspec, preal) and jp.drain_inputs_match(
        jspec, jp.speculative_snapshot(jsnap, jo.final_usage.copy()))
    # one usage cell moved under the speculation: both refuse
    moved = po.final_usage.copy()
    moved[0, 0] += 1
    assert not pp.drain_inputs_match(pspec, pp.speculative_snapshot(psnap, moved))
    jmoved = jo.final_usage.copy()
    jmoved[0, 0] += 1
    assert not jp.drain_inputs_match(jspec, jp.speculative_snapshot(jsnap, jmoved))

    und = po.undecided
    assert pp.pending_matches(und, list(und))
    assert not pp.pending_matches(und, und[:-1])
    by_cq = {}
    for w, c in und:
        by_cq.setdefault(c, []).append((w, c))
    cq = next(c for c, items in by_cq.items() if len(items) > 1)
    swapped = [x for c, items in by_cq.items() if c != cq for x in items]
    swapped += list(reversed(by_cq[cq]))
    assert not pp.pending_matches(und, swapped)  # order within a ClusterQueue matters
    regrouped = [x for c in sorted(by_cq, reverse=True) for x in by_cq[c]]
    assert pp.pending_matches(und, regrouped)  # order across them does not
    jund = jo.undecided
    assert jp.pending_matches(jund, jund[:-1]) == pp.pending_matches(und, und[:-1])


def test_unported_scopes_are_refused():
    _, _, _, psnap, ppending, pcache, _ = _both(mixed_spec(1, workloads_per_cq=2))
    for kind in ("preempt", "fair_preempt", "tas"):
        with pytest.raises(NotImplementedError, match=kind):
            pd.run_drain_for_scope(kind, psnap, ppending, pcache.flavors, device="cpu")
