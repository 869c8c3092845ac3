"""The slice end to end: the same cluster and backlog built in both
packages, drained by kueue_tpu's run_drain (device path, JAX on the CPU)
and by kueue_tpu_torch's run_drain(device="cpu") (the plain torch
versions of the four kernels). Exact agreement (tolerance 0) of the
admitted workloads with their flavors and admission cycle, parked,
fallback, cycles, truncated and the final leaf usage, and of the
encoded snapshot and the plan tensors field by field.

The headline (50k x 1k) checks are in tests/test_torch_headline.py.
"""

import copy

import numpy as np
import pytest

from kueue_tpu.core.drain import plan_drain as jax_plan_drain
from kueue_tpu.core.drain import run_drain as jax_run_drain
from kueue_tpu.core.encode import encode_snapshot as jax_encode
from kueue_tpu.core.queue_manager import queue_order_timestamp
from kueue_tpu.core.snapshot import take_snapshot as jax_take_snapshot
from kueue_tpu.models import FlavorFungibility, FlavorFungibilityPolicy
from kueue_tpu.models.cluster_queue import Preemption
from kueue_tpu.models.constants import ReclaimWithinCohortPolicy
from kueue_tpu_torch.core.drain import plan_drain as port_plan_drain
from kueue_tpu_torch.core.drain import run_drain as port_run_drain
from kueue_tpu_torch.core.encode import encode_snapshot as port_encode
from kueue_tpu_torch.core.snapshot import take_snapshot as port_take_snapshot
from kueue_tpu_torch.perf.cases import build_cache, mixed_spec

from tests.test_drain import multi_podset_spec
from tests.test_solver_path import build_env, random_spec

__all__ = ["jax_env_of", "mixed_spec"]


def jax_env_of(spec):
    """The spec in tests.test_solver_path.build_env's form: the policy
    names of mixed_spec become the JAX package's model objects."""
    out = copy.deepcopy(spec)
    for cq in out["cqs"]:
        f = cq.pop("fungibility", None)
        if isinstance(f, tuple):
            cq["fungibility"] = FlavorFungibility(
                when_can_borrow=FlavorFungibilityPolicy[f[0]],
                when_can_preempt=FlavorFungibilityPolicy[f[1]],
            )
        r = cq.pop("reclaim", None)
        if r is not None:
            cq["preemption"] = Preemption(
                reclaim_within_cohort=ReclaimWithinCohortPolicy[r]
            )
    return out


def _both(spec, jax_env=None):
    """(jax snapshot, jax pending, jax cache, port snapshot, port
    pending, port cache, timestamp_fn): the port's pending list follows
    the JAX QueueManager's heap order name by name. ``jax_env`` turns
    the spec into build_env's form (``jax_env_of`` by default)."""
    _, mgr, jcache, _ = build_env((jax_env or jax_env_of)(spec), use_solver=False)
    jpending = [
        (wl, cq) for cq, pq in mgr.cluster_queues.items() for wl in pq.snapshot_sorted()
    ]
    pcache, ppending = build_cache(spec)
    by_name = {wl.name: (wl, cq) for wl, cq in ppending}
    ppending = [by_name[wl.name] for wl, _ in jpending]
    assert [cq for _, cq in ppending] == [cq for _, cq in jpending]
    ts = lambda wl: queue_order_timestamp(wl, mgr._ts_policy)  # noqa: E731
    return (jax_take_snapshot(jcache), jpending, jcache,
            port_take_snapshot(pcache), ppending, pcache, ts)


def _view(outcome):
    return {
        "admitted": sorted(
            (wl.name, cq, repr(sorted(flavors.items())), cycle)
            for wl, cq, flavors, cycle in outcome.admitted
        ),
        "parked": sorted((wl.name, cq) for wl, cq in outcome.parked),
        "fallback": sorted((wl.name, cq) for wl, cq in outcome.fallback),
        "undecided": sorted((wl.name, cq) for wl, cq in outcome.undecided),
        "cycles": outcome.cycles,
        "truncated": outcome.truncated,
    }


SPECS = (
    [("random", s) for s in range(6)]
    + [("multi_podset", s) for s in range(4)]
    + [("mixed", s) for s in range(4)]
)


def _spec(kind, seed):
    if kind == "random":
        return random_spec(seed, workloads_per_cq=8)
    if kind == "multi_podset":
        return multi_podset_spec(seed)
    return mixed_spec(seed, workloads_per_cq=4)


@pytest.mark.parametrize("kind,seed", SPECS)
def test_drain_matches_jax(kind, seed):
    jsnap, jpending, jcache, psnap, ppending, pcache, ts = _both(_spec(kind, seed))
    j = jax_run_drain(jsnap, jpending, jcache.flavors, timestamp_fn=ts)
    p = port_run_drain(psnap, ppending, pcache.flavors, timestamp_fn=ts, device="cpu")
    assert _view(p) == _view(j)
    np.testing.assert_array_equal(p.final_usage, j.final_usage)
    assert j.cycles > 0 and j.admitted


@pytest.mark.parametrize("kind,seed", [("random", 1), ("multi_podset", 2), ("mixed", 3)])
def test_encoding_and_plan_match_jax(kind, seed):
    jsnap, jpending, jcache, psnap, ppending, pcache, ts = _both(_spec(kind, seed))
    je, pe = jax_encode(jsnap), port_encode(psnap)
    assert pe.cq_names == je.cq_names
    assert pe.cohort_names == je.cohort_names
    assert [(f.flavor, f.resource) for f in pe.fr_list] == [
        (f.flavor, f.resource) for f in je.fr_list]
    for name in ("parent", "level_mask", "nominal", "lending_limit",
                 "borrowing_limit", "local_usage", "weight_milli"):
        a, b = getattr(pe, name), getattr(je, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    jp = jax_plan_drain(jsnap, jpending, jcache.flavors, timestamp_fn=ts)
    pp = port_plan_drain(psnap, ppending, pcache.flavors, timestamp_fn=ts)
    assert set(pp.queues_np) == set(jp.queues_np)
    for name, b in jp.queues_np.items():
        a = pp.queues_np[name]
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (pp.n_segments, pp.n_steps, pp.max_cycles) == (
        jp.n_segments, jp.n_steps, jp.max_cycles)
    assert pp.cq_order == jp.cq_order
    assert pp.fallback == jp.fallback
