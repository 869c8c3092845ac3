"""The preempt drain (kernel family B10) in both packages: the same
cluster, victims and backlog built in each, drained by kueue_tpu's
run_drain_preempt (JAX on the CPU) and by kueue_tpu_torch's
run_drain_preempt(device="cpu") (the plain torch versions of the
kernels). Exact agreement (tolerance 0) of the admitted workloads with
their flavors and cycles, the evictions with their cycle, evictor and
reason, parked, fallback, truncated, overflowed panels and cycles, on
the JAX test suite's preemption shapes (tests/test_drain.py: within-CQ
preemption, cross-CQ cohort reclaim with borrowWithinCohort
thresholds, multiple resource groups, flavor fungibility, multi-podset
workloads), a forced (8, 64) panel ladder that escalates, and a 40-CQ
cut of bench.py's contended cluster. The full-width constants of
perf/contended.py are pinned to the JAX package here too.
"""

import numpy as np
import pytest

from kueue_tpu import models as jax_models
from kueue_tpu.core import cache as jax_cache
from kueue_tpu.core import preemption as jax_preemption
from kueue_tpu.core import queue_manager as jax_queue_manager
from kueue_tpu.core import scheduler as jax_scheduler
from kueue_tpu.core import workload_info as jax_workload_info
from kueue_tpu.core.drain import PanelTuner as JaxPanelTuner
from kueue_tpu.core.drain import run_drain_preempt as jax_run_drain_preempt
from kueue_tpu.core.queue_manager import queue_order_timestamp
from kueue_tpu.core.snapshot import take_snapshot as jax_take_snapshot
from kueue_tpu.models import cluster_queue as jax_cluster_queue
from kueue_tpu.models import constants as jax_constants
from kueue_tpu.models import workload as jax_workload
from kueue_tpu.utils import clock as jax_clock
from kueue_tpu_torch.core.drain import PanelTuner, run_drain_for_scope, run_drain_preempt
from kueue_tpu_torch.core.snapshot import take_snapshot
from kueue_tpu_torch.perf import contended
from kueue_tpu_torch.perf import cases
from kueue_tpu_torch.perf.cases import build_cache

from tests.test_drain import (
    build_preempt_env,
    cohort_reclaim_spec,
    multi_rg_preempt_spec,
    preempt_spec,
)
from tests.test_torch_scheduler import jax_spec, port_spec


def jax_api():
    return contended.models_api(
        jax_models, jax_constants, jax_cluster_queue, jax_workload, jax_cache,
        jax_queue_manager, jax_workload_info, jax_clock, jax_preemption, jax_scheduler,
    )


def view(outcome):
    """A PreemptDrainOutcome (either package's) as comparable data."""
    return {
        "admitted": sorted(
            (wl.name, cq, repr(sorted(flavors.items())), cyc)
            for wl, cq, flavors, cyc in outcome.admitted
        ),
        "parked": sorted((wl.name, cq) for wl, cq in outcome.parked),
        "fallback": sorted((wl.name, cq) for wl, cq in outcome.fallback),
        "evictions": sorted(
            (e.victim.name, e.victim_cq, e.cycle, e.by_cq,
             e.by_workload.name if e.by_workload is not None else None, e.reason)
            for e in outcome.evictions
        ),
        "preempted": [(wl.name, cq, cyc) for wl, cq, cyc in outcome.preempted],
        "cycles": outcome.cycles,
        "truncated": outcome.truncated,
    }


def both_drains(spec, names=False, **kw):
    """(JAX outcome, port outcome, JAX tuner, port tuner) of one spec
    (JAX model objects; ``names``: perf.cases' policy names), each
    package with a fresh PanelTuner."""
    pspec = spec if names else port_spec(spec)
    _, mgr, jcache, _ = build_preempt_env(jax_spec(spec) if names else spec)
    jpending = [
        (wl, cq) for cq, pq in mgr.cluster_queues.items() for wl in pq.snapshot_sorted()
    ]
    ts = lambda wl: queue_order_timestamp(wl, mgr._ts_policy)  # noqa: E731
    jt, pt = JaxPanelTuner(), PanelTuner()
    jout = jax_run_drain_preempt(
        jax_take_snapshot(jcache), jpending, jcache.flavors, timestamp_fn=ts,
        panel_tuner=jt, **kw,
    )
    pcache, ppending = build_cache(pspec)
    by_name = {wl.name: (wl, cq) for wl, cq in ppending}
    ppending = [by_name[wl.name] for wl, _ in jpending]
    pout = run_drain_preempt(
        take_snapshot(pcache), ppending, pcache.flavors, timestamp_fn=ts,
        panel_tuner=pt, device="cpu", **kw,
    )
    return jout, pout, jt, pt


def _multi_rg_fungible(seed):
    """tests/test_drain.py TestPreemptDrainFungibility's spec."""
    from kueue_tpu.models import FlavorFungibility
    from kueue_tpu.models.constants import FlavorFungibilityPolicy as FFP

    rng = np.random.default_rng(1000 + seed)
    spec = multi_rg_preempt_spec(seed)
    for cq in spec["cqs"]:
        cq["fungibility"] = FlavorFungibility(
            when_can_borrow=[FFP.BORROW, FFP.TRY_NEXT_FLAVOR][int(rng.integers(0, 2))],
            when_can_preempt=[FFP.TRY_NEXT_FLAVOR, FFP.PREEMPT][int(rng.integers(0, 2))],
        )
    return spec


def _multi_podset(seed):
    """tests/test_drain.py TestPreemptDrainMultiPodset's spec."""
    rng = np.random.default_rng(seed)
    spec = multi_rg_preempt_spec(seed, n_cqs=3)
    for w in spec["workloads"]:
        if rng.random() < 0.6:
            w["pod_sets"].append({
                "name": "worker",
                "count": int(rng.integers(1, 3)),
                "requests": {"cpu": str(int(rng.integers(1, 4)))},
            })
    return spec


SHAPES = {
    "within_cq": preempt_spec,
    "cohort_reclaim": cohort_reclaim_spec,
    "multi_rg": multi_rg_preempt_spec,
    "fungibility": _multi_rg_fungible,
    "multi_podset": _multi_podset,
}


@pytest.mark.parametrize("shape,seed", [
    ("within_cq", 1), ("within_cq", 3),
    ("cohort_reclaim", 1), ("cohort_reclaim", 2), ("cohort_reclaim", 4),
    ("multi_rg", 1), ("multi_rg", 5),
    ("fungibility", 2),
    ("multi_podset", 0), ("multi_podset", 3),
])
def test_preempt_drain_matches_jax(shape, seed):
    jout, pout, _, _ = both_drains(SHAPES[shape](seed), search_width=32)
    assert view(pout) == view(jout)
    assert pout.admitted and pout.preempted


@pytest.mark.parametrize("seed", [2, 6])
def test_depth3_multi_podset_case_matches_jax(seed):
    """perf.cases.preempt_spec: a depth-3 cohort forest, two resource
    groups, up to three podsets a workload, every preemption policy,
    admitted victims (chip_smoke.py's small case)."""
    jout, pout, _, _ = both_drains(cases.preempt_spec(seed), names=True, search_width=32)
    assert view(pout) == view(jout)
    assert pout.admitted and pout.preempted


def test_forced_panels_escalate_to_the_same_decisions(monkeypatch):
    """A forced (8, 64) schedule on a 20-CQ cut of the contended
    cluster: the narrow tier's searches overflow and miss, the kernel's
    flag sends the drain to the exact width, and both packages decide
    the same."""
    from kueue_tpu_torch.ops import drain_kernel as dk

    flags = []
    real = dk._solve_drain_preempt_packed

    def spy(*a, **k):
        flat = real(*a, **k)
        flags.append((k["search_width"], int(flat[-2])))
        return flat

    monkeypatch.setattr(dk, "_solve_drain_preempt_packed", spy)
    env = contended.build_contended(np.random.default_rng(contended.SEED), n_cq=20,
                                    api=jax_api())
    penv = contended.build_contended(np.random.default_rng(contended.SEED), n_cq=20)
    kw = dict(search_width=64, panel_widths=(8, 64))
    jout = jax_run_drain_preempt(jax_take_snapshot(env.cache), env.pending, env.cache.flavors,
                                 timestamp_fn=env.ts_fn, **kw)
    pout = run_drain_preempt(take_snapshot(penv.cache), penv.pending, penv.cache.flavors,
                             timestamp_fn=penv.ts_fn, device="cpu", **kw)
    assert flags == [(8, 1), (64, 0)]
    assert view(pout) == view(jout)
    assert pout.preempted


def test_contended_cut_matches_jax():
    """A 40-ClusterQueue cut (4 cohorts) of bench.py's contended cluster
    at search_width=64 with a fresh tuner: same decisions, same
    escalations."""
    env = contended.build_contended(np.random.default_rng(contended.SEED), n_cq=40,
                                    api=jax_api())
    penv = contended.build_contended(np.random.default_rng(contended.SEED), n_cq=40)
    jt, pt = JaxPanelTuner(), PanelTuner()
    jout = jax_run_drain_preempt(jax_take_snapshot(env.cache), env.pending, env.cache.flavors,
                                 timestamp_fn=env.ts_fn, search_width=64, panel_tuner=jt)
    pout = run_drain_preempt(take_snapshot(penv.cache), penv.pending, penv.cache.flavors,
                             timestamp_fn=penv.ts_fn, search_width=64, panel_tuner=pt,
                             device="cpu")
    assert view(pout) == view(jout)
    assert contended.drain_summary(pout)["hoarder_evictions"] > 0
    assert (pt.escalations, pt.solves, pt._narrow) == (jt.escalations, jt.solves, jt._narrow)


def test_jax_contended_drain_gives_the_constants():
    """CONTENDED_EXPECT and CONTENDED_PANELS are the JAX package's at
    full width (1000 ClusterQueues, 6000 victims, 5000 pending)."""
    env = contended.build_contended(np.random.default_rng(contended.SEED), api=jax_api())
    tuner = JaxPanelTuner()
    widths = tuner.widths_for(contended.SEARCH_WIDTH)
    out = jax_run_drain_preempt(jax_take_snapshot(env.cache), env.pending, env.cache.flavors,
                                timestamp_fn=env.ts_fn, search_width=contended.SEARCH_WIDTH,
                                panel_tuner=tuner)
    assert contended.drain_summary(out) == contended.CONTENDED_EXPECT
    assert {"widths": list(widths), "escalations": tuner.escalations,
            "next_narrow": tuner._narrow[contended.SEARCH_WIDTH]} == contended.CONTENDED_PANELS


def test_run_drain_for_scope_preempt_runs():
    spec = preempt_spec(0)
    _, mgr, jcache, _ = build_preempt_env(spec)
    pcache, ppending = build_cache(port_spec(spec))
    out = run_drain_for_scope("preempt", take_snapshot(pcache), ppending, pcache.flavors,
                              device="cpu")
    direct = run_drain_preempt(take_snapshot(pcache), ppending, pcache.flavors, device="cpu")
    assert view(out) == view(direct)
    assert out.admitted



def two_card_mesh():
    """A mesh over cuda:0 and cuda:1 (refused: one card per machine)."""
    import torch

    from kueue_tpu_torch.parallel.sharded_solver import Mesh

    devices = np.empty(2, dtype=object)
    devices[:] = [torch.device("cuda", 0), torch.device("cuda", 1)]
    return Mesh(devices, ("wl",))

def test_unported_options_raise():
    pcache, ppending = build_cache(port_spec(preempt_spec(0)))

    # a mesh over one device runs (tests/test_torch_parallel.py); one
    # over two cards is refused
    with pytest.raises(NotImplementedError):
        run_drain_preempt(take_snapshot(pcache), ppending, pcache.flavors, mesh=two_card_mesh(),
                          device="cpu")
    # a non-default admission policy is ported (tests/test_torch_policy.py
    # holds PREMA's victim order to the JAX package's); first-fit named
    # explicitly decides as no policy
    from kueue_tpu_torch.policy import resolve_policy

    first_fit = run_drain_preempt(take_snapshot(pcache), ppending, pcache.flavors,
                                  policy=resolve_policy("first-fit"), device="cpu")
    none = run_drain_preempt(take_snapshot(pcache), ppending, pcache.flavors, device="cpu")
    assert view(first_fit) == view(none)
