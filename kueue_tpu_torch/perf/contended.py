"""The contended preemption cluster (port of bench.py's
``contended_drain_bench`` builder) and what both preemption paths
decide on it.

1000 ClusterQueues in 100 cohorts of 10, one ``default`` flavor with 16
cpu of nominal quota each. In every cohort five "hoarders" hold eight
admitted 3-cpu workloads (24 > 16: they borrow from the cohort) and
never preempt; five "reclaimers" hold four admitted 2-cpu workloads and
queue ten higher-priority workloads that can only start by reclaiming
the hoarders' borrowed capacity or preempting their own victims:
withinClusterQueue LowerPriority, reclaimWithinCohort Any (odd index)
or LowerPriority (even), borrowWithinCohort LowerPriority with
maxPriorityThreshold 60 on every third. That is 6000 admitted victims
and 5000 pending workloads. The RNG draws happen in the order bench.py
makes them, so a seed gives the same cluster in both packages
(bench.py's ``contended`` stage uses ``np.random.default_rng(1)``).

``build_contended(rng, api=...)`` builds it with either package's
classes (``port_api()`` for this one; the tests pass the JAX package's
through ``models_api``), so this module imports nothing of the JAX
package. ``drain_summary`` and ``cycle_summary`` reduce a run of the
preempt drain and of the Scheduler to the constants below, which the
JAX package gives on the CPU (tests/test_torch_preempt_drain.py and
tests/test_torch_preempt.py hold it to them) and chip_smoke.py holds
the port to on the card.
"""

from __future__ import annotations

import hashlib
import json
from types import SimpleNamespace
from typing import List

import numpy as np

N_CQ = 1000
COHORT_SIZE = 10
HOARDER_VICTIMS, RECLAIMER_VICTIMS, WL_PER_RECLAIMER = 8, 4, 10
SEED = 1  # bench.py's contended stage
SEARCH_WIDTH = 64  # bench.py's run_drain_preempt(search_width=64)
CYCLE_CYCLES = 12  # Scheduler cycles the cycle constants cover


def models_api(models, constants, cluster_queue, workload, cache, queue_manager,
               workload_info, clock, preemption, scheduler) -> SimpleNamespace:
    """The classes ``build_contended`` and ``build_scheduler`` need, from
    one package's modules (``models``, ``models.constants``,
    ``models.cluster_queue``, ``models.workload``, ``core.cache``,
    ``core.queue_manager``, ``core.workload_info``, ``utils.clock``,
    ``core.preemption``, ``core.scheduler``)."""
    return SimpleNamespace(
        ClusterQueue=models.ClusterQueue, FlavorQuotas=models.FlavorQuotas,
        LocalQueue=models.LocalQueue, Preemption=models.Preemption,
        ResourceFlavor=models.ResourceFlavor, Workload=models.Workload,
        WorkloadConditionType=models.WorkloadConditionType,
        BorrowWithinCohort=cluster_queue.BorrowWithinCohort,
        ResourceGroup=cluster_queue.ResourceGroup,
        BorrowWithinCohortPolicy=constants.BorrowWithinCohortPolicy,
        PreemptionPolicy=constants.PreemptionPolicy,
        ReclaimWithinCohortPolicy=constants.ReclaimWithinCohortPolicy,
        PodSet=workload.PodSet, Cache=cache.Cache,
        QueueManager=queue_manager.QueueManager,
        queue_order_timestamp=queue_manager.queue_order_timestamp,
        make_admission=workload_info.make_admission, FakeClock=clock.FakeClock,
        Preemptor=preemption.Preemptor, Scheduler=scheduler.Scheduler,
    )


def port_api() -> SimpleNamespace:
    from kueue_tpu_torch import models
    from kueue_tpu_torch.core import cache, preemption, queue_manager, scheduler, workload_info
    from kueue_tpu_torch.models import cluster_queue, constants, workload
    from kueue_tpu_torch.utils import clock

    return models_api(models, constants, cluster_queue, workload, cache, queue_manager,
                      workload_info, clock, preemption, scheduler)


def build_contended(rng: np.random.Generator, n_cq: int = N_CQ, api=None) -> SimpleNamespace:
    """The contended cluster: ``cache`` (victims admitted), ``mgr`` (the
    QueueManager with the pending workloads queued), ``clock``,
    ``pending`` as (workload, cq name) in per-CQ heap order, and
    ``ts_fn``, the queue-order timestamp the drain sorts by."""
    a = api or port_api()
    clock = a.FakeClock(0.0)
    cache = a.Cache()
    mgr = a.QueueManager(clock)
    cache.add_or_update_flavor(a.ResourceFlavor(name="default"))
    for i in range(n_cq):
        name = f"ccq-{i}"
        hoarder = (i % COHORT_SIZE) < COHORT_SIZE // 2
        if hoarder:
            prem = a.Preemption()  # never preempts; a pure reclaim target
        else:
            prem = a.Preemption(
                within_cluster_queue=a.PreemptionPolicy.LOWER_PRIORITY,
                reclaim_within_cohort=(
                    a.ReclaimWithinCohortPolicy.ANY
                    if i % 2
                    else a.ReclaimWithinCohortPolicy.LOWER_PRIORITY
                ),
                borrow_within_cohort=(
                    a.BorrowWithinCohort(
                        policy=a.BorrowWithinCohortPolicy.LOWER_PRIORITY,
                        max_priority_threshold=60,
                    )
                    if i % 3 == 0
                    else a.BorrowWithinCohort()
                ),
            )
        cq = a.ClusterQueue(
            name=name,
            cohort=f"ccohort-{i // COHORT_SIZE}",
            namespace_selector={},
            resource_groups=(
                a.ResourceGroup(("cpu",), (a.FlavorQuotas.build("default", {"cpu": "16"}),)),
            ),
            preemption=prem,
        )
        cache.add_or_update_cluster_queue(cq)
        mgr.add_cluster_queue(cq)
        mgr.add_local_queue(a.LocalQueue(namespace="ns", name=f"lq-{name}", cluster_queue=name))
        # hoarders: 8 x 3 = 24 > nominal 16 (borrowing 8 from the
        # cohort); reclaimers: 4 x 2 = 8 (room for their own backlog)
        n_vic = HOARDER_VICTIMS if hoarder else RECLAIMER_VICTIMS
        v_cpu = "3" if hoarder else "2"
        for v in range(n_vic):
            wl = a.Workload(
                namespace="ns", name=f"victim-{i}-{v}",
                queue_name=f"lq-{name}", priority=int(rng.integers(0, 40)),
                pod_sets=(a.PodSet.build("main", 1, {"cpu": v_cpu}),),
            )
            wl.admission = a.make_admission(name, {"main": {"cpu": "default"}}, wl)
            wl.set_condition(
                a.WorkloadConditionType.QUOTA_RESERVED, True,
                reason="QuotaReserved", now=float(v),
            )
            cache.add_or_update_workload(wl)
        if not hoarder:
            for w in range(WL_PER_RECLAIMER):
                mgr.add_or_update_workload(
                    a.Workload(
                        namespace="ns", name=f"pre-{i}-{w}",
                        queue_name=f"lq-{name}",
                        priority=50 + 10 * int(rng.integers(0, 6)),
                        creation_time=float(i * WL_PER_RECLAIMER + w),
                        pod_sets=(
                            a.PodSet.build("main", 1, {"cpu": str(int(rng.integers(2, 8)))}),
                        ),
                    )
                )
    pending = []
    for cq_name, pq in mgr.cluster_queues.items():
        for wl in pq.snapshot_sorted():
            pending.append((wl, cq_name))

    def ts_fn(wl):
        return a.queue_order_timestamp(wl, mgr._ts_policy)

    return SimpleNamespace(cache=cache, mgr=mgr, clock=clock, pending=pending, ts_fn=ts_fn,
                           api=a)


def build_scheduler(env, **kwargs):
    """The interactive cycle over a ``build_contended`` cluster: a
    Scheduler with the batched cycle solve and the classic host
    Preemptor (``kwargs`` go to the Scheduler: ``use_preempt_solver``,
    ``device``, ``guard``)."""
    a = env.api
    kwargs.setdefault("use_solver", True)
    return a.Scheduler(
        queues=env.mgr, cache=env.cache, clock=env.clock,
        preemptor=a.Preemptor(env.clock), **kwargs,
    )


def run_cycles(sched, env, n: int = CYCLE_CYCLES) -> List[dict]:
    """``n`` cycles, each cycle's victims evicted before the next (the
    reconciler round trip compressed to the cycle boundary, as
    bench.py's fair-preempt stage does): a victim leaves the cache and
    its ClusterQueue's parked workloads are requeued."""
    records, evicted = [], set()
    for _ in range(n):
        res = sched.schedule()
        records.append(cycle_record(res))
        for e in res.preempting:
            for t in e.preemption_targets:
                wl = t.workload.workload
                if wl.name in evicted:
                    continue
                evicted.add(wl.name)
                cq_name = wl.admission.cluster_queue
                env.cache.delete_workload(wl)
                env.mgr.queue_associated_inadmissible_workloads_after(cq_name)
    return records


def _digest(obj) -> str:
    return hashlib.sha256(json.dumps(obj).encode()).hexdigest()


def drain_summary(outcome, n_cq: int = N_CQ) -> dict:
    """The CONTENDED_EXPECT keys of a PreemptDrainOutcome (either
    package's); ``digest`` hashes bench.py's decision signature: the
    (workload, cq, cycle) admissions and evictions, the parked names
    and the cycles."""
    hoarder_evictions = sum(
        1 for _, cq_name, _ in outcome.preempted
        if (int(cq_name.split("-")[1]) % COHORT_SIZE) < COHORT_SIZE // 2
    )
    sig = [
        sorted([wl.name, cq, int(cyc)] for wl, cq, _, cyc in outcome.admitted),
        sorted([wl.name, cq, int(cyc)] for wl, cq, cyc in outcome.preempted),
        sorted(wl.name for wl, _ in outcome.parked),
        int(outcome.cycles),
    ]
    return {
        "cycles": int(outcome.cycles),
        "admitted": len(outcome.admitted),
        "evicted": len(outcome.preempted),
        "parked": len(outcome.parked),
        "fallback": len(outcome.fallback),
        "truncated": bool(outcome.truncated),
        "hoarder_evictions": hoarder_evictions,
        "digest": _digest(sig),
    }


def cycle_record(result) -> dict:
    """One CycleResult (either package's) of a preempting cycle as plain
    data: admitted (workload, cq, flavors), preempting heads with their
    sorted targets, requeued count, and the victim-search path of every
    preempting head."""
    def flavors(e):
        return [[psa.name, sorted(psa.flavors.items())]
                for psa in e.workload.admission.pod_set_assignments]

    return {
        "admitted": [[e.workload.name, e.cq_name, flavors(e)] for e in result.admitted],
        "preempting": [
            [e.workload.name, e.cq_name,
             sorted([t.workload.workload.name, t.reason] for t in e.preemption_targets)]
            for e in result.preempting
        ],
        "requeued": len(result.requeued),
        "victim_search": sorted({e.victim_search for e in result.preempting}),
    }


def cycle_summary(records: List[dict]) -> dict:
    """The CONTENDED_CYCLE_EXPECT keys of a run of cycle records."""
    return {
        "cycles": len(records),
        "admitted": [len(r["admitted"]) for r in records],
        "preempting": [len(r["preempting"]) for r in records],
        "digest": _digest(records),
    }


# What the JAX package decides on the CPU at full width (seed 1,
# search_width=64, a fresh PanelTuner): the preempt drain ...
CONTENDED_EXPECT = {
    "cycles": 132,
    "admitted": 2295,
    "evicted": 3772,
    "parked": 2705,
    "fallback": 0,
    "truncated": False,
    "hoarder_evictions": 1500,
    "digest": "0706bc6dda1ad0bac52e969a6f852ea8795b258f219c769741868f4aef71a84c",
}
# ... the panel schedule a fresh PanelTuner takes for it: the narrow
# 16-wide panel overflows and misses, so the drain is solved again at
# the exact 64, and the tuner widens its next start to 32 ...
CONTENDED_PANELS = {"widths": [16, 64], "escalations": 1, "next_narrow": 32}
# ... and the first CYCLE_CYCLES Scheduler cycles with the 5000 queued
# (``run_cycles``: each cycle's victims evicted before the next;
# use_preempt_solver=True, so every deferred head's victims come from
# the batched search), about 500 heads a cycle. The JAX package's
# numbers come from its host nomination path (use_solver=False): on the
# CPU its resident cycle buffer can alias the snapshot's usage array,
# which the admit loop then edits in place (ROADMAP Queue C), and the
# decisions of both nomination paths are the same by that package's
# own parity tests.
CONTENDED_CYCLE_EXPECT = {
    "cycles": CYCLE_CYCLES,
    "admitted": [0, 111, 15, 110, 22, 109, 37, 109, 48, 107, 53, 106],
    "preempting": [100, 12, 96, 21, 103, 34, 101, 43, 100, 47, 101, 52],
    "digest": "abd0bb838123fe089ba1006a6e8b974eaf92dfd230e02f06034bfa930b75c6c7",
}
