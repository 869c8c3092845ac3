"""The fair-sharing preemption clusters (ports of bench.py's
``fair_preempt_drain_bench`` and ``fair_victim_search_bench`` builders)
and what both fair-preemption paths decide on them.

fair-preempt-1k (``build_fair_preempt``): bench.py's fair-preempt
cluster with its shapes unchanged and ``n_cq`` raised from 60 to 1000,
the headline's ClusterQueue count. ClusterQueues in cohorts of 6, one
``default`` flavor with 8 cpu each, fairSharing weights drawn from
500/1000/1000/2000 (``default_rng(11)``), withinClusterQueue
LowerPriority and reclaimWithinCohort Any with the default strategies
[LessThanOrEqualToFinalShare, LessThanInitialShare]. Every even
ClusterQueue holds 3 admitted 5-cpu victims (priority 0 or 5), all
borrowing; every ClusterQueue queues 4 workloads of 2-5 cpu at
priority 20/30/40. At 1000 ClusterQueues: 1500 victims, 4000 pending.

The fair victim search batch (``build_fair_search``): bench.py's
``fair`` stage, 64 cohorts x 4 ClusterQueues x 6 admitted 2-cpu
victims, and one 4-7 cpu head per ClusterQueue; its preempt-mode heads
go to one batched search (``default_rng(3)``).

Two shapes at the kernels' caps, not taken from bench.py: a fair
victim search batch at S = 64 nodes and Cu = 32 cells
(``build_fair_cap``, kernel B9), and a fair-preempt drain whose
segments have M = 64 nodes, depth 3 and Cu = 64 cells over two
resources (``build_fair_wide``, kernel family B11).

The RNG draws happen in the order bench.py makes them, so a seed gives
the same cluster in both packages. ``fair_api`` adds what these builders
need to ``contended.models_api``'s classes; the tests pass the JAX
package's modules, so this module imports nothing of it. The constants
below are what the JAX package gives on the CPU
(tests/test_torch_fair_preempt.py and tests/test_torch_fair_preempt_drain.py
hold it to them) and chip_smoke.py holds the port to on the card.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import List, Set, Tuple

import numpy as np

from kueue_tpu_torch.perf import contended

N_CQ = 1000
SMALL_N_CQ = 60  # bench.py's own stage
COHORT_SIZE = 6
WL_PER_CQ, VICTIMS_PER_CQ = 4, 3
WEIGHTS = (500, 1000, 1000, 2000)
WEIGHT_SEED = 11  # bench.py's w_rng
SEARCH_SEED = 3  # the fair victim search batch (bench.py's fair stage)
CYCLE_CYCLES = 8  # Scheduler cycles FAIR_PREEMPT_CYCLE_EXPECT covers
MAX_CYCLES = 600  # bench.py's host loop bound


def fair_api(api, models, flavor_assigner, snapshot, preempt_batch) -> SimpleNamespace:
    """``contended.models_api``'s classes plus FairSharing, Cohort, the
    FlavorAssigner and its Mode, take_snapshot and
    batched_fair_get_targets from one package's modules (``models``,
    ``core.flavor_assigner``, ``core.snapshot``, ``core.preempt_batch``)."""
    return SimpleNamespace(
        **vars(api), FairSharing=models.FairSharing, Cohort=models.Cohort,
        FlavorAssigner=flavor_assigner.FlavorAssigner, Mode=flavor_assigner.Mode,
        take_snapshot=snapshot.take_snapshot,
        batched_fair_get_targets=preempt_batch.batched_fair_get_targets,
    )


def port_api() -> SimpleNamespace:
    from kueue_tpu_torch import models
    from kueue_tpu_torch.core import flavor_assigner, preempt_batch, snapshot

    return fair_api(contended.port_api(), models, flavor_assigner, snapshot, preempt_batch)


def build_fair_preempt(n_cq: int = N_CQ, api=None) -> SimpleNamespace:
    """fair-preempt-1k (``n_cq`` ClusterQueues): ``cache`` (victims
    admitted), ``mgr`` (the QueueManager with the pending workloads
    queued), ``clock``, ``pending`` as (workload, cq name) in per-CQ
    heap order, ``ts_fn`` (the queue-order timestamp the drain sorts
    by) and ``api``."""
    a = api or port_api()
    prem = a.Preemption(
        within_cluster_queue=a.PreemptionPolicy.LOWER_PRIORITY,
        reclaim_within_cohort=a.ReclaimWithinCohortPolicy.ANY,
    )
    clock = a.FakeClock(0.0)
    cache = a.Cache()
    mgr = a.QueueManager(clock)
    cache.add_or_update_flavor(a.ResourceFlavor(name="default"))
    w_rng = np.random.default_rng(WEIGHT_SEED)
    t = 0.0
    for i in range(n_cq):
        name = f"fpcq-{i}"
        cq = a.ClusterQueue(
            name=name,
            cohort=f"fpcohort-{i // COHORT_SIZE}",
            namespace_selector={},
            resource_groups=(
                a.ResourceGroup(("cpu",), (a.FlavorQuotas.build("default", {"cpu": "8"}),)),
            ),
            fair_sharing=a.FairSharing(
                weight_milli=WEIGHTS[int(w_rng.integers(0, len(WEIGHTS)))]
            ),
            preemption=prem,
        )
        cache.add_or_update_cluster_queue(cq)
        mgr.add_cluster_queue(cq)
        mgr.add_local_queue(a.LocalQueue(namespace="ns", name=f"lq-{name}", cluster_queue=name))
        # every other ClusterQueue hoards: admitted victims borrowing
        # above nominal make the cohort DRS-positive
        if i % 2 == 0:
            for v in range(VICTIMS_PER_CQ):
                t += 1.0
                wl = a.Workload(
                    namespace="ns", name=f"fpv-{i}-{v}", queue_name=f"lq-{name}",
                    priority=int(w_rng.integers(0, 2)) * 5, creation_time=t,
                    pod_sets=(a.PodSet.build("main", 1, {"cpu": "5"}),),
                )
                wl.admission = a.make_admission(name, {"main": {"cpu": "default"}}, wl)
                wl.set_condition(
                    a.WorkloadConditionType.QUOTA_RESERVED, True,
                    reason="QuotaReserved", now=t,
                )
                cache.add_or_update_workload(wl)
        for w in range(WL_PER_CQ):
            t += 1.0
            mgr.add_or_update_workload(
                a.Workload(
                    namespace="ns", name=f"fpwl-{i}-{w}", queue_name=f"lq-{name}",
                    priority=20 + int(w_rng.integers(0, 3)) * 10, creation_time=t,
                    pod_sets=(
                        a.PodSet.build("main", 1, {"cpu": str(int(w_rng.integers(2, 6)))}),
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
    """The interactive fair cycle over a ``build_fair_preempt`` cluster:
    a Scheduler with fair sharing and the fair-sharing host Preemptor
    (``kwargs`` go to the Scheduler: ``use_solver``,
    ``use_preempt_solver``, ``device``)."""
    a = env.api
    return a.Scheduler(
        queues=env.mgr, cache=env.cache, clock=env.clock,
        preemptor=a.Preemptor(env.clock, enable_fair_sharing=True), fair_sharing=True,
        **kwargs,
    )


def run_to_quiescence(sched, env, max_cycles: int = MAX_CYCLES) -> Tuple[Set[str], Set[str], int]:
    """bench.py's host loop: cycles until one neither had pending work
    nor evicted, each cycle's victims evicted before the next. Returns
    (admitted names, evicted names, schedule() calls)."""
    admitted: Set[str] = set()
    evicted: Set[str] = set()
    calls = 0
    for _ in range(max_cycles):
        progressed = any(pq.pending_active() > 0 for pq in env.mgr.cluster_queues.values())
        res = sched.schedule()
        calls += 1
        admitted.update(e.workload.name for e in res.admitted)
        for e in res.preempting:
            for t in e.preemption_targets:
                wl = t.workload.workload
                if wl.name in evicted:
                    continue
                evicted.add(wl.name)
                cq_name = wl.admission.cluster_queue
                env.cache.delete_workload(wl)
                env.mgr.queue_associated_inadmissible_workloads_after(cq_name)
                progressed = True
        if not progressed:
            break
    return admitted, evicted, calls


def drain_summary(outcome) -> dict:
    """The FAIR_PREEMPT_EXPECT keys of a PreemptDrainOutcome (either
    package's); ``digest`` hashes the decision signature: the
    (workload, cq, cycle) admissions and evictions with their evictor
    and reason, the parked names and the cycles."""
    sig = [
        sorted([wl.name, cq, int(cyc)] for wl, cq, _, cyc in outcome.admitted),
        sorted([e.victim.name, e.victim_cq, int(e.cycle), e.by_cq, e.reason]
               for e in outcome.evictions),
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
        "digest": contended._digest(sig),
    }


def drain_sets(outcome) -> Tuple[Set[str], Set[str]]:
    """(admitted names, evicted names) of a drain outcome, as bench.py
    compares them with the Scheduler loop's."""
    return ({wl.name for wl, _, _, _ in outcome.admitted},
            {wl.name for wl, _, _ in outcome.preempted})


def build_fair_search(rng: np.random.Generator, api=None):
    """bench.py's fair victim search batch: (snapshot, items, preemptor)
    with ``items`` the preempt-mode heads as (workload, cq name,
    assignment)."""
    a = api or port_api()
    n_cohorts, cqs_per_cohort, victims_per_cq = 64, 4, 6
    cache = a.Cache()
    cache.add_or_update_flavor(a.ResourceFlavor(name="default"))
    prem = a.Preemption(
        within_cluster_queue=a.PreemptionPolicy.LOWER_PRIORITY,
        reclaim_within_cohort=a.ReclaimWithinCohortPolicy.ANY,
    )
    cq_names: List[str] = []
    for ci in range(n_cohorts):
        for qi in range(cqs_per_cohort):
            name = f"fcq-{ci}-{qi}"
            cq_names.append(name)
            cache.add_or_update_cluster_queue(
                a.ClusterQueue(
                    name=name, cohort=f"fco-{ci}", namespace_selector={},
                    resource_groups=(
                        a.ResourceGroup(("cpu",), (a.FlavorQuotas.build("default", {"cpu": "8"}),)),
                    ),
                    preemption=prem,
                    fair_sharing=a.FairSharing(weight_milli=int(rng.choice([500, 1000, 2000]))),
                )
            )
            # over-admit so the ClusterQueues borrow from the cohort
            for v in range(victims_per_cq):
                wl = a.Workload(
                    namespace="ns", name=f"fv-{ci}-{qi}-{v}", queue_name=f"lq-{name}",
                    priority=int(rng.integers(0, 30)), creation_time=float(v),
                    pod_sets=(a.PodSet.build("main", 1, {"cpu": "2"}),),
                )
                wl.admission = a.make_admission(name, {"main": {"cpu": "default"}}, wl)
                wl.set_condition(
                    a.WorkloadConditionType.QUOTA_RESERVED, True,
                    reason="QuotaReserved", now=float(v),
                )
                cache.add_or_update_workload(wl)
    snapshot = a.take_snapshot(cache)
    assigner = a.FlavorAssigner(snapshot, cache.flavors, enable_fair_sharing=True)
    items = []
    for i, name in enumerate(cq_names):
        wl = a.Workload(
            namespace="ns", name=f"fh-{i}", queue_name=f"lq-{name}",
            priority=100, creation_time=1000.0 + i,
            pod_sets=(a.PodSet.build("main", 1, {"cpu": str(int(rng.integers(4, 8)))}),),
        )
        asg = assigner.assign(wl, name)
        if asg.representative_mode() == a.Mode.PREEMPT:
            items.append((wl, name, asg))
    preemptor = a.Preemptor(a.FakeClock(0.0), enable_fair_sharing=True)
    return snapshot, items, preemptor


CAP_FLAVORS = 16  # x 2 resources: 32 cells, the fair lowering's MAX_FAIR_CELLS
CAP_MIDS, CAP_CQS = 3, 60  # a root, 3 cohorts, 60 ClusterQueues: 64 nodes
CAP_VICTIMS = 8  # 5 cpu each, round robin over the flavors: every flavor full


def build_fair_cap(rng: np.random.Generator, api=None):
    """A fair victim search batch at the lowering's caps, S = 64 local
    nodes and Cu = 32 cells: one root cohort over three cohorts over 60
    ClusterQueues (weights 0-2000), 16 flavors of cpu and memory with 2
    cpu and 2Gi each, 8 admitted 5-cpu victims per ClusterQueue round
    robin over the flavors (so every flavor of the cohort is full and
    most victims borrow), one 1-2 cpu head per ClusterQueue. Returns (snapshot, items,
    preemptor) as ``build_fair_search``."""
    a = api or port_api()
    flavors = [f"cf-{i}" for i in range(CAP_FLAVORS)]
    cache = a.Cache()
    for f in flavors:
        cache.add_or_update_flavor(a.ResourceFlavor(name=f))
    cache.add_or_update_cohort(a.Cohort(name="cap-root"))
    for m in range(CAP_MIDS):
        cache.add_or_update_cohort(a.Cohort(name=f"cap-mid-{m}", parent="cap-root"))
    prem = a.Preemption(
        within_cluster_queue=a.PreemptionPolicy.LOWER_PRIORITY,
        reclaim_within_cohort=a.ReclaimWithinCohortPolicy.ANY,
    )
    names = []
    for i in range(CAP_CQS):
        name = f"capcq-{i}"
        names.append(name)
        cache.add_or_update_cluster_queue(a.ClusterQueue(
            name=name, cohort=f"cap-mid-{i % CAP_MIDS}", namespace_selector={},
            resource_groups=(a.ResourceGroup(("cpu", "memory"), tuple(
                a.FlavorQuotas.build(f, {"cpu": "2", "memory": "2Gi"}) for f in flavors
            )),),
            preemption=prem,
            fair_sharing=a.FairSharing(weight_milli=int(rng.choice([0, 500, 1000, 2000]))),
        ))
        for v in range(CAP_VICTIMS):
            f = flavors[(i * CAP_VICTIMS + v) % CAP_FLAVORS]
            wl = a.Workload(
                namespace="ns", name=f"capv-{i}-{v}", queue_name=f"lq-{name}",
                priority=int(rng.integers(0, 30)), creation_time=float(v),
                pod_sets=(a.PodSet.build("main", 1, {"cpu": "5", "memory": "5Gi"}),),
            )
            wl.admission = a.make_admission(name, {"main": {"cpu": f, "memory": f}}, wl)
            wl.set_condition(
                a.WorkloadConditionType.QUOTA_RESERVED, True, reason="QuotaReserved",
                now=float(v),
            )
            cache.add_or_update_workload(wl)
    snapshot = a.take_snapshot(cache)
    assigner = a.FlavorAssigner(snapshot, cache.flavors, enable_fair_sharing=True)
    items = []
    for i, name in enumerate(names):
        wl = a.Workload(
            namespace="ns", name=f"caph-{i}", queue_name=f"lq-{name}", priority=100,
            creation_time=1000.0 + i,
            pod_sets=(a.PodSet.build("main", 1, {
                "cpu": str(int(rng.integers(1, 3))), "memory": f"{int(rng.integers(1, 3))}Gi",
            }),),
        )
        asg = assigner.assign(wl, name)
        if asg.representative_mode() == a.Mode.PREEMPT:
            items.append((wl, name, asg))
    return snapshot, items, a.Preemptor(a.FakeClock(0.0), enable_fair_sharing=True)


WIDE_SEED = 5
WIDE_ROOTS = 4  # root cohorts: the drain's segments
WIDE_MIDS, WIDE_SUBS, WIDE_CQS = 3, 2, 9  # per root: 1 + 3 + 6 + 54 = 64 nodes, depth 3
WIDE_FLAVORS = 32  # x 2 resources: 64 cells, the drain's max_fair_cells
WIDE_FLAVORS_PER_CQ = 4
WIDE_WL_PER_CQ = 3


def build_fair_wide(rng: np.random.Generator, n_roots: int = WIDE_ROOTS,
                    api=None, flavor_sets: int = 1) -> SimpleNamespace:
    """A fair-preempt drain at the panel caps, where B11's multi-bucket
    DRS, deep walks and wide panels have work: ``n_roots`` root cohorts,
    each over 3 cohorts over 2 cohorts over 9 ClusterQueues (M = 64
    nodes, depth 3; cohort and ClusterQueue weights drawn from
    0/500/1000/2000), 32 flavors of cpu and memory (Cu = 64 cells a
    segment), each ClusterQueue with 2 cpu and 2Gi in 4 of them, its
    window shifted by 4 flavors from its neighbour's. Every even
    ClusterQueue holds one admitted 4-cpu, 4Gi victim a flavor (priority
    0-10, borrowing); every ClusterQueue queues 3 workloads of 1-4 cpu
    and 1-4Gi at priority 20/30/40. Preemption as fair-preempt-1k's.
    ``flavor_sets`` > 1 gives root r its own 32 flavors (set r modulo
    ``flavor_sets``): the tree is that many times wider (FR = 64 x sets
    cells) while each segment keeps Cu = 64. Returns the env
    ``build_fair_preempt`` returns."""
    a = api or port_api()
    prem = a.Preemption(
        within_cluster_queue=a.PreemptionPolicy.LOWER_PRIORITY,
        reclaim_within_cohort=a.ReclaimWithinCohortPolicy.ANY,
    )
    clock = a.FakeClock(0.0)
    cache = a.Cache()
    mgr = a.QueueManager(clock)
    flavors = [f"wf-{i}" for i in range(WIDE_FLAVORS * flavor_sets)]
    for f in flavors:
        cache.add_or_update_flavor(a.ResourceFlavor(name=f))

    def weight():
        return a.FairSharing(weight_milli=int(rng.choice([0, 500, 1000, 2000])))

    t, i = 0.0, 0
    for r in range(n_roots):
        cache.add_or_update_cohort(a.Cohort(name=f"wide-{r}"))
        for m in range(WIDE_MIDS):
            mid = f"wide-{r}-{m}"
            cache.add_or_update_cohort(a.Cohort(name=mid, parent=f"wide-{r}",
                                                fair_sharing=weight()))
            for b in range(WIDE_SUBS):
                sub = f"{mid}-{b}"
                cache.add_or_update_cohort(a.Cohort(name=sub, parent=mid, fair_sharing=weight()))
                for _ in range(WIDE_CQS):
                    name = f"widecq-{i}"
                    own = [flavors[(r % flavor_sets) * WIDE_FLAVORS
                                   + (i * WIDE_FLAVORS_PER_CQ + k) % WIDE_FLAVORS]
                           for k in range(WIDE_FLAVORS_PER_CQ)]
                    cq = a.ClusterQueue(
                        name=name, cohort=sub, namespace_selector={},
                        resource_groups=(a.ResourceGroup(("cpu", "memory"), tuple(
                            a.FlavorQuotas.build(f, {"cpu": "2", "memory": "2Gi"}) for f in own
                        )),),
                        preemption=prem, fair_sharing=weight(),
                    )
                    cache.add_or_update_cluster_queue(cq)
                    mgr.add_cluster_queue(cq)
                    mgr.add_local_queue(a.LocalQueue(namespace="ns", name=f"lq-{name}",
                                                     cluster_queue=name))
                    for v, f in enumerate(own if i % 2 == 0 else ()):
                        t += 1.0
                        wl = a.Workload(
                            namespace="ns", name=f"widev-{i}-{v}", queue_name=f"lq-{name}",
                            priority=int(rng.integers(0, 11)), creation_time=t,
                            pod_sets=(a.PodSet.build("main", 1, {"cpu": "4", "memory": "4Gi"}),),
                        )
                        wl.admission = a.make_admission(name, {"main": {"cpu": f, "memory": f}},
                                                        wl)
                        wl.set_condition(a.WorkloadConditionType.QUOTA_RESERVED, True,
                                         reason="QuotaReserved", now=t)
                        cache.add_or_update_workload(wl)
                    for w in range(WIDE_WL_PER_CQ):
                        t += 1.0
                        mgr.add_or_update_workload(a.Workload(
                            namespace="ns", name=f"widewl-{i}-{w}", queue_name=f"lq-{name}",
                            priority=20 + int(rng.integers(0, 3)) * 10, creation_time=t,
                            pod_sets=(a.PodSet.build("main", 1, {
                                "cpu": str(int(rng.integers(1, 5))),
                                "memory": f"{int(rng.integers(1, 5))}Gi",
                            }),),
                        ))
                    i += 1
    pending = [(wl, cq_name) for cq_name, pq in mgr.cluster_queues.items()
               for wl in pq.snapshot_sorted()]

    def ts_fn(wl):
        return a.queue_order_timestamp(wl, mgr._ts_policy)

    return SimpleNamespace(cache=cache, mgr=mgr, clock=clock, pending=pending, ts_fn=ts_fn,
                           api=a)


def search_summary(items, results, meta) -> dict:
    """The FAIR_SEARCH_EXPECT keys of one batched fair search: the
    lowered shapes (``meta`` from ``lower_fair_preemption``), the heads
    with victims, the victims and a digest of every head's sorted
    (victim, reason) list."""
    sig = [
        [wl.name, sorted([t.workload.workload.name, t.reason] for t in res)]
        for (wl, _, _), res in zip(items, results)
    ]
    return {
        "heads": len(items),
        "s": int(meta["s"]), "cu": int(meta["cu"]), "v": int(meta["v"]),
        "r": int(meta["r"]), "depth": int(meta["depth"]),
        "fallback": len(meta["fallback"]),
        "with_victims": sum(1 for res in results if res),
        "victims": sum(len(res) for res in results),
        "digest": contended._digest(sig),
    }


# What the JAX package decides on the CPU: the fair-preempt drain at
# 1000 ClusterQueues ...
FAIR_PREEMPT_EXPECT = {
    "cycles": 34,
    "admitted": 2877,
    "evicted": 2000,
    "parked": 1123,
    "fallback": 0,
    "truncated": False,
    "digest": "593cb1ede613748586e82a389d8c833b00e5a2105cb7630256c3927f14824580",
}
# ... at bench.py's own 60 ...
FAIR_PREEMPT_SMALL_EXPECT = {
    "cycles": 34,
    "admitted": 181,
    "evicted": 127,
    "parked": 59,
    "fallback": 0,
    "truncated": False,
    "digest": "c898eea58079c6d9f4a4a573db8c9bbf58eb945bfdc849ac6954882b3c9af172",
}
# ... the first CYCLE_CYCLES Scheduler cycles at 1000 (each cycle's
# victims evicted before the next; the JAX side with use_solver=False,
# as perf/contended.py explains) ...
FAIR_PREEMPT_CYCLE_EXPECT = {
    "cycles": CYCLE_CYCLES,
    "admitted": [201, 385, 56, 626, 76, 639, 78, 322],
    "preempting": [313, 20, 459, 31, 481, 28, 246, 29],
    "digest": "2c1718b25e43cf628f4bd5ba8526dad90539eb3bb20930b08abe8eac52f6e465",
}
# ... the fair-preempt drain at the panel caps (build_fair_wide; 76 of
# its 216 queues freeze as stuck, their heads undecided with a flavor
# pending until the retry budget runs out, 57 of them ClusterQueues
# that hold no victims: their 215 entries are the fallback) ...
FAIR_WIDE_EXPECT = {
    "cycles": 31,
    "admitted": 288,
    "evicted": 228,
    "parked": 145,
    "fallback": 215,
    "truncated": False,
    "digest": "09b35b55094846f055ee49dae552589bbc40b753b9e5b0276535d897ccc03426",
}
# ... and the batched fair victim search of bench.py's fair stage.
FAIR_SEARCH_EXPECT = {
    "heads": 256,
    "s": 8,
    "cu": 2,
    "v": 32,
    "r": 2,
    "depth": 1,
    "fallback": 0,
    "with_victims": 73,
    "victims": 768,
    "digest": "4123d3d152e963ee84345477af81886c0144358576353f9dac2f09a10d67cfc5",
}
