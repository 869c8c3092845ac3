"""MultiKueue-at-scale scenario — BASELINE config #5: N worker
clusters x M workloads through batched cross-cluster dispatch.

Reference: pkg/controller/admissionchecks/multikueue/workload.go:298-425
(remote copies on every configured cluster, first-reserving wins with
losers dropped, status sync-back, finish propagation, orphan GC) and
multikueuecluster.go:76-187 (per-cluster remote clients).

The manager and every worker are full ClusterRuntimes sharing ONE
virtual clock, so the measured semantics — dispatch waves, reservation
races, finish sync-back — are host-speed independent; the wall time of
the whole run is the throughput number. Worker capacity is sized below
the workload count so dispatch proceeds in waves: every worker receives
copies of the whole backlog, the over-subscribed head of each worker's
queue reserves everywhere at once (the first-reserving race), losers'
copies are dropped, their freed quota pulls the next tranche, and the
spread emerges from the race resolution — the same dynamics the
reference's multikueue e2e drives with real clusters.

Port of kueue_tpu/perf/multikueue.py: every runtime takes ``device``
(the card unless "cpu" is named). ``run_federation_scale`` is bench.py's
federation stage; at its default 50 workers it gives
``FED_SCALE_EXPECT`` and the applied rebalances digest to
``FED_REBALANCE_DIGEST`` (both from the JAX package on the CPU).
"""

from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from kueue_tpu_torch.admissionchecks.multikueue import (
    MultiKueueCluster,
    MultiKueueConfig,
    MultiKueueController,
)
from kueue_tpu_torch.admissionchecks.multikueue_transport import (
    ORIGIN_LABEL,
    InProcessTransport,
)
from kueue_tpu_torch.controllers import ClusterRuntime
from kueue_tpu_torch.models import (
    AdmissionCheck,
    ClusterQueue,
    FlavorQuotas,
    LocalQueue,
    ResourceFlavor,
    Workload,
)
from kueue_tpu_torch.models.cluster_queue import ResourceGroup
from kueue_tpu_torch.models.constants import (
    MULTIKUEUE_CONTROLLER_NAME,
    WorkloadConditionType,
)
from kueue_tpu_torch.models.workload import PodSet
from kueue_tpu_torch.utils.clock import FakeClock


class CountingTransport(InProcessTransport):
    """Wire telemetry: every op counted, batched-create sizes recorded
    (the scenario's floor is that creates flow ONLY through the batched
    exchange — workload.go:298's per-object creates amortized into one
    wire round trip per cluster per pass)."""

    def __init__(self, runtime):
        super().__init__(runtime)
        self.op_counts: Dict[str, int] = {}
        self.batch_sizes: List[int] = []

    def _count(self, op: str) -> None:
        self.op_counts[op] = self.op_counts.get(op, 0) + 1

    def get_workload(self, key):
        self._count("get_workload")
        return super().get_workload(key)

    def create_workload(self, wl):
        self._count("create_workload")
        super().create_workload(wl)

    def create_workloads(self, wls):
        self._count("create_workloads")
        self.batch_sizes.append(len(wls))
        for wl in wls:
            super().create_workload(wl)

    def delete_workload(self, key):
        self._count("delete_workload")
        super().delete_workload(key)

    def list_workload_keys(self, origin):
        self._count("list_workload_keys")
        return super().list_workload_keys(origin)


@dataclass
class MKRunResult:
    wall_s: float
    virtual_s: float
    n_workers: int
    total: int
    dispatched: int  # workloads that found a reserving winner
    finished: int  # local workloads Finished via sync-back
    driver_iterations: int
    # wire telemetry
    unbatched_creates: int  # must be 0 under batch_dispatch
    batched_exchanges: int  # create_workloads calls across clusters
    total_batched_creates: int  # sum of batch sizes
    max_batch: int
    avg_batch: float
    # race / spread telemetry
    first_reserving_races: int
    winner_counts: Dict[str, int] = field(default_factory=dict)
    # hygiene
    orphans_gced: int = 0
    remote_leftovers: int = 0  # origin-labeled remotes after final GC

    @property
    def dispatch_per_sec_wall(self) -> float:
        return self.finished / max(self.wall_s, 1e-9)


class _PinnedOpenGate:
    """Latency-gate stand-in that keeps the bulk drain always on: this
    scenario measures dispatch SEMANTICS and wire efficiency at scale,
    not the latency auto-gate (which has its own tests) — a CPU-backend
    compile blip mid-run must not flip half the waves to the host path
    and make the batch-size floors nondeterministic."""

    value = 0.0

    def observe(self, dt: float) -> None:
        pass

    def erode(self) -> None:
        pass


def _manager_runtime(
    clock, n_workloads: int, wl_cpu: int, n_queues: int, device=None
) -> ClusterRuntime:
    """n_queues ClusterQueues all gated by the one MultiKueue check —
    the drain pops one head per queue per kernel cycle, so queue count
    bounds the drain's cycle depth (and many tenant queues feeding one
    dispatch check is the realistic shape anyway)."""
    rt = ClusterRuntime(clock=clock, drain_gate=_PinnedOpenGate(), device=device)
    rt.add_flavor(ResourceFlavor(name="default"))
    rt.add_admission_check(
        AdmissionCheck(
            name="mk",
            controller_name=MULTIKUEUE_CONTROLLER_NAME,
            parameters="cfg",
        )
    )
    per_q = -(-n_workloads // n_queues) * wl_cpu  # ceil: local quota ample
    for j in range(n_queues):
        rt.add_cluster_queue(
            ClusterQueue(
                name=f"mk-cq-{j}",
                namespace_selector={},
                resource_groups=(
                    ResourceGroup(
                        ("cpu",),
                        (FlavorQuotas.build("default", {"cpu": str(per_q)}),),
                    ),
                ),
                admission_checks=("mk",),
            )
        )
        rt.add_local_queue(
            LocalQueue(namespace="ns", name=f"lq-{j}", cluster_queue=f"mk-cq-{j}")
        )
    return rt


def _worker_runtime(clock, cpu_quota: int, n_queues: int, device=None) -> ClusterRuntime:
    rt = ClusterRuntime(clock=clock, drain_gate=_PinnedOpenGate(), device=device)
    rt.add_flavor(ResourceFlavor(name="default"))
    per_q = max(1, cpu_quota // n_queues)
    for j in range(n_queues):
        rt.add_cluster_queue(
            ClusterQueue(
                name=f"worker-cq-{j}",
                namespace_selector={},
                resource_groups=(
                    ResourceGroup(
                        ("cpu",),
                        (FlavorQuotas.build("default", {"cpu": str(per_q)}),),
                    ),
                ),
            )
        )
        rt.add_local_queue(
            LocalQueue(
                namespace="ns", name=f"lq-{j}", cluster_queue=f"worker-cq-{j}"
            )
        )
    return rt


def run_multikueue(
    n_workers: int = 4,
    n_workloads: int = 10_000,
    worker_cpu_each: Optional[int] = None,
    runtime_s: float = 60.0,
    wl_cpu: int = 1,
    n_queues: int = 16,
    max_virtual_s: float = 1e7,
    max_driver_iterations: int = 10_000,
    device=None,
) -> MKRunResult:
    """Drive the full dispatch lifecycle to completion.

    ``worker_cpu_each`` defaults to a quarter of the per-worker fair
    share, so the whole backlog needs ~4 dispatch waves per worker and
    the first-reserving race path is exercised on every wave."""
    clock = FakeClock(0.0)
    if worker_cpu_each is None:
        worker_cpu_each = max(1, (n_workloads * wl_cpu) // (4 * n_workers))

    manager = _manager_runtime(clock, n_workloads, wl_cpu, n_queues, device)
    workers: Dict[str, MultiKueueCluster] = {}
    transports: Dict[str, CountingTransport] = {}
    for i in range(n_workers):
        name = f"worker{i}"
        wrt = _worker_runtime(clock, worker_cpu_each, n_queues, device)
        tr = CountingTransport(wrt)
        transports[name] = tr
        workers[name] = MultiKueueCluster(name=name, transport=tr)
    ctrl = MultiKueueController(
        manager,
        clusters=workers,
        configs={
            "cfg": MultiKueueConfig(name="cfg", clusters=tuple(workers))
        },
        batch_dispatch=True,
    )
    manager.admission_check_controllers.append(ctrl)

    for i in range(n_workloads):
        manager.add_workload(
            Workload(
                namespace="ns",
                name=f"mk-{i:06d}",
                queue_name=f"lq-{i % n_queues}",
                pod_sets=(PodSet.build("main", 1, {"cpu": str(wl_cpu)}),),
            )
        )

    # finish events for remote copies: (virtual time, seq, worker, key)
    finish_events: List[tuple] = []
    scheduled_finish: set = set()
    seq = 0
    iterations = 0
    t_start = time.perf_counter()

    def pump() -> None:
        """One round of the distributed control loop at a virtual
        instant: manager pass (reserve + buffer creates + flush), then
        cascade worker-reserve / manager-observe rounds until the race
        resolution quiesces — every round the losers' freed quota pulls
        the next tranche, so capacity fills instead of advancing time
        with three quarters of the fleet idled by lost races."""
        manager.run_until_idle()
        for _ in range(4 * n_workers + 4):
            before = (
                sum(ctrl.winner_counts.values()),
                len(ctrl._reserving),
            )
            for w in workers.values():
                w.runtime.run_until_idle()
            manager.run_until_idle()
            if (
                sum(ctrl.winner_counts.values()),
                len(ctrl._reserving),
            ) == before:
                break

    while iterations < max_driver_iterations and clock.now() <= max_virtual_s:
        iterations += 1
        pump()
        # schedule finishes for newly admitted remote copies
        for name, w in workers.items():
            for wl in w.runtime.workloads.values():
                if wl.has_quota_reservation and (name, wl.key) not in scheduled_finish:
                    scheduled_finish.add((name, wl.key))
                    heapq.heappush(
                        finish_events,
                        (clock.now() + runtime_s, seq, name, wl.key),
                    )
                    seq += 1
        if all(w.is_finished for w in manager.workloads.values()):
            break
        if not finish_events:
            break  # stalled: nothing running remotely, nothing to wait on
        # advance virtual time to the next remote completion(s)
        t = finish_events[0][0]
        clock.set(max(clock.now(), t))
        while finish_events and finish_events[0][0] <= clock.now():
            _, _, name, key = heapq.heappop(finish_events)
            wrt = workers[name].runtime
            rwl = wrt.workloads.get(key)
            # the copy may have lost the race and been deleted since
            if rwl is None or rwl.is_finished:
                continue
            rwl.set_condition(
                WorkloadConditionType.FINISHED,
                True,
                "JobFinished",
                "Job finished successfully",
                now=clock.now(),
            )
            wrt.on_workload_finished(rwl)

    orphans = ctrl.gc_orphans()
    leftovers = sum(
        1
        for w in workers.values()
        for wl in w.runtime.workloads.values()
        if wl.labels.get(ORIGIN_LABEL) == ctrl.origin
    )
    wall_s = time.perf_counter() - t_start

    batch_sizes = [s for tr in transports.values() for s in tr.batch_sizes]
    return MKRunResult(
        wall_s=wall_s,
        virtual_s=clock.now(),
        n_workers=n_workers,
        total=n_workloads,
        dispatched=len(ctrl._reserving)
        + sum(
            1 for wl in manager.workloads.values() if wl.is_finished
        ),
        finished=sum(
            1 for wl in manager.workloads.values() if wl.is_finished
        ),
        driver_iterations=iterations,
        unbatched_creates=sum(
            tr.op_counts.get("create_workload", 0)
            for tr in transports.values()
        ),
        batched_exchanges=len(batch_sizes),
        total_batched_creates=sum(batch_sizes),
        max_batch=max(batch_sizes, default=0),
        avg_batch=(
            sum(batch_sizes) / len(batch_sizes) if batch_sizes else 0.0
        ),
        first_reserving_races=ctrl.first_reserving_races,
        winner_counts=dict(ctrl.winner_counts),
        orphans_gced=orphans,
        remote_leftovers=leftovers,
    )


# ---- federation-at-scale: the REAL dispatcher at 50+ workers ----
@dataclass
class FedScaleResult:
    """One fan-out scaling run through FederationDispatcher +
    GlobalScheduler (not the MultiKueueController shim above): N full
    worker control planes, planner-ranked dispatch with fanout, the
    journaled retraction protocol, and the batched global rescore
    loop driving rebalances as capacity frees in waves."""

    wall_s: float
    virtual_s: float
    n_workers: int
    total: int
    admitted: int
    passes: int
    fanout_pass_ms: float  # first full dispatch pass (mirror fan-out)
    rescore_passes: int
    rescore_ms_per_cycle: float  # batched scoring kernel, mean
    aggregate_ms_per_cycle: float  # snapshot aggregation, mean
    rebalances: int
    retractions_acked: int

    @property
    def dispatches_per_s(self) -> float:
        return self.admitted / max(self.wall_s, 1e-9)


def run_federation_scale(
    n_workers: int = 50,
    n_workloads: int = 200,
    fanout: int = 1,
    wl_cpu: int = 1,
    runtime_s: float = 300.0,
    hysteresis_s: float = 30.0,
    max_passes: int = 400,
    device=None,
    use_device: bool = True,
    on_scheduler=None,
) -> FedScaleResult:
    """Drive ``n_workloads`` through the real dispatcher at
    ``n_workers`` in-process worker planes until every workload admits.

    Capacity is deliberately heterogeneous (worker i holds
    ``1 + i % 3`` admission slots) and ``fanout`` narrow, so early
    placements park on congested workers and the global rescore loop
    has real rebalancing work as finished workloads free capacity in
    waves — the fan-out scaling scenario the ROADMAP names.

    ``device`` is every runtime's; ``use_device=False`` has the global
    scheduler rescore with the numpy mirror; ``on_scheduler``, when
    given, is called with the ``GlobalScheduler`` once it is built (a
    caller that records the rescore reports)."""
    import heapq as _heapq

    from kueue_tpu_torch.federation import FederationDispatcher, GlobalScheduler

    clock = FakeClock(0.0)
    workers: Dict[str, ClusterRuntime] = {}
    clusters: Dict[str, MultiKueueCluster] = {}
    for i in range(n_workers):
        name = f"w{i:03d}"
        rt = ClusterRuntime(clock=clock, use_solver=False, device=device)
        rt.add_flavor(ResourceFlavor(name="default"))
        slots = (1 + i % 3) * wl_cpu
        rt.add_cluster_queue(
            ClusterQueue(
                name="cq",
                namespace_selector={},
                resource_groups=(
                    ResourceGroup(
                        ("cpu",),
                        (FlavorQuotas.build("default", {"cpu": str(slots)}),),
                    ),
                ),
            )
        )
        rt.add_local_queue(
            LocalQueue(namespace="ns", name="lq", cluster_queue="cq")
        )
        workers[name] = rt
        clusters[name] = MultiKueueCluster(name=name, runtime=rt)
    manager = ClusterRuntime(clock=clock, use_solver=False, device=device)
    disp = FederationDispatcher(
        manager,
        clusters=clusters,
        fanout=fanout,
        drive_inprocess=True,
        worker_lost_timeout=1e9,
        heartbeat_interval_s=1e9,  # the pass traffic IS the probe here
    )
    gs = GlobalScheduler(
        disp, hysteresis_s=hysteresis_s, rescore_interval_s=runtime_s / 4,
        use_device=use_device,
    )
    if on_scheduler is not None:
        on_scheduler(gs)
    for i in range(n_workloads):
        manager.add_workload(
            Workload(
                namespace="ns",
                name=f"fs-{i:05d}",
                queue_name="lq",
                pod_sets=(PodSet.build("main", 1, {"cpu": str(wl_cpu)}),),
            )
        )

    t_start = time.perf_counter()
    t0 = time.perf_counter()
    manager.run_until_idle()
    fanout_pass_ms = (time.perf_counter() - t0) * 1e3

    finish_events: List[tuple] = []
    scheduled: set = set()
    seq = 0
    passes = 1
    while passes < max_passes:
        # schedule finishes for every newly reserving remote copy —
        # freed capacity is what pulls the next wave (and what makes
        # a parked workload's forecast beat its congested placement)
        for name, rt in workers.items():
            for rwl in rt.workloads.values():
                if (
                    rwl.has_quota_reservation
                    and (name, rwl.key) not in scheduled
                ):
                    scheduled.add((name, rwl.key))
                    _heapq.heappush(
                        finish_events,
                        (clock.now() + runtime_s, seq, name, rwl.key),
                    )
                    seq += 1
        if all(w.is_finished for w in manager.workloads.values()):
            break
        if finish_events:
            t = max(clock.now(), finish_events[0][0])
            clock.set(t)
            while finish_events and finish_events[0][0] <= clock.now():
                _, _, name, key = _heapq.heappop(finish_events)
                rwl = workers[name].workloads.get(key)
                if rwl is None or rwl.is_finished:
                    continue
                rwl.set_condition(
                    WorkloadConditionType.FINISHED, True, "JobFinished",
                    "Job finished successfully", now=clock.now(),
                )
                workers[name].on_workload_finished(rwl)
        else:
            clock.advance(runtime_s / 2)
        manager.run_until_idle()
        passes += 1
    wall_s = time.perf_counter() - t_start
    admitted = sum(
        1
        for w in manager.workloads.values()
        if w.is_finished or w.is_admitted
    )
    return FedScaleResult(
        wall_s=wall_s,
        virtual_s=clock.now(),
        n_workers=n_workers,
        total=n_workloads,
        admitted=admitted,
        passes=passes,
        fanout_pass_ms=fanout_pass_ms,
        rescore_passes=gs.rescores,
        rescore_ms_per_cycle=(
            gs.rescore_ms_total / gs.rescores if gs.rescores else 0.0
        ),
        aggregate_ms_per_cycle=(
            gs.aggregate_ms_total / gs.rescores if gs.rescores else 0.0
        ),
        rebalances=gs.rebalances,
        retractions_acked=_acked_retractions(manager),
    )


def _acked_retractions(manager) -> int:
    """Cumulative acked retractions from the metrics surface (the
    in-memory maps are GCd with their finished dispatch states)."""
    import re as _re

    m = getattr(manager, "metrics", None)
    if m is None:
        return 0
    match = _re.search(
        r'kueue_multikueue_retractions_total\{outcome="acked"\} (\d+)',
        m.registry.expose(),
    )
    return int(match.group(1)) if match else 0


@dataclass
class MKRangeSpec:
    """Floors for the at-scale dispatch run (the multikueue e2e's
    all-dispatched / no-orphan assertions plus wire-efficiency floors
    the batched path is for)."""

    require_all_finished: bool = True
    max_unbatched_creates: int = 0
    min_avg_batch: float = 2.0  # batching actually amortizes the wire
    min_races: int = 1  # the first-reserving race path really ran
    # every worker must carry a real share of the load (spread emerges
    # from race resolution + freed-quota waves, not round-robin)
    min_winner_share: float = 0.05
    max_remote_leftovers: int = 0
    max_wall_s: Optional[float] = None


def check_mk(result: MKRunResult, spec: MKRangeSpec) -> List[str]:
    errs: List[str] = []
    if spec.require_all_finished and result.finished < result.total:
        errs.append(f"finished {result.finished}/{result.total} workloads")
    if result.unbatched_creates > spec.max_unbatched_creates:
        errs.append(
            f"{result.unbatched_creates} creates bypassed the batched exchange"
        )
    if result.batched_exchanges and result.avg_batch < spec.min_avg_batch:
        errs.append(
            f"avg batch {result.avg_batch:.1f} < {spec.min_avg_batch}"
        )
    if result.first_reserving_races < spec.min_races:
        errs.append(
            f"only {result.first_reserving_races} first-reserving races "
            f"(scenario exercises no contention)"
        )
    if len(result.winner_counts) < result.n_workers:
        # a worker absent from winner_counts won NOTHING — exactly the
        # rotation-collapse regression the share floor exists to catch
        errs.append(
            f"only {len(result.winner_counts)}/{result.n_workers} workers "
            f"ever won a dispatch"
        )
    for name, wins in result.winner_counts.items():
        if wins / max(result.total, 1) < spec.min_winner_share:
            errs.append(
                f"{name} won only {wins}/{result.total} dispatches "
                f"(< {spec.min_winner_share:.0%} share)"
            )
    if result.remote_leftovers > spec.max_remote_leftovers:
        errs.append(
            f"{result.remote_leftovers} origin-labeled remotes survived GC"
        )
    if spec.max_wall_s is not None and result.wall_s > spec.max_wall_s:
        errs.append(f"wall time {result.wall_s:.1f}s > {spec.max_wall_s}s")
    return errs


MULTIKUEUE_RANGE_SPEC = MKRangeSpec()


def record_rescores(reports: list):
    """An ``on_scheduler`` hook for ``run_federation_scale`` that appends
    every rescore pass's report to ``reports``."""

    def hook(gs):
        real = gs.rescore

        def rescore(apply: bool = True) -> dict:
            report = real(apply)
            reports.append(report)
            return report

        gs.rescore = rescore

    return hook


def rebalance_digest(reports: list) -> str:
    """sha256 of every applied rebalance, in order, as (workload, from,
    to, gainS): what two federation runs must agree on."""
    import hashlib
    import json

    moves = [
        (m["workload"], m["from"], m["to"], m["gainS"])
        for r in reports
        for m in r["rebalanced"]
    ]
    return hashlib.sha256(json.dumps(moves).encode()).hexdigest()


def fed_scale_summary(result: FedScaleResult) -> dict:
    """A ``FedScaleResult``'s fields but the host-clock ones (walls and
    per-pass milliseconds)."""
    return {
        "n_workers": result.n_workers,
        "total": result.total,
        "admitted": result.admitted,
        "passes": result.passes,
        "rescore_passes": result.rescore_passes,
        "rebalances": result.rebalances,
        "retractions_acked": result.retractions_acked,
        "virtual_s": result.virtual_s,
    }


#: ``fed_scale_summary(run_federation_scale())`` (50 workers, 200
#: workloads), from the JAX package on the CPU
FED_SCALE_EXPECT = {
    "n_workers": 50,
    "total": 200,
    "admitted": 200,
    "passes": 5,
    "rescore_passes": 5,
    "rebalances": 24,
    "retractions_acked": 224,
    "virtual_s": 1200.0,
}
#: ``rebalance_digest`` of that run's rescore reports, from the JAX
#: package on the CPU; its rescores with pending rows score 108, 45 and
#: 10 workloads (three B15 launches)
FED_REBALANCE_DIGEST = "27c4aff44b9ab4256cc214423d2a2033c7d5d9acab4355cff0836d518643c742"
FED_RESCORE_PENDING = (108, 45, 10)
