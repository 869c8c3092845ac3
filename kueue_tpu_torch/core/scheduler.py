"""The admission scheduler — one cycle of the hot path.

Behavioral equivalent of ``pkg/scheduler/scheduler.go``: pop the head of
every ClusterQueue, snapshot the cache, nominate (validate + flavor
assignment + preemption target search + partial-admission reduction),
order entries (non-borrowing first, then priority, then FIFO — or the
fair-sharing tournament), then admit one-by-one with usage re-checks so
parallel nominations can't double-book quota; leftovers are requeued
with the right reason and a Pending status.

The flavor assignment and quota math run over the dense Snapshot; the
batched solver (ops/assign_kernel.py, two CUDA kernels on the card)
accelerates nomination for large head counts while this module remains
the decision authority.

Port of kueue_tpu/core/scheduler.py. The cycle's device work runs on
``device`` (the card unless the caller names the CPU): the cycle solve
and, for preempt-mode heads, the batched victim search
(core/preempt_batch, kernel B8). ``use_preempt_solver=True`` batches
every cycle's deferred heads; the default ``None`` batches a cycle that
defers ``preempt_solver_threshold`` or more heads while the measured
device time beats the host Preemptor's (its first probe always
batches), as the JAX package does; ``False`` searches on the host as
each head is assigned. Each preempting entry's ``victim_search`` reads
"device" or "host" accordingly. With ``fair_sharing=True`` admissions
pop in the lazy fair-sharing tournament order
(core/fair_sharing_iterator), the usage re-check keeps the reference's
remove/revert shape, and a fair-sharing Preemptor's deferred heads are
searched by kernel B9 (the fair victim tournament). A ``KernelError``
from the batched search propagates, and so does a fault of B8 or B9 on
the card, which surfaces at the search's fetch and is raised there as
one; any other exception (of the host lowering) degrades that cycle's
search to the host loop, as in the JAX package. A non-default admission
``policy`` (kueue_tpu_torch/policy) is compiled onto each cycle's
lowered batch before dispatch (candidate scores, priority boosts), is
handed to the FlavorAssigner, and its per-head score breakdown rides
each decision record (``scores``).
"""

from __future__ import annotations

import functools
import time as _time
from collections import deque
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from kueue_tpu_torch.models import Workload
from kueue_tpu_torch.models.constants import (
    InadmissibleReason,
    WorkloadConditionType,
    classify_inadmissible_message,
)
from kueue_tpu_torch.core.audit import DecisionAuditLog, DecisionRecord
from kueue_tpu_torch.core.guard import QuarantineList, SolverGuard, bisect_poison
from kueue_tpu_torch.ops import _build
from kueue_tpu_torch.ops._build import KernelError
from kueue_tpu_torch.core.flavor_assigner import (
    AssignmentResult,
    FlavorAssigner,
    Mode,
    find_max_counts,
    normalize_reasons,
)
from kueue_tpu_torch.core.queue_manager import QueueManager, RequeueReason, queue_order_timestamp
from kueue_tpu_torch.core.snapshot import Snapshot, WorkloadSnapshot, take_snapshot
from kueue_tpu_torch.utils.clock import Clock
from kueue_tpu_torch.utils.priority import priority_of


class EntryStatus(str, Enum):
    NOT_NOMINATED = ""
    NOMINATED = "nominated"
    SKIPPED = "skipped"
    ASSUMED = "assumed"


@dataclass
class PreemptionTarget:
    workload: WorkloadSnapshot
    reason: str = "InClusterQueue"


@dataclass
class Entry:
    workload: Workload
    cq_name: str
    assignment: Optional[AssignmentResult] = None
    status: EntryStatus = EntryStatus.NOT_NOMINATED
    inadmissible_msg: str = ""
    requeue_reason: RequeueReason = RequeueReason.GENERIC
    preemption_targets: List[PreemptionTarget] = field(default_factory=list)
    # decision-attribution breadcrumbs for the audit trail: which engine
    # nominated this entry and which ran its victim search
    nominated_via: str = "host"
    victim_search: str = ""


class Preemptor:
    """Interface the scheduler drives; ops implementation in
    core/preemption.py (classic + fair sharing)."""

    def get_targets(
        self, wl: Workload, cq_name: str, assignment: AssignmentResult, snapshot: Snapshot
    ) -> List[PreemptionTarget]:
        return []

    def issue_preemptions(
        self, preemptor: Workload, targets: List[PreemptionTarget]
    ) -> int:
        return 0

    def is_reclaim_possible(
        self, snapshot: Snapshot, cq_name: str, wl: Workload, fr, quantity: int
    ) -> bool:
        return False


class _LatencyEstimate:
    """Windowed-min device-latency estimate with skip-erosion re-probe.

    The min over the last ``window`` measurements discards the one-time
    one-time set-up cost (kernel build) in the first sample, yet still RISES within
    ``window`` dispatches when the device genuinely slows down (a plain
    running min can only fall, so once skip-erosion pushed it below the
    true dispatch round trip the gate would lock onto the slower device
    path forever). Erosion accumulates on skipped cycles to force an
    eventual re-probe and resets on the next real measurement, so a
    re-probe that measures slow re-disables the device."""

    def __init__(self, window: int = 5, erosion_rate: float = 0.995):
        self._samples: deque = deque(maxlen=window)
        self._erosion_rate = erosion_rate
        self._erosion = 1.0

    @property
    def value(self) -> Optional[float]:
        if not self._samples:
            return None
        return min(self._samples) * self._erosion

    def observe(self, dt: float) -> None:
        self._samples.append(dt)
        self._erosion = 1.0

    def erode(self) -> None:
        self._erosion *= self._erosion_rate


@dataclass
class CycleTrace:
    """Per-cycle phase attribution — the pprof/log-attribution analog
    (reference: schedulingCycle counter + verbose snapshot/attempt
    dumps, pkg/scheduler/logging.go; the scalability harness' CPU
    profiles). Kept in Scheduler.last_traces (ring buffer), observed
    into the phase-duration histogram by the runtime, dumped by the
    debugger and served at /debug/cycles."""

    cycle: int = 0
    heads: int = 0
    admitted: int = 0
    preempting: int = 0
    resolution: str = "host"
    total_s: float = 0.0
    # phase -> seconds: snapshot / nominate / admit on the cycle path,
    # snapshot / classify / solve / apply on the bulk-drain path
    spans: Dict[str, float] = field(default_factory=dict)
    # device vs host attribution: time spent inside device dispatches
    # (assign/victim kernels, the drain solve) vs everything else
    device_s: float = 0.0
    host_s: float = 0.0
    # mesh annotation: "off" single-device, else the active mesh shape
    # ("wl=8", "wl=4,fr=2") the drain solves sharded over
    mesh: str = "off"
    # cycle span-tree id (kueue_tpu_torch/tracing): the phase timings above
    # are lowered into real parent/child spans under this trace, served
    # at /debug/traces/<id> and referenced by decision records
    trace_id: str = ""

    def to_dict(self) -> dict:
        out = {
            "cycle": self.cycle,
            "heads": self.heads,
            "admitted": self.admitted,
            "preempting": self.preempting,
            "resolution": self.resolution,
            "totalMs": round(self.total_s * 1e3, 3),
            "deviceMs": round(self.device_s * 1e3, 3),
            "hostMs": round(self.host_s * 1e3, 3),
            "mesh": self.mesh,
            "spansMs": {k: round(v * 1e3, 3) for k, v in self.spans.items()},
        }
        if self.trace_id:
            out["traceId"] = self.trace_id
        return out


@dataclass
class CycleResult:
    admitted: List[Entry] = field(default_factory=list)
    preempting: List[Entry] = field(default_factory=list)
    requeued: List[Entry] = field(default_factory=list)
    skipped_preemptions: Dict[str, int] = field(default_factory=dict)
    # which conflict-resolution path ran: "device" (the phase-2 kernel)
    # or "host" (sequential admit loop)
    resolution: str = "host"


@dataclass
class DevicePlan:
    """Device phase-2 outcome for a pure cycle: the admitted flags and
    entry order computed by ops/assign_kernel.solve_cycle, replayed by
    the host for bookkeeping only (no quota re-checks). ``via`` records
    which engine actually solved it — "device", or "host-mirror" when
    the guard routed the batch to the numpy twin (circuit open /
    forced host mode / divergence quarantine)."""

    entries: List[Entry]
    admitted: "np.ndarray"  # bool[W]
    order: "np.ndarray"  # int32[>=W], device entry order
    via: str = "device"


class Scheduler:
    def __init__(
        self,
        queues: QueueManager,
        cache: Cache,
        clock: Clock,
        preemptor: Optional[Preemptor] = None,
        fair_sharing: bool = False,
        partial_admission: bool = True,
        apply_admission: Optional[Callable[[Workload], bool]] = None,
        wait_for_pods_ready_block: bool = False,
        tas_check=None,
        tas_assign=None,
        tas_fits=None,
        events: Optional[Callable[[str, Workload, str], None]] = None,
        limit_range_validate: Optional[Callable[[Workload], Optional[str]]] = None,
        use_solver: Optional[bool] = None,
        solver_threshold: int = 16,
        use_preempt_solver: Optional[bool] = None,
        preempt_solver_threshold: int = 4,
        transform_config=None,  # ResourceTransformConfig (quota view)
        audit: Optional[DecisionAuditLog] = None,
        guard: Optional[SolverGuard] = None,
        quarantine: Optional[QuarantineList] = None,
        tracer=None,  # tracing.Tracer; None = a private always-on one
        policy=None,  # kueue_tpu_torch/policy AdmissionPolicy; None/first-fit
        #               = score-free nomination (bit-for-bit pre-policy)
        device=None,  # torch device of the cycle solve (cuda unless "cpu")
    ):
        from kueue_tpu_torch._torch import resolve_device

        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # build and load the cycle's kernels now: a card without a
            # working toolchain raises here, not mid-cycle
            if use_solver is not False:
                _build.load(_build.CYCLE_KERNELS)
            if use_preempt_solver is not False:
                _build.load(_build.PREEMPT_CYCLE_KERNELS + _build.FAIR_CYCLE_KERNELS)
        self.queues = queues
        self.cache = cache
        # One authoritative priority-class store: heap head ordering
        # (queues) and entry ordering / snapshots (cache) must resolve
        # priorities identically.
        if queues.priority_classes is not cache.priority_classes:
            cache.priority_classes.update(queues.priority_classes)
            queues.priority_classes = cache.priority_classes
        self.clock = clock
        self.preemptor = preemptor or Preemptor()
        self.fair_sharing = fair_sharing
        self.partial_admission = partial_admission
        # durable-write hook; returning False simulates API failure
        self.apply_admission = apply_admission or (lambda wl: True)
        self.wait_for_pods_ready_block = wait_for_pods_ready_block
        self.tas_check = tas_check
        self.tas_assign = tas_assign
        self.tas_fits = tas_fits
        self.events = events or (lambda kind, wl, msg: None)
        self.limit_range_validate = limit_range_validate
        # Batched device solver as the production nomination path: None =
        # auto (on when the cycle has >= solver_threshold assignable
        # heads), True = always, False = never (host-only oracle path).
        self.use_solver = use_solver
        self.solver_threshold = solver_threshold
        # Batched victim search for preempt-mode heads (kernel B8): None
        # = auto (batched when a cycle defers >= preempt_solver_threshold
        # heads and the device estimate wins), True = always, False =
        # never (host Preemptor, searched as each head is assigned).
        self.use_preempt_solver = use_preempt_solver
        self.preempt_solver_threshold = preempt_solver_threshold
        self.transform_config = transform_config
        # active admission policy (kueue_tpu_torch/policy); the audit
        # breakdown below explains scored flavor choices per cycle
        self.policy = policy
        # workload key -> flavor score breakdown of the LAST nomination
        # (cleared per cycle; consumed by _decision_of)
        self._cycle_scores: Dict[str, dict] = {}
        # distributed tracing (kueue_tpu_torch/tracing): cycle span trees are
        # buffered per cycle and flushed atomically with the CycleTrace;
        # a bare Scheduler gets its own tracer, ClusterRuntime shares
        # one across scheduler/audit/guard/journal
        if tracer is None:
            from kueue_tpu_torch.tracing import Tracer

            tracer = Tracer(clock=clock)
        self.tracer = tracer
        # per-workload decision audit trail; both resolution paths (and
        # the runtime's bulk drain) record through the same log
        self.audit = audit if audit is not None else DecisionAuditLog(clock=clock)
        if self.audit.tracer is None:
            self.audit.tracer = self.tracer
        # Resilient solver executor (core/guard.py): exception
        # containment + wall-clock deadline around every device launch,
        # device-path circuit breaker with host-mirror failover, sampled
        # divergence detection. A bare Scheduler gets a hookless guard;
        # ClusterRuntime wires events/metrics/journal into it.
        self.guard = guard if guard is not None else SolverGuard(clock=clock)
        if getattr(self.guard, "tracer", None) is None:
            self.guard.tracer = self.tracer
        # Poison-workload quarantine: shared with the runtime (its TTL
        # sweep and kueuectl surface) when one is attached.
        self.quarantine = (
            quarantine if quarantine is not None else QuarantineList()
        )
        # runtime hooks fired when a workload enters quarantine (journal
        # record + gauge) — None outside a ClusterRuntime
        self.on_quarantine: Optional[Callable[[Workload, str], None]] = None
        self.scheduling_cycle = 0
        # per-cycle phase traces, newest last (ring buffer)
        self.last_traces = deque(maxlen=128)
        # First-class cycle-result hook: every completed cycle (host,
        # device, or runtime bulk drain) is delivered to these
        # callbacks — the public observation surface for preemption
        # reporting and admission spies (no monkeypatching schedule()).
        self.cycle_observers: List[Callable[[CycleResult], None]] = []
        # Latency-aware auto gating. A device dispatch pays a fixed
        # round-trip cost (launches and the result copy) that only
        # amortizes once the cycle batches enough heads, so auto mode
        # measures both paths at runtime and routes each cycle to the
        # cheaper one: EMA of the host cost per head, windowed MIN of
        # the observed dispatch wall time (see _LatencyEstimate for why
        # windowed: a running min can only fall, which let skip-erosion
        # permanently lock the gate onto a slow device).
        self._host_assign_ema: Optional[float] = None  # s/head
        self._device_dispatch_est = _LatencyEstimate()  # s/dispatch
        self._host_victim_ema: Optional[float] = None  # s/deferred head
        self._device_victim_est = _LatencyEstimate()  # s/batch
        # device-resident quota tensors for the interactive dispatch:
        # per cycle only changed usage rows + the heads batch transfer
        # (core/solver.ResidentCycleState)
        self._resident_state = None
        # device time accumulated by the CURRENT cycle's dispatches
        # (assign + victim kernels), folded into its CycleTrace
        self._cycle_device_s = 0.0

    # ---- the cycle (scheduler.go:176-310) ----
    def schedule(self) -> CycleResult:
        self.scheduling_cycle += 1
        result = CycleResult()
        trace = CycleTrace(cycle=self.scheduling_cycle)
        self._cycle_device_s = 0.0
        self._cycle_scores.clear()
        t0 = _time.perf_counter()
        self.guard.begin_cycle()

        heads = self.queues.heads()
        trace.heads = len(heads)
        if not heads:
            self.notify_cycle(result)
            return result
        # open the cycle span-tree buffer: mid-cycle spans (divergence
        # checks, fsyncs) and decision records reference its trace id;
        # _finish_trace flushes it atomically, a crashed cycle drops it
        self.tracer.next_cycle(self.scheduling_cycle)
        trace.spans["heads"] = _time.perf_counter() - t0
        try:
            return self._schedule_guarded(heads, result, trace, t0)
        except KernelError:
            raise  # a kernel that cannot run is not contained (core/guard.py)
        except Exception as exc:  # noqa: BLE001 — the cycle guard's
            # outer containment: an escaped phase exception must cost
            # this cycle's decisions, never the scheduler itself.
            # InjectedCrash (simulated power loss) is a BaseException
            # and passes through untouched.
            return self._contain_cycle_failure(heads, result, trace, t0, exc)

    def _schedule_guarded(self, heads, result, trace, t0) -> CycleResult:
        t1 = _time.perf_counter()
        snapshot = take_snapshot(self.cache)
        trace.spans["snapshot"] = _time.perf_counter() - t1
        self.guard.phase_checkpoint("snapshot")
        t1 = _time.perf_counter()
        entries, device_plan = self._nominate(heads, snapshot)
        trace.spans["nominate"] = _time.perf_counter() - t1
        self.guard.phase_checkpoint(
            "nominate", device_used=self._cycle_device_s > 0
        )
        # crash-consistency fault point: nomination (host walk or device
        # solve) is complete, nothing has been applied or journaled yet
        from kueue_tpu_torch.testing import faults

        faults.fire("cycle.post_solve_pre_apply")
        if device_plan is not None:
            t2 = _time.perf_counter()
            out = self._finalize_device(entries, device_plan, snapshot, result)
            trace.spans["admit"] = _time.perf_counter() - t2
            self.guard.phase_checkpoint(
                "admit", device_used=self._cycle_device_s > 0
            )
            self._finish_trace(trace, out, t0)
            self._audit_cycle(entries, out)
            self.notify_cycle(out)
            return out
        t2 = _time.perf_counter()  # 'admit' includes the entry ordering
        ordered = self._iterate(entries, snapshot)

        preempted_keys: Dict[str, WorkloadSnapshot] = {}
        # Incremental removal: once an entry's targets are accepted they
        # STAY removed from the snapshot (the reference removes + reverts
        # every accumulated target per fits() call — scheduler.go:380-388
        # — which is O(entries x targets) churn; keeping them removed is
        # observationally identical for every later fits() since those
        # remove the same set again). removed_acc reconstructs the
        # pre-removal rows for resourcesToReserve, which the reference
        # evaluates WITH preempted workloads still present. The fair-
        # sharing iterator reads snapshot usage between pops, so that
        # path keeps the reference's remove/revert shape.
        incremental = not self.fair_sharing
        removed_acc: Optional[np.ndarray] = (
            np.zeros_like(snapshot.local_usage) if incremental else None
        )
        for e in ordered:
            if e.assignment is None:
                continue
            mode = e.assignment.representative_mode()
            if mode == Mode.NO_FIT:
                continue

            if mode == Mode.PREEMPT and not e.preemption_targets:
                # Nobody to preempt. Reserve capacity unless reclaim is
                # always possible later (scheduler.go:228-242).
                from kueue_tpu_torch.core.preemption import can_always_reclaim

                cq = snapshot.cq_models[e.cq_name]
                if not can_always_reclaim(cq):
                    snapshot.add_usage(
                        e.cq_name, self._reserve_vector(e, snapshot, removed_acc)
                    )
                continue

            if any(
                t.workload.workload.key in preempted_keys
                for t in e.preemption_targets
            ):
                e.status = EntryStatus.SKIPPED
                e.inadmissible_msg = (
                    "Workload has overlapping preemption targets with another workload"
                )
                result.skipped_preemptions[e.cq_name] = (
                    result.skipped_preemptions.get(e.cq_name, 0) + 1
                )
                continue

            usage_vec = snapshot.vector_of(e.assignment.usage)
            own_removed: List[WorkloadSnapshot] = []
            if incremental:
                for t in e.preemption_targets:
                    ws = snapshot.remove_workload(t.workload.workload.key)
                    if ws is not None:
                        own_removed.append(ws)
                fits_now = snapshot.fits(e.cq_name, usage_vec)
            else:
                fits_now = self._fits_after_removals(
                    snapshot, e, usage_vec, preempted_keys
                )
            if not fits_now:
                for ws in own_removed:
                    snapshot.add_workload(ws)
                e.status = EntryStatus.SKIPPED
                e.inadmissible_msg = (
                    "Workload no longer fits after processing another workload"
                )
                if mode == Mode.PREEMPT:
                    result.skipped_preemptions[e.cq_name] = (
                        result.skipped_preemptions.get(e.cq_name, 0) + 1
                    )
                continue

            # Re-validate topology assignments against in-cycle TAS
            # usage: quota fits() above is blind to domain capacity, but
            # an earlier admission this cycle may have taken the same
            # rack/host (reference Fits' TAS branch,
            # clusterqueue_snapshot.go:135-149).
            if (
                mode == Mode.FIT
                and self.tas_fits is not None
                and any(
                    ps.topology_assignment is not None
                    for ps in e.assignment.pod_sets
                )
            ):
                tas_msg = self.tas_fits(
                    e.workload, e.cq_name, e.assignment, snapshot
                )
                if tas_msg:
                    for ws in own_removed:
                        snapshot.add_workload(ws)
                    e.status = EntryStatus.SKIPPED
                    e.inadmissible_msg = tas_msg
                    continue

            for t in e.preemption_targets:
                preempted_keys[t.workload.workload.key] = t.workload
            if removed_acc is not None:
                for ws in own_removed:
                    removed_acc[ws.cq_row] += ws.usage_vec
            snapshot.add_usage(e.cq_name, usage_vec)

            if mode == Mode.PREEMPT:
                e.workload.last_assignment = None
                n = self.preemptor.issue_preemptions(
                    e.workload, e.preemption_targets, preempting_cq=e.cq_name
                )
                if n:
                    e.inadmissible_msg += (
                        f". Pending the preemption of {n} workload(s)"
                    )
                    e.requeue_reason = RequeueReason.PENDING_PREEMPTION
                result.preempting.append(e)
                continue

            if self.wait_for_pods_ready_block and self.cache.workloads_not_ready:
                e.status = EntryStatus.SKIPPED
                e.inadmissible_msg = (
                    "waiting for all admitted workloads to be in PodsReady condition"
                )
                continue

            e.status = EntryStatus.NOMINATED
            if self._admit(e, snapshot):
                result.admitted.append(e)

        for e in entries:
            if e.status != EntryStatus.ASSUMED:
                self._requeue_and_update(e)
                result.requeued.append(e)
        trace.spans["admit"] = _time.perf_counter() - t2
        self.guard.phase_checkpoint(
            "admit", device_used=self._cycle_device_s > 0
        )
        self._finish_trace(trace, result, t0)
        self._audit_cycle(entries, result)
        self.notify_cycle(result)
        return result

    # ---- cycle guard: containment + poison attribution ----
    def _contain_cycle_failure(
        self, heads, result: CycleResult, trace, t0, exc: Exception
    ) -> CycleResult:
        """An exception escaped a cycle phase. The cycle is charged,
        never the scheduler: admissions that committed before the raise
        stand (they are in the cache and in ``result.admitted``); every
        other popped head is requeued so nothing is stranded. Poison
        attribution runs a side-effect-free nomination probe over the
        heads and bisects to the offender(s); a head that keeps doing
        this crosses the strike threshold and is quarantined."""
        self.guard.note_contained_cycle(exc)
        for wl in bisect_poison(list(heads), self._nomination_probe):
            msg = self._poison_strike(wl, exc)
            wl.set_condition(
                WorkloadConditionType.QUOTA_RESERVED, False,
                reason=classify_inadmissible_message(msg).value,
                message=msg, now=self.clock.now(),
            )
        for wl in heads:
            if wl.key in self.cache.assumed_workloads or self._is_admitted(wl):
                continue
            # FAILED_AFTER_NOMINATION: straight back onto the heap (a
            # GENERIC requeue would park every innocent head in the
            # inadmissible lot with nothing to reactivate it — the
            # contained cycle must cost a retry, not the backlog)
            self.queues.requeue_workload(
                wl, RequeueReason.FAILED_AFTER_NOMINATION
            )
        self._finish_trace(trace, result, t0)
        self.notify_cycle(result)
        return result

    def _nomination_probe(self, subset) -> None:
        """Re-run prevalidation + host flavor assignment for a subset of
        heads against a throwaway snapshot — raises iff the subset
        contains a head whose scheduling raises. Side-effect-free: the
        snapshot is private and the flavor cursors are restored."""
        snap = take_snapshot(self.cache)
        saved = [(wl, wl.last_assignment) for wl in subset]
        try:
            _entries, to_assign = self._prevalidate(list(subset), snap)
            assigner = self._make_assigner(snap)
            for e in to_assign:
                self._host_assign(assigner, e, snap, None)
        finally:
            for wl, la in saved:
                wl.last_assignment = la

    def _poison_strike(self, wl: Workload, exc) -> str:
        """One contained failure attributed to this head: strike it,
        quarantine at the threshold. Returns the cycle's
        inadmissibility message (classifies to SCHEDULING_FAILURE /
        QUARANTINED)."""
        n = self.quarantine.strike(wl.key)
        if n >= self.quarantine.threshold:
            msg = (
                f"The workload is quarantined after {n} scheduling "
                f"failures (last: {exc!r})"
            )
            self._do_quarantine(wl, msg)
            return msg
        return (
            f"Workload raised during scheduling ({exc!r}); strike "
            f"{n}/{self.quarantine.threshold} toward quarantine"
        )

    def _do_quarantine(self, wl: Workload, msg: str) -> None:
        now = self.clock.now()
        self.quarantine.add(wl.key, msg, now)
        wl.set_condition(
            WorkloadConditionType.QUOTA_RESERVED, False,
            reason=InadmissibleReason.QUARANTINED.value,
            message=msg, now=now,
        )
        self.events("WorkloadQuarantined", wl, msg)
        if self.on_quarantine is not None:
            self.on_quarantine(wl, msg)

    def _contain_head_failure(self, e: Entry, exc: Exception) -> None:
        """Per-head exception containment in the nomination loops: the
        head costs itself, not the cycle. Attribution is exact here, so
        no bisection is needed."""
        e.assignment = None
        e.preemption_targets = []
        e.inadmissible_msg = self._poison_strike(e.workload, exc)

    def notify_cycle(self, result: CycleResult) -> None:
        for cb in list(self.cycle_observers):
            cb(result)

    def _finish_trace(self, trace: "CycleTrace", result: CycleResult, t0) -> None:
        trace.total_s = _time.perf_counter() - t0
        trace.admitted = len(result.admitted)
        trace.preempting = len(result.preempting)
        trace.resolution = result.resolution
        trace.device_s = self._cycle_device_s
        trace.host_s = max(trace.total_s - self._cycle_device_s, 0.0)
        # the phase timings above, lowered into a real span tree (one
        # atomic flush — a cycle that never reaches here leaks nothing)
        self.tracer.record_cycle(trace)
        self.last_traces.append(trace)

    # ---- decision audit (core/audit.py) ----
    def _audit_cycle(self, entries: List[Entry], result: CycleResult) -> None:
        if self.audit is None:
            return
        preempting = {id(e) for e in result.preempting}
        for e in entries:
            self.audit.record(
                self._decision_of(e, result.resolution, id(e) in preempting)
            )

    def _decision_of(
        self, e: Entry, resolution: str, is_preempting: bool
    ) -> DecisionRecord:
        """Lower one entry's cycle outcome into a DecisionRecord. Both
        resolution paths funnel through here, so an identical scenario
        attributes identically whether the device scan or the host loop
        decided it."""
        a = e.assignment
        flavors: Dict[str, Dict[str, str]] = {}
        flavor_reasons: Dict[str, List[str]] = {}
        topology: Optional[dict] = None
        borrowing = False
        if a is not None:
            borrowing = a.borrowing
            for ps in a.pod_sets:
                if ps.flavors:
                    flavors[ps.name] = {
                        res: c.name for res, c in sorted(ps.flavors.items())
                    }
                if ps.reasons:
                    flavor_reasons[ps.name] = normalize_reasons(ps.reasons)
                ta = ps.topology_assignment
                if ta is not None:
                    topology = topology or {}
                    topology[ps.name] = {
                        "levels": list(ta.levels),
                        "domains": [
                            {"values": list(d.values), "count": d.count}
                            for d in ta.domains
                        ],
                    }
        preemption: Optional[dict] = None
        if e.preemption_targets:
            preemption = {
                "victims": [
                    {
                        "workload": t.workload.workload.key,
                        "reason": t.reason,
                    }
                    for t in e.preemption_targets
                ],
                "search": e.victim_search or "host",
            }
        elif a is not None and a.representative_mode() == Mode.PREEMPT:
            preemption = {"blocked": "no preemption candidates found"}

        if e.status == EntryStatus.ASSUMED:
            outcome, reason = "Admitted", InadmissibleReason.ADMITTED
        elif is_preempting:
            outcome = "Preempting"
            reason = (
                InadmissibleReason.PENDING_PREEMPTION
                if e.requeue_reason == RequeueReason.PENDING_PREEMPTION
                else InadmissibleReason.PREEMPTING
            )
        elif e.status == EntryStatus.SKIPPED:
            outcome = "Skipped"
            reason = classify_inadmissible_message(e.inadmissible_msg)
        else:
            outcome = "Pending"
            reason = classify_inadmissible_message(e.inadmissible_msg)

        cached = self.cache.cluster_queues.get(e.cq_name)
        cohort = cached.model.cohort or "" if cached is not None else ""
        return DecisionRecord(
            workload=e.workload.key,
            cluster_queue=e.cq_name,
            cycle=self.scheduling_cycle,
            outcome=outcome,
            reason=reason,
            message=e.inadmissible_msg,
            resolution=resolution,
            nominated_via=e.nominated_via,
            borrowing=borrowing,
            cohort=cohort,
            flavors=flavors,
            flavor_reasons=flavor_reasons,
            preemption=preemption,
            topology=topology,
            scores=self._cycle_scores.get(e.workload.key),
        )

    def _record_cycle_scores(self, lowered) -> None:
        """Per-head flavor score breakdown for the audit trail
        (kueue_tpu_torch/policy): score per candidate flavor set, the
        highest-scoring set, and the winning margin, so a decision
        record says WHY a flavor won. The actual assignment (which may
        differ when the top-scoring flavor doesn't fit) rides the
        record's ``flavors`` field."""
        score = lowered.score
        if score is None:
            return
        fallback = set(lowered.fallback)
        for i, wl in enumerate(lowered.heads):
            if i in fallback:
                continue
            per: Dict[str, int] = {}
            for k, fmap in enumerate(lowered.candidate_flavors[i]):
                if not fmap or k >= lowered.valid.shape[1]:
                    continue
                if not lowered.valid[i, k]:
                    continue
                sig = "+".join(sorted(set(fmap.values())))
                sc = int(score[i, k])
                if sig not in per or sc > per[sig]:
                    per[sig] = sc
            if not per:
                continue
            ranked = sorted(per.items(), key=lambda t: (-t[1], t[0]))
            margin = (
                ranked[0][1] - ranked[1][1] if len(ranked) > 1 else ranked[0][1]
            )
            self._cycle_scores[wl.key] = {
                "policy": self.policy.name,
                "perFlavor": per,
                "winner": ranked[0][0],
                "margin": margin,
            }

    # ---- nomination (scheduler.go:344-378) ----
    def _nominate(
        self, heads: List[Workload], snapshot: Snapshot
    ) -> Tuple[List[Entry], Optional[DevicePlan]]:
        entries, to_assign = self._prevalidate(heads, snapshot)
        if self._solver_enabled(len(to_assign)):
            plan = self._assign_with_solver(to_assign, snapshot)
            return entries, plan
        assigner = self._make_assigner(snapshot)
        deferred: List[Entry] = []
        t_host = _time.perf_counter()
        for e in to_assign:
            try:
                self._host_assign(assigner, e, snapshot, deferred)
            except Exception as exc:  # noqa: BLE001 — per-head guard:
                # the raising head costs itself, never the cycle
                self._contain_head_failure(e, exc)
        if to_assign:
            per_head = (_time.perf_counter() - t_host) / len(to_assign)
            self._host_assign_ema = (
                per_head
                if self._host_assign_ema is None
                else 0.8 * self._host_assign_ema + 0.2 * per_head
            )
        self._resolve_deferred(assigner, deferred, snapshot)
        return entries, None

    # cold-start guesses until the first real measurement lands
    _HOST_ASSIGN_DEFAULT = 1e-4  # s/head, host flavor loop
    _HOST_VICTIM_DEFAULT = 4e-3  # s/head, host victim search

    def _solver_enabled(self, n_assignable: int) -> bool:
        if self.use_solver is False or n_assignable == 0:
            return False
        if self.use_solver is True:
            return True
        if n_assignable < self.solver_threshold:
            return False
        device_est = self._device_dispatch_est.value
        if device_est is None:
            return True  # probe once; the measurement gates later cycles
        host_est = n_assignable * (
            self._host_assign_ema or self._HOST_ASSIGN_DEFAULT
        )
        if host_est >= device_est:
            return True
        self._device_dispatch_est.erode()  # stale-estimate re-probe
        return False

    def _victim_device_worthwhile(self, n_deferred: int) -> bool:
        device_est = self._device_victim_est.value
        if device_est is None:
            return True  # probe once
        host_est = n_deferred * (
            self._host_victim_ema or self._HOST_VICTIM_DEFAULT
        )
        if host_est >= device_est:
            return True
        self._device_victim_est.erode()
        return False

    def _make_assigner(self, snapshot: Snapshot) -> FlavorAssigner:
        return FlavorAssigner(
            snapshot,
            self.cache.flavors,
            enable_fair_sharing=self.fair_sharing,
            reclaim_oracle=functools.partial(self._reclaim_oracle, snapshot),
            tas_check=self.tas_check,
            transform=self.transform_config,
            policy=self.policy,
        )

    def _host_assign(
        self,
        assigner: FlavorAssigner,
        e: Entry,
        snapshot: Snapshot,
        deferred: Optional[List[Entry]] = None,
    ) -> None:
        """Assign flavors; preempt-mode entries are parked in
        ``deferred`` (when given) so the whole cycle's victim searches
        run in ONE batched launch (_resolve_deferred) instead of a
        sequential simulate/undo loop per head. All searches run
        against the cycle-start snapshot either way, so deferral cannot
        change decisions."""
        if deferred is not None and self.use_preempt_solver is not False:
            full = assigner.assign(e.workload, e.cq_name)
            if full.representative_mode() == Mode.PREEMPT:
                e.assignment = full
                deferred.append(e)
                return
            assignment, targets = self._finish_assignment(
                assigner, e.workload, e.cq_name, snapshot, full
            )
        else:
            assignment, targets = self._get_assignments(
                assigner, e.workload, e.cq_name, snapshot
            )
        e.assignment = assignment
        e.preemption_targets = targets
        e.inadmissible_msg = assignment.message()
        e.workload.last_assignment = assignment.last_state

    def _resolve_deferred(
        self, assigner: FlavorAssigner, deferred: List[Entry], snapshot: Snapshot
    ) -> None:
        """Victim search for every deferred preempt-mode entry: one
        launch of kernel B8 for the whole batch above the threshold
        (core/preempt_batch), the host Preemptor one head after another
        otherwise, both against the cycle-start snapshot."""
        if not deferred:
            return
        batch_on = self.use_preempt_solver is True or (
            self.use_preempt_solver is None
            and len(deferred) >= self.preempt_solver_threshold
            and self._victim_device_worthwhile(len(deferred))
        )
        t0 = _time.perf_counter()
        if batch_on:
            from kueue_tpu_torch.core.preempt_batch import batched_get_targets

            try:
                all_targets = batched_get_targets(
                    snapshot,
                    [(e.workload, e.cq_name, e.assignment) for e in deferred],
                    self.preemptor,
                    device=self.device,
                )
                dt = _time.perf_counter() - t0
                self._device_victim_est.observe(dt)
                self._cycle_device_s += dt
            except KernelError:
                raise  # a kernel that cannot run is not contained (core/guard.py)
            except Exception:  # noqa: BLE001 — any other failure of the
                # batched search degrades to the host loop, never the cycle
                batch_on = False
                t0 = _time.perf_counter()
        if not batch_on:
            all_targets = []
            for e in deferred:
                try:
                    all_targets.append(
                        self.preemptor.get_targets(
                            e.workload, e.cq_name, e.assignment, snapshot
                        )
                    )
                except Exception as exc:  # noqa: BLE001 — per-head guard
                    self._contain_head_failure(e, exc)
                    all_targets.append([])
            per_head = (_time.perf_counter() - t0) / len(deferred)
            self._host_victim_ema = (
                per_head
                if self._host_victim_ema is None
                else 0.8 * self._host_victim_ema + 0.2 * per_head
            )
        for e, targets in zip(deferred, all_targets):
            if e.assignment is None:
                continue  # contained above: strike message already set
            e.victim_search = "device" if batch_on else "host"
            try:
                if targets:
                    e.preemption_targets = targets
                else:
                    e.assignment, e.preemption_targets = self._finish_assignment(
                        assigner, e.workload, e.cq_name, snapshot, e.assignment
                    )
                e.inadmissible_msg = e.assignment.message()
                e.workload.last_assignment = e.assignment.last_state
            except Exception as exc:  # noqa: BLE001 — per-head guard
                self._contain_head_failure(e, exc)

    def _prevalidate(
        self, heads: List[Workload], snapshot: Snapshot
    ) -> Tuple[List[Entry], List[Entry]]:
        """Per-head admission preconditions (scheduler.go:361-369).
        Returns (all entries, the subset needing flavor assignment)."""
        entries: List[Entry] = []
        to_assign: List[Entry] = []
        for wl in heads:
            cq_name = self.queues.cluster_queue_for_workload(wl) or ""
            e = Entry(workload=wl, cq_name=cq_name)
            entries.append(e)
            if wl.key in self.cache.assumed_workloads or self._is_admitted(wl):
                entries.pop()  # already assumed/admitted: drop silently
                continue
            if self.quarantine.active(wl.key, self.clock.now()):
                # sidelined poison head: never nominated until its TTL
                # lapses or an operator clears it (kueuectl quarantine)
                q = self.quarantine.get(wl.key)
                e.inadmissible_msg = (
                    f"The workload is quarantined until t={q.until:.0f}: "
                    f"{q.message}"
                )
                continue
            if not wl.is_active():
                e.inadmissible_msg = "The workload is deactivated"
                continue
            if wl.has_retry_check() or wl.has_rejected_check():
                e.inadmissible_msg = "The workload has failed admission checks"
                continue
            if cq_name in snapshot.inactive_cqs:
                e.inadmissible_msg = f"ClusterQueue {cq_name} is inactive"
                continue
            if cq_name not in snapshot.cq_models:
                e.inadmissible_msg = f"ClusterQueue {cq_name} not found"
                continue
            cq = snapshot.cq_models[cq_name]
            ns_labels = self.queues.namespace_labels(wl.namespace)
            if not cq.selects_namespace(ns_labels):
                e.inadmissible_msg = (
                    "Workload namespace doesn't match ClusterQueue selector"
                )
                e.requeue_reason = RequeueReason.NAMESPACE_MISMATCH
                continue
            if self.limit_range_validate is not None:
                err = self.limit_range_validate(wl)
                if err:
                    e.inadmissible_msg = err
                    continue
            to_assign.append(e)
        return entries, to_assign

    # ---- batched nomination on the device (the production hot path) ----
    def _assign_with_solver(
        self, to_assign: List[Entry], snapshot: Snapshot
    ) -> Optional[DevicePlan]:
        """Nominate every assignable head in one device dispatch
        (ops/assign_kernel.solve_cycle_segmented_packed); heads the dense formulation
        can't represent — multi-podset, non-default fungibility, TAS,
        candidate overflow — and heads the kernel classifies non-Fit
        (potential preemption) fall back to the host FlavorAssigner,
        which remains the decision authority for them.

        The launch itself runs under the SolverGuard: a raising/late
        device dispatch (or an open circuit / divergence quarantine)
        resolves the same lowered batch on the numpy host mirror
        instead — per-head host fallback is the last resort when even
        lowering fails.

        Returns a DevicePlan when the whole cycle is resolvable from
        the device phase-2 scan (every host-path entry is NO_FIT with
        no preemption targets, so no usage interleaving outside the
        device model); otherwise None, and the host admit loop runs
        over the device-assigned entries.
        """
        from kueue_tpu_torch.core.solver import dispatch_lowered, lower_heads

        heads = [(e.workload, e.cq_name) for e in to_assign]
        try:
            lowered = lower_heads(
                snapshot,
                heads,
                self.cache.flavors,
                timestamp_fn=lambda wl: queue_order_timestamp(wl, self.queues._ts_policy),
                transform=self.transform_config,
            )
        except Exception as exc:  # noqa: BLE001 — batch-level lowering
            # failure: bisect to the poison head(s), host path for the
            # rest (per-head contained)
            self._bisect_lowering_failure(to_assign, snapshot, exc)
            return None
        if self.policy is not None and not self.policy.is_default:
            # compile the policy's score tensors onto the batch BEFORE
            # the guard sees it: the device kernel and the host mirror
            # both read lowered.score, so divergence checks stay sound
            from kueue_tpu_torch.policy import annotate_lowered

            annotate_lowered(self.policy, lowered, now=self.clock.now())
            self._record_cycle_scores(lowered)
        fallback = set(lowered.fallback)
        if len(fallback) == len(to_assign):
            # nothing representable: skip the device dispatch entirely
            self._host_assign_contained(to_assign, snapshot)
            return None
        if self._resident_state is None:
            from kueue_tpu_torch.core.solver import ResidentCycleState

            self._resident_state = ResidentCycleState(self.device)
        outcome = self.guard.solve(
            snapshot,
            lowered,
            dispatch=lambda: dispatch_lowered(
                snapshot, lowered, resident=self._resident_state
            ),
        )
        if outcome.result is None:
            # device failed AND the host mirror raised (a poison head
            # corrupting the batch): per-head host fallback decides
            self._host_assign_contained(to_assign, snapshot)
            return None
        if outcome.device_dt is not None:
            self._device_dispatch_est.observe(outcome.device_dt)
            self._cycle_device_s += outcome.device_dt
        res = outcome.result
        chosen = np.asarray(res.chosen)
        host_idx = [
            i
            for i in range(len(to_assign))
            if i in fallback or chosen[i] < 0
        ]
        if host_idx:
            self._host_assign_contained(
                [to_assign[i] for i in host_idx], snapshot
            )
        host_set = set(host_idx)
        for i, e in enumerate(to_assign):
            if i in host_set:
                continue
            e.nominated_via = outcome.via
            e.assignment = self._assignment_from_device(
                lowered, i, int(chosen[i]), snapshot
            )
            e.workload.last_assignment = e.assignment.last_state

        # Pure cycle: nothing host-side can mutate usage, so the device
        # scan's admitted flags ARE the cycle outcome.
        pure = (
            not self.fair_sharing
            and all(
                to_assign[i].assignment is not None
                and to_assign[i].assignment.representative_mode() == Mode.NO_FIT
                and not to_assign[i].preemption_targets
                for i in host_idx
            )
        )
        if not pure:
            return None
        return DevicePlan(
            entries=to_assign,
            admitted=np.asarray(res.admitted),
            order=np.asarray(res.order),
            via=outcome.via,
        )

    def _host_assign_contained(
        self, entries: List[Entry], snapshot: Snapshot
    ) -> None:
        """Host FlavorAssigner pass with per-head exception containment
        — the guard's last-resort fallback and the device path's
        host-side companion for unrepresentable heads."""
        assigner = self._make_assigner(snapshot)
        deferred: List[Entry] = []
        for e in entries:
            try:
                self._host_assign(assigner, e, snapshot, deferred)
            except Exception as exc:  # noqa: BLE001 — per-head guard
                self._contain_head_failure(e, exc)
        self._resolve_deferred(assigner, deferred, snapshot)

    def _bisect_lowering_failure(
        self, to_assign: List[Entry], snapshot: Snapshot, exc: Exception
    ) -> None:
        """lower_heads raised for the whole batch — attribution needs
        the guard's bisection (the raise names no head). Poison heads
        are struck/quarantined; the rest nominate on the host path."""
        from kueue_tpu_torch.core.solver import lower_heads

        def probe(subset) -> None:
            lower_heads(
                snapshot,
                [(e.workload, e.cq_name) for e in subset],
                self.cache.flavors,
                timestamp_fn=lambda wl: queue_order_timestamp(
                    wl, self.queues._ts_policy
                ),
                transform=self.transform_config,
            )

        poison = bisect_poison(to_assign, probe)
        for e in poison:
            self._contain_head_failure(e, exc)
        poison_ids = {id(e) for e in poison}
        self._host_assign_contained(
            [e for e in to_assign if id(e) not in poison_ids], snapshot
        )

    def _assignment_from_device(
        self,
        lowered,
        i: int,
        k: int,
        snapshot: Snapshot,
    ) -> AssignmentResult:
        """Reconstruct the host-equivalent FIT AssignmentResult from the
        kernel's chosen candidate (single podset, default fungibility —
        lower_heads guarantees these invariants for non-fallback heads)."""
        from kueue_tpu_torch.core.flavor_assigner import (
            AssignmentState,
            FlavorChoice,
            GranularMode,
            PodSetResult,
        )
        from kueue_tpu_torch.core.workload_info import effective_podset_count

        wl = lowered.heads[i]
        cq_name = lowered.cq_names[i]
        ps = wl.pod_sets[0]
        count = effective_podset_count(wl, ps)
        flavor_map = lowered.candidate_flavors[i][k]
        tried_map = lowered.candidate_tried[i][k]
        r = snapshot.row(cq_name)
        psr = PodSetResult(name=ps.name, count=count)
        usage: Dict = {}
        result = AssignmentResult(pod_sets=[psr])
        cells = lowered.cells[i, k]
        qty = lowered.qty[i, k]
        for c in range(cells.shape[0]):
            j = int(cells[c])
            if j < 0:
                continue
            fr = snapshot.fr_list[j]
            q = int(qty[c])
            usage[fr] = usage.get(fr, 0) + q
            # per-resource borrow flag (flavorassigner.go:698): request
            # pushes the CQ above nominal in this cell
            borrow = bool(
                snapshot.local_usage[r, j] + q > snapshot.nominal[r, j]
            ) and snapshot.has_cohort(cq_name)
            if borrow:
                result.borrowing = True
            psr.flavors[fr.resource] = FlavorChoice(
                name=fr.flavor,
                mode=GranularMode.FIT,
                tried_flavor_idx=tried_map.get(fr.resource, -1),
                borrow=borrow,
            )
        result.usage = usage
        result.last_state = AssignmentState(
            last_tried_flavor_idx=[dict(tried_map)],
            cluster_queue_generation=snapshot.generations.get(cq_name, 0),
        )
        return result

    def _finalize_device(
        self,
        entries: List[Entry],
        plan: DevicePlan,
        snapshot: Snapshot,
        result: CycleResult,
    ) -> CycleResult:
        """Replay the device phase-2 outcome: admit flagged entries in
        device order (bookkeeping only — the scan already resolved
        conflicts), skip Fit entries the scan rejected, requeue the
        rest. Mirrors the tail of the host loop (scheduler.go:211-292)
        minus the per-entry quota re-checks."""
        result.resolution = plan.via
        for idx in plan.order:
            if idx >= len(plan.entries):
                continue  # padding rows
            e = plan.entries[int(idx)]
            if e.assignment is None:
                continue
            if e.assignment.representative_mode() != Mode.FIT:
                continue
            if bool(plan.admitted[int(idx)]):
                snapshot.add_usage(
                    e.cq_name, snapshot.vector_of(e.assignment.usage)
                )
                if self.wait_for_pods_ready_block and self.cache.workloads_not_ready:
                    e.status = EntryStatus.SKIPPED
                    e.inadmissible_msg = (
                        "waiting for all admitted workloads to be in PodsReady condition"
                    )
                    continue
                e.status = EntryStatus.NOMINATED
                if self._admit(e, snapshot):
                    result.admitted.append(e)
            else:
                e.status = EntryStatus.SKIPPED
                e.inadmissible_msg = (
                    "Workload no longer fits after processing another workload"
                )
        for e in entries:
            if e.status != EntryStatus.ASSUMED:
                self._requeue_and_update(e)
                result.requeued.append(e)
        return result

    def _is_admitted(self, wl: Workload) -> bool:
        cached = self.cache.cluster_queues.get(
            wl.admission.cluster_queue if wl.admission else ""
        )
        return cached is not None and wl.key in cached.workloads

    def _reclaim_oracle(
        self, snapshot: Snapshot, cq_name: str, wl: Workload, fr, quantity: int
    ) -> bool:
        return self.preemptor.is_reclaim_possible(snapshot, cq_name, wl, fr, quantity)

    # ---- assignment + preemption + partial admission (scheduler.go:423-468) ----
    def _get_assignments(
        self,
        assigner: FlavorAssigner,
        wl: Workload,
        cq_name: str,
        snapshot: Snapshot,
    ) -> Tuple[AssignmentResult, List[PreemptionTarget]]:
        full = assigner.assign(wl, cq_name)
        if full.representative_mode() == Mode.PREEMPT:
            targets = self.preemptor.get_targets(wl, cq_name, full, snapshot)
            if targets:
                return full, targets
        return self._finish_assignment(assigner, wl, cq_name, snapshot, full)

    def _finish_assignment(
        self,
        assigner: FlavorAssigner,
        wl: Workload,
        cq_name: str,
        snapshot: Snapshot,
        full: AssignmentResult,
    ) -> Tuple[AssignmentResult, List[PreemptionTarget]]:
        """Tail of getAssignments once preemption targets are known to
        be absent: TAS attach for Fit, else partial-admission search."""
        if full.representative_mode() == Mode.FIT:
            return self._with_tas(wl, cq_name, full, snapshot), []
        if self.partial_admission and any(
            ps.min_count is not None for ps in wl.pod_sets
        ):
            best: Optional[AssignmentResult] = None

            def try_counts(counts: Sequence[int]) -> AssignmentResult:
                nonlocal best
                a = assigner.assign(wl, cq_name, counts=counts)
                if a.representative_mode() == Mode.FIT:
                    best = a
                return a

            found = find_max_counts(try_counts, wl)
            if found is not None and best is not None:
                return self._with_tas(wl, cq_name, best, snapshot), []
        return full, []

    def _with_tas(
        self, wl: Workload, cq_name: str, assignment: AssignmentResult, snapshot: Snapshot
    ) -> AssignmentResult:
        if self.tas_assign is not None:
            return self.tas_assign(wl, cq_name, assignment, snapshot)
        return assignment

    # ---- ordering (scheduler.go:561-642) ----
    def _iterate(self, entries: List[Entry], snapshot: Snapshot):
        if self.fair_sharing:
            from kueue_tpu_torch.core.fair_sharing_iterator import fair_sharing_iter

            # lazy: each pop re-evaluates DRS against the snapshot as
            # mutated by admissions earlier in this cycle
            return fair_sharing_iter(entries, snapshot, self._fair_tie_key)
        return sorted(entries, key=self._entry_sort_key)

    def _fair_tie_key(self, e: "Entry"):
        """Non-DRS tournament tiebreak (fair_sharing_iterator.go less()):
        priority desc behind PrioritySortingWithinCohort, then FIFO."""
        from kueue_tpu_torch.features import enabled

        parts = []
        if enabled("PrioritySortingWithinCohort"):
            parts.append(-priority_of(e.workload, self.cache.priority_classes))
        parts.append(
            int(queue_order_timestamp(e.workload, self.queues._ts_policy) * 1e9)
        )
        return tuple(parts)

    def _entry_sort_key(self, e: Entry):
        borrows = e.assignment.borrowing if e.assignment else False
        prio = priority_of(e.workload, self.cache.priority_classes)
        # int-ns, matching the heap ranks and the device lexsort key so
        # every ordering surface agrees on near-ties
        ts = int(queue_order_timestamp(e.workload, self.queues._ts_policy) * 1e9)
        return (1 if borrows else 0, -prio, ts)

    # ---- usage re-check (scheduler.go:380-388) ----
    def _fits_after_removals(
        self,
        snapshot: Snapshot,
        e: Entry,
        usage_vec: np.ndarray,
        preempted: Dict[str, WorkloadSnapshot],
    ) -> bool:
        removed: List[WorkloadSnapshot] = []
        for ws in list(preempted.values()):
            if snapshot.remove_workload(ws.workload.key) is not None:
                removed.append(ws)
        for t in e.preemption_targets:
            ws = snapshot.remove_workload(t.workload.workload.key)
            if ws is not None:
                removed.append(ws)
        ok = snapshot.fits(e.cq_name, usage_vec)
        for ws in removed:
            snapshot.add_workload(ws)
        return ok

    # ---- capacity reservation on blocked preemption (scheduler.go:391-416) ----
    def _reserve_vector(
        self,
        e: Entry,
        snapshot: Snapshot,
        removed_acc: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        usage_vec = snapshot.vector_of(e.assignment.usage)
        r = snapshot.row(e.cq_name)
        if e.assignment.representative_mode() != Mode.PREEMPT:
            return usage_vec
        reserved = np.zeros_like(usage_vec)
        from kueue_tpu_torch.ops.quota import NO_LIMIT

        # the reference evaluates reservation with this cycle's
        # preempted workloads still counted in usage; under incremental
        # removal removed_acc restores that view
        local = snapshot.local_usage[r]
        if removed_acc is not None:
            local = local + removed_acc[r]
        for j in range(len(usage_vec)):
            u = int(usage_vec[j])
            if u == 0:
                continue
            if e.assignment.borrowing:
                bl = int(snapshot.borrowing_limit[r, j])
                if bl >= NO_LIMIT:
                    reserved[j] = u
                else:
                    reserved[j] = min(
                        u,
                        int(snapshot.nominal[r, j]) + bl - int(local[j]),
                    )
            else:
                reserved[j] = max(
                    0, min(u, int(snapshot.nominal[r, j]) - int(local[j]))
                )
        return reserved

    # ---- admission (scheduler.go:498-555) ----
    def _admit(self, e: Entry, snapshot: Snapshot) -> bool:
        admission = e.assignment.to_admission(
            e.cq_name, e.workload, transform=self.transform_config
        )
        ok, msg = self.admit_prepared(
            e.workload, e.cq_name, admission, snapshot.cq_models[e.cq_name]
        )
        if ok:
            e.status = EntryStatus.ASSUMED
        else:
            e.inadmissible_msg = msg
            # end-of-cycle loop requeues every non-assumed entry
            e.status = EntryStatus.NOMINATED
        return ok

    def admit_prepared(self, wl: Workload, cq_name: str, admission, cq_model) -> Tuple[bool, str]:
        """Admission tail shared by the cycle loop and the runtime's
        bulk drain: set conditions + check states from a ready Admission
        object, assume in the cache, durable-write. Returns (ok, msg)."""
        now = self.clock.now()
        wl.admission = admission
        wl.set_condition(
            WorkloadConditionType.QUOTA_RESERVED, True, reason="QuotaReserved", now=now
        )
        # initialize admission-check states for checks applying to the
        # assigned flavors (two-phase admission)
        flavors_used = {
            f for psa in admission.pod_set_assignments for f in psa.flavors.values()
        }
        from kueue_tpu_torch.models.admission_check import AdmissionCheckState

        required = self.cache.admission_checks_for_workload(cq_model, flavors_used)
        for name in required:
            if name not in wl.admission_check_states:
                wl.admission_check_states[name] = AdmissionCheckState(name=name)
        if wl.all_checks_ready(required):
            wl.set_condition(
                WorkloadConditionType.ADMITTED, True, reason="Admitted", now=now
            )

        # Stage → commit. The condition writes above are the STAGE; the
        # cache assumption + durable write below are the COMMIT, and
        # any exception inside rolls this head back completely (cache
        # forgotten, conditions reverted) before converting to an
        # ordinary requeue — so a raising durable-write hook mid-apply
        # can never leave cached usage != Σ admitted. InjectedCrash is
        # a BaseException and still models a real process death.
        try:
            if not self.cache.assume_workload(wl):
                msg = "Failed to assume workload"
                self._rollback_admission(wl, msg)
                return False, msg
            # Workload leaves the pending queue: drop the flavor cursor
            # so a later eviction restarts from the first flavor.
            wl.last_assignment = None

            if not self.apply_admission(wl):
                self.cache.forget_workload(wl)
                msg = "Failed to admit workload: durable write failed"
                self._rollback_admission(wl, msg)
                return False, msg
        except Exception as exc:  # noqa: BLE001 — transactional apply
            if wl.key in self.cache.assumed_workloads:
                self.cache.forget_workload(wl)
            msg = f"Failed to admit workload: durable write failed ({exc!r})"
            self._rollback_admission(wl, msg)
            return False, msg
        self.events(
            "QuotaReserved", wl, f"Quota reserved in ClusterQueue {cq_name}"
        )
        if wl.is_admitted:
            self.events("Admitted", wl, f"Admitted by ClusterQueue {cq_name}")
        return True, ""

    def _rollback_admission(self, wl: Workload, msg: str) -> None:
        """Undo the optimistic condition writes of a failed admission
        (reference: UnsetQuotaReservationWithCondition on this path)."""
        wl.admission = None
        now = self.clock.now()
        wl.set_condition(
            WorkloadConditionType.QUOTA_RESERVED, False, reason="Pending",
            message=msg, now=now,
        )
        if wl.conditions.get(WorkloadConditionType.ADMITTED) is not None:
            wl.set_condition(
                WorkloadConditionType.ADMITTED, False, reason="NoReservation", now=now
            )

    # ---- requeue path (scheduler.go:644-665) ----
    def _requeue_and_update(self, e: Entry) -> None:
        if (
            e.status != EntryStatus.NOT_NOMINATED
            and e.requeue_reason == RequeueReason.GENERIC
        ):
            e.requeue_reason = RequeueReason.FAILED_AFTER_NOMINATION
        self.queues.requeue_workload(e.workload, e.requeue_reason)
        if e.status in (EntryStatus.NOT_NOMINATED, EntryStatus.SKIPPED):
            # the structured reason rides on the condition: operators
            # (and the visibility API) read WHY from the reason without
            # parsing the free-form message
            canonical = classify_inadmissible_message(e.inadmissible_msg)
            e.workload.set_condition(
                WorkloadConditionType.QUOTA_RESERVED,
                False,
                reason=(
                    canonical.value
                    if canonical != InadmissibleReason.UNKNOWN
                    else "Pending"
                ),
                message=e.inadmissible_msg,
                now=self.clock.now(),
            )
            self.events("Pending", e.workload, e.inadmissible_msg)
