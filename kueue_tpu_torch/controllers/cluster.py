"""ClusterRuntime — the in-process control plane.

The analog of cmd/kueue/main.go:106-253 wiring plus the API-server
substrate the reference controllers react to: object stores for jobs and
workloads, the queue manager + cache pair, the scheduler, and the
reconcilers, driven deterministically by ``run_until_idle`` (event ->
reconcile -> schedule -> reconcile ... until quiescent), which is what
the reference achieves asynchronously with informers + workqueues.

Port of kueue_tpu/controllers/cluster.py. The runtime's device work
runs on ``device`` (the card unless the caller names the CPU; without a
card the constructor raises): the Scheduler's cycle solve and victim
searches, the TAS manager's fleet-size pod counting, every bulk-drain
launch (blocking, pipelined, megaloop) and the resident drain encode;
``Planner`` and the federation's ``GlobalScheduler`` read
``runtime.device``. A ``KernelError`` of a drain launch or fetch leaves
``bulk_drain`` (the guard re-raises it); nothing solves that round on
the host. The durable journal (``attach_journal``) waits for the
storage slice.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from kueue_tpu_torch.models import (
    AdmissionCheck,
    ClusterQueue,
    LocalQueue,
    ResourceFlavor,
    Workload,
    WorkloadPriorityClass,
)
from kueue_tpu_torch.models.cohort import Cohort
from kueue_tpu_torch.models.constants import WorkloadConditionType
from kueue_tpu_torch.models.topology import Topology
from kueue_tpu_torch.core.cache import Cache
from kueue_tpu_torch.core.events import Event, EventRecorder
from kueue_tpu_torch.core.queue_manager import QueueManager, RequeueReason
from kueue_tpu_torch.core.scheduler import Scheduler
from kueue_tpu_torch.controllers.jobframework import GenericJob, JobReconciler
from kueue_tpu_torch.controllers.workload_controller import (
    WaitForPodsReadyConfig,
    WorkloadReconciler,
)
from kueue_tpu_torch.utils.clock import Clock

__all__ = ["ClusterRuntime", "Event"]


def _parse_megaloop(spec) -> tuple:
    """Normalize the megaloop knob (server ``--megaloop on|off|K``):
    returns ``(mode, rounds)`` with mode "on"|"off" and rounds 0 for
    online tuning, >0 for a pinned K."""
    if spec is None:
        return "off", 0
    if isinstance(spec, bool):
        return ("on", 0) if spec else ("off", 0)
    if isinstance(spec, int):
        if spec <= 0:
            return "off", 0
        return "on", int(spec)
    text = str(spec).strip().lower()
    if text in ("off", "", "0"):
        return "off", 0
    if text == "on":
        return "on", 0
    try:
        rounds = int(text)
    except ValueError:
        raise ValueError(
            f"drain_megaloop must be on|off|K, got {spec!r}"
        ) from None
    if rounds <= 0:
        return "off", 0
    return "on", rounds


class ClusterRuntime:
    def __init__(
        self,
        clock: Optional[Clock] = None,
        wait_for_pods_ready: Optional[WaitForPodsReadyConfig] = None,
        manage_jobs_without_queue_name: bool = False,
        fair_sharing: bool = False,
        tas_cache=None,
        use_solver: Optional[bool] = None,
        solver_threshold: int = 16,
        use_preempt_solver: Optional[bool] = None,
        preempt_solver_threshold: int = 4,
        resources=None,  # config.ResourceSettings (quota-view transform)
        bulk_drain_threshold: Optional[int] = 256,
        drain_gate=None,  # latency-gate override (perf harness pins it open)
        solver_path: str = "auto",  # auto | host | device (guard mode)
        guard_config=None,  # core.guard.GuardConfig override
        # Double-buffered drain loop (core/pipeline.py): "on" = chunked
        # rounds with the next round's encode+solve prefetched on a
        # speculative snapshot while the host applies the current one
        # (the default), "serial" = the same chunked rounds without
        # prefetch (the A/B + property-test comparator), "off" = the
        # pre-pipeline single-dispatch drain.
        drain_pipeline: str = "on",
        pipeline_chunk_cycles: int = 16,
        # Device-resident admission megaloop (ops/megaloop_kernel): fuse
        # up to K drain rounds of ``pipeline_chunk_cycles`` kernel
        # cycles each into ONE dispatch, the host journaling/applying
        # the batched round-stamped decision log trailing the device,
        # each round validated by the pipeline's conflict-check
        # contract. "off" (default) = per-round launches; "on" = K
        # tuned online per backlog mix (guard.RoundsTuner); an int pins
        # K. Composes with drain_pipeline ("on" also prefetches the
        # NEXT fused launch speculatively) and with mesh.
        drain_megaloop="off",
        # Multi-chip admission (kueue_tpu_torch/parallel): a parallel.Mesh
        # — or an operator spec ("auto" | "off" | a device count,
        # resolved via parallel.resolve_mesh) — shards every
        # drain-family launch (plain / contended / fair / TAS, blocking
        # AND pipelined-prefetched) over the mesh's wl axis. None/"off"
        # = single-device (no mesh).
        mesh=None,
        # Distributed tracing (kueue_tpu_torch/tracing): always-on span
        # subsystem — workload lifecycle traces + per-cycle span trees.
        # False = no-op tracer (the bench.py --trace baseline).
        tracing: bool = True,
        # Admission policy (kueue_tpu_torch/policy): a registered policy name
        # ("first-fit" | "gavel" | "prema" | "deadline" |
        # "gavel-deadline") or an AdmissionPolicy instance. The default
        # first-fit policy is bit-for-bit the pre-policy decisions.
        policy=None,
        # where the device work runs (kueue_tpu_torch._torch.resolve_device):
        # the card unless "cpu" is named
        device=None,
    ):
        from kueue_tpu_torch._torch import resolve_device
        from kueue_tpu_torch.metrics import Metrics

        self.device = resolve_device(device)
        self.clock = clock or Clock()
        self.cache = Cache()
        self.queues = QueueManager(self.clock)
        self.workloads: Dict[str, Workload] = {}
        self.jobs: Dict[str, GenericJob] = {}
        # field-index layer (pkg/controller/core/indexer): queue key,
        # admitted CQ, admission-check name -> workload keys
        from kueue_tpu_torch.controllers.indexer import workload_indexer

        self.indexer = workload_indexer()
        # workload key -> job key (O(1) has_job_for on eviction paths)
        self._jobs_by_workload: Dict[str, str] = {}
        # the recorder IS the live observability spine: every status
        # transition lands here, stamped with a monotone resourceVersion
        # the server's watch/SSE surface resumes from
        self.events = EventRecorder(clock=self.clock)
        self.metrics = Metrics()
        # distributed tracing (kueue_tpu_torch/tracing): ONE tracer shared by
        # scheduler, audit log, guard and journal — workload lifecycle
        # traces (trace ids stamped into decisions/events) + cycle span
        # trees, served at /debug/traces and shipped to read replicas
        # on the journal feed
        from kueue_tpu_torch.tracing import Tracer

        self.tracer = Tracer(
            clock=self.clock, metrics=self.metrics, enabled=tracing
        )
        # per-workload decision audit trail (core/audit.py): every
        # admission decision — host cycle, device cycle, bulk drain —
        # lands here; served at /debug/workloads/<ns>/<name>/decisions
        # and rendered by `kueuectl explain`
        from kueue_tpu_torch.core.audit import DecisionAuditLog

        self.audit = DecisionAuditLog(clock=self.clock)
        self.audit.tracer = self.tracer
        self.audit.observers.append(self._record_decision_metric)
        # admission SLOs (kueue_tpu_torch/gateway/slo.py): attainment +
        # error-budget burn over the lifecycle tracer's
        # queue-to-admission histogram. Passive until targets are
        # configured (server --slo-target-p95 / --slo-target); served
        # at /apis/kueue/v1beta1/slo, /healthz and `kueuectl slo`
        from kueue_tpu_torch.gateway.slo import SLOTracker

        self.slo = SLOTracker(self.metrics, clock=self.clock)
        # Durable-state spine (kueue_tpu_torch/storage): when a Journal is
        # attached (attach_journal), every state mutation appends a
        # record stamped with this monotone resourceVersion, and
        # recovery replays records newer than the last checkpoint.
        # None = checkpoint-only durability (the pre-journal behavior).
        self.journal = None
        self.resource_version = 0
        self._journal_degraded_seen = False
        # MultiKueue federation (kueue_tpu_torch/federation): when a
        # FederationDispatcher is attached it runs once per reconcile
        # pass — mirror/poll/retract against the worker control planes.
        # Recovery replays federation_* journal records into
        # federation_replay; the dispatcher adopts them on construction.
        self.federation = None
        self.federation_replay: List[tuple] = []
        self.pods_ready_cfg = wait_for_pods_ready or WaitForPodsReadyConfig()
        # resource adjustment pipeline stores (pkg/workload/resources.go)
        self.limit_ranges: Dict[str, "object"] = {}  # key -> LimitRange
        self.runtime_classes: Dict[str, "object"] = {}  # name -> RuntimeClass
        self.transform_config = None
        if resources is not None:
            from kueue_tpu_torch.core.workload_info import ResourceTransformConfig

            self.transform_config = ResourceTransformConfig.from_settings(
                resources
            )

        # Self-healing hot path (core/guard.py): the resilient solver
        # executor (circuit breaker + host-mirror failover + sampled
        # divergence detection) and the poison-workload quarantine,
        # both wired into this runtime's events/metrics/journal.
        from kueue_tpu_torch.core.guard import GuardConfig, QuarantineList, SolverGuard

        if guard_config is None:
            guard_config = GuardConfig(mode=solver_path)
        self.quarantine = QuarantineList(
            threshold=guard_config.poison_threshold,
            ttl_s=guard_config.quarantine_ttl_s,
        )
        self.guard = SolverGuard(
            clock=self.clock,
            config=guard_config,
            record_event=self._record_solver_event,
            metrics=self.metrics,
            journal_hook=self._journal_guard_record,
        )
        # guard spans (divergence checks, failovers) land on the
        # in-flight cycle's span tree
        self.guard.tracer = self.tracer
        # the most recent journaled solver divergence verdict (replayed
        # by recovery so a restart knows which path produced the
        # admitted state on disk)
        self.last_solver_verdict = None

        # active admission policy (kueue_tpu_torch/policy); set_policy swaps
        # it live, journals the change, and keeps scheduler + drains +
        # planner on the same instance
        from kueue_tpu_torch.policy import AdmissionPolicy, resolve_policy

        if policy is None:
            policy = resolve_policy("first-fit")
        elif isinstance(policy, str):
            policy = resolve_policy(policy)
        elif not isinstance(policy, AdmissionPolicy):
            raise ValueError(f"not an admission policy: {policy!r}")
        self.policy = policy

        tas_check = tas_assign = tas_fits = None
        self.tas_manager = None
        self.node_controller = None
        self.topology_ungater = None
        if tas_cache is not None:
            from kueue_tpu_torch.tas import TASManager
            from kueue_tpu_torch.controllers.tas import NodeController, TopologyUngater

            self.cache.tas_cache = tas_cache
            self.tas_manager = TASManager(
                tas_cache, self.cache.flavors, transform=self.transform_config,
                device=self.device,
            )
            self.node_controller = NodeController(tas_cache)
            self.topology_ungater = TopologyUngater()
            tas_check = self.tas_manager.check
            tas_assign = self.tas_manager.assign
            tas_fits = self.tas_manager.fits

        self.scheduler = Scheduler(
            queues=self.queues,
            cache=self.cache,
            clock=self.clock,
            preemptor=self._make_preemptor(fair_sharing),
            fair_sharing=fair_sharing,
            wait_for_pods_ready_block=self.pods_ready_cfg.enable
            and self.pods_ready_cfg.block_admission,
            tas_check=tas_check,
            tas_assign=tas_assign,
            tas_fits=tas_fits,
            events=lambda kind, wl, msg: self.event(kind, wl, msg),
            use_solver=use_solver,
            solver_threshold=solver_threshold,
            use_preempt_solver=use_preempt_solver,
            preempt_solver_threshold=preempt_solver_threshold,
            transform_config=self.transform_config,
            limit_range_validate=self._validate_workload_resources,
            audit=self.audit,
            guard=self.guard,
            quarantine=self.quarantine,
            tracer=self.tracer,
            policy=self.policy,
            device=self.device,
        )
        self.scheduler.on_quarantine = self._on_workload_quarantined
        if self.scheduler.preemptor is not None:
            self.scheduler.preemptor.policy = self.policy
        self._report_policy_metrics()
        self.job_reconciler = JobReconciler(
            self,
            manage_jobs_without_queue_name=manage_jobs_without_queue_name,
            wait_for_pods_ready=self.pods_ready_cfg.enable,
        )
        self.workload_reconciler = WorkloadReconciler(
            self, wait_for_pods_ready=self.pods_ready_cfg
        )
        # AdmissionCheck controllers (provisioning, multikueue, custom):
        # name -> callable(workload) run during reconcile loops
        self.admission_check_controllers: List[Callable[[Workload], None]] = []
        # QueueVisibility (deprecated, gated): cq -> top pending heads
        self.cq_pending_snapshots: Dict[str, List[dict]] = {}
        # Bulk path: backlogs at/above this head count route through the
        # single-dispatch device drains instead of one-head-per-CQ
        # cycles (None disables). Auto-gated like the cycle path: a
        # windowed-min estimate of the drain cost per head (erodes on
        # skipped opportunities so a compile-heavy first sample re-probes
        # instead of disabling the path forever) must beat the host
        # nomination estimate.
        from kueue_tpu_torch.core.scheduler import _LatencyEstimate

        self.bulk_drain_threshold = bulk_drain_threshold
        self._drain_est = drain_gate if drain_gate is not None else _LatencyEstimate()
        # Double-buffered drain loop state (core/pipeline.py)
        from kueue_tpu_torch.core.pipeline import PipelineStats

        if drain_pipeline not in ("on", "serial", "off"):
            raise ValueError(
                f"drain_pipeline must be on|serial|off, got {drain_pipeline!r}"
            )
        self.drain_pipeline = drain_pipeline
        self.pipeline_chunk_cycles = max(1, int(pipeline_chunk_cycles))
        self.pipeline = PipelineStats()
        self._pipeline_committed = 0  # committed prefetches (divergence sampling)
        # Megaloop state (core/pipeline.MegaloopStats + the K knob):
        # megaloop_rounds 0 = tune online (guard.RoundsTuner), >0 = pin
        from kueue_tpu_torch.core.pipeline import MegaloopStats

        self.drain_megaloop, self.megaloop_rounds = _parse_megaloop(
            drain_megaloop
        )
        self.megaloop = MegaloopStats()
        self._megaloop_launches = 0  # divergence-sampling schedule
        # Multi-chip admission state: the resolved mesh, its metric
        # posture, and the resident drain encode (single-device
        # pipelined rounds keep quota/hierarchy buffers on device and
        # delta-ship only touched usage rows — core/encode.py)
        self.mesh = None
        self._mesh_label = "off"
        self._mesh_place_seen = 0.0
        self._drain_resident = None
        self.set_mesh(mesh)

    def set_megaloop(self, spec) -> None:
        """Configure the fused drain (server ``--megaloop on|off|K``):
        "off" = per-round launches, "on" = K tuned online per backlog
        mix, an int pins K."""
        self.drain_megaloop, self.megaloop_rounds = _parse_megaloop(spec)

    # ---- admission policy (kueue_tpu_torch/policy) ----
    def set_policy(self, policy, journal: bool = True) -> None:
        """Install the admission policy: a registered name or an
        AdmissionPolicy instance. Journals a ``policy_config`` record
        (recovery and read replicas converge on the same policy),
        emits a PolicyConfigured event, and refreshes kueue_policy_*.
        ``journal=False`` is the recovery/replica replay path — replay
        must not re-journal."""
        from kueue_tpu_torch.policy import AdmissionPolicy, resolve_policy

        if policy is None or isinstance(policy, str):
            policy = resolve_policy(policy)
        elif not isinstance(policy, AdmissionPolicy):
            raise ValueError(f"not an admission policy: {policy!r}")
        changed = policy.name != self.policy.name
        self.policy = policy
        self.scheduler.policy = policy
        preemptor = getattr(self.scheduler, "preemptor", None)
        if preemptor is not None:
            preemptor.policy = policy
        self._report_policy_metrics(changed=changed and journal)
        if changed:
            self.events.record(
                "PolicyConfigured", "control-plane/policy",
                f"admission policy set to {policy.name!r}",
                regarding_kind="ControlPlane",
            )
            self.metrics.events_total.inc(
                kind="ControlPlane", reason="PolicyConfigured"
            )
        if journal:
            self._journal_append("policy_config", policy.to_dict())

    def _report_policy_metrics(self, changed: bool = False) -> None:
        from kueue_tpu_torch.policy import policy_names

        for name in policy_names():
            self.metrics.policy_active.set(
                1 if name == self.policy.name else 0, policy=name
            )
        if changed:
            self.metrics.policy_changes_total.inc()

    def set_mesh(self, mesh) -> None:
        """Install (or clear) the admission mesh: accepts a Mesh, an
        operator spec ("auto" | "off" | device count), or None; updates
        the kueue_mesh_* gauges either way."""
        if isinstance(mesh, (str, int)):
            from kueue_tpu_torch.parallel import resolve_mesh

            mesh = resolve_mesh(mesh, device=self.device)
        self.mesh = mesh
        from kueue_tpu_torch.parallel import mesh_shape_str

        self._mesh_label = mesh_shape_str(mesh)
        if mesh is None:
            self.metrics.mesh_devices.set(0)
            self.metrics.mesh_shard_width.set(0)
        else:
            self.metrics.mesh_devices.set(int(mesh.size))
            self.metrics.mesh_shard_width.set(int(mesh.shape["wl"]))

    def mesh_status(self) -> dict:
        """Mesh posture for the dashboard badge + SIGUSR2 dump: shape,
        device count, jit-bucket compile/reuse accounting, placement
        seconds, narrow-panel fence state, resident-encode stats."""
        from kueue_tpu_torch.parallel import bucket_stats
        from kueue_tpu_torch.parallel.harness import (
            last_panel_schedule,
            place_seconds,
        )

        resident = self._drain_resident
        return {
            "shape": self._mesh_label,
            "devices": int(self.mesh.size) if self.mesh is not None else 0,
            "buckets": bucket_stats(),
            "placeSeconds": round(place_seconds(), 6),
            "panelSchedule": last_panel_schedule(),
            "residentEncode": resident.stats() if resident is not None else {},
        }

    def _note_mesh_metrics(self) -> None:
        """Fold the harness' cumulative placement time into the
        kueue_mesh_allgather_seconds counter (delta since last fold)."""
        if self.mesh is None:
            return
        from kueue_tpu_torch.parallel.harness import place_seconds

        total = place_seconds()
        delta = total - self._mesh_place_seen
        if delta > 0:
            self.metrics.mesh_allgather_seconds.inc(delta)
            self.tracer.add_cycle_span(
                "cycle.mesh_place", delta, attrs={"mesh": self._mesh_label}
            )
            self._mesh_place_seen = total

    def _make_preemptor(self, fair_sharing: bool):
        from kueue_tpu_torch.core.preemption import Preemptor

        p = Preemptor(
            self.clock,
            enable_fair_sharing=fair_sharing,
            events=lambda kind, wl, msg: self.event(kind, wl, msg),
        )
        p.metrics_hook = self._record_preemption
        return p

    # ---- durable-state journaling (kueue_tpu_torch/storage) ----
    def attach_journal(self, journal) -> None:
        """Start journaling every mutation to ``journal`` (an opened
        storage.Journal). Wire AFTER recovery: replay applies records
        through the same mutation methods and must not re-append.

        The port has no ``storage`` package yet: this raises."""
        raise NotImplementedError(
            "attach_journal: the durable journal (storage/journal, recovery, "
            "checkpoint) is not ported yet (ROADMAP A5's storage slice)"
        )
        journal.metrics = self.metrics
        journal.tracer = self.tracer  # fsync spans on the cycle tree
        journal.clock = self.clock  # record ts rides the replica feed
        self.journal = journal
        # delta-checkpoint dirty-set (storage/checkpoint.py): every
        # mutation funneling through _journal_append marks the object
        # it touched. Fresh on every attach — mutations applied before
        # this point (recovery replay) were never noted, and the
        # tracker is born full-dirty for exactly that reason.
        from kueue_tpu_torch.storage.checkpoint import DeltaTracker

        self.delta_dirty = DeltaTracker()
        self.metrics.journal_degraded.set(1 if journal.degraded else 0)
        self.metrics.journal_segments.set(journal.stats().segments)

    def _journal_append(self, rtype: str, data: dict) -> None:
        j = self.journal
        if j is None:
            return
        self.resource_version += 1
        rec = j.append(rtype, data, rv=self.resource_version)
        tracker = getattr(self, "delta_dirty", None)
        if tracker is not None:
            # note UNCONDITIONALLY — even when the append was dropped
            # (degraded journal): the in-memory mutation still happens,
            # and checkpoint-only durability must cover it
            tracker.note(rtype, data)
        if j.degraded != self._journal_degraded_seen:
            # flip (either direction) is an operator-visible transition:
            # event + gauge; /healthz reads the journal stats directly
            self._journal_degraded_seen = j.degraded
            self.metrics.journal_degraded.set(1 if j.degraded else 0)
            if j.degraded:
                self.events.record(
                    "JournalDegraded", "control-plane/journal",
                    f"journal append failed ({j.last_error}); persistence "
                    "degraded to checkpoint-only until writes succeed",
                    regarding_kind="ControlPlane",
                )
            else:
                self.events.record(
                    "JournalRecovered", "control-plane/journal",
                    "journal writes succeeding again; full durability "
                    "restored",
                    regarding_kind="ControlPlane",
                )
        if rec is not None:
            # the record is durable (or at least queued to the OS) but
            # the in-memory apply that follows has not completed — the
            # exact window recovery's replay must close
            from kueue_tpu_torch.testing import faults

            faults.fire("journal.post_append_pre_apply")

    def _journal_wl(self, wl: Workload, require_stored: bool = False) -> None:
        if self.journal is None:
            return
        if require_stored and wl.key not in self.workloads:
            # an upsert record for an already-deleted workload would
            # resurrect it at replay
            return
        from kueue_tpu_torch import serialization as ser

        self._journal_append("workload_upsert", ser.workload_to_dict(wl))

    def _journal_wl_delete(self, key: str) -> None:
        if self.journal is None:
            return
        self._journal_append("workload_delete", {"key": key})

    def _journal_obj(self, section: str, obj: dict) -> None:
        if self.journal is None:
            return
        self._journal_append(
            "object_upsert", {"section": section, "object": obj}
        )

    def _journal_obj_delete(self, section: str, key: str) -> None:
        if self.journal is None:
            return
        self._journal_append(
            "object_delete", {"section": section, "key": key}
        )

    # ---- self-healing hot path (core/guard.py) ----
    def _record_solver_event(self, reason: str, message: str) -> None:
        """Guard hook: breaker transitions, divergences and contained
        cycles land on the same event pipeline every other status
        transition uses (reasons are members of EVENT_REASONS)."""
        self.events.record(
            reason, "control-plane/solver", message,
            regarding_kind="ControlPlane",
        )
        self.metrics.events_total.inc(kind="ControlPlane", reason=reason)

    def _journal_guard_record(self, rtype: str, data: dict) -> None:
        """Guard hook: durable solver verdicts (which path produced the
        admitted state) ride the journal."""
        if rtype == "solver_verdict":
            self.last_solver_verdict = dict(data)
        self._journal_append(rtype, data)

    def _on_workload_quarantined(self, wl: Workload, message: str) -> None:
        """Scheduler hook AFTER the quarantine entry, condition and
        event landed: journal the entry durably and refresh the gauge
        (the WorkloadQuarantined event already journaled the workload's
        post-state through the event funnel)."""
        entry = self.quarantine.get(wl.key)
        self._journal_append(
            "quarantine_set",
            entry.to_dict() if entry is not None else
            {"key": wl.key, "message": message},
        )
        self.metrics.solver_quarantined_workloads.set(len(self.quarantine))

    def _sweep_quarantine(self) -> None:
        """TTL re-admission: expired quarantine entries rejoin
        nomination (reconcile-driven, FakeClock-disciplined)."""
        for entry in self.quarantine.expired(self.clock.now()):
            self._release_quarantine(entry.key, "TTL elapsed")

    def _release_quarantine(self, key: str, why: str) -> bool:
        entry = self.quarantine.release(key)
        if entry is None:
            return False
        self._journal_append("quarantine_clear", {"key": key})
        self.metrics.solver_quarantined_workloads.set(len(self.quarantine))
        wl = self.workloads.get(key)
        if wl is not None:
            wl.set_condition(
                WorkloadConditionType.QUOTA_RESERVED, False,
                reason="Pending",
                message=f"quarantine released ({why}); workload requeued",
                now=self.clock.now(),
            )
            self.event(
                "WorkloadUnquarantined", wl, f"quarantine released ({why})"
            )
            # unpark: the condition flip re-enters the pending heap
            self.queues.add_or_update_workload(wl)
        return True

    def clear_quarantine(self, key: Optional[str] = None) -> List[str]:
        """``kueuectl quarantine clear`` / POST /debug/quarantine/clear:
        release one (or every) quarantined workload back to nomination.
        Returns the released keys."""
        keys = (
            [key] if key is not None
            else [e.key for e in self.quarantine.items()]
        )
        return [
            k for k in keys
            if self._release_quarantine(k, "cleared by operator")
        ]

    def quarantine_report(self) -> List[dict]:
        """The kueuectl/debug-route listing."""
        return [e.to_dict() for e in self.quarantine.items()]

    # ---- events ----
    def event(self, kind: str, wl: Workload, message: str = "") -> None:
        tid = self.tracer.workload_trace_id(wl.key) or ""
        ev = self.events.record(kind, wl.key, message, trace_id=tid)
        # lifecycle span on the FIRST occurrence of a series (the same
        # count-dedup bound journaling uses); Admitted closes the root
        # and observes queue-to-admission latency
        self.tracer.note_event(
            kind, wl.key, ev.count,
            cq=wl.admission.cluster_queue if wl.admission else "",
        )
        # status transitions mutate workloads in place (admission set/
        # cleared, check states flipped); the informer cache the
        # reference indexes over sees those as update events, so the
        # index refreshes here — every transition emits an event
        if wl.key in self.workloads:
            self.indexer.update(wl.key, wl)
            # the event IS the durable-write moment for in-place status
            # transitions (admission applied, eviction, check flips).
            # "Pending" journals only when the recorder opens a NEW
            # (workload, message) series: the first park with a given
            # reason ships its condition post-state (so recovery — and
            # journal-tailing read replicas, which never run cycles —
            # converge on pending conditions too), while the hot
            # requeue churn that would dominate journal volume on
            # large contended backlogs dedups into count bumps and
            # stays out, same bound the event ring itself uses.
            if kind != "Pending" or ev.count == 1:
                self._journal_wl(wl)
        self._record_metric_event(kind, wl)

    def _record_metric_event(self, kind: str, wl: Workload) -> None:
        """Event -> metric mapping (metrics.go report call sites).

        Preemptions are reported via the preemptor's metrics hook (the
        preempting CQ isn't derivable from the victim workload)."""
        # every recorded event mirrors into the scrape surface, so
        # alerting sees the same series the watch stream tells
        self.metrics.events_total.inc(kind="Workload", reason=kind)
        now = self.clock.now()
        cq = wl.admission.cluster_queue if wl.admission else ""
        if kind == "QuotaReserved" and cq:
            self.metrics.report_quota_reserved(cq, now - wl.creation_time)
        elif kind == "Admitted" and cq:
            qr = wl.conditions.get(WorkloadConditionType.QUOTA_RESERVED)
            checks_wait = now - qr.last_transition_time if qr else 0.0
            self.metrics.report_admitted(
                cq, now - wl.creation_time, checks_wait,
                lq=wl.queue_name, namespace=wl.namespace,
            )
        elif kind == "Evicted" and cq:
            ev = wl.conditions.get(WorkloadConditionType.EVICTED)
            self.metrics.report_evicted(
                cq, ev.reason if ev else "", lq=wl.queue_name,
                namespace=wl.namespace,
            )

    def _record_decision_metric(self, rec) -> None:
        """Audit-log observer: mirror each inadmissible decision into
        kueue_inadmissible_reason_total (the canonical enum keeps the
        label space bounded). Admitted/Preempting decisions are
        progress, not inadmissibility — they stay out of the series."""
        if rec.outcome in ("Pending", "Skipped"):
            self.metrics.report_inadmissible_reason(
                rec.cluster_queue, rec.reason.value
            )
        scores = getattr(rec, "scores", None)
        if scores:
            self.metrics.policy_scored_decisions_total.inc(
                policy=scores.get("policy", "")
            )

    def _record_preemption(self, preempting_cq: str, reason: str, victim: Workload) -> None:
        """ReportPreemption (metrics.go): counts the preemption for the
        preempting CQ AND the eviction (reason Preempted) for the
        victim's CQ."""
        self.metrics.report_preemption(preempting_cq, reason)
        victim_cq = victim.admission.cluster_queue if victim.admission else ""
        if victim_cq:
            self.metrics.report_evicted(
                victim_cq, "Preempted", lq=victim.queue_name,
                namespace=victim.namespace,
            )

    def _report_cycle_metrics(self, result, duration_s: float) -> None:
        # no-op cycles (empty queues) are not admission attempts —
        # reporting them would drown the success/inadmissible ratio
        considered = (
            result.admitted or result.requeued or result.preempting
            or result.skipped_preemptions
        )
        if considered:
            outcome = "success" if result.admitted else "inadmissible"
            self.metrics.report_admission_attempt(outcome, duration_s)
            if self.scheduler.last_traces:
                trace = self.scheduler.last_traces[-1]
                for phase, seconds in trace.spans.items():
                    self.metrics.admission_cycle_phase_duration_seconds.observe(
                        seconds, phase=phase
                    )
                self.metrics.report_cycle(trace)
        for cq_name, pending in self.queues.cluster_queues.items():
            self.metrics.report_pending_workloads(
                cq_name, pending.pending_active(), pending.pending_inadmissible()
            )
            cached = self.cache.cluster_queues.get(cq_name)
            if cached is not None:
                self.metrics.reserving_active_workloads.set(
                    len(cached.workloads), cluster_queue=cq_name
                )
                self.metrics.admitted_active_workloads.set(
                    sum(1 for w in cached.workloads.values() if w.is_admitted),
                    cluster_queue=cq_name,
                )
        # "skips in the LAST cycle": reset CQs with no skips this cycle
        for cq_name in self.queues.cluster_queues:
            self.metrics.admission_cycle_preemption_skips.set(
                result.skipped_preemptions.get(cq_name, 0), cluster_queue=cq_name
            )

    # ---- API-object lifecycle (delegates, main.go setupControllers) ----
    # Config mutations journal WAL-style: the record lands before the
    # stores mutate, so a crash in the window leaves a replayable
    # record, never a silently-applied-but-forgotten change.
    def add_cluster_queue(self, cq: ClusterQueue) -> None:
        from kueue_tpu_torch import serialization as ser

        self._journal_obj("clusterqueues", ser.cq_to_dict(cq))
        self.cache.add_or_update_cluster_queue(cq)
        self.queues.add_cluster_queue(cq)

    def delete_cluster_queue(self, name: str) -> None:
        self._journal_obj_delete("clusterqueues", name)
        self.cache.delete_cluster_queue(name)
        self.queues.delete_cluster_queue(name)
        self.metrics.clear_cluster_queue(name)

    def add_local_queue(self, lq: LocalQueue) -> None:
        from kueue_tpu_torch import serialization as ser

        self._journal_obj("localqueues", ser.lq_to_dict(lq))
        self.cache.add_or_update_local_queue(lq)
        self.queues.add_local_queue(lq)

    def add_flavor(self, flavor: ResourceFlavor) -> None:
        from kueue_tpu_torch import serialization as ser

        self._journal_obj("resourceflavors", ser.flavor_to_dict(flavor))
        self.cache.add_or_update_flavor(flavor)
        if self.cache.tas_cache is not None:
            self.cache.tas_cache.add_or_update_flavor(flavor)
        # watcher fan-out (clusterqueue_controller.go:137-380): a flavor
        # appearing OR changing (e.g. a corrected topology_name) can
        # clear an inactive-CQ reason — wake referencing CQs' parked
        # heads; still-inadmissible ones simply re-park
        self._reactivate_cqs(lambda cq: flavor.name in cq.flavor_names())

    def add_topology(self, topo: Topology) -> None:
        from kueue_tpu_torch import serialization as ser

        self._journal_obj("topologies", ser.topology_to_dict(topo))
        self.cache.add_or_update_topology(topo)
        if self.cache.tas_cache is not None:
            self.cache.tas_cache.add_or_update_topology(topo)

        # reactivate CQs whose TAS flavors reference this topology
        # (TopologyNotFound recovery; updates included)
        def refs_topo(cq) -> bool:
            for fname in cq.flavor_names():
                f = self.cache.flavors.get(fname)
                if f is not None and f.topology_name == topo.name:
                    return True
            return False

        self._reactivate_cqs(refs_topo)

    def _reactivate_cqs(self, predicate) -> None:
        affected = {
            name
            for name, cached in self.cache.cluster_queues.items()
            if predicate(cached.model)
        }
        if affected:
            self.queues.queue_inadmissible_workloads(affected)

    def add_cohort(self, cohort: Cohort) -> None:
        from kueue_tpu_torch import serialization as ser

        self._journal_obj("cohorts", ser.cohort_to_dict(cohort))
        self.cache.add_or_update_cohort(cohort)
        self.queues.forest.add_cohort(cohort.name, cohort.parent)

    def add_admission_check(self, ac: AdmissionCheck) -> None:
        from kueue_tpu_torch import serialization as ser

        self._journal_obj("admissionchecks", ser.check_to_dict(ac))
        old = self.cache.admission_checks.get(ac.name)
        if ac.active is None and old is not None:
            # the Active condition is controller-owned status; a spec
            # re-apply that doesn't carry it must not reset it
            ac.active = old.active
            ac.active_message = old.active_message
        self.cache.add_or_update_admission_check(ac)
        # the check APPEARING is itself a status change: CQs that went
        # inactive on AdmissionCheckNotFound must wake their parked
        # heads, same as an active-flag flip
        if old is None or old.active != ac.active:
            self._reactivate_cqs_with_check(ac.name)

    def _reactivate_cqs_with_check(self, name: str) -> None:
        # activity change invalidates CQ statuses: reactivate parked
        # heads of affected CQs in ONE queue-manager pass
        self._reactivate_cqs(
            lambda cq: name in self.cache._all_check_names(cq)
        )

    def set_admission_check_active(
        self, name: str, active: bool, message: str = ""
    ) -> None:
        """AdmissionCheck Active-condition lifecycle
        (admissioncheck_controller.go:83-116): the owning controller
        flips it when parameters (fail to) resolve; dependent CQs go
        inactive and their heads park until it recovers."""
        ac = self.cache.admission_checks.get(name)
        if ac is None or (ac.active == active and ac.active_message == message):
            return
        ac.active = active
        ac.active_message = message
        from kueue_tpu_torch import serialization as ser

        # in-place status flip: journal the post-state (replay upserts
        # the check with the flipped Active condition)
        self._journal_obj("admissionchecks", ser.check_to_dict(ac))
        self._reactivate_cqs_with_check(name)

    def local_queue_status(self, namespace: str, name: str) -> Optional[dict]:
        """LocalQueueStatus mirror (localqueue_types.go:104-150):
        pending/reserving/admitted counts + per-flavor usage."""
        lq = self.cache.local_queues.get(f"{namespace}/{name}")
        if lq is None:
            return None
        # resolve members via the queue-key field index instead of
        # scanning heaps and the CQ's workload map (the reference lists
        # with MatchingFields{WorkloadQueueKey}, localqueue_controller)
        from kueue_tpu_torch.controllers.indexer import WORKLOAD_QUEUE_KEY

        pending = reserving = admitted = 0
        for key in self.indexer.lookup(
            WORKLOAD_QUEUE_KEY, f"{namespace}/{name}"
        ):
            wl = self.workloads.get(key)
            if wl is None or wl.is_finished:
                continue
            if wl.has_quota_reservation:
                reserving += 1
                admitted += wl.is_admitted
            elif wl.active:
                pending += 1
        usage = self.cache.local_queue_usage(lq)
        flavors = sorted({fr.flavor for fr in usage})
        return {
            "pendingWorkloads": pending,
            "reservingWorkloads": reserving,
            "admittedWorkloads": int(admitted),
            "flavorUsage": [
                {
                    "name": fname,
                    "resources": [
                        {"name": fr.resource, "total": qty}
                        for fr, qty in sorted(usage.items())
                        if fr.flavor == fname
                    ],
                }
                for fname in flavors
            ],
            "flavors": flavors,
        }

    def flavor_in_use(self, name: str) -> Optional[str]:
        """First ClusterQueue referencing the flavor, or None — the
        ResourceFlavor finalizer's guard (resourceflavor_controller.go:
        the finalizer delays deletion while any CQ references it)."""
        for cq_name, cached in self.cache.cluster_queues.items():
            if name in cached.model.flavor_names():
                return cq_name
        return None

    def delete_flavor(self, name: str) -> None:
        in_use = self.flavor_in_use(name)
        if in_use is not None:
            raise ValueError(
                f"resourceFlavor {name!r} is in use by clusterQueue {in_use!r}"
            )
        self._journal_obj_delete("resourceflavors", name)
        self.cache.delete_flavor(name)
        if self.cache.tas_cache is not None:
            self.cache.tas_cache.delete_flavor(name)

    def add_priority_class(self, pc: WorkloadPriorityClass) -> None:
        from kueue_tpu_torch import serialization as ser

        self._journal_obj(
            "workloadpriorityclasses", ser.priority_class_to_dict(pc)
        )
        self.cache.add_or_update_priority_class(pc)

    # ---- nodes (TAS capacity; resource_flavor.go node watch) ----
    def add_node(self, node) -> None:
        if self.node_controller is not None:
            from kueue_tpu_torch import serialization as ser

            self._journal_obj("nodes", ser.node_to_dict(node))
            self.node_controller.add_or_update_node(node)

    def delete_node(self, name: str) -> None:
        if self.node_controller is not None:
            self._journal_obj_delete("nodes", name)
            self.node_controller.delete_node(name)

    # ---- resource adjustment objects ----
    def add_limit_range(self, lr) -> None:
        from kueue_tpu_torch import serialization as ser

        self._journal_obj("limitranges", ser.limit_range_to_dict(lr))
        self.limit_ranges[lr.key] = lr

    def delete_limit_range(self, key: str) -> None:
        self._journal_obj_delete("limitranges", key)
        self.limit_ranges.pop(key, None)

    def add_runtime_class(self, rc) -> None:
        from kueue_tpu_torch import serialization as ser

        self._journal_obj("runtimeclasses", ser.runtime_class_to_dict(rc))
        self.runtime_classes[rc.name] = rc

    def delete_runtime_class(self, name: str) -> None:
        self._journal_obj_delete("runtimeclasses", name)
        self.runtime_classes.pop(name, None)

    def _validate_workload_resources(self, wl: Workload) -> Optional[str]:
        """Scheduler nomination validation (scheduler.go:361-369):
        LimitRange bounds + requests<=limits."""
        from kueue_tpu_torch.core.limit_range import (
            validate_limit_range,
            validate_resources,
        )

        errs = validate_limit_range(wl, self.limit_ranges.values())
        errs += validate_resources(wl)
        return "; ".join(errs) if errs else None

    # ---- jobs ----
    def _wl_key_for_job(self, job: GenericJob) -> str:
        return f"{job.namespace}/{self.job_reconciler.workload_name_for(job)}"

    def add_job(self, job: GenericJob) -> None:
        self.jobs[job.key] = job
        self._jobs_by_workload[self._wl_key_for_job(job)] = job.key

    def delete_job(self, key: str) -> None:
        job = self.jobs.pop(key, None)
        if job is None:
            return
        wl_key = self._wl_key_for_job(job)
        self._jobs_by_workload.pop(wl_key, None)
        # job deletion releases its workload (reconciler dropFinalizers)
        wl = self.workloads.get(wl_key)
        if wl is not None:
            self.delete_workload(wl)

    # ---- workload store, used by reconcilers ----
    def add_workload(self, wl: Workload) -> None:
        # WAL ordering: the upsert record lands before any store
        # mutates (crash in between replays to the same state)
        self._journal_wl(wl)
        self._add_workload_stores(wl)

    def _add_workload_stores(self, wl: Workload) -> None:
        # Replacing a DIFFERENT object under the same key releases the
        # old copy's cache/queue state first (the reference's update
        # handlers route transitions explicitly; here delete+add is
        # observationally the same and leak-free — e.g. a re-POST with
        # admission unset must free the previously charged quota).
        old = self.workloads.get(wl.key)
        if old is not None and old is not wl:
            self.queues.delete_workload(old)
            if self.cache.delete_workload(old):
                self.queues.queue_associated_inadmissible_workloads_after(
                    old.admission.cluster_queue if old.admission else ""
                )
        self.workloads[wl.key] = wl
        self.indexer.update(wl.key, wl)
        if wl.is_finished:
            return
        if wl.admission is not None and wl.has_quota_reservation:
            self.cache.add_or_update_workload(wl)
        elif wl.active:
            # spec-level resource adjustment before queuing (the
            # jobframework reconciler calls workload.AdjustResources on
            # create — RuntimeClass overhead, LimitRange defaults,
            # limits-as-missing-requests). Unconditional: the
            # limits-as-requests step applies even with no LimitRange
            # or RuntimeClass objects (resources.go handleLimitsToRequests)
            from kueue_tpu_torch.core.limit_range import adjust_workload_resources

            adjust_workload_resources(
                wl, self.limit_ranges.values(), self.runtime_classes
            )
            # inactive workloads never queue (workload_controller.go
            # create/update handlers route them out of the queues)
            self.queues.add_or_update_workload(wl)
            # enqueue opens the lifecycle trace (idempotent across
            # status-update re-adds); a propagated traceparent label
            # (MultiKueue dispatch / HTTP apply) JOINS the upstream
            # trace so one id spans manager, worker and replica
            from kueue_tpu_torch.tracing import TRACEPARENT_LABEL

            self.tracer.begin_workload(
                wl.key,
                traceparent=(wl.labels or {}).get(TRACEPARENT_LABEL),
            )

    def delete_workload(self, wl: Workload) -> None:
        self._journal_wl_delete(wl.key)
        self.workloads.pop(wl.key, None)
        self.indexer.delete(wl.key)
        self.audit.forget(wl.key)  # history follows the object lifecycle
        self.tracer.forget_workload(wl.key)
        self.quarantine.forget(wl.key)  # strikes die with the object
        self.queues.delete_workload(wl)
        if self.topology_ungater is not None:
            # drop any outstanding ungate expectations: a recreated
            # workload under the same key must not inherit the barrier
            self.topology_ungater.expectations.forget(wl.key)
        if self.cache.delete_workload(wl):
            self.queues.queue_associated_inadmissible_workloads_after(
                wl.admission.cluster_queue if wl.admission else ""
            )

    def on_workload_finished(self, wl: Workload) -> None:
        cq_name = wl.admission.cluster_queue if wl.admission else ""
        self.tracer.end_workload(wl.key, status="Finished", cq=cq_name)
        self.queues.delete_workload(wl)
        if self.cache.delete_workload(wl):
            self.queues.queue_associated_inadmissible_workloads_after(cq_name)
        # quota release is a durable transition: the recovered cache
        # must not keep charging a finished workload
        self._journal_wl(wl, require_stored=True)

    def unset_quota_reservation(self, wl: Workload, reason: str, message: str) -> None:
        """workload.UnsetQuotaReservationWithCondition + requeue."""
        now = self.clock.now()
        cq_name = wl.admission.cluster_queue if wl.admission else ""
        if self.topology_ungater is not None:
            # eviction invalidates the old assignment's pending ungates
            self.topology_ungater.expectations.forget(wl.key)
        if self.cache.delete_workload(wl):
            self.queues.queue_associated_inadmissible_workloads_after(cq_name)
        wl.admission = None
        wl.set_condition(
            WorkloadConditionType.QUOTA_RESERVED, False, reason, message, now=now
        )
        if WorkloadConditionType.ADMITTED in wl.conditions:
            wl.set_condition(
                WorkloadConditionType.ADMITTED, False, "NoReservation",
                "The workload has no reservation", now=now,
            )
        wl.conditions.pop(WorkloadConditionType.EVICTED, None)
        if wl.active:
            self.queues.requeue_workload(wl, RequeueReason.GENERIC)
        # the quota release + requeue is the durable post-state (the
        # Evicted event journaled the pre-release state; this record
        # supersedes it so replay cannot resurrect the admission)
        self._journal_wl(wl, require_stored=True)

    def list_workloads(self, field: str, value: str) -> List[Workload]:
        """Index-backed workload listing (the analog of client.List with
        MatchingFields over a registered field index)."""
        out = []
        for key in self.indexer.lookup(field, value):
            wl = self.workloads.get(key)
            if wl is not None:
                out.append(wl)
        return out

    def has_job_for(self, wl: Workload) -> bool:
        return wl.key in self._jobs_by_workload

    def job_for(self, wl: Workload):
        """The job owning this workload, or None (O(1) via the
        workload->job index)."""
        job_key = self._jobs_by_workload.get(wl.key)
        return self.jobs.get(job_key) if job_key else None

    def requeue_after_backoff(self, wl: Workload) -> None:
        # The Requeued-condition flip is a workload update event: the
        # queue's push_or_update unparks it (manager.go UpdateWorkload).
        self.queues.add_or_update_workload(wl)
        self._journal_wl(wl)

    def on_pods_ready_changed(self, wl: Workload, ready: bool) -> None:
        if ready:
            self.cache.workloads_not_ready.discard(wl.key)
        elif wl.is_admitted:
            self.cache.workloads_not_ready.add(wl.key)

    def on_workload_queue_changed(self, wl: Workload) -> None:
        self.queues.delete_workload(wl)
        self.queues.add_or_update_workload(wl)
        # queue_name is an indexed field mutated in place with no event
        self.indexer.update(wl.key, wl)
        self._journal_wl(wl, require_stored=True)

    def update_reclaimable_pods(self, wl: Workload, recl: Dict[str, int]) -> None:
        wl.reclaimable_pods = dict(recl)
        # dynamic reclaim frees quota for admitted workloads: re-track
        if wl.admission is not None:
            self.cache.add_or_update_workload(wl)
            self.queues.queue_associated_inadmissible_workloads_after(
                wl.admission.cluster_queue
            )
        self._journal_wl(wl, require_stored=True)

    # ---- the loop ----
    def reconcile_once(self) -> None:
        self._sweep_quarantine()
        for job in list(self.jobs.values()):
            self.job_reconciler.reconcile(job)
        for wl in list(self.workloads.values()):
            self.workload_reconciler.reconcile(wl)
            for ctrl in self.admission_check_controllers:
                ctrl(wl)
        for ctrl in self.admission_check_controllers:
            # controllers buffering cross-cluster writes (MultiKueue
            # batched dispatch) flush once per pass
            flush = getattr(ctrl, "flush", None)
            if flush is not None:
                flush()
        if self.federation is not None:
            self.federation.step()
        if self.topology_ungater is not None:
            self._run_topology_ungater()
        self._update_queue_visibility()

    # CQ status pending-workloads snapshots (the deprecated
    # QueueVisibility feature: clusterqueue_controller.go's snapshot
    # worker publishing the top pending heads into CQ status; the
    # on-demand visibility API is the successor and always available)
    queue_visibility_max_count = 10
    # refresh cadence (queueVisibility.updateIntervalSeconds — the
    # reference runs a periodic worker, not an inline per-cycle sort)
    queue_visibility_update_interval_s = 5.0
    _queue_visibility_last = float("-inf")

    def _update_queue_visibility(self) -> None:
        from kueue_tpu_torch.features import enabled

        if not enabled("QueueVisibility"):
            if self.cq_pending_snapshots:
                self.cq_pending_snapshots = {}  # no stale data when off
            return
        now = self.clock.now()
        if now - self._queue_visibility_last < self.queue_visibility_update_interval_s:
            return
        self._queue_visibility_last = now
        from kueue_tpu_torch.visibility import pending_workloads_in_cq

        self.cq_pending_snapshots = {
            name: [
                {
                    "name": pw.name,
                    "namespace": pw.namespace,
                    "localQueueName": pw.local_queue_name,
                    "priority": pw.priority,
                    "positionInClusterQueue": pw.position_in_cluster_queue,
                }
                for pw in pending_workloads_in_cq(
                    self.queues, name, limit=self.queue_visibility_max_count
                ).items
            ]
            for name in self.queues.cluster_queues
        }

    def _run_topology_ungater(self) -> None:
        """Per TAS-admitted pod-group workload: deliver last pass's pod
        events (the informer echo), then reconcile the ungater."""
        from kueue_tpu_torch.controllers.jobs.pod import PodGroup

        for job in list(self.jobs.values()):
            if not isinstance(job, PodGroup):
                continue
            wl = self.workloads.get(self._wl_key_for_job(job))
            if wl is None:
                continue
            self.topology_ungater.observe_job(wl.key, job)
            self.topology_ungater.reconcile(wl, job)

    # ---- control-plane invariants (recovery gate) ----
    def check_invariants(self) -> List[str]:
        """Structural consistency of the whole control plane — the
        conditions that, violated, mean the scheduler would double-book
        accelerators or strand workloads. Returns violation strings
        (empty = consistent). Recovery refuses to serve on violations;
        ``kueuectl state verify`` reports them offline.

        Checked:
        - per CQ: cached usage equals the sum of admission_usage over
          its tracked workloads, and nothing is negative;
        - every cache-tracked workload exists in the store, carries an
          admission naming that CQ;
        - no workload is simultaneously pending (heap/parking lot) and
          holding a quota reservation, and no key appears in two
          pending pools;
        - resourceVersion monotone: the journal's newest stamped rv
          never exceeds the runtime's counter;
        - heap membership consistent: every pending key resolves to a
          live, active, not-finished workload.
        """
        from kueue_tpu_torch.core.workload_info import admission_usage

        v: List[str] = []
        for name, cached in self.cache.cluster_queues.items():
            expect: Dict[object, int] = {}
            for key, wl in cached.workloads.items():
                if wl.admission is None:
                    v.append(f"cq {name}: tracked workload {key} has no admission")
                    continue
                if wl.admission.cluster_queue != name:
                    v.append(
                        f"cq {name}: tracked workload {key} admitted to "
                        f"{wl.admission.cluster_queue!r}"
                    )
                if key not in self.workloads and key not in self.cache.assumed_workloads:
                    v.append(f"cq {name}: tracked workload {key} not in store")
                for fr, qty in admission_usage(wl).items():
                    expect[fr] = expect.get(fr, 0) + qty
            actual = {fr: q for fr, q in cached.usage.items() if q != 0}
            expected = {fr: q for fr, q in expect.items() if q != 0}
            if actual != expected:
                diff = {
                    fr: (actual.get(fr, 0), expected.get(fr, 0))
                    for fr in set(actual) | set(expected)
                    if actual.get(fr, 0) != expected.get(fr, 0)
                }
                v.append(
                    f"cq {name}: usage != sum of admitted "
                    f"(actual, expected): {diff}"
                )
            for fr, qty in cached.usage.items():
                if qty < 0:
                    v.append(f"cq {name}: negative usage {fr}={qty}")
        seen_pending: Dict[str, str] = {}
        for name, pq in self.queues.cluster_queues.items():
            heap_keys = set(pq.heap.keys())
            parked_keys = set(pq.inadmissible)
            dup = heap_keys & parked_keys
            if dup:
                v.append(
                    f"cq {name}: keys in both heap and parking lot: "
                    f"{sorted(dup)}"
                )
            pending = heap_keys | parked_keys
            if pq.inflight is not None:
                pending.add(pq.inflight.key)
            for key in pending:
                prev = seen_pending.get(key)
                if prev is not None and prev != name:
                    v.append(f"workload {key} pending in both {prev} and {name}")
                seen_pending[key] = name
                wl = self.workloads.get(key)
                if wl is None:
                    v.append(f"cq {name}: pending key {key} not in store")
                    continue
                if wl.has_quota_reservation:
                    v.append(
                        f"workload {key} simultaneously pending in {name} "
                        "and holding a quota reservation"
                    )
                if wl.is_finished:
                    v.append(f"cq {name}: finished workload {key} still pending")
        if self.journal is not None and self.journal.last_rv > self.resource_version:
            v.append(
                f"resourceVersion regressed: journal stamped "
                f"{self.journal.last_rv}, runtime at {self.resource_version}"
            )
        return v

    def _state_fingerprint(self):
        parts = []
        for key in sorted(self.workloads):
            wl = self.workloads[key]
            parts.append(
                (
                    key,
                    wl.active,
                    wl.admission.cluster_queue if wl.admission else None,
                    tuple(
                        (t.value, c.status, c.reason)
                        for t, c in sorted(wl.conditions.items())
                    ),
                    tuple(
                        (n, s.state.value)
                        for n, s in sorted(wl.admission_check_states.items())
                    ),
                )
            )
        for key in sorted(self.jobs):
            job = self.jobs[key]
            parts.append((key, job.is_suspended()))
        # the recorder's resourceVersion advances on series dedups too,
        # so a repeated event still registers as progress (the old
        # len(events) missed that once dedup landed)
        return tuple(parts), self.events.resource_version

    def schedule_once(self):
        """One scheduler cycle with metric reporting."""
        import time

        t0 = time.perf_counter()
        result = self.scheduler.schedule()
        self._report_cycle_metrics(result, time.perf_counter() - t0)
        return result

    def run_until_idle(self, max_iterations: int = 50) -> int:
        """Reconcile + schedule until nothing changes. Returns cycles.

        Bulk backlogs are shaped as single-dispatch device drains: when
        the pending count clears ``bulk_drain_threshold``, one
        ``bulk_drain`` call replaces that iteration's cycle (the
        reference's scheduler-as-the-service, scheduler.go:143-154, at
        drain granularity); leftovers — fallback heads, reactivated
        parked entries below threshold — run through the normal cycle.
        """
        cycles = 0
        for _ in range(max_iterations):
            before = self._state_fingerprint()
            self.reconcile_once()
            if self.bulk_drain() is None:
                self.schedule_once()
            self.reconcile_once()
            cycles += 1
            if self._state_fingerprint() == before:
                break
        return cycles

    # ---- the bulk path: device drains as the service (north star) ----
    def drain_backlog(self, snapshot):
        """The drain-representable pending backlog exactly as the bulk
        path sees it: active queues' heads in heap order, prevalidated,
        minus partial-admission heads (those decide at reduced counts
        on the host cycle loop — no drain twin). Shared with the CLI's
        ``--drain`` what-if so its plan classifies over the same
        backlog production would."""
        sched = self.scheduler
        backlog: List[Workload] = []
        for name in sorted(self.queues.cluster_queues):
            pq = self.queues.cluster_queues[name]
            if pq.active:
                backlog.extend(pq.snapshot_active_sorted())
        _, to_assign = sched._prevalidate(backlog, snapshot)
        return [
            (e.workload, e.cq_name)
            for e in to_assign
            if not (
                sched.partial_admission
                and any(ps.min_count is not None for ps in e.workload.pod_sets)
            )
        ]

    def bulk_drain(self):
        """Decide the whole pending backlog in ONE device dispatch
        (core/drain.run_drain / run_drain_preempt) and apply the
        outcome through the same admission/eviction machinery the cycle
        loop uses. Returns the CycleResult, or None when the backlog is
        below threshold / the drain is gated off."""
        import time as _time

        from kueue_tpu_torch.core.queue_manager import queue_order_timestamp
        from kueue_tpu_torch.core.scheduler import CycleTrace
        from kueue_tpu_torch.core.snapshot import take_snapshot

        sched = self.scheduler
        if self.bulk_drain_threshold is None or sched.use_solver is False:
            return None
        if not sched.guard.allow_device():
            # device circuit open / quarantined / forced host mode: the
            # drain has no device to run on — the cycle loop (host
            # authority, per-head) decides the backlog this iteration
            return None
        if sched.wait_for_pods_ready_block and self.cache.workloads_not_ready:
            return None  # the cycle loop enforces the PodsReady block
        live = [
            pq
            for pq in self.queues.cluster_queues.values()
            if pq.active and pq.pending_active() > 0
        ]
        total = sum(pq.pending_active() for pq in live)
        # depth gate: a shallow-but-wide backlog (every CQ ~1 deep)
        # drains in a couple of ordinary cycles anyway
        if total < self.bulk_drain_threshold or total < 2 * len(live):
            return None
        # latency gate FIRST, same machinery as the cycle path: probe
        # once, then require the measured drain cost/head (plan +
        # dispatch, windowed min) to beat the host nomination estimate;
        # erode on skip so a compile-heavy probe re-probes instead of
        # latching the path off. Checked before the snapshot +
        # prevalidate pass so a gated-off iteration doesn't pay that
        # O(backlog) work twice.
        host_est = sched._host_assign_ema or sched._HOST_ASSIGN_DEFAULT
        drain_est = self._drain_est.value
        if drain_est is not None and drain_est > host_est:
            self._drain_est.erode()
            return None

        sched.guard.begin_cycle()
        t0 = _time.perf_counter()
        snapshot = take_snapshot(self.cache)
        pending = self.drain_backlog(snapshot)
        if len(pending) < self.bulk_drain_threshold:
            return None
        t_snapshot = _time.perf_counter() - t0
        sched.guard.phase_checkpoint("drain.snapshot")

        ts_fn = lambda wl: queue_order_timestamp(  # noqa: E731
            wl, self.queues._ts_policy
        )

        from kueue_tpu_torch.core.drain import (
            classify_drain_scope,
            run_drain_for_scope,
        )

        tas_flavors = (
            set(self.cache.tas_cache.flavors)
            if self.cache.tas_cache is not None
            else set()
        )
        t1 = _time.perf_counter()
        kind, pending = classify_drain_scope(
            snapshot, pending, tas_flavors, sched.fair_sharing
        )
        t_classify = _time.perf_counter() - t1
        sched.guard.phase_checkpoint("drain.classify")
        if len(pending) < self.bulk_drain_threshold:
            return None  # TAS heads dropped to the cycle loop shrank it
        if kind == "plain" and self.drain_pipeline != "off":
            # the double-buffered chunked loop (core/pipeline.py) —
            # plain scope only: speculation needs nothing beyond the
            # kernel-reported final usage, and the conflict check
            # proves each commit; other scopes keep the one-shot path.
            # With the megaloop enabled the same rounds FUSE into
            # K-rounds-per-dispatch launches (ops/megaloop_kernel),
            # validated round-by-round by the identical contract.
            if self.drain_megaloop == "on":
                return self._megaloop_bulk_drain(
                    snapshot, pending, ts_fn, t_snapshot, t_classify,
                    prefetch=self.drain_pipeline == "on",
                )
            return self._pipelined_bulk_drain(
                snapshot, pending, ts_fn, t_snapshot, t_classify,
                prefetch=self.drain_pipeline == "on",
            )
        t1 = _time.perf_counter()
        # the drain launch runs under the guard of the runtime's drain
        # rounds: an injected device fault is contained, strikes the
        # breaker and leaves this iteration's backlog to the cycle loop;
        # anything the drain itself raises leaves bulk_drain
        guarded = sched.guard.device_join(
            sched.guard.device_launch(
                lambda: run_drain_for_scope(
                    kind, snapshot, pending, self.cache.flavors,
                    tas_cache=self.cache.tas_cache,
                    fs_strategies=getattr(sched.preemptor, "fs_strategies", None),
                    timestamp_fn=ts_fn,
                    mesh=self.mesh,
                    policy=self.policy,
                    now=self.clock.now(),
                    device=self.device,
                ),
                label="bulk drain",
            ),
            lambda out: out,
        )
        if guarded.result is None:
            return None
        outcome = guarded.result
        t_solve = _time.perf_counter() - t1
        sched.guard.phase_checkpoint("drain.solve", device_used=True)
        from kueue_tpu_torch.testing import faults

        faults.fire("cycle.post_solve_pre_apply")
        # plan+dispatch cost only — the apply below is per-admission
        # bookkeeping both paths pay
        self._drain_est.observe(
            (_time.perf_counter() - t0) / max(len(pending), 1)
        )
        if not (
            outcome.admitted
            or outcome.parked
            or getattr(outcome, "preempted", None)
        ):
            # every head fell back (unrepresentable backlog): the drain
            # decided NOTHING — let the cycle loop run this iteration,
            # or run_until_idle would see an unchanged fingerprint and
            # stop with the whole backlog still pending
            return None
        t1 = _time.perf_counter()
        # the drain IS this iteration's cycle: number it before the
        # apply so its decision records carry the right cycle id — and
        # open its span-tree buffer so those records (and any guard/
        # journal spans the apply produces) reference this trace
        sched.scheduling_cycle += 1
        sched.tracer.next_cycle(sched.scheduling_cycle)
        try:
            result = self._apply_drain_outcome(outcome, snapshot)
        except faults.InjectedCrash:
            raise  # simulated power loss: the recovery chaos suite's window
        except Exception as exc:  # noqa: BLE001 — contained apply: the
            # admissions that committed stand (transactional per head);
            # unprocessed heads remain in their heaps for the cycle loop
            sched.guard.note_contained_cycle(exc)
            sched.tracer.discard_cycle()
            return None
        t_apply = _time.perf_counter() - t1
        sched.guard.phase_checkpoint("drain.apply", device_used=True)
        self._note_mesh_metrics()
        dt = _time.perf_counter() - t0
        trace = CycleTrace(
            cycle=sched.scheduling_cycle,
            heads=len(pending),
            admitted=len(result.admitted),
            preempting=len(result.preempting),
            resolution="drain",
            total_s=dt,
            # drain-path phase attribution: snapshot+backlog collection,
            # scope classification, the device plan+dispatch, and the
            # host-side outcome apply
            spans={
                "snapshot": t_snapshot,
                "classify": t_classify,
                "solve": t_solve,
                "apply": t_apply,
            },
            device_s=t_solve,
            host_s=dt - t_solve,
            mesh=self._mesh_label,
        )
        sched.tracer.record_cycle(trace)
        sched.last_traces.append(trace)
        self._report_cycle_metrics(result, dt)
        sched.notify_cycle(result)
        return result

    def _megaloop_bulk_drain(
        self, snapshot, pending, ts_fn, t_snapshot, t_classify,
        prefetch=True,
    ):
        """The fused drain loop (ops/megaloop_kernel): ONE dispatch
        computes up to K drain rounds of ``pipeline_chunk_cycles``
        kernel cycles each entirely on device — encode→solve→usage
        carry across rounds with per-round head re-packs on device —
        and the host journals/applies/audits the batched round-stamped
        decision log trailing it. Every round past the first is
        validated by the pipeline's conflict-check contract
        (``drain_inputs_match`` + ``pending_matches`` against the REAL
        post-apply state); any mismatch truncates the batch at that
        round, discards the rest of the device log and re-solves from
        the real state — so correctness never rests on the fused
        continuation. With ``prefetch`` (drain_pipeline "on") the NEXT
        fused launch dispatches speculatively from the final round's
        kernel usage while the host is still applying the batch.

        Guard coverage: the deadline spans the whole launch→fetch
        window scaled by K; sampled divergence checks replay ONE
        pseudo-randomly chosen round of every N-th launch against the
        numpy drain mirror BEFORE applying it (surface
        "drain-megaloop"; a mismatch raises KernelError); the online RoundsTuner picks K per backlog
        mix unless ``--megaloop K`` pins it. Fault points:
        ``cycle.megaloop_launched`` after every fused dispatch,
        ``cycle.megaloop_commit_round`` after every passed per-round
        conflict check (nothing speculative is journaled before it)."""
        import time as _time

        from kueue_tpu_torch.core.drain import launch_drain_megaloop, run_drain
        from kueue_tpu_torch.core.pipeline import (
            drain_inputs_match,
            outcome_signature,
            pending_matches,
            speculative_snapshot,
        )
        from kueue_tpu_torch.core.scheduler import CycleTrace
        from kueue_tpu_torch.core.snapshot import take_snapshot
        from kueue_tpu_torch.testing import faults

        sched = self.scheduler
        stats = self.megaloop
        pstats = self.pipeline
        chunk = self.pipeline_chunk_cycles
        flavors = self.cache.flavors
        last_result = None
        mesh = self.mesh
        if mesh is None and self._drain_resident is None:
            from kueue_tpu_torch.core.encode import ResidentEncoder

            self._drain_resident = ResidentEncoder(self.device)
        resident = self._drain_resident if mesh is None else None
        # one policy clock for the whole fused drain (the sampled
        # divergence replay must compile identical score tensors)
        policy, pol_now = self.policy, self.clock.now()
        tuner = sched.guard.rounds_tuner

        def _k_for(n):
            return (
                self.megaloop_rounds
                if self.megaloop_rounds
                else tuner.k_for(n)
            )

        def _launch(snap, pend, k, label):
            dl = sched.guard.device_launch(
                lambda: launch_drain_megaloop(
                    snap, pend, flavors, timestamp_fn=ts_fn,
                    chunk_cycles=chunk, max_rounds=k, mesh=mesh,
                    resident=resident, policy=policy, now=pol_now,
                    device=self.device,
                ),
                label=label,
                # the fused launch legitimately runs K rounds of
                # device work: the deadline still covers the WHOLE
                # launch→fetch window, scaled to the batch
                deadline_s=sched.guard.config.device_deadline_s
                * max(k, 1),
            )
            faults.fire("cycle.megaloop_launched")
            return dl

        def _set_inflight(v):
            pstats.set_inflight(v)
            self.metrics.pipeline_inflight.set(v)

        k = _k_for(len(pending))
        t1 = _time.perf_counter()
        glaunch = _launch(snapshot, pending, k, "megaloop drain")
        t_dispatch = _time.perf_counter() - t1
        launches = 0
        first_trace = True
        while True:
            t1 = _time.perf_counter()
            out_g = sched.guard.device_join(glaunch, lambda h: h.fetch())
            t_solve = t_dispatch + (_time.perf_counter() - t1)
            pstats.note_solve(t_solve)
            _set_inflight(0)
            if out_g.result is None:
                # an injected device fault, contained: undecided heads
                # stay in their heaps; the breaker decides whether the
                # next iteration retries the device
                return last_result
            log = out_g.result
            handle = glaunch.handle
            launches += 1
            self._megaloop_launches += 1
            stats.note_launch(k, len(log.rounds))
            self.metrics.megaloop_launches_total.inc()
            sched.guard.phase_checkpoint("drain.solve", device_used=True)
            faults.fire("cycle.post_solve_pre_apply")
            self._drain_est.observe(t_solve / max(len(pending), 1))

            # sampled divergence: every N-th launch replays ONE round
            # of the batch against the numpy mirror before applying it
            verify_round = -1
            if sched.guard.should_sample_drain(self._megaloop_launches):
                verify_round = sched.guard.pick_replay_round(
                    len(log.rounds)
                )

            # ---- speculative prefetch of the NEXT fused launch ----
            pf = pf_snap = pf_pending = None
            pf_k = 0
            t_prefetch = 0.0
            if (
                prefetch
                and log.truncated
                and log.rounds
                and verify_round < 0
                and sched.guard.allow_device()
            ):
                last_round = log.rounds[-1]
                t1 = _time.perf_counter()
                pf_snap = speculative_snapshot(
                    snapshot, last_round.final_usage
                )
                pf_pending = list(last_round.undecided)
                pf_k = _k_for(len(pf_pending))
                pf = _launch(
                    pf_snap, pf_pending, pf_k, "megaloop prefetch"
                )
                t_prefetch = _time.perf_counter() - t1
                if pf.failed:
                    pf = None
                else:
                    pstats.note_prefetch()
                    _set_inflight(1)

            # ---- apply the log round by round, trailing the device ----
            committed = 0
            truncated_batch = False
            stalled = False
            snapshot2 = pending2 = None
            for r, outcome in enumerate(log.rounds):
                t_commit = 0.0
                if r > 0:
                    t1 = _time.perf_counter()
                    # the round's implied inputs (previous round's
                    # kernel usage over its undecided backlog) must
                    # equal the REAL post-apply state, or the rest of
                    # the device log is stale and is discarded
                    snapshot2 = take_snapshot(self.cache)
                    pending2 = self.drain_backlog(snapshot2)
                    prev = log.rounds[r - 1]
                    spec = speculative_snapshot(
                        snapshot, prev.final_usage
                    )
                    ok = (
                        bool(pending2)
                        and pending_matches(prev.undecided, pending2)
                        and drain_inputs_match(spec, snapshot2)
                    )
                    t_commit = _time.perf_counter() - t1
                    if not ok:
                        truncated_batch = True
                        stats.note_truncation()
                        self.metrics.megaloop_truncations_total.inc()
                        sched.tracer.add_cycle_span(
                            "cycle.discard",
                            attrs={
                                "why": "megaloop batch truncated",
                                "round": r,
                            },
                        )
                        break
                    faults.fire("cycle.megaloop_commit_round")
                if r == verify_round:
                    snap_v = (
                        snapshot
                        if r == 0
                        else speculative_snapshot(
                            snapshot, log.rounds[r - 1].final_usage
                        )
                    )
                    pend_v = (
                        list(pending)
                        if r == 0
                        else list(log.rounds[r - 1].undecided)
                    )
                    # a round that differs from the mirror raises
                    sched.guard.check_drain_divergence(
                        outcome_signature(outcome),
                        lambda: outcome_signature(
                            run_drain(
                                snap_v, pend_v, flavors,
                                timestamp_fn=ts_fn, max_cycles=chunk,
                                use_device=False, policy=policy,
                                now=pol_now,
                            )
                        ),
                        heads=len(pend_v),
                        surface="drain-megaloop",
                    )
                decided = bool(outcome.admitted or outcome.parked)
                if not decided:
                    # the round decided NOTHING (unrepresentable or
                    # stuck-frozen remainder): the cycle loop owns the
                    # rest; returning the last applied round keeps
                    # run_until_idle's fingerprint honest — a relaunch
                    # over the same backlog would stall identically
                    stalled = True
                    break

                sched.guard.begin_cycle()
                t1 = _time.perf_counter()
                sched.scheduling_cycle += 1
                sched.tracer.next_cycle(sched.scheduling_cycle)
                if committed == 0:
                    # the per-launch span: its children are this
                    # launch's per-round cycle traces, synthesized at
                    # commit time from the batched log
                    sched.tracer.add_cycle_span(
                        "cycle.megaloop",
                        t_solve,
                        attrs={"k": k, "rounds": len(log.rounds)},
                    )
                try:
                    result = self._apply_drain_outcome(outcome, snapshot)
                except faults.InjectedCrash:
                    raise  # simulated power loss: the chaos window
                except Exception as exc:  # noqa: BLE001 — contained
                    sched.guard.note_contained_cycle(exc)
                    sched.tracer.discard_cycle()
                    _set_inflight(0)
                    return last_result
                t_apply = _time.perf_counter() - t1
                pstats.note_apply(t_apply, overlapped=pf is not None)
                self.metrics.pipeline_overlap_ratio.set(
                    pstats.overlap_ratio
                )
                sched.guard.phase_checkpoint(
                    "drain.apply", device_used=True
                )
                committed += 1

                spans = {
                    "solve": t_solve if committed == 1 else 0.0,
                    "apply": t_apply,
                    "prefetch": t_prefetch if committed == 1 else 0.0,
                    "commit": t_commit,
                }
                if first_trace:
                    spans["snapshot"] = t_snapshot
                    spans["classify"] = t_classify
                    first_trace = False
                self._note_mesh_metrics()
                dt = sum(spans.values())
                trace = CycleTrace(
                    cycle=sched.scheduling_cycle,
                    heads=len(outcome.admitted)
                    + len(outcome.parked)
                    + len(outcome.fallback),
                    admitted=len(result.admitted),
                    preempting=len(result.preempting),
                    resolution="drain",
                    total_s=dt,
                    spans=spans,
                    device_s=t_solve if committed == 1 else 0.0,
                    host_s=dt - (t_solve if committed == 1 else 0.0),
                    mesh=self._mesh_label,
                )
                sched.tracer.record_cycle(trace)
                sched.last_traces.append(trace)
                self._report_cycle_metrics(result, dt)
                sched.notify_cycle(result)
                last_result = result

            stats.note_committed(committed)
            self.metrics.megaloop_rounds_per_launch.set(
                stats.rounds_per_launch
            )
            exhausted_clean = (
                not truncated_batch
                and log.truncated
                and committed == len(log.rounds)
            )
            if exhausted_clean:
                stats.note_exhausted()
            if not self.megaloop_rounds:
                tuner.observe(len(pending), committed, truncated_batch)

            if stalled:
                if pf is not None:
                    pstats.note_discard()
                    self.metrics.pipeline_prefetch_discards_total.inc()
                _set_inflight(0)
                return last_result

            if truncated_batch:
                # rounds past the mismatch are stale: drop any
                # speculative next launch and re-solve from the REAL
                # state (the serial fallback the contract promises)
                if pf is not None:
                    pstats.note_discard()
                    self.metrics.pipeline_prefetch_discards_total.inc()
                    _set_inflight(0)
                if snapshot2 is None:
                    snapshot2 = take_snapshot(self.cache)
                    pending2 = self.drain_backlog(snapshot2)
                if not pending2 or not sched.guard.allow_device():
                    return last_result
                k = _k_for(len(pending2))
                snapshot, pending = snapshot2, pending2
                t1 = _time.perf_counter()
                glaunch = _launch(snapshot, pending, k, "megaloop drain")
                t_dispatch = _time.perf_counter() - t1
                continue

            # fully-committed batch: the kernel's final usage IS the
            # post-apply state — the resident buffers adopt the device
            # slice so the next launch ships zero usage rows
            if (
                resident is not None
                and committed
                and committed == len(log.rounds)
            ):
                final = log.rounds[-1]
                resident.adopt(
                    handle.usage_dev(len(log.rounds) - 1),
                    final.final_usage,
                )

            if not log.truncated:
                # quiesced within the batch: done
                _set_inflight(0)
                return last_result

            # batch exhausted its K rounds with work left: validate
            # the final state and either commit the prefetched next
            # launch or dispatch a fresh one
            snapshot2 = take_snapshot(self.cache)
            pending2 = self.drain_backlog(snapshot2)
            if not pending2:
                if pf is not None:
                    pstats.note_discard()
                    self.metrics.pipeline_prefetch_discards_total.inc()
                _set_inflight(0)
                return last_result
            last_round = log.rounds[-1]
            commit_pf = (
                pf is not None
                and pf_snap is not None
                and pending_matches(last_round.undecided, pending2)
                and drain_inputs_match(pf_snap, snapshot2)
            )
            if commit_pf:
                pstats.note_commit()
                self._pipeline_committed += 1
                faults.fire("cycle.megaloop_commit_round")
                glaunch, t_dispatch, k = pf, 0.0, pf_k
            else:
                if pf is not None:
                    pstats.note_discard()
                    self.metrics.pipeline_prefetch_discards_total.inc()
                _set_inflight(0)
                if not sched.guard.allow_device():
                    return last_result
                k = _k_for(len(pending2))
                t1 = _time.perf_counter()
                glaunch = _launch(
                    snapshot2, pending2, k, "megaloop drain"
                )
                t_dispatch = _time.perf_counter() - t1
            snapshot, pending = snapshot2, pending2
            if launches >= 100000:
                _set_inflight(0)
                return last_result

    def _pipelined_bulk_drain(
        self, snapshot, pending, ts_fn, t_snapshot, t_classify,
        prefetch=True,
    ):
        """The double-buffered drain loop (core/pipeline.py): chunked
        rounds of ``pipeline_chunk_cycles`` kernel cycles each; while
        the host applies round t (journal append, runtime mutation,
        audit/event emission), round t+1's encode + device solve is
        already in flight against a speculative snapshot — the
        kernel-reported final usage of round t over the exact backlog
        round t left undecided. At commit the speculative inputs are
        compared against the real post-apply state; a mismatch discards
        the prefetch and re-solves (``prefetch=False`` runs the same
        rounds serially — the property-test comparator). Every round
        runs under the cycle guard: only injected device faults are
        contained, the deadline covers the whole launch→fetch window of
        prefetched solves, and every K-th committed prefetch is
        differentially verified against the numpy drain mirror (a
        mismatch raises KernelError)."""
        import time as _time

        from kueue_tpu_torch.core.drain import launch_drain, run_drain
        from kueue_tpu_torch.core.pipeline import (
            drain_inputs_match,
            outcome_signature,
            pending_matches,
            speculative_snapshot,
        )
        from kueue_tpu_torch.core.scheduler import CycleTrace
        from kueue_tpu_torch.core.snapshot import take_snapshot
        from kueue_tpu_torch.testing import faults

        sched = self.scheduler
        stats = self.pipeline
        chunk = self.pipeline_chunk_cycles
        flavors = self.cache.flavors
        last_result = None
        verify_next = False
        mesh = self.mesh
        if mesh is None and self._drain_resident is None:
            from kueue_tpu_torch.core.encode import ResidentEncoder

            self._drain_resident = ResidentEncoder(self.device)
        # single-device rounds reuse the resident device buffers; the
        # mesh path re-places with shardings every round (device_put
        # onto shards IS its transfer plan)
        resident = self._drain_resident if mesh is None else None
        # one policy clock for the whole pipelined drain: the sampled
        # divergence re-solve must compile IDENTICAL score/boost
        # tensors or deadline boosts would fake a divergence
        policy, pol_now = self.policy, self.clock.now()

        def _launch(snap, pend):
            return sched.guard.device_launch(
                lambda: launch_drain(
                    snap, pend, flavors, timestamp_fn=ts_fn, max_cycles=chunk,
                    mesh=mesh, resident=resident, policy=policy, now=pol_now,
                    device=self.device,
                ),
                label="pipelined drain round",
            )

        def _set_inflight(v):
            stats.set_inflight(v)
            self.metrics.pipeline_inflight.set(v)

        t1 = _time.perf_counter()
        glaunch = _launch(snapshot, pending)
        t_dispatch = _time.perf_counter() - t1
        rounds = 0
        while True:
            rounds += 1
            t1 = _time.perf_counter()
            out_g = sched.guard.device_join(glaunch, lambda h: h.fetch())
            t_solve = t_dispatch + (_time.perf_counter() - t1)
            stats.note_solve(t_solve)
            _set_inflight(0)
            if out_g.result is None:
                # an injected device fault, contained: undecided heads
                # stay in their heaps; the breaker decides whether the
                # next iteration retries the device
                return last_result
            outcome = out_g.result
            sched.guard.phase_checkpoint("drain.solve", device_used=True)
            faults.fire("cycle.post_solve_pre_apply")
            self._drain_est.observe(t_solve / max(len(pending), 1))
            if verify_next:
                verify_next = False
                snap_v, pend_v = snapshot, list(pending)
                # a round that differs from the mirror raises
                sched.guard.check_drain_divergence(
                    outcome_signature(outcome),
                    lambda: outcome_signature(
                        run_drain(
                            snap_v, pend_v, flavors, timestamp_fn=ts_fn,
                            max_cycles=chunk, use_device=False,
                            policy=policy, now=pol_now,
                        )
                    ),
                    heads=len(pend_v),
                )
            undecided = outcome.undecided
            decided = bool(outcome.admitted or outcome.parked)
            if not decided:
                # the chunk decided NOTHING (fully unrepresentable or
                # stuck-frozen backlog): remaining heads fall to the
                # cycle loop; returning the last applied round keeps
                # run_until_idle's fingerprint honest
                return last_result

            # ---- prefetch round t+1 before applying round t ----
            pf = pf_snap = None
            t_prefetch = 0.0
            if (
                prefetch
                and undecided
                and outcome.final_usage is not None
                and sched.guard.allow_device()
            ):
                t1 = _time.perf_counter()
                pf_snap = speculative_snapshot(snapshot, outcome.final_usage)
                pf = sched.guard.device_launch(
                    lambda: launch_drain(
                        pf_snap, undecided, flavors, timestamp_fn=ts_fn,
                        max_cycles=chunk, mesh=mesh, resident=resident,
                        policy=policy, now=pol_now, device=self.device,
                    ),
                    label="pipelined drain prefetch",
                )
                t_prefetch = _time.perf_counter() - t1
                if pf.failed:
                    pf = None
                else:
                    stats.note_prefetch()
                    _set_inflight(1)
                faults.fire("cycle.prefetch_launched")

            # ---- apply round t (the overlapped host stage) ----
            sched.guard.begin_cycle()
            t1 = _time.perf_counter()
            sched.scheduling_cycle += 1
            # the round's span-tree buffer: decision records from the
            # apply, discard markers and guard/journal spans land here;
            # flushed atomically with the round's CycleTrace below — a
            # crash at any fault point in between drops it whole
            sched.tracer.next_cycle(sched.scheduling_cycle)
            try:
                result = self._apply_drain_outcome(outcome, snapshot)
            except faults.InjectedCrash:
                raise  # simulated power loss: the chaos suite's window
            except Exception as exc:  # noqa: BLE001 — contained apply
                sched.guard.note_contained_cycle(exc)
                sched.tracer.discard_cycle()
                _set_inflight(0)
                return last_result
            t_apply = _time.perf_counter() - t1
            stats.note_apply(t_apply, overlapped=pf is not None)
            self.metrics.pipeline_overlap_ratio.set(stats.overlap_ratio)
            sched.guard.phase_checkpoint("drain.apply", device_used=True)

            # ---- commit or discard the prefetch ----
            t_commit = 0.0
            if undecided:
                t1 = _time.perf_counter()
                snapshot2 = take_snapshot(self.cache)
                pending2 = self.drain_backlog(snapshot2)
                if not pending2:
                    # the undecided heads vanished under us (deleted /
                    # deactivated mid-apply): nothing left to solve —
                    # drop any prefetch and finish
                    if pf is not None:
                        stats.note_discard()
                        self.metrics.pipeline_prefetch_discards_total.inc()
                        sched.tracer.add_cycle_span(
                            "cycle.discard",
                            attrs={"why": "backlog vanished mid-apply"},
                        )
                    undecided = []
                committed = (
                    undecided
                    and pf is not None
                    and pf_snap is not None
                    and pending_matches(undecided, pending2)
                    and drain_inputs_match(pf_snap, snapshot2)
                )
                t_commit = _time.perf_counter() - t1
                if not undecided:
                    pass
                elif committed:
                    stats.note_commit()
                    self._pipeline_committed += 1
                    faults.fire("cycle.commit_pre_apply")
                    glaunch, t_dispatch = pf, 0.0
                    verify_next = sched.guard.should_sample_drain(
                        self._pipeline_committed
                    )
                else:
                    if pf is not None:
                        stats.note_discard()
                        self.metrics.pipeline_prefetch_discards_total.inc()
                        sched.tracer.add_cycle_span(
                            "cycle.discard",
                            attrs={"why": "speculation invalidated"},
                        )
                    _set_inflight(0)
                    t1 = _time.perf_counter()
                    glaunch = _launch(snapshot2, pending2)
                    t_dispatch = _time.perf_counter() - t1
                snapshot, pending = snapshot2, pending2

            # ---- per-round trace + metrics + notification ----
            spans = {
                "solve": t_solve,
                "apply": t_apply,
                "prefetch": t_prefetch,
                "commit": t_commit,
            }
            if rounds == 1:
                spans["snapshot"] = t_snapshot
                spans["classify"] = t_classify
            self._note_mesh_metrics()
            dt = sum(spans.values())
            trace = CycleTrace(
                cycle=sched.scheduling_cycle,
                heads=len(outcome.admitted)
                + len(outcome.parked)
                + len(outcome.fallback),
                admitted=len(result.admitted),
                preempting=len(result.preempting),
                resolution="drain",
                total_s=dt,
                spans=spans,
                device_s=t_solve,
                host_s=dt - t_solve,
                mesh=self._mesh_label,
            )
            sched.tracer.record_cycle(trace)
            sched.last_traces.append(trace)
            self._report_cycle_metrics(result, dt)
            sched.notify_cycle(result)
            last_result = result
            if not undecided or rounds >= 100000:
                _set_inflight(0)
                return last_result

    def _apply_drain_outcome(self, outcome, snapshot):
        """Apply a DrainOutcome in kernel cycle order: evictions before
        the admissions that depend on them, the same interleaving the
        sequential cycle loop would produce (compressed to one pass).
        Fallback heads stay in the heap for the cycle loop."""
        from kueue_tpu_torch.core.audit import DecisionRecord
        from kueue_tpu_torch.core.scheduler import (
            CycleResult,
            Entry,
            EntryStatus,
        )
        from kueue_tpu_torch.models.constants import InadmissibleReason
        from kueue_tpu_torch.models.constants import WorkloadConditionType as WCT

        cycle = self.scheduler.scheduling_cycle
        result = CycleResult(resolution="drain")
        events: List[tuple] = []
        for ev in getattr(outcome, "evictions", []) or []:
            events.append((ev.cycle, 0, ev))
        # TASDrainOutcome aligns a TopologyAssignment per admitted entry
        assignments = list(getattr(outcome, "assignments", []) or [])
        for idx, adm in enumerate(outcome.admitted):
            ta = assignments[idx] if idx < len(assignments) else None
            events.append((adm[3], 1, (adm, ta)))
        events.sort(key=lambda t: (t[0], t[1]))
        preempting_entries: Dict[str, Entry] = {}
        for _, kind, payload in events:
            if kind == 0:
                self._apply_drain_eviction(
                    payload, preempting_entries, result
                )
                continue
            (wl, cq_name, fmap, _cyc), ta = payload
            first = next(iter(fmap.values()), None)
            psmap = (
                fmap
                if isinstance(first, dict)
                else {wl.pod_sets[0].name: fmap}
            )
            admission = self._drain_admission(
                wl, cq_name, psmap, tas_assignment=ta
            )
            ok, _msg = self.scheduler.admit_prepared(
                wl, cq_name, admission, snapshot.cq_models[cq_name]
            )
            if ok:
                self.queues.remove_from_pending(wl)
                result.admitted.append(
                    Entry(
                        workload=wl, cq_name=cq_name,
                        status=EntryStatus.ASSUMED,
                    )
                )
                self.audit.record(
                    DecisionRecord(
                        workload=wl.key,
                        cluster_queue=cq_name,
                        cycle=cycle,
                        outcome="Admitted",
                        reason=InadmissibleReason.ADMITTED,
                        resolution="drain",
                        nominated_via="device",
                        cohort=self._cohort_of(cq_name),
                        flavors={
                            name: dict(fm) for name, fm in psmap.items()
                        },
                    )
                )
            # failure leaves the head in the heap; the cycle loop
            # retries it (same as FAILED_AFTER_NOMINATION)
        now = self.clock.now()
        for wl, cq_name in outcome.parked:
            wl.set_condition(
                WCT.QUOTA_RESERVED, False,
                reason=InadmissibleReason.INSUFFICIENT_QUOTA.value,
                message="Workload didn't fit", now=now,
            )
            self.event("Pending", wl, "Workload didn't fit")
            self.queues.park_workload(wl)
            self.audit.record(
                DecisionRecord(
                    workload=wl.key,
                    cluster_queue=cq_name,
                    cycle=cycle,
                    outcome="Pending",
                    reason=InadmissibleReason.INSUFFICIENT_QUOTA,
                    message="Workload didn't fit",
                    resolution="drain",
                    nominated_via="device",
                    cohort=self._cohort_of(cq_name),
                )
            )
        for e in result.preempting:
            self.audit.record(
                DecisionRecord(
                    workload=e.workload.key,
                    cluster_queue=e.cq_name,
                    cycle=cycle,
                    outcome="Preempting",
                    reason=InadmissibleReason.PREEMPTING,
                    resolution="drain",
                    nominated_via="device",
                    cohort=self._cohort_of(e.cq_name),
                    preemption={
                        "victims": [
                            {
                                "workload": t.workload.workload.key,
                                "reason": t.reason,
                            }
                            for t in e.preemption_targets
                        ],
                        "search": "device",
                    },
                )
            )
        return result

    def _cohort_of(self, cq_name: str) -> str:
        cached = self.cache.cluster_queues.get(cq_name)
        return (cached.model.cohort or "") if cached is not None else ""

    def _drain_admission(self, wl, cq_name: str, psmap, tas_assignment=None):
        """Admission from a drain flavor map through the SAME quota view
        as the cycle path (AssignmentResult.to_admission): per-pod
        quantities via quota_per_pod (RuntimeClass overhead + resource
        transforms), effective counts, implicit pods charge. A TAS
        drain's TopologyAssignment attaches to the topology-requesting
        podset (single-podset scope) so cache assumption charges the
        TAS leaf domains exactly like a cycle-path admission."""
        from kueue_tpu_torch.core.workload_info import (
            effective_podset_count,
            quota_per_pod,
        )
        from kueue_tpu_torch.models.workload import Admission, PodSetAssignment
        from kueue_tpu_torch.resources import PODS

        podsets = {ps.name: ps for ps in wl.pod_sets}
        psas = []
        for name, fmap in psmap.items():
            ps = podsets[name]
            count = effective_podset_count(wl, ps)
            scaled = {
                r: v * count
                for r, v in quota_per_pod(ps, self.transform_config).items()
            }
            if PODS in fmap:
                scaled[PODS] = count
            psas.append(
                PodSetAssignment(
                    name=name,
                    flavors=dict(fmap),
                    resource_usage=scaled,
                    count=count,
                    topology_assignment=(
                        tas_assignment
                        if ps.topology_request is not None
                        else None
                    ),
                )
            )
        return Admission(cluster_queue=cq_name, pod_set_assignments=tuple(psas))

    def _apply_drain_eviction(self, ev, preempting_entries, result) -> None:
        from types import SimpleNamespace

        from kueue_tpu_torch.core.scheduler import Entry, PreemptionTarget

        evictor = ev.by_workload if ev.by_workload is not None else ev.victim
        target = PreemptionTarget(
            workload=SimpleNamespace(workload=ev.victim), reason=ev.reason
        )
        self.scheduler.preemptor.issue_preemptions(
            evictor, [target], preempting_cq=ev.by_cq or ev.victim_cq
        )
        e = preempting_entries.get(evictor.key)
        if e is None:
            e = Entry(
                workload=evictor, cq_name=ev.by_cq or ev.victim_cq
            )
            preempting_entries[evictor.key] = e
            result.preempting.append(e)
        e.preemption_targets.append(target)
