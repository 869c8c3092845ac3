"""Job framework — the adapter SPI and its reconciler state machine.

Reference: pkg/controller/jobframework/interface.go:41-173 (GenericJob +
optional capabilities) and reconciler.go:234-561 (the 8-step reconcile).
Any job kind integrates by subclassing GenericJob; the reconciler drives
create-workload -> wait-admission -> inject PodSetInfos + unsuspend ->
watch finish/eviction -> suspend/restore.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional, Sequence, Tuple

from kueue_tpu_torch.controllers.podset_info import PodSetInfo, from_assignment
from kueue_tpu_torch.models import Workload
from kueue_tpu_torch.models.constants import (
    EVICTED_BY_PREEMPTION,
    MULTIKUEUE_CONTROLLER_NAME,
    WorkloadConditionType,
)
from kueue_tpu_torch.models.workload import PodSet


class StopReason(Enum):
    WORKLOAD_DELETED = "WorkloadDeleted"
    WORKLOAD_EVICTED = "WorkloadEvicted"
    NOT_ADMITTED = "NotAdmitted"
    NO_MATCHING_WORKLOAD = "NoMatchingWorkload"


class GenericJob(abc.ABC):
    """interface.go:41-65 — what a job kind must provide."""

    kind: str = "Job"
    namespace: str = ""
    name: str = ""

    @property
    def key(self) -> str:
        return f"{self.kind}/{self.namespace}/{self.name}"

    # ---- queue binding ----
    @abc.abstractmethod
    def queue_name(self) -> str: ...

    def workload_priority_class(self) -> str:
        return ""

    # ---- suspend semantics ----
    @abc.abstractmethod
    def is_suspended(self) -> bool: ...

    @abc.abstractmethod
    def suspend(self) -> None: ...

    @abc.abstractmethod
    def pod_sets(self) -> Tuple[PodSet, ...]: ...

    @abc.abstractmethod
    def run_with_podsets_info(self, infos: Sequence[PodSetInfo]) -> None:
        """Inject node selectors/tolerations and unsuspend (interface.go:48)."""

    @abc.abstractmethod
    def restore_podsets_info(self, infos: Sequence[PodSetInfo]) -> bool:
        """Undo run-time injection on stop; True if anything changed."""

    @abc.abstractmethod
    def is_active(self) -> bool:
        """True while any pods are still running (interface.go:56)."""

    @abc.abstractmethod
    def finished(self) -> Tuple[str, bool, bool]:
        """(message, success, finished)."""

    def pods_ready(self) -> bool:
        """For WaitForPodsReady (JobWithPodsReady)."""
        return False

    # optional capabilities
    def reclaimable_pods(self) -> Optional[Dict[str, int]]:
        return None  # JobWithReclaimablePods

    def can_default_partial_admission(self) -> bool:
        return any(ps.min_count is not None for ps in self.pod_sets())


@dataclass
class JobEvent:
    kind: str
    job_key: str
    message: str = ""


class JobReconciler:
    """reconciler.go:234-561 against the in-process stores."""

    def __init__(
        self,
        runtime,  # ClusterRuntime
        manage_jobs_without_queue_name: bool = False,
        wait_for_pods_ready: bool = False,
    ):
        self.runtime = runtime
        self.manage_jobs_without_queue_name = manage_jobs_without_queue_name
        self.wait_for_pods_ready = wait_for_pods_ready
        self.events: List[JobEvent] = []

    # ---- helpers ----
    def _event(self, kind: str, job: GenericJob, message: str = "") -> None:
        self.events.append(JobEvent(kind=kind, job_key=job.key, message=message))

    def workload_name_for(self, job: GenericJob) -> str:
        return f"{job.kind.lower()}-{job.name}"

    def _workload_for(self, job: GenericJob) -> Optional[Workload]:
        return self.runtime.workloads.get(
            f"{job.namespace}/{self.workload_name_for(job)}"
        )

    @staticmethod
    def _compare_podsets(job_podsets, wl_podsets, counts=None) -> bool:
        if len(job_podsets) != len(wl_podsets):
            return False
        for jps, wps in zip(job_podsets, wl_podsets):
            if jps.name != wps.name or dict(jps.requests) != dict(wps.requests):
                return False
            expected = counts.get(wps.name, wps.count) if counts else wps.count
            if jps.count != expected:
                return False
        return True

    def _adjusted_job_podsets(self, job: GenericJob):
        """The desired workload podsets for this job, run through the
        resource-adjustment pipeline. The reference constructs the
        desired Workload and calls AdjustResources BEFORE comparing
        (reconciler.go ConstructWorkload), so stored workloads — which
        were adjusted at ingress — compare against adjusted specs, not
        raw job specs (otherwise any LimitRange default would make
        every stored workload look stale: delete/recreate forever)."""
        import copy

        from kueue_tpu_torch.core.limit_range import adjust_workload_resources

        raw = job.pod_sets()
        if (
            not self.runtime.limit_ranges
            and not self.runtime.runtime_classes
            and not any(ps.limits for ps in raw)
        ):
            return list(raw)  # nothing can adjust: skip the probe build
        podsets = [copy.copy(ps) for ps in raw]
        for ps in podsets:
            ps.requests = dict(ps.requests)
            ps.limits = dict(ps.limits)
            ps.overhead = dict(ps.overhead)
        probe = Workload(
            namespace=job.namespace, name="-", pod_sets=tuple(podsets)
        )
        adjust_workload_resources(
            probe,
            self.runtime.limit_ranges.values(),
            self.runtime.runtime_classes,
        )
        return list(probe.pod_sets)

    def _equivalent(self, wl: Workload, job: GenericJob) -> bool:
        """EquivalentToWorkload (reconciler.go:797-860): with a quota
        reservation the job must match the RUNNING podsets — counts
        replaced by the admission's (possibly partially-admitted)
        counts; a suspended job may still match the original spec.
        Exact-count equality prevents a running job from scaling past
        its admission (quota bypass)."""
        cls = type(self)
        job_podsets = self._adjusted_job_podsets(job)
        if wl.has_quota_reservation and wl.admission is not None:
            counts = {
                psa.name: psa.count for psa in wl.admission.pod_set_assignments
            }
            if cls._compare_podsets(job_podsets, wl.pod_sets, counts):
                return True
            return job.is_suspended() and cls._compare_podsets(
                job_podsets, wl.pod_sets
            )
        return cls._compare_podsets(job_podsets, wl.pod_sets) and all(
            jps.min_count == wps.min_count
            for jps, wps in zip(job_podsets, wl.pod_sets)
        )

    # ---- stop/start (reconciler.go:487-561) ----
    def stop_job(self, job: GenericJob, wl: Optional[Workload], reason: StopReason, message: str) -> None:
        infos = (
            [PodSetInfo(name=ps.name, count=ps.count) for ps in wl.pod_sets]
            if wl is not None
            else None
        )
        if not job.is_suspended():
            job.suspend()
            self._event("Stopped", job, message)
        if infos is not None:
            job.restore_podsets_info(infos)

    def start_job(self, job: GenericJob, wl: Workload) -> None:
        infos = []
        for psa in wl.admission.pod_set_assignments:
            default_count = next(
                (ps.count for ps in wl.pod_sets if ps.name == psa.name), 0
            )
            info = from_assignment(
                psa, self.runtime.cache.flavors, default_count
            )
            # admission-check podSetUpdates (provisioning nodeSelector
            # injection, provisioning/controller.go:659+)
            for acs in wl.admission_check_states.values():
                upd = acs.pod_set_updates.get(psa.name)
                if upd:
                    info.merge(
                        PodSetInfo(
                            name=psa.name,
                            labels=dict(upd.get("labels", {})),
                            annotations=dict(upd.get("annotations", {})),
                            node_selector=dict(upd.get("node_selector", {})),
                            tolerations=list(upd.get("tolerations", [])),
                        )
                    )
            infos.append(info)
        self._inject_topology_gates(job, wl)
        job.run_with_podsets_info(infos)
        self._event("Started", job, f"Admitted by clusterQueue {wl.admission.cluster_queue}")

    @staticmethod
    def _inject_topology_gates(job: GenericJob, wl: Workload) -> None:
        """Pod webhook analog (pod_webhook.go:192-201): pods of podsets
        admitted with a TopologyAssignment carry the topology
        scheduling gate; the TAS ungater releases them per domain."""
        from kueue_tpu_torch.controllers.jobs.pod import PodGroup

        if not isinstance(job, PodGroup):
            return
        tas_podsets = {
            psa.name
            for psa in wl.admission.pod_set_assignments
            if psa.topology_assignment is not None
        }
        if not tas_podsets:
            return
        for p in job.observed():
            if p.role in tas_podsets and p.phase == "Pending":
                p.topology_gate = True

    # ---- the reconcile (reconciler.go:234-561) ----
    def reconcile(self, job: GenericJob) -> None:
        runtime = self.runtime
        now = runtime.clock.now()

        # ignore unmanaged jobs
        if not self.manage_jobs_without_queue_name and not job.queue_name():
            return
        # a foreign managedBy means some other controller owns this job
        # entirely — no workload, no quota (reference managedBy gate)
        mb = getattr(job, "managed_by", None)
        if mb is not None and mb != MULTIKUEUE_CONTROLLER_NAME:
            return

        # 1. ensure one matching workload
        wl = self._workload_for(job)
        if wl is not None and not self._equivalent(wl, job):
            # stop the job and recreate the workload (ensureOneWorkload)
            self.stop_job(job, wl, StopReason.NO_MATCHING_WORKLOAD, "No matching Workload")
            runtime.delete_workload(wl)
            self._event("DeletedWorkload", job, f"Deleted not matching Workload: {wl.key}")
            wl = None

        if wl is not None and wl.is_finished:
            return

        # 2. job finished -> declare the workload finished
        message, success, finished = job.finished()
        if finished:
            if wl is not None and not wl.is_finished:
                reason = "Succeeded" if success else "Failed"
                wl.set_condition(
                    WorkloadConditionType.FINISHED, True, reason, message, now=now
                )
                runtime.on_workload_finished(wl)
                self._event("FinishedWorkload", job, f"Workload '{wl.key}' is declared finished")
            return

        # 3. no workload -> create one (handleJobWithNoWorkload)
        if wl is None:
            if not job.is_suspended():
                self.stop_job(job, None, StopReason.NO_MATCHING_WORKLOAD, "Missing Workload; unable to restore pod templates")
            wl = self._create_workload(job)
            runtime.add_workload(wl)
            self._event("CreatedWorkload", job, f"Created Workload: {wl.key}")
            return

        # 4. reclaimable pods sync
        recl = job.reclaimable_pods()
        if recl is not None and recl != wl.reclaimable_pods:
            runtime.update_reclaimable_pods(wl, recl)

        # 5. WaitForPodsReady: surface PodsReady condition
        if self.wait_for_pods_ready:
            ready = wl.is_admitted and job.pods_ready()
            prev = wl.conditions.get(WorkloadConditionType.PODS_READY)
            if prev is None or prev.status != ready:
                wl.set_condition(
                    WorkloadConditionType.PODS_READY,
                    ready,
                    "PodsReady" if ready else "WaitingForPodsReady",
                    "All pods reached readiness" if ready else "Waiting for pods to be ready",
                    now=now,
                )
                runtime.on_pods_ready_changed(wl, ready)

        # 6. eviction
        ev = wl.conditions.get(WorkloadConditionType.EVICTED)
        if ev is not None and ev.status:
            self.stop_job(job, wl, StopReason.WORKLOAD_EVICTED, ev.message)
            if wl.has_quota_reservation and not job.is_active():
                requeued = ev.reason == EVICTED_BY_PREEMPTION
                wl.set_condition(
                    WorkloadConditionType.REQUEUED, requeued, ev.reason, ev.message, now=now
                )
                runtime.unset_quota_reservation(wl, "Pending", ev.message)
            return

        # 7. suspended
        if job.is_suspended():
            if wl.is_admitted:
                if getattr(job, "managed_by", None) == MULTIKUEUE_CONTROLLER_NAME:
                    # MultiKueue managedBy: the winning remote cluster
                    # runs the job; keep it suspended here
                    return
                self.start_job(job, wl)
                return
            q = job.queue_name()
            if wl.queue_name != q:
                wl.queue_name = q
                runtime.on_workload_queue_changed(wl)
            return

        # 8. unsuspended but not admitted -> stop
        if not wl.is_admitted:
            self.stop_job(job, wl, StopReason.NOT_ADMITTED, "Not admitted by cluster queue")

    def _create_workload(self, job: GenericJob) -> Workload:
        runtime = self.runtime
        pc_name = job.workload_priority_class()
        priority = 0
        source = ""
        if pc_name:
            pc = runtime.cache.priority_classes.get(pc_name)
            if pc is not None:
                priority = pc.value
                source = "kueue.x-k8s.io/workloadpriorityclass"
        return Workload(
            namespace=job.namespace,
            name=self.workload_name_for(job),
            queue_name=job.queue_name(),
            pod_sets=job.pod_sets(),
            priority=priority,
            priority_class_name=pc_name,
            priority_class_source=source,
            creation_time=runtime.clock.now(),
        )
