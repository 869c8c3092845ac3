"""WorkloadReconciler — the workload lifecycle state machine.

Reference: pkg/controller/core/workload_controller.go:143-596. Drives:
admission-check sync (Pending -> Ready => Admitted; Retry => evict and
reset checks; Rejected => deactivate), deactivation eviction,
maximumExecutionTimeSeconds, WaitForPodsReady timeout with exponential
requeue backoff (b * 2^(n-1), capped) and optional deactivation after
backoffLimitCount.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from kueue_tpu_torch.models import Workload
from kueue_tpu_torch.models.constants import (
    EVICTED_BY_ADMISSION_CHECK,
    EVICTED_BY_DEACTIVATION,
    EVICTED_BY_MAXIMUM_EXECUTION_TIME,
    EVICTED_BY_PODS_READY_TIMEOUT,
    AdmissionCheckStateType,
    WorkloadConditionType,
)
from kueue_tpu_torch.models.workload import RequeueState


@dataclass
class WaitForPodsReadyConfig:
    """apis/config/v1beta1/configuration_types.go:216-318."""

    enable: bool = False
    timeout_seconds: float = 300.0
    block_admission: bool = False
    # requeuingStrategy
    backoff_base_seconds: float = 60.0
    backoff_limit_count: Optional[int] = None
    backoff_max_seconds: float = 3600.0
    recovery_timeout_seconds: Optional[float] = None


class WorkloadReconciler:
    def __init__(self, runtime, wait_for_pods_ready: Optional[WaitForPodsReadyConfig] = None):
        self.runtime = runtime
        self.pods_ready_cfg = wait_for_pods_ready or WaitForPodsReadyConfig()

    # ---- entry ----
    def reconcile(self, wl: Workload) -> None:
        runtime = self.runtime
        now = runtime.clock.now()

        if wl.is_finished:
            return

        # requeue-condition recovery (:160-190): Requeued=False gates the
        # pending queues; reactivation / backoff completion flips it back
        req = wl.conditions.get(WorkloadConditionType.REQUEUED)
        if wl.active and req is not None and not req.status:
            if req.reason == EVICTED_BY_DEACTIVATION:
                wl.set_condition(
                    WorkloadConditionType.REQUEUED, True, "Reactivated",
                    "The workload was reactivated", now=now,
                )
                runtime.requeue_after_backoff(wl)
            elif req.reason in (
                EVICTED_BY_PODS_READY_TIMEOUT,
                EVICTED_BY_ADMISSION_CHECK,
            ):
                requeue_at = (
                    wl.requeue_state.requeue_at
                    if wl.requeue_state is not None
                    else None
                )
                if requeue_at is None or now >= requeue_at:
                    if wl.requeue_state is not None:
                        wl.requeue_state.requeue_at = None
                    wl.set_condition(
                        WorkloadConditionType.REQUEUED, True, "BackoffFinished",
                        "The workload backoff was finished", now=now,
                    )
                    runtime.requeue_after_backoff(wl)

        # deactivation (workload_controller.go:190-224): spec.active
        # false evicts, leaves the queues, and never requeues. The
        # REQUEUED=False breadcrumb lets the reactivation branch above
        # requeue the workload when spec.active flips back.
        if not wl.active:
            runtime.queues.delete_workload(wl)
            if not wl.is_evicted:
                self._evict(
                    wl,
                    EVICTED_BY_DEACTIVATION,
                    "The workload is deactivated",
                    now,
                )
            if wl.conditions.get(WorkloadConditionType.REQUEUED) is None or (
                wl.conditions[WorkloadConditionType.REQUEUED].status
            ):
                wl.set_condition(
                    WorkloadConditionType.REQUEUED, False,
                    EVICTED_BY_DEACTIVATION, "The workload is deactivated",
                    now=now,
                )
            self._complete_jobless_eviction(wl, now)
            return

        # evicted workloads WITHOUT a job (plain Workload objects, e.g.
        # CLI/importer-created) complete their eviction here — the job
        # reconciler's step 6 does it for job-backed ones
        self._complete_jobless_eviction(wl, now)

        # admission-check outcomes (:409-421,511-545)
        if self._sync_admission_checks(wl, now):
            return

        # maximum execution time (:546-596)
        if (
            wl.maximum_execution_time_seconds is not None
            and wl.is_admitted
        ):
            adm = wl.conditions.get(WorkloadConditionType.ADMITTED)
            elapsed = now - adm.last_transition_time
            if elapsed >= wl.maximum_execution_time_seconds:
                wl.active = False
                runtime.event(
                    "Deactivated", wl,
                    "exceeding the maximum execution time",
                )
                self._evict(
                    wl,
                    EVICTED_BY_MAXIMUM_EXECUTION_TIME,
                    "exceeding the maximum execution time",
                    now,
                )
                return

        # WaitForPodsReady timeout (:290-304,546-596)
        cfg = self.pods_ready_cfg
        if cfg.enable and wl.is_admitted and not wl.is_evicted:
            ready = wl.condition_true(WorkloadConditionType.PODS_READY)
            if not ready:
                adm = wl.conditions.get(WorkloadConditionType.ADMITTED)
                waited = now - adm.last_transition_time
                if waited >= cfg.timeout_seconds:
                    self._evict_pods_ready_timeout(wl, now)

    def _complete_jobless_eviction(self, wl: Workload, now: float) -> None:
        from kueue_tpu_torch.models.constants import EVICTED_BY_PREEMPTION

        ev = wl.conditions.get(WorkloadConditionType.EVICTED)
        if (
            ev is None
            or not ev.status
            or not wl.has_quota_reservation
            or self.runtime.has_job_for(wl)
        ):
            return
        if wl.active:
            wl.set_condition(
                WorkloadConditionType.REQUEUED,
                ev.reason == EVICTED_BY_PREEMPTION,
                ev.reason, ev.message, now=now,
            )
        self.runtime.unset_quota_reservation(wl, "Pending", ev.message)

    # ---- admission checks ----
    def _sync_admission_checks(self, wl: Workload, now: float) -> bool:
        """Returns True when an eviction/deactivation was triggered."""
        runtime = self.runtime

        rejected = [
            s for s in wl.admission_check_states.values()
            if s.state == AdmissionCheckStateType.REJECTED
        ]
        if rejected:
            # rejection deactivates the workload (:511-528)
            wl.active = False
            runtime.event(
                "AdmissionChecksRejected", wl,
                f"Deactivating workload because of rejected admission check: {rejected[0].name}",
            )
            self._evict(
                wl,
                EVICTED_BY_DEACTIVATION,
                f"Admission check {rejected[0].name} rejected the workload",
                now,
            )
            return True

        retries = [
            s for s in wl.admission_check_states.values()
            if s.state == AdmissionCheckStateType.RETRY
        ]
        if retries and wl.has_quota_reservation and not wl.is_evicted:
            self._evict(
                wl,
                EVICTED_BY_ADMISSION_CHECK,
                f"At least one admission check is false: {retries[0].name}",
                now,
            )
            # reset check states so the next attempt starts Pending
            for s in wl.admission_check_states.values():
                s.state = AdmissionCheckStateType.PENDING
            return True

        # QuotaReserved + all checks Ready -> Admitted (SyncAdmittedCondition)
        if wl.has_quota_reservation and not wl.is_admitted and wl.admission is not None:
            cq = runtime.cache.cluster_queues.get(wl.admission.cluster_queue)
            if cq is not None:
                flavors_used = {
                    f for psa in wl.admission.pod_set_assignments
                    for f in psa.flavors.values()
                }
                required = runtime.cache.admission_checks_for_workload(
                    cq.model, flavors_used
                )
                if wl.all_checks_ready(required):
                    wl.set_condition(
                        WorkloadConditionType.ADMITTED, True, "Admitted",
                        "The workload is admitted", now=now,
                    )
                    runtime.event("Admitted", wl, "The workload is admitted")
        return False

    # ---- evictions ----
    def _evict(self, wl: Workload, reason: str, message: str, now: float) -> None:
        wl.set_condition(WorkloadConditionType.EVICTED, True, reason, message, now=now)
        self.runtime.event("Evicted", wl, message)

    def _evict_pods_ready_timeout(self, wl: Workload, now: float) -> None:
        cfg = self.pods_ready_cfg
        state = wl.requeue_state or RequeueState()
        state.count += 1
        backoff = min(
            cfg.backoff_base_seconds * (2.0 ** (state.count - 1)),
            cfg.backoff_max_seconds,
        )
        state.requeue_at = now + backoff
        wl.requeue_state = state
        if cfg.backoff_limit_count is not None and state.count > cfg.backoff_limit_count:
            wl.active = False
            self.runtime.event(
                "Deactivated", wl,
                "exceeded the PodsReady requeue backoff limit",
            )
            self._evict(
                wl, EVICTED_BY_DEACTIVATION,
                "exceeded the maximum number of re-queuing retries", now,
            )
            return
        self._evict(
            wl,
            EVICTED_BY_PODS_READY_TIMEOUT,
            f"Exceeded the PodsReady timeout {wl.key}",
            now,
        )
