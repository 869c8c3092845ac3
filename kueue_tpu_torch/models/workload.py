"""Workload — the unit of admission.

Mirrors apis/kueue/v1beta1/workload_types.go: up to 8 podSets (pod
template resources + count, optional minCount for partial admission,
optional topologyRequest), priority, the ``active`` kill-switch and
maximumExecutionTimeSeconds. Status carries the admission (ClusterQueue
plus per-podset flavor/usage/count/topology assignments), requeue
backoff state, admission-check states, reclaimable pods and conditions.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kueue_tpu_torch.models.admission_check import AdmissionCheckState
from kueue_tpu_torch.models.constants import (
    DEFAULT_PODSET_NAME,
    MAX_PODSETS,
    TOPOLOGY_MODE_PREFERRED,
    TOPOLOGY_MODE_REQUIRED,
    TOPOLOGY_MODE_UNCONSTRAINED,
    WorkloadConditionType,
)
from kueue_tpu_torch.models.resource_flavor import Toleration
from kueue_tpu_torch.resources import Requests, requests_from_spec, scale_requests


@dataclass
class PodSetTopologyRequest:
    """workload_types.go:91-129 / topology_types.go annotations."""

    mode: str  # Required | Preferred | Unconstrained
    level: Optional[str] = None  # topology level label for Required/Preferred
    pod_index_label: Optional[str] = None

    def __post_init__(self):
        if self.mode not in (
            TOPOLOGY_MODE_REQUIRED,
            TOPOLOGY_MODE_PREFERRED,
            TOPOLOGY_MODE_UNCONSTRAINED,
        ):
            raise ValueError(f"invalid topology request mode {self.mode}")
        if self.mode != TOPOLOGY_MODE_UNCONSTRAINED and not self.level:
            raise ValueError("Required/Preferred topology request needs a level")


@dataclass
class PodSet:
    name: str = DEFAULT_PODSET_NAME
    count: int = 1
    # Per-pod resource requests in canonical int64 units.
    requests: Requests = field(default_factory=dict)
    min_count: Optional[int] = None  # enables partial admission
    topology_request: Optional[PodSetTopologyRequest] = None
    node_selector: Dict[str, str] = field(default_factory=dict)
    tolerations: Tuple[Toleration, ...] = ()
    # Per-pod resource limits; the adjustment pipeline uses them as
    # missing requests (pkg/workload/resources.go
    # UseLimitsAsMissingRequestsInPod) and validates requests <= limits.
    limits: Requests = field(default_factory=dict)
    # RuntimeClass pod overhead (podSpec.overhead): charged on top of
    # requests for quota purposes; filled from the RuntimeClass object
    # when runtime_class_name is set and overhead is empty.
    overhead: Requests = field(default_factory=dict)
    runtime_class_name: Optional[str] = None

    def __post_init__(self):
        if self.count < 1:
            raise ValueError("PodSet.count must be >= 1")
        if self.min_count is not None and not (0 < self.min_count <= self.count):
            raise ValueError("PodSet.minCount must be in (0, count]")

    @staticmethod
    def build(
        name: str, count: int, requests: Dict[str, object],
        limits: Optional[Dict[str, object]] = None,
        overhead: Optional[Dict[str, object]] = None,
        **kw,
    ) -> "PodSet":
        return PodSet(
            name=name, count=count, requests=requests_from_spec(requests),
            limits=requests_from_spec(limits or {}),
            overhead=requests_from_spec(overhead or {}),
            **kw,
        )

    def total_requests(self) -> Requests:
        return scale_requests(self.requests, self.count)


@dataclass
class TopologyDomainAssignment:
    values: Tuple[str, ...]  # label values, one per level
    count: int


@dataclass
class TopologyAssignment:
    levels: Tuple[str, ...]
    domains: Tuple[TopologyDomainAssignment, ...]


@dataclass
class PodSetAssignment:
    name: str
    # resource name -> flavor name
    flavors: Dict[str, str] = field(default_factory=dict)
    # resource name -> total canonical quantity admitted for this podset
    resource_usage: Requests = field(default_factory=dict)
    count: int = 0
    topology_assignment: Optional[TopologyAssignment] = None


@dataclass
class Admission:
    cluster_queue: str
    pod_set_assignments: Tuple[PodSetAssignment, ...] = ()


@dataclass
class Condition:
    type: WorkloadConditionType
    status: bool
    reason: str = ""
    message: str = ""
    last_transition_time: float = 0.0


@dataclass
class RequeueState:
    """workload_types.go:372-387 — eviction backoff bookkeeping."""

    count: int = 0
    requeue_at: Optional[float] = None


@dataclass
class Workload:
    namespace: str
    name: str
    queue_name: str = ""
    pod_sets: Tuple[PodSet, ...] = field(default_factory=lambda: (PodSet(),))
    priority: int = 0
    priority_class_name: str = ""
    priority_class_source: str = ""  # "" | "kueue.x-k8s.io/workloadpriorityclass" | "scheduling.k8s.io/priorityclass"
    active: bool = True
    maximum_execution_time_seconds: Optional[int] = None
    creation_time: float = 0.0
    uid: str = ""
    # object labels (kueue.x-k8s.io/multikueue-origin etc.)
    labels: Dict[str, str] = field(default_factory=dict)

    # ---- status ----
    admission: Optional[Admission] = None
    conditions: Dict[WorkloadConditionType, Condition] = field(default_factory=dict)
    admission_check_states: Dict[str, AdmissionCheckState] = field(default_factory=dict)
    requeue_state: Optional[RequeueState] = None
    # podset name -> number of pods whose resources are reclaimable (finished early)
    reclaimable_pods: Dict[str, int] = field(default_factory=dict)
    # bookkeeping mirrored from the scheduler (LastAssignment analog)
    scheduling_stats_evictions: List[str] = field(default_factory=list)
    # In-memory flavor-assignment resume state (never serialized):
    # reference keeps this on queue workload.Info as LastAssignment.
    last_assignment: Optional[object] = None

    def __post_init__(self):
        if not (self.namespace and self.name):
            raise ValueError("Workload requires namespace and name")
        if not (1 <= len(self.pod_sets) <= MAX_PODSETS):
            raise ValueError(f"Workload requires 1..{MAX_PODSETS} podSets")
        names = [ps.name for ps in self.pod_sets]
        if len(set(names)) != len(names):
            raise ValueError("podSet names must be unique")
        if not self.uid:
            self.uid = f"{self.namespace}/{self.name}"
        # identity is immutable; hot paths (snapshot simulate/undo,
        # queue maps) read .key millions of times per cycle
        self._key = f"{self.namespace}/{self.name}"

    # ---- identity ----
    @property
    def key(self) -> str:
        return self._key

    # ---- condition helpers (pkg/workload semantics) ----
    def condition_true(self, ctype: WorkloadConditionType) -> bool:
        c = self.conditions.get(ctype)
        return c is not None and c.status

    def set_condition(
        self, ctype: WorkloadConditionType, status: bool, reason: str = "",
        message: str = "", now: float = 0.0,
    ) -> None:
        """apimeta.SetStatusCondition semantics: reason/message always
        refresh, but lastTransitionTime only moves on a status flip."""
        prev = self.conditions.get(ctype)
        transition = prev is None or prev.status != status
        self.conditions[ctype] = Condition(
            type=ctype, status=status, reason=reason, message=message,
            last_transition_time=now if transition else prev.last_transition_time,
        )

    @property
    def has_quota_reservation(self) -> bool:
        return self.condition_true(WorkloadConditionType.QUOTA_RESERVED)

    @property
    def is_admitted(self) -> bool:
        return self.condition_true(WorkloadConditionType.ADMITTED)

    @property
    def is_finished(self) -> bool:
        return self.condition_true(WorkloadConditionType.FINISHED)

    @property
    def is_evicted(self) -> bool:
        return self.condition_true(WorkloadConditionType.EVICTED)

    def is_active(self) -> bool:
        return self.active

    # ---- admission checks ----
    def all_checks_ready(self, required: Tuple[str, ...]) -> bool:
        from kueue_tpu_torch.models.constants import AdmissionCheckStateType

        return all(
            self.admission_check_states.get(name) is not None
            and self.admission_check_states[name].state == AdmissionCheckStateType.READY
            for name in required
        )

    def has_rejected_check(self) -> bool:
        from kueue_tpu_torch.models.constants import AdmissionCheckStateType

        return any(
            s.state == AdmissionCheckStateType.REJECTED
            for s in self.admission_check_states.values()
        )

    def has_retry_check(self) -> bool:
        from kueue_tpu_torch.models.constants import AdmissionCheckStateType

        return any(
            s.state == AdmissionCheckStateType.RETRY
            for s in self.admission_check_states.values()
        )
