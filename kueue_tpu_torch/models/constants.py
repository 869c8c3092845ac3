"""Enums shared across the API model.

Values track the reference's string constants so configs and recorded
decisions diff cleanly against the Go implementation.
"""

from enum import Enum


class QueueingStrategy(str, Enum):
    """apis/kueue/v1beta1/clusterqueue_types.go:74-87."""

    STRICT_FIFO = "StrictFIFO"
    BEST_EFFORT_FIFO = "BestEffortFIFO"


class StopPolicy(str, Enum):
    """apis/kueue/v1beta1/clusterqueue_types.go:114-126."""

    NONE = "None"
    HOLD = "Hold"
    HOLD_AND_DRAIN = "HoldAndDrain"


class PreemptionPolicy(str, Enum):
    """withinClusterQueue policy (clusterqueue_types.go:424-495)."""

    NEVER = "Never"
    LOWER_PRIORITY = "LowerPriority"
    LOWER_OR_NEWER_EQUAL_PRIORITY = "LowerOrNewerEqualPriority"


class ReclaimWithinCohortPolicy(str, Enum):
    """reclaimWithinCohort policy."""

    NEVER = "Never"
    LOWER_PRIORITY = "LowerPriority"
    ANY = "Any"


class BorrowWithinCohortPolicy(str, Enum):
    NEVER = "Never"
    LOWER_PRIORITY = "LowerPriority"


class FlavorFungibilityPolicy(str, Enum):
    """clusterqueue_types.go:379-401."""

    BORROW = "Borrow"
    PREEMPT = "Preempt"
    TRY_NEXT_FLAVOR = "TryNextFlavor"


class AdmissionCheckStateType(str, Enum):
    """apis/kueue/v1beta1/admissioncheck_types.go:23-45."""

    PENDING = "Pending"
    READY = "Ready"
    RETRY = "Retry"
    REJECTED = "Rejected"


class WorkloadConditionType(str, Enum):
    """apis/kueue/v1beta1/workload_types.go:477-612."""

    QUOTA_RESERVED = "QuotaReserved"
    ADMITTED = "Admitted"
    PODS_READY = "PodsReady"
    EVICTED = "Evicted"
    PREEMPTED = "Preempted"
    REQUEUED = "Requeued"
    FINISHED = "Finished"
    DEACTIVATION_TARGET = "DeactivationTarget"


# Eviction reasons (workload_types.go).
EVICTED_BY_PREEMPTION = "Preempted"
EVICTED_BY_PODS_READY_TIMEOUT = "PodsReadyTimeout"
EVICTED_BY_ADMISSION_CHECK = "AdmissionCheck"
EVICTED_BY_CLUSTER_QUEUE_STOPPED = "ClusterQueueStopped"
EVICTED_BY_LOCAL_QUEUE_STOPPED = "LocalQueueStopped"
EVICTED_BY_DEACTIVATION = "Deactivated"
EVICTED_BY_MAXIMUM_EXECUTION_TIME = "MaximumExecutionTimeExceeded"

# AdmissionCheck controller names (two-phase admission plugins).
PROVISIONING_CONTROLLER_NAME = "kueue.x-k8s.io/provisioning-request"
MULTIKUEUE_CONTROLLER_NAME = "kueue.x-k8s.io/multikueue"


class InadmissibleReason(str, Enum):
    """Canonical admission-decision reasons (the low-cardinality label
    space of ``kueue_inadmissible_reason_total`` and the ``reason``
    field of every DecisionRecord in core/audit.py).

    Free-form inadmissibility messages stay on the record for humans;
    alerting, metrics and the visibility API key on these values only,
    so the set must stay closed — tests/test_audit.py lints that no
    ad-hoc reason string reaches the audit trail or the event recorder.
    """

    # terminal / progressing outcomes
    ADMITTED = "Admitted"
    PREEMPTING = "Preempting"
    PENDING_PREEMPTION = "PendingPreemption"
    # prevalidation (scheduler.go:361-369)
    DEACTIVATED = "WorkloadDeactivated"
    FAILED_ADMISSION_CHECKS = "FailedAdmissionChecks"
    CLUSTER_QUEUE_INACTIVE = "ClusterQueueInactive"
    CLUSTER_QUEUE_NOT_FOUND = "ClusterQueueNotFound"
    NAMESPACE_MISMATCH = "NamespaceMismatch"
    INVALID_RESOURCES = "InvalidResources"
    # flavor assignment (flavorassigner.go classification)
    RESOURCE_UNAVAILABLE = "ResourceUnavailableInClusterQueue"
    FLAVOR_NOT_FOUND = "FlavorNotFound"
    UNTOLERATED_TAINT = "UntoleratedTaint"
    NODE_AFFINITY_MISMATCH = "NodeAffinityMismatch"
    NO_QUOTA_FOR_RESOURCE = "NoQuotaForResource"
    REQUEST_EXCEEDS_CAPACITY = "RequestExceedsMaxCapacity"
    INSUFFICIENT_QUOTA = "InsufficientQuota"
    NO_FLAVOR_ATTEMPTED = "NoFlavorAttempted"
    # topology-aware scheduling
    TOPOLOGY_INCOMPATIBLE = "TopologyIncompatible"
    TOPOLOGY_NO_FIT = "TopologyNoFit"
    # in-cycle admit-loop outcomes (scheduler.go:211-292)
    OVERLAPPING_PREEMPTION = "OverlappingPreemptionTargets"
    LOST_QUOTA_RACE = "LostQuotaRace"
    WAITING_FOR_PODS_READY = "WaitingForPodsReady"
    ASSUME_FAILED = "AssumeFailed"
    DURABLE_WRITE_FAILED = "DurableWriteFailed"
    # self-healing hot path (core/guard.py): a head whose scheduling
    # raised gets a contained strike; repeated strikes quarantine it
    SCHEDULING_FAILURE = "SchedulingFailure"
    QUARANTINED = "WorkloadQuarantined"
    # admission policies (kueue_tpu/policy): a flavor that FITS but was
    # outranked by a higher-scoring flavor under the active policy —
    # distinct from "doesn't fit" so audit/metrics stay low-cardinality
    # and `kueuectl explain` can say why the flavor lost
    SCORE_OUTRANKED = "ScoreOutrankedFlavor"
    UNKNOWN = "Unknown"


# Event reasons the runtime recorder accepts (``ClusterRuntime.event``
# first argument). Closed set for the same low-cardinality contract as
# InadmissibleReason: kueue_events_total{reason=...} must not explode.
EVENT_REASONS = frozenset(
    {
        "QuotaReserved",
        "Admitted",
        "Pending",
        "Evicted",
        "Preempted",
        "Deactivated",
        "AdmissionChecksRejected",
        "ProvisioningRequestCreated",
        # two-phase provisioning (admissionchecks/provisioning.py) +
        # elastic capacity plane (kueue_tpu/elastic): the full
        # ProvisioningRequest lifecycle — capacity stood up, attempt
        # failed into the retry ladder, previously granted capacity
        # withdrawn — and the capacity-plane side of the loop (a
        # journaled flavor-quota grant, a worker cordoned ahead of
        # scale-down)
        "Provisioned",
        "ProvisioningFailed",
        "CapacityRevoked",
        "ElasticCapacityGranted",
        "ElasticWorkerCordoned",
        "MultiKueueClusterLost",
        "MultiKueueRejected",
        "MultiKueueReserved",
        # MultiKueue federation (kueue_tpu/federation): idempotent
        # retraction acks, and the per-cluster guard that sidelines a
        # persistently failing remote from new dispatches
        "MultiKueueRetracted",
        "MultiKueueClusterQuarantined",
        "MultiKueueClusterRecovered",
        # global scheduler (kueue_tpu/federation/global_scheduler.py):
        # a placement moved because another cluster's forecast beat the
        # current one past the hysteresis threshold
        "MultiKueueRebalanced",
        # durable-state subsystem (kueue_tpu/storage): journal append
        # failure flips persistence to degraded; recovery flips it back
        "JournalDegraded",
        "JournalRecovered",
        # self-healing hot path (core/guard.py): device-path circuit
        # breaker transitions, sampled-divergence quarantine of the
        # device solver, contained cycle failures, and the
        # poison-workload quarantine lifecycle
        "SolverFailover",
        "SolverRecovered",
        "SolverDiverged",
        "SchedulingCycleFailed",
        "WorkloadQuarantined",
        "WorkloadUnquarantined",
        # admission policies (kueue_tpu/policy): the active policy
        # changed (server --policy, set_policy, recovery replay)
        "PolicyConfigured",
    }
)


# Patterns mapping free-form inadmissibility messages to the canonical
# reason, most-specific first: compound messages (several flavors
# rejected for different causes, "; "-joined podsets) resolve to the
# FIRST listed pattern they match, so quota-shaped causes (closest to
# admission) dominate structural ones deterministically.
_INADMISSIBLE_PATTERNS = (
    (r"Pending the preemption", InadmissibleReason.PENDING_PREEMPTION),
    (r"overlapping preemption targets", InadmissibleReason.OVERLAPPING_PREEMPTION),
    (r"no longer fits after processing", InadmissibleReason.LOST_QUOTA_RACE),
    (r"PodsReady condition", InadmissibleReason.WAITING_FOR_PODS_READY),
    (r"lost on score to flavor", InadmissibleReason.SCORE_OUTRANKED),
    (r"insufficient unused quota", InadmissibleReason.INSUFFICIENT_QUOTA),
    (r"request > maximum capacity", InadmissibleReason.REQUEST_EXCEEDS_CAPACITY),
    (r"no quota defined for", InadmissibleReason.NO_QUOTA_FOR_RESOURCE),
    (r"Workload didn't fit", InadmissibleReason.INSUFFICIENT_QUOTA),
    (r"untolerated taint", InadmissibleReason.UNTOLERATED_TAINT),
    (r"doesn't match node affinity", InadmissibleReason.NODE_AFFINITY_MISMATCH),
    (r"unavailable in ClusterQueue", InadmissibleReason.RESOURCE_UNAVAILABLE),
    (
        r"TopologyAwareScheduling|information missing in TAS cache"
        r"|does not contain the requested level",
        InadmissibleReason.TOPOLOGY_INCOMPATIBLE,
    ),
    (r"topology|TAS pod set", InadmissibleReason.TOPOLOGY_NO_FIT),
    (r"could be attempted", InadmissibleReason.NO_FLAVOR_ATTEMPTED),
    (r"flavor \S+ not found", InadmissibleReason.FLAVOR_NOT_FOUND),
    (r"ClusterQueue \S+ is inactive", InadmissibleReason.CLUSTER_QUEUE_INACTIVE),
    (r"ClusterQueue \S+ not found", InadmissibleReason.CLUSTER_QUEUE_NOT_FOUND),
    (r"namespace doesn't match", InadmissibleReason.NAMESPACE_MISMATCH),
    (r"deactivated", InadmissibleReason.DEACTIVATED),
    (r"failed admission checks", InadmissibleReason.FAILED_ADMISSION_CHECKS),
    (
        r"limitRange|must not exceed its limits",
        InadmissibleReason.INVALID_RESOURCES,
    ),
    (r"Failed to assume", InadmissibleReason.ASSUME_FAILED),
    (r"durable write failed", InadmissibleReason.DURABLE_WRITE_FAILED),
    # self-healing hot path: quarantine dominates the strike message
    # (a quarantined head's message also names the original failure)
    (r"is quarantined", InadmissibleReason.QUARANTINED),
    (r"raised during scheduling", InadmissibleReason.SCHEDULING_FAILURE),
)


def classify_inadmissible_message(message: str) -> InadmissibleReason:
    """Map a free-form inadmissibility message onto the canonical
    reason enum. Deterministic: first matching pattern wins, so stable
    given the normalized (sorted) reason ordering the FlavorAssigner
    emits. Unmatched messages classify as UNKNOWN — the audit lint
    treats that as a bug in the emitting site, not a valid label."""
    import re as _re

    if not message:
        return InadmissibleReason.UNKNOWN
    for pattern, reason in _INADMISSIBLE_PATTERNS:
        if _re.search(pattern, message):
            return reason
    return InadmissibleReason.UNKNOWN

# TAS podset annotation equivalents (apis/kueue/v1alpha1/topology_types.go:24-79).
TOPOLOGY_MODE_REQUIRED = "Required"
TOPOLOGY_MODE_PREFERRED = "Preferred"
TOPOLOGY_MODE_UNCONSTRAINED = "Unconstrained"

MAX_PODSETS = 8          # workload_types.go podSets max
MAX_RESOURCE_GROUPS = 16  # clusterqueue_types.go resourceGroups max
DEFAULT_PODSET_NAME = "main"
