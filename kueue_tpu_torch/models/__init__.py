"""API object model — the framework's equivalent of Kueue's CRD types.

Python dataclasses mirroring the structure and defaulting/validation
semantics of the reference's ``apis/kueue/v1beta1`` (and v1alpha1 Cohort
/ Topology), without any Kubernetes machinery: objects are plain values
held in the framework's store, validated on construction.
"""

from kueue_tpu_torch.models.constants import (  # noqa: F401
    QueueingStrategy,
    StopPolicy,
    PreemptionPolicy,
    ReclaimWithinCohortPolicy,
    BorrowWithinCohortPolicy,
    FlavorFungibilityPolicy,
    AdmissionCheckStateType,
    WorkloadConditionType,
)
from kueue_tpu_torch.models.resource_flavor import ResourceFlavor, Toleration, Taint  # noqa: F401
from kueue_tpu_torch.models.cluster_queue import (  # noqa: F401
    ClusterQueue,
    ResourceGroup,
    FlavorQuotas,
    ResourceQuota,
    Preemption,
    BorrowWithinCohort,
    FlavorFungibility,
    FairSharing,
)
from kueue_tpu_torch.models.local_queue import LocalQueue  # noqa: F401
from kueue_tpu_torch.models.cohort import Cohort  # noqa: F401
from kueue_tpu_torch.models.topology import Topology, TopologyLevel  # noqa: F401
from kueue_tpu_torch.models.admission_check import AdmissionCheck, AdmissionCheckState  # noqa: F401
from kueue_tpu_torch.models.priority_class import WorkloadPriorityClass  # noqa: F401
from kueue_tpu_torch.models.workload import (  # noqa: F401
    Workload,
    PodSet,
    PodSetTopologyRequest,
    Admission,
    PodSetAssignment,
    TopologyAssignment,
    TopologyDomainAssignment,
    Condition,
    RequeueState,
)
