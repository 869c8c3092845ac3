"""Controllers: workload lifecycle, job framework, integrations.

Behavioral port of pkg/controller/{core,jobframework,jobs} onto the
in-process object model: no API server — the ClusterRuntime in
cluster.py is the store the reconcilers react to, and reconciles run
synchronously in deterministic loops (run_until_idle), which is what
lets lifecycle tests be exact replays of the reference's envtest
scenarios.
"""

from kueue_tpu_torch.controllers.podset_info import PodSetInfo, from_assignment
from kueue_tpu_torch.controllers.jobframework import (
    GenericJob,
    JobReconciler,
    StopReason,
)
from kueue_tpu_torch.controllers.workload_controller import WorkloadReconciler
from kueue_tpu_torch.controllers.cluster import ClusterRuntime

__all__ = [
    "PodSetInfo",
    "from_assignment",
    "GenericJob",
    "JobReconciler",
    "StopReason",
    "WorkloadReconciler",
    "ClusterRuntime",
]
