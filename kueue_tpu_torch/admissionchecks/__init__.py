"""AdmissionCheck controllers — the two-phase-admission plugin boundary.

Reference: pkg/controller/admissionchecks/multikueue. Phase 1 (quota
reservation) happens in the scheduler; these controllers flip
per-workload check states to Ready (phase 2) before the workload
becomes Admitted. The port has the MultiKueue controller; the
provisioning controller is still to port.
"""

from kueue_tpu_torch.admissionchecks.multikueue import (
    MULTIKUEUE_CONTROLLER_NAME,
    MultiKueueCluster,
    MultiKueueConfig,
    MultiKueueController,
)

__all__ = [
    "MULTIKUEUE_CONTROLLER_NAME",
    "MultiKueueCluster",
    "MultiKueueConfig",
    "MultiKueueController",
]
