"""AdmissionCheck — the two-phase admission extension point.

Mirrors apis/kueue/v1beta1/admissioncheck_types.go: a named check
handled by a controller, with optional parameters reference. Per-
workload check states live on the Workload (AdmissionCheckState).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from kueue_tpu_torch.models.constants import AdmissionCheckStateType


@dataclass
class AdmissionCheck:
    name: str
    controller_name: str
    parameters: Optional[str] = None  # opaque reference resolved by the controller
    retry_delay_seconds: int = 15
    # Active condition (admissioncheck_controller.go:83-116): STATUS,
    # owned by the check's controller — flipped when its parameters
    # (fail to) resolve; CQs referencing an inactive check go inactive.
    # None = unset (spec applies never carry it; the runtime preserves
    # the previous condition on update and treats unset as active).
    active: Optional[bool] = None
    active_message: str = ""

    def __post_init__(self):
        if not (self.name and self.controller_name):
            raise ValueError("AdmissionCheck requires name and controllerName")


@dataclass
class AdmissionCheckState:
    name: str
    state: AdmissionCheckStateType = AdmissionCheckStateType.PENDING
    message: str = ""
    last_transition_time: float = 0.0
    pod_set_updates: dict = field(default_factory=dict)
    # podset name -> {"node_selector": {...}, "tolerations": [...], "labels": {...}}
