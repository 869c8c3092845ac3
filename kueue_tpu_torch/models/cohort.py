"""Cohort — explicit hierarchical quota node.

Mirrors apis/kueue/v1alpha1/cohort_types.go:26-74: optional parent
(hierarchical cohorts; cycles disable the subtree), own resource groups
so interior nodes can hold quota, and a fair-sharing weight.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

from kueue_tpu_torch.models.cluster_queue import FairSharing, ResourceGroup


@dataclass
class Cohort:
    name: str
    parent: Optional[str] = None
    resource_groups: Tuple[ResourceGroup, ...] = ()
    fair_sharing: FairSharing = field(default_factory=FairSharing)

    def __post_init__(self):
        if not self.name:
            raise ValueError("Cohort.name is required")
        if self.parent == self.name:
            raise ValueError("Cohort cannot be its own parent")
