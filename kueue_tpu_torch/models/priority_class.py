"""WorkloadPriorityClass — priority independent of pod priority.

Mirrors apis/kueue/v1beta1/workloadpriorityclass_types.go.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class WorkloadPriorityClass:
    name: str
    value: int
    description: str = ""

    def __post_init__(self):
        if not self.name:
            raise ValueError("WorkloadPriorityClass.name is required")
