"""Priority resolution helpers (pkg/util/priority analog)."""

from __future__ import annotations

from typing import Mapping, Optional

from kueue_tpu_torch.models.priority_class import WorkloadPriorityClass
from kueue_tpu_torch.models.workload import Workload

WORKLOAD_PRIORITY_CLASS_SOURCE = "kueue.x-k8s.io/workloadpriorityclass"
POD_PRIORITY_CLASS_SOURCE = "scheduling.k8s.io/priorityclass"


def priority_of(
    wl: Workload,
    priority_classes: Optional[Mapping[str, WorkloadPriorityClass]] = None,
) -> int:
    """Resolve the effective priority of a workload.

    WorkloadPriorityClass takes precedence over the inline priority only
    when the workload's priorityClassSource names the workload-priority
    domain (matches the reference's source-gated resolution; a pod
    PriorityClass of the same name must not override the copied value).
    An empty source is deliberately treated as the workload-priority
    domain: objects built directly against this API (no webhook
    defaulting pass) reference a WorkloadPriorityClass by name alone;
    callers importing pod-PriorityClass-derived priorities must set
    source=POD_PRIORITY_CLASS_SOURCE to opt out of the override.
    """
    if (
        priority_classes
        and wl.priority_class_name
        and wl.priority_class_source in ("", WORKLOAD_PRIORITY_CLASS_SOURCE)
        and wl.priority_class_name in priority_classes
    ):
        return priority_classes[wl.priority_class_name].value
    return wl.priority
