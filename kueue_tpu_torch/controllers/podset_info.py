"""PodSetInfo — node-placement payload injected into started jobs.

Reference: pkg/podset/podset.go:44-150. When a workload is admitted,
each podset assignment resolves to the flavors' nodeLabels/tolerations
(plus the TAS label + scheduling gate when a topology assignment is
present); the job integration merges these into its pod templates on
start and restores the originals on stop/suspend.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kueue_tpu_torch import features
from kueue_tpu_torch.models import ResourceFlavor
from kueue_tpu_torch.models.workload import PodSetAssignment

TAS_LABEL = "kueue.x-k8s.io/tas"
TOPOLOGY_SCHEDULING_GATE = "kueue.x-k8s.io/topology"


class BadPodSetsUpdateError(ValueError):
    pass


@dataclass
class PodSetInfo:
    name: str = ""
    count: int = 0
    annotations: Dict[str, str] = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    node_selector: Dict[str, str] = field(default_factory=dict)
    tolerations: List = field(default_factory=list)
    scheduling_gates: List[str] = field(default_factory=list)

    def merge(self, other: "PodSetInfo") -> None:
        """Merge-keep-first with conflict detection (podset.go:111-141)."""
        for attr in ("annotations", "labels", "node_selector"):
            mine, theirs = getattr(self, attr), getattr(other, attr)
            for k, v in theirs.items():
                if k in mine and mine[k] != v:
                    raise BadPodSetsUpdateError(
                        f"conflict for {attr} key {k}: {mine[k]} != {v}"
                    )
            for k, v in theirs.items():
                mine.setdefault(k, v)
        for t in other.tolerations:
            if t not in self.tolerations:
                self.tolerations.append(t)
        for g in other.scheduling_gates:
            if g not in self.scheduling_gates:
                self.scheduling_gates.append(g)


def from_assignment(
    assignment: PodSetAssignment,
    flavors: Dict[str, ResourceFlavor],
    default_count: int,
) -> PodSetInfo:
    """podset.FromAssignment (:56-87): flavor nodeLabels/tolerations +
    TAS gate."""
    info = PodSetInfo(
        name=assignment.name,
        count=assignment.count or default_count,
    )
    if (
        features.enabled("TopologyAwareScheduling")
        and assignment.topology_assignment is not None
    ):
        info.labels[TAS_LABEL] = "true"
        info.scheduling_gates.append(TOPOLOGY_SCHEDULING_GATE)
    seen = set()
    for flavor_name in assignment.flavors.values():
        if flavor_name in seen:
            continue
        seen.add(flavor_name)
        flavor = flavors.get(flavor_name)
        if flavor is None:
            raise KeyError(f"flavor {flavor_name} not found")
        for k, v in flavor.node_labels.items():
            info.node_selector.setdefault(k, v)
        info.tolerations.extend(flavor.tolerations)
    return info
