"""ResourceFlavor — a hardware variant of a resource.

Mirrors apis/kueue/v1beta1/resourceflavor_types.go:46-104: node labels
for flavor<->node matching, taints the flavor's nodes carry, extra
tolerations injected into admitted pods, and an optional topologyName
that opts the flavor into Topology-Aware Scheduling.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class Taint:
    key: str
    value: str = ""
    effect: str = "NoSchedule"  # NoSchedule | PreferNoSchedule | NoExecute


@dataclass(frozen=True)
class Toleration:
    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # empty matches all effects

    def tolerates(self, taint: Taint) -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if self.operator == "Exists":
            return self.key == "" or self.key == taint.key
        return self.key == taint.key and self.value == taint.value


@dataclass
class ResourceFlavor:
    name: str
    node_labels: Dict[str, str] = field(default_factory=dict)
    node_taints: Tuple[Taint, ...] = ()
    tolerations: Tuple[Toleration, ...] = ()
    topology_name: Optional[str] = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("ResourceFlavor.name is required")


def group_label_keys(group_flavors, flavors_by_name) -> set:
    """Label keys known to any flavor in a resource group — the only
    keys the flavor node-selector match considers
    (flavorassigner.go:640-684)."""
    keys = set()
    for fq in group_flavors:
        flavor = flavors_by_name.get(fq.name)
        if flavor is not None:
            keys.update(flavor.node_labels)
    return keys


def selector_matches(node_selector, flavor: "ResourceFlavor", allowed_keys) -> bool:
    """Node-selector match restricted to the group's flavor label keys."""
    for k, v in node_selector.items():
        if k in allowed_keys and flavor.node_labels.get(k) != v:
            return False
    return True


def flavor_eligible(flavor: Optional["ResourceFlavor"], ps, allowed_keys) -> bool:
    """Shared taint + node-selector eligibility for a podset on a flavor.

    The single source of truth for both the host FlavorAssigner walk and
    the dense-solver candidate lowering (core/solver.py) — the two paths
    must agree or the batched kernel emits candidates the host authority
    would reject."""
    if flavor is None:
        return False
    if not taints_tolerated(
        flavor.node_taints, tuple(ps.tolerations) + tuple(flavor.tolerations)
    ):
        return False
    return selector_matches(ps.node_selector, flavor, allowed_keys)


def taints_tolerated(taints, tolerations) -> bool:
    """True when every NoSchedule/NoExecute taint is tolerated.

    PreferNoSchedule taints never block placement (matches
    k8s.io/component-helpers semantics used by the reference's flavor
    selector, pkg/scheduler/flavorassigner/flavorassigner.go:640-684).
    """
    for taint in taints:
        if taint.effect == "PreferNoSchedule":
            continue
        if not any(tol.tolerates(taint) for tol in tolerations):
            return False
    return True
