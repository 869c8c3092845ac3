"""Feature gates.

Mirrors pkg/features/kube_features.go:36-166 (gate names) and the
versioned defaults at :179-252, collapsed to the latest version's
default. Gates marked LockToDefault cannot be overridden.

Thread-safety follows the reference's global featuregate registry; the
TPU build keeps one process-global ``FeatureGates`` instance that tests
may swap via ``override``.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Tuple


@dataclass(frozen=True)
class GateSpec:
    default: bool
    prerelease: str  # Alpha | Beta | GA | Deprecated
    lock_to_default: bool = False


# Latest-version defaults (kube_features.go:179-252).
_SPECS: Dict[str, GateSpec] = {
    "PartialAdmission": GateSpec(True, "Beta"),
    "QueueVisibility": GateSpec(False, "Deprecated"),
    "FlavorFungibility": GateSpec(True, "Beta"),
    "ProvisioningACC": GateSpec(True, "Beta"),
    "VisibilityOnDemand": GateSpec(True, "Beta"),
    "PrioritySortingWithinCohort": GateSpec(True, "Beta"),
    "MultiKueue": GateSpec(True, "Beta"),
    "LendingLimit": GateSpec(True, "Beta"),
    "MultiKueueBatchJobWithManagedBy": GateSpec(False, "Alpha"),
    "MultiplePreemptions": GateSpec(True, "GA", lock_to_default=True),
    "TopologyAwareScheduling": GateSpec(False, "Alpha"),
    "ConfigurableResourceTransformations": GateSpec(True, "Beta"),
    "WorkloadResourceRequestsSummary": GateSpec(True, "GA", lock_to_default=True),
    "ExposeFlavorsInLocalQueue": GateSpec(True, "Beta"),
    "KeepQuotaForProvReqRetry": GateSpec(False, "Deprecated"),
    "ManagedJobsNamespaceSelector": GateSpec(True, "Beta"),
    "LocalQueueMetrics": GateSpec(False, "Alpha"),
    "LocalQueueDefaulting": GateSpec(False, "Alpha"),
    "TASProfileMostFreeCapacity": GateSpec(False, "Deprecated"),
    "TASProfileLeastFreeCapacity": GateSpec(False, "Deprecated"),
    "TASProfileMixed": GateSpec(False, "Deprecated"),
    "HierarchicalCohorts": GateSpec(True, "Beta"),
}


class FeatureGates:
    def __init__(self, overrides: Dict[str, bool] | None = None):
        self._lock = threading.Lock()
        self._values = {name: spec.default for name, spec in _SPECS.items()}
        if overrides:
            self.set_from_map(overrides)

    def enabled(self, name: str) -> bool:
        if name not in _SPECS:
            raise KeyError(f"unknown feature gate {name!r}")
        return self._values[name]

    def set(self, name: str, value: bool) -> None:
        spec = _SPECS.get(name)
        if spec is None:
            raise KeyError(f"unknown feature gate {name!r}")
        if spec.lock_to_default and value != spec.default:
            raise ValueError(
                f"feature gate {name} is locked to {spec.default}"
            )
        with self._lock:
            self._values[name] = value

    def set_from_map(self, overrides: Dict[str, bool]) -> None:
        for name, value in overrides.items():
            self.set(name, value)

    def known(self) -> Tuple[str, ...]:
        return tuple(sorted(_SPECS))


gates = FeatureGates()


def enabled(name: str) -> bool:
    return gates.enabled(name)


@contextlib.contextmanager
def override(name: str, value: bool) -> Iterator[None]:
    """Test helper — temporarily flip a gate (even locked ones)."""
    old = gates._values[name]
    with gates._lock:
        gates._values[name] = value
    try:
        yield
    finally:
        with gates._lock:
            gates._values[name] = old
