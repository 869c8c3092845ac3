"""Topology-Aware Scheduling (TAS).

Reference: pkg/cache/tas_cache.go, tas_flavor.go, tas_flavor_snapshot.go
and pkg/scheduler/flavorassigner/tas_flavorassigner.go; the port of
kueue_tpu/tas. The domain forest is flattened to dense leaf arrays
(capacity/usage per resource) with per-level segment ids; phase-1 pod
counting is one vectorized min-reduce + per-level segment sums (on the
host, or kernel B12 in ops/tas_kernel.py at fleet size), and phase-2
domain selection is the reference's greedy over the (tiny) per-level
count vectors. The TAS drain's in-kernel placement is kernel B13
(ops/drain_kernel.solve_drain_tas).
"""

from kueue_tpu_torch.tas.cache import Node, TASCache, TASFlavorCache
from kueue_tpu_torch.tas.snapshot import (
    TASAssignmentResult,
    TASFlavorSnapshot,
    TASPodSetRequest,
)
from kueue_tpu_torch.tas.manager import TASManager

__all__ = [
    "Node",
    "TASCache",
    "TASFlavorCache",
    "TASAssignmentResult",
    "TASFlavorSnapshot",
    "TASPodSetRequest",
    "TASManager",
]
