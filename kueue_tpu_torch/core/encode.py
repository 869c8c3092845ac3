"""Snapshot -> device-array codec (port of kueue_tpu/core/encode.py).

One definition of the dense array layout the device kernels consume —
the cohort forest as parent links + level masks, the quota triple and
leaf usage as int64[N, FR] matrices — so every consumer reads the same
bytes for the same snapshot. ``encode_snapshot`` is view-based (no
copies); ``device_arrays`` places the arrays on a torch device.

This slice carries ``EncodedSnapshot``, ``encode_snapshot`` and
``device_arrays``. ``decode_snapshot`` and ``EncodedSnapshot.with_quota``
(the planner's), ``ResidentEncoder`` (device-resident rows for the
pipelined cycle path) and the admission-policy score encoders are not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np

from kueue_tpu_torch.core.snapshot import Snapshot, WorkloadSnapshot
from kueue_tpu_torch.resources import FlavorResource

__all__ = [
    "EncodedSnapshot",
    "encode_snapshot",
    "device_arrays",
]


@dataclass
class EncodedSnapshot:
    """The snapshot's dense-tensor essence.

    Array fields are the device payload (what the kernels consume);
    the name tuples + host-object maps carry exactly enough identity to
    decode back into a ``Snapshot``. Quota/usage arrays are VIEWS of
    the source snapshot — callers mutating them must copy first.
    """

    cq_names: Tuple[str, ...]
    cohort_names: Tuple[str, ...]
    fr_list: Tuple[FlavorResource, ...]
    parent: np.ndarray  # int32[N]
    level_mask: np.ndarray  # bool[D+1, N]
    nominal: np.ndarray  # int64[N, FR]
    lending_limit: np.ndarray  # int64[N, FR]
    borrowing_limit: np.ndarray  # int64[N, FR]
    local_usage: np.ndarray  # int64[N, FR]
    weight_milli: np.ndarray  # int64[N]
    generations: Dict[str, int] = field(default_factory=dict)
    inactive_cqs: Tuple[str, ...] = ()
    # host-only references (never shipped to the device)
    cq_models: Dict[str, object] = field(default_factory=dict)
    priority_classes: Dict[str, object] = field(default_factory=dict)
    workloads: Dict[str, WorkloadSnapshot] = field(default_factory=dict)

    @property
    def n_cq(self) -> int:
        return len(self.cq_names)

    @property
    def n_nodes(self) -> int:
        return self.parent.shape[0]

    @property
    def max_depth(self) -> int:
        return self.level_mask.shape[0] - 1


def encode_snapshot(snapshot: Snapshot) -> EncodedSnapshot:
    """Snapshot -> dense arrays (views; zero-copy)."""
    flat = snapshot.flat
    return EncodedSnapshot(
        cq_names=flat.cq_names,
        cohort_names=flat.cohort_names,
        fr_list=snapshot.fr_list,
        parent=flat.parent,
        level_mask=flat.level_masks(),
        nominal=snapshot.nominal,
        lending_limit=snapshot.lending_limit,
        borrowing_limit=snapshot.borrowing_limit,
        local_usage=snapshot.local_usage,
        weight_milli=snapshot.weight_milli,
        generations=snapshot.generations,
        inactive_cqs=snapshot.inactive_cqs,
        cq_models=snapshot.cq_models,
        priority_classes=snapshot.priority_classes,
        workloads=snapshot.workloads,
    )


def device_arrays(enc: EncodedSnapshot, device):
    """(QuotaTree, paths, roots): the quota tree and the ancestor paths
    as torch tensors on ``device`` (int64 quotas, int32 links), and the
    numpy root of every node."""
    from kueue_tpu_torch._torch import torch
    from kueue_tpu_torch.interop import quota_tree
    from kueue_tpu_torch.ops.assign_kernel import build_paths, build_roots

    tree = quota_tree(
        {
            "parent": enc.parent,
            "level_mask": enc.level_mask,
            "nominal": enc.nominal,
            "lending_limit": enc.lending_limit,
            "borrowing_limit": enc.borrowing_limit,
        },
        device,
    )
    paths = torch.as_tensor(build_paths(enc.parent, enc.max_depth), device=tree.device)
    return tree, paths, build_roots(enc.parent)
