"""Snapshot -> device-array codec (port of kueue_tpu/core/encode.py).

One definition of the dense array layout the device kernels consume —
the cohort forest as parent links + level masks, the quota triple and
leaf usage as int64[N, FR] matrices — so every consumer reads the same
bytes for the same snapshot. ``encode_snapshot`` is view-based (no
copies); ``device_arrays`` places the arrays on a torch device.

Ported: ``EncodedSnapshot``, ``encode_snapshot``, ``device_arrays``
and ``ResidentEncoder`` (the drain's device-resident tree, paths and
leaf usage between launches). ``decode_snapshot`` and
``EncodedSnapshot.with_quota`` (the planner's) and the admission-policy
score encoders are not ported yet.
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
    "ResidentEncoder",
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
    from kueue_tpu_torch._torch import to_device
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
    paths = to_device(build_paths(enc.parent, enc.max_depth), tree.device)
    return tree, paths, build_roots(enc.parent)


class ResidentEncoder:
    """Device-resident drain encode for chained drain launches: the
    quota tree and ancestor paths stay on the card between launches,
    and each launch ships only the leaf-usage rows that changed (a row
    scatter, kernel ``scatter_rows``) instead of a full re-encode.

    ``refresh(snapshot)`` returns ``(tree, paths, usage_dev)`` whose
    content is byte-identical to a fresh encode of the same snapshot:
    the delta path fires only while the structure fingerprint (CQ and
    cohort row order, cohort edges, the quota triple) is unchanged, and
    any config change re-encodes in full. After a fully committed
    megaloop launch, ``adopt`` takes the launch's final-usage device
    slice as the resident buffer, so the next ``refresh`` diffs against
    exactly the post-apply state and ships zero rows."""

    def __init__(self, device=None):
        from kueue_tpu_torch._torch import resolve_device

        self.device = resolve_device(device)
        self._names = None
        self._parent = None
        self._quota_key = None  # (nominal, lending, borrowing) copies
        self._tree = None
        self._paths = None
        self._usage = None  # device [N, FR]
        self._usage_host = None  # numpy copy of the device content
        # telemetry
        self.full_encodes = 0
        self.delta_rounds = 0
        self.delta_rows = 0
        self.adopts = 0

    def _structure_matches(self, enc: EncodedSnapshot) -> bool:
        if self._names != tuple(enc.cq_names) + tuple(enc.cohort_names):
            return False
        if self._usage_host is None or (
            self._usage_host.shape != enc.local_usage.shape
        ):
            return False
        if not np.array_equal(self._parent, enc.parent):
            return False
        nom, lend, bor = self._quota_key
        return (
            np.array_equal(nom, enc.nominal)
            and np.array_equal(lend, enc.lending_limit)
            and np.array_equal(bor, enc.borrowing_limit)
        )

    def refresh(self, snapshot: Snapshot):
        """(tree, paths, usage_dev) with the least transfer."""
        from kueue_tpu_torch._torch import to_device
        from kueue_tpu_torch.core.solver import _bucket
        from kueue_tpu_torch.ops.resident import scatter_rows

        enc = encode_snapshot(snapshot)
        if not self._structure_matches(enc):
            self._tree, self._paths, _ = device_arrays(enc, self.device)
            self._usage = to_device(enc.local_usage, self.device, np.int64)
            self._usage_host = enc.local_usage.copy()
            self._names = tuple(enc.cq_names) + tuple(enc.cohort_names)
            self._parent = np.array(enc.parent, copy=True)
            self._quota_key = (
                enc.nominal.copy(),
                enc.lending_limit.copy(),
                enc.borrowing_limit.copy(),
            )
            self.full_encodes += 1
            return self._tree, self._paths, self._usage

        new = enc.local_usage
        changed = (new != self._usage_host).any(axis=1)
        idx = np.flatnonzero(changed)
        if idx.size:
            if idx.size > max(16, new.shape[0] // 4):
                # bulk change: a fresh upload beats a large scatter
                self._usage = to_device(new, self.device, np.int64)
            else:
                # the delta width is bucketed as the reference buckets
                # it, padded by repeating the first changed row (an
                # idempotent write)
                n = _bucket(int(idx.size), minimum=4)
                idx_p = np.concatenate(
                    [idx, np.full(n - idx.size, idx[0], dtype=idx.dtype)]
                ).astype(np.int32)
                # the scatter writes in place, and the buffer may be the
                # usage a launch still reads: scatter into a copy
                usage = self._usage.clone()
                scatter_rows(
                    usage,
                    to_device(idx_p, self.device),
                    to_device(new[idx_p], self.device, np.int64),
                )
                self._usage = usage
            self._usage_host = new.copy()
            self.delta_rows += int(idx.size)
        self.delta_rounds += 1
        return self._tree, self._paths, self._usage

    def adopt(self, usage_dev, usage_host: np.ndarray) -> None:
        """The megaloop's post-commit hand-off: after every round of a
        launch committed, the launch's final leaf usage IS the
        post-apply state, so the resident buffer takes the device slice
        directly and the next ``refresh`` ships zero rows. A truncated
        batch must not adopt (the real state diverged mid-batch)."""
        if self._usage_host is None or (
            self._usage_host.shape != usage_host.shape
        ):
            return  # no resident structure yet: the next refresh rebuilds
        self._usage = usage_dev
        self._usage_host = np.asarray(usage_host, dtype=np.int64).copy()
        self.adopts += 1
