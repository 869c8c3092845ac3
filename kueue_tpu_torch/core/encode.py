"""Snapshot -> device-array codec (port of kueue_tpu/core/encode.py).

One definition of the dense array layout the device kernels consume —
the cohort forest as parent links + level masks, the quota triple and
leaf usage as int64[N, FR] matrices — so every consumer reads the same
bytes for the same snapshot. ``encode_snapshot`` is view-based (no
copies); ``device_arrays`` places the arrays on a torch device;
``decode_snapshot`` rebuilds an independent, fully functional
``Snapshot`` from the arrays (the planner's per-scenario host
snapshots, ``EncodedSnapshot.with_quota``).

Also here: ``ResidentEncoder`` (the drain's device-resident tree,
paths and leaf usage between launches) and the admission-policy score
encoders (``encode_candidate_scores``, ``_multi``), which compile a
policy (kueue_tpu_torch/policy) into the int64 score tensors the
kernels argmax over.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple

import numpy as np

from kueue_tpu_torch.core.hierarchy import FlatHierarchy
from kueue_tpu_torch.core.snapshot import Snapshot, WorkloadSnapshot
from kueue_tpu_torch.ops.quota_np import subtree_quota_np
from kueue_tpu_torch.resources import FlavorResource

__all__ = [
    "EncodedSnapshot",
    "encode_snapshot",
    "decode_snapshot",
    "device_arrays",
    "ResidentEncoder",
    "encode_candidate_scores",
    "encode_candidate_scores_multi",
]


@dataclass
class EncodedSnapshot:
    """The snapshot's dense-tensor essence.

    Array fields are the device payload (what the kernels consume);
    the name tuples + host-object maps carry exactly enough identity to
    decode back into a ``Snapshot``. Quota/usage arrays are VIEWS of
    the source snapshot by default — callers mutating them (the planner
    stacking scenario variants) must copy first (``with_quota``).
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

    def with_quota(
        self,
        nominal: Optional[np.ndarray] = None,
        lending_limit: Optional[np.ndarray] = None,
        borrowing_limit: Optional[np.ndarray] = None,
        local_usage: Optional[np.ndarray] = None,
    ) -> "EncodedSnapshot":
        """A variant sharing structure but carrying replacement quota /
        usage arrays — how the planner materializes one scenario."""
        return replace(
            self,
            nominal=self.nominal if nominal is None else nominal,
            lending_limit=(
                self.lending_limit if lending_limit is None else lending_limit
            ),
            borrowing_limit=(
                self.borrowing_limit if borrowing_limit is None else borrowing_limit
            ),
            local_usage=(
                self.local_usage if local_usage is None else local_usage
            ),
        )


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


def decode_snapshot(enc: EncodedSnapshot) -> Snapshot:
    """Arrays -> an independent Snapshot (array fields copied, so the
    result is safely mutable: the planner's forecast simulation
    add/remove-usage loops run on decoded scenario snapshots without
    touching the live state)."""
    index = {name: i for i, name in enumerate(enc.cq_names)}
    for j, name in enumerate(enc.cohort_names):
        index[name] = enc.n_cq + j
    parent = np.array(enc.parent, dtype=np.int32, copy=True)
    n = parent.shape[0]
    depth = np.zeros(n, dtype=np.int32)
    for i in range(n):
        d, cur = 0, int(parent[i])
        while cur >= 0:
            d += 1
            cur = int(parent[cur])
        depth[i] = d
    flat = FlatHierarchy(
        cq_names=tuple(enc.cq_names),
        cohort_names=tuple(enc.cohort_names),
        index=index,
        parent=parent,
        depth=depth,
        max_depth=int(depth.max()) if n else 0,
        inactive_cqs=(),
    )
    nominal = np.array(enc.nominal, dtype=np.int64, copy=True)
    lend = np.array(enc.lending_limit, dtype=np.int64, copy=True)
    borrow = np.array(enc.borrowing_limit, dtype=np.int64, copy=True)
    subtree, guaranteed = subtree_quota_np(
        parent, flat.level_masks(), nominal, lend
    )
    fr_list = tuple(enc.fr_list)
    fr_index = {fr: j for j, fr in enumerate(fr_list)}
    resource_names = tuple(sorted({fr.resource for fr in fr_list}))
    rname_index = {r: i for i, r in enumerate(resource_names)}
    resource_index = np.array(
        [rname_index[fr.resource] for fr in fr_list], dtype=np.int32
    )
    snap = Snapshot(
        flat=flat,
        fr_list=fr_list,
        fr_index=fr_index,
        resource_names=resource_names,
        resource_index=resource_index,
        nominal=nominal,
        lending_limit=lend,
        borrowing_limit=borrow,
        subtree=subtree,
        guaranteed=guaranteed,
        local_usage=np.array(enc.local_usage, dtype=np.int64, copy=True),
        weight_milli=np.array(enc.weight_milli, dtype=np.int64, copy=True),
        cq_models=dict(enc.cq_models),
        inactive_cqs=tuple(enc.inactive_cqs),
        generations=dict(enc.generations),
        priority_classes=dict(enc.priority_classes),
    )
    # workload registrations WITHOUT re-adding usage: local_usage above
    # already carries their charge (add_workload would double-count)
    for key, ws in enc.workloads.items():
        snap.workloads[key] = ws
        snap._by_cq.setdefault(ws.cq_name, {})[key] = ws
    return snap


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


# ---- admission-policy score tensors (kueue_tpu_torch/policy) ----
# The policy subsystem's declarative inputs (per-flavor throughput,
# deadlines, remaining work — workload labels) enter the device path
# HERE: compiled once per lowered batch into dense int64 score tensors
# the scored kernels argmax over. Like the quota codec above, this is
# the single definition both the cycle dispatch (core/solver.pack_heads)
# and the bulk drain (core/drain.plan_drain) ship, so device kernels
# and their numpy mirrors read the SAME bytes for the same policy.


def _flavor_sig(flavor_map: dict) -> Tuple[str, ...]:
    """A candidate's distinct flavor names (one flavor per touched
    resource group; dict values repeat per resource)."""
    return tuple(sorted(set(flavor_map.values())))


def _template_sigs(flist, n_k: int, sig_cache: dict):
    """(k, flavor_sig) tuple of a template-shared candidate flavor
    list — computed ONCE per list identity (lowering shares one list
    per template, so a 50k-head backlog resolves this O(templates)
    times). The returned tuple is hashable: score rows cache on IT,
    not on template identity, so the hundreds of per-CQ templates that
    enumerate the same flavors share one compiled row."""
    sigs = sig_cache.get(id(flist))
    if sigs is None:
        sigs = sig_cache[id(flist)] = tuple(
            (k, _flavor_sig(fmap))
            for k, fmap in enumerate(flist[:n_k])
            if fmap
        )
    return sigs


def encode_candidate_scores(
    policy, heads, candidate_flavors, n_k: int
) -> np.ndarray:
    """int64[W, K] candidate scores for a cycle batch.

    ``candidate_flavors[i][k]`` is the lowered {resource: flavor} map
    (core/solver.Lowered). Candidate flavor signatures memoize per
    template-shared list identity and scores per (workload labels,
    flavor set), so compilation is O(templates + distinct pairs), not
    O(heads x candidates)."""
    w = len(heads)
    score = np.zeros((w, n_k), dtype=np.int64)
    cache: dict = {}
    sig_cache: dict = {}
    for i, wl in enumerate(heads):
        flist = candidate_flavors[i]
        if not flist:
            continue
        labels = getattr(wl, "labels", None)
        labels_sig = tuple(sorted(labels.items())) if labels else ()
        for k, fsig in _template_sigs(flist, n_k, sig_cache):
            key = (labels_sig, fsig)
            s = cache.get(key)
            if s is None:
                s = cache[key] = int(policy.candidate_score(wl, fsig))
            score[i, k] = s
    return score


def encode_candidate_scores_multi(policy, lowered) -> np.ndarray:
    """int64[W, P, K] candidate scores for a drain batch
    (core/solver.MultiLowered): every podset's candidate walk scores
    independently, exactly like its flavor walk.

    Bulk discipline (the 50k-head drain must not pay a python loop per
    candidate): heads grouped by (label signature, template flavor
    list) share ONE computed score row, scattered with fancy indexing —
    compilation is O(heads) dict appends + O(distinct groups) policy
    calls."""
    w, pmax, n_k = lowered.valid.shape
    score = np.zeros((w, pmax, n_k), dtype=np.int64)
    sig_cache: dict = {}
    groups: dict = {}  # (labels_sig, candidate sigs, p) -> [head idx]
    rep: dict = {}  # group key -> representative workload
    for i, wl in enumerate(lowered.heads):
        per_ps = lowered.candidate_flavors[i]
        if not per_ps:
            continue
        labels = getattr(wl, "labels", None)
        labels_sig = tuple(sorted(labels.items())) if labels else ()
        for p, flist in enumerate(per_ps[:pmax]):
            key = (labels_sig, _template_sigs(flist, n_k, sig_cache), p)
            g = groups.get(key)
            if g is None:
                g = groups[key] = []
                rep[key] = wl
            g.append(i)
    row_cache: dict = {}
    for key, idxs in groups.items():
        labels_sig, sigs, p = key
        rkey = (labels_sig, sigs)
        row = row_cache.get(rkey)
        if row is None:
            wl = rep[key]
            row = np.zeros(n_k, dtype=np.int64)
            for k, fsig in sigs:
                row[k] = int(policy.candidate_score(wl, fsig))
            row_cache[rkey] = row
        score[np.asarray(idxs, dtype=np.intp), p] = row
    return score


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
