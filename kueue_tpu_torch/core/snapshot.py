"""Per-cycle snapshot: cache state flattened into dense tensors.

Equivalent of the reference's ``pkg/cache/snapshot.go`` +
``clusterqueue_snapshot.go``, redesigned struct-of-arrays: instead of a
cloned object forest with simulate/undo closures, the snapshot is a set
of flat arrays (cohort-parent indices, per-node quota cells, a single
mutable [node x flavor-resource] local-usage matrix) over which

- availability queries evaluate the whole forest at once
  (ops/quota_np for host-side loops, ops/quota for the drain), and
- preemption simulation is add/subtract on one usage row — no object
  graph mutation, trivially undoable, and directly shippable to the
  card as one contiguous buffer.

Workload usage vectors are dense int64[FR] rows, so Fits/Simulate*
(clusterqueue_snapshot.go:75-150) become vector compares.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from kueue_tpu_torch.models import ClusterQueue, Workload
from kueue_tpu_torch.models.cluster_queue import ResourceQuota
from kueue_tpu_torch.core.cache import Cache
from kueue_tpu_torch.core.hierarchy import FlatHierarchy
from kueue_tpu_torch.core.workload_info import admission_usage
from kueue_tpu_torch.ops.quota import NO_LIMIT
from kueue_tpu_torch.ops.quota_np import (
    available_all_np,
    dominant_resource_share_np,
    potential_available_all_np,
    subtree_quota_np,
    usage_tree_np,
)
from kueue_tpu_torch.resources import FlavorResource, FlavorResourceQuantities


@dataclass
class WorkloadSnapshot:
    workload: Workload
    cq_name: str
    cq_row: int
    usage_vec: np.ndarray  # int64[FR]
    priority: int
    quota_reserved_time: float


@dataclass
class Snapshot:
    flat: FlatHierarchy
    fr_list: Tuple[FlavorResource, ...]
    fr_index: Dict[FlavorResource, int]
    resource_names: Tuple[str, ...]
    resource_index: np.ndarray  # int32[FR] -> resource id (sorted names)
    # quota arrays [N, FR]
    nominal: np.ndarray
    lending_limit: np.ndarray
    borrowing_limit: np.ndarray
    subtree: np.ndarray
    guaranteed: np.ndarray
    # mutable during the cycle
    local_usage: np.ndarray  # int64[N, FR]; nonzero only on CQ rows
    weight_milli: np.ndarray  # int64[N]
    cq_models: Dict[str, ClusterQueue]
    workloads: Dict[str, WorkloadSnapshot] = field(default_factory=dict)
    # per-CQ workload index (maintained by add/remove_workload) and
    # memoized root/membership lookups — the preemption candidate scan
    # hits these once per head per cycle
    _by_cq: Dict[str, Dict[str, WorkloadSnapshot]] = field(default_factory=dict)
    _roots: Optional[np.ndarray] = None
    _members: Dict[int, Set[str]] = field(default_factory=dict)
    inactive_cqs: Tuple[str, ...] = ()
    # AllocatableResourceGeneration per CQ (invalidates LastAssignment)
    generations: Dict[str, int] = field(default_factory=dict)
    # WorkloadPriorityClass map for consistent priority resolution
    priority_classes: Dict[str, object] = field(default_factory=dict)
    # derived-matrix caches, invalidated by _mutated()
    _usage_version: int = 0
    _usage_cache: Optional[tuple] = None
    _avail_cache: Optional[tuple] = None
    _pa_cache: Optional[np.ndarray] = None
    _drs_cache: Optional[tuple] = None
    # incrementally-maintained tree usage (usage_tree_np semantics):
    # updated along the mutated row's ancestor path in O(depth*FR)
    # instead of re-running the full level-scheduled reduction, so the
    # admit loop's per-entry fits() re-check is a path walk, not a
    # matrix recompute.
    _tree_usage: Optional[np.ndarray] = None
    _paths: Dict[int, List[int]] = field(default_factory=dict)

    # ---- derived state ----
    # The usage/available matrices are O(N*FR) tree reductions queried
    # thousands of times per cycle (per head, per flavor) but mutated
    # only between queries (add/remove usage). A version counter keyed
    # cache collapses the recomputes to one per mutation epoch.
    def _mutated(self) -> None:
        self._usage_version += 1

    def usage(self) -> np.ndarray:
        if self._usage_cache is None or self._usage_cache[0] != self._usage_version:
            self._usage_cache = (
                self._usage_version,
                usage_tree_np(
                    self.flat.parent, self._lm(), self.guaranteed,
                    self.local_usage,
                ),
            )
        return self._usage_cache[1]

    # ---- incremental tree usage + single-row available ----
    def _ensure_tree_usage(self) -> np.ndarray:
        if self._tree_usage is None:
            self._tree_usage = self.usage().copy()
        return self._tree_usage

    def _apply_tree_delta(self, row: int, vec: np.ndarray, sign: int) -> None:
        """Propagate a leaf usage change up the cohort path; exact twin
        of re-running usage_tree_np (child contribution to its parent is
        max(0, usage - guaranteed))."""
        if self._tree_usage is None:
            return
        U, G, parent = self._tree_usage, self.guaranteed, self.flat.parent
        delta = sign * vec
        cur = row
        while True:
            old_excess = np.maximum(0, U[cur] - G[cur])
            U[cur] = U[cur] + delta
            p = int(parent[cur])
            if p < 0:
                break
            delta = np.maximum(0, U[cur] - G[cur]) - old_excess
            if not delta.any():
                break
            cur = p

    def _path_of(self, row: int) -> List[int]:
        path = self._paths.get(row)
        if path is None:
            path = [row] + self.path_to_root(row)
            self._paths[row] = path
        return path

    def available_row(self, row: int) -> np.ndarray:
        """available() for one node via a root->node path walk over the
        incrementally-maintained tree usage — O(depth*FR) instead of the
        O(N*FR) full reduction; parity with available_all_np is asserted
        in tests."""
        U = self._ensure_tree_usage()
        path = self._path_of(row)
        root = path[-1]
        avail = self.subtree[root] - U[root]
        for n in reversed(path[:-1]):
            stored = self.subtree[n] - self.guaranteed[n]
            used = np.maximum(0, U[n] - self.guaranteed[n])
            with_max = stored - used + self.borrowing_limit[n]
            has_borrow = self.borrowing_limit[n] < NO_LIMIT
            clamped = np.where(has_borrow, np.minimum(with_max, avail), avail)
            avail = np.maximum(0, self.guaranteed[n] - U[n]) + clamped
        return avail

    def available(self) -> np.ndarray:
        if self._avail_cache is None or self._avail_cache[0] != self._usage_version:
            self._avail_cache = (
                self._usage_version,
                available_all_np(
                    self.flat.parent, self._lm(), self.subtree,
                    self.guaranteed, self.borrowing_limit, self.usage(),
                ),
            )
        return self._avail_cache[1]

    def potential_available(self) -> np.ndarray:
        if self._pa_cache is None:  # usage-independent: compute once
            self._pa_cache = potential_available_all_np(
                self.flat.parent, self._lm(), self.subtree, self.guaranteed,
                self.borrowing_limit,
            )
        return self._pa_cache

    def _lm(self) -> np.ndarray:
        return self.flat.level_masks()

    def row(self, cq_name: str) -> int:
        return self.flat.index[cq_name]

    # ---- queries (ClusterQueueSnapshot equivalents) ----
    def fits(self, cq_name: str, usage_vec: np.ndarray) -> bool:
        """FitInCohort/Fits: every requested cell within available."""
        avail = self.available_row(self.row(cq_name))
        need = usage_vec > 0
        return bool(np.all(avail[need] >= usage_vec[need]))

    def available_for(self, cq_name: str) -> np.ndarray:
        return self.available_row(self.row(cq_name))

    def borrowing_after(self, cq_name: str, usage_vec: np.ndarray) -> bool:
        """Would admitting usage_vec push the CQ above its nominal
        subtree quota in any cell (i.e. require borrowing)?"""
        r = self.row(cq_name)
        after = self.local_usage[r] + usage_vec
        return bool(np.any(after > self.subtree[r]))

    def is_borrowing(self, cq_name: str) -> bool:
        r = self.row(cq_name)
        return bool(np.any(self.local_usage[r] > self.subtree[r]))

    # ---- simulation (SimulateUsageAddition/Removal, RemoveWorkload) ----
    def add_usage(self, cq_name: str, usage_vec: np.ndarray) -> None:
        row = self.row(cq_name)
        self.local_usage[row] += usage_vec
        self._apply_tree_delta(row, usage_vec, 1)
        self._mutated()

    def remove_usage(self, cq_name: str, usage_vec: np.ndarray) -> None:
        row = self.row(cq_name)
        self.local_usage[row] -= usage_vec
        self._apply_tree_delta(row, usage_vec, -1)
        self._mutated()

    def add_workload(self, ws: WorkloadSnapshot) -> None:
        self.workloads[ws.workload.key] = ws
        self._by_cq.setdefault(ws.cq_name, {})[ws.workload.key] = ws
        self.local_usage[ws.cq_row] += ws.usage_vec
        self._apply_tree_delta(ws.cq_row, ws.usage_vec, 1)
        self._mutated()

    def remove_workload(self, wl_key: str) -> Optional[WorkloadSnapshot]:
        ws = self.workloads.pop(wl_key, None)
        if ws is not None:
            self._by_cq.get(ws.cq_name, {}).pop(wl_key, None)
            self.local_usage[ws.cq_row] -= ws.usage_vec
            self._apply_tree_delta(ws.cq_row, ws.usage_vec, -1)
            self._mutated()
        return ws

    def workloads_in_cq(self, cq_name: str) -> List[WorkloadSnapshot]:
        return list(self._by_cq.get(cq_name, {}).values())

    def workloads_in_cohort_of(self, cq_name: str) -> List[WorkloadSnapshot]:
        members = self.cohort_members(cq_name)
        return [
            ws
            for m in members
            for ws in self._by_cq.get(m, {}).values()
        ]

    def roots(self) -> np.ndarray:
        """int32[N] root node per node, computed once per snapshot."""
        if self._roots is None:
            from kueue_tpu_torch.ops.assign_kernel import build_roots

            self._roots = build_roots(self.flat.parent)
        return self._roots

    def cohort_members(self, cq_name: str) -> Set[str]:
        """All CQ names in the same cohort tree (incl. cq_name)."""
        roots = self.roots()
        me = int(roots[self.row(cq_name)])
        cached = self._members.get(me)
        if cached is None:
            cached = {
                name
                for name in self.flat.cq_names
                if int(roots[self.flat.index[name]]) == me
            }
            self._members[me] = cached
        return cached

    def has_cohort(self, cq_name: str) -> bool:
        return self.flat.parent[self.row(cq_name)] >= 0

    # ---- fair sharing ----
    def dominant_resource_share(
        self, cq_name: str, wl_req: Optional[np.ndarray] = None
    ) -> int:
        n, fr = self.local_usage.shape
        wl = np.zeros((n, fr), dtype=np.int64)
        if wl_req is not None:
            wl[self.row(cq_name)] = wl_req
        dws, _ = dominant_resource_share_np(
            self.flat.parent, self._lm(), self.subtree, self.guaranteed,
            self.borrowing_limit, self.usage(), wl, self.weight_milli,
            self.resource_index, len(self.resource_names),
        )
        return int(dws[self.row(cq_name)])

    def all_node_drs(self) -> np.ndarray:
        """DominantResourceShare of every node (CQs and cohorts) against
        current usage — used by the fair-sharing preemption tournament.
        Version-cached: the tournament asks several times per pick while
        usage only changes between picks."""
        if self._drs_cache is None or self._drs_cache[0] != self._usage_version:
            n, fr = self.local_usage.shape
            dws, _ = dominant_resource_share_np(
                self.flat.parent, self._lm(), self.subtree, self.guaranteed,
                self.borrowing_limit, self.usage(),
                np.zeros((n, fr), dtype=np.int64), self.weight_milli,
                self.resource_index, len(self.resource_names),
            )
            self._drs_cache = (self._usage_version, dws)
        return self._drs_cache[1]

    def path_to_root(self, row: int) -> List[int]:
        """Node rows from `row`'s parent up to (and including) the root."""
        out: List[int] = []
        cur = int(self.flat.parent[row])
        while cur >= 0:
            out.append(cur)
            cur = int(self.flat.parent[cur])
        return out

    def children_of(self, row: int) -> Tuple[List[int], List[int]]:
        """(cq_children, cohort_children) rows of a cohort node."""
        cqs, cohorts = [], []
        n_cq = self.flat.n_cq
        for i, p in enumerate(self.flat.parent):
            if int(p) == row:
                (cqs if i < n_cq else cohorts).append(i)
        return cqs, cohorts

    def vector_of(self, usage: FlavorResourceQuantities) -> np.ndarray:
        vec = np.zeros(len(self.fr_list), dtype=np.int64)
        for fr, qty in usage.items():
            j = self.fr_index.get(fr)
            if j is not None:
                vec[j] += qty
        return vec


def _quota_cells(
    node_quotas: Dict[FlavorResource, ResourceQuota],
    fr_index: Dict[FlavorResource, int],
    nominal: np.ndarray,
    lend: np.ndarray,
    borrow: np.ndarray,
    row: int,
) -> None:
    for fr, q in node_quotas.items():
        j = fr_index[fr]
        nominal[row, j] = q.nominal
        if q.lending_limit is not None:
            lend[row, j] = q.lending_limit
        if q.borrowing_limit is not None:
            borrow[row, j] = q.borrowing_limit


def _collect_quotas(resource_groups) -> Dict[FlavorResource, ResourceQuota]:
    out: Dict[FlavorResource, ResourceQuota] = {}
    for rg in resource_groups:
        for fq in rg.flavors:
            for rname, q in fq.resources.items():
                out[FlavorResource(fq.name, rname)] = q
    return out


def take_snapshot(cache: Cache) -> Snapshot:
    """Flatten the cache into a Snapshot (pkg/cache/snapshot.go:104-158).

    Inactive ClusterQueues (stopped, missing flavors/checks/topologies,
    cyclic cohorts) are excluded and reported, mirroring
    InactiveClusterQueueSets.
    """
    active_names: List[str] = []
    inactive: List[str] = []
    for name in sorted(cache.cluster_queues):
        if cache.cluster_queue_status(name).active:
            active_names.append(name)
        else:
            inactive.append(name)

    flat = cache.forest.flatten(active_names)
    inactive.extend(flat.inactive_cqs)

    # FR universe: every (flavor, resource) cell defined by any active CQ
    # or cohort resource group.
    frs: Set[FlavorResource] = set()
    for name in flat.cq_names:
        frs |= set(_collect_quotas(cache.cluster_queues[name].model.resource_groups))
    for cname in flat.cohort_names:
        cohort = cache.cohorts.get(cname)
        if cohort is not None:
            frs |= set(_collect_quotas(cohort.resource_groups))
    fr_list = tuple(sorted(frs))
    fr_index = {fr: j for j, fr in enumerate(fr_list)}
    resource_names = tuple(sorted({fr.resource for fr in fr_list}))
    rname_index = {r: i for i, r in enumerate(resource_names)}
    resource_index = np.array(
        [rname_index[fr.resource] for fr in fr_list], dtype=np.int32
    )

    n = flat.n_nodes
    nominal = np.zeros((n, len(fr_list)), dtype=np.int64)
    lend = np.full((n, len(fr_list)), NO_LIMIT, dtype=np.int64)
    borrow = np.full((n, len(fr_list)), NO_LIMIT, dtype=np.int64)
    weight = np.full(n, 1000, dtype=np.int64)

    cq_models: Dict[str, ClusterQueue] = {}
    for name in flat.cq_names:
        model = cache.cluster_queues[name].model
        cq_models[name] = model
        row = flat.index[name]
        _quota_cells(_collect_quotas(model.resource_groups), fr_index, nominal, lend, borrow, row)
        weight[row] = model.fair_sharing.weight_milli
    for cname in flat.cohort_names:
        cohort = cache.cohorts.get(cname)
        if cohort is not None:
            row = flat.index[cname]
            _quota_cells(_collect_quotas(cohort.resource_groups), fr_index, nominal, lend, borrow, row)
            weight[row] = cohort.fair_sharing.weight_milli

    level_mask = flat.level_masks()
    subtree, guaranteed = subtree_quota_np(flat.parent, level_mask, nominal, lend)

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
        local_usage=np.zeros((n, len(fr_list)), dtype=np.int64),
        weight_milli=weight,
        cq_models=cq_models,
        inactive_cqs=tuple(inactive),
        generations={
            name: cache.cluster_queues[name].allocatable_generation
            for name in flat.cq_names
        },
        priority_classes=dict(cache.priority_classes),
    )

    from kueue_tpu_torch.models.constants import WorkloadConditionType
    from kueue_tpu_torch.utils.priority import priority_of

    for name in flat.cq_names:
        cached = cache.cluster_queues[name]
        for wl in cached.workloads.values():
            usage = admission_usage(wl)
            qr = wl.conditions.get(WorkloadConditionType.QUOTA_RESERVED)
            snap.add_workload(
                WorkloadSnapshot(
                    workload=wl,
                    cq_name=name,
                    cq_row=flat.index[name],
                    usage_vec=snap.vector_of(usage),
                    priority=priority_of(wl, cache.priority_classes),
                    quota_reserved_time=qr.last_transition_time if qr else wl.creation_time,
                )
            )
    return snap
