"""Cohort forest — host-side structure manager.

Behavioral equivalent of the reference's ``pkg/hierarchy`` (generic
(ClusterQueue, Cohort) forest with implicit-cohort creation, edge
updates and cycle detection) plus the array flattening the quota
recurrences consume: nodes are assigned dense indices (ClusterQueues
first, then cohorts), parents become an int32 index array, and depths
become per-level masks so bottom-up/top-down accumulation runs one tree
level at a time (see ops/quota.py and csrc/quota_tree.cu).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

ROOT = -1


@dataclass
class CohortNode:
    name: str
    parent: Optional[str] = None  # parent cohort name
    explicit: bool = False  # created by a Cohort API object (may carry quota)
    cq_children: Set[str] = field(default_factory=set)
    cohort_children: Set[str] = field(default_factory=set)


class CohortForest:
    """Tracks CQ->cohort membership and cohort->cohort edges.

    Implicit cohorts spring into existence when referenced and vanish
    when no longer referenced (pkg/hierarchy/manager.go semantics).
    Cycles are detected per tree; members of cyclic trees are reported
    so callers can mark them inactive (the reference's
    ErrCohortHasCycle / InactiveClusterQueueSets behavior).
    """

    def __init__(self) -> None:
        self.cohorts: Dict[str, CohortNode] = {}
        self.cq_parent: Dict[str, Optional[str]] = {}

    # ---- ClusterQueue membership ----
    def add_cluster_queue(self, cq: str, cohort: Optional[str]) -> None:
        if cq in self.cq_parent:
            self.update_cluster_queue(cq, cohort)
            return
        self.cq_parent[cq] = cohort
        if cohort:
            self._cohort_node(cohort).cq_children.add(cq)

    def update_cluster_queue(self, cq: str, cohort: Optional[str]) -> None:
        old = self.cq_parent.get(cq)
        if old == cohort:
            return
        if old:
            node = self.cohorts.get(old)
            if node:
                node.cq_children.discard(cq)
                self._gc_cohort(old)
        self.cq_parent[cq] = cohort
        if cohort:
            self._cohort_node(cohort).cq_children.add(cq)

    def delete_cluster_queue(self, cq: str) -> None:
        cohort = self.cq_parent.pop(cq, None)
        if cohort and cohort in self.cohorts:
            self.cohorts[cohort].cq_children.discard(cq)
            self._gc_cohort(cohort)

    # ---- Cohort edges ----
    def add_cohort(self, name: str, parent: Optional[str] = None) -> None:
        node = self._cohort_node(name)
        node.explicit = True
        self._set_cohort_parent(node, parent)

    def update_cohort(self, name: str, parent: Optional[str]) -> None:
        self.add_cohort(name, parent)

    def delete_cohort(self, name: str) -> None:
        node = self.cohorts.get(name)
        if node is None:
            return
        node.explicit = False
        self._set_cohort_parent(node, None)
        self._gc_cohort(name)

    def _set_cohort_parent(self, node: CohortNode, parent: Optional[str]) -> None:
        if node.parent == parent:
            return
        if node.parent and node.parent in self.cohorts:
            self.cohorts[node.parent].cohort_children.discard(node.name)
            self._gc_cohort(node.parent)
        node.parent = parent
        if parent:
            self._cohort_node(parent).cohort_children.add(node.name)

    def _cohort_node(self, name: str) -> CohortNode:
        if name not in self.cohorts:
            self.cohorts[name] = CohortNode(name=name)
        return self.cohorts[name]

    def _gc_cohort(self, name: str) -> None:
        node = self.cohorts.get(name)
        if (
            node is not None
            and not node.explicit
            and not node.cq_children
            and not node.cohort_children
        ):
            if node.parent and node.parent in self.cohorts:
                self.cohorts[node.parent].cohort_children.discard(name)
                parent = node.parent
                del self.cohorts[name]
                self._gc_cohort(parent)
                return
            del self.cohorts[name]

    # ---- cycle detection ----
    def cyclic_cohorts(self) -> Set[str]:
        """Names of cohorts participating in (or below) a parent cycle."""
        state: Dict[str, int] = {}  # 0=visiting, 1=ok, 2=cyclic

        def visit(name: str) -> int:
            st = state.get(name)
            if st is not None:
                return 2 if st == 0 else st
            state[name] = 0
            node = self.cohorts.get(name)
            result = 1
            if node and node.parent:
                if node.parent in self.cohorts:
                    result = visit(node.parent)
                # dangling parent reference => treated as root (implicit
                # cohort exists by construction, so this is defensive)
            state[name] = result
            return result

        return {name for name in self.cohorts if visit(name) == 2}

    def cq_in_cycle(self, cq: str) -> bool:
        parent = self.cq_parent.get(cq)
        return parent is not None and parent in self.cyclic_cohorts()

    def root_of(self, cohort: str) -> str:
        seen = set()
        cur = cohort
        while cur in self.cohorts and self.cohorts[cur].parent and cur not in seen:
            seen.add(cur)
            cur = self.cohorts[cur].parent
        return cur

    # ---- flattening ----
    def flatten(self, cq_names: List[str]) -> "FlatHierarchy":
        """Assign dense indices and build parent/level arrays.

        CQs occupy rows [0, n_cq); cohorts follow in sorted order for
        determinism. Cyclic cohorts (and their CQs) are excluded — the
        caller reports them inactive, mirroring the reference's
        snapshot skipping cyclic CQs.
        """
        cyclic = self.cyclic_cohorts()
        active_cqs = [cq for cq in cq_names if self.cq_parent.get(cq) not in cyclic]
        cohort_names = sorted(name for name in self.cohorts if name not in cyclic)

        index: Dict[str, int] = {}
        for i, cq in enumerate(active_cqs):
            index[cq] = i
        n_cq = len(active_cqs)
        for j, name in enumerate(cohort_names):
            index[name] = n_cq + j
        n = n_cq + len(cohort_names)

        parent = np.full(n, ROOT, dtype=np.int32)
        for cq in active_cqs:
            p = self.cq_parent.get(cq)
            if p is not None and p in index:
                parent[index[cq]] = index[p]
        for name in cohort_names:
            p = self.cohorts[name].parent
            if p is not None and p in index:
                parent[index[name]] = index[p]

        depth = np.zeros(n, dtype=np.int32)
        # parents are cohorts only; compute depth by walking up
        for i in range(n):
            d, cur = 0, parent[i]
            while cur != ROOT:
                d += 1
                cur = parent[cur]
            depth[i] = d
        max_depth = int(depth.max()) if n else 0

        return FlatHierarchy(
            cq_names=tuple(active_cqs),
            cohort_names=tuple(cohort_names),
            index=index,
            parent=parent,
            depth=depth,
            max_depth=max_depth,
            inactive_cqs=tuple(
                cq for cq in cq_names if self.cq_parent.get(cq) in cyclic
            ),
        )


@dataclass(frozen=True)
class FlatHierarchy:
    """Dense index view of the cohort forest for the JAX kernels."""

    cq_names: Tuple[str, ...]
    cohort_names: Tuple[str, ...]
    index: Dict[str, int]
    parent: np.ndarray  # int32[N], ROOT(-1) for roots
    depth: np.ndarray  # int32[N]
    max_depth: int
    inactive_cqs: Tuple[str, ...] = ()

    @property
    def n_cq(self) -> int:
        return len(self.cq_names)

    @property
    def n_nodes(self) -> int:
        return len(self.cq_names) + len(self.cohort_names)

    def level_masks(self) -> np.ndarray:
        """bool[max_depth+1, N]: mask of nodes at each depth.
        Memoized — the hierarchy is frozen, and the scheduler asks for
        these masks thousands of times per cycle."""
        cached = getattr(self, "_lm_cache", None)
        if cached is None:
            cached = np.stack(
                [self.depth == d for d in range(self.max_depth + 1)]
            ) if self.n_nodes else np.zeros((1, 0), dtype=bool)
            object.__setattr__(self, "_lm_cache", cached)
        return cached
