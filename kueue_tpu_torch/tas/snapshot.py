"""TASFlavorSnapshot — hierarchical topology-domain placement.

Reference: pkg/cache/tas_flavor_snapshot.go:91-697. The domain forest
(e.g. block -> rack -> hostname) is flattened into dense leaf arrays:

  free_capacity[L, R]  node allocatable minus non-TAS usage
  tas_usage[L, R]      usage from admitted TAS workloads
  seg_ids[d][L]        leaf -> domain index at level d

Phase 1 (fillInCounts, :647-690) — how many pods fit in each domain —
is one vectorized min-reduce over resources followed by per-level
segment sums. Below ``DEVICE_LEAF_THRESHOLD`` leaves the host numpy
reduction computes the per-leaf counts; at or above it kernel B12
(ops/tas_kernel.leaf_counts, csrc/tas_leaf_counts.cu) does, on the
snapshot's ``device`` (the card unless the caller names the CPU, where
the kernel's plain torch version runs). Phase 2 (:394-444,513-621) — level search and
minimize-domain selection — is the reference's greedy over the per-level
count vectors, which are tiny after phase 1.

Placement profiles follow useBestFitAlgorithm/useLeastFreeCapacity
gates (:551-568): BestFit by default; TASProfile{MostFreeCapacity,
LeastFreeCapacity,Mixed} feature gates switch the ordering.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kueue_tpu_torch import features
from kueue_tpu_torch.models.constants import (
    TOPOLOGY_MODE_PREFERRED,
    TOPOLOGY_MODE_REQUIRED,
    TOPOLOGY_MODE_UNCONSTRAINED,
)
from kueue_tpu_torch.models.resource_flavor import Toleration, taints_tolerated
from kueue_tpu_torch.models.workload import (
    PodSetTopologyRequest,
    TopologyAssignment,
    TopologyDomainAssignment,
)
from kueue_tpu_torch.resources import PODS

HOSTNAME_LABEL = "kubernetes.io/hostname"

MAX_COUNT = (1 << 31) - 1  # int32 max, CountIn semantics


def domain_id(values: Sequence[str]) -> str:
    return ",".join(values)


@dataclass
class TASPodSetRequest:
    """TASPodSetRequests (tas_flavor_snapshot.go:340-360)."""

    podset_name: str
    count: int
    single_pod_requests: Dict[str, int]
    topology_request: Optional[PodSetTopologyRequest]
    tolerations: Tuple[Toleration, ...] = ()
    implied: bool = False  # TAS-only CQ, no explicit request
    flavor: str = ""

    def total_requests(self) -> Dict[str, int]:
        out = {r: v * self.count for r, v in self.single_pod_requests.items()}
        out[PODS] = out.get(PODS, 0) + self.count
        return out


@dataclass
class TASAssignmentResult:
    """Per-podset outcome; failure_reason == '' means success."""

    assignments: Dict[str, Optional[TopologyAssignment]] = field(default_factory=dict)
    failure_reason: str = ""
    failed_podset: str = ""


class _Domain:
    """One node of the domain forest (tas_flavor_snapshot.go:40-70).

    ``state`` carries phase-1 fit counts, then phase-2 assigned counts.
    """

    __slots__ = ("id", "level_values", "parent", "children", "state", "leaf_idx")

    def __init__(self, id_: str, level_values: Tuple[str, ...]):
        self.id = id_
        self.level_values = level_values
        self.parent: Optional["_Domain"] = None
        self.children: List["_Domain"] = []
        self.state: int = 0
        self.leaf_idx: int = -1  # >= 0 only for leaves


class TASFlavorSnapshot:
    def __init__(
        self,
        topology_name: str,
        level_keys: Sequence[str],
        tolerations: Tuple[Toleration, ...] = (),
        device=None,
    ):
        self.topology_name = topology_name
        # where the leaf counts run at fleet size (None: the card)
        self.device = device
        self.level_keys: Tuple[str, ...] = tuple(level_keys)
        self.tolerations = tuple(tolerations)
        self.leaves: Dict[str, _Domain] = {}
        self.domains: Dict[str, _Domain] = {}
        self.roots: Dict[str, _Domain] = {}
        self.domains_per_level: List[Dict[str, _Domain]] = [
            {} for _ in self.level_keys
        ]
        # Dense leaf arrays, built by freeze()
        self._frozen = False
        self._leaf_order: List[_Domain] = []
        self._resources: List[str] = []
        self._free: Optional[np.ndarray] = None  # [L, R]
        self._tas_usage: Optional[np.ndarray] = None  # [L, R]
        self._leaf_taints: List[Tuple] = []
        # sparse accumulation pre-freeze
        self._free_map: Dict[str, Dict[str, int]] = {}
        self._tas_usage_map: Dict[str, Dict[str, int]] = {}
        self._taints_map: Dict[str, Tuple] = {}
        # (device, dense device view), built lazily on first device-path use
        self._topo_dev = None

    # ---- node ingest (tas_flavor_snapshot.go:138-220) ----
    def is_lowest_level_hostname(self) -> bool:
        return self.level_keys[-1] == HOSTNAME_LABEL

    def lowest_level(self) -> str:
        return self.level_keys[-1]

    def add_node(
        self,
        labels: Dict[str, str],
        allocatable: Dict[str, int],
        taints: Tuple = (),
    ) -> str:
        """Ingest one node; returns its leaf domain id."""
        level_values = tuple(labels.get(k, "") for k in self.level_keys)
        did = domain_id(level_values)
        if self.is_lowest_level_hostname():
            did = domain_id(level_values[-1:])
        if did not in self.leaves:
            leaf = _Domain(did, level_values)
            self.leaves[did] = leaf
            self._free_map[did] = {}
            self._tas_usage_map[did] = {}
            if self.is_lowest_level_hostname():
                self._taints_map[did] = tuple(taints)
        acc = self._free_map[did]
        for r, v in allocatable.items():
            acc[r] = acc.get(r, 0) + int(v)
        self._frozen = False
        return did

    def add_non_tas_usage(self, did: str, usage: Dict[str, int]) -> None:
        """Subtract static/non-TAS pod usage + 1 pod slot (:216-220)."""
        acc = self._free_map[did]
        for r, v in usage.items():
            acc[r] = acc.get(r, 0) - int(v)
        acc[PODS] = acc.get(PODS, 0) - 1

    def add_tas_usage(self, did: str, usage: Dict[str, int], count: int) -> None:
        if did not in self._tas_usage_map:
            # Usage may refer to domains whose nodes are gone; track so
            # re-added nodes see it (tas_flavor.go addUsage tolerance).
            if did not in self.leaves:
                return
            self._tas_usage_map[did] = {}
        acc = self._tas_usage_map[did]
        for r, v in usage.items():
            acc[r] = acc.get(r, 0) + int(v)
        acc[PODS] = acc.get(PODS, 0) + int(count)
        self._frozen = False

    def remove_tas_usage(self, did: str, usage: Dict[str, int], count: int) -> None:
        if did not in self._tas_usage_map:
            return
        acc = self._tas_usage_map[did]
        for r, v in usage.items():
            acc[r] = acc.get(r, 0) - int(v)
        acc[PODS] = acc.get(PODS, 0) - int(count)
        self._frozen = False

    # ---- tree + dense arrays (initialize, :174-205) ----
    def freeze(self) -> None:
        if self._frozen:
            return
        self._topo_dev = None  # device view rebuilt with the host arrays
        self.domains = {}
        self.roots = {}
        self.domains_per_level = [{} for _ in self.level_keys]
        for leaf in self.leaves.values():
            leaf.children = []
        for leaf in self.leaves.values():
            self.domains[leaf.id] = leaf
            self.domains_per_level[len(leaf.level_values) - 1][leaf.id] = leaf
            self._initialize_helper(leaf)

        self._leaf_order = sorted(self.leaves.values(), key=lambda d: d.level_values)
        for i, leaf in enumerate(self._leaf_order):
            leaf.leaf_idx = i
        res = set()
        for acc in self._free_map.values():
            res.update(acc)
        for acc in self._tas_usage_map.values():
            res.update(acc)
        res.add(PODS)
        self._resources = sorted(res)
        r_index = {r: j for j, r in enumerate(self._resources)}
        n_l, n_r = len(self._leaf_order), len(self._resources)
        self._free = np.zeros((n_l, n_r), dtype=np.int64)
        self._tas_usage = np.zeros((n_l, n_r), dtype=np.int64)
        self._leaf_taints = []
        for i, leaf in enumerate(self._leaf_order):
            for r, v in self._free_map.get(leaf.id, {}).items():
                self._free[i, r_index[r]] = v
            for r, v in self._tas_usage_map.get(leaf.id, {}).items():
                self._tas_usage[i, r_index[r]] = v
            self._leaf_taints.append(self._taints_map.get(leaf.id, ()))
        self._frozen = True

    def _initialize_helper(self, dom: _Domain) -> None:
        if len(dom.level_values) == 1:
            self.roots[dom.id] = dom
            return
        parent_values = dom.level_values[:-1]
        pid = domain_id(parent_values)
        parent = self.domains.get(pid)
        if parent is None:
            parent = _Domain(pid, parent_values)
            self.domains_per_level[len(parent_values) - 1][pid] = parent
            self.domains[pid] = parent
            self._initialize_helper(parent)
        dom.parent = parent
        parent.children.append(dom)

    # ---- phase 1: fillInCounts (:647-690) ----
    # Leaf count at which phase-1 CountIn runs on the device (kernel
    # B12, ops/tas_kernel.leaf_counts) instead of host numpy: the
    # reference's value, kept so that the two packages dispatch alike
    # (their decisions do not depend on it). Where it would sit on the
    # card is measured by chip_smoke.py (PERF.md, open questions).
    # Tests drop it to exercise device/host parity.
    DEVICE_LEAF_THRESHOLD = 100_000

    def _leaf_counts_device(
        self,
        requests: Dict[str, int],
        assumed_usage: Dict[str, Dict[str, int]],
        simulate_empty: bool,
        tolerations: Tuple[Toleration, ...],
    ) -> np.ndarray:
        """Kernel B12's CountIn on ``self.device`` (decision-identical
        to the host path; parity in tests/test_torch_tas.py). Requests
        naming a resource no node carries short-circuit to zeros (host
        semantics)."""
        from kueue_tpu_torch._torch import resolve_device, to_device
        from kueue_tpu_torch.ops import tas_kernel

        dev = resolve_device(self.device)
        if self._topo_dev is None or self._topo_dev[0] != dev:
            self._topo_dev = (dev, tas_kernel.topology_from_snapshot(self, dev))
        topo = self._topo_dev[1]
        n_l = len(self._leaf_order)
        r_index = {r: j for j, r in enumerate(self._resources)}

        req = np.zeros(len(self._resources), dtype=np.int64)
        for r, v in requests.items():
            if v == 0:
                continue
            j = r_index.get(r)
            if j is None:
                return np.zeros(n_l, dtype=np.int64)
            req[j] = v

        assumed = np.zeros((n_l, len(self._resources)), dtype=np.int64)
        for did, usage in assumed_usage.items():
            leaf = self.leaves.get(did)
            if leaf is None:
                continue
            for r, v in usage.items():
                j = r_index.get(r)
                if j is not None:
                    assumed[leaf.leaf_idx, j] += v

        taint_ok = np.ones(n_l, dtype=bool)
        if self.is_lowest_level_hostname():
            for i, taints in enumerate(self._leaf_taints):
                if taints and not taints_tolerated(taints, tolerations):
                    taint_ok[i] = False

        counts = tas_kernel.leaf_counts(
            topo,
            to_device(req[None, :], dev, np.int64),
            to_device(assumed[None, :, :], dev, np.int64),
            to_device(taint_ok[None, :], dev, np.bool_),
            to_device(np.array([simulate_empty]), dev, np.bool_),
        )
        return counts[0].cpu().numpy()

    def _leaf_counts(
        self,
        requests: Dict[str, int],
        assumed_usage: Dict[str, Dict[str, int]],
        simulate_empty: bool,
        tolerations: Tuple[Toleration, ...],
    ) -> np.ndarray:
        """Vectorized CountIn over all leaves. Returns int64[L]."""
        self.freeze()
        n_l = len(self._leaf_order)
        if n_l >= self.DEVICE_LEAF_THRESHOLD:
            return self._leaf_counts_device(
                requests, assumed_usage, simulate_empty, tolerations
            )
        remaining = self._free.copy()
        if not simulate_empty:
            remaining -= self._tas_usage
        if assumed_usage:
            r_index = {r: j for j, r in enumerate(self._resources)}
            for did, usage in assumed_usage.items():
                leaf = self.leaves.get(did)
                if leaf is None:
                    continue
                for r, v in usage.items():
                    j = r_index.get(r)
                    if j is not None:
                        remaining[leaf.leaf_idx, j] -= v

        # req vector over the dense resource axis; resources requested
        # but unknown to every node force count 0 (CountIn :123-124)
        req = np.zeros(len(self._resources), dtype=np.int64)
        unknown = False
        for r, v in requests.items():
            if v == 0:
                continue
            if r in self._resources:
                req[self._resources.index(r)] = v
            else:
                unknown = True
        if unknown:
            return np.zeros(n_l, dtype=np.int64)

        mask = req > 0
        if not mask.any():
            counts = np.full(n_l, MAX_COUNT, dtype=np.int64)
        else:
            # Go int32(capacity/value) truncates toward zero
            quot = remaining[:, mask] // req[mask]
            neg = remaining[:, mask] < 0
            quot = np.where(neg, -((-remaining[:, mask]) // req[mask]), quot)
            counts = quot.min(axis=1)
        counts = np.minimum(counts, MAX_COUNT)

        # taint filtering (:656-663): untolerated leaves excluded (0)
        if self.is_lowest_level_hostname():
            for i, taints in enumerate(self._leaf_taints):
                if taints and not taints_tolerated(taints, tolerations):
                    counts[i] = 0
        return counts

    def fill_in_counts(
        self,
        requests: Dict[str, int],
        assumed_usage: Dict[str, Dict[str, int]],
        simulate_empty: bool,
        tolerations: Tuple[Toleration, ...],
    ) -> None:
        counts = self._leaf_counts(requests, assumed_usage, simulate_empty, tolerations)
        for dom in self.domains.values():
            dom.state = 0
        for i, leaf in enumerate(self._leaf_order):
            leaf.state = int(counts[i])
        # bubble raw sums up, deepest level first (fillInCountsHelper
        # :678-690 — per-level segment sums in the dense formulation)
        for d in range(len(self.level_keys) - 1, 0, -1):
            for dom in self.domains_per_level[d].values():
                if dom.parent is not None:
                    dom.parent.state += dom.state

    # ---- profiles (:551-568) ----
    @staticmethod
    def _use_best_fit(unconstrained: bool) -> bool:
        if (
            features.enabled("TASProfileMostFreeCapacity")
            or features.enabled("TASProfileLeastFreeCapacity")
            or (unconstrained and features.enabled("TASProfileMixed"))
        ):
            return False
        return True

    @staticmethod
    def _use_least_free(unconstrained: bool) -> bool:
        if features.enabled("TASProfileLeastFreeCapacity") or (
            unconstrained and features.enabled("TASProfileMixed")
        ):
            return True
        return False

    # ---- phase 2 (:494-621) ----
    def _sorted_domains(
        self, domains: List[_Domain], unconstrained: bool
    ) -> List[_Domain]:
        result = sorted(
            domains, key=lambda d: (-d.state, d.level_values)
        )
        if self._use_least_free(unconstrained):
            result.reverse()
        return result

    @staticmethod
    def _best_fit_idx(domains: List[_Domain], count: int) -> int:
        """First domain with the lowest state still >= count (:500-511)."""
        best = 0
        for i, dom in enumerate(domains):
            if dom.state >= count and dom.state != domains[best].state:
                best = i
        return best

    def _not_fit_message(self, fit_count: int, total: int) -> str:
        if fit_count == 0:
            return (
                f'topology "{self.topology_name}" doesn\'t allow to fit any '
                f"of {total} pod(s)"
            )
        return (
            f'topology "{self.topology_name}" allows to fit only '
            f"{fit_count} out of {total} pod(s)"
        )

    def _find_level_with_fit_domains(
        self, level_idx: int, required: bool, count: int, unconstrained: bool
    ) -> Tuple[int, List[_Domain], str]:
        domains = list(self.domains_per_level[level_idx].values())
        if not domains:
            return 0, [], f"no topology domains at level: {self.level_keys[level_idx]}"
        sorted_domains = self._sorted_domains(domains, unconstrained)
        top = sorted_domains[0]
        if self._use_best_fit(unconstrained) and top.state >= count:
            top = sorted_domains[self._best_fit_idx(sorted_domains, count)]
        if top.state < count:
            if required:
                return 0, [], self._not_fit_message(top.state, count)
            if level_idx > 0 and not unconstrained:
                return self._find_level_with_fit_domains(
                    level_idx - 1, required, count, unconstrained
                )
            results: List[_Domain] = []
            remaining = count
            idx = 0
            while remaining > 0 and idx < len(sorted_domains) and sorted_domains[idx].state > 0:
                offset = 0
                if (
                    self._use_best_fit(unconstrained)
                    and sorted_domains[idx].state >= remaining
                ):
                    offset = self._best_fit_idx(sorted_domains[idx:], remaining)
                results.append(sorted_domains[idx + offset])
                remaining -= sorted_domains[idx].state
                idx += 1
            if remaining > 0:
                return 0, [], self._not_fit_message(count - remaining, count)
            return level_idx, results, ""
        return level_idx, [top], ""

    def _update_counts_to_minimum(
        self, domains: List[_Domain], count: int, unconstrained: bool
    ) -> List[_Domain]:
        result: List[_Domain] = []
        remaining = count
        for i, dom in enumerate(domains):
            if self._use_best_fit(unconstrained) and dom.state >= remaining:
                dom = domains[i + self._best_fit_idx(domains[i:], remaining)]
            if dom.state >= remaining:
                dom.state = remaining
                result.append(dom)
                return result
            remaining -= dom.state
            result.append(dom)
        raise AssertionError(
            f"unexpected remainingCount {remaining} of {count}"
        )

    @staticmethod
    def _lower_level_domains(domains: List[_Domain]) -> List[_Domain]:
        out: List[_Domain] = []
        for dom in domains:
            out.extend(dom.children)
        return out

    def _build_assignment(self, domains: List[_Domain]) -> TopologyAssignment:
        domains = sorted(domains, key=lambda d: d.level_values)
        level_idx = 0
        if self.is_lowest_level_hostname():
            level_idx = len(self.level_keys) - 1
        return TopologyAssignment(
            levels=self.level_keys[level_idx:],
            domains=tuple(
                TopologyDomainAssignment(
                    values=d.level_values[level_idx:], count=d.state
                )
                for d in domains
            ),
        )

    # ---- request resolution (:445-495) ----
    def has_level(self, tr: Optional[PodSetTopologyRequest]) -> bool:
        key = self._level_key(tr)
        return key is not None and key in self.level_keys

    def _level_key(self, tr: Optional[PodSetTopologyRequest]) -> Optional[str]:
        if tr is None:
            return None
        if tr.mode == TOPOLOGY_MODE_REQUIRED or tr.mode == TOPOLOGY_MODE_PREFERRED:
            return tr.level
        if tr.mode == TOPOLOGY_MODE_UNCONSTRAINED:
            return self.lowest_level()
        return None

    # ---- the per-podset search (findTopologyAssignment :406-444) ----
    def find_topology_assignment(
        self,
        req: TASPodSetRequest,
        assumed_usage: Dict[str, Dict[str, int]],
        simulate_empty: bool = False,
    ) -> Tuple[Optional[TopologyAssignment], str]:
        requests = dict(req.single_pod_requests)
        requests[PODS] = requests.get(PODS, 0) + 1
        required = (
            req.topology_request is not None
            and req.topology_request.mode == TOPOLOGY_MODE_REQUIRED
        )
        key = self._level_key(req.topology_request)
        if key is None and req.implied:
            key = self.lowest_level()
        unconstrained = (
            req.topology_request is not None
            and req.topology_request.mode == TOPOLOGY_MODE_UNCONSTRAINED
        ) or req.implied
        if key is None:
            return None, "topology level not specified"
        if key not in self.level_keys:
            return None, f"no requested topology level: {key}"
        level_idx = self.level_keys.index(key)

        self.fill_in_counts(
            requests,
            assumed_usage,
            simulate_empty,
            tuple(req.tolerations) + self.tolerations,
        )
        fit_level, domains, reason = self._find_level_with_fit_domains(
            level_idx, required, req.count, unconstrained
        )
        if reason:
            return None, reason
        domains = self._update_counts_to_minimum(domains, req.count, unconstrained)
        for li in range(fit_level, len(self.level_keys) - 1):
            lower = self._lower_level_domains(domains)
            lower = self._sorted_domains(lower, unconstrained)
            domains = self._update_counts_to_minimum(lower, req.count, unconstrained)
        return self._build_assignment(domains), ""

    def podset_fit_counts(
        self,
        req: TASPodSetRequest,
        assumed_usage: Dict[str, Dict[str, int]],
        simulate_empty: bool = False,
    ) -> np.ndarray:
        """Phase-1 per-leaf pod-fit counts for one podset request —
        the same counts find_topology_assignment places against, exposed
        for admit-time re-validation (ClusterQueueSnapshot.Fits' TAS
        branch). int64[L], indexed by ``leaves[did].leaf_idx``."""
        requests = dict(req.single_pod_requests)
        requests[PODS] = requests.get(PODS, 0) + 1
        return self._leaf_counts(
            requests,
            assumed_usage,
            simulate_empty,
            tuple(req.tolerations) + self.tolerations,
        )

    @staticmethod
    def charge_assumed(
        assumed: Dict[str, Dict[str, int]],
        req: TASPodSetRequest,
        assignment: TopologyAssignment,
    ) -> None:
        """Accumulate one podset's assumed usage the way
        find_topology_assignments does: the FULL TotalRequests() charged
        to EVERY assigned domain (parity quirk, :383-390)."""
        total = req.total_requests()
        for dom in assignment.domains:
            acc = assumed.setdefault(domain_id(dom.values), {})
            for r, v in total.items():
                acc[r] = acc.get(r, 0) + v

    # ---- multi-podset entry (FindTopologyAssignmentsForFlavor :374-392) ----
    def find_topology_assignments(
        self,
        reqs: Sequence[TASPodSetRequest],
        simulate_empty: bool = False,
    ) -> TASAssignmentResult:
        result = TASAssignmentResult()
        assumed: Dict[str, Dict[str, int]] = {}
        for req in reqs:
            assignment, reason = self.find_topology_assignment(
                req, assumed, simulate_empty
            )
            result.assignments[req.podset_name] = assignment
            if reason:
                result.failure_reason = reason
                result.failed_podset = req.podset_name
                return result
            self.charge_assumed(assumed, req, assignment)
        return result
