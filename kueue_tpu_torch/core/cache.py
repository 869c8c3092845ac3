"""Authoritative admitted-usage cache.

Behavioral equivalent of the reference's ``pkg/cache`` Cache: the
in-memory source of truth for admitted workloads and their quota usage,
optimistic ("assumed") admissions awaiting durable acknowledgement,
ClusterQueue active-status reasons, and the inputs the per-cycle
Snapshot flattens into tensors (pkg/cache/cache.go:102-137, 603-660;
clusterqueue.go active-status reasons).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from kueue_tpu_torch.models import (
    AdmissionCheck,
    ClusterQueue,
    Cohort,
    LocalQueue,
    ResourceFlavor,
    Topology,
    Workload,
)
from kueue_tpu_torch.models.priority_class import WorkloadPriorityClass
from kueue_tpu_torch.models.constants import StopPolicy
from kueue_tpu_torch.core.hierarchy import CohortForest
from kueue_tpu_torch.core.workload_info import admission_usage
from kueue_tpu_torch.resources import FlavorResource, FlavorResourceQuantities


@dataclass
class CQStatus:
    active: bool
    reasons: Tuple[str, ...] = ()
    message: str = ""


@dataclass
class CachedClusterQueue:
    model: ClusterQueue
    workloads: Dict[str, Workload] = field(default_factory=dict)
    usage: FlavorResourceQuantities = field(default_factory=dict)
    # Generation bumped whenever allocatable resources change; invalidates
    # workloads' remembered flavor-assignment cursors (LastAssignment).
    allocatable_generation: int = 0


class Cache:
    """Tracks every admitted workload's usage per ClusterQueue."""

    def __init__(
        self,
        priority_classes: Optional[Dict[str, WorkloadPriorityClass]] = None,
    ) -> None:
        self.cluster_queues: Dict[str, CachedClusterQueue] = {}
        self.cohorts: Dict[str, Cohort] = {}
        self.flavors: Dict[str, ResourceFlavor] = {}
        self.admission_checks: Dict[str, AdmissionCheck] = {}
        self.topologies: Dict[str, Topology] = {}
        self.local_queues: Dict[str, LocalQueue] = {}
        # WorkloadPriorityClass registry. Pass the same dict to the
        # QueueManager so heap ordering, entry sorting and preemption
        # all resolve one consistent priority per workload (the
        # reference reads one informer cache for the same reason).
        self.priority_classes = priority_classes if priority_classes is not None else {}
        self.forest = CohortForest()
        self.assumed_workloads: Dict[str, str] = {}  # wl key -> cq name
        # reverse index: which CQ currently tracks each workload
        self._wl_cq: Dict[str, str] = {}
        # workloads admitted but whose pods aren't ready yet
        # (WaitForPodsReady blockAdmission support, cache.go:160-205)
        self.workloads_not_ready: Set[str] = set()
        # Optional TAS cache: charged/released alongside quota usage so
        # later entries in a cycle see earlier TAS admissions (the
        # reference's snapshot.AddWorkload updates TAS usage in place).
        self.tas_cache = None  # kueue_tpu_torch.tas.TASCache

    # ---- object lifecycle ----
    def add_or_update_cluster_queue(self, cq: ClusterQueue) -> None:
        cached = self.cluster_queues.get(cq.name)
        if cached is None:
            self.cluster_queues[cq.name] = CachedClusterQueue(model=cq)
            self.forest.add_cluster_queue(cq.name, cq.cohort)
        else:
            cached.model = cq
            cached.allocatable_generation += 1
            self.forest.update_cluster_queue(cq.name, cq.cohort)

    def delete_cluster_queue(self, name: str) -> None:
        self.cluster_queues.pop(name, None)
        self.forest.delete_cluster_queue(name)

    def add_or_update_cohort(self, cohort: Cohort) -> None:
        self.cohorts[cohort.name] = cohort
        self.forest.add_cohort(cohort.name, cohort.parent)
        self._bump_generations()

    def delete_cohort(self, name: str) -> None:
        self.cohorts.pop(name, None)
        self.forest.delete_cohort(name)
        self._bump_generations()

    def add_or_update_flavor(self, flavor: ResourceFlavor) -> None:
        self.flavors[flavor.name] = flavor
        self._bump_generations()

    def delete_flavor(self, name: str) -> None:
        self.flavors.pop(name, None)
        self._bump_generations()

    def add_or_update_admission_check(self, ac: AdmissionCheck) -> None:
        self.admission_checks[ac.name] = ac

    def delete_admission_check(self, name: str) -> None:
        self.admission_checks.pop(name, None)

    def add_or_update_topology(self, topo: Topology) -> None:
        self.topologies[topo.name] = topo
        self._bump_generations()

    def delete_topology(self, name: str) -> None:
        self.topologies.pop(name, None)
        self._bump_generations()

    def add_or_update_priority_class(self, pc: WorkloadPriorityClass) -> None:
        self.priority_classes[pc.name] = pc

    def delete_priority_class(self, name: str) -> None:
        self.priority_classes.pop(name, None)

    def add_or_update_local_queue(self, lq: LocalQueue) -> None:
        self.local_queues[lq.key] = lq

    def delete_local_queue(self, key: str) -> None:
        self.local_queues.pop(key, None)

    def _bump_generations(self) -> None:
        for cached in self.cluster_queues.values():
            cached.allocatable_generation += 1

    # ---- CQ active status (cache/clusterqueue.go reasons) ----
    def cluster_queue_status(self, name: str) -> CQStatus:
        cached = self.cluster_queues.get(name)
        if cached is None:
            return CQStatus(active=False, reasons=("Unknown",))
        reasons: List[str] = []
        cq = cached.model
        if cq.stop_policy != StopPolicy.NONE:
            reasons.append("Stopped")
        missing_flavors = [f for f in cq.flavor_names() if f not in self.flavors]
        if missing_flavors:
            reasons.append("FlavorNotFound")
        for ac_name in self._all_check_names(cq):
            ac = self.admission_checks.get(ac_name)
            if ac is None:
                reasons.append("AdmissionCheckNotFound")
                break
            if ac.active is False:  # None = condition unset = active
                # clusterqueue_controller.go: CheckNotFoundOrInactive
                reasons.append("AdmissionCheckInactive")
                break
        for fname in cq.flavor_names():
            flavor = self.flavors.get(fname)
            if flavor and flavor.topology_name and flavor.topology_name not in self.topologies:
                reasons.append("TopologyNotFound")
                break
        if self.forest.cq_in_cycle(name):
            reasons.append("CohortCycle")
        return CQStatus(active=not reasons, reasons=tuple(reasons))

    def _all_check_names(self, cq: ClusterQueue) -> Tuple[str, ...]:
        names = set(cq.admission_checks) | set(cq.admission_checks_strategy)
        return tuple(sorted(names))

    def admission_checks_for_workload(
        self, cq: ClusterQueue, flavors_used: Set[str]
    ) -> Tuple[str, ...]:
        """Checks applying to a workload given its assigned flavors
        (admissionChecksStrategy scoping)."""
        out = set(cq.admission_checks)
        for name, only_flavors in cq.admission_checks_strategy.items():
            if not only_flavors or set(only_flavors) & flavors_used:
                out.add(name)
        return tuple(sorted(out))

    # ---- workload usage accounting ----
    def _apply_usage(self, cq: CachedClusterQueue, usage: FlavorResourceQuantities, sign: int) -> None:
        for fr, qty in usage.items():
            cq.usage[fr] = cq.usage.get(fr, 0) + sign * qty

    def add_or_update_workload(self, wl: Workload) -> bool:
        """Track an admitted workload (event path, cache.go AddOrUpdateWorkload)."""
        if wl.admission is None:
            return False
        cached = self.cluster_queues.get(wl.admission.cluster_queue)
        if cached is None:
            return False
        self._forget_if_assumed(wl.key)
        # If the workload was tracked under a different CQ (admission
        # moved, coalesced events), release the old tracking first so
        # its usage doesn't leak (reference UpdateWorkload(old, new)).
        prev_cq = self._wl_cq.get(wl.key)
        if prev_cq is not None and prev_cq != wl.admission.cluster_queue:
            prev = self.cluster_queues.get(prev_cq)
            if prev is not None:
                old = prev.workloads.pop(wl.key, None)
                if old is not None:
                    self._apply_usage(prev, admission_usage(old), -1)
                    if self.tas_cache is not None:
                        self.tas_cache.remove_usage(old)
        old = cached.workloads.get(wl.key)
        if old is not None:
            self._apply_usage(cached, admission_usage(old), -1)
            if self.tas_cache is not None:
                self.tas_cache.remove_usage(old)
        cached.workloads[wl.key] = wl
        self._apply_usage(cached, admission_usage(wl), +1)
        if self.tas_cache is not None:
            self.tas_cache.add_usage(wl)
        self._wl_cq[wl.key] = wl.admission.cluster_queue
        return True

    def delete_workload(self, wl: Workload) -> bool:
        cq_name = (
            self._wl_cq.get(wl.key)
            or self.assumed_workloads.get(wl.key)
            or (wl.admission.cluster_queue if wl.admission else None)
        )
        self.assumed_workloads.pop(wl.key, None)
        self._wl_cq.pop(wl.key, None)
        self.workloads_not_ready.discard(wl.key)
        if cq_name is None:
            return False
        cached = self.cluster_queues.get(cq_name)
        if cached is None:
            # The CQ is gone but TAS usage is keyed per flavor, not per
            # CQ — release it from the passed workload (idempotent in
            # the TAS cache) so domains don't stay charged forever.
            if self.tas_cache is not None:
                self.tas_cache.remove_usage(wl)
            return False
        tracked = cached.workloads.pop(wl.key, None)
        if tracked is not None:
            self._apply_usage(cached, admission_usage(tracked), -1)
            if self.tas_cache is not None:
                self.tas_cache.remove_usage(tracked)
        return tracked is not None

    def assume_workload(self, wl: Workload) -> bool:
        """Optimistically admit before the durable status write lands
        (cache.go:603-630). Usage counts immediately so the next cycle
        can't double-book the quota."""
        if wl.admission is None or wl.key in self.assumed_workloads:
            return False
        cached = self.cluster_queues.get(wl.admission.cluster_queue)
        if cached is None:
            return False
        cached.workloads[wl.key] = wl
        self._apply_usage(cached, admission_usage(wl), +1)
        if self.tas_cache is not None:
            self.tas_cache.add_usage(wl)
        self.assumed_workloads[wl.key] = wl.admission.cluster_queue
        self._wl_cq[wl.key] = wl.admission.cluster_queue
        return True

    def forget_workload(self, wl: Workload) -> bool:
        """Undo a failed assumed admission (cache.go:632-660)."""
        if wl.key not in self.assumed_workloads:
            return False
        cq_name = self.assumed_workloads.pop(wl.key)
        cached = self.cluster_queues.get(cq_name)
        if cached is None:
            return False
        tracked = cached.workloads.pop(wl.key, None)
        if tracked is not None:
            self._apply_usage(cached, admission_usage(tracked), -1)
            if self.tas_cache is not None:
                self.tas_cache.remove_usage(tracked)
        self._wl_cq.pop(wl.key, None)
        return True

    def _forget_if_assumed(self, key: str) -> None:
        self.assumed_workloads.pop(key, None)

    # ---- stats for status/metrics ----
    def usage_for(self, cq_name: str) -> FlavorResourceQuantities:
        cached = self.cluster_queues.get(cq_name)
        return dict(cached.usage) if cached else {}

    def admitted_count(self, cq_name: str) -> int:
        cached = self.cluster_queues.get(cq_name)
        return len(cached.workloads) if cached else 0

    def local_queue_usage(self, lq: LocalQueue) -> FlavorResourceQuantities:
        cached = self.cluster_queues.get(lq.cluster_queue)
        if cached is None:
            return {}
        out: FlavorResourceQuantities = {}
        for wl in cached.workloads.values():
            if wl.namespace == lq.namespace and wl.queue_name == lq.name:
                for fr, qty in admission_usage(wl).items():
                    out[fr] = out.get(fr, 0) + qty
        return out
