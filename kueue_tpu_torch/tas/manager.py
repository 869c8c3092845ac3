"""TASManager — glue between the scheduler and the TAS cache.

Implements the two hook points Scheduler exposes:

- ``check``  <- checkPodSetAndFlavorMatchForTAS
  (pkg/scheduler/flavorassigner/tas_flavorassigner.go:95-122): flavor /
  podset TAS compatibility during flavor assignment.
- ``assign`` <- Assignment.WorkloadsTopologyRequests (:31-50) +
  ClusterQueueSnapshot.FindTopologyAssignmentsForWorkload
  (pkg/cache/clusterqueue_snapshot.go:206-221): computes topology
  assignments for every TAS podset of a nominated workload and attaches
  them to the AssignmentResult, or degrades the mode to NO_FIT with the
  failure reason.

In-cycle usage visibility: the TASCache is charged on admission via the
core Cache's tas hook (assume/add -> add_usage, delete/forget ->
remove_usage), so later entries in the same cycle see earlier entries'
TAS usage — equivalent to the reference's snapshot.AddWorkload updating
the TAS snapshot in place.
"""

from __future__ import annotations

from typing import Dict, Optional

from kueue_tpu_torch.models import ClusterQueue, ResourceFlavor, Workload
from kueue_tpu_torch.models.workload import PodSet
from kueue_tpu_torch.core.flavor_assigner import AssignmentResult, GranularMode
from kueue_tpu_torch.core.workload_info import quota_per_pod
from kueue_tpu_torch.tas.cache import TASCache
from kueue_tpu_torch.tas.snapshot import TASPodSetRequest


class TASManager:
    def __init__(
        self,
        tas_cache: TASCache,
        flavors: Dict[str, ResourceFlavor],
        transform=None,  # ResourceTransformConfig (quota view)
        device=None,  # where fleet-size leaf counts run (None: the card)
    ):
        self.tas_cache = tas_cache
        self.device = device
        self.flavors = flavors
        self.transform = transform
        # snapshots cached per TASCache generation: one build per state
        # change instead of one per nominated workload
        self._snapshots = {}
        self._snap_gen = -1

    def _snapshot_for(self, flavor_name: str):
        gen = self.tas_cache.generation
        if gen != self._snap_gen:
            self._snapshots = {}
            self._snap_gen = gen
        snap = self._snapshots.get(flavor_name)
        if snap is None:
            snap = self.tas_cache.flavors[flavor_name].snapshot(self.device)
            self._snapshots[flavor_name] = snap
        return snap

    # ---- helpers ----
    def _is_tas_flavor(self, name: str) -> bool:
        return name in self.tas_cache.flavors

    def cq_tas_only(self, cq: ClusterQueue) -> bool:
        """True when every flavor of the CQ is a TAS flavor (cq.tasOnly)."""
        names = [
            fq.name for rg in cq.resource_groups for fq in rg.flavors
        ]
        return bool(names) and all(self._is_tas_flavor(n) for n in names)

    def _is_tas_implied(self, ps: PodSet, cq: ClusterQueue) -> bool:
        return ps.topology_request is None and self.cq_tas_only(cq)

    def _is_tas_requested(self, ps: PodSet, cq: ClusterQueue) -> bool:
        return ps.topology_request is not None or self._is_tas_implied(ps, cq)

    # ---- hook 1: flavor compatibility (tas_flavorassigner.go:95-122) ----
    def check(
        self, cq: ClusterQueue, ps: PodSet, flavor: ResourceFlavor
    ) -> Optional[str]:
        if ps.topology_request is not None:
            if flavor.topology_name is None:
                return (
                    f'Flavor "{flavor.name}" does not support '
                    "TopologyAwareScheduling"
                )
            fc = self.tas_cache.flavors.get(flavor.name)
            if fc is None:
                return f'Flavor "{flavor.name}" information missing in TAS cache'
            # level check reads only the topology's level keys — no
            # snapshot build on the flavor-walk hot path
            tr = ps.topology_request
            level = tr.level if tr.level is not None else fc.level_keys[-1]
            if level not in fc.level_keys:
                return (
                    f'Flavor "{flavor.name}" does not contain the requested level'
                )
        if self._is_tas_implied(ps, cq):
            return None
        if ps.topology_request is None and flavor.topology_name is not None:
            return f'Flavor "{flavor.name}" supports only TopologyAwareScheduling'
        return None

    # ---- hook 2: workload assignment ----
    def assign(
        self,
        wl: Workload,
        cq_name: str,
        assignment: AssignmentResult,
        snapshot,
        cq: Optional[ClusterQueue] = None,
        simulate_empty: bool = False,
    ) -> AssignmentResult:
        cq = cq or snapshot.cq_models.get(cq_name)
        if cq is None:
            return assignment
        podsets = {ps.name: ps for ps in wl.pod_sets}

        # group requests per TAS flavor, reference order
        by_flavor: Dict[str, list] = {}
        for psr in assignment.pod_sets:
            ps = podsets.get(psr.name)
            if ps is None or not self._is_tas_requested(ps, cq):
                continue
            if psr.reasons:  # no quota assignment for the podset
                continue
            flavor_names = {c.name for c in psr.flavors.values()}
            if len(flavor_names) != 1:
                psr.reasons.append(
                    "more than one flavor assigned to a TAS pod set"
                )
                psr.update_mode(GranularMode.NO_FIT)
                continue
            flavor_name = next(iter(flavor_names))
            if not self._is_tas_flavor(flavor_name):
                psr.reasons.append(
                    "workload requires Topology, but there is no TAS cache "
                    "information for the assigned flavor"
                )
                psr.update_mode(GranularMode.NO_FIT)
                continue
            by_flavor.setdefault(flavor_name, []).append(
                TASPodSetRequest(
                    podset_name=psr.name,
                    count=psr.count,
                    # topology capacity must count what pods actually
                    # consume on nodes: requests + RuntimeClass overhead
                    # (+transformations), same as quota accounting
                    single_pod_requests=dict(
                        quota_per_pod(ps, self.transform)
                    ),
                    topology_request=ps.topology_request,
                    tolerations=tuple(ps.tolerations),
                    implied=self._is_tas_implied(ps, cq),
                    flavor=flavor_name,
                )
            )

        if not by_flavor:
            return assignment

        by_name = {psr.name: psr for psr in assignment.pod_sets}
        for flavor_name, reqs in by_flavor.items():
            snap = self._snapshot_for(flavor_name)
            result = snap.find_topology_assignments(reqs, simulate_empty)
            for ps_name, ta in result.assignments.items():
                psr = by_name[ps_name]
                if ta is not None:
                    psr.topology_assignment = ta
            if result.failure_reason:
                psr = by_name[result.failed_podset]
                psr.reasons.append(result.failure_reason)
                psr.update_mode(GranularMode.NO_FIT)
        return assignment

    # ---- hook 3: in-cycle admit-time re-validation ----
    def fits(
        self, wl: Workload, cq_name: str, assignment: AssignmentResult, snapshot
    ) -> Optional[str]:
        """Re-validate an entry's topology assignments against CURRENT
        TAS usage (reference: ClusterQueueSnapshot.Fits' TAS branch,
        pkg/cache/clusterqueue_snapshot.go:135-149).

        Assignments were computed at nominate time against one shared
        TAS snapshot; an earlier admission this cycle charges the TAS
        cache (bumping its generation), so this check sees in-cycle
        usage and rejects overlapping domain assignments. Returns an
        error message, or None when everything still fits.
        """
        from kueue_tpu_torch.tas.snapshot import domain_id as _domain_id

        podsets = {ps.name: ps for ps in wl.pod_sets}
        # per flavor: domain id -> usage assumed by earlier podsets of
        # THIS workload (same accounting as find_topology_assignments)
        assumed: Dict[str, Dict[str, Dict[str, int]]] = {}
        for psr in assignment.pod_sets:
            ta = psr.topology_assignment
            if ta is None:
                continue
            ps = podsets.get(psr.name)
            if ps is None:
                continue
            flavor_names = {c.name for c in psr.flavors.values()}
            if len(flavor_names) != 1:
                continue
            flavor_name = next(iter(flavor_names))
            if not self._is_tas_flavor(flavor_name):
                continue
            snap = self._snapshot_for(flavor_name)
            req = TASPodSetRequest(
                podset_name=psr.name,
                count=psr.count,
                # same quota view as assign(): overhead + transformations
                single_pod_requests=dict(quota_per_pod(ps, self.transform)),
                topology_request=ps.topology_request,
                tolerations=tuple(ps.tolerations),
                flavor=flavor_name,
            )
            facc = assumed.setdefault(flavor_name, {})
            counts = snap.podset_fit_counts(req, facc)
            for dom in ta.domains:
                did = _domain_id(dom.values)
                leaf = snap.leaves.get(did)
                if leaf is None:
                    return (
                        f'topology domain "{did}" of flavor "{flavor_name}"'
                        " no longer exists"
                    )
                if counts[leaf.leaf_idx] < dom.count:
                    return (
                        "Workload no longer fits: topology domain "
                        f'"{did}" cannot hold {dom.count} pod(s) of pod set '
                        f"{psr.name} after in-cycle TAS admissions"
                    )
            snap.charge_assumed(facc, req, ta)
        return None
