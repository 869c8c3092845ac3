"""TAS node-lifecycle controller and topology ungater.

Reference: pkg/controller/tas — resource_flavor.go:71-110 (node watch
feeding per-flavor capacity) and topology_ungater.go:60-136 (removing
the kueue.x-k8s.io/topology scheduling gate from pods per domain
assignment, guarded by an expectations create-observation barrier).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from kueue_tpu_torch.models import Workload
from kueue_tpu_torch.controllers.jobs.pod import PodGroup, SimPod
from kueue_tpu_torch.tas.cache import Node, TASCache
from kueue_tpu_torch.utils.expectations import ExpectationsStore


class NodeController:
    """Node scrape/watch -> TASCache ingest (resource_flavor.go:71-110).

    The reference reconciler watches corev1.Node events and rebuilds
    the affected flavors' capacity; here node events are delivered
    explicitly (the runtime's API surface) and routed to every flavor
    cache, bumping the TAS generation so per-cycle snapshots rebuild.
    """

    def __init__(self, tas_cache: TASCache):
        self.tas_cache = tas_cache

    def add_or_update_node(self, node: Node) -> None:
        self.tas_cache.add_or_update_node(node)

    def delete_node(self, name: str) -> None:
        self.tas_cache.delete_node(name)

    def ingest(self, nodes) -> int:
        """Bulk scrape (initial list)."""
        n = 0
        for node in nodes:
            self.add_or_update_node(node)
            n += 1
        return n


class TopologyUngater:
    """Removes topology scheduling gates per domain assignment
    (topology_ungater.go:60-136).

    Reconcile for a TAS-admitted workload:
      1. bail while previous ungate operations are unobserved
         (expectations.Store.Satisfied — the create-observation barrier
         preventing double-ungating off a stale informer cache);
      2. per PodSetAssignment with a TopologyAssignment: rank-order the
         podset's gated pods, count schedulable pods already placed in
         each domain (by node-selector match), and assign gated pods to
         the remaining per-domain capacity;
      3. record the acted-on pod UIDs as expected, then remove the
         gates and inject the domain's node-selector labels.

    Observation is delivered through ``pod_event`` — the runtime calls
    it as the "informer echo" for pod updates/deletes.
    """

    def __init__(self):
        self.expectations = ExpectationsStore("tas-topology-ungater")
        # telemetry for tests/operators
        self.pending_reconciles: int = 0
        self.ungated_total: int = 0

    # ---- event side (podHandler in the reference) ----
    def pod_event(self, wl_key: str, pod: SimPod, deleted: bool = False) -> None:
        """A pod changed (or disappeared): if its topology gate is gone
        it counts as observed — deleted pods count too
        (topology_ungater.go queueReconcileForPod)."""
        if deleted or not pod.topology_gate:
            self.expectations.observed_uid(wl_key, pod.uid)

    def observe_job(self, wl_key: str, job: PodGroup) -> None:
        """Deliver the echo for every member pod (one reconcile-loop
        delay after the mutation, like the informer)."""
        for p in job.pods:
            self.pod_event(wl_key, p, deleted=(p.phase == "Deleted"))

    # ---- reconcile ----
    @staticmethod
    def _is_admitted_by_tas(wl: Workload) -> bool:
        return (
            wl.is_admitted
            and wl.admission is not None
            and any(
                psa.topology_assignment is not None
                for psa in wl.admission.pod_set_assignments
            )
        )

    @staticmethod
    def _domain_selector(levels, values) -> Dict[str, str]:
        return dict(zip(levels, values))

    def reconcile(self, wl: Workload, job: PodGroup) -> int:
        """Returns the number of pods ungated this pass (0 when blocked
        on the barrier or nothing to do)."""
        if not self._is_admitted_by_tas(wl):
            return 0
        if not self.expectations.satisfied(wl.key):
            self.pending_reconciles += 1
            return 0

        to_ungate: List[Tuple[SimPod, Dict[str, str]]] = []
        for psa in wl.admission.pod_set_assignments:
            ta = psa.topology_assignment
            if ta is None:
                continue
            members = [
                p for p in job.observed() if p.role == psa.name
            ]
            # rank-ordered, stable (assignGatedPodsToDomains)
            members.sort(
                key=lambda p: (p.rank if p.rank is not None else 1 << 30, p.name)
            )
            gated = [p for p in members if p.topology_gate]
            if not gated:
                continue
            cursor = 0
            for dom in ta.domains:
                selector = self._domain_selector(ta.levels, dom.values)
                placed = sum(
                    1
                    for p in members
                    if not p.topology_gate
                    and all(
                        p.node_selector.get(k) == v for k, v in selector.items()
                    )
                )
                room = dom.count - placed
                while room > 0 and cursor < len(gated):
                    to_ungate.append((gated[cursor], selector))
                    cursor += 1
                    room -= 1

        if not to_ungate:
            return 0
        # barrier BEFORE acting (ExpectUIDs then issue the patches)
        self.expectations.expect_uids(
            wl.key, [p.uid for p, _ in to_ungate]
        )
        for pod, selector in to_ungate:
            merged = dict(pod.node_selector)
            merged.update(selector)
            pod.node_selector = merged
            pod.topology_gate = False
            if pod.phase == "Pending" and pod.schedulable:
                pod.phase = "Running"
        self.ungated_total += len(to_ungate)
        return len(to_ungate)
