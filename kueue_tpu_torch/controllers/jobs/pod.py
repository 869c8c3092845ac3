"""Plain-Pod and pod-group integration.

Reference: pkg/controller/jobs/pod (pod_controller.go, 1373 LoC — the
largest integration). Pods cannot be suspended, so Kueue gates them
with the ``kueue.x-k8s.io/admission`` scheduling gate at creation
(pod_webhook.go:192-201); admission removes the gate and injects node
selectors; eviction DELETES the pods. Groups are assembled from the
``pod-group-name`` label with a ``pod-group-total-count`` annotation —
the workload exists once all pods are observed, distinct pod shapes
become distinct podsets, and failed pods may be replaced by new ones
(retriable groups).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from kueue_tpu_torch.controllers.jobframework import GenericJob
from kueue_tpu_torch.controllers.podset_info import PodSetInfo
from kueue_tpu_torch.models.workload import PodSet
from kueue_tpu_torch.resources import Requests, requests_from_spec

ADMISSION_GATE = "kueue.x-k8s.io/admission"

POD_PENDING = "Pending"
POD_RUNNING = "Running"
POD_SUCCEEDED = "Succeeded"
POD_FAILED = "Failed"
POD_DELETED = "Deleted"


@dataclass
class SimPod:
    """The Pod slice the integration consumes."""

    name: str
    requests: Requests = field(default_factory=dict)
    role: str = "main"  # shape key; distinct roles -> distinct podsets
    gated: bool = True
    phase: str = POD_PENDING
    node_selector: Dict[str, str] = field(default_factory=dict)
    # The kueue.x-k8s.io/topology scheduling gate (pod_webhook.go:192-201):
    # injected for TAS workloads; removed per-domain by the topology
    # ungater (controllers/tas.py), NOT by admission.
    topology_gate: bool = False
    # rank-ordered placement (job completion index etc.)
    rank: Optional[int] = None
    uid: str = ""

    def __post_init__(self):
        if not self.uid:
            self.uid = f"uid-{self.name}-{id(self):x}"

    @property
    def schedulable(self) -> bool:
        return not self.gated and not self.topology_gate

    @staticmethod
    def build(name, requests=None, **kw) -> "SimPod":
        return SimPod(name=name, requests=requests_from_spec(requests or {}), **kw)


@dataclass
class PodGroup(GenericJob):
    """A pod group (or a single pod: total_count=1). ComposableJob
    analog: the job object is assembled from its member pods."""

    kind = "Pod"
    namespace: str = ""
    name: str = ""  # pod-group-name (or the pod name for singletons)
    queue: str = ""
    priority_class: str = ""
    total_count: int = 1
    pods: List[SimPod] = field(default_factory=list)

    _injected: Optional[Dict[str, Dict[str, str]]] = None

    @staticmethod
    def single(namespace, pod: SimPod, queue, **kw) -> "PodGroup":
        return PodGroup(
            namespace=namespace, name=pod.name, queue=queue,
            total_count=1, pods=[pod], **kw,
        )

    # ---- group assembly ----
    def observed(self) -> List[SimPod]:
        return [p for p in self.pods if p.phase != POD_DELETED]

    def is_complete(self) -> bool:
        """All member pods observed (expectations barrier analog)."""
        return len(self.observed()) >= self.total_count

    def add_pod(self, pod: SimPod) -> None:
        self.pods.append(pod)

    # ---- GenericJob ----
    def queue_name(self) -> str:
        return self.queue

    def workload_priority_class(self) -> str:
        return self.priority_class

    def is_suspended(self) -> bool:
        # gated pods are the suspend state for pods
        return any(p.gated for p in self.observed()) or not self.observed()

    def suspend(self) -> None:
        """Stopping a pod group deletes its (started) pods
        (pod_controller.go stop: DELETE, pods are not suspendable).
        Pending gated pods stay gated."""
        for p in self.observed():
            if not p.gated:
                p.phase = POD_DELETED

    def pod_sets(self) -> Tuple[PodSet, ...]:
        # one podset per distinct role, counts from the group spec
        roles: Dict[str, List[SimPod]] = {}
        for p in self.observed():
            roles.setdefault(p.role, []).append(p)
        out = []
        for role in sorted(roles):
            members = roles[role]
            out.append(
                PodSet(
                    name=role,
                    count=len(members),
                    requests=dict(members[0].requests),
                    node_selector=dict(members[0].node_selector),
                )
            )
        return tuple(out) if out else (PodSet(name="main", count=max(self.total_count, 1)),)

    def run_with_podsets_info(self, infos: Sequence[PodSetInfo]) -> None:
        by_role = {i.name: i for i in infos}
        self._injected = {}
        for p in self.observed():
            info = by_role.get(p.role)
            if info is not None:
                self._injected[p.name] = dict(p.node_selector)
                merged = dict(p.node_selector)
                merged.update(info.node_selector)
                p.node_selector = merged
            p.gated = False  # the admission gate lifts at start
            # topology-gated pods stay Pending until the ungater
            # removes the topology gate per domain assignment
            if p.phase == POD_PENDING and p.schedulable:
                p.phase = POD_RUNNING

    def restore_podsets_info(self, infos: Sequence[PodSetInfo]) -> bool:
        changed = False
        if self._injected:
            for p in self.pods:
                orig = self._injected.get(p.name)
                if orig is not None and p.node_selector != orig:
                    p.node_selector = orig
                    changed = True
            self._injected = None
        return changed

    def is_active(self) -> bool:
        return any(p.phase == POD_RUNNING for p in self.pods)

    def finished(self) -> Tuple[str, bool, bool]:
        live = self.observed()
        if not live:
            return "", False, False
        if all(p.phase == POD_SUCCEEDED for p in live):
            return "Pods succeeded", True, True
        # a failed pod fails the group only when it wasn't replaced:
        # group complete AND some pod failed AND nothing pending/running
        terminal = all(
            p.phase in (POD_SUCCEEDED, POD_FAILED) for p in live
        )
        if terminal and any(p.phase == POD_FAILED for p in live):
            return "At least one pod failed", False, True
        return "", False, False

    def pods_ready(self) -> bool:
        live = self.observed()
        return bool(live) and all(
            p.phase in (POD_RUNNING, POD_SUCCEEDED) for p in live
        )

    def reclaimable_pods(self) -> Optional[Dict[str, int]]:
        done: Dict[str, int] = {}
        for p in self.observed():
            if p.phase == POD_SUCCEEDED:
                done[p.role] = done.get(p.role, 0) + 1
        return done or None

    # simulation helpers
    def succeed_all(self) -> None:
        for p in self.observed():
            p.phase = POD_SUCCEEDED

    def replace_failed(self, pod: SimPod) -> None:
        """Retriable groups: a replacement joins while the failed pod's
        slot is released (pod_controller.go replacement semantics)."""
        for p in self.pods:
            if p.phase == POD_FAILED:
                p.phase = POD_DELETED
                break
        self.pods.append(pod)
