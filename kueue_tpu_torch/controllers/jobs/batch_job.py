"""batch/Job integration.

Reference: pkg/controller/jobs/job/job_controller.go (376 LoC).
Suspend-based: Kueue gates the job via spec.suspend; admission injects
flavor node selectors and (for partial admission) scales parallelism;
suspension restores the original values. Pod execution is simulated —
the runtime marks pods active on start, and tests (or the scale
harness) complete them, mirroring how the reference's envtest suites
flip Job status without kubelets.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from kueue_tpu_torch.controllers.jobframework import GenericJob
from kueue_tpu_torch.controllers.podset_info import PodSetInfo
from kueue_tpu_torch.models.workload import PodSet
from kueue_tpu_torch.resources import Requests, requests_from_spec


@dataclass
class BatchJob(GenericJob):
    kind = "Job"
    namespace: str = ""
    name: str = ""
    queue: str = ""  # kueue.x-k8s.io/queue-name label
    priority_class: str = ""

    suspended: bool = True
    # MultiKueue managedBy (batch Job spec.managedBy, feature
    # MultiKueueBatchJobWithManagedBy): non-None defers local start
    managed_by: Optional[str] = None
    parallelism: int = 1
    completions: int = 1
    backoff_limit: int = 6
    # partial admission (job-min-parallelism annotation)
    min_parallelism: Optional[int] = None

    # pod template
    requests: Requests = field(default_factory=dict)
    node_selector: Dict[str, str] = field(default_factory=dict)
    tolerations: Tuple = ()

    # simulated status
    active_pods: int = 0
    ready_pods: int = 0
    succeeded: int = 0
    failed: int = 0

    # injected state bookkeeping (RunWithPodSetsInfo / RestorePodSetsInfo)
    _original_node_selector: Optional[Dict[str, str]] = None
    _original_parallelism: Optional[int] = None

    @staticmethod
    def build(namespace, name, queue, parallelism=1, completions=None,
              requests=None, **kw) -> "BatchJob":
        return BatchJob(
            namespace=namespace, name=name, queue=queue,
            parallelism=parallelism,
            completions=completions if completions is not None else parallelism,
            requests=requests_from_spec(requests or {}),
            **kw,
        )

    # ---- GenericJob ----
    def queue_name(self) -> str:
        return self.queue

    def workload_priority_class(self) -> str:
        return self.priority_class

    def is_suspended(self) -> bool:
        return self.suspended

    def suspend(self) -> None:
        self.suspended = True
        # suspending a k8s Job deletes its pods
        self.active_pods = 0
        self.ready_pods = 0

    def pod_sets(self) -> Tuple[PodSet, ...]:
        return (
            PodSet(
                name="main",
                count=self.parallelism,
                requests=dict(self.requests),
                min_count=self.min_parallelism,
                node_selector=dict(self.node_selector),
                tolerations=tuple(self.tolerations),
            ),
        )

    def run_with_podsets_info(self, infos: Sequence[PodSetInfo]) -> None:
        info = infos[0]
        self._original_node_selector = dict(self.node_selector)
        self._original_parallelism = self.parallelism
        merged = dict(self.node_selector)
        merged.update(info.node_selector)
        self.node_selector = merged
        if info.count and info.count != self.parallelism:
            self.parallelism = info.count  # partial admission scale-down
        self.suspended = False
        self.active_pods = self.parallelism  # pods start (simulated)

    def restore_podsets_info(self, infos: Sequence[PodSetInfo]) -> bool:
        changed = False
        if self._original_node_selector is not None:
            changed = self.node_selector != self._original_node_selector
            self.node_selector = self._original_node_selector
            self._original_node_selector = None
        if self._original_parallelism is not None:
            changed = changed or self.parallelism != self._original_parallelism
            self.parallelism = self._original_parallelism
            self._original_parallelism = None
        return changed

    def is_active(self) -> bool:
        return self.active_pods > 0

    def finished(self) -> Tuple[str, bool, bool]:
        if self.succeeded >= self.completions:
            return "Job finished successfully", True, True
        if self.failed > self.backoff_limit:
            return "Job failed", False, True
        return "", False, False

    def pods_ready(self) -> bool:
        return not self.suspended and self.ready_pods >= self.parallelism

    def reclaimable_pods(self) -> Optional[Dict[str, int]]:
        """job_controller.go ReclaimablePods: once the remaining
        completions drop below parallelism, the surplus parallel slots
        are reclaimable — count = parallelism - remaining."""
        if self.parallelism == 1 or self.succeeded == 0:
            return None
        remaining = self.completions - self.succeeded
        if remaining >= self.parallelism:
            return None
        return {"main": self.parallelism - remaining}

    # ---- simulation helpers ----
    def mark_pods_ready(self, n: Optional[int] = None) -> None:
        self.ready_pods = self.parallelism if n is None else n

    def complete(self, success: bool = True) -> None:
        if success:
            self.succeeded = self.completions
        else:
            self.failed = self.backoff_limit + 1
        self.active_pods = 0
