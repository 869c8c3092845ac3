"""Pending-workload queues.

Behavioral equivalent of the reference's ``pkg/queue``: per-ClusterQueue
pending heaps with two pools (active heap + inadmissible parking lot),
StrictFIFO/BestEffortFIFO requeue policies, pop-cycle race avoidance,
eviction-backoff gating, and a manager owning LocalQueues, cohort-wide
reactivation and the Heads() handoff to the scheduler.

Mirrored semantics (no code ported):
- ordering: priority desc, then queue-order timestamp asc
  (pkg/queue/cluster_queue.go:413-426)
- requeue policy matrix by queueing strategy and reason
  (cluster_queue.go:402-407)
- popCycle / queueInadmissibleCycle: a workload requeued "generic"
  while a cohort-wide reactivation happened since its Pop goes back to
  the heap, not the parking lot (cluster_queue.go:225-252)
- backoffWaitingTimeExpired gates heap entry on RequeueState.requeueAt
  and the Requeued condition (cluster_queue.go:176-187)
- cohort-wide requeue: freeing capacity in one CQ reactivates parked
  workloads across the whole cohort tree (pkg/queue/manager.go:513-563)
"""

from __future__ import annotations

import threading
from enum import Enum
from typing import Callable, Dict, Iterable, List, Optional, Set

from kueue_tpu_torch.models import ClusterQueue as ClusterQueueModel
from kueue_tpu_torch.models import LocalQueue as LocalQueueModel
from kueue_tpu_torch.models import QueueingStrategy, StopPolicy, Workload
from kueue_tpu_torch.models.constants import WorkloadConditionType
from kueue_tpu_torch.models.priority_class import WorkloadPriorityClass
from kueue_tpu_torch.core.hierarchy import CohortForest
from kueue_tpu_torch.utils.clock import Clock
from kueue_tpu_torch.utils.heap import Heap
from kueue_tpu_torch.utils.priority import priority_of


class RequeueReason(str, Enum):
    FAILED_AFTER_NOMINATION = "FailedAfterNomination"
    NAMESPACE_MISMATCH = "NamespaceMismatch"
    GENERIC = ""
    PENDING_PREEMPTION = "PendingPreemption"


class RequeueTimestamp(str, Enum):
    """waitForPodsReady.requeuingStrategy.timestamp config."""

    EVICTION = "Eviction"
    CREATION = "Creation"


def queue_order_timestamp(wl: Workload, policy: RequeueTimestamp) -> float:
    if policy == RequeueTimestamp.EVICTION:
        evicted = wl.conditions.get(WorkloadConditionType.EVICTED)
        if evicted is not None and evicted.status:
            return evicted.last_transition_time
    return wl.creation_time


class PendingClusterQueue:
    """One ClusterQueue's pending pools: active heap + parking lot."""

    def __init__(
        self,
        name: str,
        strategy: QueueingStrategy,
        clock: Clock,
        priority_fn: Callable[[Workload], int],
        timestamp_policy: RequeueTimestamp = RequeueTimestamp.EVICTION,
    ):
        self.name = name
        self.strategy = strategy
        self.clock = clock
        self._priority_fn = priority_fn
        self._ts_policy = timestamp_policy
        # native C++ heap when the shared library is available, else the
        # generic Python heap with the identical ordering
        from kueue_tpu_torch.utils.native_heap import make_workload_heap

        self.heap = make_workload_heap(
            key_fn=lambda w: w.key,
            priority_fn=priority_fn,
            timestamp_fn=lambda w: queue_order_timestamp(w, timestamp_policy),
        )
        self.inadmissible: Dict[str, Workload] = {}
        self.pop_cycle = 0
        self.queue_inadmissible_cycle = -1
        self.inflight: Optional[Workload] = None
        self.active = True
        self.namespace_selector: Optional[Dict[str, str]] = None

    def _less(self, a: Workload, b: Workload) -> bool:
        """Strict ordering (cluster_queue.go:413-426); ties report
        neither-less so snapshot_sorted's stable sort preserves
        insertion order, matching the heaps' FIFO tie-break. Timestamps
        quantize to integer ns exactly like the heap ranks do, so heap
        pop order and snapshot ordering agree on near-ties."""
        pa, pb = self._priority_fn(a), self._priority_fn(b)
        if pa != pb:
            return pa > pb
        ta = int(queue_order_timestamp(a, self._ts_policy) * 1e9)
        tb = int(queue_order_timestamp(b, self._ts_policy) * 1e9)
        return ta < tb

    # ---- backoff gate ----
    def _backoff_expired(self, wl: Workload) -> bool:
        requeued = wl.conditions.get(WorkloadConditionType.REQUEUED)
        if requeued is not None and not requeued.status:
            return False
        if wl.requeue_state is None or wl.requeue_state.requeue_at is None:
            return True
        return self.clock.now() >= wl.requeue_state.requeue_at

    # ---- mutations ----
    def push_or_update(self, wl: Workload) -> None:
        key = wl.key
        self._forget_inflight(key)
        old = self.inadmissible.get(key)
        if old is not None:
            if old is wl:
                # In-place mutation (no API-server copies here): the
                # change test below can't fire — re-evaluate only the
                # backoff gate so a finished backoff unparks while
                # irrelevant updates stay parked.
                if not self._backoff_expired(wl):
                    return
            elif (
                # Stay parked if nothing admission-relevant changed
                # (spec / reclaimable pods / Evicted / Requeued conditions).
                old.pod_sets == wl.pod_sets
                and old.reclaimable_pods == wl.reclaimable_pods
                and old.priority == wl.priority
                and old.conditions.get(WorkloadConditionType.EVICTED)
                == wl.conditions.get(WorkloadConditionType.EVICTED)
                and old.conditions.get(WorkloadConditionType.REQUEUED)
                == wl.conditions.get(WorkloadConditionType.REQUEUED)
            ):
                self.inadmissible[key] = wl
                return
            del self.inadmissible[key]
        if self.heap.get_by_key(key) is None and not self._backoff_expired(wl):
            self.inadmissible[key] = wl
            return
        self.heap.push_or_update(wl)

    def delete(self, wl_key: str) -> None:
        self.inadmissible.pop(wl_key, None)
        self.heap.delete(wl_key)
        self._forget_inflight(wl_key)

    def requeue_if_not_present(self, wl: Workload, reason: RequeueReason) -> bool:
        if self.strategy == QueueingStrategy.STRICT_FIFO:
            immediate = reason != RequeueReason.NAMESPACE_MISMATCH
        else:
            immediate = reason in (
                RequeueReason.FAILED_AFTER_NOMINATION,
                RequeueReason.PENDING_PREEMPTION,
            )
        return self._requeue(wl, immediate)

    def _requeue(self, wl: Workload, immediate: bool) -> bool:
        key = wl.key
        self._forget_inflight(key)
        # A workload with untried flavors left in its fungibility cursor
        # retries immediately (cluster_queue.go:231 PendingFlavors).
        pending_flavors = (
            wl.last_assignment is not None
            and getattr(wl.last_assignment, "pending_flavors", lambda: False)()
        )
        if self._backoff_expired(wl) and (
            immediate
            or self.queue_inadmissible_cycle >= self.pop_cycle
            or pending_flavors
        ):
            parked = self.inadmissible.pop(key, None)
            if parked is not None:
                wl = parked
            return self.heap.push_if_not_present(wl)
        if key in self.inadmissible:
            return False
        if self.heap.get_by_key(key) is not None:
            return False
        self.inadmissible[key] = wl
        return True

    def queue_inadmissible(
        self, namespace_labels: Callable[[str], Dict[str, str]]
    ) -> bool:
        """Move parked workloads back to the heap (cluster conditions
        changed). Namespace-selector misses and unexpired backoffs stay
        parked."""
        self.queue_inadmissible_cycle = self.pop_cycle
        if not self.inadmissible:
            return False
        remaining: Dict[str, Workload] = {}
        moved = False
        for key, wl in self.inadmissible.items():
            ns_ok = self.namespace_selector is None or all(
                namespace_labels(wl.namespace).get(k) == v
                for k, v in self.namespace_selector.items()
            )
            if not ns_ok or not self._backoff_expired(wl):
                remaining[key] = wl
            else:
                moved = self.heap.push_if_not_present(wl) or moved
        self.inadmissible = remaining
        return moved

    def pop(self) -> Optional[Workload]:
        self.pop_cycle += 1
        head = self.heap.pop()
        self.inflight = head
        return head

    def _forget_inflight(self, key: str) -> None:
        if self.inflight is not None and self.inflight.key == key:
            self.inflight = None

    # ---- introspection ----
    def pending(self) -> int:
        return self.pending_active() + len(self.inadmissible)

    def pending_active(self) -> int:
        return len(self.heap) + (1 if self.inflight is not None else 0)

    def pending_inadmissible(self) -> int:
        return len(self.inadmissible)

    def snapshot_sorted(self) -> List[Workload]:
        items = list(self.heap.items()) + list(self.inadmissible.values())
        if self.inflight is not None:
            items.append(self.inflight)
        return self._heap_order(items)

    def snapshot_active_sorted(self) -> List[Workload]:
        """Active pending only (heap + inflight, no parked), in heap
        order — the workloads the cycle loop would pop as heads."""
        items = list(self.heap.items())
        if self.inflight is not None:
            items.append(self.inflight)
        return self._heap_order(items)

    def _heap_order(self, items: List[Workload]) -> List[Workload]:
        import functools

        return sorted(
            items,
            key=functools.cmp_to_key(
                lambda a, b: -1 if self._less(a, b) else (1 if self._less(b, a) else 0)
            ),
        )

    def park(self, wl: Workload) -> None:
        """Move a workload straight into inadmissible parking (the bulk
        drain's terminal NoFit outcome; the kernel already modeled the
        requeue/reactivation churn the host would run to get here)."""
        key = wl.key
        self.heap.delete(key)
        self._forget_inflight(key)
        self.inadmissible[key] = wl


class QueueManager:
    """Owns LocalQueues and per-CQ pending queues (pkg/queue/manager.go).

    Single authoritative pending-state store. ``heads()`` hands the
    scheduler the head workload of every active ClusterQueue;
    ``wait_for_heads`` blocks on a condition variable for runtime use.
    """

    def __init__(
        self,
        clock: Clock,
        priority_classes: Optional[Dict[str, WorkloadPriorityClass]] = None,
        timestamp_policy: RequeueTimestamp = RequeueTimestamp.EVICTION,
        namespace_labels: Optional[Callable[[str], Dict[str, str]]] = None,
    ):
        self.clock = clock
        self.priority_classes = priority_classes if priority_classes is not None else {}
        self._ts_policy = timestamp_policy
        self.namespace_labels = namespace_labels or (lambda ns: {})
        self.cluster_queues: Dict[str, PendingClusterQueue] = {}
        self.local_queues: Dict[str, LocalQueueModel] = {}
        self.lq_items: Dict[str, Dict[str, Workload]] = {}
        self.forest = CohortForest()
        self._cq_models: Dict[str, ClusterQueueModel] = {}
        self._cond = threading.Condition()

    def _priority(self, wl: Workload) -> int:
        return priority_of(wl, self.priority_classes)

    # ---- ClusterQueue lifecycle ----
    def add_cluster_queue(self, cq: ClusterQueueModel) -> None:
        pending = PendingClusterQueue(
            cq.name, cq.queueing_strategy, self.clock, self._priority, self._ts_policy
        )
        pending.namespace_selector = cq.namespace_selector
        pending.active = cq.stop_policy == StopPolicy.NONE
        self.cluster_queues[cq.name] = pending
        self._cq_models[cq.name] = cq
        self.forest.add_cluster_queue(cq.name, cq.cohort)
        # Adopt workloads from LocalQueues already pointing at this CQ
        # (manager.go AddClusterQueue requeues existing workloads).
        for lq_key, lq in self.local_queues.items():
            if lq.cluster_queue == cq.name:
                for wl in self.lq_items[lq_key].values():
                    pending.push_or_update(wl)
        self._broadcast()

    def update_cluster_queue(self, cq: ClusterQueueModel) -> None:
        pending = self.cluster_queues.get(cq.name)
        if pending is None:
            self.add_cluster_queue(cq)
            return
        pending.strategy = cq.queueing_strategy
        pending.namespace_selector = cq.namespace_selector
        pending.active = cq.stop_policy == StopPolicy.NONE
        self._cq_models[cq.name] = cq
        self.forest.update_cluster_queue(cq.name, cq.cohort)
        # Any spec change can make parked workloads admissible (new
        # quota, selector, strategy) — reactivate them all, mirroring
        # manager.UpdateClusterQueue's unconditional requeue.
        pending.queue_inadmissible(self.namespace_labels)
        self._broadcast()

    def delete_cluster_queue(self, name: str) -> None:
        self.cluster_queues.pop(name, None)
        self._cq_models.pop(name, None)
        self.forest.delete_cluster_queue(name)

    # ---- LocalQueue lifecycle ----
    def add_local_queue(
        self, lq: LocalQueueModel, workloads: Iterable[Workload] = ()
    ) -> None:
        self.local_queues[lq.key] = lq
        items = self.lq_items.setdefault(lq.key, {})
        for wl in workloads:
            items[wl.key] = wl
        pending = self.cluster_queues.get(lq.cluster_queue)
        if pending is not None:
            for wl in items.values():
                pending.push_or_update(wl)
            self._broadcast()

    def delete_local_queue(self, lq_key: str) -> None:
        lq = self.local_queues.pop(lq_key, None)
        items = self.lq_items.pop(lq_key, {})
        if lq is None:
            return
        pending = self.cluster_queues.get(lq.cluster_queue)
        if pending is not None:
            for key in items:
                pending.delete(key)

    def _lq_key_for(self, wl: Workload) -> str:
        return f"{wl.namespace}/{wl.queue_name}"

    # ---- Workload events (manager.go:374-470) ----
    def add_or_update_workload(self, wl: Workload) -> bool:
        lq = self.local_queues.get(self._lq_key_for(wl))
        if lq is None:
            return False
        self.lq_items.setdefault(lq.key, {})[wl.key] = wl
        if lq.stop_policy != StopPolicy.NONE:
            return False
        pending = self.cluster_queues.get(lq.cluster_queue)
        if pending is None:
            return False
        pending.push_or_update(wl)
        self._broadcast()
        return True

    def delete_workload(self, wl: Workload) -> None:
        lq = self.local_queues.get(self._lq_key_for(wl))
        if lq is not None:
            self.lq_items.get(lq.key, {}).pop(wl.key, None)
            pending = self.cluster_queues.get(lq.cluster_queue)
            if pending is not None:
                pending.delete(wl.key)

    def remove_from_pending(self, wl: Workload) -> None:
        """Drop a workload from its CQ's pending structures only (the
        admitted path: it stays a LocalQueue item, unlike
        delete_workload)."""
        lq = self.local_queues.get(self._lq_key_for(wl))
        if lq is None:
            return
        pending = self.cluster_queues.get(lq.cluster_queue)
        if pending is not None:
            pending.delete(wl.key)

    def park_workload(self, wl: Workload) -> None:
        """Terminal-NoFit parking for the bulk drain (see
        ClusterQueuePending.park)."""
        lq = self.local_queues.get(self._lq_key_for(wl))
        if lq is None:
            return
        pending = self.cluster_queues.get(lq.cluster_queue)
        if pending is not None:
            pending.park(wl)

    def requeue_workload(self, wl: Workload, reason: RequeueReason) -> bool:
        lq = self.local_queues.get(self._lq_key_for(wl))
        if lq is None or lq.stop_policy != StopPolicy.NONE:
            return False
        pending = self.cluster_queues.get(lq.cluster_queue)
        if pending is None:
            return False
        added = pending.requeue_if_not_present(wl, reason)
        if added:
            self._broadcast()
        return added

    # ---- cohort-wide reactivation (manager.go:466-563) ----
    def queue_associated_inadmissible_workloads_after(
        self, cq_name: str, mutate: Optional[Callable[[], None]] = None
    ) -> None:
        """After usage is freed in cq_name (workload finished/evicted),
        reactivate parked workloads in every CQ of its cohort tree."""
        if mutate is not None:
            mutate()
        cohort = self.forest.cq_parent.get(cq_name)
        if cohort is None:
            self._queue_inadmissible({cq_name})
            return
        root = self.forest.root_of(cohort)
        members = self._cohort_tree_cqs(root)
        self._queue_inadmissible(members)

    def queue_inadmissible_workloads(self, cq_names: Set[str]) -> None:
        self._queue_inadmissible(cq_names)

    def _cohort_tree_cqs(self, root_cohort: str) -> Set[str]:
        out: Set[str] = set()
        stack = [root_cohort]
        while stack:
            name = stack.pop()
            node = self.forest.cohorts.get(name)
            if node is None:
                continue
            out |= node.cq_children
            stack.extend(node.cohort_children)
        return out

    def _queue_inadmissible(self, cq_names: Set[str]) -> None:
        moved = False
        for name in cq_names:
            pending = self.cluster_queues.get(name)
            if pending is not None:
                moved = pending.queue_inadmissible(self.namespace_labels) or moved
        if moved:
            self._broadcast()

    # ---- scheduler handoff ----
    def heads(self) -> List[Workload]:
        """Pop the head of every active ClusterQueue (manager.go Heads)."""
        out: List[Workload] = []
        for name in sorted(self.cluster_queues):
            pending = self.cluster_queues[name]
            if not pending.active:
                continue
            head = pending.pop()
            if head is not None:
                out.append(head)
        return out

    def wait_for_heads(self, timeout: Optional[float] = None) -> List[Workload]:
        with self._cond:
            heads = self.heads()
            if heads:
                return heads
            self._cond.wait(timeout=timeout)
            return self.heads()

    def _broadcast(self) -> None:
        with self._cond:
            self._cond.notify_all()

    # ---- introspection / visibility ----
    def pending_workloads(self, cq_name: str) -> int:
        pending = self.cluster_queues.get(cq_name)
        return pending.pending() if pending else 0

    def cluster_queue_for_workload(self, wl: Workload) -> Optional[str]:
        lq = self.local_queues.get(self._lq_key_for(wl))
        return lq.cluster_queue if lq else None
