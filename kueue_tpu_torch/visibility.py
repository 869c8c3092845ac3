"""Visibility API — on-demand pending-workloads summaries + decisions.

Reference: apis/visibility/v1beta1 + pkg/visibility (the embedded
apiserver serving PendingWorkloadsSummary subresources on CQ/LQ at
:8082). Here the same payloads are computed straight from the
QueueManager's heap snapshots (pkg/queue/manager.go:695-731) and — when
the caller hands over the decision audit log (core/audit.py) — each
pending workload carries its latest STRUCTURED inadmissibility reason,
so "why is this pending" is answerable from the position listing alone.
``workload_decisions`` exposes the full per-workload decision history
(the ``/debug/workloads/<ns>/<name>/decisions`` payload). Servers
(HTTP, gRPC) can wrap these functions.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from kueue_tpu_torch.core.queue_manager import QueueManager


@dataclass
class PendingWorkload:
    """visibility/v1beta1 PendingWorkload, extended with the latest
    audit-trail reason (empty when no decision has been recorded yet —
    e.g. a workload queued but never popped as a head)."""

    name: str
    namespace: str
    local_queue_name: str
    priority: int
    position_in_cluster_queue: int
    position_in_local_queue: int
    inadmissible_reason: str = ""
    message: str = ""
    last_cycle: int = 0


@dataclass
class PendingWorkloadsSummary:
    items: List[PendingWorkload] = field(default_factory=list)


def pending_workloads_in_cq(
    queues: QueueManager,
    cq_name: str,
    offset: int = 0,
    limit: int = 1000,
    audit=None,
) -> PendingWorkloadsSummary:
    """pkg/visibility/api/v1beta1/pending_workloads_cq.go:37-46.

    Positions are computed over the FULL pending set (heap + parked +
    inflight, merged in heap order) before offset/limit slicing, so a
    paginated client sees stable absolute positions."""
    pending = queues.cluster_queues.get(cq_name)
    if pending is None:
        return PendingWorkloadsSummary()
    ordered = pending.snapshot_sorted()
    lq_positions: dict = {}
    items: List[PendingWorkload] = []
    for pos, wl in enumerate(ordered):
        lq_key = f"{wl.namespace}/{wl.queue_name}"
        lq_pos = lq_positions.get(lq_key, 0)
        lq_positions[lq_key] = lq_pos + 1
        if pos < offset or len(items) >= limit:
            continue
        reason = message = ""
        last_cycle = 0
        if audit is not None:
            latest = audit.latest(wl.key)
            if latest is not None:
                reason = latest.reason.value
                message = latest.message
                last_cycle = latest.last_cycle
        items.append(
            PendingWorkload(
                name=wl.name,
                namespace=wl.namespace,
                local_queue_name=wl.queue_name,
                priority=queues._priority(wl),
                position_in_cluster_queue=pos,
                position_in_local_queue=lq_pos,
                inadmissible_reason=reason,
                message=message,
                last_cycle=last_cycle,
            )
        )
    return PendingWorkloadsSummary(items=items)


def pending_workloads_in_lq(
    queues: QueueManager, namespace: str, lq_name: str,
    offset: int = 0, limit: int = 1000,
    audit=None,
) -> PendingWorkloadsSummary:
    """LQ variant: the CQ summary filtered to one LocalQueue, with LQ
    positions recomputed."""
    lq = queues.local_queues.get(f"{namespace}/{lq_name}")
    if lq is None:
        return PendingWorkloadsSummary()
    cq_summary = pending_workloads_in_cq(
        queues, lq.cluster_queue, offset=0, limit=1 << 30, audit=audit
    )
    items = [
        pw for pw in cq_summary.items
        if pw.namespace == namespace and pw.local_queue_name == lq_name
    ]
    return PendingWorkloadsSummary(items=items[offset : offset + limit])


def workload_decisions(audit, key: str) -> List[dict]:
    """The full decision history of one workload as wire dicts, oldest
    first — the /debug/workloads/<ns>/<name>/decisions payload and the
    data `kueuectl explain` renders."""
    if audit is None:
        return []
    return [rec.to_dict() for rec in audit.for_workload(key)]


def pending_position(
    queues: QueueManager, cq_name: str, key: str, audit=None
) -> Optional[PendingWorkload]:
    """One workload's pending entry (position + structured reason), or
    None when it is not pending in the ClusterQueue."""
    for pw in pending_workloads_in_cq(queues, cq_name, audit=audit).items:
        if f"{pw.namespace}/{pw.name}" == key:
            return pw
    return None
