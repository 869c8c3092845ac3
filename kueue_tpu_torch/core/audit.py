"""Decision audit trail — why every admission decision went the way it did.

The scheduler computes rich per-workload rationale every cycle —
flavor-by-flavor rejection reasons, preemption victim choices, TAS
placements, which resolution path (host loop, batched device scan,
bulk drain) decided — and before this module all of it died with the
CycleResult. The audit log keeps it: one ``DecisionRecord`` per
nominated entry per cycle, stored in a bounded per-workload ring so a
stuck job's full decision history is inspectable after the fact
(``GET /debug/workloads/<ns>/<name>/decisions``, ``kueuectl explain``,
the dashboard's "why pending" panel, the SIGUSR2 dump).

Design constraints:

- reasons are members of the canonical ``InadmissibleReason`` enum
  (models/constants.py) — ``record()`` rejects ad-hoc strings so the
  ``kueue_inadmissible_reason_total`` label space stays bounded;
- consecutive identical decisions count-dedup (the EventSeries analog):
  a workload parked for a thousand cycles holds ONE record with
  ``count=1000`` and a moving ``last_cycle``, so hot requeue loops
  cannot flush real history out of the ring;
- host and device paths attribute identically: the record carries both
  the cycle's resolution path and which engine nominated the entry, so
  solver-vs-host discrepancies are diffable from the trail alone.
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional

from kueue_tpu_torch.models.constants import InadmissibleReason


@dataclass
class DecisionRecord:
    """One admission decision for one workload in one cycle."""

    workload: str  # "namespace/name" key
    cluster_queue: str
    cycle: int  # scheduling cycle that first produced this decision
    outcome: str  # Admitted | Preempting | Skipped | Pending
    reason: InadmissibleReason
    message: str = ""
    # which path resolved the cycle (host | device | drain) and which
    # engine nominated this entry (host FlavorAssigner | device kernel)
    resolution: str = "host"
    nominated_via: str = "host"
    # borrowing/cohort state at evaluation time
    borrowing: bool = False
    cohort: str = ""
    # podset name -> {resource: flavor} for the chosen assignment
    flavors: Dict[str, Dict[str, str]] = field(default_factory=dict)
    # podset name -> normalized flavor-by-flavor rejection reasons
    flavor_reasons: Dict[str, List[str]] = field(default_factory=dict)
    # {"victims": [{"workload", "reason"}...], "search": "host|device"}
    # or {"blocked": <why no victims>} for a preempt-mode dead end
    preemption: Optional[dict] = None
    # TAS placement outcome: {"podset": {"levels": [...], "domains":
    # [{"values": [...], "count": n}, ...]}}
    topology: Optional[dict] = None
    # admission-policy flavor score breakdown (kueue_tpu/policy):
    # {"policy": name, "perFlavor": {"<flavors>": score_milli, ...},
    #  "winner": "<flavors>", "margin": winner - runner-up} — why a
    # flavor won under a scoring policy (`kueuectl explain` renders it;
    # absent under the default first-fit policy)
    scores: Optional[dict] = None
    # dedup bookkeeping
    count: int = 1
    last_cycle: int = 0
    timestamp: float = 0.0
    # monotone log position (stamped by DecisionAuditLog.record; a
    # dedup merge RESTAMPS the merged record) — the replication feed's
    # resume cursor, exactly the EventRecorder resourceVersion pattern
    seq: int = 0
    # the workload's lifecycle trace id (kueue_tpu_torch/tracing), stamped at
    # record time so `kueuectl explain` and read replicas correlate
    # this decision with its span tree. Empty = untraced emitter.
    trace_id: str = ""

    def __post_init__(self):
        if self.last_cycle < self.cycle:
            self.last_cycle = self.cycle

    def dedup_key(self) -> tuple:
        return (
            self.workload,
            self.cluster_queue,
            self.outcome,
            self.reason.value,
            self.message,
            self.nominated_via,
            self.resolution,
        )

    def to_dict(self) -> dict:
        out = {
            "workload": self.workload,
            "clusterQueue": self.cluster_queue,
            "cycle": self.cycle,
            "lastCycle": self.last_cycle,
            "count": self.count,
            "outcome": self.outcome,
            "reason": self.reason.value,
            "message": self.message,
            "resolution": self.resolution,
            "nominatedVia": self.nominated_via,
            "borrowing": self.borrowing,
            "cohort": self.cohort,
            "timestamp": self.timestamp,
            "seq": self.seq,
        }
        if self.trace_id:
            out["traceId"] = self.trace_id
        if self.flavors:
            out["flavors"] = self.flavors
        if self.flavor_reasons:
            out["flavorReasons"] = self.flavor_reasons
        if self.preemption is not None:
            out["preemption"] = self.preemption
        if self.topology is not None:
            out["topology"] = self.topology
        if self.scores is not None:
            out["scores"] = self.scores
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "DecisionRecord":
        """Wire-dict inverse of ``to_dict`` — the replication ingest
        half (storage/tailer.py ships audit deltas so a read replica's
        ``explain`` renders the leader's decision rationale)."""
        return cls(
            workload=d["workload"],
            cluster_queue=d.get("clusterQueue", ""),
            cycle=int(d.get("cycle", 0)),
            outcome=d.get("outcome", "Pending"),
            reason=InadmissibleReason(d.get("reason", "Unknown")),
            message=d.get("message", ""),
            resolution=d.get("resolution", "host"),
            nominated_via=d.get("nominatedVia", "host"),
            borrowing=bool(d.get("borrowing", False)),
            cohort=d.get("cohort", ""),
            flavors=d.get("flavors") or {},
            flavor_reasons=d.get("flavorReasons") or {},
            preemption=d.get("preemption"),
            topology=d.get("topology"),
            scores=d.get("scores"),
            count=int(d.get("count", 1)),
            last_cycle=int(d.get("lastCycle", 0)),
            timestamp=float(d.get("timestamp", 0.0)),
            seq=int(d.get("seq", 0)),
            trace_id=d.get("traceId", ""),
        )


class DecisionAuditLog:
    """Bounded per-workload decision history.

    ``per_workload`` bounds each workload's ring; ``max_workloads``
    bounds the tracked-key set with LRU eviction so a churn-heavy
    cluster (create/delete thousands of short jobs) cannot grow the log
    without bound. Thread-safe: the scheduler writes under the server
    lock but debug/visibility readers may race it.
    """

    def __init__(
        self,
        per_workload: int = 32,
        max_workloads: int = 4096,
        clock=None,
    ):
        self.per_workload = per_workload
        self.max_workloads = max_workloads
        self._clock = clock
        self._records: "OrderedDict[str, Deque[DecisionRecord]]" = OrderedDict()
        self._lock = threading.Lock()
        # monotone stamp of the newest record/merge — the replication
        # feed cursor (a dedup merge restamps, so "records with seq >
        # N" always includes every ring entry that CHANGED since N)
        self.seq = 0
        # recent-stamp log for O(delta) feed reads: every stamp (new
        # record or merge restamp) appends here; since() walks the
        # suffix instead of scanning every tracked ring (the feed polls
        # this at the replica poll rate). Bounded: a cursor older than
        # the log's left edge falls back to the full scan.
        self._stamp_log: Deque = deque(maxlen=8192)
        # called with each incoming record (before dedup-merge), the
        # runtime's metric mirror hangs here
        self.observers: List[Callable[[DecisionRecord], None]] = []
        # distributed tracing (kueue_tpu_torch/tracing): when attached, every
        # record is stamped with its workload's lifecycle trace id, and
        # every NEW ring entry (not a dedup merge — hot requeue loops
        # must not spam spans) lands as decision spans on that trace
        self.tracer = None

    def _now(self) -> float:
        if self._clock is not None:
            return self._clock.now()
        import time

        return time.time()

    def record(self, rec: DecisionRecord) -> DecisionRecord:
        if not isinstance(rec.reason, InadmissibleReason):
            raise ValueError(
                f"decision reason {rec.reason!r} is not a canonical "
                "InadmissibleReason — ad-hoc reason strings are not allowed"
            )
        tracer = self.tracer
        if tracer is not None and not rec.trace_id:
            rec.trace_id = tracer.workload_trace_id(rec.workload) or ""
        with self._lock:
            rec.timestamp = self._now()
            ring = self._records.get(rec.workload)
            if ring is None:
                ring = deque(maxlen=self.per_workload)
                self._records[rec.workload] = ring
            self._records.move_to_end(rec.workload)
            while len(self._records) > self.max_workloads:
                self._records.popitem(last=False)
            self.seq += 1
            if ring and ring[-1].dedup_key() == rec.dedup_key():
                latest = ring[-1]
                latest.count += 1
                latest.last_cycle = max(latest.last_cycle, rec.last_cycle)
                latest.timestamp = rec.timestamp
                latest.seq = self.seq
                stored = latest
            else:
                rec.seq = self.seq
                ring.append(rec)
                stored = rec
            self._stamp_log.append((self.seq, stored))
        for cb in list(self.observers):
            cb(rec)
        return stored

    def ingest(self, item: dict) -> None:
        """Replication ingest (storage/tailer.py): upsert one leader
        audit record verbatim — seq preserved, observers NOT notified
        (the metric mirror must count each decision once, on the
        leader). A repeat of the tail record's dedup key is the
        leader's count-merge restamp and replaces it in place."""
        rec = DecisionRecord.from_dict(item)
        with self._lock:
            if rec.seq <= self.seq:
                return  # overlap from a re-poll: already ingested
            self.seq = rec.seq
            ring = self._records.get(rec.workload)
            if ring is None:
                ring = deque(maxlen=self.per_workload)
                self._records[rec.workload] = ring
            self._records.move_to_end(rec.workload)
            while len(self._records) > self.max_workloads:
                self._records.popitem(last=False)
            if ring and ring[-1].dedup_key() == rec.dedup_key():
                ring[-1] = rec  # the leader's merged copy supersedes
            else:
                ring.append(rec)

    def since(self, seq: int, limit: int = 2048) -> List[dict]:
        """Wire dicts of every record stamped newer than ``seq``, in
        seq order (capped at ``limit``) — the replication feed's audit
        delta. O(delta) via the stamp log when the cursor is inside its
        window (every repeat poll); a record restamped several times in
        the window ships once, at its latest stamp."""
        with self._lock:
            log = self._stamp_log
            if not log or seq + 1 >= log[0][0]:
                # fast path: the log still covers everything after seq
                picked = []
                emitted = set()
                for stamp, rec in reversed(log):
                    if stamp <= seq:
                        break
                    # only a record's LATEST stamp represents it; older
                    # stamps of the same object are superseded merges
                    if rec.seq == stamp and id(rec) not in emitted:
                        emitted.add(id(rec))
                        picked.append(rec)
                picked.reverse()
                return [r.to_dict() for r in picked[:limit]]
            newer = [
                r
                for ring in self._records.values()
                for r in ring
                if r.seq > seq
            ]
        newer.sort(key=lambda r: r.seq)
        return [r.to_dict() for r in newer[:limit]]

    # ---- reads ----
    def for_workload(self, key: str) -> List[DecisionRecord]:
        with self._lock:
            return list(self._records.get(key, ()))

    def latest(self, key: str) -> Optional[DecisionRecord]:
        with self._lock:
            ring = self._records.get(key)
            return ring[-1] if ring else None

    def tail(self, n: int = 20) -> List[DecisionRecord]:
        """The n most recent records across all workloads, oldest
        first (last_cycle order) — the SIGUSR2 dump's view."""
        with self._lock:
            everything = [r for ring in self._records.values() for r in ring]
        everything.sort(key=lambda r: (r.last_cycle, r.workload))
        return everything[-n:]

    def forget(self, key: str) -> None:
        with self._lock:
            self._records.pop(key, None)

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._records)

    def __len__(self) -> int:
        with self._lock:
            return sum(len(ring) for ring in self._records.values())
