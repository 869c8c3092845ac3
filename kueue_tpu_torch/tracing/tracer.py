"""Clock-injected, always-on span store — the distributed-tracing spine.

Two correlated trace families live here:

- **workload lifecycle traces** — one trace per workload, the root
  span opened at enqueue and closed at admission (or finish/delete),
  with point-in-time children for every NEW decision the audit trail
  records and every lifecycle event the runtime emits. The trace id is
  stamped into ``DecisionRecord``s and event annotations, so
  ``kueuectl explain``, the journal feed and read replicas all render
  the same causality.
- **cycle span trees** — one trace per scheduling cycle / drain round:
  the root ``cycle`` span plus phase children (snapshot/encode/solve/
  apply, pipeline prefetch/commit/discard, divergence checks, journal
  fsyncs) carrying real measured durations. Decision spans reference
  their cycle trace through the ``cycleTrace`` attr, which is how "900
  ms between enqueue and admit" decomposes into the cycles that spent
  it.

Crash discipline: cycle spans are BUFFERED per cycle
(``next_cycle``/``add_cycle_span``) and flushed atomically by
``record_cycle`` — a cycle that dies mid-flight (contained failure or
InjectedCrash at any fault point, including ``cycle.commit_pre_apply``)
drops its buffer whole, so the store can never hold a half-open cycle
span. Lifecycle roots are the only open-by-design spans.

Replication: every stored/updated span is stamped with a monotone
``seq`` (the EventRecorder-resourceVersion pattern); ``since(seq)``
ships the delta on the leader's journal feed and ``ingest`` upserts it
on a replica, preserving trace/span ids so a waterfall rendered on the
replica is the leader's.

Overhead contract: always-on must stay under 2 % of cycle time
(``bench.py --trace``). The hot path STORES almost nothing per
workload: decision and lifecycle-event spans are synthesized at read
time from the audit ring and event ring (which already carry the trace
id and a timestamp — storing them twice would double the cost of every
admission), so a workload costs one root span at enqueue, a restamp at
admission, and O(1) dict stamps in between. Metric mirrors are batched
(``_flush_counts_locked``) because a per-span registry inc costs more
than the span itself. The store is LRU-bounded so a 50k drain keeps
the newest ``max_traces`` traces, not all 50k.
"""

from __future__ import annotations

import itertools as _itertools
import os
import threading
import time as _time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

from kueue_tpu_torch.tracing.names import CYCLE_PHASE_SPANS, SPAN_NAMES

#: workload label carrying the W3C traceparent across control planes
#: (the MultiKueue dispatcher stamps it on mirrored copies; a worker's
#: runtime adopts the trace id instead of opening a fresh one)
TRACEPARENT_LABEL = "kueue.x-k8s.io/traceparent"


def format_traceparent(trace_id: str, span_id: str) -> str:
    """W3C trace-context header value (version 00, sampled)."""
    return f"00-{trace_id}-{span_id}-01"


def parse_traceparent(value: Optional[str]) -> Optional[Tuple[str, str]]:
    """(trace_id, parent_span_id) from a traceparent header/label, or
    None when absent/malformed — propagation is best-effort, a corrupt
    header must never fail the request carrying it."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) < 4:
        return None
    _, trace_id, span_id = parts[0], parts[1], parts[2]
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if int(trace_id, 16) == 0:
        return None
    return trace_id, span_id


@dataclass(slots=True)
class Span:
    """One span. ``start`` is wall-clock (the tracer's injected clock)
    so spans from different processes align on one waterfall;
    ``duration`` is measured with perf_counter by the recording site.
    ``duration < 0`` means the span is still open (lifecycle roots)."""

    trace_id: str
    span_id: str
    parent_id: Optional[str]
    name: str
    start: float
    duration: float = -1.0
    attrs: Dict[str, object] = field(default_factory=dict)
    seq: int = 0

    @property
    def ended(self) -> bool:
        return self.duration >= 0

    def to_dict(self) -> dict:
        out = {
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentId": self.parent_id,
            "name": self.name,
            "start": self.start,
            "durationMs": (
                round(self.duration * 1e3, 6) if self.ended else None
            ),
            "seq": self.seq,
        }
        if self.attrs:
            out["attrs"] = self.attrs
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        dur_ms = d.get("durationMs")
        return cls(
            trace_id=d["traceId"],
            span_id=d["spanId"],
            parent_id=d.get("parentId"),
            name=d.get("name", ""),
            start=float(d.get("start", 0.0)),
            duration=(float(dur_ms) / 1e3 if dur_ms is not None else -1.0),
            attrs=d.get("attrs") or {},
            seq=int(d.get("seq", 0)),
        )


class Tracer:
    """Bounded in-memory trace store + the recording API.

    Thread-safe: the scheduler writes under the server lock, but the
    journal-feed reader, debug routes and replica ingest may race it.
    ``enabled=False`` turns every recording call into a no-op (the
    ``bench.py --trace`` baseline); ``passive=True`` keeps ingest and
    reads working while local recording no-ops (read replicas render
    the LEADER's spans, never their own)."""

    def __init__(
        self,
        clock=None,
        metrics=None,
        max_traces: int = 4096,
        enabled: bool = True,
    ):
        self._clock = clock
        self.metrics = metrics
        self.max_traces = max_traces
        self.enabled = enabled
        self.passive = False
        # trace id -> spans in record order (LRU-bounded on traces)
        self._traces: "OrderedDict[str, List[Span]]" = OrderedDict()  # guarded by: _lock
        # workload key -> lifecycle trace id (writes locked; the event/
        # audit hot path does GIL-atomic lock-free dict READS — see
        # workload_trace_id)
        self._workload: Dict[str, str] = {}  # guarded by: _lock
        # workload key -> open lifecycle root (for close-on-admit)
        self._roots: Dict[str, Span] = {}  # guarded by: _lock
        self._lock = threading.Lock()
        # replication stamp (the audit-log seq pattern): every stored
        # or updated span restamps; since() ships each span once at its
        # latest stamp
        self.seq = 0  # guarded by: _lock
        self._stamp_log: Deque = deque(maxlen=8192)  # guarded by: _lock
        # id generation: process-unique prefix + counter — cheap, and
        # unique across the processes of one deployment (pid+random).
        # itertools.count.__next__ is C-atomic under the GIL, so id
        # generation never needs _lock even though recording sites
        # call it both inside and outside the locked region (a plain
        # `self._n += 1` here raced scheduler vs request threads into
        # duplicate span ids)
        self._id_prefix = f"{os.getpid() & 0xFFFF:04x}{int.from_bytes(os.urandom(4), 'big'):08x}"
        self._ids = iter(_itertools.count(1))
        # the in-flight cycle: (trace_id, root_span_id, cycle, buffer)
        # — children buffered here flush atomically in record_cycle
        self._cycle: Optional[Tuple[str, str, int, List[Span]]] = None
        # the most recently FLUSHED cycle trace id: the scheduler's
        # audit pass runs just after the flush and still references it
        self._last_cycle_tid: Optional[str] = None  # guarded by: _lock
        # batched kueue_trace_spans_total mirror: a per-span registry
        # inc costs more than the span itself (label-key hashing), so
        # counts accumulate here and flush per cycle / per read — the
        # hot path pays one dict bump per span, the scrape surface lags
        # by at most one cycle
        self._pending_counts: Dict[str, int] = {}  # guarded by: _lock
        self._pending_n = 0  # guarded by: _lock
        # exact self-accounting: wall seconds spent inside the tracer's
        # recording entry points (the guard.divergence_check_s pattern)
        # — bench.py --trace asserts the <2% overhead budget on THIS,
        # which a noisy shared-CPU host cannot corrupt the way a wall
        # A/B can
        self.self_time_s = 0.0
        # batched queue-to-admission waits (cq -> [seconds]), same
        # rationale: one histogram label resolution per flush, not per
        # admitted workload
        self._pending_waits: Dict[str, List[float]] = {}  # guarded by: _lock
        # scheduling-cycle number -> cycle trace id (bounded): the
        # read-time synthesis of decision spans correlates an audit
        # record's cycle with its span tree through this index
        self._cycle_index: "OrderedDict[int, str]" = OrderedDict()  # guarded by: _lock

    # ---- clock / ids ----
    def now(self) -> float:
        return self._clock.now() if self._clock is not None else _time.time()

    def _next_id(self, width: int = 16) -> str:
        """Hex id: process-entropy prefix + monotone counter, so ids
        never collide across the processes sharing one trace (manager /
        worker / replica) — nor across this process's threads (the
        counter is a GIL-atomic itertools.count, callable with or
        without _lock held)."""
        n = next(self._ids)
        ent = width - 10 if width > 10 else 0
        return self._id_prefix[:ent] + f"{n:x}".rjust(width - ent, "0")

    def new_trace_id(self) -> str:
        return self._id_prefix + f"{next(self._ids):x}".rjust(20, "0")

    # ---- storage primitives ----
    def _check_name(self, name: str) -> None:
        if name not in SPAN_NAMES:
            raise ValueError(
                f"span name {name!r} is not in the closed registry "
                "(kueue_tpu_torch.tracing.names.SPAN_NAMES) — ad-hoc span "
                "names are not allowed"
            )

    def _store(self, span: Span) -> Span:  # kueuelint: holds=_lock
        """Stamp + append one span (lock held by caller)."""
        self.seq += 1
        span.seq = self.seq
        ring = self._traces.get(span.trace_id)
        if ring is None:
            ring = []
            self._traces[span.trace_id] = ring
            self._traces.move_to_end(span.trace_id)
            while len(self._traces) > self.max_traces:
                gone_id, gone = self._traces.popitem(last=False)
                for s in gone:
                    key = s.attrs.get("workload")
                    if key is not None and self._workload.get(key) == gone_id:
                        del self._workload[key]
                        self._roots.pop(key, None)
        ring.append(span)
        self._stamp_log.append((self.seq, span))
        if self.metrics is not None:
            name = span.name
            self._pending_counts[name] = self._pending_counts.get(name, 0) + 1
            self._pending_n += 1
            if self._pending_n >= 1024:
                self._flush_counts_locked()
        return span

    def _flush_counts_locked(self) -> None:
        """Push the batched span-name counts + admission waits into
        the registry (lock held by caller)."""
        self._pending_n = 0
        if self.metrics is None:
            return
        if self._pending_counts:
            counter = self.metrics.trace_spans_total
            for name, n in self._pending_counts.items():
                counter.inc(n, name=name)
            self._pending_counts.clear()
        if self._pending_waits:
            hist = self.metrics.trace_queue_to_admission_seconds
            for cq, waits in self._pending_waits.items():
                hist.observe_many(waits, cluster_queue=cq)
            self._pending_waits.clear()

    def flush_metrics(self) -> None:
        with self._lock:
            self._flush_counts_locked()

    def _restamp(self, span: Span) -> None:  # kueuelint: holds=_lock
        self.seq += 1
        span.seq = self.seq
        self._stamp_log.append((self.seq, span))

    def record_span(
        self,
        name: str,
        trace_id: str,
        parent_id: Optional[str],
        start: Optional[float] = None,
        duration: float = 0.0,
        attrs: Optional[dict] = None,
    ) -> Optional[Span]:
        """Record one COMPLETED span (retroactive recording — the
        drain/cycle paths measure with perf_counter and lower the
        result here, so a crash mid-measurement stores nothing)."""
        if not self.enabled or self.passive:
            return None
        self._check_name(name)
        if start is None:
            start = self.now() - max(duration, 0.0)
        span = Span(
            trace_id=trace_id,
            span_id=self._next_id(16),
            parent_id=parent_id,
            name=name,
            start=start,
            duration=max(duration, 0.0),
            attrs=dict(attrs) if attrs else {},
        )
        with self._lock:
            return self._store(span)

    # ---- workload lifecycle traces ----
    def begin_workload(
        self, key: str, traceparent: Optional[str] = None
    ) -> Optional[str]:
        """Open (or join) the lifecycle trace for ``key``. Idempotent:
        a workload already holding a live trace keeps it. With a
        ``traceparent`` (federation dispatch / HTTP apply), the root
        JOINS the propagated trace id instead of minting one — the one
        trace then spans manager, worker and replica."""
        if not self.enabled or self.passive:
            return None
        t0 = _time.perf_counter()
        try:
            return self._begin_workload(key, traceparent)
        finally:
            self.self_time_s += _time.perf_counter() - t0

    def _begin_workload(
        self, key: str, traceparent: Optional[str]
    ) -> Optional[str]:
        parent = parse_traceparent(traceparent)
        with self._lock:
            tid = self._workload.get(key)
            if tid is not None and tid in self._traces:
                return tid
            parent_span = None
            if parent is not None:
                tid, parent_span = parent
            else:
                tid = self.new_trace_id()
            now = self.now()
            # the root is the ONLY stored lifecycle span: enqueue,
            # decision and transition children are synthesized at read
            # time from the audit/event rings (see lifecycle_spans in
            # tracing/__init__) — the hot path must not pay for them
            root = Span(
                trace_id=tid,
                span_id=self._next_id(16),
                parent_id=parent_span,
                name="workload.lifecycle",
                start=now,
                duration=-1.0,
                attrs={"workload": key},
            )
            self._workload[key] = tid
            self._roots[key] = root
            self._store(root)
            return tid

    def workload_trace_id(self, key: str) -> Optional[str]:
        # lock-free read: both dicts mutate only under the lock and
        # dict.get is atomic under the GIL — this sits on the event and
        # audit hot paths, where a lock round trip per call would be
        # the tracer's single biggest cost
        tid = self._workload.get(key)
        return tid if tid is not None and tid in self._traces else None

    def workload_root(self, key: str) -> Optional[Span]:
        with self._lock:
            return self._roots.get(key)

    def _add_workload_spans_locked(
        self, key: str, items, now: float
    ) -> Optional[Span]:
        """Store (name, attrs, duration) children on the workload's
        lifecycle trace under the already-held lock. Returns the last
        stored span (None for workloads without a live trace)."""
        tid = self._workload.get(key)
        if tid is None or tid not in self._traces:
            return None
        root = self._roots.get(key)
        parent = root.span_id if root is not None else None
        last = None
        for name, attrs, duration in items:
            last = self._store(
                Span(
                    trace_id=tid,
                    span_id=self._next_id(16),
                    parent_id=parent,
                    name=name,
                    start=now,
                    duration=max(duration, 0.0),
                    attrs=attrs,
                )
            )
        return last

    def add_workload_span(
        self, name: str, key: str, attrs: Optional[dict] = None,
        duration: float = 0.0,
    ) -> Optional[Span]:
        """One point-in-time child on the workload's lifecycle trace
        (no-op for workloads without a live trace)."""
        if not self.enabled or self.passive:
            return None
        t0 = _time.perf_counter()
        try:
            self._check_name(name)
            with self._lock:
                return self._add_workload_spans_locked(
                    key, ((name, dict(attrs) if attrs else {}, duration),),
                    self.now(),
                )
        finally:
            self.self_time_s += _time.perf_counter() - t0

    def note_event(self, kind: str, key: str, count: int, cq: str = "") -> None:
        """Event-funnel hook. Lifecycle-event spans are NOT stored —
        the event ring already carries the trace id and timestamps and
        is synthesized into spans at read time; the only hot-path work
        left is closing the root on admission."""
        if kind == "Admitted" and count == 1:
            self.end_workload(key, status="Admitted", cq=cq)

    def end_workload(self, key: str, status: str = "", cq: str = "") -> None:
        """Close the lifecycle root (admission, finish or delete).
        Admission observes ``kueue_trace_queue_to_admission_seconds``."""
        if not self.enabled or self.passive:
            return
        t0 = _time.perf_counter()
        try:
            self._end_workload(key, status, cq)
        finally:
            self.self_time_s += _time.perf_counter() - t0

    def _end_workload(self, key: str, status: str, cq: str) -> None:
        with self._lock:
            # the root stays in _roots after closing: federation spans
            # recorded post-admit still parent to it
            root = self._roots.get(key)
            if root is None or root.ended:
                return
            root.duration = max(self.now() - root.start, 0.0)
            if status:
                root.attrs["status"] = status
            self._restamp(root)
            if status == "Admitted" and self.metrics is not None:
                # batched: one histogram label resolution per flush
                self._pending_waits.setdefault(cq, []).append(root.duration)

    def forget_workload(self, key: str) -> None:
        """Workload deleted: close its root (history stays readable
        until the trace LRU forgets it, the audit-ring contract)."""
        self.end_workload(key, status="Deleted")
        with self._lock:
            self._workload.pop(key, None)
            self._roots.pop(key, None)

    # ---- cycle span trees ----
    def next_cycle(self, cycle: int) -> Optional[Tuple[str, str]]:
        """Open the buffer for one scheduling cycle / drain round and
        pre-allocate its (trace_id, root_span_id) so mid-cycle spans
        (divergence checks, fsyncs, failovers) and decision records can
        reference the tree before it is flushed. An unflushed previous
        buffer (crashed cycle) is discarded whole — no orphans."""
        if not self.enabled or self.passive:
            self._cycle = None
            return None
        t0 = _time.perf_counter()
        self._cycle = (self.new_trace_id(), self._next_id(16), cycle, [])
        self.self_time_s += _time.perf_counter() - t0
        return self._cycle[0], self._cycle[1]

    def cycle_trace_id(self, cycle: int) -> Optional[str]:
        """The span-tree id of scheduling cycle ``cycle`` (None once
        the bounded index forgets it). Populated by record_cycle on the
        plane that ran the cycle and by ingest on replicas."""
        with self._lock:
            return self._cycle_index.get(cycle)

    def current_cycle_trace_id(self, include_last: bool = True) -> Optional[str]:
        """The in-flight cycle's trace id, falling back (by default) to
        the most recently flushed one — decision records written in the
        post-flush audit pass still belong to that cycle."""
        c = self._cycle
        if c is not None:
            return c[0]
        return self._last_cycle_tid if include_last else None

    def add_cycle_span(
        self, name: str, duration: float = 0.0,
        attrs: Optional[dict] = None,
    ) -> None:
        """Buffer one completed child under the in-flight cycle root
        (flushed by record_cycle; dropped whole on a crashed cycle)."""
        if not self.enabled or self.passive or self._cycle is None:
            return
        self._check_name(name)
        tid, root_id, _cycle, buf = self._cycle
        buf.append(
            Span(
                trace_id=tid,
                span_id=self._next_id(16),
                parent_id=root_id,
                name=name,
                start=self.now() - max(duration, 0.0),
                duration=max(duration, 0.0),
                attrs=dict(attrs) if attrs else {},
            )
        )

    def record_cycle(self, trace) -> Optional[str]:
        """Flush the in-flight cycle buffer + the phase children lowered
        from a completed CycleTrace as ONE atomic span tree. Returns the
        trace id (also stamped onto ``trace.trace_id``)."""
        if not self.enabled or self.passive:
            return None
        t0 = _time.perf_counter()
        try:
            return self._record_cycle(trace)
        finally:
            self.self_time_s += _time.perf_counter() - t0

    def _record_cycle(self, trace) -> Optional[str]:
        c = self._cycle
        self._cycle = None
        if c is None:
            return None
        tid, root_id, cycle, buf = c
        now = self.now()
        root = Span(
            trace_id=tid,
            span_id=root_id,
            parent_id=None,
            name="cycle",
            start=now - max(trace.total_s, 0.0),
            duration=max(trace.total_s, 0.0),
            attrs={
                "cycle": cycle,
                "resolution": trace.resolution,
                "heads": trace.heads,
                "admitted": trace.admitted,
                "preempting": trace.preempting,
                "mesh": trace.mesh,
            },
        )
        with self._lock:
            self._store(root)
            # phase children in CycleTrace order, laid end-to-start so
            # the waterfall reads like the cycle executed
            offset = root.start
            for phase, seconds in trace.spans.items():
                name = CYCLE_PHASE_SPANS.get(phase)
                if name is None:
                    raise ValueError(
                        f"cycle phase {phase!r} has no span mapping "
                        "(tracing/names.CYCLE_PHASE_SPANS)"
                    )
                self._store(
                    Span(
                        trace_id=tid,
                        span_id=self._next_id(16),
                        parent_id=root_id,
                        name=name,
                        start=offset,
                        duration=max(seconds, 0.0),
                        attrs={"cycle": cycle},
                    )
                )
                offset += max(seconds, 0.0)
            for span in buf:
                self._store(span)
            self._cycle_index[cycle] = tid
            while len(self._cycle_index) > 8192:
                self._cycle_index.popitem(last=False)
            self._flush_counts_locked()
            self._last_cycle_tid = tid
        if trace is not None:
            trace.trace_id = tid
        return tid

    def discard_cycle(self) -> None:
        """Drop the in-flight buffer (contained cycle failure where no
        CycleTrace will be recorded)."""
        self._cycle = None

    # ---- replication (the journal-feed delta) ----
    def since(self, seq: int, limit: int = 4096) -> List[dict]:
        """Wire dicts of every span stamped newer than ``seq``, in seq
        order — each span once, at its latest stamp (a root closed
        after shipping open re-ships with its duration)."""
        with self._lock:
            self._flush_counts_locked()
            log = self._stamp_log
            if log and seq + 1 < log[0][0]:
                # cursor fell out of the stamp window: full scan
                newer = [
                    s
                    for ring in self._traces.values()
                    for s in ring
                    if s.seq > seq
                ]
                newer.sort(key=lambda s: s.seq)
                return [s.to_dict() for s in newer[:limit]]
            picked = []
            emitted = set()
            for stamp, span in reversed(log):
                if stamp <= seq:
                    break
                if span.seq == stamp and id(span) not in emitted:
                    emitted.add(id(span))
                    picked.append(span)
            picked.reverse()
            return [s.to_dict() for s in picked[:limit]]

    def ingest(self, item: dict) -> None:
        """Replica ingest: upsert one leader span verbatim (ids and seq
        preserved). A re-shipped span (root restamped at close) replaces
        its earlier copy in place."""
        try:
            span = Span.from_dict(item)
        except (KeyError, TypeError, ValueError):
            return  # malformed span must never kill the tail loop
        with self._lock:
            if span.seq > self.seq:
                self.seq = span.seq
            ring = self._traces.get(span.trace_id)
            if ring is None:
                ring = []
                self._traces[span.trace_id] = ring
            self._traces.move_to_end(span.trace_id)
            for i, existing in enumerate(ring):
                if existing.span_id == span.span_id:
                    ring[i] = span
                    break
            else:
                ring.append(span)
            while len(self._traces) > self.max_traces:
                gone_id, gone = self._traces.popitem(last=False)
                for s in gone:
                    key = s.attrs.get("workload")
                    if key is not None and self._workload.get(key) == gone_id:
                        del self._workload[key]
                        self._roots.pop(key, None)
            if span.name == "workload.lifecycle":
                key = span.attrs.get("workload")
                if key:
                    self._workload[key] = span.trace_id
            elif span.name == "cycle":
                cycle = span.attrs.get("cycle")
                if cycle is not None:
                    self._cycle_index[int(cycle)] = span.trace_id
                    while len(self._cycle_index) > 8192:
                        self._cycle_index.popitem(last=False)

    # ---- reads ----
    def trace(self, trace_id: str) -> List[Span]:
        with self._lock:
            return list(self._traces.get(trace_id, ()))

    def traces_summary(self, limit: int = 64) -> List[dict]:
        """Newest traces first: id, root name, span count, duration."""
        with self._lock:
            items = list(self._traces.items())[-limit:]
        out = []
        for tid, spans in reversed(items):
            root = next((s for s in spans if s.parent_id is None), None)
            out.append(
                {
                    "traceId": tid,
                    "root": root.name if root is not None else "",
                    "spans": len(spans),
                    "start": root.start if root is not None else 0.0,
                    "durationMs": (
                        round(root.duration * 1e3, 3)
                        if root is not None and root.ended
                        else None
                    ),
                    "attrs": root.attrs if root is not None else {},
                }
            )
        return out

    def open_spans(self, prefix: str = "") -> List[Span]:
        """Spans not yet closed (lifecycle roots are open by design;
        anything ``cycle.``-prefixed here is a leak — the chaos suite
        asserts this stays empty across crash/recovery)."""
        with self._lock:
            return [
                s
                for ring in self._traces.values()
                for s in ring
                if not s.ended and s.name.startswith(prefix)
            ]

    def stats(self) -> dict:
        with self._lock:
            self._flush_counts_locked()
            n_spans = sum(len(r) for r in self._traces.values())
            return {
                "traces": len(self._traces),
                "spans": n_spans,
                "openSpans": sum(
                    1
                    for ring in self._traces.values()
                    for s in ring
                    if not s.ended
                ),
                "seq": self.seq,
                "enabled": self.enabled,
                "passive": self.passive,
                "selfTimeS": round(self.self_time_s, 6),
            }

    def __len__(self) -> int:
        with self._lock:
            return sum(len(r) for r in self._traces.values())
