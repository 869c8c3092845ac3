"""Kubernetes-style Event pipeline — recorder, series dedup, watch.

Reference: the controller-runtime EventRecorder the Go controllers
emit through (record.EventRecorder; every admission/eviction/
preemption call site in pkg/scheduler and pkg/controller/core) plus
the apiserver watch semantics clients resume from: every recorded
event carries a monotonically increasing ``resourceVersion``, a
subscriber asks for "everything after N" and either gets it or a
too-old signal (the 410 Gone analog) when N has already fallen out of
the bounded history window.

The recorder is the single in-process event store:

- bounded ring (``ring_size``): the newest events in resourceVersion
  order — the watch/SSE resume window;
- per-object series dedup (the EventSeries/count aggregation of the
  reference recorder): a repeat of (kind, object, reason, message)
  bumps ``count``/``lastTimestamp`` and restamps the SAME event with a
  fresh resourceVersion instead of appending a duplicate, so a
  hot-looping requeue cannot flush real history out of the ring;
- a Condition-based ``wait()`` that parks watchers until something
  newer than their resourceVersion lands — the long-poll/SSE surface
  in server/app.py is a thin loop over it.

It also quacks like the plain ``List[Event]`` it replaced
(len/iter/indexing), so in-process consumers (dashboard payload,
tests asserting on ``runtime.events``) read it unchanged.
"""

from __future__ import annotations

import contextlib
import threading
import time as _time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple


@dataclass
class Event:
    """One recorded event. ``kind`` is the event reason ("Admitted",
    "Pending", "Preempted", ...) — the field name predates the
    recorder and is kept for the in-process consumers; the wire dict
    exposes it as ``reason`` with ``regarding`` carrying the object
    coordinates."""

    kind: str
    object_key: str
    message: str = ""
    regarding_kind: str = "Workload"
    count: int = 1
    first_timestamp: float = 0.0
    last_timestamp: float = 0.0
    resource_version: int = 0
    # distributed-tracing annotation (kueue_tpu_torch/tracing): the regarded
    # workload's lifecycle trace id — watch/SSE consumers can jump from
    # an event straight to its waterfall. Empty = untraced emitter.
    trace_id: str = ""

    def to_dict(self) -> dict:
        ns, _, name = self.object_key.rpartition("/")
        out = {
            "reason": self.kind,
            "object": self.object_key,
            "message": self.message,
            "regarding": {
                "kind": self.regarding_kind,
                "namespace": ns,
                "name": name,
            },
            "count": self.count,
            "firstTimestamp": self.first_timestamp,
            "lastTimestamp": self.last_timestamp,
            "resourceVersion": self.resource_version,
        }
        if self.trace_id:
            out["traceId"] = self.trace_id
        return out


class EventRecorder:
    def __init__(self, clock=None, ring_size: int = 1024):
        self._clock = clock
        self.ring_size = ring_size
        # ring is kept in resourceVersion order: a series dedup moves
        # the bumped event to the tail, so "events after N" is always a
        # suffix and trimming always drops the stalest series
        self._ring: List[Event] = []
        self._series: Dict[Tuple[str, str, str, str], Event] = {}
        self._rv = 0
        # highest resourceVersion ever trimmed out of the ring: a
        # resume below it has a gap the recorder can no longer fill
        self._evicted_rv = 0
        self._cond = threading.Condition()
        # wake coalescing (kueue_tpu_torch/gateway): while held > 0, records
        # mark pending instead of notifying — the coalesce() exit fires
        # ONE notify_all for the whole window. `wakes` counts actual
        # notify_all invocations (the exactly-once-per-flush test reads
        # it); waiters are condition-based re-checks with a bounded
        # wait, so a deferred wake can never lose an event.
        self._held = 0
        self._pending_wake = False
        self.wakes = 0

    def _notify_locked(self) -> None:  # kueuelint: holds=_cond
        if self._held > 0:
            self._pending_wake = True
            return
        self.wakes += 1
        self._cond.notify_all()

    @contextlib.contextmanager
    def coalesce(self):
        """Defer watcher wake-ups: everything recorded (or ingested)
        inside the context produces ONE notify_all at exit — the
        gateway wraps each flush window in this so N batched appends
        wake blocked watch/SSE waiters exactly once."""
        with self._cond:
            self._held += 1
        try:
            yield self
        finally:
            with self._cond:
                self._held -= 1
                if self._held == 0 and self._pending_wake:
                    self._pending_wake = False
                    self.wakes += 1
                    self._cond.notify_all()

    # ---- recording ----
    def _now(self) -> float:
        return self._clock.now() if self._clock is not None else _time.time()

    def record(
        self,
        kind: str,
        object_key: str,
        message: str = "",
        regarding_kind: str = "Workload",
        trace_id: str = "",
    ) -> Event:
        with self._cond:
            now = self._now()
            self._rv += 1
            key = (regarding_kind, object_key, kind, message)
            ev = self._series.get(key)
            if ev is not None:
                ev.count += 1
                ev.last_timestamp = now
                ev.resource_version = self._rv
                if trace_id:
                    ev.trace_id = trace_id
                self._ring.remove(ev)
                self._ring.append(ev)
            else:
                ev = Event(
                    kind=kind,
                    object_key=object_key,
                    message=message,
                    regarding_kind=regarding_kind,
                    first_timestamp=now,
                    last_timestamp=now,
                    resource_version=self._rv,
                    trace_id=trace_id,
                )
                self._ring.append(ev)
                self._series[key] = ev
                while len(self._ring) > self.ring_size:
                    old = self._ring.pop(0)
                    self._evicted_rv = max(
                        self._evicted_rv, old.resource_version
                    )
                    okey = (old.regarding_kind, old.object_key, old.kind,
                            old.message)
                    if self._series.get(okey) is old:
                        del self._series[okey]
            self._notify_locked()
            return ev

    def ingest(self, item: dict) -> Optional[Event]:
        """Replication ingest (storage/tailer.py): append a wire-format
        event EXACTLY as the leader stamped it — the resourceVersion is
        preserved, never re-issued, so a watcher that fails over from
        leader to replica (or back) resumes from the same version
        space. The feed is already series-deduped and rv-ordered on the
        leader; a repeat of a known series key here is the leader's
        count bump and restamps the same ring entry. Out-of-date items
        (rv <= the newest ingested) are dropped — re-polls overlap."""
        rv = int(item.get("resourceVersion", 0))
        with self._cond:
            if rv <= self._rv:
                return None
            self._rv = rv
            regarding = item.get("regarding") or {}
            key = (
                regarding.get("kind", "Workload"),
                item.get("object", ""),
                item.get("reason", ""),
                item.get("message", ""),
            )
            ev = self._series.get(key)
            if ev is not None:
                ev.count = int(item.get("count", ev.count + 1))
                ev.last_timestamp = float(item.get("lastTimestamp", 0.0))
                ev.resource_version = rv
                if item.get("traceId"):
                    ev.trace_id = item["traceId"]
                self._ring.remove(ev)
                self._ring.append(ev)
            else:
                ev = Event(
                    kind=item.get("reason", ""),
                    object_key=item.get("object", ""),
                    message=item.get("message", ""),
                    regarding_kind=regarding.get("kind", "Workload"),
                    count=int(item.get("count", 1)),
                    first_timestamp=float(item.get("firstTimestamp", 0.0)),
                    last_timestamp=float(item.get("lastTimestamp", 0.0)),
                    resource_version=rv,
                    trace_id=item.get("traceId", ""),
                )
                self._ring.append(ev)
                self._series[key] = ev
                while len(self._ring) > self.ring_size:
                    old = self._ring.pop(0)
                    self._evicted_rv = max(
                        self._evicted_rv, old.resource_version
                    )
                    okey = (old.regarding_kind, old.object_key, old.kind,
                            old.message)
                    if self._series.get(okey) is old:
                        del self._series[okey]
            self._notify_locked()
            return ev

    def kick(self) -> None:
        """Wake every parked watcher WITHOUT recording anything — the
        read-replica tail calls this after a poll applies records so
        blocked watch/SSE waiters re-evaluate immediately instead of
        rediscovering state at their next bounded-wait tick."""
        with self._cond:
            self._notify_locked()

    def note_gap(self, rv: int) -> None:
        """Replication gap marker: the upstream feed could not fill
        versions up to ``rv`` (the leader's ring already evicted them).
        Local watchers resumed below ``rv`` must relist — the same
        too-old signal a trimmed local ring produces."""
        with self._cond:
            if rv > self._evicted_rv:
                self._evicted_rv = rv
            if rv > self._rv:
                self._rv = rv
            self._notify_locked()

    # ---- read / watch ----
    @property
    def resource_version(self) -> int:
        """The latest stamped resourceVersion (0 = nothing recorded)."""
        return self._rv

    def _since_locked(
        self, rv: int, regarding_kind: Optional[str]
    ) -> List[dict]:
        out: List[dict] = []
        for ev in reversed(self._ring):
            if ev.resource_version <= rv:
                break
            if regarding_kind is None or ev.regarding_kind == regarding_kind:
                out.append(ev.to_dict())
        out.reverse()
        return out

    def since(
        self, rv: int = 0, regarding_kind: Optional[str] = None
    ) -> Tuple[List[dict], bool]:
        """Wire dicts of every event newer than ``rv`` (ascending), and
        whether ``rv`` predates the ring's history (resume gap — the
        client must relist instead of trusting the continuation)."""
        with self._cond:
            return self._since_locked(rv, regarding_kind), rv < self._evicted_rv

    def wait(
        self,
        rv: int,
        timeout: float,
        regarding_kind: Optional[str] = None,
        should_stop=None,
    ) -> Tuple[List[dict], int, bool]:
        """Long-poll primitive: block until events newer than ``rv``
        exist (or ``timeout`` elapses / ``should_stop()`` turns true).
        Returns (events, latest_rv, too_old)."""
        deadline = _time.monotonic() + timeout
        with self._cond:
            while True:
                too_old = rv < self._evicted_rv
                out = self._since_locked(rv, regarding_kind)
                remaining = deadline - _time.monotonic()
                if out or too_old or remaining <= 0 or (
                    should_stop is not None and should_stop()
                ):
                    return out, self._rv, too_old
                # bounded waits so should_stop is rechecked even when
                # no event ever lands (server shutdown mid-poll)
                self._cond.wait(min(remaining, 0.5))

    # ---- list emulation (the pre-recorder ``runtime.events`` shape) ----
    def __len__(self) -> int:
        with self._cond:
            return len(self._ring)

    def __iter__(self) -> Iterator[Event]:
        with self._cond:
            return iter(list(self._ring))

    def __getitem__(self, idx):
        with self._cond:
            return list(self._ring)[idx]

    def __bool__(self) -> bool:
        return len(self) > 0
