"""Chrome trace-event export — Perfetto/chrome://tracing loadable.

One span becomes one complete event (``"ph": "X"``) with microsecond
timestamps; open spans (lifecycle roots still waiting on admission)
become instant events (``"ph": "i"``). Spans are grouped into tracks:
pid 1 is the workload lifecycle, and each correlated cycle trace gets
its own tid so a waterfall shows the enqueue→admit arc above the
cycles that spent the time.
"""

from __future__ import annotations

from typing import Dict, List


def to_chrome_trace(spans: List[dict]) -> dict:
    """Spans (wire dicts, any mix of traces) -> a Chrome trace-event
    JSON object (``{"traceEvents": [...]}``) loadable in Perfetto."""
    if not spans:
        return {"traceEvents": []}
    t0 = min(s.get("start", 0.0) for s in spans)
    # one tid per trace id, workload lifecycle traces first
    tids: Dict[str, int] = {}

    def tid_of(trace_id: str) -> int:
        if trace_id not in tids:
            tids[trace_id] = len(tids) + 1
        return tids[trace_id]

    events = []
    for s in spans:
        ts_us = max(s.get("start", 0.0) - t0, 0.0) * 1e6
        args = {"traceId": s.get("traceId"), "spanId": s.get("spanId")}
        args.update(s.get("attrs") or {})
        base = {
            "name": s.get("name", ""),
            "pid": 1,
            "tid": tid_of(s.get("traceId", "")),
            "ts": round(ts_us, 3),
            "cat": (s.get("name", "") or ".").split(".")[0],
            "args": args,
        }
        dur_ms = s.get("durationMs")
        if dur_ms is None:
            base["ph"] = "i"
            base["s"] = "t"  # thread-scoped instant
        else:
            base["ph"] = "X"
            base["dur"] = round(float(dur_ms) * 1e3, 3)
        events.append(base)
    events.sort(key=lambda e: (e["tid"], e["ts"]))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
    }
