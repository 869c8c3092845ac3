"""End-to-end distributed tracing for the control plane.

``Tracer`` (tracer.py) records two correlated span families — workload
lifecycle traces (enqueue → nominate → flavor-assign → victim-search →
quota-reserve → admit/preempt/requeue) and per-cycle span trees
(snapshot/encode/solve/apply plus pipeline, guard and journal spans) —
into a bounded in-memory store served at ``GET /debug/traces`` and
replicated to read replicas over the journal feed. Context propagates
W3C-traceparent-style: as an HTTP header on client requests and as the
``kueue.x-k8s.io/traceparent`` workload label across MultiKueue
dispatch, so one trace id follows a workload from the manager through
the winning worker's admission cycle onto a tailing replica.
"""

from kueue_tpu_torch.tracing.names import (
    CYCLE_PHASE_SPANS,
    CYCLE_SPAN_NAMES,
    EVENT_SPANS,
    SPAN_NAMES,
    WORKLOAD_SPAN_NAMES,
)
from kueue_tpu_torch.tracing.tracer import (
    TRACEPARENT_LABEL,
    Span,
    Tracer,
    format_traceparent,
    parse_traceparent,
)
from kueue_tpu_torch.tracing.export import to_chrome_trace

__all__ = [
    "CYCLE_PHASE_SPANS",
    "CYCLE_SPAN_NAMES",
    "EVENT_SPANS",
    "SPAN_NAMES",
    "WORKLOAD_SPAN_NAMES",
    "TRACEPARENT_LABEL",
    "Span",
    "Tracer",
    "format_traceparent",
    "parse_traceparent",
    "to_chrome_trace",
    "lifecycle_spans",
    "workload_trace_payload",
]


def lifecycle_spans(rt, key: str):
    """(trace_id, spans) — the workload's lifecycle trace as wire
    dicts. Only the ROOT (and federation hops) are stored; enqueue,
    decision and transition children are synthesized here from the
    audit ring and event ring, which already carry the trace id, a
    timestamp and the full rationale — the hot admission path pays for
    none of this. Synthesized span ids derive from the source record's
    replicated stamp (audit ``seq`` / event ``resourceVersion``), so a
    replica's payload is identical to the leader's."""
    tracer = getattr(rt, "tracer", None)
    if tracer is None:
        return None, []
    tid = tracer.workload_trace_id(key)
    if tid is None:
        # the trace may have been LRU-evicted; the audit trail still
        # names the id (stamped on every DecisionRecord)
        audit = getattr(rt, "audit", None)
        latest = audit.latest(key) if audit is not None else None
        tid = getattr(latest, "trace_id", "") or None
    if tid is None:
        return None, []
    spans = [s.to_dict() for s in tracer.trace(tid)]
    root = next(
        (s for s in spans if s.get("name") == "workload.lifecycle"), None
    )
    root_id = root["spanId"] if root is not None else None
    if root is not None:
        spans.append(
            {
                "traceId": tid,
                "spanId": f"enq{root_id[:13]}",
                "parentId": root_id,
                "name": "workload.enqueue",
                "start": root["start"],
                "durationMs": 0.0,
                "seq": root.get("seq", 0),
                "attrs": {"workload": key},
            }
        )
    audit = getattr(rt, "audit", None)
    if audit is not None:
        for rec in audit.for_workload(key):
            if rec.trace_id != tid:
                continue  # a previous incarnation's trace
            attrs = {
                "cycle": rec.cycle,
                "outcome": rec.outcome,
                "reason": rec.reason.value,
                "clusterQueue": rec.cluster_queue,
            }
            if rec.count > 1:
                attrs["count"] = rec.count
            linked = tracer.cycle_trace_id(rec.last_cycle)
            if linked is not None:
                attrs["cycleTrace"] = linked
            names = ["workload.nominate"]
            if rec.flavors or rec.flavor_reasons:
                names.append("workload.flavor_assign")
            if rec.preemption is not None:
                names.append("workload.victim_search")
            for i, name in enumerate(names):
                spans.append(
                    {
                        "traceId": tid,
                        "spanId": f"d{rec.seq:014x}{i:x}",
                        "parentId": root_id,
                        "name": name,
                        "start": rec.timestamp,
                        "durationMs": 0.0,
                        "seq": rec.seq,
                        "attrs": attrs,
                    }
                )
    events = getattr(rt, "events", None)
    if events is not None:
        for ev in list(events):
            if getattr(ev, "object_key", None) != key:
                continue
            if getattr(ev, "trace_id", "") != tid:
                continue
            name = EVENT_SPANS.get(ev.kind)
            if name is None:
                continue
            attrs = {"event": ev.kind}
            if ev.count > 1:
                attrs["count"] = ev.count
            spans.append(
                {
                    "traceId": tid,
                    "spanId": f"e{ev.resource_version:015x}",
                    "parentId": root_id,
                    "name": name,
                    "start": ev.first_timestamp,
                    "durationMs": 0.0,
                    "seq": ev.resource_version,
                    "attrs": attrs,
                }
            )
    return tid, spans


def workload_trace_payload(rt, key: str) -> dict:
    """The ``kueuectl trace`` / ``GET /debug/workloads/.../trace``
    payload: the workload's lifecycle spans PLUS every cycle trace its
    decision spans reference, assembled server-side so one response
    renders the full waterfall. Shared by the HTTP handler and the
    CLI's offline state-replay mode."""
    tracer = getattr(rt, "tracer", None)
    tid, spans = lifecycle_spans(rt, key)
    seen = {tid}
    for s in list(spans):
        linked = (s.get("attrs") or {}).get("cycleTrace")
        if linked and linked not in seen:
            seen.add(linked)
            spans.extend(x.to_dict() for x in tracer.trace(linked))
    return {"workload": key, "traceId": tid, "spans": spans}
