"""Closed span-name registry.

The same low-cardinality contract ``EVENT_REASONS`` and
``InadmissibleReason`` enforce on the event/audit surfaces applies to
spans: ``kueue_trace_spans_total{name=...}`` is labeled by span name,
so the set must stay closed. ``Tracer`` rejects names outside this
registry at the call site, and tests/test_tracing.py lints every
literal ``span("...")`` / ``add_cycle_span("...")`` in the source tree
against it — the reason-enum lint pattern applied to tracing.
"""

from __future__ import annotations

# workload lifecycle traces: one trace per workload, root opened at
# enqueue and closed at admission (or finish/delete). Children are
# point-in-time decision/transition spans; their durations live on the
# correlated cycle trace (the ``cycleTrace`` attr).
WORKLOAD_SPAN_NAMES = frozenset(
    {
        "workload.lifecycle",
        "workload.enqueue",
        "workload.nominate",
        "workload.flavor_assign",
        "workload.victim_search",
        "workload.quota_reserve",
        "workload.admission_check",
        "workload.admit",
        "workload.preempt",
        "workload.evict",
        "workload.requeue",
        "workload.quarantine",
        # MultiKueue federation hops on the same lifecycle trace: the
        # manager's dispatch fan-out, the winner pick, and every
        # sync-back observation of the winner's reservation
        "federation.dispatch",
        "federation.winner",
        "federation.sync_back",
        "federation.retract",
        # global scheduler (federation/global_scheduler.py): one span
        # per APPLIED rebalance, joining the federation hop spans on
        # the workload's lifecycle trace (from/to/fence/forecast gain)
        "global.rescore",
    }
)

# cycle span trees: one trace per scheduling cycle / drain round, the
# phase children carrying real durations (the CycleTrace spans lowered
# into parent/child structure).
CYCLE_SPAN_NAMES = frozenset(
    {
        "cycle",
        "cycle.heads",
        "cycle.snapshot",
        "cycle.nominate",
        "cycle.admit",
        "cycle.classify",
        "cycle.encode",
        "cycle.solve",
        "cycle.apply",
        "cycle.prefetch",
        "cycle.commit",
        "cycle.discard",
        "cycle.megaloop",
        "cycle.mesh_place",
        "cycle.divergence_check",
        "cycle.guard_failover",
        "cycle.journal_fsync",
    }
)

# replica tail spans (the read-replica's own apply work)
REPLICA_SPAN_NAMES = frozenset(
    {
        "replica.poll",
        "replica.apply",
    }
)

SPAN_NAMES = WORKLOAD_SPAN_NAMES | CYCLE_SPAN_NAMES | REPLICA_SPAN_NAMES

# CycleTrace phase key -> cycle span name (the lowering used by
# Tracer.record_cycle; a phase without a registry entry is a bug in
# the emitting site, same contract as classify_inadmissible_message)
CYCLE_PHASE_SPANS = {
    "heads": "cycle.heads",
    "snapshot": "cycle.snapshot",
    "nominate": "cycle.nominate",
    "admit": "cycle.admit",
    "classify": "cycle.classify",
    "encode": "cycle.encode",
    "solve": "cycle.solve",
    "apply": "cycle.apply",
    "prefetch": "cycle.prefetch",
    "commit": "cycle.commit",
}

# event reason -> workload lifecycle span (ClusterRuntime.event funnel;
# reasons not listed here do not produce spans)
EVENT_SPANS = {
    "QuotaReserved": "workload.quota_reserve",
    "Admitted": "workload.admit",
    "Evicted": "workload.evict",
    "Preempted": "workload.preempt",
    "Pending": "workload.requeue",
    "WorkloadQuarantined": "workload.quarantine",
}
