"""The Kueue metric set (pkg/metrics/metrics.go:70-380).

Every metric keeps the reference's name (namespace ``kueue``), labels
and type, so dashboards/alerts written against the Go implementation
read identically. LocalQueue variants are emitted only when the
LocalQueueMetrics feature gate is on (:115-331).
"""

from __future__ import annotations

from typing import Optional

from kueue_tpu_torch import features
from kueue_tpu_torch.metrics.registry import Registry

NS = "kueue"

# admission_attempt_duration_seconds exponential buckets (metrics.go:88)
ATTEMPT_BUCKETS = tuple(0.0001 * (10 ** i) for i in range(8))


class Metrics:
    def __init__(self, registry: Optional[Registry] = None):
        r = registry or Registry()
        self.registry = r

        self.admission_attempts_total = r.counter(
            f"{NS}_admission_attempts_total",
            "Total number of attempts to admit workloads, label 'result' is success or inadmissible",
            ("result",),
        )
        self.admission_attempt_duration_seconds = r.histogram(
            f"{NS}_admission_attempt_duration_seconds",
            "Latency of an admission attempt",
            ("result",),
            buckets=ATTEMPT_BUCKETS,
        )
        self.admission_cycle_phase_duration_seconds = r.histogram(
            f"{NS}_admission_cycle_phase_duration_seconds",
            "Per-phase latency of a scheduling cycle (snapshot|nominate|admit)",
            ("phase",),
            buckets=ATTEMPT_BUCKETS,
        )
        # event-stream mirror: every EventRecorder.record() increments
        # this, so scrape-based alerting sees the same story the
        # watch/SSE stream tells (kind = object kind, reason = event
        # reason: Admitted, Pending, Evicted, Preempted, ...)
        self.events_total = r.counter(
            f"{NS}_events_total",
            "Total number of recorded events per object kind and reason",
            ("kind", "reason"),
        )
        # per-cycle trace mirror (CycleTrace): counts/latency by which
        # conflict-resolution path ran (host | device | drain)
        self.cycle_total = r.counter(
            f"{NS}_cycle_total",
            "Total number of scheduling cycles per resolution path",
            ("resolution",),
        )
        self.cycle_duration_seconds = r.histogram(
            f"{NS}_cycle_duration_seconds",
            "Wall-clock latency of a scheduling cycle per resolution path",
            ("resolution",),
            buckets=ATTEMPT_BUCKETS,
        )
        self.cycle_device_seconds = r.histogram(
            f"{NS}_cycle_device_seconds",
            "Time a scheduling cycle spent inside device dispatches",
            ("resolution",),
            buckets=ATTEMPT_BUCKETS,
        )
        self.cycle_last_heads = r.gauge(
            f"{NS}_cycle_last_heads",
            "Head count of the most recent scheduling cycle",
        )
        self.cycle_last_admitted = r.gauge(
            f"{NS}_cycle_last_admitted",
            "Admissions in the most recent scheduling cycle",
        )
        self.admission_cycle_preemption_skips = r.gauge(
            f"{NS}_admission_cycle_preemption_skips",
            "Number of workloads whose preemption was skipped in the last cycle",
            ("cluster_queue",),
        )
        self.pending_workloads = r.gauge(
            f"{NS}_pending_workloads",
            "Number of pending workloads, per cluster_queue and status (active|inadmissible)",
            ("cluster_queue", "status"),
        )
        # "why pending" scrape surface: one series per (cq, canonical
        # reason), fed by the decision audit trail (core/audit.py). The
        # reason label is a member of InadmissibleReason — a closed
        # enum — so cardinality stays bounded
        self.inadmissible_reason_total = r.counter(
            f"{NS}_inadmissible_reason_total",
            "Total inadmissible admission decisions per cluster_queue and canonical reason",
            ("cluster_queue", "reason"),
        )
        self.quota_reserved_workloads_total = r.counter(
            f"{NS}_quota_reserved_workloads_total",
            "Total number of quota reserved workloads per cluster_queue",
            ("cluster_queue",),
        )
        self.quota_reserved_wait_time_seconds = r.histogram(
            f"{NS}_quota_reserved_wait_time_seconds",
            "Time between workload creation and quota reservation",
            ("cluster_queue",),
        )
        self.admitted_workloads_total = r.counter(
            f"{NS}_admitted_workloads_total",
            "Total number of admitted workloads per cluster_queue",
            ("cluster_queue",),
        )
        self.admission_wait_time_seconds = r.histogram(
            f"{NS}_admission_wait_time_seconds",
            "Time between workload creation and admission",
            ("cluster_queue",),
        )
        self.admission_checks_wait_time_seconds = r.histogram(
            f"{NS}_admission_checks_wait_time_seconds",
            "Time between quota reservation and admission",
            ("cluster_queue",),
        )
        self.evicted_workloads_total = r.counter(
            f"{NS}_evicted_workloads_total",
            "Total number of evicted workloads per cluster_queue and reason",
            ("cluster_queue", "reason"),
        )
        self.preempted_workloads_total = r.counter(
            f"{NS}_preempted_workloads_total",
            "Total number of preempted workloads per preempting cluster_queue and reason",
            ("preempting_cluster_queue", "reason"),
        )
        self.reserving_active_workloads = r.gauge(
            f"{NS}_reserving_active_workloads",
            "Number of workloads with quota reservation per cluster_queue",
            ("cluster_queue",),
        )
        self.admitted_active_workloads = r.gauge(
            f"{NS}_admitted_active_workloads",
            "Number of admitted not-finished workloads per cluster_queue",
            ("cluster_queue",),
        )
        self.cluster_queue_status = r.gauge(
            f"{NS}_cluster_queue_status",
            "ClusterQueue status (1 for the active condition state)",
            ("cluster_queue", "status"),
        )
        self.cluster_queue_resource_reservation = r.gauge(
            f"{NS}_cluster_queue_resource_reservation",
            "Total quantity of reserved quota per cohort/cluster_queue/flavor/resource",
            ("cohort", "cluster_queue", "flavor", "resource"),
        )
        self.cluster_queue_resource_usage = r.gauge(
            f"{NS}_cluster_queue_resource_usage",
            "Total quantity of used quota per cohort/cluster_queue/flavor/resource",
            ("cohort", "cluster_queue", "flavor", "resource"),
        )
        self.cluster_queue_nominal_quota = r.gauge(
            f"{NS}_cluster_queue_nominal_quota",
            "Nominal quota per cohort/cluster_queue/flavor/resource",
            ("cohort", "cluster_queue", "flavor", "resource"),
        )
        self.cluster_queue_borrowing_limit = r.gauge(
            f"{NS}_cluster_queue_borrowing_limit",
            "Borrowing limit per cohort/cluster_queue/flavor/resource",
            ("cohort", "cluster_queue", "flavor", "resource"),
        )
        self.cluster_queue_lending_limit = r.gauge(
            f"{NS}_cluster_queue_lending_limit",
            "Lending limit per cohort/cluster_queue/flavor/resource",
            ("cohort", "cluster_queue", "flavor", "resource"),
        )
        self.cluster_queue_weighted_share = r.gauge(
            f"{NS}_cluster_queue_weighted_share",
            "Fair-sharing weighted share per cluster_queue",
            ("cluster_queue",),
        )
        self.cohort_weighted_share = r.gauge(
            f"{NS}_cohort_weighted_share",
            "Fair-sharing weighted share per cohort",
            ("cohort",),
        )
        # capacity planner (kueue_tpu_torch/planner): scrape surface for the
        # what-if scenario sweeps — run counts per target kind, total
        # scenarios evaluated, and batch latency per resolution path
        # (device = one vmapped launch, host = numpy reference)
        self.planner_runs_total = r.counter(
            f"{NS}_planner_runs_total",
            "Total capacity-planner runs per target kind (workload|clusterqueue|adhoc)",
            ("target",),
        )
        self.planner_scenarios_total = r.counter(
            f"{NS}_planner_scenarios_total",
            "Total what-if scenarios evaluated by the capacity planner",
        )
        self.planner_duration_seconds = r.histogram(
            f"{NS}_planner_duration_seconds",
            "Wall-clock latency of one planner scenario batch per path (device|host)",
            ("path",),
            buckets=ATTEMPT_BUCKETS,
        )
        # `path` is a closed set: materialize both series up front so
        # the scrape surface is complete before the first plan runs
        for path in ("device", "host"):
            self.planner_duration_seconds.touch(path=path)
        self.planner_last_scenarios = r.gauge(
            f"{NS}_planner_last_scenarios",
            "Scenario count of the most recent capacity-planner run",
        )
        # admission policies (kueue_tpu_torch/policy): which registered
        # policy is active (exactly one series is 1), how many times
        # the config changed, and decisions made under scoring policies
        self.policy_active = r.gauge(
            f"{NS}_policy_active",
            "1 for the active admission policy (first-fit|gavel|prema|"
            "deadline|gavel-deadline), 0 otherwise",
            ("policy",),
        )
        self.policy_changes_total = r.counter(
            f"{NS}_policy_changes_total",
            "Total admission-policy configuration changes",
        )
        self.policy_scored_decisions_total = r.counter(
            f"{NS}_policy_scored_decisions_total",
            "Total admission decisions carrying a flavor score "
            "breakdown (made under a scoring, non-first-fit policy)",
            ("policy",),
        )
        # self-healing hot path (core/guard.py): which solver path the
        # next cycle takes (exactly one of the two series is 1), and
        # the failover / divergence / quarantine accounting.
        # kueue_solver_path{path="host"} == 1 is the paging signal for
        # a degraded (circuit-open or quarantined) device path.
        self.solver_path = r.gauge(
            f"{NS}_solver_path",
            "Active solver path (1 on the path admission currently uses)",
            ("path",),
        )
        for path in ("device", "host"):
            self.solver_path.set(1 if path == "device" else 0, path=path)
        self.solver_failovers_total = r.counter(
            f"{NS}_solver_failovers_total",
            "Total device-solver failures converted into host-mirror fallback, by cause (raise|deadline)",
            ("reason",),
        )
        self.solver_divergence_checks_total = r.counter(
            f"{NS}_solver_divergence_checks_total",
            "Total sampled differential verifications of the device solver against the host mirror",
        )
        self.solver_divergences_total = r.counter(
            f"{NS}_solver_divergences_total",
            "Total divergences caught by the sampled differential verification (each quarantines the device path)",
        )
        self.solver_quarantined_workloads = r.gauge(
            f"{NS}_solver_quarantined_workloads",
            "Workloads currently sidelined by the poison-workload quarantine",
        )
        # double-buffered drain loop (core/pipeline.py): overlap_ratio
        # near 1 means every host apply ran with the next round's solve
        # in flight; a rising discard counter means applies keep
        # invalidating the speculation (pipeline off-rhythm — check
        # what mutates state mid-drain); inflight is the live 0/1
        # speculative-launch gauge.
        self.pipeline_overlap_ratio = r.gauge(
            f"{NS}_pipeline_overlap_ratio",
            "Fraction of bulk-drain host apply time that ran with the next round's device solve in flight",
        )
        self.pipeline_prefetch_discards_total = r.counter(
            f"{NS}_pipeline_prefetch_discards_total",
            "Total speculative drain launches discarded because the apply invalidated their inputs",
        )
        self.pipeline_inflight = r.gauge(
            f"{NS}_pipeline_inflight",
            "Speculative drain launches currently in flight (0 or 1)",
        )
        # label-less series: materialize at zero so the scrape surface
        # is complete before the first pipelined drain runs
        self.pipeline_overlap_ratio.set(0.0)
        self.pipeline_prefetch_discards_total.inc(0.0)
        self.pipeline_inflight.set(0)
        # device-resident megaloop (ops/megaloop_kernel +
        # controllers._megaloop_bulk_drain): rounds_per_launch is the
        # amortization the fusion buys (committed drain rounds per
        # fused dispatch — 1.0 means it buys nothing); a rising
        # truncation counter means the per-round conflict check keeps
        # cutting batches (interference mid-drain, stuck queues or
        # structural fallback re-entering the backlog — shrink K or
        # check what mutates state under the drain)
        self.megaloop_rounds_per_launch = r.gauge(
            f"{NS}_megaloop_rounds_per_launch",
            "Committed drain rounds amortized per fused megaloop dispatch",
        )
        self.megaloop_launches_total = r.counter(
            f"{NS}_megaloop_launches_total",
            "Total fused megaloop drain dispatches",
        )
        self.megaloop_truncations_total = r.counter(
            f"{NS}_megaloop_truncations_total",
            "Total megaloop batches truncated by a failed per-round conflict check",
        )
        self.megaloop_rounds_per_launch.set(0.0)
        self.megaloop_launches_total.inc(0.0)
        self.megaloop_truncations_total.inc(0.0)
        # multi-chip admission (kueue_tpu_torch/parallel): mesh posture + the
        # host-side sharding overhead. mesh_devices is 0 while the
        # server runs single-device (--mesh off or < 2 devices);
        # allgather_seconds accumulates the wall time spent placing
        # sharded drain inputs across the mesh (the observable host
        # cost of sharding — the in-kernel collectives ride device_s).
        self.mesh_devices = r.gauge(
            f"{NS}_mesh_devices",
            "Devices in the active admission mesh (0 = single-device)",
        )
        self.mesh_shard_width = r.gauge(
            f"{NS}_mesh_shard_width",
            "Queue-axis (wl) shard count of the active admission mesh (0 = single-device)",
        )
        self.mesh_allgather_seconds = r.counter(
            f"{NS}_mesh_allgather_seconds",
            "Cumulative seconds spent placing/gathering sharded drain inputs across the mesh",
        )
        # materialize at zero: the scrape surface is complete before
        # the first sharded drain (and while the mesh is off)
        self.mesh_devices.set(0)
        self.mesh_shard_width.set(0)
        self.mesh_allgather_seconds.inc(0.0)
        # MultiKueue federation (kueue_tpu_torch/federation): cross-cluster
        # dispatch accounting. clusters_active dropping below the
        # configured cluster count is the paging signal for a partition
        # (paired with /healthz's "federation" detail reporting
        # "degraded" while any configured worker is lost).
        self.multikueue_dispatches_total = r.counter(
            f"{NS}_multikueue_dispatches_total",
            "Total federation transport exchanges per worker cluster and outcome (ok|unreachable|rejected)",
            ("cluster", "outcome"),
        )
        self.multikueue_retractions_total = r.counter(
            f"{NS}_multikueue_retractions_total",
            "Total retraction protocol transitions by outcome (enqueued|acked|retried|deduped)",
            ("outcome",),
        )
        self.multikueue_remote_rtt_seconds = r.histogram(
            f"{NS}_multikueue_remote_rtt_seconds",
            "Round-trip latency of federation transport exchanges per worker cluster",
            ("cluster",),
            buckets=ATTEMPT_BUCKETS,
        )
        # `cluster` is open-ended (worker names), so materialize the
        # empty-label series up front — the exposition grammar (every
        # histogram exposes buckets) must hold before the first
        # dispatch; the dispatcher touches each real cluster's series
        # as it is configured
        self.multikueue_remote_rtt_seconds.touch(cluster="")
        self.multikueue_clusters_active = r.gauge(
            f"{NS}_multikueue_clusters_active",
            "Worker clusters currently reachable and not quarantined",
        )
        # gray-failure health plane (kueue_tpu_torch/federation/health.py):
        # per-worker latency state, RTT quantiles and hedge accounting.
        # worker_health is one-hot per (cluster, state) — a worker in
        # "degraded" is in latency probation (slow but alive: no NEW
        # dispatches, still syncing/retracting); a sustained hedge rate
        # near the budget means the fleet's tail latency is eating the
        # hedge allowance (raise the budget or fix the gray worker).
        self.worker_health = r.gauge(
            f"{NS}_worker_health",
            "1 for each worker cluster's current latency-health state (healthy|degraded|lost)",
            ("cluster", "state"),
        )
        self.worker_rtt_quantile_seconds = r.gauge(
            f"{NS}_worker_rtt_quantile_seconds",
            "Windowed RTT quantiles per worker cluster (quantile in p50|p95|p99)",
            ("cluster", "quantile"),
        )
        # `cluster` is open-ended: materialize the empty-label series
        # so the scrape surface is complete before the first worker is
        # configured; `state`/`quantile` are closed sets, exposed per
        # value
        for state in ("healthy", "degraded", "lost"):
            self.worker_health.set(0.0, cluster="", state=state)
        for q in ("p50", "p95", "p99"):
            self.worker_rtt_quantile_seconds.set(0.0, cluster="", quantile=q)
        self.hedges_total = r.counter(
            f"{NS}_hedges_total",
            "Total hedged federation exchanges by outcome (won = the backup answered, lost = it failed too)",
            ("outcome",),
        )
        for outcome in ("won", "lost"):
            self.hedges_total.inc(0.0, outcome=outcome)
        self.hedge_rate = r.gauge(
            f"{NS}_hedge_rate",
            "Hedged fraction of all federation exchanges (budget-capped)",
        )
        self.hedge_rate.set(0.0)
        # global scheduler (kueue_tpu_torch/federation/global_scheduler.py):
        # federation-wide rescore loop + planner-driven rebalancing.
        # A rising skipped_stale rate means rescores race deposals
        # (shrink the rescore interval or grow hysteresis); reachable
        # workers below the configured count means some worker serves
        # no readable state (no in-process runtime and no feed reader).
        self.global_rescore_total = r.counter(
            f"{NS}_global_rescore_total",
            "Total global rescore passes (aggregate + batched scoring + rebalance apply)",
        )
        self.global_rescore_total.inc(0.0)
        self.global_rescore_seconds = r.histogram(
            f"{NS}_global_rescore_seconds",
            "Wall time of one batched (workload x cluster) rescore pass",
            buckets=ATTEMPT_BUCKETS,
        )
        self.global_rescore_seconds.touch()
        self.global_rebalances_total = r.counter(
            f"{NS}_global_rebalances_total",
            "Total rebalance decisions by outcome (applied|skipped_stale|skipped_gone|skipped_covered|skipped_cooldown)",
            ("outcome",),
        )
        for outcome in (
            "applied", "skipped_stale", "skipped_gone",
            "skipped_covered", "skipped_cooldown",
        ):
            self.global_rebalances_total.inc(0.0, outcome=outcome)
        self.global_pending_workloads = r.gauge(
            f"{NS}_global_pending_workloads",
            "Rebalanceable pending workloads scored in the last global rescore",
        )
        self.global_pending_workloads.set(0)
        self.global_workers_reachable = r.gauge(
            f"{NS}_global_workers_reachable",
            "Worker clusters readable (in-process or feed) in the last global rescore",
        )
        self.global_workers_reachable.set(0)
        # durable-state subsystem (kueue_tpu_torch/storage): journal health +
        # crash-recovery accounting. journal_degraded is the paging
        # signal — 1 means appends are failing (ENOSPC/EIO) and the
        # control plane is running on checkpoint-only durability.
        self.journal_degraded = r.gauge(
            f"{NS}_journal_degraded",
            "1 while journal appends are failing and persistence is degraded to checkpoint-only",
        )
        self.journal_appends_total = r.counter(
            f"{NS}_journal_appends_total",
            "Total journal records successfully appended",
        )
        self.journal_append_errors_total = r.counter(
            f"{NS}_journal_append_errors_total",
            "Total journal append failures (records lost to degraded persistence)",
        )
        self.journal_fsyncs_total = r.counter(
            f"{NS}_journal_fsyncs_total",
            "Total fsync calls on the active journal segment",
        )
        self.journal_bytes_written_total = r.counter(
            f"{NS}_journal_bytes_written_total",
            "Total bytes appended to the journal",
        )
        self.journal_segments = r.gauge(
            f"{NS}_journal_segments",
            "Journal segment files currently on disk",
        )
        self.journal_reclaimed_bytes_total = r.counter(
            f"{NS}_journal_reclaimed_bytes_total",
            "Total sealed-segment bytes deleted by checkpoint-driven journal compaction",
        )
        # delta checkpoints (kueue_tpu_torch/storage/checkpoint.py): chain
        # health + the O(changed) cost signal. checkpoint_degraded is
        # the paging companion of journal_degraded — 1 means chain
        # writes are failing (ENOSPC on the state volume) and the
        # newest durable state is the PREVIOUS chain head.
        self.checkpoints_total = r.counter(
            f"{NS}_checkpoints_total",
            "Total checkpoint attempts by kind (full anchor, delta, failed write)",
            ("kind",),
        )
        for kind in ("full", "delta", "failed"):
            self.checkpoints_total.inc(0.0, kind=kind)
        self.checkpoint_bytes_total = r.counter(
            f"{NS}_checkpoint_bytes_total",
            "Total bytes durably written to the checkpoint chain by kind",
            ("kind",),
        )
        for kind in ("full", "delta"):
            self.checkpoint_bytes_total.inc(0.0, kind=kind)
        self.checkpoint_duration_seconds = r.histogram(
            f"{NS}_checkpoint_duration_seconds",
            "Wall time of one checkpoint (serialize + durable write + chain GC) by kind",
            ("kind",),
        )
        for kind in ("full", "delta"):
            self.checkpoint_duration_seconds.touch(kind=kind)
        self.checkpoint_degraded = r.gauge(
            f"{NS}_checkpoint_degraded",
            "1 while delta-checkpoint chain writes are failing (previous chain still valid)",
        )
        self.checkpoint_degraded.set(0)
        self.checkpoint_chain_files = r.gauge(
            f"{NS}_checkpoint_chain_files",
            "Checkpoint chain files (anchors + deltas) currently on disk",
        )
        self.checkpoint_chain_files.set(0)
        self.recovery_runs_total = r.counter(
            f"{NS}_recovery_runs_total",
            "Total checkpoint+journal recoveries performed by this process",
        )
        self.recovery_replayed_records_total = r.counter(
            f"{NS}_recovery_replayed_records_total",
            "Total journal records replayed during recovery",
        )
        self.recovery_skipped_stale_records_total = r.counter(
            f"{NS}_recovery_skipped_stale_records_total",
            "Total journal records refused during recovery for carrying a stale fencing token",
        )
        self.recovery_torn_bytes_total = r.counter(
            f"{NS}_recovery_torn_bytes_total",
            "Total torn-tail bytes truncated from the journal during recovery",
        )
        # distributed tracing (kueue_tpu_torch/tracing): span volume per
        # closed-registry name, and the end-to-end queue-to-admission
        # latency the lifecycle traces measure (root open at enqueue,
        # closed at admission) — the signal the heterogeneity-aware
        # policy tier is judged on. The name label is a member of
        # SPAN_NAMES (closed set), so cardinality stays bounded.
        self.trace_spans_total = r.counter(
            f"{NS}_trace_spans_total",
            "Total spans recorded per span name (closed registry kueue_tpu_torch.tracing.names.SPAN_NAMES)",
            ("name",),
        )
        from kueue_tpu_torch.tracing.names import SPAN_NAMES

        # materialize every registry name at zero: the scrape surface
        # is complete before the first span lands
        for span_name in sorted(SPAN_NAMES):
            self.trace_spans_total.inc(0.0, name=span_name)
        self.trace_queue_to_admission_seconds = r.histogram(
            f"{NS}_trace_queue_to_admission_seconds",
            "End-to-end enqueue-to-admission latency per cluster_queue (workload lifecycle trace root duration)",
            ("cluster_queue",),
        )
        # cluster_queue is open-ended: materialize the empty-label
        # series up front, the multikueue_remote_rtt_seconds pattern
        self.trace_queue_to_admission_seconds.touch(cluster_queue="")
        # gateway serving tier (kueue_tpu_torch/gateway): write-path batching
        # + per-tenant backpressure accounting. A rising shed counter
        # is the load-shedding signal (pair with the per-reason label
        # to tell a flooding tenant from a saturated queue); queue
        # depth near the configured bound means flushes cannot keep up
        # with arrivals.
        self.gateway_requests_total = r.counter(
            f"{NS}_gateway_requests_total",
            "Total writes through the gateway per outcome (applied|rejected|shed)",
            ("outcome",),
        )
        for outcome in ("applied", "rejected", "shed"):
            self.gateway_requests_total.inc(0.0, outcome=outcome)
        self.gateway_batches_total = r.counter(
            f"{NS}_gateway_batches_total",
            "Total coalesced flush windows the gateway drained",
        )
        self.gateway_batches_total.inc(0.0)
        self.gateway_shed_total = r.counter(
            f"{NS}_gateway_shed_total",
            "Total writes shed with 429 per reason (tenant_rate|tenant_share|queue_full)",
            ("reason",),
        )
        for reason in ("tenant_rate", "tenant_share", "queue_full"):
            self.gateway_shed_total.inc(0.0, reason=reason)
        self.gateway_queue_depth = r.gauge(
            f"{NS}_gateway_queue_depth",
            "Writes waiting in the gateway coalescing queue after the last flush",
        )
        self.gateway_queue_depth.set(0)
        self.gateway_batch_size = r.histogram(
            f"{NS}_gateway_batch_size",
            "Requests coalesced into one gateway flush window",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024),
        )
        self.gateway_batch_size.touch()
        self.gateway_flush_duration_seconds = r.histogram(
            f"{NS}_gateway_flush_duration_seconds",
            "Wall-clock latency of one gateway flush (apply + reconcile + group fsync)",
            buckets=ATTEMPT_BUCKETS,
        )
        self.gateway_flush_duration_seconds.touch()
        # admission SLOs (kueue_tpu_torch/gateway/slo.py): attainment and
        # error-budget burn of enqueue->admission latency against
        # per-ClusterQueue p95 targets, computed from the
        # kueue_trace_queue_to_admission_seconds histogram.
        # kueue_slo_degraded == 1 (sustained burn) is the paging
        # signal and flips /healthz to "degraded".
        self.slo_target_seconds = r.gauge(
            f"{NS}_slo_target_seconds",
            "Configured p95 queue-to-admission target per cluster_queue",
            ("cluster_queue",),
        )
        self.slo_target_seconds.set(0.0, cluster_queue="")
        self.slo_attainment_ratio = r.gauge(
            f"{NS}_slo_attainment_ratio",
            "Fraction of admissions within the queue-to-admission target per cluster_queue",
            ("cluster_queue",),
        )
        self.slo_attainment_ratio.set(0.0, cluster_queue="")
        self.slo_error_budget_burn_rate = r.gauge(
            f"{NS}_slo_error_budget_burn_rate",
            "Windowed error-budget burn rate per cluster_queue (1.0 consumes the budget exactly at the sustainable pace)",
            ("cluster_queue",),
        )
        self.slo_error_budget_burn_rate.set(0.0, cluster_queue="")
        self.slo_degraded = r.gauge(
            f"{NS}_slo_degraded",
            "1 while any cluster_queue's burn rate has exceeded the threshold for the sustain window",
        )
        self.slo_degraded.set(0)
        # journal-tailing read replicas (kueue_tpu_torch/storage/tailer.py):
        # staleness + replay accounting. On a replica, applied_seq
        # trails the leader's kueue_journal_appends head by the poll
        # interval and lag_seconds is the paging signal for a replica
        # falling behind; on the leader all four stay at zero (the
        # roster lives on /apis/kueue/v1beta1/replicas instead).
        self.replica_applied_seq = r.gauge(
            f"{NS}_replica_applied_seq",
            "Newest journal sequence this replica has applied (0 on the leader)",
        )
        self.replica_lag_seconds = r.gauge(
            f"{NS}_replica_lag_seconds",
            "Estimated staleness of this replica behind the leader's journal head",
        )
        self.replica_records_applied_total = r.counter(
            f"{NS}_replica_records_applied_total",
            "Total journal records applied by this replica's tailer",
        )
        self.replica_resyncs_total = r.counter(
            f"{NS}_replica_resyncs_total",
            "Total checkpoint resyncs (compaction jumps + fencing re-anchors)",
        )
        # materialize at zero: the replication section of the scrape
        # surface exists on every process, leader included
        self.replica_applied_seq.set(0)
        self.replica_lag_seconds.set(0.0)
        self.replica_records_applied_total.inc(0.0)
        self.replica_resyncs_total.inc(0.0)
        # two-phase provisioning (admissionchecks/provisioning.py):
        # ProvisioningRequest lifecycle volume per closed state label,
        # the retry-ladder rate and its backoff distribution. A rising
        # exhausted count is the "autoscaler cannot satisfy this class"
        # signal; booking_expired without matching provisioned means
        # capacity keeps arriving too late.
        self.provisioning_requests_total = r.counter(
            f"{NS}_provisioning_requests_total",
            "ProvisioningRequest lifecycle transitions per state "
            "(created|submitted|provisioned|failed|booking_expired"
            "|capacity_revoked|exhausted)",
            ("state",),
        )
        for state in (
            "created", "submitted", "provisioned", "failed",
            "booking_expired", "capacity_revoked", "exhausted",
        ):
            self.provisioning_requests_total.inc(0.0, state=state)
        self.provisioning_retries_total = r.counter(
            f"{NS}_provisioning_retries_total",
            "Total provisioning retry attempts entered (b*2^(n-1) ladder)",
        )
        self.provisioning_retries_total.inc(0.0)
        self.provisioning_backoff_seconds = r.histogram(
            f"{NS}_provisioning_backoff_seconds",
            "Backoff applied before each provisioning retry attempt",
            buckets=(30, 60, 120, 240, 480, 960, 1800, 3600),
        )
        self.provisioning_backoff_seconds.touch()
        # elastic capacity plane (kueue_tpu_torch/elastic): journaled quota
        # grants/revokes, currently granted capacity per (flavor,
        # resource), the batched scale-up chooser, and drain-ahead
        # membership. grants minus revokes tracks net elastic quota;
        # workers_cordoned > 0 for long means a drain is stuck behind
        # unretractable placements.
        self.elastic_grants_total = r.counter(
            f"{NS}_elastic_grants_total",
            "Total journaled elastic_grant capacity mutations applied",
        )
        self.elastic_grants_total.inc(0.0)
        self.elastic_revokes_total = r.counter(
            f"{NS}_elastic_revokes_total",
            "Total journaled elastic_revoke capacity withdrawals applied",
        )
        self.elastic_revokes_total.inc(0.0)
        self.elastic_granted_resources = r.gauge(
            f"{NS}_elastic_granted_resources",
            "Capacity currently granted by the provider per flavor and "
            "resource (canonical units)",
            ("flavor", "resource"),
        )
        # flavor/resource are open-ended: materialize the empty-label
        # series up front, the multikueue_remote_rtt_seconds pattern
        self.elastic_granted_resources.set(0.0, flavor="", resource="")
        self.elastic_chooser_launches_total = r.counter(
            f"{NS}_elastic_chooser_launches_total",
            "Total batched scale-up chooser launches (one vmapped "
            "plan_kernel sweep scoring every candidate flavor delta)",
        )
        self.elastic_chooser_launches_total.inc(0.0)
        self.elastic_chooser_seconds = r.histogram(
            f"{NS}_elastic_chooser_seconds",
            "Wall-clock latency of one batched scale-up chooser plan",
            buckets=ATTEMPT_BUCKETS,
        )
        self.elastic_chooser_seconds.touch()
        self.elastic_workers_cordoned = r.gauge(
            f"{NS}_elastic_workers_cordoned",
            "Federation workers currently cordoned (drain-ahead: no "
            "new dispatches, placements being retracted)",
        )
        self.elastic_workers_cordoned.set(0)
        self.elastic_membership_changes_total = r.counter(
            f"{NS}_elastic_membership_changes_total",
            "Dynamic federation membership operations per kind "
            "(join|cordon|uncordon|drain|leave)",
            ("kind",),
        )
        for kind in ("join", "cordon", "uncordon", "drain", "leave"):
            self.elastic_membership_changes_total.inc(0.0, kind=kind)
        # LocalQueue variants (LocalQueueMetrics feature gate)
        self.local_queue_pending_workloads = r.gauge(
            f"{NS}_local_queue_pending_workloads",
            "Number of pending workloads per local_queue",
            ("local_queue", "namespace", "status"),
        )
        self.local_queue_admitted_workloads_total = r.counter(
            f"{NS}_local_queue_admitted_workloads_total",
            "Total admitted workloads per local_queue",
            ("local_queue", "namespace"),
        )
        self.local_queue_evicted_workloads_total = r.counter(
            f"{NS}_local_queue_evicted_workloads_total",
            "Total evicted workloads per local_queue and reason",
            ("local_queue", "namespace", "reason"),
        )

    # ---- reporting helpers (metrics.go:387-470) ----
    @property
    def lq_enabled(self) -> bool:
        return features.enabled("LocalQueueMetrics")

    def report_admission_attempt(self, result: str, duration_s: float) -> None:
        self.admission_attempts_total.inc(result=result)
        self.admission_attempt_duration_seconds.observe(duration_s, result=result)

    def report_cycle(self, trace) -> None:
        """Mirror one CycleTrace into the scrape surface."""
        self.cycle_total.inc(resolution=trace.resolution)
        self.cycle_duration_seconds.observe(
            trace.total_s, resolution=trace.resolution
        )
        self.cycle_device_seconds.observe(
            trace.device_s, resolution=trace.resolution
        )
        self.cycle_last_heads.set(trace.heads)
        self.cycle_last_admitted.set(trace.admitted)

    def report_planner(
        self, target_kind: str, n_scenarios: int, duration_s: float, path: str
    ) -> None:
        """Mirror one capacity-planner run into the scrape surface."""
        self.planner_runs_total.inc(target=target_kind)
        self.planner_scenarios_total.inc(n_scenarios)
        self.planner_duration_seconds.observe(duration_s, path=path)
        self.planner_last_scenarios.set(n_scenarios)

    def report_dispatch(
        self, cluster: str, outcome: str, rtt_s: Optional[float] = None
    ) -> None:
        """Mirror one federation transport exchange into the scrape
        surface (outcome in ok|unreachable|rejected; RTT only when the
        exchange completed a round trip)."""
        self.multikueue_dispatches_total.inc(cluster=cluster, outcome=outcome)
        if rtt_s is not None:
            self.multikueue_remote_rtt_seconds.observe(rtt_s, cluster=cluster)

    def report_retraction(self, outcome: str) -> None:
        self.multikueue_retractions_total.inc(outcome=outcome)

    def report_hedge(self, outcome: str) -> None:
        self.hedges_total.inc(outcome=outcome)

    def report_worker_health(self, cluster: str, snapshot: dict) -> None:
        """Mirror one worker's health-plane snapshot into the scrape
        surface: one-hot state + RTT quantile gauges."""
        for state in ("healthy", "degraded", "lost"):
            self.worker_health.set(
                1.0 if snapshot["state"] == state else 0.0,
                cluster=cluster, state=state,
            )
        for q, key in (("p50", "rttP50"), ("p95", "rttP95"),
                       ("p99", "rttP99")):
            self.worker_rtt_quantile_seconds.set(
                snapshot[key], cluster=cluster, quantile=q
            )

    def report_inadmissible_reason(self, cq: str, reason: str) -> None:
        self.inadmissible_reason_total.inc(cluster_queue=cq, reason=reason)

    def report_pending_workloads(self, cq: str, active: int, inadmissible: int) -> None:
        self.pending_workloads.set(active, cluster_queue=cq, status="active")
        self.pending_workloads.set(
            inadmissible, cluster_queue=cq, status="inadmissible"
        )

    def report_quota_reserved(self, cq: str, wait_s: float) -> None:
        self.quota_reserved_workloads_total.inc(cluster_queue=cq)
        self.quota_reserved_wait_time_seconds.observe(wait_s, cluster_queue=cq)

    def report_admitted(self, cq: str, wait_s: float, checks_wait_s: float,
                        lq: str = "", namespace: str = "") -> None:
        self.admitted_workloads_total.inc(cluster_queue=cq)
        self.admission_wait_time_seconds.observe(wait_s, cluster_queue=cq)
        self.admission_checks_wait_time_seconds.observe(
            checks_wait_s, cluster_queue=cq
        )
        if lq and self.lq_enabled:
            self.local_queue_admitted_workloads_total.inc(
                local_queue=lq, namespace=namespace
            )

    def report_evicted(self, cq: str, reason: str, lq: str = "", namespace: str = "") -> None:
        self.evicted_workloads_total.inc(cluster_queue=cq, reason=reason)
        if lq and self.lq_enabled:
            self.local_queue_evicted_workloads_total.inc(
                local_queue=lq, namespace=namespace, reason=reason
            )

    def report_preemption(self, preempting_cq: str, reason: str) -> None:
        self.preempted_workloads_total.inc(
            preempting_cluster_queue=preempting_cq, reason=reason
        )

    def report_cq_quotas(self, cohort: str, cq: str, quotas) -> None:
        """quotas: iterable of (flavor, resource, nominal, borrowing, lending)."""
        for flavor, resource, nominal, borrowing, lending in quotas:
            labels = dict(
                cohort=cohort, cluster_queue=cq, flavor=flavor, resource=resource
            )
            self.cluster_queue_nominal_quota.set(nominal, **labels)
            if borrowing is not None:
                self.cluster_queue_borrowing_limit.set(borrowing, **labels)
            if lending is not None:
                self.cluster_queue_lending_limit.set(lending, **labels)

    def report_cq_usage(self, cohort: str, cq: str, usage) -> None:
        """usage: iterable of (flavor, resource, reserved, used)."""
        for flavor, resource, reserved, used in usage:
            labels = dict(
                cohort=cohort, cluster_queue=cq, flavor=flavor, resource=resource
            )
            self.cluster_queue_resource_reservation.set(reserved, **labels)
            self.cluster_queue_resource_usage.set(used, **labels)

    def clear_cluster_queue(self, cq: str) -> None:
        """ClearClusterQueueMetrics on CQ delete: drop every series of
        every metric labeled with this cluster_queue — gauges, counters
        and histograms alike — so a recreated CQ starts fresh."""
        for metric in self.registry._metrics.values():
            metric.clear_matching("cluster_queue", cq)
            metric.clear_matching("preempting_cluster_queue", cq)
