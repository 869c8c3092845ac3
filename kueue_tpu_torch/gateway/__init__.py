"""Gateway serving tier: for now the admission SLOs alone.

``slo.SLOTracker`` is the ``kueue_slo_*`` family: attainment ratio and
error-budget burn rate computed from the lifecycle tracer's
``kueue_trace_queue_to_admission_seconds`` histogram against
per-ClusterQueue p95 targets. ``ClusterRuntime`` constructs one. The
write-path batcher and the per-tenant rate limiter come with the
serving plane (ROADMAP A9).
"""

from kueue_tpu_torch.gateway.slo import SLOTracker

__all__ = ["SLOTracker"]
