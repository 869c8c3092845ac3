"""Prometheus-style metrics (pkg/metrics/metrics.go)."""

from kueue_tpu_torch.metrics.registry import Counter, Gauge, Histogram, Registry
from kueue_tpu_torch.metrics.metrics import Metrics

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "Metrics"]
