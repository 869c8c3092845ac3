"""Minimal prometheus-compatible metric primitives.

Counters/gauges/histograms with label sets and text exposition in the
Prometheus format, so the scrape output diffs against the reference's
controller-runtime registry output.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


def _fmt_labels(names: Sequence[str], values: Tuple[str, ...]) -> str:
    if not names:
        return ""
    inner = ",".join(
        f'{n}="{v}"' for n, v in zip(names, values)
    )
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class _Metric:
    def __init__(self, name: str, help_: str, label_names: Sequence[str] = ()):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        missing = set(self.label_names) - set(labels)
        extra = set(labels) - set(self.label_names)
        if missing or extra:
            raise ValueError(
                f"{self.name}: labels mismatch (missing={missing}, extra={extra})"
            )
        return tuple(str(labels[n]) for n in self.label_names)

    def clear_matching(self, label: str, value: str) -> None:
        """Drop every series whose ``label`` equals ``value`` (no-op if
        this metric doesn't carry the label)."""
        try:
            idx = self.label_names.index(label)
        except ValueError:
            return
        with self._lock:
            self._clear_keys(
                [k for k in self._series_keys() if k[idx] == value]
            )

    def _series_keys(self):  # overridden per kind
        return ()

    def _clear_keys(self, keys) -> None:
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help_, label_names=()):
        super().__init__(name, help_, label_names)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return self._values.get(self._key(labels), 0.0)

    def series(self):
        """(labels_dict, value) per live series — the public read the
        dashboard aggregates from (no poking at _values)."""
        with self._lock:
            return [
                (dict(zip(self.label_names, key)), v)
                for key, v in self._values.items()
            ]

    def delete(self, **labels) -> None:
        self._values.pop(self._key(labels), None)

    def _series_keys(self):
        return list(self._values)

    def _clear_keys(self, keys) -> None:
        for k in keys:
            self._values.pop(k, None)

    def collect(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.kind}"]
        for key, v in sorted(self._values.items()):
            out.append(f"{self.name}{_fmt_labels(self.label_names, key)} {_fmt_value(v)}")
        return out


class Gauge(Counter):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)


# controller-runtime default + the exponential buckets used by
# admission_attempt_duration_seconds (metrics.go:82-91)
DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10,
)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_, label_names=(), buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[Tuple[str, ...], List[int]] = {}
        self._sums: Dict[Tuple[str, ...], float] = {}
        self._totals: Dict[Tuple[str, ...], int] = {}

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def observe_many(self, values, **labels) -> None:
        """Batched observe: one label-key resolution for a whole list
        of observations (hot-path mirrors batch per cycle — per-sample
        key hashing would cost more than the samples)."""
        key = self._key(labels)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            total = self._sums.get(key, 0.0)
            n = 0
            for value in values:
                for i, b in enumerate(self.buckets):
                    if value <= b:
                        counts[i] += 1
                total += value
                n += 1
            self._sums[key] = total
            self._totals[key] = self._totals.get(key, 0) + n

    def touch(self, **labels) -> None:
        """Materialize a zero-count series for a known label value, so
        closed label sets expose complete (all-zero) bucket/sum/count
        series before the first observation."""
        key = self._key(labels)
        with self._lock:
            self._counts.setdefault(key, [0] * len(self.buckets))
            self._sums.setdefault(key, 0.0)
            self._totals.setdefault(key, 0)

    def _series_keys(self):
        return list(self._totals)

    def _clear_keys(self, keys) -> None:
        for k in keys:
            self._counts.pop(k, None)
            self._sums.pop(k, None)
            self._totals.pop(k, None)

    def count(self, **labels) -> int:
        return self._totals.get(self._key(labels), 0)

    def snapshot(self):
        """(labels_dict, bucket_counts, total, sum) per live series —
        the public read aggregators (the SLO tracker) compute from
        without poking at the private maps. ``bucket_counts`` aligns
        with ``self.buckets``."""
        with self._lock:
            return [
                (
                    dict(zip(self.label_names, key)),
                    list(
                        self._counts.get(key, [0] * len(self.buckets))
                    ),
                    self._totals.get(key, 0),
                    self._sums.get(key, 0.0),
                )
                for key in self._totals
            ]

    def sum(self, **labels) -> float:
        return self._sums.get(self._key(labels), 0.0)

    def collect(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.kind}"]
        for key in sorted(self._totals):
            counts = self._counts[key]
            for i, b in enumerate(self.buckets):
                lbl = _fmt_labels(
                    self.label_names + ("le",), key + (_fmt_value(b),)
                )
                out.append(f"{self.name}_bucket{lbl} {counts[i]}")
            lbl_inf = _fmt_labels(self.label_names + ("le",), key + ("+Inf",))
            out.append(f"{self.name}_bucket{lbl_inf} {self._totals[key]}")
            out.append(
                f"{self.name}_sum{_fmt_labels(self.label_names, key)} {_fmt_value(self._sums[key])}"
            )
            out.append(
                f"{self.name}_count{_fmt_labels(self.label_names, key)} {self._totals[key]}"
            )
        return out


class Registry:
    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def register(self, metric: _Metric) -> _Metric:
        with self._lock:
            if metric.name in self._metrics:
                raise ValueError(f"metric {metric.name} already registered")
            self._metrics[metric.name] = metric
        return metric

    def counter(self, name, help_, label_names=()) -> Counter:
        return self.register(Counter(name, help_, label_names))

    def gauge(self, name, help_, label_names=()) -> Gauge:
        return self.register(Gauge(name, help_, label_names))

    def histogram(self, name, help_, label_names=(), buckets=DEFAULT_BUCKETS) -> Histogram:
        return self.register(Histogram(name, help_, label_names, buckets))

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def expose(self) -> str:
        """Prometheus text exposition format."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            lines.extend(self._metrics[name].collect())
        return "\n".join(lines) + "\n"
