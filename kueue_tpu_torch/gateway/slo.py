"""Admission SLOs — attainment + error-budget burn over the lifecycle tracer's
queue-to-admission histogram.

The lifecycle tracer observes every admission's enqueue→admit latency
into ``kueue_trace_queue_to_admission_seconds{cluster_queue}``; this
tracker reads that histogram against per-ClusterQueue p95 targets
("``objective`` of admissions within ``target`` seconds", default
objective 0.95) and derives the ``kueue_slo_*`` family:

- attainment ratio — lifetime fraction of admissions within target
  (the bucket boundary at or above the target counts as "good", so
  pick targets on histogram bucket boundaries for exact accounting);
- error-budget burn rate — over a sliding window, the observed
  bad fraction divided by the budget ``1 - objective``: burn 1.0
  consumes the budget exactly at the sustainable pace, burn >
  ``burn_threshold`` held for ``sustain_s`` flips the tracker (and
  /healthz) to "degraded" — the multiwindow-burn paging pattern.

The tracker is passive and cheap: ``refresh()`` is called lazily from
the serving surfaces (healthz, /metrics, the slo route, the gateway
flusher), rate-limited by ``maybe_refresh``.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional


class SLOTracker:
    def __init__(
        self,
        metrics,
        clock=None,
        objective: float = 0.95,
        default_target_s: float = 0.0,
        burn_window_s: float = 300.0,
        burn_threshold: float = 2.0,
        sustain_s: float = 60.0,
    ):
        if clock is None:
            from kueue_tpu_torch.utils.clock import Clock

            clock = Clock()
        self.metrics = metrics
        self.clock = clock
        self.objective = objective
        self.default_target_s = float(default_target_s)  # 0 = no default
        self.burn_window_s = burn_window_s
        self.burn_threshold = burn_threshold
        self.sustain_s = sustain_s
        self._lock = threading.Lock()
        self.targets: Dict[str, float] = {}  # guarded by: _lock
        # per-CQ (t, total, good) snapshots bounding the burn window
        self._snaps: Dict[str, deque] = {}  # guarded by: _lock
        self._burn_since: Dict[str, float] = {}  # guarded by: _lock
        self._last: Dict[str, dict] = {}  # guarded by: _lock
        self._last_refresh: Optional[float] = None  # guarded by: _lock

    # ---- configuration ----
    def configure(
        self,
        default_target_s: Optional[float] = None,
        targets: Optional[Dict[str, float]] = None,
        objective: Optional[float] = None,
        burn_window_s: Optional[float] = None,
        burn_threshold: Optional[float] = None,
        sustain_s: Optional[float] = None,
    ) -> None:
        with self._lock:
            if default_target_s is not None:
                self.default_target_s = float(default_target_s)
            if targets:
                self.targets.update(
                    {cq: float(t) for cq, t in targets.items()}
                )
            if objective is not None:
                if not 0.0 < objective < 1.0:
                    raise ValueError("objective must be in (0, 1)")
                self.objective = objective
            if burn_window_s is not None:
                self.burn_window_s = burn_window_s
            if burn_threshold is not None:
                self.burn_threshold = burn_threshold
            if sustain_s is not None:
                self.sustain_s = sustain_s

    def set_target(self, cq: str, seconds: float) -> None:
        with self._lock:
            self.targets[cq] = float(seconds)
            self.metrics.slo_target_seconds.set(
                float(seconds), cluster_queue=cq
            )

    def target_for(self, cq: str) -> float:
        """The p95 target for one CQ (0.0 = untracked)."""
        with self._lock:
            return self.targets.get(cq, self.default_target_s)

    @property
    def enabled(self) -> bool:
        with self._lock:
            return self.default_target_s > 0 or bool(self.targets)

    # ---- computation ----
    def _good_count(self, bucket_counts, buckets, total: int,
                    target: float) -> int:
        """Admissions within ``target``: the cumulative count of the
        first bucket boundary >= target (conservatively generous by at
        most one bucket; exact when the target IS a boundary)."""
        for le, count in zip(buckets, bucket_counts):
            if target <= le:
                return count
        return total

    def refresh(self) -> None:
        """Recompute attainment/burn for every targeted CQ from the
        histogram's current state and mirror the kueue_slo_* gauges."""
        hist = self.metrics.trace_queue_to_admission_seconds
        now = self.clock.now()
        degraded_any = False
        for labels, bucket_counts, total, _sum in hist.snapshot():
            cq = labels.get("cluster_queue", "")
            if not cq:
                continue
            target = self.target_for(cq)
            if target <= 0:
                continue
            good = self._good_count(bucket_counts, hist.buckets, total, target)
            attainment = (good / total) if total else 1.0
            with self._lock:
                snaps = self._snaps.setdefault(cq, deque())
                snaps.append((now, total, good))
                # keep ONE snapshot at or before the window start as the
                # burn baseline; drop anything older than that
                while (
                    len(snaps) > 1
                    and snaps[1][0] <= now - self.burn_window_s
                ):
                    snaps.popleft()
                base_t, base_total, base_good = snaps[0]
                d_total = total - base_total
                d_bad = (total - good) - (base_total - base_good)
                budget = max(1e-9, 1.0 - self.objective)
                burn = (d_bad / d_total) / budget if d_total > 0 else 0.0
                if burn > self.burn_threshold:
                    self._burn_since.setdefault(cq, now)
                else:
                    self._burn_since.pop(cq, None)
                since = self._burn_since.get(cq)
                degraded = (
                    since is not None and now - since >= self.sustain_s
                )
                degraded_any = degraded_any or degraded
                self._last[cq] = {
                    "clusterQueue": cq,
                    "targetSeconds": target,
                    "objective": self.objective,
                    "admitted": total,
                    "withinTarget": good,
                    "attainment": round(attainment, 6),
                    "burnRate": round(burn, 4),
                    "burningSinceS": (
                        round(now - since, 3) if since is not None else None
                    ),
                    "degraded": degraded,
                }
            self.metrics.slo_attainment_ratio.set(
                attainment, cluster_queue=cq
            )
            self.metrics.slo_error_budget_burn_rate.set(
                burn, cluster_queue=cq
            )
            self.metrics.slo_target_seconds.set(target, cluster_queue=cq)
        with self._lock:
            # forget CQs whose target was removed
            for cq in list(self._last):
                if self.targets.get(cq, self.default_target_s) <= 0:
                    self._last.pop(cq, None)
                    self._snaps.pop(cq, None)
                    self._burn_since.pop(cq, None)
            self._last_refresh = now
        self.metrics.slo_degraded.set(1 if degraded_any else 0)

    def maybe_refresh(self, min_interval_s: float = 1.0) -> None:
        if not self.enabled:
            return
        with self._lock:
            last = self._last_refresh
        if last is not None and self.clock.now() - last < min_interval_s:
            return
        self.refresh()

    # ---- posture ----
    @property
    def degraded(self) -> bool:
        with self._lock:
            return any(e["degraded"] for e in self._last.values())

    def report(self) -> dict:
        """The /apis/kueue/v1beta1/slo payload (also embedded in
        /healthz, the dashboard and the SIGUSR2 dump)."""
        with self._lock:
            entries = sorted(
                (dict(e) for e in self._last.values()),
                key=lambda e: e["clusterQueue"],
            )
            return {
                "enabled": self.default_target_s > 0 or bool(self.targets),
                "objective": self.objective,
                "defaultTargetSeconds": self.default_target_s or None,
                "burnWindowSeconds": self.burn_window_s,
                "burnThreshold": self.burn_threshold,
                "sustainSeconds": self.sustain_s,
                "degraded": any(e["degraded"] for e in entries),
                "clusterQueues": entries,
            }
