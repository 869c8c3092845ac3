"""Latency-aware worker health plane — gray-failure detection.

Every robustness layer before this one models workers as binary
alive/lost: a fixed transport timeout plus ``worker_lost_timeout``
means a *limping* worker that answers every call just under the
deadline is indistinguishable from a healthy one, silently dragging
every dispatch step, heartbeat sweep and global rescore down with it.
This module folds per-worker EWMA RTT, windowed p95/p99 quantiles,
error rate and heartbeat slack into a hysteresis state machine::

    healthy -> degraded (probation) -> lost

Probation is distinct from quarantine (strike-driven TTL) and cordon
(operator intent): a degraded worker receives no NEW dispatches but
keeps syncing its existing placements and acknowledging retractions —
the cheapest way off a gray worker is finishing the conversation, not
cutting it. Flap detection (state-change rate over a window) extends
the probation hold so an oscillating worker cannot re-enter the
dispatch rotation between its bad minutes.

The plane also owns the two latency-derived control signals:

- **adaptive deadlines**: per-call timeout = ``clamp(k * p99_rtt,
  floor, cap)`` instead of the historical fixed 10 s — healthy workers
  fail fast, slow-but-alive workers keep their (observed) budget;
- **hedged dispatch**: the hedge delay is the p95 RTT, and a global
  budget caps hedges at a few percent of calls.

Clock discipline: this module never reads time itself. RTT samples
arrive as floats measured by the dispatcher (whose ``perf_counter``
use carries the justified allowlist entry), and every schedule-
relevant decision takes ``now`` from the injected runtime clock.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

HEALTHY = "healthy"
DEGRADED = "degraded"
LOST = "lost"

STATES = (HEALTHY, DEGRADED, LOST)


def _quantile(sorted_samples: List[float], q: float) -> float:
    """Nearest-rank quantile over an already-sorted sample list."""
    if not sorted_samples:
        return 0.0
    idx = min(len(sorted_samples) - 1, int(q * len(sorted_samples)))
    return sorted_samples[idx]


class _WorkerRecord:
    """Per-worker rolling telemetry + state machine bookkeeping."""

    __slots__ = (
        "ewma_rtt",
        "rtts",
        "outcomes",
        "consecutive_errors",
        "last_contact",
        "state",
        "last_breach_at",
        "entered_at",
        "transitions",
        "_sorted_cache",
    )

    def __init__(self, window: int) -> None:
        self.ewma_rtt: Optional[float] = None
        self.rtts: Deque[float] = deque(maxlen=window)
        self.outcomes: Deque[bool] = deque(maxlen=window)
        self.consecutive_errors = 0
        self.last_contact: Optional[float] = None
        self.state = HEALTHY
        self.last_breach_at: Optional[float] = None
        self.entered_at = 0.0
        self.transitions: Deque[float] = deque(maxlen=32)
        self._sorted_cache: Optional[List[float]] = None

    def sorted_rtts(self) -> List[float]:
        if self._sorted_cache is None:
            self._sorted_cache = sorted(self.rtts)
        return self._sorted_cache

    def invalidate(self) -> None:
        self._sorted_cache = None

    def error_rate(self) -> float:
        if not self.outcomes:
            return 0.0
        return sum(1 for ok in self.outcomes if not ok) / len(self.outcomes)


class HealthPlane:
    """Federation-wide latency/health authority (one per dispatcher).

    All thresholds are constructor knobs so the chaos suites can pin
    them; the defaults are tuned for the historical 10 s fixed
    deadline the adaptive clamp replaces (``deadline_cap_s``).
    """

    def __init__(
        self,
        clock,
        *,
        window: int = 64,
        ewma_alpha: float = 0.3,
        deadline_k: float = 3.0,
        deadline_floor_s: float = 1.0,
        deadline_cap_s: float = 10.0,
        degrade_rtt_s: float = 2.0,
        degrade_error_rate: float = 0.5,
        degrade_min_samples: int = 3,
        slack_factor: float = 3.0,
        heartbeat_interval_s: float = 30.0,
        lost_error_streak: int = 8,
        probation_hold_s: float = 30.0,
        flap_window_s: float = 300.0,
        flap_threshold: int = 3,
        flap_extend_factor: float = 2.0,
        hold_cap_s: float = 600.0,
        hedge_budget: float = 0.05,
        hedge_min_samples: int = 8,
    ) -> None:
        self.clock = clock
        self.window = window
        self.ewma_alpha = ewma_alpha
        self.deadline_k = deadline_k
        self.deadline_floor_s = deadline_floor_s
        self.deadline_cap_s = deadline_cap_s
        self.degrade_rtt_s = degrade_rtt_s
        self.degrade_error_rate = degrade_error_rate
        self.degrade_min_samples = degrade_min_samples
        self.slack_factor = slack_factor
        self.heartbeat_interval_s = heartbeat_interval_s
        self.lost_error_streak = lost_error_streak
        self.probation_hold_s = probation_hold_s
        self.flap_window_s = flap_window_s
        self.flap_threshold = flap_threshold
        self.flap_extend_factor = flap_extend_factor
        self.hold_cap_s = hold_cap_s
        self.hedge_budget = hedge_budget
        self.hedge_min_samples = hedge_min_samples
        self._workers: Dict[str, _WorkerRecord] = {}
        # hedge budget accounting is fleet-wide: the budget bounds the
        # extra load hedging may put on the whole federation
        self.calls_total = 0
        self.hedges_total = 0

    # ---- ingestion ----------------------------------------------------
    def _rec(self, cluster: str) -> _WorkerRecord:
        rec = self._workers.get(cluster)
        if rec is None:
            rec = self._workers[cluster] = _WorkerRecord(self.window)
        return rec

    def observe_rtt(self, cluster: str, rtt_s: float, ok: bool = True) -> None:
        """One completed wire exchange: RTT plus its outcome."""
        rec = self._rec(cluster)
        rec.rtts.append(max(0.0, float(rtt_s)))
        rec.invalidate()
        rec.outcomes.append(bool(ok))
        if ok:
            rec.consecutive_errors = 0
            rec.last_contact = self.clock.now()
            if rec.ewma_rtt is None:
                rec.ewma_rtt = float(rtt_s)
            else:
                a = self.ewma_alpha
                rec.ewma_rtt = a * float(rtt_s) + (1.0 - a) * rec.ewma_rtt
        else:
            rec.consecutive_errors += 1
        self._advance(cluster, rec, self.clock.now())

    def observe_error(self, cluster: str) -> None:
        """A failed exchange with no meaningful RTT (refused/instant)."""
        rec = self._rec(cluster)
        rec.outcomes.append(False)
        rec.consecutive_errors += 1
        self._advance(cluster, rec, self.clock.now())

    def observe_contact(self, cluster: str, now: float) -> None:
        """Any successful exchange refreshes heartbeat slack."""
        self._rec(cluster).last_contact = now

    def forget(self, cluster: str) -> None:
        self._workers.pop(cluster, None)

    # ---- state machine ------------------------------------------------
    def _breach(self, rec: _WorkerRecord, now: float) -> bool:
        if len(rec.outcomes) >= self.degrade_min_samples:
            if rec.error_rate() >= self.degrade_error_rate:
                return True
        if len(rec.rtts) >= self.degrade_min_samples:
            if _quantile(rec.sorted_rtts(), 0.95) > self.degrade_rtt_s:
                return True
        if rec.last_contact is not None:
            slack = now - rec.last_contact
            if slack > self.slack_factor * self.heartbeat_interval_s:
                return True
        return False

    def _lost_grade(self, rec: _WorkerRecord) -> bool:
        return rec.consecutive_errors >= self.lost_error_streak

    def _hold_s(self, rec: _WorkerRecord, now: float) -> float:
        """Probation hold, extended exponentially by recent flaps."""
        flaps = sum(
            1 for t in rec.transitions if now - t <= self.flap_window_s
        )
        hold = self.probation_hold_s
        if flaps >= self.flap_threshold:
            hold *= self.flap_extend_factor ** (
                flaps - self.flap_threshold + 1
            )
        return min(hold, self.hold_cap_s)

    def _enter(self, rec: _WorkerRecord, state: str, now: float) -> None:
        if rec.state == state:
            return
        rec.state = state
        rec.entered_at = now
        rec.transitions.append(now)

    def _advance(self, cluster: str, rec: _WorkerRecord, now: float) -> None:
        breach = self._breach(rec, now)
        if breach:
            rec.last_breach_at = now
        if rec.state == HEALTHY:
            if self._lost_grade(rec):
                self._enter(rec, LOST, now)
            elif breach:
                self._enter(rec, DEGRADED, now)
        elif rec.state == DEGRADED:
            if self._lost_grade(rec):
                self._enter(rec, LOST, now)
            elif not breach:
                since_breach = now - (rec.last_breach_at or rec.entered_at)
                if since_breach >= self._hold_s(rec, now):
                    self._enter(rec, HEALTHY, now)
        else:  # LOST: recovery lands in probation, never straight healthy
            if rec.consecutive_errors == 0:
                self._enter(rec, DEGRADED, now)

    # ---- queries ------------------------------------------------------
    def state(self, cluster: str) -> str:
        rec = self._workers.get(cluster)
        if rec is None:
            return HEALTHY
        # heartbeat slack decays without traffic: re-evaluate on read
        self._advance(cluster, rec, self.clock.now())
        return rec.state

    def degraded(self, cluster: str) -> bool:
        return self.state(cluster) != HEALTHY

    def probation(self) -> List[str]:
        return sorted(
            name
            for name in self._workers
            if self.state(name) == DEGRADED
        )

    def rtt_quantile(self, cluster: str, q: float) -> float:
        rec = self._workers.get(cluster)
        if rec is None:
            return 0.0
        return _quantile(rec.sorted_rtts(), q)

    def ewma_rtt(self, cluster: str) -> float:
        rec = self._workers.get(cluster)
        if rec is None or rec.ewma_rtt is None:
            return 0.0
        return rec.ewma_rtt

    def error_rate(self, cluster: str) -> float:
        rec = self._workers.get(cluster)
        return rec.error_rate() if rec is not None else 0.0

    def deadline_s(self, cluster: str, cap_s: Optional[float] = None) -> float:
        """Adaptive per-call deadline: ``clamp(k*p99, floor, cap)``.

        With no samples yet (first contact) the full cap applies — the
        conservative choice for a worker we know nothing about.
        """
        cap = self.deadline_cap_s if cap_s is None else cap_s
        rec = self._workers.get(cluster)
        if rec is None or len(rec.rtts) < self.degrade_min_samples:
            return cap
        p99 = _quantile(rec.sorted_rtts(), 0.99)
        return min(cap, max(self.deadline_floor_s, self.deadline_k * p99))

    def hedge_delay_s(self, cluster: str) -> Optional[float]:
        """p95-RTT hedge delay, or None when hedging must not fire:
        too few samples to place the p95, or the fleet-wide budget is
        exhausted."""
        rec = self._workers.get(cluster)
        if rec is None or len(rec.rtts) < self.hedge_min_samples:
            return None
        if self.calls_total > 0 and (
            self.hedges_total >= self.hedge_budget * self.calls_total
        ):
            return None
        p95 = _quantile(rec.sorted_rtts(), 0.95)
        return max(self.deadline_floor_s * 0.1, p95)

    def record_call(self) -> None:
        self.calls_total += 1

    def record_hedge(self) -> None:
        self.hedges_total += 1

    def hedge_rate(self) -> float:
        if self.calls_total == 0:
            return 0.0
        return self.hedges_total / self.calls_total

    # ---- reporting ----------------------------------------------------
    def snapshot(self, cluster: str) -> Dict[str, object]:
        rec = self._workers.get(cluster)
        if rec is None:
            return {
                "state": HEALTHY,
                "ewmaRtt": 0.0,
                "rttP50": 0.0,
                "rttP95": 0.0,
                "rttP99": 0.0,
                "errorRate": 0.0,
                "samples": 0,
            }
        srtt = rec.sorted_rtts()
        return {
            "state": self.state(cluster),
            "ewmaRtt": rec.ewma_rtt or 0.0,
            "rttP50": _quantile(srtt, 0.50),
            "rttP95": _quantile(srtt, 0.95),
            "rttP99": _quantile(srtt, 0.99),
            "errorRate": rec.error_rate(),
            "samples": len(rec.rtts),
        }

    def fingerprint(self) -> Tuple[str, ...]:
        """Hashable health posture for the dispatcher's rank cache —
        a probation flip must invalidate cached rankings mid-step."""
        return tuple(
            f"{name}={self.state(name)}"
            for name in sorted(self._workers)
        )
