"""Global scheduler — the federation as ONE scheduling domain.

Layered on the ``FederationDispatcher``, this closes the loop the
dispatcher leaves open: dispatch ranks clusters once and never looks
back. The global scheduler aggregates every worker's state into a
``GlobalSnapshot`` (federation/aggregate.py — in-process runtimes read
directly, remote workers read through the replica feed they already
serve), scores every (pending workload x cluster) pair in one batched
kernel launch (ops/global_kernel.py, kernel B15 on the runtime's
device; numpy mirror in ops/global_np.py), and — when the forecaster says another cluster
beats the current placement by more than the hysteresis threshold —
retracts and re-dispatches through the dispatcher's journaled
at-least-once retraction protocol, under the same per-workload fencing
epochs that already guarantee exactly-one admission across crashes and
partitions.

Safety model (chaos-tested in tests/test_global_scheduler.py):

- **Stale-fence CAS.** A rebalance decision is computed against the
  fence observed at aggregation time; by apply time a deposal/heal may
  have moved the placement. The apply compares the observed fence to
  the live one and DROPS the move on mismatch (``global.stale_fence``
  models the race) — a rebalance can only move the epoch it scored.
- **Crash mid-retraction.** The old winner's retraction is journaled
  before the new dispatch intent (``global.rebalance_retract`` fires
  between them): a crash there replays to "old winner still named,
  unacked retraction queued" — the pump deletes the stale copy, the
  sync loop deposes, and re-dispatch converges to exactly one
  admission, the dispatcher's story unchanged.
- **Partitioned worker.** ``global.partition`` fires per worker read;
  an unreadable worker degrades to unscorable columns — never a
  rebalance target, never a reason to fail the pass.

Rebalancing only touches workloads that are dispatched but NOT yet
admitted: moving a running gang is preemption, which stays with the
deposal path.

In the port nothing contains the rescore: whatever
``rescore_pairs`` raises (a ``KernelError`` of B15 included) leaves
``rescore``, and no pass is re-solved on the host behind it.
``use_device=False`` stays the explicit host choice (the numpy
mirror). Tailing a remote worker's feed (``attach_feed_reader``) waits
for the serving plane's ``storage/tailer``.
"""

from __future__ import annotations

import time as _time
from typing import Dict, List, Optional

from kueue_tpu_torch.federation.dispatcher import (
    DISPATCH_RECORD,
    WINNER_LABEL,
)
from kueue_tpu_torch.testing import faults

__all__ = ["GlobalScheduler"]


class GlobalScheduler:
    def __init__(
        self,
        dispatcher,
        hysteresis_s: float = 60.0,
        rescore_interval_s: float = 30.0,
        use_device: bool = True,
        max_rebalances_per_pass: int = 8,
        rebalance_cooldown_s: float = 60.0,
        degraded_penalty_s: float = 120.0,
    ):
        self.disp = dispatcher
        self.runtime = dispatcher.runtime
        self.hysteresis_s = float(hysteresis_s)
        self.rescore_interval_s = float(rescore_interval_s)
        self.use_device = use_device
        self.max_rebalances_per_pass = int(max_rebalances_per_pass)
        # gray-failure coupling: clusters the latency health
        # plane holds in probation get this many seconds added to
        # every forecast BEFORE the key pack — the kernel prefers
        # moving OFF them and never rebalances ONTO them, while the
        # penalty (not an invalid mask) keeps a fully-degraded
        # federation schedulable
        self.degraded_penalty_s = float(degraded_penalty_s)
        # per-workload churn guard: a workload that just moved is not
        # moved again until the cooldown lapses — forecast noise (or a
        # herd of movers chasing the same freed slot) must not bounce
        # a gang between clusters faster than admission can land
        self.rebalance_cooldown_s = float(rebalance_cooldown_s)
        self._last_moved: Dict[str, float] = {}
        #: worker name -> feed reader (JournalTailer or read runtime)
        self.readers: Dict[str, object] = {}
        self.last_rescore_at: Optional[float] = None
        self.last_report: Optional[dict] = None
        self.rescores = 0
        self.rebalances = 0
        self.rescore_ms_total = 0.0  # perf accounting (bench/perf)
        self.aggregate_ms_total = 0.0
        dispatcher.global_scheduler = self
        m = getattr(self.runtime, "metrics", None)
        if m is not None:
            m.global_pending_workloads.set(0)
            m.global_workers_reachable.set(0)

    # ---- worker feed readers (wire-only clusters) ----
    def attach_reader(self, name: str, reader) -> None:
        """Register a feed reader for a wire-only worker: a
        ``JournalTailer`` (polled once per rescore) or any object with
        a read-only ``ClusterRuntime`` under ``.runtime``."""
        self.readers[name] = reader

    def attach_feed_reader(
        self, name: str, url: str, token: Optional[str] = None,
        poll_timeout_s: float = 30.0,
    ):
        """Tail a remote worker's replication feed — the replica
        machinery pointed at the worker. The tailer keeps a live
        read-only twin the aggregation forecasts against.
        ``poll_timeout_s`` caps the source's adaptive per-poll
        deadline.

        The port has no ``storage/tailer`` yet: this raises."""
        raise NotImplementedError(
            "attach_feed_reader: the journal tailer (storage/tailer) and the "
            "HTTP client are not ported yet (ROADMAP A9)"
        )

    def _poll_readers(self) -> None:
        for reader in self.readers.values():
            poll = getattr(reader, "poll_once", None)
            if poll is None:
                continue
            try:
                poll()
            except Exception:  # noqa: BLE001 — a failed poll leaves the
                # previous twin serving; the worker scores stale or
                # unscorable, never breaks the pass
                continue

    def _degraded_mask(self, clusters):
        """bool[C] probation mask aligned to the snapshot's cluster
        order, from the dispatcher's latency health plane."""
        import numpy as np

        health = getattr(self.disp, "worker_health", None)
        mask = np.zeros(len(clusters), dtype=bool)
        if health is None:
            return mask, []
        probation = set(health.probation())
        for i, name in enumerate(clusters):
            mask[i] = name in probation
        return mask, sorted(probation & set(clusters))

    # ---- the loop ----
    def maybe_step(self) -> Optional[dict]:
        """Interval-gated rescore, called from every dispatcher pass."""
        now = self.runtime.clock.now()
        if (
            self.last_rescore_at is not None
            and now - self.last_rescore_at < self.rescore_interval_s
        ):
            return None
        return self.rescore()

    def rescore(self, apply: bool = True) -> dict:
        """One global pass: aggregate -> batched score -> (optionally)
        hysteresis-gated rebalances. Returns the pass report; with
        ``apply=False`` it is a pure read (the /global/standings and
        ``kueuectl pending-workloads --global`` payload)."""
        from kueue_tpu_torch.federation.aggregate import collect_global_snapshot
        from kueue_tpu_torch.ops.global_np import rescore_np

        now = self.runtime.clock.now()
        t_agg = _time.perf_counter()
        self._poll_readers()
        snap = collect_global_snapshot(self.disp, readers=self.readers)
        tta_ms, score, valid, current, rotation = snap.encode()
        aggregate_s = _time.perf_counter() - t_agg
        hysteresis_ms = int(round(self.hysteresis_s * 1000.0))
        degraded, degraded_names = self._degraded_mask(snap.clusters)
        penalty_ms = int(round(self.degraded_penalty_s * 1000.0))
        t0 = _time.perf_counter()
        path = "host"
        res = None
        if self.use_device and len(snap.keys) and len(snap.clusters):
            from kueue_tpu_torch.ops.global_kernel import rescore_pairs

            # no containment: a fault of B15 leaves the pass
            res = rescore_pairs(
                tta_ms, score, valid, current, rotation, hysteresis_ms,
                degraded=degraded, degraded_penalty_ms=penalty_ms,
                device=getattr(self.runtime, "device", None),
            )
            path = "device"
        if res is None:
            res = rescore_np(
                tta_ms, score, valid, current, rotation, hysteresis_ms,
                degraded=degraded, degraded_penalty_ms=penalty_ms,
            )
        duration_s = _time.perf_counter() - t0

        candidates: List[tuple] = []
        rows = []
        snap_rows = snap.to_dict()["workloads"]
        for i, key in enumerate(snap.keys):
            best = int(res.best[i])
            best_name = snap.clusters[best] if best >= 0 else None
            gain_ms = int(res.gain_ms[i])
            rebalance = bool(res.rebalance[i])
            rows.append(
                {
                    "workload": key,
                    "current": snap.current.get(key),
                    "fence": snap.fences.get(key, 0),
                    "best": best_name,
                    "gainS": round(gain_ms / 1000.0, 3),
                    "rebalance": rebalance,
                    "ttaByClusterS": snap_rows[i]["ttaByClusterS"],
                }
            )
            if rebalance and best_name is not None:
                candidates.append((gain_ms, key, best_name, i))
        applied = []
        if apply:
            # biggest forecast gain first; cap per pass so one noisy
            # rescore cannot thrash the whole federation at once
            candidates.sort(key=lambda t: (-t[0], t[1]))
            for gain_ms, key, target, i in candidates[
                : self.max_rebalances_per_pass
            ]:
                moved = self._rebalance(
                    key, target, snap.fences.get(key, -1), gain_ms, now
                )
                if moved:
                    applied.append(
                        {
                            "workload": key,
                            "from": snap.current.get(key),
                            "to": target,
                            "gainS": round(gain_ms / 1000.0, 3),
                        }
                    )
            self.rescores += 1
            self.last_rescore_at = now
        reachable = sum(
            1 for v in snap.workers.values() if v.reachable
        )
        report = {
            "at": now,
            "path": path,
            "durationMs": round(duration_s * 1e3, 3),
            "aggregateMs": round(aggregate_s * 1e3, 3),
            "pending": len(snap.keys),
            "clusters": list(snap.clusters),
            "degradedClusters": degraded_names,
            "reachableWorkers": reachable,
            "rebalanceCandidates": len(candidates),
            "rebalanced": applied,
            "workers": {
                name: v.to_dict() for name, v in snap.workers.items()
            },
            "workloads": rows,
        }
        m = getattr(self.runtime, "metrics", None)
        if m is not None and apply:
            m.global_rescore_total.inc()
            m.global_rescore_seconds.observe(duration_s)
            m.global_pending_workloads.set(len(snap.keys))
            m.global_workers_reachable.set(reachable)
        if apply:
            self.rescore_ms_total += duration_s * 1e3
            self.aggregate_ms_total += aggregate_s * 1e3
            self.last_report = report
        return report

    def _target_degraded(self, target: str) -> bool:
        health = getattr(self.disp, "worker_health", None)
        if health is None:
            return False
        from kueue_tpu_torch.federation.health import DEGRADED

        return health.state(target) == DEGRADED

    # ---- the move ----
    def _rebalance(
        self, key: str, target: str, observed_fence: int, gain_ms: int,
        now: float,
    ) -> bool:
        """Retract-and-redispatch one placement under its fencing
        epoch. Returns True when the move was applied."""
        m = getattr(self.runtime, "metrics", None)

        def skip(outcome: str) -> bool:
            if m is not None:
                m.global_rebalances_total.inc(outcome=outcome)
            return False

        st = self.disp.states.get(key)
        wl = self.runtime.workloads.get(key)
        if (
            st is None
            or wl is None
            or st.finished
            or st.fence == 0
            or wl.is_finished
            or wl.is_admitted
            or target not in self.disp.clusters
            # drain-ahead: a cordoned worker must not RECEIVE moves
            # (its own placements are being drained off it)
            or target in self.disp.cordoned
            # gray-failure probation: a worker the health plane holds
            # DEGRADED (apply-time check — it may have slipped into
            # probation since the snapshot scored) must not RECEIVE
            # moves either; its existing placements keep syncing
            or self._target_degraded(target)
            or st.winner == target
        ):
            return skip("skipped_gone")
        if st.winner is None and target in st.clusters:
            # still racing and the best cluster is already a target:
            # the first-reserving race covers it, nothing to move
            return skip("skipped_covered")
        moved_at = self._last_moved.get(key)
        if (
            moved_at is not None
            and now - moved_at < self.rebalance_cooldown_s
        ):
            return skip("skipped_cooldown")
        # CAS on the fencing epoch: the decision was computed against
        # the fence observed at aggregation; any movement since
        # (deposal, heal, concurrent rebalance) invalidates it
        observed = int(
            faults.transform("global.stale_fence", observed_fence)
        )
        if observed != st.fence:
            return skip("skipped_stale")
        old = st.winner or (st.clusters[0] if st.clusters else None)
        retract_from = sorted((set(st.clusters) | st.mirrored) - {target})
        st.winner = None
        st.fence += 1
        wl.labels.pop(WINNER_LABEL, None)
        # every old-epoch copy gets an at-least-once retraction under
        # the OLD fence — journaled before the new dispatch intent, so
        # a crash in the window below replays to "stale copies queued
        # for delete" and the dispatcher's deposal path converges
        for name in retract_from:
            self.disp._enqueue_retraction(key, name, st.fence - 1)
        faults.fire("global.rebalance_retract")
        st.clusters = [target]
        st.mirrored = set()
        self.disp._journal(
            DISPATCH_RECORD,
            {"key": st.key, "fence": st.fence, "clusters": st.clusters},
        )
        self.disp._set_pending(
            wl,
            f'rebalanced from "{old}" to "{target}" '
            f"(forecast gain {gain_ms / 1000.0:.1f}s, fence {st.fence})",
            now,
        )
        self.disp._trace_span(
            "global.rescore", key,
            {
                "from": old,
                "to": target,
                "fence": st.fence,
                "gainMs": gain_ms,
            },
        )
        self.runtime.event(
            "MultiKueueRebalanced", wl,
            f'The workload was rebalanced from "{old}" to "{target}" '
            f"(forecast gain {gain_ms / 1000.0:.1f}s, fence {st.fence})",
        )
        self.rebalances += 1
        self._last_moved[key] = now
        if m is not None:
            m.global_rebalances_total.inc(outcome="applied")
        return True

    # ---- surfaces ----
    def standings(self) -> dict:
        """The /global/standings payload: a fresh READ-ONLY rescore
        (no rebalances applied) plus the last applied pass."""
        report = self.rescore(apply=False)
        report["lastApplied"] = (
            {
                "at": self.last_report["at"],
                "rebalanced": self.last_report["rebalanced"],
                "rebalanceCandidates": self.last_report[
                    "rebalanceCandidates"
                ],
            }
            if self.last_report is not None
            else None
        )
        report["rescores"] = self.rescores
        report["rebalances"] = self.rebalances
        report["hysteresisS"] = self.hysteresis_s
        report["rescoreIntervalS"] = self.rescore_interval_s
        return report

    def status(self) -> dict:
        return {
            "rescores": self.rescores,
            "rebalances": self.rebalances,
            "lastRescoreAt": self.last_rescore_at,
            "hysteresisS": self.hysteresis_s,
            "rescoreIntervalS": self.rescore_interval_s,
            "readers": sorted(self.readers),
        }
