"""The conflict-check contract that chains drain rounds (port of the
speculation functions of kueue_tpu/core/pipeline.py).

A drain round t+1 can be launched before round t's outcome is applied,
against a speculative snapshot: round t's snapshot with the kernel's
final leaf usage substituted (``speculative_snapshot``), over the
backlog round t left undecided. Correctness never rests on the
speculation: before a speculative result is trusted, its inputs are
compared with the real post-apply state (``drain_inputs_match``,
``pending_matches``); the megaloop's rounds are validated the same way.
``outcome_signature`` is the decision fingerprint two outcomes are
compared by.

The runtime loops that use them are
``controllers/cluster.ClusterRuntime._pipelined_bulk_drain`` and
``_megaloop_bulk_drain``; ``PipelineStats`` and ``MegaloopStats`` are
their accounting (the ``kueue_pipeline_*`` and ``kueue_megaloop_*``
metric sources).
"""

from __future__ import annotations

import copy
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclass
class PipelineStats:
    """Observable pipeline accounting (the ``kueue_pipeline_*`` metric
    source and the dashboard badge detail).

    Written by the drain thread mid-round while the server's request
    threads render ``to_dict`` (dashboard, SIGUSR2 dump) — so every
    mutation goes through a ``note_*`` method under ``_lock`` and
    ``to_dict`` snapshots under the same lock (a dump mid-round must
    never show ``overlapped_apply_s`` from round t with ``apply_s``
    from round t-1)."""

    rounds: int = 0  # guarded by: _lock
    prefetches: int = 0  # guarded by: _lock — speculative launches
    commits: int = 0  # guarded by: _lock — conflict check passed
    discards: int = 0  # guarded by: _lock — invalidated by the apply
    inflight: int = 0  # guarded by: _lock — launches in flight (0|1)
    apply_s: float = 0.0  # guarded by: _lock — host apply wall time
    overlapped_apply_s: float = 0.0  # guarded by: _lock
    solve_s: float = 0.0  # guarded by: _lock — blocked-on-fetch wall
    _lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False,
    )

    # ---- mutation API (the drain thread) ----
    def note_solve(self, seconds: float) -> None:
        with self._lock:
            self.solve_s += seconds

    def note_prefetch(self) -> None:
        with self._lock:
            self.prefetches += 1

    def note_apply(self, seconds: float, overlapped: bool) -> None:
        """One applied round: ``overlapped`` when a speculative solve
        was in flight during the apply."""
        with self._lock:
            self.rounds += 1
            self.apply_s += seconds
            if overlapped:
                self.overlapped_apply_s += seconds

    def note_commit(self) -> None:
        with self._lock:
            self.commits += 1

    def note_discard(self) -> None:
        with self._lock:
            self.discards += 1

    def set_inflight(self, n: int) -> None:
        with self._lock:
            self.inflight = n

    # ---- read API (request threads) ----
    def _overlap_ratio_locked(self) -> float:
        return (
            self.overlapped_apply_s / self.apply_s if self.apply_s > 0 else 0.0
        )

    @property
    def overlap_ratio(self) -> float:
        """Fraction of host apply time that ran with a device solve in
        flight — 1.0 means every apply was fully double-buffered."""
        with self._lock:
            return self._overlap_ratio_locked()

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "rounds": self.rounds,
                "prefetches": self.prefetches,
                "commits": self.commits,
                "discards": self.discards,
                "inflight": self.inflight,
                "overlapRatio": round(self._overlap_ratio_locked(), 4),
                "applyMs": round(self.apply_s * 1e3, 3),
                "overlappedApplyMs": round(
                    self.overlapped_apply_s * 1e3, 3
                ),
                "solveMs": round(self.solve_s * 1e3, 3),
            }


@dataclass
class MegaloopStats:
    """Observable megaloop accounting (the ``kueue_megaloop_*`` metric
    source, the dashboard badge and the SIGUSR2 section).

    Same threading contract as PipelineStats: the drain thread mutates
    mid-batch while request threads render ``to_dict`` — every write
    goes through a ``note_*`` method under ``_lock`` and ``to_dict``
    snapshots under the same lock."""

    launches: int = 0  # guarded by: _lock — fused dispatches
    rounds: int = 0  # guarded by: _lock — rounds committed (applied)
    device_rounds: int = 0  # guarded by: _lock — rounds the device computed
    truncations: int = 0  # guarded by: _lock — batches cut by a conflict miss
    exhausted: int = 0  # guarded by: _lock — full-K batches with work left
    last_k: int = 0  # guarded by: _lock — rounds-per-launch of the last launch
    last_rounds: int = 0  # guarded by: _lock — rounds the last launch shipped
    _lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False,
    )

    # ---- mutation API (the drain thread) ----
    def note_launch(self, k: int, device_rounds: int) -> None:
        with self._lock:
            self.launches += 1
            self.last_k = k
            self.device_rounds += device_rounds

    def note_committed(self, rounds: int) -> None:
        with self._lock:
            self.rounds += rounds
            self.last_rounds = rounds

    def note_truncation(self) -> None:
        with self._lock:
            self.truncations += 1

    def note_exhausted(self) -> None:
        with self._lock:
            self.exhausted += 1

    # ---- read API (request threads) ----
    def _rounds_per_launch_locked(self) -> float:
        return self.rounds / self.launches if self.launches else 0.0

    @property
    def rounds_per_launch(self) -> float:
        """Committed drain rounds amortized per fused dispatch — the
        megaloop's whole point; 1.0 means the fusion buys nothing."""
        with self._lock:
            return self._rounds_per_launch_locked()

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "launches": self.launches,
                "rounds": self.rounds,
                "deviceRounds": self.device_rounds,
                "truncations": self.truncations,
                "exhausted": self.exhausted,
                "lastK": self.last_k,
                "lastRounds": self.last_rounds,
                "roundsPerLaunch": round(
                    self._rounds_per_launch_locked(), 4
                ),
            }


def speculative_snapshot(snapshot, final_usage: np.ndarray):
    """Round t's snapshot with the kernel-reported final leaf usage
    substituted: the predicted post-apply state round t+1 solves
    against.

    Shallow copy: quota arrays, hierarchy and models are shared (an
    apply never mutates them); only ``local_usage`` is replaced and the
    usage-derived caches dropped so nothing stale leaks through."""
    spec = copy.copy(snapshot)
    spec.local_usage = np.asarray(final_usage, dtype=np.int64).copy()
    spec._usage_cache = None
    spec._avail_cache = None
    spec._drs_cache = None
    spec._tree_usage = None
    spec._usage_version = snapshot._usage_version + 1
    return spec


def drain_inputs_match(spec_snapshot, real_snapshot) -> bool:
    """The commit-time conflict check over everything the plain drain
    reads: hierarchy identity, quota tensors and leaf usage. If it
    passes, the speculative launch solved byte-identical inputs to the
    launch a serial loop would have made from ``real_snapshot``."""
    a, b = spec_snapshot, real_snapshot
    if a.flat.cq_names != b.flat.cq_names:
        return False
    if a.fr_list != b.fr_list or a.inactive_cqs != b.inactive_cqs:
        return False
    return (
        np.array_equal(a.flat.parent, b.flat.parent)
        and np.array_equal(a.nominal, b.nominal)
        and np.array_equal(a.lending_limit, b.lending_limit)
        and np.array_equal(a.borrowing_limit, b.borrowing_limit)
        and np.array_equal(a.local_usage, b.local_usage)
    )


def pending_matches(
    speculated: Sequence[Tuple[object, str]],
    actual: Sequence[Tuple[object, str]],
) -> bool:
    """Does the real post-apply backlog equal the one the speculative
    launch was planned over? Order matters within a ClusterQueue (heap
    order feeds the queue tensors by position) but not across them
    (plan_drain buckets per ClusterQueue)."""
    if len(speculated) != len(actual):
        return False

    def per_cq(items):
        by: Dict[str, List[str]] = {}
        for wl, cq in items:
            by.setdefault(cq, []).append(wl.key)
        return by

    return per_cq(speculated) == per_cq(actual)


def outcome_signature(outcome) -> dict:
    """Decision fingerprint of a DrainOutcome: everything that feeds the
    apply, nothing incidental."""
    def _fmap(flavors):
        # single-podset {res: flavor} or multi-podset {ps: {res: flavor}}
        return tuple(
            sorted(
                (k, tuple(sorted(v.items())) if isinstance(v, dict) else v)
                for k, v in flavors.items()
            )
        )

    return {
        "admitted": sorted(
            (wl.key, cq, _fmap(flavors), cycle)
            for wl, cq, flavors, cycle in outcome.admitted
        ),
        "parked": sorted((wl.key, cq) for wl, cq in outcome.parked),
        "fallback": sorted((wl.key, cq) for wl, cq in outcome.fallback),
        "cycles": outcome.cycles,
        "truncated": outcome.truncated,
    }
