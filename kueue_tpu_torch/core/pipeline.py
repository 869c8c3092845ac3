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

The runtime loops that use them (the pipelined and megaloop drain
loops) and their accounting (``PipelineStats``, ``MegaloopStats``) are
not ported yet.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Sequence, Tuple

import numpy as np


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
