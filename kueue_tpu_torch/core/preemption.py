"""Preemption helpers (port of kueue_tpu/core/preemption.py, partial).

This slice carries only ``can_always_reclaim``, which the drain's
lowering (core/solver.py) reads to decide which blocked heads reserve
capacity. The host ``Preemptor`` (classic and fair victim search) needs
the scheduler and is not ported yet.
"""

from __future__ import annotations

from kueue_tpu_torch.models.constants import ReclaimWithinCohortPolicy


def can_always_reclaim(cq) -> bool:
    """preemption.CanAlwaysReclaim: reclaimWithinCohort=Any guarantees
    capacity can be taken back later, so no reservation is needed."""
    return cq.preemption.reclaim_within_cohort == ReclaimWithinCohortPolicy.ANY
