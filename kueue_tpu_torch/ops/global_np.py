"""Numpy mirror of the global rescore kernel (ops/global_kernel.py).

Identical int64 recurrences over identical tensors — the same
host-authority contract every kernel in ``KERNEL_MIRRORS`` keeps: the
global scheduler's device pass must be bit-for-bit reproducible here,
so the guard-style fallback (``GlobalScheduler(use_device=False)``)
and the parity property tests (tests/test_global_scheduler.py) can
hold the device path to an exact answer.
"""

from __future__ import annotations

import numpy as np

from kueue_tpu_torch.ops.global_kernel import (
    IDX_BITS,
    INVALID_KEY,
    MAX_CLUSTERS,
    SCORE_BITS,
    SCORE_HALF,
    TTA_CAP_MS,
    RescoreResult,
)

__all__ = ["rescore_np"]

_IDX_SHIFT = 1 << IDX_BITS
_TTA_SHIFT = 1 << (SCORE_BITS + IDX_BITS)


def rescore_np(
    tta_ms, score, valid, current, rotation, hysteresis_ms: int,
    degraded=None, degraded_penalty_ms: int = 0,
) -> RescoreResult:
    """The kernel's exact arithmetic in numpy: pack one int64 key per
    (workload, cluster) pair — (tta asc, score desc, rotated index
    asc) — argmin per row, hysteresis-gate the move. ``degraded``
    columns get ``degraded_penalty_ms`` added to their (clipped) TTA
    before packing, same as the device pass."""
    tta_ms = np.asarray(tta_ms, dtype=np.int64)
    score = np.asarray(score, dtype=np.int64)
    valid = np.asarray(valid, dtype=bool)
    current = np.asarray(current, dtype=np.int32)
    rotation = np.asarray(rotation, dtype=np.int32)
    w, c = tta_ms.shape
    if degraded is None:
        degraded = np.zeros(c, dtype=bool)
    degraded = np.asarray(degraded, dtype=bool)
    if w == 0 or c == 0:
        return RescoreResult(
            np.full(w, -1, dtype=np.int32),
            np.full(w, INVALID_KEY, dtype=np.int64),
            np.zeros(w, dtype=np.int64),
            np.zeros(w, dtype=bool),
        )
    if c > MAX_CLUSTERS:
        raise ValueError(
            f"{c} clusters exceeds the {MAX_CLUSTERS}-cluster key budget"
        )
    cols = np.arange(c, dtype=np.int64)[None, :]
    idx = (cols - rotation.astype(np.int64)[:, None]) % c
    penalty = degraded.astype(np.int64)[None, :] * np.int64(
        int(degraded_penalty_ms)
    )
    tta_c = np.clip(np.clip(tta_ms, 0, TTA_CAP_MS) + penalty, 0, TTA_CAP_MS)
    score_c = np.clip(score, -SCORE_HALF, SCORE_HALF - 1) + SCORE_HALF
    key = (
        tta_c * _TTA_SHIFT
        + ((1 << SCORE_BITS) - 1 - score_c) * _IDX_SHIFT
        + idx
    )
    key = np.where(valid, key, INVALID_KEY)
    best = np.argmin(key, axis=1).astype(np.int32)
    best_key = np.min(key, axis=1)
    has_best = best_key < INVALID_KEY
    best = np.where(has_best, best, np.int32(-1)).astype(np.int32)
    cur_col = np.clip(current, 0, c - 1).astype(np.int64)
    rows = np.arange(w)
    cur_valid = (current >= 0) & valid[rows, cur_col]
    cur_tta = tta_c[rows, cur_col]
    best_col = np.clip(best, 0, c - 1).astype(np.int64)
    best_tta = tta_c[rows, best_col]
    movable = cur_valid & has_best
    gain = np.where(movable, cur_tta - best_tta, np.int64(0))
    rebalance = (
        movable
        & (best != current.astype(np.int32))
        & (gain > np.int64(int(hysteresis_ms)))
    )
    return RescoreResult(best, best_key, gain, rebalance)
