"""NumPy mirrors of ops/quota.py.

The scheduler's host-side simulate/undo loops (preemption candidate
search) need quota evaluations at Python speed without device launch
overhead for tiny intermediate states. These functions implement the
identical level-scheduled recurrences as ops/quota.py (the tensor path
and the quota_tree kernel used by the drain); tests assert
cell-for-cell parity between the two.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from kueue_tpu_torch.ops.quota import NO_LIMIT


def _guaranteed(subtree: np.ndarray, lending_limit: np.ndarray) -> np.ndarray:
    has_lending = lending_limit < NO_LIMIT
    return np.where(has_lending, np.maximum(0, subtree - lending_limit), 0)


def _segment_to_parent(parent: np.ndarray, contrib: np.ndarray) -> np.ndarray:
    out = np.zeros_like(contrib)
    valid = parent >= 0
    np.add.at(out, parent[valid], contrib[valid])
    return out


def subtree_quota_np(
    parent: np.ndarray,
    level_mask: np.ndarray,
    nominal: np.ndarray,
    lending_limit: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    subtree = nominal.copy()
    for d in range(level_mask.shape[0] - 1, 0, -1):
        mask = level_mask[d][:, None]
        guaranteed_d = _guaranteed(subtree, lending_limit)
        contrib = np.where(mask, subtree - guaranteed_d, 0)
        subtree = subtree + _segment_to_parent(parent, contrib)
    return subtree, _guaranteed(subtree, lending_limit)


def usage_tree_np(
    parent: np.ndarray,
    level_mask: np.ndarray,
    guaranteed: np.ndarray,
    local_usage: np.ndarray,
) -> np.ndarray:
    usage = local_usage.copy()
    for d in range(level_mask.shape[0] - 1, 0, -1):
        mask = level_mask[d][:, None]
        contrib = np.where(mask, np.maximum(0, usage - guaranteed), 0)
        usage = usage + _segment_to_parent(parent, contrib)
    return usage


def available_all_np(
    parent: np.ndarray,
    level_mask: np.ndarray,
    subtree: np.ndarray,
    guaranteed: np.ndarray,
    borrowing_limit: np.ndarray,
    usage: np.ndarray,
) -> np.ndarray:
    avail = subtree - usage
    has_borrow = borrowing_limit < NO_LIMIT
    idx = np.maximum(parent, 0)
    for d in range(1, level_mask.shape[0]):
        mask = level_mask[d][:, None]
        parent_avail = avail[idx]
        stored = subtree - guaranteed
        used = np.maximum(0, usage - guaranteed)
        with_max = stored - used + borrowing_limit
        clamped = np.where(has_borrow, np.minimum(with_max, parent_avail), parent_avail)
        local = np.maximum(0, guaranteed - usage)
        avail = np.where(mask, local + clamped, avail)
    return avail


def potential_available_all_np(
    parent: np.ndarray,
    level_mask: np.ndarray,
    subtree: np.ndarray,
    guaranteed: np.ndarray,
    borrowing_limit: np.ndarray,
) -> np.ndarray:
    pot = subtree.copy()
    has_borrow = borrowing_limit < NO_LIMIT
    idx = np.maximum(parent, 0)
    for d in range(1, level_mask.shape[0]):
        mask = level_mask[d][:, None]
        parent_pot = pot[idx]
        v = guaranteed + parent_pot
        v = np.where(has_borrow, np.minimum(subtree + borrowing_limit, v), v)
        pot = np.where(mask, v, pot)
    return pot


def dominant_resource_share_np(
    parent: np.ndarray,
    level_mask: np.ndarray,
    subtree: np.ndarray,
    guaranteed: np.ndarray,
    borrowing_limit: np.ndarray,
    usage: np.ndarray,
    wl_req: np.ndarray,
    weight_milli: np.ndarray,
    resource_index: np.ndarray,
    n_resources: int,
) -> Tuple[np.ndarray, np.ndarray]:
    from kueue_tpu_torch.ops.quota import DRS_MAX

    n = parent.shape[0]
    borrowed_fr = np.maximum(0, wl_req + usage - subtree)
    borrowed = np.zeros((n, n_resources), dtype=np.int64)
    for j, r in enumerate(resource_index):
        borrowed[:, r] += borrowed_fr[:, j]

    pot = potential_available_all_np(parent, level_mask, subtree, guaranteed, borrowing_limit)
    idx = np.maximum(parent, 0)
    parent_pot = pot[idx]
    lendable = np.zeros((n, n_resources), dtype=np.int64)
    for j, r in enumerate(resource_index):
        lendable[:, r] += parent_pot[:, j]
    lendable = np.where((parent >= 0)[:, None], lendable, 0)

    ratio = np.where(
        (borrowed > 0) & (lendable > 0),
        borrowed * 1000 // np.maximum(lendable, 1),
        -1,
    )
    drs = ratio.max(axis=1)
    dominant = ratio.argmax(axis=1).astype(np.int32)

    active = (borrowed > 0).any(axis=1) & (parent >= 0)
    zero_weight = weight_milli == 0
    num = drs * 1000
    den = np.maximum(weight_milli, 1)
    trunc_div = np.sign(num) * (np.abs(num) // den)
    dws = np.where(active, np.where(zero_weight, DRS_MAX, trunc_div), 0)
    dominant = np.where(active & (drs >= 0), dominant, -1)
    return dws, dominant
