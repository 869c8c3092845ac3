"""Host mirror of the cycle solve (port of kueue_tpu/planner/engine.py,
partial).

This slice carries only what the solver guard's host authority
(``core/guard.solve_lowered_host``) needs: ``solve_scenario_host`` and
its numpy helpers, a sequential numpy replay of one cycle batch with
the same int64 recurrences as the device solve. The planner itself
(scenarios, sweeps, forecasts) is not ported yet.
"""

from __future__ import annotations

import numpy as np

from kueue_tpu_torch.ops.quota import NO_LIMIT
from kueue_tpu_torch.ops.quota_np import (
    available_all_np,
    potential_available_all_np,
    subtree_quota_np,
    usage_tree_np,
)


def _avail_along_path_np(
    path: np.ndarray,  # int32[D+1], -1 padded
    cells: np.ndarray,  # int32[C] (clamped by caller)
    usage: np.ndarray,  # int64[N, FR] full tree
    subtree: np.ndarray,
    guaranteed: np.ndarray,
    borrowing_limit: np.ndarray,
    max_depth: int,
) -> np.ndarray:
    valid = path >= 0
    root_pos = int(valid.sum()) - 1
    avail = np.zeros(cells.shape[0], dtype=np.int64)
    for d in range(max_depth, -1, -1):
        if not valid[d]:
            continue
        node = int(path[d])
        if d == root_pos:
            avail = subtree[node, cells] - usage[node, cells]
            continue
        stored = subtree[node, cells] - guaranteed[node, cells]
        used = np.maximum(0, usage[node, cells] - guaranteed[node, cells])
        with_max = stored - used + borrowing_limit[node, cells]
        has_borrow = borrowing_limit[node, cells] < NO_LIMIT
        clamped = np.where(has_borrow, np.minimum(with_max, avail), avail)
        avail = np.maximum(0, guaranteed[node, cells] - usage[node, cells]) + clamped
    return avail


def _bubble_usage_np(
    path: np.ndarray,
    cells: np.ndarray,
    delta: np.ndarray,  # int64[C], already masked by cell validity
    usage: np.ndarray,
    guaranteed: np.ndarray,
    max_depth: int,
) -> None:
    delta = delta.copy()
    for d in range(0, max_depth + 1):
        if path[d] < 0:
            break
        node = int(path[d])
        old = usage[node, cells].copy()
        g = guaranteed[node, cells]
        new = old + delta
        np.add.at(usage, (node, cells), delta)
        delta = np.maximum(0, new - g) - np.maximum(0, old - g)
        if not delta.any():
            break


def solve_scenario_host(
    parent: np.ndarray,
    level_mask: np.ndarray,
    nominal: np.ndarray,
    lending: np.ndarray,
    borrowing: np.ndarray,
    local_usage: np.ndarray,
    batch,  # numpy HeadsBatch
    paths: np.ndarray,
    max_depth: int,
) -> dict:
    """Pure-numpy mirror of one scenario's device solve — identical
    int64 recurrences over identical arrays, so the device path is
    verifiable bit-for-bit. Sequential over the global entry order
    (solve_cycle semantics; segmented interleavings touch disjoint
    trees, so final state matches — property-tested for the kernel)."""
    w = batch.cq_row.shape[0]
    subtree, guaranteed = subtree_quota_np(parent, level_mask, nominal, lending)
    usage = usage_tree_np(parent, level_mask, guaranteed, local_usage)
    avail = available_all_np(
        parent, level_mask, subtree, guaranteed, borrowing, usage
    )
    potential = potential_available_all_np(
        parent, level_mask, subtree, guaranteed, borrowing
    )

    cq = np.maximum(batch.cq_row, 0)
    cell_need = (batch.cells >= 0) & (batch.qty > 0)
    cells = np.maximum(batch.cells, 0)
    avail_wkc = avail[cq[:, None, None], cells]
    subtree_wkc = subtree[cq[:, None, None], cells]
    local_wkc = local_usage[cq[:, None, None], cells]
    potential_wkc = potential[cq[:, None, None], cells]
    nominal_wkc = nominal[cq[:, None, None], cells]

    fits = np.all(np.where(cell_need, avail_wkc >= batch.qty, True), axis=-1)
    pot_fits = np.all(
        np.where(
            cell_need,
            (batch.qty <= potential_wkc) & (batch.qty <= nominal_wkc),
            True,
        ),
        axis=-1,
    )
    has_cohort = (parent[cq] >= 0)[:, None]
    borrows_wk = (
        np.any(
            np.where(cell_need, local_wkc + batch.qty > subtree_wkc, False),
            axis=-1,
        )
        & has_cohort
    )

    populated = batch.cq_row >= 0
    # masked score-argmax (kueue_tpu/policy) — np.argmax's first-max
    # tie-break keeps the walk order, so all-zero/absent scores are
    # the boolean first-fit argmax bit-for-bit (the kernel's rule)
    score = getattr(batch, "score", None)
    if score is None:
        score = np.int64(0)
    neg = np.int64(-(2**62))
    fit_ok = fits & batch.valid
    first_fit = np.argmax(np.where(fit_ok, score, neg), axis=1)
    chosen = np.where(
        fit_ok.any(axis=1) & populated, first_fit, -1
    ).astype(np.int32)
    pre_ok = pot_fits & batch.valid
    preempt_k = np.where(
        pre_ok.any(axis=1) & populated & (chosen < 0),
        np.argmax(np.where(pre_ok, score, neg), axis=1),
        -1,
    ).astype(np.int32)

    eff_k = np.where(chosen >= 0, chosen, preempt_k)
    eff_safe = np.maximum(eff_k, 0)
    head_borrow = (
        np.take_along_axis(borrows_wk, eff_safe[:, None], axis=1)[:, 0]
        & (eff_k >= 0)
    )
    nofit = eff_k < 0
    order = np.lexsort(
        (
            batch.timestamp,
            -batch.priority,
            head_borrow.astype(np.int64),
            nofit.astype(np.int64),
        )
    )
    cells_eff = np.take_along_axis(
        batch.cells, eff_safe[:, None, None], axis=1
    )[:, 0]
    qty_eff = np.take_along_axis(batch.qty, eff_safe[:, None, None], axis=1)[:, 0]

    usage_t = usage.copy()
    admitted = np.zeros(w, dtype=bool)
    reserved = np.zeros(w, dtype=bool)
    for wi in order:
        if batch.cq_row[wi] < 0:
            continue
        cqs = int(cq[wi])
        path = paths[cqs]
        ccells = np.maximum(cells_eff[wi], 0)
        qty = qty_eff[wi]
        cell_valid = (cells_eff[wi] >= 0) & (qty > 0)

        a = _avail_along_path_np(
            path, ccells, usage_t, subtree, guaranteed, borrowing, max_depth
        )
        step_fits = bool(np.all(np.where(cell_valid, a >= qty, True)))
        if chosen[wi] >= 0 and step_fits:
            admitted[wi] = True
            _bubble_usage_np(
                path, ccells, np.where(cell_valid, qty, 0),
                usage_t, guaranteed, max_depth,
            )
            continue
        if chosen[wi] < 0 and preempt_k[wi] >= 0 and batch.no_reclaim[wi]:
            reserved[wi] = True
            nominal_c = nominal[cqs, ccells]
            bl_c = borrowing[cqs, ccells]
            leaf_c = usage_t[cqs, ccells]
            borrow_cap = np.where(
                bl_c < NO_LIMIT,
                np.minimum(qty, nominal_c + bl_c - leaf_c),
                qty,
            )
            nominal_cap = np.maximum(0, np.minimum(qty, nominal_c - leaf_c))
            reserve_qty = borrow_cap if head_borrow[wi] else nominal_cap
            _bubble_usage_np(
                path, ccells, np.where(cell_valid, reserve_qty, 0),
                usage_t, guaranteed, max_depth,
            )
    return {
        "chosen": chosen,
        "admitted": admitted,
        "borrows": head_borrow,
        "reserved": reserved,
        "order": order.astype(np.int32),
        "preempt_k": preempt_k,
        "usage": usage_t,
    }
