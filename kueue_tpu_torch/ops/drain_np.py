"""NumPy mirror of the plain bulk drain (port of
kueue_tpu/ops/drain_np.py; only the imports differ).

Identical int64 recurrences over identical arrays: ``solve_drain_np``
decides what ops/drain_kernel.solve_drain decides, with ``max_cycles``
an input, the cursor routing unreached entries to the undecided set
as the kernel does, and the final ``local_usage`` in the result. It is
the host authority of the megaloop's numpy twin (ops/megaloop_np.py,
``core/drain.run_drain_megaloop_host``).

Scope matches the plain kernel exactly: multi-podset nomination with
policy-aware group walks and cursor resume, the (borrowing, priority,
timestamp) admission order, capacity reservation for blocked
preempt-mode heads, PendingFlavors retry budgets and stuck detection.

Sequential-vs-segmented equivalence: the kernel's phase 2 runs root
cohorts side by side, but they touch disjoint node rows, so processing
heads sequentially in the global entry order, as this mirror does,
produces the identical final state.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from kueue_tpu_torch.ops.quota import NO_LIMIT
from kueue_tpu_torch.ops.quota_np import (
    available_all_np,
    potential_available_all_np,
    subtree_quota_np,
    usage_tree_np,
)


class DrainResultNP(NamedTuple):
    """solve_drain's DrainResult with numpy arrays."""

    admitted_k: np.ndarray  # int32[Q,L,P]
    admitted_cycle: np.ndarray  # int32[Q,L]
    cursor: np.ndarray  # int32[Q]
    cycles: int
    local_usage: np.ndarray  # int64[N,FR]
    stuck: np.ndarray  # bool[Q]


def _avail_along_path_np(
    path, cells, usage, subtree, guaranteed, borrowing_limit, max_depth
):
    """available() at the path's leaf, root-down over the ancestor path
    (the planner's mirror of assign_kernel._avail_along_path)."""
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


def _bubble_usage_np(path, cells, delta, usage, guaranteed, max_depth):
    """addUsage bubble-up along one ancestor path (in place)."""
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


def _cell_masks_np(
    nominal, parent, subtree, guaranteed, local, cq_row, cells, qty,
    avail, potential,
):
    """Per-cell classification against the cycle-start snapshot — the
    numpy twin of assign_kernel.cell_masks (default policy: no pwb)."""
    cq = np.maximum(cq_row, 0)
    cell_need = (cells >= 0) & (qty > 0)
    cc = np.maximum(cells, 0)
    avail_wkc = avail[cq[:, None, None], cc]
    potential_wkc = potential[cq[:, None, None], cc]
    local_wkc = local[cq[:, None, None], cc]
    subtree_wkc = subtree[cq[:, None, None], cc]
    nominal_wkc = nominal[cq[:, None, None], cc]
    has_cohort = (parent[cq] >= 0)[:, None]

    fit_cells = np.where(cell_need, avail_wkc >= qty, True)
    pot_cells = np.where(
        cell_need, (qty <= potential_wkc) & (qty <= nominal_wkc), True
    )
    reclaim_cells = np.where(cell_need, local_wkc + qty <= nominal_wkc, True)
    borrow_cells = (
        np.where(cell_need, local_wkc + qty > subtree_wkc, False)
        & has_cohort[..., None]
    )
    return fit_cells, pot_cells, reclaim_cells, borrow_cells, cell_need


def _group_walk_np(
    gid, gl, gmask, head_valid, fit_cells, pot_cells, reclaim_cells,
    borrow_cells, ffb, ffp, score=None,
):
    """drain_kernel._group_walk, jnp → np verbatim (including the
    policy score-argmax: all-zero/absent scores reduce to the
    earliest-flavor choice bit-for-bit)."""
    inf = np.int32(2**30)
    neg = np.int64(-(2**62))
    sc = (
        score if score is not None else np.zeros(head_valid.shape, np.int64)
    )[:, :, None]  # [Q,K,1]
    valid3 = head_valid[:, :, None]  # [Q,K,1]
    cellmode = np.where(
        fit_cells,
        3,
        np.where(pot_cells & reclaim_cells, 2, np.where(pot_cells, 1, 0)),
    ).astype(np.int32)
    gmode = np.min(
        np.where(gmask, cellmode[..., None], 3), axis=2
    )  # [Q,K,G]
    gborrow = np.any(np.where(gmask, borrow_cells[..., None], False), axis=2)
    borrow_ok = ~gborrow | ffb[:, None, None]
    stop = valid3 & (
        ((gmode == 3) & borrow_ok)
        | ((gmode == 1) | (gmode == 2)) & ffp[:, None, None] & borrow_ok
    )
    stop_sc = np.where(stop, sc, neg)  # [Q,K,G]
    stop_best = np.max(stop_sc, axis=1)  # [Q,G]
    stop_sel = stop & (stop_sc == stop_best[:, None, :])
    stop_idx = np.min(np.where(stop_sel, gid, inf), axis=1)  # [Q,G]
    stopped = stop_idx < inf
    best_mode = np.max(np.where(valid3, gmode, -1), axis=1)  # [Q,G]
    bm_sel = valid3 & (gmode == best_mode[:, None, :])
    bm_sc = np.where(bm_sel, sc, neg)
    bm_best = np.max(bm_sc, axis=1)  # [Q,G]
    best_idx = np.min(
        np.where(bm_sel & (bm_sc == bm_best[:, None, :]), gid, inf), axis=1
    )
    choice_idx = np.where(stopped, stop_idx, best_idx)  # [Q,G]
    at_choice = valid3 & (gid == choice_idx[:, None, :])
    choice_mode = np.max(
        np.where(at_choice, gmode, -1), axis=1
    )  # [Q,G]
    have = (choice_idx < inf) & (choice_mode >= 1)
    head_mode = np.min(np.where(have, choice_mode, 0), axis=1)  # [Q]
    match = head_valid & np.all(gid == choice_idx[:, None, :], axis=-1)
    has_rep = np.any(match, axis=1)
    k_rep = np.argmax(match, axis=1).astype(np.int32)
    chosen = np.where((head_mode == 3) & has_rep, k_rep, -1)
    pre_k = np.where(
        ((head_mode == 1) | (head_mode == 2)) & has_rep, k_rep, -1
    )
    is_last = np.any(at_choice & gl, axis=1)
    tried = np.where(stopped & ~is_last, choice_idx, -1)
    pending = np.any(tried >= 0, axis=1)
    next_start = (tried + 1).astype(np.int32)
    return chosen, pre_k, pending, next_start


def _nominate_multi_np(
    nominal, parent, subtree, guaranteed, local, usage0, queues, cur,
    active, g_start, potential,
):
    """drain_kernel._nominate_multi, jnp → np (plain scope: no victim
    veto, no preempt-while-borrowing)."""
    q, l, pmax, k, c = queues["cells"].shape
    q_idx = np.arange(q)
    avail0 = available_all_np(
        parent, queues["level_mask"], subtree, guaranteed,
        queues["borrowing"], usage0,
    )
    g = queues["gidx"].shape[-1]
    n_fr = local.shape[1]
    head_cq = np.where(active, queues["cq_rows"], -1).astype(np.int32)

    accum = np.zeros((q, n_fr), dtype=np.int64)
    processed = np.ones(q, dtype=bool)
    head_mode = np.full(q, 3, dtype=np.int32)
    head_borrow = np.zeros(q, dtype=bool)
    pending = np.zeros(q, dtype=bool)
    rep_list, nstart_list, cells_list, qty_list = [], [], [], []
    npod = queues["n_podsets"][q_idx, cur]  # [Q]

    for p in range(pmax):
        real = active & (p < npod)
        cells_p = queues["cells"][q_idx, cur, p]  # [Q,K,C]
        qty_p = queues["qty"][q_idx, cur, p]
        if p == 0:
            infl = qty_p
        else:
            accum_at = accum[q_idx[:, None, None], np.maximum(cells_p, 0)]
            infl = qty_p + np.where((cells_p >= 0) & (qty_p > 0), accum_at, 0)
        fit_cells, pot_cells, reclaim_cells, borrow_cells, _need = (
            _cell_masks_np(
                nominal, parent, subtree, guaranteed, local, head_cq,
                cells_p, infl, avail0, potential,
            )
        )
        gid_p = queues["gidx"][q_idx, cur, p]
        gl_p = queues["glast"][q_idx, cur, p]
        cg_p = queues["cgrp"][q_idx, cur, p]
        gmask_p = cg_p[..., None] == np.arange(g)[None, None, None, :]
        k_mask_p = np.all(gid_p >= g_start[:, p][:, None, :], axis=-1)
        valid_p = queues["valid"][q_idx, cur, p] & real[:, None] & k_mask_p
        score_np = queues.get("score")
        score_p = score_np[q_idx, cur, p] if score_np is not None else None
        chosen_p, pre_p, pending_p, nstart_p = _group_walk_np(
            gid_p, gl_p, gmask_p, valid_p, fit_cells, pot_cells,
            reclaim_cells, borrow_cells, queues["ffb"], queues["ffp"],
            score=score_p,
        )
        live = real & processed
        mode_p = np.where(chosen_p >= 0, 3, np.where(pre_p >= 0, 1, 0))
        mode_p = np.where(live, mode_p, 3)
        rep_p = np.where(chosen_p >= 0, chosen_p, pre_p)
        use_p = live & (rep_p >= 0)
        rep_safe = np.maximum(rep_p, 0)
        cells_rep = np.take_along_axis(
            cells_p, rep_safe[:, None, None], axis=1
        )[:, 0]  # [Q,C]
        qty_rep = np.take_along_axis(qty_p, rep_safe[:, None, None], axis=1)[:, 0]
        cells_rep = np.where(use_p[:, None] & (cells_rep >= 0), cells_rep, -1)
        qty_rep = np.where(cells_rep >= 0, qty_rep, 0)
        if p < pmax - 1:
            np.add.at(
                accum,
                (q_idx[:, None], np.maximum(cells_rep, 0)),
                np.where(cells_rep >= 0, qty_rep, 0),
            )
        borrow_rep = np.any(
            np.take_along_axis(borrow_cells, rep_safe[:, None, None], axis=1)[
                :, 0
            ]
            & (cells_rep >= 0),
            axis=1,
        )
        head_borrow = head_borrow | (borrow_rep & use_p)
        pending = pending | (pending_p & live)
        head_mode = np.minimum(head_mode, mode_p)
        processed = processed & (mode_p >= 1)
        rep_list.append(np.where(use_p, rep_p, -1))
        nstart_list.append(np.where(live[:, None], nstart_p, 0))
        cells_list.append(cells_rep)
        qty_list.append(qty_rep)

    rep_k = np.stack(rep_list, axis=1)  # [Q,P]
    next_start = np.stack(nstart_list, axis=1)  # [Q,P,G]
    mcells = np.concatenate(cells_list, axis=1)  # [Q,P*C]
    mqty = np.concatenate(qty_list, axis=1)
    if pmax > 1:
        pc = pmax * c
        pos = np.arange(pc)
        same = (mcells[:, None, :] == mcells[:, :, None]) & (mcells >= 0)[:, None, :]
        summed = np.sum(np.where(same, mqty[:, None, :], 0), axis=2)
        first = ~np.any(
            same & (pos[None, None, :] < pos[None, :, None]), axis=2
        )
        mqty = np.where(first & (mcells >= 0), summed, 0)
        mcells = np.where(first, mcells, -1)

    is_fit = active & (head_mode == 3)
    is_pre = active & (head_mode >= 1) & (head_mode < 3)
    pend = pending & is_pre
    return is_fit, is_pre, pend, head_borrow, rep_k, next_start, mcells, mqty


def solve_drain_np(
    parent: np.ndarray,
    level_mask: np.ndarray,
    nominal: np.ndarray,
    lending: np.ndarray,
    borrowing: np.ndarray,
    local_usage: np.ndarray,  # int64[N,FR] starting leaf usage
    queues_np: dict,  # DrainQueues layout (plan_drain.queues_np)
    paths: np.ndarray,  # int32[N, D+1]
    max_depth: int,
    max_cycles: int,
) -> DrainResultNP:
    """The plain multi-cycle drain on the host, bit-for-bit."""
    subtree, guaranteed = subtree_quota_np(parent, level_mask, nominal, lending)
    potential = potential_available_all_np(
        parent, level_mask, subtree, guaranteed, borrowing
    )

    q, l, pmax, k, c = queues_np["cells"].shape
    g = queues_np["gidx"].shape[-1]
    q_idx = np.arange(q)
    qlen = queues_np["qlen"]
    cq = np.maximum(queues_np["cq_rows"], 0)
    # the nominator reads these through one dict (plus the structural
    # arrays the queue tensors don't carry)
    queues = dict(queues_np)
    queues["level_mask"] = level_mask
    queues["borrowing"] = borrowing

    local = local_usage.copy()
    cursor = np.zeros(q, dtype=np.int32)
    g_start = np.zeros((q, pmax, g), dtype=np.int32)
    retries = np.zeros(q, dtype=np.int32)
    stuck = np.zeros(q, dtype=bool)
    no_prog = 0
    adm_k = np.full((q, l, pmax), -1, dtype=np.int32)
    adm_cycle = np.full((q, l), -1, dtype=np.int32)
    cycle = 0

    while np.any((cursor < qlen) & ~stuck) and cycle < max_cycles:
        active = cursor < qlen
        cur = np.minimum(cursor, l - 1)
        usage0 = usage_tree_np(parent, level_mask, guaranteed, local)
        (is_fit, is_pre, pend, head_borrow, rep_k, walk_next,
         cells_eff, qty_eff) = _nominate_multi_np(
            nominal, parent, subtree, guaranteed, local, usage0, queues,
            cur, active, g_start, potential,
        )
        nofit = ~(is_fit | is_pre)

        prio = queues_np["priority"][q_idx, cur]
        ts = queues_np["timestamp"][q_idx, cur]
        order = np.lexsort(
            (ts, -prio, head_borrow.astype(np.int64), nofit.astype(np.int64))
        )

        # sequential admit in global entry order (segments are disjoint
        # trees, so this equals the kernel's segmented interleaving)
        usage_t = usage0.copy()
        admitted = np.zeros(q, dtype=bool)
        for qi in order:
            qi = int(qi)
            if not active[qi] or queues_np["seg_id"][qi] < 0 or nofit[qi]:
                continue
            path = paths[cq[qi]]
            cells_ = cells_eff[qi]
            qty_ = qty_eff[qi]
            ccells = np.maximum(cells_, 0)
            cell_valid = (cells_ >= 0) & (qty_ > 0)
            a = _avail_along_path_np(
                path, ccells, usage_t, subtree, guaranteed, borrowing,
                max_depth,
            )
            fits = bool(np.all(np.where(cell_valid, a >= qty_, True)))
            if is_fit[qi] and fits:
                admitted[qi] = True
                _bubble_usage_np(
                    path, ccells, np.where(cell_valid, qty_, 0),
                    usage_t, guaranteed, max_depth,
                )
            elif is_pre[qi] and queues_np["no_reclaim"][qi]:
                nominal_c = nominal[cq[qi], ccells]
                bl_c = borrowing[cq[qi], ccells]
                leaf_c = usage_t[cq[qi], ccells]
                borrow_cap = np.where(
                    bl_c < NO_LIMIT,
                    np.minimum(qty_, nominal_c + bl_c - leaf_c),
                    qty_,
                )
                nominal_cap = np.maximum(
                    0, np.minimum(qty_, nominal_c - leaf_c)
                )
                reserve_qty = borrow_cap if head_borrow[qi] else nominal_cap
                _bubble_usage_np(
                    path, ccells, np.where(cell_valid, reserve_qty, 0),
                    usage_t, guaranteed, max_depth,
                )

        # leaf usage adds for admissions only (reservations die with
        # the cycle; interior rows rebuild from leaves next cycle)
        cell_valid = (cells_eff >= 0) & (qty_eff > 0)
        add = np.where(cell_valid & admitted[:, None], qty_eff, 0)
        np.add.at(local, (cq[:, None], np.maximum(cells_eff, 0)), add)

        # ---- cursor motion (drain_kernel._cursor_queue_motion) ----
        over_budget = retries >= queues_np["retry_cap"]
        stuck = stuck | (active & (~is_fit) & pend & over_budget)
        resolve = active & (admitted | ((~is_fit) & ~pend))
        stuck = stuck & ~resolve
        retrying = active & (~is_fit) & pend & ~stuck
        advance = resolve
        retries = np.where(
            advance | ~active, 0, np.where(retrying, retries + 1, retries)
        )
        no_prog = 0 if bool(np.any(advance)) else no_prog + 1
        stuck = stuck | (
            (no_prog >= 2 * int(np.max(queues_np["retry_cap"])))
            & active
            & ~advance
        )
        sel = admitted & active
        adm_k[q_idx, cur] = np.where(
            sel[:, None], rep_k, adm_k[q_idx, cur]
        )
        adm_cycle[q_idx, cur] = np.where(sel, cycle, adm_cycle[q_idx, cur])
        lost = active & is_fit & (~admitted)
        g_start = np.where(
            advance[:, None, None],
            0,
            np.where((lost | retrying)[:, None, None], walk_next, g_start),
        ).astype(np.int32)
        cursor = cursor + advance.astype(np.int32)
        cycle += 1

    return DrainResultNP(
        admitted_k=adm_k,
        admitted_cycle=adm_cycle,
        cursor=cursor,
        cycles=cycle,
        local_usage=local,
        stuck=stuck,
    )
