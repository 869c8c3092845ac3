"""Multi-cycle admission drain — the plain bulk drain on the card.

Port of the plain ``solve_drain`` of kueue_tpu/ops/drain_kernel.py.
Per-CQ pending queues are dense tensors; each cycle reproduces the
reference's semantics (pkg/scheduler/scheduler.go:176-310) for
preemption-free drains:

- heads: each CQ's queue front (one head per CQ per cycle);
- nomination: the per-group flavor walk against cycle-start usage,
  podsets in order (``drain_nominate``);
- conflict resolution: the reference's entry order (borrowing asc,
  priority desc, timestamp asc) within each root cohort, independent
  root cohorts in parallel (``drain_phase2``);
- queue motion: admitted heads leave, NoFit heads park, conflict losers
  and PendingFlavors heads retry from their stored cursors, provably
  cycling queues freeze as stuck (``drain_queue_motion``);
- capacity reservation: blocked preempt-mode heads of queues with
  reclaimWithinCohort != Any reserve within their cycle; the usage
  tree is rebuilt from leaf rows every cycle, so reservations die with
  the cycle.

Each cycle is five launches on the card: kernel 1 (``quota_tree``,
ops/quota.py) twice for the cycle-start usage tree and availability,
then kernels 2-4 below. Every wrapper launches its CUDA kernel for a
CUDA tensor (or raises) and runs the plain torch version beside it for
a CPU tensor; plain and kernel share one in-place interface over
``DrainState`` and ``CycleBuffers``, so ``solve_drain`` is one loop for
both. Kernel 4 keeps the cycle counter and a ``done`` flag on the
device; every launch returns at once when ``done`` is set, so the host
checks the flag only every few cycles and ``cycles`` stays exact.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, fields
from typing import NamedTuple, Optional


from kueue_tpu_torch._torch import BOOL, I32, I64, torch
from kueue_tpu_torch.ops import _build
from kueue_tpu_torch.ops.assign_kernel import (
    Segments,
    _avail_along_path,
    _lexsort,
    build_segments,
    cell_masks,
    segmented_rank,
)
from kueue_tpu_torch.ops.quota import (
    NO_LIMIT,
    QuotaTree,
    available_all,
    potential_available_all,
    subtree_quota,
    usage_tree,
)

# Widest shapes the CUDA kernels take (per-thread arrays are static):
# candidates K, cells C, resource groups G, podsets P; P*C <= 32 lanes.
MAX_K, MAX_C, MAX_G, MAX_P = 16, 8, 8, 4


class DrainQueues(NamedTuple):
    """Per-ClusterQueue pending queues, densely packed.

    Q queues, L max queue length, P podsets, K flavor candidates, C
    cells per candidate, G resource groups.

    cq_rows:  int32[Q]   — tree row of each queue's ClusterQueue.
    seg_id:   int32[Q]   — compact root-cohort id (-1: no segment).
    qlen:     int32[Q]   — live entries in each queue.
    cells:    int32[Q,L,P,K,C] / qty: int64[Q,L,P,K,C] — each entry's
              lowered flavor candidates; valid: bool[Q,L,P,K].
    gidx:     int32[Q,L,P,K,G] — candidate k's flavor index within each
              of the entry's resource-group walks.
    glast:    bool[Q,L,P,K,G] — that flavor is the last of its group.
    cgrp:     int8[Q,L,P,K,C] — resource-group index of each cell (-1).
    n_podsets: int32[Q,L] — real podsets per entry.
    ffb/ffp:  bool[Q] — flavorFungibility whenCanBorrow == Borrow /
              whenCanPreempt == Preempt.
    retry_cap: int32[Q] — PendingFlavors retry budget.
    priority / timestamp: int64[Q,L] — entry order keys.
    no_reclaim: bool[Q] — the CQ reserves capacity when blocked.
    score:    int64[Q,L,P,K] admission-policy scores, or None (= zeros).
    """

    cq_rows: torch.Tensor
    seg_id: torch.Tensor
    qlen: torch.Tensor
    cells: torch.Tensor
    qty: torch.Tensor
    valid: torch.Tensor
    gidx: torch.Tensor
    glast: torch.Tensor
    cgrp: torch.Tensor
    n_podsets: torch.Tensor
    ffb: torch.Tensor
    ffp: torch.Tensor
    retry_cap: torch.Tensor
    priority: torch.Tensor
    timestamp: torch.Tensor
    no_reclaim: torch.Tensor
    score: Optional[torch.Tensor] = None


class DrainResult(NamedTuple):
    """admitted_k: int32[Q,L,P] chosen candidate per podset (-1 = never
    admitted); admitted_cycle: int32[Q,L]; cursor: int32[Q] final queue
    position; cycles: int32[1]; local_usage: int64[N,FR] final leaf
    usage; stuck: bool[Q] frozen PendingFlavors spinners."""

    admitted_k: torch.Tensor
    admitted_cycle: torch.Tensor
    cursor: torch.Tensor
    cycles: torch.Tensor
    local_usage: torch.Tensor
    stuck: torch.Tensor


@dataclass
class DrainState:
    """The loop state carried across cycles (all on one device)."""

    local: torch.Tensor  # int64[N,FR] leaf usage
    cursor: torch.Tensor  # int32[Q]
    g_start: torch.Tensor  # int32[Q,P,G] per-group resume starts
    retries: torch.Tensor  # int32[Q]
    stuck: torch.Tensor  # bool[Q]
    no_prog: torch.Tensor  # int32[1] cycles without any advance
    adm_k: torch.Tensor  # int32[Q,L,P]
    adm_cycle: torch.Tensor  # int32[Q,L]
    cycle: torch.Tensor  # int32[1]
    done: torch.Tensor  # int32[1] loop condition failed

    @classmethod
    def initial(cls, local_usage, queues: DrainQueues, max_cycles: int):
        q, l, pmax, _, _ = queues.cells.shape
        g = queues.gidx.shape[-1]
        dev = local_usage.device
        go = bool((queues.qlen > 0).any()) and max_cycles > 0
        return cls(
            local=local_usage.clone(),
            cursor=torch.zeros(q, dtype=I32, device=dev),
            g_start=torch.zeros((q, pmax, g), dtype=I32, device=dev),
            retries=torch.zeros(q, dtype=I32, device=dev),
            stuck=torch.zeros(q, dtype=BOOL, device=dev),
            no_prog=torch.zeros(1, dtype=I32, device=dev),
            adm_k=torch.full((q, l, pmax), -1, dtype=I32, device=dev),
            adm_cycle=torch.full((q, l), -1, dtype=I32, device=dev),
            cycle=torch.zeros(1, dtype=I32, device=dev),
            done=torch.full((1,), 0 if go else 1, dtype=I32, device=dev),
        )

    def clone(self) -> "DrainState":
        return DrainState(**{f.name: getattr(self, f.name).clone() for f in fields(self)})


@dataclass
class CycleBuffers:
    """Per-cycle intermediates, allocated once per drain."""

    usage: torch.Tensor  # int64[N,FR] cycle usage tree (mutated by phase 2)
    avail: torch.Tensor  # int64[N,FR] cycle-start availability
    is_fit: torch.Tensor  # bool[Q]
    is_pre: torch.Tensor  # bool[Q]
    pend: torch.Tensor  # bool[Q]
    head_borrow: torch.Tensor  # bool[Q]
    rep_k: torch.Tensor  # int32[Q,P]
    walk_next: torch.Tensor  # int32[Q,P,G]
    cells_eff: torch.Tensor  # int32[Q,P*C] merged representative cells
    qty_eff: torch.Tensor  # int64[Q,P*C]
    admitted: torch.Tensor  # bool[Q]
    order: torch.Tensor  # int32[Q] phase-2 scratch (per-segment order)

    @classmethod
    def empty(cls, local_usage, queues: DrainQueues):
        q, _, pmax, _, c = queues.cells.shape
        g = queues.gidx.shape[-1]
        dev = local_usage.device
        return cls(
            usage=torch.empty_like(local_usage),
            avail=torch.empty_like(local_usage),
            is_fit=torch.zeros(q, dtype=BOOL, device=dev),
            is_pre=torch.zeros(q, dtype=BOOL, device=dev),
            pend=torch.zeros(q, dtype=BOOL, device=dev),
            head_borrow=torch.zeros(q, dtype=BOOL, device=dev),
            rep_k=torch.full((q, pmax), -1, dtype=I32, device=dev),
            walk_next=torch.zeros((q, pmax, g), dtype=I32, device=dev),
            cells_eff=torch.full((q, pmax * c), -1, dtype=I32, device=dev),
            qty_eff=torch.zeros((q, pmax * c), dtype=I64, device=dev),
            admitted=torch.zeros(q, dtype=BOOL, device=dev),
            order=torch.zeros(q, dtype=I32, device=dev),
        )

    def clone(self) -> "CycleBuffers":
        return CycleBuffers(**{f.name: getattr(self, f.name).clone() for f in fields(self)})


def _done(state: DrainState) -> bool:
    """Plain-path honour of the done flag (a host read on the CPU)."""
    return bool(state.done.item())


# ---- plain torch versions ------------------------------------------------


def _group_walk(
    gid, gl, gmask, head_valid, fit_cells, pot_cells, reclaim_cells,
    borrow_cells, ffb, ffp, score=None,
):
    """Policy-aware emulation of the host's per-group flavor walk
    (flavor_assigner._find_flavor_for_resource + _should_try_next_flavor
    + the reclaim-oracle upgrade), vectorized over queues.

    Each resource group walks its flavors (restricted by the per-group
    cursor already folded into ``head_valid``): a flavor STOPS the walk
    when it fits and is non-borrowing, when it fits and
    whenCanBorrow=Borrow, or under whenCanPreempt=Preempt when it is
    preempt/reclaim eligible; otherwise the best granular mode seen
    wins (FIT > RECLAIM > PREEMPT). Choices are masked score-argmaxes
    with ties to the earliest flavor (all-zero scores = first fit).

    Returns (chosen int[Q], pre_k int[Q], pending bool[Q], next_start
    int32[Q,G])."""
    inf = 2**30
    neg = -(2**62)
    if score is None:
        score = torch.zeros(head_valid.shape, dtype=I64, device=head_valid.device)
    sc = score[:, :, None]  # [Q,K,1]
    valid3 = head_valid[:, :, None]  # [Q,K,1]
    cellmode = torch.where(
        fit_cells,
        3,
        torch.where(pot_cells & reclaim_cells, 2, torch.where(pot_cells, 1, 0)),
    ).to(I32)
    gmode = torch.where(gmask, cellmode[..., None], 3).amin(dim=2)  # [Q,K,G]
    gborrow = (gmask & borrow_cells[..., None]).any(dim=2)  # [Q,K,G]
    borrow_ok = ~gborrow | ffb[:, None, None]
    stop = valid3 & (
        ((gmode == 3) & borrow_ok)
        | (((gmode == 1) | (gmode == 2)) & ffp[:, None, None] & borrow_ok)
    )
    stop_sc = torch.where(stop, sc, neg)  # [Q,K,G]
    stop_best = stop_sc.amax(dim=1)  # [Q,G]
    stop_sel = stop & (stop_sc == stop_best[:, None, :])
    stop_idx = torch.where(stop_sel, gid, inf).amin(dim=1)  # [Q,G]
    stopped = stop_idx < inf
    best_mode = torch.where(valid3, gmode, -1).amax(dim=1)  # [Q,G]
    bm_sel = valid3 & (gmode == best_mode[:, None, :])
    bm_sc = torch.where(bm_sel, sc, neg)
    bm_best = bm_sc.amax(dim=1)
    best_idx = torch.where(bm_sel & (bm_sc == bm_best[:, None, :]), gid, inf).amin(dim=1)
    choice_idx = torch.where(stopped, stop_idx, best_idx)  # [Q,G]
    at_choice = valid3 & (gid == choice_idx[:, None, :])
    choice_mode = torch.where(at_choice, gmode, -1).amax(dim=1)  # [Q,G]
    have = (choice_idx < inf) & (choice_mode >= 1)
    head_mode = torch.where(have, choice_mode, 0).amin(dim=1)  # [Q]
    match = head_valid & (gid == choice_idx[:, None, :]).all(dim=-1)
    has_rep = match.any(dim=1)
    k_rep = match.to(I64).argmax(dim=1)
    chosen = torch.where((head_mode == 3) & has_rep, k_rep, -1)
    pre_k = torch.where(((head_mode == 1) | (head_mode == 2)) & has_rep, k_rep, -1)
    # stored cursor: the stop index unless it was the group's last
    # flavor; best-mode (non-stop) walks ran to the end and store -1
    is_last = (at_choice & gl).any(dim=1)
    tried = torch.where(stopped & ~is_last, choice_idx, -1)
    pending = (tried >= 0).any(dim=1)
    next_start = (tried + 1).to(I32)
    return chosen, pre_k, pending, next_start


def drain_nominate_plain(ctx: DrainContext, state: DrainState, buf: CycleBuffers) -> None:
    """Sequential multi-podset nomination for the current heads
    (the JAX ``_nominate_multi`` + ``cell_masks`` + ``_group_walk``).

    Podset p's walk sees quantities inflated by the cells chosen by
    podsets < p (assignment_usage); a podset with no choice fails the
    workload. The merged representative cells sum duplicate cells onto
    their first occurrence."""
    if _done(state):
        return
    tree, queues = ctx.tree, ctx.queues
    q, l, pmax, _, c = queues.cells.shape
    g = queues.gidx.shape[-1]
    local = state.local
    n_fr = local.shape[1]
    dev = local.device
    q_idx = torch.arange(q, device=dev)
    active = state.cursor < queues.qlen
    cur = state.cursor.clamp_max(l - 1).long()
    head_cq = torch.where(active, queues.cq_rows, -1)
    g_start = state.g_start

    accum = torch.zeros((q, n_fr), dtype=I64, device=dev)
    processed = torch.ones(q, dtype=BOOL, device=dev)
    head_mode = torch.full((q,), 3, dtype=I32, device=dev)
    head_borrow = torch.zeros(q, dtype=BOOL, device=dev)
    pending = torch.zeros(q, dtype=BOOL, device=dev)
    rep_list, nstart_list, cells_list, qty_list = [], [], [], []
    npod = queues.n_podsets[q_idx, cur]
    garange = torch.arange(g, device=dev)

    for p in range(pmax):
        real = active & (p < npod)
        cells_p = queues.cells[q_idx, cur, p]  # [Q,K,C]
        qty_p = queues.qty[q_idx, cur, p]
        if p == 0:
            infl = qty_p
        else:
            accum_at = accum[q_idx[:, None, None], cells_p.clamp_min(0).long()]
            infl = qty_p + torch.where((cells_p >= 0) & (qty_p > 0), accum_at, 0)
        fit_cells, pot_cells, reclaim_cells, borrow_cells, _ = cell_masks(
            tree, ctx.subtree, ctx.guaranteed, local, head_cq, cells_p, infl,
            avail=buf.avail, potential=ctx.potential,
        )
        gid_p = queues.gidx[q_idx, cur, p]  # [Q,K,G]
        gl_p = queues.glast[q_idx, cur, p]
        cg_p = queues.cgrp[q_idx, cur, p]
        gmask_p = cg_p.long()[..., None] == garange
        k_mask_p = (gid_p >= g_start[:, p][:, None, :]).all(dim=-1)
        valid_p = queues.valid[q_idx, cur, p] & real[:, None] & k_mask_p
        score_p = queues.score[q_idx, cur, p] if queues.score is not None else None
        chosen_p, pre_p, pending_p, nstart_p = _group_walk(
            gid_p, gl_p, gmask_p, valid_p, fit_cells, pot_cells,
            reclaim_cells, borrow_cells, queues.ffb, queues.ffp, score=score_p,
        )
        live = real & processed
        mode_p = torch.where(chosen_p >= 0, 3, torch.where(pre_p >= 0, 1, 0))
        mode_p = torch.where(live, mode_p, 3)  # pads/unprocessed inert
        rep_p = torch.where(chosen_p >= 0, chosen_p, pre_p)
        use_p = live & (rep_p >= 0)
        rep_safe = rep_p.clamp_min(0)[:, None, None].expand(q, 1, c)
        cells_rep = torch.gather(cells_p, 1, rep_safe)[:, 0]  # [Q,C]
        qty_rep = torch.gather(qty_p, 1, rep_safe)[:, 0]
        cells_rep = torch.where(use_p[:, None] & (cells_rep >= 0), cells_rep, -1)
        qty_rep = torch.where(cells_rep >= 0, qty_rep, 0)
        if p < pmax - 1:
            # assignment_usage grows for fit AND preempt choices alike
            accum.index_put_(
                (q_idx[:, None].expand(q, c), cells_rep.clamp_min(0).long()),
                torch.where(cells_rep >= 0, qty_rep, 0),
                accumulate=True,
            )
        borrow_rep = (
            torch.gather(borrow_cells, 1, rep_safe)[:, 0] & (cells_rep >= 0)
        ).any(dim=1)
        head_borrow = head_borrow | (borrow_rep & use_p)
        pending = pending | (pending_p & live)
        head_mode = torch.minimum(head_mode, mode_p.to(I32))
        processed = processed & (mode_p >= 1)
        rep_list.append(torch.where(use_p, rep_p, -1))
        nstart_list.append(torch.where(live[:, None], nstart_p, 0))
        cells_list.append(cells_rep)
        qty_list.append(qty_rep)

    mcells = torch.cat(cells_list, dim=1)  # [Q,P*C]
    mqty = torch.cat(qty_list, dim=1)
    if pmax > 1:
        # merge duplicate cells: sum onto the first occurrence, zero the
        # rest (a single candidate's cells are distinct by construction)
        pos = torch.arange(pmax * c, device=dev)
        same = (mcells[:, None, :] == mcells[:, :, None]) & (mcells >= 0)[:, None, :]
        summed = torch.where(same, mqty[:, None, :], 0).sum(dim=2)
        first = ~(same & (pos[None, None, :] < pos[None, :, None])).any(dim=2)
        mqty = torch.where(first & (mcells >= 0), summed, 0)
        mcells = torch.where(first, mcells, -1)

    is_fit = active & (head_mode == 3)
    is_pre = active & (head_mode >= 1) & (head_mode < 3)
    buf.is_fit.copy_(is_fit)
    buf.is_pre.copy_(is_pre)
    buf.pend.copy_(pending & is_pre)  # NoFit nominations clear the cursor
    buf.head_borrow.copy_(head_borrow)
    buf.rep_k.copy_(torch.stack(rep_list, dim=1))
    buf.walk_next.copy_(torch.stack(nstart_list, dim=1))
    buf.cells_eff.copy_(mcells)
    buf.qty_eff.copy_(mqty)
    buf.admitted.zero_()


def drain_phase2_plain(ctx: DrainContext, state: DrainState, buf: CycleBuffers) -> None:
    """Entry-order sort, segmented rank and the phase-2 step scan of
    the JAX ``_plain_cycle``: step s admits (or reserves for) the
    rank-s head of every root segment against the in-cycle usage
    tree, bubbling each node's over-guaranteed delta up the path.
    Mutates ``buf.usage`` (reservations die with the cycle) and adds
    the admitted quantities to the leaf rows of ``state.local``."""
    if _done(state):
        return
    tree, queues, paths = ctx.tree, ctx.queues, ctx.paths
    subtree, guaranteed = ctx.subtree, ctx.guaranteed
    n_segments, n_steps = ctx.n_segments, ctx.n_steps
    max_depth = tree.max_depth
    q, l = queues.priority.shape
    dev = buf.usage.device
    q_idx = torch.arange(q, device=dev)
    active = state.cursor < queues.qlen
    cur = state.cursor.clamp_max(l - 1).long()
    is_fit, is_pre, head_borrow = buf.is_fit, buf.is_pre, buf.head_borrow
    cells_eff, qty_eff = buf.cells_eff, buf.qty_eff
    nofit = ~(is_fit | is_pre)

    prio = queues.priority[q_idx, cur]
    ts = queues.timestamp[q_idx, cur]
    order = _lexsort((ts, -prio, head_borrow.to(I64), nofit.to(I64)))
    seg = queues.seg_id.clamp_min(0)[order]
    valid_sorted = active[order] & (queues.seg_id[order] >= 0) & ~nofit[order]
    rank = segmented_rank(seg, valid_sorted)
    rank_scatter = torch.where(valid_sorted, rank, n_steps)
    keep = (rank_scatter < n_steps) & (seg < n_segments)
    mat = torch.full((n_steps, n_segments), -1, dtype=I32, device=dev)
    mat[rank_scatter[keep].long(), seg[keep].long()] = order[keep].to(I32)

    usage = buf.usage
    cq = queues.cq_rows.clamp_min(0).long()
    admit_sn = torch.zeros((n_steps, n_segments), dtype=BOOL, device=dev)
    for s in range(n_steps):
        idx = mat[s]
        act = idx >= 0
        if not bool(act.any()):
            continue
        hidx = idx.clamp_min(0).long()
        cqs = cq[hidx]
        path = paths[cqs]
        cells_ = cells_eff[hidx]
        qty_ = qty_eff[hidx]
        ccells = cells_.clamp_min(0).long()
        cell_valid = (cells_ >= 0) & (qty_ > 0) & act[:, None]

        avail = _avail_along_path(
            path, cells_, usage, subtree, guaranteed, tree.borrowing_limit, max_depth
        )
        fits = torch.where(cell_valid, avail >= qty_, True).all(dim=1)
        admit = act & is_fit[hidx] & fits
        reserve = act & is_pre[hidx] & queues.no_reclaim[hidx]
        nominal_c = tree.nominal[cqs[:, None], ccells]
        bl_c = tree.borrowing_limit[cqs[:, None], ccells]
        leaf_usage_c = usage[cqs[:, None], ccells]
        borrow_cap = torch.where(
            bl_c < NO_LIMIT, torch.minimum(qty_, nominal_c + bl_c - leaf_usage_c), qty_
        )
        nominal_cap = torch.minimum(qty_, nominal_c - leaf_usage_c).clamp_min(0)
        reserve_qty = torch.where(head_borrow[hidx][:, None], borrow_cap, nominal_cap)
        delta = torch.where(
            cell_valid & admit[:, None],
            qty_,
            torch.where(cell_valid & reserve[:, None], reserve_qty, 0),
        )
        for d in range(0, max_depth + 1):
            node = path[:, d].clamp_min(0).long()[:, None].expand_as(ccells)
            node_valid = (path[:, d] >= 0)[:, None]
            old = usage[node, ccells]
            gg = guaranteed[node, ccells]
            new = old + delta
            usage.index_put_(
                (node, ccells), torch.where(node_valid, delta, 0), accumulate=True
            )
            over_old = (old - gg).clamp_min(0)
            over_new = (new - gg).clamp_min(0)
            delta = torch.where(node_valid, over_new - over_old, delta)
        admit_sn[s] = admit

    flat_idx = mat.reshape(-1)
    sel = flat_idx >= 0
    admitted = torch.zeros(q, dtype=BOOL, device=dev)
    admitted[flat_idx[sel].long()] = admit_sn.reshape(-1)[sel]
    # leaf usage adds for admissions only — the cycle's reservations
    # die with the cycle
    cell_valid = (cells_eff >= 0) & (qty_eff > 0)
    add = torch.where(cell_valid & admitted[:, None], qty_eff, 0)
    state.local.index_put_(
        (cq[:, None].expand_as(cells_eff), cells_eff.clamp_min(0).long()),
        add,
        accumulate=True,
    )
    buf.admitted.copy_(admitted)


def drain_queue_motion_plain(ctx: DrainContext, state: DrainState, buf: CycleBuffers) -> None:
    """Cursor-based end-of-cycle queue motion (the JAX
    ``_cursor_queue_motion``) plus the while_loop condition.

    Admitted heads leave; non-Fit heads park unless a podset walk
    stored a pending flavor cursor (PendingFlavors); conflict losers
    stay, resuming every podset from its stored per-group cursors. A
    queue retrying beyond its joint-cursor budget is provably cycling
    and freezes as stuck; with no queue advancing for 2x the budget,
    every non-advancing active queue freezes. Then the cycle counter
    advances and ``done`` is set once no unstuck queue has entries
    left or ``max_cycles`` is reached."""
    if _done(state):
        return
    queues = ctx.queues
    q, l = queues.priority.shape
    dev = state.cursor.device
    q_idx = torch.arange(q, device=dev)
    cursor = state.cursor
    active = cursor < queues.qlen
    cur = cursor.clamp_max(l - 1).long()
    is_fit, pend, admitted = buf.is_fit, buf.pend, buf.admitted
    retries = state.retries

    over_budget = retries >= queues.retry_cap
    stuck = state.stuck | (active & ~is_fit & pend & over_budget)
    resolve = active & (admitted | (~is_fit & ~pend))
    stuck = stuck & ~resolve
    retrying = active & ~is_fit & pend & ~stuck
    advance = resolve
    retries = torch.where(
        advance | ~active, 0, torch.where(retrying, retries + 1, retries)
    ).to(I32)
    no_prog = torch.where(advance.any(), 0, state.no_prog + 1).to(I32)
    stuck = stuck | ((no_prog >= 2 * queues.retry_cap.max()) & active & ~advance)
    wrote = admitted & active
    state.adm_k[q_idx, cur] = torch.where(wrote[:, None], buf.rep_k, state.adm_k[q_idx, cur])
    state.adm_cycle[q_idx, cur] = torch.where(wrote, state.cycle, state.adm_cycle[q_idx, cur])
    lost = active & is_fit & ~admitted
    g_start = torch.where(
        advance[:, None, None],
        0,
        torch.where((lost | retrying)[:, None, None], buf.walk_next, state.g_start),
    ).to(I32)
    cursor = (cursor + advance.to(I32)).to(I32)
    cycle = state.cycle + 1
    go = ((cursor < queues.qlen) & ~stuck).any() & (cycle < ctx.max_cycles)

    state.retries.copy_(retries)
    state.stuck.copy_(stuck)
    state.no_prog.copy_(no_prog)
    state.g_start.copy_(g_start)
    state.cursor.copy_(cursor)
    state.cycle.copy_(cycle)
    state.done.copy_((~go).to(I32).reshape(1))


# ---- kernels 2-4 (csrc/drain_*.cu) ---------------------------------------


@dataclass
class DrainContext:
    """What stays fixed for one drain: the tree and its derived
    matrices, the queues, paths, segments and the static sizes. The
    kernel wrappers read it; ``kernel_args`` builds the C argument
    arrays once per (state, buffers) pair."""

    tree: QuotaTree
    subtree: torch.Tensor
    guaranteed: torch.Tensor
    potential: torch.Tensor
    paths: torch.Tensor
    queues: DrainQueues
    segments: Segments
    n_segments: int
    n_steps: int
    max_cycles: int
    _args: Optional[tuple] = None  # (state, buf, ints, ptrs)

    @classmethod
    def build(cls, tree, queues, paths, n_segments, n_steps, max_cycles):
        subtree, guaranteed = subtree_quota(tree)
        potential = potential_available_all(tree, subtree, guaranteed)
        segments = build_segments(queues.seg_id.cpu().numpy(), tree.device)
        return cls(
            tree, subtree, guaranteed, potential, paths, queues, segments,
            n_segments, n_steps, max_cycles,
        )

    def kernel_args(self, kernel: str, state: DrainState, buf: CycleBuffers):
        """(ints, ptrs) ctypes arrays in csrc/drain_common.cuh order,
        every tensor checked; cached for the last (state, buf)."""
        cached = self._args
        if cached is not None and cached[0] is state and cached[1] is buf:
            return cached[2], cached[3]
        queues, tree = self.queues, self.tree
        q, l, pmax, k, c = queues.cells.shape
        g = queues.gidx.shape[-1]
        n, fr = tree.nominal.shape
        if k > MAX_K or c > MAX_C or g > MAX_G or pmax > MAX_P:
            raise _build.KernelInputError(
                f"{kernel}: the drain kernels take K<={MAX_K}, C<={MAX_C}, "
                f"G<={MAX_G}, P<={MAX_P}; got K={k}, C={c}, G={g}, P={pmax}"
            )
        s = self.segments.count
        e5, e4 = (q, l, pmax, k, c), (q, l, pmax, k)
        eg = (q, l, pmax, k, g)
        spec = [
            # DrainQueues
            ("cq_rows", queues.cq_rows, I32, (q,)),
            ("seg_id", queues.seg_id, I32, (q,)),
            ("qlen", queues.qlen, I32, (q,)),
            ("cells", queues.cells, I32, e5),
            ("qty", queues.qty, I64, e5),
            ("valid", queues.valid, BOOL, e4),
            ("gidx", queues.gidx, I32, eg),
            ("glast", queues.glast, BOOL, eg),
            ("cgrp", queues.cgrp, torch.int8, e5),
            ("n_podsets", queues.n_podsets, I32, (q, l)),
            ("ffb", queues.ffb, BOOL, (q,)),
            ("ffp", queues.ffp, BOOL, (q,)),
            ("retry_cap", queues.retry_cap, I32, (q,)),
            ("priority", queues.priority, I64, (q, l)),
            ("timestamp", queues.timestamp, I64, (q, l)),
            ("no_reclaim", queues.no_reclaim, BOOL, (q,)),
            ("score", queues.score, I64, e4),
            # tree
            ("parent", tree.parent, I32, (n,)),
            ("nominal", tree.nominal, I64, (n, fr)),
            ("borrowing_limit", tree.borrowing_limit, I64, (n, fr)),
            ("subtree", self.subtree, I64, (n, fr)),
            ("guaranteed", self.guaranteed, I64, (n, fr)),
            ("potential", self.potential, I64, (n, fr)),
            ("paths", self.paths, I32, (n, tree.max_depth + 1)),
            # DrainState
            ("local", state.local, I64, (n, fr)),
            ("cursor", state.cursor, I32, (q,)),
            ("g_start", state.g_start, I32, (q, pmax, g)),
            ("retries", state.retries, I32, (q,)),
            ("stuck", state.stuck, BOOL, (q,)),
            ("no_prog", state.no_prog, I32, (1,)),
            ("adm_k", state.adm_k, I32, (q, l, pmax)),
            ("adm_cycle", state.adm_cycle, I32, (q, l)),
            ("cycle", state.cycle, I32, (1,)),
            ("done", state.done, I32, (1,)),
            # CycleBuffers
            ("usage", buf.usage, I64, (n, fr)),
            ("avail", buf.avail, I64, (n, fr)),
            ("is_fit", buf.is_fit, BOOL, (q,)),
            ("is_pre", buf.is_pre, BOOL, (q,)),
            ("pend", buf.pend, BOOL, (q,)),
            ("head_borrow", buf.head_borrow, BOOL, (q,)),
            ("rep_k", buf.rep_k, I32, (q, pmax)),
            ("walk_next", buf.walk_next, I32, (q, pmax, g)),
            ("cells_eff", buf.cells_eff, I32, (q, pmax * c)),
            ("qty_eff", buf.qty_eff, I64, (q, pmax * c)),
            ("admitted", buf.admitted, BOOL, (q,)),
            ("order", buf.order, I32, (q,)),
            # segments
            ("seg_offsets", self.segments.offsets, I32, (s + 1,)),
            ("seg_members", self.segments.members, I32, None),
        ]
        ptrs = [_build.ptr(kernel, name, t, dt, sh) for name, t, dt, sh in spec]
        ints = [
            q, l, pmax, k, c, g, n, fr, tree.max_depth,
            self.n_segments, self.n_steps, s, self.max_cycles,
        ]
        c_ints = (ctypes.c_int * len(ints))(*ints)
        c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
        self._args = (state, buf, c_ints, c_ptrs)
        return c_ints, c_ptrs


def _launch(kernel: str, ctx: DrainContext, state: DrainState, buf: CycleBuffers):
    ints, ptrs = ctx.kernel_args(kernel, state, buf)
    fn = _build.c_function(
        kernel,
        kernel,
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
    )
    _build.note_launch(kernel)
    rc = fn(
        ctypes.addressof(ints), len(ints), ctypes.addressof(ptrs), len(ptrs),
        _build.stream_ptr(state.local.device),
    )
    _build.check(rc, kernel)


def drain_nominate(ctx: DrainContext, state: DrainState, buf: CycleBuffers) -> None:
    """Kernel 2: every queue head's nomination (one thread per queue)."""
    if not state.local.is_cuda:
        return drain_nominate_plain(ctx, state, buf)
    _launch("drain_nominate", ctx, state, buf)


def drain_phase2(ctx: DrainContext, state: DrainState, buf: CycleBuffers) -> None:
    """Kernel 3: conflict resolution in entry order (one block per root
    segment)."""
    if not state.local.is_cuda:
        return drain_phase2_plain(ctx, state, buf)
    _launch("drain_phase2", ctx, state, buf)


def drain_queue_motion(ctx: DrainContext, state: DrainState, buf: CycleBuffers) -> None:
    """Kernel 4: queue motion, the cycle counter and the done flag (one
    block striding over the queues)."""
    if not state.local.is_cuda:
        return drain_queue_motion_plain(ctx, state, buf)
    _launch("drain_queue_motion", ctx, state, buf)


# ---- the drain ----------------------------------------------------------


def drain_cycle(ctx: DrainContext, state: DrainState, buf: CycleBuffers) -> None:
    """ONE drain cycle: five launches on the card (or their plain
    versions on the CPU)."""
    usage_tree(ctx.tree, ctx.guaranteed, state.local, out=buf.usage, done=state.done)
    available_all(
        ctx.tree, ctx.subtree, ctx.guaranteed, buf.usage, out=buf.avail, done=state.done
    )
    drain_nominate(ctx, state, buf)
    drain_phase2(ctx, state, buf)
    drain_queue_motion(ctx, state, buf)


# cycles the host enqueues between two reads of the device done flag
CHECK_EVERY_CUDA = 8
CHECK_EVERY_CPU = 1


def solve_drain(
    tree: QuotaTree,
    local_usage: torch.Tensor,  # int64[N, FR] starting leaf usage
    queues: DrainQueues,
    paths: torch.Tensor,  # int32[N, D+1]
    n_segments: int,
    n_steps: int,
    max_cycles: int,
) -> DrainResult:
    """The plain drain to quiescence (or ``max_cycles``).

    The host enqueues ``CHECK_EVERY_CUDA`` cycles on the card
    (``CHECK_EVERY_CPU`` on the CPU) between reads of the device
    ``done`` flag; cycles enqueued past the end return at once, so the
    result is the same for any interval."""
    ctx = DrainContext.build(tree, queues, paths, n_segments, n_steps, max_cycles)
    state = DrainState.initial(local_usage, queues, max_cycles)
    buf = CycleBuffers.empty(local_usage, queues)
    check_every = CHECK_EVERY_CUDA if local_usage.is_cuda else CHECK_EVERY_CPU
    while not bool(state.done.item()):
        for _ in range(check_every):
            drain_cycle(ctx, state, buf)
    return DrainResult(
        admitted_k=state.adm_k,
        admitted_cycle=state.adm_cycle,
        cursor=state.cursor,
        cycles=state.cycle,
        local_usage=state.local,
        stuck=state.stuck,
    )


def _solve_drain_packed(
    tree, local_usage, queues, paths, n_segments: int, n_steps: int, max_cycles: int
) -> torch.Tensor:
    """solve_drain with the decision tensors flattened into one int64
    vector (the JAX ``_solve_drain_packed`` layout), so the host
    retrieves the whole drain in a single copy."""
    r = solve_drain(tree, local_usage, queues, paths, n_segments, n_steps, max_cycles)
    return torch.cat(
        [
            r.admitted_k.reshape(-1).to(I64),
            r.admitted_cycle.reshape(-1).to(I64),
            r.cursor.to(I64),
            r.stuck.to(I64),
            r.local_usage.reshape(-1),
            r.cycles.reshape(1).to(I64),
        ]
    )
