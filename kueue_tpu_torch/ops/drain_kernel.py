"""Multi-cycle admission drain: the plain, the fair-sharing, the
classic-preemption, the fair-preemption and the Topology-Aware
Scheduling bulk drains on the card.

Port of ``solve_drain``, ``solve_drain_fair``, ``solve_drain_preempt``,
``solve_drain_fair_preempt`` and ``solve_drain_tas`` of
kueue_tpu/ops/drain_kernel.py (here ``solve_drain`` with ``fair``, then
``solve_drain_preempt``, ``solve_drain_fair_preempt`` and
``solve_drain_tas`` at the end of this module). Per-CQ pending queues are dense tensors; each cycle
reproduces the reference's semantics (pkg/scheduler/scheduler.go:176-310)
for preemption-free drains:

- heads: each CQ's queue front (one head per CQ per cycle);
- nomination: the per-group flavor walk against cycle-start usage,
  podsets in order (``drain_nominate``);
- conflict resolution: the reference's entry order (borrowing asc,
  priority desc, timestamp asc) within each root cohort, independent
  root cohorts in parallel (``drain_phase2``); in the fair drain the
  fair-sharing cohort tournament, one pop per root cohort a step
  against the live usage (``drain_fair_phase2``);
- queue motion: admitted heads leave, NoFit heads park, conflict losers
  and PendingFlavors heads retry from their stored cursors, provably
  cycling queues freeze as stuck (``drain_queue_motion``);
- capacity reservation: blocked preempt-mode heads of queues with
  reclaimWithinCohort != Any reserve within their cycle; the usage
  tree is rebuilt from leaf rows every cycle, so reservations die with
  the cycle.

Each cycle is four launches on the card: kernel 1 (``quota_tree``,
ops/quota.usage_and_available) once for the cycle-start usage tree and
availability, then kernels 2-4 below. Every wrapper launches its CUDA
kernel for a CUDA tensor (or raises) and runs the plain torch version
beside it for a CPU tensor; plain and kernel share one in-place interface over
``DrainState`` and ``CycleBuffers``, so ``solve_drain`` is one loop for
both. Kernel 4 keeps the cycle counter and a ``done`` flag on the
device; every launch returns at once when ``done`` is set, so the host
checks the flag only every few cycles (or, for a launch bounded by a
few hundred cycles, never: ``run_cycles``) and ``cycles`` stays exact.

The state carries ``alive`` and ``cap`` for the megaloop
(ops/megaloop_kernel.py), whose round boundary retires stuck queues and
rewrites the retry budgets; in the plain and fair drains they stay all
ones and the plan's ``retry_cap``.

The preempt drain keeps the same nomination (with the reclaim oracle's
inputs) and replaces phase 2 and the motion by three kernels over a
``PreemptState`` (entry status, the live candidate pools, the eviction
record) and ``PreemptBuffers``: the victim search, its step scan and
its cycle end (kernels 6-8). The fair-preempt drain keeps that
nomination and cycle end (the motion also fills each admitted entry's
row of the fair panels, ``FairPreemptState.pq_cu``) and runs the fair
victim tournament on each segment's fair panels and the fair
admission tournament with the preempt dispositions in between
(kernels B11a and B11b). The TAS drain keeps the plain nomination and
motion over a ``TASState`` (the live TAS leaf usage, each admission's
step) and ``TASBuffers`` (each queue's nomination placement), and
replaces phase 2 by the nomination placement of every TAS head against
the cycle-start leaf usage (kernel B13a, ``drain_tas_place``) and ONE
global step scan that re-validates and charges the placed leaves
(kernel B13b, ``drain_tas_phase2``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, fields
from types import SimpleNamespace
from typing import NamedTuple, Optional

import numpy as np

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
from kueue_tpu_torch.ops.fair_preempt_kernel import FairProblem, solve_fair
from kueue_tpu_torch.ops.preempt_kernel import PreemptProblem, _bubble_local, solve_preempt
from kueue_tpu_torch.ops.quota import (
    DRS_MAX,
    NO_LIMIT,
    QuotaTree,
    potential_available_all,
    subtree_quota,
    usage_and_available,
    usage_tree_plain,
)
from kueue_tpu_torch.ops.tas_kernel import _trunc_div

# Widest shapes the CUDA kernels take (per-thread arrays are static):
# candidates K, cells C, resource groups G, podsets P; P*C <= 32 lanes.
MAX_K, MAX_C, MAX_G, MAX_P = 16, 8, 8, 4
# resources the fair drain's kernel takes (its per-thread borrowed sums)
MAX_R = 16
# the preempt drain's and the fair-preempt drain's pointers in the
# kernels' argument layout
PREEMPT_PTRS = 15 + 8 + 10
FAIR_PREEMPT_PTRS = 8
TAS_PTRS = 13 + 4 + 5


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
    cycle: torch.Tensor  # int32[1] (in the megaloop: the in-round cycle)
    done: torch.Tensor  # int32[1] loop condition failed
    alive: torch.Tensor  # bool[Q] queues still in the drain (a megaloop
    #                      round boundary retires stuck ones)
    cap: torch.Tensor  # int32[Q] PendingFlavors retry budget in force

    @classmethod
    def initial(cls, local_usage, queues: DrainQueues, max_cycles: int):
        """The state before the first cycle. ``done`` is computed on the
        device, so building it reads nothing back to the host."""
        q, l, pmax, _, _ = queues.cells.shape
        g = queues.gidx.shape[-1]
        dev = local_usage.device
        go = (queues.qlen > 0).any() & (max_cycles > 0)
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
            done=(~go).to(I32).reshape(1),
            alive=torch.ones(q, dtype=BOOL, device=dev),
            cap=queues.retry_cap.clone(),
        )

    def clone(self):
        return type(self)(**{f.name: getattr(self, f.name).clone() for f in fields(self)})


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
        return type(self)(**{f.name: getattr(self, f.name).clone() for f in fields(self)})


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
    active = (state.cursor < queues.qlen) & state.alive
    cur = state.cursor.clamp_max(l - 1).long()
    head_cq = torch.where(active, queues.cq_rows, -1)
    g_start = state.g_start

    veto = pwb = None
    if ctx.preempt is not None:
        # the preempt drain's reclaim oracle: a cell carrying an
        # eligible same-CQ victim cannot be upgraded to RECLAIM, and
        # borrowWithinCohort lets the preempt mode cover requests above
        # nominal (canPreemptWhileBorrowing)
        elig, veto = _elig_same_and_veto(ctx, state, active, cur)
        buf.elig_same.copy_(elig)
        buf.veto.copy_(veto)
        # canPreemptWhileBorrowing: borrowWithinCohort, and in the
        # fair-preempt drain also reclaimWithinCohort
        vic = ctx.preempt.victims
        pwb = vic.bwc if ctx.fair_preempt is None else vic.bwc | vic.reclaim_enabled

    accum = torch.zeros((q, n_fr), dtype=I64, device=dev)
    processed = torch.ones(q, dtype=BOOL, device=dev)
    head_mode = torch.full((q,), 3, dtype=I32, device=dev)
    head_borrow = torch.zeros(q, dtype=BOOL, device=dev)
    pending = torch.zeros(q, dtype=BOOL, device=dev)
    rep_list, nstart_list, cells_list, qty_list, need_list = [], [], [], [], []
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
            avail=buf.avail, potential=ctx.potential, pwb=pwb,
        )
        if veto is not None:
            on_victim = veto[q_idx[:, None, None], cells_p.clamp_min(0).long()] & (cells_p >= 0)
            reclaim_cells = reclaim_cells & ~on_victim
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
        # cells of the choice that did not fit: its frs_need_preemption
        fit_rep = torch.gather(fit_cells, 1, rep_safe)[:, 0]
        need_list.append((cells_rep >= 0) & (qty_rep > 0) & ~fit_rep)
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
    mneed = torch.cat(need_list, dim=1)
    if pmax > 1:
        # merge duplicate cells: sum onto the first occurrence, zero the
        # rest (a single candidate's cells are distinct by construction);
        # the need is the union over the podsets
        pos = torch.arange(pmax * c, device=dev)
        same = (mcells[:, None, :] == mcells[:, :, None]) & (mcells >= 0)[:, None, :]
        summed = torch.where(same, mqty[:, None, :], 0).sum(dim=2)
        first = ~(same & (pos[None, None, :] < pos[None, :, None])).any(dim=2)
        mneed = (same & mneed[:, None, :]).any(dim=2) & first
        mqty = torch.where(first & (mcells >= 0), summed, 0)
        mcells = torch.where(first, mcells, -1)
    if ctx.preempt is not None:
        buf.need_pre.copy_(mneed)

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


def _charge_paths(usage, guaranteed, path, ccells, delta, max_depth: int) -> None:
    """Bubble each row's per-cell ``delta`` up its ``path`` on the usage
    tree, in place (rows are distinct root cohorts: disjoint paths)."""
    for d in range(max_depth + 1):
        node = path[:, d].clamp_min(0).long()[:, None].expand_as(ccells)
        node_valid = (path[:, d] >= 0)[:, None]
        old = usage[node, ccells]
        gg = guaranteed[node, ccells]
        new = old + delta
        usage.index_put_((node, ccells), torch.where(node_valid, delta, 0), accumulate=True)
        delta = torch.where(
            node_valid, (new - gg).clamp_min(0) - (old - gg).clamp_min(0), delta
        )


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
    active = (state.cursor < queues.qlen) & state.alive
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
        _charge_paths(usage, guaranteed, path, ccells, delta, max_depth)
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
    active = (cursor < queues.qlen) & state.alive
    cur = cursor.clamp_max(l - 1).long()
    is_fit, pend, admitted = buf.is_fit, buf.pend, buf.admitted
    retries = state.retries

    over_budget = retries >= state.cap
    stuck = state.stuck | (active & ~is_fit & pend & over_budget)
    resolve = active & (admitted | (~is_fit & ~pend))
    stuck = stuck & ~resolve
    retrying = active & ~is_fit & pend & ~stuck
    advance = resolve
    retries = torch.where(
        advance | ~active, 0, torch.where(retrying, retries + 1, retries)
    ).to(I32)
    no_prog = torch.where(advance.any(), 0, state.no_prog + 1).to(I32)
    stuck = stuck | ((no_prog >= 2 * state.cap.max()) & active & ~advance)
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

    state.retries.copy_(retries)
    state.stuck.copy_(stuck)
    state.no_prog.copy_(no_prog)
    state.g_start.copy_(g_start)
    state.cursor.copy_(cursor)
    state.cycle.copy_(cycle)
    if ctx.max_rounds == 0:  # in the megaloop the round boundary owns done
        go = ((cursor < queues.qlen) & ~stuck).any() & (cycle < ctx.max_cycles)
        state.done.copy_((~go).to(I32).reshape(1))


# ---- kernels 2-4 (csrc/drain_*.cu) ---------------------------------------


@dataclass
class FairInputs:
    """The fair-sharing drain's extra inputs (``solve_drain(fair=)``) and
    the scratch its kernel keeps between the steps of a cycle."""

    depth_of: torch.Tensor  # int32[N] tree depth (roots 0)
    weight: torch.Tensor  # int64[N] fairSharing weight (milli)
    lendable: torch.Tensor  # int64[N,R] quota-only lendable per resource
    res_of_fr: torch.Tensor  # int32[FR] cell -> resource bucket
    n_res: int
    prio_tie: bool  # PrioritySortingWithinCohort
    chain: Optional[torch.Tensor] = None  # int64[Q,D+1] kernel scratch
    flags: Optional[torch.Tensor] = None  # uint8[Q] kernel scratch


class SegVictims(NamedTuple):
    """Per-root-cohort (segment) candidate pools and per-queue search
    configuration of the preempt drain (the JAX ``SegVictims``).

    S segments, V pool slots per segment, Cv cells per victim, M local
    nodes per segment (its ClusterQueues, interior cohorts and root),
    D+1 path length, Q queues, L entries per queue.

    Pool slots come in two parts. Part A: workloads admitted in the
    snapshot, static. Part B: one slot per pending entry of the segment,
    invalid until the drain admits the entry; then the cycle fills it
    with the admitted cells and quantities, so the entry is a live
    reclaim candidate from the next cycle on (the host cycle loop sees
    drain-admitted workloads in its snapshot the same way;
    preemption.go:480-524).

    scells/sqty: int32/int64[S,V,Cv] the slot's global cells and usage
            (-1 pads; part B -1 until filled).
    sprio/sts: int64[S,V] priority and queue-order timestamp.
    svalid0: bool[S,V] slot live at drain start (part A).
    sowner: int32[S,V] owner ClusterQueue's tree row (-1 pad).
    sowner_local: int32[S,V] owner's segment-local node id.
    sslot_q/sslot_l: int32[S,V] part B: the (queue, position) of the
            slot's entry (-1 for part A).
    seg_nodes: int32[S,M] global rows of the segment's nodes (-1 pad).
    lpaths: int32[S,M,D+1] each local node's ancestor path in local ids.
    hlocal: int32[Q] each queue's ClusterQueue as a local node id.
    perm: int32[Q,V] the queue's candidate order over its segment's
            slots (preemption.go:591-618).
    entry_slot: int32[Q,L] part-B slot of each entry (-1 none).
    same_enabled: bool[Q] withinClusterQueue != Never.
    same_prio_ok: bool[Q] withinClusterQueue == LowerOrNewerEqualPriority.
    reclaim_enabled: bool[Q] reclaimWithinCohort != Never (with cohort).
    only_lower: bool[Q] reclaimWithinCohort != Any.
    bwc: bool[Q] borrowWithinCohort.policy != Never.
    bwc_thr1: int64[Q] maxPriorityThreshold + 1 (NO_BWC_THRESHOLD when
            unset); the threshold is min(head priority, bwc_thr1)
            (preemption.go:194-204).
    """

    scells: torch.Tensor
    sqty: torch.Tensor
    sprio: torch.Tensor
    sts: torch.Tensor
    svalid0: torch.Tensor
    sowner: torch.Tensor
    sowner_local: torch.Tensor
    sslot_q: torch.Tensor
    sslot_l: torch.Tensor
    seg_nodes: torch.Tensor
    lpaths: torch.Tensor
    hlocal: torch.Tensor
    perm: torch.Tensor
    entry_slot: torch.Tensor
    same_enabled: torch.Tensor
    same_prio_ok: torch.Tensor
    reclaim_enabled: torch.Tensor
    only_lower: torch.Tensor
    bwc: torch.Tensor
    bwc_thr1: torch.Tensor


class FairSegPanels(NamedTuple):
    """Per-root-cohort local panels of the fair-preempt drain's victim
    tournament (the JAX ``FairSegPanels``; shapes shared with
    SegVictims). S segments, M local nodes, Cu panel cells (the
    segment's ACTIVE cell universe: every flavor-resource with quota or
    usage anywhere in the root cohort, plus every queued entry's
    candidate cells; DRS aggregates over all of them,
    fair_sharing.go:49-104), V pool slots.

    seg_cells:    int32[S,Cu] global cell ids (-1 pads).
    parent_local: int32[S,M] local parent (-1 root / pads).
    depth_local:  int32[S,M] local depth (segment root 0).
    is_cq_local, node_valid: bool[S,M].
    weight_local: int64[S,M] fairSharing weight (milli) per node.
    res_of_cell:  int32[S,Cu] panel cell -> resource bucket; pads point
                  at the inert extra bucket (n_res).
    svqty_cu:     int64[S,V,Cu] pool-slot usage at panel cell positions
                  (part A static; part B zero until the drain admits the
                  entry and fills the slot).
    """

    seg_cells: torch.Tensor
    parent_local: torch.Tensor
    depth_local: torch.Tensor
    is_cq_local: torch.Tensor
    node_valid: torch.Tensor
    weight_local: torch.Tensor
    res_of_cell: torch.Tensor
    svqty_cu: torch.Tensor


# SegVictims fields indexed per queue (the [Q, ...] axis)
SEG_VICTIM_Q_FIELDS = (
    "hlocal", "perm", "entry_slot", "same_enabled", "same_prio_ok",
    "reclaim_enabled", "only_lower", "bwc", "bwc_thr1",
)

# bwc_thr1 sentinel meaning "no maxPriorityThreshold configured"
NO_BWC_THRESHOLD = 1 << 60

# widest shapes the preempt drain's kernels take: a victim's cells, the
# candidate window, a segment's nodes
MAX_CV = 32
MAX_SEARCH_WIDTH = 512
MAX_M = 64
# widest fair panels the fair-preempt drain's kernels take
# (csrc/drain_fair_preempt_search.cu): panel cells (resource buckets one
# more) and segment nodes
MAX_FAIR_CU = 64
MAX_FAIR_M = 64


@dataclass
class PreemptInputs:
    """The preempt drain's extra inputs (``solve_drain_preempt``): the
    segment candidate pools and the candidate window of one search."""

    victims: SegVictims
    search_width: int
    # drain_preempt_motion's reductions and per-queue flags (int32[4 +
    # ceil(Q/4)], the kernel resets it after each launch)
    motion_scratch: Optional[torch.Tensor] = None


@dataclass
class FairPreemptInputs:
    """The fair-preempt drain's extra inputs
    (``solve_drain_fair_preempt``): the segments' fair panels and the
    strategy stack."""

    panels: FairSegPanels
    strategy1: int
    has_second: bool
    # drain_fair_preempt_phase2's fit tree where its rows stay in device
    # memory (int64[N, FR] scratch, filled by the kernel)
    fit_usage: Optional[torch.Tensor] = None


def _motion_scratch_len(q: int) -> int:
    return 4 + -(-q // 4)


def motion_scratch(q: int, device) -> torch.Tensor:
    """drain_preempt_motion's scratch as a launch finds it: the ticket,
    the progress and live flags zero, the largest retry cap at INT_MIN,
    then a byte a queue."""
    t = torch.zeros(_motion_scratch_len(q), dtype=I32, device=device)
    t[2] = torch.iinfo(torch.int32).min
    return t


@dataclass
class DrainContext:
    """What stays fixed for one drain: the tree and its derived
    matrices, the queues, paths, segments and the static sizes; for the
    megaloop its round sizes, for the fair drain its extra inputs. The
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
    chunk_cycles: int = 0  # megaloop only: cycles per round
    max_rounds: int = 0  # megaloop only; 0 for the plain and fair drains
    fair: Optional[FairInputs] = None
    preempt: Optional[PreemptInputs] = None
    fair_preempt: Optional[FairPreemptInputs] = None
    tas: Optional["TASInputs"] = None
    _args: Optional[tuple] = None  # (state, buf, ints, ptrs)

    @classmethod
    def build(cls, tree, queues, paths, n_segments, n_steps, max_cycles,
              seg_id=None, **extra):
        """``seg_id`` is the host copy of ``queues.seg_id`` (read back
        from the device when not given)."""
        subtree, guaranteed = subtree_quota(tree)
        potential = potential_available_all(tree, subtree, guaranteed)
        if seg_id is None:
            seg_id = queues.seg_id.cpu().numpy()
        segments = build_segments(seg_id, tree.device)
        fair = extra.get("fair")
        if fair is not None and fair.chain is None:
            q = queues.qlen.shape[0]
            fair.chain = torch.zeros((q, tree.max_depth + 1), dtype=I64, device=tree.device)
            fair.flags = torch.zeros(q, dtype=torch.uint8, device=tree.device)
        tas = extra.get("tas")
        if tas is not None and tas.nd is None:
            tas.nd = torch.tensor(tas.n_domains, dtype=I32).to(tree.device)
            if bool((tas.heads.t_count >= 0).all()):
                tas.groups = tas_leaf_groups(tas.seg_ids.cpu().numpy(), tas.n_domains,
                                             tas.heads.parent_map.cpu().numpy(), tree.device)
        fp = extra.get("fair_preempt")
        if fp is not None and fp.fit_usage is None and tree.nominal.is_cuda:
            fp.fit_usage = torch.empty_like(tree.nominal)
        pre = extra.get("preempt")
        if pre is not None and pre.motion_scratch is None and tree.nominal.is_cuda:
            pre.motion_scratch = motion_scratch(queues.qlen.shape[0], tree.device)
        return cls(
            tree, subtree, guaranteed, potential, paths, queues, segments,
            n_segments, n_steps, max_cycles, **extra,
        )

    def kernel_args(self, kernel: str, state: DrainState, buf: CycleBuffers):
        """(ints, ptrs) ctypes arrays in csrc/drain_common.cuh order,
        every tensor checked; cached for the last (state, buf). The
        megaloop's round log (a MegaloopState's extra fields), the fair
        inputs and the preempt drain's pools, state and buffers (a
        PreemptState and PreemptBuffers) are NULL where the drain has
        none."""
        cached = self._args
        if cached is not None and cached[0] is state and cached[1] is buf:
            return cached[2], cached[3]
        queues, tree = self.queues, self.tree
        q, l, pmax, k, c = queues.cells.shape
        g = queues.gidx.shape[-1]
        n, fr = tree.nominal.shape
        d1 = tree.max_depth + 1
        if k > MAX_K or c > MAX_C or g > MAX_G or pmax > MAX_P:
            raise _build.KernelInputError(
                f"{kernel}: the drain kernels take K<={MAX_K}, C<={MAX_C}, "
                f"G<={MAX_G}, P<={MAX_P}; got K={k}, C={c}, G={g}, P={pmax}"
            )
        s = self.segments.count
        e5, e4 = (q, l, pmax, k, c), (q, l, pmax, k)
        eg = (q, l, pmax, k, g)
        rr = self.max_rounds
        fair = self.fair
        if fair is not None and fair.n_res > MAX_R:
            raise _build.KernelInputError(
                f"{kernel}: the fair drain takes at most {MAX_R} resources, got {fair.n_res}"
            )
        rounds = getattr(state, "adm_round", None) is not None
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
            ("paths", self.paths, I32, (n, d1)),
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
            ("alive", state.alive, BOOL, (q,)),
            ("cap", state.cap, I32, (q,)),
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
            # the megaloop's round log (MegaloopState)
            ("cap_suffix", getattr(state, "cap_suffix", None), I32, (q, l)),
            ("adm_round", getattr(state, "adm_round", None), I32, (q, l)),
            ("round_idx", getattr(state, "round_idx", None), I32, (1,)),
            ("total", getattr(state, "total", None), I32, (1,)),
            ("r_cursor", getattr(state, "r_cursor", None), I32, (rr, q)),
            ("r_stuck", getattr(state, "r_stuck", None), BOOL, (rr, q)),
            ("r_cycles", getattr(state, "r_cycles", None), I32, (rr,)),
            ("r_usage", getattr(state, "r_usage", None), I64, (rr, n, fr)),
        ]
        if rounds != (rr > 0):
            raise _build.KernelInputError(
                f"{kernel}: a megaloop context needs a MegaloopState and only it"
            )
        if fair is not None:
            nr = fair.lendable.shape[1]
            spec += [
                ("depth_of", fair.depth_of, I32, (n,)),
                ("weight", fair.weight, I64, (n,)),
                ("lendable", fair.lendable, I64, (n, nr)),
                ("res_of_fr", fair.res_of_fr, I32, (fr,)),
                ("chain", fair.chain, I64, (q, d1)),
                ("flags", fair.flags, torch.uint8, (q,)),
            ]
        else:
            spec += [(name, None, None, None) for name in (
                "depth_of", "weight", "lendable", "res_of_fr", "chain", "flags")]
        pre = self.preempt
        v = cv = m = width = 0
        if pre is not None:
            vic = pre.victims
            s_dim, v, cv = vic.scells.shape
            m = vic.seg_nodes.shape[1]
            width = pre.search_width
            if (cv > MAX_CV or width > MAX_SEARCH_WIDTH or m > MAX_M or pmax * c > 32
                    or s_dim != self.n_segments):
                raise _build.KernelInputError(
                    f"{kernel}: the preempt drain takes Cv<={MAX_CV} victim cells, "
                    f"search_width<={MAX_SEARCH_WIDTH}, M<={MAX_M} segment nodes, P*C<=32 "
                    f"and one pool per segment; got Cv={cv}, search_width={width}, M={m}, "
                    f"P*C={pmax * c}, {s_dim} pools for {self.n_segments} segments"
                )
            sv, svc = (s_dim, v), (s_dim, v, cv)
            spec += [
                # SegVictims (the kernels read the live pool from the state)
                ("sprio", vic.sprio, I64, sv),
                ("sts", vic.sts, I64, sv),
                ("sowner", vic.sowner, I32, sv),
                ("sowner_local", vic.sowner_local, I32, sv),
                ("seg_nodes", vic.seg_nodes, I32, (s_dim, m)),
                ("lpaths", vic.lpaths, I32, (s_dim, m, d1)),
                ("hlocal", vic.hlocal, I32, (q,)),
                ("perm", vic.perm, I32, (q, v)),
                ("entry_slot", vic.entry_slot, I32, (q, l)),
                ("same_enabled", vic.same_enabled, BOOL, (q,)),
                ("same_prio_ok", vic.same_prio_ok, BOOL, (q,)),
                ("reclaim_enabled", vic.reclaim_enabled, BOOL, (q,)),
                ("only_lower", vic.only_lower, BOOL, (q,)),
                ("bwc", vic.bwc, BOOL, (q,)),
                ("bwc_thr1", vic.bwc_thr1, I64, (q,)),
                # PreemptState
                ("status", state.status, I32, (q, l)),
                ("pcells", state.pcells, I32, svc),
                ("pqty", state.pqty, I64, svc),
                ("pvalid", state.pvalid, BOOL, sv),
                ("vevicted", state.vevicted, BOOL, sv),
                ("evict_cycle", state.evict_cycle, I32, sv),
                ("evict_by", state.evict_by, I32, sv),
                ("ovf", state.ovf, BOOL, (1,)),
                # PreemptBuffers
                ("need_pre", buf.need_pre, BOOL, (q, pmax * c)),
                ("elig_same", buf.elig_same, BOOL, (q, v)),
                ("veto", buf.veto, BOOL, (q, fr)),
                ("targets", buf.targets, BOOL, (q, v)),
                ("psuccess", buf.psuccess, BOOL, (q,)),
                ("untrusted", buf.untrusted, BOOL, (q,)),
                ("preempt_ok", buf.preempt_ok, BOOL, (q,)),
                ("leaf", buf.leaf, I64, (n, fr)),
                ("ev_now", buf.ev_now, BOOL, sv),
                ("ev_by", buf.ev_by, I32, sv),
            ]
        else:
            spec += [(name, None, None, None) for name in range(PREEMPT_PTRS)]
        fp = self.fair_preempt
        cu = strategy1 = has_second = 0
        if fp is not None:
            pan = fp.panels
            s_dim = pan.seg_cells.shape[0]
            cu = pan.seg_cells.shape[1]
            strategy1, has_second = int(fp.strategy1), int(bool(fp.has_second))
            if fair is None or pre is None or cu > MAX_FAIR_CU or m > MAX_FAIR_M:
                raise _build.KernelInputError(
                    f"{kernel}: the fair-preempt drain needs the fair and preempt inputs and "
                    f"takes Cu<={MAX_FAIR_CU} panel cells and M<={MAX_FAIR_M} segment nodes; "
                    f"got Cu={cu}, M={m}"
                )
            sm = (s_dim, m)
            spec += [
                ("seg_cells", pan.seg_cells, I32, (s_dim, cu)),
                ("parent_local", pan.parent_local, I32, sm),
                ("depth_local", pan.depth_local, I32, sm),
                ("is_cq_local", pan.is_cq_local, BOOL, sm),
                ("node_valid", pan.node_valid, BOOL, sm),
                ("weight_local", pan.weight_local, I64, sm),
                ("res_of_cell", pan.res_of_cell, I32, (s_dim, cu)),
                ("pq_cu", state.pq_cu, I64, (s_dim, v, cu)),
            ]
        else:
            spec += [(name, None, None, None) for name in range(FAIR_PREEMPT_PTRS)]
        tas = self.tas
        lf = rt = d_t = nd = 0
        if tas is not None:
            th = tas.heads
            lf, rt = tas.topo_free.shape
            d_t = len(tas.n_domains)
            nd = th.parent_map.shape[1]
            if (nd > MAX_TAS_ND or d_t > MAX_TAS_DEPTH or rt > MAX_TAS_R or pmax * c > 32
                    or max(tas.n_domains) > nd):
                raise _build.KernelInputError(
                    f"{kernel}: the TAS drain takes ND<={MAX_TAS_ND} domains a level, "
                    f"D<={MAX_TAS_DEPTH} levels, Rt<={MAX_TAS_R} resources and P*C<=32; "
                    f"got ND={nd}, D={d_t}, Rt={rt}, P*C={pmax * c}"
                )
            spec += [
                ("topo_free", tas.topo_free, I64, (lf, rt)),
                ("seg_ids", tas.seg_ids, I32, (d_t, lf)),
                ("n_domains", tas.nd, I32, (d_t,)),
                ("t_is", th.t_is, BOOL, (q,)),
                ("t_req", th.t_req, I64, (q, l, rt)),
                ("t_count", th.t_count, I32, (q, l)),
                ("t_level", th.t_level, I32, (q, l)),
                ("t_mode", th.t_mode, I32, (q, l)),
                ("t_top", th.t_top, I32, (q,)),
                ("t_flavor", th.t_flavor, I32, (q,)),
                ("leaf_flavor", th.leaf_flavor, I32, (lf,)),
                ("parent_map", th.parent_map, I32, (d_t, nd)),
                ("t_bad", th.t_bad, BOOL, (q, l)),
                # TASState, TASBuffers
                ("tas_u", state.tas_u, I64, (lf, rt)),
                ("adm_step", state.adm_step, I32, (q, l)),
                ("tas_nom_ok", buf.tas_nom_ok, BOOL, (q,)),
                ("taken0", buf.taken0, I64, (q, lf)),
            ]
            grp = tas.groups
            if grp is None:
                raise _build.KernelInputError(
                    f"{kernel}: the TAS kernels take a nested domain forest (each domain's "
                    "leaves inside one domain of the level above) and gang sizes >= 0"
                )
            spec += [
                ("leaf_order", grp.leaf_order, I32, (lf,)),
                ("dom_beg", grp.dom_beg, I32, (d_t, nd)),
                ("dom_end", grp.dom_end, I32, (d_t, nd)),
                ("child_off", grp.child_off, I32, (d_t, nd + 1)),
                ("child_list", grp.child_list, I32, (d_t, nd)),
            ]
        else:
            spec += [(name, None, None, None) for name in range(TAS_PTRS)]
        spec.append(("fit_usage", fp.fit_usage if fp is not None else None, I64, (n, fr)))
        spec.append(("motion_scratch", pre.motion_scratch if pre is not None else None, I32,
                     (_motion_scratch_len(q),)))
        ptrs = [_build.ptr(kernel, name, t, dt, sh) for name, t, dt, sh in spec]
        ints = [
            q, l, pmax, k, c, g, n, fr, tree.max_depth,
            self.n_segments, self.n_steps, s, self.max_cycles,
            self.chunk_cycles, rr,
            fair.n_res if fair is not None else 0,
            int(bool(fair.prio_tie)) if fair is not None else 0,
            v, cv, m, width,
            cu, strategy1, has_second,
            lf, rt, d_t, nd,
            self.segments.max_size,
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
    """Kernel 2: every queue head's nomination (one warp per queue)."""
    if not state.local.is_cuda:
        return drain_nominate_plain(ctx, state, buf)
    _launch("drain_nominate", ctx, state, buf)


# drain_phase2's shared memory (csrc/drain_phase2.cu): a block's opt-in
# bytes, and the walked heads a staging window holds
PHASE2_SHARED_BYTES = 232448 - 1024
PHASE2_WINDOW = 32


def _align8(b: int) -> int:
    return (b + 7) & ~7


def phase2_segment_bytes(n_walk: int, fr: int, max_depth: int) -> int:
    """Shared-memory bytes drain_phase2 needs to walk a segment of
    ``n_walk`` walked heads on shared rows: per path entry (head, level)
    a node id, a slot and the subtree, guaranteed, borrowing-limit, usage
    and nominal rows of FR cells (``segment_bytes`` in the kernel)."""
    return n_walk * (max_depth + 1) * (8 + 40 * fr)


def phase2_layout(max_members: int, n_steps: int, pc: int, fr: int, max_depth: int):
    """drain_phase2's shared memory a block, as the kernel plans it
    (``plan_layout`` in csrc/drain_phase2.cu): the members' sort keys,
    ClusterQueue rows and paths (left in device memory when they do not
    fit), the walk order and its admissions, two staging windows and the
    rows of the largest walk, capped by what is left. Returns {"win",
    "keys", "rows_bytes", "total"}, or None when even one-head windows
    do not fit."""
    m, d1 = max(max_members, 1), max_depth + 1
    base = _align8(4 * m) + _align8(m)
    keys = _align8(4 * m) + _align8(m) + 16 * m + _align8(4 * m) + _align8(4 * m * d1)

    def window(win):
        return _align8(4 * win * (pc + max_depth + 4)) + 8 * win * pc

    win = PHASE2_WINDOW
    with_keys = base + keys + 2 * window(win) <= PHASE2_SHARED_BYTES
    if not with_keys:
        while win > 1 and base + 2 * window(win) > PHASE2_SHARED_BYTES:
            win >>= 1
        if base + 2 * window(win) > PHASE2_SHARED_BYTES:
            return None
    fixed = base + 2 * window(win) + (keys if with_keys else 0)
    need = _align8(phase2_segment_bytes(min(m, max(n_steps, 0)), fr, max_depth))
    rows = min(need, PHASE2_SHARED_BYTES - fixed)
    return {"win": win, "keys": with_keys, "rows_bytes": rows, "total": fixed + rows}


def drain_phase2(ctx: DrainContext, state: DrainState, buf: CycleBuffers) -> None:
    """Kernel 3: conflict resolution in entry order (one block per root
    segment; keys and the walk's rows in shared memory)."""
    if not state.local.is_cuda:
        return drain_phase2_plain(ctx, state, buf)
    _launch("drain_phase2", ctx, state, buf)


def drain_queue_motion(ctx: DrainContext, state: DrainState, buf: CycleBuffers) -> None:
    """Kernel 4: queue motion, the cycle counter and the done flag (one
    block striding over the queues)."""
    if not state.local.is_cuda:
        return drain_queue_motion_plain(ctx, state, buf)
    _launch("drain_queue_motion", ctx, state, buf)


# ---- the fair-sharing drain's phase 2 (kernel drain_fair_phase2) -----------


def _segment_min(vals, seg, num: int):
    """jax.ops.segment_min: the minimum of ``vals`` per segment id, the
    int64 maximum for an empty segment."""
    out = torch.full((num,), torch.iinfo(I64).max, dtype=I64, device=vals.device)
    return out.scatter_reduce_(0, seg, vals, "amin", include_self=True)


def _fair_chain(
    usage, borrowed_base, paths_q, mcells, mqty, subtree, guaranteed,
    lendable, weight, parent, res_of, n_res: int, max_depth: int,
):
    """Per-head fair-sharing DRS chain (the JAX ``_fair_chain``): for
    each queue q and path level d, the DominantResourceShare of path
    node d with q's representative usage added at its ClusterQueue row.
    Only the head's cells change, so the node's per-resource borrowed
    total is ``borrowed_base`` plus the head-cell delta; lendable is
    quota-only. Returns int64[Q, D+1]."""
    qn = mcells.shape[0]
    dev = usage.device
    cells_c = mcells.clamp_min(0).long()
    cell_ok = (mcells >= 0) & (mqty > 0)
    delta = torch.where(cell_ok, mqty, 0)
    q_rows = torch.arange(qn, device=dev)[:, None].expand_as(res_of)
    chains = []
    for d in range(max_depth + 1):
        node = paths_q[:, d].clamp_min(0).long()
        node_valid = paths_q[:, d] >= 0
        u_at = usage[node[:, None], cells_c]
        sub_at = subtree[node[:, None], cells_c]
        g_at = guaranteed[node[:, None], cells_c]
        new = u_at + delta
        bdelta = (new - sub_at).clamp_min(0) - (u_at - sub_at).clamp_min(0)
        badd = torch.zeros((qn, n_res + 1), dtype=I64, device=dev)
        badd.index_put_(
            (q_rows, res_of.long()), torch.where(cell_ok, bdelta, 0), accumulate=True
        )
        borrowed = borrowed_base[node] + badd[:, :n_res]
        lend = lendable[node]
        ratio = torch.where(
            (borrowed > 0) & (lend > 0), borrowed * 1000 // lend.clamp_min(1), -1
        )
        drs = ratio.amax(dim=1)
        has_parent = parent[node] >= 0
        active = (borrowed > 0).any(dim=1) & has_parent & node_valid
        w = weight[node]
        num = drs * 1000
        trunc = torch.sign(num) * (num.abs() // w.clamp_min(1))
        chains.append(torch.where(active, torch.where(w == 0, DRS_MAX, trunc), 0))
        # bubble the head usage to the next level (over-guaranteed)
        delta = torch.where(
            node_valid[:, None],
            (new - g_at).clamp_min(0) - (u_at - g_at).clamp_min(0),
            delta,
        )
    return torch.stack(chains, dim=1)


def _fair_tournament(
    chain, remaining, paths_q, cq_rows, depth_of, parent, prio, ts,
    n_nodes: int, max_tree_depth: int, prio_tie: bool,
):
    """One fair-sharing pop per root cohort (the JAX ``_fair_tournament``):
    every cohort node picks the best of its children's winners by the
    child's DRS (the winner's chain value at the child's level), then
    -priority when ``prio_tie``, then timestamp, then queue index; a
    node keeps its winner only when some proposal's DRS is below
    INF = 2^62. Returns bool[Q]: this queue's head wins its root."""
    inf = 1 << 62
    qn = remaining.shape[0]
    dev = chain.device
    q_ar = torch.arange(qn, device=dev)
    cqr = cq_rows.clamp_min(0).long()
    head_depth = depth_of[cqr].long()
    win = torch.full((n_nodes + 1,), -1, dtype=I64, device=dev)
    win[torch.where(remaining, cqr, n_nodes)] = q_ar
    win_q = win[:n_nodes]
    tie1 = -prio if prio_tie else torch.zeros_like(prio)
    par = parent.long()
    pp = par.clamp_min(0)
    for d in range(max_tree_depth, 0, -1):
        at_d = (depth_of == d) & (win_q >= 0)
        wq = win_q.clamp_min(0)
        lvl = (head_depth[wq] - d).clamp(0, chain.shape[1] - 1)
        k_dws = torch.where(at_d, chain[wq, lvl], inf)
        k_t1 = torch.where(at_d, tie1[wq], inf)
        k_t2 = torch.where(at_d, ts[wq], inf)
        k_qi = torch.where(at_d, wq, inf)
        seg = torch.where(at_d & (par >= 0), par, n_nodes)
        m1 = _segment_min(k_dws, seg, n_nodes + 1)[:n_nodes]
        s1 = at_d & (k_dws == m1[pp])
        m2 = _segment_min(torch.where(s1, k_t1, inf), seg, n_nodes + 1)[:n_nodes]
        s2 = s1 & (k_t1 == m2[pp])
        m3 = _segment_min(torch.where(s2, k_t2, inf), seg, n_nodes + 1)[:n_nodes]
        s3 = s2 & (k_t2 == m3[pp])
        m4 = _segment_min(torch.where(s3, k_qi, inf), seg, n_nodes + 1)[:n_nodes]
        parent_win = torch.where(m4 < inf, m4, -1)
        # only nodes that received proposals overwrite their winner
        win_q = torch.where(m1 < inf, parent_win, win_q)
    root_pos = (paths_q >= 0).sum(dim=1) - 1
    root_row = paths_q[q_ar, root_pos.clamp_min(0)].clamp_min(0).long()
    return remaining & (win_q[root_row] == q_ar)


def drain_fair_phase2_plain(ctx: DrainContext, state: DrainState, buf: CycleBuffers) -> None:
    """The fair cycle's conflict resolution (the step scan of the JAX
    ``solve_drain_fair``): each of ``n_steps`` steps pops one head per
    root cohort through the DRS tournament against the live usage
    tree, then admits it (or reserves for it) exactly as phase 2 does.
    Mutates ``buf.usage``; admissions are added to ``state.local``."""
    if _done(state):
        return
    tree, queues, fair = ctx.tree, ctx.queues, ctx.fair
    subtree, guaranteed = ctx.subtree, ctx.guaranteed
    max_depth = tree.max_depth
    q, l = queues.priority.shape
    n_nodes, fr = tree.nominal.shape
    dev = buf.usage.device
    q_idx = torch.arange(q, device=dev)
    active = (state.cursor < queues.qlen) & state.alive
    cur = state.cursor.clamp_max(l - 1).long()
    is_fit, is_pre, head_borrow = buf.is_fit, buf.is_pre, buf.head_borrow
    cells_eff, qty_eff = buf.cells_eff, buf.qty_eff
    nofit = ~(is_fit | is_pre)
    prio = queues.priority[q_idx, cur]
    ts = queues.timestamp[q_idx, cur]
    cq = queues.cq_rows.clamp_min(0).long()
    paths_q = ctx.paths[cq]
    cells_c = cells_eff.clamp_min(0).long()
    cell_valid_all = (cells_eff >= 0) & (qty_eff > 0)
    n_res = fair.n_res
    res_of_q = torch.where(cell_valid_all, fair.res_of_fr[cells_c], n_res)
    node_rows = torch.arange(n_nodes, device=dev)[:, None].expand(n_nodes, fr)
    node_res = fair.res_of_fr.long()[None, :].expand(n_nodes, fr)
    nominal_c = tree.nominal[cq[:, None], cells_c]
    bl_c = tree.borrowing_limit[cq[:, None], cells_c]

    usage = buf.usage
    remaining = active & ~nofit & (queues.cq_rows >= 0)
    admitted = torch.zeros(q, dtype=BOOL, device=dev)
    for _ in range(ctx.n_steps):
        if not bool(remaining.any()):
            break  # later steps have no winner and change nothing
        bb = torch.zeros((n_nodes, n_res + 1), dtype=I64, device=dev)
        bb.index_put_((node_rows, node_res), (usage - subtree).clamp_min(0), accumulate=True)
        chain = _fair_chain(
            usage, bb[:, :n_res], paths_q, cells_eff, qty_eff, subtree, guaranteed,
            fair.lendable, fair.weight, tree.parent, res_of_q, n_res, max_depth,
        )
        win = _fair_tournament(
            chain, remaining, paths_q, queues.cq_rows, fair.depth_of, tree.parent,
            prio, ts, n_nodes, max_depth, fair.prio_tie,
        )
        avail = _avail_along_path(
            paths_q, cells_eff, usage, subtree, guaranteed, tree.borrowing_limit, max_depth
        )
        cell_valid = cell_valid_all & win[:, None]
        fits = torch.where(cell_valid, avail >= qty_eff, True).all(dim=1)
        admit = win & is_fit & fits
        reserve = win & is_pre & queues.no_reclaim
        leaf_usage_c = usage[cq[:, None], cells_c]
        borrow_cap = torch.where(
            bl_c < NO_LIMIT, torch.minimum(qty_eff, nominal_c + bl_c - leaf_usage_c), qty_eff
        )
        nominal_cap = torch.minimum(qty_eff, nominal_c - leaf_usage_c).clamp_min(0)
        reserve_qty = torch.where(head_borrow[:, None], borrow_cap, nominal_cap)
        delta = torch.where(
            cell_valid & admit[:, None],
            qty_eff,
            torch.where(cell_valid & reserve[:, None], reserve_qty, 0),
        )
        # winners are one per root cohort: their paths are disjoint
        _charge_paths(usage, guaranteed, paths_q, cells_c, delta, max_depth)
        remaining = remaining & ~win
        admitted = admitted | admit
    # leaf usage adds for admissions only: reservations die with the cycle
    add = torch.where(cell_valid_all & admitted[:, None], qty_eff, 0)
    state.local.index_put_((cq[:, None].expand_as(cells_c), cells_c), add, accumulate=True)
    buf.admitted.copy_(admitted)


def drain_fair_phase2(ctx: DrainContext, state: DrainState, buf: CycleBuffers) -> None:
    """Kernel 5: the fair cycle's tournament and admissions (one block
    per root segment)."""
    if not state.local.is_cuda:
        return drain_fair_phase2_plain(ctx, state, buf)
    _launch("drain_fair_phase2", ctx, state, buf)


# ---- the drain ----------------------------------------------------------


def drain_cycle(ctx: DrainContext, state: DrainState, buf: CycleBuffers) -> None:
    """ONE drain cycle: four launches on the card (or their plain
    versions on the CPU); the fair drain's phase 2 is its tournament."""
    usage_and_available(ctx.tree, ctx.subtree, ctx.guaranteed, state.local, buf.usage,
                        buf.avail, done=state.done)
    drain_nominate(ctx, state, buf)
    if ctx.fair is None:
        drain_phase2(ctx, state, buf)
    else:
        drain_fair_phase2(ctx, state, buf)
    drain_queue_motion(ctx, state, buf)


# cycles the host enqueues between two reads of the device done flag
CHECK_EVERY_CUDA = 8
CHECK_EVERY_CPU = 1
# a launch bounded by at most this many cycles (a pipeline chunk, a
# megaloop's chunk_cycles x max_rounds) is enqueued whole, with no read
# of the flag: cycles past the end return at once
ENQUEUE_ALL_CYCLES = 256
# reads of the device done flag on the card (each one a host sync)
DONE_READS = 0


def run_cycles(ctx, state, buf, cycle, bound: int) -> None:
    """Run ``cycle(ctx, state, buf)`` until the device ``done`` flag is
    set. On the card with ``bound`` at most ENQUEUE_ALL_CYCLES, all
    ``bound`` cycles are enqueued with no host read, so the caller's
    one fetch is the only sync; otherwise the flag is read every
    CHECK_EVERY_CUDA cycles (CHECK_EVERY_CPU on the CPU). The result is
    the same either way."""
    global DONE_READS
    on_card = state.local.is_cuda
    if on_card and bound <= ENQUEUE_ALL_CYCLES:
        for _ in range(bound):
            cycle(ctx, state, buf)
        return
    every = CHECK_EVERY_CUDA if on_card else CHECK_EVERY_CPU
    while True:
        DONE_READS += int(on_card)
        if bool(state.done.item()):
            return
        for _ in range(every):
            cycle(ctx, state, buf)


def solve_drain(
    tree: QuotaTree,
    local_usage: torch.Tensor,  # int64[N, FR] starting leaf usage
    queues: DrainQueues,
    paths: torch.Tensor,  # int32[N, D+1]
    n_segments: int,
    n_steps: int,
    max_cycles: int,
    seg_id=None,  # host copy of queues.seg_id
    fair: Optional[FairInputs] = None,
) -> DrainResult:
    """The plain drain to quiescence or ``max_cycles``; with ``fair``
    the fair-sharing drain (the JAX ``solve_drain_fair``): each cycle
    pops heads by the cohort DRS tournament, one per root cohort a
    step, every pop against the usage as the cycle's earlier admissions
    and reservations left it, while nomination and queue motion stay
    the plain drain's."""
    ctx = DrainContext.build(
        tree, queues, paths, n_segments, n_steps, max_cycles, seg_id=seg_id, fair=fair
    )
    state = DrainState.initial(local_usage, queues, max_cycles)
    buf = CycleBuffers.empty(local_usage, queues)
    run_cycles(ctx, state, buf, drain_cycle, max_cycles)
    return DrainResult(
        admitted_k=state.adm_k,
        admitted_cycle=state.adm_cycle,
        cursor=state.cursor,
        cycles=state.cycle,
        local_usage=state.local,
        stuck=state.stuck,
    )


def _pack_drain(r: DrainResult) -> torch.Tensor:
    """The decision tensors flattened into one int64 vector (the JAX
    ``_solve_drain_packed`` layout), so the host retrieves the whole
    drain in a single copy."""
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


def _solve_drain_packed(
    tree, local_usage, queues, paths, n_segments: int, n_steps: int, max_cycles: int,
    seg_id=None, fair: Optional[FairInputs] = None,
) -> torch.Tensor:
    """solve_drain, packed; the plain and the fair drain share the
    layout, so one decoder serves both scopes."""
    return _pack_drain(solve_drain(
        tree, local_usage, queues, paths, n_segments, n_steps, max_cycles,
        seg_id=seg_id, fair=fair,
    ))


# ---- the preempt drain (kernels drain_preempt_*) ---------------------------


class PreemptDrainResult(NamedTuple):
    """status: int32[Q,L] final entry state (0 pending, 1 parked, 2
    admitted); admitted_k / admitted_cycle as DrainResult; evicted:
    bool[S,V] the pool slot was preempted (part-A snapshot victims and
    part-B drain-admitted entries); evicted_cycle: int32[S,V];
    evicted_by: int32[S,V] the evicting queue (-1 where not evicted):
    the overlap guard and the live mask let one head at most evict a
    slot, so the attribution is exact; stuck: bool[Q]; cycles;
    local_usage; overflowed: bool — some head's eligible candidates
    overflowed the ``search_width`` window and its search missed; while
    it is False every truncated search was exact, so the decisions equal
    any wider window's (the panel ladder's escalation trigger)."""

    status: torch.Tensor
    admitted_k: torch.Tensor
    admitted_cycle: torch.Tensor
    evicted: torch.Tensor
    evicted_cycle: torch.Tensor
    evicted_by: torch.Tensor
    stuck: torch.Tensor
    cycles: torch.Tensor
    local_usage: torch.Tensor
    overflowed: torch.Tensor


@dataclass
class PreemptState(DrainState):
    """The preempt drain's loop state: DrainState (whose ``cursor`` is
    each queue's head, its first pending entry, kept by the motion
    kernel), the entries' status, the live candidate pools (part-B slots
    fill as entries are admitted), the eviction record and the overflow
    flag."""

    status: torch.Tensor = None  # int32[Q,L] 0 pending, 1 parked, 2 admitted
    pcells: torch.Tensor = None  # int32[S,V,Cv]
    pqty: torch.Tensor = None  # int64[S,V,Cv]
    pvalid: torch.Tensor = None  # bool[S,V]
    vevicted: torch.Tensor = None  # bool[S,V]
    evict_cycle: torch.Tensor = None  # int32[S,V]
    evict_by: torch.Tensor = None  # int32[S,V]
    ovf: torch.Tensor = None  # bool[1]

    @classmethod
    def initial_preempt(cls, local_usage, queues: DrainQueues, max_cycles: int,
                        victims: SegVictims):
        base = DrainState.initial(local_usage, queues, max_cycles)
        q, l = queues.priority.shape
        dev = local_usage.device
        return cls(
            **{f.name: getattr(base, f.name) for f in fields(base)},
            status=torch.zeros((q, l), dtype=I32, device=dev),
            pcells=victims.scells.clone(),
            pqty=victims.sqty.clone(),
            pvalid=victims.svalid0.clone(),
            vevicted=torch.zeros_like(victims.svalid0),
            evict_cycle=torch.full(victims.svalid0.shape, -1, dtype=I32, device=dev),
            evict_by=torch.full(victims.svalid0.shape, -1, dtype=I32, device=dev),
            ovf=torch.zeros(1, dtype=BOOL, device=dev),
        )


@dataclass
class PreemptBuffers(CycleBuffers):
    """CycleBuffers plus the preempt cycle's intermediates."""

    need_pre: torch.Tensor = None  # bool[Q,P*C] merged cells needing preemption
    elig_same: torch.Tensor = None  # bool[Q,V] eligible same-CQ victims
    veto: torch.Tensor = None  # bool[Q,FR] cells with an eligible same-CQ victim
    targets: torch.Tensor = None  # bool[Q,V] the search's victims, slot space
    psuccess: torch.Tensor = None  # bool[Q] the search found a trusted set
    untrusted: torch.Tensor = None  # bool[Q] inconclusive truncated search
    preempt_ok: torch.Tensor = None  # bool[Q] preempted this cycle
    leaf: torch.Tensor = None  # int64[N,FR] phase 2's in-cycle leaf usage
    ev_now: torch.Tensor = None  # bool[S,V] evicted this cycle
    ev_by: torch.Tensor = None  # int32[S,V] by which queue (-1)

    @classmethod
    def empty_preempt(cls, local_usage, queues: DrainQueues, victims: SegVictims):
        base = CycleBuffers.empty(local_usage, queues)
        q, _, pmax, _, c = queues.cells.shape
        s_dim, v, _ = victims.scells.shape
        dev = local_usage.device
        return cls(
            **{f.name: getattr(base, f.name) for f in fields(base)},
            need_pre=torch.zeros((q, pmax * c), dtype=BOOL, device=dev),
            elig_same=torch.zeros((q, v), dtype=BOOL, device=dev),
            veto=torch.zeros((q, local_usage.shape[1]), dtype=BOOL, device=dev),
            targets=torch.zeros((q, v), dtype=BOOL, device=dev),
            psuccess=torch.zeros(q, dtype=BOOL, device=dev),
            untrusted=torch.zeros(q, dtype=BOOL, device=dev),
            preempt_ok=torch.zeros(q, dtype=BOOL, device=dev),
            # rows of no segment never change in the drain: phase 2
            # refreshes only its segments' rows from the leaf usage
            leaf=local_usage.clone(),
            ev_now=torch.zeros((s_dim, v), dtype=BOOL, device=dev),
            ev_by=torch.full((s_dim, v), -1, dtype=I32, device=dev),
        )


def _elig_same_and_veto(ctx: DrainContext, state: PreemptState, active, cur):
    """Same-CQ victim eligibility (preemption.go:480-524's priority rule)
    of every queue head over its segment's live pool, and the dense
    veto of the reclaim oracle: the cells those victims use. Zero for
    inactive queues. Returns (bool[Q,V], bool[Q,FR])."""
    vic = ctx.preempt.victims
    queues = ctx.queues
    q = queues.qlen.shape[0]
    n_fr = state.local.shape[1]
    q_idx = torch.arange(q, device=state.local.device)
    prio = queues.priority[q_idx, cur]
    ts = queues.timestamp[q_idx, cur]
    sq = queues.seg_id.clamp_min(0).long()
    live_q = (state.pvalid & ~state.vevicted)[sq]
    sprio_q = vic.sprio[sq]
    same_q = (vic.sowner[sq] >= 0) & (vic.sowner_local[sq] == vic.hlocal[:, None])
    lower = sprio_q < prio[:, None]
    newer_eq = vic.same_prio_ok[:, None] & (sprio_q == prio[:, None]) & (ts[:, None] < vic.sts[sq])
    elig = live_q & same_q & vic.same_enabled[:, None] & (lower | newer_eq) & active[:, None]
    vcells = state.pcells[sq]  # [Q,V,Cv]
    at = torch.where((vcells >= 0) & elig[:, :, None], vcells, n_fr).reshape(q, -1).long()
    veto = torch.zeros((q, n_fr + 1), dtype=BOOL, device=elig.device)
    veto.scatter_(1, at, True)
    return elig, veto[:, :n_fr]


def _compact_candidates(cand_ord, width: int):
    """The True positions of ``cand_ord`` (bool[Q,V], in candidate
    order) packed into the first ``width`` slots (the JAX
    ``_compact_candidates``). Returns (comp int[Q,width] of ord indices,
    -1 pads; overflow bool[Q]). minimalPreemptions stops at the first
    fitting prefix, so truncation is exact whenever the search succeeds
    in the window or fails without overflow."""
    qn, v = cand_ord.shape
    rank = torch.cumsum(cand_ord.to(I64), dim=1) - 1
    dest = torch.where(cand_ord & (rank < width), rank, width)
    src = torch.arange(v, device=cand_ord.device).expand(qn, v)
    comp = torch.full((qn, width + 1), -1, dtype=I64, device=cand_ord.device)
    comp.scatter_(1, dest, src)
    overflow = (cand_ord & (rank >= width)).any(dim=1)
    return comp[:, :width], overflow


def _pool_eligibility(ctx: DrainContext, state: PreemptState, buf: PreemptBuffers, prio,
                      cells_c) -> SimpleNamespace:
    """Candidate eligibility of every queue head over its segment's live
    pool (preemption.go:480-524, shared by the classic and the fair
    searches): a candidate uses a cell needing preemption; a same-CQ one
    passes the nomination's priority rule (``buf.elig_same``); an
    other-CQ one needs reclaimWithinCohort, its priority rule, and its
    ClusterQueue borrowing at cycle start in such a cell. Also returns
    the segment-local panels at the head cells it reads."""
    tree, queues, vic = ctx.tree, ctx.queues, ctx.preempt.victims
    need_pre = buf.need_pre
    sq = queues.seg_id.clamp_min(0).long()
    live_q = (state.pvalid & ~state.vevicted)[sq]  # [Q,V]
    sprio_q = vic.sprio[sq]
    olocal_q = vic.sowner_local[sq].clamp_min(0).long()
    slot_ok = vic.sowner[sq] >= 0
    same_q = slot_ok & (vic.sowner_local[sq] == vic.hlocal[:, None])
    lower = sprio_q < prio[:, None]

    # segment-local panels at this cycle's head cells
    rows = vic.seg_nodes.clamp_min(0).long()[sq][:, :, None]  # [Q,M,1]
    cc = cells_c[:, None, :]
    u0_sub = buf.usage[rows, cc]
    lf0_sub = state.local[rows, cc]
    nom_sub = tree.nominal[rows, cc]
    # victim usage at the head cells
    pcells_q = state.pcells[sq]  # [Q,V,Cv]
    match = (pcells_q[:, :, :, None] == cells_c[:, None, None, :]) & (pcells_q >= 0)[..., None]
    vq_at = torch.where(match, state.pqty[sq][..., None], 0).sum(dim=2)  # [Q,V,C']

    uses = ((vq_at * need_pre[:, None, :].to(I64)) > 0).any(dim=2)
    borrow_by_local = ((lf0_sub > nom_sub) & need_pre[:, None, :]).any(dim=2)  # [Q,M]
    owner_borrow0 = torch.gather(borrow_by_local, 1, olocal_q)
    oth_prio_ok = ~vic.only_lower[:, None] | lower
    elig_other = (live_q & ~same_q & slot_ok & vic.reclaim_enabled[:, None]
                  & oth_prio_ok & owner_borrow0)
    elig = uses & (buf.elig_same | elig_other)
    return SimpleNamespace(
        live_q=live_q, sprio_q=sprio_q, olocal_q=olocal_q, same_q=same_q, rows=rows, cc=cc,
        u0_sub=u0_sub, lf0_sub=lf0_sub, nom_sub=nom_sub, vq_at=vq_at, elig=elig,
    )


def drain_preempt_search_plain(ctx: DrainContext, state: PreemptState,
                               buf: PreemptBuffers) -> None:
    """Every preempt-mode head's victim search over its segment's pool
    (the JAX ``solve_drain_preempt`` cycle, :1866-1987): candidate
    eligibility, the strategy ladder (preemption.go:144-191) with its
    cases and two attempts, the compaction in candidate order to
    ``search_width``, both minimalPreemptions attempts on the segment's
    local panels (``solve_preempt``, the search B8 runs), and the
    trust of a truncated search. Writes the targets in slot space,
    psuccess and untrusted; sets the state's overflow flag."""
    if _done(state):
        return
    tree, queues, pre = ctx.tree, ctx.queues, ctx.preempt
    vic, width = pre.victims, pre.search_width
    q, l = queues.priority.shape
    v = vic.perm.shape[1]
    dev = state.local.device
    q_idx = torch.arange(q, device=dev)
    active = (state.cursor < queues.qlen) & state.alive
    cur = state.cursor.clamp_max(l - 1).long()
    prio = queues.priority[q_idx, cur]
    sq = queues.seg_id.clamp_min(0).long()
    cells_eff, qty_eff, need_pre = buf.cells_eff, buf.qty_eff, buf.need_pre
    cell_need = (cells_eff >= 0) & (qty_eff > 0)
    cells_c = cells_eff.clamp_min(0).long()

    pool = _pool_eligibility(ctx, state, buf, prio, cells_c)
    live_q, sprio_q, olocal_q = pool.live_q, pool.sprio_q, pool.olocal_q
    same_q, rows, cc = pool.same_q, pool.rows, pool.cc
    u0_sub, lf0_sub, nom_sub = pool.u0_sub, pool.lf0_sub, pool.nom_sub
    vq_at, elig = pool.vq_at, pool.elig

    # the strategy ladder (preemption.go:144-191)
    hl = vic.hlocal.clamp_min(0).long()
    under_nominal = torch.where(need_pre, lf0_sub[q_idx, hl] < nom_sub[q_idx, hl], True).all(dim=1)
    other_exists = (elig & ~same_q).any(dim=1)
    thr = torch.minimum(prio, vic.bwc_thr1)
    case_a = ~other_exists
    case_b = other_exists & vic.bwc
    case_c = other_exists & ~vic.bwc & under_nominal
    cand1 = torch.where(
        case_b[:, None],
        elig & (same_q | (sprio_q < thr[:, None]) | under_nominal[:, None]),
        torch.where((case_a | case_c)[:, None], elig, elig & same_q),
    )
    cand2 = elig & same_q  # a failed reclaim-without-borrowing attempt falls back here
    run2 = case_c
    enabled1 = active & buf.is_pre & (vic.same_enabled | vic.reclaim_enabled)

    perm = vic.perm.long()
    panels = dict(
        paths=vic.lpaths[sq], usage0=u0_sub, leaf0=lf0_sub, nominal=nom_sub,
        subtree_q=ctx.subtree[rows, cc], guaranteed=ctx.guaranteed[rows, cc],
        borrow_lim=tree.borrowing_limit[rows, cc], hrow=vic.hlocal,
        need_qty=torch.where(cell_need, qty_eff, 0), need_pre=need_pre,
    )

    def attempt(cand, enabled, allow_borrow, thr_on):
        comp, over = _compact_candidates(torch.gather(cand, 1, perm), width)
        slot = torch.gather(perm, 1, comp.clamp_min(0))  # [Q,width]
        problem = PreemptProblem(
            **panels, allow_borrow=allow_borrow, has_thr=thr_on, thr=thr,
            crow=torch.gather(olocal_q, 1, slot),
            cqty=vq_at[q_idx[:, None], slot], cvalid=comp >= 0,
            csame=torch.gather(same_q, 1, slot), cprio=torch.gather(sprio_q, 1, slot),
            row_valid=enabled,
        )
        r = solve_preempt(problem, tree.max_depth, width)
        # step space -> slot space
        hit = (comp >= 0) & r.targets & r.fits[:, None]
        out = torch.zeros((q, v + 1), dtype=I32, device=dev)
        out.scatter_add_(1, torch.where(hit, slot, v), hit.to(I32))
        return out[:, :v] > 0, r.fits, over

    t1, found1, over1 = attempt(cand1, enabled1, ~case_c, case_b)
    t2, found2, over2 = attempt(
        cand2, enabled1 & run2, torch.ones_like(run2), torch.zeros_like(run2)
    )
    # an attempt-1 overflow-and-miss is inconclusive whatever attempt 2
    # finds: the untruncated ladder might have succeeded at attempt 1
    untrusted = enabled1 & ((over1 & ~found1) | (~found1 & run2 & over2 & ~found2))
    buf.targets.copy_(torch.where(found1[:, None], t1, t2))
    buf.psuccess.copy_(buf.is_pre & ~untrusted & (found1 | found2))
    buf.untrusted.copy_(untrusted)
    buf.preempt_ok.zero_()
    state.ovf.copy_(state.ovf | untrusted.any())


def drain_preempt_phase2_plain(ctx: DrainContext, state: PreemptState,
                               buf: PreemptBuffers) -> None:
    """The preempt cycle's step scan (the JAX ``solve_drain_preempt``,
    :1988-2166): entries in (borrowing, -priority, timestamp) order per
    root segment; a head whose targets overlap an earlier eviction of
    the cycle is skipped; a preempting head removes its victims at
    their owner rows, re-checks its fit, and reverts the removals when
    it no longer fits; admitted and preempting heads charge their usage,
    blocked no-reclaim heads reserve. The usage tree is rebuilt from the
    leaf rows after any removal or revert, as the JAX code does. Writes
    the in-cycle leaf usage, this cycle's evictions and the admitted
    and preempt_ok flags; ``state.local`` is left to the motion."""
    if _done(state):
        return
    tree, queues, vic = ctx.tree, ctx.queues, ctx.preempt.victims
    subtree, guaranteed = ctx.subtree, ctx.guaranteed
    n_segments, n_steps, max_depth = ctx.n_segments, ctx.n_steps, tree.max_depth
    q, l = queues.priority.shape
    dev = buf.usage.device
    q_idx = torch.arange(q, device=dev)
    active = (state.cursor < queues.qlen) & state.alive
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

    cq = queues.cq_rows.clamp_min(0).long()
    sq_all = queues.seg_id.clamp_min(0).long()
    cell_need = (cells_eff >= 0) & (qty_eff > 0)
    leaf = state.local.clone()
    usage = buf.usage  # == usage_tree(leaf) throughout
    s_dim, v = buf.ev_now.shape
    ev_now = torch.zeros((s_dim, v), dtype=BOOL, device=dev)
    ev_by = torch.full((s_dim, v), -1, dtype=I32, device=dev)
    admitted = torch.zeros(q, dtype=BOOL, device=dev)
    preempt_ok = torch.zeros(q, dtype=BOOL, device=dev)
    for s in range(n_steps):
        idx = mat[s]
        if not bool((idx >= 0).any()):
            continue
        h = idx[idx >= 0].long()  # one head per live segment
        cqs = cq[h]
        path = ctx.paths[cqs]
        cells_, qty_ = cells_eff[h], qty_eff[h]
        ccells = cells_.clamp_min(0).long()
        cell_valid = cell_need[h]
        sq_h = sq_all[h]
        htarg = buf.targets[h]  # [G,V]
        # overlapping-preemption-targets guard: an earlier head this
        # cycle already evicted one of our victims -> skip
        overlap = (htarg & ev_now[sq_h]).any(dim=1)
        do_pre = buf.psuccess[h] & ~overlap
        # remove the victims at their OWNER leaf rows
        pc_h = state.pcells[sq_h]  # [G,V,Cv]
        rm_mask = htarg & do_pre[:, None]
        rm_qty = torch.where(rm_mask[:, :, None] & (pc_h >= 0), state.pqty[sq_h], 0)
        rows_b = vic.sowner[sq_h].clamp_min(0).long()[:, :, None].expand_as(pc_h).reshape(-1)
        cols_b = pc_h.clamp_min(0).long().reshape(-1)
        leaf.index_put_((rows_b, cols_b), -rm_qty.reshape(-1), accumulate=True)
        if bool(rm_mask.any()):
            usage.copy_(usage_tree_plain(tree, guaranteed, leaf))
        avail = _avail_along_path(
            path, cells_, usage, subtree, guaranteed, tree.borrowing_limit, max_depth
        )
        fits = torch.where(cell_valid, avail >= qty_, True).all(dim=1)
        admit = is_fit[h] & fits
        pre_ok = do_pre & fits
        # revert failed preempters' removals
        revert = do_pre & ~fits
        leaf.index_put_(
            (rows_b, cols_b), torch.where(revert[:, None, None], rm_qty, 0).reshape(-1),
            accumulate=True,
        )
        reserve = is_pre[h] & ~buf.psuccess[h] & queues.no_reclaim[h]
        nominal_c = tree.nominal[cqs[:, None], ccells]
        bl_c = tree.borrowing_limit[cqs[:, None], ccells]
        leaf_usage_c = leaf[cqs[:, None], ccells]
        borrow_cap = torch.where(
            bl_c < NO_LIMIT, torch.minimum(qty_, nominal_c + bl_c - leaf_usage_c), qty_
        )
        nominal_cap = torch.minimum(qty_, nominal_c - leaf_usage_c).clamp_min(0)
        reserve_qty = torch.where(head_borrow[h][:, None], borrow_cap, nominal_cap)
        # charge admitted heads and successful preempters (AddUsage runs
        # for both, scheduler.go:211-292); reserve for blocked ones
        delta = torch.where(
            cell_valid & (admit | pre_ok)[:, None],
            qty_,
            torch.where(cell_valid & reserve[:, None], reserve_qty, 0),
        )
        leaf.index_put_((cqs[:, None].expand_as(ccells), ccells), delta, accumulate=True)
        if bool(revert.any()):
            usage.copy_(usage_tree_plain(tree, guaranteed, leaf))
        else:
            _charge_paths(usage, guaranteed, path, ccells, delta, max_depth)
        evicts = htarg & pre_ok[:, None]
        ev_now[sq_h] = ev_now[sq_h] | evicts
        ev_by[sq_h] = torch.maximum(ev_by[sq_h], torch.where(evicts, h[:, None].to(I32), -1))
        admitted[h] = admit
        preempt_ok[h] = pre_ok
    buf.leaf.copy_(leaf)
    buf.ev_now.copy_(ev_now)
    buf.ev_by.copy_(ev_by)
    buf.admitted.copy_(admitted)
    buf.preempt_ok.copy_(preempt_ok)


def drain_preempt_motion_plain(ctx: DrainContext, state: PreemptState,
                               buf: PreemptBuffers) -> None:
    """The preempt cycle's end (the JAX ``solve_drain_preempt``,
    :2168-2287; ``solve_drain_fair_preempt``, :2716-2842, which also
    fills the slot's fair-panel row ``pq_cu``): admitted heads charge
    their leaf usage, each evicted victim releases its full usage at its
    owner row, admitted entries fill their part-B pool slot; then the queue motion with the preempt
    rules (heads skipped after a successful search stay pending,
    untrusted searches freeze their queue, the stagnation guard, an
    eviction in a root cohort reactivates its parked entries), the next
    heads, the cycle counter and the ``done`` flag."""
    if _done(state):
        return
    queues, vic = ctx.queues, ctx.preempt.victims
    q, l = queues.priority.shape
    dev = state.cursor.device
    q_idx = torch.arange(q, device=dev)
    active = (state.cursor < queues.qlen) & state.alive
    cur = state.cursor.clamp_max(l - 1).long()
    is_fit, pend, admitted = buf.is_fit, buf.pend, buf.admitted
    preempt_ok, psuccess = buf.preempt_ok, buf.psuccess
    cells_eff, qty_eff = buf.cells_eff, buf.qty_eff
    cell_need = (cells_eff >= 0) & (qty_eff > 0)
    cq = queues.cq_rows.clamp_min(0).long()
    sq = queues.seg_id.clamp_min(0).long()
    cycle = state.cycle

    # leaf usage: admissions, then evictions at the owner rows
    state.local.index_put_(
        (cq[:, None].expand_as(cells_eff), cells_eff.clamp_min(0).long()),
        torch.where(cell_need & admitted[:, None], qty_eff, 0),
        accumulate=True,
    )
    newly = buf.ev_now
    pcells = state.pcells
    ev_qty = torch.where(newly[:, :, None] & (pcells >= 0), state.pqty, 0)
    owner = vic.sowner.clamp_min(0).long()[:, :, None].expand_as(pcells)
    state.local.index_put_(
        (owner.reshape(-1), pcells.clamp_min(0).long().reshape(-1)), -ev_qty.reshape(-1),
        accumulate=True,
    )
    state.vevicted.copy_(state.vevicted | newly)
    state.evict_cycle.copy_(torch.where(newly, cycle, state.evict_cycle))
    state.evict_by.copy_(torch.where(newly, buf.ev_by, state.evict_by))
    # admitted entries fill their part-B slot: live candidates from now on
    slot_w = vic.entry_slot[q_idx, cur]
    fill = admitted & active & (slot_w >= 0)
    if bool(fill.any()):
        fq = torch.nonzero(fill).flatten()
        pad = pcells.shape[2] - cells_eff.shape[1]
        fs, fl = sq[fq], slot_w[fq].long()
        pcells[fs, fl] = torch.cat(
            [cells_eff[fq], torch.full((fq.numel(), pad), -1, dtype=I32, device=dev)], dim=1
        )
        state.pqty[fs, fl] = torch.cat(
            [qty_eff[fq], torch.zeros((fq.numel(), pad), dtype=I64, device=dev)], dim=1
        )
        state.pvalid[fs, fl] = True
        if ctx.fair_preempt is not None:
            # the fair panels' view of the slot: its usage at panel cells
            state.pq_cu[fs, fl] = _need_at_panel(ctx, buf)[fq]

    # queue motion. Park only NOT_NOMINATED outcomes (NoFit, or a search
    # that found no victims); heads skipped after a successful search
    # (the fits re-check or the overlap guard) requeue and stay pending
    retries = state.retries
    pre_skipped = psuccess & ~preempt_ok
    undecided = active & ~is_fit & ~preempt_ok & ~pre_skipped
    stuck = state.stuck | buf.untrusted
    stuck = stuck | (undecided & pend & (retries >= state.cap))
    retrying = undecided & pend & ~stuck
    new_status = torch.where(admitted, 2, torch.where(undecided & ~pend, 1, 0)).to(I32)
    head_advanced = active & (new_status != 0)
    stuck = stuck & ~head_advanced
    retries = torch.where(
        head_advanced | ~active, 0, torch.where(retrying, retries + 1, retries)
    ).to(I32)
    any_prog = head_advanced.any() | newly.any()
    no_prog = torch.where(any_prog, 0, state.no_prog + 1).to(I32)
    stuck = stuck | ((no_prog >= 2 * state.cap.max()) & active & ~head_advanced)
    wrote = admitted & active
    state.adm_k[q_idx, cur] = torch.where(wrote[:, None], buf.rep_k, state.adm_k[q_idx, cur])
    state.adm_cycle[q_idx, cur] = torch.where(wrote, cycle, state.adm_cycle[q_idx, cur])
    status = state.status
    status[q_idx, cur] = torch.where(active, new_status, status[q_idx, cur])
    # an eviction in a root cohort reactivates its parked entries
    released = newly.any(dim=1)[sq] & (queues.seg_id >= 0)
    status.copy_(torch.where(released[:, None] & (status == 1), 0, status))
    lost = active & is_fit & ~admitted
    walk_reset = admitted | (active & ~is_fit & ~retrying) | preempt_ok
    g_start = torch.where(
        walk_reset[:, None, None],
        0,
        torch.where((lost | retrying)[:, None, None], buf.walk_next, state.g_start),
    ).to(I32)
    pos = torch.arange(l, device=dev, dtype=I32)
    cursor = torch.where(status == 0, pos, l).amin(dim=1).to(I32)  # the next heads
    cycle = state.cycle + 1
    state.retries.copy_(retries)
    state.stuck.copy_(stuck)
    state.no_prog.copy_(no_prog)
    state.g_start.copy_(g_start)
    state.cursor.copy_(cursor)
    state.cycle.copy_(cycle)
    go = ((cursor < queues.qlen) & ~stuck).any() & (cycle < ctx.max_cycles)
    state.done.copy_((~go).to(I32).reshape(1))


def drain_preempt_search(ctx: DrainContext, state: PreemptState, buf: PreemptBuffers) -> None:
    """Kernel 6: every preempt-mode head's strategy ladder (one warp per
    queue, one lane per cell)."""
    if not state.local.is_cuda:
        return drain_preempt_search_plain(ctx, state, buf)
    _launch("drain_preempt_search", ctx, state, buf)


def drain_preempt_phase2(ctx: DrainContext, state: PreemptState, buf: PreemptBuffers) -> None:
    """Kernel 7: the preempt cycle's step scan (one block per root
    segment)."""
    if not state.local.is_cuda:
        return drain_preempt_phase2_plain(ctx, state, buf)
    _launch("drain_preempt_phase2", ctx, state, buf)


def drain_preempt_motion(ctx: DrainContext, state: PreemptState, buf: PreemptBuffers) -> None:
    """Kernel 8: cycle-end usage, pool fill, queue motion and the done
    flag (blocks over the slots, a warp a queue; the last block to
    finish takes the whole drain's reductions)."""
    if not state.local.is_cuda:
        return drain_preempt_motion_plain(ctx, state, buf)
    _launch("drain_preempt_motion", ctx, state, buf)


def drain_preempt_cycle(ctx: DrainContext, state: PreemptState, buf: PreemptBuffers) -> None:
    """ONE preempt drain cycle: five launches on the card (quota_tree
    once, drain_nominate with the reclaim oracle, the search, phase 2,
    the motion), or their plain versions on the CPU."""
    usage_and_available(ctx.tree, ctx.subtree, ctx.guaranteed, state.local, buf.usage,
                        buf.avail, done=state.done)
    drain_nominate(ctx, state, buf)
    drain_preempt_search(ctx, state, buf)
    drain_preempt_phase2(ctx, state, buf)
    drain_preempt_motion(ctx, state, buf)


def solve_drain_preempt(
    tree: QuotaTree,
    local_usage: torch.Tensor,  # int64[N, FR]
    queues: DrainQueues,
    victims: SegVictims,
    paths: torch.Tensor,  # int32[N, D+1]
    n_segments: int,
    n_steps: int,
    max_cycles: int,
    search_width: int = 32,
    seg_id=None,  # host copy of queues.seg_id
) -> PreemptDrainResult:
    """Multi-cycle drain with classic preemption (the JAX
    ``solve_drain_preempt``): within-ClusterQueue preemption and
    cross-CQ cohort reclamation, each cycle's searches against the
    cycle-start usage, the entry-order scan with evictions and fits
    re-checks, and the cycle-end pool refill and queue motion. Each
    entry is pending (0), parked (1) or admitted (2); each queue's head
    is its first pending entry. A head whose eligible candidates
    overflow ``search_width`` and whose search misses freezes its queue
    and sets ``overflowed``."""
    ctx = DrainContext.build(
        tree, queues, paths, n_segments, n_steps, max_cycles, seg_id=seg_id,
        preempt=PreemptInputs(victims=victims, search_width=int(search_width)),
    )
    state = PreemptState.initial_preempt(local_usage, queues, max_cycles, victims)
    buf = PreemptBuffers.empty_preempt(local_usage, queues, victims)
    run_cycles(ctx, state, buf, drain_preempt_cycle, max_cycles)
    return PreemptDrainResult(
        status=state.status,
        admitted_k=state.adm_k,
        admitted_cycle=state.adm_cycle,
        evicted=state.vevicted,
        evicted_cycle=state.evict_cycle,
        evicted_by=state.evict_by,
        stuck=state.stuck,
        cycles=state.cycle,
        local_usage=state.local,
        overflowed=state.ovf,
    )


def _pack_drain_preempt(r: PreemptDrainResult) -> torch.Tensor:
    """The JAX ``_solve_drain_preempt_packed`` layout (int32): status,
    admitted_k, admitted_cycle, evicted, evicted_cycle, evicted_by,
    stuck, overflowed, cycles."""
    return torch.cat([
        r.status.reshape(-1),
        r.admitted_k.reshape(-1),
        r.admitted_cycle.reshape(-1),
        r.evicted.to(I32).reshape(-1),
        r.evicted_cycle.reshape(-1),
        r.evicted_by.reshape(-1),
        r.stuck.to(I32),
        r.overflowed.to(I32).reshape(1),
        r.cycles.reshape(1),
    ])


def _solve_drain_preempt_packed(
    tree, local_usage, queues, victims, paths, n_segments: int, n_steps: int,
    max_cycles: int, search_width: int, seg_id=None,
) -> torch.Tensor:
    return _pack_drain_preempt(solve_drain_preempt(
        tree, local_usage, queues, victims, paths, n_segments, n_steps, max_cycles,
        search_width, seg_id=seg_id,
    ))


# ---- the fair-preempt drain (kernels drain_fair_preempt_*) ----------------


@dataclass
class FairPreemptState(PreemptState):
    """PreemptState plus the pool's usage at the fair panels' cells."""

    pq_cu: torch.Tensor = None  # int64[S,V,Cu]

    @classmethod
    def initial_fair(cls, local_usage, queues: DrainQueues, max_cycles: int,
                     victims: SegVictims, panels: FairSegPanels):
        base = PreemptState.initial_preempt(local_usage, queues, max_cycles, victims)
        return cls(**{f.name: getattr(base, f.name) for f in fields(base)},
                   pq_cu=panels.svqty_cu.clone())


def _need_at_panel(ctx: DrainContext, buf: CycleBuffers) -> torch.Tensor:
    """Each head's request at its segment's panel cells: int64[Q,Cu]."""
    panels = ctx.fair_preempt.panels
    sq = ctx.queues.seg_id.clamp_min(0).long()
    seg_cells = panels.seg_cells[sq]  # [Q,Cu]
    cell_need = (buf.cells_eff >= 0) & (buf.qty_eff > 0)
    match = (
        (buf.cells_eff[:, :, None] == seg_cells[:, None, :])
        & cell_need[:, :, None]
        & (seg_cells >= 0)[:, None, :]
    )  # [Q,C',Cu]
    return torch.where(match, buf.qty_eff[:, :, None], 0).sum(dim=1)


def drain_fair_preempt_search_plain(ctx: DrainContext, state: FairPreemptState,
                                    buf: PreemptBuffers) -> None:
    """Every preempt-mode head's fair victim tournament over its
    segment's pool (the JAX ``solve_drain_fair_preempt`` cycle,
    :2471-2602): the classic candidate eligibility, the live usage panel
    over the segment's active cell universe with the head's request
    bubbled in (preemption.go:394-395), the candidates in the queue's
    order (``perm``), ``solve_fair`` (the search B9 runs), and the
    targets scattered back to slot space. Writes targets and psuccess;
    no search is truncated, so untrusted stays 0."""
    if _done(state):
        return
    tree, queues, vic = ctx.tree, ctx.queues, ctx.preempt.victims
    fp, n_res = ctx.fair_preempt, ctx.fair.n_res
    panels = fp.panels
    q, l = queues.priority.shape
    v = vic.perm.shape[1]
    m = vic.seg_nodes.shape[1]
    dev = state.local.device
    q_idx = torch.arange(q, device=dev)
    active = (state.cursor < queues.qlen) & state.alive
    cur = state.cursor.clamp_max(l - 1).long()
    prio = queues.priority[q_idx, cur]
    sq = queues.seg_id.clamp_min(0).long()
    cells_c = buf.cells_eff.clamp_min(0).long()
    pool = _pool_eligibility(ctx, state, buf, prio, cells_c)
    enabled = active & buf.is_pre & (vic.same_enabled | vic.reclaim_enabled)

    seg_cells = panels.seg_cells[sq]  # [Q,Cu]
    scc = seg_cells.clamp_min(0).long()[:, None, :]
    lpaths = vic.lpaths[sq]  # [Q,M,D+1]
    nvalid = panels.node_valid[sq]
    hpath = lpaths[q_idx, vic.hlocal.clamp_min(0).long()]  # [Q,D+1]
    anc = (
        (hpath[:, 1:, None] == torch.arange(m, device=dev)[None, None, :])
        & (hpath[:, 1:, None] >= 0)
    ).any(dim=1)  # [Q,M] strict ancestors of the head
    need_cu = _need_at_panel(ctx, buf)
    # live panels (pad cells and rows zeroed so the DRS buckets stay inert)
    pmask = (seg_cells >= 0)[:, None, :] & nvalid[:, :, None]
    rows = pool.rows
    pu0 = torch.where(pmask, buf.usage[rows, scc], 0)
    psub = torch.where(pmask, ctx.subtree[rows, scc], 0)
    pg = torch.where(pmask, ctx.guaranteed[rows, scc], 0)
    pbl = torch.where(pmask, tree.borrowing_limit[rows, scc], NO_LIMIT)
    # the head's usage is part of the simulated state
    _bubble_local(hpath, need_cu, pu0, pg, tree.max_depth, torch.ones_like(enabled))
    perm = vic.perm.long()
    problem = FairProblem(
        paths=lpaths, usage0=pu0, subtree_q=psub, guaranteed=pg, borrow_lim=pbl,
        weight=panels.weight_local[sq], parent_loc=panels.parent_local[sq],
        depth_s=panels.depth_local[sq], is_cq=panels.is_cq_local[sq], svalid=nvalid,
        anc_of_head=anc, hrow=vic.hlocal, need_qty=need_cu, res_of=panels.res_of_cell[sq],
        crow=torch.gather(pool.olocal_q, 1, perm).to(I32),
        cqty=state.pq_cu[sq][q_idx[:, None], perm],
        cvalid=torch.gather(pool.live_q & pool.elig, 1, perm) & enabled[:, None],
        row_valid=enabled,
    )
    r = solve_fair(problem, tree.max_depth, v, m, n_res + 1, fp.strategy1, fp.has_second)
    psuccess = enabled & r.fits
    # candidate order -> slot space
    hit = r.targets & psuccess[:, None]
    targets = torch.zeros((q, v), dtype=I32, device=dev)
    targets.scatter_add_(1, perm, hit.to(I32))
    buf.targets.copy_(targets > 0)
    buf.psuccess.copy_(psuccess)
    buf.untrusted.zero_()
    buf.preempt_ok.zero_()


def drain_fair_preempt_phase2_plain(ctx: DrainContext, state: FairPreemptState,
                                    buf: PreemptBuffers) -> None:
    """The fair-preempt cycle's admissions (the JAX
    ``solve_drain_fair_preempt`` step scan, :2604-2742): each of
    ``n_steps`` steps pops one head per root cohort through the DRS
    tournament against the live usage; a popped preempter whose targets
    overlap an earlier eviction of the cycle is skipped; a popped head
    is re-checked for fit with EVERY accepted victim of the cycle
    removed (the host's non-incremental fits-after-removals: the
    tournament keeps reading usage with the victims present, so the
    removals live only inside the fit check); admitted heads and
    successful preempters charge their usage, blocked no-reclaim heads
    reserve. Writes the in-cycle leaf usage, this cycle's evictions and
    the admitted and preempt_ok flags; ``state.local`` is left to the
    motion."""
    if _done(state):
        return
    tree, queues, vic, fair = ctx.tree, ctx.queues, ctx.preempt.victims, ctx.fair
    subtree, guaranteed = ctx.subtree, ctx.guaranteed
    max_depth, n_res = tree.max_depth, fair.n_res
    q, l = queues.priority.shape
    n_nodes, fr = tree.nominal.shape
    dev = buf.usage.device
    q_idx = torch.arange(q, device=dev)
    active = (state.cursor < queues.qlen) & state.alive
    cur = state.cursor.clamp_max(l - 1).long()
    is_fit, is_pre, head_borrow = buf.is_fit, buf.is_pre, buf.head_borrow
    psuccess, targets = buf.psuccess, buf.targets
    cells_eff, qty_eff = buf.cells_eff, buf.qty_eff
    prio = queues.priority[q_idx, cur]
    ts = queues.timestamp[q_idx, cur]
    cq = queues.cq_rows.clamp_min(0).long()
    sq = queues.seg_id.clamp_min(0).long()
    paths_q = ctx.paths[cq]
    cells_c = cells_eff.clamp_min(0).long()
    cell_need = (cells_eff >= 0) & (qty_eff > 0)
    res_of_q = torch.where(cell_need, fair.res_of_fr[cells_c], n_res)
    node_rows = torch.arange(n_nodes, device=dev)[:, None].expand(n_nodes, fr)
    node_res = fair.res_of_fr.long()[None, :].expand(n_nodes, fr)
    nominal_c = tree.nominal[cq[:, None], cells_c]
    bl_c = tree.borrowing_limit[cq[:, None], cells_c]
    pcells, pqty = state.pcells, state.pqty
    owner = vic.sowner.clamp_min(0).long()[:, :, None].expand_as(pcells).reshape(-1)
    pc_cols = pcells.clamp_min(0).long().reshape(-1)
    s_dim, v = buf.ev_now.shape

    usage = buf.usage  # == usage_tree(leaf) throughout
    leaf = state.local.clone()
    remaining = active & (is_fit | is_pre) & (queues.cq_rows >= 0)
    ev_now = torch.zeros((s_dim, v), dtype=BOOL, device=dev)
    ev_by = torch.full((s_dim, v), -1, dtype=I32, device=dev)
    admitted = torch.zeros(q, dtype=BOOL, device=dev)
    preempt_ok = torch.zeros(q, dtype=BOOL, device=dev)
    for _ in range(ctx.n_steps):
        if not bool(remaining.any()):
            break  # later steps have no winner and change nothing
        bb = torch.zeros((n_nodes, n_res + 1), dtype=I64, device=dev)
        bb.index_put_((node_rows, node_res), (usage - subtree).clamp_min(0), accumulate=True)
        chain = _fair_chain(
            usage, bb[:, :n_res], paths_q, cells_eff, qty_eff, subtree, guaranteed,
            fair.lendable, fair.weight, tree.parent, res_of_q, n_res, max_depth,
        )
        win = _fair_tournament(
            chain, remaining, paths_q, queues.cq_rows, fair.depth_of, tree.parent,
            prio, ts, n_nodes, max_depth, fair.prio_tie,
        )
        own_t = targets & (win & psuccess)[:, None]  # [Q,V]
        overlap = (own_t & ev_now[sq]).any(dim=1)
        do_pre = win & is_pre & psuccess & ~overlap
        # winners are one per root cohort: their targets land in
        # distinct segments
        own_seg = torch.zeros((s_dim + 1, v), dtype=BOOL, device=dev)
        own_seg[torch.where(do_pre, sq, s_dim)] |= own_t
        # fits with EVERY accepted victim removed; a winner's path sees
        # only its own segment's removals
        rm_all = ev_now | own_seg[:s_dim]
        rm_qty = torch.where(rm_all[:, :, None] & (pcells >= 0), pqty, 0)
        leaf_fits = leaf.clone()
        leaf_fits.index_put_((owner, pc_cols), -rm_qty.reshape(-1), accumulate=True)
        usage_fits = usage_tree_plain(tree, guaranteed, leaf_fits)
        avail = _avail_along_path(
            paths_q, cells_eff, usage_fits, subtree, guaranteed, tree.borrowing_limit, max_depth
        )
        cell_valid = cell_need & win[:, None]
        fits = torch.where(cell_valid, avail >= qty_eff, True).all(dim=1)
        admit = win & is_fit & fits
        pre_ok = do_pre & fits
        reserve = win & is_pre & ~psuccess & queues.no_reclaim
        leaf_usage_c = leaf[cq[:, None], cells_c]
        borrow_cap = torch.where(
            bl_c < NO_LIMIT, torch.minimum(qty_eff, nominal_c + bl_c - leaf_usage_c), qty_eff
        )
        nominal_cap = torch.minimum(qty_eff, nominal_c - leaf_usage_c).clamp_min(0)
        reserve_qty = torch.where(head_borrow[:, None], borrow_cap, nominal_cap)
        # charge admitted heads and successful preempters (AddUsage runs
        # for both, scheduler.go:211-292) and reservations; the victims
        # stay present in the tournament's usage
        delta = torch.where(
            cell_valid & (admit | pre_ok)[:, None],
            qty_eff,
            torch.where(cell_valid & reserve[:, None], reserve_qty, 0),
        )
        leaf.index_put_((cq[:, None].expand_as(cells_c), cells_c), delta, accumulate=True)
        _charge_paths(usage, guaranteed, paths_q, cells_c, delta, max_depth)
        evicts = own_t & pre_ok[:, None]
        commit = torch.zeros((s_dim + 1, v), dtype=BOOL, device=dev)
        commit[torch.where(pre_ok, sq, s_dim)] |= evicts
        ev_now = ev_now | commit[:s_dim]
        by = torch.full((s_dim + 1, v), -1, dtype=I32, device=dev)
        by[torch.where(pre_ok, sq, s_dim)] = torch.where(evicts, q_idx[:, None].to(I32), -1)
        ev_by = torch.maximum(ev_by, by[:s_dim])
        remaining = remaining & ~win
        admitted = admitted | admit
        preempt_ok = preempt_ok | pre_ok
    buf.leaf.copy_(leaf)
    buf.ev_now.copy_(ev_now)
    buf.ev_by.copy_(ev_by)
    buf.admitted.copy_(admitted)
    buf.preempt_ok.copy_(preempt_ok)


def drain_fair_preempt_search(ctx: DrainContext, state: FairPreemptState,
                              buf: PreemptBuffers) -> None:
    """Kernel B11a: every preempt-mode head's fair victim tournament
    (one warp per queue)."""
    if not state.local.is_cuda:
        return drain_fair_preempt_search_plain(ctx, state, buf)
    _launch("drain_fair_preempt_search", ctx, state, buf)


def drain_fair_preempt_phase2(ctx: DrainContext, state: FairPreemptState,
                              buf: PreemptBuffers) -> None:
    """Kernel B11b: the fair-preempt cycle's admission tournament with
    its dispositions (one block per root segment)."""
    if not state.local.is_cuda:
        return drain_fair_preempt_phase2_plain(ctx, state, buf)
    _launch("drain_fair_preempt_phase2", ctx, state, buf)


def drain_fair_preempt_cycle(ctx: DrainContext, state: FairPreemptState,
                             buf: PreemptBuffers) -> None:
    """ONE fair-preempt drain cycle: five launches on the card
    (quota_tree once, drain_nominate with the reclaim oracle, the fair
    search, its phase 2, the preempt motion with the fair-panel fill),
    or their plain versions on the CPU."""
    usage_and_available(ctx.tree, ctx.subtree, ctx.guaranteed, state.local, buf.usage,
                        buf.avail, done=state.done)
    drain_nominate(ctx, state, buf)
    drain_fair_preempt_search(ctx, state, buf)
    drain_fair_preempt_phase2(ctx, state, buf)
    drain_preempt_motion(ctx, state, buf)


def fair_preempt_context(tree, queues, victims, panels, paths, fair: FairInputs,
                         n_segments: int, n_steps: int, max_cycles: int, strategy1: int,
                         has_second: bool, seg_id=None) -> DrainContext:
    """The DrainContext of a fair-preempt drain: the fair tournament's
    inputs, the segment pools and the fair panels."""
    return DrainContext.build(
        tree, queues, paths, n_segments, n_steps, max_cycles, seg_id=seg_id, fair=fair,
        preempt=PreemptInputs(victims=victims, search_width=0),
        fair_preempt=FairPreemptInputs(
            panels=panels, strategy1=int(strategy1), has_second=bool(has_second),
        ),
    )


def solve_drain_fair_preempt(
    tree: QuotaTree,
    local_usage: torch.Tensor,  # int64[N, FR]
    queues: DrainQueues,
    victims: SegVictims,
    panels: FairSegPanels,
    paths: torch.Tensor,  # int32[N, D+1]
    fair: FairInputs,
    n_segments: int,
    n_steps: int,
    max_cycles: int,
    strategy1: int,
    has_second: bool,
    seg_id=None,  # host copy of queues.seg_id
) -> PreemptDrainResult:
    """Multi-cycle drain with fair-sharing admission order AND
    fair-sharing preemption (the JAX ``solve_drain_fair_preempt``, the
    fair-cohort configuration of keps/1714-fair-sharing): per cycle the
    nomination with the reclaim oracle, the fair victim tournament for
    every preempt-mode head on its segment's live panels (part-A
    snapshot victims and part-B drain-admitted entries), the admission
    tournament with its dispositions, and the cycle end of the preempt
    drain (evictions, part-B fill, queue motion). No search is
    truncated, so ``overflowed`` stays False."""
    ctx = fair_preempt_context(
        tree, queues, victims, panels, paths, fair, n_segments, n_steps, max_cycles,
        strategy1, has_second, seg_id=seg_id,
    )
    state = FairPreemptState.initial_fair(local_usage, queues, max_cycles, victims, panels)
    buf = PreemptBuffers.empty_preempt(local_usage, queues, victims)
    run_cycles(ctx, state, buf, drain_fair_preempt_cycle, max_cycles)
    return PreemptDrainResult(
        status=state.status,
        admitted_k=state.adm_k,
        admitted_cycle=state.adm_cycle,
        evicted=state.vevicted,
        evicted_cycle=state.evict_cycle,
        evicted_by=state.evict_by,
        stuck=state.stuck,
        cycles=state.cycle,
        local_usage=state.local,
        overflowed=state.ovf,
    )


def _solve_drain_fair_preempt_packed(
    tree, local_usage, queues, victims, panels, paths, fair: FairInputs, n_segments: int,
    n_steps: int, max_cycles: int, strategy1: int, has_second: bool, seg_id=None,
) -> torch.Tensor:
    """solve_drain_fair_preempt in the JAX
    ``_solve_drain_fair_preempt_packed`` layout (the preempt drain's),
    so one decoder serves both preempt scopes."""
    return _pack_drain_preempt(solve_drain_fair_preempt(
        tree, local_usage, queues, victims, panels, paths, fair, n_segments, n_steps,
        max_cycles, strategy1, has_second, seg_id=seg_id,
    ))


# ---- the TAS drain (kernel B13: drain_tas_place, drain_tas_phase2) ----------

MAX_COUNT_TAS = (1 << 31) - 1
# the placement kernel's shared-memory rows hold up to this many domains
# a level (the lowering caps the merged forest at MAX_TAS_DOMAINS
# leaves, core/drain.py) and this many levels
MAX_TAS_ND = 2048
MAX_TAS_DEPTH = 16
MAX_TAS_R = 16


class TASHeads(NamedTuple):
    """Per-queue TAS lowering for solve_drain_tas over a MERGED domain
    forest: every in-scope TAS flavor's topology concatenated into one
    disjoint forest, aligned at the LEAF level (a flavor with fewer
    levels gets structural dummy top levels so seg_ids/parent chains
    stay rectangular; dummies are unreachable — ``t_top`` clamps the
    preferred-mode relax-up at each flavor's real top).

    t_is:    bool[Q]         — the queue's entries are TAS workloads.
    t_req:   int64[Q, L, Rt] — per-ENTRY per-pod request vector on the
             UNION topology resource axis (pods slot included as 1).
    t_count: int32[Q, L]     — gang size per entry.
    t_level: int32[Q, L]     — requested topology level index in GLOBAL
             (merged) level space; leaf level for unconstrained mode.
    t_mode:  int32[Q, L]     — 0 Required, 1 Preferred, 2 Unconstrained
             (tas_flavor_snapshot.go:513-568 search modes).
    t_top:   int32[Q]        — the queue's flavor's top level in global
             space (= D_global - D_flavor); relax-up stops here.
    t_flavor: int32[Q]       — the queue's flavor index.
    leaf_flavor: int32[Lf]   — owning flavor per merged-forest leaf
             (placement masks every other flavor's leaves to state 0).
    parent_map: int32[D_t, ND] — domain -> parent domain index at the
             level above (row 0 unused, zero; ordering owned by the
             merged-forest lowering), ND = max domains/level.
    t_bad:   bool[Q, L]      — entry requests a topology on a
             ClusterQueue whose flavor doesn't support TAS: the host
             rejects the flavor and PARKS the head (tas/manager.py
             check); forcing NoFit parks it at the same cycle.
    """

    t_is: torch.Tensor
    t_req: torch.Tensor
    t_count: torch.Tensor
    t_level: torch.Tensor
    t_mode: torch.Tensor
    t_top: torch.Tensor
    t_flavor: torch.Tensor
    leaf_flavor: torch.Tensor
    parent_map: torch.Tensor
    t_bad: torch.Tensor


@dataclass
class TASInputs:
    """The TAS drain's fixed inputs: the merged forest's free capacity
    and per-level segment ids, its per-level domain counts (host tuple
    and device vector) and the per-queue TAS lowering."""

    topo_free: torch.Tensor  # int64[Lf, Rt]
    seg_ids: torch.Tensor  # int32[D_t, Lf]
    n_domains: tuple
    heads: TASHeads
    nd: Optional[torch.Tensor] = None  # int32[D_t], filled by DrainContext.build
    # the leaves grouped by domain (tas_leaf_groups), filled by
    # DrainContext.build; None when the forest is not nested or a gang
    # size is negative (drain_tas_place's split assumes counts >= 0)
    groups: Optional["TASLeafGroups"] = None


class TASLeafGroups(NamedTuple):
    """The merged forest's leaves grouped by domain, for
    drain_tas_place: one leaf order in which every level's domains are
    runs of consecutive positions (a domain's total is a prefix
    difference), and each level's domains grouped by their parent."""

    leaf_order: torch.Tensor  # int32[Lf] leaf ids in (seg_ids[0], ..., seg_ids[D_t-1]) order
    dom_beg: torch.Tensor  # int32[D_t, ND] first position of domain j's run (0 when empty)
    dom_end: torch.Tensor  # int32[D_t, ND] one past its last (0 when empty)
    child_off: torch.Tensor  # int32[D_t, ND+1] level d's domains of parent p:
    child_list: torch.Tensor  # int32[D_t, ND]   child_list[d, child_off[d, p]:child_off[d, p+1]]


def tas_leaf_groups(seg_ids: np.ndarray, n_domains, parent_map: np.ndarray,
                    device) -> Optional[TASLeafGroups]:
    """Group the leaves of a merged TAS forest by domain, on the host.

    Leaves sorted by their domain ids from the top level down make every
    level's domains runs when the forest is nested (a domain's leaves
    all lie in one domain of the level above, as ``_merge_tas_forests``
    builds it); returns None when some run is broken. Leaves whose id
    at a level is outside [0, n_domains[d]) belong to no run there.
    Level d's domains j < n_domains[d] are grouped by their parent
    ``max(parent_map[d, j], 0)`` (level 0's list is unused)."""
    d_t, lf = seg_ids.shape
    nd = parent_map.shape[1]
    order = np.lexsort(seg_ids[::-1]) if d_t else np.arange(lf)
    pos = np.arange(lf)
    beg = np.zeros((d_t, nd), dtype=np.int32)
    end = np.zeros((d_t, nd), dtype=np.int32)
    child_off = np.zeros((d_t, nd + 1), dtype=np.int32)
    child_list = np.zeros((d_t, nd), dtype=np.int32)
    for d in range(d_t):
        n = int(n_domains[d])
        s = seg_ids[d][order].astype(np.int64)
        ok = (s >= 0) & (s < n)
        count = np.bincount(s[ok], minlength=nd)[:nd]
        first = np.full(nd, lf, dtype=np.int64)
        last = np.full(nd, -1, dtype=np.int64)
        np.minimum.at(first, s[ok], pos[ok])
        np.maximum.at(last, s[ok], pos[ok])
        has = count > 0
        if (last[has] - first[has] + 1 != count[has]).any():
            return None
        beg[d] = np.where(has, first, 0)
        end[d] = np.where(has, last + 1, 0)
        if d:
            par = np.maximum(parent_map[d, :n].astype(np.int64), 0)
            child_list[d, :n] = np.argsort(par, kind="stable")
            child_off[d, 1:] = np.cumsum(np.bincount(par, minlength=nd)[:nd])
    return TASLeafGroups(*(torch.as_tensor(x.astype(np.int32)).to(device)
                           for x in (order, beg, end, child_off, child_list)))


class TASDrainResult(NamedTuple):
    """DrainResult plus TAS outputs: adm_step int32[Q,L] (intra-cycle
    admission sequence — the host replay orders placements by
    (admitted_cycle, adm_step)); tas_usage int64[Lf,Rt] final TAS leaf
    usage (the host replay asserts it reproduces this exactly)."""

    admitted_k: torch.Tensor
    admitted_cycle: torch.Tensor
    adm_step: torch.Tensor
    cursor: torch.Tensor
    cycles: torch.Tensor
    local_usage: torch.Tensor
    tas_usage: torch.Tensor
    stuck: torch.Tensor


@dataclass
class TASState(DrainState):
    """The TAS drain's loop state: the plain drain's plus the live TAS
    leaf usage (it stays on the card across cycles) and each entry's
    admission step within its cycle."""

    tas_u: Optional[torch.Tensor] = None  # int64[Lf, Rt]
    adm_step: Optional[torch.Tensor] = None  # int32[Q, L]

    @classmethod
    def initial_tas(cls, local_usage, queues: DrainQueues, max_cycles: int, tas_usage0):
        base = DrainState.initial(local_usage, queues, max_cycles)
        return cls(
            **{f.name: getattr(base, f.name) for f in fields(base)},
            tas_u=tas_usage0.clone(),
            adm_step=torch.full_like(base.adm_cycle, -1),
        )


@dataclass
class TASBuffers(CycleBuffers):
    """The TAS cycle's buffers: the plain cycle's plus each queue's
    nomination placement (feasible, and the pods taken per leaf)."""

    tas_nom_ok: Optional[torch.Tensor] = None  # bool[Q]
    taken0: Optional[torch.Tensor] = None  # int64[Q, Lf]

    @classmethod
    def empty_tas(cls, local_usage, queues: DrainQueues, n_leaves: int):
        base = CycleBuffers.empty(local_usage, queues)
        q = queues.qlen.shape[0]
        dev = local_usage.device
        return cls(
            **{f.name: getattr(base, f.name) for f in fields(base)},
            tas_nom_ok=torch.zeros(q, dtype=BOOL, device=dev),
            taken0=torch.zeros((q, n_leaves), dtype=I64, device=dev),
        )


def _tas_trunc_counts(rem, req):
    """Per (row, leaf) CountIn against ``rem`` int64[Lf, R] for request
    rows req int64[B, R]: the truncating quotient's minimum over the
    requested resources (MAX_COUNT_TAS when none). Returns int64[B, Lf]."""
    q = _trunc_div(rem[None], req[:, None, :])
    q = torch.where((req > 0)[:, None, :], q, MAX_COUNT_TAS)
    return q.amin(dim=-1)


def _tas_split(s, child_ok, cnt):
    """Greedy desc-order fill of ``cnt`` over the masked domains with the
    BestFit jump (tas_flavor_snapshot.go:468-511), batched over rows:
    s, child_ok [B, ND], cnt [B]. The prefix runs on values clamped to
    ``cnt`` (the reference's clamp; in int64 here). Nothing covered
    makes position 0 take the whole remainder, as the reference's
    argmax does."""
    inf = 1 << 62
    nd = s.shape[1]
    pos = torch.arange(nd, device=s.device)[None, :]
    sm = torch.where(child_ok, s, -1)
    order = torch.sort(-sm, dim=1, stable=True).indices
    ss = sm.gather(1, order)
    ss_c = torch.minimum(ss.clamp_min(0), cnt[:, None])
    prefix = ss_c.cumsum(dim=1) - ss_c
    remaining = cnt[:, None] - prefix
    covered = (remaining > 0) & (ss >= remaining)
    k = covered.to(I64).argmax(dim=1)
    rem_k = remaining.gather(1, k[:, None]).clamp_min(0)  # [B, 1]
    fitmask = (pos >= k[:, None]) & (ss >= rem_k) & (rem_k > 0)
    mval = torch.where(fitmask, ss, inf).amin(dim=1, keepdim=True)
    jstar = (fitmask & (ss == mval)).to(I64).argmax(dim=1)
    take = torch.where(pos < k[:, None], ss.clamp_min(0), 0)
    take.scatter_(1, jstar[:, None], rem_k)
    out = torch.zeros_like(take).scatter_(1, order, take)
    return torch.where(child_ok, out, 0)


def _tas_fit_and_place(
    topo_free,  # int64[Lf, Rt]
    tas_u,  # int64[Lf, Rt] current TAS usage
    seg_ids,  # int32[D_t, Lf]
    n_domains,  # tuple per level
    parent_map,  # int32[D_t, ND]
    req,  # int64[B, Rt] per-pod requests
    count,  # int32[B] gang sizes
    level,  # int32[B] requested level index (global level space)
    place: bool,
    mode=None,  # int32[B]: 0 Required, 1 Preferred, 2 Unconstrained
    top_level=None,  # int32[B]: each flavor's real top level (relax floor)
    leaf_sel=None,  # bool[B, Lf]: each row's flavor's leaves in the merged forest
):
    """Phase-1 counts + the reference's phase-2 greedy (BestFit default
    profile) for B podsets against the same TAS state
    (tas_flavor_snapshot.go:394-444,494-621), the JAX
    ``_tas_fit_and_place`` batched over rows, all three search modes:

    - Required: the requested level must hold ONE fitting domain;
    - Preferred: relax upward (level-1, ..., the flavor's top) looking
      for a single fit, then fall back to a multi-domain greedy take at
      the top level (:443-465);
    - Unconstrained: single fit at the lowest level, else the
      multi-domain take AT that level (no upward relaxation).

    Returns (fits bool[B], taken int64[B, Lf]) — ``taken`` is all-zero
    unless ``place`` and the request fits. ``mode``/``top_level``
    default to Required at ``level`` with no floor."""
    b = req.shape[0]
    n_lf = topo_free.shape[0]
    d_t = len(n_domains)
    nd_max = parent_map.shape[1]
    dev = topo_free.device
    inf = 1 << 62
    if mode is None:
        mode = torch.zeros(b, dtype=I32, device=dev)
    if top_level is None:
        top_level = torch.zeros(b, dtype=I32, device=dev)
    level, mode, top_level = level.long(), mode.long(), top_level.long()

    counts = _tas_trunc_counts(topo_free - tas_u, req).clamp_max(MAX_COUNT_TAS)
    counts = counts.clamp_min(-(1 << 40))  # keep sums sane
    if leaf_sel is not None:
        # other flavors' leaves are invisible: their domains total 0
        counts = torch.where(leaf_sel, counts, 0)

    # per-level domain totals, padded to ND with -1
    ar = torch.arange(nd_max, device=dev)
    states = []
    for d, nd in enumerate(n_domains):
        s = torch.zeros((b, nd_max), dtype=I64, device=dev)
        s.scatter_add_(1, seg_ids[d].long()[None, :].expand(b, n_lf), counts)
        states.append(torch.where(ar[None, :] < nd, s, -1))

    cnt = count.long()
    ok_l, idx_l, total_l = [], [], []
    for d, nd in enumerate(n_domains):
        s = states[d]
        valid = (ar < nd)[None, :]
        fit = valid & (s >= cnt[:, None])
        mval = torch.where(fit, s, inf).amin(dim=1, keepdim=True)
        idx_l.append((fit & (s == mval)).to(I64).argmax(dim=1))
        ok_l.append(fit.any(dim=1))
        # the multi-domain take walks positive-state domains only (:453)
        total_l.append(torch.where(valid, s.clamp_min(0), 0).sum(dim=1))
    ok_vec = torch.stack(ok_l, dim=1)  # [B, D]
    idx_vec = torch.stack(idx_l, dim=1)
    total_vec = torch.stack(total_l, dim=1)
    lvl = torch.arange(d_t, device=dev)[None, :]

    lv_c = level.clamp(0, d_t - 1)[:, None]
    ok_at_l = ok_vec.gather(1, lv_c)[:, 0]
    total_at_l = total_vec.gather(1, lv_c)[:, 0]
    total_at_top = total_vec.gather(1, top_level.clamp(0, d_t - 1)[:, None])[:, 0]
    # preferred: FIRST single fit walking up from the requested level
    # (:446-448) = the deepest fitting level in [top_level, level]
    pref_ok = ok_vec & (lvl <= level[:, None]) & (lvl >= top_level[:, None])
    pref_found = pref_ok.any(dim=1)
    pref_level = torch.where(pref_ok, lvl, -1).amax(dim=1)

    is_pref, is_unc = mode == 1, mode == 2
    fits = torch.where(
        is_pref,
        pref_found | (total_at_top >= cnt),
        torch.where(is_unc, ok_at_l | (total_at_l >= cnt), ok_at_l),
    )
    multi = torch.where(is_pref, ~pref_found, is_unc & ~ok_at_l)
    fit_level = torch.where(is_pref, torch.where(pref_found, pref_level, top_level), level)

    if not place:
        return fits, torch.zeros((b, n_lf), dtype=I64, device=dev)

    # seed the allocation at the fit level — one best-fit domain capped
    # at count, or the multi-domain greedy take (:450-465) — then
    # descend with the pooled greedy split
    alloc = torch.zeros((b, d_t, nd_max), dtype=I64, device=dev)
    for d, nd in enumerate(n_domains):
        single = torch.zeros((b, nd_max), dtype=I64, device=dev)
        single.scatter_(1, idx_vec[:, d:d + 1], torch.where(fits & ~multi, cnt, 0)[:, None])
        valid = (ar < nd)[None, :].expand(b, nd_max)
        seed = torch.where((multi & fits)[:, None], _tas_split(states[d], valid, cnt), single)
        alloc[:, d] = torch.where((fit_level == d)[:, None], seed, alloc[:, d])
    for d in range(1, d_t):
        # children (at level d) of domains picked at level d-1
        pm = parent_map[d].long().clamp_min(0)
        picked_above = alloc[:, d - 1][:, pm] > 0
        child_ok = picked_above & (ar < n_domains[d])[None, :]
        alloc[:, d] = torch.where(
            ((fit_level < d) & fits)[:, None], _tas_split(states[d], child_ok, cnt), alloc[:, d]
        )

    # leaf-level taken counts, gathered through the leaf -> domain ids
    taken = alloc[:, d_t - 1][:, seg_ids[d_t - 1].long()]
    return fits, torch.where(fits[:, None], taken, 0)


def drain_tas_place_plain(ctx: DrainContext, state: TASState, buf: TASBuffers) -> None:
    """Nomination placement (the JAX ``solve_drain_tas`` cycle's
    ``tas_place_v`` and the parks after it): every TAS head (a queue of
    TAS workloads with entries left) is placed against the CYCLE-START
    TAS usage; ``tas_nom_ok`` and ``taken0`` hold the result (zeros in
    the rows of other queues, which no decision reads). A quota-Fit TAS
    head whose placement fails parks; a topology request on a non-TAS
    flavor (``t_bad``) parks whatever its mode."""
    if _done(state):
        return
    tas, queues = ctx.tas, ctx.queues
    th = tas.heads
    q, l = queues.priority.shape
    dev = state.cursor.device
    q_idx = torch.arange(q, device=dev)
    active = (state.cursor < queues.qlen) & state.alive
    cur = state.cursor.clamp_max(l - 1).long()
    tas_head = th.t_is & active
    nom_ok = torch.zeros(q, dtype=BOOL, device=dev)
    taken0 = torch.zeros_like(buf.taken0)
    rows = torch.nonzero(tas_head).flatten()
    if rows.numel():
        rc = cur[rows]
        leaf_sel = th.leaf_flavor[None, :] == th.t_flavor[rows][:, None]
        fits, taken = _tas_fit_and_place(
            tas.topo_free, state.tas_u, tas.seg_ids, tas.n_domains, th.parent_map,
            th.t_req[rows, rc], th.t_count[rows, rc], th.t_level[rows, rc], True,
            mode=th.t_mode[rows, rc], top_level=th.t_top[rows], leaf_sel=leaf_sel,
        )
        nom_ok[rows] = fits
        taken0[rows] = taken
    bad = th.t_bad[q_idx, cur] & active
    parked = (tas_head & buf.is_fit & ~nom_ok) | bad
    buf.is_fit.copy_(buf.is_fit & ~parked)
    buf.is_pre.copy_(buf.is_pre & ~bad)
    buf.pend.copy_(buf.pend & ~parked)  # degrade-to-NoFit clears the cursor
    buf.tas_nom_ok.copy_(nom_ok)
    buf.taken0.copy_(taken0)


def drain_tas_phase2_plain(ctx: DrainContext, state: TASState, buf: TASBuffers) -> None:
    """The TAS cycle's ONE global step scan (the JAX ``solve_drain_tas``
    phase 2): the nominated heads of every queue in the scheduler's entry
    order (borrowing, priority, FIFO, queue index), ``n_steps`` at most;
    each re-validates its nominated leaves against the LIVE TAS usage,
    admits (quota fits and the leaves still hold) or reserves for it as
    the plain phase 2 does, and an admitted TAS head charges its leaves
    at once. Mutates ``buf.usage`` and ``state.tas_u``; admissions are
    added to ``state.local`` and their step recorded in ``adm_step``."""
    if _done(state):
        return
    tree, queues, paths, tas = ctx.tree, ctx.queues, ctx.paths, ctx.tas
    th = tas.heads
    subtree, guaranteed = ctx.subtree, ctx.guaranteed
    max_depth = tree.max_depth
    q, l = queues.priority.shape
    dev = buf.usage.device
    q_idx = torch.arange(q, device=dev)
    active = (state.cursor < queues.qlen) & state.alive
    cur = state.cursor.clamp_max(l - 1).long()
    is_fit, is_pre, head_borrow = buf.is_fit, buf.is_pre, buf.head_borrow
    cells_eff, qty_eff = buf.cells_eff, buf.qty_eff
    nofit = ~(is_fit | is_pre)

    prio = queues.priority[q_idx, cur]
    ts = queues.timestamp[q_idx, cur]
    order = _lexsort((ts, -prio, head_borrow.to(I64), nofit.to(I64)))
    valid_sorted = active[order] & (queues.cq_rows[order] >= 0) & ~nofit[order]
    walk = order[valid_sorted][: ctx.n_steps].tolist()

    usage, tas_u = buf.usage, state.tas_u
    cq = queues.cq_rows.clamp_min(0).long()
    t_req = th.t_req[q_idx, cur]  # [Q, Rt]
    admitted = torch.zeros(q, dtype=BOOL, device=dev)
    step_of = torch.full((q,), -1, dtype=I32, device=dev)
    for s, h in enumerate(walk):
        row = slice(h, h + 1)
        path = paths[cq[row]]
        cells_, qty_ = cells_eff[row], qty_eff[row]
        ccells = cells_.clamp_min(0).long()
        cell_valid = (cells_ >= 0) & (qty_ > 0)
        avail = _avail_along_path(
            path, cells_, usage, subtree, guaranteed, tree.borrowing_limit, max_depth
        )
        fits = bool(torch.where(cell_valid, avail >= qty_, True).all())
        t_ok = True
        if bool(th.t_is[h]):
            # admit-time TAS re-validation: every NOMINATED leaf must
            # still hold its assigned count against LIVE usage
            taken_h = buf.taken0[h]
            now = _tas_trunc_counts(tas.topo_free - tas_u, t_req[row])[0]
            t_ok = bool(((taken_h == 0) | (now >= taken_h)).all())
        admit = bool(is_fit[h]) and fits and t_ok
        if admit and bool(th.t_is[h]):
            tas_u += t_req[h][None, :] * buf.taken0[h][:, None]
        reserve = bool(is_pre[h]) and bool(queues.no_reclaim[h])
        nominal_c = tree.nominal[cq[row][:, None], ccells]
        bl_c = tree.borrowing_limit[cq[row][:, None], ccells]
        leaf_usage_c = usage[cq[row][:, None], ccells]
        borrow_cap = torch.where(
            bl_c < NO_LIMIT, torch.minimum(qty_, nominal_c + bl_c - leaf_usage_c), qty_
        )
        nominal_cap = torch.minimum(qty_, nominal_c - leaf_usage_c).clamp_min(0)
        reserve_qty = borrow_cap if bool(head_borrow[h]) else nominal_cap
        delta = torch.where(cell_valid & admit, qty_, torch.where(cell_valid & reserve,
                                                                  reserve_qty, 0))
        _charge_paths(usage, guaranteed, path, ccells, delta, max_depth)
        admitted[h] = admit
        if admit:
            step_of[h] = s

    cell_valid = (cells_eff >= 0) & (qty_eff > 0)
    add = torch.where(cell_valid & admitted[:, None], qty_eff, 0)
    state.local.index_put_(
        (cq[:, None].expand_as(cells_eff), cells_eff.clamp_min(0).long()), add, accumulate=True
    )
    buf.admitted.copy_(admitted)
    wrote = admitted & active
    state.adm_step[q_idx, cur] = torch.where(wrote, step_of, state.adm_step[q_idx, cur])


def drain_tas_place(ctx: DrainContext, state: TASState, buf: TASBuffers) -> None:
    """Kernel B13a: nomination placement (one block per queue)."""
    if not state.local.is_cuda:
        return drain_tas_place_plain(ctx, state, buf)
    _launch("drain_tas_place", ctx, state, buf)


def drain_tas_phase2(ctx: DrainContext, state: TASState, buf: TASBuffers) -> None:
    """Kernel B13b: the global step scan (one block)."""
    if not state.local.is_cuda:
        return drain_tas_phase2_plain(ctx, state, buf)
    _launch("drain_tas_phase2", ctx, state, buf)


def drain_tas_cycle(ctx: DrainContext, state: TASState, buf: TASBuffers) -> None:
    """ONE TAS drain cycle: five launches on the card (quota_tree once,
    drain_nominate, drain_tas_place, drain_tas_phase2,
    drain_queue_motion), or their plain versions on the CPU."""
    usage_and_available(ctx.tree, ctx.subtree, ctx.guaranteed, state.local, buf.usage,
                        buf.avail, done=state.done)
    drain_nominate(ctx, state, buf)
    drain_tas_place(ctx, state, buf)
    drain_tas_phase2(ctx, state, buf)
    drain_queue_motion(ctx, state, buf)


def tas_context(tree, queues, paths, topo_free, seg_ids, theads: TASHeads, n_domains,
                n_steps: int, max_cycles: int, seg_id=None) -> DrainContext:
    """The DrainContext of a TAS drain (its phase 2 is one global scan,
    so the root segments only size the shared argument layout)."""
    return DrainContext.build(
        tree, queues, paths, 1, n_steps, max_cycles, seg_id=seg_id,
        tas=TASInputs(topo_free=topo_free, seg_ids=seg_ids, n_domains=tuple(n_domains),
                      heads=theads),
    )


def solve_drain_tas(
    tree: QuotaTree,
    local_usage: torch.Tensor,  # int64[N, FR]
    queues: DrainQueues,
    paths: torch.Tensor,  # int32[N, D+1]
    topo_free: torch.Tensor,  # int64[Lf, Rt]
    tas_usage0: torch.Tensor,  # int64[Lf, Rt]
    seg_ids: torch.Tensor,  # int32[D_t, Lf]
    theads: TASHeads,
    n_domains,  # tuple
    n_steps: int,  # TOTAL sequential steps per cycle (global order)
    max_cycles: int,
    seg_id=None,  # host copy of queues.seg_id
) -> TASDrainResult:
    """Multi-cycle drain with Topology-Aware Scheduling heads decided
    IN KERNEL (the JAX ``solve_drain_tas``). A shared topology couples
    every ClusterQueue using the flavor — across cohorts — so phase 2 is
    one GLOBAL sequential scan in the scheduler's entry order. Per
    cycle: the normal quota nomination; each quota-Fit TAS head's
    placement against CYCLE-START TAS state, which parks infeasible
    heads (the host's degrade-to-NoFit, tas_flavorassigner.go:31-50);
    then one head per step in global (borrowing, priority, FIFO) order,
    TAS heads re-validating their nominated leaves against the LIVE TAS
    state and charging them at once; then queue motion. The host
    replays admitted placements in (cycle, step) order and asserts the
    final leaf usage matches ``tas_usage``."""
    ctx = tas_context(tree, queues, paths, topo_free, seg_ids, theads, n_domains, n_steps,
                      max_cycles, seg_id=seg_id)
    state = TASState.initial_tas(local_usage, queues, max_cycles, tas_usage0)
    buf = TASBuffers.empty_tas(local_usage, queues, topo_free.shape[0])
    run_cycles(ctx, state, buf, drain_tas_cycle, max_cycles)
    return TASDrainResult(
        admitted_k=state.adm_k,
        admitted_cycle=state.adm_cycle,
        adm_step=state.adm_step,
        cursor=state.cursor,
        cycles=state.cycle,
        local_usage=state.local,
        tas_usage=state.tas_u,
        stuck=state.stuck,
    )


def _solve_drain_tas_packed(
    tree, local_usage, queues, paths, topo_free, tas_usage0, seg_ids, theads, n_domains,
    n_steps: int, max_cycles: int, seg_id=None,
) -> torch.Tensor:
    """solve_drain_tas in the JAX ``_solve_drain_tas_packed`` layout
    (adm_k, adm_cycle, adm_step, cursor, stuck, tas_usage, cycles, all
    int64), so the host retrieves the whole drain in a single copy."""
    r = solve_drain_tas(
        tree, local_usage, queues, paths, topo_free, tas_usage0, seg_ids, theads, n_domains,
        n_steps, max_cycles, seg_id=seg_id,
    )
    return torch.cat([
        r.admitted_k.reshape(-1).to(I64),
        r.admitted_cycle.reshape(-1).to(I64),
        r.adm_step.reshape(-1).to(I64),
        r.cursor.to(I64),
        r.stuck.to(I64),
        r.tas_usage.reshape(-1),
        r.cycles.reshape(1).to(I64),
    ])
