"""Scenario-batched admission solve, kernel B14 — the planner's device
path (port of kueue_tpu/ops/plan_kernel.py).

S scenario variants of the quota tensors (nominal / lending / borrowing
limits, leaf usage), of the head priorities and of the policy scores
solve against ONE shared heads batch: the segmented cycle solver of
ops/assign_kernel.py under one more batch axis, as the JAX package's
``jax.vmap`` is. Structure — parent links, level masks, ancestor paths,
candidate cells, the segment schedule — is scenario-invariant. Subtree
quotas and the usage tree are recomputed per scenario, so a nominal
delta flows through guaranteed and available.

On the card it is three launches whatever S is, each with the scenario
as a grid dimension:

- ``plan_quota_tree`` (``csrc/plan_quota_tree.cu``): subtree and
  guaranteed, the usage tree, available and potential of every
  scenario (quota_tree's bodies);
- ``plan_phase1`` (``csrc/plan_phase1.cu``): cycle_phase1's body, one
  warp per (scenario, head);
- ``plan_phase2`` (``csrc/plan_phase2.cu``): the entry order (one sort
  a distinct priority row, then a stable partition by class a
  scenario), each (segment, scenario)'s walk list and the segment walk
  of cycle_walk.cuh, one warp a (segment, scenario).

Per scenario it returns, packed for one host fetch:
  per_head int64[S, 6, W]  — chosen candidate, admitted flag, borrows,
                             reserved (blocked preempt-mode capacity
                             hold), phase-2 entry order (over all W,
                             pads included), and the preempt-mode
                             representative candidate;
  usage    int64[S, N, FR] — the post-admission usage tree.

``solve_scenarios_plain`` is the plain torch version (the CPU path and
what the kernels are held to on the card), vectorized over the
scenario axis: about ``n_steps`` Python iterations, not S x n_steps.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from kueue_tpu_torch._torch import BOOL, I32, I64, torch
from kueue_tpu_torch.ops import _build
from kueue_tpu_torch.ops.assign_kernel import (
    MAX_C,
    MAX_K,
    NEG_SCORE,
    HeadsBatch,
    Segments,
    _avail_along_path,
    _bubble_usage,
    _call,
    build_segments,
    segmented_rank,
)
from kueue_tpu_torch.ops.quota import (
    NO_LIMIT,
    QuotaTree,
    available_all_plain,
    potential_available_all_plain,
    subtree_quota_plain,
    usage_tree_plain,
)

# per-head rows of the packed result
PER_HEAD_ROWS = 6
# the plain phase 1 gathers [S, W, K, C] tensors: scenarios in chunks of
# at most this many elements a gathered tensor
_PLAIN_CHUNK = 1 << 25


def _nsf(x: torch.Tensor) -> torch.Tensor:
    """[S, N, FR] -> [N, S*FR]: every recurrence acts on a node row
    cell by cell, so the scenario axis folds into the cells."""
    s, n, fr = x.shape
    return x.permute(1, 0, 2).reshape(n, s * fr)


def _snf(x: torch.Tensor, s: int) -> torch.Tensor:
    n = x.shape[0]
    return x.reshape(n, s, -1).permute(1, 0, 2).contiguous()


# the shared memory a plan_phase2 block may take (227 KB, less the static
# part): a walk list is ranked in a bitmap of the W positions or, past
# it, among the segment's positions; past both, in a bitmap in device
# memory
MAX_SMEM = 232448 - 1024
LIST_BLOCKS = 264  # plan_phase2's blocks of device-memory walk lists (kListBlocks)

# ---- plan_quota_tree (csrc/plan_quota_tree.cu) ---------------------------


def plan_quota_tree_plain(parent, level_mask, nominal_s, lending_s, borrowing_s, usage_s):
    """The plain version of ``plan_quota_tree``: (subtree, guaranteed,
    usage tree, available, potential), each int64[S, N, FR]."""
    s = nominal_s.shape[0]
    tree = QuotaTree(
        parent=parent,
        level_mask=level_mask,
        nominal=_nsf(nominal_s),
        lending_limit=_nsf(lending_s),
        borrowing_limit=_nsf(borrowing_s),
    )
    sub, g = subtree_quota_plain(tree)
    usage = usage_tree_plain(tree, g, _nsf(usage_s))
    avail = available_all_plain(tree, sub, g, usage)
    pot = potential_available_all_plain(tree, sub, g)
    return tuple(_snf(x, s) for x in (sub, g, usage, avail, pot))


def plan_quota_tree(parent, level_mask, nominal_s, lending_s, borrowing_s, usage_s,
                    usage_out=None):
    """Every scenario's quota recurrences: (subtree, guaranteed, usage
    tree, available, potential), each int64[S, N, FR]. On a CUDA tensor
    one launch of ``plan_quota_tree``; the usage tree goes to
    ``usage_out`` when given (a view into the packed result)."""
    if not nominal_s.is_cuda:
        out = plan_quota_tree_plain(
            parent, level_mask, nominal_s, lending_s, borrowing_s, usage_s
        )
        if usage_out is not None:
            usage_out.copy_(out[2])
            out = out[:2] + (usage_out,) + out[3:]
        return out
    kernel = "plan_quota_tree"
    s, n, fr = nominal_s.shape
    d = level_mask.shape[0] - 1
    shape = (s, n, fr)
    sub, g, avail, pot = (torch.empty_like(nominal_s) for _ in range(4))
    usage = usage_out if usage_out is not None else torch.empty_like(nominal_s)
    ptr = _build.ptr
    ptrs = [
        ptr(kernel, "parent", parent, I32, (n,)),
        ptr(kernel, "level_mask", level_mask, BOOL, (d + 1, n)),
        ptr(kernel, "nominal", nominal_s, I64, shape),
        ptr(kernel, "lending", lending_s, I64, shape),
        ptr(kernel, "borrowing", borrowing_s, I64, shape),
        ptr(kernel, "local_usage", usage_s, I64, shape),
        sub.data_ptr(),
        g.data_ptr(),
        ptr(kernel, "usage_out", usage, I64, shape),
        avail.data_ptr(),
        pot.data_ptr(),
    ]
    if s > 65535:
        raise _build.KernelInputError(f"{kernel}: takes S<=65535 scenarios, got {s}")
    _call(kernel, [s, n, fr, d], ptrs, nominal_s.device)
    return sub, g, usage, avail, pot


# ---- plan_phase1 (csrc/plan_phase1.cu) -----------------------------------


def plan_phase1_plain(parent, nominal_s, subtree_s, local_s, avail_s, potential_s,
                      heads: HeadsBatch, score_s):
    """The plain version of ``plan_phase1``: (chosen int32[S, W],
    borrows bool[S, W, K], preempt_k int32[S, W]), cycle_phase1's
    plain version with the scenario axis in front."""
    s = nominal_s.shape[0]
    w, k, c = heads.cells.shape
    cq = heads.cq_row.clamp_min(0).long()
    qty = heads.qty
    cell_need = (heads.cells >= 0) & (qty > 0)
    cq_i = cq[:, None, None]
    cc = heads.cells.clamp_min(0).long()
    has_cohort = (parent[cq] >= 0)[:, None]
    populated = heads.cq_row >= 0
    outs = []
    step = max(1, _PLAIN_CHUNK // max(1, w * k * c))
    for a in range(0, s, step):
        sl = slice(a, min(s, a + step))

        def g(x):
            return x[sl][:, cq_i, cc]  # [s', W, K, C]

        avail_wkc, sub_wkc, local_wkc = g(avail_s), g(subtree_s), g(local_s)
        pot_wkc, nom_wkc = g(potential_s), g(nominal_s)
        fits = torch.where(cell_need, avail_wkc >= qty, True).all(dim=-1)
        pot_fits = torch.where(
            cell_need, (qty <= pot_wkc) & (qty <= nom_wkc), True
        ).all(dim=-1)
        borrows = (
            torch.where(cell_need, local_wkc + qty > sub_wkc, False).any(dim=-1)
            & has_cohort
        )
        score = score_s[sl]
        neg = torch.full_like(score, NEG_SCORE)
        fit_ok = fits & heads.valid
        first_fit = torch.argmax(torch.where(fit_ok, score, neg), dim=2)
        chosen = torch.where(fit_ok.any(dim=2) & populated, first_fit, -1).to(I32)
        pre_ok = pot_fits & heads.valid
        first_pre = torch.argmax(torch.where(pre_ok, score, neg), dim=2)
        preempt_k = torch.where(
            pre_ok.any(dim=2) & populated & (chosen < 0), first_pre, -1
        ).to(I32)
        outs.append((chosen, borrows, preempt_k))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def plan_phase1(parent, nominal_s, subtree_s, local_s, avail_s, potential_s,
                heads: HeadsBatch, score_s):
    """Phase 1 of every scenario: (chosen int32[S, W], borrows bool[S,
    W, K], preempt_k int32[S, W]). On a CUDA tensor one launch of
    ``plan_phase1``."""
    if not nominal_s.is_cuda:
        return plan_phase1_plain(
            parent, nominal_s, subtree_s, local_s, avail_s, potential_s, heads, score_s
        )
    kernel = "plan_phase1"
    s, n, fr = nominal_s.shape
    w, k, c = heads.cells.shape
    if k > MAX_K:
        raise _build.KernelInputError(f"{kernel}: takes K<={MAX_K} candidates, got {k}")
    if s > 65535:
        raise _build.KernelInputError(f"{kernel}: takes S<=65535 scenarios, got {s}")
    dev = nominal_s.device
    chosen = torch.empty((s, w), dtype=I32, device=dev)
    borrows = torch.empty((s, w, k), dtype=BOOL, device=dev)
    preempt_k = torch.empty((s, w), dtype=I32, device=dev)
    q = (s, n, fr)
    ptr = _build.ptr
    ptrs = [
        ptr(kernel, "cq_row", heads.cq_row, I32, (w,)),
        ptr(kernel, "cells", heads.cells, I32, (w, k, c)),
        ptr(kernel, "qty", heads.qty, I64, (w, k, c)),
        ptr(kernel, "valid", heads.valid, BOOL, (w, k)),
        ptr(kernel, "score", score_s, I64, (s, w, k)),
        ptr(kernel, "avail", avail_s, I64, q),
        ptr(kernel, "potential", potential_s, I64, q),
        ptr(kernel, "subtree", subtree_s, I64, q),
        ptr(kernel, "local_usage", local_s, I64, q),
        ptr(kernel, "nominal", nominal_s, I64, q),
        ptr(kernel, "parent", parent, I32, (n,)),
        chosen.data_ptr(),
        borrows.data_ptr(),
        preempt_k.data_ptr(),
    ]
    _call(kernel, [s, w, k, c, n, fr], ptrs, dev)
    return chosen, borrows, preempt_k


# ---- plan_phase2 (csrc/plan_phase2.cu) -----------------------------------


def _lexsort_rows(keys):
    """``jnp.lexsort`` along dim 1 of [S, W] keys (the LAST key is the
    primary one; stable)."""
    s, w = keys[0].shape
    order = torch.arange(w, device=keys[0].device).expand(s, w)
    for key in keys:
        idx = torch.sort(key.gather(1, order), dim=1, stable=True).indices
        order = order.gather(1, idx)
    return order


def plan_phase2_plain(nominal_s, borrowing_s, subtree_s, guaranteed_s, usage_s, paths,
                      heads: HeadsBatch, priority_s, seg_id, n_segments: int,
                      n_steps: int, chosen, borrows_wk, preempt_k) -> torch.Tensor:
    """The plain version of ``plan_phase2``: the packed int64[S, 6, W]
    rows (chosen, admitted, borrows, reserved, order, preempt_k);
    ``usage_s`` (the usage trees, contiguous) ends as every scenario's
    final usage tree. cycle_phase2's plain version with the scenario
    axis in front: one step of the scan handles every (scenario,
    segment) pair's head of that rank."""
    s, n, fr = nominal_s.shape
    w, k, c = heads.cells.shape
    max_depth = paths.shape[1] - 1
    dev = usage_s.device
    eff_k = torch.where(chosen >= 0, chosen, preempt_k)  # [S, W]
    eff_safe = eff_k.clamp_min(0).long()
    head_borrow = borrows_wk.gather(2, eff_safe[..., None])[..., 0] & (eff_k >= 0)
    nofit = eff_k < 0
    order = _lexsort_rows(
        (heads.timestamp.expand(s, w), -priority_s, head_borrow.to(I64), nofit.to(I64))
    )

    seg_sorted = seg_id.clamp_min(0).long()[order]  # [S, W]
    valid_sorted = (
        (heads.cq_row[order] >= 0) & (seg_id[order] >= 0) & ~nofit.gather(1, order)
    )
    # ranks within (scenario, segment): one flat segmented rank over
    # combined segment ids
    scen = torch.arange(s, device=dev)[:, None].expand(s, w)
    combined = scen * (w + 1) + seg_sorted
    rank = segmented_rank(combined.reshape(-1), valid_sorted.reshape(-1)).view(s, w).long()
    keep = valid_sorted & (rank < n_steps) & (seg_sorted < n_segments)
    mat = torch.full((s, n_steps, n_segments), -1, dtype=I64, device=dev)
    mat[scen[keep], rank[keep], seg_sorted[keep]] = order[keep]
    n_iter = int(rank[keep].max()) + 1 if bool(keep.any()) else 0

    rows = torch.arange(w, device=dev)[None].expand(s, w)
    cells_eff = heads.cells[rows, eff_safe]  # [S, W, C]
    qty_eff = heads.qty[rows, eff_safe]
    cq = heads.cq_row.clamp_min(0).long()
    usage = usage_s.view(s * n, fr)
    nominal = nominal_s.reshape(s * n, fr)
    borrowing = borrowing_s.reshape(s * n, fr)
    subtree = subtree_s.reshape(s * n, fr)
    guaranteed = guaranteed_s.reshape(s * n, fr)
    admitted = torch.zeros((s, w), dtype=BOOL, device=dev)
    reserved = torch.zeros((s, w), dtype=BOOL, device=dev)
    for st in range(n_iter):
        idx = mat[:, st, :]  # [S, G]
        sc, sg = (idx >= 0).nonzero(as_tuple=True)
        hidx = idx[sc, sg]
        cqs = cq[hidx]
        path = paths[cqs]
        path = torch.where(path >= 0, path + (sc * n)[:, None].to(path.dtype), -1)
        cells_ = cells_eff[sc, hidx]
        qty_ = qty_eff[sc, hidx]
        ccells = cells_.clamp_min(0).long()
        cell_valid = (cells_ >= 0) & (qty_ > 0)
        avail = _avail_along_path(
            path, cells_, usage, subtree, guaranteed, borrowing, max_depth
        )
        fits = torch.where(cell_valid, avail >= qty_, True).all(dim=1)
        admit = (chosen[sc, hidx] >= 0) & fits
        reserve = (chosen[sc, hidx] < 0) & (preempt_k[sc, hidx] >= 0) & heads.no_reclaim[hidx]
        leaf = (cqs + sc * n)[:, None]
        nominal_c = nominal[leaf, ccells]
        bl_c = borrowing[leaf, ccells]
        leaf_c = usage[leaf, ccells]
        borrow_cap = torch.where(
            bl_c < NO_LIMIT, torch.minimum(qty_, nominal_c + bl_c - leaf_c), qty_
        )
        nominal_cap = torch.minimum(qty_, nominal_c - leaf_c).clamp_min(0)
        reserve_qty = torch.where(head_borrow[sc, hidx][:, None], borrow_cap, nominal_cap)
        delta = torch.where(
            cell_valid & admit[:, None],
            qty_,
            torch.where(cell_valid & reserve[:, None], reserve_qty, 0),
        )
        _bubble_usage(path, cells_, delta, usage, guaranteed, max_depth)
        admitted[sc, hidx] = admit
        reserved[sc, hidx] = reserve

    return torch.stack(
        [chosen.to(I64), admitted.to(I64), head_borrow.to(I64), reserved.to(I64),
         order.to(I64), preempt_k.to(I64)],
        dim=1,
    )


def _align16(n: int) -> int:
    return (n + 15) & ~15


def plan_phase2(nominal_s, borrowing_s, subtree_s, guaranteed_s, usage_s, paths,
                heads: HeadsBatch, priority_s, seg_id, segments: Segments,
                n_segments: int, n_steps: int, chosen, borrows_wk, preempt_k,
                out=None) -> torch.Tensor:
    """Phase 2 of every scenario: the packed int64[S, 6, W] rows (into
    ``out`` when given). ``usage_s`` (the scenarios' usage trees) is
    updated in place. On a CUDA tensor one call of ``plan_phase2``
    (its sort and its walk); ``segments`` is the CSR of ``seg_id``."""
    if not usage_s.is_cuda:
        res = plan_phase2_plain(
            nominal_s, borrowing_s, subtree_s, guaranteed_s, usage_s, paths, heads,
            priority_s, seg_id, n_segments, n_steps, chosen, borrows_wk, preempt_k,
        )
        if out is None:
            return res
        out.copy_(res)
        return out
    kernel = "plan_phase2"
    s, n, fr = nominal_s.shape
    w, k, c = heads.cells.shape
    d = paths.shape[1] - 1
    if c > MAX_C:
        raise _build.KernelInputError(f"{kernel}: takes C<={MAX_C} cells, got {c}")
    if s > 65535:
        raise _build.KernelInputError(f"{kernel}: takes S<=65535 scenarios, got {s}")
    dev = usage_s.device
    # the walk lists' bitmaps in device memory where neither a bitmap of
    # W positions nor the largest segment's positions fit a block
    list_bits = None
    bitmap, positions = 2 * _align16(4 * -(-w // 32)), _align16(4 * segments.max_size)
    n_walk_segs = min(segments.count, n_segments)
    if bitmap > MAX_SMEM and positions > MAX_SMEM and n_walk_segs > 0:
        blocks = min(n_walk_segs * s, LIST_BLOCKS)
        list_bits = torch.empty(blocks * 2 * -(-w // 32), dtype=I32, device=dev)
    if out is None:
        out = torch.empty((s, PER_HEAD_ROWS, w), dtype=I64, device=dev)
    n_seg = segments.count
    q = (s, n, fr)
    # scratch: each head's class and position, the sort's two buffers
    # (then the walk lists), per scenario its flags and class counts, per
    # walk its length (held here until the launches are enqueued)
    cls = torch.empty((s, w), dtype=torch.uint8, device=dev)
    pos, idx_a, idx_b = (torch.empty((s, w), dtype=I32, device=dev) for _ in range(3))
    ctl = torch.empty((s, 4), dtype=I32, device=dev)
    n_walk = torch.empty((s, max(n_seg, 1)), dtype=I32, device=dev)
    ptr = _build.ptr
    ptrs = [
        ptr(kernel, "cq_row", heads.cq_row, I32, (w,)),
        ptr(kernel, "cells", heads.cells, I32, (w, k, c)),
        ptr(kernel, "qty", heads.qty, I64, (w, k, c)),
        ptr(kernel, "priority", priority_s, I64, (s, w)),
        ptr(kernel, "timestamp", heads.timestamp, I64, (w,)),
        ptr(kernel, "no_reclaim", heads.no_reclaim, BOOL, (w,)),
        ptr(kernel, "chosen", chosen, I32, (s, w)),
        ptr(kernel, "borrows", borrows_wk, BOOL, (s, w, k)),
        ptr(kernel, "preempt_k", preempt_k, I32, (s, w)),
        ptr(kernel, "seg_id", seg_id, I32, (w,)),
        ptr(kernel, "seg_offsets", segments.offsets, I32, (n_seg + 1,)),
        ptr(kernel, "seg_members", segments.members, I32, None),
        ptr(kernel, "nominal", nominal_s, I64, q),
        ptr(kernel, "borrowing_limit", borrowing_s, I64, q),
        ptr(kernel, "subtree", subtree_s, I64, q),
        ptr(kernel, "guaranteed", guaranteed_s, I64, q),
        ptr(kernel, "paths", paths, I32, (n, d + 1)),
        ptr(kernel, "usage", usage_s, I64, q),
        ptr(kernel, "per_head", out, I64, (s, PER_HEAD_ROWS, w)),
        cls.data_ptr(), pos.data_ptr(), idx_a.data_ptr(), idx_b.data_ptr(), ctl.data_ptr(),
        n_walk.data_ptr(), ptr(kernel, "list_bits", list_bits, I32, None),
    ]
    ints = [s, w, k, c, n, fr, d, n_segments, n_steps, n_seg, segments.max_size]
    _call(kernel, ints, ptrs, dev)
    return out


# ---- the whole solve ------------------------------------------------------


def _seg(seg_id, device) -> Tuple[torch.Tensor, Segments]:
    seg_np = (
        seg_id.cpu().numpy() if isinstance(seg_id, torch.Tensor) else np.asarray(seg_id)
    )
    return (
        torch.as_tensor(seg_np.astype(np.int32), device=device),
        build_segments(seg_np, device),
    )


def solve_scenarios_packed(
    parent,  # int32[N]
    level_mask,  # bool[D+1, N]
    nominal_s,  # int64[S, N, FR]
    lending_s,  # int64[S, N, FR]
    borrowing_s,  # int64[S, N, FR]
    usage_s,  # int64[S, N, FR] leaf usage
    priority_s,  # int64[S, W]
    score_s,  # int64[S, W, K] per-scenario policy scores (zeros = first-fit)
    heads: HeadsBatch,  # shared across scenarios (priority/score overridden)
    paths,  # int32[N, D+1]
    seg_id,  # int32[W] compact root-cohort id per head (-1 pad)
    n_segments: int,
    n_steps: int,
) -> torch.Tensor:
    """Every scenario's solve in one int64 buffer: ``per_head`` [S, 6,
    W] then ``usage`` [S, N, FR] (``unpack`` splits it), so the host
    fetches the whole sweep in ONE device-to-host copy. On the card
    three launches (plan_quota_tree, plan_phase1, plan_phase2); on the
    CPU their plain versions."""
    s, n, fr = nominal_s.shape
    w = heads.cq_row.shape[0]
    dev = nominal_s.device
    buf = torch.empty(s * PER_HEAD_ROWS * w + s * n * fr, dtype=I64, device=dev)
    per_head, usage = unpack(buf, s, w, n, fr)
    sub, g, usage, avail, pot = plan_quota_tree(
        parent, level_mask, nominal_s, lending_s, borrowing_s, usage_s, usage_out=usage
    )
    chosen, borrows_wk, preempt_k = plan_phase1(
        parent, nominal_s, sub, usage_s, avail, pot, heads, score_s
    )
    seg_t, segments = _seg(seg_id, dev)
    plan_phase2(
        nominal_s, borrowing_s, sub, g, usage, paths, heads, priority_s, seg_t,
        segments, n_segments, n_steps, chosen, borrows_wk, preempt_k, out=per_head,
    )
    return buf


def unpack(buf, s: int, w: int, n: int, fr: int):
    """(per_head [S, 6, W], usage [S, N, FR]) views of a packed buffer
    (a tensor or a numpy array)."""
    split = s * PER_HEAD_ROWS * w
    return (
        buf[:split].reshape(s, PER_HEAD_ROWS, w),
        buf[split:].reshape(s, n, fr),
    )


def solve_scenarios(parent, level_mask, nominal_s, lending_s, borrowing_s, usage_s,
                    priority_s, score_s, heads: HeadsBatch, paths, seg_id,
                    n_segments: int, n_steps: int):
    """(per_head int64[S, 6, W], usage int64[S, N, FR]): the JAX
    ``solve_scenarios_jit``'s two outputs, as views of one buffer."""
    s, n, fr = nominal_s.shape
    buf = solve_scenarios_packed(
        parent, level_mask, nominal_s, lending_s, borrowing_s, usage_s, priority_s,
        score_s, heads, paths, seg_id, n_segments, n_steps,
    )
    return unpack(buf, s, heads.cq_row.shape[0], n, fr)


def solve_scenarios_plain(parent, level_mask, nominal_s, lending_s, borrowing_s, usage_s,
                          priority_s, score_s, heads: HeadsBatch, paths, seg_id,
                          n_segments: int, n_steps: int):
    """The plain version of the whole solve on any device (what the
    three kernels are held to on the card): (per_head, usage)."""
    sub, g, usage, avail, pot = plan_quota_tree_plain(
        parent, level_mask, nominal_s, lending_s, borrowing_s, usage_s
    )
    chosen, borrows_wk, preempt_k = plan_phase1_plain(
        parent, nominal_s, sub, usage_s, avail, pot, heads, score_s
    )
    seg_t, _ = _seg(seg_id, nominal_s.device)
    per_head = plan_phase2_plain(
        nominal_s, borrowing_s, sub, g, usage, paths, heads, priority_s, seg_t,
        n_segments, n_steps, chosen, borrows_wk, preempt_k,
    )
    return per_head, usage
