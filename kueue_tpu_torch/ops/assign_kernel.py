"""Batched admission solver (port of kueue_tpu/ops/assign_kernel.py).

One interactive scheduling cycle's nomination and conflict resolution
over dense tensors, as in the JAX package:

- phase 1, ``phase1_classify``: every (head, flavor candidate) pair
  against the cycle-start availability; the first fitting candidate (or
  the masked score-argmax), its borrow bit, and the representative
  preempt-mode candidate of unfit heads. Kernel ``cycle_phase1``
  (``csrc/cycle_phase1.cu``), one warp per head.
- phase 2, ``cycle_phase2``: the reference's entry order (lexsort over
  all heads: no-fit last, non-borrowing first, priority desc,
  timestamp asc), then within each root cohort the heads in that order
  re-check availability along their ancestor path, admit or reserve,
  and bubble the usage delta up the path. Kernel ``cycle_phase2``
  (``csrc/cycle_phase2.cu``), one block per root cohort.
- ``solve_cycle_segmented`` / ``solve_cycle_segmented_packed``: the
  whole cycle (four ``quota_tree`` launches, then the two kernels); the
  packed form returns int64[5, W] (chosen, admitted, borrows, reserved,
  order) for one device-to-host copy.
- ``solve_cycle`` / ``solve_cycle_packed``: the unsegmented cycle, one
  scan over all heads in the global entry order (kernel B3',
  ``cycle_global``, ``csrc/cycle_global.cu``: each root cohort's heads
  walked in that order, a block a group of whole root subtrees, their
  rows in shared memory where they fit); ``parallel.ShardedSolver``
  runs its phase 2 on the gathered phase-1 output.
  ``solve_cycle_plain`` is the JAX ``solve_cycle`` written out in torch.

Every wrapper launches its CUDA kernel for a CUDA tensor (or raises) and
runs the plain torch version beside it (``*_plain``) for a CPU tensor.
The drain reuses the host helpers here (``build_paths``,
``build_roots``, ``build_segments``, ``cell_masks``,
``_avail_along_path``, ``segmented_rank``, ``_lexsort``).

Shapes: N nodes (CQs then cohorts), FR flavor-resource cells, W heads,
K flavor candidates per head, C requested cells per candidate, D max
tree depth.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np

from kueue_tpu_torch._torch import BOOL, I32, I64, to_device, torch
from kueue_tpu_torch.ops import _build
from kueue_tpu_torch.ops.quota import (
    NO_LIMIT,
    QuotaTree,
    available_all,
    potential_available_all,
    quota_all,
    quota_all_plain,
    subtree_quota,
    tree_forest,
    usage_and_available,
    usage_tree,
)

# jnp.argmax's sentinel for ineligible candidates in the score-argmax
NEG_SCORE = -(2**62)
# widest candidate fan-out the phase-1 kernel takes (one lane per k)
MAX_K = 32
# widest cell list the phase-2 kernel takes (one lane per cell)
MAX_C = 32


class HeadsBatch(NamedTuple):
    """One cycle's nominated heads, densely packed (torch tensors).

    cq_row:    int32[W]   — head's ClusterQueue row, -1 for padding.
    cells:     int32[W,K,C] — FR cell indices requested by candidate k,
                              -1 for unused cell slots.
    qty:       int64[W,K,C] — requested quantity per cell.
    valid:     bool[W,K]  — candidate slot is populated.
    priority:  int64[W]
    timestamp: int64[W]   — queue-order timestamp (ns); lower = older.
    no_reclaim: bool[W]   — CQ cannot always reclaim: blocked
                            preempt-mode heads RESERVE capacity.
    score:     int64[W,K] candidate scores; None is all-zero (the
                          default first-fit policy).
    """

    cq_row: torch.Tensor
    cells: torch.Tensor
    qty: torch.Tensor
    valid: torch.Tensor
    priority: torch.Tensor
    timestamp: torch.Tensor
    no_reclaim: torch.Tensor
    score: Optional[torch.Tensor] = None


class SolveResult(NamedTuple):
    """chosen: int32[W] candidate index (-1 = no fit in phase 1).
    admitted: bool[W]; borrows: bool[W] (of the chosen candidate);
    reserved: bool[W] — blocked preempt-mode head reserved capacity;
    usage: int64[N,FR] the cycle's usage tree after all admissions and
    reservations (None where only the packed outcome came back);
    order: int32[W] — the admission entry order used by phase 2."""

    chosen: object
    admitted: object
    borrows: object
    reserved: object
    usage: object
    order: object


def build_paths(parent, max_depth: int):
    """int32[N, D+1] ancestor paths: row i = [i, parent(i), ..., root,
    -1 pads]. Host-side helper (numpy)."""
    n = parent.shape[0]
    paths = np.full((n, max_depth + 1), -1, dtype=np.int32)
    for i in range(n):
        cur, d = i, 0
        while cur >= 0 and d <= max_depth:
            paths[i, d] = cur
            cur = int(parent[cur])
            d += 1
    return paths


def build_roots(parent):
    """int32[N] root node of every node (itself when parentless).
    Host-side helper; segments of the segmented phase-2 resolver."""
    n = parent.shape[0]
    roots = np.empty(n, dtype=np.int32)
    for i in range(n):
        cur = i
        while parent[cur] >= 0:
            cur = int(parent[cur])
        roots[i] = cur
    return roots


def cell_masks(
    tree: QuotaTree,
    subtree: torch.Tensor,
    guaranteed: torch.Tensor,
    local_usage: torch.Tensor,
    cq_row: torch.Tensor,  # int32[W]
    cells: torch.Tensor,  # int32[W,K,C]
    qty: torch.Tensor,  # int64[W,K,C] (already inflated by any
    #                     accumulated same-nomination usage)
    usage=None,  # precomputed usage_tree, or None to build it
    avail=None,  # precomputed available_all (once per cycle)
    potential=None,  # precomputed potential_available_all (constant)
    pwb=None,  # bool[W] canPreemptWhileBorrowing
):
    """Per-cell classification masks against the cycle-start snapshot
    (zero/pad cells are permissive): fit, preempt-eligible, the reclaim
    upgrade's leaf condition, and borrowing. Returns (fit, pot,
    reclaim, borrow, need), each bool[W,K,C]."""
    if avail is None:
        if usage is None:
            _, avail = usage_and_available(tree, subtree, guaranteed, local_usage)
        else:
            avail = available_all(tree, subtree, guaranteed, usage)
    if potential is None:
        potential = potential_available_all(tree, subtree, guaranteed)

    cq = cq_row.clamp_min(0).long()[:, None, None]
    cell_need = (cells >= 0) & (qty > 0)
    cc = cells.clamp_min(0).long()
    avail_wkc = avail[cq, cc]
    potential_wkc = potential[cq, cc]
    local_wkc = local_usage[cq, cc]
    subtree_wkc = subtree[cq, cc]
    nominal_wkc = tree.nominal[cq, cc]
    has_cohort = (tree.parent[cq[:, 0, 0]] >= 0)[:, None, None]

    true = torch.ones_like(cell_need)
    fit_cells = torch.where(cell_need, avail_wkc >= qty, true)
    nominal_ok = qty <= nominal_wkc
    if pwb is not None:
        nominal_ok = nominal_ok | pwb[:, None, None]
    pot_cells = torch.where(cell_need, (qty <= potential_wkc) & nominal_ok, true)
    reclaim_cells = torch.where(cell_need, local_wkc + qty <= nominal_wkc, true)
    borrow_cells = cell_need & (local_wkc + qty > subtree_wkc) & has_cohort
    return fit_cells, pot_cells, reclaim_cells, borrow_cells, cell_need


def _avail_along_path(
    path: torch.Tensor,  # int32[B, D+1]
    cells: torch.Tensor,  # int32[B, C]
    usage: torch.Tensor,  # int64[N, FR] current full usage tree
    subtree: torch.Tensor,
    guaranteed: torch.Tensor,
    borrowing_limit: torch.Tensor,
    max_depth: int,
) -> torch.Tensor:
    """available() at each path's leaf, computed root-down over the
    ancestor path only (resource_node.go:89-104), for a batch of B
    paths. Returns int64[B, C]."""
    rows = path.clamp_min(0).long()[:, :, None]  # [B, D+1, 1]
    cc = cells.clamp_min(0).long()[:, None, :]  # [B, 1, C]
    sub = subtree[rows, cc]  # [B, D+1, C]
    g = guaranteed[rows, cc]
    bl = borrowing_limit[rows, cc]
    u = usage[rows, cc]

    valid = path >= 0  # [B, D+1]
    root_pos = valid.to(torch.int64).sum(dim=1) - 1  # [B]

    avail = torch.zeros(cells.shape, dtype=torch.int64, device=usage.device)
    for d in range(max_depth, -1, -1):
        is_root = (root_pos == d)[:, None]
        root_avail = sub[:, d] - u[:, d]
        stored = sub[:, d] - g[:, d]
        used = (u[:, d] - g[:, d]).clamp_min(0)
        with_max = stored - used + bl[:, d]
        clamped = torch.where(
            bl[:, d] < NO_LIMIT, torch.minimum(with_max, avail), avail
        )
        nonroot_avail = (g[:, d] - u[:, d]).clamp_min(0) + clamped
        new_avail = torch.where(is_root, root_avail, nonroot_avail)
        avail = torch.where(valid[:, d : d + 1], new_avail, avail)
    return avail


def segmented_rank(seg: torch.Tensor, valid_sorted: torch.Tensor) -> torch.Tensor:
    """Per sorted slot: how many valid same-segment predecessors it has.

    A stable sort groups slots by segment while preserving slot order;
    within each run the exclusive cumsum of the valid flags minus the
    run-start offset is exactly the pairwise rank."""
    order2 = torch.sort(seg, stable=True).indices
    valid2 = valid_sorted[order2].to(torch.int64)
    seg2 = seg[order2]
    excl = torch.cumsum(valid2, dim=0) - valid2
    first = torch.ones_like(seg2, dtype=torch.bool)
    first[1:] = seg2[1:] != seg2[:-1]
    # excl is nondecreasing, so a running max of run-start values always
    # holds the CURRENT run's start offset
    base = torch.cummax(
        torch.where(first, excl, torch.full_like(excl, -1)), dim=0
    ).values
    rank2 = (excl - base).to(torch.int32)
    out = torch.zeros_like(rank2)
    out[order2] = rank2
    return out


def _lexsort(keys):
    """``jnp.lexsort``: the LAST key is the primary one; stable."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in keys:
        order = order[torch.sort(key[order], stable=True).indices]
    return order


class Segments(NamedTuple):
    """Root-cohort membership in CSR form: the rows (heads or queues) of
    segment s are members[offsets[s]:offsets[s+1]], ascending."""

    offsets: torch.Tensor  # int32[S+1]
    members: torch.Tensor  # int32[M]
    max_size: int = 0  # rows in the largest segment

    @property
    def count(self) -> int:
        return self.offsets.shape[0] - 1


def build_segments(seg_id: np.ndarray, device) -> Segments:
    """CSR membership of the root-cohort segments (host-side)."""
    seg_id = np.asarray(seg_id)
    live = np.nonzero(seg_id >= 0)[0]
    n_seg = int(seg_id[live].max()) + 1 if live.size else 0
    members = live[np.argsort(seg_id[live], kind="stable")].astype(np.int32)
    counts = np.bincount(seg_id[live], minlength=n_seg)
    offsets = np.zeros(n_seg + 1, dtype=np.int32)
    np.cumsum(counts, out=offsets[1:])
    return Segments(
        offsets=to_device(offsets, device),
        members=to_device(members, device),
        max_size=int(counts.max()) if n_seg else 0,
    )


# ---- phase 1: kernel cycle_phase1 (csrc/cycle_phase1.cu) ----------------


def phase1_classify_plain(
    tree: QuotaTree,
    subtree: torch.Tensor,
    local_usage: torch.Tensor,
    avail: torch.Tensor,
    potential: torch.Tensor,
    heads: HeadsBatch,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of ``cycle_phase1``: (chosen int32[W],
    borrows bool[W,K], preempt_k int32[W]) from the cycle-start
    availability ``avail`` and ``potential`` (both [N, FR])."""
    cq = heads.cq_row.clamp_min(0).long()
    qty = heads.qty
    # zero-quantity cells never constrain the fit (the host path masks
    # usage > 0 and clamps available() at 0)
    cell_need = (heads.cells >= 0) & (qty > 0)
    idx = (cq[:, None, None], heads.cells.clamp_min(0).long())
    avail_wkc = avail[idx]
    subtree_wkc = subtree[idx]
    local_wkc = local_usage[idx]
    potential_wkc = potential[idx]
    nominal_wkc = tree.nominal[idx]

    fits = torch.where(cell_need, avail_wkc >= qty, True).all(dim=-1)
    # default-policy PREEMPT per cell: request <= potentialAvailable AND
    # request <= nominal
    pot_fits = torch.where(
        cell_need, (qty <= potential_wkc) & (qty <= nominal_wkc), True
    ).all(dim=-1)
    has_cohort = (tree.parent[cq] >= 0)[:, None]
    borrows = (
        torch.where(cell_need, local_wkc + qty > subtree_wkc, False).any(dim=-1)
        & has_cohort
    )

    # masked score-argmax; torch.argmax returns the first maximum, as
    # jnp.argmax does, so all-zero scores give the first fit
    score = heads.score if heads.score is not None else torch.zeros_like(qty[:, :, 0])
    neg = torch.full_like(score, NEG_SCORE)
    populated = heads.cq_row >= 0
    fit_ok = fits & heads.valid
    first_fit = torch.argmax(torch.where(fit_ok, score, neg), dim=1)
    chosen = torch.where(fit_ok.any(dim=1) & populated, first_fit, -1).to(I32)
    pre_ok = pot_fits & heads.valid
    first_pre = torch.argmax(torch.where(pre_ok, score, neg), dim=1)
    preempt_k = torch.where(
        pre_ok.any(dim=1) & populated & (chosen < 0), first_pre, -1
    ).to(I32)
    return chosen, borrows, preempt_k


def phase1_classify(
    tree: QuotaTree,
    subtree: torch.Tensor,
    guaranteed: torch.Tensor,
    local_usage: torch.Tensor,
    heads: HeadsBatch,
    avail: Optional[torch.Tensor] = None,
    potential: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pick each head's first fitting candidate against the cycle-start
    snapshot. Returns (chosen int32[W], borrows bool[W,K], preempt_k
    int32[W]). ``avail`` / ``potential`` are computed (``quota_tree``
    launches) when not given."""
    if avail is None:
        _, avail = usage_and_available(tree, subtree, guaranteed, local_usage)
    if potential is None:
        potential = potential_available_all(tree, subtree, guaranteed)
    if not local_usage.is_cuda:
        return phase1_classify_plain(tree, subtree, local_usage, avail, potential, heads)

    kernel = "cycle_phase1"
    w, k, c = heads.cells.shape
    n, fr = tree.nominal.shape
    if k > MAX_K:
        raise _build.KernelInputError(f"{kernel}: takes K<={MAX_K} candidates, got {k}")
    dev = local_usage.device
    chosen = torch.empty(w, dtype=I32, device=dev)
    borrows = torch.empty((w, k), dtype=BOOL, device=dev)
    preempt_k = torch.empty(w, dtype=I32, device=dev)
    ptr = _build.ptr
    ptrs = [
        ptr(kernel, "cq_row", heads.cq_row, I32, (w,)),
        ptr(kernel, "cells", heads.cells, I32, (w, k, c)),
        ptr(kernel, "qty", heads.qty, I64, (w, k, c)),
        ptr(kernel, "valid", heads.valid, BOOL, (w, k)),
        ptr(kernel, "score", heads.score, I64, (w, k)),
        ptr(kernel, "avail", avail, I64, (n, fr)),
        ptr(kernel, "potential", potential, I64, (n, fr)),
        ptr(kernel, "subtree", subtree, I64, (n, fr)),
        ptr(kernel, "local_usage", local_usage, I64, (n, fr)),
        ptr(kernel, "nominal", tree.nominal, I64, (n, fr)),
        ptr(kernel, "parent", tree.parent, I32, (n,)),
        chosen.data_ptr(),
        borrows.data_ptr(),
        preempt_k.data_ptr(),
    ]
    _call(kernel, [w, k, c, n, fr], ptrs, dev)
    return chosen, borrows, preempt_k


def _call(kernel: str, ints, ptrs, device) -> None:
    """Launch ``kernel`` through its C entry ``(ints, n_ints, ptrs,
    n_ptrs, stream)`` and count the launch."""
    c_ints = (ctypes.c_int * len(ints))(*ints)
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    fn = _build.c_function(
        kernel,
        kernel,
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
    )
    _build.note_launch(kernel)
    rc = fn(
        ctypes.addressof(c_ints), len(ints), ctypes.addressof(c_ptrs), len(ptrs),
        _build.stream_ptr(device),
    )
    _build.check(rc, kernel)


# ---- phase 2: kernel cycle_phase2 (csrc/cycle_phase2.cu) ----------------

# A block's opt-in shared memory on sm_90 (232,448 bytes), less the
# kilobyte cycle_phase2 keeps for its static variables.
PHASE2_SHARED_BYTES = 232448 - 1024
PHASE2_WINDOW = 32  # walked heads a staging window


def segment_bytes(n_walk: int, fr: int, max_depth: int) -> int:
    """Shared-memory bytes cycle_phase2 needs to walk a segment of
    ``n_walk`` walked heads on shared rows: per path entry (head, level)
    a node id, a slot and the subtree, guaranteed, borrowing-limit and
    usage rows of ``fr`` int64 cells. A segment that needs more than its
    block has left (``phase2_layout``'s ``rows_bytes``) walks on the
    device-memory rows; the kernel chooses, block by block."""
    return n_walk * (max_depth + 1) * (8 + 32 * fr)


def _align8(b: int) -> int:
    return (b + 7) & ~7


def phase2_layout(w: int, max_members: int, c: int, fr: int, max_depth: int):
    """cycle_phase2's shared memory a block, as the kernel plans it
    (``plan_layout`` in csrc/cycle_phase2.cu): the sort keys (priority
    and timestamp, 16 B a head, left in device memory when they do not
    fit), two staging windows of ``win`` heads, the ranks and walk order
    (8 B a member), the classes (1 B a head), and ``rows_bytes`` for a
    segment's rows. None when even one-head windows do not fit (the
    kernel refuses the shape)."""

    def window(win):
        return _align8(4 * win * (c + max_depth + 4)) + 24 * win * c

    base = 2 * _align8(4 * max_members) + _align8(w)
    win = PHASE2_WINDOW
    keys = base + 16 * w + 2 * window(win) <= PHASE2_SHARED_BYTES
    if not keys:
        while win > 1 and base + 2 * window(win) > PHASE2_SHARED_BYTES:
            win >>= 1
        if base + 2 * window(win) > PHASE2_SHARED_BYTES:
            return None
    fixed = base + 2 * window(win) + (16 * w if keys else 0)
    need = _align8(segment_bytes(max_members, fr, max_depth))
    rows = min(need, PHASE2_SHARED_BYTES - fixed)
    return {"win": win, "keys": keys, "rows_bytes": rows, "total": fixed + rows}


GLOBAL_BLOCKS = 264  # cycle_global's largest grid: two blocks a multiprocessor
# the layout ints cycle_global takes after its shape (csrc/cycle_global.cu)
GLOBAL_LAYOUT_FIELDS = ("prio", "ts", "stage", "stage_buf", "cls", "mem", "rows",
                        "rows_bytes", "win", "keys", "total")


def global_layout(w: int, c: int, fr: int, max_depth: int, n_bins: int, max_bin: int):
    """cycle_global's grid and shared memory a block (csrc/cycle_global.cu
    takes them as they are): a block per group of consecutive forest bins
    (at most GLOBAL_BLOCKS groups); per block the classes (1 B a head),
    two staging windows of ``win`` heads, the member lists (12 B a head
    and two words a 32 heads), the sort keys (priority and timestamp, 16
    B a head, left in device memory when they do not fit) and
    ``rows_bytes`` for a group's subtree, guaranteed, borrowing-limit and
    usage rows (a group whose rows need more walks on the device-memory
    rows). Where the classes, member lists and one-head windows do not
    fit (W beyond ~17,000 heads), ``keys`` is 2: the classes and member
    lists go to a device scratch of ``scratch`` ints
    (``global_scratch_ints``) and the windows and rows take the block's
    shared memory. ``scratch`` is 0 otherwise."""

    def window(win):
        return _align8(4 * win * (c + max_depth + 4)) + 24 * win * c

    grid = max(1, min(n_bins, GLOBAL_BLOCKS))
    base = _align8(w) + _align8(4 * (3 * w + 2 * ((w + 31) // 32)))  # classes, members
    if base + 2 * window(1) > PHASE2_SHARED_BYTES:
        return _global_layout_wide(w, window, grid, n_bins, max_bin, fr)
    win = PHASE2_WINDOW
    while win > 1 and base + 2 * window(win) > PHASE2_SHARED_BYTES:
        win >>= 1
    keys = base + 2 * window(win) + 16 * w <= PHASE2_SHARED_BYTES
    off, at = {}, 0
    for name, size in (("prio", 8 * w if keys else 0), ("ts", 8 * w if keys else 0),
                       ("stage", 2 * window(win)), ("cls", _align8(w)),
                       ("mem", base - _align8(w))):
        off[name] = at
        at += size
    need = -(-n_bins // grid) * max_bin * fr * 32
    rows = min(need, PHASE2_SHARED_BYTES - at)
    return {**off, "grid": grid, "stage_buf": window(win), "rows": at, "rows_bytes": rows,
            "win": win, "keys": int(keys), "total": at + rows, "scratch": 0}


def global_scratch_ints(w: int, grid: int) -> int:
    """The wide layout's device scratch (csrc/cycle_global.cu): the
    member-list counter, the lists (3 ints a head), each block's position
    bits and their prefix (2 words a 32 heads), the classes (1 B a
    head)."""
    return 1 + 3 * w + grid * 2 * -(-w // 32) + -(-w // 4)


def _global_layout_wide(w, window, grid, n_bins, max_bin, fr):
    """global_layout where the classes and member lists of W heads do not
    fit a block: only the windows and rows are in shared memory."""
    win = PHASE2_WINDOW
    while win > 1 and 2 * window(win) > PHASE2_SHARED_BYTES:
        win >>= 1
    at = 2 * window(win)
    need = -(-n_bins // grid) * max_bin * fr * 32
    rows = min(need, PHASE2_SHARED_BYTES - at)
    return {"prio": 0, "ts": 0, "stage": 0, "cls": at, "mem": at, "grid": grid,
            "stage_buf": window(win), "rows": at, "rows_bytes": rows, "win": win, "keys": 2,
            "total": at + rows, "scratch": global_scratch_ints(w, grid)}


def _bubble_usage(
    path: torch.Tensor,  # int32[B, D+1]
    cells: torch.Tensor,  # int32[B, C]
    delta: torch.Tensor,  # int64[B, C], already masked by cell validity
    usage: torch.Tensor,  # int64[N, FR], updated in place
    guaranteed: torch.Tensor,
    max_depth: int,
) -> None:
    """addUsage bubble-up (resource_node.go:123-144) for B paths at
    once: add ``delta`` at each leaf, then each node's over-guaranteed
    delta to its parent. Every gather of a level happens before its
    scatter-add, as in the JAX ``.at[].add``."""
    ccells = cells.clamp_min(0).long()
    for d in range(0, max_depth + 1):
        node = path[:, d].clamp_min(0).long()[:, None].expand_as(ccells)
        node_valid = (path[:, d] >= 0)[:, None]
        old = usage[node, ccells]
        g = guaranteed[node, ccells]
        new = old + delta
        usage.index_put_((node, ccells), torch.where(node_valid, delta, 0), accumulate=True)
        over_old = (old - g).clamp_min(0)
        over_new = (new - g).clamp_min(0)
        delta = torch.where(node_valid, over_new - over_old, delta)


def cycle_phase2_plain(
    tree: QuotaTree,
    subtree: torch.Tensor,
    guaranteed: torch.Tensor,
    usage: torch.Tensor,  # int64[N, FR] the cycle usage tree, mutated
    paths: torch.Tensor,
    heads: HeadsBatch,
    seg_id: torch.Tensor,  # int32[W] compact root-cohort id, -1 pad
    n_segments: int,
    n_steps: int,
    chosen: torch.Tensor,
    borrows_wk: torch.Tensor,
    preempt_k: torch.Tensor,
) -> torch.Tensor:
    """The plain version of ``cycle_phase2``: entry order, segmented
    rank and the step scan of the JAX ``solve_cycle_segmented``.
    Returns the packed int64[5, W] outcome (chosen, admitted, borrows,
    reserved, order); ``usage`` ends as the cycle's final usage tree."""
    max_depth = tree.max_depth
    w, k, c = heads.cells.shape
    dev = usage.device
    eff_k = torch.where(chosen >= 0, chosen, preempt_k)
    eff_safe = eff_k.clamp_min(0).long()
    rows = torch.arange(w, device=dev)
    head_borrow = borrows_wk[rows, eff_safe] & (eff_k >= 0)
    nofit = eff_k < 0
    order = _lexsort(
        (heads.timestamp, -heads.priority, head_borrow.to(I64), nofit.to(I64))
    )

    seg = seg_id.clamp_min(0)[order]
    valid_sorted = (heads.cq_row[order] >= 0) & (seg_id[order] >= 0) & ~nofit[order]
    rank = segmented_rank(seg, valid_sorted)
    # ranks >= n_steps (and segments >= n_segments) drop, as the JAX
    # mode="drop" scatter drops them
    keep = valid_sorted & (rank < n_steps) & (seg < n_segments)
    mat = torch.full((n_steps, n_segments), -1, dtype=I32, device=dev)
    mat[rank[keep].long(), seg[keep].long()] = order[keep].to(I32)

    cells_eff = heads.cells[rows, eff_safe]  # [W, C]
    qty_eff = heads.qty[rows, eff_safe]
    cq = heads.cq_row.clamp_min(0).long()
    admitted = torch.zeros(w, dtype=BOOL, device=dev)
    reserved = torch.zeros(w, dtype=BOOL, device=dev)
    for s in range(n_steps):
        idx = mat[s]
        active = idx >= 0
        if not bool(active.any()):
            continue
        hidx = idx[active].long()
        cqs = cq[hidx]
        path = paths[cqs]
        cells_ = cells_eff[hidx]
        qty_ = qty_eff[hidx]
        ccells = cells_.clamp_min(0).long()
        cell_valid = (cells_ >= 0) & (qty_ > 0)

        avail = _avail_along_path(
            path, cells_, usage, subtree, guaranteed, tree.borrowing_limit, max_depth
        )
        fits = torch.where(cell_valid, avail >= qty_, True).all(dim=1)
        admit = (chosen[hidx] >= 0) & fits
        # blocked preempt-mode head: reserve capacity so later entries
        # cannot take it (resourcesToReserve, scheduler.go:391-416)
        reserve = (chosen[hidx] < 0) & (preempt_k[hidx] >= 0) & heads.no_reclaim[hidx]
        nominal_c = tree.nominal[cqs[:, None], ccells]
        bl_c = tree.borrowing_limit[cqs[:, None], ccells]
        leaf_c = usage[cqs[:, None], ccells]
        borrow_cap = torch.where(
            bl_c < NO_LIMIT, torch.minimum(qty_, nominal_c + bl_c - leaf_c), qty_
        )
        nominal_cap = torch.minimum(qty_, nominal_c - leaf_c).clamp_min(0)
        reserve_qty = torch.where(head_borrow[hidx][:, None], borrow_cap, nominal_cap)
        delta = torch.where(
            cell_valid & admit[:, None],
            qty_,
            torch.where(cell_valid & reserve[:, None], reserve_qty, 0),
        )
        _bubble_usage(path, cells_, delta, usage, guaranteed, max_depth)
        admitted[hidx] = admit
        reserved[hidx] = reserve

    return torch.stack(
        [
            chosen.to(I64),
            admitted.to(I64),
            head_borrow.to(I64),
            reserved.to(I64),
            order.to(I64),
        ]
    )


def cycle_phase2(
    tree: QuotaTree,
    subtree: torch.Tensor,
    guaranteed: torch.Tensor,
    usage: torch.Tensor,
    paths: torch.Tensor,
    heads: HeadsBatch,
    seg_id: torch.Tensor,
    segments: Segments,
    n_segments: int,
    n_steps: int,
    chosen: torch.Tensor,
    borrows_wk: torch.Tensor,
    preempt_k: torch.Tensor,
) -> torch.Tensor:
    """Phase 2 of the cycle: the packed int64[5, W] outcome. ``usage``
    (the cycle usage tree, never the resident leaf buffer) is updated
    in place by the admissions and reservations. ``segments`` is the
    CSR of ``seg_id`` (``build_segments``), which the kernel walks, a
    block a segment: on shared-memory rows where ``segment_bytes`` of
    its walk fit ``phase2_layout``'s ``rows_bytes``, else on the
    device-memory rows."""
    if not usage.is_cuda:
        return cycle_phase2_plain(
            tree, subtree, guaranteed, usage, paths, heads, seg_id,
            n_segments, n_steps, chosen, borrows_wk, preempt_k,
        )
    kernel = "cycle_phase2"
    w, k, c = heads.cells.shape
    n, fr = tree.nominal.shape
    d = tree.max_depth
    if c > MAX_C:
        raise _build.KernelInputError(f"{kernel}: takes C<={MAX_C} cells, got {c}")
    n_seg = segments.count
    packed = torch.empty((5, w), dtype=I64, device=usage.device)
    ptr = _build.ptr
    ptrs = [
        ptr(kernel, "cq_row", heads.cq_row, I32, (w,)),
        ptr(kernel, "cells", heads.cells, I32, (w, k, c)),
        ptr(kernel, "qty", heads.qty, I64, (w, k, c)),
        ptr(kernel, "priority", heads.priority, I64, (w,)),
        ptr(kernel, "timestamp", heads.timestamp, I64, (w,)),
        ptr(kernel, "no_reclaim", heads.no_reclaim, BOOL, (w,)),
        ptr(kernel, "chosen", chosen, I32, (w,)),
        ptr(kernel, "borrows", borrows_wk, BOOL, (w, k)),
        ptr(kernel, "preempt_k", preempt_k, I32, (w,)),
        ptr(kernel, "seg_id", seg_id, I32, (w,)),
        ptr(kernel, "seg_offsets", segments.offsets, I32, (n_seg + 1,)),
        ptr(kernel, "seg_members", segments.members, I32, None),
        ptr(kernel, "nominal", tree.nominal, I64, (n, fr)),
        ptr(kernel, "borrowing_limit", tree.borrowing_limit, I64, (n, fr)),
        ptr(kernel, "subtree", subtree, I64, (n, fr)),
        ptr(kernel, "guaranteed", guaranteed, I64, (n, fr)),
        ptr(kernel, "paths", paths, I32, (n, d + 1)),
        ptr(kernel, "usage", usage, I64, (n, fr)),
        packed.data_ptr(),
    ]
    ints = [w, k, c, n, fr, d, n_segments, n_steps, n_seg, segments.max_size]
    _call(kernel, ints, ptrs, usage.device)
    return packed


# ---- the whole cycle ----------------------------------------------------


def _as_seg_id(seg_id, device) -> Tuple[torch.Tensor, Segments]:
    seg_np = seg_id.cpu().numpy() if isinstance(seg_id, torch.Tensor) else np.asarray(seg_id)
    return (
        torch.as_tensor(seg_np.astype(np.int32), device=device),
        build_segments(seg_np, device),
    )


def _solve(tree, local_usage, heads, paths, seg_id, n_segments, n_steps):
    subtree, guaranteed, usage, avail, potential = quota_all(tree, local_usage)
    chosen, borrows_wk, preempt_k = phase1_classify(
        tree, subtree, guaranteed, local_usage, heads, avail, potential
    )
    seg_t, segments = _as_seg_id(seg_id, local_usage.device)
    # phase 2 mutates the cycle usage tree built above, never the
    # caller's leaf usage (the resident buffer of ResidentCycleState)
    packed = cycle_phase2(
        tree, subtree, guaranteed, usage, paths, heads, seg_t, segments,
        n_segments, n_steps, chosen, borrows_wk, preempt_k,
    )
    return packed, usage


def solve_cycle_segmented(
    tree: QuotaTree,
    local_usage: torch.Tensor,
    heads: HeadsBatch,
    paths: torch.Tensor,  # int32[N, D+1]
    seg_id,  # int32[W] compact root-cohort id per head (-1 pad)
    n_segments: int,
    n_steps: int,
) -> SolveResult:
    """One admission cycle with independent root cohorts resolved in
    parallel (the JAX ``solve_cycle_segmented``): heads of different
    roots touch disjoint node rows, so only heads within one root
    serialize, in the global entry order."""
    packed, usage = _solve(tree, local_usage, heads, paths, seg_id, n_segments, n_steps)
    return SolveResult(
        chosen=packed[0].to(I32),
        admitted=packed[1].to(BOOL),
        borrows=packed[2].to(BOOL),
        reserved=packed[3].to(BOOL),
        usage=usage,
        order=packed[4].to(I32),
    )


def solve_cycle_segmented_packed(
    tree, local_usage, heads, paths, seg_id, n_segments: int, n_steps: int
) -> torch.Tensor:
    """solve_cycle_segmented with the per-head outputs stacked into ONE
    int64[5, W] tensor (chosen, admitted, borrows, reserved, order), so
    the host retrieves the whole cycle outcome in a single copy."""
    return _solve(tree, local_usage, heads, paths, seg_id, n_segments, n_steps)[0]


# ---- the unsegmented cycle: kernel B3' cycle_global (csrc/cycle_global.cu)


def cycle_global_plain(
    tree: QuotaTree,
    subtree: torch.Tensor,
    guaranteed: torch.Tensor,
    usage: torch.Tensor,  # int64[N, FR] the cycle usage tree, mutated
    paths: torch.Tensor,
    heads: HeadsBatch,
    chosen: torch.Tensor,
    borrows_wk: torch.Tensor,
    preempt_k: torch.Tensor,
) -> torch.Tensor:
    """The plain version of ``cycle_global``: the entry order and the
    lax.scan step loop of the JAX ``solve_cycle``, one head a step over
    all W heads in that order. Returns the packed int64[5, W] outcome
    (chosen, admitted, borrows, reserved, order); ``usage`` ends as the
    cycle's final usage tree."""
    max_depth = tree.max_depth
    w = heads.cq_row.shape[0]
    dev = usage.device
    # effective candidate: the fit choice, else the preempt-mode
    # representative, so that a preempt-mode head's reservation blocks
    # later borrowers (scheduler.go:228-242)
    eff_k = torch.where(chosen >= 0, chosen, preempt_k)
    eff_safe = eff_k.clamp_min(0).long()
    rows = torch.arange(w, device=dev)
    head_borrow = borrows_wk[rows, eff_safe] & (eff_k >= 0)
    # entry order: (borrowing asc, priority desc, timestamp asc); padded
    # or hopeless (NoFit-everywhere) heads sink to the end
    nofit = eff_k < 0
    order = _lexsort(
        (heads.timestamp, -heads.priority, head_borrow.to(I64), nofit.to(I64))
    )
    cells_eff = heads.cells[rows, eff_safe]  # [W, C]
    qty_eff = heads.qty[rows, eff_safe]
    cq = heads.cq_row
    cqs = cq.clamp_min(0).long()
    may_admit = (cq >= 0) & (chosen >= 0)
    # blocked preempt-mode head: reserve capacity so later entries cannot
    # take it (resourcesToReserve, scheduler.go:391-416)
    reserve = (cq >= 0) & (chosen < 0) & (preempt_k >= 0) & heads.no_reclaim
    admitted = torch.zeros(w, dtype=BOOL, device=dev)
    for s in range(w):
        wi = order[s : s + 1]
        path = paths[cqs[wi]]  # [1, D+1]
        cells_ = cells_eff[wi]  # [1, C]
        qty_ = qty_eff[wi]
        cell_valid = (cells_ >= 0) & (qty_ > 0)
        avail = _avail_along_path(
            path, cells_, usage, subtree, guaranteed, tree.borrowing_limit, max_depth
        )
        fits = torch.where(cell_valid, avail >= qty_, True).all(dim=1)
        admit = may_admit[wi] & fits
        _bubble_usage(
            path, cells_, torch.where(cell_valid & admit[:, None], qty_, 0), usage,
            guaranteed, max_depth,
        )
        # the reservation's caps from the leaf row after this step's admit
        leaf = cqs[wi][:, None]
        ccells = cells_.clamp_min(0).long()
        nominal_c = tree.nominal[leaf, ccells]
        bl_c = tree.borrowing_limit[leaf, ccells]
        leaf_c = usage[leaf, ccells]
        borrow_cap = torch.where(
            bl_c < NO_LIMIT, torch.minimum(qty_, nominal_c + bl_c - leaf_c), qty_
        )
        nominal_cap = torch.minimum(qty_, nominal_c - leaf_c).clamp_min(0)
        reserve_qty = torch.where(head_borrow[wi][:, None], borrow_cap, nominal_cap)
        _bubble_usage(
            path, cells_, torch.where(cell_valid & reserve[wi][:, None], reserve_qty, 0),
            usage, guaranteed, max_depth,
        )
        admitted[wi] = admit
    return torch.stack(
        [chosen.to(I64), admitted.to(I64), head_borrow.to(I64), reserve.to(I64),
         order.to(I64)]
    )


def cycle_global(
    tree: QuotaTree,
    subtree: torch.Tensor,
    guaranteed: torch.Tensor,
    usage: torch.Tensor,
    paths: torch.Tensor,
    heads: HeadsBatch,
    chosen: torch.Tensor,
    borrows_wk: torch.Tensor,
    preempt_k: torch.Tensor,
    packed: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Phase 2 of the unsegmented cycle: the packed int64[5, W] outcome
    (into ``packed`` when given). ``usage`` (the cycle usage tree) is
    updated in place by the admissions and reservations. On the card a
    block walks each group of whole root subtrees of the tree's forest
    (``tree_forest``: quota_tree's bins), on its rows in shared memory
    where they fit and on the device-memory rows where they do not; past
    ~17,000 heads its classes and member lists are in a device scratch
    (``global_layout``'s wide layout)."""
    if not usage.is_cuda:
        res = cycle_global_plain(
            tree, subtree, guaranteed, usage, paths, heads, chosen, borrows_wk, preempt_k
        )
        if packed is None:
            return res
        packed.copy_(res)
        return packed
    kernel = "cycle_global"
    w, k, c = heads.cells.shape
    n, fr = tree.nominal.shape
    d = tree.max_depth
    if c > MAX_C:
        raise _build.KernelInputError(f"{kernel}: takes C<={MAX_C} cells, got {c}")
    forest = tree_forest(tree)
    n_bins = forest.bins.shape[0]
    lay = global_layout(w, c, fr, d, n_bins, forest.max_bin)
    scratch = None
    if lay["scratch"]:
        scratch = torch.empty(lay["scratch"], dtype=I32, device=usage.device)
    if packed is None:
        packed = torch.empty((5, w), dtype=I64, device=usage.device)
    ptr = _build.ptr
    ptrs = [
        ptr(kernel, "cq_row", heads.cq_row, I32, (w,)),
        ptr(kernel, "cells", heads.cells, I32, (w, k, c)),
        ptr(kernel, "qty", heads.qty, I64, (w, k, c)),
        ptr(kernel, "priority", heads.priority, I64, (w,)),
        ptr(kernel, "timestamp", heads.timestamp, I64, (w,)),
        ptr(kernel, "no_reclaim", heads.no_reclaim, BOOL, (w,)),
        ptr(kernel, "chosen", chosen, I32, (w,)),
        ptr(kernel, "borrows", borrows_wk, BOOL, (w, k)),
        ptr(kernel, "preempt_k", preempt_k, I32, (w,)),
        ptr(kernel, "nominal", tree.nominal, I64, (n, fr)),
        ptr(kernel, "borrowing_limit", tree.borrowing_limit, I64, (n, fr)),
        ptr(kernel, "subtree", subtree, I64, (n, fr)),
        ptr(kernel, "guaranteed", guaranteed, I64, (n, fr)),
        ptr(kernel, "paths", paths, I32, (n, d + 1)),
        ptr(kernel, "pos", forest.pos, I32, (n,)),
        ptr(kernel, "meta", forest.meta, I32, (n, 4)),
        ptr(kernel, "bins", forest.bins, I32, (n_bins, forest.depth + 2)),
        ptr(kernel, "usage", usage, I64, (n, fr)),
        ptr(kernel, "packed", packed, I64, (5, w)),
        ptr(kernel, "scratch", scratch, I32, None),
    ]
    ints = [w, k, c, n, fr, d, n_bins, forest.depth + 2, lay["grid"]] + [
        int(lay[f]) for f in GLOBAL_LAYOUT_FIELDS]
    _call(kernel, ints, ptrs, usage.device)
    return packed


def _unpack(packed: torch.Tensor, usage) -> SolveResult:
    return SolveResult(
        chosen=packed[0].to(I32),
        admitted=packed[1].to(BOOL),
        borrows=packed[2].to(BOOL),
        reserved=packed[3].to(BOOL),
        usage=usage,
        order=packed[4].to(I32),
    )


def _solve_global(tree, local_usage, heads, paths, packed=None, usage_out=None):
    subtree, guaranteed, usage, avail, potential = quota_all(
        tree, local_usage, out_usage=usage_out
    )
    chosen, borrows_wk, preempt_k = phase1_classify(
        tree, subtree, guaranteed, local_usage, heads, avail, potential
    )
    packed = cycle_global(
        tree, subtree, guaranteed, usage, paths, heads, chosen, borrows_wk, preempt_k,
        packed=packed,
    )
    return packed, usage


def solve_cycle_plain(
    tree: QuotaTree, local_usage: torch.Tensor, heads: HeadsBatch, paths: torch.Tensor
) -> SolveResult:
    """The JAX ``solve_cycle`` written out in plain torch: the quota
    recurrences, phase 1 (``phase1_classify_plain``), the global
    lexsort and one step a head. The reference of ``solve_cycle`` on
    any device."""
    subtree, guaranteed, usage, avail, potential = quota_all_plain(tree, local_usage)
    chosen, borrows_wk, preempt_k = phase1_classify_plain(
        tree, subtree, local_usage, avail, potential, heads
    )
    packed = cycle_global_plain(
        tree, subtree, guaranteed, usage, paths, heads, chosen, borrows_wk, preempt_k
    )
    return _unpack(packed, usage)


def solve_cycle(
    tree: QuotaTree, local_usage: torch.Tensor, heads: HeadsBatch, paths: torch.Tensor
) -> SolveResult:
    """One full admission cycle with one global scan (the JAX
    ``solve_cycle``): phase 1 picks flavors for all heads in parallel;
    phase 2 re-checks and admits in the reference's entry order —
    non-borrowing first, then priority desc, then queue timestamp
    (scheduler.go:575-599) — against incrementally updated
    availability. On the card: ``quota_tree``, ``cycle_phase1`` and
    ``cycle_global``; decisions equal ``solve_cycle_segmented``'s."""
    packed, usage = _solve_global(tree, local_usage, heads, paths)
    return _unpack(packed, usage)


def solve_cycle_packed(
    tree: QuotaTree, local_usage: torch.Tensor, heads: HeadsBatch, paths: torch.Tensor
) -> torch.Tensor:
    """solve_cycle with its outcome in ONE int64 buffer: the [5, W] rows
    (chosen, admitted, borrows, reserved, order) flattened, then the
    [N, FR] usage tree, so the host fetches the cycle in one copy
    (``unpack_cycle`` splits it)."""
    w = heads.cq_row.shape[0]
    n, fr = tree.nominal.shape
    buf = torch.empty(5 * w + n * fr, dtype=I64, device=local_usage.device)
    _solve_global(
        tree, local_usage, heads, paths, packed=buf[: 5 * w].view(5, w),
        usage_out=buf[5 * w:].view(n, fr),
    )
    return buf


def unpack_cycle(buf, w: int, n: int, fr: int) -> SolveResult:
    """The SolveResult of a ``solve_cycle_packed`` buffer (a tensor or
    a numpy array)."""
    packed = torch.as_tensor(buf[: 5 * w]).reshape(5, w)
    return _unpack(packed, torch.as_tensor(buf[5 * w:]).reshape(n, fr))
