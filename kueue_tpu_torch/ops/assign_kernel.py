"""Batched admission solver pieces (port of kueue_tpu/ops/assign_kernel.py).

This slice carries what the plain bulk drain uses:

- ``build_paths`` / ``build_roots``: host-side (numpy) ancestor paths
  and root cohorts of the node forest;
- plain torch versions of ``cell_masks`` (phase-1 per-cell
  classification), ``_avail_along_path`` (available() along one
  ancestor path, batched) and ``segmented_rank``. The drain's plain
  version calls them; on the card the drain kernels compute the same
  values inside ``csrc/drain_nominate.cu`` and ``csrc/drain_phase2.cu``.

The interactive cycle solver (``phase1_classify``, ``solve_cycle*``)
belongs to the cycle path and is not ported yet.

Shapes: N nodes (CQs then cohorts), FR flavor-resource cells, W heads,
K flavor candidates per head, C requested cells per candidate, D max
tree depth.
"""

from __future__ import annotations

import numpy as np

from kueue_tpu_torch._torch import torch
from kueue_tpu_torch.ops.quota import (
    NO_LIMIT,
    QuotaTree,
    available_all,
    potential_available_all,
    usage_tree,
)


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
            usage = usage_tree(tree, guaranteed, local_usage)
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
