"""Tensorized cohort quota math (port of kueue_tpu/ops/quota.py).

The reference's recursive quota functions (pkg/cache/resource_node.go)
as level-scheduled passes over a dense node array:

- ``subtree_quota``           <- updateCohortResourceNode (:157-193)
- ``usage_tree``              <- the Usage invariant of addUsage /
                                 removeUsage (:123-144), recomputed
                                 bottom-up from leaf usage
- ``available_all``           <- available() (:89-104), top-down
- ``potential_available_all`` <- potentialAvailable() (:108-119)

Layout: N nodes (ClusterQueues first, then cohorts), FR dense (flavor,
resource) cells, all quantities int64.

Each function is a wrapper over kernel 1, ``quota_tree``
(``csrc/quota_tree.cu``): on a CUDA tensor it launches the kernel (or
raises), on a CPU tensor it runs the plain torch version beside it
(``*_plain``). The wrappers take an optional ``out`` buffer and an
optional ``done`` flag (int32[1] on the same device): when the flag is
set the call does nothing, which lets the drain's host loop enqueue a
few cycles ahead of its termination check.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

from kueue_tpu_torch._torch import BOOL, I32, I64, torch
from kueue_tpu_torch.ops import _build

# Sentinel for "no limit" (nil BorrowingLimit/LendingLimit). Large but
# safe against int64 overflow when added to real quantities.
NO_LIMIT = 1 << 60

# Matches the reference returning math.MaxInt for weight==0 && borrowing.
DRS_MAX = (1 << 63) - 1

KERNEL = "quota_tree"


@dataclass
class QuotaTree:
    """Static-structure view of the cohort forest + quota tensors.

    parent: int32[N] — parent node index, -1 for roots.
    level_mask: bool[D+1, N] — nodes at each depth.
    nominal: int64[N, FR]
    lending_limit / borrowing_limit: int64[N, FR], NO_LIMIT when unset.
    """

    parent: torch.Tensor
    level_mask: torch.Tensor
    nominal: torch.Tensor
    lending_limit: torch.Tensor
    borrowing_limit: torch.Tensor

    @property
    def n_nodes(self) -> int:
        return self.parent.shape[0]

    @property
    def max_depth(self) -> int:
        return self.level_mask.shape[0] - 1

    @property
    def device(self) -> torch.device:
        return self.nominal.device


# ---- plain torch versions (CPU path; the kernel's reference on the card)


def _guaranteed(subtree: torch.Tensor, lending_limit: torch.Tensor) -> torch.Tensor:
    """guaranteedQuota (resource_node.go:63-68): max(0, SubtreeQuota -
    lendingLimit) when a lending limit is set, else 0."""
    has_lending = lending_limit < NO_LIMIT
    return torch.where(
        has_lending, (subtree - lending_limit).clamp_min(0), torch.zeros_like(subtree)
    )


def _parent_index(tree: QuotaTree) -> torch.Tensor:
    """parent rows with roots mapped to row 0 (masked by callers)."""
    return tree.parent.clamp_min(0).long()


def _segment_to_parent(tree: QuotaTree, contrib: torch.Tensor) -> torch.Tensor:
    """Scatter-add per-node contributions into their parent rows."""
    n = tree.parent.shape[0]
    seg = torch.where(tree.parent >= 0, tree.parent, n).long()
    out = torch.zeros((n + 1,) + contrib.shape[1:], dtype=contrib.dtype, device=contrib.device)
    out.index_add_(0, seg, contrib)
    return out[:n]


def subtree_quota_plain(tree: QuotaTree) -> Tuple[torch.Tensor, torch.Tensor]:
    subtree = tree.nominal.clone()
    for d in range(tree.max_depth, 0, -1):
        mask = tree.level_mask[d][:, None]
        contrib = torch.where(
            mask, subtree - _guaranteed(subtree, tree.lending_limit), 0
        )
        subtree = subtree + _segment_to_parent(tree, contrib)
    return subtree, _guaranteed(subtree, tree.lending_limit)


def usage_tree_plain(
    tree: QuotaTree, guaranteed: torch.Tensor, local_usage: torch.Tensor
) -> torch.Tensor:
    usage = local_usage.clone()
    for d in range(tree.max_depth, 0, -1):
        mask = tree.level_mask[d][:, None]
        contrib = torch.where(mask, (usage - guaranteed).clamp_min(0), 0)
        usage = usage + _segment_to_parent(tree, contrib)
    return usage


def available_all_plain(
    tree: QuotaTree,
    subtree: torch.Tensor,
    guaranteed: torch.Tensor,
    usage: torch.Tensor,
) -> torch.Tensor:
    avail = subtree - usage  # correct for roots; overwritten below otherwise
    has_borrow = tree.borrowing_limit < NO_LIMIT
    pidx = _parent_index(tree)
    stored_in_parent = subtree - guaranteed
    used_in_parent = (usage - guaranteed).clamp_min(0)
    with_max = stored_in_parent - used_in_parent + tree.borrowing_limit
    local = (guaranteed - usage).clamp_min(0)
    for d in range(1, tree.max_depth + 1):
        mask = tree.level_mask[d][:, None]
        parent_avail = avail[pidx]
        clamped = torch.where(
            has_borrow, torch.minimum(with_max, parent_avail), parent_avail
        )
        avail = torch.where(mask, local + clamped, avail)
    return avail


def potential_available_all_plain(
    tree: QuotaTree, subtree: torch.Tensor, guaranteed: torch.Tensor
) -> torch.Tensor:
    pot = subtree.clone()
    has_borrow = tree.borrowing_limit < NO_LIMIT
    pidx = _parent_index(tree)
    capped = subtree + tree.borrowing_limit
    for d in range(1, tree.max_depth + 1):
        mask = tree.level_mask[d][:, None]
        v = guaranteed + pot[pidx]
        v = torch.where(has_borrow, torch.minimum(capped, v), v)
        pot = torch.where(mask, v, pot)
    return pot


# ---- kernel 1: quota_tree (csrc/quota_tree.cu)

def _launch(which: str, mode: int, tree: QuotaTree, named, done) -> None:
    """Launch ``which`` over [N, FR] tensors ``named`` ((name, tensor)
    pairs in C argument order; a None tensor is passed as NULL)."""
    n, fr = tree.nominal.shape
    ptrs = [_build.ptr(KERNEL, name, t, I64, (n, fr)) for name, t in named]
    args = [
        mode,
        _build.ptr(KERNEL, "parent", tree.parent, I32, (n,)),
        _build.ptr(KERNEL, "level_mask", tree.level_mask, BOOL, (tree.max_depth + 1, n)),
        n,
        fr,
        tree.max_depth,
        *ptrs,
        _build.ptr(KERNEL, "done", done, I32, (1,)),
        _build.stream_ptr(tree.nominal.device),
    ]
    # (mode, parent, level_mask, n, fr, max_depth, tensors..., done, stream)
    fn = _build.c_function(
        KERNEL,
        which,
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        + [ctypes.c_int] * 3
        + [ctypes.c_void_p] * (len(ptrs) + 2),
    )
    _build.note_launch(KERNEL)
    _build.check(fn(*args), KERNEL)


def _skip(done: Optional[torch.Tensor]) -> bool:
    """Plain-path honour of the done flag (a host read on the CPU)."""
    return done is not None and bool(done.item())


# ---- public wrappers


def subtree_quota(tree: QuotaTree) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bottom-up SubtreeQuota and guaranteedQuota for every node.

    SubtreeQuota(node) = nominal + sum_children (child.SubtreeQuota -
    child.guaranteedQuota) — resource_node.go:186-189."""
    if not tree.nominal.is_cuda:
        return subtree_quota_plain(tree)
    subtree = torch.empty_like(tree.nominal)
    guaranteed = torch.empty_like(tree.nominal)
    _launch(
        "quota_bottom_up", 0, tree,
        [("nominal", tree.nominal), ("lending_limit", tree.lending_limit),
         ("subtree", subtree), ("guaranteed", guaranteed)],
        None,
    )
    return subtree, guaranteed


def usage_tree(
    tree: QuotaTree,
    guaranteed: torch.Tensor,
    local_usage: torch.Tensor,
    out: Optional[torch.Tensor] = None,
    done: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Bottom-up Usage for every node from leaf (ClusterQueue) usage:
    cohort usage = sum_children max(0, child.Usage - child.guaranteed)
    (resource_node.go:190-192)."""
    if not local_usage.is_cuda:
        if _skip(done):
            return out
        res = usage_tree_plain(tree, guaranteed, local_usage)
        if out is None:
            return res
        out.copy_(res)
        return out
    if out is None:
        out = torch.empty_like(local_usage)
    _launch(
        "quota_bottom_up", 1, tree,
        [("local_usage", local_usage), ("guaranteed", guaranteed),
         ("out", out), ("unused", None)],
        done,
    )
    return out


def available_all(
    tree: QuotaTree,
    subtree: torch.Tensor,
    guaranteed: torch.Tensor,
    usage: torch.Tensor,
    out: Optional[torch.Tensor] = None,
    done: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """available() for every node, top-down (resource_node.go:89-104).

    Root: SubtreeQuota - Usage. Non-root: max(0, guaranteed - usage) +
    parentAvailable, clamped by the borrowing limit via storedInParent
    - usedInParent + borrowingLimit."""
    if not usage.is_cuda:
        if _skip(done):
            return out
        res = available_all_plain(tree, subtree, guaranteed, usage)
        if out is None:
            return res
        out.copy_(res)
        return out
    if out is None:
        out = torch.empty_like(usage)
    _launch(
        "quota_top_down", 0, tree,
        [("subtree", subtree), ("guaranteed", guaranteed),
         ("borrowing_limit", tree.borrowing_limit), ("usage", usage),
         ("out", out)],
        done,
    )
    return out


def potential_available_all(
    tree: QuotaTree, subtree: torch.Tensor, guaranteed: torch.Tensor
) -> torch.Tensor:
    """potentialAvailable() for every node (resource_node.go:108-119):
    the maximum capacity assuming zero usage, respecting borrowing
    limits."""
    if not subtree.is_cuda:
        return potential_available_all_plain(tree, subtree, guaranteed)
    out = torch.empty_like(subtree)
    _launch(
        "quota_top_down", 1, tree,
        [("subtree", subtree), ("guaranteed", guaranteed),
         ("borrowing_limit", tree.borrowing_limit), ("usage", None),
         ("out", out)],
        None,
    )
    return out
