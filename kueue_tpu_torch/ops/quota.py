"""Tensorized cohort quota math (port of kueue_tpu/ops/quota.py).

The reference's recursive quota functions (pkg/cache/resource_node.go)
as level-scheduled passes over a dense node array:

- ``subtree_quota``           <- updateCohortResourceNode (:157-193)
- ``usage_tree``              <- the Usage invariant of addUsage /
                                 removeUsage (:123-144), recomputed
                                 bottom-up from leaf usage
- ``available_all``           <- available() (:89-104), top-down
- ``potential_available_all`` <- potentialAvailable() (:108-119)
- ``lendable_per_resource``   <- calculateLendable (fair_sharing.go:90-104)
- ``dominant_resource_share`` <- DominantResourceShare (:49-86)

Layout: N nodes (ClusterQueues first, then cohorts), FR dense (flavor,
resource) cells, all quantities int64.

The first four are wrappers over kernel 1, ``quota_tree``
(``csrc/quota_tree.cu``), the last two over kernel B1', ``quota_drs``
(``csrc/quota_drs.cu``): on a CUDA tensor a wrapper launches its kernel
(or raises), on a CPU tensor it runs the plain torch version beside it
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


# ---- kernel B1': quota_drs (csrc/quota_drs.cu) ---------------------------
#
# The fair-sharing reductions over the quota tree: calculateLendable
# (fair_sharing.go:90-104) and DominantResourceShare (:49-86). Two C
# entries, quota_lendable and quota_drs, under the one launch counter
# ``quota_drs``.

DRS_KERNEL = "quota_drs"


def _per_resource(x: torch.Tensor, resource_index: torch.Tensor, n_resources: int):
    """Sum the [N, FR] cells of ``x`` per resource: int64[N, R]."""
    out = torch.zeros((x.shape[0], n_resources), dtype=I64, device=x.device)
    out.index_add_(1, resource_index.long(), x)
    return out


def lendable_per_resource_plain(
    tree: QuotaTree,
    subtree: torch.Tensor,
    guaranteed: torch.Tensor,
    resource_index: torch.Tensor,
    n_resources: int,
) -> torch.Tensor:
    """The plain version of ``lendable_per_resource``."""
    pot = potential_available_all_plain(tree, subtree, guaranteed)
    per_res = _per_resource(pot[_parent_index(tree)], resource_index, n_resources)
    return torch.where((tree.parent >= 0)[:, None], per_res, 0)


def dominant_resource_share_plain(
    tree: QuotaTree,
    subtree: torch.Tensor,
    guaranteed: torch.Tensor,
    usage: torch.Tensor,
    wl_req: torch.Tensor,
    weight_milli: torch.Tensor,
    resource_index: torch.Tensor,
    n_resources: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``dominant_resource_share``."""
    borrowed = _per_resource(
        (wl_req + usage - subtree).clamp_min(0), resource_index, n_resources
    )
    lendable = lendable_per_resource_plain(
        tree, subtree, guaranteed, resource_index, n_resources
    )
    # only borrowing resources with lendable > 0 take part
    # (fair_sharing.go:69-78, drs starts at -1)
    ratio = torch.where(
        (borrowed > 0) & (lendable > 0),
        torch.div(borrowed * 1000, lendable.clamp_min(1), rounding_mode="floor"),
        -1,
    )
    drs = ratio.max(dim=1).values
    # torch.argmax, like jnp.argmax, returns the first maximum
    dominant = ratio.argmax(dim=1).to(I32)
    active = (borrowed > 0).any(dim=1) & (tree.parent >= 0)
    # Go's division truncates toward zero; drs may be -1
    share = torch.div(drs * 1000, weight_milli.clamp_min(1), rounding_mode="trunc")
    dws = torch.where(
        active, torch.where(weight_milli == 0, DRS_MAX, share), 0
    )
    dominant = torch.where(active & (drs >= 0), dominant, -1).to(I32)
    return dws, dominant


def _drs_call(symbol: str, tree, subtree, guaranteed, resource_index, n_resources, extra):
    """Launch ``symbol`` of kernel quota_drs: (ints, n_ints, ptrs, n_ptrs,
    stream), with the [N, FR] potentialAvailable scratch allocated
    here and ``extra`` ((name, tensor, dtype, shape) after it)."""
    n, fr = tree.nominal.shape
    d = tree.max_depth
    ptr = _build.ptr
    k = DRS_KERNEL
    pot = torch.empty_like(subtree)
    ptrs = [
        ptr(k, "parent", tree.parent, I32, (n,)),
        ptr(k, "level_mask", tree.level_mask, BOOL, (d + 1, n)),
        ptr(k, "subtree", subtree, I64, (n, fr)),
        ptr(k, "guaranteed", guaranteed, I64, (n, fr)),
        ptr(k, "borrowing_limit", tree.borrowing_limit, I64, (n, fr)),
        ptr(k, "resource_index", resource_index, I32, (fr,)),
        pot.data_ptr(),
    ] + [ptr(k, name, t, dtype, shape) for name, t, dtype, shape in extra]
    ints = [n, fr, int(n_resources), d]
    c_ints = (ctypes.c_int * len(ints))(*ints)
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    fn = _build.c_function(
        k, symbol,
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
    )
    _build.note_launch(k)
    rc = fn(
        ctypes.addressof(c_ints), len(ints), ctypes.addressof(c_ptrs), len(ptrs),
        _build.stream_ptr(subtree.device),
    )
    _build.check(rc, k)


def lendable_per_resource(
    tree: QuotaTree,
    subtree: torch.Tensor,
    guaranteed: torch.Tensor,
    resource_index: torch.Tensor,  # int32[FR] resource of each cell
    n_resources: int,
) -> torch.Tensor:
    """calculateLendable for every node (fair_sharing.go:90-104): the
    parent's potentialAvailable summed per resource. Roots get zeros
    (their DRS is 0 by definition). Returns int64[N, R]."""
    if not subtree.is_cuda:
        return lendable_per_resource_plain(
            tree, subtree, guaranteed, resource_index, n_resources
        )
    out = torch.empty((tree.n_nodes, int(n_resources)), dtype=I64, device=subtree.device)
    _drs_call(
        "quota_lendable", tree, subtree, guaranteed, resource_index, n_resources,
        [("out", out, I64, tuple(out.shape))],
    )
    return out


def dominant_resource_share(
    tree: QuotaTree,
    subtree: torch.Tensor,
    guaranteed: torch.Tensor,
    usage: torch.Tensor,
    wl_req: torch.Tensor,
    weight_milli: torch.Tensor,
    resource_index: torch.Tensor,
    n_resources: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """DominantResourceShare for every node (fair_sharing.go:49-86).

    wl_req: int64[N, FR] hypothetical extra usage per node (zeros for
    the current share). Returns (dws int64[N], dominant resource id
    int32[N], -1 where the node does not borrow). dws = max over
    resources of (borrowed above the subtree quota * 1000 / lendable)
    * 1000 / weight_milli, truncated as Go divides; a zero weight while
    borrowing gives DRS_MAX. Ties pick the lowest resource id: callers
    number resources in sorted name order."""
    if not usage.is_cuda:
        return dominant_resource_share_plain(
            tree, subtree, guaranteed, usage, wl_req, weight_milli, resource_index,
            n_resources,
        )
    n, fr = tree.nominal.shape
    dws = torch.empty(n, dtype=I64, device=usage.device)
    dominant = torch.empty(n, dtype=I32, device=usage.device)
    _drs_call(
        "quota_drs", tree, subtree, guaranteed, resource_index, n_resources,
        [("usage", usage, I64, (n, fr)), ("wl_req", wl_req, I64, (n, fr)),
         ("weight_milli", weight_milli, I64, (n,)), ("drs", dws, I64, (n,)),
         ("dominant", dominant, I32, (n,))],
    )
    return dws, dominant
