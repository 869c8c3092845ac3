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
(``csrc/quota_tree.cu``), one launch each; ``usage_and_available`` (the
drain cycle's pair) and ``quota_all`` (the interactive cycle's four) run
their recurrences in ONE launch of it. The last two are wrappers over
kernel B1', ``quota_drs`` (``csrc/quota_drs.cu``). On a CUDA tensor a
wrapper launches its kernel (or raises), on a CPU tensor it runs the
plain torch version beside it (``*_plain``). The wrappers take an
optional ``out`` buffer and an optional ``done`` flag (int32[1] on the
same device): when the flag is set the call does nothing, which lets
the drain's host loop enqueue a few cycles ahead of its termination
check.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np

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
    forest: kernel 1's packing of the forest (``build_forest``), made
    with the tree where the host has its parent array, else at the
    first launch.
    """

    parent: torch.Tensor
    level_mask: torch.Tensor
    nominal: torch.Tensor
    lending_limit: torch.Tensor
    borrowing_limit: torch.Tensor
    forest: Optional["Forest"] = None  # kernel 1's packing (tree_forest)

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

# The recurrences one launch runs, a bitmask: (subtree, guaranteed),
# usage, available, potential, in that order per column.
SUBTREE, USAGE, AVAIL, POTENTIAL = 1, 2, 4, 8

# Root subtrees are packed into bins of about N / BIN_SMS nodes, at most
# BIN_NODES (a subtree larger than that is a bin of its own): a block a
# bin, so at least BIN_SMS blocks share the work where the forest allows.
BIN_SMS = 132
BIN_NODES = 64
# a block's opt-in shared memory (sm_90): the blocks of a bin split its
# columns to fit it (column_chunk)
QUOTA_SHARED_BYTES = 232448 - 1024


def _mats(mask: int) -> int:
    """The [nodes, columns] matrices kernel 1 keeps for the recurrences
    of ``mask`` (``mats_of`` in the kernel: subtree, guaranteed, usage,
    borrowing limit, available, potential, as they are needed)."""
    down = bool(mask & (AVAIL | POTENTIAL))
    return ((bool(mask & SUBTREE) or down) + 1 + bool(mask & (USAGE | AVAIL)) + down
            + bool(mask & AVAIL) + bool(mask & POTENTIAL))


def bin_shared_bytes(n_nodes: int, fr: int, mask: int) -> int:
    """Shared bytes kernel 1 needs to run ``fr`` columns of a bin of
    ``n_nodes`` nodes on shared rows: 16 B of packing a node, and a row
    of int64 cells for each matrix the recurrences of ``mask`` keep."""
    return n_nodes * (16 + 8 * fr * _mats(mask))


def column_chunk(max_bin: int, fr: int, mask: int, n_bins: int) -> int:
    """Columns a block of kernel 1 owns (``column_chunk`` in the kernel;
    the blocks of a bin split its columns): few enough that the blocks
    of all ``n_bins`` bins fill the card's BIN_SMS multiprocessors and
    that the largest bin's rows fit a block's shared memory. A bin too
    large for even one column runs on the device-memory rows."""
    want = -(-BIN_SMS // max(n_bins, 1))
    par = -(-fr // want)
    fit = (QUOTA_SHARED_BYTES // max(max_bin, 1) - 16) // (8 * _mats(mask))
    cw = fit if 1 <= fit < par else par
    return max(cw, 1)


class Forest(NamedTuple):
    """The cohort forest as kernel 1 walks it, built once on the host
    from ``parent``. Whole root subtrees are packed into bins (a block
    each); a bin's nodes are numbered breadth first, its roots first,
    so each level is a run of positions and each node's children are a
    run of the next level.

    meta: int32[N, 4] per position (bins back to back): the node, its
    parent's position in the bin (-1 for a root), and its children's
    positions in the bin, [first, end).
    bins: int32[B, depth + 2] per bin the position where each level
    starts, then the bin's end.
    pos: int32[N] each node's position (the inverse of meta's first
    column); kernel B3' (cycle_global) groups heads by it.
    """

    meta: torch.Tensor
    bins: torch.Tensor
    depth: int
    max_bin: int
    pos: torch.Tensor

    def to(self, device) -> "Forest":
        return self._replace(meta=self.meta.to(device), bins=self.bins.to(device),
                             pos=self.pos.to(device))


def build_forest(parent, device=None) -> Forest:
    """The ``Forest`` of a parent array (numpy or a list; -1 for roots)
    on ``device``."""
    parent = np.asarray(parent, dtype=np.int64)
    n = parent.shape[0]
    children = [[] for _ in range(n)]
    roots = []
    for i, p in enumerate(parent.tolist()):
        (roots if p < 0 else children[p]).append(i)
    # breadth-first order of the whole forest: subtree sizes and depths
    order, depth_of = list(roots), np.zeros(n, dtype=np.int64)
    for i in order:
        for c in children[i]:
            depth_of[c] = depth_of[i] + 1
            order.append(c)
    size = np.ones(n, dtype=np.int64)
    for i in reversed(order):
        if parent[i] >= 0:
            size[parent[i]] += size[i]
    depth = int(depth_of.max()) if n else 0
    target = min(max(1, -(-n // BIN_SMS)), BIN_NODES)
    groups, cur, cur_n = [], [], 0
    for r in roots:
        if cur and cur_n + size[r] > target:
            groups.append(cur)
            cur, cur_n = [], 0
        cur.append(r)
        cur_n += int(size[r])
    if cur:
        groups.append(cur)
    meta = np.zeros((n, 4), dtype=np.int32)
    bins = np.zeros((len(groups), depth + 2), dtype=np.int32)
    pos = 0
    for b, group in enumerate(groups):
        start, level, parents = pos, group, [-1] * len(group)
        for d in range(depth + 1):
            bins[b, d] = pos
            nxt, nxt_parents = [], []
            first = pos - start + len(level)  # the next level's first position
            for j, node in enumerate(level):
                kids = children[node]
                meta[pos + j] = (node, parents[j], first + len(nxt), first + len(nxt) + len(kids))
                nxt_parents += [pos - start + j] * len(kids)
                nxt += kids
            pos += len(level)
            level, parents = nxt, nxt_parents
        bins[b, depth + 1] = pos
    max_bin = int((bins[:, -1] - bins[:, 0]).max()) if len(groups) else 0
    pos = np.empty(n, dtype=np.int32)
    pos[meta[:, 0]] = np.arange(n, dtype=np.int32)
    dev = torch.device("cpu") if device is None else device
    return Forest(
        meta=torch.from_numpy(meta).to(dev, non_blocking=True),
        bins=torch.from_numpy(bins).to(dev, non_blocking=True),
        depth=depth,
        max_bin=max_bin,
        pos=torch.from_numpy(pos).to(dev, non_blocking=True),
    )


def tree_forest(tree: QuotaTree) -> Forest:
    """``tree.forest``, built from ``tree.parent`` (a host read) the first
    time a tree made without one needs it."""
    if tree.forest is None:
        tree.forest = build_forest(tree.parent.cpu().numpy(), tree.device)
    return tree.forest


def _launch(tree: QuotaTree, mask: int, done=None, **views) -> None:
    """ONE launch of kernel 1 running the recurrences of ``mask`` on the
    [N, FR] tensors ``views`` (subtree, guaranteed, local, usage, avail,
    potential: each an input or an output as ``mask`` says)."""
    k = KERNEL
    n, fr = tree.nominal.shape
    forest = tree_forest(tree)
    sub = bool(mask & SUBTREE)
    rows = [
        ("nominal", tree.nominal if sub else None),
        ("lending_limit", tree.lending_limit if sub else None),
        ("borrowing_limit", tree.borrowing_limit if mask & (AVAIL | POTENTIAL) else None),
    ] + [(name, views.get(name)) for name in (
        "local", "subtree", "guaranteed", "usage", "avail", "potential")]
    n_bins = forest.bins.shape[0]
    ptrs = [
        _build.ptr(k, "meta", forest.meta, I32, (n, 4)),
        _build.ptr(k, "bins", forest.bins, I32, (n_bins, forest.depth + 2)),
        *(_build.ptr(k, name, t, I64, (n, fr)) for name, t in rows),
        _build.ptr(k, "done", done, I32, (1,)),
    ]
    ints = [mask, n, fr, forest.depth, n_bins, forest.max_bin]
    c_ints = (ctypes.c_int * len(ints))(*ints)
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    fn = _build.c_function(
        k, k, [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    )
    _build.note_launch(k)
    rc = fn(ctypes.addressof(c_ints), len(ints), ctypes.addressof(c_ptrs), len(ptrs),
            _build.stream_ptr(tree.nominal.device))
    _build.check(rc, k)


def _skip(done: Optional[torch.Tensor]) -> bool:
    """Plain-path honour of the done flag (a host read on the CPU)."""
    return done is not None and bool(done.item())


def _into(out: Optional[torch.Tensor], res: torch.Tensor) -> torch.Tensor:
    if out is None:
        return res
    out.copy_(res)
    return out


# ---- public wrappers


def subtree_quota(tree: QuotaTree) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bottom-up SubtreeQuota and guaranteedQuota for every node.

    SubtreeQuota(node) = nominal + sum_children (child.SubtreeQuota -
    child.guaranteedQuota) — resource_node.go:186-189."""
    if not tree.nominal.is_cuda:
        return subtree_quota_plain(tree)
    subtree = torch.empty_like(tree.nominal)
    guaranteed = torch.empty_like(tree.nominal)
    _launch(tree, SUBTREE, subtree=subtree, guaranteed=guaranteed)
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
        return _into(out, usage_tree_plain(tree, guaranteed, local_usage))
    if out is None:
        out = torch.empty_like(local_usage)
    _launch(tree, USAGE, done, guaranteed=guaranteed, local=local_usage, usage=out)
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
        return _into(out, available_all_plain(tree, subtree, guaranteed, usage))
    if out is None:
        out = torch.empty_like(usage)
    _launch(tree, AVAIL, done, subtree=subtree, guaranteed=guaranteed, usage=usage, avail=out)
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
    _launch(tree, POTENTIAL, subtree=subtree, guaranteed=guaranteed, potential=out)
    return out


def usage_and_available_plain(
    tree: QuotaTree, subtree: torch.Tensor, guaranteed: torch.Tensor, local_usage: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``usage_and_available``."""
    usage = usage_tree_plain(tree, guaranteed, local_usage)
    return usage, available_all_plain(tree, subtree, guaranteed, usage)


def usage_and_available(
    tree: QuotaTree,
    subtree: torch.Tensor,
    guaranteed: torch.Tensor,
    local_usage: torch.Tensor,
    out_usage: Optional[torch.Tensor] = None,
    out_avail: Optional[torch.Tensor] = None,
    done: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``usage_tree`` then ``available_all`` on its usage, in ONE launch:
    the drain cycle's quota pass. Returns (usage, avail)."""
    if not local_usage.is_cuda:
        if _skip(done):
            return out_usage, out_avail
        usage, avail = usage_and_available_plain(tree, subtree, guaranteed, local_usage)
        return _into(out_usage, usage), _into(out_avail, avail)
    if out_usage is None:
        out_usage = torch.empty_like(local_usage)
    if out_avail is None:
        out_avail = torch.empty_like(local_usage)
    _launch(tree, USAGE | AVAIL, done, subtree=subtree, guaranteed=guaranteed,
            local=local_usage, usage=out_usage, avail=out_avail)
    return out_usage, out_avail


def quota_all_plain(tree: QuotaTree, local_usage: torch.Tensor):
    """The plain version of ``quota_all``."""
    subtree, guaranteed = subtree_quota_plain(tree)
    usage, avail = usage_and_available_plain(tree, subtree, guaranteed, local_usage)
    potential = potential_available_all_plain(tree, subtree, guaranteed)
    return subtree, guaranteed, usage, avail, potential


def quota_all(tree: QuotaTree, local_usage: torch.Tensor,
              out_usage: Optional[torch.Tensor] = None):
    """All four recurrences in ONE launch: (subtree, guaranteed, usage,
    avail, potential), the cycle's quota views. ``out_usage`` receives
    the usage tree when given."""
    if not local_usage.is_cuda:
        res = quota_all_plain(tree, local_usage)
        return res[:2] + (_into(out_usage, res[2]),) + res[3:]
    views = {name: torch.empty_like(local_usage)
             for name in ("subtree", "guaranteed", "avail", "potential")}
    views["usage"] = torch.empty_like(local_usage) if out_usage is None else out_usage
    _launch(tree, SUBTREE | USAGE | AVAIL | POTENTIAL, local=local_usage, **views)
    return tuple(views[k] for k in ("subtree", "guaranteed", "usage", "avail", "potential"))


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
