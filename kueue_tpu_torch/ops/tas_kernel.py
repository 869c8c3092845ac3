"""TAS phase-1 pod counting: kernel B12 and its plain torch versions.

Port of kueue_tpu/ops/tas_kernel.py. Re-expresses fillInCounts
(pkg/cache/tas_flavor_snapshot.go:647-690) as dense tensor ops, batched
over B podset requests: per-leaf CountIn is a masked truncating-divide
min-reduce over the resource axis (``leaf_counts``), and per-level
domain totals are segment sums over leaf -> domain index vectors
(``level_counts``). ``fill_in_counts`` is the two together.

Each of ``leaf_counts`` and ``level_counts`` launches its CUDA entry of
csrc/tas_leaf_counts.cu (kernel B12) for CUDA tensors, or raises; for
CPU tensors it runs the plain version beside it. Both entries count
under the one launch counter ``tas_leaf_counts``.

Integer semantics: Go's ``int32(capacity / value)`` truncates toward
zero: ``sign(num) * (|num| // max(den, 1))``, the reference's
``_trunc_div``. Counts are clipped above at 2^31-1 (no floor), a
request naming no quantity of a resource (0) does not limit it, and an
untolerated leaf counts 0.

Also here, copied from the reference: the dense view of a frozen
TASFlavorSnapshot (``topology_from_snapshot``), the single owner of the
domain order (``_level_prefix_index``) and the parent map in that order
(``domain_parent_map``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np

from kueue_tpu_torch._torch import BOOL, I32, I64, resolve_device, to_device, torch
from kueue_tpu_torch.ops import _build

MAX_COUNT = (1 << 31) - 1
KERNEL = "tas_leaf_counts"


class TASTopology(NamedTuple):
    """Dense topology-forest view.

    free:      int64[L, R] leaf free capacity (alloc - non-TAS usage)
    tas_usage: int64[L, R] usage of admitted TAS workloads
    seg_ids:   int32[D, L] leaf -> domain index at each level d
               (level D-1 is the leaf level: seg_ids[D-1] = arange(L))
    n_domains: per-level domain counts
    """

    free: torch.Tensor
    tas_usage: torch.Tensor
    seg_ids: torch.Tensor
    n_domains: Tuple[int, ...]


def _trunc_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """Go-style integer division truncating toward zero."""
    return torch.sign(num) * (num.abs() // den.clamp_min(1))


# ---- plain torch versions ------------------------------------------------


def leaf_counts_plain(topo: TASTopology, req, assumed, taint_ok, simulate_empty):
    """CountIn for every (request, leaf) pair: req int64[B, R],
    assumed int64[B, L, R], taint_ok bool[B, L], simulate_empty
    bool[B]. Returns int64[B, L]."""
    usage = torch.where(simulate_empty[:, None, None], 0, topo.tas_usage[None, :, :])
    remaining = topo.free[None, :, :] - usage - assumed  # [B, L, R]
    per_res = _trunc_div(remaining, req[:, None, :])
    per_res = torch.where((req > 0)[:, None, :], per_res, MAX_COUNT)
    counts = per_res.amin(dim=-1).clamp_max(MAX_COUNT)
    return torch.where(taint_ok, counts, 0)


def level_counts_plain(topo: TASTopology, counts) -> Tuple[torch.Tensor, ...]:
    """Bubble leaf counts into every level's domain totals: counts
    int64[B, L] -> per level d int64[B, n_domains[d]]."""
    b = counts.shape[0]
    out = []
    for d, nd in enumerate(topo.n_domains):
        seg = topo.seg_ids[d].long()
        keep = (seg >= 0) & (seg < nd)  # jax.ops.segment_sum drops the rest
        s = torch.zeros((b, nd), dtype=I64, device=counts.device)
        s.scatter_add_(1, seg[keep][None, :].expand(b, -1), counts[:, keep])
        out.append(s)
    return tuple(out)


# ---- kernel B12 (csrc/tas_leaf_counts.cu) --------------------------------


def leaf_counts(topo: TASTopology, req, assumed, taint_ok, simulate_empty):
    """CountIn for every (request, leaf) pair (``leaf_counts_plain``):
    one thread per (request, leaf) on the card."""
    if not topo.free.is_cuda:
        return leaf_counts_plain(topo, req, assumed, taint_ok, simulate_empty)
    n_l, n_r = topo.free.shape
    b = req.shape[0]
    out = torch.empty((b, n_l), dtype=I64, device=topo.free.device)
    fn = _build.c_function(
        KERNEL, "leaf_counts",
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    )
    args = (
        _build.ptr(KERNEL, "free", topo.free, I64, (n_l, n_r)),
        _build.ptr(KERNEL, "tas_usage", topo.tas_usage, I64, (n_l, n_r)),
        _build.ptr(KERNEL, "req", req, I64, (b, n_r)),
        _build.ptr(KERNEL, "assumed", assumed, I64, (b, n_l, n_r)),
        _build.ptr(KERNEL, "taint_ok", taint_ok, BOOL, (b, n_l)),
        _build.ptr(KERNEL, "simulate_empty", simulate_empty, BOOL, (b,)),
        out.data_ptr(),
        b, n_l, n_r,
        _build.stream_ptr(out.device),
    )
    _build.note_launch(KERNEL)
    _build.check(fn(*args), KERNEL)
    return out


def level_counts(topo: TASTopology, counts) -> Tuple[torch.Tensor, ...]:
    """Per-level domain totals (``level_counts_plain``): one thread per
    (request, leaf) adds its count into every level's domain total with
    an int64 atomicAdd (integer sums are exact in any order)."""
    if not counts.is_cuda:
        return level_counts_plain(topo, counts)
    b, n_l = counts.shape
    d = len(topo.n_domains)
    offs = np.concatenate([[0], np.cumsum(topo.n_domains)]).astype(np.int32)
    total = int(offs[-1])
    dev = counts.device
    out = torch.zeros((b, total), dtype=I64, device=dev)
    offsets = to_device(offs, dev, np.int32)
    fn = _build.c_function(
        KERNEL, "level_counts",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    )
    args = (
        _build.ptr(KERNEL, "counts", counts, I64, (b, n_l)),
        _build.ptr(KERNEL, "seg_ids", topo.seg_ids, I32, (d, n_l)),
        _build.ptr(KERNEL, "offsets", offsets, I32, (d + 1,)),
        out.data_ptr(),
        b, n_l, d, total,
        _build.stream_ptr(dev),
    )
    _build.note_launch(KERNEL)
    _build.check(fn(*args), KERNEL)
    return tuple(out[:, int(offs[i]):int(offs[i + 1])] for i in range(d))


def fill_in_counts(topo: TASTopology, req, assumed, taint_ok, simulate_empty):
    """Batched phase 1: per-leaf counts and per-level domain totals."""
    counts = leaf_counts(topo, req, assumed, taint_ok, simulate_empty)
    return counts, level_counts(topo, counts)


# ---- the dense view of a snapshot (host) ---------------------------------


def _level_prefix_index(snap, d):
    """Domain order at level d: sorted by level_values prefix (stable,
    matches host _sorted_domains tie-break order). SINGLE owner of the
    domain-index ordering — seg_ids and parent maps must agree."""
    prefixes = sorted({leaf.level_values[: d + 1] for leaf in snap._leaf_order})
    return {p: i for i, p in enumerate(prefixes)}


def topology_from_snapshot(snap, device=None) -> TASTopology:
    """The dense view of a host TASFlavorSnapshot (frozen) on
    ``device`` (the card unless the caller names another)."""
    dev = resolve_device(device)
    snap.freeze()
    leaves = snap._leaf_order
    depth = len(snap.level_keys)
    seg_ids = np.zeros((depth, len(leaves)), dtype=np.int32)
    n_domains = []
    for d in range(depth):
        index = _level_prefix_index(snap, d)
        for i, leaf in enumerate(leaves):
            seg_ids[d, i] = index[leaf.level_values[: d + 1]]
        n_domains.append(len(index))
    return TASTopology(
        free=to_device(snap._free, dev, np.int64),
        tas_usage=to_device(snap._tas_usage, dev, np.int64),
        seg_ids=to_device(seg_ids, dev, np.int32),
        n_domains=tuple(n_domains),
    )


def domain_parent_map(snap):
    """int32[D, ND]: domain index at level d -> parent index at level
    d-1, in the SAME ordering as topology_from_snapshot's seg_ids (row
    0 is unused and zero)."""
    snap.freeze()
    depth = len(snap.level_keys)
    indexes = [_level_prefix_index(snap, d) for d in range(depth)]
    nd_max = max(len(ix) for ix in indexes)
    parent_map = np.zeros((depth, nd_max), dtype=np.int32)
    for d in range(1, depth):
        for p, idx in indexes[d].items():
            parent_map[d, idx] = indexes[d - 1][p[:-1]]
    return parent_map
