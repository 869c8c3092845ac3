"""Batched classic preemption: the victim search of a scheduling cycle
on the card (port of kueue_tpu/ops/preempt_kernel.py).

The reference computes preemption targets per nominated head with a
sequential simulate/undo loop over the snapshot
(``pkg/scheduler/preemption/preemption.go:275-342`` minimalPreemptions:
remove candidates in order until the head fits, then fill back the ones
whose removal turned out unnecessary). Every preempt-mode head's search
runs against the cycle-start snapshot, so the searches are independent
and batch: the host (core/preempt_batch.py) lowers each head's ladder
attempt to a small local problem, the ``[S, Cu]`` quota and usage
panels of its root cohort's subtree restricted to the cells the head
references, plus its pre-filtered, pre-sorted candidates.

Semantics (parity-tested against core/preemption.py and the JAX
package in tests/test_torch_preempt.py):

- in-loop borrowing check: other-CQ candidates are skipped while their
  CQ is no longer borrowing in the simulated state (preemption.go:300);
- allow-borrowing flip: under borrowWithinCohort, removing an other-CQ
  candidate at or above the priority threshold disables borrowing for
  every later fit check (preemption.go:307-312);
- fit check: available() along the head's ancestor path plus the
  nominal cap when borrowing is disallowed (preemption.go:552-574);
- fill-back: candidates re-added in reverse removal order, skipping the
  one whose removal produced the fit, each kept out iff the head still
  fits without it (preemption.go:318-338).

``solve_preempt_packed`` is kernel B8, ``preempt_search``
(``csrc/preempt_search.cu``), for CUDA tensors, and its plain torch
version ``solve_preempt`` for CPU tensors; the packed layout is the JAX
package's: ``int32[W*V]`` targets, then ``int32[W]`` fits, one copy.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

from kueue_tpu_torch._torch import BOOL, I32, I64, torch
from kueue_tpu_torch.ops import _build
from kueue_tpu_torch.ops.quota import NO_LIMIT

KERNEL = "preempt_search"
# widest problems the kernel takes: one warp lane per cell, the
# candidates' removal flags in shared memory
MAX_CELLS = 16
MAX_CANDIDATES = 512


class PreemptProblem(NamedTuple):
    """W attempt rows (a head lowers to up to two ladder attempts), each
    a local subtree problem. S = padded subtree size, Cu = padded cell
    count, V = padded candidate count, D = local depth.

    paths:     int32[W, S, D+1] local ancestor path of each local row.
    usage0:    int64[W, S, Cu] bubbled usage tree (gathered global).
    leaf0:     int64[W, S, Cu] leaf (ClusterQueue-local) usage.
    nominal, subtree_q, guaranteed, borrow_lim: int64[W, S, Cu].
    hrow:      int32[W] the head's local row.
    need_qty:  int64[W, Cu] the head's request per cell.
    need_pre:  bool[W, Cu] the cell needs preemption (the borrowing
               checks read only these).
    allow_borrow: bool[W] the attempt's starting allowBorrowing.
    has_thr:   bool[W] / thr: int64[W] allowBorrowingBelowPriority.
    crow:      int32[W, V] candidate's ClusterQueue local row.
    cqty:      int64[W, V, Cu] candidate's admitted usage per cell.
    cvalid, csame: bool[W, V]; cprio: int64[W, V].
    row_valid: bool[W] padding rows compute nothing.
    """

    paths: torch.Tensor
    usage0: torch.Tensor
    leaf0: torch.Tensor
    nominal: torch.Tensor
    subtree_q: torch.Tensor
    guaranteed: torch.Tensor
    borrow_lim: torch.Tensor
    hrow: torch.Tensor
    need_qty: torch.Tensor
    need_pre: torch.Tensor
    allow_borrow: torch.Tensor
    has_thr: torch.Tensor
    thr: torch.Tensor
    crow: torch.Tensor
    cqty: torch.Tensor
    cvalid: torch.Tensor
    csame: torch.Tensor
    cprio: torch.Tensor
    row_valid: torch.Tensor


class PreemptResult(NamedTuple):
    """targets: bool[W, V] the candidate is a victim; fits: bool[W] the
    attempt found a fitting victim set (a miss has no targets)."""

    targets: torch.Tensor
    fits: torch.Tensor


# ---- the plain torch version --------------------------------------------


def _avail_local(path, usage, subtree_q, guaranteed, borrow_lim, depth: int):
    """available() at each row's path leaf over all Cu cells: the
    root-down recurrence of resource_node.go:89-104 on the local panels
    (the JAX ``_avail_local``, batched over rows). path: int32[W, D+1]
    local rows; panels int64[W, S, Cu]. Returns int64[W, Cu]."""
    w_idx = torch.arange(path.shape[0], device=path.device)[:, None]
    rows = path.clamp_min(0).long()
    sub, g, bl, u = (m[w_idx, rows] for m in (subtree_q, guaranteed, borrow_lim, usage))
    valid = path >= 0
    root_pos = valid.to(I64).sum(dim=1) - 1
    avail = torch.zeros((path.shape[0], usage.shape[2]), dtype=I64, device=usage.device)
    for d in range(depth, -1, -1):
        is_root = (root_pos == d)[:, None]
        root_avail = sub[:, d] - u[:, d]
        with_max = sub[:, d] - g[:, d] - (u[:, d] - g[:, d]).clamp_min(0) + bl[:, d]
        clamped = torch.where(bl[:, d] < NO_LIMIT, torch.minimum(with_max, avail), avail)
        nonroot = (g[:, d] - u[:, d]).clamp_min(0) + clamped
        avail = torch.where(valid[:, d : d + 1], torch.where(is_root, root_avail, nonroot), avail)
    return avail


def _bubble_local(path, qty, usage, guaranteed, depth: int, apply) -> None:
    """addUsage/removeUsage (resource_node.go:123-144) of the signed
    ``qty`` (int64[W, Cu]) up each row's ``path`` (int32[W, D+1]) on
    the local usage panels, in place, where ``apply`` (bool[W])."""
    w_idx = torch.arange(path.shape[0], device=path.device)
    delta = torch.where(apply[:, None], qty, 0)
    for d in range(depth + 1):
        node = path[:, d].clamp_min(0).long()
        node_valid = (path[:, d] >= 0)[:, None]
        old = usage[w_idx, node]
        g = guaranteed[w_idx, node]
        new = old + delta
        usage[w_idx, node] = old + torch.where(node_valid, delta, 0)
        delta = torch.where(
            node_valid, (new - g).clamp_min(0) - (old - g).clamp_min(0), delta
        )


def solve_preempt(p: PreemptProblem, depth: int, n_cand: int,
                  trace: Optional[dict] = None) -> PreemptResult:
    """Remove-until-fit then fill-back for every row at once (the JAX
    ``_solve_one`` vmapped over rows); the candidate loop runs only
    while some row is still searching. With ``trace`` (a dict) it
    records each row's steps, int64[W]: the candidates it visited while
    searching and the removals it tried to put back."""
    w = p.hrow.shape[0]
    dev = p.usage0.device
    w_idx = torch.arange(w, device=dev)
    hrow = p.hrow.clamp_min(0).long()
    hpath = p.paths[w_idx, hrow]
    need = p.need_qty > 0
    nom_h = p.nominal[w_idx, hrow]

    def fits(usage, leaf, allow_borrow):
        avail = _avail_local(hpath, usage, p.subtree_q, p.guaranteed, p.borrow_lim, depth)
        ok = torch.where(need, avail >= p.need_qty, True).all(dim=1)
        nb_ok = torch.where(need, leaf[w_idx, hrow] + p.need_qty <= nom_h, True).all(dim=1)
        return ok & (allow_borrow | nb_ok)

    usage = p.usage0.clone()
    leaf = p.leaf0.clone()
    allow_borrow = p.allow_borrow & p.row_valid
    done = ~p.row_valid  # padding rows do no work
    fit_at = torch.full((w,), -1, dtype=I64, device=dev)
    removed = torch.zeros((w, n_cand), dtype=BOOL, device=dev)
    steps = torch.zeros(w, dtype=I64, device=dev)
    for v in range(n_cand):
        is_live = p.cvalid[:, v] & ~done
        steps += is_live
        if not bool(is_live.any()):
            continue  # no row acts: nothing changes at this step
        crow = p.crow[:, v].clamp_min(0).long()
        # other-CQ candidates count only while their CQ still borrows
        # (in the simulated state) in a cell needing preemption
        cq_borrowing = ((leaf[w_idx, crow] > p.nominal[w_idx, crow]) & p.need_pre).any(dim=1)
        act = is_live & (p.csame[:, v] | cq_borrowing)
        flip = act & ~p.csame[:, v] & p.has_thr & (p.cprio[:, v] >= p.thr)
        allow_borrow = allow_borrow & ~flip
        _bubble_local(p.paths[w_idx, crow], -p.cqty[:, v], usage, p.guaranteed, depth, act)
        leaf[w_idx, crow] += torch.where(act[:, None], -p.cqty[:, v], 0)
        removed[:, v] = act
        now_fits = act & fits(usage, leaf, allow_borrow)
        fit_at = torch.where(now_fits & ~done, v, fit_at)
        done = done | now_fits
    found = done & p.row_valid

    # fill-back: reverse removal order, skipping the fitting removal
    for v in range(n_cand - 1, -1, -1):
        act = found & removed[:, v] & (fit_at != v)
        steps += act
        if not bool(act.any()):
            continue
        crow = p.crow[:, v].clamp_min(0).long()
        usage2 = usage.clone()
        _bubble_local(p.paths[w_idx, crow], p.cqty[:, v], usage2, p.guaranteed, depth, act)
        leaf2 = leaf.clone()
        leaf2[w_idx, crow] += torch.where(act[:, None], p.cqty[:, v], 0)
        keep = act & fits(usage2, leaf2, allow_borrow)
        usage = torch.where(keep[:, None, None], usage2, usage)
        leaf = torch.where(keep[:, None, None], leaf2, leaf)
        removed[:, v] = removed[:, v] & ~keep
    if trace is not None:
        trace["steps"] = steps
    return PreemptResult(targets=removed & found[:, None], fits=found)


def _pack(r: PreemptResult) -> torch.Tensor:
    return torch.cat([r.targets.to(I32).reshape(-1), r.fits.to(I32)])


# ---- kernel B8 (csrc/preempt_search.cu) -----------------------------------

_FIELDS = (
    ("paths", I32), ("usage0", I64), ("leaf0", I64), ("nominal", I64),
    ("subtree_q", I64), ("guaranteed", I64), ("borrow_lim", I64), ("hrow", I32),
    ("need_qty", I64), ("need_pre", BOOL), ("allow_borrow", BOOL), ("has_thr", BOOL),
    ("thr", I64), ("crow", I32), ("cqty", I64), ("cvalid", BOOL), ("csame", BOOL),
    ("cprio", I64), ("row_valid", BOOL),
)


def _launch(p: PreemptProblem, depth: int, n_cand: int) -> torch.Tensor:
    w, s, d1 = p.paths.shape
    cu = p.usage0.shape[2]
    v = n_cand
    if cu > MAX_CELLS or v > MAX_CANDIDATES or d1 != depth + 1:
        raise _build.KernelInputError(
            f"{KERNEL}: takes Cu<={MAX_CELLS} cells, V<={MAX_CANDIDATES} candidates and "
            f"paths of depth+1 entries; got Cu={cu}, V={v}, paths {d1} for depth {depth}"
        )
    shapes = {
        "paths": (w, s, d1), "hrow": (w,), "need_qty": (w, cu), "need_pre": (w, cu),
        "allow_borrow": (w,), "has_thr": (w,), "thr": (w,), "crow": (w, v),
        "cqty": (w, v, cu), "cvalid": (w, v), "csame": (w, v), "cprio": (w, v),
        "row_valid": (w,),
    }
    ptrs = [
        _build.ptr(KERNEL, name, getattr(p, name), dt, shapes.get(name, (w, s, cu)))
        for name, dt in _FIELDS
    ]
    out = torch.empty(w * v + w, dtype=I32, device=p.usage0.device)
    ptrs.append(out.data_ptr())
    fn = _build.c_function(
        KERNEL, KERNEL,
        [ctypes.c_int] * 5 + [ctypes.c_void_p] * len(ptrs) + [ctypes.c_void_p],
    )
    _build.note_launch(KERNEL)
    _build.check(fn(w, s, cu, v, depth, *ptrs, _build.stream_ptr(p.usage0.device)), KERNEL)
    return out


def solve_preempt_packed(p: PreemptProblem, depth: int, n_cand: int) -> torch.Tensor:
    """Every row's victim search, packed: int32[W*V] targets (row
    major), then int32[W] fits. Kernel B8 on a CUDA problem (it raises
    ``KernelError`` on what it cannot take), the plain version on a CPU
    one."""
    if not p.usage0.is_cuda:
        return _pack(solve_preempt(p, depth, n_cand))
    return _launch(p, depth, n_cand)
