"""Batched fair-sharing preemption: the victim tournament of a
scheduling cycle on the card (port of kueue_tpu/ops/fair_preempt_kernel.py).

The reference's fair-sharing victim search
(``pkg/scheduler/preemption/preemption.go:372-463`` +
``preemption/fairsharing/``) walks the cohort tree from the root
picking the highest-DominantResourceShare subtree, pops that
ClusterQueue's next candidate, gates it through the configured strategy
at the almost-LCA, and re-evaluates DRS after every accepted removal.
Every preempt-mode head's search runs against the cycle-start snapshot,
so the searches are independent: the host (core/preempt_batch.py)
lowers each head to a local problem over its root cohort's subtree and
its ACTIVE cell universe (every cell with quota or usage anywhere in
that subtree: DRS aggregates borrowed/lendable per resource over all of
them, fair_sharing.go:49-104), and one launch resolves every head.

Exactness notes (parity with the JAX package and the host Preemptor in
tests/test_torch_fair_preempt.py):

- pruning in the first pass is recomputed per pick instead of stored
  (every host prune condition is a monotone function of the simulated
  state); the second strategy's dropped queues are carried as a mask;
- tie-breaks copy the host walk: children in ascending local row
  keeping >=, so the highest (drs, row) wins; cohorts win ties against
  ClusterQueues; a rootless head takes its own row;
- the strategy gate reads target_new_share on a probe removal that is
  rolled back when rejected (rejected candidates move to the retry set
  without touching usage), as preemption.go:438-453;
- DRS integers: ``borrowed * 1000 // lendable`` (floor of
  non-negatives, -1 where nothing is borrowed or nothing lendable),
  the weight step truncating toward zero, DRS_MAX for weight 0 and 0
  for roots and non-borrowing nodes.

``solve_fair_packed`` is kernel B9, ``fair_search``
(``csrc/fair_search.cu``), for CUDA tensors, and the plain torch
version ``solve_fair`` for CPU tensors; the packed layout is the JAX
package's: ``int32[W*V]`` targets, then ``int32[W]`` fits, one copy.
The plain version is the JAX ``vmap`` written out: every row steps
together, a row that is done keeps its state.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

from kueue_tpu_torch._torch import BOOL, I32, I64, torch
from kueue_tpu_torch.ops import _build
from kueue_tpu_torch.ops.preempt_kernel import _avail_local, _bubble_local
from kueue_tpu_torch.ops.quota import DRS_MAX, NO_LIMIT

KERNEL = "fair_search"

# strategy ids (config fairSharing.preemptionStrategies)
LESS_THAN_OR_EQUAL_TO_FINAL = 0
LESS_THAN_INITIAL = 1

# widest problems the kernel takes (csrc/fair_local.cuh): two nodes and
# two cells a warp lane, the usage panel and the per-node lendable table
# in shared memory
MAX_NODES = 64
MAX_CELLS = 64
MAX_BUCKETS = MAX_CELLS + 1  # one resource a cell plus the inert one
MAX_CANDIDATES = 1024


def split_panel_rows(
    counts: Sequence[int], v_full: int, bucket
) -> Tuple[int, List[int], List[int]]:
    """Two-tier candidate-panel schedule for the batched tournament.

    The loop's trip count scales with the candidate-panel width V
    (``max_iters = 2V + S + 4``) and V is padded to the LARGEST head's
    pool, so one deep pool taxes every head in the batch. Heads whose
    whole pool fits a narrow panel (the bucketed median pool size) solve
    at that width; only the overflowing heads solve at the full width.
    A head's search is an independent subproblem over its OWN
    candidates, so the narrow width is exact for any head whose pool
    fits it.

    Returns ``(v_narrow, narrow_rows, wide_rows)``; ``wide_rows`` is
    empty when every pool fits the narrow panel."""
    counts = list(counts)
    if not counts:
        return v_full, [], []
    ordered = sorted(counts)
    median = ordered[(len(ordered) - 1) // 2]
    v_narrow = min(bucket(max(median, 1), minimum=2), v_full)
    if v_narrow >= v_full:
        return v_full, list(range(len(counts))), []
    narrow = [i for i, c in enumerate(counts) if c <= v_narrow]
    wide = [i for i, c in enumerate(counts) if c > v_narrow]
    return v_narrow, narrow, wide


class FairProblem(NamedTuple):
    """W head rows, each a local subtree problem. S = padded subtree
    size, Cu = padded cell count (the subtree's active cell universe),
    V = padded candidate count, D = local depth.

    paths:      int32[W, S, D+1] local ancestor path per local row.
    usage0:     int64[W, S, Cu] bubbled usage INCLUDING the head's
                request at its row (the host adds it before computing
                DRS, preemption.go:394-395).
    subtree_q / guaranteed / borrow_lim: int64[W, S, Cu].
    weight:     int64[W, S] fairSharing weight per node.
    parent_loc: int32[W, S] local parent (-1 root / padding).
    depth_s:    int32[W, S] distance from the root (root = 0).
    is_cq, svalid: bool[W, S].
    anc_of_head: bool[W, S] strict ancestors of the head row.
    hrow:       int32[W].
    need_qty:   int64[W, Cu] head request per cell.
    res_of:     int32[W, Cu] cell -> resource bucket (padded cells
                point at the inert last bucket).
    crow:       int32[W, V]; cqty: int64[W, V, Cu]; cvalid: bool[W, V].
    row_valid:  bool[W].
    """

    paths: torch.Tensor
    usage0: torch.Tensor
    subtree_q: torch.Tensor
    guaranteed: torch.Tensor
    borrow_lim: torch.Tensor
    weight: torch.Tensor
    parent_loc: torch.Tensor
    depth_s: torch.Tensor
    is_cq: torch.Tensor
    svalid: torch.Tensor
    anc_of_head: torch.Tensor
    hrow: torch.Tensor
    need_qty: torch.Tensor
    res_of: torch.Tensor
    crow: torch.Tensor
    cqty: torch.Tensor
    cvalid: torch.Tensor
    row_valid: torch.Tensor


class FairResult(NamedTuple):
    """targets: bool[W, V] the candidate is a victim; fits: bool[W]."""

    targets: torch.Tensor
    fits: torch.Tensor


# ---- the plain torch version --------------------------------------------


def _lendable(p: FairProblem, depth: int, n_res: int) -> torch.Tensor:
    """potentialAvailable of each node's PARENT summed per resource
    bucket (fair_sharing.go:90-104): quota only, so once per problem.
    Returns int64[W, S, R], 0 at roots."""
    w, s, cu = p.subtree_q.shape
    w_idx = torch.arange(w, device=p.subtree_q.device)[:, None]
    parent = p.parent_loc.clamp_min(0).long()
    pot = p.subtree_q.clone()
    has_borrow = p.borrow_lim < NO_LIMIT
    capped = p.subtree_q + p.borrow_lim
    for d in range(1, depth + 1):
        v = p.guaranteed + pot[w_idx, parent]
        v = torch.where(has_borrow, torch.minimum(capped, v), v)
        pot = torch.where((p.depth_s == d)[:, :, None], v, pot)
    lend = torch.zeros((w, s, n_res), dtype=I64, device=pot.device)
    lend.scatter_add_(2, p.res_of.long()[:, None, :].expand(w, s, cu), pot[w_idx, parent])
    return torch.where((p.parent_loc >= 0)[:, :, None], lend, 0)


def _drs_panel(p: FairProblem, usage, lendable, n_res: int) -> torch.Tensor:
    """all_node_drs on the local panels (fair_sharing.go:49-104):
    int64[W, S]."""
    w, s, cu = usage.shape
    borrowed_c = (usage - p.subtree_q).clamp_min(0)
    borrowed = torch.zeros((w, s, n_res), dtype=I64, device=usage.device)
    borrowed.scatter_add_(2, p.res_of.long()[:, None, :].expand(w, s, cu), borrowed_c)
    ratio = torch.where(
        (borrowed > 0) & (lendable > 0), borrowed * 1000 // lendable.clamp_min(1), -1
    )
    drs = ratio.amax(dim=2)
    active = (borrowed > 0).any(dim=2) & (p.parent_loc >= 0)
    num = drs * 1000
    trunc = torch.sign(num) * (num.abs() // p.weight.clamp_min(1))
    return torch.where(active, torch.where(p.weight == 0, DRS_MAX, trunc), 0)


def _tournament(p: FairProblem, drs, avail_v, pruned2, hrow, root_row, depth: int):
    """next_target: the host walk with recomputed pruning, per row.
    Returns int64[W] local ClusterQueue row or -1."""
    w, s = drs.shape
    dev = drs.device
    w_idx = torch.arange(w, device=dev)
    s_idx = torch.arange(s, device=dev)[None, :]
    has_c = torch.zeros((w, s + 1), dtype=BOOL, device=dev)
    has_c.scatter_(1, torch.where(avail_v, p.crow.long(), s), True)
    has_c = has_c[:, :s]
    elig_cq = (
        p.is_cq & p.svalid & has_c & ~pruned2 & ~((drs == 0) & (s_idx != hrow[:, None]))
    )
    # cohort walkability, bottom-up: the subtree holds an eligible
    # ClusterQueue reachable through walkable cohorts
    ok = elig_cq & p.is_cq
    parent = p.parent_loc.clamp_min(0).long()
    is_root_row = s_idx == root_row[:, None]
    walkable = (~p.is_cq & ((drs != 0) | p.anc_of_head | is_root_row)) | is_root_row
    for d in range(depth, 0, -1):
        contrib = ok & (p.depth_s == d) & (p.parent_loc >= 0)
        gathered = torch.zeros((w, s), dtype=I32, device=dev)
        gathered.scatter_reduce_(1, parent, contrib.to(I32), "amax")
        ok = ok | ((gathered > 0) & walkable)

    cur = root_row.clone()
    pick = torch.full((w,), -1, dtype=I64, device=dev)
    done = ~ok[w_idx, cur]
    neg = torch.tensor(-1, dtype=I64, device=dev)
    for _ in range(depth + 1):
        child = p.svalid & (p.parent_loc.long() == cur[:, None])
        cq_ch = child & elig_cq
        co_ch = child & ~p.is_cq & ok
        best_cq_drs = torch.where(cq_ch, drs, neg).amax(dim=1)
        best_cq = torch.where(cq_ch & (drs == best_cq_drs[:, None]), s_idx, neg).amax(dim=1)
        best_co_drs = torch.where(co_ch, drs, neg).amax(dim=1)
        best_co = torch.where(co_ch & (drs == best_co_drs[:, None]), s_idx, neg).amax(dim=1)
        go_cohort = (best_co >= 0) & ((best_cq < 0) | (best_co_drs >= best_cq_drs))
        pick = torch.where(done, pick, torch.where(go_cohort, neg, best_cq))
        done = done | ~go_cohort
        cur = torch.where(go_cohort, best_co, cur)
    rootless = p.parent_loc[w_idx, hrow] < 0
    own = torch.where(has_c[w_idx, hrow], hrow, neg)
    return torch.where(rootless, own, pick)


def _almost_lca(paths, row, lca):
    """The node on ``row``'s path just below ``lca`` (int64[W])."""
    w_idx = torch.arange(paths.shape[0], device=paths.device)
    path = paths[w_idx, row.clamp_min(0)].long()  # [W, D+1]
    pos = (path == lca[:, None]).to(I32).argmax(dim=1)
    return path[w_idx, (pos - 1).clamp_min(0)]


def solve_fair(p: FairProblem, depth: int, n_cand: int, n_local: int, n_res: int,
               strategy1: int, has_second: bool, trace: Optional[dict] = None) -> FairResult:
    """Every row's fair victim tournament, then its fill-back (the JAX
    ``_solve_one_fair`` vmapped over rows): ``n_res`` resource buckets
    (the inert one included), at most ``2V + S + 4`` picks a row.
    ``trace``, when given, receives each row's tournament iterations
    ("iterations") and accepted removals before the fill-back
    ("removed"), int64[W] (perf/kernel_ab.py's chain bound, the tests'
    edge guards)."""
    w = p.hrow.shape[0]
    dev = p.usage0.device
    w_idx = torch.arange(w, device=dev)
    v_ar = torch.arange(n_cand, device=dev)[None, :]
    hrow = p.hrow.clamp_min(0).long()
    hpath = p.paths[w_idx, hrow]
    need = p.need_qty > 0
    root_pos = (hpath >= 0).to(I64).sum(dim=1) - 1
    root_row = hpath[w_idx, root_pos.clamp_min(0)].long()
    crow = p.crow.long()
    lendable = _lendable(p, depth, n_res)
    all_rows = torch.ones(w, dtype=BOOL, device=dev)

    def fits_at_head(usage):
        avail = _avail_local(hpath, usage, p.subtree_q, p.guaranteed, p.borrow_lim,
                             depth).clamp_min(0)
        return torch.where(need, avail >= p.need_qty, True).all(dim=1)

    def fits_without_head(usage):
        u2 = usage.clone()
        _bubble_local(hpath, -p.need_qty, u2, p.guaranteed, depth, all_rows)
        return fits_at_head(u2)

    usage = p.usage0.clone()
    removed = torch.zeros((w, n_cand), dtype=BOOL, device=dev)
    rstep = torch.full((w, n_cand), -1, dtype=I64, device=dev)
    retried = torch.zeros_like(removed)
    pruned2 = torch.zeros((w, n_local), dtype=BOOL, device=dev)
    phase = torch.ones(w, dtype=I64, device=dev)
    done = ~p.row_valid
    fits = torch.zeros(w, dtype=BOOL, device=dev)
    n_removed = torch.zeros(w, dtype=I64, device=dev)
    iterations = torch.zeros(w, dtype=I64, device=dev)
    for _ in range(2 * n_cand + n_local + 4):
        live = ~done
        if not bool(live.any()):
            break  # every row has left its loop
        iterations += live.to(I64)
        avail_v = p.cvalid & ~removed & torch.where((phase == 1)[:, None], ~retried, retried)
        drs = _drs_panel(p, usage, lendable, n_res)
        pick = _tournament(
            p, drs, avail_v, pruned2 & (phase == 2)[:, None], hrow, root_row, depth
        )
        # pick == -1: the phase transition, or give up
        to_phase2 = live & (pick < 0) & (phase == 1) & has_second
        give_up = live & (pick < 0) & ~to_phase2
        phase = torch.where(to_phase2, 2, phase)
        done = done | give_up

        pick_c = pick.clamp_min(0)
        act = live & (pick >= 0) & ~done
        cond = (crow == pick_c[:, None]) & avail_v
        v = torch.where(cond, v_ar, n_cand).argmin(dim=1)
        act = act & cond.any(dim=1)
        own = act & (pick == hrow) & (phase == 1)

        # lca_of: the target's first ancestor that is also a head
        # ancestor, for both shares
        tpath = p.paths[w_idx, pick_c].long()
        in_anc = p.anc_of_head[w_idx[:, None], tpath.clamp_min(0)] & (tpath >= 0)
        lca = tpath[w_idx, in_anc.to(I32).argmax(dim=1)]
        head_node = _almost_lca(p.paths, hrow, lca).clamp_min(0)
        tgt_node = _almost_lca(p.paths, pick_c, lca).clamp_min(0)
        pre_share = drs[w_idx, head_node]
        tgt_old = drs[w_idx, tgt_node]

        # the probe removal (the strategy gate's and the accepted path's)
        vrow = crow[w_idx, v].clamp_min(0)
        usage_probe = usage.clone()
        _bubble_local(p.paths[w_idx, vrow], -p.cqty[w_idx, v], usage_probe, p.guaranteed,
                      depth, act)
        tgt_new = _drs_panel(p, usage_probe, lendable, n_res)[w_idx, tgt_node]
        if strategy1 == LESS_THAN_OR_EQUAL_TO_FINAL:
            allowed_s1 = pre_share <= tgt_new
        else:
            allowed_s1 = pre_share < tgt_old
        allowed_s2 = pre_share < tgt_old
        accept = act & (
            own | ((phase == 1) & ~own & allowed_s1) | ((phase == 2) & allowed_s2)
        )
        reject1 = act & (phase == 1) & ~own & ~allowed_s1

        usage = torch.where(accept[:, None, None], usage_probe, usage)
        hit = v_ar == v[:, None]
        removed = removed | (hit & accept[:, None])
        rstep = torch.where(hit & accept[:, None], n_removed[:, None], rstep)
        n_removed = n_removed + accept.to(I64)
        retried = retried | (hit & reject1[:, None])
        # the second strategy drops the picked queue whatever the gate says
        pruned2[w_idx, pick_c] = pruned2[w_idx, pick_c] | (act & (phase == 2))

        now_fits = accept & fits_without_head(usage)
        fits = fits | now_fits
        done = done | now_fits
    fits = fits & p.row_valid
    if trace is not None:
        trace["iterations"], trace["removed"] = iterations, n_removed.clone()

    # fill-back: reverse removal order, skipping the last removal
    _bubble_local(hpath, -p.need_qty, usage, p.guaranteed, depth, fits)
    for s in range(n_cand - 2, -1, -1):
        cond = rstep == s
        act = fits & cond.any(dim=1) & (s <= n_removed - 2)
        if not bool(act.any()):
            continue
        v = cond.to(I32).argmax(dim=1)
        vrow = crow[w_idx, v].clamp_min(0)
        u2 = usage.clone()
        _bubble_local(p.paths[w_idx, vrow], p.cqty[w_idx, v], u2, p.guaranteed, depth, act)
        keep = act & fits_at_head(u2)
        usage = torch.where(keep[:, None, None], u2, usage)
        removed = removed & ~((v_ar == v[:, None]) & keep[:, None])
    return FairResult(targets=removed & fits[:, None], fits=fits)


def _pack(r: FairResult) -> torch.Tensor:
    return torch.cat([r.targets.to(I32).reshape(-1), r.fits.to(I32)])


# ---- kernel B9 (csrc/fair_search.cu) --------------------------------------

_FIELDS = (
    ("paths", I32), ("usage0", I64), ("subtree_q", I64), ("guaranteed", I64),
    ("borrow_lim", I64), ("weight", I64), ("parent_loc", I32), ("depth_s", I32),
    ("is_cq", BOOL), ("svalid", BOOL), ("anc_of_head", BOOL), ("hrow", I32),
    ("need_qty", I64), ("res_of", I32), ("crow", I32), ("cqty", I64), ("cvalid", BOOL),
    ("row_valid", BOOL),
)


def _launch(p: FairProblem, depth: int, n_cand: int, n_local: int, n_res: int,
            strategy1: int, has_second: bool) -> torch.Tensor:
    w, s, d1 = p.paths.shape
    cu = p.usage0.shape[2]
    v = n_cand
    if (s > MAX_NODES or cu > MAX_CELLS or n_res > MAX_BUCKETS or v > MAX_CANDIDATES
            or d1 != depth + 1 or s != n_local):
        raise _build.KernelInputError(
            f"{KERNEL}: takes S<={MAX_NODES} nodes, Cu<={MAX_CELLS} cells, "
            f"R<={MAX_BUCKETS} buckets, V<={MAX_CANDIDATES} candidates and paths "
            f"of depth+1 entries; got S={s} (n_local {n_local}), Cu={cu}, R={n_res}, V={v}, "
            f"paths {d1} for depth {depth}"
        )
    ws, wsc = (w, s), (w, s, cu)
    shapes = {
        "paths": (w, s, d1), "weight": ws, "parent_loc": ws, "depth_s": ws, "is_cq": ws,
        "svalid": ws, "anc_of_head": ws, "hrow": (w,), "need_qty": (w, cu),
        "res_of": (w, cu), "crow": (w, v), "cqty": (w, v, cu), "cvalid": (w, v),
        "row_valid": (w,),
    }
    ptrs = [
        _build.ptr(KERNEL, name, getattr(p, name), dt, shapes.get(name, wsc))
        for name, dt in _FIELDS
    ]
    out = torch.empty(w * v + w, dtype=I32, device=p.usage0.device)
    ptrs.append(out.data_ptr())
    fn = _build.c_function(
        KERNEL, KERNEL,
        [ctypes.c_int] * 8 + [ctypes.c_void_p] * len(ptrs) + [ctypes.c_void_p],
    )
    _build.note_launch(KERNEL)
    _build.check(
        fn(w, s, cu, v, depth, n_res, int(strategy1), int(bool(has_second)), *ptrs,
           _build.stream_ptr(p.usage0.device)),
        KERNEL,
    )
    return out


def solve_fair_packed(p: FairProblem, depth: int, n_cand: int, n_local: int, n_res: int,
                      strategy1: int, has_second: bool) -> torch.Tensor:
    """Every row's fair victim search, packed: int32[W*V] targets (row
    major), then int32[W] fits. Kernel B9 on a CUDA problem (it raises
    ``KernelError`` on what it cannot take), the plain version on a CPU
    one."""
    if not p.usage0.is_cuda:
        return _pack(solve_fair(p, depth, n_cand, n_local, n_res, strategy1, has_second))
    return _launch(p, depth, n_cand, n_local, n_res, strategy1, has_second)
