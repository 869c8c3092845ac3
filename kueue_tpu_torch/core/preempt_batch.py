"""Host glue for the batched preemption kernels (ops/preempt_kernel.py,
kernel B8, and ops/fair_preempt_kernel.py, kernel B9); port of
kueue_tpu/core/preempt_batch.py.

Lowers every preempt-mode head of a cycle into local-subtree problems
and resolves ALL victim searches in one launch on the card. The host
keeps the cheap, static parts of ``core/preemption.py``: candidate
discovery under the withinClusterQueue/reclaimWithinCohort policies,
the eviction/priority/timestamp candidate ordering, and the classic
strategy ladder (preemption.go:127-191); the per-candidate
simulate/undo fit evaluations run in the kernel.

Exactness notes:

- every head's search runs against the cycle-start snapshot (matching
  nomination semantics), so heads are independent and batch cleanly;
- the cell universe per head is just the head's own usage cells: the
  fit check reads only those cells, the in-loop borrowing check reads
  only frs_need_preemption cells (a subset), and quota bubbling is
  per-cell independent, so candidate usage outside the head's cells
  cannot influence any decision;
- heads whose candidate or cell count exceeds the padding caps are
  searched by the host Preemptor, which stays the decision authority
  for them (the reference's semantics, not a failover: a kernel that
  cannot run raises).

A fair-sharing preemptor routes to ``batched_fair_get_targets``: each
head lowers to its root cohort's subtree over the subtree's active cell
universe (``lower_fair_preemption``), and kernel B9 runs the fair
victim tournament for every head in one launch, on a narrow and (for
the few heads with deep pools) a full-width candidate panel. Heads
beyond the panel caps (MAX_CANDIDATES candidates, MAX_FAIR_NODES nodes,
MAX_FAIR_CELLS cells) are searched by the host Preemptor.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kueue_tpu_torch.models import Workload
from kueue_tpu_torch.core.flavor_assigner import AssignmentResult
from kueue_tpu_torch.core.scheduler import PreemptionTarget
from kueue_tpu_torch.core.snapshot import Snapshot, WorkloadSnapshot
from kueue_tpu_torch.core.solver import _bucket
from kueue_tpu_torch.ops._build import KernelError
# padding caps, kernel B8's limits: above them the host Preemptor
# searches the head
from kueue_tpu_torch.ops.preempt_kernel import MAX_CANDIDATES, MAX_CELLS

# the fair lowering's caps (the JAX package's): above them the host
# Preemptor searches the head
MAX_FAIR_CELLS = 32
MAX_FAIR_NODES = 64


@dataclass
class _Attempt:
    entry_idx: int
    candidates: List[WorkloadSnapshot]
    allow_borrowing: bool
    threshold: Optional[int]


@dataclass
class LoweredPreemption:
    attempts: List[_Attempt] = field(default_factory=list)
    # entry index -> list of its attempt row ids (ladder order)
    rows_of: Dict[int, List[int]] = field(default_factory=dict)
    fallback: List[int] = field(default_factory=list)
    arrays: Optional[dict] = None
    depth: int = 0
    n_cand: int = 0


class _SubtreeIndex:
    """Local row numbering + paths for one root cohort's subtree."""

    __slots__ = ("rows", "local", "paths")

    def __init__(self, rows: np.ndarray, parent: np.ndarray, max_depth: int):
        self.rows = rows  # global row ids, sorted
        self.local = {int(r): i for i, r in enumerate(rows)}
        d1 = max_depth + 1
        self.paths = np.full((len(rows), d1), -1, dtype=np.int32)
        for i, r in enumerate(rows):
            cur, d = int(r), 0
            while cur >= 0 and d < d1:
                self.paths[i, d] = self.local[cur]
                cur = int(parent[cur])
                d += 1


def _head_candidates(snapshot: Snapshot, item, preemptor):
    """Shared per-head discovery: build the preemption context and the
    sorted candidate list (preemption.go:111-115), used by both the
    classic and the fair lowerings."""
    from kueue_tpu_torch.core.preemption import _Ctx

    wl, cq_name, assignment = item
    ctx = _Ctx(
        preemptor=wl,
        cq_name=cq_name,
        cq_row=snapshot.row(cq_name),
        snapshot=snapshot,
        frs_need_preemption=preemptor._frs_need_preemption(assignment),
        usage_vec=snapshot.vector_of(assignment.usage),
    )
    candidates = preemptor._find_candidates(ctx)
    candidates.sort(key=preemptor._candidate_key(ctx))
    return ctx, candidates


def lower_preemption(
    snapshot: Snapshot,
    items: Sequence[Tuple[Workload, str, AssignmentResult]],
    preemptor,
) -> LoweredPreemption:
    """items: (workload, cq_name, PREEMPT-mode assignment) per head.
    Classic strategy ladder only — batched_get_targets routes
    fair-sharing heads to lower_fair_preemption before reaching here."""
    from kueue_tpu_torch.ops.assign_kernel import build_roots

    out = LoweredPreemption()
    parent = snapshot.flat.parent
    roots = build_roots(parent)
    max_depth = snapshot.flat.max_depth
    subtrees: Dict[int, _SubtreeIndex] = {}

    per_attempt_meta: List[dict] = []
    for idx, item in enumerate(items):
        wl, cq_name, assignment = item
        ctx, candidates = _head_candidates(snapshot, item, preemptor)
        out.rows_of[idx] = []
        if not candidates:
            continue  # no candidates -> no targets; nothing to dispatch
        if len(candidates) > MAX_CANDIDATES:
            out.fallback.append(idx)
            continue
        cells = [int(j) for j in np.flatnonzero(ctx.usage_vec)]
        if len(cells) > MAX_CELLS:
            out.fallback.append(idx)
            continue

        cq = snapshot.cq_models[cq_name]
        same_queue = [c for c in candidates if c.cq_name == cq_name]
        ladder: List[Tuple[List[WorkloadSnapshot], bool, Optional[int]]] = []
        if len(same_queue) == len(candidates):
            ladder.append((candidates, True, None))
        else:
            allowed, threshold = preemptor._can_borrow_within_cohort(cq, ctx)
            if allowed:
                cands = candidates
                if not preemptor._queue_under_nominal(ctx):
                    cands = [
                        c
                        for c in candidates
                        if c.cq_name == cq_name or c.priority < threshold
                    ]
                ladder.append((cands, True, threshold))
            else:
                if preemptor._queue_under_nominal(ctx):
                    ladder.append((candidates, False, None))
                ladder.append((same_queue, True, None))

        for cands, allow_borrow, thr in ladder:
            row_id = len(out.attempts)
            out.attempts.append(
                _Attempt(
                    entry_idx=idx,
                    candidates=cands,
                    allow_borrowing=allow_borrow,
                    threshold=thr,
                )
            )
            out.rows_of[idx].append(row_id)
            per_attempt_meta.append(
                {"ctx": ctx, "cells": cells, "frs": ctx.frs_need_preemption}
            )

    if not out.attempts:
        return out

    w = len(out.attempts)
    n_cand = _bucket(
        max(len(a.candidates) for a in out.attempts), minimum=8
    )
    cu = _bucket(
        max(len(m["cells"]) for m in per_attempt_meta), minimum=2
    )
    # subtree panels sized to the largest involved root cohort
    needed_roots = {
        int(roots[m["ctx"].cq_row]) for m in per_attempt_meta
    }
    for root in needed_roots:
        if root not in subtrees:
            rows = np.flatnonzero(roots == root)
            subtrees[root] = _SubtreeIndex(rows, parent, max_depth)
    s = _bucket(max(len(subtrees[r].rows) for r in needed_roots), minimum=2)
    d1 = max_depth + 1

    from kueue_tpu_torch.ops.quota import NO_LIMIT

    usage_global = snapshot.usage()
    INT_MIN = np.iinfo(np.int64).min

    paths = np.full((w, s, d1), -1, dtype=np.int32)
    usage0 = np.zeros((w, s, cu), dtype=np.int64)
    leaf0 = np.zeros((w, s, cu), dtype=np.int64)
    nominal = np.zeros((w, s, cu), dtype=np.int64)
    subtree_q = np.zeros((w, s, cu), dtype=np.int64)
    guaranteed = np.zeros((w, s, cu), dtype=np.int64)
    borrow_lim = np.full((w, s, cu), NO_LIMIT, dtype=np.int64)
    hrow = np.zeros(w, dtype=np.int32)
    need_qty = np.zeros((w, cu), dtype=np.int64)
    need_pre = np.zeros((w, cu), dtype=bool)
    allow_borrow = np.zeros(w, dtype=bool)
    has_thr = np.zeros(w, dtype=bool)
    thr = np.full(w, INT_MIN, dtype=np.int64)
    crow = np.zeros((w, n_cand), dtype=np.int32)
    cqty = np.zeros((w, n_cand, cu), dtype=np.int64)
    cvalid = np.zeros((w, n_cand), dtype=bool)
    csame = np.zeros((w, n_cand), dtype=bool)
    cprio = np.zeros((w, n_cand), dtype=np.int64)

    for a_i, (attempt, meta) in enumerate(zip(out.attempts, per_attempt_meta)):
        ctx = meta["ctx"]
        cells = meta["cells"]
        sub = subtrees[int(roots[ctx.cq_row])]
        ns, nc = len(sub.rows), len(cells)
        ix = np.ix_(sub.rows, cells)
        paths[a_i, :ns] = sub.paths
        usage0[a_i, :ns, :nc] = usage_global[ix]
        leaf0[a_i, :ns, :nc] = snapshot.local_usage[ix]
        nominal[a_i, :ns, :nc] = snapshot.nominal[ix]
        subtree_q[a_i, :ns, :nc] = snapshot.subtree[ix]
        guaranteed[a_i, :ns, :nc] = snapshot.guaranteed[ix]
        # padded cells/rows keep the NO_LIMIT init: zero quota + free
        # borrowing is inert in every recurrence
        borrow_lim[a_i, :ns, :nc] = snapshot.borrowing_limit[ix]
        hrow[a_i] = sub.local[ctx.cq_row]
        need_qty[a_i, :nc] = ctx.usage_vec[cells]
        frs_j = {
            snapshot.fr_index[fr]
            for fr in meta["frs"]
            if fr in snapshot.fr_index
        }
        need_pre[a_i, :nc] = [j in frs_j for j in cells]
        allow_borrow[a_i] = attempt.allow_borrowing
        if attempt.threshold is not None:
            has_thr[a_i] = True
            thr[a_i] = attempt.threshold
        for v, ws in enumerate(attempt.candidates):
            crow[a_i, v] = sub.local[ws.cq_row]
            cqty[a_i, v, :nc] = ws.usage_vec[cells]
            cvalid[a_i, v] = True
            csame[a_i, v] = ws.cq_name == ctx.cq_name
            cprio[a_i, v] = ws.priority

    out.arrays = dict(
        paths=paths, usage0=usage0, leaf0=leaf0, nominal=nominal,
        subtree_q=subtree_q, guaranteed=guaranteed, borrow_lim=borrow_lim,
        hrow=hrow, need_qty=need_qty, need_pre=need_pre,
        allow_borrow=allow_borrow, has_thr=has_thr, thr=thr,
        crow=crow, cqty=cqty, cvalid=cvalid, csame=csame, cprio=cprio,
        row_valid=np.ones(w, dtype=bool),
    )
    out.depth = max_depth
    out.n_cand = n_cand
    return out


def _pad_rows(arrays: dict, w_pad: int) -> dict:
    w = arrays["row_valid"].shape[0]
    if w_pad == w:
        return arrays
    out = {}
    for k, v in arrays.items():
        pad_shape = (w_pad - w,) + v.shape[1:]
        if k == "borrow_lim":
            from kueue_tpu_torch.ops.quota import NO_LIMIT

            pad = np.full(pad_shape, NO_LIMIT, dtype=v.dtype)
        elif k == "paths":
            pad = np.full(pad_shape, -1, dtype=v.dtype)
        else:
            pad = np.zeros(pad_shape, dtype=v.dtype)
        out[k] = np.concatenate([v, pad])
    return out


def _fetch(dev, kernel: str, launch) -> np.ndarray:
    """``launch()`` (the upload, the kernel and its packed result) fetched
    to the host. A kernel's fault on the card surfaces as a torch error
    at the first sync after it, here: it is raised as a KernelError,
    which the Scheduler does not contain, so a failing kernel never
    moves a cycle's search to the host Preemptor."""
    import torch

    try:
        return launch().cpu().numpy()
    except KernelError:
        raise
    except RuntimeError as exc:  # torch.AcceleratorError is one
        if dev.type == "cuda" or isinstance(exc, torch.AcceleratorError):
            raise KernelError(f"kernel {kernel} failed on {dev}: {exc}") from exc
        raise


def _reason_for(ws: WorkloadSnapshot, cq_name: str, thr: Optional[int]) -> str:
    from kueue_tpu_torch.core.preemption import (
        IN_CLUSTER_QUEUE,
        IN_COHORT_RECLAIM_WHILE_BORROWING,
        IN_COHORT_RECLAMATION,
    )

    if ws.cq_name == cq_name:
        return IN_CLUSTER_QUEUE
    if thr is not None and ws.priority < thr:
        return IN_COHORT_RECLAIM_WHILE_BORROWING
    return IN_COHORT_RECLAMATION


# ---- fair sharing (ops/fair_preempt_kernel.py, kernel B9) ----


def _bubble_np(paths, local_row, cells_qty, usage, guaranteed):
    """numpy addUsage bubble on a local panel (resource_node.go:123-144)."""
    path = paths[local_row]
    delta = cells_qty.copy()
    for node in path:
        if node < 0:
            break
        old = usage[node].copy()
        usage[node] += delta
        delta = np.maximum(0, usage[node] - guaranteed[node]) - np.maximum(
            0, old - guaranteed[node]
        )
        if not delta.any():
            break
    return usage


def lower_fair_preemption(
    snapshot: Snapshot,
    items: Sequence[Tuple[Workload, str, AssignmentResult]],
    preemptor,
):
    """Lower fair-sharing heads into FairProblem panels. Returns
    (problem_arrays|None, meta) where meta carries per-head candidate
    lists and the fallback indices."""
    from kueue_tpu_torch.core.preemption import LESS_THAN_OR_EQUAL_TO_FINAL_SHARE
    from kueue_tpu_torch.ops.assign_kernel import build_roots
    from kueue_tpu_torch.ops.quota import NO_LIMIT

    parent = snapshot.flat.parent
    roots = build_roots(parent)
    max_depth = snapshot.flat.max_depth
    n_cq = snapshot.flat.n_cq
    subtrees: Dict[int, _SubtreeIndex] = {}

    rows_meta: List[dict] = []
    fallback: List[int] = []
    empty: List[int] = []
    for idx, item in enumerate(items):
        ctx, candidates = _head_candidates(snapshot, item, preemptor)
        if not candidates:
            empty.append(idx)
            continue
        if len(candidates) > MAX_CANDIDATES:
            fallback.append(idx)
            continue
        root = int(roots[ctx.cq_row])
        sub = subtrees.get(root)
        if sub is None:
            rows = np.flatnonzero(roots == root)
            sub = _SubtreeIndex(rows, parent, max_depth)
            subtrees[root] = sub
        if len(sub.rows) > MAX_FAIR_NODES:
            fallback.append(idx)
            continue
        # the ACTIVE cell universe of the whole subtree: DRS aggregates
        # over every cell carrying quota or usage, not just head cells
        panel_rows = sub.rows
        active = (
            (snapshot.nominal[panel_rows] > 0).any(axis=0)
            | (snapshot.local_usage[panel_rows] > 0).any(axis=0)
            | (ctx.usage_vec > 0)
        )
        cells = [int(j) for j in np.flatnonzero(active)]
        if len(cells) > MAX_FAIR_CELLS:
            fallback.append(idx)
            continue
        rows_meta.append(
            {"idx": idx, "ctx": ctx, "cands": candidates, "cells": cells, "sub": sub}
        )

    meta = {"rows": rows_meta, "fallback": fallback, "empty": empty}
    if not rows_meta:
        return None, meta

    w = len(rows_meta)
    s = _bucket(max(len(m["sub"].rows) for m in rows_meta), minimum=2)
    cu = _bucket(max(len(m["cells"]) for m in rows_meta), minimum=2)
    v = _bucket(max(len(m["cands"]) for m in rows_meta), minimum=2)
    d1 = max_depth + 1
    res_names = sorted(
        {snapshot.fr_list[j].resource for m in rows_meta for j in m["cells"]}
    )
    r = max(len(res_names) + 1, 2)  # +1 inert bucket for padded cells
    res_id = {name: i for i, name in enumerate(res_names)}

    usage_global = snapshot.usage()
    depth_global = snapshot.flat.depth

    arrays = dict(
        paths=np.full((w, s, d1), -1, dtype=np.int32),
        usage0=np.zeros((w, s, cu), dtype=np.int64),
        subtree_q=np.zeros((w, s, cu), dtype=np.int64),
        guaranteed=np.zeros((w, s, cu), dtype=np.int64),
        borrow_lim=np.full((w, s, cu), NO_LIMIT, dtype=np.int64),
        weight=np.full((w, s), 1000, dtype=np.int64),
        parent_loc=np.full((w, s), -1, dtype=np.int32),
        depth_s=np.zeros((w, s), dtype=np.int32),
        is_cq=np.zeros((w, s), dtype=bool),
        svalid=np.zeros((w, s), dtype=bool),
        anc_of_head=np.zeros((w, s), dtype=bool),
        hrow=np.zeros(w, dtype=np.int32),
        need_qty=np.zeros((w, cu), dtype=np.int64),
        res_of=np.full((w, cu), r - 1, dtype=np.int32),  # pad: inert bucket
        crow=np.zeros((w, v), dtype=np.int32),
        cqty=np.zeros((w, v, cu), dtype=np.int64),
        cvalid=np.zeros((w, v), dtype=bool),
        row_valid=np.ones(w, dtype=bool),
    )

    for a_i, m in enumerate(rows_meta):
        ctx, sub, cells = m["ctx"], m["sub"], m["cells"]
        ns, nc = len(sub.rows), len(cells)
        ix = np.ix_(sub.rows, cells)
        arrays["paths"][a_i, :ns] = sub.paths
        arrays["usage0"][a_i, :ns, :nc] = usage_global[ix]
        arrays["subtree_q"][a_i, :ns, :nc] = snapshot.subtree[ix]
        arrays["guaranteed"][a_i, :ns, :nc] = snapshot.guaranteed[ix]
        arrays["borrow_lim"][a_i, :ns, :nc] = snapshot.borrowing_limit[ix]
        arrays["weight"][a_i, :ns] = snapshot.weight_milli[sub.rows]
        root_depth = int(depth_global[sub.rows].min())
        for i, grow in enumerate(sub.rows):
            gp = int(parent[grow])
            arrays["parent_loc"][a_i, i] = sub.local.get(gp, -1)
            arrays["depth_s"][a_i, i] = int(depth_global[grow]) - root_depth
            arrays["is_cq"][a_i, i] = grow < n_cq
        arrays["svalid"][a_i, :ns] = True
        for anc in snapshot.path_to_root(ctx.cq_row):
            li = sub.local.get(int(anc))
            if li is not None:
                arrays["anc_of_head"][a_i, li] = True
        hrow_l = sub.local[ctx.cq_row]
        arrays["hrow"][a_i] = hrow_l
        arrays["need_qty"][a_i, :nc] = ctx.usage_vec[cells]
        for ci, j in enumerate(cells):
            arrays["res_of"][a_i, ci] = res_id[snapshot.fr_list[j].resource]
        # the head's usage is part of the simulated state
        # (preemption.go:394-395 AddUsage before DRS)
        _bubble_np(
            arrays["paths"][a_i], hrow_l, arrays["need_qty"][a_i],
            arrays["usage0"][a_i], arrays["guaranteed"][a_i],
        )
        for vi, ws in enumerate(m["cands"]):
            arrays["crow"][a_i, vi] = sub.local[ws.cq_row]
            arrays["cqty"][a_i, vi, :nc] = ws.usage_vec[cells]
            arrays["cvalid"][a_i, vi] = True

    strategy1 = (
        0 if preemptor.fs_strategies[0] == LESS_THAN_OR_EQUAL_TO_FINAL_SHARE else 1
    )
    meta.update(
        arrays=arrays, s=s, cu=cu, v=v, r=r, depth=max_depth,
        strategy1=strategy1, has_second=len(preemptor.fs_strategies) > 1,
    )
    return arrays, meta


def fair_tiers(arrays: dict, meta: dict, mesh=None):
    """The two-tier candidate-panel schedule of ``batched_fair_get_targets``:
    ``[(rows, v_dim, padded row arrays)]`` for the narrow tier and, when
    some head's pool overflows it, the full-width tier (heads whose
    whole pool fits the bucketed-median panel solve at the narrow width,
    exact by membership: a head never sees a truncated view of its own
    pool). Under ``mesh`` one full-width tier, its rows padded to a
    multiple of the mesh's ``wl`` axis, as the JAX package's sharded
    search keeps one dispatch."""
    from kueue_tpu_torch.ops.fair_preempt_kernel import split_panel_rows

    counts = [len(m["cands"]) for m in meta["rows"]]
    if mesh is None:
        v_narrow, narrow_rows, wide_rows = split_panel_rows(counts, meta["v"], _bucket)
    else:
        v_narrow, narrow_rows, wide_rows = meta["v"], list(range(len(counts))), []
    tiers = []
    for rows, v_dim in ((narrow_rows, v_narrow), (wide_rows, meta["v"])):
        if not rows:
            continue
        sub = {
            k: (
                x[rows][:, :v_dim]
                if k in ("crow", "cvalid")
                else x[rows][:, :v_dim, :]
                if k == "cqty"
                else x[rows]
            )
            for k, x in arrays.items()
        }
        w_pad = _bucket(len(rows), minimum=8)
        if mesh is not None:
            from kueue_tpu_torch.parallel.sharded_solver import pad_w_multiple

            w_pad = pad_w_multiple(w_pad, mesh.shape["wl"])
        tiers.append((rows, v_dim, _pad_rows(sub, w_pad)))
    return tiers


def batched_fair_get_targets(
    snapshot: Snapshot,
    items: Sequence[Tuple[Workload, str, AssignmentResult]],
    preemptor,
    mesh=None,
    device=None,
) -> List[List[PreemptionTarget]]:
    """Fair-sharing victim sets for every preempt-mode head, one launch
    of kernel B9 per panel tier on ``device`` (the card unless the
    caller names the CPU, where the plain version runs); heads beyond
    the lowering's caps are searched by the host Preemptor. With
    ``mesh`` (a ``parallel`` Mesh over one device) the head rows are
    padded to a multiple of its ``wl`` axis and placed through
    ``place_fair_problem``, in one full-width launch; a mesh over
    several devices raises NotImplementedError. Parity:
    tests/test_torch_fair_preempt.py."""
    from kueue_tpu_torch._torch import resolve_device
    from kueue_tpu_torch.core.preemption import IN_CLUSTER_QUEUE, IN_COHORT_FAIR_SHARING
    from kueue_tpu_torch.interop import fair_problem
    from kueue_tpu_torch.ops.fair_preempt_kernel import solve_fair_packed

    if mesh is not None:
        from kueue_tpu_torch.parallel.sharded_solver import mesh_device, place_fair_problem

        dev = mesh_device(mesh)

        def problem_of(padded):
            return place_fair_problem(mesh, padded)
    else:
        dev = resolve_device(device)

        def problem_of(padded):
            return fair_problem(padded, dev)
    results: List[List[PreemptionTarget]] = [[] for _ in items]
    arrays, meta = lower_fair_preemption(snapshot, items, preemptor)
    for idx in meta["fallback"]:
        wl, cq_name, assignment = items[idx]
        results[idx] = preemptor.get_targets(wl, cq_name, assignment, snapshot)
    if arrays is None:
        return results

    targets_of = {}
    fits_of = {}
    for rows, v_dim, padded in fair_tiers(arrays, meta, mesh):
        w_pad = padded["row_valid"].shape[0]
        flat = _fetch(dev, "fair_search", lambda: solve_fair_packed(
            problem_of(padded), depth=meta["depth"], n_cand=v_dim,
            n_local=meta["s"], n_res=meta["r"], strategy1=meta["strategy1"],
            has_second=meta["has_second"],
        ))  # one fetch per tier
        tmask = flat[: w_pad * v_dim].reshape(w_pad, v_dim)
        fits = flat[w_pad * v_dim:].astype(bool)
        for out_i, a_i in enumerate(rows):
            targets_of[a_i] = tmask[out_i]
            fits_of[a_i] = bool(fits[out_i])

    for a_i, m in enumerate(meta["rows"]):
        if not fits_of.get(a_i, False):
            continue
        idx = m["idx"]
        cq_name = items[idx][1]
        tmask = targets_of[a_i]
        results[idx] = [
            PreemptionTarget(
                workload=ws,
                reason=IN_CLUSTER_QUEUE if ws.cq_name == cq_name else IN_COHORT_FAIR_SHARING,
            )
            for vi, ws in enumerate(m["cands"])
            if vi < len(tmask) and tmask[vi]
        ]
    return results


def batched_get_targets(
    snapshot: Snapshot,
    items: Sequence[Tuple[Workload, str, AssignmentResult]],
    preemptor,
    device=None,
) -> List[List[PreemptionTarget]]:
    """Victim sets for every preempt-mode head, one launch of kernel B8
    on ``device`` (the card unless the caller names the CPU, where the
    plain version runs); a fair-sharing preemptor goes to
    ``batched_fair_get_targets`` (kernel B9). Heads beyond the padding
    caps are searched by the host Preemptor. Decision parity with
    preemptor.get_targets and with the JAX package is asserted in
    tests/test_torch_preempt.py and tests/test_torch_fair_preempt.py."""
    from kueue_tpu_torch._torch import resolve_device
    from kueue_tpu_torch.interop import preempt_problem
    from kueue_tpu_torch.ops.preempt_kernel import solve_preempt_packed

    if preemptor.enable_fair_sharing:
        return batched_fair_get_targets(snapshot, items, preemptor, device=device)
    dev = resolve_device(device)

    results: List[List[PreemptionTarget]] = [[] for _ in items]
    lowered = lower_preemption(snapshot, items, preemptor)
    for idx in lowered.fallback:
        wl, cq_name, assignment = items[idx]
        results[idx] = preemptor.get_targets(wl, cq_name, assignment, snapshot)
    if not lowered.attempts:
        return results

    arrays = lowered.arrays
    w = arrays["row_valid"].shape[0]
    w_pad = _bucket(w, minimum=8)
    arrays = _pad_rows(arrays, w_pad)
    flat = _fetch(dev, "preempt_search", lambda: solve_preempt_packed(
        preempt_problem(arrays, dev), depth=lowered.depth, n_cand=lowered.n_cand
    ))  # one fetch
    targets_mask = flat[: w_pad * lowered.n_cand].reshape(w_pad, lowered.n_cand)
    fits = flat[w_pad * lowered.n_cand :].astype(bool)

    for idx, rows in lowered.rows_of.items():
        for row_id in rows:
            if not fits[row_id]:
                continue
            attempt = lowered.attempts[row_id]
            cq_name = items[idx][1]
            results[idx] = [
                PreemptionTarget(
                    workload=ws,
                    reason=_reason_for(ws, cq_name, attempt.threshold),
                )
                for v, ws in enumerate(attempt.candidates)
                if targets_mask[row_id, v]
            ]
            break  # first fitting ladder attempt wins
    return results
