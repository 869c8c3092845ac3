"""Host glue for the batched preemption kernel (ops/preempt_kernel.py,
kernel B8); port of the classic half of kueue_tpu/core/preempt_batch.py.

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

Fair-sharing preemption (``batched_fair_get_targets``, kernel B9) is not
ported yet (ROADMAP A6b).
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
# padding caps, kernel B8's limits: above them the host Preemptor
# searches the head
from kueue_tpu_torch.ops.preempt_kernel import MAX_CANDIDATES, MAX_CELLS


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


def batched_get_targets(
    snapshot: Snapshot,
    items: Sequence[Tuple[Workload, str, AssignmentResult]],
    preemptor,
    device=None,
) -> List[List[PreemptionTarget]]:
    """Victim sets for every preempt-mode head, one launch of kernel B8
    on ``device`` (the card unless the caller names the CPU, where the
    plain version runs). Heads beyond the padding caps are searched by
    the host Preemptor. Decision parity with preemptor.get_targets and
    with the JAX package is asserted in tests/test_torch_preempt.py.
    A fair-sharing preemptor is not ported yet (NotImplementedError)."""
    from kueue_tpu_torch._torch import resolve_device
    from kueue_tpu_torch.interop import preempt_problem
    from kueue_tpu_torch.ops.preempt_kernel import solve_preempt_packed

    if preemptor.enable_fair_sharing:
        raise NotImplementedError(
            "fair-sharing victim search (batched_fair_get_targets, kernel B9) is not "
            "ported yet (ROADMAP A6b)"
        )
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
    problem = preempt_problem(arrays, dev)
    flat = solve_preempt_packed(
        problem, depth=lowered.depth, n_cand=lowered.n_cand
    ).cpu().numpy()  # one fetch
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
