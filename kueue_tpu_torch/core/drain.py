"""Bulk admission drain — host glue for ops/drain_kernel.py (port of
the plain scope of kueue_tpu/core/drain.py).

Lowers an entire pending backlog (every queued workload, not just the
cycle heads) into dense per-CQ queue tensors, runs the multi-cycle
drain on the card (kernels 1-4, ops/quota.py and ops/drain_kernel.py),
fetches the packed result in ONE device-to-host copy and maps the
decisions back to workloads. Workloads the dense form can't express
are reported in ``fallback``.

This slice carries the plain drain: ``plan_drain``, ``run_drain``,
``DrainLaunch.fetch`` and ``_map_drain_result``. The fair, preempt,
fair-preempt, TAS and megaloop drains, mesh sharding and admission
policies are not ported yet; ``run_drain`` raises NotImplementedError
for them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kueue_tpu_torch.models import ResourceFlavor, Workload
from kueue_tpu_torch.core.snapshot import Snapshot
from kueue_tpu_torch.core.solver import (
    MultiLowered,
    _bucket,
    lower_heads_multi,
    tree_arrays,
)


@dataclass
class DrainPlan:
    queues_np: dict  # field name -> numpy array (DrainQueues layout)
    # (q, pos) -> index into lowered.heads
    head_of: Dict[Tuple[int, int], int]
    lowered: MultiLowered
    cq_order: List[str]  # queue index -> cq name
    n_segments: int
    n_steps: int
    max_cycles: int
    fallback: List[int] = field(default_factory=list)


@dataclass
class DrainOutcome:
    # (workload, cq_name, resource->flavor map, cycle index)
    admitted: List[Tuple[Workload, str, Dict[str, str], int]]
    parked: List[Tuple[Workload, str]]
    fallback: List[Tuple[Workload, str]]
    cycles: int
    # max_cycles hit before quiescence: entries the kernel never
    # processed were routed to ``fallback`` (not parked), so the cycle
    # loop — not a silent park — decides them
    truncated: bool = False
    # the truncation-routed subset of ``fallback``: entries the kernel
    # simply never reached before max_cycles (NOT structurally
    # unrepresentable, NOT stuck-frozen) — re-running the drain over
    # exactly these from the post-apply state continues where this
    # chunk stopped. The pipelined drain loop (core/pipeline.py) feeds
    # them to the next round.
    undecided: List[Tuple[Workload, str]] = field(default_factory=list)
    # final leaf usage [N, FR] as the kernel left it — the speculative
    # post-apply snapshot the pipeline launches round t+1 against
    # (None on paths that don't report it)
    final_usage: Optional[np.ndarray] = None


def _admitted_flavors(lowered, i: int, adm_k_row) -> Dict[str, str]:
    """resource -> flavor map of an admitted head.

    Single-podset heads keep the flat {resource: flavor} shape; a
    multi-podset head returns {podset name: {resource: flavor}} (the
    per-PodSetAssignment flavors of the reference Admission)."""
    npods = int(lowered.n_podsets[i])
    wl = lowered.heads[i]
    if npods <= 1:
        return dict(lowered.candidate_flavors[i][0][int(adm_k_row[0])])
    return {
        wl.pod_sets[pp].name: dict(
            lowered.candidate_flavors[i][pp][int(adm_k_row[pp])]
        )
        for pp in range(npods)
    }


def plan_drain(
    snapshot: Snapshot,
    pending: Sequence[Tuple[Workload, str]],
    flavors: Dict[str, ResourceFlavor],
    max_candidates: int = 8,
    max_cells: int = 4,
    timestamp_fn=None,
    max_podsets: int = 4,
    allow_tas: bool = False,
    policy=None,  # admission policy: only the default (None) is ported
    now: float = 0.0,  # policy clock (deadline boosts)
) -> DrainPlan:
    """Lower the backlog and pack it into per-CQ queue tensors.

    ``pending`` must be in per-CQ heap order (priority desc, timestamp
    asc — use QueueManager pending snapshots); relative order across
    CQs is irrelevant.
    """
    from kueue_tpu_torch.ops.assign_kernel import build_roots

    if policy is not None and not policy.is_default:
        raise NotImplementedError(
            "admission policies (kueue_tpu/policy) are not ported yet: "
            "the port's drain is first-fit (all-zero scores)"
        )
    lowered = lower_heads_multi(
        snapshot, pending, flavors, max_candidates, max_cells, max_podsets,
        timestamp_fn, any_fungibility=True, allow_tas=allow_tas,
    )
    fallback = set(lowered.fallback)

    by_cq: Dict[str, List[int]] = {}
    for i, cq_name in enumerate(lowered.cq_names):
        if i in fallback:
            continue
        by_cq.setdefault(cq_name, []).append(i)

    cq_order = sorted(by_cq)
    q = max(len(cq_order), 1)
    l = max((len(v) for v in by_cq.values()), default=1)
    k, c = max_candidates, max_cells
    # P = widest podset vector among representable heads (padded
    # podsets are inert in the kernel: no cells, mode FIT)
    pdim = max(
        [1]
        + [
            int(lowered.n_podsets[i])
            for i in range(len(lowered.heads))
            if i not in fallback
        ]
    )

    cq_rows = np.full(q, -1, dtype=np.int32)
    qlen = np.zeros(q, dtype=np.int32)
    n_podsets = np.ones((q, l), dtype=np.int32)
    cells = np.full((q, l, pdim, k, c), -1, dtype=np.int32)
    qty = np.zeros((q, l, pdim, k, c), dtype=np.int64)
    valid = np.zeros((q, l, pdim, k), dtype=bool)
    # per-group candidate cursor inputs (drain_kernel.DrainQueues):
    # G = widest resource-group vector among representable heads
    g = max(
        [1]
        + [
            lowered.n_groups[i]
            for i in range(len(lowered.heads))
            if i not in fallback
        ]
    )
    gidx = np.zeros((q, l, pdim, k, g), dtype=np.int32)
    glast = np.zeros((q, l, pdim, k, g), dtype=bool)
    cgrp = np.full(cells.shape, -1, dtype=np.int8)
    # policy candidate scores (zeros = the default first-fit policy —
    # the kernels' score-argmax then IS the first-fit walk)
    score = np.zeros((q, l, pdim, k), dtype=np.int64)
    ffb = np.ones(q, dtype=bool)
    ffp = np.zeros(q, dtype=bool)
    # convergent-retry budget per queue: the max joint cursor-odometer
    # size of its entries (clamped; see drain_kernel stuck machinery)
    retry_cap = np.full(q, 2 * max_candidates + 2, dtype=np.int32)
    priority = np.zeros((q, l), dtype=np.int64)
    timestamp = np.zeros((q, l), dtype=np.int64)
    no_reclaim = np.zeros(q, dtype=bool)
    head_of: Dict[Tuple[int, int], int] = {}

    cursor_rows_of: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for qi, cq_name in enumerate(cq_order):
        idxs = by_cq[cq_name]
        cq_rows[qi] = snapshot.row(cq_name)
        qlen[qi] = len(idxs)
        no_reclaim[qi] = bool(lowered.no_reclaim[idxs[0]])
        ffb[qi] = bool(lowered.ffb[idxs[0]])
        ffp[qi] = bool(lowered.ffp[idxs[0]])
        retry_cap[qi] = min(
            4096, max(lowered.walk_states[i] for i in idxs) + 1
        )
        n = len(idxs)
        idx_arr = np.asarray(idxs, dtype=np.int64)
        n_podsets[qi, :n] = lowered.n_podsets[idx_arr]
        cells[qi, :n] = lowered.cells[idx_arr, :pdim]
        qty[qi, :n] = lowered.qty[idx_arr, :pdim]
        valid[qi, :n] = lowered.valid[idx_arr, :pdim]
        cgrp[qi, :n] = lowered.cgrp[idx_arr, :pdim]
        if lowered.score is not None:
            score[qi, :n] = lowered.score[idx_arr, :pdim]
        priority[qi, :n] = lowered.priority[idx_arr]
        timestamp[qi, :n] = lowered.timestamp[idx_arr]
        for pos, i in enumerate(idxs):
            head_of[(qi, pos)] = i
            for pp in range(int(lowered.n_podsets[i])):
                groups = lowered.candidate_groups[i][pp]
                # group lists are shared per lowering template: memoize
                # the dense cursor rows per list identity
                rows = cursor_rows_of.get(id(groups))
                if rows is None:
                    gi_row = np.zeros((k, g), dtype=np.int32)
                    # pad group slots (heads touching fewer than G
                    # groups) must stay permanently eligible:
                    # glast=True makes the resumed start 0
                    gl_row = np.ones((k, g), dtype=bool)
                    for kk, gvec in enumerate(groups):
                        for gx, (fi, lastf) in enumerate(gvec):
                            gi_row[kk, gx] = fi
                            gl_row[kk, gx] = lastf
                    rows = (gi_row, gl_row)
                    cursor_rows_of[id(groups)] = rows
                gidx[qi, pos, pp] = rows[0]
                glast[qi, pos, pp] = rows[1]

    roots = build_roots(snapshot.flat.parent)
    seg_id = np.full(q, -1, dtype=np.int32)
    live = cq_rows >= 0
    if live.any():
        uniq, inv = np.unique(roots[cq_rows[live]], return_inverse=True)
        seg_id[live] = inv.astype(np.int32)
        n_segments = _bucket(len(uniq), minimum=8)
        n_steps = _bucket(int(np.bincount(inv).max()), minimum=8)
        # Sound cycle cap: every cycle, each root cohort with live heads
        # retires at least one entry OR advances some head's per-group
        # flavor cursor — its rank-0 valid head admits (no in-segment
        # predecessor has touched usage yet); NoFit heads park unless a
        # group's walk stored a pending cursor, in which case the
        # cursor strictly advances and can do so at most K times per
        # entry before the walk exhausts and parks. Conflict-lost heads
        # retrying per remaining candidate pair with a same-segment
        # admission that cycle. So cycles <= largest segment's entries
        # x (1 + K pending retries each).
        max_seg_events = int(
            np.bincount(inv, weights=qlen[live].astype(np.float64)).max()
        ) * (int(retry_cap.max()) + 1)
    else:
        n_segments = n_steps = 8
        max_seg_events = 0

    return DrainPlan(
        queues_np=dict(
            cq_rows=cq_rows,
            seg_id=seg_id,
            qlen=qlen,
            cells=cells,
            qty=qty,
            valid=valid,
            n_podsets=n_podsets,
            gidx=gidx,
            glast=glast,
            cgrp=cgrp,
            ffb=ffb,
            ffp=ffp,
            retry_cap=retry_cap,
            priority=priority,
            timestamp=timestamp,
            no_reclaim=no_reclaim,
            score=score,
        ),
        head_of=head_of,
        lowered=lowered,
        cq_order=cq_order,
        n_segments=n_segments,
        n_steps=n_steps,
        # the drain stops at quiescence; this is a backstop only,
        # bucketed as the JAX package buckets it (see _bucket)
        max_cycles=_bucket(max_seg_events + 8, minimum=16),
        # the COMPLETE fallback set — outcome mapping must use this,
        # not lowered.fallback, or extra exclusions silently vanish
        fallback=sorted(fallback),
    )


@dataclass
class DrainLaunch:
    """A plain-drain solve and its packed result, still on the device.

    ``fetch()`` makes the ONE device-to-host copy and maps decisions
    back to workloads."""

    plan: DrainPlan
    queues_np: dict
    flat_dev: object  # int64 tensor, _solve_drain_packed layout
    usage_shape: Tuple[int, int]

    def fetch(self) -> DrainOutcome:
        flat = self.flat_dev.cpu().numpy()  # the single fetch
        nq, nl, npd = self.queues_np["cells"].shape[:3]  # incl. padding
        ql = nq * nl
        qlp = nq * nl * npd
        adm_k = flat[:qlp].reshape((nq, nl, npd))
        adm_cycle = flat[qlp : qlp + ql].reshape((nq, nl))
        cursor = flat[qlp + ql : qlp + ql + nq]
        stuck_q = flat[qlp + ql + nq : qlp + ql + 2 * nq].astype(bool)
        off = qlp + ql + 2 * nq
        n_u = int(self.usage_shape[0]) * int(self.usage_shape[1])
        final_usage = flat[off : off + n_u].reshape(self.usage_shape)
        cycles = int(flat[-1])
        return _map_drain_result(
            self.plan, adm_k, adm_cycle, cursor, stuck_q, cycles,
            self.queues_np, [], final_usage=final_usage,
        )


def run_drain(
    snapshot: Snapshot,
    pending: Sequence[Tuple[Workload, str]],
    flavors: Dict[str, ResourceFlavor],
    max_candidates: int = 8,
    max_cells: int = 4,
    timestamp_fn=None,
    max_cycles: Optional[int] = None,
    mesh=None,
    fair_sharing: bool = False,
    policy=None,
    now: float = 0.0,
    device=None,
) -> DrainOutcome:
    """Plan + solve + map back, with one device-to-host copy.

    Runs on the card: ``device`` defaults to ``cuda`` and raises where
    there is none; ``device="cpu"`` runs the plain torch versions of
    the kernels on the host. ``max_cycles`` overrides the computed
    backstop. Fair sharing, mesh sharding and non-default admission
    policies are not ported yet and raise NotImplementedError."""
    from kueue_tpu_torch._torch import resolve_device
    from kueue_tpu_torch.interop import drain_queues
    from kueue_tpu_torch.ops.drain_kernel import _solve_drain_packed

    if fair_sharing:
        raise NotImplementedError("the fair-sharing drain is not ported yet")
    if mesh is not None:
        raise NotImplementedError("mesh-sharded drains are not ported yet")
    dev = resolve_device(device)
    plan = plan_drain(
        snapshot, pending, flavors, max_candidates, max_cells, timestamp_fn,
        policy=policy, now=now,
    )
    if max_cycles is not None:
        plan.max_cycles = max_cycles
    tree, paths, _ = tree_arrays(snapshot, dev)
    usage_in = tree.nominal.new_tensor(snapshot.local_usage)
    queues = drain_queues(plan.queues_np, dev)
    flat_dev = _solve_drain_packed(
        tree,
        usage_in,
        queues,
        paths,
        n_segments=plan.n_segments,
        n_steps=plan.n_steps,
        max_cycles=plan.max_cycles,
    )
    return DrainLaunch(
        plan=plan,
        queues_np=plan.queues_np,
        flat_dev=flat_dev,
        usage_shape=tuple(snapshot.local_usage.shape),
    ).fetch()


def _map_drain_result(
    plan: DrainPlan,
    adm_k,
    adm_cycle,
    cursor,
    stuck_q,
    cycles: int,
    queues_np: dict,
    extra_fb_entries: List[Tuple[Workload, str]],
    final_usage: Optional[np.ndarray] = None,
) -> DrainOutcome:
    """Map a plain drain's per-queue result tensors back onto workloads
    — ONE definition shared by the device fetch and the numpy host
    mirror, so the two paths cannot disagree on outcome decoding."""
    # stuck-frozen queues are terminal no-decisions, not truncation
    truncated = bool(np.any((cursor < queues_np["qlen"]) & ~stuck_q))

    lowered = plan.lowered
    admitted: List[Tuple[Workload, str, Dict[str, str], int]] = []
    parked: List[Tuple[Workload, str]] = []
    extra_fallback: List[Tuple[Workload, str]] = []
    undecided: List[Tuple[Workload, str]] = []
    for (qi, pos), i in plan.head_of.items():
        wl = lowered.heads[i]
        cq_name = lowered.cq_names[i]
        kk = int(adm_k[qi, pos, 0])
        if kk >= 0:
            admitted.append(
                (wl, cq_name, _admitted_flavors(lowered, i, adm_k[qi, pos]),
                 int(adm_cycle[qi, pos]))
            )
        elif pos >= int(cursor[qi]):
            # never processed (max_cycles backstop hit): not a decision.
            # Entries of stuck-frozen queues are terminal no-decisions
            # (a rerun cannot resolve them); the rest are undecided and
            # a follow-up chunk from the post-apply state decides them.
            extra_fallback.append((wl, cq_name))
            if not bool(stuck_q[qi]):
                undecided.append((wl, cq_name))
        else:
            parked.append((wl, cq_name))
    admitted.sort(key=lambda t: t[3])
    fb = (
        [(lowered.heads[i], lowered.cq_names[i]) for i in plan.fallback]
        + extra_fb_entries
        + extra_fallback
    )
    return DrainOutcome(
        admitted=admitted, parked=parked, fallback=fb, cycles=cycles,
        truncated=truncated, undecided=undecided, final_usage=final_usage,
    )
