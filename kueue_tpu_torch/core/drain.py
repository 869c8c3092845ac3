"""Bulk admission drain — host glue for ops/drain_kernel.py (port of
the plain scope of kueue_tpu/core/drain.py).

Lowers an entire pending backlog (every queued workload, not just the
cycle heads) into dense per-CQ queue tensors, runs the multi-cycle
drain on the card (kernels 1-4, ops/quota.py and ops/drain_kernel.py),
fetches the packed result in ONE device-to-host copy and maps the
decisions back to workloads. Workloads the dense form can't express
are reported in ``fallback``.

Ported: the plain drain (``plan_drain``, ``run_drain``,
``launch_drain`` and its ``DrainLaunch``), the fair-sharing drain
(``run_drain(fair_sharing=True)``), the K-round megaloop
(``launch_drain_megaloop`` and its ``MegaloopLaunch``, with the numpy
host twin ``run_drain_megaloop_host``), and the scope routing
(``classify_drain_scope``, ``run_drain_for_scope``,
``launch_drain_for_scope``). The preempt, fair-preempt and TAS drains,
mesh sharding and non-default admission policies are not ported yet
and raise NotImplementedError.
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


def _fair_lendable(snapshot: Snapshot, paths_np: np.ndarray):
    """(depth_of, lendable, res_of_fr) for the fair-sharing drain.

    lendable depends on quota only: potentialAvailable of the PARENT,
    summed per resource (fair_sharing.go:90-104)."""
    from kueue_tpu_torch.ops.quota_np import potential_available_all_np

    parent = snapshot.flat.parent
    depth_of = (np.sum(paths_np >= 0, axis=1) - 1).astype(np.int32)
    pot = potential_available_all_np(
        parent, snapshot.flat.level_masks(), snapshot.subtree,
        snapshot.guaranteed, snapshot.borrowing_limit,
    )
    n_res = len(snapshot.resource_names)
    lendable = np.zeros((len(parent), n_res), dtype=np.int64)
    parent_pot = pot[np.maximum(parent, 0)]
    np.add.at(lendable.T, snapshot.resource_index, parent_pot.T)
    lendable[parent < 0] = 0
    return depth_of, lendable, snapshot.resource_index.astype(np.int32)


def _preempt_capable(snapshot: Snapshot, cq_name: str) -> bool:
    """The ClusterQueue can preempt: within itself, or reclaim within its
    cohort."""
    from kueue_tpu_torch.models.constants import (
        PreemptionPolicy,
        ReclaimWithinCohortPolicy,
    )

    prem = snapshot.cq_models[cq_name].preemption
    return prem.within_cluster_queue != PreemptionPolicy.NEVER or (
        snapshot.has_cohort(cq_name)
        and prem.reclaim_within_cohort != ReclaimWithinCohortPolicy.NEVER
    )


def classify_drain_scope(
    snapshot: Snapshot,
    pending: Sequence[Tuple[Workload, str]],
    tas_flavors,
    fair_sharing: bool,
):
    """Pick which drain covers a backlog.

    Returns ``(kind, pending2)`` with kind one of ``"fair_preempt"``,
    ``"fair"``, ``"preempt"``, ``"tas"``, ``"plain"``. TAS heads ride
    the drain only through the TAS drain, which has no eviction
    support: with fair sharing or any preempt-capable plain CQ in the
    backlog they are dropped from ``pending2`` (the cycle loop decides
    them) and the rest drains under the preempt/fair scopes.
    """
    tas_flavors = set(tas_flavors or ())

    def _on_tas_cq(cq_name: str) -> bool:
        cq = snapshot.cq_models.get(cq_name)
        return cq is not None and any(
            fq.name in tas_flavors
            for rg in cq.resource_groups
            for fq in rg.flavors
        )

    cq_names = {c for _, c in pending}
    tas_cqs = (
        {c for c in cq_names if _on_tas_cq(c)} if tas_flavors else set()
    )
    any_preempt = any(
        _preempt_capable(snapshot, c) for c in cq_names - tas_cqs
        if c in snapshot.cq_models
    )
    use_tas = bool(tas_cqs) and not fair_sharing and not any_preempt
    pending2 = list(pending)
    if tas_cqs and not use_tas:
        pending2 = [(w, c) for w, c in pending2 if c not in tas_cqs]
    if fair_sharing and any_preempt:
        return "fair_preempt", pending2
    if fair_sharing:
        return "fair", pending2
    if any_preempt:
        return "preempt", pending2
    if use_tas:
        return "tas", pending2
    return "plain", pending2


def run_drain_for_scope(
    kind: str,
    snapshot: Snapshot,
    pending: Sequence[Tuple[Workload, str]],
    flavors: Dict[str, ResourceFlavor],
    timestamp_fn=None,
    mesh=None,
    policy=None,
    now: float = 0.0,
    device=None,
):
    """Dispatch the drain a classify_drain_scope kind names: the one
    place the kind-to-drain mapping lives. The preempt, fair-preempt
    and TAS drains are not ported yet (NotImplementedError)."""
    if kind in ("fair_preempt", "preempt", "tas"):
        raise NotImplementedError(f"the {kind} drain is not ported yet")
    return run_drain(
        snapshot, pending, flavors, timestamp_fn=timestamp_fn, mesh=mesh,
        fair_sharing=kind == "fair", policy=policy, now=now, device=device,
    )


def launch_drain_for_scope(
    kind: str,
    snapshot: Snapshot,
    pending: Sequence[Tuple[Workload, str]],
    flavors: Dict[str, ResourceFlavor],
    timestamp_fn=None,
    max_cycles: Optional[int] = None,
    mesh=None,
    resident=None,
    policy=None,
    now: float = 0.0,
    device=None,
) -> Optional["DrainLaunch"]:
    """Launch/fetch twin of ``run_drain_for_scope`` for the scopes a
    pipelined drain loop can double-buffer: the plain one. Returns None
    for every other kind (they keep the blocking path)."""
    if kind != "plain":
        return None
    return launch_drain(
        snapshot, pending, flavors, timestamp_fn=timestamp_fn,
        max_cycles=max_cycles, mesh=mesh, resident=resident,
        policy=policy, now=now, device=device,
    )


@dataclass
class DrainLaunch:
    """An in-flight plain or fair drain (the launch/fetch split).

    ``launch_drain`` enqueues the packed solve and returns; the card
    works while the host does something else. ``fetch()`` makes the ONE
    device-to-host copy (the sync) and maps decisions back to
    workloads. Nothing between construction and fetch touches runtime
    state, so an unfetched launch is always safe to discard."""

    plan: DrainPlan
    queues_np: dict
    flat_dev: object  # int64 tensor, _solve_drain_packed layout
    usage_shape: Tuple[int, int]
    extra_fb_entries: List[Tuple[Workload, str]] = field(default_factory=list)
    # the exact backlog this launch solves, in per-CQ heap order (the
    # pipeline's commit check compares it with the real backlog)
    pending: Optional[List[Tuple[Workload, str]]] = None
    max_cycles: Optional[int] = None

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
            self.queues_np, self.extra_fb_entries, final_usage=final_usage,
        )


def _route_preempt_capable(snapshot: Snapshot, plan: DrainPlan) -> List[Tuple[Workload, str]]:
    """The fair drain orders admissions by the tournament; fair
    preemption is not in it, so preempt-capable ClusterQueues leave the
    plan (their queues emptied in place) and their entries return as
    fallback, for the cycle loop."""
    extra: List[Tuple[Workload, str]] = []
    for qi, cq_name in enumerate(plan.cq_order):
        if not _preempt_capable(snapshot, cq_name):
            continue
        plan.queues_np["qlen"][qi] = 0
        plan.queues_np["cq_rows"][qi] = -1
        plan.queues_np["seg_id"][qi] = -1
        for pos in range(plan.queues_np["cells"].shape[1]):
            i = plan.head_of.pop((qi, pos), None)
            if i is not None:
                extra.append((plan.lowered.heads[i], plan.lowered.cq_names[i]))
    return extra


def fair_inputs(snapshot: Snapshot, max_depth: int, dev):
    """The fair drain's extra inputs on ``dev`` (ops/drain_kernel.FairInputs):
    depth, weight and lendable per node, the resource of each cell, and
    the PrioritySortingWithinCohort gate as it stands."""
    from kueue_tpu_torch._torch import to_device
    from kueue_tpu_torch.features import enabled as feature_enabled
    from kueue_tpu_torch.ops.assign_kernel import build_paths
    from kueue_tpu_torch.ops.drain_kernel import FairInputs

    paths_np = build_paths(snapshot.flat.parent, max_depth)
    depth_of, lendable, res_of_fr = _fair_lendable(snapshot, paths_np)
    return FairInputs(
        depth_of=to_device(depth_of, dev, np.int32),
        weight=to_device(snapshot.weight_milli, dev, np.int64),
        lendable=to_device(lendable, dev, np.int64),
        res_of_fr=to_device(res_of_fr, dev, np.int32),
        n_res=len(snapshot.resource_names),
        prio_tie=bool(feature_enabled("PrioritySortingWithinCohort")),
    )


def _drain_device_inputs(snapshot: Snapshot, plan: DrainPlan, dev, resident=None):
    """(tree, paths, leaf usage, DrainQueues) on ``dev``, uploaded with
    no host sync; with ``resident`` (a ResidentEncoder on ``dev``) the
    tree and paths stay on the card and only changed usage rows ship."""
    from kueue_tpu_torch._torch import to_device
    from kueue_tpu_torch.interop import drain_queues

    if resident is not None:
        tree, paths, usage_in = resident.refresh(snapshot)
    else:
        tree, paths, _ = tree_arrays(snapshot, dev)
        usage_in = to_device(snapshot.local_usage, dev, np.int64)
    return tree, paths, usage_in, drain_queues(plan.queues_np, dev)


def launch_drain(
    snapshot: Snapshot,
    pending: Sequence[Tuple[Workload, str]],
    flavors: Dict[str, ResourceFlavor],
    max_candidates: int = 8,
    max_cells: int = 4,
    timestamp_fn=None,
    max_cycles: Optional[int] = None,
    mesh=None,
    resident=None,  # core.encode.ResidentEncoder
    policy=None,
    now: float = 0.0,
    device=None,
    fair_sharing: bool = False,
) -> DrainLaunch:
    """Plan the drain and enqueue its solve without fetching: the
    asynchronous half of ``run_drain``; ``run_drain(...) ==
    launch_drain(...).fetch()`` by construction.

    The inputs go up with no host sync. Where the cycle bound
    (``max_cycles``, else the plan's backstop) is at most
    ``ENQUEUE_ALL_CYCLES`` (a pipeline chunk) every cycle is enqueued
    with no read of the device ``done`` flag, so the launch returns
    while the card works and ``fetch()`` is the one sync; a larger
    bound (a plan's backstop: 16384 cycles and up for the seeded
    cases, 32768 at the headline) reads the flag every few cycles
    rather than enqueueing that many no-op launches, so that launch
    waits for the card. With
    ``resident`` the tree and paths stay on the card between launches
    and only changed leaf-usage rows ship. With ``fair_sharing`` the
    fair drain (see ``run_drain``)."""
    from kueue_tpu_torch._torch import resolve_device
    from kueue_tpu_torch.ops.drain_kernel import _solve_drain_packed

    if mesh is not None:
        raise NotImplementedError("mesh-sharded drains are not ported yet")
    dev = resolve_device(device)
    plan = plan_drain(
        snapshot, pending, flavors, max_candidates, max_cells, timestamp_fn,
        policy=policy, now=now,
    )
    extra_fb = _route_preempt_capable(snapshot, plan) if fair_sharing else []
    if max_cycles is not None:
        plan.max_cycles = max_cycles
    tree, paths, usage_in, queues = _drain_device_inputs(snapshot, plan, dev, resident)
    flat_dev = _solve_drain_packed(
        tree, usage_in, queues, paths,
        n_segments=plan.n_segments, n_steps=plan.n_steps, max_cycles=plan.max_cycles,
        seg_id=plan.queues_np["seg_id"],
        fair=fair_inputs(snapshot, tree.max_depth, dev) if fair_sharing else None,
    )
    return DrainLaunch(
        plan=plan,
        queues_np=plan.queues_np,
        flat_dev=flat_dev,
        usage_shape=tuple(snapshot.local_usage.shape),
        extra_fb_entries=extra_fb,
        pending=list(pending),
        max_cycles=plan.max_cycles,
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
    backstop. With ``fair_sharing`` each cycle's admission order is the
    fair-sharing cohort tournament (ops/drain_kernel.solve_drain with
    ``fair``) instead of the (borrowing, priority, FIFO) sort;
    preempt-capable ClusterQueues route to ``fallback``. Mesh sharding
    and non-default admission policies are not ported yet and raise
    NotImplementedError."""
    return launch_drain(
        snapshot, pending, flavors, max_candidates, max_cells, timestamp_fn,
        max_cycles=max_cycles, mesh=mesh, policy=policy, now=now, device=device,
        fair_sharing=fair_sharing,
    ).fetch()


def _cap_suffix_of(plan: DrainPlan) -> np.ndarray:
    """int32[Q, L] suffix retry budgets: ``cap[q, p]`` is the
    ``retry_cap`` a fresh ``plan_drain`` over the queue's entries at
    positions >= p computes (min(4096, max walk_states + 1)), which the
    megaloop gathers at each round boundary. Column 0 equals
    ``plan.queues_np['retry_cap']`` for every queue with entries."""
    q = plan.queues_np["qlen"].shape[0]
    l = plan.queues_np["cells"].shape[1]
    cap = np.zeros((q, l), dtype=np.int32)
    per_q: Dict[int, List[Tuple[int, int]]] = {}
    for (qi, pos), i in plan.head_of.items():
        per_q.setdefault(qi, []).append((pos, i))
    ws = plan.lowered.walk_states
    for qi, items in per_q.items():
        items.sort()
        vals = np.array([ws[i] for _, i in items], dtype=np.int64)
        sfx = np.maximum.accumulate(vals[::-1])[::-1]
        cap[qi, : len(items)] = np.minimum(4096, sfx + 1).astype(np.int32)
    return cap


@dataclass
class MegaloopLog:
    """The host-decoded round-stamped log of one megaloop launch: one
    DrainOutcome per round run, in order, each what a serial
    ``launch_drain(max_cycles=chunk_cycles)`` over the previous round's
    undecided backlog fetches. ``truncated``: the last round still left
    entries undecided (the round budget ran out); the caller relaunches
    from the post-apply state."""

    rounds: List[DrainOutcome]
    n_rounds: int
    cycles: int
    truncated: bool


@dataclass
class MegaloopLaunch:
    """An in-flight megaloop: ONE launch and ONE fetch for up to K
    rounds. Nothing between construction and ``fetch`` touches runtime
    state, so an unfetched launch is always safe to discard."""

    plan: DrainPlan
    queues_np: dict
    flat_dev: object  # int64 tensor: the packed log, on the device
    usage_shape: Tuple[int, int]
    start_usage: np.ndarray  # launch-time leaf usage
    pending: List[Tuple[Workload, str]]
    chunk_cycles: int
    max_rounds: int

    def _usage_offset(self, r: int) -> int:
        q, l, p = self.queues_np["cells"].shape[:3]
        n, fr = self.usage_shape
        return (
            q * l * p + 2 * q * l + 2 * self.max_rounds * q
            + self.max_rounds + r * n * fr
        )

    def usage_dev(self, r: int):
        """Round r's final leaf usage as a device view of the packed
        log (what a ResidentEncoder adopts after a fully committed
        launch, with no host round trip)."""
        n, fr = self.usage_shape
        off = self._usage_offset(r)
        return self.flat_dev[off : off + n * fr].reshape((n, fr))

    def fetch(self) -> MegaloopLog:
        flat = self.flat_dev.cpu().numpy()  # the single fetch
        q, l, p = self.queues_np["cells"].shape[:3]
        n, fr = self.usage_shape
        rr = self.max_rounds
        qlp, ql = q * l * p, q * l
        off = 0
        adm_k = flat[off : off + qlp].reshape((q, l, p)); off += qlp
        adm_cycle = flat[off : off + ql].reshape((q, l)); off += ql
        adm_round = flat[off : off + ql].reshape((q, l)); off += ql
        r_cursor = flat[off : off + rr * q].reshape((rr, q)); off += rr * q
        r_stuck = flat[off : off + rr * q].reshape((rr, q)).astype(bool); off += rr * q
        r_cycles = flat[off : off + rr]; off += rr
        r_usage = flat[off : off + rr * n * fr].reshape((rr, n, fr))
        n_rounds = int(flat[-2])
        cycles = int(flat[-1])
        rounds = _map_megaloop_rounds(
            self.plan, self.queues_np, adm_k, adm_cycle, adm_round,
            r_cursor, r_stuck, r_cycles, r_usage, n_rounds, self.start_usage,
        )
        return MegaloopLog(
            rounds=rounds,
            n_rounds=n_rounds,
            cycles=cycles,
            truncated=bool(rounds and rounds[-1].undecided),
        )


def _map_megaloop_rounds(
    plan: DrainPlan,
    queues_np: dict,
    adm_k,
    adm_cycle,
    adm_round,
    r_cursor,
    r_stuck,
    r_cycles,
    r_usage,
    n_rounds: int,
    start_usage: np.ndarray,
) -> List[DrainOutcome]:
    """Slice the log into per-round DrainOutcomes, each what
    ``_map_drain_result`` gives for a serial round launched over the
    previous round's undecided backlog: a round's scope is the entries
    past the previous cursor in queues not yet retired; unreached
    entries route to fallback (and to ``undecided`` unless their queue
    went stuck); ``plan.fallback`` belongs to round 0 only."""
    lowered = plan.lowered
    q = queues_np["qlen"].shape[0]
    rounds: List[DrainOutcome] = []
    prev_cursor = np.zeros(q, dtype=np.int64)
    prev_dead = np.zeros(q, dtype=bool)
    for r in range(max(int(n_rounds), 1)):
        ran = r < int(n_rounds)
        cursor_r = np.asarray(r_cursor[r] if ran else prev_cursor)
        stuck_r = np.asarray(r_stuck[r]).astype(bool) if ran else prev_dead
        cycles_r = int(r_cycles[r]) if ran else 0
        usage_r = np.asarray(r_usage[r]) if ran else np.asarray(start_usage)
        admitted: List[Tuple[Workload, str, Dict[str, str], int]] = []
        parked: List[Tuple[Workload, str]] = []
        fb_extra: List[Tuple[Workload, str]] = []
        undecided: List[Tuple[Workload, str]] = []
        for (qi, pos), i in plan.head_of.items():
            if prev_dead[qi] or pos < prev_cursor[qi]:
                continue  # decided (or retired) in an earlier round
            wl = lowered.heads[i]
            cq_name = lowered.cq_names[i]
            if int(adm_round[qi, pos]) == r:
                admitted.append(
                    (wl, cq_name,
                     _admitted_flavors(lowered, i, adm_k[qi, pos]),
                     int(adm_cycle[qi, pos]))
                )
            elif pos >= int(cursor_r[qi]):
                # never processed this round: no decision; stuck-frozen
                # queues are terminal, the rest feed the next round
                fb_extra.append((wl, cq_name))
                if not stuck_r[qi]:
                    undecided.append((wl, cq_name))
            else:
                parked.append((wl, cq_name))
        admitted.sort(key=lambda t: t[3])
        fb = (
            [(lowered.heads[i], lowered.cq_names[i]) for i in plan.fallback]
            if r == 0
            else []
        ) + fb_extra
        rounds.append(
            DrainOutcome(
                admitted=admitted,
                parked=parked,
                fallback=fb,
                cycles=cycles_r,
                truncated=bool(undecided),
                undecided=undecided,
                final_usage=usage_r.astype(np.int64, copy=False),
            )
        )
        prev_cursor = cursor_r.astype(np.int64).copy()
        prev_dead = prev_dead | stuck_r
    return rounds


def launch_drain_megaloop(
    snapshot: Snapshot,
    pending: Sequence[Tuple[Workload, str]],
    flavors: Dict[str, ResourceFlavor],
    max_candidates: int = 8,
    max_cells: int = 4,
    timestamp_fn=None,
    chunk_cycles: int = 16,
    max_rounds: int = 8,
    mesh=None,
    resident=None,  # core.encode.ResidentEncoder
    policy=None,
    now: float = 0.0,
    device=None,
) -> MegaloopLaunch:
    """Plan and enqueue the K-round megaloop without fetching: up to
    ``max_rounds`` drain rounds of ``chunk_cycles`` cycles in one launch
    (ops/megaloop_kernel.solve_drain_megaloop). The uploads and the
    ``chunk_cycles x max_rounds`` cycles of launches go out with no
    host read, so this returns while the card works; ``fetch()`` is the
    one sync. With ``resident`` the tree and paths stay on the card
    between launches."""
    from kueue_tpu_torch._torch import resolve_device, to_device
    from kueue_tpu_torch.ops.megaloop_kernel import _solve_drain_megaloop_packed

    if mesh is not None:
        raise NotImplementedError("mesh-sharded drains are not ported yet")
    dev = resolve_device(device)
    plan = plan_drain(
        snapshot, pending, flavors, max_candidates, max_cells, timestamp_fn,
        policy=policy, now=now,
    )
    cap_suffix = _cap_suffix_of(plan)
    tree, paths, usage_in, queues = _drain_device_inputs(snapshot, plan, dev, resident)
    flat_dev = _solve_drain_megaloop_packed(
        tree, usage_in, queues, paths, to_device(cap_suffix, dev, np.int32),
        n_segments=plan.n_segments,
        n_steps=plan.n_steps,
        chunk_cycles=int(chunk_cycles),
        max_rounds=int(max_rounds),
        seg_id=plan.queues_np["seg_id"],
    )
    return MegaloopLaunch(
        plan=plan,
        queues_np=plan.queues_np,
        flat_dev=flat_dev,
        usage_shape=tuple(snapshot.local_usage.shape),
        start_usage=np.asarray(snapshot.local_usage),
        pending=list(pending),
        chunk_cycles=int(chunk_cycles),
        max_rounds=int(max_rounds),
    )


def run_drain_megaloop_host(
    snapshot: Snapshot,
    pending: Sequence[Tuple[Workload, str]],
    flavors: Dict[str, ResourceFlavor],
    max_candidates: int = 8,
    max_cells: int = 4,
    timestamp_fn=None,
    chunk_cycles: int = 16,
    max_rounds: int = 8,
    policy=None,
    now: float = 0.0,
) -> MegaloopLog:
    """The megaloop's numpy host twin over the same plan tensors
    (ops/megaloop_np.solve_megaloop_np, which IS the serial chunked loop
    over suffix-trimmed queues), decoded by the same
    ``_map_megaloop_rounds``."""
    from kueue_tpu_torch.core.encode import encode_snapshot
    from kueue_tpu_torch.ops.assign_kernel import build_paths
    from kueue_tpu_torch.ops.megaloop_np import solve_megaloop_np

    plan = plan_drain(
        snapshot, pending, flavors, max_candidates, max_cells, timestamp_fn,
        policy=policy, now=now,
    )
    cap_suffix = _cap_suffix_of(plan)
    enc = encode_snapshot(snapshot)
    paths_np = build_paths(enc.parent, enc.max_depth)
    host = solve_megaloop_np(
        enc.parent,
        enc.level_mask,
        enc.nominal.astype(np.int64, copy=False),
        enc.lending_limit.astype(np.int64, copy=False),
        enc.borrowing_limit.astype(np.int64, copy=False),
        enc.local_usage.astype(np.int64, copy=False),
        plan.queues_np,
        paths_np,
        enc.max_depth,
        int(chunk_cycles),
        int(max_rounds),
        cap_suffix,
    )
    rounds = _map_megaloop_rounds(
        plan, plan.queues_np, host.admitted_k, host.admitted_cycle,
        host.admitted_round, host.round_cursor, host.round_stuck,
        host.round_cycles, host.round_usage, host.rounds,
        np.asarray(snapshot.local_usage),
    )
    return MegaloopLog(
        rounds=rounds,
        n_rounds=host.rounds,
        cycles=host.cycles,
        truncated=bool(rounds and rounds[-1].undecided),
    )


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
