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
host twin ``run_drain_megaloop_host``), the drain with classic
preemption (``run_drain_preempt``, its candidate-pool lowering and the
``PanelTuner`` ladder of search widths), the drain with fair-sharing
order and fair-sharing preemption (``run_drain_fair_preempt``, the same
pools plus each segment's fair panels), and the scope routing
(``classify_drain_scope``, ``run_drain_for_scope``,
``launch_drain_for_scope``), and the drain with Topology-Aware
Scheduling (``run_drain_tas``: the merged domain forest of every
in-scope TAS flavor, the placement and its admit-time re-validation in
kernel B13, and the host replay of the placements). Every drain takes
an admission ``policy`` (kueue_tpu_torch/policy): ``plan_drain``
compiles its candidate scores and priority boosts onto the backlog, and
the preemption drains order victims by its PREMA costs.

Every drain takes ``mesh=`` (kueue_tpu_torch/parallel): its per-queue
tensors are padded to a multiple of the mesh's ``wl`` axis with inert
queues (qlen 0, cq_row and seg_id -1; the decode skips them) and placed
through the mesh's ``place_*`` entry, then the same kernels run; the
decisions do not change with the mesh. Under a mesh the preempt drain
runs a narrow panel width only after the harness's canary certified it.
A mesh over one device (a card, or the CPU's virtual devices) runs; a
mesh over several distinct devices raises NotImplementedError, as
splitting the drain loop over cards waits for a machine with more than
one GPU (ROADMAP A11).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kueue_tpu_torch.models import ResourceFlavor, Workload
from kueue_tpu_torch.core.snapshot import Snapshot
from kueue_tpu_torch.ops import _build
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
    policy=None,  # kueue_tpu_torch/policy AdmissionPolicy: compiles the
    #               per-entry candidate score tensor (zeros = first-fit)
    now: float = 0.0,  # policy clock (deadline boosts)
) -> DrainPlan:
    """Lower the backlog and pack it into per-CQ queue tensors.

    ``pending`` must be in per-CQ heap order (priority desc, timestamp
    asc — use QueueManager pending snapshots); relative order across
    CQs is irrelevant.
    """
    from kueue_tpu_torch.ops.assign_kernel import build_roots

    lowered = lower_heads_multi(
        snapshot, pending, flavors, max_candidates, max_cells, max_podsets,
        timestamp_fn, any_fungibility=True, allow_tas=allow_tas,
    )
    if policy is not None and not policy.is_default:
        from kueue_tpu_torch.policy import annotate_multi

        annotate_multi(policy, lowered, now)
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


@dataclass
class DrainEviction:
    """One eviction with evictor attribution (the kernel records the
    evicting queue exactly; the evicting ENTRY is the queue's next
    admission at/after the eviction cycle — exact except for the rare
    head that evicts, then loses every later fits() re-check)."""

    victim: Workload
    victim_cq: str
    cycle: int
    by_cq: Optional[str] = None
    by_workload: Optional[Workload] = None
    # Preempted condition reason (preemption.py IN_* constants)
    reason: str = "InClusterQueue"


@dataclass
class PreemptDrainOutcome(DrainOutcome):
    # (victim workload, cq_name, cycle index of the eviction)
    preempted: List[Tuple[Workload, str, int]] = field(default_factory=list)
    # same evictions, with evictor attribution (aligned order)
    evictions: List[DrainEviction] = field(default_factory=list)


@dataclass
class _VictimLowering:
    """The per-root-cohort candidate-pool lowering of the preempt drain
    (``run_drain_preempt``)."""

    victims_np: dict
    slot_meta: Dict[int, list]
    victim_of: Dict[Tuple[int, int], object]
    extra_fb_entries: List[Tuple[Workload, str]]
    seg_root: Dict[int, int]
    seg_queues: Dict[int, List[int]]
    seg_members: Dict[int, List[int]]
    local_ids: Dict[int, Dict[int, int]]  # s -> global row -> local id
    row_names: list
    v_cap: int
    s_dim: int
    cv: int
    m_dim: int


def _lower_victim_pools(
    snapshot: Snapshot,
    plan: DrainPlan,
    timestamp_fn,
    now: Optional[float],
    max_victims: int,
    max_victim_cells: int,
    max_cycles: Optional[int],
    # fn(s, members, seg_queues_s) -> bool: extra scope veto, given the
    # segment id, its member CQ rows and its queue-index list
    extra_segment_bad=None,
    policy=None,  # kueue_tpu_torch/policy: PREMA victim-cost adjustments
) -> _VictimLowering:
    """Build the SegVictims arrays + metadata for a preemption drain
    and set plan.max_cycles. Mutates plan (drops ineligible queues)."""
    from kueue_tpu_torch.models.constants import (
        BorrowWithinCohortPolicy,
        PreemptionPolicy,
        ReclaimWithinCohortPolicy,
        WorkloadConditionType,
    )
    from kueue_tpu_torch.ops.assign_kernel import build_paths, build_roots
    from kueue_tpu_torch.ops.drain_kernel import NO_BWC_THRESHOLD as NO_THR

    q = max(len(plan.cq_order), 1)
    nl = plan.queues_np["cells"].shape[1]
    pdim, kdim, cdim = plan.queues_np["cells"].shape[2:]
    merged_cells = pdim * cdim  # the kernel's mcells width

    # ---- per-queue preemption policy flags ----
    same_enabled = np.zeros(q, dtype=bool)
    same_prio_ok = np.zeros(q, dtype=bool)
    reclaim_enabled = np.zeros(q, dtype=bool)
    only_lower = np.zeros(q, dtype=bool)
    bwc = np.zeros(q, dtype=bool)
    bwc_thr1 = np.full(q, NO_THR, dtype=np.int64)
    for qi, cq_name in enumerate(plan.cq_order):
        prem = snapshot.cq_models[cq_name].preemption
        same_enabled[qi] = prem.within_cluster_queue != PreemptionPolicy.NEVER
        same_prio_ok[qi] = (
            prem.within_cluster_queue
            == PreemptionPolicy.LOWER_OR_NEWER_EQUAL_PRIORITY
        )
        reclaim_enabled[qi] = snapshot.has_cohort(cq_name) and (
            prem.reclaim_within_cohort != ReclaimWithinCohortPolicy.NEVER
        )
        # the host rule is != Any (preemption.py _find_candidates), not
        # == LowerPriority — they differ on unknown policy values
        only_lower[qi] = (
            prem.reclaim_within_cohort != ReclaimWithinCohortPolicy.ANY
        )
        pol = prem.borrow_within_cohort
        bwc[qi] = pol.policy != BorrowWithinCohortPolicy.NEVER
        if pol.max_priority_threshold is not None:
            bwc_thr1[qi] = int(pol.max_priority_threshold) + 1
    can_search = same_enabled | reclaim_enabled

    # ---- segment membership ----
    cq_rows = plan.queues_np["cq_rows"]
    seg_id = plan.queues_np["seg_id"]
    qlen = plan.queues_np["qlen"]
    roots_all = build_roots(snapshot.flat.parent)
    n_cq = snapshot.flat.n_cq
    row_names = snapshot.flat.cq_names  # row i -> name
    queue_of_row = {int(cq_rows[qi]): qi for qi in range(len(plan.cq_order))}
    seg_root = {}
    seg_queues: Dict[int, List[int]] = {}
    for qi in range(len(plan.cq_order)):
        s = int(seg_id[qi])
        if s < 0:
            continue
        seg_root[s] = int(roots_all[int(cq_rows[qi])])
        seg_queues.setdefault(s, []).append(qi)
    seg_members: Dict[int, List[int]] = {
        s: [r for r in range(n_cq) if int(roots_all[r]) == root]
        for s, root in seg_root.items()
    }
    scoped = {
        s: any(reclaim_enabled[qi] for qi in seg_queues[s])
        for s in seg_root
    }
    # part-B (drain-admitted-entry) slots are needed whenever ANY queue
    # in the segment searches — not just under cohort reclaim: a parked
    # higher-priority head reactivated by an eviction can preempt a
    # drain-admitted lower-priority entry of its OWN ClusterQueue
    dynamic = {
        s: any(can_search[qi] for qi in seg_queues[s]) for s in seg_root
    }

    # ---- pool membership + segment scope checks ----
    paths_np = build_paths(snapshot.flat.parent, snapshot.flat.max_depth)
    pool_of: Dict[int, list] = {}  # s -> [(ws, owner_row)]
    bad_segments: List[int] = []
    for s, members in seg_members.items():
        entries = []
        bad = False
        for r in members:
            name = row_names[r]
            qi = queue_of_row.get(r)
            include = scoped[s] or (qi is not None and same_enabled[qi])
            if not include:
                continue
            for ws in snapshot.workloads_in_cq(name):
                if int(np.count_nonzero(ws.usage_vec)) > max_victim_cells:
                    # an unrepresentable victim of an included CQ makes
                    # the whole segment's searches unsound
                    bad = True
                    break
                entries.append((ws, r))
            if bad:
                break
        n_b = sum(int(qlen[qi]) for qi in seg_queues[s]) if dynamic[s] else 0
        if extra_segment_bad is not None and not bad:
            bad = bool(extra_segment_bad(s, members, seg_queues[s]))
        if bad or len(entries) + n_b > max_victims:
            bad_segments.append(s)
            pool_of[s] = []
        else:
            pool_of[s] = entries

    # searching queues of bad segments fall back to the cycle loop
    drop_queues: List[int] = [
        qi
        for s in bad_segments
        for qi in seg_queues[s]
        if can_search[qi]
    ]
    for s in bad_segments:
        scoped[s] = False
        dynamic[s] = False
    dropped = set(drop_queues)

    # ---- dense pool arrays ----
    pool_totals = [
        len(pool_of.get(s, []))
        + (
            sum(int(qlen[qi]) for qi in seg_queues[s] if qi not in dropped)
            if dynamic[s]
            else 0
        )
        for s in seg_root
    ]
    v_cap = _bucket(max(pool_totals, default=1), minimum=8)
    s_dim = plan.n_segments
    cv = max(
        merged_cells,
        max(
            (
                int(np.count_nonzero(ws.usage_vec))
                for pool in pool_of.values()
                for ws, _ in pool
            ),
            default=1,
        ),
    )
    dmax = paths_np.shape[1]
    node_counts = [
        len(
            np.unique(
                paths_np[np.asarray(members, dtype=np.int64)][
                    paths_np[np.asarray(members, dtype=np.int64)] >= 0
                ]
            )
        )
        for members in seg_members.values()
    ]
    m_dim = _bucket(max(node_counts, default=1), minimum=4)

    scells = np.full((s_dim, v_cap, cv), -1, dtype=np.int32)
    sqty = np.zeros((s_dim, v_cap, cv), dtype=np.int64)
    sprio = np.zeros((s_dim, v_cap), dtype=np.int64)
    sts = np.zeros((s_dim, v_cap), dtype=np.int64)
    svalid0 = np.zeros((s_dim, v_cap), dtype=bool)
    sowner = np.full((s_dim, v_cap), -1, dtype=np.int32)
    sowner_local = np.zeros((s_dim, v_cap), dtype=np.int32)
    sslot_q = np.full((s_dim, v_cap), -1, dtype=np.int32)
    sslot_l = np.full((s_dim, v_cap), -1, dtype=np.int32)
    seg_nodes = np.full((s_dim, m_dim), -1, dtype=np.int32)
    lpaths = np.full((s_dim, m_dim, dmax), -1, dtype=np.int32)
    hlocal = np.zeros(q, dtype=np.int32)
    perm = np.tile(np.arange(v_cap, dtype=np.int32), (q, 1))
    entry_slot = np.full((q, nl), -1, dtype=np.int32)
    victim_of: Dict[Tuple[int, int], object] = {}
    slot_meta: Dict[int, list] = {}  # s -> [(evicted0, owner, prio, rt, uid, adj)]
    # PREMA-style victim-cost adjustment (kueue_tpu_torch/policy):
    # inserted into the candidate sort key between the (evicted,
    # other-CQ) tiers and priority; zero for every victim under the
    # default policy, so the ordering is byte-identical to the
    # unadjusted sort
    def _cost_adjust(wl) -> int:
        if policy is None or policy.is_default:
            return 0
        return int(policy.victim_cost_adjust(wl))


    if now is None:
        rts = [
            ws.quota_reserved_time
            for pool in pool_of.values()
            for ws, _ in pool
        ]
        now = (max(rts) + 1.0) if rts else 0.0

    local_ids: Dict[int, Dict[int, int]] = {}
    for s, members in seg_members.items():
        nodes = np.unique(
            paths_np[np.asarray(members, dtype=np.int64)]
        )
        nodes = nodes[nodes >= 0]
        local_id = {int(g): i for i, g in enumerate(nodes)}
        local_ids[s] = local_id
        seg_nodes[s, : len(nodes)] = nodes
        for i, gnode in enumerate(nodes):
            gp = paths_np[int(gnode)]
            for d in range(dmax):
                if gp[d] >= 0:
                    lpaths[s, i, d] = local_id[int(gp[d])]
        for qi in seg_queues[s]:
            hlocal[qi] = local_id[int(cq_rows[qi])]
        meta = []
        slot = 0
        for ws, owner in pool_of.get(s, []):
            js = np.flatnonzero(ws.usage_vec)
            scells[s, slot, : len(js)] = js
            sqty[s, slot, : len(js)] = ws.usage_vec[js]
            sprio[s, slot] = ws.priority
            tsv = (
                timestamp_fn(ws.workload)
                if timestamp_fn
                else ws.workload.creation_time
            )
            sts[s, slot] = int(tsv * 1e9)
            svalid0[s, slot] = True
            sowner[s, slot] = owner
            sowner_local[s, slot] = local_id[int(owner)]
            victim_of[(s, slot)] = ws
            meta.append(
                (
                    ws.workload.condition_true(WorkloadConditionType.EVICTED),
                    int(owner),
                    int(ws.priority),
                    float(ws.quota_reserved_time),
                    ws.workload.uid,
                    _cost_adjust(ws.workload),
                )
            )
            slot += 1
        if dynamic[s]:
            for qi in seg_queues[s]:
                if qi in dropped:
                    continue
                for pos in range(int(qlen[qi])):
                    i = plan.head_of[(qi, pos)]
                    wl = plan.lowered.heads[i]
                    sprio[s, slot] = plan.queues_np["priority"][qi, pos]
                    sts[s, slot] = plan.queues_np["timestamp"][qi, pos]
                    sowner[s, slot] = cq_rows[qi]
                    sowner_local[s, slot] = local_id[int(cq_rows[qi])]
                    sslot_q[s, slot] = qi
                    sslot_l[s, slot] = pos
                    entry_slot[qi, pos] = slot
                    meta.append(
                        (
                            False,
                            int(cq_rows[qi]),
                            int(plan.queues_np["priority"][qi, pos]),
                            float(now),
                            wl.uid,
                            _cost_adjust(wl),
                        )
                    )
                    slot += 1
        slot_meta[s] = meta
        # candidate order per queue (preemption.go:591-618): evicted
        # first, other-CQ first, lowest priority, most recently
        # reserved, uid; pad slots last
        for qi in seg_queues[s]:
            own = int(cq_rows[qi])
            keyed = sorted(
                range(len(meta)),
                key=lambda j: (
                    0 if meta[j][0] else 1,
                    0 if meta[j][1] != own else 1,
                    meta[j][5],
                    meta[j][2],
                    -meta[j][3],
                    meta[j][4],
                ),
            )
            perm[qi, : len(keyed)] = np.asarray(keyed, dtype=np.int32)
            perm[qi, len(keyed) :] = np.arange(
                len(keyed), v_cap, dtype=np.int32
            )

    # ---- drop ineligible queues to the fallback path ----
    extra_fb_entries: List[Tuple[Workload, str]] = []
    if drop_queues:
        for qi in drop_queues:
            plan.queues_np["qlen"][qi] = 0
            plan.queues_np["cq_rows"][qi] = -1
            plan.queues_np["seg_id"][qi] = -1
            for pos in range(plan.queues_np["cells"].shape[1]):
                i = plan.head_of.pop((qi, pos), None)
                if i is not None:
                    extra_fb_entries.append(
                        (plan.lowered.heads[i], plan.lowered.cq_names[i])
                    )

    # cycle cap: between evictions the preemption-free per-segment
    # progress bound applies (>=1 retire per cycle per live segment);
    # each eviction cycle retires nothing but consumes a pool slot and
    # can reactivate the segment's parked entries once
    qlen = plan.queues_np["qlen"]
    seg_id = plan.queues_np["seg_id"]
    live = seg_id >= 0
    if live.any():
        nseg = int(seg_id[live].max()) + 1
        seg_entries = np.bincount(
            seg_id[live], weights=qlen[live].astype(np.float64), minlength=nseg
        )
        seg_victims = np.zeros(nseg, dtype=np.float64)
        for s in seg_root:
            if s < nseg:
                seg_victims[s] = len(slot_meta.get(s, []))
        # each entry may additionally burn up to max_candidates cycles
        # retrying with advanced per-group pending cursors before it
        # retires (the PendingFlavors emulation), hence the (K+1) factor
        cap = (
            int(((seg_victims + 1) * seg_entries + seg_victims).max())
            * (int(plan.queues_np["retry_cap"].max()) + 1)
            + 8
        )
    else:
        cap = 16
    plan.max_cycles = _bucket(cap, minimum=16)
    if max_cycles is not None:
        plan.max_cycles = max_cycles

    victims_np = dict(
        scells=scells, sqty=sqty, sprio=sprio, sts=sts, svalid0=svalid0,
        sowner=sowner, sowner_local=sowner_local, sslot_q=sslot_q,
        sslot_l=sslot_l, seg_nodes=seg_nodes, lpaths=lpaths,
        hlocal=hlocal, perm=perm, entry_slot=entry_slot,
        same_enabled=same_enabled, same_prio_ok=same_prio_ok,
        reclaim_enabled=reclaim_enabled, only_lower=only_lower, bwc=bwc,
        bwc_thr1=bwc_thr1,
    )
    return _VictimLowering(
        victims_np=victims_np,
        slot_meta=slot_meta,
        victim_of=victim_of,
        extra_fb_entries=extra_fb_entries,
        seg_root=seg_root,
        seg_queues=seg_queues,
        seg_members=seg_members,
        local_ids=local_ids,
        row_names=row_names,
        v_cap=v_cap,
        s_dim=s_dim,
        cv=cv,
        m_dim=m_dim,
    )


class PanelTuner:
    """Online kernel-shape search for the victim-search panel width.

    The search's cost grows with ``search_width`` (each step of the
    ladder is a serial removal and fit check), so the shape lever is
    the panel width itself. Candidate panels are already sorted by the
    preemption-cost key (evicted first, other-CQ first, lowest
    priority, most recently reserved — preemption.go:591-618, the
    ordering PREMA/arXiv:1909.04548 motivates), so the true victim set
    is a PREFIX of the panel in the common case and a narrow window
    finds it. Exactness is guaranteed by the escape hatch in
    ``run_drain_preempt``: a solve whose ``overflowed`` flag fired
    (some eligible list overflowed the window AND the search missed)
    is discarded and re-solved at the next wider width, ending at the
    exact ``search_width`` — decisions are bit-for-bit the fixed-width
    kernel's at every step.

    This tuner is the per-workload-mix coordinate descent of
    arXiv:2406.20037 reduced to the one live coordinate: per final
    (exact) width it walks the width ladder — an escalation widens the
    starting panel for the next call, ``shrink_after`` consecutive
    clean narrow solves try the next narrower rung. State only ever
    changes WHICH executable runs, never what it answers."""

    LADDER = (8, 16, 32, 64, 128, 256, 512)

    def __init__(self, shrink_after: int = 8):
        self.shrink_after = shrink_after
        self._narrow: Dict[int, int] = {}  # final width -> narrow width
        self._clean: Dict[int, int] = {}  # consecutive clean solves
        self.escalations = 0
        self.solves = 0

    def _default_narrow(self, final: int) -> int:
        for w in self.LADDER:
            if w * 4 >= final:
                return min(w, final)
        return final

    def widths_for(self, final: int) -> Tuple[int, ...]:
        """The width schedule for one drain: (narrow, ..., final)."""
        narrow = self._narrow.get(final)
        if narrow is None:
            narrow = self._default_narrow(final)
            self._narrow[final] = narrow
        if narrow >= final:
            return (final,)
        return (narrow, final)

    def observe(self, final: int, escalated: bool) -> None:
        self.solves += 1
        narrow = self._narrow.get(final, final)
        if escalated:
            self.escalations += 1
            self._clean[final] = 0
            # widen: next rung up (capped at final)
            self._narrow[final] = min(final, max(narrow * 2, 8))
        else:
            n = self._clean.get(final, 0) + 1
            self._clean[final] = n
            if n >= self.shrink_after and narrow > self.LADDER[0]:
                self._narrow[final] = narrow // 2
                self._clean[final] = 0


# process-wide default tuner: the production runtime and the bench
# share it so the shape converges to the live workload mix
_PANEL_TUNER = PanelTuner()

# operator override (server --panel-widths): a fixed schedule replaces
# the tuner's; None = tune online
_PANEL_WIDTHS_OVERRIDE: Optional[Tuple[int, ...]] = None


def set_default_panel_widths(widths: Optional[Sequence[int]]) -> None:
    """Pin the victim-search panel schedule process-wide (the server's
    ``--panel-widths`` knob); None restores the online PanelTuner."""
    global _PANEL_WIDTHS_OVERRIDE
    _PANEL_WIDTHS_OVERRIDE = tuple(widths) if widths is not None else None


def preempt_drain_inputs(
    snapshot: Snapshot,
    pending: Sequence[Tuple[Workload, str]],
    flavors: Dict[str, ResourceFlavor],
    dev,
    max_candidates: int = 8,
    max_cells: int = 4,
    max_victims: int = 512,
    max_victim_cells: int = 4,
    timestamp_fn=None,
    max_cycles: Optional[int] = None,
    now: Optional[float] = None,
    policy=None,
    mesh=None,
):
    """The preempt drain's plan, pool lowering and device inputs, as
    ``run_drain_preempt`` makes them: (plan, lowering, tree, paths,
    leaf usage, DrainQueues, SegVictims) on ``dev``. Under ``mesh`` the
    queues and the pools' per-queue arrays are padded to a multiple of
    ``wl`` and placed through ``place_preempt_drain_inputs``."""
    from kueue_tpu_torch.interop import seg_victims

    plan = plan_drain(
        snapshot, pending, flavors, max_candidates, max_cells, timestamp_fn,
        policy=policy, now=now or 0.0,
    )
    low = _lower_victim_pools(
        snapshot, plan, timestamp_fn, now, max_victims, max_victim_cells, max_cycles,
        policy=policy,
    )
    if mesh is not None:
        tree, paths, usage_in, queues, victims = _place_preempt(snapshot, plan, low, dev, mesh)
        return plan, low, tree, paths, usage_in, queues, victims
    tree, paths, usage_in, queues = _drain_device_inputs(snapshot, plan, dev)
    return plan, low, tree, paths, usage_in, queues, seg_victims(low.victims_np, dev)


def _place_preempt(snapshot: Snapshot, plan: DrainPlan, low, dev, mesh, fairp_np=None):
    """The preemption drains' inputs under ``mesh``: the queues and the
    pools' per-queue arrays padded to a multiple of ``wl``, then placed
    through ``place_preempt_drain_inputs`` (with ``fairp_np``, the fair
    panels, through ``place_fair_preempt_drain_inputs``). Returns
    (tree, paths, leaf usage, DrainQueues, SegVictims[, FairSegPanels])."""
    import time

    from kueue_tpu_torch.parallel import harness
    from kueue_tpu_torch.parallel.sharded_solver import (
        pad_victim_arrays,
        place_fair_preempt_drain_inputs,
        place_preempt_drain_inputs,
    )

    t0 = time.perf_counter()
    _mesh_pad(plan, mesh)
    low.victims_np = pad_victim_arrays(low.victims_np, plan.queues_np["qlen"].shape[0])
    tree, paths, _ = tree_arrays(snapshot, dev)
    if fairp_np is None:
        tree, usage_in, queues, victims, paths = place_preempt_drain_inputs(
            mesh, tree, snapshot.local_usage, plan.queues_np, low.victims_np, paths
        )
        out = (tree, paths, usage_in, queues, victims)
    else:
        tree, usage_in, queues, victims, panels, paths = place_fair_preempt_drain_inputs(
            mesh, tree, snapshot.local_usage, plan.queues_np, low.victims_np, fairp_np, paths
        )
        out = (tree, paths, usage_in, queues, victims, panels)
    harness.note_place_seconds(time.perf_counter() - t0)
    return out


def run_drain_preempt(
    snapshot: Snapshot,
    pending: Sequence[Tuple[Workload, str]],
    flavors: Dict[str, ResourceFlavor],
    max_candidates: int = 8,
    max_cells: int = 4,
    max_victims: int = 512,
    max_victim_cells: int = 4,
    timestamp_fn=None,
    max_cycles: Optional[int] = None,
    now: Optional[float] = None,
    search_width: int = 32,
    mesh=None,
    panel_widths: Optional[Sequence[int]] = None,
    panel_tuner: Optional[PanelTuner] = None,
    policy=None,
    device=None,
    # internal (the narrow-panel canary): run the given panel_widths
    # under the mesh WITHOUT consulting the canary's verdict — the
    # canary itself is what establishes it
    _trust_panel_widths: bool = False,
) -> PreemptDrainOutcome:
    """Multi-cycle drain WITH classic preemption — within-ClusterQueue
    and cross-CQ cohort reclamation — on the card, one fetch for each
    panel tier (ops/drain_kernel.solve_drain_preempt).

    Candidates are pooled per root cohort (segment): every member CQ's
    admitted workloads (part A), plus one slot per pending entry that
    becomes a live reclaim candidate once the drain admits it (part B —
    the host cycle loop sees drain-admitted workloads in its snapshot
    the same way). ``now`` is the quota-reservation instant attributed
    to in-drain admissions for candidate ordering (default: after every
    part-A reservation). ``max_victims`` caps a SEGMENT's pool;
    overflowing segments route their preempt-capable queues to
    ``fallback`` for the sequential cycle loop, as do victims with more
    than ``max_victim_cells`` distinct usage cells. ``search_width``
    bounds one head's per-cycle candidate scan. The caller applies the
    reported admissions and evictions in cycle order (a drain-admitted
    entry may later be evicted by a reclaiming CQ: it appears in BOTH
    lists) — this function only decides.

    ``panel_widths`` overrides the panel schedule (last entry = the
    trusted exact width); the default is the process-wide
    ``PanelTuner``'s (narrow, search_width) schedule: the drain is
    solved at the narrow cost-ordered panel and again at the next wider
    width only when the kernel reports an inconclusive truncated search
    (``overflowed``), so decisions always equal the fixed
    ``search_width`` drain's.

    Runs on the card: ``device`` defaults to ``cuda`` and raises where
    there is none; ``device="cpu"`` runs the plain torch versions.
    ``policy`` scores the flavor candidates and, under PREMA, orders
    the victims by its costs. With ``mesh`` (a ``parallel`` Mesh over
    one device) the per-queue tensors are padded to a multiple of its
    ``wl`` axis and placed on it, and each narrow rung of the panel
    ladder runs only after the per-(mesh, width) canary of
    ``parallel.harness.mesh_safe_widths`` reproduced the drain without
    the mesh; a mesh over several devices raises NotImplementedError."""
    from kueue_tpu_torch.ops.drain_kernel import _solve_drain_preempt_packed

    dev = _run_device(mesh, device)
    plan, low, tree, paths, usage_in, queues, victims = preempt_drain_inputs(
        snapshot, pending, flavors, dev, max_candidates, max_cells,
        max_victims, max_victim_cells, timestamp_fn, max_cycles, now, policy=policy,
        mesh=mesh,
    )
    # ---- the two-tier panel ladder (exactness escape hatch): a clean
    # narrow run is provably identical to the exact width's, and an
    # escalated run IS the wider run
    tuner = panel_tuner if panel_tuner is not None else _PANEL_TUNER
    if panel_widths is None:
        panel_widths = _PANEL_WIDTHS_OVERRIDE
    if panel_widths is not None:
        widths = tuple(panel_widths)
    else:
        widths = tuner.widths_for(search_width)
    if mesh is not None and not _trust_panel_widths:
        # each narrow rung runs under the mesh only after a canary
        # proved it (memoized per mesh and width); unsupported rungs
        # clamp up the ladder to the exact ``search_width``
        from kueue_tpu_torch.parallel.harness import mesh_safe_widths, note_panel_schedule

        safe = mesh_safe_widths(mesh, widths)
        note_panel_schedule(safe, fenced=safe != widths)
        widths = safe
    escalated = False
    for i, width in enumerate(widths):
        if mesh is not None:
            from kueue_tpu_torch.parallel import harness

            harness.note_bucket(
                "preempt_kernel",
                (plan.queues_np["cells"].shape, plan.n_segments, plan.n_steps,
                 plan.max_cycles, int(width)),
                mesh,
            )
        flat = _solve_drain_preempt_packed(
            tree, usage_in, queues, victims, paths,
            n_segments=plan.n_segments, n_steps=plan.n_steps,
            max_cycles=plan.max_cycles, search_width=int(width),
            seg_id=plan.queues_np["seg_id"],
        ).cpu().numpy()  # one fetch per tier; the common case stops at the first
        overflowed = bool(flat[-2])
        if not overflowed or i == len(widths) - 1:
            break
        escalated = True
    if panel_widths is None:
        tuner.observe(search_width, escalated)
    return _preempt_outcome(plan, low, flat, plan.queues_np)


def _preempt_outcome(
    plan: DrainPlan,
    low: _VictimLowering,
    flat: np.ndarray,
    queues_np: dict,
    fair: bool = False,
) -> PreemptDrainOutcome:
    """Unpack a PreemptDrainResult flat vector and map decisions back
    to workloads (shared by the classic and fair preemption drains;
    ``fair`` switches the Preempted-condition reason rules)."""
    lowered = plan.lowered
    s_dim, v_cap = low.s_dim, low.v_cap
    slot_meta, victim_of = low.slot_meta, low.victim_of
    seg_root, row_names = low.seg_root, low.row_names
    extra_fb_entries = low.extra_fb_entries
    victims_np = low.victims_np
    sowner = victims_np["sowner"]
    sprio = victims_np["sprio"]
    sslot_q = victims_np["sslot_q"]
    sslot_l = victims_np["sslot_l"]
    bwc = victims_np["bwc"]
    bwc_thr1 = victims_np["bwc_thr1"]
    cq_rows = plan.queues_np["cq_rows"]

    nq, nl2, npd = queues_np["cells"].shape[:3]  # incl. mesh padding
    ql, sv, qlp = nq * nl2, s_dim * v_cap, nq * nl2 * npd
    off = 0
    status = flat[off : off + ql].reshape((nq, nl2)); off += ql
    adm_k = flat[off : off + qlp].reshape((nq, nl2, npd)); off += qlp
    adm_cycle = flat[off : off + ql].reshape((nq, nl2)); off += ql
    evicted = flat[off : off + sv].reshape((s_dim, v_cap)).astype(bool); off += sv
    evict_cycle = flat[off : off + sv].reshape((s_dim, v_cap)); off += sv
    evict_by = flat[off : off + sv].reshape((s_dim, v_cap)); off += sv
    stuck_q = flat[off : off + nq].astype(bool); off += nq
    cycles = int(flat[-1])
    # truncated = the CYCLE CAP cut undecided work; queues frozen by
    # the stuck machinery are a terminal no-decision, not truncation —
    # rerunning with a larger cap cannot resolve them
    truncated = bool(
        np.any(
            (status == 0)
            & (np.arange(nl2)[None, :] < queues_np["qlen"][:, None])
            & ~stuck_q[:, None]
        )
    )

    lowered = plan.lowered
    admitted: List[Tuple[Workload, str, Dict[str, str], int]] = []
    parked: List[Tuple[Workload, str]] = []
    extra_fallback: List[Tuple[Workload, str]] = list(extra_fb_entries)
    for (qi, pos), i in plan.head_of.items():
        wl = lowered.heads[i]
        cq_name = lowered.cq_names[i]
        st = int(status[qi, pos])
        kk = int(adm_k[qi, pos, 0])
        if st == 2 and kk >= 0:
            admitted.append(
                (wl, cq_name, _admitted_flavors(lowered, i, adm_k[qi, pos]),
                 int(adm_cycle[qi, pos]))
            )
        elif st == 0:
            # still pending at max_cycles: not a decision
            extra_fallback.append((wl, cq_name))
        else:
            parked.append((wl, cq_name))
    admitted.sort(key=lambda t: t[3])
    from kueue_tpu_torch.core.preemption import (
        IN_COHORT_FAIR_SHARING,
        IN_CLUSTER_QUEUE,
        IN_COHORT_RECLAIM_WHILE_BORROWING,
        IN_COHORT_RECLAMATION,
    )
    from kueue_tpu_torch.ops.drain_kernel import NO_BWC_THRESHOLD

    def _evictor_entry(qi: int, cyc: int):
        """(workload, priority) of queue qi's evicting entry at cycle
        cyc: its next admission at/after cyc (a preempting head charges
        usage at the eviction cycle and admits at a later one); falls
        back to the queue's first never-admitted entry when the head
        lost every later re-check and parked."""
        best = None
        first_unadmitted = None
        for pos in range(int(plan.queues_np["qlen"][qi])):
            i = plan.head_of.get((qi, pos))
            if i is None:
                continue
            if int(status[qi, pos]) == 2:
                ac = int(adm_cycle[qi, pos])
                if ac >= cyc and (best is None or ac < best[0]):
                    best = (ac, i, pos)
            elif first_unadmitted is None:
                first_unadmitted = (i, pos)
        if best is not None:
            i, pos = best[1], best[2]
        elif first_unadmitted is not None:
            i, pos = first_unadmitted
        else:
            return None, 0
        return (
            lowered.heads[i],
            int(plan.queues_np["priority"][qi, pos]),
        )

    preempted: List[Tuple[Workload, str, int]] = []
    evictions: List[DrainEviction] = []
    for s in seg_root:
        for slot in range(len(slot_meta.get(s, []))):
            if not evicted[s, slot]:
                continue
            cyc = int(evict_cycle[s, slot])
            ws = victim_of.get((s, slot))
            if ws is not None:
                victim_wl = ws.workload
                victim_cq = row_names[int(sowner[s, slot])]
            else:
                qi, pos = int(sslot_q[s, slot]), int(sslot_l[s, slot])
                i = plan.head_of.get((qi, pos))
                if i is None:
                    continue
                victim_wl = lowered.heads[i]
                victim_cq = lowered.cq_names[i]
            preempted.append((victim_wl, victim_cq, cyc))
            qi_by = int(evict_by[s, slot])
            by_cq = by_wl = None
            reason = IN_CLUSTER_QUEUE
            if 0 <= qi_by < len(plan.cq_order):
                by_cq = plan.cq_order[qi_by]
                by_wl, by_prio = _evictor_entry(qi_by, cyc)
                if int(cq_rows[qi_by]) != int(sowner[s, slot]):
                    if fair:
                        # fair tournament victims from another CQ
                        # (preemption.py _fair_preemptions)
                        reason = IN_COHORT_FAIR_SHARING
                    else:
                        # the ladder's threshold rule
                        # (preemption.go:353-357): below min(evictor
                        # priority, maxPriorityThreshold+1) the reclaim
                        # rode borrowWithinCohort
                        thr = min(by_prio, int(bwc_thr1[qi_by]), NO_BWC_THRESHOLD)
                        if bwc[qi_by] and int(sprio[s, slot]) < thr:
                            reason = IN_COHORT_RECLAIM_WHILE_BORROWING
                        else:
                            reason = IN_COHORT_RECLAMATION
            evictions.append(
                DrainEviction(
                    victim=victim_wl, victim_cq=victim_cq, cycle=cyc,
                    by_cq=by_cq, by_workload=by_wl, reason=reason,
                )
            )
    order = sorted(range(len(preempted)), key=lambda ix: preempted[ix][2])
    preempted = [preempted[ix] for ix in order]
    evictions = [evictions[ix] for ix in order]
    fb = [
        (lowered.heads[i], lowered.cq_names[i]) for i in plan.fallback
    ] + extra_fallback
    return PreemptDrainOutcome(
        admitted=admitted,
        parked=parked,
        fallback=fb,
        cycles=cycles,
        truncated=truncated,
        preempted=preempted,
        evictions=evictions,
    )


def fair_preempt_drain_inputs(
    snapshot: Snapshot,
    pending: Sequence[Tuple[Workload, str]],
    flavors: Dict[str, ResourceFlavor],
    dev,
    max_candidates: int = 8,
    max_cells: int = 4,
    max_victims: int = 512,
    max_victim_cells: int = 4,
    max_fair_cells: int = 64,
    timestamp_fn=None,
    max_cycles: Optional[int] = None,
    now: Optional[float] = None,
    policy=None,
    mesh=None,
):
    """The fair-preempt drain's plan, pool lowering and device inputs,
    as ``run_drain_fair_preempt`` makes them: (plan, lowering, tree,
    paths, leaf usage, DrainQueues, SegVictims, FairSegPanels,
    FairInputs) on ``dev``; under ``mesh`` padded to a multiple of its
    ``wl`` axis and placed through ``place_fair_preempt_drain_inputs``.

    The candidate pools are the classic preemption drain's (fair
    sharing shares _find_candidates and the candidate ordering,
    preemption.go:480-524, :591-618); on top of them each segment gets
    LOCAL fair panels over its ACTIVE cell universe (every
    flavor-resource with quota or usage anywhere in the root cohort plus
    every queued entry's candidate cells: DRS aggregates over all of
    them, fair_sharing.go:49-104). A segment whose universe exceeds
    ``max_fair_cells`` routes its preempt-capable queues to fallback,
    like the batched search's MAX_FAIR_CELLS cap."""
    from kueue_tpu_torch.interop import fair_seg_panels, seg_victims

    plan = plan_drain(
        snapshot, pending, flavors, max_candidates, max_cells, timestamp_fn,
        policy=policy, now=now or 0.0,
    )
    parent_arr = snapshot.flat.parent
    n_cq = snapshot.flat.n_cq
    n_res = len(snapshot.resource_names)
    res_of_fr = snapshot.resource_index.astype(np.int32)
    universe_of: Dict[int, np.ndarray] = {}
    qlen_np = plan.queues_np["qlen"]

    def seg_universe_bad(s: int, members, seg_queues_s) -> bool:
        """The segment's active cell universe; veto the segment (its
        searching queues go to fallback) when it exceeds the panel cap."""
        nodes = set()
        for r in members:
            cur = int(r)
            while cur >= 0:
                nodes.add(cur)
                cur = int(parent_arr[cur])
        rows = np.asarray(sorted(nodes), dtype=np.int64)
        active = (snapshot.nominal[rows] > 0).any(axis=0) | (
            snapshot.local_usage[rows] > 0
        ).any(axis=0)
        for qi in seg_queues_s:
            cells_q = plan.queues_np["cells"][qi, : int(qlen_np[qi])]
            cs = cells_q[cells_q >= 0]
            if cs.size:
                active[np.unique(cs)] = True
        universe_of[s] = np.flatnonzero(active).astype(np.int32)
        return len(universe_of[s]) > max_fair_cells

    low = _lower_victim_pools(
        snapshot, plan, timestamp_fn, now, max_victims, max_victim_cells, max_cycles,
        extra_segment_bad=seg_universe_bad, policy=policy,
    )
    s_dim, v_cap, m_dim = low.s_dim, low.v_cap, low.m_dim

    # ---- fair panels ----
    good = {s: u for s, u in universe_of.items() if len(u) <= max_fair_cells}
    cu = _bucket(max((len(u) for u in good.values()), default=1), minimum=2)
    seg_cells = np.full((s_dim, cu), -1, dtype=np.int32)
    parent_local = np.full((s_dim, m_dim), -1, dtype=np.int32)
    depth_local = np.zeros((s_dim, m_dim), dtype=np.int32)
    is_cq_local = np.zeros((s_dim, m_dim), dtype=bool)
    node_valid = np.zeros((s_dim, m_dim), dtype=bool)
    weight_local = np.full((s_dim, m_dim), 1000, dtype=np.int64)
    res_of_cell = np.full((s_dim, cu), n_res, dtype=np.int32)
    svqty_cu = np.zeros((s_dim, v_cap, cu), dtype=np.int64)

    fair = fair_inputs(snapshot, snapshot.flat.max_depth, dev, mesh=mesh)
    depth_of = fair.depth_of.cpu().numpy()
    victims_by_seg: Dict[int, List[Tuple[int, object]]] = {}
    for (ss, slot), ws in low.victim_of.items():
        victims_by_seg.setdefault(ss, []).append((slot, ws))
    for s, local_id in low.local_ids.items():
        u = good.get(s)
        if u is None:
            continue  # vetoed segment: panels stay inert
        seg_cells[s, : len(u)] = u
        res_of_cell[s, : len(u)] = res_of_fr[u]
        root_depth = min(int(depth_of[g]) for g in local_id)
        for gnode, li in local_id.items():
            node_valid[s, li] = True
            is_cq_local[s, li] = gnode < n_cq
            parent_local[s, li] = local_id.get(int(parent_arr[gnode]), -1)
            weight_local[s, li] = int(snapshot.weight_milli[gnode])
            depth_local[s, li] = int(depth_of[gnode]) - root_depth
        cell_pos = {int(j): ci for ci, j in enumerate(u)}
        for slot, ws in victims_by_seg.get(s, ()):
            for j in np.flatnonzero(ws.usage_vec):
                ci = cell_pos.get(int(j))
                if ci is None:  # usage cells are in the universe by construction
                    raise AssertionError(f"victim cell {j} outside segment {s} universe")
                svqty_cu[s, slot, ci] = int(ws.usage_vec[j])

    fairp_np = dict(
        seg_cells=seg_cells, parent_local=parent_local, depth_local=depth_local,
        is_cq_local=is_cq_local, node_valid=node_valid, weight_local=weight_local,
        res_of_cell=res_of_cell, svqty_cu=svqty_cu,
    )
    if mesh is not None:
        tree, paths, usage_in, queues, victims, panels = _place_preempt(
            snapshot, plan, low, dev, mesh, fairp_np
        )
        return plan, low, tree, paths, usage_in, queues, victims, panels, fair
    tree, paths, usage_in, queues = _drain_device_inputs(snapshot, plan, dev)
    panels = fair_seg_panels(fairp_np, dev)
    return (plan, low, tree, paths, usage_in, queues, seg_victims(low.victims_np, dev),
            panels, fair)


def run_drain_fair_preempt(
    snapshot: Snapshot,
    pending: Sequence[Tuple[Workload, str]],
    flavors: Dict[str, ResourceFlavor],
    max_candidates: int = 8,
    max_cells: int = 4,
    max_victims: int = 512,
    max_victim_cells: int = 4,
    max_fair_cells: int = 64,
    timestamp_fn=None,
    max_cycles: Optional[int] = None,
    now: Optional[float] = None,
    policy=None,
    fs_strategies: Optional[Sequence[str]] = None,
    mesh=None,
    device=None,
) -> PreemptDrainOutcome:
    """Multi-cycle drain with fair-sharing admission order AND
    fair-sharing preemption, the fair-cohort configuration, on the card
    with one fetch (ops/drain_kernel.solve_drain_fair_preempt; inputs as
    ``fair_preempt_drain_inputs`` says). ``fs_strategies`` defaults to
    the Preemptor's [LessThanOrEqualToFinalShare, LessThanInitialShare].
    Victim attribution reasons are InClusterQueue / InCohortFairSharing
    (preemption.py _fair_preemptions). The caller applies the reported
    admissions and evictions in cycle order; this function only decides.

    Runs on the card: ``device`` defaults to ``cuda`` and raises where
    there is none; ``device="cpu"`` runs the plain torch versions.
    ``policy`` scores the flavor candidates and, under PREMA, orders
    the victims by its costs. With ``mesh`` (a ``parallel`` Mesh over
    one device) the per-queue tensors are padded to a multiple of its
    ``wl`` axis and placed on it; a mesh over several devices raises
    NotImplementedError."""
    from kueue_tpu_torch.core.preemption import (
        LESS_THAN_INITIAL_SHARE,
        LESS_THAN_OR_EQUAL_TO_FINAL_SHARE,
    )
    from kueue_tpu_torch.ops.drain_kernel import _solve_drain_fair_preempt_packed

    plan, low, tree, paths, usage_in, queues, victims, panels, fair = (
        fair_preempt_drain_inputs(
            snapshot, pending, flavors, _run_device(mesh, device), max_candidates,
            max_cells, max_victims, max_victim_cells, max_fair_cells, timestamp_fn,
            max_cycles, now, policy=policy, mesh=mesh,
        )
    )
    if mesh is not None:
        from kueue_tpu_torch.parallel import harness

        harness.note_bucket(
            "fair_preempt_kernel",
            (plan.queues_np["cells"].shape, plan.n_segments, plan.n_steps, plan.max_cycles),
            mesh,
        )
    strategies = list(
        fs_strategies or [LESS_THAN_OR_EQUAL_TO_FINAL_SHARE, LESS_THAN_INITIAL_SHARE]
    )
    flat = _solve_drain_fair_preempt_packed(
        tree, usage_in, queues, victims, panels, paths, fair,
        n_segments=plan.n_segments, n_steps=plan.n_steps, max_cycles=plan.max_cycles,
        strategy1=0 if strategies[0] == LESS_THAN_OR_EQUAL_TO_FINAL_SHARE else 1,
        has_second=len(strategies) > 1, seg_id=plan.queues_np["seg_id"],
    ).cpu().numpy()  # the single fetch
    return _preempt_outcome(plan, low, flat, plan.queues_np, fair=True)


# caps keeping the TAS placement exact and its kernel's shared-memory
# rows bounded: MAX_TAS_COUNT * MAX_TAS_DOMAINS < 2^31 (the reference's
# i32 prefix in its split; the port's is int64, clamped as there).
# Gangs above a million pods or merged forests above 2048 leaves route
# to the host cycle loop.
MAX_TAS_COUNT = 1 << 20
MAX_TAS_DOMAINS = 1 << 11


def _merge_tas_forests(snaps, union_res, d_global):
    """Concatenate per-flavor topologies into ONE disjoint domain
    forest, aligned at the LEAF level.

    A flavor with fewer levels gets structural dummy TOP levels (one
    domain per missing level, chained) so seg_ids/parent maps stay
    rectangular; the dummies are semantically unreachable — the kernel
    clamps the preferred-mode relax-up at each flavor's real top
    (TASHeads.t_top). Returns (topo_free, tas_usage, seg_ids,
    n_domains, parent_map, leaf_flavor, leaf_off) on the union resource
    axis, or None when ``snaps`` is empty."""
    if not snaps:
        return None
    from kueue_tpu_torch.ops.tas_kernel import _level_prefix_index

    n_res = max(len(union_res), 1)
    u_index = {r: j for j, r in enumerate(union_res)}
    n_f = len(snaps)
    idxs_of = []
    counts = []  # [F][D] domains per flavor per global level
    for s in snaps:
        df = len(s.level_keys)
        idxs = [_level_prefix_index(s, d) for d in range(df)]
        idxs_of.append(idxs)
        counts.append([1] * (d_global - df) + [len(ix) for ix in idxs])
    n_domains = tuple(sum(counts[f][d] for f in range(n_f)) for d in range(d_global))
    dom_off = [[0] * n_f for _ in range(d_global)]
    for d in range(d_global):
        acc = 0
        for f in range(n_f):
            dom_off[d][f] = acc
            acc += counts[f][d]
    lf_total = sum(len(s._leaf_order) for s in snaps)
    nd_max = max(n_domains)
    seg_ids = np.zeros((d_global, lf_total), dtype=np.int32)
    parent_map = np.zeros((d_global, nd_max), dtype=np.int32)
    topo_free = np.zeros((lf_total, n_res), dtype=np.int64)
    tas_usage = np.zeros((lf_total, n_res), dtype=np.int64)
    leaf_flavor = np.zeros(lf_total, dtype=np.int32)
    leaf_off: Dict[int, int] = {}
    off_l = 0
    for f, s in enumerate(snaps):
        df = len(s.level_keys)
        lvl_off = d_global - df
        nl_f = len(s._leaf_order)
        idxs = idxs_of[f]
        leaf_off[f] = off_l
        leaf_flavor[off_l : off_l + nl_f] = f
        cols = [u_index[r] for r in s._resources]
        topo_free[off_l : off_l + nl_f, cols] = s._free
        tas_usage[off_l : off_l + nl_f, cols] = s._tas_usage
        for d in range(d_global):
            dl = d - lvl_off
            if dl < 0:
                seg_ids[d, off_l : off_l + nl_f] = dom_off[d][f]
            else:
                for i, leaf in enumerate(s._leaf_order):
                    seg_ids[d, off_l + i] = dom_off[d][f] + idxs[dl][leaf.level_values[: dl + 1]]
        for d in range(1, d_global):
            dl = d - lvl_off
            if dl < 0:
                parent_map[d, dom_off[d][f]] = dom_off[d - 1][f]
            elif dl == 0:
                for idx in idxs[0].values():
                    parent_map[d, dom_off[d][f] + idx] = dom_off[d - 1][f]
            else:
                for p, idx in idxs[dl].items():
                    parent_map[d, dom_off[d][f] + idx] = (
                        dom_off[d - 1][f] + idxs[dl - 1][p[:-1]]
                    )
        off_l += nl_f
    return (topo_free, tas_usage, seg_ids, n_domains, parent_map, leaf_flavor, leaf_off)


@dataclass
class TASDrainOutcome(DrainOutcome):
    # TopologyAssignment per admitted entry, aligned with ``admitted``
    # (None for non-TAS workloads)
    assignments: List[object] = field(default_factory=list)


@dataclass
class TASDrainInputs:
    """A TAS drain's host lowering and its inputs on the device (what
    ``tas_drain_inputs`` returns and ``run_drain_tas`` solves)."""

    plan: DrainPlan
    tas_queue: Dict[int, str]  # in-scope queue index -> TAS flavor name
    snaps: Dict[str, object]  # flavor name -> frozen TASFlavorSnapshot
    live_flavors: List[str]
    union_res: List[str]
    leaf_off: Dict[int, int]
    extra_fb: List[Tuple[Workload, str]]
    theads_np: dict
    n_domains: Tuple[int, ...]
    n_steps: int
    # on the device
    tree: object
    paths: object
    local: object
    queues: object
    topo: object  # TASTopology of the merged forest
    theads: object  # TASHeads

    def solve_args(self) -> tuple:
        """The positional arguments of ops/drain_kernel.solve_drain_tas."""
        return (self.tree, self.local, self.queues, self.paths, self.topo.free,
                self.topo.tas_usage, self.topo.seg_ids, self.theads, self.n_domains,
                self.n_steps, self.plan.max_cycles)


def tas_drain_inputs(
    snapshot: Snapshot,
    pending: Sequence[Tuple[Workload, str]],
    flavors: Dict[str, ResourceFlavor],
    tas_cache,
    device,
    max_candidates: int = 8,
    max_cells: int = 4,
    timestamp_fn=None,
    max_cycles: Optional[int] = None,
    policy=None,
    now: float = 0.0,
    mesh=None,
) -> TASDrainInputs:
    """The TAS drain's host lowering (the JAX ``run_drain_tas`` up to
    its solve): the plan, the scope rules, the merged domain forest and
    the per-queue TAS lowering, uploaded to ``device`` with no host
    sync. Under ``mesh`` the queues and the TAS per-queue arrays are
    padded to a multiple of its ``wl`` axis and placed through
    ``place_tas_drain_inputs``."""
    from kueue_tpu_torch._torch import to_device
    from kueue_tpu_torch.core.workload_info import quota_per_pod
    from kueue_tpu_torch.interop import drain_queues, tas_heads, tas_topology
    from kueue_tpu_torch.models.constants import (
        TOPOLOGY_MODE_PREFERRED,
        TOPOLOGY_MODE_REQUIRED,
        TOPOLOGY_MODE_UNCONSTRAINED,
        PreemptionPolicy,
        ReclaimWithinCohortPolicy,
    )
    from kueue_tpu_torch.resources import PODS

    plan = plan_drain(
        snapshot, pending, flavors, max_candidates, max_cells, timestamp_fn,
        allow_tas=True, policy=policy, now=now,
    )
    q = max(len(plan.cq_order), 1)
    nl = plan.queues_np["cells"].shape[1]

    tas_flavor_names = set(tas_cache.flavors)
    mode_id = {
        TOPOLOGY_MODE_REQUIRED: 0,
        TOPOLOGY_MODE_PREFERRED: 1,
        TOPOLOGY_MODE_UNCONSTRAINED: 2,
    }

    def cq_flavor_names(cq_name):
        cq = snapshot.cq_models[cq_name]
        return {fq.name for rg in cq.resource_groups for fq in rg.flavors}

    # ---- scope: classify queues; EVERY in-scope TAS flavor joins the
    # merged domain forest (queues segmented by flavor) ----
    drop: List[int] = []
    tas_queue: Dict[int, str] = {}  # qi -> tas flavor name
    t_bad = np.zeros((q, nl), dtype=bool)
    for qi, cq_name in enumerate(plan.cq_order):
        prem = snapshot.cq_models[cq_name].preemption
        names = cq_flavor_names(cq_name)
        tnames = names & tas_flavor_names
        if not tnames:
            # plain quota queue — topology-requesting entries on a
            # non-TAS flavor are PARKED in kernel at the exact cycle
            # the host would reject the flavor ("does not support
            # TopologyAwareScheduling", tas/manager.py check); the
            # queue itself stays in the drain
            for pos in range(int(plan.queues_np["qlen"][qi])):
                i = plan.head_of.get((qi, pos))
                if i is not None and any(
                    ps.topology_request is not None for ps in plan.lowered.heads[i].pod_sets
                ):
                    t_bad[qi, pos] = True
            continue
        capable = prem.within_cluster_queue != PreemptionPolicy.NEVER or (
            snapshot.has_cohort(cq_name)
            and prem.reclaim_within_cohort != ReclaimWithinCohortPolicy.NEVER
        )
        if capable or len(names) != 1:
            drop.append(qi)
            continue
        tas_queue[qi] = next(iter(tnames))

    # per-flavor snapshots; tainted flavors stay host-side (the kernel
    # has no toleration filtering), and the merged forest caps its
    # domain axis (MAX_TAS_DOMAINS: the placement kernel's rows)
    flavor_names = sorted(set(tas_queue.values()))
    snaps: Dict[str, object] = {}
    total_leaves = 0
    for fname in flavor_names:
        s = tas_cache.flavors[fname].snapshot(device)
        s.freeze()
        over = total_leaves + len(s._leaf_order) > MAX_TAS_DOMAINS
        if over or any(t for t in s._leaf_taints):
            for qi in [k for k, v in tas_queue.items() if v == fname]:
                drop.append(qi)
                del tas_queue[qi]
        else:
            total_leaves += len(s._leaf_order)
            snaps[fname] = s

    # union resource axis + merged level depth
    union_res = sorted({r for s in snaps.values() for r in s._resources})
    n_res_t = max(len(union_res), 1)
    u_index = {r: j for j, r in enumerate(union_res)}
    d_global = max((len(s.level_keys) for s in snaps.values()), default=1)

    # per-entry TAS lowering + scope checks
    t_is = np.zeros(q, dtype=bool)
    t_req = np.zeros((q, nl, n_res_t), dtype=np.int64)
    t_count = np.zeros((q, nl), dtype=np.int32)
    t_level = np.zeros((q, nl), dtype=np.int32)
    t_mode = np.zeros((q, nl), dtype=np.int32)
    t_top = np.zeros(q, dtype=np.int32)
    t_flavor = np.zeros(q, dtype=np.int32)
    dropped = set(drop)
    for qi, fname in tas_queue.items():
        if qi in dropped:
            continue
        snap_f = snaps[fname]
        lvl_off = d_global - len(snap_f.level_keys)
        r_index_f = set(snap_f._resources)
        ok = True
        for pos in range(int(plan.queues_np["qlen"][qi])):
            i = plan.head_of.get((qi, pos))
            if i is None:
                continue
            wl = plan.lowered.heads[i]
            if len(wl.pod_sets) != 1:
                ok = False
                break
            ps = wl.pod_sets[0]
            tr = ps.topology_request
            if tr is None or tr.mode not in mode_id:
                ok = False
                break
            if tr.mode == TOPOLOGY_MODE_UNCONSTRAINED:
                lvl_local = len(snap_f.level_keys) - 1  # lowest level
            elif tr.level in snap_f.level_keys:
                lvl_local = snap_f.level_keys.index(tr.level)
            else:
                ok = False
                break
            per_pod = dict(quota_per_pod(ps, None))
            per_pod[PODS] = per_pod.get(PODS, 0) + 1
            if any(r not in r_index_f for r in per_pod):
                ok = False
                break
            if int(ps.count) > MAX_TAS_COUNT:
                ok = False  # keeps the placement's prefix sums exact
                break
            for r, v in per_pod.items():
                t_req[qi, pos, u_index[r]] = int(v)
            t_count[qi, pos] = int(ps.count)
            t_level[qi, pos] = lvl_off + lvl_local
            t_mode[qi, pos] = mode_id[tr.mode]
        if not ok:
            drop.append(qi)
            dropped.add(qi)
        else:
            t_is[qi] = True
            t_top[qi] = d_global - len(snap_f.level_keys)

    # drop out-of-scope queues to the fallback path
    extra_fb: List[Tuple[Workload, str]] = []
    for qi in sorted(set(drop)):
        plan.queues_np["qlen"][qi] = 0
        plan.queues_np["cq_rows"][qi] = -1
        plan.queues_np["seg_id"][qi] = -1
        for pos in range(nl):
            i = plan.head_of.pop((qi, pos), None)
            if i is not None:
                extra_fb.append((plan.lowered.heads[i], plan.lowered.cq_names[i]))

    if max_cycles is not None:
        plan.max_cycles = max_cycles

    live_flavors = sorted({tas_queue[qi] for qi in tas_queue if qi not in dropped})
    merged = _merge_tas_forests([snaps[f] for f in live_flavors], union_res, d_global)
    if merged is not None:
        (topo_free_np, tas_usage0_np, seg_ids_np, n_domains, parent_map,
         leaf_flavor_np, leaf_off) = merged
        # queue flavor ids on the LIVE flavor axis
        live_idx = {f: i for i, f in enumerate(live_flavors)}
        for qi, fname in tas_queue.items():
            if qi not in dropped:
                t_flavor[qi] = live_idx[fname]
    else:
        # no TAS queue in scope: inert 1-leaf topology
        topo_free_np = np.zeros((1, 1), dtype=np.int64)
        tas_usage0_np = np.zeros((1, 1), dtype=np.int64)
        seg_ids_np = np.zeros((1, 1), dtype=np.int32)
        n_domains = (1,)
        parent_map = np.zeros((1, 1), dtype=np.int32)
        leaf_flavor_np = np.zeros(1, dtype=np.int32)
        leaf_off = {}
        t_req = t_req[:, :, :1]

    theads_np = dict(
        t_is=t_is, t_req=t_req, t_count=t_count, t_level=t_level, t_mode=t_mode,
        t_top=t_top, t_flavor=t_flavor, leaf_flavor=leaf_flavor_np, parent_map=parent_map,
        t_bad=t_bad,
    )
    n_live = int((plan.queues_np["cq_rows"] >= 0).sum())
    tree, paths, _ = tree_arrays(snapshot, device)
    common = dict(
        tas_queue={qi: f for qi, f in tas_queue.items() if qi not in dropped},
        snaps=snaps, live_flavors=live_flavors, union_res=union_res, leaf_off=leaf_off,
        extra_fb=extra_fb, n_domains=tuple(int(n) for n in n_domains),
        n_steps=_bucket(max(n_live, 1), minimum=8),
    )
    if mesh is not None:
        import time

        from kueue_tpu_torch.parallel import harness
        from kueue_tpu_torch.parallel.sharded_solver import (
            pad_tas_arrays,
            place_tas_drain_inputs,
        )

        t0 = time.perf_counter()
        _mesh_pad(plan, mesh)
        theads_np = pad_tas_arrays(theads_np, plan.queues_np["qlen"].shape[0])
        tree, local, queues, paths, topo, theads = place_tas_drain_inputs(
            mesh, tree, snapshot.local_usage, plan.queues_np, paths, topo_free_np,
            tas_usage0_np, seg_ids_np, theads_np, n_domains,
        )
        harness.note_place_seconds(time.perf_counter() - t0)
        return TASDrainInputs(
            plan=plan, theads_np=theads_np, tree=tree, paths=paths, local=local,
            queues=queues, topo=topo, theads=theads, **common,
        )
    return TASDrainInputs(
        plan=plan, theads_np=theads_np,
        tree=tree, paths=paths,
        local=to_device(snapshot.local_usage, device, np.int64),
        queues=drain_queues(plan.queues_np, device),
        topo=tas_topology(dict(free=topo_free_np, tas_usage=tas_usage0_np, seg_ids=seg_ids_np,
                               n_domains=n_domains), device),
        theads=tas_heads(theads_np, device),
        **common,
    )


def _tas_outcome(inp: TASDrainInputs, flat: np.ndarray) -> TASDrainOutcome:
    """Decode the packed TAS drain (``_solve_drain_tas_packed``) and
    replay its placements on the host: per admission cycle against
    cycle-start state, per FLAVOR, the TopologyAssignments are
    reconstructed and the final leaf usage must reproduce the kernel's
    exactly, flavor by flavor."""
    from kueue_tpu_torch.core.workload_info import quota_per_pod
    from kueue_tpu_torch.tas.snapshot import TASPodSetRequest, domain_id

    plan = inp.plan
    queues_np = plan.queues_np
    nq, nl2, npd = queues_np["cells"].shape[:3]
    lf_n, n_res_t = inp.topo.free.shape
    ql, qlp = nq * nl2, nq * nl2 * npd
    off = 0
    adm_k = flat[off : off + qlp].reshape((nq, nl2, npd))
    off += qlp
    adm_cycle = flat[off : off + ql].reshape((nq, nl2))
    off += ql
    adm_step = flat[off : off + ql].reshape((nq, nl2))
    off += ql
    cursor = flat[off : off + nq]
    off += nq
    stuck_q = flat[off : off + nq].astype(bool)
    off += nq
    tas_final = flat[off : off + lf_n * n_res_t].reshape((lf_n, n_res_t))
    cycles = int(flat[-1])
    truncated = bool(np.any((cursor < queues_np["qlen"]) & ~stuck_q))

    lowered = plan.lowered
    admitted: List[Tuple[Workload, str, Dict[str, str], int]] = []
    adm_meta: List[Tuple[int, int, int]] = []  # (cycle, step, index)
    parked: List[Tuple[Workload, str]] = []
    extra_fallback: List[Tuple[Workload, str]] = list(inp.extra_fb)
    for (qi, pos), i in plan.head_of.items():
        wl = lowered.heads[i]
        cq_name = lowered.cq_names[i]
        if int(adm_k[qi, pos, 0]) >= 0:
            adm_meta.append((int(adm_cycle[qi, pos]), int(adm_step[qi, pos]), len(admitted)))
            admitted.append(
                (wl, cq_name, _admitted_flavors(lowered, i, adm_k[qi, pos]),
                 int(adm_cycle[qi, pos]))
            )
        elif pos >= int(cursor[qi]):
            extra_fallback.append((wl, cq_name))
        else:
            parked.append((wl, cq_name))
    order = sorted(range(len(admitted)), key=lambda j: adm_meta[j][:2])
    admitted = [admitted[adm_meta[j][2]] for j in order]
    adm_meta = [adm_meta[j] for j in order]

    # ---- replay: reconstruct TopologyAssignments per admission cycle
    # against cycle-start state (the kernel nominates against it too),
    # per FLAVOR; the final leaf usage must reproduce the kernel's
    # exactly, flavor by flavor ----
    assignments: List[object] = [None] * len(admitted)
    if inp.live_flavors:
        snaps = inp.snaps
        u_index = {r: j for j, r in enumerate(inp.union_res)}
        live_idx = {f: i for i, f in enumerate(inp.live_flavors)}
        flavor_of_cq = {plan.cq_order[qi]: fname for qi, fname in inp.tas_queue.items()}
        j = 0
        while j < len(admitted):
            cyc = adm_meta[j][0]
            batch = []
            while j < len(admitted) and adm_meta[j][0] == cyc:
                wl, cq_name, _, _ = admitted[j]
                if wl.pod_sets[0].topology_request is not None and cq_name in flavor_of_cq:
                    batch.append(j)
                j += 1
            placed = []
            for bj in batch:
                wl, cq_name = admitted[bj][0], admitted[bj][1]
                sf = snaps[flavor_of_cq[cq_name]]
                ps = wl.pod_sets[0]
                req = TASPodSetRequest(
                    podset_name=ps.name,
                    count=ps.count,
                    single_pod_requests=dict(quota_per_pod(ps, None)),
                    topology_request=ps.topology_request,
                    tolerations=tuple(ps.tolerations),
                )
                ta, reason = sf.find_topology_assignment(req, {})
                if reason:  # explicit raise: must survive `python -O`
                    raise AssertionError(f"TAS drain replay failed for {wl.name}: {reason}")
                assignments[bj] = ta
                placed.append((sf, req, ta))
            for sf, req, ta in placed:  # charge AFTER the batch
                for dom in ta.domains:
                    usage = {r: v * dom.count for r, v in req.single_pod_requests.items()}
                    sf.add_tas_usage(domain_id(dom.values), usage, dom.count)
        for fname in inp.live_flavors:
            sf = snaps[fname]
            sf.freeze()
            off = inp.leaf_off[live_idx[fname]]
            nl_f = len(sf._leaf_order)
            cols = [u_index[r] for r in sf._resources]
            sub = tas_final[off : off + nl_f][:, cols]
            if not np.array_equal(sf._tas_usage, sub):
                bad = np.argwhere(sf._tas_usage != sub)[:8]
                raise AssertionError(
                    f"TAS drain replay does not reproduce the kernel's leaf usage for "
                    f"flavor {fname} — placement parity bug; first diffs (leaf, res): "
                    + "; ".join(
                        f"{tuple(ix)}: host={sf._tas_usage[tuple(ix)]} kernel={sub[tuple(ix)]}"
                        for ix in bad
                    )
                )

    fb = [(lowered.heads[i], lowered.cq_names[i]) for i in plan.fallback] + extra_fallback
    return TASDrainOutcome(
        admitted=admitted,
        parked=parked,
        fallback=fb,
        cycles=cycles,
        truncated=truncated,
        assignments=assignments,
    )


def run_drain_tas(
    snapshot: Snapshot,
    pending: Sequence[Tuple[Workload, str]],
    flavors: Dict[str, ResourceFlavor],
    tas_cache,
    max_candidates: int = 8,
    max_cells: int = 4,
    timestamp_fn=None,
    max_cycles: Optional[int] = None,
    mesh=None,
    policy=None,
    now: float = 0.0,
    device=None,
) -> TASDrainOutcome:
    """Multi-cycle drain with Topology-Aware Scheduling heads decided
    on the card (ops/drain_kernel.solve_drain_tas, kernel B13) — the
    lowering and upload, one solve and ONE fetch, then a cheap host
    replay (one placement per ADMITTED workload, grouped per cycle
    against cycle-start state) that reconstructs the
    TopologyAssignments and asserts the kernel's final TAS leaf usage
    is reproduced exactly, flavor by flavor.

    Runs on the card: ``device`` defaults to ``cuda`` and raises where
    there is none; ``device="cpu"`` runs the plain torch versions.

    Scope: single-podset topology requests in ALL THREE modes —
    Required, Preferred (level relaxation,
    tas_flavor_snapshot.go:513-549), Unconstrained — over ANY number of
    taint-free TAS flavors (queues segmented by flavor, each placing
    into its own subtree of one merged domain forest); TAS
    ClusterQueues must be preemption-free and single-flavor, and the
    default BestFit profile applies. Topology requests on non-TAS
    ClusterQueues PARK in kernel at the exact cycle the host would
    reject the flavor. Heads outside the scope route to ``fallback``
    for the cycle loop. With ``mesh`` (a ``parallel`` Mesh over one
    device) the per-queue tensors are padded to a multiple of its
    ``wl`` axis and placed on it; a mesh over several devices raises
    NotImplementedError."""
    from kueue_tpu_torch.ops.drain_kernel import _solve_drain_tas_packed

    dev = _run_device(mesh, device)
    inp = tas_drain_inputs(
        snapshot, pending, flavors, tas_cache, dev, max_candidates, max_cells,
        timestamp_fn, max_cycles=max_cycles, policy=policy, now=now, mesh=mesh,
    )
    if mesh is not None:
        from kueue_tpu_torch.parallel import harness

        harness.note_bucket(
            "tas_kernel",
            (inp.plan.queues_np["cells"].shape, inp.n_domains, inp.n_steps,
             inp.plan.max_cycles),
            mesh,
        )
    flat = _solve_drain_tas_packed(
        *inp.solve_args(), seg_id=inp.plan.queues_np["seg_id"]
    ).cpu().numpy()  # the single fetch
    return _tas_outcome(inp, flat)


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
    tas_cache=None,
    fs_strategies=None,
    timestamp_fn=None,
    mesh=None,
    policy=None,
    now: float = 0.0,
    device=None,
):
    """Dispatch the drain a classify_drain_scope kind names: the one
    place the kind-to-drain mapping lives. ``fs_strategies`` (the
    preemptor's fairSharing.preemptionStrategies) goes to the
    fair-preempt drain, ``tas_cache`` (the TASCache) to the TAS drain."""
    if kind == "tas":
        return run_drain_tas(
            snapshot, pending, flavors, tas_cache, timestamp_fn=timestamp_fn,
            mesh=mesh, policy=policy, now=now, device=device,
        )
    if kind == "fair_preempt":
        return run_drain_fair_preempt(
            snapshot, pending, flavors, timestamp_fn=timestamp_fn,
            fs_strategies=fs_strategies, mesh=mesh, policy=policy, device=device,
        )
    if kind == "preempt":
        return run_drain_preempt(
            snapshot, pending, flavors, timestamp_fn=timestamp_fn, mesh=mesh,
            policy=policy, device=device,
        )
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
        flat = _build.fetch(self.flat_dev, "the drain")  # the single fetch
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


def fair_inputs(snapshot: Snapshot, max_depth: int, dev, mesh=None):
    """The fair drain's extra inputs on ``dev`` (ops/drain_kernel.FairInputs):
    depth, weight and lendable per node, the resource of each cell, and
    the PrioritySortingWithinCohort gate as it stands. Under ``mesh``
    they are placed whole through ``place_fair_drain_extras``."""
    from kueue_tpu_torch._torch import to_device
    from kueue_tpu_torch.features import enabled as feature_enabled
    from kueue_tpu_torch.ops.assign_kernel import build_paths
    from kueue_tpu_torch.ops.drain_kernel import FairInputs

    paths_np = build_paths(snapshot.flat.parent, max_depth)
    depth_of, lendable, res_of_fr = _fair_lendable(snapshot, paths_np)
    if mesh is not None:
        from kueue_tpu_torch.parallel.sharded_solver import place_fair_drain_extras

        return place_fair_drain_extras(
            mesh, depth_of, snapshot.weight_milli, lendable, res_of_fr,
            len(snapshot.resource_names),
            bool(feature_enabled("PrioritySortingWithinCohort")),
        )
    return FairInputs(
        depth_of=to_device(depth_of, dev, np.int32),
        weight=to_device(snapshot.weight_milli, dev, np.int64),
        lendable=to_device(lendable, dev, np.int64),
        res_of_fr=to_device(res_of_fr, dev, np.int32),
        n_res=len(snapshot.resource_names),
        prio_tie=bool(feature_enabled("PrioritySortingWithinCohort")),
    )


def _run_device(mesh, device):
    """The device a drain runs on: under ``mesh`` its one device (a mesh
    over several distinct devices raises NotImplementedError before any
    device is touched), else ``device`` (the card unless the caller
    names the CPU)."""
    from kueue_tpu_torch._torch import resolve_device

    if mesh is None:
        return resolve_device(device)
    from kueue_tpu_torch.parallel.sharded_solver import mesh_device

    dev = mesh_device(mesh)
    if device is not None and resolve_device(device).type != dev.type:
        raise ValueError(f"device={device} disagrees with the mesh's device {dev}")
    return dev


def _mesh_pad(plan: DrainPlan, mesh) -> None:
    """Pad the plan's Q axis to a multiple of the mesh's ``wl`` axis
    with inert queues (qlen 0, cq_row/seg_id -1). The decode reads the
    padded ``plan.queues_np`` and skips the pads as it skips empty
    queues, so the decisions do not change with the mesh."""
    from kueue_tpu_torch.parallel.sharded_solver import pad_queue_arrays

    plan.queues_np = pad_queue_arrays(plan.queues_np, mesh.shape["wl"])


def _drain_device_inputs(snapshot: Snapshot, plan: DrainPlan, dev, resident=None, mesh=None):
    """(tree, paths, leaf usage, DrainQueues) on ``dev``, uploaded with
    no host sync; with ``resident`` (a ResidentEncoder on ``dev``) the
    tree and paths stay on the card and only changed usage rows ship.
    Under ``mesh`` the plan's Q axis is padded to a multiple of ``wl``
    and the inputs are placed through ``place_drain_inputs`` (the
    resident buffers are single-device only)."""
    import time

    from kueue_tpu_torch._torch import to_device
    from kueue_tpu_torch.interop import drain_queues

    if mesh is not None:
        from kueue_tpu_torch.parallel import harness
        from kueue_tpu_torch.parallel.sharded_solver import place_drain_inputs

        if resident is not None:
            raise ValueError(
                "resident=... is single-device only: the mesh path places its "
                "inputs on the mesh every launch — pass resident=None under a mesh"
            )
        t0 = time.perf_counter()
        _mesh_pad(plan, mesh)
        tree, paths, _ = tree_arrays(snapshot, dev)
        tree, usage_in, queues, paths = place_drain_inputs(
            mesh, tree, snapshot.local_usage, plan.queues_np, paths
        )
        harness.note_place_seconds(time.perf_counter() - t0)
        return tree, paths, usage_in, queues
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
    fair drain (see ``run_drain``). With ``mesh`` (a ``parallel`` Mesh
    over one device; ``resident`` must be None) the queues are padded
    to a multiple of its ``wl`` axis and placed on it; a mesh over
    several devices raises NotImplementedError."""
    from kueue_tpu_torch.ops.drain_kernel import _solve_drain_packed

    dev = _run_device(mesh, device)
    plan = plan_drain(
        snapshot, pending, flavors, max_candidates, max_cells, timestamp_fn,
        policy=policy, now=now,
    )
    extra_fb = _route_preempt_capable(snapshot, plan) if fair_sharing else []
    if max_cycles is not None:
        plan.max_cycles = max_cycles
    tree, paths, usage_in, queues = _drain_device_inputs(snapshot, plan, dev, resident, mesh)
    if mesh is not None:
        from kueue_tpu_torch.parallel import harness

        harness.note_bucket(
            "drain_kernel",
            (plan.queues_np["cells"].shape, plan.n_segments, plan.n_steps, plan.max_cycles,
             "fair" if fair_sharing else "plain"),
            mesh,
        )
    flat_dev = _solve_drain_packed(
        tree, usage_in, queues, paths,
        n_segments=plan.n_segments, n_steps=plan.n_steps, max_cycles=plan.max_cycles,
        seg_id=plan.queues_np["seg_id"],
        fair=fair_inputs(snapshot, tree.max_depth, dev, mesh) if fair_sharing else None,
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
    use_device: bool = True,
) -> DrainOutcome:
    """Plan + solve + map back, with one device-to-host copy.

    Runs on the card: ``device`` defaults to ``cuda`` and raises where
    there is none; ``device="cpu"`` runs the plain torch versions of
    the kernels on the host. ``max_cycles`` overrides the computed
    backstop. With ``fair_sharing`` each cycle's admission order is the
    fair-sharing cohort tournament (ops/drain_kernel.solve_drain with
    ``fair``) instead of the (borrowing, priority, FIFO) sort;
    preempt-capable ClusterQueues route to ``fallback``. ``policy``
    (kueue_tpu_torch/policy) scores the flavor candidates and boosts
    priorities at ``now``. ``mesh`` (a ``parallel`` Mesh over one
    device) pads the queues to a multiple of its ``wl`` axis and places
    them on it; a mesh over several devices raises NotImplementedError.

    ``use_device=False`` solves the identical plan on the numpy host
    mirror (ops/drain_np.solve_drain_np), bit-for-bit the same
    decisions: the runtime's sampled divergence check. Plain scope
    only."""
    if not use_device:
        return _run_drain_np(
            snapshot, pending, flavors, max_candidates, max_cells, timestamp_fn,
            max_cycles, mesh, fair_sharing, policy, now,
        )
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
        flat = _build.fetch(self.flat_dev, "the megaloop")  # the single fetch
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


def _run_drain_np(snapshot, pending, flavors, max_candidates, max_cells, timestamp_fn,
                  max_cycles, mesh, fair_sharing, policy, now) -> DrainOutcome:
    """``run_drain(use_device=False)``: the plan solved by the numpy
    mirror, no tensor anywhere."""
    from kueue_tpu_torch.core.encode import encode_snapshot
    from kueue_tpu_torch.ops.assign_kernel import build_paths
    from kueue_tpu_torch.ops.drain_np import solve_drain_np

    if fair_sharing or mesh is not None:
        raise ValueError(
            "use_device=False covers the plain drain only (no fair "
            "tournament, no mesh sharding)"
        )
    plan = plan_drain(
        snapshot, pending, flavors, max_candidates, max_cells, timestamp_fn,
        policy=policy, now=now,
    )
    if max_cycles is not None:
        plan.max_cycles = max_cycles
    enc = encode_snapshot(snapshot)
    host = solve_drain_np(
        enc.parent,
        enc.level_mask,
        enc.nominal.astype(np.int64, copy=False),
        enc.lending_limit.astype(np.int64, copy=False),
        enc.borrowing_limit.astype(np.int64, copy=False),
        enc.local_usage.astype(np.int64, copy=False),
        plan.queues_np,
        build_paths(enc.parent, enc.max_depth),
        enc.max_depth,
        plan.max_cycles,
    )
    return _map_drain_result(
        plan, host.admitted_k, host.admitted_cycle, host.cursor, host.stuck,
        int(host.cycles), plan.queues_np, extra_fb_entries=[],
        final_usage=np.asarray(host.local_usage),
    )


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
    between launches. With ``mesh`` (a ``parallel`` Mesh over one
    device; ``resident`` must be None) the queues and the suffix retry
    budgets are padded to a multiple of its ``wl`` axis and placed on
    it; a mesh over several devices raises NotImplementedError."""
    from kueue_tpu_torch._torch import to_device
    from kueue_tpu_torch.ops.megaloop_kernel import _solve_drain_megaloop_packed

    dev = _run_device(mesh, device)
    plan = plan_drain(
        snapshot, pending, flavors, max_candidates, max_cells, timestamp_fn,
        policy=policy, now=now,
    )
    tree, paths, usage_in, queues = _drain_device_inputs(snapshot, plan, dev, resident, mesh)
    # after the mesh padding: inert queues get zero budgets
    cap_suffix = _cap_suffix_of(plan)
    if mesh is not None:
        from kueue_tpu_torch.parallel import harness

        harness.note_bucket(
            "megaloop_kernel",
            (plan.queues_np["cells"].shape, plan.n_segments, plan.n_steps,
             int(chunk_cycles), int(max_rounds)),
            mesh,
        )
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
