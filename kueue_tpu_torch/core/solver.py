"""Host glue lowering a Snapshot + pending workloads into dense tensors
(port of kueue_tpu/core/solver.py, the drain's part).

It mirrors the candidate enumeration the host FlavorAssigner performs
sequentially — flavor eligibility (taints, node-selector labels),
resume-from-cursor (LastAssignment), per-resource-group cartesian
candidates — but emits it as padded numpy tensors the drain consumes.
Workloads the dense form cannot represent exactly (resources not
covered, no eligible flavor, candidate fan-out beyond K or cells beyond
C, TAS podsets) are reported in ``MultiLowered.fallback``.

This slice carries ``lower_heads_multi`` (the drain's lowering), its
template builder, ``tree_arrays`` and ``_bucket``. The interactive
cycle's ``lower_heads`` / ``pack_heads`` / ``dispatch_lowered`` and
``ResidentCycleState`` belong to the cycle path and are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kueue_tpu_torch.models import ResourceFlavor, Workload
from kueue_tpu_torch.models.cluster_queue import ClusterQueue
from kueue_tpu_torch.models.constants import FlavorFungibilityPolicy
from kueue_tpu_torch.models.resource_flavor import flavor_eligible, group_label_keys
from kueue_tpu_torch.core.snapshot import Snapshot
from kueue_tpu_torch.core.workload_info import effective_podset_count, quota_per_pod
from kueue_tpu_torch.resources import PODS, FlavorResource
from kueue_tpu_torch.utils.priority import priority_of

def _default_fungibility(cq: ClusterQueue) -> bool:
    ff = cq.flavor_fungibility
    return (
        ff.when_can_borrow == FlavorFungibilityPolicy.BORROW
        and ff.when_can_preempt == FlavorFungibilityPolicy.TRY_NEXT_FLAVOR
    )


class _Template:
    """Quantity-independent lowering of one (CQ, podset shape, cursor)
    combination — the candidate enumeration is identical for every
    workload sharing it, so bulk lowering (50k-pending drains) builds it
    once and only fills per-workload quantities."""

    __slots__ = (
        "fallback",
        "n_groups",
        "cq_row",
        "no_reclaim",
        "candidates",
        "any_valid",
        "cells_arr",
        "valid_row",
        "qty_sel",
        "cgrp_arr",
        "res_names",
        "flavor_list",
        "tried_list",
        "group_list",
        "group_sizes",
    )

    def __init__(self):
        self.fallback = False
        self.n_groups = 0
        self.cq_row = -1
        self.no_reclaim = False
        # per candidate slot: None (invalid) or
        # (cell_js, cell_resources, flavor_map, tried_map)
        self.candidates: List = []
        self.any_valid = False
        # dense per-template rows shared by every head using it:
        # cells_arr int32[K,C]; valid_row bool[K]; qty_sel int32[K,C]
        # indexes a per-head request vector laid out as res_names + [0]
        self.cells_arr = None
        self.valid_row = None
        self.qty_sel = None
        # int8[K,C]: resource-group index of each candidate cell (-1 pad)
        self.cgrp_arr = None
        self.res_names: Tuple[str, ...] = ()
        self.flavor_list: List[Dict[str, str]] = []
        self.tried_list: List[Dict[str, int]] = []
        # per candidate: tuple per group of (flavor idx in rg.flavors,
        # is-last-flavor flag); empty tuple for invalid candidates
        self.group_list: List[tuple] = []
        # full walk length (len(rg.flavors)) per touched group — sizes
        # the drain's convergent-retry odometer bound
        self.group_sizes: Tuple[int, ...] = ()


def _podset_sig(ps, per_pod) -> tuple:
    sel = tuple(sorted(ps.node_selector.items())) if ps.node_selector else ()
    return (tuple(sorted(per_pod)), sel, tuple(ps.tolerations))


def _build_template(
    snapshot: Snapshot,
    cq,
    cq_name: str,
    ps,
    per_pod: Dict[str, int],  # quota-view requests (overhead+transform)
    starts: Tuple[int, ...],
    flavors: Dict[str, ResourceFlavor],
    k: int,
    c: int,
    allow_tas: bool = False,
) -> _Template:
    t = _Template()

    # resource groups touched by this podset, in CQ order (names only —
    # quantities are per-workload)
    touched: List[Tuple[object, List[str]]] = []
    for rg in cq.resource_groups:
        rg_res = [r for r in sorted(per_pod) if r in rg.covered_resources]
        if PODS in rg.covered_resources:
            rg_res.append(PODS)
        if rg_res:
            touched.append((rg, sorted(rg_res)))
    covered = {r for rg, _ in touched for r in rg.covered_resources}
    if any(r not in covered for r in per_pod):
        t.fallback = True  # resource not covered: host reports it
        return t
    t.n_groups = len(touched)
    t.group_sizes = tuple(len(rg.flavors) for rg, _ in touched)

    per_rg: List[List[Tuple[str, int]]] = []
    for gidx, (rg, rg_res) in enumerate(touched):
        label_keys = group_label_keys(rg.flavors, flavors)
        start = starts[gidx] if gidx < len(starts) else 0
        n_flavors = len(rg.flavors)
        options: List[Tuple[str, int]] = []
        for gi in range(start, n_flavors):
            fq = rg.flavors[gi]
            flavor = flavors.get(fq.name)
            if (
                not allow_tas
                and flavor is not None
                and flavor.topology_name is not None
            ):
                # TAS flavors (incl. implied TAS on TAS-only CQs)
                # need topology placement — host path only, unless the
                # caller is the TAS drain (run_drain_tas), which does
                # the placement in kernel
                t.fallback = True
                return t
            if flavor_eligible(flavor, ps, label_keys):
                # host cursor semantics: a FIT at the group's last
                # flavor stores -1 (restart from 0 next time)
                last = gi == n_flavors - 1
                tried = -1 if last else gi
                options.append((fq.name, tried, gi, last))
        if not options:
            t.fallback = True
            return t
        per_rg.append(options)

    n_cand = 1
    for options in per_rg:
        n_cand *= len(options)
    n_cells = sum(len(rg_res) for _, rg_res in touched)
    if n_cand > k or n_cells > c:
        t.fallback = True
        return t

    # cartesian product across RGs in reference order (first RG's
    # flavor walk is the outer loop — matches the sequential search
    # trying RG1 flavors fully per RG0 choice)
    combos: List[List[tuple]] = [[]]
    for gidx, options in enumerate(per_rg):
        combos = [
            prev + [(gidx, f, tr, gi, lastf)]
            for prev in combos
            for (f, tr, gi, lastf) in options
        ]

    from kueue_tpu_torch.core.preemption import can_always_reclaim

    t.cq_row = snapshot.row(cq_name)
    t.no_reclaim = not can_always_reclaim(cq)
    for combo in combos:
        cell_js: List[int] = []
        cell_rs: List[str] = []
        cell_gs: List[int] = []
        flavor_map: Dict[str, str] = {}
        tried_map: Dict[str, int] = {}
        gvec: List[tuple] = []
        ok = True
        for gidx, fname, tried, gi, lastf in combo:
            gvec.append((gi, lastf))
            for r in touched[gidx][1]:
                j = snapshot.fr_index.get(FlavorResource(fname, r))
                if j is None:
                    ok = False
                    break
                cell_js.append(j)
                cell_rs.append(r)
                cell_gs.append(gidx)
                flavor_map[r] = fname
                tried_map[r] = tried
            if not ok:
                break
        if ok:
            t.candidates.append(
                (tuple(cell_js), tuple(cell_rs), flavor_map, tried_map, tuple(cell_gs))
            )
            t.group_list.append(tuple(gvec))
            t.any_valid = True
        else:
            t.candidates.append(None)
            t.group_list.append(())
    if not t.any_valid:
        t.fallback = True
        return t

    # dense rows for the vectorized per-head fill
    res_names = tuple(sorted({r for _, rg_res in touched for r in rg_res}))
    r_idx = {r: x for x, r in enumerate(res_names)}
    t.res_names = res_names
    t.cells_arr = np.full((k, c), -1, dtype=np.int32)
    t.valid_row = np.zeros(k, dtype=bool)
    # unused cell slots select the trailing 0 of the request vector
    t.qty_sel = np.full((k, c), len(res_names), dtype=np.int32)
    t.cgrp_arr = np.full((k, c), -1, dtype=np.int8)
    for ki, cand in enumerate(t.candidates):
        if cand is None:
            t.flavor_list.append({})
            t.tried_list.append({})
            continue
        cell_js, cell_rs, flavor_map, tried_map, cell_gs = cand
        for ci, (j, r, cg) in enumerate(zip(cell_js, cell_rs, cell_gs)):
            t.cells_arr[ki, ci] = j
            t.qty_sel[ki, ci] = r_idx[r]
            t.cgrp_arr[ki, ci] = cg
        t.valid_row[ki] = True
        t.flavor_list.append(flavor_map)
        t.tried_list.append(tried_map)
    return t


def _resolve_starts(cq, per_pod, state, ps_idx: int) -> Tuple[int, ...]:
    """Per-resource-group cursor starts from a workload's
    LastAssignment (AssignmentState.next_flavor_to_try) — ONE
    definition shared by the cycle and drain lowerings."""
    if state is None:
        return ()
    starts_l = []
    for rg in cq.resource_groups:
        rg_res = [r for r in sorted(per_pod) if r in rg.covered_resources]
        if PODS in rg.covered_resources:
            rg_res.append(PODS)
        if rg_res:
            starts_l.append(state.next_flavor_to_try(ps_idx, sorted(rg_res)[0]))
    return tuple(starts_l)


def tree_arrays(snapshot: Snapshot, device):
    """(QuotaTree, paths, roots) device inputs from a Snapshot, via the
    shared snapshot->array codec (core/encode.py)."""
    from kueue_tpu_torch.core.encode import device_arrays, encode_snapshot

    return device_arrays(encode_snapshot(snapshot), device)


def _bucket(w: int, minimum: int = 64) -> int:
    """Round up to a power of two, at least ``minimum``, as the JAX
    package does: the drain plan's sizes (n_segments, n_steps,
    max_cycles) then equal the reference's, so phase 2 drops the same
    ranks (those >= n_steps) and a truncated drain stops at the same
    cycle."""
    n = minimum
    while n < w:
        n *= 2
    return n


@dataclass
class MultiLowered:
    """Dense multi-podset head batch for the drain: the single-podset
    layout with an extra P axis (podsets padded to a common max). A
    workload's podsets nominate SEQUENTIALLY in the kernel — the
    host couples them only through assignment_usage at shared
    (flavor, resource) cells, so each podset keeps its own candidate
    template, cursor vector, and walk."""

    cq_row: np.ndarray  # int32[W]
    n_podsets: np.ndarray  # int32[W]
    cells: np.ndarray  # int32[W,P,K,C]
    qty: np.ndarray  # int64[W,P,K,C]
    valid: np.ndarray  # bool[W,P,K]
    cgrp: np.ndarray  # int8[W,P,K,C]
    priority: np.ndarray  # int64[W]
    timestamp: np.ndarray  # int64[W]
    no_reclaim: np.ndarray  # bool[W]
    ffb: np.ndarray  # bool[W]
    ffp: np.ndarray  # bool[W]
    # int64[W,P,K] admission-policy candidate scores (kueue_tpu/policy:
    # annotate_multi); None = default first-fit (plan_drain ships zeros)
    score: Optional[np.ndarray] = None
    # per head per podset: candidate k -> maps (template-shared lists)
    candidate_flavors: List[List[list]] = field(default_factory=list)
    candidate_groups: List[List[list]] = field(default_factory=list)
    heads: List[Workload] = field(default_factory=list)
    cq_names: List[str] = field(default_factory=list)
    fallback: List[int] = field(default_factory=list)
    n_groups: List[int] = field(default_factory=list)  # max over podsets
    # per head: number of distinct joint cursor states its podsets' walk
    # odometer can take — prod over podsets of prod over groups of
    # (walk length + 1); a CONVERGENT PendingFlavors retry sequence
    # cannot exceed it, so it is the sound stuck-detection budget
    walk_states: List[int] = field(default_factory=list)


def lower_heads_multi(
    snapshot: Snapshot,
    heads: Sequence[Tuple[Workload, str]],
    flavors: Dict[str, ResourceFlavor],
    max_candidates: int = 8,
    max_cells: int = 16,
    max_podsets: int = 4,
    timestamp_fn=None,
    transform=None,
    any_fungibility: bool = True,
    allow_tas: bool = False,
) -> MultiLowered:
    """lower_heads generalized over podsets (drain path).

    Cursor starts resolve per (podset index, resource) from the
    workload's LastAssignment, exactly like the host's
    AssignmentState.next_flavor_to_try."""
    w = len(heads)
    k, c = max_candidates, max_cells
    # size the podset axis to what the batch actually needs: the
    # common all-single-podset backlog must not pay 4x the memory and
    # memset of a padded axis
    pmax = max(
        [1]
        + [
            len(wl.pod_sets)
            for wl, cqn in heads
            if len(wl.pod_sets) <= max_podsets
            and cqn in snapshot.cq_models
        ]
    )
    out = MultiLowered(
        cq_row=np.full(w, -1, dtype=np.int32),
        n_podsets=np.zeros(w, dtype=np.int32),
        cells=np.full((w, pmax, k, c), -1, dtype=np.int32),
        qty=np.zeros((w, pmax, k, c), dtype=np.int64),
        valid=np.zeros((w, pmax, k), dtype=bool),
        cgrp=np.full((w, pmax, k, c), -1, dtype=np.int8),
        priority=np.zeros(w, dtype=np.int64),
        timestamp=np.zeros(w, dtype=np.int64),
        no_reclaim=np.zeros(w, dtype=bool),
        ffb=np.ones(w, dtype=bool),
        ffp=np.zeros(w, dtype=bool),
    )
    templates: Dict[tuple, _Template] = {}
    groups: Dict[tuple, tuple] = {}  # (key, p) -> (t, idxs, pcs)

    for i, (wl, cq_name) in enumerate(heads):
        out.heads.append(wl)
        out.cq_names.append(cq_name)
        # per-podset maps appended as podsets lower (indexed p <
        # n_podsets only; fallback heads keep empty lists)
        flav_i: list = []
        grp_i: list = []
        out.candidate_flavors.append(flav_i)
        out.candidate_groups.append(grp_i)
        out.n_groups.append(0)
        out.walk_states.append(1)
        if cq_name not in snapshot.cq_models:
            out.fallback.append(i)
            continue
        cq = snapshot.cq_models[cq_name]
        if len(wl.pod_sets) > max_podsets or (
            not any_fungibility and not _default_fungibility(cq)
        ):
            out.fallback.append(i)
            continue
        ff = cq.flavor_fungibility
        out.ffb[i] = ff.when_can_borrow == FlavorFungibilityPolicy.BORROW
        out.ffp[i] = ff.when_can_preempt == FlavorFungibilityPolicy.PREEMPT

        state = wl.last_assignment
        gen = snapshot.generations.get(cq_name, 0)
        if state is not None and gen > state.cluster_queue_generation:
            state = None

        # fast path: the overwhelmingly common single-podset head skips
        # the per-podset list plumbing below (bulk-drain lowering cost)
        if len(wl.pod_sets) == 1:
            ps = wl.pod_sets[0]
            if ps.topology_request is not None and not allow_tas:
                out.fallback.append(i)
                continue
            per_pod = quota_per_pod(ps, transform)
            starts = _resolve_starts(cq, per_pod, state, 0)
            key = (cq_name, _podset_sig(ps, per_pod), starts)
            t = templates.get(key)
            if t is None:
                t = _build_template(
                    snapshot, cq, cq_name, ps, per_pod, starts, flavors, k, c,
                    allow_tas=allow_tas,
                )
                templates[key] = t
            if t.fallback:
                out.fallback.append(i)
                continue
            out.cq_row[i] = t.cq_row
            out.n_podsets[i] = 1
            out.no_reclaim[i] = t.no_reclaim
            out.priority[i] = priority_of(wl, snapshot.priority_classes)
            ts = timestamp_fn(wl) if timestamp_fn else wl.creation_time
            out.timestamp[i] = int(ts * 1e9)
            out.n_groups[i] = t.n_groups
            ws = 1
            for n_g in t.group_sizes:
                ws *= n_g + 1
            out.walk_states[i] = ws
            flav_i.append(t.flavor_list)
            grp_i.append(t.group_list)
            group = groups.get((key, 0))
            if group is None:
                group = groups[(key, 0)] = (t, [], [])
            group[1].append(i)
            group[2].append((per_pod, effective_podset_count(wl, ps)))
            continue

        bad = False
        head_templates = []
        for ps_idx, ps in enumerate(wl.pod_sets):
            if ps.topology_request is not None and not allow_tas:
                bad = True  # TAS placement stays on the host path
                break
            per_pod = quota_per_pod(ps, transform)
            starts = _resolve_starts(cq, per_pod, state, ps_idx)
            key = (cq_name, _podset_sig(ps, per_pod), starts)
            t = templates.get(key)
            if t is None:
                t = _build_template(
                    snapshot, cq, cq_name, ps, per_pod, starts, flavors, k, c
                )
                templates[key] = t
            if t.fallback:
                bad = True
                break
            head_templates.append((key, t, ps, per_pod))
        if bad:
            out.fallback.append(i)
            continue

        out.cq_row[i] = head_templates[0][1].cq_row
        out.n_podsets[i] = len(wl.pod_sets)
        out.no_reclaim[i] = head_templates[0][1].no_reclaim
        out.priority[i] = priority_of(wl, snapshot.priority_classes)
        ts = timestamp_fn(wl) if timestamp_fn else wl.creation_time
        out.timestamp[i] = int(ts * 1e9)
        out.n_groups[i] = max(t.n_groups for _, t, _, _ in head_templates)
        ws = 1
        for _, t, _, _ in head_templates:
            for n_g in t.group_sizes:
                ws *= n_g + 1
        out.walk_states[i] = ws
        for p, (key, t, ps, per_pod) in enumerate(head_templates):
            flav_i.append(t.flavor_list)
            grp_i.append(t.group_list)
            count = effective_podset_count(wl, ps)
            group = groups.get((key, p))
            if group is None:
                group = groups[(key, p)] = (t, [], [])
            group[1].append(i)
            group[2].append((per_pod, count))

    for (key, p), (t, idxs, pcs) in groups.items():
        ii = np.asarray(idxs, dtype=np.intp)
        out.cells[ii, p] = t.cells_arr
        out.valid[ii, p] = t.valid_row
        out.cgrp[ii, p] = t.cgrp_arr
        rmat = np.zeros((len(ii), len(t.res_names) + 1), dtype=np.int64)
        for x, r in enumerate(t.res_names):
            if r == PODS:
                rmat[:, x] = [count for (_, count) in pcs]
            else:
                rmat[:, x] = [pp.get(r, 0) * count for (pp, count) in pcs]
        out.qty[ii, p] = rmat[:, t.qty_sel]
    return out
