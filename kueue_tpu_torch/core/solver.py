"""Host glue lowering a Snapshot + heads into dense tensors (port of
kueue_tpu/core/solver.py).

It mirrors the candidate enumeration the host FlavorAssigner performs
sequentially — flavor eligibility (taints, node-selector labels),
resume-from-cursor (LastAssignment), per-resource-group cartesian
candidates — but emits it as padded numpy tensors the solvers consume.
Heads the dense form cannot represent exactly are reported in
``fallback`` and nominate on the host.

Two lowerings: ``lower_heads`` for the interactive cycle (one podset,
default fungibility; ``dispatch_lowered`` ships it to the cycle solver,
``ops/assign_kernel.solve_cycle_segmented_packed``, with the quota
tensors kept on the card between cycles by ``ResidentCycleState``) and
``lower_heads_multi`` for the bulk drain. ``dispatch_lowered(mesh=)``
places the cycle on a ``parallel`` Mesh over one device (W padded to its
``wl`` axis) and runs the same segmented solve.
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
from kueue_tpu_torch.ops._build import KernelError
from kueue_tpu_torch.ops.assign_kernel import solve_cycle_segmented_packed
from kueue_tpu_torch.ops.resident import scatter_rows


@dataclass
class Lowered:
    """Dense batch + bookkeeping to map results back to workloads."""

    cq_row: np.ndarray  # int32[W]
    cells: np.ndarray  # int32[W,K,C]
    qty: np.ndarray  # int64[W,K,C]
    valid: np.ndarray  # bool[W,K]
    priority: np.ndarray  # int64[W]
    timestamp: np.ndarray  # int64[W] (ns)
    no_reclaim: np.ndarray  # bool[W] — reserve capacity when blocked
    # int64[W,K] admission-policy candidate scores (kueue_tpu_torch/policy:
    # annotate_lowered compiles them from workload labels); None = the
    # default first-fit policy (pack_heads ships zeros, the kernel's
    # score-argmax then IS the first-fit argmax)
    score: Optional[np.ndarray] = None

    # per head: candidate k -> flavor name chosen per resource group
    candidate_flavors: List[List[Dict[str, str]]] = field(default_factory=list)
    # per head: candidate k -> resource -> host-equivalent tried-flavor
    # cursor (LastAssignment idx; -1 when the chosen flavor is the last
    # of its resource group, matching _find_flavor_for_resource)
    candidate_tried: List[List[Dict[str, int]]] = field(default_factory=list)
    heads: List[Workload] = field(default_factory=list)
    cq_names: List[str] = field(default_factory=list)
    fallback: List[int] = field(default_factory=list)  # indices into input heads
    # per head: number of resource groups its request touches
    n_groups: List[int] = field(default_factory=list)


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


def lower_heads(
    snapshot: Snapshot,
    heads: Sequence[Tuple[Workload, str]],
    flavors: Dict[str, ResourceFlavor],
    max_candidates: int = 8,
    max_cells: int = 16,
    timestamp_fn=None,
    transform=None,  # ResourceTransformConfig for the quota view
) -> Lowered:
    """Build the dense head batch for the INTERACTIVE cycle path; route
    inexpressible heads to ``fallback`` (handled by the host
    FlavorAssigner). The drain lowers via lower_heads_multi, which also
    carries multi-podset, fungibility-policy and cursor-vector inputs.

    Candidate enumeration is memoized per (CQ, podset shape, cursor):
    a bulk backlog over 1k CQs lowers in O(templates + heads), not
    O(heads x flavors)."""
    w = len(heads)
    k, c = max_candidates, max_cells
    out = Lowered(
        cq_row=np.full(w, -1, dtype=np.int32),
        cells=np.full((w, k, c), -1, dtype=np.int32),
        qty=np.zeros((w, k, c), dtype=np.int64),
        valid=np.zeros((w, k), dtype=bool),
        priority=np.zeros(w, dtype=np.int64),
        timestamp=np.zeros(w, dtype=np.int64),
        no_reclaim=np.zeros(w, dtype=bool),
    )
    templates: Dict[tuple, _Template] = {}
    # template key -> (template, head indexes, per-head (per_pod, count))
    groups: Dict[tuple, tuple] = {}

    for i, (wl, cq_name) in enumerate(heads):
        out.heads.append(wl)
        out.cq_names.append(cq_name)
        out.candidate_flavors.append([])
        out.candidate_tried.append([])
        out.n_groups.append(0)
        if cq_name not in snapshot.cq_models:
            out.fallback.append(i)
            continue
        cq = snapshot.cq_models[cq_name]
        if len(wl.pod_sets) != 1 or not _default_fungibility(cq):
            out.fallback.append(i)
            continue
        ps = wl.pod_sets[0]
        if ps.topology_request is not None:
            out.fallback.append(i)  # TAS placement stays on the host path
            continue
        per_pod = quota_per_pod(ps, transform)

        # per-RG cursor starts (LastAssignment resume)
        state = wl.last_assignment
        gen = snapshot.generations.get(cq_name, 0)
        if state is not None and gen > state.cluster_queue_generation:
            state = None
        starts = _resolve_starts(cq, per_pod, state, 0)

        key = (cq_name, _podset_sig(ps, per_pod), starts)
        t = templates.get(key)
        if t is None:
            t = _build_template(
                snapshot, cq, cq_name, ps, per_pod, starts, flavors, k, c
            )
            templates[key] = t
        out.n_groups[i] = t.n_groups
        if t.fallback:
            out.fallback.append(i)
            continue

        count = effective_podset_count(wl, ps)

        out.no_reclaim[i] = t.no_reclaim
        out.priority[i] = priority_of(wl, snapshot.priority_classes)
        ts = timestamp_fn(wl) if timestamp_fn else wl.creation_time
        out.timestamp[i] = int(ts * 1e9)
        # shared read-only maps (one list per template, not per head)
        out.candidate_flavors[i] = t.flavor_list
        out.candidate_tried[i] = t.tried_list
        # defer the array fills: heads sharing a template batch into ONE
        # numpy op per field instead of four small ops per head (the
        # per-head fills dominated bulk-drain lowering wall time)
        group = groups.get(key)
        if group is None:
            group = groups[key] = (t, [], [])
        group[1].append(i)
        group[2].append((per_pod, count))

    for t, idxs, pcs in groups.values():
        ii = np.asarray(idxs, dtype=np.intp)
        out.cq_row[ii] = t.cq_row
        out.cells[ii] = t.cells_arr
        out.valid[ii] = t.valid_row
        # request matrix: rows = heads in this group, cols = the
        # template's resource order (+1 zero column for padding cells)
        rmat = np.zeros((len(ii), len(t.res_names) + 1), dtype=np.int64)
        for x, r in enumerate(t.res_names):
            if r == PODS:
                rmat[:, x] = [count for (_, count) in pcs]
            else:
                rmat[:, x] = [pp.get(r, 0) * count for (pp, count) in pcs]
        out.qty[ii] = rmat[:, t.qty_sel]
    return out


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


class ResidentCycleState:
    """Device-resident quota tensors for the interactive cycle path.

    The tree changes rarely (quota/config edits) and usage changes touch
    a few ClusterQueue rows per cycle (admissions, evictions, finishes),
    so both stay RESIDENT on the device between cycles: per cycle the
    host compares the fresh snapshot against its copy of the device
    content and ships only the changed usage rows (``scatter_rows``, in
    place on the resident buffer), re-uploading everything only when
    the structure fingerprint (row order, cell universe, quota values,
    cohort edges) changes. The heads batch still ships per cycle: it IS
    the cycle's input.
    """

    def __init__(self, device=None):
        from kueue_tpu_torch._torch import resolve_device

        self.device = resolve_device(device)
        self._names = None
        self._parent = None
        self._quota_key = None  # (nominal, lending, borrowing) copies
        self._tree = None
        self._paths = None
        self._roots = None
        self._usage = None  # device [N, FR]
        self._usage_host = None  # numpy mirror of the device content
        # telemetry (debugging)
        self.full_uploads = 0
        self.delta_cycles = 0
        self.delta_rows = 0

    def _structure_matches(self, snapshot: Snapshot) -> bool:
        if self._names != tuple(snapshot.flat.cq_names):
            return False
        if self._usage_host is None or (
            self._usage_host.shape != snapshot.local_usage.shape
        ):
            return False
        if not np.array_equal(self._parent, snapshot.flat.parent):
            return False
        nom, lend, bor = self._quota_key
        return (
            np.array_equal(nom, snapshot.nominal)
            and np.array_equal(lend, snapshot.lending_limit)
            and np.array_equal(bor, snapshot.borrowing_limit)
        )

    def refresh(self, snapshot: Snapshot):
        """(tree, paths, roots, usage_dev) with minimal transfer."""
        from kueue_tpu_torch._torch import torch

        if not self._structure_matches(snapshot):
            self._tree, self._paths, self._roots = tree_arrays(snapshot, self.device)
            # torch.tensor copies: the buffer is updated in place later
            # and must not alias the snapshot's array
            self._usage = torch.tensor(snapshot.local_usage, device=self.device)
            self._usage_host = snapshot.local_usage.copy()
            self._names = tuple(snapshot.flat.cq_names)
            self._parent = np.array(snapshot.flat.parent, copy=True)
            self._quota_key = (
                snapshot.nominal.copy(),
                snapshot.lending_limit.copy(),
                snapshot.borrowing_limit.copy(),
            )
            self.full_uploads += 1
            return self._tree, self._paths, self._roots, self._usage

        new = snapshot.local_usage
        changed = (new != self._usage_host).any(axis=1)
        idx = np.flatnonzero(changed)
        if idx.size:
            if idx.size > max(16, new.shape[0] // 4):
                # bulk change: a fresh upload beats a huge scatter
                self._usage = torch.tensor(new, device=self.device)
            else:
                # the reference buckets the delta width (padding by
                # repeating the first changed row, idempotent under a
                # set) so its jit compiles once per bucket; the port
                # keeps the same padded launch
                n = _bucket(int(idx.size), minimum=4)
                idx_p = np.concatenate(
                    [idx, np.full(n - idx.size, idx[0], dtype=idx.dtype)]
                ).astype(np.int32)
                scatter_rows(
                    self._usage,
                    torch.as_tensor(idx_p, device=self.device),
                    torch.as_tensor(new[idx_p], device=self.device),
                )
            self._usage_host = new.copy()
            self.delta_rows += int(idx.size)
        self.delta_cycles += 1
        return self._tree, self._paths, self._roots, self._usage


def pack_heads(lowered: Lowered, roots, w_pad: int):
    """Pad a lowered head batch to ``w_pad`` rows and derive the
    segmented phase-2 schedule inputs. Shared by the cycle dispatch and
    the host mirror so the two cannot disagree on padding or segment
    compaction. Returns numpy (HeadsBatch, seg_id, n_segments,
    n_steps)."""
    from kueue_tpu_torch.ops.assign_kernel import HeadsBatch

    w = len(lowered.heads)
    cq_row, cells, qty = lowered.cq_row, lowered.cells, lowered.qty
    valid, priority = lowered.valid, lowered.priority
    timestamp, no_reclaim = lowered.timestamp, lowered.no_reclaim
    # score tensor always shipped (zeros = the default first-fit policy)
    score = lowered.score
    if score is None:
        score = np.zeros(valid.shape, dtype=np.int64)
    if w_pad > w:
        pad = w_pad - w
        cq_row = np.concatenate([cq_row, np.full(pad, -1, dtype=np.int32)])
        cells = np.concatenate(
            [cells, np.full((pad,) + cells.shape[1:], -1, dtype=np.int32)]
        )
        qty = np.concatenate([qty, np.zeros((pad,) + qty.shape[1:], dtype=np.int64)])
        valid = np.concatenate([valid, np.zeros((pad,) + valid.shape[1:], dtype=bool)])
        priority = np.concatenate([priority, np.zeros(pad, dtype=np.int64)])
        timestamp = np.concatenate([timestamp, np.zeros(pad, dtype=np.int64)])
        no_reclaim = np.concatenate([no_reclaim, np.zeros(pad, dtype=bool)])
        score = np.concatenate(
            [score, np.zeros((pad,) + score.shape[1:], dtype=np.int64)]
        )
    batch_np = HeadsBatch(
        cq_row=cq_row, cells=cells, qty=qty, valid=valid,
        priority=priority, timestamp=timestamp, no_reclaim=no_reclaim,
        score=score,
    )
    # compact segment ids: one per LIVE root cohort; the max head count
    # within one root bounds phase-2's sequential depth
    seg_id = np.full(w_pad, -1, dtype=np.int32)
    live_mask = cq_row >= 0
    if live_mask.any():
        uniq, inv = np.unique(roots[cq_row[live_mask]], return_inverse=True)
        seg_id[live_mask] = inv.astype(np.int32)
        n_segments = _bucket(len(uniq), minimum=8)
        n_steps = _bucket(int(np.bincount(inv).max()), minimum=8)
    else:
        n_segments = n_steps = 8
    return batch_np, seg_id, n_segments, n_steps


def dispatch_lowered(
    snapshot: Snapshot,
    lowered: Lowered,
    pad_heads: bool = True,
    mesh=None,
    resident: Optional[ResidentCycleState] = None,
    device=None,
):
    """Ship an already-lowered batch to the segmented cycle solver.

    Padding rows (cq_row == -1) are inert in both solver phases, so the
    first ``len(lowered.heads)`` result entries map 1:1 onto the input
    heads. With ``resident`` the quota tree, paths and usage matrix stay
    on its device between cycles and the host ships only changed usage
    rows; without it they ship to ``device`` (the card unless the
    caller names the CPU).

    With ``mesh`` (a ``parallel`` Mesh over one device) W is padded to
    a multiple of its ``wl`` axis, ``resident`` is skipped, and the
    heads, tree and usage are placed through ``place_cycle_inputs``;
    the segmented solve (B2/B3) then runs as without it. A mesh over
    several distinct devices raises NotImplementedError (ROADMAP A11).

    Returns a HOST-side SolveResult (numpy arrays, usage omitted): all
    per-head outputs come back in one packed copy."""
    from kueue_tpu_torch._torch import resolve_device, torch
    from kueue_tpu_torch.ops.assign_kernel import HeadsBatch, SolveResult

    w = len(lowered.heads)
    w_pad = _bucket(w) if pad_heads else w
    if mesh is not None:
        from kueue_tpu_torch.parallel.sharded_solver import (
            mesh_device,
            pad_w_multiple,
            place_cycle_inputs,
        )

        # W divides the mesh's wl axis: power-of-two buckets already do
        # for power-of-two meshes, this covers the rest
        w_pad = pad_w_multiple(w_pad, mesh.shape["wl"])
        dev = mesh_device(mesh)
    else:
        dev = resident.device if resident is not None else resolve_device(device)
    try:
        if mesh is not None:
            tree, paths, roots = tree_arrays(snapshot, dev)
            batch_np, seg_id, n_segments, n_steps = pack_heads(lowered, roots, w_pad)
            tree, usage_in, batch, paths, seg_id = place_cycle_inputs(
                mesh, tree, snapshot.local_usage, batch_np, paths, seg_id
            )
        else:
            if resident is not None:
                tree, paths, roots, usage_in = resident.refresh(snapshot)
            else:
                tree, paths, roots = tree_arrays(snapshot, dev)
                usage_in = torch.tensor(snapshot.local_usage, device=dev)
            batch_np, seg_id, n_segments, n_steps = pack_heads(lowered, roots, w_pad)
            batch = HeadsBatch(*(torch.as_tensor(x, device=dev) for x in batch_np))
        packed = (
            solve_cycle_segmented_packed(
                tree, usage_in, batch, paths, seg_id, n_segments, n_steps
            )
            .cpu()
            .numpy()
        )  # ONE device->host copy for the whole cycle outcome
    except torch.AcceleratorError as exc:
        # a kernel's fault on the card surfaces at the next CUDA call
        # (the fetch, or the next cycle's upload): never contained
        raise KernelError(f"the cycle's kernels failed on {dev}: {exc}") from exc
    return SolveResult(
        chosen=packed[0].astype(np.int32),
        admitted=packed[1].astype(bool),
        borrows=packed[2].astype(bool),
        reserved=packed[3].astype(bool),
        usage=None,
        order=packed[4].astype(np.int32),
    )


def solve_heads(
    snapshot: Snapshot,
    heads: Sequence[Tuple[Workload, str]],
    flavors: Dict[str, ResourceFlavor],
    max_candidates: int = 8,
    max_cells: int = 16,
    timestamp_fn=None,
    pad_heads: bool = True,
    device=None,
):
    """One-call convenience: lower, dispatch, return (Lowered, SolveResult)."""
    lowered = lower_heads(
        snapshot, heads, flavors, max_candidates, max_cells, timestamp_fn
    )
    return lowered, dispatch_lowered(snapshot, lowered, pad_heads, device=device)


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
    # int64[W,P,K] admission-policy candidate scores (kueue_tpu_torch/policy:
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
