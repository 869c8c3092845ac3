"""ShardedSolver — the admission cycle over a device mesh (port of
kueue_tpu/parallel/sharded_solver.py).

The reference scales by running ONE scheduler goroutine per cluster
(pkg/scheduler/scheduler.go:143-154). The JAX package's scale axis is a
``jax.sharding.Mesh`` over which one cycle's tensors shard:

  - ``wl`` (data axis): heads are sharded — phase-1 flavor
    classification is embarrassingly parallel over heads, so each
    device classifies its shard against the quota tensors.
  - ``fr`` (tensor axis, 2-D meshes): the [N, FR] quota tensors shard
    over flavor-resource cells for very wide clusters.

Phase 2 (the scan over the admission order) is sequential by
construction: it runs on the gathered phase-1 output.

The port keeps that layout with its own small ``Mesh`` (axis names, a
``shape`` dict and a ``devices`` array of ``torch.device``).
``ShardedSolver`` pads the heads to a multiple of ``wl``, computes the
quota recurrences once (kernel 1, ``quota_tree``), runs phase 1
(``cycle_phase1``) once per ``wl`` shard on that shard's device, gathers
chosen, borrows and preempt_k onto the mesh's first device and runs the
unsegmented phase 2 there (kernel B3', ``cycle_global``). An ``fr`` axis
is recorded; the quota tensors stay whole, as there is one device to
hold them.

A mesh whose devices are all one device is accepted at any ``wl`` size:
on ``cuda`` that is one card, on ``cpu`` the virtual mesh of the tests
(``make_mesh(n, device="cpu")``, the counterpart of
``--xla_force_host_platform_device_count``). A mesh over more than one
distinct device raises NotImplementedError before any device is
touched: splitting the cycle and the drain loop over cards needs a
collective every cycle, and waits for a machine with more than one GPU
(ROADMAP A11).

The ``place_*`` entries put each production entry's inputs (numpy
arrays or tensors) on the mesh's device; the ``pad_*`` helpers pad the
Q axis (or W) to a multiple of ``wl`` with inert rows, exactly as the
JAX package does, so the decisions do not change with the mesh.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np

from kueue_tpu_torch._torch import I64, resolve_device, to_device, torch
from kueue_tpu_torch.ops.assign_kernel import HeadsBatch, SolveResult
from kueue_tpu_torch.ops.quota import QuotaTree

class Mesh:
    """A device mesh: ``devices`` (an object array of ``torch.device``,
    one axis per name) and ``axis_names``; ``shape`` maps each axis to
    its size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices, axis_names: Tuple[str, ...]):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(src.shape):
            arr[idx] = torch.device(src[idx])
        if arr.ndim != len(axis_names):
            raise ValueError(f"devices of shape {arr.shape} for axes {axis_names}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def distinct_devices(self) -> Tuple[torch.device, ...]:
        seen = []
        for d in self.devices.flat:
            if d not in seen:
                seen.append(d)
        return tuple(seen)

    def shard_devices(self) -> Tuple[torch.device, ...]:
        """The device of each ``wl`` shard (the first along ``fr``)."""
        flat = self.devices.reshape(self.shape["wl"], -1)
        return tuple(flat[i, 0] for i in range(flat.shape[0]))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {list(self.distinct_devices())})"


def mesh_device(mesh: Mesh) -> torch.device:
    """The one device a mesh runs on; NotImplementedError for a mesh
    over several distinct devices, checked before any device is
    touched. A ``cuda`` mesh needs the card (``resolve_device``)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a kueue_tpu_torch.parallel Mesh, got {type(mesh)}")
    distinct = mesh.distinct_devices()
    if len(distinct) != 1:
        raise NotImplementedError(
            "a mesh over more than one distinct device is not supported yet "
            "(ROADMAP A11): splitting the cycle and the drains over GPUs needs a "
            "collective every cycle and a machine with more than one GPU to test "
            f"it; this mesh spans {[str(d) for d in distinct]}"
        )
    return resolve_device(distinct[0])


def make_mesh(
    n_devices: Optional[int] = None, fr_parallel: bool = False, device=None
) -> Mesh:
    """A 1-D ``(wl,)`` or 2-D ``(wl, fr)`` mesh over the first
    ``n_devices`` devices. On ``cuda`` (the default) the devices are the
    first n of ``torch.cuda.device_count()`` cards, sliced as the JAX
    package slices ``jax.devices()``; on ``cpu`` they are n virtual CPU
    devices (default 1). The 2-D layout applies only when n >= 4 and n
    is even."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    else:
        devices = [torch.device("cpu")] * (1 if n_devices is None else int(n_devices))
    n = len(devices)
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    if fr_parallel and n >= 4 and n % 2 == 0:
        return Mesh(arr.reshape(n // 2, 2), ("wl", "fr"))
    return Mesh(arr, ("wl",))


# ---- layout descriptors -----------------------------------------------


def _fr_spec(mesh: Mesh, fr_size: int) -> tuple:
    """[_, FR] layout: fr-sharded only when the mesh has an fr axis AND
    the cell count divides it; replicated otherwise."""
    if "fr" in mesh.axis_names and fr_size % mesh.shape["fr"] == 0:
        return (None, "fr")
    return (None, None)


def build_tree_spec(mesh: Mesh, fr_size: int) -> QuotaTree:
    """The quota tree's layout: one partition spec (a tuple of axis
    names or None, one per tensor axis) per field."""
    fr = _fr_spec(mesh, fr_size)
    return QuotaTree(
        parent=(None,), level_mask=(None, None), nominal=fr, lending_limit=fr,
        borrowing_limit=fr,
    )


def build_heads_spec(mesh: Mesh) -> HeadsBatch:
    """The heads batch's layout: every field sharded along ``wl``."""
    return HeadsBatch(
        cq_row=("wl",), cells=("wl", None, None), qty=("wl", None, None),
        valid=("wl", None), priority=("wl",), timestamp=("wl",), no_reclaim=("wl",),
        score=("wl", None),
    )


# ---- placement ----------------------------------------------------------


def _put(x, dev, dtype=None) -> torch.Tensor:
    """``x`` (a numpy array or a tensor) on ``dev``; a tensor already
    there is returned as it is."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, non_blocking=True)
    return to_device(x, dev, dtype)


def _put_tree(tree: QuotaTree, dev) -> QuotaTree:
    return QuotaTree(
        parent=_put(tree.parent, dev, np.int32),
        level_mask=_put(tree.level_mask, dev, np.bool_),
        nominal=_put(tree.nominal, dev, np.int64),
        lending_limit=_put(tree.lending_limit, dev, np.int64),
        borrowing_limit=_put(tree.borrowing_limit, dev, np.int64),
    )


def _fields(x) -> dict:
    """A dict of the fields of ``x`` (a mapping or a named tuple)."""
    return dict(x) if isinstance(x, Mapping) else x._asdict()


def _put_heads(heads, dev) -> HeadsBatch:
    from kueue_tpu_torch.interop import HEADS_DTYPES

    f = _fields(heads)
    return HeadsBatch(**{
        name: None if f.get(name) is None else _put(f[name], dev, dtype)
        for name, dtype in HEADS_DTYPES.items()
    })


class ShardedSolver:
    """Places solver inputs on the mesh and runs the unsegmented cycle:
    phase 1 per ``wl`` shard, phase 2 (B3') on the gathered output."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.device = mesh_device(mesh)

    @property
    def wl_axis_size(self) -> int:
        return self.mesh.shape["wl"]

    def place(self, tree: QuotaTree, local_usage, heads: HeadsBatch, paths):
        """Every input on the mesh's device (score None -> zeros)."""
        dev = self.device
        heads = _put_heads(heads, dev)
        if heads.score is None:
            heads = heads._replace(score=torch.zeros(heads.valid.shape, dtype=I64, device=dev))
        return (
            _put_tree(tree, dev),
            _put(local_usage, dev, np.int64),
            heads,
            _put(paths, dev, np.int32),
        )

    def pad_heads(self, heads: HeadsBatch) -> HeadsBatch:
        """Pad W up to a multiple of the wl axis (padding rows have
        cq_row == -1 and cells == -1 and are never admitted; score None
        becomes zeros)."""
        w = heads.cq_row.shape[0]
        step = self.wl_axis_size
        target = pad_w_multiple(w, step)
        if target == w:
            return heads
        pad = target - w

        def pad_with(x, value):
            block = torch.full((pad,) + tuple(x.shape[1:]), value, dtype=x.dtype, device=x.device)
            return torch.cat([x, block])

        score = heads.score
        if score is None:
            score = torch.zeros(heads.valid.shape, dtype=I64, device=heads.valid.device)
        return HeadsBatch(
            cq_row=pad_with(heads.cq_row, -1),
            cells=pad_with(heads.cells, -1),
            qty=pad_with(heads.qty, 0),
            valid=pad_with(heads.valid, False),
            priority=pad_with(heads.priority, 0),
            timestamp=pad_with(heads.timestamp, 0),
            no_reclaim=pad_with(heads.no_reclaim, False),
            score=pad_with(score, 0),
        )

    def phase1(self, tree, local_usage, heads, subtree, guaranteed, avail, potential):
        """Phase 1 (kernel B2) once per ``wl`` shard on its device, all
        against the one cycle-start ``avail`` / ``potential``; the
        outputs gathered, in head order, on the mesh's first device."""
        from kueue_tpu_torch.ops.assign_kernel import phase1_classify

        w = heads.cq_row.shape[0]
        n_shards = self.wl_axis_size
        rows = w // n_shards
        parts = []
        for i, dev in enumerate(self.mesh.shard_devices()):
            sl = slice(i * rows, (i + 1) * rows)
            shard = HeadsBatch(*(None if x is None else x[sl].to(dev) for x in heads))
            on = (lambda t, dev=dev: t.to(dev))  # noqa: E731
            parts.append(phase1_classify(
                _put_tree(tree, dev), on(subtree), on(guaranteed), on(local_usage), shard,
                on(avail), on(potential),
            ))
        first = self.device
        return tuple(torch.cat([p[j].to(first) for p in parts]) for j in range(3))

    def __call__(self, tree: QuotaTree, local_usage, heads: HeadsBatch, paths) -> SolveResult:
        from kueue_tpu_torch.ops.assign_kernel import _unpack, cycle_global
        from kueue_tpu_torch.ops.quota import (
            available_all,
            potential_available_all,
            subtree_quota,
            usage_tree,
        )

        tree_d, usage_d, heads_d, paths_d = self.place(tree, local_usage, heads, paths)
        heads_d = self.pad_heads(heads_d)
        # the quota recurrences once, before the split
        subtree, guaranteed = subtree_quota(tree_d)
        usage = usage_tree(tree_d, guaranteed, usage_d)
        avail = available_all(tree_d, subtree, guaranteed, usage)
        potential = potential_available_all(tree_d, subtree, guaranteed)
        chosen, borrows_wk, preempt_k = self.phase1(
            tree_d, usage_d, heads_d, subtree, guaranteed, avail, potential
        )
        packed = cycle_global(
            tree_d, subtree, guaranteed, usage, paths_d, heads_d, chosen, borrows_wk,
            preempt_k,
        )
        return _unpack(packed, usage)


# ---- production-entry placement (the segmented cycle + the drains) ----


def pad_w_multiple(w: int, multiple: int) -> int:
    """Head-count target divisible by the mesh's wl axis."""
    return ((w + multiple - 1) // multiple) * multiple


def place_cycle_inputs(mesh: Mesh, tree: QuotaTree, local_usage, heads, paths, seg_id):
    """The segmented-cycle inputs (core/solver.dispatch_lowered) on the
    mesh: heads sharded along ``wl``, the quota tensors whole. Inputs
    may be numpy arrays or tensors; ``seg_id`` stays a host array (the
    segments' CSR is built from it on the host). The caller pads W to a
    multiple of the wl axis (pad_w_multiple)."""
    dev = mesh_device(mesh)
    return (
        _put_tree(tree, dev),
        _put(local_usage, dev, np.int64),
        _put_heads(heads, dev),
        _put(paths, dev, np.int32),
        np.asarray(seg_id, dtype=np.int32),
    )


def pad_queue_arrays(queues_np: dict, multiple: int) -> dict:
    """Pad the drain's Q axis to a multiple of the mesh's wl axis with
    inert queues (qlen 0, cq_row/seg_id -1, cells/cgrp -1)."""
    q = queues_np["qlen"].shape[0]
    target = pad_w_multiple(q, multiple)
    if target == q:
        return queues_np
    pad = target - q
    out = {}
    for name, arr in queues_np.items():
        if arr is None:
            out[name] = None
            continue
        pad_block = np.zeros((pad,) + arr.shape[1:], dtype=arr.dtype)
        if name in ("cq_rows", "seg_id", "cells", "cgrp"):
            pad_block[:] = -1
        out[name] = np.concatenate([arr, pad_block])
    return out


def place_drain_inputs(mesh: Mesh, tree: QuotaTree, local_usage, queues, paths, victims=None):
    """The drain's inputs on the mesh: per-queue tensors (``queues``, a
    plan's padded ``queues_np`` or a DrainQueues) sharded along ``wl``,
    the quota tree and paths whole. Returns (tree, leaf usage,
    DrainQueues, paths[, SegVictims])."""
    from kueue_tpu_torch.interop import drain_queues, seg_victims

    dev = mesh_device(mesh)
    out = (
        _put_tree(tree, dev),
        _put(local_usage, dev, np.int64),
        drain_queues(_fields(queues), dev),
        _put(paths, dev, np.int32),
    )
    if victims is None:
        return out
    return out + (seg_victims(_fields(victims), dev),)


def pad_victim_arrays(victims_np: dict, q_target: int) -> dict:
    """Pad SegVictims' per-queue arrays to the mesh-padded Q with inert
    queues (identity perm, no entries, all policies off)."""
    from kueue_tpu_torch.ops.drain_kernel import NO_BWC_THRESHOLD, SEG_VICTIM_Q_FIELDS

    q = victims_np["hlocal"].shape[0]
    if q_target == q:
        return victims_np
    pad = q_target - q
    out = dict(victims_np)
    for name in SEG_VICTIM_Q_FIELDS:
        arr = victims_np[name]
        if name == "perm":
            block = np.tile(np.arange(arr.shape[1], dtype=arr.dtype), (pad, 1))
        elif name == "entry_slot":
            block = np.full((pad,) + arr.shape[1:], -1, dtype=arr.dtype)
        elif name == "bwc_thr1":
            block = np.full((pad,), NO_BWC_THRESHOLD, dtype=arr.dtype)
        else:
            block = np.zeros((pad,) + arr.shape[1:], dtype=arr.dtype)
        out[name] = np.concatenate([arr, block])
    return out


def place_preempt_drain_inputs(mesh: Mesh, tree, local_usage, queues, victims, paths):
    """The preemption drain's inputs on the mesh: per-queue tensors
    (queues and SegVictims' per-queue config) sharded along ``wl``; the
    quota tree, paths and the per-segment candidate pools whole (every
    shard's queues search the same pools). Returns (tree, leaf usage,
    DrainQueues, SegVictims, paths)."""
    tree_d, local_d, queues_d, paths_d, victims_d = place_drain_inputs(
        mesh, tree, local_usage, queues, paths, victims
    )
    return tree_d, local_d, queues_d, victims_d, paths_d


def place_fair_preempt_drain_inputs(mesh: Mesh, tree, local_usage, queues, victims, fairp, paths):
    """The fair-preemption drain's inputs on the mesh: the classic
    preempt placement plus the FairSegPanels whole (every panel tensor
    lives in segment space, and the tournament reduces over whole root
    cohorts). Returns (tree, leaf usage, DrainQueues, SegVictims,
    FairSegPanels, paths)."""
    from kueue_tpu_torch.interop import fair_seg_panels

    tree_d, local_d, queues_d, victims_d, paths_d = place_preempt_drain_inputs(
        mesh, tree, local_usage, queues, victims, paths
    )
    return (tree_d, local_d, queues_d, victims_d,
            fair_seg_panels(_fields(fairp), mesh_device(mesh)), paths_d)


# TASHeads fields indexed by queue (sharded along ``wl``); the merged
# domain forest (leaf_flavor / parent_map, and the topo_free /
# tas_usage0 / seg_ids companions) stays whole.
TAS_Q_FIELDS = (
    "t_is", "t_req", "t_count", "t_level", "t_mode", "t_top", "t_flavor", "t_bad",
)


def pad_tas_arrays(theads_np: dict, q_target: int) -> dict:
    """Pad TASHeads' per-queue arrays to the mesh-padded Q with inert
    rows (t_is False — the kernel never touches them; zero requests)."""
    q = theads_np["t_is"].shape[0]
    if q_target == q:
        return theads_np
    pad = q_target - q
    out = dict(theads_np)
    for name in TAS_Q_FIELDS:
        arr = theads_np[name]
        out[name] = np.concatenate([arr, np.zeros((pad,) + arr.shape[1:], dtype=arr.dtype)])
    return out


def place_tas_drain_inputs(
    mesh: Mesh, tree, local_usage, queues, paths, topo_free, tas_usage0, seg_ids, theads,
    n_domains,
):
    """The TAS drain's inputs on the mesh: per-queue tensors sharded
    along ``wl``, the merged domain forest whole. Returns (tree, leaf
    usage, DrainQueues, paths, TASTopology, TASHeads)."""
    from kueue_tpu_torch.interop import tas_heads, tas_topology

    dev = mesh_device(mesh)
    tree_d, local_d, queues_d, paths_d = place_drain_inputs(
        mesh, tree, local_usage, queues, paths
    )
    topo = tas_topology(
        dict(free=topo_free, tas_usage=tas_usage0, seg_ids=seg_ids, n_domains=n_domains), dev
    )
    return tree_d, local_d, queues_d, paths_d, topo, tas_heads(_fields(theads), dev)


def place_fair_drain_extras(mesh: Mesh, depth_of, weight, lendable, res_of_fr, n_res: int,
                            prio_tie: bool):
    """The fair drain's node-space extras on the mesh, whole (the
    tournament reduces over the whole cohort forest on every shard).
    Returns FairInputs."""
    from kueue_tpu_torch.interop import fair_inputs

    return fair_inputs(
        dict(depth_of=depth_of, weight=weight, lendable=lendable, res_of_fr=res_of_fr,
             n_res=n_res, prio_tie=prio_tie),
        mesh_device(mesh),
    )


def place_fair_problem(mesh: Mesh, problem):
    """A FairProblem (its padded row arrays) on the mesh, every head row
    sharded along ``wl`` — the fair tournament search is embarrassingly
    parallel over heads. The caller pads W to a multiple of wl."""
    from kueue_tpu_torch.interop import fair_problem

    arrays = _fields(problem)
    if arrays["row_valid"].shape[0] % mesh.shape["wl"]:
        raise ValueError("pad the fair problem's rows to a multiple of the wl axis first")
    return fair_problem(arrays, mesh_device(mesh))

