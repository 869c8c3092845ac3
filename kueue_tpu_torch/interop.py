"""Carry solver inputs given as numpy arrays into this package.

``drain_inputs`` takes the arrays a plain drain consumes — the encoded
snapshot's fields and a plan's per-queue tensors, as plain dicts of
numpy arrays (whichever package produced them) — and returns this
package's ``QuotaTree``, ``DrainQueues``, leaf usage and ancestor paths
on a device; ``fair_inputs`` adds the fair drain's ``FairInputs``,
``seg_victims`` the preempt drain's candidate pools (``SegVictims``);
``heads_batch`` does the same for the cycle solver's ``HeadsBatch``,
``preempt_problem`` for the batched victim search's
``PreemptProblem``, ``fair_problem`` for the fair victim search's
``FairProblem`` and ``fair_seg_panels`` for the fair-preempt drain's
``FairSegPanels``; ``tas_topology`` the dense TAS forest
(``TASTopology``: free capacity, TAS usage, segment ids) and
``tas_heads`` the TAS drain's per-queue lowering (``TASHeads``);
``plan_inputs`` the planner's scenario-batched solve (kernel B14) from
the arrays ``Planner.plan`` stacks; ``drs_inputs`` the fair-sharing
reductions' resource map, weights and request (kernel B1'). The parity tests feed the same
arrays to both packages through it; nothing here imports the JAX
package.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np

from kueue_tpu_torch._torch import resolve_device, to_device, torch
from kueue_tpu_torch.ops.assign_kernel import HeadsBatch, build_paths
from kueue_tpu_torch.ops.drain_kernel import (
    DrainQueues,
    FairInputs,
    FairSegPanels,
    SegVictims,
    TASHeads,
)
from kueue_tpu_torch.ops.fair_preempt_kernel import FairProblem
from kueue_tpu_torch.ops.preempt_kernel import PreemptProblem
from kueue_tpu_torch.ops.quota import QuotaTree
from kueue_tpu_torch.ops.tas_kernel import TASTopology

# DrainQueues field -> numpy dtype of the plan tensors
QUEUE_DTYPES = {
    "cq_rows": np.int32,
    "seg_id": np.int32,
    "qlen": np.int32,
    "cells": np.int32,
    "qty": np.int64,
    "valid": np.bool_,
    "gidx": np.int32,
    "glast": np.bool_,
    "cgrp": np.int8,
    "n_podsets": np.int32,
    "ffb": np.bool_,
    "ffp": np.bool_,
    "retry_cap": np.int32,
    "priority": np.int64,
    "timestamp": np.int64,
    "no_reclaim": np.bool_,
    "score": np.int64,
}


# HeadsBatch field -> numpy dtype
HEADS_DTYPES = {
    "cq_row": np.int32,
    "cells": np.int32,
    "qty": np.int64,
    "valid": np.bool_,
    "priority": np.int64,
    "timestamp": np.int64,
    "no_reclaim": np.bool_,
    "score": np.int64,
}


# SegVictims field -> numpy dtype
VICTIM_DTYPES = {
    "scells": np.int32, "sqty": np.int64, "sprio": np.int64, "sts": np.int64,
    "svalid0": np.bool_, "sowner": np.int32, "sowner_local": np.int32,
    "sslot_q": np.int32, "sslot_l": np.int32, "seg_nodes": np.int32,
    "lpaths": np.int32, "hlocal": np.int32, "perm": np.int32, "entry_slot": np.int32,
    "same_enabled": np.bool_, "same_prio_ok": np.bool_, "reclaim_enabled": np.bool_,
    "only_lower": np.bool_, "bwc": np.bool_, "bwc_thr1": np.int64,
}


# PreemptProblem field -> numpy dtype
PROBLEM_DTYPES = {
    "paths": np.int32, "usage0": np.int64, "leaf0": np.int64, "nominal": np.int64,
    "subtree_q": np.int64, "guaranteed": np.int64, "borrow_lim": np.int64,
    "hrow": np.int32, "need_qty": np.int64, "need_pre": np.bool_,
    "allow_borrow": np.bool_, "has_thr": np.bool_, "thr": np.int64, "crow": np.int32,
    "cqty": np.int64, "cvalid": np.bool_, "csame": np.bool_, "cprio": np.int64,
    "row_valid": np.bool_,
}


# FairProblem field -> numpy dtype
FAIR_PROBLEM_DTYPES = {
    "paths": np.int32, "usage0": np.int64, "subtree_q": np.int64, "guaranteed": np.int64,
    "borrow_lim": np.int64, "weight": np.int64, "parent_loc": np.int32,
    "depth_s": np.int32, "is_cq": np.bool_, "svalid": np.bool_, "anc_of_head": np.bool_,
    "hrow": np.int32, "need_qty": np.int64, "res_of": np.int32, "crow": np.int32,
    "cqty": np.int64, "cvalid": np.bool_, "row_valid": np.bool_,
}


# FairSegPanels field -> numpy dtype
FAIR_PANEL_DTYPES = {
    "seg_cells": np.int32, "parent_local": np.int32, "depth_local": np.int32,
    "is_cq_local": np.bool_, "node_valid": np.bool_, "weight_local": np.int64,
    "res_of_cell": np.int32, "svqty_cu": np.int64,
}


def _on(a, dtype, device) -> torch.Tensor:
    return to_device(a, device, dtype)


def quota_tree(enc: Mapping[str, np.ndarray], device=None) -> QuotaTree:
    """QuotaTree from ``parent``, ``level_mask``, ``nominal``,
    ``lending_limit`` and ``borrowing_limit``."""
    dev = resolve_device(device)
    return QuotaTree(
        parent=_on(enc["parent"], np.int32, dev),
        level_mask=_on(enc["level_mask"], np.bool_, dev),
        nominal=_on(enc["nominal"], np.int64, dev),
        lending_limit=_on(enc["lending_limit"], np.int64, dev),
        borrowing_limit=_on(enc["borrowing_limit"], np.int64, dev),
    )


def drain_queues(queues_np: Mapping[str, np.ndarray], device=None) -> DrainQueues:
    """DrainQueues from a plan's ``queues_np`` (a missing or None
    ``score`` stays None, which the drain reads as all zeros)."""
    dev = resolve_device(device)
    fields = {}
    for name, dtype in QUEUE_DTYPES.items():
        a = queues_np.get(name)
        fields[name] = None if a is None else _on(a, dtype, dev)
    return DrainQueues(**fields)


def drain_inputs(
    enc: Mapping[str, np.ndarray], queues_np: Mapping[str, np.ndarray], device=None
) -> Tuple[QuotaTree, DrainQueues, torch.Tensor, torch.Tensor]:
    """(QuotaTree, DrainQueues, local_usage int64[N,FR], paths
    int32[N,D+1]) on ``device`` from the encoded snapshot fields
    (``parent``, ``level_mask``, ``nominal``, ``lending_limit``,
    ``borrowing_limit``, ``local_usage``, ``max_depth``) and a plan's
    ``queues_np``."""
    dev = resolve_device(device)
    tree = quota_tree(enc, dev)
    queues = drain_queues(queues_np, dev)
    local = _on(enc["local_usage"], np.int64, dev)
    paths = _on(build_paths(np.asarray(enc["parent"]), int(enc["max_depth"])), np.int32, dev)
    return tree, queues, local, paths


def fair_inputs(fair: Mapping[str, object], device=None) -> FairInputs:
    """FairInputs from ``depth_of``, ``weight``, ``lendable``,
    ``res_of_fr`` (numpy arrays), ``n_res`` and ``prio_tie``."""
    dev = resolve_device(device)
    return FairInputs(
        depth_of=_on(fair["depth_of"], np.int32, dev),
        weight=_on(fair["weight"], np.int64, dev),
        lendable=_on(fair["lendable"], np.int64, dev),
        res_of_fr=_on(fair["res_of_fr"], np.int32, dev),
        n_res=int(fair["n_res"]),
        prio_tie=bool(fair["prio_tie"]),
    )


def heads_batch(batch: Mapping[str, np.ndarray], device=None) -> HeadsBatch:
    """HeadsBatch from the cycle batch's fields (a missing or None
    ``score`` stays None, which the solver reads as all zeros)."""
    dev = resolve_device(device)
    return HeadsBatch(**{
        name: None if batch.get(name) is None else _on(batch[name], dtype, dev)
        for name, dtype in HEADS_DTYPES.items()
    })


def seg_victims(victims_np: Mapping[str, np.ndarray], device=None) -> SegVictims:
    """SegVictims from a preempt drain's lowered pools (``victims_np``,
    the ``_lower_victim_pools`` arrays of either package)."""
    dev = resolve_device(device)
    return SegVictims(**{
        name: _on(victims_np[name], dtype, dev) for name, dtype in VICTIM_DTYPES.items()
    })


def preempt_problem(arrays: Mapping[str, np.ndarray], device=None) -> PreemptProblem:
    """PreemptProblem from ``lower_preemption``'s arrays (padded rows
    included) of either package."""
    dev = resolve_device(device)
    return PreemptProblem(**{
        name: _on(arrays[name], dtype, dev) for name, dtype in PROBLEM_DTYPES.items()
    })


def fair_problem(arrays: Mapping[str, np.ndarray], device=None) -> FairProblem:
    """FairProblem from ``lower_fair_preemption``'s arrays (padded rows
    included) of either package."""
    dev = resolve_device(device)
    return FairProblem(**{
        name: _on(arrays[name], dtype, dev) for name, dtype in FAIR_PROBLEM_DTYPES.items()
    })


def fair_seg_panels(panels: Mapping[str, np.ndarray], device=None) -> FairSegPanels:
    """FairSegPanels from a fair-preempt drain's lowered panels of
    either package."""
    dev = resolve_device(device)
    return FairSegPanels(**{
        name: _on(panels[name], dtype, dev) for name, dtype in FAIR_PANEL_DTYPES.items()
    })


# TASHeads field -> numpy dtype
TAS_HEAD_DTYPES = {
    "t_is": np.bool_, "t_req": np.int64, "t_count": np.int32, "t_level": np.int32,
    "t_mode": np.int32, "t_top": np.int32, "t_flavor": np.int32, "leaf_flavor": np.int32,
    "parent_map": np.int32, "t_bad": np.bool_,
}


def tas_topology(arrays: Mapping[str, object], device=None) -> TASTopology:
    """TASTopology from ``free`` int64[L, R], ``tas_usage`` int64[L, R],
    ``seg_ids`` int32[D, L] and ``n_domains`` (a TASFlavorSnapshot's
    dense view, or a TAS drain's merged forest, of either package)."""
    dev = resolve_device(device)
    return TASTopology(
        free=_on(arrays["free"], np.int64, dev),
        tas_usage=_on(arrays["tas_usage"], np.int64, dev),
        seg_ids=_on(arrays["seg_ids"], np.int32, dev),
        n_domains=tuple(int(n) for n in arrays["n_domains"]),
    )


def tas_heads(arrays: Mapping[str, np.ndarray], device=None) -> TASHeads:
    """TASHeads from a TAS drain's per-queue lowering (``theads_np`` of
    either package's run_drain_tas)."""
    dev = resolve_device(device)
    return TASHeads(**{
        name: _on(arrays[name], dtype, dev) for name, dtype in TAS_HEAD_DTYPES.items()
    })


# the planner's stacked arrays (kernel B14) -> numpy dtype
PLAN_DTYPES = {
    "parent": np.int32, "level_mask": np.bool_, "nominal_s": np.int64,
    "lending_s": np.int64, "borrowing_s": np.int64, "usage_s": np.int64,
    "priority_s": np.int64, "score_s": np.int64, "paths": np.int32,
}


def plan_inputs(arrays: Mapping[str, object], device=None) -> dict:
    """The keyword inputs of ``ops.plan_kernel.solve_scenarios`` (and
    its ``_packed`` and ``_plain`` forms, with ``n_segments`` and
    ``n_steps`` added) from the arrays the planner stacks: ``parent``,
    ``level_mask``, the five [S, ...] stacks (``nominal_s``,
    ``lending_s``, ``borrowing_s``, ``usage_s``, ``priority_s``),
    ``score_s``, ``heads`` (the padded heads batch: a mapping or a named
    tuple of either package, its ``priority`` and ``score`` unused),
    ``paths`` and ``seg_id``. Tensors go to ``device``; ``seg_id`` stays
    a host array (the segments' CSR is built from it on the host)."""
    dev = resolve_device(device)
    heads = arrays["heads"]
    if not isinstance(heads, Mapping):
        heads = heads._asdict()
    out = {name: _on(arrays[name], dtype, dev) for name, dtype in PLAN_DTYPES.items()}
    out["heads"] = heads_batch(
        {name: heads[name] for name in HEADS_DTYPES if name not in ("priority", "score")},
        dev,
    )
    out["seg_id"] = np.asarray(arrays["seg_id"], dtype=np.int32)
    return out


def drs_inputs(arrays: Mapping[str, np.ndarray], device=None) -> dict:
    """The fair-sharing reductions' extra inputs (ops/quota
    ``lendable_per_resource`` / ``dominant_resource_share``, kernel B1')
    from ``resource_index`` int[FR], ``weight_milli`` int[N] and
    ``wl_req`` int[N, FR]: int32, int64 and int64 tensors on
    ``device``."""
    dev = resolve_device(device)
    return {
        "resource_index": _on(arrays["resource_index"], np.int32, dev),
        "weight_milli": _on(arrays["weight_milli"], np.int64, dev),
        "wl_req": _on(arrays["wl_req"], np.int64, dev),
    }
