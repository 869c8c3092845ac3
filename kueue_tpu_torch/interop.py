"""Carry solver inputs given as numpy arrays into this package.

``drain_inputs`` takes the arrays a plain drain consumes — the encoded
snapshot's fields and a plan's per-queue tensors, as plain dicts of
numpy arrays (whichever package produced them) — and returns this
package's ``QuotaTree``, ``DrainQueues``, leaf usage and ancestor paths
on a device; ``heads_batch`` does the same for the cycle solver's
``HeadsBatch``. The parity tests feed the same arrays to both packages
through it; nothing here imports the JAX package.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np

from kueue_tpu_torch._torch import resolve_device, torch
from kueue_tpu_torch.ops.assign_kernel import HeadsBatch, build_paths
from kueue_tpu_torch.ops.drain_kernel import DrainQueues
from kueue_tpu_torch.ops.quota import QuotaTree

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


def _on(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=dtype, copy=True), device=device)


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


def heads_batch(batch: Mapping[str, np.ndarray], device=None) -> HeadsBatch:
    """HeadsBatch from the cycle batch's fields (a missing or None
    ``score`` stays None, which the solver reads as all zeros)."""
    dev = resolve_device(device)
    return HeadsBatch(**{
        name: None if batch.get(name) is None else _on(batch[name], dtype, dev)
        for name, dtype in HEADS_DTYPES.items()
    })
