"""The mesh path on the card (chip_smoke.py phase 13, the card tests):
hooks that run the port's Scheduler with its cycle dispatch on a mesh
and record what the segmented solve (B3) was given, so the unsegmented
solve (B3') can be held to it on the same inputs.

- ``dispatch_through_mesh(mesh)``: while active, the cycle dispatch
  (``core/solver.dispatch_lowered``) runs with ``mesh=``;
- ``record_cycle_solves(store)``: while active, every segmented solve
  the dispatch makes appends its inputs and its outcome (the packed
  [5, W] rows and the usage tree) to ``store``.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List

import numpy as np

from kueue_tpu_torch.core import solver
from kueue_tpu_torch.ops import assign_kernel as ak


@dataclass
class CycleSolve:
    """One segmented cycle solve: its inputs and B3's outcome."""

    tree: object
    local: object  # leaf usage (a copy: the resident buffer moves on)
    heads: object
    paths: object
    seg_id: np.ndarray
    n_segments: int
    n_steps: int
    packed: object  # int64[5, W]
    usage: object  # int64[N, FR] the cycle's final usage tree


@contextlib.contextmanager
def dispatch_through_mesh(on):
    """While active, the Scheduler's cycle dispatch places its inputs on
    the mesh ``on`` (``dispatch_lowered(mesh=on)``; the resident buffer
    is skipped under a mesh)."""
    saved = solver.dispatch_lowered

    def dispatch(snapshot, lowered, pad_heads=True, mesh=None, resident=None, device=None):
        return saved(snapshot, lowered, pad_heads, mesh=on)

    solver.dispatch_lowered = dispatch
    try:
        yield
    finally:
        solver.dispatch_lowered = saved


@contextlib.contextmanager
def record_cycle_solves(store: List[CycleSolve]):
    """While active, each segmented cycle solve of the dispatch runs as
    before and appends its inputs and outcome to ``store``."""
    saved = solver.solve_cycle_segmented_packed

    def solve(tree, local, heads, paths, seg_id, n_segments, n_steps):
        local = local.clone()
        packed, usage = ak._solve(tree, local, heads, paths, seg_id, n_segments, n_steps)
        store.append(CycleSolve(tree, local, heads, paths, np.asarray(seg_id), n_segments,
                                n_steps, packed, usage))
        return packed

    solver.solve_cycle_segmented_packed = solve
    try:
        yield
    finally:
        solver.solve_cycle_segmented_packed = saved
