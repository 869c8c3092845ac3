"""Hold every kernel to its plain version, step by step.

- The drains: ``lockstep`` (the plain drain), ``lockstep_megaloop``
  (the K-round megaloop: the plain cycle and the round boundary) and
  ``lockstep_fair`` (the fair drain: its tournament in place of phase
  2) run a drain on the kernels and, before every kernel step, copy the
  state; the plain version of that step runs on the copy, and the two
  results must be equal in every field (int64, tolerance 0).
- The interactive cycle: inside ``cycle_kernels_through(check)``, every
  cycle dispatch of the port's Scheduler (core/solver.dispatch_lowered)
  and every resident row scatter run launch by launch through
  ``check(name, kernel, plain)``; ``Lockstep`` is the check that runs
  the plain version on the same inputs (copies of what the kernel
  writes in place) and compares.

On the card this checks each CUDA kernel at every cycle of a real run;
on the CPU both sides are the plain versions (a check of the harness).
chip_smoke.py and tests/test_torch_cuda.py use it.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import fields
from typing import Callable, Dict, List, Optional

from kueue_tpu_torch._torch import torch
from kueue_tpu_torch.core import solver
from kueue_tpu_torch.ops import _build
from kueue_tpu_torch.ops import assign_kernel as ak
from kueue_tpu_torch.ops import drain_kernel as dk
from kueue_tpu_torch.ops import megaloop_kernel as ml
from kueue_tpu_torch.ops import quota, resident


class LockstepMismatch(AssertionError):
    """A kernel step disagreed with its plain version."""


def _usage_kernel(ctx, s, b):
    quota.usage_tree(ctx.tree, ctx.guaranteed, s.local, out=b.usage, done=s.done)


def _usage_plain(ctx, s, b):
    if not s.done.item():
        b.usage.copy_(quota.usage_tree_plain(ctx.tree, ctx.guaranteed, s.local))


def _avail_kernel(ctx, s, b):
    quota.available_all(
        ctx.tree, ctx.subtree, ctx.guaranteed, b.usage, out=b.avail, done=s.done
    )


def _avail_plain(ctx, s, b):
    if not s.done.item():
        b.avail.copy_(
            quota.available_all_plain(ctx.tree, ctx.subtree, ctx.guaranteed, b.usage)
        )


# (kernel name, kernel step, plain step) of one drain cycle, in order;
# each acts in place on (ctx, state, buf)
STEPS = (
    ("quota_tree", _usage_kernel, _usage_plain),
    ("quota_tree", _avail_kernel, _avail_plain),
    ("drain_nominate", dk.drain_nominate, dk.drain_nominate_plain),
    ("drain_phase2", dk.drain_phase2, dk.drain_phase2_plain),
    ("drain_queue_motion", dk.drain_queue_motion, dk.drain_queue_motion_plain),
)
MEGALOOP_STEPS = STEPS + (
    ("megaloop_boundary", ml.megaloop_boundary, ml.megaloop_boundary_plain),
)
FAIR_STEPS = tuple(
    ("drain_fair_phase2", dk.drain_fair_phase2, dk.drain_fair_phase2_plain)
    if name == "drain_phase2" else step
    for step in STEPS
    for name in (step[0],)
)
DRAIN_KERNELS = _build.DRAIN_KERNELS
MEGALOOP_KERNELS = _build.MEGALOOP_KERNELS
FAIR_KERNELS = _build.FAIR_KERNELS


def max_abs_diff(a, b, skip=()) -> int:
    """Largest |a.f - b.f| over the tensor fields of two dataclasses."""
    err = 0
    for f in fields(a):
        if f.name in skip:
            continue
        x = getattr(a, f.name).to(torch.int64)
        y = getattr(b, f.name).to(torch.int64)
        if x.shape != y.shape:
            raise LockstepMismatch(f"{f.name}: shapes {tuple(x.shape)} vs {tuple(y.shape)}")
        if x.numel():
            err = max(err, int((x - y).abs().max().item()))
    return err


def _check_quota(tree, errs, label) -> None:
    sub_k, g_k = quota.subtree_quota(tree)
    sub_p, g_p = quota.subtree_quota_plain(tree)
    pot_k = quota.potential_available_all(tree, sub_k, g_k)
    pot_p = quota.potential_available_all_plain(tree, sub_p, g_p)
    e = max(
        int((sub_k - sub_p).abs().max()),
        int((g_k - g_p).abs().max()),
        int((pot_k - pot_p).abs().max()),
    )
    errs["quota_tree"] = max(errs.get("quota_tree", 0), e)
    if e:
        raise LockstepMismatch(f"{label}: quota_tree subtree/potential differ by {e}")


def run_lockstep(ctx, state, buf, steps, bound: int, errs: Dict[str, int],
                 label: str = "", plain_ms: Optional[Dict[str, List[float]]] = None,
                 stop_after: Optional[int] = None) -> int:
    """Cycles of ``steps`` until ``done`` (or ``stop_after`` cycles),
    each kernel step checked against its plain step on copies; returns
    the cycles run."""
    buf.usage.zero_()
    buf.avail.zero_()
    cycles = 0
    while not state.done.item() and cycles != stop_after:
        if cycles > bound:
            raise LockstepMismatch(f"{label}: the drain ran past its bound of {bound} cycles")
        for name, kern, plain in steps:
            ps, pb = state.clone(), buf.clone()
            kern(ctx, state, buf)
            if plain_ms is None:
                plain(ctx, ps, pb)
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                plain(ctx, ps, pb)
                torch.cuda.synchronize()
                plain_ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
            # buf.order is kernel 3's scratch; the plain version has none
            e = max(max_abs_diff(state, ps), max_abs_diff(buf, pb, skip=("order",)))
            errs[name] = max(errs.get(name, 0), e)
            if e:
                raise LockstepMismatch(
                    f"{label}: {name} differs from its plain version by {e} "
                    f"at cycle {cycles}"
                )
        cycles += 1
    return cycles


def lockstep(
    tree, local, queues, paths, n_segments, n_steps, max_cycles,
    errs: Dict[str, int], label: str = "",
    plain_ms: Optional[Dict[str, List[float]]] = None,
    fair: Optional[dk.FairInputs] = None,
    stop_after: Optional[int] = None,
):
    """The plain drain (the fair drain with ``fair``) on the kernels,
    checking every step against its plain version; ``errs`` collects
    the largest difference per kernel (0 on success). When ``plain_ms``
    is given, it collects each plain step's wall time in ms (host and
    card, synchronised on both sides). Returns (ctx, final state,
    cycles). Raises LockstepMismatch on the first difference."""
    _check_quota(tree, errs, label)
    ctx = dk.DrainContext.build(
        tree, queues, paths, n_segments, n_steps, max_cycles, fair=fair
    )
    state = dk.DrainState.initial(local, queues, max_cycles)
    buf = dk.CycleBuffers.empty(local, queues)
    steps = STEPS if fair is None else FAIR_STEPS
    cycles = run_lockstep(ctx, state, buf, steps, max_cycles, errs, label, plain_ms, stop_after)
    return ctx, state, cycles


def lockstep_megaloop(
    tree, local, queues, paths, cap_suffix, n_segments, n_steps, chunk_cycles,
    max_rounds, errs: Dict[str, int], label: str = "",
    plain_ms: Optional[Dict[str, List[float]]] = None,
    stop_after: Optional[int] = None,
):
    """``lockstep`` for the megaloop: the plain cycle's five launches
    and the round boundary at every cycle. Returns (ctx, final
    MegaloopState, cycles)."""
    _check_quota(tree, errs, label)
    bound = chunk_cycles * max_rounds
    ctx = dk.DrainContext.build(
        tree, queues, paths, n_segments, n_steps, bound,
        chunk_cycles=chunk_cycles, max_rounds=max_rounds,
    )
    state = ml.MegaloopState.initial_rounds(local, queues, cap_suffix, max_rounds)
    buf = dk.CycleBuffers.empty(local, queues)
    cycles = run_lockstep(
        ctx, state, buf, MEGALOOP_STEPS, bound, errs, label, plain_ms, stop_after
    )
    return ctx, state, cycles


# ---- the interactive cycle ----------------------------------------------

CYCLE_KERNELS = _build.CYCLE_KERNELS

# check(kernel name, kernel thunk, plain thunk) -> the kernel's result
Check = Callable[[str, Callable, Callable], object]


def cycle_solve(tree, local_usage, heads, paths, seg_id, n_segments, n_steps, check):
    """``solve_cycle_segmented_packed`` launch by launch (four quota_tree
    passes, cycle_phase1, cycle_phase2), each through ``check``."""
    sub, g = check(
        "quota_tree", lambda: quota.subtree_quota(tree), lambda: quota.subtree_quota_plain(tree)
    )
    usage = check(
        "quota_tree",
        lambda: quota.usage_tree(tree, g, local_usage),
        lambda: quota.usage_tree_plain(tree, g, local_usage),
    )
    avail = check(
        "quota_tree",
        lambda: quota.available_all(tree, sub, g, usage),
        lambda: quota.available_all_plain(tree, sub, g, usage),
    )
    pot = check(
        "quota_tree",
        lambda: quota.potential_available_all(tree, sub, g),
        lambda: quota.potential_available_all_plain(tree, sub, g),
    )
    chosen, borrows, pk = check(
        "cycle_phase1",
        lambda: ak.phase1_classify(tree, sub, g, local_usage, heads, avail, pot),
        lambda: ak.phase1_classify_plain(tree, sub, local_usage, avail, pot, heads),
    )
    seg_t, segments = ak._as_seg_id(seg_id, local_usage.device)
    usage_p = usage.clone()  # phase 2 updates the usage tree in place
    packed, _ = check(
        "cycle_phase2",
        lambda: (
            ak.cycle_phase2(
                tree, sub, g, usage, paths, heads, seg_t, segments,
                n_segments, n_steps, chosen, borrows, pk,
            ),
            usage,
        ),
        lambda: (
            ak.cycle_phase2_plain(
                tree, sub, g, usage_p, paths, heads, seg_t,
                n_segments, n_steps, chosen, borrows, pk,
            ),
            usage_p,
        ),
    )
    return packed


def scatter_step(usage, idx, rows, check) -> None:
    """``scatter_rows`` through ``check`` (the plain version on a copy
    of the buffer as the kernel found it)."""
    expect = usage.clone()

    def kern():
        resident.scatter_rows(usage, idx, rows)
        return usage

    def plain():
        resident.scatter_rows_plain(expect, idx, rows)
        return expect

    check("scatter_rows", kern, plain)


@contextlib.contextmanager
def cycle_kernels_through(check: Check):
    """While active, the cycle dispatch (``solver.dispatch_lowered``)
    and the resident scatter (``ResidentCycleState.refresh``) run launch
    by launch through ``check``."""
    saved = (solver.solve_cycle_segmented_packed, solver.scatter_rows)
    solver.solve_cycle_segmented_packed = (
        lambda tree, local, heads, paths, seg_id, n_segments, n_steps: cycle_solve(
            tree, local, heads, paths, seg_id, n_segments, n_steps, check
        )
    )
    solver.scatter_rows = lambda usage, idx, rows: scatter_step(usage, idx, rows, check)
    try:
        yield
    finally:
        solver.solve_cycle_segmented_packed, solver.scatter_rows = saved


def _tensors(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


class Lockstep:
    """The check that holds each kernel launch to its plain version on
    the same inputs: ``errs`` collects the largest difference per
    kernel, ``launches`` the launches checked, ``plain_ms`` (when given)
    each plain call's wall time in ms, synchronised on both sides. A
    difference raises LockstepMismatch and is kept in ``failures`` too,
    since the Scheduler contains an exception raised inside a cycle."""

    def __init__(self, errs: Dict[str, int], label: str = "",
                 plain_ms: Optional[Dict[str, List[float]]] = None):
        self.errs = errs
        self.label = label
        self.plain_ms = plain_ms
        self.launches: Dict[str, int] = {}
        self.failures: List[str] = []

    def __call__(self, name, kern, plain):
        out_k = kern()
        if self.plain_ms is None:
            out_p = plain()
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out_p = plain()
            torch.cuda.synchronize()
            self.plain_ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        err = 0
        for x, y in zip(_tensors(out_k), _tensors(out_p)):
            x, y = x.to(torch.int64), y.to(torch.int64)
            if x.shape != y.shape:
                err = max(err, 1 << 62)
            elif x.numel():
                err = max(err, int((x - y).abs().max().item()))
        self.errs[name] = max(self.errs.get(name, 0), err)
        self.launches[name] = self.launches.get(name, 0) + 1
        if err:
            msg = (f"{self.label}: {name} differs from its plain version by {err} "
                   f"at its launch {self.launches[name]}")
            self.failures.append(msg)
            raise LockstepMismatch(msg)
        return out_k
