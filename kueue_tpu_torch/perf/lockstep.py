"""Hold every kernel to its plain version, step by step.

- The drains: ``lockstep`` (the plain drain; the fair drain with
  ``fair``: its tournament in place of phase 2), ``lockstep_megaloop``
  (the K-round megaloop: the plain cycle and the round boundary) and
  ``lockstep_preempt`` (the preempt drain: nomination with the reclaim
  oracle, the victim search, its phase 2 and motion),
  ``lockstep_fair_preempt`` (the fair-preempt drain: the same with the
  fair victim tournament and the fair admission tournament) and
  ``lockstep_tas`` (the TAS drain: the nomination placement and the
  global step scan in place of phase 2) run a
  drain on the kernels and, before every kernel step, copy the state;
  the plain version of that step runs on the copy, and the two results
  must be equal in every field (int64, tolerance 0).
- The interactive cycle: inside ``cycle_kernels_through(check)``, every
  cycle dispatch of the port's Scheduler (core/solver.dispatch_lowered)
  and every resident row scatter run launch by launch through
  ``check(name, kernel, plain)``, and inside
  ``preempt_search_through(check)`` every batched victim search
  (core/preempt_batch, kernel B8), inside ``fair_search_through(check)``
  every batched fair victim search (kernel B9); ``leaf_counts_step``
  puts TAS pod counting (kernel B12) through a check, ``plan_solve``
  the planner's scenario-batched solve (kernel B14, its three launches)
  and, inside ``plan_kernels_through(check)``, every ``Planner.plan``
  solve; ``Lockstep`` is the check that runs
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
from kueue_tpu_torch.ops import fair_preempt_kernel as fpk
from kueue_tpu_torch.ops import megaloop_kernel as ml
from kueue_tpu_torch.ops import plan_kernel as plk
from kueue_tpu_torch.ops import preempt_kernel as pk
from kueue_tpu_torch.ops import quota, resident


class LockstepMismatch(AssertionError):
    """A kernel step disagreed with its plain version."""


def _quota_kernel(ctx, s, b):
    quota.usage_and_available(ctx.tree, ctx.subtree, ctx.guaranteed, s.local, b.usage,
                              b.avail, done=s.done)


def _quota_plain(ctx, s, b):
    if not s.done.item():
        usage, avail = quota.usage_and_available_plain(
            ctx.tree, ctx.subtree, ctx.guaranteed, s.local)
        b.usage.copy_(usage)
        b.avail.copy_(avail)


# (kernel name, kernel step, plain step) of one drain cycle, in order;
# each acts in place on (ctx, state, buf)
STEPS = (
    ("quota_tree", _quota_kernel, _quota_plain),
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
PREEMPT_STEPS = STEPS[:2] + (
    ("drain_preempt_search", dk.drain_preempt_search, dk.drain_preempt_search_plain),
    ("drain_preempt_phase2", dk.drain_preempt_phase2, dk.drain_preempt_phase2_plain),
    ("drain_preempt_motion", dk.drain_preempt_motion, dk.drain_preempt_motion_plain),
)
FAIR_PREEMPT_STEPS = STEPS[:2] + (
    ("drain_fair_preempt_search", dk.drain_fair_preempt_search,
     dk.drain_fair_preempt_search_plain),
    ("drain_fair_preempt_phase2", dk.drain_fair_preempt_phase2,
     dk.drain_fair_preempt_phase2_plain),
    ("drain_preempt_motion", dk.drain_preempt_motion, dk.drain_preempt_motion_plain),
)
TAS_STEPS = STEPS[:2] + (
    ("drain_tas_place", dk.drain_tas_place, dk.drain_tas_place_plain),
    ("drain_tas_phase2", dk.drain_tas_phase2, dk.drain_tas_phase2_plain),
    STEPS[3],
)
DRAIN_KERNELS = _build.DRAIN_KERNELS
TAS_DRAIN_KERNELS = _build.TAS_DRAIN_KERNELS
MEGALOOP_KERNELS = _build.MEGALOOP_KERNELS
FAIR_KERNELS = _build.FAIR_KERNELS
PREEMPT_KERNELS = _build.PREEMPT_KERNELS
FAIR_PREEMPT_KERNELS = _build.FAIR_PREEMPT_KERNELS
PLAN_KERNELS = _build.PLAN_KERNELS


def _diff_max(a, b, skip=()):
    """Largest |a.f - b.f| over the tensor fields of two dataclasses, as
    a 0-d int64 tensor on their device: enqueued, not read."""
    diffs = []
    for f in fields(a):
        if f.name in skip:
            continue
        x = getattr(a, f.name).to(torch.int64)
        y = getattr(b, f.name).to(torch.int64)
        if x.shape != y.shape:
            raise LockstepMismatch(f"{f.name}: shapes {tuple(x.shape)} vs {tuple(y.shape)}")
        if x.numel():
            diffs.append((x - y).abs().max())
    return torch.stack(diffs).max()


def max_abs_diff(a, b, skip=()) -> int:
    """Largest |a.f - b.f| over the tensor fields of two dataclasses."""
    return int(_diff_max(a, b, skip).item())


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
        diffs = []
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
            # buf.order is kernel 3's scratch; the plain version has none.
            # The difference is taken in stream order, before the next
            # step writes the state in place, and read once a cycle.
            diffs.append(torch.maximum(_diff_max(state, ps),
                                       _diff_max(buf, pb, skip=("order",))))
        for (name, _, _), e in zip(steps, torch.stack(diffs).tolist()):
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
    """``lockstep`` for the megaloop: the plain cycle's four launches
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


def lockstep_preempt(
    tree, local, queues, victims, paths, n_segments, n_steps, max_cycles, search_width,
    errs: Dict[str, int], label: str = "",
    plain_ms: Optional[Dict[str, List[float]]] = None,
    stop_after: Optional[int] = None,
):
    """``lockstep`` for the preempt drain at one ``search_width``: every
    cycle's five launches, each against its plain version (which
    rebuilds the usage tree after removals as the JAX code does, where
    the phase-2 kernel bubbles). Returns (ctx, final PreemptState,
    cycles)."""
    _check_quota(tree, errs, label)
    ctx = dk.DrainContext.build(
        tree, queues, paths, n_segments, n_steps, max_cycles,
        preempt=dk.PreemptInputs(victims=victims, search_width=int(search_width)),
    )
    state = dk.PreemptState.initial_preempt(local, queues, max_cycles, victims)
    buf = dk.PreemptBuffers.empty_preempt(local, queues, victims)
    cycles = run_lockstep(
        ctx, state, buf, PREEMPT_STEPS, max_cycles, errs, label, plain_ms, stop_after
    )
    return ctx, state, cycles


def lockstep_fair_preempt(
    tree, local, queues, victims, panels, paths, fair, n_segments, n_steps, max_cycles,
    strategy1, has_second, errs: Dict[str, int], label: str = "",
    plain_ms: Optional[Dict[str, List[float]]] = None,
    stop_after: Optional[int] = None,
):
    """``lockstep`` for the fair-preempt drain: every cycle's five
    launches, each against its plain version (which rebuilds the usage
    tree for every fit check as the JAX code does, where the phase-2
    kernel bubbles the removals and puts them back). Returns (ctx, final
    FairPreemptState, cycles)."""
    _check_quota(tree, errs, label)
    ctx = dk.fair_preempt_context(
        tree, queues, victims, panels, paths, fair, n_segments, n_steps, max_cycles,
        strategy1, has_second,
    )
    state = dk.FairPreemptState.initial_fair(local, queues, max_cycles, victims, panels)
    buf = dk.PreemptBuffers.empty_preempt(local, queues, victims)
    cycles = run_lockstep(
        ctx, state, buf, FAIR_PREEMPT_STEPS, max_cycles, errs, label, plain_ms, stop_after
    )
    return ctx, state, cycles


def lockstep_tas(
    tree, local, queues, paths, topo_free, tas_usage0, seg_ids, theads, n_domains, n_steps,
    max_cycles, errs: Dict[str, int], label: str = "",
    plain_ms: Optional[Dict[str, List[float]]] = None,
    stop_after: Optional[int] = None,
):
    """``lockstep`` for the TAS drain: every cycle's five launches (the
    nomination placement and the global step scan in place of phase 2),
    each against its plain version. Returns (ctx, final TASState,
    cycles)."""
    _check_quota(tree, errs, label)
    ctx = dk.tas_context(tree, queues, paths, topo_free, seg_ids, theads, n_domains, n_steps,
                         max_cycles)
    state = dk.TASState.initial_tas(local, queues, max_cycles, tas_usage0)
    buf = dk.TASBuffers.empty_tas(local, queues, topo_free.shape[0])
    cycles = run_lockstep(
        ctx, state, buf, TAS_STEPS, max_cycles, errs, label, plain_ms, stop_after
    )
    return ctx, state, cycles


# ---- TAS pod counting (kernel B12) -----------------------------------------


def leaf_counts_step(topo, req, assumed, taint_ok, simulate_empty, check: "Check"):
    """B12's two entries on one batch through ``check``: the leaf counts,
    then the per-level totals over the kernel's counts."""
    from kueue_tpu_torch.ops import tas_kernel as tk

    counts = check(
        "tas_leaf_counts",
        lambda: tk.leaf_counts(topo, req, assumed, taint_ok, simulate_empty),
        lambda: tk.leaf_counts_plain(topo, req, assumed, taint_ok, simulate_empty),
    )
    levels = check(
        "tas_leaf_counts",
        lambda: tk.level_counts(topo, counts),
        lambda: tk.level_counts_plain(topo, counts),
    )
    return counts, levels


# ---- the interactive cycle ----------------------------------------------

CYCLE_KERNELS = _build.CYCLE_KERNELS
PREEMPT_CYCLE_KERNELS = _build.PREEMPT_CYCLE_KERNELS
FAIR_CYCLE_KERNELS = _build.FAIR_CYCLE_KERNELS

# check(kernel name, kernel thunk, plain thunk) -> the kernel's result
Check = Callable[[str, Callable, Callable], object]


def cycle_solve(tree, local_usage, heads, paths, seg_id, n_segments, n_steps, check):
    """``solve_cycle_segmented_packed`` launch by launch (one quota_tree
    launch for its four recurrences, cycle_phase1, cycle_phase2), each
    through ``check``."""
    sub, g, usage, avail, pot = check(
        "quota_tree",
        lambda: quota.quota_all(tree, local_usage),
        lambda: quota.quota_all_plain(tree, local_usage),
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


def plan_solve(parent, level_mask, nominal_s, lending_s, borrowing_s, usage_s, priority_s,
               score_s, heads, paths, seg_id, n_segments, n_steps, check):
    """``ops.plan_kernel.solve_scenarios_packed`` launch by launch
    (plan_quota_tree, plan_phase1, plan_phase2), each through
    ``check``; the inputs as ``interop.plan_inputs`` gives them.
    Returns the packed buffer."""
    s, n, fr = nominal_s.shape
    w = heads.cq_row.shape[0]
    buf = torch.empty(s * plk.PER_HEAD_ROWS * w + s * n * fr, dtype=torch.int64,
                      device=nominal_s.device)
    per_head, usage = plk.unpack(buf, s, w, n, fr)
    tree_args = (parent, level_mask, nominal_s, lending_s, borrowing_s, usage_s)
    sub, g, usage, avail, pot = check(
        "plan_quota_tree",
        lambda: plk.plan_quota_tree(*tree_args, usage_out=usage),
        lambda: plk.plan_quota_tree_plain(*tree_args),
    )
    p1_args = (parent, nominal_s, sub, usage_s, avail, pot, heads, score_s)
    chosen, borrows, pre = check(
        "plan_phase1", lambda: plk.plan_phase1(*p1_args), lambda: plk.plan_phase1_plain(*p1_args)
    )
    seg_t, segments = plk._seg(seg_id, usage.device)
    usage_p = usage.clone()  # phase 2 updates the usage trees in place
    check(
        "plan_phase2",
        lambda: (
            plk.plan_phase2(
                nominal_s, borrowing_s, sub, g, usage, paths, heads, priority_s, seg_t,
                segments, n_segments, n_steps, chosen, borrows, pre, out=per_head,
            ),
            usage,
        ),
        lambda: (
            plk.plan_phase2_plain(
                nominal_s, borrowing_s, sub, g, usage_p, paths, heads, priority_s, seg_t,
                n_segments, n_steps, chosen, borrows, pre,
            ),
            usage_p,
        ),
    )
    return buf


@contextlib.contextmanager
def plan_kernels_through(check: Check):
    """While active, every planner solve (``Planner.plan``'s call of
    ``ops.plan_kernel.solve_scenarios_packed``) runs launch by launch
    through ``check``."""
    saved = plk.solve_scenarios_packed
    plk.solve_scenarios_packed = lambda *a, **kw: plan_solve(*a, **kw, check=check)
    try:
        yield
    finally:
        plk.solve_scenarios_packed = saved


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


@contextlib.contextmanager
def preempt_search_through(check: Check):
    """While active, the cycle's batched victim search (kernel B8,
    ``ops.preempt_kernel.solve_preempt_packed`` as core/preempt_batch
    calls it) runs through ``check`` against the plain ``solve_preempt``
    on the same problem."""
    saved = pk.solve_preempt_packed

    def search(p, depth, n_cand):
        return check(
            "preempt_search",
            lambda: saved(p, depth, n_cand),
            lambda: pk._pack(pk.solve_preempt(p, depth, n_cand)),
        )

    pk.solve_preempt_packed = search
    try:
        yield
    finally:
        pk.solve_preempt_packed = saved


@contextlib.contextmanager
def fair_search_through(check: Check):
    """While active, the cycle's batched fair victim search (kernel B9,
    ``ops.fair_preempt_kernel.solve_fair_packed`` as core/preempt_batch
    calls it) runs through ``check`` against the plain ``solve_fair`` on
    the same problem."""
    saved = fpk.solve_fair_packed

    def search(p, depth, n_cand, n_local, n_res, strategy1, has_second):
        args = (p, depth, n_cand, n_local, n_res, strategy1, has_second)
        return check(
            "fair_search",
            lambda: saved(*args),
            lambda: fpk._pack(fpk.solve_fair(*args)),
        )

    fpk.solve_fair_packed = search
    try:
        yield
    finally:
        fpk.solve_fair_packed = saved


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
