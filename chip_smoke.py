#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``kueue_tpu_torch``) on one card.

Run from the repository root: ``python3 chip_smoke.py``. It needs one
CUDA device and ``nvcc``; without them, or without the package beside
it, it exits non-zero and prints no result. It drives four paths: the
plain bulk drain (phases 2-3), the K-round megaloop (phase 4), the
fair-sharing drain (phase 5) and the interactive admission cycle
(phase 6).

1. Prints the card's name and power limit, builds the nine kernels from
   ``kueue_tpu_torch/csrc`` with nvcc (sm_90a, in parallel) and prints
   the build seconds and each kernel's registers and spills.
2. Holds each kernel to its plain PyTorch version on the card, bit-exact
   (int64, tolerance 0), in lockstep at EVERY cycle of two drains: the
   real 50k x 1k headline plan, and a small seeded case with three
   podsets, nonzero candidate scores, a depth-3 cohort forest,
   borrowing and lending limits and PendingFlavors queues that freeze
   as stuck. The plain steps of the headline lockstep are timed.
   Then the headline drain runs once more on the kernels alone with
   every launch timed on the device (a spin kernel holds the stream
   while the host enqueues the events and the launch), and each
   cycle's bytes bound is counted from that cycle's data.
3. Drives the plain drain through its entry point: headline cluster
   (seed 0) -> Cache -> take_snapshot -> run_drain(device="cuda"), with
   the launch counters reset just before; asserts 74 cycles, 15178
   admitted, 34822 parked, 0 fallback, not truncated, the decision
   digest the JAX package gives, and that every kernel launched. Prints
   the drain's wall time (median of 3 after a warm run), and the
   device time of the same drain's launches replayed as one CUDA graph.
4. The megaloop chain at the headline (perf/megaloop.py: 8 rounds of 8
   cycles a launch, relaunched over the last round's undecided backlog
   until a log is not truncated):
   a. lockstep: every launch of its six per-cycle launches (quota_tree
      twice, drain_nominate, drain_phase2, drain_queue_motion,
      megaloop_boundary) held to its plain version at every cycle of
      both launches of the chain, and of mixed_spec(7) at 56 cycles a
      round, where a round boundary retires stuck queues;
   b. the main path: the chained launch_drain_megaloop(device="cuda"),
      counters reset before; asserts MEGALOOP_EXPECT, the lockstep's
      rounds, and every kernel launched; prints each launch's rounds,
      host syncs and wall split into plan, enqueue and fetch;
   c. each round equal to the serial chain of launch_drain(max_cycles=8)
      on cuda (outcome signature, undecided, final usage), with that
      chain's wall beside the megaloop's;
   d. every launch of the chain timed alone on the device, with its
      bytes bound from its own cycle's data.
5. The fair-sharing drain at the headline: lockstep of its launches
   (drain_fair_phase2 in place of drain_phase2) at every cycle of the
   headline and of the depth-3 weighted perf.cases.fair_spec;
   run_drain(fair_sharing=True, device="cuda") gives FAIR_EXPECT with
   every kernel launched; its wall and solve time; every launch timed
   alone with its bytes bound.
6. The interactive cycle (``Scheduler.schedule``) over the headline
   cluster with the whole 50k backlog queued (1000 heads a cycle): the
   16 cycles of CYCLE_EXPECT, then on to cycle 40 (steady state: from
   cycle 24 on each cycle changes at most N/4 usage rows, so the
   resident buffer takes row deltas through scatter_rows):
   a. lockstep: every launch of the cycle's kernels (quota_tree,
      cycle_phase1, cycle_phase2, scatter_rows) held to its plain
      version at every one of the 40 headline cycles and of a small
      seeded cluster run to quiescence (perf.cases.cycle_spec:
      depth-3 cohorts, limits, reservations, host victim search),
      whose decisions must equal the same run on the CPU;
   b. the main path: the port's Scheduler on cuda under the strict
      guard (GuardConfig(mode="device", divergence_check_every=1): no
      failover, every cycle re-solved on the host mirror), launch
      counters reset before and read after each of the two runs;
      asserts the JAX package's CYCLE_EXPECT over the first 16 cycles,
      all 40 equal to the lockstep run, the small run equal to its
      lockstep run, every dispatch via the device, 0 failures,
      0 divergences, and every kernel launched by each run;
   c. timing: every cycle-kernel launch timed alone on the device with
      its bytes bound from its own inputs (quota_tree and the two
      phases over the first 16 cycles, scatter_rows over the steady
      ones, index_copy_ on each scatter's inputs beside it), and the
      16 cycles' wall per cycle split into snapshot, lowering,
      dispatch (solve and the one fetch), the rest of nomination and
      the host apply.
7. Prints the nine kernels' JSON line, the card line, and as the last
   line ``{"ok": true, "device": {...}}``.

No phase is caught and passed over: any failure exits non-zero.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from dataclasses import fields

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
SPIN_CYCLES = 2_000_000  # about 1 ms of the card's clock, per timed launch
SMALL_SEED = 7  # mixed_spec seed whose drain freezes PendingFlavors queues
FAIR_SEED = 4  # fair_spec seed: depth 3, weights 0-2000, 133 cycles
SMALL_CYCLE_SEED = 0  # cycle_spec seed: reservations, preemption, scatters
SMALL_CYCLES = 24  # its preempting heads re-nominate until then (no evictions)
STEADY_CYCLES = 40  # the headline run goes on to here: from cycle 24 on, each
# cycle changes at most N/4 usage rows, so the resident buffer takes row deltas

SOURCES = {
    "quota_tree": "kueue_tpu_torch/csrc/quota_tree.cu",
    "drain_nominate": "kueue_tpu_torch/csrc/drain_nominate.cu",
    "drain_phase2": "kueue_tpu_torch/csrc/drain_phase2.cu",
    "drain_queue_motion": "kueue_tpu_torch/csrc/drain_queue_motion.cu",
    "cycle_phase1": "kueue_tpu_torch/csrc/cycle_phase1.cu",
    "cycle_phase2": "kueue_tpu_torch/csrc/cycle_phase2.cu",
    "scatter_rows": "kueue_tpu_torch/csrc/scatter_rows.cu",
    "megaloop_boundary": "kueue_tpu_torch/csrc/megaloop_boundary.cu",
    "drain_fair_phase2": "kueue_tpu_torch/csrc/drain_fair_phase2.cu",
}
REPLACES = {
    "quota_tree": "kueue_tpu/ops/quota.py:93",
    "drain_nominate": "kueue_tpu/ops/drain_kernel.py:230",
    "drain_phase2": "kueue_tpu/ops/drain_kernel.py:451",
    "drain_queue_motion": "kueue_tpu/ops/drain_kernel.py:396",
    "cycle_phase1": "kueue_tpu/ops/assign_kernel.py:199",
    "cycle_phase2": "kueue_tpu/ops/assign_kernel.py:475",
    "scatter_rows": "kueue_tpu/core/solver.py:504",
    "megaloop_boundary": "kueue_tpu/ops/megaloop_kernel.py:82",
    "drain_fair_phase2": "kueue_tpu/ops/drain_kernel.py:1297",
}


T0 = time.perf_counter()


def stamp() -> str:
    """Seconds since the script started, for the phase lines."""
    return f"[{time.perf_counter() - T0:.0f} s]"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


# ---- timing and bounds -------------------------------------------------


class BoundData:
    """Host copies of a drain's fixed inputs, for the bytes bounds."""

    def __init__(self, ctx):
        qs = ctx.queues
        self.q, self.l, self.p, self.k, self.c = qs.cells.shape
        self.g = qs.gidx.shape[-1]
        self.n, self.fr = ctx.tree.nominal.shape
        self.d1 = ctx.tree.max_depth + 1
        self.s = ctx.segments.count
        self.cells = qs.cells.cpu().numpy()
        self.qlen = qs.qlen.cpu().numpy()
        self.rows = qs.cq_rows.cpu().numpy()
        self.no_reclaim = qs.no_reclaim.cpu().numpy()
        self.paths = ctx.paths.cpu().numpy()


def _distinct(rows: np.ndarray, cells: np.ndarray, fr: int) -> int:
    """Number of distinct (row, cell) pairs, cells < 0 ignored."""
    keep = cells >= 0
    return int(np.unique(rows[keep].astype(np.int64) * fr + cells[keep]).size)


def cycle_bytes(bd: BoundData, cursor: np.ndarray, buf, alive=None) -> dict:
    """Bytes each kernel must move in one cycle (each input read once,
    each output written once), counted from the cycle's own data:
    ``cursor`` (and the megaloop's ``alive``) at the cycle's start and
    the buffers after it, which say who was nominated and admitted.
    quota_tree gets its two passes."""
    q, l, p, k, c, g, fr, d1 = bd.q, bd.l, bd.p, bd.k, bd.c, bd.g, bd.fr, bd.d1
    tree_links = 4 * bd.n + d1 * bd.n
    mat = bd.n * fr * 8
    # usage_tree: local, guaranteed in, usage out; available_all:
    # subtree, guaranteed, borrowing_limit, usage in, avail out
    quota = [3 * mat + tree_links, 5 * mat + tree_links]

    active = cursor < bd.qlen
    if alive is not None:
        active &= alive
    n_act = int(active.sum())
    cur = np.minimum(cursor, l - 1)
    head_cells = bd.cells[np.arange(q), cur]  # [Q,P,K,C]
    act = np.nonzero(active)[0]
    entry = p * k * c * (4 + 8 + 1) + p * k * (1 + 8) + p * k * g * (4 + 1)
    per_head_io = 4 * 5 + 2 + 4 * p * g  # queue scalars, flags, cursors
    outs = 5 + 4 * p + 4 * p * g + 12 * p * c
    # avail, nominal, local, potential, subtree of each distinct
    # (cq row, cell) pair the heads' candidates gather from
    pairs = _distinct(
        np.repeat(bd.rows[act], p * k * c), head_cells[act].reshape(-1), fr
    )
    nominate = n_act * (entry + per_head_io) + q * (8 + outs) + pairs * 5 * 8

    is_fit = buf.is_fit.cpu().numpy()
    is_pre = buf.is_pre.cpu().numpy()
    nominated = is_fit | is_pre
    admitted = buf.admitted.cpu().numpy()
    ce = buf.cells_eff.cpu().numpy()
    qe = buf.qty_eff.cpu().numpy()
    ce = np.where(qe > 0, ce, -1)  # cells the walk touches
    nom = np.nonzero(nominated)[0]
    # subtree, guaranteed, borrowing_limit, usage read and usage written
    # once for each distinct (node, cell) pair on a nominated head's path
    path_nodes = bd.paths[bd.rows[nom]]  # [H, D+1]
    pc = ce.shape[1]
    node_rows = np.repeat(path_nodes, pc, axis=1)  # [H, (D+1)*PC]
    node_cells = np.tile(ce[nom], (1, d1))
    node_cells = np.where(node_rows >= 0, node_cells, -1)
    path_pairs = _distinct(node_rows.reshape(-1), node_cells.reshape(-1), fr)
    adm = np.nonzero(admitted)[0]
    adm_pairs = _distinct(np.repeat(bd.rows[adm], pc), ce[adm].reshape(-1), fr)
    reserve = np.nonzero(is_pre & bd.no_reclaim & ~admitted)[0]
    res_pairs = _distinct(np.repeat(bd.rows[reserve], pc), ce[reserve].reshape(-1), fr)
    # per nominated head: borrow, fit, pre, no_reclaim flags, cursor,
    # cq row, priority, timestamp, merged cells and quantities, path row
    per_head = 4 + 4 + 4 + 8 + 8 + 12 * pc + 4 * d1
    phase2 = (
        len(nom) * per_head
        + path_pairs * 5 * 8
        + adm_pairs * 2 * 8  # local read and written
        + res_pairs * 8  # nominal
        + q * (2 + 4 + 1)  # fit/pre flags while ranking, members, admitted out
        + 4 * (bd.s + 1)
    )
    motion = q * (8 + 4 + 3 + 8 + 4 + 2 + 8 * p * g + 4 * p * g) + len(adm) * (
        4 * p + 4 * p + 4
    )
    return {
        "quota_tree": quota,
        "drain_nominate": [nominate],
        "drain_phase2": [phase2],
        "drain_queue_motion": [motion],
    }


def timed_drain(ctx, local, queues):
    """The drain once more on the kernels alone, every launch timed on
    the device through ``TimedLaunches``, for all the cycles that do
    work, with each cycle's bytes (``cycle_bytes``). Returns (cycles,
    the timer)."""
    from kueue_tpu_torch.ops import drain_kernel as dk
    from kueue_tpu_torch.perf.lockstep import STEPS

    bd = BoundData(ctx)
    state = dk.DrainState.initial(local, queues, ctx.max_cycles)
    buf = dk.CycleBuffers.empty(local, queues)
    timer = TimedLaunches()
    cycles = 0
    while not state.done.item():
        cursor = state.cursor.cpu().numpy()
        for name, kern, _ in STEPS:
            timer(name, lambda: kern(ctx, state, buf), None)
        timer.add_bytes(cycle_bytes(bd, cursor, buf))
        cycles += 1
    return cycles, timer


def drain_graph_ms(ctx, local, queues, n_cycles, reps=3):
    """Device time of the whole drain with no host in it: ``n_cycles``
    cycles (as many as the main path enqueues; those past the end are
    no-ops) captured in one CUDA graph and replayed from the initial
    state between two events. Returns (median ms, admitted, cycles)."""
    import torch

    from kueue_tpu_torch.ops import drain_kernel as dk

    state0 = dk.DrainState.initial(local, queues, ctx.max_cycles)
    state = state0.clone()
    buf = dk.CycleBuffers.empty(local, queues)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n_cycles):
            dk.drain_cycle(ctx, state, buf)
    times = []
    for _ in range(reps):
        for f in fields(state):
            getattr(state, f.name).copy_(getattr(state0, f.name))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    admitted = int((state.adm_cycle >= 0).sum())
    return float(np.median(times)), admitted, int(state.cycle.item())


# ---- the interactive cycle ------------------------------------------------


def strict_guard(check_every: int = 1):
    """GuardConfig(mode="device", divergence_check_every=1): no
    failover, every device solve re-solved on the host mirror; with a
    log of the path each solve took. The timing runs pass 0 (no
    mirror)."""
    from kueue_tpu_torch.core.guard import GuardConfig, SolverGuard
    from kueue_tpu_torch.utils.clock import FakeClock

    guard = SolverGuard(
        clock=FakeClock(0.0),
        config=GuardConfig(mode="device", divergence_check_every=check_every),
    )
    guard.vias = []
    solve = guard.solve

    def logged(snapshot, lowered, dispatch):
        out = solve(snapshot, lowered, dispatch)
        guard.vias.append(out.via)
        return out

    guard.solve = logged
    return guard


def check_strict(guard, label: str) -> None:
    """Every dispatch went via the device, was checked against the
    host mirror, and nothing failed, diverged or was contained."""
    n = len(guard.vias)
    if n == 0 or guard.vias != ["device"] * n:
        fail(f"{label}: dispatch paths {guard.vias}")
    if guard.divergence_checks != n:
        fail(f"{label}: {guard.divergence_checks} divergence checks for {n} solves")
    bad = (guard.failovers, guard.breaker.consecutive_failures, guard.divergences,
           guard.contained_cycles)
    if any(bad):
        fail(f"{label}: failovers, breaker failures, divergences, contained cycles = {bad}")


def cycle_launch_bytes(tree, heads, paths, seg_id, phase1, packed) -> dict:
    """Bytes each launch of one cycle solve must move (each input read
    once, each output written once), from that cycle's own data; the
    gathers count distinct (row, cell) pairs."""
    n, fr = tree.nominal.shape
    d1 = paths.shape[1]
    mat, links = n * fr * 8, 4 * n + d1 * n
    quota = [4 * mat + links, 3 * mat + links, 5 * mat + links, 4 * mat + links]

    cq = heads.cq_row.cpu().numpy()
    cells = heads.cells.cpu().numpy()
    qty = heads.qty.cpu().numpy()
    valid = heads.valid.cpu().numpy()
    w, k, c = cells.shape
    live = cq >= 0  # pad rows carry no work beyond their cq_row and outputs
    n_live = int(live.sum())
    cand = valid & live[:, None]  # [W, K] the candidates a head has
    need = (cells >= 0) & (qty > 0) & cand[:, :, None]
    rows = np.broadcast_to(np.maximum(cq, 0)[:, None, None], cells.shape)
    pairs = _distinct(rows[need], cells[need], fr)
    # in: every row's cq_row; a live row's K valid flags; a candidate's
    # score and C cell indices, and the quantity of each real cell
    # (cells >= 0); avail, potential, subtree, local and nominal of each
    # distinct (row, cell) pair needed, a live row's parent; out:
    # chosen, borrows, preempt_k of every row
    phase1_b = (4 * w + k * n_live + int(cand.sum()) * (8 + 4 * c)
                + 8 * int((cells[cand] >= 0).sum()) + pairs * 5 * 8
                + 4 * len(np.unique(cq[live])) + w * (4 + k + 4))

    chosen, _, preempt_k = (t.cpu().numpy() for t in phase1)
    p = packed.cpu().numpy()
    eff = np.where(chosen >= 0, chosen, preempt_k)
    walked = np.nonzero(live & (eff >= 0))[0]
    ce_all = cells[walked, eff[walked]]
    qe = qty[walked, eff[walked]]
    ce = np.where(qe > 0, ce_all, -1)
    path_rows = paths.cpu().numpy()[cq[walked]]  # [H, D+1]
    node_rows = np.repeat(path_rows, c, axis=1)
    node_cells = np.where(node_rows >= 0, np.tile(ce, (1, d1)), -1)
    path_pairs = _distinct(node_rows.reshape(-1), node_cells.reshape(-1), fr)
    moved = (p[1, walked] > 0) | (p[3, walked] > 0)
    mrows = np.repeat(path_rows[moved], c, axis=1)
    mcells = np.where(mrows >= 0, np.tile(ce[moved], (1, d1)), -1)
    written = _distinct(mrows.reshape(-1), mcells.reshape(-1), fr)
    leaf = _distinct(np.repeat(cq[walked], c), ce.reshape(-1), fr)
    seg = np.asarray(seg_id)
    n_seg = int(seg.max()) + 1 if (seg >= 0).any() else 0
    # per live head: cq_row, priority, timestamp, chosen, preempt_k,
    # seg_id, the effective candidate's borrow bit, no_reclaim (a pad
    # row: its cq_row); the CSR; per walked head its C cell indices, the
    # quantity of each real cell and its path; subtree, guaranteed,
    # borrowing_limit, usage per path pair, nominal per leaf pair, usage
    # written per moved pair; the packed [5, W] out
    phase2_b = (34 * n_live + 4 * (w - n_live) + 4 * (n_seg + 1)
                + 4 * int((seg >= 0).sum()) + len(walked) * (4 * c + 4 * d1)
                + 8 * int((ce_all >= 0).sum()) + path_pairs * 32 + leaf * 8
                + written * 8 + 40 * w)
    return {"quota_tree": quota, "cycle_phase1": [phase1_b], "cycle_phase2": [phase2_b]}


class TimedLaunches:
    """Times each kernel launch alone on the device (also the check of
    perf.lockstep's interface): before the launch a spin kernel
    (``torch.cuda._sleep``) holds the stream while the host enqueues the
    start event, the launch and the end event, so the events bracket
    the launch's device time and no host time. A launch whose start
    event had already run when the host finished enqueuing counts as
    uncovered, and the spin doubles (up to 16 times its start). Keeps
    the device and host ms per kernel, each launch's bytes, the last
    phase-1 outputs (for phase 2's bytes) and every scatter's inputs
    (for the library yardstick)."""

    def __init__(self):
        self.dev_ms, self.host_ms, self.nbytes = {}, {}, {}
        self.spin, self.uncovered = SPIN_CYCLES, 0
        self.phase1 = None
        self.scatter_args = []

    def __call__(self, name, kern, plain):
        import torch

        torch.cuda._sleep(self.spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        out = kern()
        host = time.perf_counter() - t0
        end.record()
        if start.query():
            self.uncovered += 1
            self.spin = min(2 * self.spin, 16 * SPIN_CYCLES)
        end.synchronize()
        self.dev_ms.setdefault(name, []).append(start.elapsed_time(end))
        self.host_ms.setdefault(name, []).append(host * 1e3)
        if name == "cycle_phase1":
            self.phase1 = out
        return out

    def add_bytes(self, per_kernel: dict) -> None:
        for name, b in per_kernel.items():
            self.nbytes.setdefault(name, []).extend(b)


@contextlib.contextmanager
def timed_cycle_kernels(timer: TimedLaunches):
    """The cycle dispatch and the resident scatter, launch by launch
    through ``timer``, with each launch's bytes."""
    from kueue_tpu_torch.core import solver
    from kueue_tpu_torch.perf import lockstep

    saved = (solver.solve_cycle_segmented_packed, solver.scatter_rows)

    def solve(tree, local, heads, paths, seg_id, n_segments, n_steps):
        packed = lockstep.cycle_solve(
            tree, local, heads, paths, seg_id, n_segments, n_steps, timer
        )
        timer.add_bytes(cycle_launch_bytes(tree, heads, paths, seg_id, timer.phase1, packed))
        return packed

    def scatter(usage, idx, rows):
        timer.scatter_args.append((usage.clone(), idx, rows))
        lockstep.scatter_step(usage, idx, rows, timer)
        # the delta's distinct rows: an index and a row read, a row
        # written (the padding repeats the first row and adds nothing)
        uniq = int(idx.unique().numel())
        timer.add_bytes({"scatter_rows": [4 * uniq + 16 * uniq * rows.shape[1]]})

    solver.solve_cycle_segmented_packed, solver.scatter_rows = solve, scatter
    try:
        yield
    finally:
        solver.solve_cycle_segmented_packed, solver.scatter_rows = saved


def timing_of(timer: TimedLaunches, name: str, plain_ms: dict) -> dict:
    """One kernel's numbers for the result lines: means over the timed
    launches, the bound from their bytes."""
    nbytes = float(np.mean(timer.nbytes[name]))
    return {
        "ms": float(np.mean(timer.dev_ms[name])),
        "device_ms_total": float(np.sum(timer.dev_ms[name])),
        "host_ms": float(np.mean(timer.host_ms[name])),
        "plain_ms": float(np.mean(plain_ms[name])),
        "bytes": nbytes,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "timed": len(timer.dev_ms[name]),
    }


def index_copy_ms(scatters) -> float:
    """ms per call of ``index_copy_``, the one PyTorch call computing
    scatter_rows' function, on each scatter's inputs, every call timed
    alone as the kernels are (the yardstick only), after one warm call."""
    timer = TimedLaunches()
    usage, idx, rows = scatters[0]
    usage.index_copy_(0, idx.long(), rows)
    for usage, idx, rows in scatters:
        idx64 = idx.long()
        timer("index_copy_", lambda: usage.index_copy_(0, idx64, rows), None)
    return float(np.mean(timer.dev_ms["index_copy_"]))


@contextlib.contextmanager
def timed_cycle_phases(spans: dict):
    """Host wall of the cycle's lowering and dispatch (solve and the
    one fetch, which synchronises), per call."""
    from kueue_tpu_torch.core import solver

    saved = (solver.lower_heads, solver.dispatch_lowered)

    def timed(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            spans.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return call

    solver.lower_heads = timed("lowering", saved[0])
    solver.dispatch_lowered = timed("dispatch", saved[1])
    try:
        yield
    finally:
        solver.lower_heads, solver.dispatch_lowered = saved


def cycle_path(device) -> dict:
    """Phase 4 on ``device`` ("cuda"; the CPU only to rehearse the
    harness): returns what the result lines need."""
    import torch

    from kueue_tpu_torch.core.snapshot import take_snapshot as snap_of
    from kueue_tpu_torch.ops import _build
    from kueue_tpu_torch.perf import cases, cycle
    from kueue_tpu_torch.perf.lockstep import (
        CYCLE_KERNELS,
        Lockstep,
        cycle_kernels_through,
    )

    steady = STEADY_CYCLES - cycle.CYCLES

    def headline_run(sched, ccache, label, before=None, after=None):
        """The headline's CYCLE_EXPECT cycles, checked, then its steady
        cycles; ``before``/``after`` wrap each part (context factories)."""
        with (before or contextlib.nullcontext)():
            records = cycle.run_cycles(sched)
        csum = cycle.cycle_summary(records, ccache, snap_of)
        if csum != cycle.CYCLE_EXPECT:
            fail(f"{label}: {csum} != expected {cycle.CYCLE_EXPECT}")
        with (after or contextlib.nullcontext)():
            records += cycle.run_cycles(sched, steady)
        return records, csum

    # 4a. the cycle's kernels in lockstep at the headline (its first
    # cycles' plain ms apart from the steady cycles') and on the small
    # cluster (to quiescence)
    cerrs, cplain, stplain = {}, {}, {}
    t0 = time.perf_counter()
    sched, ccache = cycle.build_headline_scheduler(device=device, guard=strict_guard())
    check = Lockstep(cerrs, label="cycle headline", plain_ms=cplain)
    stcheck = Lockstep(cerrs, label="cycle headline, steady", plain_ms=stplain)
    lock_records, csum = headline_run(
        sched, ccache, "cycle lockstep at the headline",
        lambda: cycle_kernels_through(check), lambda: cycle_kernels_through(stcheck),
    )
    if check.failures or stcheck.failures:
        fail(f"cycle lockstep at the headline: {check.failures + stcheck.failures}")
    check_strict(sched.guard, "cycle lockstep at the headline")
    if stcheck.launches.get("scatter_rows", 0) <= 0:
        fail("the headline's steady cycles made no row scatter")
    print(f"{stamp()} cycle lockstep headline: {len(lock_records)} cycles, launches "
          f"checked {json.dumps(check.launches)} in the first {cycle.CYCLES}, "
          f"{json.dumps(stcheck.launches)} in the steady ones, every one bit-exact "
          f"({time.perf_counter() - t0:.1f} s); admitted {csum['admitted']} then "
          f"{[len(r['admitted']) for r in lock_records[cycle.CYCLES:]]}")

    spec = cases.cycle_spec(SMALL_CYCLE_SEED)
    ssched, smgr, _ = cases.build_scheduler(spec, device=device, guard=strict_guard())
    scheck = Lockstep(cerrs, label="cycle small")
    with cycle_kernels_through(scheck):
        srecords = cycle.run_until_quiet(ssched, smgr, SMALL_CYCLES)
    cpu_sched, cpu_mgr, _ = cases.build_scheduler(spec, device="cpu")
    if scheck.failures or srecords != cycle.run_until_quiet(cpu_sched, cpu_mgr, SMALL_CYCLES):
        fail(f"cycle lockstep on the small cluster: {scheck.failures or 'decisions differ from the CPU'}")
    check_strict(ssched.guard, "cycle lockstep on the small cluster")
    if set(scheck.launches) != set(CYCLE_KERNELS):
        fail(f"the small cycle run checked only {sorted(scheck.launches)}")
    print(f"{stamp()} cycle lockstep small cluster (cycle_spec({SMALL_CYCLE_SEED}), depth "
          f"{ssched._resident_state._tree.max_depth}): {len(srecords)} cycles, launches "
          f"checked {json.dumps(scheck.launches)}, bit-exact, equal to the CPU run")

    # 4b. the main path: the port's Scheduler on cuda, strict guard
    _build.reset_launches()
    sched, ccache = cycle.build_headline_scheduler(device=device, guard=strict_guard())
    records, csum = headline_run(sched, ccache, "headline cycles")
    cycle_launches = _build.launch_counts()
    if records != lock_records:
        fail("the headline cycles on cuda differ from their lockstep run")
    check_strict(sched.guard, "headline cycles")
    rs = sched._resident_state
    print(f"{stamp()} Scheduler on cuda, headline: {json.dumps(csum)}; "
          f"{len(records)} cycles in all, equal to the lockstep run; resolutions "
          f"{[r['resolution'] for r in records]}; every dispatch via the device and "
          f"checked on the host mirror ({sched.guard.divergence_checks}), 0 failures, "
          f"0 divergences; resident uploads {rs.full_uploads}, delta cycles "
          f"{rs.delta_cycles}, rows {rs.delta_rows}; launches {json.dumps(cycle_launches)}")
    _build.reset_launches()
    ssched, smgr, _ = cases.build_scheduler(spec, device=device, guard=strict_guard())
    srecords2 = cycle.run_until_quiet(ssched, smgr, SMALL_CYCLES)
    small_launches = _build.launch_counts()
    if srecords2 != srecords:
        fail("the small cycle run on cuda differs from its lockstep run")
    check_strict(ssched.guard, "small cycles")
    print(f"{stamp()} Scheduler on cuda, small cluster: {len(srecords2)} cycles equal to the CPU "
          f"run; launches {json.dumps(small_launches)}")
    for name in CYCLE_KERNELS:
        if cycle_launches[name] <= 0:
            fail(f"kernel {name} was not launched by the headline cycles")
        if small_launches[name] <= 0:
            fail(f"kernel {name} was not launched by the small cluster's cycles")

    # 4c. timing: every launch alone on the device (quota_tree and the
    # two phases over the first cycles, the scatter over the steady
    # ones), then the walls
    timer, stimer = TimedLaunches(), TimedLaunches()
    sched, ccache = cycle.build_headline_scheduler(device=device, guard=strict_guard(0))
    timed_records, _ = headline_run(
        sched, ccache, "the timed headline cycles",
        lambda: timed_cycle_kernels(timer), lambda: timed_cycle_kernels(stimer),
    )
    if timed_records != lock_records:
        fail("the timed headline cycles changed their decisions")
    library = {"scatter_rows": index_copy_ms(stimer.scatter_args)}
    ctiming = {name: timing_of(timer, name, cplain)
               for name in ("quota_tree", "cycle_phase1", "cycle_phase2")}
    ctiming["scatter_rows"] = timing_of(stimer, "scatter_rows", stplain)
    steady_timing = {name: timing_of(stimer, name, stplain)
                     for name in ("quota_tree", "cycle_phase1", "cycle_phase2")}
    print(f"{stamp()} timed cycle launches: first {cycle.CYCLES} cycles "
          f"{json.dumps({k: len(v) for k, v in timer.dev_ms.items()})}, steady "
          f"{json.dumps({k: len(v) for k, v in stimer.dev_ms.items()})}, "
          f"{timer.uncovered + stimer.uncovered} uncovered; scatter rows "
          f"{[int(a[1].unique().numel()) for a in stimer.scatter_args]}")

    sched, ccache = cycle.build_headline_scheduler(device=device, guard=strict_guard(0))
    spans, totals = {}, []
    with timed_cycle_phases(spans):
        recs = []
        for _ in range(cycle.CYCLES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            recs.append(cycle.cycle_record(sched.schedule()))
            totals.append(time.perf_counter() - t0)
    if cycle.cycle_summary(recs, ccache, snap_of) != cycle.CYCLE_EXPECT:
        fail("the timed headline cycles changed their decisions")
    traces = list(sched.last_traces)
    parts = {
        "total": totals,
        "snapshot": [t.spans["snapshot"] for t in traces],
        "lowering": spans["lowering"],
        "dispatch": spans["dispatch"],
        "nominate_rest": [t.spans["nominate"] - lo - di for t, lo, di in
                          zip(traces, spans["lowering"], spans["dispatch"])],
        "host_apply": [t.spans["admit"] for t in traces],
    }
    cycle_ms = {k: 1e3 * float(np.mean(v)) for k, v in parts.items()}
    cycle_max_ms = 1e3 * float(np.max(totals))
    solve_dev = sum(ctiming[n]["ms"] * m for n, m in
                    (("quota_tree", 4), ("cycle_phase1", 1), ("cycle_phase2", 1)))
    print(f"{stamp()} headline cycle wall, mean of {cycle.CYCLES} cycles (max {cycle_max_ms:.1f} ms): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in cycle_ms.items())
          + f"; the solve's six launches, each timed alone, {solve_dev:.3f} ms a cycle")
    depth = sched._resident_state._tree.max_depth
    cshapes = {
        "quota_tree": f"headline cycles 1-{cycle.CYCLES}, 4 a cycle, D={depth}",
        "cycle_phase1": f"headline cycles 1-{cycle.CYCLES}, W=1024 K=8 C=16",
        "cycle_phase2": f"headline cycles 1-{cycle.CYCLES}, W=1024 K=8 C=16 D={depth}",
        "scatter_rows": f"headline cycles {cycle.CYCLES + 1}-{STEADY_CYCLES}, row deltas",
    }
    for name, t in ctiming.items():
        print(f"kernel {name} [{cshapes[name]}]: mean over {t['timed']} launches: "
              f"{t['ms'] * 1e3:.2f} us/launch on the device ({t['device_ms_total']:.3f} ms "
              f"in all), {t['host_ms'] * 1e3:.2f} us/call to enqueue, plain "
              f"{t['plain_ms']:.3f} ms/call, bound {t['bound_ms'] * 1e3:.4f} us "
              f"({t['bytes']:.0f} B); launches headline {cycle_launches[name]} small "
              f"{small_launches[name]}; max_abs_err {cerrs[name]}"
              + (f"; index_copy_ {library[name] * 1e3:.2f} us/call" if name in library else ""))
    for name, t in steady_timing.items():
        print(f"kernel {name} [headline cycles {cycle.CYCLES + 1}-{STEADY_CYCLES}]: "
              f"{t['ms'] * 1e3:.2f} us/launch over {t['timed']}, plain "
              f"{t['plain_ms']:.3f} ms/call, bound {t['bound_ms'] * 1e3:.4f} us")

    return {
        "errs": cerrs, "timing": ctiming, "library": library,
        "launches": {"cycle_headline": cycle_launches, "cycle_small": small_launches},
        "cycle_ms": cycle_ms, "cycle_max_ms": cycle_max_ms, "solve_dev": solve_dev,
    }


# ---- the megaloop and the fair drain --------------------------------------


def boundary_bytes(bd: BoundData, cursor, closing: bool, alive_after, n_stamped: int) -> int:
    """Bytes megaloop_boundary must move in one cycle: per queue its
    cursor, length, alive, stuck and admitted flags; a 4-byte round
    stamp per admission of the cycle; at a boundary the leaf usage read
    and its snapshot written, per queue the snapshot's cursor and stuck
    flag, the new alive, stuck, retries, per-group cursors and budget
    written, and the budget read for each remaining queue; the
    scalars."""
    q, pg = bd.q, bd.p * bd.g
    b = q * 11 + 4 * n_stamped + 24
    if closing:
        remaining = (cursor < bd.qlen) & alive_after
        b += 2 * bd.n * bd.fr * 8 + q * (4 + 1 + 1 + 1 + 4 + 4 * pg + 4)
        b += 4 * int(remaining.sum())
    return b


def fair_bytes(bd: BoundData, cursor, alive, buf, n_res: int) -> int:
    """Bytes drain_fair_phase2 must move in one cycle (each input read
    once, each output written once): per participating head its used
    cells and their quantities (an unused slot costs nothing), cursor, priority, timestamp, ClusterQueue row and
    flags; per distinct node on their paths its usage and subtree rows
    (the borrowed sums), lendable, weight, parent and depth; guaranteed
    and borrowing_limit per distinct (node, cell) pair on the paths;
    nominal per reserving head's leaf pair; usage written per moved
    pair; local read and written per admitted leaf pair; the cell-to-
    resource map, the segments and the admitted flags."""
    fr, d1 = bd.fr, bd.d1
    active = (cursor < bd.qlen) & alive
    is_fit = buf.is_fit.cpu().numpy()
    is_pre = buf.is_pre.cpu().numpy()
    admitted = buf.admitted.cpu().numpy()
    part = np.nonzero(active & (is_fit | is_pre) & (bd.rows >= 0))[0]
    ce = buf.cells_eff.cpu().numpy()
    qe = buf.qty_eff.cpu().numpy()
    ce = np.where(qe > 0, ce, -1)
    pc = ce.shape[1]
    path_nodes = bd.paths[bd.rows[part]]  # [H, D+1]
    nodes = np.unique(path_nodes[path_nodes >= 0])
    node_rows = np.repeat(path_nodes, pc, axis=1)
    node_cells = np.where(node_rows >= 0, np.tile(ce[part], (1, d1)), -1)
    pairs = _distinct(node_rows.reshape(-1), node_cells.reshape(-1), fr)
    adm = np.nonzero(admitted)[0]
    adm_pairs = _distinct(np.repeat(bd.rows[adm], pc), ce[adm].reshape(-1), fr)
    reserve = np.nonzero(is_pre & bd.no_reclaim & active)[0]
    res_pairs = _distinct(np.repeat(bd.rows[reserve], pc), ce[reserve].reshape(-1), fr)
    moved = np.nonzero(admitted | (is_pre & bd.no_reclaim & active))[0]
    mrows = np.repeat(bd.paths[bd.rows[moved]], pc, axis=1)
    mcells = np.where(mrows >= 0, np.tile(ce[moved], (1, d1)), -1)
    moved_pairs = _distinct(mrows.reshape(-1), mcells.reshape(-1), fr)
    per_head = 4 + 8 + 8 + 4 + 4 * d1 + 4 + 5
    per_node = 2 * fr * 8 + 8 * n_res + 8 + 4 + 4
    return (len(part) * per_head + 12 * int((ce[part] >= 0).sum()) + len(nodes) * per_node + pairs * 16 + res_pairs * 8
            + moved_pairs * 8 + adm_pairs * 16 + 4 * fr + 4 * (bd.s + 1) + 4 * bd.q
            + bd.q)


def megaloop_inputs(snap, pending, flavors, dev):
    """One chain launch's plan and device inputs, as
    launch_drain_megaloop builds them."""
    from kueue_tpu_torch._torch import to_device
    from kueue_tpu_torch.core import drain as pd
    from kueue_tpu_torch.perf import headline

    plan = pd.plan_drain(snap, pending, flavors, max_cells=headline.HEADLINE_MAX_CELLS)
    tree, paths, local, queues = pd._drain_device_inputs(snap, plan, dev)
    cap = to_device(pd._cap_suffix_of(plan), dev, np.int32)
    return dict(snap=snap, pending=list(pending), plan=plan, tree=tree, paths=paths,
                local=local, queues=queues, cap=cap)


def megaloop_log(inp, state):
    """The host-decoded log a megaloop state holds."""
    from kueue_tpu_torch.core import drain as pd
    from kueue_tpu_torch.ops.megaloop_kernel import pack_megaloop, result_of
    from kueue_tpu_torch.perf import megaloop

    return pd.MegaloopLaunch(
        plan=inp["plan"], queues_np=inp["plan"].queues_np,
        flat_dev=pack_megaloop(result_of(state)),
        usage_shape=tuple(inp["snap"].local_usage.shape),
        start_usage=np.asarray(inp["snap"].local_usage), pending=inp["pending"],
        chunk_cycles=megaloop.CHUNK_CYCLES, max_rounds=megaloop.MAX_ROUNDS,
    ).fetch()


def round_view(out):
    from kueue_tpu_torch.core.pipeline import outcome_signature

    sig = outcome_signature(out)
    sig["undecided"] = sorted((wl.key, cq) for wl, cq in out.undecided)
    sig["final_usage"] = np.asarray(out.final_usage).tolist()
    return sig


def megaloop_path(dev, cache, pending) -> dict:
    """Phase 4: the megaloop chain at the headline (module docstring)."""
    import torch

    from kueue_tpu_torch.core import drain as pd
    from kueue_tpu_torch.core.pipeline import speculative_snapshot
    from kueue_tpu_torch.core.snapshot import take_snapshot
    from kueue_tpu_torch.ops import _build
    from kueue_tpu_torch.ops import drain_kernel as dk
    from kueue_tpu_torch.ops import megaloop_kernel as ml
    from kueue_tpu_torch.perf import cases, headline, megaloop
    from kueue_tpu_torch.perf.lockstep import MEGALOOP_STEPS, lockstep_megaloop

    ch, mr = megaloop.CHUNK_CYCLES, megaloop.MAX_ROUNDS
    errs, plain = {}, {}

    # 4a. lockstep over the chain's launches, and the small case
    t0 = time.perf_counter()
    inputs, lock_logs = [], []
    s, p = take_snapshot(cache), pending
    while True:
        inp = megaloop_inputs(s, p, cache.flavors, dev)
        _, state, cyc = lockstep_megaloop(
            inp["tree"], inp["local"], inp["queues"], inp["paths"], inp["cap"],
            inp["plan"].n_segments, inp["plan"].n_steps, ch, mr, errs,
            label=f"megaloop launch {len(inputs) + 1}", plain_ms=plain,
        )
        log = megaloop_log(inp, state)
        inputs.append(inp)
        lock_logs.append(log)
        if not log.truncated:
            break
        if len(inputs) >= megaloop.MAX_LAUNCHES:
            fail("the lockstep megaloop chain did not end")
        last = log.rounds[-1]
        s, p = speculative_snapshot(s, last.final_usage), last.undecided
    lsum = megaloop.chain_summary(lock_logs)
    if lsum != megaloop.MEGALOOP_EXPECT:
        fail(f"megaloop lockstep chain {lsum} != expected {megaloop.MEGALOOP_EXPECT}")
    print(f"{stamp()} megaloop lockstep headline (chunk_cycles={ch}, max_rounds={mr}): "
          f"{len(lock_logs)} launches, rounds {lsum['rounds_per_launch']}, "
          f"{lsum['cycles']} cycles, every launch of {sorted(errs)} bit-exact to its plain "
          f"version ({time.perf_counter() - t0:.1f} s)")

    spec = cases.mixed_spec(SMALL_SEED)
    s_cache, s_pending = cases.build_cache(spec)
    sinp = megaloop_inputs(take_snapshot(s_cache), s_pending, s_cache.flavors, dev)
    sp = sinp["plan"]
    # at 56 cycles a round its PendingFlavors queues freeze in the second
    # round, and that round's boundary retires them
    _, s_state, s_cyc = lockstep_megaloop(
        sinp["tree"], sinp["local"], sinp["queues"], sinp["paths"], sinp["cap"],
        sp.n_segments, sp.n_steps, 56, 6, errs, label="megaloop small",
    )
    retired = int((~s_state.alive).sum())
    if retired == 0:
        fail("the small megaloop retired no stuck queue")
    print(f"{stamp()} megaloop lockstep small case (mixed_spec({SMALL_SEED}), 56 x 6): "
          f"{s_cyc} cycles, {int(s_state.round_idx.item())} rounds, {retired} queues "
          f"retired at a boundary, bit-exact")

    # 4b. the main path: the chained launch_drain_megaloop on cuda
    plan_s = []
    real_plan = pd.plan_drain

    def timed_plan(*a, **k):
        t = time.perf_counter()
        out = real_plan(*a, **k)
        plan_s.append(time.perf_counter() - t)
        return out

    _build.reset_launches()
    logs, walls = [], []
    pd.plan_drain = timed_plan
    try:
        s, p = take_snapshot(cache), pending
        while True:
            torch.cuda.synchronize()
            reads = dk.DONE_READS
            t0 = time.perf_counter()
            launch = pd.launch_drain_megaloop(
                s, p, cache.flavors, max_cells=headline.HEADLINE_MAX_CELLS,
                chunk_cycles=ch, max_rounds=mr, device="cuda",
            )
            t1 = time.perf_counter()
            syncs = dk.DONE_READS - reads + 1  # the done-flag reads and the fetch
            torch.cuda.synchronize()  # the fetch's wait for the card, timed apart
            tw = time.perf_counter()
            log = launch.fetch()
            t2 = time.perf_counter()
            logs.append(log)
            walls.append({"plan_ms": plan_s[-1] * 1e3,
                          "enqueue_ms": (t1 - t0 - plan_s[-1]) * 1e3,
                          "fetch_ms": (t2 - t1) * 1e3, "fetch_wait_ms": (tw - t1) * 1e3,
                          "fetch_copy_decode_ms": (t2 - tw) * 1e3, "host_syncs": syncs,
                          "rounds": log.n_rounds, "cycles": log.cycles})
            if not log.truncated or len(logs) >= megaloop.MAX_LAUNCHES:
                break
            last = log.rounds[-1]
            s, p = speculative_snapshot(s, last.final_usage), last.undecided
    finally:
        pd.plan_drain = real_plan
    launches = _build.launch_counts()
    summary = megaloop.chain_summary(logs)
    print(f"{stamp()} launch_drain_megaloop chain on cuda: {json.dumps(summary)}; "
          f"launches {json.dumps(launches)}")
    if summary != megaloop.MEGALOOP_EXPECT:
        fail(f"megaloop chain {summary} != expected {megaloop.MEGALOOP_EXPECT}")
    if [[round_view(r) for r in g.rounds] for g in logs] != [
            [round_view(r) for r in g.rounds] for g in lock_logs]:
        fail("the megaloop chain on cuda differs from its lockstep run")
    for name in _build.MEGALOOP_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by the megaloop chain")
    for i, w in enumerate(walls):
        print(f"  launch {i + 1}: {w['rounds']} rounds, {w['cycles']} cycles, host syncs "
              f"{w['host_syncs']}; wall {w['plan_ms'] + w['enqueue_ms'] + w['fetch_ms']:.1f} ms"
              f" = plan {w['plan_ms']:.1f} + enqueue {w['enqueue_ms']:.1f} + fetch "
              f"{w['fetch_ms']:.1f} ms (the card's remaining work {w['fetch_wait_ms']:.1f}, "
              f"the copy and the host decode of the rounds "
              f"{w['fetch_copy_decode_ms']:.1f})")

    # 4c. each round equals the serial launch_drain chain on cuda
    rounds = [r for g in logs for r in g.rounds]
    t0 = time.perf_counter()
    serial = megaloop.serial_chain(
        pd.launch_drain, speculative_snapshot, take_snapshot(cache), pending,
        cache.flavors, len(rounds), device="cuda",
    )
    serial_ms = (time.perf_counter() - t0) * 1e3
    if [round_view(r) for r in serial] != [round_view(r) for r in rounds]:
        fail("the megaloop rounds differ from the serial launch_drain chain")
    print(f"{stamp()} serial chain: {len(serial)} launch_drain(max_cycles={ch}) launches on "
          f"cuda equal the megaloop's {len(rounds)} rounds (signature, undecided, final "
          f"usage); its wall {serial_ms:.1f} ms beside the megaloop chain's "
          f"{sum(w['plan_ms'] + w['enqueue_ms'] + w['fetch_ms'] for w in walls):.1f} ms")

    # 4d. every launch of the chain timed alone on the device
    timer = TimedLaunches()
    for inp in inputs:
        plan = inp["plan"]
        ctx = dk.DrainContext.build(
            inp["tree"], inp["queues"], inp["paths"], plan.n_segments, plan.n_steps,
            ch * mr, chunk_cycles=ch, max_rounds=mr,
        )
        bd = BoundData(ctx)
        state = ml.MegaloopState.initial_rounds(inp["local"], inp["queues"], inp["cap"], mr)
        buf = dk.CycleBuffers.empty(inp["local"], inp["queues"])
        while not state.done.item():
            cursor = state.cursor.cpu().numpy()
            alive = state.alive.cpu().numpy()
            rnd = int(state.round_idx.item())
            for name, kern, _ in MEGALOOP_STEPS:
                timer(name, lambda: kern(ctx, state, buf), None)
            per = cycle_bytes(bd, cursor, buf, alive)
            after = state.cursor.cpu().numpy()
            per["megaloop_boundary"] = [boundary_bytes(
                bd, after, int(state.round_idx.item()) != rnd,
                state.alive.cpu().numpy(), int(buf.admitted.sum()))]
            timer.add_bytes(per)
    timing = {name: timing_of(timer, name, plain) for name in _build.MEGALOOP_KERNELS}
    print(f"{stamp()} timed megaloop chain: "
          f"{json.dumps({k: len(v) for k, v in timer.dev_ms.items()})} launches each timed "
          f"alone, {timer.uncovered} uncovered")
    return {"errs": errs, "timing": timing, "launches": launches, "walls": walls,
            "serial_ms": serial_ms, "summary": summary}


def fair_inputs_of(cache, pending, dev, max_cells):
    """The fair drain's plan (preempt-capable queues routed out) and its
    device inputs, as run_drain(fair_sharing=True) builds them."""
    from kueue_tpu_torch.core import drain as pd
    from kueue_tpu_torch.core.snapshot import take_snapshot

    snap = take_snapshot(cache)
    plan = pd.plan_drain(snap, pending, cache.flavors, max_cells=max_cells)
    pd._route_preempt_capable(snap, plan)
    tree, paths, local, queues = pd._drain_device_inputs(snap, plan, dev)
    return plan, tree, paths, local, queues, pd.fair_inputs(snap, tree.max_depth, dev)


def fair_path(dev, cache, pending) -> dict:
    """Phase 5: the fair-sharing drain at the headline (module docstring)."""
    import torch

    from kueue_tpu_torch.core.drain import run_drain
    from kueue_tpu_torch.core.snapshot import take_snapshot
    from kueue_tpu_torch.ops import _build
    from kueue_tpu_torch.ops import drain_kernel as dk
    from kueue_tpu_torch.perf import cases, headline
    from kueue_tpu_torch.perf.lockstep import FAIR_STEPS, lockstep

    mc = headline.HEADLINE_MAX_CELLS
    errs, plain = {}, {}

    # 5a. lockstep at the headline and on the depth-3 weighted case
    t0 = time.perf_counter()
    plan, tree, paths, local, queues, fair = fair_inputs_of(cache, pending, dev, mc)
    _, _, cyc = lockstep(tree, local, queues, paths, plan.n_segments, plan.n_steps,
                         plan.max_cycles, errs, label="fair headline", plain_ms=plain,
                         fair=fair)
    if cyc != headline.FAIR_EXPECT["cycles"]:
        fail(f"fair lockstep headline ran {cyc} cycles")
    print(f"{stamp()} fair lockstep headline: {cyc} cycles, every launch of {sorted(errs)} "
          f"bit-exact ({time.perf_counter() - t0:.1f} s)")
    f_cache, f_pending = cases.build_cache(cases.fair_spec(FAIR_SEED))
    fp, ft, fpa, fl, fq, ff = fair_inputs_of(f_cache, f_pending, dev, 4)
    _, _, fcyc = lockstep(ft, fl, fq, fpa, fp.n_segments, fp.n_steps, fp.max_cycles, errs,
                          label="fair small", fair=ff)
    print(f"{stamp()} fair lockstep small case (fair_spec({FAIR_SEED}), D={ft.max_depth}, "
          f"{int((fq.qlen > 0).sum())} queues in the tournament): {fcyc} cycles, bit-exact")

    # 5b. the main path
    _build.reset_launches()
    out = run_drain(take_snapshot(cache), pending, cache.flavors, max_cells=mc,
                    fair_sharing=True, device="cuda")
    launches = _build.launch_counts()
    summary = headline.outcome_summary(out)
    print(f"{stamp()} run_drain(fair_sharing=True) on cuda: {json.dumps(summary)}; "
          f"launches {json.dumps(launches)}")
    if summary != headline.FAIR_EXPECT:
        fail(f"fair drain {summary} != expected {headline.FAIR_EXPECT}")
    for name in _build.FAIR_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by the fair drain")
    walls, solves = [], []
    for _ in range(3):
        snap = take_snapshot(cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_drain(snap, pending, cache.flavors, max_cells=mc, fair_sharing=True, device="cuda")
        walls.append(time.perf_counter() - t0)
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dk._solve_drain_packed(
            tree, local, queues, paths, plan.n_segments, plan.n_steps, plan.max_cycles,
            seg_id=plan.queues_np["seg_id"], fair=fair,
        ).cpu()
        solves.append(time.perf_counter() - t0)
    wall_ms = float(np.median(walls)) * 1e3
    solve_ms = float(np.median(solves)) * 1e3
    print(f"{stamp()} fair drain wall (run_drain, lowering included, median of 3): "
          f"{wall_ms:.1f} ms = {wall_ms / cyc:.3f} ms/cycle; solve (inputs on the card, "
          f"{cyc} cycles, one fetch) {solve_ms:.2f} ms = {solve_ms / cyc:.4f} ms/cycle")

    # 5c. every launch timed alone on the device
    ctx = dk.DrainContext.build(tree, queues, paths, plan.n_segments, plan.n_steps,
                                plan.max_cycles, fair=fair)
    bd = BoundData(ctx)
    state = dk.DrainState.initial(local, queues, plan.max_cycles)
    buf = dk.CycleBuffers.empty(local, queues)
    timer = TimedLaunches()
    while not state.done.item():
        cursor = state.cursor.cpu().numpy()
        alive = state.alive.cpu().numpy()
        for name, kern, _ in FAIR_STEPS:
            timer(name, lambda: kern(ctx, state, buf), None)
        per = cycle_bytes(bd, cursor, buf)
        del per["drain_phase2"]
        per["drain_fair_phase2"] = [fair_bytes(bd, cursor, alive, buf, fair.n_res)]
        timer.add_bytes(per)
    timing = {name: timing_of(timer, name, plain) for name in _build.FAIR_KERNELS}
    print(f"{stamp()} timed fair drain: "
          f"{json.dumps({k: len(v) for k, v in timer.dev_ms.items()})} launches each timed "
          f"alone, {timer.uncovered} uncovered")
    return {"errs": errs, "timing": timing, "launches": launches, "wall_ms": wall_ms,
            "solve_ms": solve_ms, "cycles": cyc}


# ---- main ---------------------------------------------------------------


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: the port runs on the card")
    try:
        from kueue_tpu_torch.core.drain import plan_drain, run_drain
        from kueue_tpu_torch.interop import drain_queues
        from kueue_tpu_torch.core.snapshot import take_snapshot
        from kueue_tpu_torch.core.solver import tree_arrays
        from kueue_tpu_torch.ops import _build
        from kueue_tpu_torch.ops.drain_kernel import _solve_drain_packed
        from kueue_tpu_torch.perf import cases, headline
        from kueue_tpu_torch.perf.lockstep import DRAIN_KERNELS, lockstep
    except ImportError as exc:
        fail(f"kueue_tpu_torch is not importable here ({exc}); run from the repo root")

    dev = torch.device("cuda")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")

    # 1. build
    build_s = _build.build_all()
    print(f"build: {len(_build.KERNELS)} kernels in {build_s:.2f} s")
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    errs = {name: 0 for name in _build.KERNELS}

    # 2a. lockstep on the headline plan
    t0 = time.perf_counter()
    rng = np.random.default_rng(headline.HEADLINE_SEED)
    cache = headline.build_cluster(rng)
    pending = headline.build_backlog(rng)
    print(f"headline cluster + backlog: {len(pending)} workloads "
          f"({time.perf_counter() - t0:.1f} s)")
    snap = take_snapshot(cache)
    plan = plan_drain(snap, pending, cache.flavors, max_cells=headline.HEADLINE_MAX_CELLS)
    tree, paths, _ = tree_arrays(snap, dev)
    local = tree.nominal.new_tensor(snap.local_usage)
    queues = drain_queues(plan.queues_np, dev)
    print(f"headline plan: cells {tuple(plan.queues_np['cells'].shape)} "
          f"G={plan.queues_np['gidx'].shape[-1]} N={tree.n_nodes} "
          f"FR={tree.nominal.shape[1]} D={tree.max_depth} "
          f"n_segments={plan.n_segments} n_steps={plan.n_steps} "
          f"max_cycles={plan.max_cycles}")
    t0 = time.perf_counter()
    plain_ms = {}
    ctx0, _, cyc = lockstep(
        tree, local, queues, paths, plan.n_segments, plan.n_steps,
        plan.max_cycles, errs, label="headline", plain_ms=plain_ms,
    )
    print(f"{stamp()} lockstep headline: {cyc} cycles, every kernel bit-exact to its "
          f"plain version ({time.perf_counter() - t0:.1f} s)")
    if cyc != headline.HEADLINE_EXPECT["cycles"]:
        fail(f"lockstep headline ran {cyc} cycles")

    # 2b. lockstep on the small seeded case, with nonzero scores
    spec = cases.mixed_spec(SMALL_SEED)
    s_cache, s_pending = cases.build_cache(spec)
    s_snap = take_snapshot(s_cache)
    s_plan = plan_drain(s_snap, s_pending, s_cache.flavors)
    srng = np.random.default_rng(SMALL_SEED)
    s_plan.queues_np["score"] = srng.integers(-2, 3, size=s_plan.queues_np["score"].shape)
    s_tree, s_paths, _ = tree_arrays(s_snap, dev)
    s_local = s_tree.nominal.new_tensor(s_snap.local_usage)
    s_queues = drain_queues(s_plan.queues_np, dev)
    _, s_state, s_cyc = lockstep(
        s_tree, s_local, s_queues, s_paths, s_plan.n_segments,
        s_plan.n_steps, s_plan.max_cycles, errs, label="small",
    )
    n_stuck = int(s_state.stuck.sum())
    shape = tuple(s_plan.queues_np["cells"].shape)
    print(f"{stamp()} lockstep small case: cells {shape} D={s_tree.max_depth} "
          f"{s_cyc} cycles, {n_stuck} stuck queues, bit-exact")
    if shape[2] != 3 or s_tree.max_depth != 3 or n_stuck == 0:
        fail("the small case lost its coverage (P=3, depth 3, stuck queues)")

    # 2c. every launch of the headline drain timed on the device
    t_cyc, dtimer = timed_drain(ctx0, local, queues)
    if t_cyc != headline.HEADLINE_EXPECT["cycles"]:
        fail(f"timed headline drain ran {t_cyc} cycles")
    timing = {name: timing_of(dtimer, name, plain_ms) for name in DRAIN_KERNELS}
    kernel_ms = sum(t["device_ms_total"] for t in timing.values())
    print(f"{stamp()} timed headline drain: {t_cyc} cycles, "
          f"{sum(len(v) for v in dtimer.dev_ms.values())} launches each timed alone "
          f"on the device, {dtimer.uncovered} uncovered")

    # 3. the slice through its entry point
    _build.reset_launches()
    outcome = run_drain(
        take_snapshot(cache), pending, cache.flavors,
        max_cells=headline.HEADLINE_MAX_CELLS, device="cuda",
    )
    launches = _build.launch_counts()
    summary = headline.outcome_summary(outcome)
    print(f"{stamp()} run_drain on cuda: {json.dumps(summary)}; launches {json.dumps(launches)}")
    if summary != headline.HEADLINE_EXPECT:
        fail(f"headline drain {summary} != expected {headline.HEADLINE_EXPECT}")
    for name in DRAIN_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the main path")
    graph_ms, g_adm, g_cyc = drain_graph_ms(
        ctx0, local, queues, launches["drain_nominate"]
    )
    if (g_cyc, g_adm) != (summary["cycles"], summary["admitted"]):
        fail(f"the drain replayed as one graph gave {g_cyc} cycles, {g_adm} admitted")
    q, l, p, k, c = plan.queues_np["cells"].shape
    g = plan.queues_np["gidx"].shape[-1]
    n, fr = tree.nominal.shape
    shapes = {
        "quota_tree": f"N={n} FR={fr} D={tree.max_depth}",
        "drain_nominate": f"Q={q} L={l} P={p} K={k} C={c} G={g}",
        "drain_phase2": f"Q={q} segments={ctx0.segments.count} "
                        f"n_steps={plan.n_steps} P*C={p * c} D={tree.max_depth}",
        "drain_queue_motion": f"Q={q} L={l} P={p} G={g}",
    }
    for name in DRAIN_KERNELS:
        t = timing[name]
        print(f"kernel {name} [{shapes[name]}]: mean over the drain's {t['timed']} "
              f"launches with work: {t['ms'] * 1e3:.2f} us/launch on the device "
              f"({t['device_ms_total']:.3f} ms in all), {t['host_ms'] * 1e3:.2f} us/call "
              f"to enqueue on the host, plain {t['plain_ms']:.3f} ms/call, bound "
              f"{t['bound_ms'] * 1e3:.4f} us ({t['bytes']:.0f} B); main-path launches "
              f"{launches[name]}, max_abs_err {errs[name]}")

    walls = []
    for _ in range(3):
        s = take_snapshot(cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_drain(s, pending, cache.flavors, max_cells=headline.HEADLINE_MAX_CELLS,
                  device="cuda")
        walls.append(time.perf_counter() - t0)
    plans = []
    for _ in range(3):
        s = take_snapshot(cache)
        t0 = time.perf_counter()
        plan_drain(s, pending, cache.flavors, max_cells=headline.HEADLINE_MAX_CELLS)
        plans.append(time.perf_counter() - t0)
    solves = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flat = _solve_drain_packed(tree, local, queues, paths, plan.n_segments,
                                   plan.n_steps, plan.max_cycles)
        flat.cpu()
        solves.append(time.perf_counter() - t0)
    wall_ms = float(np.median(walls)) * 1e3
    plan_ms = float(np.median(plans)) * 1e3
    solve_ms = float(np.median(solves)) * 1e3
    cycles = summary["cycles"]
    print(f"{stamp()} headline drain wall (run_drain, lowering included, median of 3): "
          f"{wall_ms:.1f} ms = {wall_ms / cycles:.3f} ms/cycle; of which "
          f"plan_drain (host lowering) {plan_ms:.1f} ms; solve (inputs on the "
          f"card, {cycles} cycles, one fetch) {solve_ms:.2f} ms = "
          f"{solve_ms / cycles:.4f} ms/cycle; the kernels' device time over "
          f"the {cycles} cycles (each launch timed alone) {kernel_ms:.3f} ms "
          f"= {100 * kernel_ms / wall_ms:.2f}% of the wall; "
          f"the drain's {launches['drain_nominate']} cycles of launches as one CUDA "
          f"graph, no host: {graph_ms:.3f} ms = {100 * graph_ms / solve_ms:.1f}% "
          f"of the solve")

    # 4. the megaloop chain; 5. the fair drain
    drain_launches = launches
    mega = megaloop_path(dev, cache, pending)
    fairr = fair_path(dev, cache, pending)
    for label, res in (("megaloop", mega), ("fair", fairr)):
        for name, t in res["timing"].items():
            print(f"kernel {name} [{label}]: mean over {t['timed']} launches with work: "
                  f"{t['ms'] * 1e3:.2f} us/launch on the device ({t['device_ms_total']:.3f} ms "
                  f"in all), {t['host_ms'] * 1e3:.2f} us/call to enqueue, plain "
                  f"{t['plain_ms']:.3f} ms/call, bound {t['bound_ms'] * 1e3:.4f} us "
                  f"({t['bytes']:.0f} B); main-path launches {res['launches'][name]}, "
                  f"max_abs_err {res['errs'][name]}")

    # 6. the interactive cycle
    cyc = cycle_path(dev)
    cerrs, ctiming, library = cyc["errs"], cyc["timing"], cyc["library"]
    cycle_launches = cyc["launches"]["cycle_headline"]
    small_launches = cyc["launches"]["cycle_small"]

    # 7. result lines
    by_path = {
        "drain": drain_launches, "megaloop": mega["launches"], "fair": fairr["launches"],
        "cycle_headline": cycle_launches, "cycle_small": small_launches,
    }
    kernels = []
    for name in _build.KERNELS:
        if name in DRAIN_KERNELS:
            t, lib = timing[name], None
        elif name == "megaloop_boundary":
            t, lib = mega["timing"][name], None
        elif name == "drain_fair_phase2":
            t, lib = fairr["timing"][name], None
        else:
            t, lib = ctiming[name], library.get(name)
        entry = {
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(c[name] for c in by_path.values()),
            "launches_by_path": {k: c[name] for k, c in by_path.items()},
            "max_abs_err": max(r.get(name, 0) for r in (errs, cerrs, mega["errs"], fairr["errs"])),
            "ms": t["ms"],
            "device_ms_total": t["device_ms_total"],
            "host_ms": t["host_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes",
            "library_ms": lib,
        }
        for label, res in (("megaloop", mega), ("fair", fairr)):
            if name in res["timing"] and name not in ("megaloop_boundary", "drain_fair_phase2"):
                entry.setdefault("ms_by_path", {})[label] = res["timing"][name]["ms"]
        kernels.append(entry)
    if len(kernels) != 9:
        fail(f"{len(kernels)} kernels in the result line")
    print(json.dumps({"kernels": kernels, "wall_ms": wall_ms, "plan_ms": plan_ms,
                      "solve_ms": solve_ms, "kernels_device_ms": kernel_ms,
                      "drain_graph_ms": graph_ms, "cycles": cycles,
                      "megaloop_walls": mega["walls"], "megaloop_serial_ms": mega["serial_ms"],
                      "fair_wall_ms": fairr["wall_ms"], "fair_solve_ms": fairr["solve_ms"],
                      "fair_cycles": fairr["cycles"],
                      "cycle_ms": cyc["cycle_ms"], "cycle_max_ms": cyc["cycle_max_ms"],
                      "cycle_solve_device_ms": cyc["solve_dev"]}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
