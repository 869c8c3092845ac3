"""Two builds of a kernel timed side by side on one card: B3
(``cycle_phase2``), B4's nomination (``drain_nominate``), B1
(``quota_tree``, per call site), B4's phase 2 (``drain_phase2``), the TAS
drain's step scan (``drain_tas_phase2``, B13) and placement
(``drain_tas_place``, B13a), the unsegmented cycle's walk
(``cycle_global``, B3'), the fair-preempt drain's victim search
(``drain_fair_preempt_search``, B11a) and step scan
(``drain_fair_preempt_phase2``, B11b) and the fair drain's (B7,
``drain_fair_phase2``).

    python -m kueue_tpu_torch.perf.kernel_ab [--parent DIR] [--split]
                                             [--kernel NAME ...]

Run from the repository root on a machine with one CUDA card and nvcc.
It records the inputs of every launch with work of the chosen kernels:
``cycle_phase2`` and the cycle's quota call site (``quota_all``) over
the headline cycles (perf/cycle.py's Scheduler, ``CYCLES`` cycles);
``drain_nominate`` over three drains (the headline plain drain, the
contended preempt drain at each panel width of its schedule, the
fair-preempt drain at the panel caps, ``build_fair_wide``); the drain's
quota call site (``usage_and_available``) and ``drain_phase2`` over the
headline plain drain, and ``drain_phase2`` also over the first launch of
the headline's megaloop chain (perf/megaloop.py's rounds); ``drain_tas_place``
and ``drain_tas_phase2`` over tas-drain-10k; ``drain_fair_preempt_search``
and ``drain_fair_preempt_phase2`` over fair-preempt-1k
(perf/fairpreempt.build_fair_preempt) and the panel caps
(``build_fair_wide``); ``drain_fair_phase2`` over the headline fair
drain. Then it times
each recorded launch alone on the device, once per build in turns:
parent, new, new, parent. A spin kernel holds the stream while the host
enqueues the start event, the launch and the end event, so the events
bracket the launch's device time and no host time. The two builds'
outputs are held equal at every launch (int64, tolerance 0).

The parent's ``cycle_global`` takes the argument list it had before its
shared-memory check went (six ints, sixteen pointers): a build that
still exports ``cycle_global_smem_limit`` is called so.

B1's parent build runs a call site as several launches (two entries,
``quota_bottom_up`` and ``quota_top_down``, one recurrence a launch:
two at the drain's site, four at the cycle's); each is timed alone and
their times are summed against the new build's one launch.

``--parent DIR``: a directory holding another build's sources (the
parent commit's ``kueue_tpu_torch/csrc``), built here with the same
nvcc flags. Without it only the current sources are timed (new, new).
``--split``: each build's split too: ``cycle_phase2``, ``drain_phase2``
and ``drain_tas_phase2`` with ``n_steps = 0`` (the order and the ranks,
no walk), ``drain_fair_preempt_phase2`` and ``drain_fair_phase2`` with
``n_steps = 0`` (their staging alone), ``drain_fair_preempt_search``
with ``no_cand`` (the cycle's need_pre cleared, so no slot is a
candidate and every search gives up at its first pick, one a phase:
the staging alone), every drain kernel and the drain's quota site with
the done flag set (the launch's floor), and ``cycle_global`` with every
head made no-fit (chosen and preempt_k -1: the positions alone).
``--kernel NAME``: record and time that kernel only (repeatable).

It also measures the card's shared-memory load latency (one thread
chasing pointers through shared memory; the slope between two chase
lengths, so the launch cancels) and counts each serial launch's chain:
the walked heads of its longest segment (``cycle_global``: of its
longest root cohort, beside all its walked heads; ``drain_tas_phase2``:
every walked head, a shared topology couples them; ``drain_fair_preempt_phase2``
and ``drain_fair_phase2``: the pops of its longest segment, 2(D+1) trips a
pop; ``drain_fair_preempt_search``: the iterations of its longest search,
counted by the plain version, 4(D+1) + 8 trips an iteration). Prints the ptxas lines
(registers, stack frame, spills) of each build, a line per kernel, path
and build, and as its last line a JSON object with every number.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

KERNELS = ("cycle_phase2", "drain_nominate", "quota_tree", "drain_phase2", "drain_tas_phase2",
           "cycle_global", "drain_tas_place", "drain_fair_preempt_search",
           "drain_fair_preempt_phase2", "drain_fair_phase2")
CYCLES = 30  # headline Scheduler cycles recorded (chip_smoke.py's STEADY_CYCLES)
SPIN = 2_000_000  # about 1 ms of the card's clock before each timed launch
CHASE_HOPS = (1 << 20, 1 << 21)
HOPS_PER_HEAD = 2  # a walked head's dependent shared-memory trips: read its rows, add
# a fair victim search iteration's dependent shared-memory trips beyond its
# bubbles' levels: the pick's DRS and cursor reads, the popped candidate,
# the target's path, the two shares, the sums and the new DRS
SEARCH_TRIPS = 8

CHASE_SRC = r"""
#include <cuda_runtime.h>
__global__ void chase(const int* next, int hops, int* out) {
  __shared__ int s[4096];
  for (int i = threadIdx.x; i < 4096; i += blockDim.x) s[i] = next[i];
  __syncthreads();
  if (threadIdx.x != 0) return;
  int j = 0;
  for (int h = 0; h < hops; ++h) j = s[j];
  *out = j;
}
extern "C" int smem_chase(const int* next, int hops, int* out, void* stream) {
  chase<<<1, 128, 0, (cudaStream_t)stream>>>(next, hops, out);
  return (int)cudaGetLastError();
}
"""


def _argtypes():
    return [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def _nvcc(src: Path, lib: Path):
    from kueue_tpu_torch.ops import _build

    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _drain_ints(csrc: Path) -> int:
    """The number of ints a drain kernel of ``csrc`` takes (its
    drain_common.cuh's kNumInts)."""
    text = (csrc / "drain_common.cuh").read_text()
    return int(text.split("constexpr int kNumInts = ")[1].split(";")[0])


def _drain_ptrs(csrc: Path) -> int:
    """The number of pointers a drain kernel of ``csrc`` takes (its
    drain_common.cuh's kNumPtrs, a sum of section sizes): a build with
    fewer takes the first ones, the later sections being appended."""
    text = (csrc / "drain_common.cuh").read_text()
    expr = text.split("constexpr int kNumPtrs = ")[1].split(";")[0]
    return sum(int(x) for x in expr.split("+"))


def build(csrc: Path, out: Path, names=KERNELS) -> dict:
    """Build ``names`` from ``csrc`` into ``out`` (in parallel); returns
    {name: (library, ptxas lines)}. A drain kernel of a build with fewer
    ints than this one's is called with its own count."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {name: _nvcc(csrc / f"{name}.cu", out / f"lib{name}.so") for name in names}
    built = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {csrc / name}.cu:\n{log}")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        lines = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "stack frame" in ln]
        built[name] = (lib, lines)
    built["_drain_ints"] = _drain_ints(csrc)
    built["_drain_ptrs"] = _drain_ptrs(csrc)
    return built


def entry(built: dict, kernel: str, symbol: str = None):
    """The C entry ``symbol`` (default: the kernel's name) of ``built``'s
    library of ``kernel``, taking (ints, n_ints, ptrs, n_ptrs, stream)
    where it is the kernel's own entry."""
    fn = getattr(built[kernel][0], symbol or kernel)
    fn.restype = ctypes.c_int
    if symbol is None or symbol == kernel:
        fn.argtypes = _argtypes()
    if kernel.startswith("drain_"):
        n_ints, n_own = built["_drain_ints"], built["_drain_ptrs"]
        return lambda ints, n, ptrs, n_ptrs, stream: fn(ints, min(n, n_ints), ptrs,
                                                        min(n_ptrs, n_own), stream)
    return fn


@contextlib.contextmanager
def using(built: dict):
    """The wrappers launch ``built``'s entries in place of _build's."""
    from kueue_tpu_torch.ops import _build

    saved = _build.c_function

    def pick(kernel, symbol, argtypes):
        if kernel in built and symbol == kernel:
            return entry(built, kernel)
        return saved(kernel, symbol, argtypes)

    _build.c_function = pick
    try:
        yield
    finally:
        _build.c_function = saved


def _clone(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(
            x, **{f.name: _clone(getattr(x, f.name)) for f in dataclasses.fields(x) if f.init}
        )
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_clone(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    return x


class Timer:
    """Each launch alone on the device (chip_smoke.py's TimedLaunches).
    ``make()`` gives (launches, outputs): each launch is timed alone
    and the times are summed. A launch whose start event had run before
    the host finished enqueuing it (``uncovered``: its time holds host
    time) is timed again on fresh inputs, with a longer spin."""

    def __init__(self):
        self.spin, self.uncovered = SPIN, 0

    def __call__(self, make):
        import torch

        while True:
            fns, outputs = make()
            total, covered, outs = 0.0, True, []
            for fn in fns:
                torch.cuda._sleep(self.spin)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                outs.append(fn())
                end.record()
                covered &= not start.query()
                end.synchronize()
                total += start.elapsed_time(end) * 1e3
            if covered:
                return total, outputs(outs[-1])
            self.uncovered += 1
            self.spin = min(2 * self.spin, 16 * SPIN)


# ---- recording ------------------------------------------------------------


def record_cycles(dev, n: int = CYCLES) -> dict:
    """The arguments of every cycle_phase2 launch and of every quota_all
    call over ``n`` headline cycles (each a copy taken before the
    launch)."""
    from kueue_tpu_torch.ops import assign_kernel as ak
    from kueue_tpu_torch.perf import cycle

    recs = {"cycle_phase2": [], "quota_tree": []}
    orig = (ak.cycle_phase2, ak.quota_all)

    def spy_phase2(*args):
        recs["cycle_phase2"].append(_clone(args))
        return orig[0](*args)

    def spy_quota(tree, local, **kw):
        recs["quota_tree"].append((tree, local.clone()))
        return orig[1](tree, local, **kw)

    ak.cycle_phase2, ak.quota_all = spy_phase2, spy_quota
    try:
        sched, _ = cycle.build_headline_scheduler(device=dev)
        cycle.run_cycles(sched, n)
    finally:
        ak.cycle_phase2, ak.quota_all = orig
    return recs


def _record_drain(ctx, state, buf, steps, names) -> dict:
    """{kernel: [(ctx, state copy, buffers copy)]} before every launch of
    ``names`` in a cycle with work."""
    recs = {name: [] for name in names}
    while not state.done.item():
        for name, kern, _ in steps:
            if name in recs:
                recs[name].append((ctx, state.clone(), buf.clone()))
            kern(ctx, state, buf)
    return recs


def record_drains(dev, kernels) -> dict:
    """{kernel: {path: records}} of the drains' launches of ``kernels``."""
    import torch

    from kueue_tpu_torch.core import drain as pd
    from kueue_tpu_torch.core.snapshot import take_snapshot
    from kueue_tpu_torch.core.solver import tree_arrays
    from kueue_tpu_torch.interop import drain_queues
    from kueue_tpu_torch.ops import drain_kernel as dk
    from kueue_tpu_torch.ops import megaloop_kernel as mk
    from kueue_tpu_torch.perf import contended, fairpreempt as fp, headline, megaloop
    from kueue_tpu_torch.perf.lockstep import (
        FAIR_PREEMPT_STEPS,
        MEGALOOP_STEPS,
        PREEMPT_STEPS,
        STEPS,
    )

    out = {k: {} for k in kernels}
    rng = np.random.default_rng(headline.HEADLINE_SEED)
    cache = headline.build_cluster(rng)
    pending = headline.build_backlog(rng)
    snap = take_snapshot(cache)
    plan = pd.plan_drain(snap, pending, cache.flavors, max_cells=headline.HEADLINE_MAX_CELLS)
    tree, paths, _ = tree_arrays(snap, dev)
    local = torch.as_tensor(snap.local_usage, device=dev)
    queues = drain_queues(plan.queues_np, dev)
    ctx = dk.DrainContext.build(tree, queues, paths, plan.n_segments, plan.n_steps,
                                plan.max_cycles)
    recs = _record_drain(ctx, dk.DrainState.initial(local, queues, plan.max_cycles),
                         dk.CycleBuffers.empty(local, queues), STEPS, kernels)
    for k in kernels:
        out[k]["headline"] = recs[k]

    if "drain_phase2" in kernels:
        bound = megaloop.CHUNK_CYCLES * megaloop.MAX_ROUNDS
        mctx = dk.DrainContext.build(
            tree, queues, paths, plan.n_segments, plan.n_steps, bound,
            chunk_cycles=megaloop.CHUNK_CYCLES, max_rounds=megaloop.MAX_ROUNDS)
        cap = torch.as_tensor(pd._cap_suffix_of(plan), device=dev)
        state = mk.MegaloopState.initial_rounds(local, queues, cap, megaloop.MAX_ROUNDS)
        recs = _record_drain(mctx, state, dk.CycleBuffers.empty(local, queues),
                             MEGALOOP_STEPS, ("drain_phase2",))
        out["drain_phase2"]["megaloop"] = recs["drain_phase2"]

    if "drain_nominate" not in kernels:
        return out
    env = contended.build_contended(np.random.default_rng(contended.SEED))
    plan, _, tree, paths, local, queues, victims = pd.preempt_drain_inputs(
        take_snapshot(env.cache), env.pending, env.cache.flavors, dev, timestamp_fn=env.ts_fn)
    recs = []
    for width in contended.CONTENDED_PANELS["widths"]:
        ctx = dk.DrainContext.build(
            tree, queues, paths, plan.n_segments, plan.n_steps, plan.max_cycles,
            preempt=dk.PreemptInputs(victims=victims, search_width=int(width)))
        recs += _record_drain(ctx, dk.PreemptState.initial_preempt(local, queues,
                                                                   plan.max_cycles, victims),
                              dk.PreemptBuffers.empty_preempt(local, queues, victims),
                              PREEMPT_STEPS, ("drain_nominate",))["drain_nominate"]
    out["drain_nominate"]["contended"] = recs

    wenv = fp.build_fair_wide(np.random.default_rng(fp.WIDE_SEED))
    plan, _, tree, paths, local, queues, victims, panels, fair = pd.fair_preempt_drain_inputs(
        take_snapshot(wenv.cache), wenv.pending, wenv.cache.flavors, dev,
        timestamp_fn=wenv.ts_fn)
    ctx = dk.fair_preempt_context(tree, queues, victims, panels, paths, fair, plan.n_segments,
                                  plan.n_steps, plan.max_cycles, 0, True)
    out["drain_nominate"]["caps"] = _record_drain(
        ctx, dk.FairPreemptState.initial_fair(local, queues, plan.max_cycles, victims, panels),
        dk.PreemptBuffers.empty_preempt(local, queues, victims), FAIR_PREEMPT_STEPS,
        ("drain_nominate",))["drain_nominate"]
    return out


def record_tas(dev, names=("drain_tas_phase2",)) -> dict:
    """{kernel: [(ctx, state copy, buffers copy)]} before every launch of
    ``names`` with work of tas-drain-10k."""
    from kueue_tpu_torch.core import drain as pd
    from kueue_tpu_torch.core.snapshot import take_snapshot
    from kueue_tpu_torch.ops import drain_kernel as dk
    from kueue_tpu_torch.perf import tas as pt
    from kueue_tpu_torch.perf.lockstep import TAS_STEPS

    env = pt.build_tas_drain(np.random.default_rng(pt.TAS_DRAIN_SEED))
    inp = pd.tas_drain_inputs(take_snapshot(env.cache), env.pending, env.cache.flavors, env.tas,
                              dev, timestamp_fn=env.ts_fn)
    ctx = dk.tas_context(inp.tree, inp.queues, inp.paths, inp.topo.free, inp.topo.seg_ids,
                         inp.theads, inp.n_domains, inp.n_steps, inp.plan.max_cycles)
    state = dk.TASState.initial_tas(inp.local, inp.queues, inp.plan.max_cycles,
                                    inp.topo.tas_usage)
    buf = dk.TASBuffers.empty_tas(inp.local, inp.queues, inp.topo.free.shape[0])
    return _record_drain(ctx, state, buf, TAS_STEPS, names)


def record_fair_preempt(dev, names=("drain_fair_preempt_phase2",)) -> dict:
    """{kernel: {path: records}} of ``names`` (the fair-preempt drain's
    search and step scan) over fair-preempt-1k and the panel caps."""
    from kueue_tpu_torch.core import drain as pd
    from kueue_tpu_torch.core.snapshot import take_snapshot
    from kueue_tpu_torch.ops import drain_kernel as dk
    from kueue_tpu_torch.perf import fairpreempt as fp
    from kueue_tpu_torch.perf.lockstep import FAIR_PREEMPT_STEPS

    out = {k: {} for k in names}
    for label, env in (("fair-preempt-1k", fp.build_fair_preempt(1000)),
                       ("caps", fp.build_fair_wide(np.random.default_rng(fp.WIDE_SEED)))):
        plan, _, tree, paths, local, queues, victims, panels, fair = (
            pd.fair_preempt_drain_inputs(take_snapshot(env.cache), env.pending,
                                         env.cache.flavors, dev, timestamp_fn=env.ts_fn))
        ctx = dk.fair_preempt_context(tree, queues, victims, panels, paths, fair,
                                      plan.n_segments, plan.n_steps, plan.max_cycles, 0, True)
        recs = _record_drain(
            ctx, dk.FairPreemptState.initial_fair(local, queues, plan.max_cycles, victims, panels),
            dk.PreemptBuffers.empty_preempt(local, queues, victims), FAIR_PREEMPT_STEPS, names)
        for k in names:
            out[k][label] = recs[k]
    return out


def record_fair(dev) -> list:
    """Records of drain_fair_phase2 (B7) over the headline fair drain, as
    run_drain(fair_sharing=True) builds it."""
    from kueue_tpu_torch.core import drain as pd
    from kueue_tpu_torch.core.snapshot import take_snapshot
    from kueue_tpu_torch.ops import drain_kernel as dk
    from kueue_tpu_torch.perf import headline
    from kueue_tpu_torch.perf.lockstep import FAIR_STEPS

    rng = np.random.default_rng(headline.HEADLINE_SEED)
    cache = headline.build_cluster(rng)
    pending = headline.build_backlog(rng)
    snap = take_snapshot(cache)
    plan = pd.plan_drain(snap, pending, cache.flavors, max_cells=headline.HEADLINE_MAX_CELLS)
    pd._route_preempt_capable(snap, plan)
    tree, paths, local, queues = pd._drain_device_inputs(snap, plan, dev)
    fair = pd.fair_inputs(snap, tree.max_depth, dev)
    ctx = dk.DrainContext.build(tree, queues, paths, plan.n_segments, plan.n_steps,
                                plan.max_cycles, seg_id=plan.queues_np["seg_id"], fair=fair)
    return _record_drain(ctx, dk.DrainState.initial(local, queues, plan.max_cycles),
                         dk.CycleBuffers.empty(local, queues), FAIR_STEPS,
                         ("drain_fair_phase2",))["drain_fair_phase2"]


# ---- the launches ---------------------------------------------------------
#
# make(record, variant, built) -> (launches, outputs getter); variant is
# None (the launch as recorded) or a split: "n_steps=0" or "done".


def chain_heads(rec) -> int:
    """Walked heads of a cycle_phase2 launch's longest segment: the heads
    with an effective candidate, a ClusterQueue and a segment below
    n_segments, at most n_steps a segment (the JAX mode="drop" rule)."""
    _, _, _, _, _, heads, seg_t, _, n_segments, n_steps, chosen, _, pk = rec
    seg = seg_t.cpu().numpy()
    walked = ((chosen >= 0) | (pk >= 0)).cpu().numpy() & (heads.cq_row >= 0).cpu().numpy()
    walked &= (seg >= 0) & (seg < n_segments)
    counts = np.bincount(seg[walked], minlength=1)
    return int(min(int(counts.max()), n_steps))


def drain_chain_heads(rec) -> int:
    """Walked heads of a drain_phase2 launch's longest segment: its
    nominated, active queues of a segment below n_segments, at most
    n_steps a segment."""
    ctx, state, buf = rec
    q = ctx.queues
    seg = q.seg_id.cpu().numpy()
    active = ((state.cursor < q.qlen) & state.alive).cpu().numpy()
    walked = (buf.is_fit | buf.is_pre).cpu().numpy() & active
    walked &= (seg >= 0) & (seg < ctx.n_segments)
    counts = np.bincount(seg[walked], minlength=1)
    return int(min(int(counts.max()), ctx.n_steps))


def root_chain_heads(rec) -> int:
    """Walked heads of a cycle_global launch's longest root cohort (the
    cycle's root segments, no segment or step dropped)."""
    _, _, _, _, _, heads, seg_t, _, _, _, chosen, _, pk = rec
    seg = seg_t.cpu().numpy()
    walked = ((chosen >= 0) | (pk >= 0)).cpu().numpy() & (heads.cq_row >= 0).cpu().numpy()
    return int(np.bincount(seg[walked & (seg >= 0)], minlength=1).max())


def all_walked_heads(rec) -> int:
    """Every walked head of a cycle's heads: the chain the parent's
    cycle_global walked, one warp over all of them."""
    _, _, _, _, _, heads, _, _, _, _, chosen, _, pk = rec
    return int((((chosen >= 0) | (pk >= 0)) & (heads.cq_row >= 0)).sum().item())


def fair_pops(rec) -> int:
    """Pops of a drain_fair_preempt_phase2 launch's longest segment: its
    heads taking part in the tournament (active, nominated, on a
    ClusterQueue), at most n_steps."""
    ctx, state, buf = rec
    q = ctx.queues
    seg = q.seg_id.cpu().numpy()
    rem = ((buf.is_fit | buf.is_pre) & (state.cursor < q.qlen) & state.alive
           & (q.cq_rows >= 0)).cpu().numpy()
    rem &= (seg >= 0) & (seg < ctx.segments.count)
    counts = np.bincount(seg[rem], minlength=1)
    return int(min(int(counts.max()), ctx.n_steps))


def search_iterations(rec) -> int:
    """Tournament iterations of a drain_fair_preempt_search launch's
    longest search, counted by its plain version on a copy."""
    from kueue_tpu_torch.ops import drain_kernel as dk
    from kueue_tpu_torch.ops import fair_preempt_kernel as fpk

    ctx, state, buf = rec
    counts = []

    def counted(p, *args):
        trace = {}
        out = fpk.solve_fair(p, *args, trace=trace)
        iters = trace["iterations"]
        counts.append(int(iters.max().item()) if iters.numel() else 0)
        return out

    saved = dk.solve_fair
    dk.solve_fair = counted
    try:
        dk.drain_fair_preempt_search_plain(ctx, state.clone(), buf.clone())
    finally:
        dk.solve_fair = saved
    return max(counts, default=0)


def tas_chain_heads(rec) -> int:
    """Walked heads of a drain_tas_phase2 launch: its nominated, active
    queues on a ClusterQueue, at most n_steps (one global scan)."""
    ctx, state, buf = rec
    q = ctx.queues
    walked = (buf.is_fit | buf.is_pre) & (state.cursor < q.qlen) & state.alive & (q.cq_rows >= 0)
    return int(min(int(walked.sum().item()), ctx.n_steps))


def cycle_launch(rec, variant, built):
    """One cycle_phase2 launch on a fresh copy of its usage tree."""
    from kueue_tpu_torch.ops import assign_kernel as ak

    args = list(rec)
    args[3] = rec[3].clone()
    if variant == "n_steps=0":
        args[9] = 0
    return [lambda: ak.cycle_phase2(*args)], lambda packed: (packed, args[3])


def _drain_launch(kernel):
    def make(rec, variant, built):
        from kueue_tpu_torch.ops import drain_kernel as dk

        ctx, state, buf = rec
        state, buf = state.clone(), buf.clone()
        if variant == "done":
            state.done.fill_(1)
        if variant == "no_cand":
            buf.need_pre.zero_()
        if variant == "n_steps=0":
            ctx = dataclasses.replace(ctx, n_steps=0, _args=None)

        def outputs(_):
            return tuple(getattr(x, f.name) for x in (state, buf)
                         for f in dataclasses.fields(x)
                         if getattr(x, f.name) is not None and f.name != "order")

        return [lambda: getattr(dk, kernel)(ctx, state, buf)], outputs

    return make


nominate_launch = _drain_launch("drain_nominate")
phase2_launch = _drain_launch("drain_phase2")
tas_phase2_launch = _drain_launch("drain_tas_phase2")
tas_place_launch = _drain_launch("drain_tas_place")
fair_preempt_launch = _drain_launch("drain_fair_preempt_phase2")
fair_search_launch = _drain_launch("drain_fair_preempt_search")
fair_launch = _drain_launch("drain_fair_phase2")


def _old_global(built, tree, sub, g, usage, paths, heads, chosen, borrows, pk):
    """The parent's cycle_global entry (six ints, sixteen pointers: the
    whole usage tree in one block's shared memory)."""
    import torch

    w, k, c = heads.cells.shape
    n, fr = tree.nominal.shape
    packed = torch.empty((5, w), dtype=torch.int64, device=usage.device)
    tensors = (heads.cq_row, heads.cells, heads.qty, heads.priority, heads.timestamp,
               heads.no_reclaim, chosen, borrows, pk, tree.nominal, tree.borrowing_limit, sub,
               g, paths, usage, packed)
    ints = (ctypes.c_int * 6)(w, k, c, n, fr, tree.max_depth)
    ptrs = (ctypes.c_void_p * 16)(*(t.data_ptr() for t in tensors))
    fn, stream = entry(built, "cycle_global"), _stream(usage)

    def call():
        rc = fn(ctypes.addressof(ints), 6, ctypes.addressof(ptrs), 16, stream)
        if rc != 0:
            raise RuntimeError(f"the parent's cycle_global failed: cudaError {rc}")
        return packed
    return call


def global_launch(rec, variant, built):
    """One cycle_global launch on the heads of a recorded cycle_phase2
    launch, on a fresh copy of its usage tree; "positions": every head
    no-fit, so nothing is walked."""
    import torch

    from kueue_tpu_torch.ops import assign_kernel as ak

    tree, sub, g, usage, paths, heads = rec[:6]
    chosen, borrows, pk = rec[10:13]
    if variant == "positions":
        chosen, pk = torch.full_like(chosen, -1), torch.full_like(pk, -1)
    u = usage.clone()
    args = (tree, sub, g, u, paths, heads, chosen, borrows, pk)
    if hasattr(built["cycle_global"][0], "cycle_global_smem_limit"):
        fn = _old_global(built, *args)
    else:
        fn = lambda: ak.cycle_global(*args)  # noqa: E731
    return [fn], lambda packed: (packed, u)


def _views(like, names):
    import torch

    return {name: torch.empty_like(like) for name in names}


def _stream(t) -> int:
    from kueue_tpu_torch.ops import _build

    return _build.stream_ptr(t.device)


def _old_quota(built, rows, *launches):
    """B1's parent entries: each launch (symbol, mode, (tensor, ...)) on
    ``rows`` = (parent, level_mask, n, fr, max_depth), one recurrence a
    launch, its pointers as the old C signature takes them (None =
    NULL)."""
    fns = []
    for symbol, mode, tensors in launches:
        fn = entry(built, "quota_tree", symbol)
        ptrs = [None if t is None else t.data_ptr() for t in tensors]
        parent, level_mask, n, fr, d = rows

        def call(fn=fn, mode=mode, ptrs=ptrs, stream=_stream(parent)):
            rc = fn(ctypes.c_int(mode), ctypes.c_void_p(parent.data_ptr()),
                    ctypes.c_void_p(level_mask.data_ptr()), ctypes.c_int(n),
                    ctypes.c_int(fr), ctypes.c_int(d),
                    *(ctypes.c_void_p(x) for x in ptrs), ctypes.c_void_p(stream))
            if rc != 0:
                raise RuntimeError(f"the parent's quota_tree failed: cudaError {rc}")
        fns.append(call)
    return fns


def _new_abi(built) -> bool:
    return hasattr(built["quota_tree"][0], "quota_tree")


def quota_drain_launch(rec, variant, built):
    """The drain cycle's quota call site: usage_tree then available_all
    on the recorded state; one launch in a build with the fused entry,
    two in the parent's."""
    from kueue_tpu_torch.ops import quota

    ctx, state, buf = rec
    done = state.done.clone()
    if variant == "done":
        done.fill_(1)
    usage, avail = buf.usage.clone(), buf.avail.clone()
    outputs = lambda _: (usage, avail)  # noqa: E731
    if _new_abi(built):
        return [lambda: quota.usage_and_available(
            ctx.tree, ctx.subtree, ctx.guaranteed, state.local, usage, avail, done)], outputs
    t = ctx.tree
    rows = (t.parent, t.level_mask, t.n_nodes, t.nominal.shape[1], t.max_depth)
    return _old_quota(
        built, rows,
        ("quota_bottom_up", 1, (state.local, ctx.guaranteed, usage, None, done)),
        ("quota_top_down", 0, (ctx.subtree, ctx.guaranteed, t.borrowing_limit, usage, avail,
                               done)),
    ), outputs


def quota_cycle_launch(rec, variant, built):
    """The cycle's quota call site: all four recurrences from the tree
    and the leaf usage; one launch in a build with the fused entry, four
    in the parent's."""
    from kueue_tpu_torch.ops import quota

    tree, local = rec
    names = ("subtree", "guaranteed", "usage", "avail", "potential")
    v = _views(local, names)
    outputs = lambda _: tuple(v[k] for k in names)  # noqa: E731
    if _new_abi(built):
        return [lambda: quota._launch(
            tree, quota.SUBTREE | quota.USAGE | quota.AVAIL | quota.POTENTIAL, local=local,
            **v)], outputs
    rows = (tree.parent, tree.level_mask, tree.n_nodes, tree.nominal.shape[1], tree.max_depth)
    bl = tree.borrowing_limit
    return _old_quota(
        built, rows,
        ("quota_bottom_up", 0, (tree.nominal, tree.lending_limit, v["subtree"],
                                v["guaranteed"], None)),
        ("quota_bottom_up", 1, (local, v["guaranteed"], v["usage"], None, None)),
        ("quota_top_down", 0, (v["subtree"], v["guaranteed"], bl, v["usage"], v["avail"],
                               None)),
        ("quota_top_down", 1, (v["subtree"], v["guaranteed"], bl, None, v["potential"],
                               None)),
    ), outputs


def time_path(records, make, builds: dict, order, variant) -> dict:
    """Each record's launches once per entry of ``order`` (build names),
    outputs held equal across builds; {build: mean us, median, max}."""
    import torch

    timer = Timer()
    us = {name: [] for name in builds}
    for rec in records:
        ref = None
        for name in order:
            with using(builds[name]):
                t, res = timer(lambda: make(rec, variant, builds[name]))
            us[name].append(t)
            got = [x.to(torch.int64) for x in res]
            if ref is None:
                ref = got
            elif any(not torch.equal(a, b) for a, b in zip(ref, got)):
                raise SystemExit(f"kernel_ab: build {name} differs from build {order[0]}")
    return {name: float(np.mean(v)) for name, v in us.items()} | {
        f"{name} median": float(np.median(v)) for name, v in us.items()} | {
        f"{name} max": float(np.max(v)) for name, v in us.items()} | {
        "uncovered, timed again": timer.uncovered}


def smem_latency_ns(dev, work: Path) -> float:
    """ns per dependent shared-memory load: the slope of a one-thread
    pointer chase between two lengths (a random cycle of 4096 entries)."""
    import torch

    src, lib = work / "smem_chase.cu", work / "libsmem_chase.so"
    src.write_text(CHASE_SRC)
    proc = _nvcc(src, lib)
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the chase:\n{log}")
    fn = ctypes.CDLL(str(lib)).smem_chase
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    perm = np.random.default_rng(0).permutation(4096)
    nxt = np.empty(4096, dtype=np.int32)
    nxt[perm] = np.roll(perm, -1)
    nxt_t = torch.as_tensor(nxt, device=dev)
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ms = {}
    for hops in CHASE_HOPS * 3:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if fn(nxt_t.data_ptr(), hops, out.data_ptr(), stream) != 0:
            raise RuntimeError("the chase did not launch")
        end.record()
        end.synchronize()
        ms.setdefault(hops, []).append(start.elapsed_time(end))
    lo, hi = CHASE_HOPS
    return (min(ms[hi]) - min(ms[lo])) * 1e6 / (hi - lo)


# each kernel's splits with --split (quota_tree's drain call site: "done")
SPLITS = {"cycle_phase2": ("n_steps=0",), "drain_nominate": ("done",),
          "drain_phase2": ("n_steps=0", "done"), "drain_tas_phase2": ("n_steps=0", "done"),
          "cycle_global": ("positions",), "drain_tas_place": ("done",),
          "drain_fair_preempt_search": ("no_cand", "done"),
          "drain_fair_preempt_phase2": ("n_steps=0", "done"),
          "drain_fair_phase2": ("n_steps=0", "done")}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="the parent build's csrc directory")
    ap.add_argument("--split", action="store_true", help="also time each kernel's split")
    ap.add_argument("--kernel", choices=KERNELS, action="append",
                    help="time this kernel only (repeatable)")
    args = ap.parse_args(argv)
    kernels = tuple(args.kernel or KERNELS)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    from kueue_tpu_torch.ops import _build

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card)
    work = Path(tempfile.mkdtemp(prefix="kernel_ab-"))
    t0 = time.perf_counter()
    builds = {"new": build(_build.CSRC, work / "new", kernels)}
    if args.parent is not None:
        builds["parent"] = build(args.parent.resolve(), work / "parent", kernels)
    print(f"built {sorted(builds)} in {time.perf_counter() - t0:.1f} s")
    for bname, built in builds.items():
        for kname in kernels:
            for ln in built[kname][1]:
                print(f"  {bname} {kname}: {ln}")
    order = ["parent", "new", "new", "parent"] if "parent" in builds else ["new", "new"]
    _build.load(_build.KERNELS)  # the other kernels the recording runs

    t0 = time.perf_counter()
    cyc = (record_cycles(dev) if {"cycle_phase2", "quota_tree", "cycle_global"} & set(kernels)
           else {})
    drain_kernels = tuple(k for k in ("drain_nominate", "quota_tree", "drain_phase2")
                          if k in kernels)
    drains = record_drains(dev, drain_kernels) if drain_kernels else {}
    paths = []
    if "cycle_phase2" in kernels:
        paths.append(("cycle_phase2", "headline cycles", cyc["cycle_phase2"], cycle_launch))
    if "quota_tree" in kernels:
        paths.append(("quota_tree", "headline drain call site", drains["quota_tree"]["headline"],
                      quota_drain_launch))
        paths.append(("quota_tree", "headline cycle call site", cyc["quota_tree"],
                      quota_cycle_launch))
    for label, recs in drains.get("drain_nominate", {}).items():
        paths.append(("drain_nominate", f"{label} drain", recs, nominate_launch))
    for label, recs in drains.get("drain_phase2", {}).items():
        paths.append(("drain_phase2", f"{label} drain", recs, phase2_launch))
    tas_names = tuple(k for k in ("drain_tas_place", "drain_tas_phase2") if k in kernels)
    tas_recs = record_tas(dev, tas_names) if tas_names else {}
    tas = tas_recs.get("drain_tas_phase2", [])
    if tas:
        paths.append(("drain_tas_phase2", "tas-drain-10k", tas, tas_phase2_launch))
    if "drain_tas_place" in tas_recs:
        paths.append(("drain_tas_place", "tas-drain-10k", tas_recs["drain_tas_place"],
                      tas_place_launch))
    fp_names = tuple(k for k in ("drain_fair_preempt_search", "drain_fair_preempt_phase2")
                     if k in kernels)
    fpre = record_fair_preempt(dev, fp_names) if fp_names else {}
    for label, recs in fpre.get("drain_fair_preempt_search", {}).items():
        paths.append(("drain_fair_preempt_search", label, recs, fair_search_launch))
    for label, recs in fpre.get("drain_fair_preempt_phase2", {}).items():
        paths.append(("drain_fair_preempt_phase2", label, recs, fair_preempt_launch))
    fair = record_fair(dev) if "drain_fair_phase2" in kernels else []
    if fair:
        paths.append(("drain_fair_phase2", "headline fair drain", fair, fair_launch))
    if "cycle_global" in kernels:
        paths.append(("cycle_global", "headline cycles", cyc["cycle_phase2"], global_launch))
    print(f"recorded {[(k, label, len(r)) for k, label, r, _ in paths]} "
          f"({time.perf_counter() - t0:.1f} s)")
    lat = smem_latency_ns(dev, work)
    result = {"card": card, "smem_latency_ns": lat, "ptxas": {
        b: {k: built[k][1] for k in kernels} for b, built in builds.items()},
        "chains": {}, "times_us": {}}
    print(f"shared-memory load latency {lat:.3f} ns")
    chain_paths = [("drain_phase2", f"{label} drain", recs, drain_chain_heads)
                   for label, recs in drains.get("drain_phase2", {}).items()]
    # B11b and B7: 2(D+1) dependent trips a pop (its chain's levels, then
    # the charge bubbled up its path); B11a: 4(D+1) + 8 an iteration
    chain_paths += [("drain_fair_preempt_phase2", label, recs, fair_pops)
                    for label, recs in fpre.get("drain_fair_preempt_phase2", {}).items()]
    if fair:
        chain_paths.append(("drain_fair_phase2", "headline fair drain", fair, fair_pops))
    chain_paths += [("drain_fair_preempt_search", label, recs, search_iterations)
                    for label, recs in fpre.get("drain_fair_preempt_search", {}).items()]
    if "cycle_phase2" in kernels:
        chain_paths.append(("cycle_phase2", "headline cycles", cyc["cycle_phase2"], chain_heads))
    if "cycle_global" in kernels:
        chain_paths += [("cycle_global", "headline cycles, longest root", cyc["cycle_phase2"],
                         root_chain_heads),
                        ("cycle_global", "headline cycles, every walked head",
                         cyc["cycle_phase2"], all_walked_heads)]
    if tas:
        chain_paths.append(("drain_tas_phase2", "tas-drain-10k", tas, tas_chain_heads))
    for kname, label, recs, count in chain_paths:
        chains = [count(r) for r in recs] or [0]
        hops = HOPS_PER_HEAD
        if kname.startswith("drain_fair") and recs:
            d1 = recs[0][0].tree.max_depth + 1
            hops = 4 * d1 + SEARCH_TRIPS if kname == "drain_fair_preempt_search" else 2 * d1
        chain_us = float(np.mean(chains)) * hops * lat * 1e-3
        result["chains"][f"{kname} [{label}]"] = {"heads": chains, "bound_us": chain_us,
                                                   "trips": hops}
        print(f"{kname} [{label}]: the longest segments walk {float(np.mean(chains)):.2f} "
              f"heads (max {max(chains)}): chain bound {chain_us:.4f} us a launch "
              f"({hops} trips a head)")

    for kname, label, recs, make in paths:
        splits = SPLITS.get(kname, ())
        if kname == "quota_tree" and "drain" in label:
            splits = ("done",)
        for variant in (None,) + (splits if args.split else ()):
            key = f"{kname} [{label}{', ' + variant if variant else ''}]"
            res = time_path(recs, make, builds, order, variant)
            result["times_us"][key] = res | {"launches": len(recs)}
            print(f"{key}: {len(recs)} launches, " + ", ".join(
                f"{b} {res[b]:.2f} us (median {res[b + ' median']:.2f}, max "
                f"{res[b + ' max']:.2f})" for b in builds)
                + f"; {res['uncovered, timed again']} uncovered, timed again")
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
