"""Two builds of a kernel timed side by side on one card: B3
(``cycle_phase2``), B4's nomination (``drain_nominate``), B1
(``quota_tree``, per call site), B4's phase 2 (``drain_phase2``), the TAS
drain's step scan (``drain_tas_phase2``, B13) and placement
(``drain_tas_place``, B13a), the unsegmented cycle's walk
(``cycle_global``, B3'), the fair-preempt drain's victim search
(``drain_fair_preempt_search``, B11a) and step scan
(``drain_fair_preempt_phase2``, B11b), the fair drain's (B7,
``drain_fair_phase2``), the preempt drain's step scan
(``drain_preempt_phase2``, B10b), victim search (``drain_preempt_search``,
B10a) and cycle end (``drain_preempt_motion``, B10c), and the planner's
order and walk (``plan_phase2``).

    python -m kueue_tpu_torch.perf.kernel_ab [--parent DIR] [--split]
                                             [--kernel NAME ...]

Run from the repository root on a machine with one CUDA card and nvcc.
It records the inputs of every launch with work of the chosen kernels:
``cycle_phase2`` and the cycle's quota call site (``quota_all``) over
the headline cycles (perf/cycle.py's Scheduler, ``CYCLES`` cycles);
``drain_nominate`` over three drains (the headline plain drain, the
contended preempt drain at each panel width of its schedule (a path
each), the
fair-preempt drain at the panel caps, ``build_fair_wide``); the drain's
quota call site (``usage_and_available``) and ``drain_phase2`` over the
headline plain drain, and ``drain_phase2`` also over the first launch of
the headline's megaloop chain (perf/megaloop.py's rounds); ``drain_tas_place``
and ``drain_tas_phase2`` over tas-drain-10k; ``drain_fair_preempt_search``
and ``drain_fair_preempt_phase2`` over fair-preempt-1k
(perf/fairpreempt.build_fair_preempt) and the panel caps
(``build_fair_wide``); ``drain_fair_phase2`` over the headline fair
drain; ``drain_preempt_phase2`` and ``drain_preempt_search`` over the
contended preempt drain at each panel width of its schedule (a path
each); ``drain_preempt_motion`` over the contended drain at each width,
fair-preempt-1k and the panel caps; ``plan_phase2`` over the one B14 call of
``Planner.plan`` at planner-sweep-50k and at planner-stage-500. Then it
times
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
the done flag set (the launch's floor), ``cycle_global`` with every
head made no-fit (chosen and preempt_k -1: the positions alone),
``drain_preempt_phase2`` with ``n_steps = 0`` (its staging and ranking
alone) and ``done``, ``drain_preempt_search`` with ``no_cand`` (need_pre
cleared: the staging and eligibility, no ladder) and ``done``,
``drain_preempt_motion`` with ``alive=0`` (every queue retired: the
eviction pass and the reductions, the queue pass reduced to its flags)
and ``done``, and ``plan_phase2`` as the device time of its
launches by part, read from a ``torch.profiler`` trace of each recorded
call: the entry order (every launch but the walk's) and the walk
(launches whose kernel name holds ``walk``), beside a stable
``torch.argsort`` lexsort of the same keys (the plain version's
``_lexsort_rows``, timed alone; a yardstick for the sort, used on no
path).
``--kernel NAME``: record and time that kernel only (repeatable).

It also measures the card's shared-memory load latency (one thread
chasing pointers through shared memory; the slope between two chase
lengths, so the launch cancels) and counts each serial launch's chain:
the walked heads of its longest segment (``cycle_global``: of its
longest root cohort, beside all its walked heads; ``drain_tas_phase2``:
every walked head, a shared topology couples them; ``drain_fair_preempt_phase2``
and ``drain_fair_phase2``: the pops of its longest segment, 2(D+1) trips a
pop; ``drain_fair_preempt_search``: the iterations of its longest search,
counted by the plain version, 4(D+1) + 8 trips an iteration;
``drain_preempt_phase2``: two trips a walked head of its longest
segment and two more a preempter among them, which removes its victims
first; ``drain_preempt_search``: the removal and fill-back steps of its
longest search, both attempts, counted by the plain version, (D+1) + 5
trips a step (the owner row, the owner vote, the candidate's usage and
path, the bubble a level, the fit's reads and vote);
``drain_preempt_motion``: seven dependent trips to the L2 cache, timed by
a chase through device memory (the done flag, a slot's eviction byte or
a queue's scalars, its cells or statuses, the writes and atomics, the
ticket, the last block's reads of the partials, its writes);
``plan_phase2``: the longest (segment, scenario) walk's heads).
Prints the ptxas lines
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
           "drain_fair_preempt_phase2", "drain_fair_phase2", "drain_preempt_phase2",
           "plan_phase2", "drain_preempt_search", "drain_preempt_motion")
CYCLES = 30  # headline Scheduler cycles recorded (chip_smoke.py's STEADY_CYCLES)
SPIN = 2_000_000  # about 1 ms of the card's clock before each timed launch
CHASE_HOPS = (1 << 20, 1 << 21)
HOPS_PER_HEAD = 2  # a walked head's dependent shared-memory trips: read its rows, add
# a fair victim search iteration's dependent shared-memory trips beyond its
# bubbles' levels: the pick's DRS and cursor reads, the popped candidate,
# the target's path, the two shares, the sums and the new DRS
SEARCH_TRIPS = 8
# a preempt search step's dependent shared-memory trips beyond its bubble's
# levels: the owner row, the owner vote, the candidate's usage and path,
# the fit's reads and its vote
LADDER_TRIPS = 5
MOTION_L2_TRIPS = 7  # drain_preempt_motion's dependent trips to the L2 cache

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
// the same chase through device memory, past the L1 (the loads hit L2)
__global__ void chase_l2(const int* next, int hops, int* out) {
  int j = 0;
  for (int h = 0; h < hops; ++h) j = __ldcg(next + j);
  *out = j;
}
extern "C" int l2_chase(const int* next, int hops, int* out, void* stream) {
  chase_l2<<<1, 1, 0, (cudaStream_t)stream>>>(next, hops, out);
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


def _entry_ptrs(csrc: Path, kernel: str) -> int:
    """The number of pointers ``csrc``'s plan_phase2 or cycle_global
    takes (an older build takes fewer scratch pointers, the last ones)."""
    text = (csrc / f"{kernel}.cu").read_text()
    if "n_ptrs != " not in text:  # an entry with its own argument list
        return 1 << 30
    return int(text.split("n_ptrs != ")[1].split(")")[0])


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
    for k in ("plan_phase2", "cycle_global"):
        built[f"_{k}_ptrs"] = _entry_ptrs(csrc, k)
    return built


def entry(built: dict, kernel: str, symbol: str = None):
    """The C entry ``symbol`` (default: the kernel's name) of ``built``'s
    library of ``kernel``, taking (ints, n_ints, ptrs, n_ptrs, stream)
    where it is the kernel's own entry."""
    fn = getattr(built[kernel][0], symbol or kernel)
    fn.restype = ctypes.c_int
    if symbol is None or symbol == kernel:
        fn.argtypes = _argtypes()
    if kernel in ("plan_phase2", "cycle_global"):
        n_own = built[f"_{kernel}_ptrs"]
        return lambda ints, n, ptrs, n_ptrs, stream: fn(ints, n, ptrs, min(n_ptrs, n_own),
                                                        stream)
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
        if k in ("drain_nominate", "quota_tree", "drain_phase2"):  # a plain drain's kernels
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

    pre_names = tuple(k for k in ("drain_nominate", "drain_preempt_phase2", "drain_preempt_search",
                                  "drain_preempt_motion") if k in kernels)
    if not pre_names:
        return out
    env = contended.build_contended(np.random.default_rng(contended.SEED))
    plan, _, tree, paths, local, queues, victims = pd.preempt_drain_inputs(
        take_snapshot(env.cache), env.pending, env.cache.flavors, dev, timestamp_fn=env.ts_fn)
    for width in contended.CONTENDED_PANELS["widths"]:
        ctx = dk.DrainContext.build(
            tree, queues, paths, plan.n_segments, plan.n_steps, plan.max_cycles,
            preempt=dk.PreemptInputs(victims=victims, search_width=int(width)))
        tier = _record_drain(ctx, dk.PreemptState.initial_preempt(local, queues,
                                                                  plan.max_cycles, victims),
                             dk.PreemptBuffers.empty_preempt(local, queues, victims),
                             PREEMPT_STEPS, pre_names)
        for k in pre_names:
            out[k][f"contended drain at width {width}"] = tier[k]
    if "drain_nominate" not in kernels:
        return out

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


def record_plans(dev) -> dict:
    """{path: [plan_phase2 arguments]}: the one plan_phase2 call of
    ``Planner.plan`` at planner-sweep-50k and at planner-stage-500 (its
    usage trees copied before the launch)."""
    from kueue_tpu_torch.core.snapshot import take_snapshot
    from kueue_tpu_torch.ops import plan_kernel as plk
    from kueue_tpu_torch.perf import planner as pp

    out = {}
    saved = plk.plan_phase2
    for label, build in (("planner-sweep-50k", lambda: pp.build_sweep(
            np.random.default_rng(pp.SWEEP_SEED), device=dev)),
            ("planner-stage-500", lambda: pp.build_stage(device=dev))):
        planner, scens, cache, _ = build()
        recs = []

        def spy(*args, **kw):
            kw = dict(kw)
            kw.pop("out", None)
            recs.append((_clone(args), kw))
            return saved(*args, **kw)

        plk.plan_phase2 = spy
        try:
            planner.plan(scenarios=scens, heads_mode="backlog", include_reasons="none")
        finally:
            plk.plan_phase2 = saved
        out[label] = recs
    return out


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


def ladder_steps(rec) -> int:
    """Removal and fill-back steps of a drain_preempt_search launch's
    longest search (both attempts of a head), counted by its plain
    version on a copy."""
    from kueue_tpu_torch.ops import drain_kernel as dk
    from kueue_tpu_torch.ops import preempt_kernel as pk

    ctx, state, buf = rec
    steps = []

    def counted(p, depth, n_cand):
        trace = {}
        out = pk.solve_preempt(p, depth, n_cand, trace=trace)
        steps.append(trace["steps"])
        return out

    saved = dk.solve_preempt
    dk.solve_preempt = counted
    try:
        dk.drain_preempt_search_plain(ctx, state.clone(), buf.clone())
    finally:
        dk.solve_preempt = saved
    return int(sum(steps).max().item()) if steps else 0


def preempt_chain_trips(rec) -> int:
    """Dependent shared-memory trips of a drain_preempt_phase2 launch's
    longest segment: two a walked head (read its path's rows, add) and
    two more a preempter among them (its victims' rows read, then
    removed); walked heads are the nominated, active queues, at most
    n_steps a segment in entry order."""
    ctx, state, buf = rec
    q = ctx.queues
    seg = q.seg_id.cpu().numpy()
    active = ((state.cursor < q.qlen) & state.alive).cpu().numpy()
    walked = (buf.is_fit | buf.is_pre).cpu().numpy() & active
    walked &= (seg >= 0) & (seg < ctx.n_segments)
    pre = buf.psuccess.cpu().numpy() & walked
    best = 0
    for g in np.unique(seg[walked]):
        heads = np.nonzero(walked & (seg == g))[0]
        n = min(len(heads), ctx.n_steps)
        # preempters among all the segment's walkable heads: exact where
        # no rank is dropped (n_steps covers the segment)
        best = max(best, 2 * n + 2 * min(int(pre[heads].sum()), n))
    return best


def plan_chain_heads(rec) -> int:
    """Walked heads of a plan_phase2 call's longest (segment, scenario)
    walk: heads with an effective candidate, a ClusterQueue and a
    segment below n_segments, at most n_steps a segment."""
    args, _ = rec
    heads, seg_t, n_segments, n_steps, chosen, pk = (args[6], args[8], args[10], args[11],
                                                      args[12], args[14])
    seg = seg_t.cpu().numpy()
    live = (heads.cq_row.cpu().numpy() >= 0) & (seg >= 0) & (seg < n_segments)
    walked = ((chosen >= 0) | (pk >= 0)).cpu().numpy() & live[None]
    best = 0
    for si in range(walked.shape[0]):
        if walked[si].any():
            best = max(best, int(min(np.bincount(seg[walked[si]]).max(), n_steps)))
    return best


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
        if variant == "alive=0":
            state.alive.zero_()

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
preempt_phase2_launch = _drain_launch("drain_preempt_phase2")
preempt_search_launch = _drain_launch("drain_preempt_search")
preempt_motion_launch = _drain_launch("drain_preempt_motion")


def plan_launch(rec, variant, built):
    """One plan_phase2 call on a fresh copy of its usage trees."""
    from kueue_tpu_torch.ops import plan_kernel as plk

    args, kw = rec
    args = list(args)
    args[4] = args[4].clone()
    return [lambda: plk.plan_phase2(*args, **kw)], lambda packed: (packed, args[4])


def plan_split_us(records, builds, order) -> dict:
    """plan_phase2's device time by part, per build: each recorded call
    traced by torch.profiler once per entry of ``order``, its launches'
    device times summed into the entry order (every launch whose kernel
    name does not hold ``walk``) and the walk; beside them a stable
    torch.argsort lexsort of the order's keys (``_lexsort_rows``), timed
    alone on the same card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kueue_tpu_torch.ops import plan_kernel as plk

    parts = {name: {"order": [], "walk": []} for name in builds}
    by_kernel = {name: {} for name in builds}
    for rec in records:
        for name in order:
            with using(builds[name]):
                fns, _ = plan_launch(rec, None, builds[name])
                fns[0]()  # warm
                torch.cuda.synchronize()
                fns, _ = plan_launch(rec, None, builds[name])
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    fns[0]()
                    torch.cuda.synchronize()
            us = {"order": 0.0, "walk": 0.0}
            for ev in prof.events():
                if ev.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                if "memset" in ev.name.lower() or "memcpy" in ev.name.lower():
                    continue
                t = ev.time_range.elapsed_us()
                us["walk" if "walk" in ev.name else "order"] += t
                short = ev.name.replace("(anonymous namespace)::", "").split("(")[0]
                short = short.split("::")[-1].split("<")[0]
                by_kernel[name].setdefault(short, []).append(t)
            for k, v in us.items():
                parts[name][k].append(v)
    out = {f"{name} {k}": float(np.mean(v)) for name, d in parts.items() for k, v in d.items()}
    # each kernel's device us a call (summed over its launches, e.g. the
    # merge passes), for the record
    n_calls = {name: len(records) * order.count(name) for name in builds}
    out["by kernel"] = {name: {k: float(np.sum(v)) / n_calls[name] for k, v in d.items()}
                        for name, d in by_kernel.items()}
    timer = Timer()
    lex = []
    for rec in records:
        args, _ = rec
        heads, priority_s = args[6], args[7]
        chosen, borrows_wk, pk = args[12], args[13], args[14]
        s, w = priority_s.shape
        eff = torch.where(chosen >= 0, chosen, pk)
        hb = borrows_wk.gather(2, eff.clamp_min(0).long()[..., None])[..., 0] & (eff >= 0)
        keys = (heads.timestamp.expand(s, w), -priority_s, hb.to(torch.int64),
                (eff < 0).to(torch.int64))
        t, _ = timer(lambda: ([lambda: plk._lexsort_rows(keys)], lambda o: (o,)))
        lex.append(t)
    out["torch.argsort lexsort"] = float(np.mean(lex))
    return out


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


def smem_latency_ns(dev, work: Path, symbol: str = "smem_chase") -> float:
    """ns per dependent shared-memory load: the slope of a one-thread
    pointer chase between two lengths (a random cycle of 4096 entries);
    with ``symbol="l2_chase"`` the same chase through device memory, its
    loads past the L1 (ns per dependent L2 hit)."""
    import torch

    src, lib = work / "smem_chase.cu", work / "libsmem_chase.so"
    if not lib.exists():
        src.write_text(CHASE_SRC)
        proc = _nvcc(src, lib)
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the chase:\n{log}")
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
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
          "drain_fair_phase2": ("n_steps=0", "done"),
          "drain_preempt_phase2": ("n_steps=0", "done"),
          "drain_preempt_search": ("no_cand", "done"),
          "drain_preempt_motion": ("alive=0", "done")}


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
    drain_kernels = tuple(k for k in ("drain_nominate", "quota_tree", "drain_phase2",
                                      "drain_preempt_phase2", "drain_preempt_search",
                                      "drain_preempt_motion") if k in kernels)
    drains = record_drains(dev, drain_kernels) if drain_kernels else {}
    paths = []
    if "cycle_phase2" in kernels:
        paths.append(("cycle_phase2", "headline cycles", cyc["cycle_phase2"], cycle_launch))
    if "quota_tree" in kernels:
        paths.append(("quota_tree", "headline drain call site", drains["quota_tree"]["headline"],
                      quota_drain_launch))
        paths.append(("quota_tree", "headline cycle call site", cyc["quota_tree"],
                      quota_cycle_launch))
    def named(label):  # a drain's path
        return label if "drain" in label else f"{label} drain"

    for label, recs in drains.get("drain_nominate", {}).items():
        paths.append(("drain_nominate", named(label), recs, nominate_launch))
    for label, recs in drains.get("drain_phase2", {}).items():
        paths.append(("drain_phase2", f"{label} drain", recs, phase2_launch))
    for label, recs in drains.get("drain_preempt_phase2", {}).items():
        paths.append(("drain_preempt_phase2", named(label), recs, preempt_phase2_launch))
    for label, recs in drains.get("drain_preempt_search", {}).items():
        paths.append(("drain_preempt_search", named(label), recs, preempt_search_launch))
    for label, recs in drains.get("drain_preempt_motion", {}).items():
        paths.append(("drain_preempt_motion", named(label), recs, preempt_motion_launch))
    plans = record_plans(dev) if "plan_phase2" in kernels else {}
    for label, recs in plans.items():
        paths.append(("plan_phase2", label, recs, plan_launch))
    tas_names = tuple(k for k in ("drain_tas_place", "drain_tas_phase2") if k in kernels)
    tas_recs = record_tas(dev, tas_names) if tas_names else {}
    tas = tas_recs.get("drain_tas_phase2", [])
    if tas:
        paths.append(("drain_tas_phase2", "tas-drain-10k", tas, tas_phase2_launch))
    if "drain_tas_place" in tas_recs:
        paths.append(("drain_tas_place", "tas-drain-10k", tas_recs["drain_tas_place"],
                      tas_place_launch))
    fp_names = tuple(k for k in ("drain_fair_preempt_search", "drain_fair_preempt_phase2",
                                 "drain_preempt_motion") if k in kernels)
    fpre = record_fair_preempt(dev, fp_names) if fp_names else {}
    for label, recs in fpre.get("drain_fair_preempt_search", {}).items():
        paths.append(("drain_fair_preempt_search", label, recs, fair_search_launch))
    for label, recs in fpre.get("drain_fair_preempt_phase2", {}).items():
        paths.append(("drain_fair_preempt_phase2", label, recs, fair_preempt_launch))
    for label, recs in fpre.get("drain_preempt_motion", {}).items():
        paths.append(("drain_preempt_motion", named(label), recs, preempt_motion_launch))
    fair = record_fair(dev) if "drain_fair_phase2" in kernels else []
    if fair:
        paths.append(("drain_fair_phase2", "headline fair drain", fair, fair_launch))
    if "cycle_global" in kernels:
        paths.append(("cycle_global", "headline cycles", cyc["cycle_phase2"], global_launch))
    print(f"recorded {[(k, label, len(r)) for k, label, r, _ in paths]} "
          f"({time.perf_counter() - t0:.1f} s)")
    lat = smem_latency_ns(dev, work)
    l2 = smem_latency_ns(dev, work, "l2_chase")
    result = {"card": card, "smem_latency_ns": lat, "l2_latency_ns": l2, "ptxas": {
        b: {k: built[k][1] for k in kernels} for b, built in builds.items()},
        "chains": {}, "times_us": {}}
    print(f"shared-memory load latency {lat:.3f} ns, L2 {l2:.3f} ns")
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
    chain_paths += [("plan_phase2", label, recs, plan_chain_heads)
                    for label, recs in plans.items()]
    # B10b: its count is in trips (two a walked head, two more a preempter)
    chain_paths += [("drain_preempt_phase2", named(label), recs, preempt_chain_trips)
                    for label, recs in drains.get("drain_preempt_phase2", {}).items()]
    chain_paths += [("drain_preempt_search", named(label), recs, ladder_steps)
                    for label, recs in drains.get("drain_preempt_search", {}).items()]
    motion_paths = list(drains.get("drain_preempt_motion", {}).items()) + list(
        fpre.get("drain_preempt_motion", {}).items())
    chain_paths += [("drain_preempt_motion", named(label), recs, lambda _: MOTION_L2_TRIPS)
                    for label, recs in motion_paths]
    for kname, label, recs, count in chain_paths:
        chains = [count(r) for r in recs] or [0]
        hops = 1 if kname in ("drain_preempt_phase2", "drain_preempt_motion") else HOPS_PER_HEAD
        if kname.startswith("drain_fair") and recs:
            d1 = recs[0][0].tree.max_depth + 1
            hops = 4 * d1 + SEARCH_TRIPS if kname == "drain_fair_preempt_search" else 2 * d1
        if kname == "drain_preempt_search" and recs:
            hops = recs[0][0].tree.max_depth + 1 + LADDER_TRIPS
        trip_ns = l2 if kname == "drain_preempt_motion" else lat
        chain_us = float(np.mean(chains)) * hops * trip_ns * 1e-3
        result["chains"][f"{kname} [{label}]"] = {"heads": chains, "bound_us": chain_us,
                                                   "trips": hops}
        what = {"drain_preempt_phase2": "dependent trips",
                "drain_preempt_motion": "dependent L2 trips",
                "drain_preempt_search": f"ladder steps, {hops} trips a step"}.get(
                    kname, f"heads, {hops} trips a head")
        print(f"{kname} [{label}]: the longest segments walk {float(np.mean(chains)):.2f} "
              f"{what} (max {max(chains)}): chain bound {chain_us:.4f} us a launch")

    for label, recs in plans.items():
        if args.split:
            key = f"plan_phase2 [{label}, split]"
            res = plan_split_us(recs, builds, order)
            result["times_us"][key] = res
            print(f"{key}: " + ", ".join(f"{k} {v:.2f} us" for k, v in res.items()
                                         if k != "by kernel")
                  + f"; by kernel {json.dumps(res['by kernel'])}")
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
