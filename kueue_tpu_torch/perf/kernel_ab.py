"""Two builds of the kernels B3 (``cycle_phase2``) and B4's nomination
(``drain_nominate``) timed side by side on one card.

    python -m kueue_tpu_torch.perf.kernel_ab [--parent DIR] [--split]

Run from the repository root on a machine with one CUDA card and nvcc.
It records the inputs of every ``cycle_phase2`` launch over the
headline cycles (perf/cycle.py's Scheduler, ``CYCLES`` cycles) and of
every ``drain_nominate`` launch with work of three drains: the headline
plain drain, the contended preempt drain at each panel width of its
schedule, and the fair-preempt drain at the panel caps
(``build_fair_wide``). Then it times each recorded launch alone on the
device, once per build in turns: parent, new, new, parent. A spin
kernel holds the stream while the host enqueues the start event, the
launch and the end event, so the events bracket the launch's device
time and no host time. The two builds' outputs are held equal at every
launch (int64, tolerance 0).

``--parent DIR``: a directory holding another build's sources (the
parent commit's ``kueue_tpu_torch/csrc``), built here with the same
nvcc flags. Without it only the current sources are timed (new, new).
``--split``: each build's split too: ``cycle_phase2`` with
``n_steps = 0`` (the entry order and the ranks, no walk) and
``drain_nominate`` with the done flag set (the launch's floor).
``--kernel NAME``: record and time that kernel only.

It also measures the card's shared-memory load latency (one thread
chasing pointers through shared memory; the slope between two chase
lengths, so the launch cancels) and counts each cycle launch's chain:
the walked heads of its longest segment. Prints the ptxas lines
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

KERNELS = ("cycle_phase2", "drain_nominate")
CYCLES = 30  # headline Scheduler cycles recorded (chip_smoke.py's STEADY_CYCLES)
SPIN = 2_000_000  # about 1 ms of the card's clock before each timed launch
CHASE_HOPS = (1 << 20, 1 << 21)
HOPS_PER_HEAD = 2  # a walked head's dependent shared-memory trips: read its rows, add

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


def build(csrc: Path, out: Path) -> dict:
    """Build ``KERNELS`` from ``csrc`` into ``out`` (in parallel); returns
    {name: (C entry, ptxas lines)}."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {name: _nvcc(csrc / f"{name}.cu", out / f"lib{name}.so") for name in KERNELS}
    built = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {csrc / name}.cu:\n{log}")
        fn = getattr(ctypes.CDLL(str(out / f"lib{name}.so")), name)
        fn.restype = ctypes.c_int
        fn.argtypes = _argtypes()
        lines = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "stack frame" in ln]
        built[name] = (fn, lines)
    return built


@contextlib.contextmanager
def using(built: dict):
    """The wrappers launch ``built``'s entries in place of _build's."""
    from kueue_tpu_torch.ops import _build

    saved = _build.c_function

    def pick(kernel, symbol, argtypes):
        if kernel in built and symbol == kernel:
            return built[kernel][0]
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
    A launch whose start event had run before the host finished
    enqueuing it (``uncovered``: its time holds host time) is timed
    again on fresh inputs, with a longer spin."""

    def __init__(self):
        self.spin, self.uncovered = SPIN, 0

    def __call__(self, make):
        import torch

        while True:
            fn, outputs = make()
            torch.cuda._sleep(self.spin)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            covered = not start.query()
            end.synchronize()
            if covered:
                return start.elapsed_time(end) * 1e3, outputs(out)
            self.uncovered += 1
            self.spin = min(2 * self.spin, 16 * SPIN)


# ---- recording ------------------------------------------------------------


def record_cycles(dev, n: int = CYCLES) -> list:
    """The arguments of every cycle_phase2 launch over ``n`` headline
    cycles (each a copy taken before the launch)."""
    from kueue_tpu_torch.ops import assign_kernel as ak
    from kueue_tpu_torch.perf import cycle

    recs, orig = [], ak.cycle_phase2

    def spy(*args):
        recs.append(_clone(args))
        return orig(*args)

    ak.cycle_phase2 = spy
    try:
        sched, _ = cycle.build_headline_scheduler(device=dev)
        cycle.run_cycles(sched, n)
    finally:
        ak.cycle_phase2 = orig
    return recs


def _record_drain(ctx, state, buf, steps) -> list:
    """(ctx, state copy, buffers copy) before every nomination with work."""
    recs = []
    while not state.done.item():
        for name, kern, _ in steps:
            if name == "drain_nominate":
                recs.append((ctx, state.clone(), buf.clone()))
            kern(ctx, state, buf)
    return recs


def record_drains(dev) -> dict:
    import torch

    from kueue_tpu_torch.core import drain as pd
    from kueue_tpu_torch.core.snapshot import take_snapshot
    from kueue_tpu_torch.core.solver import tree_arrays
    from kueue_tpu_torch.interop import drain_queues
    from kueue_tpu_torch.ops import drain_kernel as dk
    from kueue_tpu_torch.perf import contended, fairpreempt as fp, headline
    from kueue_tpu_torch.perf.lockstep import FAIR_PREEMPT_STEPS, PREEMPT_STEPS, STEPS

    out = {}
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
    out["headline"] = _record_drain(ctx, dk.DrainState.initial(local, queues, plan.max_cycles),
                                    dk.CycleBuffers.empty(local, queues), STEPS)

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
                              PREEMPT_STEPS)
    out["contended"] = recs

    wenv = fp.build_fair_wide(np.random.default_rng(fp.WIDE_SEED))
    plan, _, tree, paths, local, queues, victims, panels, fair = pd.fair_preempt_drain_inputs(
        take_snapshot(wenv.cache), wenv.pending, wenv.cache.flavors, dev,
        timestamp_fn=wenv.ts_fn)
    ctx = dk.fair_preempt_context(tree, queues, victims, panels, paths, fair, plan.n_segments,
                                  plan.n_steps, plan.max_cycles, 0, True)
    out["caps"] = _record_drain(
        ctx, dk.FairPreemptState.initial_fair(local, queues, plan.max_cycles, victims, panels),
        dk.PreemptBuffers.empty_preempt(local, queues, victims), FAIR_PREEMPT_STEPS)
    return out


# ---- the launches ---------------------------------------------------------


def chain_heads(rec) -> int:
    """Walked heads of the launch's longest segment: the heads with an
    effective candidate, a ClusterQueue and a segment below n_segments,
    at most n_steps a segment (the JAX mode="drop" rule)."""
    _, _, _, _, _, heads, seg_t, _, n_segments, n_steps, chosen, _, pk = rec
    seg = seg_t.cpu().numpy()
    walked = ((chosen >= 0) | (pk >= 0)).cpu().numpy() & (heads.cq_row >= 0).cpu().numpy()
    walked &= (seg >= 0) & (seg < n_segments)
    counts = np.bincount(seg[walked], minlength=1)
    return int(min(int(counts.max()), n_steps))


def cycle_launch(rec, split: bool):
    """(thunk, outputs getter) of one cycle_phase2 launch on a fresh copy
    of its usage tree."""
    from kueue_tpu_torch.ops import assign_kernel as ak

    args = list(rec)
    args[3] = rec[3].clone()
    if split:
        args[9] = 0
    return lambda: ak.cycle_phase2(*args), lambda packed: (packed, args[3])


def nominate_launch(rec, split: bool):
    from kueue_tpu_torch.ops import drain_kernel as dk

    ctx, state, buf = rec
    if split:
        state = state.clone()
        state.done.fill_(1)
    buf = buf.clone()

    def outputs(_):
        return tuple(getattr(buf, f.name) for f in dataclasses.fields(buf)
                     if getattr(buf, f.name) is not None)

    return lambda: dk.drain_nominate(ctx, state, buf), outputs


def time_path(records, make, builds: dict, order, split: bool) -> dict:
    """Each record's launch once per entry of ``order`` (build names),
    outputs held equal across builds; {build: mean us, median, max}."""
    import torch

    timer = Timer()
    us = {name: [] for name in builds}
    for rec in records:
        ref = None
        for name in order:
            with using(builds[name]):
                t, res = timer(lambda: make(rec, split))
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


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="the parent build's csrc directory")
    ap.add_argument("--split", action="store_true", help="also time each kernel's split")
    ap.add_argument("--kernel", choices=KERNELS, help="time this kernel only")
    args = ap.parse_args(argv)
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
    builds = {"new": build(_build.CSRC, work / "new")}
    if args.parent is not None:
        builds["parent"] = build(args.parent.resolve(), work / "parent")
    print(f"built {sorted(builds)} in {time.perf_counter() - t0:.1f} s")
    for bname, built in builds.items():
        for kname, (_, lines) in built.items():
            for ln in lines:
                print(f"  {bname} {kname}: {ln}")
    order = ["parent", "new", "new", "parent"] if "parent" in builds else ["new", "new"]
    _build.load(_build.KERNELS)  # the other kernels the recording runs

    t0 = time.perf_counter()
    cycles = record_cycles(dev) if args.kernel != "drain_nominate" else []
    drains = record_drains(dev) if args.kernel != "cycle_phase2" else {}
    print(f"recorded {len(cycles)} cycle launches, "
          f"{ {k: len(v) for k, v in drains.items()} } nominations "
          f"({time.perf_counter() - t0:.1f} s)")
    lat = smem_latency_ns(dev, work)
    chains = [chain_heads(r) for r in cycles] or [0]
    chain_us = float(np.mean(chains)) * HOPS_PER_HEAD * lat * 1e-3
    print(f"shared-memory load latency {lat:.3f} ns; the cycles' longest segments walk "
          f"{float(np.mean(chains)):.2f} heads (max {max(chains)}): chain bound "
          f"{chain_us:.4f} us a launch ({HOPS_PER_HEAD} trips a head)")

    result = {"card": card, "smem_latency_ns": lat, "cycle_chain_heads": chains,
              "cycle_chain_bound_us": chain_us, "ptxas": {
                  b: {k: lines for k, (_, lines) in built.items()} for b, built in builds.items()},
              "times_us": {}}
    paths = [("cycle_phase2", "headline cycles", cycles, cycle_launch)] if cycles else []
    paths += [("drain_nominate", f"{label} drain", recs, nominate_launch)
              for label, recs in drains.items()]
    for kname, label, recs, make in paths:
        for split in (False, True) if args.split else (False,):
            key = f"{kname} [{label}{', split' if split else ''}]"
            res = time_path(recs, make, builds, order, split)
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
