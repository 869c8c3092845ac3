#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``kueue_tpu_torch``) on one card.

Run from the repository root: ``python3 chip_smoke.py``. It needs one
CUDA device and ``nvcc``; without them, or without the package beside
it, it exits non-zero and prints no result.

1. Prints the card's name and power limit, builds the four kernels from
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
3. Drives the slice through its entry point: headline cluster (seed 0)
   -> Cache -> take_snapshot -> run_drain(device="cuda"), with the
   launch counters reset just before; asserts 74 cycles, 15178
   admitted, 34822 parked, 0 fallback, not truncated, the decision
   digest the JAX package gives, and that every kernel launched. Prints
   the drain's wall time (median of 3 after a warm run), and the
   device time of the same drain's launches replayed as one CUDA graph.
4. Prints the kernels' JSON line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

No phase is caught and passed over: any failure exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import fields

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
SPIN_CYCLES = 2_000_000  # about 1 ms of the card's clock, per timed launch
SMALL_SEED = 7  # mixed_spec seed whose drain freezes PendingFlavors queues

SOURCES = {
    "quota_tree": "kueue_tpu_torch/csrc/quota_tree.cu",
    "drain_nominate": "kueue_tpu_torch/csrc/drain_nominate.cu",
    "drain_phase2": "kueue_tpu_torch/csrc/drain_phase2.cu",
    "drain_queue_motion": "kueue_tpu_torch/csrc/drain_queue_motion.cu",
}
REPLACES = {
    "quota_tree": "kueue_tpu/ops/quota.py:93",
    "drain_nominate": "kueue_tpu/ops/drain_kernel.py:230",
    "drain_phase2": "kueue_tpu/ops/drain_kernel.py:451",
    "drain_queue_motion": "kueue_tpu/ops/drain_kernel.py:396",
}


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


def cycle_bytes(bd: BoundData, cursor: np.ndarray, buf) -> dict:
    """Bytes each kernel must move in one cycle (each input read once,
    each output written once), counted from the cycle's own data:
    ``cursor`` at the cycle's start and the buffers after it, which say
    who was nominated and admitted. quota_tree gets its two passes."""
    q, l, p, k, c, g, fr, d1 = bd.q, bd.l, bd.p, bd.k, bd.c, bd.g, bd.fr, bd.d1
    tree_links = 4 * bd.n + d1 * bd.n
    mat = bd.n * fr * 8
    # usage_tree: local, guaranteed in, usage out; available_all:
    # subtree, guaranteed, borrowing_limit, usage in, avail out
    quota = [3 * mat + tree_links, 5 * mat + tree_links]

    active = cursor < bd.qlen
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
    the device, for all the cycles that do work.

    Before each launch a spin kernel (``torch.cuda._sleep``) holds the
    stream while the host enqueues the start event, the launch and the
    end event, so the events bracket the launch's device time and no
    host time. A launch whose start event had already run when the host
    finished enqueuing is counted as uncovered (the spin then doubles).
    Also the host's time to enqueue each call, and each cycle's bytes
    (``cycle_bytes``). Returns (cycles, device ms, host ms, bytes,
    uncovered), the middle three per kernel per launch."""
    import torch

    from kueue_tpu_torch.ops import drain_kernel as dk
    from kueue_tpu_torch.perf.lockstep import STEPS

    bd = BoundData(ctx)
    state = dk.DrainState.initial(local, queues, ctx.max_cycles)
    buf = dk.CycleBuffers.empty(local, queues)
    dev_ms, host_ms, nbytes = {}, {}, {}
    spin, uncovered, cycles = SPIN_CYCLES, 0, 0
    while not state.done.item():
        cursor = state.cursor.cpu().numpy()
        for name, kern, _ in STEPS:
            torch.cuda._sleep(spin)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            kern(ctx, state, buf)
            host = time.perf_counter() - t0
            end.record()
            if start.query():
                uncovered += 1
                spin *= 2
            end.synchronize()
            dev_ms.setdefault(name, []).append(start.elapsed_time(end))
            host_ms.setdefault(name, []).append(host * 1e3)
        for name, b in cycle_bytes(bd, cursor, buf).items():
            nbytes.setdefault(name, []).extend(b)
        cycles += 1
    return cycles, dev_ms, host_ms, nbytes, uncovered


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
        from kueue_tpu_torch.perf.lockstep import lockstep
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
    print(f"lockstep headline: {cyc} cycles, every kernel bit-exact to its "
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
    print(f"lockstep small case: cells {shape} D={s_tree.max_depth} "
          f"{s_cyc} cycles, {n_stuck} stuck queues, bit-exact")
    if shape[2] != 3 or s_tree.max_depth != 3 or n_stuck == 0:
        fail("the small case lost its coverage (P=3, depth 3, stuck queues)")

    # 2c. every launch of the headline drain timed on the device
    t_cyc, dev_ms, host_ms, nbytes, uncovered = timed_drain(ctx0, local, queues)
    if t_cyc != headline.HEADLINE_EXPECT["cycles"]:
        fail(f"timed headline drain ran {t_cyc} cycles")
    timing = {
        name: {
            "ms": float(np.mean(dev_ms[name])),
            "device_ms_total": float(np.sum(dev_ms[name])),
            "host_ms": float(np.mean(host_ms[name])),
            "plain_ms": float(np.mean(plain_ms[name])),
            "bytes": float(np.mean(nbytes[name])),
            "bound_ms": float(np.mean(nbytes[name])) / HBM_BYTES_PER_S * 1e3,
            "timed": len(dev_ms[name]),
        }
        for name in _build.KERNELS
    }
    kernel_ms = sum(t["device_ms_total"] for t in timing.values())
    print(f"timed headline drain: {t_cyc} cycles, {sum(len(v) for v in dev_ms.values())} "
          f"launches each timed alone on the device, {uncovered} uncovered")

    # 3. the slice through its entry point
    _build.reset_launches()
    outcome = run_drain(
        take_snapshot(cache), pending, cache.flavors,
        max_cells=headline.HEADLINE_MAX_CELLS, device="cuda",
    )
    launches = _build.launch_counts()
    summary = headline.outcome_summary(outcome)
    print(f"run_drain on cuda: {json.dumps(summary)}; launches {json.dumps(launches)}")
    if summary != headline.HEADLINE_EXPECT:
        fail(f"headline drain {summary} != expected {headline.HEADLINE_EXPECT}")
    for name in _build.KERNELS:
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
    for name in _build.KERNELS:
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
    print(f"headline drain wall (run_drain, lowering included, median of 3): "
          f"{wall_ms:.1f} ms = {wall_ms / cycles:.3f} ms/cycle; of which "
          f"plan_drain (host lowering) {plan_ms:.1f} ms; solve (inputs on the "
          f"card, {cycles} cycles, one fetch) {solve_ms:.2f} ms = "
          f"{solve_ms / cycles:.4f} ms/cycle; the kernels' device time over "
          f"the {cycles} cycles (each launch timed alone) {kernel_ms:.3f} ms "
          f"= {100 * kernel_ms / wall_ms:.2f}% of the wall; "
          f"the drain's {launches['drain_nominate']} cycles of launches as one CUDA "
          f"graph, no host: {graph_ms:.3f} ms = {100 * graph_ms / solve_ms:.1f}% "
          f"of the solve")

    # 4. result lines
    kernels = []
    for name in _build.KERNELS:
        t = timing[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": t["ms"],
            "device_ms_total": t["device_ms_total"],
            "host_ms": t["host_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels, "wall_ms": wall_ms, "plan_ms": plan_ms,
                      "solve_ms": solve_ms, "kernels_device_ms": kernel_ms,
                      "drain_graph_ms": graph_ms,
                      "cycles": cycles}))
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
