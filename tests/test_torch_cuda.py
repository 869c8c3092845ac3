"""The CUDA kernels on the card (marked ``cuda``; skipped where there is
no CUDA device or no nvcc, since a CUDA kernel has no CPU mode).

- the drain's four kernels bit-exact to their plain versions at every
  cycle of seeded drains (kueue_tpu_torch.perf.lockstep), with nonzero
  candidate scores; run_drain on the card equals run_drain(device="cpu");
- the cycle's kernels (quota_tree, cycle_phase1, cycle_phase2,
  scatter_rows) bit-exact to their plain versions on seeded random
  batches and at every cycle of the port's Scheduler on seeded
  clusters, whose decisions on the card equal those on the CPU;
- the megaloop's six launches (the plain cycle and megaloop_boundary)
  and the fair drain's (drain_fair_phase2 in place of phase 2) bit-exact
  to their plain versions at every cycle of seeded drains and at the
  headline's first cycles; the megaloop and the fair drain on the card
  equal their CPU runs;
- launch_drain_megaloop returns before the card finishes, with no host
  read (CUDA's sync debug mode set to raise);
- a CUDA tensor launches the kernel (the launch counters rise);
- a kernel source that does not build makes a Scheduler on the card,
  the megaloop and the fair drain raise KernelError (no fallback);
- the fair victim search (B9) bit-exact to its plain version at bench.py's
  fair shape and at the lowering's caps (S=64 nodes, Cu=32 cells), and
  inside the fair Scheduler's cycles, whose decisions on the card equal
  those on the CPU;
- a fair_search build that traps on the card makes the fair
  Scheduler's schedule() raise KernelError (no host search);
- every launch of the fair-preempt drain (B11's search and phase 2, the
  extended drain_preempt_motion) bit-exact to its plain version at
  every cycle of perf.cases.fair_preempt_spec, bench.py's 60-CQ stage
  and a drain at the panel caps (build_fair_wide with two root
  cohorts); the drain on the card equals its CPU run (the classic drain's
  lockstep above holds the extended motion kernel with its fair pointer
  NULL);
- every launch of the TAS drain (B13's drain_tas_place and
  drain_tas_phase2 beside the plain cycle's kernels) bit-exact to its
  plain version at every cycle of perf.cases.tas_spec, a cut of
  bench.py's tas_drain stage and perf.cases.tas_scan_spec (with and
  without dropped ranks), the drain on the card equal to its CPU run;
  B12's two entries (tas_leaf_counts) bit-exact on a batch with
  assumed usage, simulate_empty and tainted leaves, and the snapshot's
  device path equal to the CPU; a drain_tas_place that does not build
  makes the TAS drain raise KernelError.

- the unsegmented cycle's kernel B3' (cycle_global) bit-exact to its
  plain version on random batches up to W=1024 and at its edges (a
  usage tree beyond one block's shared memory among them) and equal to
  the segmented B3, and a trapping build raising at ShardedSolver's
  first sync;
  B1' (quota_drs) bit-exact to its plain versions, and a build that
  fails raising KernelError; run_drain (plain and fair) and
  dispatch_lowered on a one-card mesh (and on the card repeated eight
  times, which pads every axis) equal to the run without it;
  entry(device="cuda") equal to solve_cycle_plain.

- the federation's global rescore (B15, global_rescore) bit-exact to
  its plain version and to the numpy mirror on 200 random batches up
  to C=4096, rescore_pairs on the card equal to the CPU;
  ClusterRuntime(device="cuda") draining a small cluster through the
  drain kernels (serial, pipelined, megaloop) equal to its CPU run;
  run_federation_scale(8, 40) on the card equal to the CPU with every
  rescore with rows on B15; a trapping B15 raising KernelError out of
  GlobalScheduler.rescore and a trapping drain_nominate out of a
  pipelined bulk_drain round's device_join (perf/trap.py); a drain
  round on the card planted wrong at its fetch raising KernelError at
  the sampled check against the numpy mirror.

- the redesigned kernels at their edges: drain_nominate bit-exact to its
  plain version on random nominations with K*C up to 128 pairs, P = 4
  podsets repeating cells, G = 8 groups, tied flavor indices and
  scores, retired and exhausted queues, a set done flag, and over the
  contended cut's 128-entry pools; cycle_phase2 with a segment beyond
  its shared-memory rows beside small ones, W not a multiple of 32,
  pads, dropped ranks, repeated cells and paths of 7 levels.

- quota_tree (B1) one launch a call site: quota_all (the cycle's four
  recurrences) and usage_and_available (the drain's pair) bit-exact to
  their plain versions, and each single recurrence, on forests of depth
  1-7 with a root subtree beyond a block's shared memory (its columns
  split over blocks, or on device rows) beside small ones, FR not a
  multiple of 32, and a set done flag;
  drain_phase2 (B4's phase 2) bit-exact after the card's own quota pass
  and nomination on perf.cases.phase2_batch: a segment beyond its shared
  rows beside small ones, dropped ranks, reserves, ties, paths of 7
  levels, heads whose merged cells repeat a cell, a segment whose keys
  outgrow shared memory, and a set done flag.

- the placement and the fair-preempt step scan redesigned for the card:
  drain_tas_place with the TAS cycle's other launches bit-exact at every
  cycle of perf.cases.tas_edge_spec (negative headroom, gangs spread
  over every host, Preferred relaxing to the flavor's top, two flavors
  of unequal depth) and of a cut of bench.py's tas_drain stage at
  ND = 2048 hosts; drain_fair_preempt_phase2 with the fair-preempt
  cycle's other launches bit-exact at every cycle of
  perf.cases.fair_preempt_edge_spec (overlapping targets, reserves,
  weight 0, ties; PrioritySortingWithinCohort on and off) and of the
  panel caps widened to FR = 128 cells, whose rows exceed a block's
  shared memory (the device-row path).

- the fair-preempt search and the fair step scan redesigned for the card:
  drain_fair_preempt_search with the fair-preempt cycle's other launches
  bit-exact at every cycle of perf.cases.fair_preempt_spec seeds 1 and 8
  (weight 0, DRS ties, the second strategy's pruning, own-queue victims,
  fill-backs that keep victims, a rootless head) under both strategies
  and each alone, and of the panel caps (V = 512, M = 64, Cu = 64);
  drain_fair_phase2 with the fair cycle's other launches bit-exact at
  every cycle of perf.cases.fair_spec (depth 3: admissions charge team
  and dept cohorts; parents whose every proposal is DRS_MAX),
  PrioritySortingWithinCohort on and off, and over the first cycles of
  fair_spec with 70 and 150 ClusterQueues a team, whose org segment's
  rows, then its heads' tables, exceed a block's shared memory (the
  device-row path, then the step scan over device memory).

These tests import neither JAX nor kueue_tpu. On the machine with the
card, which has no JAX, run them without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from kueue_tpu_torch import interop
from kueue_tpu_torch.core import drain as pd
from kueue_tpu_torch.core.drain import plan_drain, run_drain
from kueue_tpu_torch.core.guard import GuardConfig, SolverGuard
from kueue_tpu_torch.interop import drain_queues
from kueue_tpu_torch.core.snapshot import take_snapshot
from kueue_tpu_torch.core.solver import tree_arrays
from kueue_tpu_torch.ops import _build
from kueue_tpu_torch.perf import cases, cycle
from kueue_tpu_torch.perf.cases import build_cache, mixed_spec
from kueue_tpu_torch.ops import drain_kernel as dk
from kueue_tpu_torch._torch import to_device
from kueue_tpu_torch.perf import headline
from kueue_tpu_torch.perf.cases import fair_spec
from kueue_tpu_torch.perf.lockstep import (
    CYCLE_KERNELS,
    DRAIN_KERNELS,
    FAIR_KERNELS,
    MEGALOOP_KERNELS,
    Lockstep,
    cycle_kernels_through,
    cycle_solve,
    lockstep,
    lockstep_megaloop,
    scatter_step,
)
from kueue_tpu_torch.utils.clock import FakeClock

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    if not _nvcc_found():
        pytest.skip("needs nvcc to build the kernels")
    return torch.device("cuda")


def _nvcc_found() -> bool:
    try:
        _build.nvcc_path()
    except RuntimeError:
        return False
    return True


def _inputs(seed, dev, score_seed=None, workloads_per_cq=4):
    cache, pending = build_cache(mixed_spec(seed, workloads_per_cq=workloads_per_cq))
    snap = take_snapshot(cache)
    plan = plan_drain(snap, pending, cache.flavors)
    if score_seed is not None:
        rng = np.random.default_rng(score_seed)
        plan.queues_np["score"] = rng.integers(-2, 3, size=plan.queues_np["score"].shape)
    tree, paths, _ = tree_arrays(snap, dev)
    local = tree.nominal.new_tensor(snap.local_usage)
    return tree, local, drain_queues(plan.queues_np, dev), paths, plan


# seeds with stuck queues (4, 7, 8) and without; seed 1 (3466 cycles)
# is left to the CPU tests, its lockstep would take minutes on the card
@pytest.mark.parametrize("seed", [0, 2, 4, 7, 8])
def test_kernels_bit_exact_every_cycle(cuda, seed):
    tree, local, queues, paths, plan = _inputs(seed, cuda, score_seed=seed)
    errs = {}
    _, state, cycles = lockstep(
        tree, local, queues, paths, plan.n_segments, plan.n_steps,
        plan.max_cycles, errs, label=f"seed {seed}",
    )
    assert cycles > 0
    assert set(errs) == set(DRAIN_KERNELS)
    assert all(e == 0 for e in errs.values())


def _view(outcome):
    return (
        sorted((wl.name, repr(sorted(f.items())), c) for wl, _, f, c in outcome.admitted),
        sorted(wl.name for wl, _ in outcome.parked),
        sorted(wl.name for wl, _ in outcome.fallback),
        outcome.cycles,
        outcome.truncated,
    )


@pytest.mark.parametrize("seed", range(4))
def test_run_drain_on_card_matches_cpu(cuda, seed):
    cache, pending = build_cache(mixed_spec(seed, workloads_per_cq=6))
    _build.reset_launches()
    on_card = run_drain(take_snapshot(cache), pending, cache.flavors, device="cuda")
    counts = _build.launch_counts()
    on_cpu = run_drain(take_snapshot(cache), pending, cache.flavors, device="cpu")
    assert _view(on_card) == _view(on_cpu)
    np.testing.assert_array_equal(on_card.final_usage, on_cpu.final_usage)
    assert all(counts[name] > 0 for name in DRAIN_KERNELS)


@pytest.mark.parametrize("seed,drop", [(s, False) for s in range(6)] + [(1, True), (4, True)])
def test_cycle_kernels_bit_exact_on_random_batches(cuda, seed, drop):
    b = cases.cycle_batch(seed, w=64, k=8, c=16, drop_steps=drop)
    tree = interop.quota_tree(b, cuda)
    heads = interop.heads_batch(b, cuda)
    local = torch.as_tensor(b["local_usage"], device=cuda)
    paths = torch.as_tensor(b["paths"], device=cuda)
    errs = {}
    check = Lockstep(errs, label=f"batch {seed}")
    _build.reset_launches()
    packed = cycle_solve(
        tree, local, heads, paths, b["seg_id"], b["n_segments"], b["n_steps"], check
    )
    rng = np.random.default_rng(seed)
    idx = torch.as_tensor(np.array([3, 1, 5, 3], dtype=np.int32), device=cuda)
    rows = torch.as_tensor(rng.integers(0, 1 << 40, size=(4, local.shape[1])), device=cuda)
    rows[3] = rows[0]
    scatter_step(local, idx, rows, check)
    torch.cuda.synchronize()
    assert set(errs) == set(CYCLE_KERNELS) and all(e == 0 for e in errs.values())
    counts = _build.launch_counts()
    assert all(counts[name] > 0 for name in CYCLE_KERNELS)
    assert bool((packed[1] > 0).any())  # something was admitted


def _cycle_trace(sched, mgr, cache):
    records = cycle.run_until_quiet(sched, mgr)
    return records, {n: sorted(c.workloads) for n, c in cache.cluster_queues.items()}


@pytest.mark.parametrize("seed", range(3))
def test_cycle_scheduler_on_card_matches_cpu(cuda, seed):
    spec = cases.cycle_spec(seed)
    guard = SolverGuard(
        clock=FakeClock(1000.0),
        config=GuardConfig(mode="device", divergence_check_every=1),
    )
    sched, mgr, cache = cases.build_scheduler(spec, device="cuda", guard=guard)
    errs = {}
    check = Lockstep(errs, label=f"cycle_spec {seed}")
    _build.reset_launches()
    with cycle_kernels_through(check):
        on_card = _cycle_trace(sched, mgr, cache)
    counts = _build.launch_counts()
    on_cpu = _cycle_trace(*cases.build_scheduler(spec, device="cpu"))
    assert on_card == on_cpu
    assert check.failures == [] and all(e == 0 for e in errs.values())
    assert guard.contained_cycles == 0 and guard.divergences == 0 and guard.failovers == 0
    assert guard.divergence_checks > 0
    assert all(counts[name] > 0 for name in CYCLE_KERNELS)


def test_scheduler_raises_when_a_kernel_does_not_build(cuda, monkeypatch, tmp_path):
    """A Scheduler on the card builds its kernels when it is made: a
    source that does not compile raises KernelError there (no failover
    to the host mirror)."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in _build.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            (csrc / src.name).write_text(src.read_text())
    (csrc / "cycle_phase2.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_FNS", {})
    with pytest.raises(_build.KernelError, match="cycle_phase2"):
        cases.build_scheduler(cases.cycle_spec(0), device="cuda")


# ---- the megaloop and the fair drain -------------------------------------


def _drain_case(cache, pending, dev, fair=False, max_cells=4):
    """(snapshot, plan, tree, paths, local, queues[, fair inputs]) on
    ``dev`` as the entry points build them."""
    snap = take_snapshot(cache)
    plan = plan_drain(snap, pending, cache.flavors, max_cells=max_cells)
    if fair:
        pd._route_preempt_capable(snap, plan)
    tree, paths, local, queues = pd._drain_device_inputs(snap, plan, dev)
    extra = pd.fair_inputs(snap, tree.max_depth, dev) if fair else None
    return snap, plan, tree, paths, local, queues, extra


@pytest.mark.parametrize("seed,chunk,rounds", [(0, 3, 8), (2, 2, 16), (7, 56, 6)])
def test_megaloop_kernels_bit_exact_every_cycle(cuda, seed, chunk, rounds):
    cache, pending = build_cache(mixed_spec(seed, workloads_per_cq=6))
    _, plan, tree, paths, local, queues, _ = _drain_case(cache, pending, cuda)
    cap = to_device(pd._cap_suffix_of(plan), cuda, np.int32)
    errs = {}
    _, state, cycles = lockstep_megaloop(
        tree, local, queues, paths, cap, plan.n_segments, plan.n_steps, chunk, rounds,
        errs, label=f"megaloop seed {seed}",
    )
    assert cycles > 0 and int(state.round_idx.item()) >= 1
    assert set(errs) == set(MEGALOOP_KERNELS) and not any(errs.values())


@pytest.mark.parametrize("seed", [2, 4, 5])
def test_fair_kernels_bit_exact_every_cycle(cuda, seed):
    cache, pending = build_cache(fair_spec(seed))
    _, plan, tree, paths, local, queues, fair = _drain_case(cache, pending, cuda, fair=True)
    errs = {}
    _, _, cycles = lockstep(
        tree, local, queues, paths, plan.n_segments, plan.n_steps, plan.max_cycles,
        errs, label=f"fair seed {seed}", fair=fair,
    )
    assert cycles > 0
    assert set(errs) == set(FAIR_KERNELS) and not any(errs.values())


def test_new_kernels_bit_exact_on_the_headline_first_cycles(cuda):
    rng = np.random.default_rng(headline.HEADLINE_SEED)
    cache = headline.build_cluster(rng)
    pending = headline.build_backlog(rng)
    mc = headline.HEADLINE_MAX_CELLS
    _, plan, tree, paths, local, queues, _ = _drain_case(cache, pending, cuda, max_cells=mc)
    cap = to_device(pd._cap_suffix_of(plan), cuda, np.int32)
    errs = {}
    lockstep_megaloop(
        tree, local, queues, paths, cap, plan.n_segments, plan.n_steps, 2, 8, errs,
        label="headline megaloop", stop_after=6,
    )
    _, plan, tree, paths, local, queues, fair = _drain_case(
        cache, pending, cuda, fair=True, max_cells=mc)
    lockstep(
        tree, local, queues, paths, plan.n_segments, plan.n_steps, plan.max_cycles, errs,
        label="headline fair", fair=fair, stop_after=3,
    )
    assert set(errs) == set(MEGALOOP_KERNELS) | set(FAIR_KERNELS)
    assert not any(errs.values())


def _log_view(log):
    return (log.n_rounds, log.cycles, log.truncated, [_view(r) for r in log.rounds],
            [r.final_usage.tolist() for r in log.rounds])


@pytest.mark.parametrize("seed", range(3))
def test_megaloop_and_fair_on_card_match_cpu(cuda, seed):
    cache, pending = build_cache(mixed_spec(seed, workloads_per_cq=6))
    _build.reset_launches()
    on_card = pd.launch_drain_megaloop(
        take_snapshot(cache), pending, cache.flavors, chunk_cycles=3, max_rounds=8,
        device="cuda").fetch()
    counts = _build.launch_counts()
    on_cpu = pd.launch_drain_megaloop(
        take_snapshot(cache), pending, cache.flavors, chunk_cycles=3, max_rounds=8,
        device="cpu").fetch()
    assert _log_view(on_card) == _log_view(on_cpu)
    assert all(counts[name] > 0 for name in MEGALOOP_KERNELS)

    fcache, fpending = build_cache(fair_spec([2, 4, 5][seed]))
    _build.reset_launches()
    on_card = run_drain(take_snapshot(fcache), fpending, fcache.flavors,
                        fair_sharing=True, device="cuda")
    counts = _build.launch_counts()
    on_cpu = run_drain(take_snapshot(fcache), fpending, fcache.flavors,
                       fair_sharing=True, device="cpu")
    assert _view(on_card) == _view(on_cpu)
    np.testing.assert_array_equal(on_card.final_usage, on_cpu.final_usage)
    assert all(counts[name] > 0 for name in FAIR_KERNELS)
    assert counts["drain_phase2"] == 0


@pytest.mark.parametrize("kind", ["megaloop", "plain", "fair"])
def test_launch_returns_before_the_card_finishes(cuda, kind):
    """No host read between the plan and the fetch of a launch bounded
    by a pipeline chunk (at most ENQUEUE_ALL_CYCLES cycles): with CUDA's
    sync debug mode set to raise, the launch makes no synchronising
    call and reads no done flag, and the stream is still busy with a
    spin enqueued before it when it returns. The fetch equals the same
    launch on the CPU."""
    if kind == "megaloop":
        cache, pending = build_cache(mixed_spec(0, workloads_per_cq=6))
        launch_fn, view = pd.launch_drain_megaloop, _log_view
        kw = dict(chunk_cycles=3, max_rounds=8)
    else:
        cache, pending = build_cache(fair_spec(4) if kind == "fair" else
                                     mixed_spec(0, workloads_per_cq=6))
        launch_fn, view = pd.launch_drain, _view
        kw = dict(fair_sharing=kind == "fair", max_cycles=64)
    launch_fn(take_snapshot(cache), pending, cache.flavors, device="cuda", **kw).fetch()  # builds
    snap = take_snapshot(cache)
    reads = dk.DONE_READS
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # about 0.1 s of the card's clock
    torch.cuda.set_sync_debug_mode("error")
    try:
        launch = launch_fn(snap, pending, cache.flavors, device="cuda", **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert dk.DONE_READS == reads
    assert not torch.cuda.current_stream().query()
    on_cpu = launch_fn(take_snapshot(cache), pending, cache.flavors, device="cpu", **kw)
    assert view(launch.fetch()) == view(on_cpu.fetch())


def _broken(monkeypatch, tmp_path, name):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in _build.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            (csrc / src.name).write_text(src.read_text())
    (csrc / f"{name}.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_FNS", {})


def test_megaloop_raises_when_its_kernel_does_not_build(cuda, monkeypatch, tmp_path):
    cache, pending = build_cache(mixed_spec(0, workloads_per_cq=2))
    _broken(monkeypatch, tmp_path, "megaloop_boundary")
    with pytest.raises(_build.KernelError, match="megaloop_boundary"):
        pd.launch_drain_megaloop(take_snapshot(cache), pending, cache.flavors,
                                 chunk_cycles=2, max_rounds=2, device="cuda").fetch()


def test_fair_drain_raises_when_its_kernel_does_not_build(cuda, monkeypatch, tmp_path):
    cache, pending = build_cache(fair_spec(2, workloads_per_cq=2))
    _broken(monkeypatch, tmp_path, "drain_fair_phase2")
    with pytest.raises(_build.KernelError, match="drain_fair_phase2"):
        run_drain(take_snapshot(cache), pending, cache.flavors, fair_sharing=True,
                  device="cuda")


# ---- classic preemption: the batched victim search and the preempt drain -


def _contended_cut(n_cq):
    from kueue_tpu_torch.perf import contended

    return contended.build_contended(np.random.default_rng(contended.SEED), n_cq=n_cq)


def _b8_problem(env, dev):
    """kernel B8's problem for the preempt-mode heads of a contended cut,
    as core/preempt_batch lowers it (padded rows included)."""
    from kueue_tpu_torch.core.flavor_assigner import FlavorAssigner, Mode
    from kueue_tpu_torch.core.preempt_batch import _pad_rows, lower_preemption
    from kueue_tpu_torch.core.preemption import Preemptor
    from kueue_tpu_torch.core.solver import _bucket

    snap = take_snapshot(env.cache)
    assigner = FlavorAssigner(snap, env.cache.flavors)
    items = [(wl, cq, a) for wl, cq in env.pending for a in [assigner.assign(wl, cq)]
             if a.representative_mode() == Mode.PREEMPT]
    lowered = lower_preemption(snap, items, Preemptor(FakeClock(0.0)))
    arrays = _pad_rows(lowered.arrays, _bucket(len(lowered.attempts), minimum=8))
    return interop.preempt_problem(arrays, dev), lowered


@pytest.mark.parametrize("n_cq", [20, 100])
def test_preempt_search_bit_exact(cuda, n_cq):
    from kueue_tpu_torch.ops import preempt_kernel as pk

    p, lowered = _b8_problem(_contended_cut(n_cq), cuda)
    _build.reset_launches()
    got = pk.solve_preempt_packed(p, lowered.depth, lowered.n_cand)
    want = pk._pack(pk.solve_preempt(p, lowered.depth, lowered.n_cand))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert _build.launch_counts()["preempt_search"] == 1
    assert int(got[-p.hrow.shape[0]:].sum()) > 0  # some attempt found victims


def test_preempt_search_refuses_wide_cells(cuda):
    from kueue_tpu_torch.ops import preempt_kernel as pk
    from kueue_tpu_torch.ops.quota import NO_LIMIT

    p, lowered = _b8_problem(_contended_cut(20), cuda)
    extra = pk.MAX_CELLS + 1 - p.usage0.shape[2]

    def widen(t, fill=0):
        pad = torch.full(t.shape[:-1] + (extra,), fill, dtype=t.dtype, device=t.device)
        return torch.cat([t, pad], dim=-1)

    wide = p._replace(
        **{k: widen(getattr(p, k)) for k in ("usage0", "leaf0", "nominal", "subtree_q",
                                             "guaranteed", "need_qty", "need_pre", "cqty")},
        borrow_lim=widen(p.borrow_lim, NO_LIMIT),
    )
    with pytest.raises(_build.KernelInputError, match="Cu<="):
        pk.solve_preempt_packed(wide, lowered.depth, lowered.n_cand)


def _preempt_case(cache, pending, dev, ts=None):
    snap = take_snapshot(cache)
    return pd.preempt_drain_inputs(snap, pending, cache.flavors, dev, timestamp_fn=ts)


@pytest.mark.parametrize("case,width", [
    ("spec-2", 32), ("spec-6", 32), ("contended-40", 64), ("contended-40", 8),
])
def test_preempt_drain_kernels_bit_exact_every_cycle(cuda, case, width):
    """Every launch of the preempt cycle (the usage tree, nomination with
    the reclaim oracle, the search, phase 2, the motion) against its
    plain version at every cycle; width 8 overflows the contended
    cut's candidate lists."""
    from kueue_tpu_torch.perf.lockstep import PREEMPT_KERNELS, lockstep_preempt

    kind, n = case.split("-")
    if kind == "spec":
        cache, pending = build_cache(cases.preempt_spec(int(n)))
        ts = None
    else:
        env = _contended_cut(int(n))
        cache, pending, ts = env.cache, env.pending, env.ts_fn
    plan, _, tree, paths, local, queues, victims = _preempt_case(cache, pending, cuda, ts)
    errs = {}
    _, state, cycles = lockstep_preempt(
        tree, local, queues, victims, paths, plan.n_segments, plan.n_steps,
        plan.max_cycles, width, errs, label=case,
    )
    assert cycles > 0 and bool(state.vevicted.any())
    assert set(errs) == set(PREEMPT_KERNELS) and not any(errs.values())
    assert bool(state.ovf.item()) == (width == 8)


def test_preempt_drain_refuses_a_wide_window(cuda):
    cache, pending = build_cache(cases.preempt_spec(2))
    plan, _, tree, paths, local, queues, victims = _preempt_case(cache, pending, cuda)
    with pytest.raises(_build.KernelInputError, match="search_width"):
        dk.solve_drain_preempt(tree, local, queues, victims, paths, plan.n_segments,
                               plan.n_steps, plan.max_cycles, search_width=1024)


def _preempt_view(out):
    return (_view(out), sorted((e.victim.name, e.cycle, e.by_cq, e.reason)
                               for e in out.evictions))


@pytest.mark.parametrize("case", ["spec-2", "spec-6", "contended-40"])
def test_preempt_drain_on_card_matches_cpu(cuda, case):
    from kueue_tpu_torch.perf.lockstep import PREEMPT_KERNELS

    kind, n = case.split("-")
    if kind == "spec":
        cache, pending = build_cache(cases.preempt_spec(int(n)))
        kw = {}
    else:
        env = _contended_cut(int(n))
        cache, pending, kw = env.cache, env.pending, {"timestamp_fn": env.ts_fn}
    _build.reset_launches()
    on_card = pd.run_drain_preempt(take_snapshot(cache), pending, cache.flavors,
                                   search_width=64, panel_widths=(8, 64), device="cuda", **kw)
    counts = _build.launch_counts()
    on_cpu = pd.run_drain_preempt(take_snapshot(cache), pending, cache.flavors,
                                  search_width=64, panel_widths=(8, 64), device="cpu", **kw)
    assert _preempt_view(on_card) == _preempt_view(on_cpu)
    assert all(counts[name] > 0 for name in PREEMPT_KERNELS)
    assert counts["drain_phase2"] == 0 and counts["drain_queue_motion"] == 0


def test_nominate_without_pools_still_bit_exact_at_the_headline(cuda):
    """The extended drain_nominate with NULL pool pointers (the plain
    drain) against its plain version on the headline's first cycles."""
    rng = np.random.default_rng(headline.HEADLINE_SEED)
    cache = headline.build_cluster(rng)
    pending = headline.build_backlog(rng)
    _, plan, tree, paths, local, queues, _ = _drain_case(
        cache, pending, cuda, max_cells=headline.HEADLINE_MAX_CELLS)
    errs = {}
    lockstep(tree, local, queues, paths, plan.n_segments, plan.n_steps, plan.max_cycles,
             errs, label="headline plain", stop_after=4)
    assert set(errs) == set(DRAIN_KERNELS) and not any(errs.values())


def test_scheduler_batched_search_on_card_matches_cpu(cuda):
    from kueue_tpu_torch.perf import contended
    from kueue_tpu_torch.perf.lockstep import preempt_search_through

    def run(dev, check=None):
        env = _contended_cut(40)
        sched = contended.build_scheduler(env, use_preempt_solver=True, device=dev)
        if check is None:
            return contended.run_cycles(sched, env, 6)
        with preempt_search_through(check), cycle_kernels_through(check):
            return contended.run_cycles(sched, env, 6)

    errs = {}
    check = Lockstep(errs, label="contended cut")
    _build.reset_launches()
    on_card = run("cuda", check)
    counts = _build.launch_counts()
    assert on_card == run("cpu")
    assert check.failures == [] and not any(errs.values())
    assert counts["preempt_search"] > 0 and check.launches["preempt_search"] > 0
    assert all(r["victim_search"] == ["device"] for r in on_card if r["preempting"])


def test_preempt_paths_raise_when_a_kernel_does_not_build(cuda, monkeypatch, tmp_path):
    from kueue_tpu_torch.perf import contended

    cache, pending = build_cache(cases.preempt_spec(2))
    _broken(monkeypatch, tmp_path, "drain_preempt_phase2")
    with pytest.raises(_build.KernelError, match="drain_preempt_phase2"):
        pd.run_drain_preempt(take_snapshot(cache), pending, cache.flavors, device="cuda")
    with pytest.raises(_build.KernelError):
        contended.build_scheduler(_contended_cut(20), use_preempt_solver=True, device="cuda")


# ---- fair-sharing preemption (B9, B11) ------------------------------------


def _b9_tiers(snap, items, pre, dev):
    from kueue_tpu_torch.core.preempt_batch import fair_tiers, lower_fair_preemption

    arrays, meta = lower_fair_preemption(snap, items, pre)
    return [(interop.fair_problem(padded, dev), v_dim, meta)
            for _, v_dim, padded in fair_tiers(arrays, meta)]


@pytest.mark.parametrize("shape", ["bench", "cap"])
def test_fair_search_bit_exact(cuda, shape):
    """B9 against plain solve_fair on the same problem: bench.py's fair
    stage (S=8, Cu=2, V=32) and the lowering's caps (S=64, Cu=32)."""
    from kueue_tpu_torch.ops import fair_preempt_kernel as fpk
    from kueue_tpu_torch.perf import fairpreempt as fp

    build = fp.build_fair_search if shape == "bench" else fp.build_fair_cap
    seed = fp.SEARCH_SEED if shape == "bench" else 0
    tiers = _b9_tiers(*build(np.random.default_rng(seed)), cuda)
    if shape == "cap":
        assert tiers[0][0].usage0.shape[1:] == (64, 32)
    _build.reset_launches()
    found = 0
    for p, v_dim, meta in tiers:
        kw = dict(depth=meta["depth"], n_cand=v_dim, n_local=meta["s"], n_res=meta["r"],
                  strategy1=meta["strategy1"], has_second=meta["has_second"])
        got = fpk.solve_fair_packed(p, **kw)
        want = fpk._pack(fpk.solve_fair(p, **kw))
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        found += int(got[-p.hrow.shape[0]:].sum())
    assert _build.launch_counts()["fair_search"] == len(tiers)
    assert found > 0  # some head found victims


def test_fair_search_refuses_wide_panels(cuda):
    from kueue_tpu_torch.ops import fair_preempt_kernel as fpk
    from kueue_tpu_torch.perf import fairpreempt as fp

    p, v_dim, meta = _b9_tiers(*fp.build_fair_search(np.random.default_rng(fp.SEARCH_SEED)),
                               cuda)[0]
    with pytest.raises(_build.KernelInputError, match="R<="):
        fpk.solve_fair_packed(p, meta["depth"], v_dim, meta["s"], fpk.MAX_BUCKETS + 1,
                              meta["strategy1"], meta["has_second"])


def _fair_preempt_case(case, dev):
    from kueue_tpu_torch.perf import fairpreempt as fp

    kind, n = case.split("-")
    if kind == "spec":
        cache, pending = build_cache(cases.fair_preempt_spec(int(n)))
        return cache, pending, {"max_cycles": 32}
    if kind == "wide":
        env = fp.build_fair_wide(np.random.default_rng(fp.WIDE_SEED), int(n))
        return env.cache, env.pending, {"timestamp_fn": env.ts_fn}
    env = fp.build_fair_preempt(int(n))
    return env.cache, env.pending, {"timestamp_fn": env.ts_fn}


@pytest.mark.parametrize("case", ["spec-1", "spec-8", "bench-60", "wide-2"])
def test_fair_preempt_drain_kernels_bit_exact_every_cycle(cuda, case):
    from kueue_tpu_torch.perf.lockstep import FAIR_PREEMPT_KERNELS, lockstep_fair_preempt

    cache, pending, kw = _fair_preempt_case(case, cuda)
    plan, _, tree, paths, local, queues, victims, panels, fair = pd.fair_preempt_drain_inputs(
        take_snapshot(cache), pending, cache.flavors, cuda, **kw)
    errs = {}
    _, state, cycles = lockstep_fair_preempt(
        tree, local, queues, victims, panels, paths, fair, plan.n_segments, plan.n_steps,
        plan.max_cycles, 0, True, errs, label=case)
    assert cycles > 0 and bool(state.vevicted.any())
    assert set(errs) == set(FAIR_PREEMPT_KERNELS) and not any(errs.values())


@pytest.mark.parametrize("prio_tie", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_fair_preempt_phase2_bit_exact_at_the_scan_edges(cuda, seed, prio_tie):
    """drain_fair_preempt_phase2, with the fair-preempt cycle's other
    launches, equal to its plain version at every cycle of
    perf.cases.fair_preempt_edge_spec."""
    from kueue_tpu_torch import features
    from kueue_tpu_torch.perf.lockstep import FAIR_PREEMPT_KERNELS, lockstep_fair_preempt

    cache, pending = build_cache(cases.fair_preempt_edge_spec(seed))
    with features.override("PrioritySortingWithinCohort", prio_tie):
        plan, _, tree, paths, local, queues, victims, panels, fair = (
            pd.fair_preempt_drain_inputs(take_snapshot(cache), pending, cache.flavors, cuda))
    errs = {}
    _, state, cycles = lockstep_fair_preempt(
        tree, local, queues, victims, panels, paths, fair, plan.n_segments, plan.n_steps, 32,
        0, True, errs, label=f"fair_preempt_edge_spec({seed})")
    assert cycles > 0 and bool(state.vevicted.any())
    assert set(errs) == set(FAIR_PREEMPT_KERNELS) and not any(errs.values())


def test_fair_preempt_phase2_on_device_rows(cuda):
    """The panel caps with two flavor sets (FR = 128 cells, M = 64
    nodes): the segment's rows exceed a block's shared memory, so
    drain_fair_preempt_phase2 keeps them in device memory; bit-exact at
    every cycle."""
    from kueue_tpu_torch.perf import fairpreempt as fp
    from kueue_tpu_torch.perf.lockstep import FAIR_PREEMPT_KERNELS, lockstep_fair_preempt

    env = fp.build_fair_wide(np.random.default_rng(fp.WIDE_SEED), 2, flavor_sets=2)
    plan, _, tree, paths, local, queues, victims, panels, fair = pd.fair_preempt_drain_inputs(
        take_snapshot(env.cache), env.pending, env.cache.flavors, cuda, timestamp_fn=env.ts_fn)
    m, fr = victims.seg_nodes.shape[1], tree.nominal.shape[1]
    assert 6 * m * fr * 8 > 232448  # six row arrays of the segment: beyond the block's room
    errs = {}
    _, state, cycles = lockstep_fair_preempt(
        tree, local, queues, victims, panels, paths, fair, plan.n_segments, plan.n_steps,
        plan.max_cycles, 0, True, errs, label="caps, FR 128")
    assert cycles > 0 and bool(state.vevicted.any())
    assert set(errs) == set(FAIR_PREEMPT_KERNELS) and not any(errs.values())


@pytest.mark.parametrize("case", ["spec-1", "bench-60"])
def test_fair_preempt_drain_on_card_matches_cpu(cuda, case):
    from kueue_tpu_torch.perf.lockstep import FAIR_PREEMPT_KERNELS

    cache, pending, kw = _fair_preempt_case(case, cuda)
    _build.reset_launches()
    on_card = pd.run_drain_fair_preempt(take_snapshot(cache), pending, cache.flavors,
                                        device="cuda", **kw)
    counts = _build.launch_counts()
    on_cpu = pd.run_drain_fair_preempt(take_snapshot(cache), pending, cache.flavors,
                                       device="cpu", **kw)
    assert _preempt_view(on_card) == _preempt_view(on_cpu)
    assert all(counts[name] > 0 for name in FAIR_PREEMPT_KERNELS)
    assert counts["drain_preempt_search"] == 0 and counts["drain_preempt_phase2"] == 0


def test_fair_scheduler_on_card_matches_cpu(cuda):
    from kueue_tpu_torch.perf import contended, fairpreempt as fp
    from kueue_tpu_torch.perf.lockstep import fair_search_through

    def run(dev, check=None):
        env = fp.build_fair_preempt(fp.SMALL_N_CQ)
        sched = fp.build_scheduler(env, use_solver=True, use_preempt_solver=True, device=dev)
        if check is None:
            return contended.run_cycles(sched, env, 6)
        with fair_search_through(check), cycle_kernels_through(check):
            return contended.run_cycles(sched, env, 6)

    errs = {}
    check = Lockstep(errs, label="fair cut")
    _build.reset_launches()
    on_card = run("cuda", check)
    counts = _build.launch_counts()
    assert on_card == run("cpu")
    assert check.failures == [] and not any(errs.values())
    assert counts["fair_search"] > 0 and check.launches["fair_search"] > 0
    assert all(r["victim_search"] == ["device"] for r in on_card if r["preempting"])


def test_fair_preempt_paths_raise_when_a_kernel_does_not_build(cuda, monkeypatch, tmp_path):
    from kueue_tpu_torch.perf import fairpreempt as fp

    env = fp.build_fair_preempt(12)
    _broken(monkeypatch, tmp_path, "drain_fair_preempt_search")
    with pytest.raises(_build.KernelError, match="drain_fair_preempt_search"):
        pd.run_drain_fair_preempt(take_snapshot(env.cache), env.pending, env.cache.flavors,
                                  device="cuda")
    with pytest.raises(_build.KernelError):
        fp.build_scheduler(env, use_preempt_solver=True, device="cuda")


_B9_FAULT_RUN = """
import pathlib, sys
from kueue_tpu_torch.ops import _build
from kueue_tpu_torch.perf import fairpreempt as fp

_build.CSRC = pathlib.Path(sys.argv[1])
_build.BUILD_DIR = _build.CSRC.parent / "build"
env = fp.build_fair_preempt(12)
sched = fp.build_scheduler(env, use_preempt_solver=True, device="cuda")
host = []
real = sched.preemptor.get_targets
sched.preemptor.get_targets = lambda *a, **k: host.append(a) or real(*a, **k)
try:
    for _ in range(4):
        sched.schedule()
except _build.KernelError as exc:
    print("KernelError", host == [], exc)
    sys.exit(0)
print("no KernelError; host searches", len(host))
sys.exit(1)
"""


def test_fair_scheduler_raises_when_b9_faults_on_the_card(cuda, tmp_path):
    """A fair_search build that traps on the card: the fault surfaces at
    the batched search's fetch and schedule() raises KernelError instead
    of returning the host Preemptor's decisions. It runs in a process of
    its own, since a trap leaves that process's CUDA context unusable."""
    import pathlib
    import subprocess
    import sys

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in _build.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            (csrc / src.name).write_text(src.read_text())
    body = (csrc / "fair_search.cu").read_text()
    entry = "  const int w = blockIdx.x;\n"
    assert entry in body
    (csrc / "fair_search.cu").write_text(
        body.replace(entry, entry + "  if (threadIdx.x == 0) __trap();\n", 1))
    repo = pathlib.Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, "-c", _B9_FAULT_RUN, str(csrc)], cwd=repo,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout + run.stderr
    assert run.stdout.startswith("KernelError True"), run.stdout


# ---- Topology-Aware Scheduling (B12, B13) ----------------------------------


def _tas_inputs(dev, spec):
    from kueue_tpu_torch.perf import tas as tas_perf

    env = tas_perf.build_tas_env(spec)
    return env, pd.tas_drain_inputs(take_snapshot(env.cache), env.pending, env.cache.flavors,
                                    env.tas, dev, timestamp_fn=env.ts_fn)


def _tas_specs():
    from kueue_tpu_torch.perf import tas as tas_perf

    return {
        "two_flavors": cases.tas_spec(0),
        "bench_cut": tas_perf.drain_spec(np.random.default_rng(6), 12, 12, shape=(2, 4, 8)),
    }


@pytest.mark.parametrize("case", ["two_flavors", "bench_cut"])
def test_tas_drain_kernels_bit_exact_every_cycle(cuda, case):
    """Every launch of the TAS cycle (drain_tas_place and
    drain_tas_phase2 among them) equal to its plain version at every
    cycle, and the drain on the card equal to its CPU run."""
    from kueue_tpu_torch.perf import tas as tas_perf
    from kueue_tpu_torch.perf.lockstep import TAS_DRAIN_KERNELS, lockstep_tas

    spec = _tas_specs()[case]
    env, inp = _tas_inputs(cuda, spec)
    errs = {}
    _, state, cycles = lockstep_tas(*inp.solve_args(), errs, label=case)
    assert cycles > 0 and set(errs) == set(TAS_DRAIN_KERNELS)
    assert all(e == 0 for e in errs.values())
    assert int((state.adm_cycle >= 0).sum()) > 0
    outs = []
    for d in (cuda, "cpu"):
        e = tas_perf.build_tas_env(spec)
        _build.reset_launches()
        outs.append(pd.run_drain_tas(take_snapshot(e.cache), e.pending, e.cache.flavors, e.tas,
                                     timestamp_fn=e.ts_fn, device=d))
        if d == cuda:
            assert all(_build.launch_counts()[k] > 0 for k in TAS_DRAIN_KERNELS)
    assert tas_perf.drain_summary(outs[0]) == tas_perf.drain_summary(outs[1])


@pytest.mark.parametrize("n_steps", [None, 2])
@pytest.mark.parametrize("seed", range(4))
def test_tas_phase2_bit_exact_at_the_scan_edges(cuda, seed, n_steps):
    """drain_tas_phase2, with the TAS cycle's other launches, equal to its
    plain version at every cycle of perf.cases.tas_scan_spec (four
    topology resources, gangs over more than 64 leaves, two heads on the
    same leaves in one cycle, plain heads, ties, reserves); with
    n_steps = 2 a cycle's later ranks are dropped."""
    from kueue_tpu_torch.perf.lockstep import TAS_DRAIN_KERNELS, lockstep_tas

    _, inp = _tas_inputs(cuda, cases.tas_scan_spec(seed))
    args = list(inp.solve_args())
    if n_steps is not None:
        args[9:11] = [n_steps, 48]
    errs = {}
    _, state, cycles = lockstep_tas(*args, errs, label=f"tas_scan_spec({seed})")
    assert cycles > 0 and set(errs) == set(TAS_DRAIN_KERNELS)
    assert all(e == 0 for e in errs.values())
    assert int((state.adm_cycle >= 0).sum()) > 0


@pytest.mark.parametrize("shape", [(8, 16, 8), (4, 8, 64)])
def test_tas_leaf_counts_bit_exact(cuda, shape):
    """B12's two entries against their plain versions on a batch with
    nonzero assumed usage, a simulate_empty row and taint-masked leaves;
    the snapshot's device path (threshold lowered) equal to the CPU."""
    from kueue_tpu_torch.ops import tas_kernel as tk
    from kueue_tpu_torch.perf import tas as tas_perf
    from kueue_tpu_torch.perf.lockstep import Lockstep, leaf_counts_step

    fc, req = tas_perf.build_placement(shape)
    snap = fc.snapshot(cuda)
    snap.freeze()
    topo = tk.topology_from_snapshot(snap, cuda)
    n_l, n_r = topo.free.shape
    rng = np.random.default_rng(sum(shape))
    b = 16
    reqs = rng.integers(0, 3000, (b, n_r))
    assumed = rng.integers(0, 20000, (b, n_l, n_r))
    taint_ok = rng.random((b, n_l)) < 0.95
    sim = np.zeros(b, dtype=bool)
    sim[3] = True
    errs = {}
    leaf_counts_step(topo, to_device(reqs, cuda, np.int64), to_device(assumed, cuda, np.int64),
                     to_device(taint_ok, cuda, np.bool_), to_device(sim, cuda, np.bool_),
                     Lockstep(errs, f"b12 {shape}"))
    assert errs == {"tas_leaf_counts": 0}
    from kueue_tpu_torch.tas.snapshot import TASFlavorSnapshot

    old = TASFlavorSnapshot.DEVICE_LEAF_THRESHOLD
    TASFlavorSnapshot.DEVICE_LEAF_THRESHOLD = 1
    try:
        outs = []
        for d in (cuda, "cpu"):
            _build.reset_launches()
            r = fc.snapshot(d).find_topology_assignments([req])
            outs.append((r.failure_reason, sorted((x.values, x.count)
                                                  for x in r.assignments["main"].domains)
                         if r.assignments["main"] is not None else None))
            if d == cuda:
                assert _build.launch_counts()["tas_leaf_counts"] > 0
        assert outs[0] == outs[1]
    finally:
        TASFlavorSnapshot.DEVICE_LEAF_THRESHOLD = old


@pytest.mark.parametrize("seed", range(4))
def test_tas_place_bit_exact_at_the_placement_edges(cuda, seed):
    """drain_tas_place, with the TAS cycle's other launches, equal to its
    plain version at every cycle of perf.cases.tas_edge_spec."""
    from kueue_tpu_torch.perf.lockstep import TAS_DRAIN_KERNELS, lockstep_tas

    _, inp = _tas_inputs(cuda, cases.tas_edge_spec(seed))
    errs = {}
    _, state, cycles = lockstep_tas(*inp.solve_args(), errs, label=f"tas_edge_spec({seed})")
    assert cycles > 0 and set(errs) == set(TAS_DRAIN_KERNELS)
    assert all(e == 0 for e in errs.values())
    assert int((state.adm_cycle >= 0).sum()) > 0


def test_tas_place_bit_exact_at_2048_domains(cuda):
    """drain_tas_place at the lowering's cap of ND = 2048 domains a level
    (16 blocks x 8 racks x 16 hosts), 24 cycles of a 12-queue cut."""
    from kueue_tpu_torch.perf import tas as tas_perf
    from kueue_tpu_torch.perf.lockstep import TAS_DRAIN_KERNELS, lockstep_tas

    spec = tas_perf.drain_spec(np.random.default_rng(6), 12, 12, shape=(16, 8, 16))
    _, inp = _tas_inputs(cuda, spec)
    assert max(inp.n_domains) == 2048 == dk.MAX_TAS_ND
    errs = {}
    _, _, cycles = lockstep_tas(*inp.solve_args(), errs, label="nd-2048", stop_after=24)
    assert cycles > 0 and set(errs) == set(TAS_DRAIN_KERNELS)
    assert all(e == 0 for e in errs.values())


def test_tas_drain_raises_when_a_kernel_does_not_build(cuda, monkeypatch, tmp_path):
    env, _ = _tas_inputs("cpu", cases.tas_spec(1))
    _broken(monkeypatch, tmp_path, "drain_tas_place")
    with pytest.raises(_build.KernelError, match="drain_tas_place"):
        pd.run_drain_tas(take_snapshot(env.cache), env.pending, env.cache.flavors, env.tas,
                         timestamp_fn=env.ts_fn, device="cuda")


# ---- the planner's scenario-batched solve (kernel B14) --------------------


@pytest.mark.parametrize("seed,s,drop", [(0, 1, False), (1, 5, False), (2, 17, False),
                                         (3, 5, True)])
def test_plan_kernels_bit_exact_on_random_batches(cuda, seed, s, drop):
    from kueue_tpu_torch.perf.cases import plan_batch
    from kueue_tpu_torch.perf.lockstep import PLAN_KERNELS, plan_solve

    b = plan_batch(seed, s, drop_steps=drop, w=64, k=8, c=16)
    inp = interop.plan_inputs(b, cuda)
    errs = {}
    _build.reset_launches()
    buf = plan_solve(**inp, n_segments=b["n_segments"], n_steps=b["n_steps"],
                     check=Lockstep(errs, label=f"plan batch {seed}"))
    torch.cuda.synchronize()
    assert errs == {name: 0 for name in PLAN_KERNELS}
    assert all(_build.launch_counts()[name] == 1 for name in PLAN_KERNELS)
    from kueue_tpu_torch.ops import plan_kernel as plk

    per_head, usage = plk.solve_scenarios_plain(
        **interop.plan_inputs(b, "cpu"), n_segments=b["n_segments"], n_steps=b["n_steps"])
    n, fr = b["nominal_s"].shape[1:]
    ph, u = plk.unpack(buf.cpu(), s, b["heads"]["cq_row"].shape[0], n, fr)
    assert torch.equal(ph, per_head) and torch.equal(u, usage)
    assert bool((ph[:, 1] > 0).any())


def test_planner_on_card_matches_cpu(cuda):
    """Planner.plan on the card at a cut of planner-stage-500 with a
    scenario of every delta kind: one B14 call (its three launches),
    every launch bit-exact, the report equal to the CPU's."""
    from kueue_tpu_torch.perf import planner as pp
    from kueue_tpu_torch.perf.lockstep import PLAN_KERNELS, plan_kernels_through
    from kueue_tpu_torch.planner.scenarios import (
        BorrowingLimitDelta,
        PlanScenario,
        PolicyDelta,
        PriorityDelta,
    )

    reps = []
    for d in (cuda, "cpu"):
        planner, sweep, cache, mgr = pp.build_stage(n_cq=12, n_scenarios=12, device=d)
        sweep += [
            PlanScenario("prio", (PriorityDelta("ns/pwl-3-9", 100),)),
            PlanScenario("borrow", (BorrowingLimitDelta("pcq-1", "default", "cpu", 4000),)),
            PlanScenario("gavel", (PolicyDelta("gavel"),)),
        ]
        errs = {}
        _build.reset_launches()
        with plan_kernels_through(Lockstep(errs, label="planner")):
            rep = planner.plan(scenarios=sweep, include_reasons="all", verify_host=True)
        if d == cuda:
            assert errs == {name: 0 for name in PLAN_KERNELS}
            assert all(_build.launch_counts()[name] == 1 for name in PLAN_KERNELS)
        out = rep.to_dict()
        for k in ("durationMs", "sweepMs", "scenariosPerSecond"):
            out.pop(k)
        reps.append(out)
    assert reps[0] == reps[1]


def test_scored_cycle_on_card_after_the_body_refactor(cuda):
    """A Gavel-scored Scheduler on the card: every cycle launch (B2 and
    B3 over cycle_body.cuh) bit-exact, the decisions and score
    breakdowns equal to the CPU's."""
    from kueue_tpu_torch.core.scheduler import Scheduler
    from kueue_tpu_torch.perf import planner as pp
    from kueue_tpu_torch.policy import resolve_policy

    runs = []
    for d in (cuda, "cpu"):
        env = pp.build_policy(np.random.default_rng(pp.POLICY_SEED), n_cq=12, wl_per_cq=12)
        sched = Scheduler(queues=env.mgr, cache=env.cache, clock=env.clock, use_solver=True,
                          solver_threshold=1, device=d, policy=resolve_policy("gavel"))
        errs = {}
        trace = []
        with cycle_kernels_through(Lockstep(errs, label="gavel cycle")):
            for _ in range(5):
                r = sched.schedule()
                trace.append((sorted((e.workload.name,
                                      tuple(e.workload.admission.pod_set_assignments[0]
                                            .flavors.items())) for e in r.admitted),
                              dict(sched._cycle_scores)))
        assert all(e == 0 for e in errs.values())
        runs.append(trace)
    assert runs[0] == runs[1] and runs[0][0][0]


def test_planner_raises_when_a_plan_kernel_does_not_build(cuda, monkeypatch, tmp_path):
    from kueue_tpu_torch.perf import planner as pp

    _broken(monkeypatch, tmp_path, "plan_phase2")
    planner, sweep, _, _ = pp.build_stage(n_cq=4, n_scenarios=2, device=cuda)
    with pytest.raises(_build.KernelError, match="plan_phase2"):
        planner.plan(scenarios=sweep)


# ---- the mesh harness: the unsegmented cycle (B3') and the DRS (B1') --------


def _cycle_global_exact(cuda, b):
    """One cycle_global launch on the batch equal to cycle_global_plain
    bit for bit, usage tree included; solve_cycle (B3') equal to the
    segmented solve (B3) on the same heads."""
    from kueue_tpu_torch.ops import assign_kernel as ak
    from kueue_tpu_torch.ops import quota as q

    tree, heads = interop.quota_tree(b, cuda), interop.heads_batch(b, cuda)
    local = torch.tensor(b["local_usage"], device=cuda)
    paths = torch.tensor(b["paths"], device=cuda)
    sub, g = q.subtree_quota(tree)
    usage = q.usage_tree(tree, g, local)
    ph = ak.phase1_classify(tree, sub, g, local, heads)
    u2 = usage.clone()
    before = _build.launch_counts()["cycle_global"]
    packed = ak.cycle_global(tree, sub, g, usage, paths, heads, *ph)
    assert _build.launch_counts()["cycle_global"] == before + 1
    assert torch.equal(packed, ak.cycle_global_plain(tree, sub, g, u2, paths, heads, *ph))
    assert torch.equal(usage, u2)
    got = ak.solve_cycle(tree, local, heads, paths)
    seg = ak.solve_cycle_segmented(tree, local, heads, paths, b["seg_id"],
                                   max(b["n_segments"], 1), max(b["n_steps"], 1))
    for f in ("chosen", "admitted", "borrows", "reserved", "usage", "order"):
        assert torch.equal(getattr(got, f), getattr(seg, f)), f


@pytest.mark.parametrize("seed,kw", [(s, {}) for s in range(6)]
                         + [(s, {"w": 200, "n_cq": 60, "fr": 12}) for s in (6, 7)]
                         + [(8, {"w": 1024, "n_cq": 400, "fr": 17, "depth": 1})])
def test_cycle_global_bit_exact_on_random_batches(cuda, seed, kw):
    _cycle_global_exact(cuda, cases.cycle_batch(seed, **kw))


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("edge", cases.GLOBAL_EDGES)
def test_cycle_global_bit_exact_at_the_edges(cuda, edge, seed):
    """The CPU tests' edges (tests/test_torch_tas_scan.py): a tree beyond
    one block's shared memory, one root holding most heads, cohort-less
    ClusterQueues, paths of 8 levels, pads and no-fit heads, W = 37."""
    _cycle_global_exact(cuda, cases.global_batch(edge, seed))


def test_cycle_global_refuses_a_tree_beyond_shared_memory(cuda):
    """The refusal this test held is gone: the 288 kB usage tree of 3000
    ClusterQueues x FR 12, beyond one block's shared memory, launches
    once, equals cycle_global_plain bit for bit and equals the segmented
    solve."""
    b = cases.cycle_batch(0, w=8, n_cq=3000, fr=12)
    assert 8 * b["nominal"].size > 232448
    _cycle_global_exact(cuda, b)


@pytest.mark.parametrize("seed", range(4))
def test_quota_drs_bit_exact_on_random_forests(cuda, seed):
    from kueue_tpu_torch.ops import quota as q

    b = cases.cycle_batch(seed, n_cq=30, fr=8)
    tree = interop.quota_tree(b, cuda)
    n, fr = tree.nominal.shape
    rng = np.random.default_rng(seed)
    n_res = int(rng.integers(1, 4))
    ri = torch.tensor(np.sort(rng.integers(0, n_res, fr)).astype(np.int32), device=cuda)
    w = torch.tensor(rng.choice([0, 3, 500, 1000, 2000], n), device=cuda)
    local = torch.tensor(b["local_usage"] * 2, device=cuda)
    sub, g = q.subtree_quota(tree)
    usage = q.usage_tree(tree, g, local)
    req = torch.tensor(rng.integers(0, 20, (n, fr)) * (rng.random((n, fr)) < 0.3), device=cuda)
    before = _build.launch_counts()["quota_drs"]
    assert torch.equal(q.lendable_per_resource(tree, sub, g, ri, n_res),
                       q.lendable_per_resource_plain(tree, sub, g, ri, n_res))
    for wr in (torch.zeros_like(req), req):
        d, dom = q.dominant_resource_share(tree, sub, g, usage, wr, w, ri, n_res)
        pd_, pdom = q.dominant_resource_share_plain(tree, sub, g, usage, wr, w, ri, n_res)
        assert torch.equal(d, pd_) and torch.equal(dom, pdom)
        assert (dom >= 0).any()
    assert _build.launch_counts()["quota_drs"] == before + 3


def test_one_card_mesh_drain_and_dispatch_equal_the_unsharded_run(cuda):
    from kueue_tpu_torch import entry
    from kueue_tpu_torch.core import solver
    from kueue_tpu_torch.parallel import ShardedSolver, make_mesh
    from kueue_tpu_torch.parallel.sharded_solver import Mesh

    one = make_mesh(1)
    assert one.shape == {"wl": 1} and one.distinct_devices() == (torch.device("cuda", 0),)
    # the same card eight times: every Q and W axis padded with inert rows
    eight = Mesh(np.array([torch.device("cuda", 0)] * 8, dtype=object), ("wl",))
    for mesh in (one, eight):
        for case in (entry.drain_case, entry.fair_drain_case):
            fair = case is entry.fair_drain_case
            ref = run_drain(*case(), fair_sharing=fair, device="cuda")
            got = run_drain(*case(), fair_sharing=fair, mesh=mesh)
            assert _view(got) == _view(ref)
        snap, pending, flavors = entry.preempt_drain_case()
        heads = [(w, c) for w, c in pending if len(w.pod_sets) == 1]
        low = solver.lower_heads(snap, heads, flavors)
        a = solver.dispatch_lowered(snap, low, device="cuda")
        b = solver.dispatch_lowered(snap, low, mesh=mesh)
        for f in ("chosen", "admitted", "borrows", "reserved", "order"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
    fn, args = entry.entry(device="cuda")
    for mesh in (one, eight):
        got = ShardedSolver(mesh)(*args)
        ref = fn(*args)
        w = ref.admitted.shape[0]
        for f in ("chosen", "admitted", "borrows", "reserved"):
            assert torch.equal(getattr(got, f)[:w], getattr(ref, f)), f
        assert torch.equal(got.usage, ref.usage)


def test_entry_on_the_card_equals_its_plain_version(cuda):
    from kueue_tpu_torch import entry
    from kueue_tpu_torch.ops import assign_kernel as ak

    fn, args = entry.entry()
    assert args[1].is_cuda
    got, ref = fn(*args), ak.solve_cycle_plain(*args)
    for f in ("chosen", "admitted", "borrows", "reserved", "usage", "order"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


def test_drs_raises_when_its_kernel_does_not_build(cuda, monkeypatch, tmp_path):
    from kueue_tpu_torch.ops import quota as q

    b = cases.cycle_batch(0)
    tree = interop.quota_tree(b, cuda)
    _broken(monkeypatch, tmp_path, "quota_drs")
    ri = torch.zeros(tree.nominal.shape[1], dtype=torch.int32, device=cuda)
    with pytest.raises(_build.KernelError, match="quota_drs"):
        q.lendable_per_resource(tree, tree.nominal, tree.nominal, ri, 1)


_B3G_FAULT_RUN = """
import pathlib, sys
from kueue_tpu_torch.ops import _build
from kueue_tpu_torch import entry
from kueue_tpu_torch.parallel import ShardedSolver, make_mesh

_build.CSRC = pathlib.Path(sys.argv[1])
_build.BUILD_DIR = _build.CSRC.parent / "build"
fn, args = entry.entry(device="cuda")
try:
    out = ShardedSolver(make_mesh(1))(*args)
    out.admitted.cpu()
except Exception as exc:  # a fault at the launch or at the first sync after it
    print("raised", type(exc).__name__, _build.launch_counts()["cycle_global"])
    sys.exit(0)
print("no error")
sys.exit(1)
"""


def test_a_faulting_cycle_global_raises_and_is_not_contained(cuda, tmp_path):
    """A cycle_global build that traps on the card: ShardedSolver's
    result raises at its first sync; nothing solves on the host in its
    place. In a process of its own, as a trap leaves that process's
    CUDA context unusable."""
    import pathlib
    import subprocess
    import sys

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in _build.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            (csrc / src.name).write_text(src.read_text())
    body = (csrc / "cycle_global.cu").read_text()
    entry = "  const int b = blockIdx.x, G = gridDim.x;\n"
    assert entry in body
    (csrc / "cycle_global.cu").write_text(
        body.replace(entry, entry + "  if (threadIdx.x == 0) __trap();\n", 1))
    repo = pathlib.Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, "-c", _B3G_FAULT_RUN, str(csrc)], cwd=repo,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout + run.stderr
    assert run.stdout.startswith("raised") and run.stdout.split()[-1] == "1", run.stdout


# ---- the runtime and the federation (B15) ---------------------------------


def _b15_batch(rng):
    """One random B15 input: mostly small fleets, some up to C=4096 and
    W in the thousands, with degraded columns, wide rotations and
    current columns past C."""
    from kueue_tpu_torch.perf.cases import rescore_fleet

    kind = int(rng.integers(0, 4))
    if kind == 0:
        return rescore_fleet(rng)
    if kind == 1:
        c = int(rng.integers(1, 4097))
        w = int(rng.integers(1, max(2, 2_000_000 // c)))
    else:
        c = int(rng.integers(2, 129))
        w = int(rng.integers(1, 4096))
    return rescore_fleet(rng, w=w, c=c, invalid=float(rng.choice([0.0, 0.25, 0.9, 1.0])),
                         n_degraded=int(rng.integers(0, c + 1)) if kind != 3 else None,
                         wide_rotation=kind == 3, current_past=kind >= 2)


def test_global_rescore_bit_exact_on_random_batches(cuda):
    from kueue_tpu_torch.ops import global_kernel as gk
    from kueue_tpu_torch.ops import global_np as gnp

    rng = np.random.default_rng(915)
    _build.reset_launches()
    n = 0
    for i in range(200):
        a = _b15_batch(rng)
        w, c = a["tta_ms"].shape
        if w == 0:
            continue
        deg = a.get("degraded", np.zeros(c, bool))
        pen = a.get("degraded_penalty_ms", 0)
        t = gk.rescore_inputs(a["tta_ms"], a["score"], a["valid"], a["current"],
                              a["rotation"], deg, cuda)
        card = gk.rescore_packed(*t, a["hysteresis_ms"], pen)
        plain = gk.rescore_plain(*t, a["hysteresis_ms"], pen)
        assert torch.equal(card, plain), (i, w, c)
        ref = gnp.rescore_np(**a)
        got = gk.decode(card.cpu().numpy())
        for f in ("best", "best_key", "gain_ms", "rebalance"):
            assert np.array_equal(getattr(got, f), getattr(ref, f)), (i, f)
        n += 1
    assert _build.launch_counts()["global_rescore"] == n


def test_rescore_pairs_on_the_card_equals_the_cpu(cuda):
    from kueue_tpu_torch.ops import global_kernel as gk
    from kueue_tpu_torch.perf.cases import rescore_fleet

    a = rescore_fleet(np.random.default_rng(3), w=300, c=50, n_degraded=4)
    on_card = gk.rescore_pairs(**a)
    on_cpu = gk.rescore_pairs(**a, device="cpu")
    for f in ("best", "best_key", "gain_ms", "rebalance"):
        assert np.array_equal(getattr(on_card, f), getattr(on_cpu, f)), f
    with pytest.raises(ValueError, match="4096-cluster"):
        gk.rescore_pairs(**rescore_fleet(np.random.default_rng(0), w=1, c=4097))


def _runtime_view(rt):
    from kueue_tpu_torch.perf import runtime as prt

    return (prt.admitted_summary(rt), [(e.kind, e.object_key) for e in rt.events])


@pytest.mark.parametrize("mode,chunk,megaloop", [("serial", 16, "off"), ("on", 4, "off"),
                                                 ("on", 4, "4")])
def test_runtime_on_the_card_drains_through_the_kernels(cuda, mode, chunk, megaloop):
    from kueue_tpu_torch.perf import runtime as prt

    cut = dict(n_cq=32, wl_per_cq=14, n_flavors=2, n_cohort=4)
    _build.reset_launches()
    rt = prt.build_drain_loop_rt(mode, 5, chunk=chunk, megaloop=megaloop, device="cuda", **cut)
    rt.run_until_idle()
    counts = _build.launch_counts()
    ref = prt.build_drain_loop_rt(mode, 5, chunk=chunk, megaloop=megaloop, device="cpu", **cut)
    ref.run_until_idle()
    assert _runtime_view(rt) == _runtime_view(ref)
    assert rt.guard.health()["failovers"] == 0
    for name in DRAIN_KERNELS:
        assert counts[name] > 0, name
    if megaloop != "off":
        assert counts["megaloop_boundary"] > 0 and rt.megaloop.launches >= 1


def test_federation_on_the_card_equals_the_cpu(cuda):
    from kueue_tpu_torch.perf import multikueue as pmk

    reps = {}
    res = {}
    for dev in ("cuda", "cpu"):
        reps[dev] = []
        _build.reset_launches()
        res[dev] = pmk.run_federation_scale(n_workers=8, n_workloads=40, device=dev,
                                            on_scheduler=pmk.record_rescores(reps[dev]))
        if dev == "cuda":
            launches = _build.launch_counts()["global_rescore"]
    assert pmk.fed_scale_summary(res["cuda"]) == pmk.fed_scale_summary(res["cpu"])
    assert pmk.rebalance_digest(reps["cuda"]) == pmk.rebalance_digest(reps["cpu"])
    with_rows = [r for r in reps["cuda"] if r["pending"]]
    assert with_rows and all(r["path"] == "device" for r in with_rows)
    assert launches == len(with_rows)


@pytest.mark.parametrize("megaloop", ["off", "4"])
def test_wrong_drain_round_raises_on_the_card(cuda, monkeypatch, megaloop):
    """A drain round on the card whose admissions come back one cycle
    late (planted at the fetch) is caught by the sampled check against
    the numpy mirror: bulk_drain raises KernelError naming the field,
    with no failover and the device path not quarantined."""
    from kueue_tpu_torch.perf import runtime as prt

    real_drain, real_mega = pd.DrainLaunch.fetch, pd.MegaloopLaunch.fetch

    def late(outcome):
        outcome.admitted = [(wl, cq, fl, cyc + 1) for wl, cq, fl, cyc in outcome.admitted]
        return outcome

    def mega(self):
        log = real_mega(self)
        for outcome in log.rounds:
            late(outcome)
        return log

    rt = prt.build_drain_loop_rt("on", 5, chunk=4, megaloop=megaloop, device="cuda",
                                 n_cq=32, wl_per_cq=14, n_flavors=2, n_cohort=4)
    rt.guard.config.divergence_check_every = 1
    monkeypatch.setattr(pd.DrainLaunch, "fetch", lambda self: late(real_drain(self)))
    monkeypatch.setattr(pd.MegaloopLaunch, "fetch", mega)
    _build.reset_launches()
    with pytest.raises(_build.KernelError, match="admitted"):
        rt.bulk_drain()
    assert _build.launch_counts()["drain_nominate"] > 0
    health = rt.guard.health()
    assert health["divergences"] == 1 and health["failovers"] == 0
    assert rt.guard.path == "device"


def test_rescore_raises_when_b15_faults_on_the_card(cuda, tmp_path):
    """A global_rescore build that traps: GlobalScheduler.rescore raises
    KernelError and the numpy mirror never runs in its place."""
    from kueue_tpu_torch.perf import trap

    run = trap.run_trapped("global_rescore", trap.RESCORE_RUN, tmp_path)
    assert run.returncode == 0, run.stdout + run.stderr
    assert run.stdout.startswith("KernelError True"), run.stdout


def test_drain_round_raises_when_a_kernel_faults_on_the_card(cuda, tmp_path):
    """A drain_nominate build that traps: the pipelined drain round's
    device_join raises KernelError out of bulk_drain, with no failover
    and nothing admitted."""
    from kueue_tpu_torch.perf import trap

    run = trap.run_trapped("drain_nominate", trap.DRAIN_RUN, tmp_path)
    assert run.returncode == 0, run.stdout + run.stderr
    assert run.stdout.startswith("KernelError True"), run.stdout


# ---- the redesigned kernels at their edges: B4's nomination (a warp a
# queue head) and B3 (cycle_phase2 on shared or device-memory rows) ----


# (k, c, p, g): K*C = 64, 96, 128 pairs (two to four lanes deep), P = kMaxP
# podsets repeating cells, G = 8 groups, tied flavor indices and scores
NOMINATE_EDGES = {
    "fold-2": dict(k=16, c=4, p=1, g=2),
    "fold-3": dict(k=12, c=8, p=2, g=3),
    "fold-4": dict(k=16, c=8, p=1, g=4, fr=10),
    "podsets-4": dict(k=4, c=3, p=dk.MAX_P, g=2, fr=4),
    "groups-8": dict(k=8, c=8, p=2, g=dk.MAX_G, fr=9),
    "unscored": dict(k=8, c=3, p=1, g=2, scored=False),
}


def _nominate_step(ctx, state, buf):
    """drain_nominate on the card against drain_nominate_plain on
    copies; returns the kernel's buffers."""
    ps, pb = state.clone(), buf.clone()
    _build.reset_launches()
    dk.drain_nominate(ctx, state, buf)
    dk.drain_nominate_plain(ctx, ps, pb)
    torch.cuda.synchronize()
    assert _build.launch_counts()["drain_nominate"] == 1
    for name in ("is_fit", "is_pre", "pend", "head_borrow", "rep_k", "walk_next",
                 "cells_eff", "qty_eff", "admitted"):
        assert torch.equal(getattr(buf, name), getattr(pb, name)), name
    return buf


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("shape", sorted(NOMINATE_EDGES))
def test_nominate_bit_exact_at_edge_shapes(cuda, shape, seed):
    b = cases.nominate_batch(seed, q=61, **NOMINATE_EDGES[shape])
    ctx, state, buf = cases.nominate_inputs(b, cuda)
    buf.admitted.fill_(True)  # the nomination clears it
    out = _nominate_step(ctx, state, buf)
    assert bool(out.is_fit.any() or out.is_pre.any())
    assert not bool(out.admitted.any())


def test_nominate_done_is_a_no_op_and_retired_queues_nominate_nothing(cuda):
    b = cases.nominate_batch(3, q=40, k=12, c=8, p=3, g=3)
    ctx, state, buf = cases.nominate_inputs(b, cuda)
    state.alive.zero_()
    out = _nominate_step(ctx, state, buf)
    assert not bool(out.is_fit.any() or out.is_pre.any())
    assert bool((out.rep_k == -1).all() and (out.cells_eff == -1).all())
    ctx, state, buf = cases.nominate_inputs(b, cuda)
    state.done.fill_(1)
    buf.admitted.fill_(True)
    before = buf.clone()
    out = _nominate_step(ctx, state, buf)
    for f in ("is_fit", "rep_k", "walk_next", "cells_eff", "qty_eff", "admitted"):
        assert torch.equal(getattr(out, f), getattr(before, f)), f


def test_nominate_oracle_over_pools_wider_than_a_warp(cuda):
    """The reclaim oracle's victim loop split over the lanes, V = 128
    pool entries a segment: every launch of the preempt cycle held to its
    plain version over the contended cut's first cycles."""
    from kueue_tpu_torch.perf.lockstep import PREEMPT_KERNELS, lockstep_preempt

    env = _contended_cut(40)
    plan, _, tree, paths, local, queues, victims = _preempt_case(
        env.cache, env.pending, cuda, env.ts_fn)
    assert victims.sowner.shape[1] > 32
    errs = {}
    _, state, cycles = lockstep_preempt(
        tree, local, queues, victims, paths, plan.n_segments, plan.n_steps,
        plan.max_cycles, 64, errs, label="contended-40, V=128", stop_after=24,
    )
    assert cycles == 24 and bool(state.vevicted.any())
    assert set(errs) == set(PREEMPT_KERNELS) and not any(errs.values())


# cycle_batch with one root cohort holding most ClusterQueues (depth 1):
# its segment outgrows cycle_phase2's shared rows, the parentless
# ClusterQueues' segments do not; W not a multiple of 32, pads; the
# drop cases rank fewer steps than the largest segment. Depth 6 (paths of
# 7 levels) walks level by level, on device-memory rows at W=200 and on
# shared rows at W=40.
CYCLE_EDGES = [(1, 400, False, 1), (6, 477, True, 1), (1, 77, True, 1), (3, 1000, False, 1),
               (0, 200, False, 6), (2, 40, True, 6)]


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("seed,w,drop,depth", CYCLE_EDGES)
def test_cycle_phase2_bit_exact_on_shared_and_device_rows(cuda, seed, w, drop, depth, dup):
    """With ``dup`` every third head's candidates repeat a cell (two
    lanes add at each level, as the JAX .at[].add does)."""
    from kueue_tpu_torch.ops import assign_kernel as ak
    from kueue_tpu_torch.ops import quota

    n_cq = w if depth == 1 else w // 3
    b = cases.cycle_batch(seed, w=w, k=4, c=8, depth=depth, n_cq=n_cq, fr=17,
                          drop_steps=drop)
    if dup:
        b["cells"][::3, :, 1] = np.where(b["cells"][::3, :, 1] >= 0, b["cells"][::3, :, 0], -1)
    tree = interop.quota_tree(b, cuda)
    heads = interop.heads_batch(b, cuda)
    local = torch.as_tensor(b["local_usage"], device=cuda)
    paths = torch.as_tensor(b["paths"], device=cuda)
    errs = {}
    _build.reset_launches()
    packed = cycle_solve(tree, local, heads, paths, b["seg_id"], b["n_segments"],
                         b["n_steps"], Lockstep(errs, label=f"cycle edge {seed}, W={w}"))
    torch.cuda.synchronize()
    assert set(errs) == set(CYCLE_KERNELS) - {"scatter_rows"} and not any(errs.values())
    assert _build.launch_counts()["cycle_phase2"] == 1
    assert bool((packed[1] > 0).any())
    sub, g = quota.subtree_quota(tree)
    chosen, _, pk = ak.phase1_classify(tree, sub, g, local, heads)
    walked = (b["cq_row"] >= 0) & ((chosen >= 0) | (pk >= 0)).cpu().numpy()
    n_walk = np.minimum(np.bincount(b["seg_id"][walked]), b["n_steps"])
    members = int(np.bincount(b["seg_id"][b["seg_id"] >= 0]).max())
    lay = ak.phase2_layout(w, members, 8, 17, b["max_depth"])
    need = [ak.segment_bytes(int(n), 17, b["max_depth"]) for n in n_walk]
    if depth == 1:
        assert min(need) <= lay["rows_bytes"]  # small segments walk on shared rows
    if w >= 200:  # and the big ones on device-memory rows
        assert max(need) > lay["rows_bytes"]
    else:
        assert max(need) <= lay["rows_bytes"]


# ---- B1 (quota_tree, one launch a call site) and B4's phase 2
# (drain_phase2: keys and rows in shared memory) at their edges ----


# (seed, depth, big): a root subtree of `big` nodes (FR = 37) whose
# columns blocks split (300) or that runs on device rows (4000)
QUOTA_EDGES = [(0, 1, 300), (1, 3, 300), (0, 7, 300), (2, 1, 0), (3, 4, 0), (4, 3, 4000)]


@pytest.mark.parametrize("seed,depth,big", QUOTA_EDGES)
def test_quota_tree_one_launch_a_call_site(cuda, seed, depth, big):
    from kueue_tpu_torch.ops import quota

    f = cases.quota_forest(seed, depth=depth, big=big)
    tree = interop.quota_tree(f, cuda)
    local = torch.as_tensor(f["local_usage"], device=cuda)
    want = quota.quota_all_plain(interop.quota_tree(f, "cpu"),
                                 torch.as_tensor(f["local_usage"]))
    every = quota.SUBTREE | quota.USAGE | quota.AVAIL | quota.POTENTIAL
    max_bin, room = tree.forest.max_bin, quota.QUOTA_SHARED_BYTES
    cw = quota.column_chunk(max_bin, 37, every, tree.forest.bins.shape[0])
    assert (quota.bin_shared_bytes(max_bin, 37, every) > room) == (big > 0)
    assert (quota.bin_shared_bytes(max_bin, cw, every) > room) == (big == 4000)
    _build.reset_launches()
    got = quota.quota_all(tree, local)
    torch.cuda.synchronize()
    assert _build.launch_counts()["quota_tree"] == 1
    for name, x, y in zip(("subtree", "guaranteed", "usage", "avail", "potential"), got, want):
        assert torch.equal(x.cpu(), y), name
    sub, g = got[:2]
    u, a = torch.full_like(local, -7), torch.full_like(local, -7)
    _build.reset_launches()
    quota.usage_and_available(tree, sub, g, local, u, a)
    torch.cuda.synchronize()
    assert _build.launch_counts()["quota_tree"] == 1
    assert torch.equal(u.cpu(), want[2]) and torch.equal(a.cpu(), want[3])
    singles = (quota.subtree_quota(tree) + (quota.usage_tree(tree, g, local),
               quota.available_all(tree, sub, g, u), quota.potential_available_all(tree, sub, g)))
    for name, x, y in zip(("subtree", "guaranteed", "usage", "avail", "potential"), singles,
                          want):
        assert torch.equal(x.cpu(), y), name
    done = torch.ones(1, dtype=torch.int32, device=cuda)
    u.fill_(-7)
    quota.usage_and_available(tree, sub, g, local, u, a, done=done)
    assert bool((u == -7).all())


PHASE2_EDGES = {
    "wide": dict(q=160, big=0.9, fr=40),
    "wide-drop": dict(q=160, big=0.9, fr=40, drop=True),
    "deep": dict(q=40, depth=6),
    "deep-drop": dict(q=40, depth=6, drop=True),
    "podsets-3": dict(q=48, p=3, c=3, fr=5),
}


def _phase2_inputs(b, dev):
    """(ctx, state, buffers) of a phase2_batch on ``dev`` after the card's
    quota pass and nomination of its cycle."""
    from kueue_tpu_torch.ops import quota

    qn = b["queues_np"]
    tree, queues, local, paths = interop.drain_inputs(b, qn, dev)
    ctx = dk.DrainContext.build(tree, queues, paths, b["n_segments"], b["n_steps"], 8,
                                seg_id=qn["seg_id"])
    state = dk.DrainState.initial(local, queues, 8)
    for name in ("local", "cursor", "g_start", "alive"):
        getattr(state, name).copy_(torch.as_tensor(b[name]))
    state.done.zero_()
    buf = dk.CycleBuffers.empty(local, queues)
    quota.usage_and_available(ctx.tree, ctx.subtree, ctx.guaranteed, state.local, buf.usage,
                              buf.avail, done=state.done)
    dk.drain_nominate(ctx, state, buf)
    return ctx, state, buf


def _phase2_step(ctx, state, buf):
    """drain_phase2 on the card against drain_phase2_plain on copies."""
    ps, pb = state.clone(), buf.clone()
    _build.reset_launches()
    dk.drain_phase2(ctx, state, buf)
    dk.drain_phase2_plain(ctx, ps, pb)
    torch.cuda.synchronize()
    assert _build.launch_counts()["drain_phase2"] == 1
    for x, y in ((state, ps), (buf, pb)):
        for f in dataclasses.fields(x):
            if f.name != "order":
                assert torch.equal(getattr(x, f.name), getattr(y, f.name)), f.name


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("case", sorted(PHASE2_EDGES))
def test_drain_phase2_bit_exact_at_its_edges(cuda, case, seed, dup):
    """With ``dup`` every third nominated head's second merged cell
    repeats its first (two lanes add at each level, as the JAX .at[].add
    does)."""
    b = cases.phase2_batch(seed, **PHASE2_EDGES[case])
    ctx, state, buf = _phase2_inputs(b, cuda)
    nominated = torch.nonzero(buf.is_fit | buf.is_pre).flatten()
    assert nominated.numel() > 0
    if dup:
        rows = nominated[::3]
        cells, qty = buf.cells_eff[rows], buf.qty_eff[rows]
        ok = (cells[:, 0] >= 0) & (cells[:, 1] >= 0) & (qty[:, 1] > 0)
        assert bool(ok.any())
        cells[:, 1] = torch.where(ok, cells[:, 0], cells[:, 1])
        buf.cells_eff[rows] = cells
    _phase2_step(ctx, state, buf)
    assert bool(buf.admitted.any())


def test_drain_phase2_keys_in_device_memory(cuda):
    """A segment of ~6900 queues: its keys outgrow the block's shared
    memory, so the ranks read them from device memory and the walk runs
    on device rows, in windows."""
    b = cases.phase2_batch(0, q=7000, big=0.99, fr=5)
    qn = b["queues_np"]
    p, c = qn["cells"].shape[2], qn["cells"].shape[4]
    members = int(np.bincount(qn["seg_id"]).max())
    assert not dk.phase2_layout(members, b["n_steps"], p * c, 5, b["max_depth"])["keys"]
    ctx, state, buf = _phase2_inputs(b, cuda)
    _phase2_step(ctx, state, buf)
    assert int(buf.admitted.sum()) > 2 * dk.PHASE2_WINDOW


def test_drain_phase2_done_is_a_no_op(cuda):
    b = cases.phase2_batch(0, **PHASE2_EDGES["wide"])
    ctx, state, buf = _phase2_inputs(b, cuda)
    state.done.fill_(1)
    before_s, before_b = state.clone(), buf.clone()
    _phase2_step(ctx, state, buf)
    for x, y in ((state, before_s), (buf, before_b)):
        for f in dataclasses.fields(x):
            assert torch.equal(getattr(x, f.name), getattr(y, f.name)), f.name


# ---- the fair-preempt search (B11a) and the fair step scan (B7) redesigned ----


@pytest.mark.parametrize("case", ["spec-1", "spec-8", "spec-1-initial", "spec-8-final",
                                  "wide-1"])
def test_fair_preempt_search_bit_exact_at_its_edges(cuda, case):
    """drain_fair_preempt_search, with the fair-preempt cycle's other
    launches, equal to its plain version at every cycle (the search
    edges: tests/test_torch_fair_redesign_edges.py guards that these
    drains reach them)."""
    from kueue_tpu_torch.ops import fair_preempt_kernel as fpk
    from kueue_tpu_torch.perf import fairpreempt as fp
    from kueue_tpu_torch.perf.lockstep import FAIR_PREEMPT_KERNELS, lockstep_fair_preempt

    kind, n, *stack = case.split("-")
    strategy1, has_second = fpk.LESS_THAN_OR_EQUAL_TO_FINAL, True
    if stack:
        strategy1 = {"initial": fpk.LESS_THAN_INITIAL,
                     "final": fpk.LESS_THAN_OR_EQUAL_TO_FINAL}[stack[0]]
        has_second = False
    if kind == "spec":
        cache, pending = build_cache(cases.fair_preempt_spec(int(n)))
        kw, max_cycles = {}, 32
    else:
        env = fp.build_fair_wide(np.random.default_rng(fp.WIDE_SEED), int(n))
        cache, pending, kw, max_cycles = env.cache, env.pending, {"timestamp_fn": env.ts_fn}, 0
    plan, _, tree, paths, local, queues, victims, panels, fair = pd.fair_preempt_drain_inputs(
        take_snapshot(cache), pending, cache.flavors, cuda, **kw)
    if kind == "wide":
        assert victims.perm.shape[1] == 512 and victims.seg_nodes.shape[1] == 64
        assert panels.seg_cells.shape[1] == 64
    errs = {}
    _, state, cycles = lockstep_fair_preempt(
        tree, local, queues, victims, panels, paths, fair, plan.n_segments, plan.n_steps,
        max_cycles or plan.max_cycles, strategy1, has_second, errs, label=case)
    assert cycles > 0 and bool(state.vevicted.any())
    assert set(errs) == set(FAIR_PREEMPT_KERNELS) and not any(errs.values())


@pytest.mark.parametrize("prio_tie", [True, False])
@pytest.mark.parametrize("seed", [2, 4])
def test_fair_phase2_bit_exact_at_its_edges(cuda, seed, prio_tie):
    from kueue_tpu_torch import features

    with features.override("PrioritySortingWithinCohort", prio_tie):
        cache, pending = build_cache(fair_spec(seed))
        _, plan, tree, paths, local, queues, fair = _drain_case(cache, pending, cuda, fair=True)
        errs = {}
        _, state, cycles = lockstep(
            tree, local, queues, paths, plan.n_segments, plan.n_steps, plan.max_cycles, errs,
            label=f"fair seed {seed}, prio_tie {prio_tie}", fair=fair)
    assert cycles > 0 and bool(state.adm_cycle.ge(0).any())
    assert set(errs) == set(FAIR_KERNELS) and not any(errs.values())


@pytest.mark.parametrize("per_team", [70, 150])
def test_fair_phase2_on_segments_beyond_shared_memory(cuda, per_team):
    """fair_spec with 70 and 150 ClusterQueues a team: the org's segment
    holds some 190 and 400 queues. At 70 its usage, subtree, guaranteed
    and borrowing-limit rows (one a node, FR cells) no longer fit beside
    its heads' and nodes' tables; at 150 the tables alone do not."""
    cache, pending = build_cache(fair_spec(4, workloads_per_cq=2, cqs_per_team=per_team))
    _, plan, tree, paths, local, queues, fair = _drain_case(cache, pending, cuda, fair=True)
    seg = plan.queues_np["seg_id"]
    assert np.bincount(seg[seg >= 0]).max() >= 2.5 * per_team
    errs = {}
    _, _, cycles = lockstep(
        tree, local, queues, paths, plan.n_segments, plan.n_steps, plan.max_cycles, errs,
        label=f"fair_spec, {per_team} a team", fair=fair, stop_after=6)
    assert cycles > 0
    assert set(errs) == set(FAIR_KERNELS) and not any(errs.values())
