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
  the megaloop and the fair drain raise KernelError (no fallback).

These tests import neither JAX nor kueue_tpu. On the machine with the
card, which has no JAX, run them without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

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
