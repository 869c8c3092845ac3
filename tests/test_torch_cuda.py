"""The CUDA kernels on the card (marked ``cuda``; skipped where there is
no CUDA device or no nvcc, since a CUDA kernel has no CPU mode).

- the drain's four kernels bit-exact to their plain versions at every
  cycle of seeded drains (kueue_tpu_torch.perf.lockstep), with nonzero
  candidate scores; run_drain on the card equals run_drain(device="cpu");
- the cycle's kernels (quota_tree, cycle_phase1, cycle_phase2,
  scatter_rows) bit-exact to their plain versions on seeded random
  batches and at every cycle of the port's Scheduler on seeded
  clusters, whose decisions on the card equal those on the CPU;
- a CUDA tensor launches the kernel (the launch counters rise);
- a kernel source that does not build makes a Scheduler on the card
  raise KernelError when it is made.

These tests import neither JAX nor kueue_tpu. On the machine with the
card, which has no JAX, run them without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from kueue_tpu_torch import interop
from kueue_tpu_torch.core.drain import plan_drain, run_drain
from kueue_tpu_torch.core.guard import GuardConfig, SolverGuard
from kueue_tpu_torch.interop import drain_queues
from kueue_tpu_torch.core.snapshot import take_snapshot
from kueue_tpu_torch.core.solver import tree_arrays
from kueue_tpu_torch.ops import _build
from kueue_tpu_torch.perf import cases, cycle
from kueue_tpu_torch.perf.cases import build_cache, mixed_spec
from kueue_tpu_torch.perf.lockstep import (
    CYCLE_KERNELS,
    DRAIN_KERNELS,
    Lockstep,
    cycle_kernels_through,
    cycle_solve,
    lockstep,
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
