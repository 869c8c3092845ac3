"""The four CUDA kernels on the card (marked ``cuda``; skipped where
there is no CUDA device or no nvcc, since a CUDA kernel has no CPU mode).

- every kernel bit-exact to its plain version at every cycle of seeded
  drains (kueue_tpu_torch.perf.lockstep), with nonzero candidate scores;
- run_drain on the card equals run_drain(device="cpu") on seeded specs;
- a CUDA tensor launches the kernel (the launch counters rise).

These tests import neither JAX nor kueue_tpu. On the machine with the
card, which has no JAX, run them without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from kueue_tpu_torch.core.drain import plan_drain, run_drain
from kueue_tpu_torch.interop import drain_queues
from kueue_tpu_torch.core.snapshot import take_snapshot
from kueue_tpu_torch.core.solver import tree_arrays
from kueue_tpu_torch.ops import _build
from kueue_tpu_torch.perf.cases import build_cache, mixed_spec
from kueue_tpu_torch.perf.lockstep import lockstep

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
    assert set(errs) == set(_build.KERNELS)
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
    assert all(counts[name] > 0 for name in _build.KERNELS)
