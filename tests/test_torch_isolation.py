"""The PyTorch port (kueue_tpu_torch) stands alone.

- it imports and runs its CPU path with jax, flax and kueue_tpu blocked
  (a plain drain, a megaloop launch, a fair drain, a cycle, the preempt
  and fair-preempt drains, a fair cycle with the batched fair search,
  the TAS drain and a TAS placement, a Gavel drain, a planner sweep
  with a policy scenario, a drain on a two-device CPU mesh and the
  unsegmented cycle of entry.entry);
- no module of the package, nor chip_smoke.py, imports jax, flax or
  kueue_tpu (AST scan);
- its entry points run on the card: without one, and without an
  explicit device="cpu", they raise instead of falling back.
"""

import ast
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "kueue_tpu_torch"
FORBIDDEN = ("jax", "flax", "kueue_tpu")


def _port_files():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in FORBIDDEN:
                bad.append((node.lineno, name))
    return bad


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: str(p.relative_to(REPO))
)
def test_no_jax_or_reference_import(path):
    assert _forbidden_imports(path) == []


def test_scan_covers_every_subpackage():
    scanned = {p.relative_to(PKG).parts[0] for p in _port_files() if PKG in p.parents}
    assert {"core", "ops", "perf", "tas", "models", "policy", "planner", "parallel",
            "entry.py"} <= scanned


def test_scan_catches_a_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import numpy\nfrom kueue_tpu.ops import quota\nimport jax.numpy as jnp\n")
    assert [n for _, n in _forbidden_imports(f)] == ["kueue_tpu.ops", "jax.numpy"]


_BLOCKED_RUN = r"""
import sys
for name in ("jax", "jaxlib", "flax", "kueue_tpu"):
    sys.modules[name] = None  # any import of them raises ImportError
import importlib, pkgutil
import kueue_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(kueue_tpu_torch.__path__, "kueue_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
from kueue_tpu_torch.core.drain import run_drain
from kueue_tpu_torch.core.snapshot import take_snapshot
from kueue_tpu_torch.perf.cases import build_cache, mixed_spec
cache, pending = build_cache(mixed_spec(1, workloads_per_cq=3))
out = run_drain(take_snapshot(cache), pending, cache.flavors, device="cpu")
assert out.admitted and out.cycles > 0
from kueue_tpu_torch.core.drain import launch_drain_megaloop
log = launch_drain_megaloop(take_snapshot(cache), pending, cache.flavors,
                            chunk_cycles=2, max_rounds=4, device="cpu").fetch()
assert log.n_rounds >= 1 and log.rounds[0].admitted
from kueue_tpu_torch.perf.cases import fair_spec
fcache, fpending = build_cache(fair_spec(0, workloads_per_cq=3))
fair = run_drain(take_snapshot(fcache), fpending, fcache.flavors, fair_sharing=True,
                 device="cpu")
assert fair.admitted and fair.cycles > 0
from kueue_tpu_torch.perf.cases import build_scheduler, cycle_spec
sched, _, _ = build_scheduler(cycle_spec(0, workloads_per_cq=2), device="cpu")
assert sched.schedule().admitted
from kueue_tpu_torch.core.drain import run_drain_preempt
from kueue_tpu_torch.perf.cases import preempt_spec
pcache, ppending = build_cache(preempt_spec(2))
pre = run_drain_preempt(take_snapshot(pcache), ppending, pcache.flavors, device="cpu")
assert pre.admitted and pre.preempted
from kueue_tpu_torch.core.drain import run_drain_fair_preempt
from kueue_tpu_torch.perf import contended, fairpreempt
fenv = fairpreempt.build_fair_preempt(12)
fpre = run_drain_fair_preempt(take_snapshot(fenv.cache), fenv.pending, fenv.cache.flavors,
                              timestamp_fn=fenv.ts_fn, device="cpu")
assert fpre.admitted and fpre.preempted
fsched = fairpreempt.build_scheduler(fenv, use_preempt_solver=True, device="cpu")
assert any(r["preempting"] for r in contended.run_cycles(fsched, fenv, 3))
from kueue_tpu_torch.core.drain import run_drain_tas
from kueue_tpu_torch.perf import tas as tas_perf
from kueue_tpu_torch.perf.cases import tas_spec
tenv = tas_perf.build_tas_env(tas_spec(0))
tas_out = run_drain_tas(take_snapshot(tenv.cache), tenv.pending, tenv.cache.flavors, tenv.tas,
                        timestamp_fn=tenv.ts_fn, device="cpu")
assert tas_out.admitted and all(a is not None for (w, *_), a in
                                zip(tas_out.admitted, tas_out.assignments)
                                if w.pod_sets[0].topology_request is not None)
fc, req = tas_perf.build_placement((2, 4, 4))
assert fc.snapshot("cpu").find_topology_assignments([req]).failure_reason
import numpy as np
from kueue_tpu_torch.perf import planner as planner_perf
from kueue_tpu_torch.policy import resolve_policy
penv = planner_perf.build_policy(np.random.default_rng(21), n_cq=4, wl_per_cq=6)
gavel = run_drain(take_snapshot(penv.cache), penv.pending, penv.cache.flavors,
                  timestamp_fn=penv.ts_fn, policy=resolve_policy("gavel"), device="cpu")
assert gavel.admitted
planner, sweep, _, _ = planner_perf.build_stage(n_cq=4, n_scenarios=3, device="cpu")
from kueue_tpu_torch.planner.scenarios import PlanScenario, PolicyDelta
report = planner.plan(scenarios=sweep + [PlanScenario("gavel", (PolicyDelta("gavel"),))],
                      include_reasons="all", verify_host=True)
assert report.launches == 1 and report.recommended
from kueue_tpu_torch.parallel import make_mesh
import kueue_tpu_torch.entry as port_entry
mesh_out = run_drain(take_snapshot(cache), pending, cache.flavors, mesh=make_mesh(2, device="cpu"))
assert [w.name for w, *_ in mesh_out.admitted] == [w.name for w, *_ in out.admitted]
fn, args = port_entry.entry(device="cpu")
assert bool(fn(*args).admitted.any())
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "kueue_tpu")
            and sys.modules[m] is not None]
print("OK", len(mods), out.cycles, len(out.admitted))
"""


def test_imports_and_runs_with_jax_blocked():
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.startswith("OK")


def _small_drain_inputs():
    from kueue_tpu_torch.core.snapshot import take_snapshot
    from kueue_tpu_torch.perf.cases import build_cache, mixed_spec

    cache, pending = build_cache(mixed_spec(2, workloads_per_cq=2))
    return take_snapshot(cache), pending, cache.flavors


def test_run_drain_without_device_raises_without_cuda(monkeypatch):
    import torch

    from kueue_tpu_torch.core.drain import run_drain

    from kueue_tpu_torch.core.drain import (
        launch_drain,
        launch_drain_megaloop,
        run_drain_for_scope,
    )
    from kueue_tpu_torch.core.encode import ResidentEncoder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    snap, pending, flavors = _small_drain_inputs()
    with pytest.raises(RuntimeError, match="CUDA"):
        run_drain(snap, pending, flavors)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_drain(snap, pending, flavors, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_drain(snap, pending, flavors, fair_sharing=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_drain_for_scope("fair", snap, pending, flavors)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_drain_for_scope("fair_preempt", snap, pending, flavors)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_drain(snap, pending, flavors, max_cycles=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_drain_megaloop(snap, pending, flavors)
    with pytest.raises(RuntimeError, match="CUDA"):
        ResidentEncoder()
    with pytest.raises(RuntimeError, match="CUDA"):
        run_drain_for_scope("preempt", snap, pending, flavors)
    from kueue_tpu_torch.tas import TASCache

    with pytest.raises(RuntimeError, match="CUDA"):
        run_drain_for_scope("tas", snap, pending, flavors, TASCache())


def test_planner_without_device_raises_without_cuda(monkeypatch):
    """The planner solves on the card unless asked for the CPU; its
    host mirror (use_device=False) needs none."""
    import torch

    from kueue_tpu_torch.interop import plan_inputs
    from kueue_tpu_torch.perf import planner as planner_perf
    from kueue_tpu_torch.perf.cases import plan_batch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    planner, sweep, _, _ = planner_perf.build_stage(n_cq=3, n_scenarios=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        planner.plan(scenarios=sweep)
    assert planner.plan(scenarios=sweep, use_device=False).backend == "host"
    with pytest.raises(RuntimeError, match="CUDA"):
        plan_inputs(plan_batch(0, 2))


def test_resolve_device_defaults_to_cuda(monkeypatch):
    import torch

    from kueue_tpu_torch._torch import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device().type == "cuda"
    assert resolve_device("cpu").type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"


def test_unported_drain_scopes_raise():
    """A mesh over more than one distinct device raises (a mesh over one
    device runs, tests/test_torch_parallel.py), and no launch/fetch
    split is offered for a scope other than the plain one (None, as the
    reference returns)."""
    from kueue_tpu_torch.core.drain import (
        launch_drain,
        launch_drain_for_scope,
        launch_drain_megaloop,
        run_drain,
        run_drain_fair_preempt,
        run_drain_for_scope,
        run_drain_preempt,
    )

    from kueue_tpu_torch.core.drain import run_drain_tas
    from kueue_tpu_torch.tas import TASCache

    snap, pending, flavors = _small_drain_inputs()
    assert run_drain_for_scope("tas", snap, pending, flavors, TASCache(), device="cpu").cycles > 0
    assert run_drain_for_scope("fair_preempt", snap, pending, flavors, device="cpu").cycles > 0
    for kind in ("preempt", "fair_preempt", "tas", "fair"):
        assert launch_drain_for_scope(kind, snap, pending, flavors, device="cpu") is None
    import numpy as np
    import torch

    from kueue_tpu_torch.parallel.sharded_solver import Mesh

    two = np.empty(2, dtype=object)
    two[:] = [torch.device("cuda", 0), torch.device("cuda", 1)]
    two_cards = Mesh(two, ("wl",))
    for fn in (run_drain, launch_drain, launch_drain_megaloop, run_drain_preempt,
               run_drain_fair_preempt):
        with pytest.raises(NotImplementedError):
            fn(snap, pending, flavors, mesh=two_cards, device="cpu")
    with pytest.raises(NotImplementedError):
        run_drain_tas(snap, pending, flavors, TASCache(), mesh=two_cards, device="cpu")


def test_wrappers_reject_cpu_tensors_for_kernels():
    """The kernel argument checks refuse a tensor the kernel cannot
    take (here: one on the CPU) instead of passing its pointer on."""
    import torch

    from kueue_tpu_torch.ops import _build

    t = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        _build.ptr("quota_tree", "nominal", t, torch.int64, (3,))
    assert _build.ptr("quota_tree", "done", None, torch.int32) is None


def test_nothing_builds_at_import():
    """Importing the package builds no kernel and needs no nvcc."""
    res = subprocess.run(
        [sys.executable, "-c",
         "import kueue_tpu_torch.ops.drain_kernel as d, kueue_tpu_torch.ops._build as b;"
         "print(len(b._LIBS), sum(b.LAUNCHES.values()))"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split() == ["0", "0"]
