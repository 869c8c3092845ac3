"""The mesh harness of the port (kueue_tpu_torch.parallel) against the
JAX package's (kueue_tpu.parallel) on the CPU, exactly (tolerance 0).
The JAX side runs on the 8-device virtual CPU mesh tests/conftest.py
forces; the port's on ``make_mesh(8, device="cpu")``, eight virtual CPU
devices that are all one device, so every Q and W axis is padded to a
multiple of 8 as the JAX package pads it:

- ShardedSolver (phase 1 per wl shard, the unsegmented phase 2, kernel
  B3') with fr_parallel off and on, at W = 16, 61 (not a multiple of wl)
  and 200, and pad_heads, against the JAX ShardedSolver and pad_heads;
- make_mesh shapes (8 -> wl; 8 with fr -> wl, fr; 3 with fr -> wl),
  resolve_mesh (off / None / "" / 1 -> None), mesh_shape_str,
  bucket_stats and reset_stats;
- dispatch_lowered, run_drain (plain and fair), launch_drain_megaloop,
  run_drain_preempt (its narrow-panel canary run and memoized),
  run_drain_fair_preempt, run_drain_tas and batched_fair_get_targets
  with ``mesh=``: equal to the port without a mesh and to JAX with its
  mesh, on the fixtures of the dry run's drives (kueue_tpu_torch.entry,
  built in both packages) and the perf cases;
- entry.dryrun_multichip(8) completes;
- a mesh over cuda:0 and cuda:1 raises NotImplementedError before any
  device is touched, at every entry that takes a mesh;
- SHARDED_KERNELS and KERNEL_PORTS resolve: every sharded key is a
  registered port, and every named JAX entry, wrapper, plain version,
  source, test and kernel name exists (the port's counterpart of the
  lint in tests/test_drain_parity.py).
"""

import importlib
import pathlib

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from kueue_tpu import models as jax_models
from kueue_tpu import parallel as jpar
from kueue_tpu.core import drain as jdrain
from kueue_tpu.core import flavor_assigner as jax_fa
from kueue_tpu.core import preempt_batch as jax_pb
from kueue_tpu.core import snapshot as jax_snapshot
from kueue_tpu.core import solver as jsolver
from kueue_tpu.parallel import sharded_solver as jss
from kueue_tpu_torch import entry, interop
from kueue_tpu_torch import parallel as ppar
from kueue_tpu_torch.core import drain as pdrain
from kueue_tpu_torch.core import preempt_batch as ppb
from kueue_tpu_torch.core import solver as psolver
from kueue_tpu_torch.core.snapshot import take_snapshot
from kueue_tpu_torch.ops import KERNEL_PORTS, _build
from kueue_tpu_torch.parallel import harness
from kueue_tpu_torch.parallel.sharded_solver import Mesh, ShardedSolver, make_mesh
from kueue_tpu_torch.perf import fairpreempt as fp
from kueue_tpu_torch.perf import megaloop as pml
from kueue_tpu_torch.perf import tas as pt
from kueue_tpu_torch.perf.cases import tas_spec
from tests.test_torch_preempt_drain import jax_api, two_card_mesh
from tests.test_torch_tas import JAX as JAX_TAS

REPO = pathlib.Path(__file__).resolve().parent.parent
FIELDS = ("chosen", "admitted", "borrows", "reserved", "usage", "order")
TREE_FIELDS = ("parent", "level_mask", "nominal", "lending_limit", "borrowing_limit")


@pytest.fixture(scope="module")
def meshes():
    """(the port's 8-device CPU mesh, the JAX package's)."""
    return make_mesh(8, device="cpu"), jss.make_mesh(8)


def jax_fair_api():
    return fp.fair_api(jax_api(), jax_models, jax_fa, jax_snapshot, jax_pb)


def port_heads(heads):
    return interop.heads_batch(
        {k: None if getattr(heads, k) is None else np.asarray(getattr(heads, k))
         for k in heads._fields},
        "cpu",
    )


def port_args(tree, usage, heads, paths):
    t = interop.quota_tree({k: np.asarray(getattr(tree, k)) for k in TREE_FIELDS}, "cpu")
    return t, np.asarray(usage), port_heads(heads), np.asarray(paths)


# ---- ShardedSolver and the mesh ----------------------------------------


@pytest.mark.parametrize("w", [16, 61, 200])
@pytest.mark.parametrize("fr_parallel", [False, True])
def test_sharded_solver_matches_jax(fr_parallel, w):
    tree, usage, heads, paths = graft._synthetic_problem(n_cq=16, n_cohort=4, fr=8, w=w)
    ref = jss.ShardedSolver(jss.make_mesh(8, fr_parallel=fr_parallel))(tree, usage, heads, paths)
    mesh = make_mesh(8, fr_parallel=fr_parallel, device="cpu")
    got = ShardedSolver(mesh)(*port_args(tree, usage, heads, paths))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    assert got.admitted.shape[0] % 8 == 0 and bool(got.admitted.any())


def test_pad_heads_matches_jax(meshes):
    mesh, jmesh = meshes
    _, _, heads, _ = graft._synthetic_problem(n_cq=16, n_cohort=4, fr=8, w=61)
    ref = jss.ShardedSolver(jmesh).pad_heads(heads)
    got = ShardedSolver(mesh).pad_heads(port_heads(heads))
    for f in ref._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    assert got.cq_row.shape == (64,) and (got.cq_row[61:] == -1).all()
    assert (got.cells[61:] == -1).all() and got.score is not None


@pytest.mark.parametrize("n, fr_parallel, shape", [
    (8, False, {"wl": 8}), (8, True, {"wl": 4, "fr": 2}), (3, True, {"wl": 3}),
    (1, False, {"wl": 1}),
])
def test_make_mesh_shapes(n, fr_parallel, shape):
    mesh = make_mesh(n, fr_parallel=fr_parallel, device="cpu")
    assert mesh.shape == shape
    assert dict(jss.make_mesh(n, fr_parallel=fr_parallel).shape) == shape
    assert harness.mesh_shape_str(mesh) == jpar.mesh_shape_str(jss.make_mesh(n, fr_parallel))
    assert mesh.distinct_devices() == (torch.device("cpu"),)


@pytest.mark.parametrize("spec", ["off", None, "", 1, "1", "auto"])
def test_resolve_mesh_below_two_devices_is_none(spec):
    assert ppar.resolve_mesh(spec, device="cpu") is None


def test_resolve_mesh_counts_virtual_cpu_devices():
    mesh = ppar.resolve_mesh("8", device="cpu")
    assert harness.mesh_shape_str(mesh) == "wl=8" == jpar.mesh_shape_str(jpar.resolve_mesh("8"))
    assert harness.mesh_shape_str(ppar.resolve_mesh(4, fr_parallel=True, device="cpu")) == (
        "wl=2,fr=2"
    )
    assert harness.mesh_shape_str(None) == "off"


def test_bucket_stats_and_reset(meshes):
    mesh, _ = meshes
    harness.reset_stats()
    assert harness.bucket_stats() == {"buckets": 0, "hits": 0, "misses": 0, "perKernel": {}}
    assert harness.place_seconds() == 0.0
    pdrain.run_drain(*entry.drain_case(), mesh=mesh, device="cpu")
    pdrain.run_drain(*entry.drain_case(), mesh=mesh, device="cpu")
    st = harness.bucket_stats()
    assert st["perKernel"]["drain_kernel"] == {"buckets": 1, "hits": 1, "misses": 1}
    assert harness.place_seconds() > 0
    harness.reset_stats()
    assert harness.bucket_stats()["buckets"] == 0 and harness.place_seconds() == 0.0


# ---- every mesh= path: the port with and without, JAX with its mesh ----


def _solve_view(res):
    return {f: np.asarray(getattr(res, f)).tolist() for f in FIELDS if f != "usage"}


@pytest.mark.parametrize("case", ["drain_case", "preempt_drain_case"])
def test_dispatch_lowered_mesh(case, meshes):
    mesh, jmesh = meshes
    snap, pending, flavors = getattr(entry, case)()
    jsnap, jpending, jflavors = getattr(entry, case)(jax_fair_api())
    # one cycle's heads: the single-podset workloads
    heads = [(w, c) for w, c in pending if len(w.pod_sets) == 1]
    jheads = [(w, c) for w, c in jpending if len(w.pod_sets) == 1]
    low = psolver.lower_heads(snap, heads, flavors)
    jlow = jsolver.lower_heads(jsnap, jheads, jflavors)
    plain = psolver.dispatch_lowered(snap, low, device="cpu")
    got = psolver.dispatch_lowered(snap, low, mesh=mesh)
    ref = jsolver.dispatch_lowered(jsnap, jlow, mesh=jmesh)
    assert _solve_view(got) == _solve_view(plain) == _solve_view(ref)
    assert bool(np.asarray(got.admitted).any())


def _drain_view(out):
    return (sorted((w.name, c, repr(sorted(f.items())), cy) for w, c, f, cy in out.admitted),
            sorted(w.name for w, _ in out.parked), sorted(w.name for w, _ in out.fallback),
            out.cycles, out.truncated)


@pytest.mark.parametrize("fair", [False, True])
def test_run_drain_mesh(fair, meshes):
    mesh, jmesh = meshes
    case = entry.fair_drain_case if fair else entry.drain_case
    plain = pdrain.run_drain(*case(), fair_sharing=fair, device="cpu")
    got = pdrain.run_drain(*case(), fair_sharing=fair, mesh=mesh)
    ref = jdrain.run_drain(*case(jax_fair_api()), fair_sharing=fair, mesh=jmesh)
    assert _drain_view(got) == _drain_view(plain) == _drain_view(ref)
    np.testing.assert_array_equal(got.final_usage, plain.final_usage)
    assert got.admitted and not got.fallback


def test_megaloop_mesh(meshes):
    mesh, jmesh = meshes

    def chain(launch, spec_snap, case, **kw):
        snap, pending, flavors = case
        return pml.run_chain(launch, spec_snap, snap, pending, flavors, chunk_cycles=2,
                             max_rounds=3, **kw)

    from kueue_tpu.core.pipeline import speculative_snapshot as jspec
    from kueue_tpu_torch.core.pipeline import speculative_snapshot as pspec

    plain = chain(pdrain.launch_drain_megaloop, pspec, entry.drain_case(), device="cpu")
    got = chain(pdrain.launch_drain_megaloop, pspec, entry.drain_case(), mesh=mesh)
    ref = chain(jdrain.launch_drain_megaloop, jspec, entry.drain_case(jax_fair_api()),
                mesh=jmesh)
    assert pml.chain_summary(got) == pml.chain_summary(plain) == pml.chain_summary(ref)
    assert len(got) >= 1 and got[0].n_rounds >= 2


def _preempt_view(out):
    return _drain_view(out) + (sorted((w.name, c, cy) for w, c, cy in out.preempted),)


def test_run_drain_preempt_mesh_with_the_canary(meshes):
    mesh, jmesh = meshes
    harness._NARROW_VERDICTS.clear()
    harness.reset_stats()
    plain = pdrain.run_drain_preempt(*entry.preempt_drain_case(), device="cpu",
                                     panel_tuner=pdrain.PanelTuner())
    got = pdrain.run_drain_preempt(*entry.preempt_drain_case(), mesh=mesh,
                                   panel_tuner=pdrain.PanelTuner())
    ref = jdrain.run_drain_preempt(*entry.preempt_drain_case(jax_fair_api()), mesh=jmesh,
                                   panel_tuner=jdrain.PanelTuner())
    assert _preempt_view(got) == _preempt_view(plain) == _preempt_view(ref)
    assert got.preempted
    # the canary ran on this mesh for the narrow rung, and is memoized
    verdicts = harness.probe_verdicts()
    fp_key = harness.mesh_fingerprint(mesh)
    assert any(k[0] == fp_key for k in verdicts) and all(verdicts.values())
    sched = harness.last_panel_schedule()
    assert sched["fenced"] is False and len(sched["widths"]) == 2
    assert harness.bucket_stats()["perKernel"]["preempt_kernel"]["misses"] >= 1
    n = len(verdicts)
    pdrain.run_drain_preempt(*entry.preempt_drain_case(), mesh=mesh,
                             panel_tuner=pdrain.PanelTuner())
    assert len(harness.probe_verdicts()) == n


def test_mesh_safe_widths_clamps_an_unsupported_rung(meshes):
    mesh, _ = meshes
    key = (harness.mesh_fingerprint(mesh), 8)
    saved = dict(harness._NARROW_VERDICTS)
    try:
        harness.demote_panel_width(mesh, 8)
        harness._NARROW_VERDICTS[(key[0], 16)] = True
        assert harness.mesh_safe_widths(mesh, (8, 32)) == (16, 32)
        harness._NARROW_VERDICTS[(key[0], 16)] = False
        assert harness.mesh_safe_widths(mesh, (8, 32)) == (32,)
    finally:
        harness._NARROW_VERDICTS.clear()
        harness._NARROW_VERDICTS.update(saved)


def test_run_drain_fair_preempt_mesh(meshes):
    mesh, jmesh = meshes

    def run(fn, env, **kw):
        return fn(env.api.take_snapshot(env.cache), env.pending, env.cache.flavors,
                  timestamp_fn=env.ts_fn, **kw)

    plain = run(pdrain.run_drain_fair_preempt, fp.build_fair_preempt(12), device="cpu")
    got = run(pdrain.run_drain_fair_preempt, fp.build_fair_preempt(12), mesh=mesh)
    ref = run(jdrain.run_drain_fair_preempt, fp.build_fair_preempt(12, api=jax_fair_api()),
              mesh=jmesh)
    assert _preempt_view(got) == _preempt_view(plain) == _preempt_view(ref)
    assert got.preempted and got.admitted


@pytest.mark.parametrize("seed", [0, 1])
def test_run_drain_tas_mesh(seed, meshes):
    mesh, jmesh = meshes
    from kueue_tpu.core.snapshot import take_snapshot as jts

    pe = pt.build_tas_env(tas_spec(seed))
    plain = pdrain.run_drain_tas(take_snapshot(pe.cache), pe.pending, pe.cache.flavors, pe.tas,
                                 timestamp_fn=pe.ts_fn, device="cpu")
    pe = pt.build_tas_env(tas_spec(seed))
    got = pdrain.run_drain_tas(take_snapshot(pe.cache), pe.pending, pe.cache.flavors, pe.tas,
                               timestamp_fn=pe.ts_fn, mesh=mesh)
    je = pt.build_tas_env(tas_spec(seed), JAX_TAS)
    ref = jdrain.run_drain_tas(jts(je.cache), je.pending, je.cache.flavors, je.tas,
                               timestamp_fn=je.ts_fn, mesh=jmesh)

    def view(out):
        return (pt.placements(out), sorted(w.name for w, _ in out.parked),
                sorted(w.name for w, _ in out.fallback), out.cycles, out.truncated,
                sorted(pt.leaf_usage(out).items()))

    assert view(got) == view(plain) == view(ref)
    assert got.admitted


def _targets(results):
    return [sorted((t.workload.workload.name, t.reason) for t in r) for r in results]


def test_batched_fair_get_targets_mesh(meshes):
    mesh, jmesh = meshes
    snap, items, pre = entry.fair_search_case()
    plain = ppb.batched_fair_get_targets(snap, items, pre, device="cpu")
    got = ppb.batched_fair_get_targets(snap, items, pre, mesh=mesh)
    ref = jax_pb.batched_fair_get_targets(*entry.fair_search_case(jax_fair_api()), mesh=jmesh)
    assert _targets(got) == _targets(plain) == _targets(ref)
    assert any(got)
    # bench.py's fair stage under the mesh: one full-width tier, the
    # same victims
    snap, items, pre = fp.build_fair_search(np.random.default_rng(fp.SEARCH_SEED))
    arrays, meta = ppb.lower_fair_preemption(snap, items, pre)
    tiers = ppb.fair_tiers(arrays, meta, mesh)
    assert len(tiers) == 1 and tiers[0][1] == meta["v"]
    assert tiers[0][2]["row_valid"].shape[0] % 8 == 0
    res = ppb.batched_fair_get_targets(snap, items, pre, mesh=mesh)
    assert fp.search_summary(items, res, meta) == fp.FAIR_SEARCH_EXPECT


def test_dryrun_multichip_completes():
    entry.dryrun_multichip(8)


# ---- what is refused --------------------------------------------------


def test_a_mesh_over_two_cards_raises_before_touching_a_device(monkeypatch):
    # were a device touched, resolve_device would raise RuntimeError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    two = two_card_mesh()
    assert two.shape == {"wl": 2}
    with pytest.raises(NotImplementedError, match="A11"):
        ShardedSolver(two)
    snap, pending, flavors = entry.drain_case()
    for fn in (pdrain.run_drain, pdrain.launch_drain, pdrain.launch_drain_megaloop,
               pdrain.run_drain_preempt, pdrain.run_drain_fair_preempt):
        with pytest.raises(NotImplementedError, match="more than one"):
            fn(snap, pending, flavors, mesh=two)
    with pytest.raises(NotImplementedError):
        pdrain.run_drain(snap, pending, flavors, fair_sharing=True, mesh=two)
    pe = pt.build_tas_env(tas_spec(0))
    with pytest.raises(NotImplementedError):
        pdrain.run_drain_tas(take_snapshot(pe.cache), pe.pending, pe.cache.flavors, pe.tas,
                             mesh=two)
    low = psolver.lower_heads(snap, [(w, c) for w, c in pending if len(w.pod_sets) == 1],
                              flavors)
    with pytest.raises(NotImplementedError):
        psolver.dispatch_lowered(snap, low, mesh=two)
    fsnap, items, pre = entry.fair_search_case()
    with pytest.raises(NotImplementedError):
        ppb.batched_fair_get_targets(fsnap, items, pre, mesh=two)


def test_a_card_mesh_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    one = Mesh(np.array([torch.device("cuda", 0)], dtype=object), ("wl",))
    with pytest.raises(RuntimeError, match="CUDA"):
        pdrain.run_drain(*entry.drain_case(), mesh=one)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(1)


def test_resident_is_single_device_only(meshes):
    mesh, _ = meshes
    with pytest.raises(ValueError, match="single-device"):
        pdrain.launch_drain(*entry.drain_case(), mesh=mesh, resident=object())


# ---- the registries ---------------------------------------------------


def _resolve(dotted):
    module, attr = dotted.split(":")
    return getattr(importlib.import_module(module), attr)


def test_sharded_kernels_are_registered_ports():
    assert set(ppar.SHARDED_KERNELS) <= set(KERNEL_PORTS)
    assert set(ppar.SHARDED_KERNELS) == set(jpar.SHARDED_KERNELS)
    for name, dotted in ppar.SHARDED_KERNELS.items():
        assert callable(_resolve(dotted)), name
        assert dotted.startswith("kueue_tpu_torch.parallel.sharded_solver:")


@pytest.mark.parametrize("module", sorted(KERNEL_PORTS))
def test_kernel_ports_resolve(module):
    port = KERNEL_PORTS[module]
    for dotted in port.jax:
        assert dotted.startswith(f"kueue_tpu.ops.{module}:")
        assert callable(_resolve(dotted)), dotted
    for dotted in port.wrappers + port.plain:
        assert dotted.startswith("kueue_tpu_torch.")
        assert callable(_resolve(dotted)), dotted
    for path in port.sources + port.tests:
        assert (REPO / path).is_file(), path
    assert set(port.kernels) <= set(_build.KERNELS)
    for test in port.tests:
        assert "kueue_tpu" in (REPO / test).read_text()


def test_kernel_ports_cover_every_built_kernel_once():
    names = [n for p in KERNEL_PORTS.values() for n in p.kernels]
    assert sorted(names) == sorted(_build.KERNELS)
    # every JAX kernel module is ported
    from kueue_tpu.ops import KERNEL_MIRRORS

    assert set(KERNEL_MIRRORS) - set(KERNEL_PORTS) == set()
