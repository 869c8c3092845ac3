"""``ClusterRuntime`` in the PyTorch port against the JAX package.

The same seeded cluster (``kueue_tpu_torch.perf.runtime``: bench.py's
pipeline/megaloop environment cut to 32 ClusterQueues in 4 cohorts, 2
flavors, 14 workloads a queue, the bulk-drain threshold at 256 so the
drain runs) goes through ``run_until_idle`` in both packages, the
port's on ``device="cpu"`` (the plain versions of its kernels), in every
drain mode: ``drain_pipeline`` off/serial/on, and the megaloop with a
pinned K. Compared, exactly: the admitted set, each admission
(ClusterQueue, flavors per podset), every workload's conditions, and
the events as (reason, key) in order. Also the host cycle loop
(``bulk_drain_threshold=None``) and a TAS runtime built from
``perf.cases.tas_spec``.

The JAX side runs twice and must agree with itself before the port is
held to it (the reference's resident-buffer aliasing on XLA's CPU
client can move its cycle path between runs: ROADMAP Queue C); on
these clusters it has not moved.
"""

from types import SimpleNamespace

import pytest

from kueue_tpu.controllers import ClusterRuntime as JRuntime
from kueue_tpu.core.scheduler import _LatencyEstimate as JLatency
from kueue_tpu.models import ClusterQueue, FlavorQuotas, LocalQueue, ResourceFlavor, Workload
from kueue_tpu.models.cluster_queue import ResourceGroup
from kueue_tpu.models.topology import Topology, TopologyLevel
from kueue_tpu.models.workload import PodSet, PodSetTopologyRequest
from kueue_tpu.tas.cache import Node, TASCache
from kueue_tpu_torch.perf import runtime as prt
from kueue_tpu_torch.perf.cases import tas_spec

JAX_PKG = SimpleNamespace(
    ClusterRuntime=JRuntime, LatencyEstimate=JLatency, ClusterQueue=ClusterQueue,
    FlavorQuotas=FlavorQuotas, LocalQueue=LocalQueue, ResourceFlavor=ResourceFlavor,
    Workload=Workload, ResourceGroup=ResourceGroup, PodSet=PodSet, Topology=Topology,
    TopologyLevel=TopologyLevel, Node=Node, TASCache=TASCache,
    PodSetTopologyRequest=PodSetTopologyRequest,
)
CUT = dict(n_cq=32, wl_per_cq=14, n_flavors=2, n_cohort=4)


def observe(rt):
    """What two runtimes must agree on."""
    admissions = {}
    conditions = {}
    for key, wl in sorted(rt.workloads.items()):
        if wl.admission is not None:
            admissions[key] = (
                wl.admission.cluster_queue,
                [(a.name, sorted(a.flavors.items()), a.count)
                 for a in wl.admission.pod_set_assignments],
            )
        conditions[key] = sorted(
            (str(c.type), c.status, c.reason, c.message) for c in wl.conditions.values()
        )
    return {
        "admitted": sorted(prt.admitted_of(rt)),
        "admissions": admissions,
        "conditions": conditions,
        "events": [(e.kind, e.object_key) for e in rt.events],
        "invariants": rt.check_invariants(),
    }


def _run(build):
    rt = build()
    rt.run_until_idle()
    return rt, observe(rt)


def assert_same(build_jax, build_port):
    _, ref = _run(build_jax)
    _, again = _run(build_jax)
    assert again == ref, "the JAX package moved between runs"
    rt, got = _run(build_port)
    assert got["invariants"] == []
    for field in ("admitted", "admissions", "conditions", "events"):
        assert got[field] == ref[field], field
    return rt, got


MODES = [
    ("off", 16, "off"),
    ("serial", 16, "off"),
    ("on", 16, "off"),
    ("serial", 4, "off"),
    ("on", 4, "4"),
    ("serial", 4, "4"),
    ("on", 4, "16"),
]


@pytest.mark.parametrize("seed", [3, 5])
@pytest.mark.parametrize("mode,chunk,megaloop", MODES,
                         ids=[f"{m}-c{c}-k{k}" for m, c, k in MODES])
def test_drain_modes_match(mode, chunk, megaloop, seed):
    rt, got = assert_same(
        lambda: prt.build_drain_loop_rt(mode, seed, chunk=chunk, megaloop=megaloop,
                                        pkg=JAX_PKG, **CUT),
        lambda: prt.build_drain_loop_rt(mode, seed, chunk=chunk, megaloop=megaloop,
                                        device="cpu", **CUT),
    )
    assert got["admitted"]
    drains = [t for t in rt.scheduler.last_traces if t.resolution == "drain"]
    assert drains, "the bulk drain did not run"
    if megaloop != "off":
        assert rt.megaloop.launches >= 1
    elif mode != "off":
        assert rt.pipeline.rounds >= 1


def test_every_mode_admits_the_same_set():
    sets = set()
    for mode, chunk, megaloop in MODES:
        rt = prt.build_drain_loop_rt(mode, 5, chunk=chunk, megaloop=megaloop, device="cpu",
                                     **CUT)
        prt.drain_once(rt)
        if chunk == 4:
            sets.add(("c4", prt.admitted_of(rt)))
        else:
            sets.add(("c16", prt.admitted_of(rt)))
    assert len(sets) == 2


def test_pipelined_loop_prefetches():
    rt = prt.build_drain_loop_rt("on", 5, chunk=4, device="cpu", **CUT)
    prt.drain_once(rt)
    assert rt.pipeline.rounds >= 2 and rt.pipeline.prefetches >= 1
    assert rt.guard.health()["failovers"] == 0


def test_host_cycle_loop_matches():
    def build(pkg, **kw):
        rt = prt.build_drain_loop_rt("off", 7, pkg=pkg, **kw, **CUT)
        rt.bulk_drain_threshold = None
        return rt

    rt, got = assert_same(lambda: build(JAX_PKG), lambda: build(None, device="cpu"))
    assert got["admitted"]
    assert all(t.resolution != "drain" for t in rt.scheduler.last_traces)


@pytest.mark.parametrize("seed", [0, 1])
def test_tas_runtime_matches(seed):
    spec = tas_spec(seed)
    rt, got = assert_same(
        lambda: prt.build_tas_runtime(spec, pkg=JAX_PKG),
        lambda: prt.build_tas_runtime(spec, device="cpu"),
    )
    assert got["admitted"]
    assert any(
        a.topology_assignment is not None
        for k in got["admitted"] for a in rt.workloads[k].admission.pod_set_assignments
    )


@pytest.mark.slow
@pytest.mark.parametrize("stage", ["pipeline", "megaloop"])
def test_stage_constants_from_the_jax_package(stage):
    """``RUNTIME_DRAIN_EXPECT`` and ``RUNTIME_MEGALOOP_EXPECT``, which
    chip_smoke.py holds the card's 50k x 1000-CQ drains to, recomputed
    from the JAX package: one serial bulk_drain of bench.py's pipeline
    stage (seed default_rng(13), chunk 16) and megaloop stage
    (default_rng(17), chunk 4)."""
    seed, chunk, expect = {
        "pipeline": (13, prt.PIPELINE_CHUNK, prt.RUNTIME_DRAIN_EXPECT),
        "megaloop": (17, prt.MEGALOOP_CHUNK, prt.RUNTIME_MEGALOOP_EXPECT),
    }[stage]
    rt = prt.build_drain_loop_rt("serial", prt.stage_seed(seed), chunk=chunk, pkg=JAX_PKG)
    prt.drain_once(rt)
    assert prt.admitted_summary(rt) == expect


def test_attach_journal_refuses():
    rt = prt.build_drain_loop_rt("off", 1, device="cpu", n_cq=2, wl_per_cq=1, n_flavors=1,
                                 n_cohort=1)
    with pytest.raises(NotImplementedError, match="storage"):
        rt.attach_journal(object())


def test_runtime_needs_a_card_unless_told_the_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from kueue_tpu_torch.controllers import ClusterRuntime

    with pytest.raises(RuntimeError, match="CUDA"):
        ClusterRuntime()


def test_drain_round_kernel_error_is_not_contained(monkeypatch):
    """A KernelError at a pipelined round's fetch leaves bulk_drain: the
    guard's device_join re-raises it and no round goes to the host."""
    from kueue_tpu_torch.core import drain as pd
    from kueue_tpu_torch.ops._build import KernelError

    rt = prt.build_drain_loop_rt("serial", 5, device="cpu", **CUT)

    def boom(self):
        raise KernelError("drain_phase2 failed")

    monkeypatch.setattr(pd.DrainLaunch, "fetch", boom)
    with pytest.raises(KernelError):
        rt.bulk_drain()
    assert rt.guard.health()["failovers"] == 0 and not prt.admitted_of(rt)


def plant_wrong_drain(monkeypatch):
    """Every drain launch's fetch stamps its admissions one cycle late,
    as a wrong kernel would: the apply order and the speculation's
    inputs stay as they were, so prefetches still commit and the
    sampled check sees the round."""
    from kueue_tpu_torch.core import drain as pd

    real_drain, real_mega = pd.DrainLaunch.fetch, pd.MegaloopLaunch.fetch

    def late(outcome):
        outcome.admitted = [(wl, cq, fl, cyc + 1) for wl, cq, fl, cyc in outcome.admitted]
        return outcome

    def mega(self):
        log = real_mega(self)
        for outcome in log.rounds:
            late(outcome)
        return log

    monkeypatch.setattr(pd.DrainLaunch, "fetch", lambda self: late(real_drain(self)))
    monkeypatch.setattr(pd.MegaloopLaunch, "fetch", mega)


@pytest.mark.parametrize("megaloop", ["off", "4"])
def test_sampled_divergence_raises(monkeypatch, megaloop):
    """A sampled drain round that differs from the numpy mirror raises
    KernelError naming the field; the host's answer is not taken in its
    place and the device path is not quarantined."""
    from kueue_tpu_torch.ops._build import KernelError

    rt = prt.build_drain_loop_rt("on", 5, chunk=4, megaloop=megaloop, device="cpu", **CUT)
    rt.guard.config.divergence_check_every = 1
    plant_wrong_drain(monkeypatch)
    with pytest.raises(KernelError, match="admitted"):
        rt.bulk_drain()
    health = rt.guard.health()
    assert health["divergences"] == 1 and health["failovers"] == 0
    assert rt.guard.last_divergence["fields"] == ["admitted"]
    assert rt.guard.path == "device"


@pytest.mark.parametrize("mode,megaloop", [("off", "off"), ("serial", "off"), ("on", "4")])
def test_drain_errors_are_not_contained(monkeypatch, mode, megaloop):
    """What a drain round's lowering, upload or launch raises (here
    torch's out-of-memory, not a KernelError) leaves bulk_drain in every
    loop: no failover, and no round goes to the host."""
    import torch

    from kueue_tpu_torch.core import drain as pd

    rt = prt.build_drain_loop_rt(mode, 5, chunk=4, megaloop=megaloop, device="cpu", **CUT)

    def oom(*args, **kwargs):
        raise torch.OutOfMemoryError("CUDA out of memory uploading the drain's inputs")

    for name in ("run_drain_for_scope", "launch_drain", "launch_drain_megaloop"):
        monkeypatch.setattr(pd, name, oom)
    with pytest.raises(torch.OutOfMemoryError):
        rt.bulk_drain()
    assert rt.guard.health()["failovers"] == 0 and not prt.admitted_of(rt)


@pytest.mark.parametrize("mode,megaloop", [("off", "off"), ("on", "off"), ("on", "4")])
def test_injected_device_fault_is_contained(mode, megaloop):
    """The injected fault ``solver.device_raise`` keeps the reference's
    containment: the round is dropped, the breaker is struck and the
    backlog stays pending for the next iteration."""
    from kueue_tpu_torch.testing import faults

    rt = prt.build_drain_loop_rt(mode, 5, chunk=4, megaloop=megaloop, device="cpu", **CUT)

    def fault():
        raise RuntimeError("injected device fault")

    faults.arm("solver.device_raise", action=fault)
    try:
        assert rt.bulk_drain() is None
    finally:
        faults.disarm("solver.device_raise")
    assert rt.guard.health()["failovers"] == 1 and not prt.admitted_of(rt)


@pytest.mark.parametrize("mode,megaloop", [("off", "off"), ("serial", "off"), ("on", "4")])
def test_late_round_keeps_the_cards_answer(mode, megaloop):
    """A round past its deadline strikes the breaker as in the reference,
    but its answer is applied: the drain admits what an on-time drain
    admits."""
    def drained(deadline_s):
        rt = prt.build_drain_loop_rt(mode, 5, chunk=4, megaloop=megaloop, device="cpu",
                                     **CUT)
        rt.guard.config.device_deadline_s = deadline_s
        prt.drain_once(rt)
        return rt

    ref, late = drained(30.0), drained(-1.0)  # -1: every round is late
    assert prt.admitted_of(late) == prt.admitted_of(ref) and prt.admitted_of(ref)
    assert ref.guard.health()["failovers"] == 0
    assert late.guard.health()["failovers"] >= 1


@pytest.mark.parametrize("megaloop", ["off", "4"])
def test_sampled_divergence_checks_match(megaloop):
    """Every committed prefetched round (every fused launch with the
    megaloop) replayed on the numpy drain mirror (``run_drain(
    use_device=False)``): no divergence, and both packages decide alike."""
    def build(pkg, **kw):
        rt = prt.build_drain_loop_rt("on", 5, chunk=4, megaloop=megaloop, pkg=pkg, **kw,
                                     **CUT)
        rt.guard.config.divergence_check_every = 1
        return rt

    rt, got = assert_same(lambda: build(JAX_PKG), lambda: build(None, device="cpu"))
    health = rt.guard.health()
    assert health["divergenceChecks"] > 0 and health["divergences"] == 0
