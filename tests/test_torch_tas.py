"""Topology-Aware Scheduling in the port against the JAX package, on the
CPU, tolerance 0:

- every scenario of tests/test_tas.py's TestFindTopologyAssignment on
  both packages' TASFlavorSnapshots: the same assignment (levels,
  domains and counts) and the same failure message;
- kernel B12's plain versions (leaf_counts, level_counts,
  fill_in_counts) against the JAX functions on the same inputs, and the
  port's snapshot with DEVICE_LEAF_THRESHOLD lowered to 1 (the B12
  wrapper on CPU tensors) equal to its host path;
- the dense forest views (topology_from_snapshot's seg_ids and
  n_domains, domain_parent_map, the drain's _merge_tas_forests) equal
  to the JAX package's, byte for byte;
- the Scheduler with TAS hooks (TASManager check/assign/fits) over the
  same cycles as tests/test_tas.py's TestSchedulerIntegration and
  TestInCycleTASRecheck: the same admissions, topology assignments and
  requeue messages;
- without a card, the snapshot's device path (at or above the
  threshold, no device named) raises instead of counting on the host.
"""

import numpy as np
import pytest

from kueue_tpu import features as jfeatures
from kueue_tpu import models as jm
from kueue_tpu import tas as jtas
from kueue_tpu.core import cache as jcache
from kueue_tpu.core import queue_manager as jqm
from kueue_tpu.core.drain import _merge_tas_forests as jax_merge
from kueue_tpu.core.scheduler import Scheduler as JaxScheduler
from kueue_tpu.models import topology as jtopo
from kueue_tpu.models import workload as jwl
from kueue_tpu.models.resource_flavor import Taint as JTaint
from kueue_tpu.models.resource_flavor import Toleration as JToleration
from kueue_tpu.ops import tas_kernel as jtk
from kueue_tpu.utils import clock as jclock
from kueue_tpu_torch import features as pfeatures
from kueue_tpu_torch._torch import to_device, torch
from kueue_tpu_torch.core.drain import _merge_tas_forests as port_merge
from kueue_tpu_torch.core.scheduler import Scheduler as PortScheduler
from kueue_tpu_torch.models.resource_flavor import Taint as PTaint
from kueue_tpu_torch.models.resource_flavor import Toleration as PToleration
from kueue_tpu_torch.ops import tas_kernel as ptk
from kueue_tpu_torch.perf import tas as pt
from kueue_tpu_torch.tas.snapshot import TASFlavorSnapshot as PortSnapshot

BLOCK, RACK, HOST = "cloud/block", "cloud/rack", "kubernetes.io/hostname"

JAX = pt.tas_api(jm, jtopo, jwl, jcache, jqm, jclock, jtas)
PORT = pt.port_api()
PKGS = (
    (JAX, jtas.TASFlavorSnapshot, jwl.PodSetTopologyRequest, JTaint, JToleration, jfeatures),
    (PORT, PortSnapshot, PORT.PodSetTopologyRequest, PTaint, PToleration, pfeatures),
)


def node(block, rack, host, cpu=4, pods=110):
    return (
        {BLOCK: block, RACK: rack, HOST: host},
        {"cpu": cpu * 1000, "memory": 16 << 30, "pods": pods},
    )


DEFAULT_NODES = [
    node("b1", "r1", "h1"),
    node("b1", "r1", "h2"),
    node("b1", "r2", "h3"),
    node("b2", "r3", "h4"),
    node("b2", "r3", "h5"),
    node("b2", "r3", "h6"),
]
TWO_HOSTS = [node("b1", "r1", "h1", cpu=16), node("b1", "r2", "h2", cpu=4)]


def _view(ta):
    if ta is None:
        return None
    return (tuple(ta.levels), tuple((tuple(d.values), d.count) for d in ta.domains))


# (name, nodes, tainted host, snapshot levels, requests [(count, cpu, mode,
# level, podset name, tolerate the taint)], tas usage, non-TAS usage,
# feature gate, simulate_empty) — tests/test_tas.py's scenarios
R = "Required"
SPECS = [
    ("required_rack_fits", DEFAULT_NODES, None, None, [(8, 1000, R, RACK)], None, None, None,
     False),
    ("required_rack_no_fit", DEFAULT_NODES, None, None, [(13, 1000, R, RACK)], None, None, None,
     False),
    ("required_block_fits_two_racks", DEFAULT_NODES, None, None, [(12, 1000, R, BLOCK)], None,
     None, None, False),
    ("preferred_falls_back_up_a_level", DEFAULT_NODES, None, None,
     [(16, 1000, "Preferred", RACK)], None, None, None, False),
    ("preferred_too_big_fails", DEFAULT_NODES, None, None, [(25, 1000, "Preferred", RACK)], None,
     None, None, False),
    ("unconstrained_picks_hosts_directly", DEFAULT_NODES, None, None,
     [(2, 1000, "Unconstrained", None)], None, None, None, False),
    ("best_fit_prefers_smallest_fitting_domain", TWO_HOSTS, None, None, [(3, 1000, R, RACK)],
     None, None, None, False),
    ("least_free_profile", TWO_HOSTS, None, None, [(3, 1000, R, RACK)], None, None,
     "TASProfileLeastFreeCapacity", False),
    ("least_free_profile_multi", TWO_HOSTS, None, None, [(18, 1000, R, BLOCK)], None, None,
     "TASProfileLeastFreeCapacity", False),
    ("most_free_profile_takes_biggest", TWO_HOSTS, None, None, [(3, 1000, R, RACK)], None, None,
     "TASProfileMostFreeCapacity", False),
    ("taint_excludes_node", DEFAULT_NODES[:2], "h1", None, [(8, 1000, R, RACK)], None, None,
     None, False),
    ("taint_tolerated", DEFAULT_NODES[:2], "h1", None, [(8, 1000, R, RACK, "main", True)], None,
     None, None, False),
    ("hostname_lowest_level_emits_host_only_values", DEFAULT_NODES, None, None,
     [(1, 1000, R, RACK)], None, None, None, False),
    ("non_hostname_lowest_emits_full_values", [node("b1", "r1", "hX"), node("b1", "r2", "hY")],
     None, (BLOCK, RACK), [(4, 1000, R, RACK)], None, None, None, False),
    ("pods_capacity_limits", [node("b1", "r1", "h1", cpu=1000, pods=3)], None, None,
     [(4, 1000, R, RACK)], None, None, None, False),
    ("pods_capacity_fits", [node("b1", "r1", "h1", cpu=1000, pods=3)], None, None,
     [(3, 1000, R, RACK)], None, None, None, False),
    ("multi_podset_assumed_usage", [node("b1", "r1", "h1", cpu=8)], None, None,
     [(4, 1000, R, RACK, "a"), (4, 1000, R, RACK, "b")], None, None, None, False),
    ("multi_podset_third_fails", [node("b1", "r1", "h1", cpu=8)], None, None,
     [(4, 1000, R, RACK, "a"), (4, 1000, R, RACK, "b"), (1, 1000, R, RACK, "c")], None, None,
     None, False),
    ("simulate_empty_off", [node("b1", "r1", "h1", cpu=4)], None, None, [(4, 1000, R, RACK)],
     ("h1", {"cpu": 4000}, 4), None, None, False),
    ("simulate_empty_ignores_tas_usage", [node("b1", "r1", "h1", cpu=4)], None, None,
     [(4, 1000, R, RACK)], ("h1", {"cpu": 4000}, 4), None, None, True),
    ("missing_level_reported", DEFAULT_NODES, None, None, [(1, 1000, R, "no/such-level")], None,
     None, None, False),
    ("non_tas_usage_reduces_capacity", [node("b1", "r1", "h1", cpu=4)], None, None,
     [(3, 1000, R, RACK)], None, {"cpu": 2000}, None, False),
    ("non_tas_usage_fits", [node("b1", "r1", "h1", cpu=4)], None, None, [(2, 1000, R, RACK)],
     None, {"cpu": 2000}, None, False),
]


def _find(pkg, spec):
    api, snap_cls, tr_cls, taint_cls, tol_cls, feats = pkg
    _, nodes, tainted, levels, reqs, usage, non_tas, gate, sim = spec
    snap = snap_cls("default", levels or (BLOCK, RACK, HOST))
    taint = taint_cls(key="gpu", value="true", effect="NoSchedule")
    for labels, alloc in nodes:
        did = snap.add_node(labels, alloc, (taint,) if labels.get(HOST) == tainted else ())
        if non_tas:
            snap.add_non_tas_usage(did, non_tas)
    if usage:
        snap.add_tas_usage(*usage)
    snap.freeze()
    out = []
    for count, cpu, mode, level, *rest in reqs:
        name = rest[0] if rest else "main"
        tolerate = rest[1] if len(rest) > 1 else False
        out.append(api.TASPodSetRequest(
            podset_name=name, count=count, single_pod_requests={"cpu": cpu},
            topology_request=tr_cls(mode=mode, level=None if mode == "Unconstrained" else level),
            tolerations=(tol_cls(key="gpu", operator="Exists"),) if tolerate else (),
        ))
    if gate is None:
        res = snap.find_topology_assignments(out, simulate_empty=sim)
    else:
        with feats.override(gate, True):
            res = snap.find_topology_assignments(out, simulate_empty=sim)
    return ({k: _view(v) for k, v in res.assignments.items()}, res.failure_reason,
            res.failed_podset)


@pytest.mark.parametrize("spec", SPECS, ids=[s[0] for s in SPECS])
def test_find_topology_assignment_matches_jax(spec):
    jax_out = _find(PKGS[0], spec)
    port_out = _find(PKGS[1], spec)
    assert port_out == jax_out
    if spec[0] in ("required_rack_fits", "unconstrained_picks_hosts_directly"):
        assert port_out[1] == "" and port_out[0]["main"] is not None


# ---- kernel B12's plain versions --------------------------------------------


def _random_snapshots(seed):
    rng = np.random.default_rng(seed)
    nodes = []
    for b in range(2):
        for r in range(3):
            for h in range(rng.integers(1, 4)):
                nodes.append(node(f"b{b}", f"r{b}-{r}", f"h{b}{r}{h}",
                                  cpu=int(rng.integers(1, 9))))
    snaps = []
    for snap_cls in (jtas.TASFlavorSnapshot, PortSnapshot):
        s = snap_cls("default", (BLOCK, RACK, HOST))
        for labels, alloc in nodes:
            s.add_node(labels, alloc)
        s.freeze()
        snaps.append(s)
    return rng, snaps


def _b12_inputs(rng, snap, edge: bool):
    n_l, n_r = len(snap._leaf_order), len(snap._resources)
    b = 3
    req = np.zeros((b, n_r), dtype=np.int64)
    for i in range(b):
        req[i, snap._resources.index("cpu")] = int(rng.integers(500, 3000))
        req[i, snap._resources.index("pods")] = 1
    assumed = np.zeros((b, n_l, n_r), dtype=np.int64)
    taint_ok = np.ones((b, n_l), dtype=bool)
    sim = np.zeros(b, dtype=bool)
    usage = np.zeros((n_l, n_r), dtype=np.int64)
    if edge:
        # negative remaining capacity, simulate_empty, nonzero assumed
        # usage and a taint-masked leaf
        usage = rng.integers(0, 9000, (n_l, n_r)).astype(np.int64)
        assumed = rng.integers(0, 3000, (b, n_l, n_r)).astype(np.int64)
        taint_ok[1, 0] = False
        sim[2] = True
        req[1, snap._resources.index("memory")] = 1 << 30
    return req, assumed, taint_ok, sim, usage


@pytest.mark.parametrize("edge", [False, True], ids=["plain", "edges"])
@pytest.mark.parametrize("seed", range(4))
def test_fill_in_counts_plain_matches_jax(seed, edge):
    from kueue_tpu._jax import jnp

    rng, (jsnap, psnap) = _random_snapshots(seed)
    req, assumed, taint_ok, sim, usage = _b12_inputs(rng, psnap, edge)
    jtopo_ = jtk.topology_from_snapshot(jsnap)
    jtopo_ = jtopo_.replace(tas_usage=jnp.asarray(usage))
    jc, jl = jtk.fill_in_counts(jtopo_, jnp.asarray(req), jnp.asarray(assumed),
                                jnp.asarray(taint_ok), jnp.asarray(sim))
    ptopo = ptk.topology_from_snapshot(psnap, "cpu")._replace(
        tas_usage=to_device(usage, "cpu", np.int64))
    args = [to_device(a, "cpu", d) for a, d in ((req, np.int64), (assumed, np.int64),
                                                (taint_ok, np.bool_), (sim, np.bool_))]
    pc, pl = ptk.fill_in_counts(ptopo, *args)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    assert len(pl) == len(jl)
    for a, b in zip(pl, jl):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        ptk.leaf_counts(ptopo, *args).numpy(),
        np.asarray(jtk.leaf_counts_jit(jtopo_, *(jnp.asarray(a.numpy()) for a in args))),
    )
    if edge:
        assert (pc.numpy() < 0).any() and (pc.numpy()[1, 0] == 0)


@pytest.mark.parametrize("simulate_empty", [False, True])
def test_leaf_counts_device_path_matches_host(monkeypatch, simulate_empty):
    """The snapshot at the threshold (lowered to 1) counts through the
    B12 wrapper on the snapshot's device, here the CPU; the counts and
    the placements equal the host path's."""
    fc, _ = pt.build_placement((2, 4, 4))
    t = PToleration(key="gpu", operator="Exists")
    req = PORT.TASPodSetRequest(
        podset_name="main", count=40, single_pod_requests={"cpu": 3000},
        topology_request=PORT.PodSetTopologyRequest(mode="Required", level="rack"),
        tolerations=(t,),
    )
    snap_h = fc.snapshot("cpu")
    snap_h.add_tas_usage(next(iter(snap_h.leaves)), {"cpu": 60000}, 20)
    assumed = {next(iter(snap_h.leaves)): {"cpu": 4000, "pods": 2}}
    host = snap_h.podset_fit_counts(req, assumed, simulate_empty)
    host_out = snap_h.find_topology_assignments([req], simulate_empty)
    monkeypatch.setattr(PortSnapshot, "DEVICE_LEAF_THRESHOLD", 1)
    snap_d = fc.snapshot("cpu")
    snap_d.add_tas_usage(next(iter(snap_d.leaves)), {"cpu": 60000}, 20)
    np.testing.assert_array_equal(snap_d.podset_fit_counts(req, assumed, simulate_empty), host)
    dev_out = snap_d.find_topology_assignments([req], simulate_empty)
    assert {k: _view(v) for k, v in dev_out.assignments.items()} == {
        k: _view(v) for k, v in host_out.assignments.items()}
    assert dev_out.failure_reason == host_out.failure_reason
    unknown = PORT.TASPodSetRequest(
        podset_name="main", count=1, single_pod_requests={"nvidia.com/gpu": 1},
        topology_request=req.topology_request,
    )
    assert (snap_d.podset_fit_counts(unknown, {}) == 0).all()


def test_leaf_counts_without_device_raises_without_cuda(monkeypatch):
    """At or above the threshold with no device named, the snapshot
    counts on the card: without one it raises, it does not count on
    the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(PortSnapshot, "DEVICE_LEAF_THRESHOLD", 1)
    fc, req = pt.build_placement((1, 2, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        fc.snapshot().find_topology_assignments([req])
    monkeypatch.setattr(PortSnapshot, "DEVICE_LEAF_THRESHOLD", 10**9)
    assert fc.snapshot().find_topology_assignments([req]).failure_reason


# ---- the dense forest views -------------------------------------------------


def _two_flavor_snaps(api, snap_levels):
    env = pt.build_tas_env(two_flavor_spec(), api)
    return [env.tas.flavors[f].snapshot() for f in snap_levels]


def two_flavor_spec():
    from kueue_tpu_torch.perf.cases import tas_spec

    return tas_spec(3)


def test_forest_views_match_jax():
    jsnaps = _two_flavor_snaps(JAX, ("tas-a", "tas-b"))
    psnaps = _two_flavor_snaps(PORT, ("tas-a", "tas-b"))
    for js, ps in zip(jsnaps, psnaps):
        jt = jtk.topology_from_snapshot(js)
        ptopo = ptk.topology_from_snapshot(ps, "cpu")
        np.testing.assert_array_equal(ptopo.seg_ids.numpy(), np.asarray(jt.seg_ids))
        assert ptopo.seg_ids.dtype == torch.int32
        assert ptopo.n_domains == tuple(jt.n_domains)
        np.testing.assert_array_equal(ptopo.free.numpy(), np.asarray(jt.free))
        jp, pp = jtk.domain_parent_map(js), ptk.domain_parent_map(ps)
        assert jp.dtype == pp.dtype and jp.tobytes() == pp.tobytes()
    union = sorted({r for s in psnaps for r in s._resources})
    jm_ = jax_merge(jsnaps, union, 3)
    pm_ = port_merge(psnaps, union, 3)
    for a, b in zip(jm_, pm_):
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        else:
            assert a == b
    assert jax_merge([], union, 1) is None and port_merge([], union, 1) is None


# ---- the Scheduler with TAS hooks ---------------------------------------------


def _sched_env(pkg, sched_cls, cqs, quota, fits):
    api = pkg[0]
    spec = {
        "topologies": {"default": (BLOCK, RACK, HOST)},
        "flavors": [("tas-flavor", "default", {})],
        "nodes": [(f"n{i}", labels, alloc) for i, (labels, alloc) in enumerate(DEFAULT_NODES)],
        "cqs": [(cq, "tas-flavor", quota) for cq in cqs],
        "workloads": [],
    }
    env = pt.build_tas_env(spec, api)
    manager = api.TASManager(env.tas, env.cache.flavors)
    kw = dict(device="cpu") if sched_cls is PortScheduler else {}
    sched = sched_cls(
        queues=env.mgr, cache=env.cache, clock=api.FakeClock(0.0),
        tas_check=manager.check, tas_assign=manager.assign,
        tas_fits=manager.fits if fits else None, **kw,
    )
    return env, sched, manager


def _wl(api, name, cq, count, t, mode="Required", level=RACK):
    tr = None if mode is None else api.PodSetTopologyRequest(mode=mode, level=level)
    return api.Workload(
        namespace="ns", name=name, queue_name=f"lq-{cq}", creation_time=t,
        pod_sets=(api.PodSet.build("main", count, {"cpu": "1"}, topology_request=tr),),
    )


def _run(pkg, sched_cls, scenario):
    cqs, quota, fits, steps = scenario
    env, sched, _ = _sched_env(pkg, sched_cls, cqs, quota, fits)
    api = pkg[0]
    trace = []
    for step in steps:
        if step[0] == "add":
            env.mgr.add_or_update_workload(_wl(api, *step[1:]))
        elif step[0] == "delete":
            wl = next(w for c in env.cache.cluster_queues.values() for w in c.workloads.values()
                      if w.name == step[1])
            env.cache.delete_workload(wl)
            for cq in cqs:
                env.mgr.queue_associated_inadmissible_workloads_after(cq)
        else:
            res = sched.schedule()
            trace.append((
                [(e.workload.name,
                  _view(e.workload.admission.pod_set_assignments[0].topology_assignment))
                 for e in res.admitted],
                sorted((e.workload.name, e.inadmissible_msg) for e in res.requeued),
            ))
    usage = {f: {k: dict(v) for k, v in fc._usage.items()} for f, fc in env.tas.flavors.items()}
    return trace, usage


S = ("schedule",)
SCHED_SCENARIOS = {
    "admission_carries_topology_assignment": (["cq"], "24", False, [("add", "w1", "cq", 8, 0.0),
                                                                    S]),
    "second_workload_sees_first_usage": (["cq"], "24", False, [
        ("add", "w1", "cq", 12, 0.0), S, ("add", "w2", "cq", 8, 1.0), S]),
    "tas_capacity_exhausted_requeues": (["cq"], "100", False, [
        ("add", "w1", "cq", 12, 0.0), S, ("add", "w2", "cq", 12, 1.0), S]),
    "workload_removal_frees_tas_capacity": (["cq"], "100", False, [
        ("add", "w1", "cq", 12, 0.0), S, ("add", "w2", "cq", 12, 1.0), S, ("delete", "w1"), S]),
    "non_tas_podset_implied_on_tas_flavor": (["cq"], "24", False, [
        ("add", "plain", "cq", 1, 0.0, None, None), S]),
    "overlapping_heads_not_both_admitted": (["cq-a", "cq-b"], "24", True, [
        ("add", "wa", "cq-a", 12, 0.0), ("add", "wb", "cq-b", 12, 1.0), S]),
    "non_overlapping_heads_both_admitted": (["cq-a", "cq-b"], "24", True, [
        ("add", "wa", "cq-a", 12, 0.0), ("add", "wb", "cq-b", 8, 1.0), S]),
    "skipped_head_admits_next_cycle": (["cq-a", "cq-b"], "24", True, [
        ("add", "wa", "cq-a", 12, 0.0), ("add", "wb", "cq-b", 12, 1.0), S, ("delete", "wa"), S]),
}


@pytest.mark.parametrize("name", sorted(SCHED_SCENARIOS))
def test_scheduler_with_tas_hooks_matches_jax(name):
    scenario = SCHED_SCENARIOS[name]
    jax_trace = _run(PKGS[0], JaxScheduler, scenario)
    port_trace = _run(PKGS[1], PortScheduler, scenario)
    assert port_trace == jax_trace
    trace, usage = port_trace
    if name == "overlapping_heads_not_both_admitted":
        assert [n for n, _ in trace[0][0]] == ["wa"]
        assert "no longer fits" in dict(trace[0][1])["wb"].lower()
        assert sum(v.get("cpu", 0) for v in usage["tas-flavor"].values()) == 12000
    if name == "skipped_head_admits_next_cycle":
        assert [n for n, _ in trace[1][0]] == ["wb"]


def test_check_rejects_topology_request_on_plain_flavor():
    msgs = []
    for pkg, sched_cls in ((PKGS[0], JaxScheduler), (PKGS[1], PortScheduler)):
        api = pkg[0]
        _, _, manager = _sched_env(pkg, sched_cls, ["cq"], "24", False)
        plain = api.ResourceFlavor(name="plain")
        cq = api.ClusterQueue(
            name="cq2", namespace_selector={},
            resource_groups=(api.ResourceGroup(
                ("cpu",), (api.FlavorQuotas.build("plain", {"cpu": "8"}),)),),
        )
        ps = api.PodSet.build(
            "main", 1, {"cpu": "1"},
            topology_request=api.PodSetTopologyRequest(mode="Required", level=RACK),
        )
        msgs.append(manager.check(cq, ps, plain))
    assert msgs[0] == msgs[1]
    assert "does not support TopologyAwareScheduling" in msgs[1]
