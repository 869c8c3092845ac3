"""The MultiKueue federation in the PyTorch port against the JAX package.

The in-process scenarios of tests/test_global_scheduler.py
(aggregation, rebalancing), tests/test_federation.py (dispatch,
placement, partitions and fencing, the rank cache, gangs, retraction
dedup, observability) and tests/test_multikueue_transport.py (the
reconnect state machine, orphan GC, batched dispatch), each written
once against a package namespace and run in both packages: the port's
runtimes on ``device="cpu"``, so its global rescore runs kernel B15's
plain version, and the JAX package's jitted B15 on the CPU. The two
runs' observations must be equal: rescore reports (pending, rows with
``best``/``gainS``/``rebalance``, ``rebalanced``, path), dispatch
states (winner, fence, targets), remote holders, retractions, admitted
sets, the managers' events as (reason, key), and the federation's
counters. Left out: what needs the journal, recovery, HTTP or the CLI
(none is ported yet). Also ``run_federation_scale(8, 40)`` with every
``FedScaleResult`` field equal but the walls, with the device rescore
and with ``use_device=False``.
"""

import functools
import re
from types import SimpleNamespace

import numpy as np
import pytest

import kueue_tpu.admissionchecks.multikueue as j_mk
import kueue_tpu.admissionchecks.multikueue_transport as j_tr
import kueue_tpu.controllers as j_ctrl
import kueue_tpu.federation as j_fed
import kueue_tpu.models as j_models
import kueue_tpu.models.cluster_queue as j_cqm
import kueue_tpu.models.constants as j_const
import kueue_tpu.models.workload as j_wlm
import kueue_tpu.perf.multikueue as j_perf
import kueue_tpu.planner as j_planner
import kueue_tpu.serialization as j_ser
import kueue_tpu.testing.faults as j_faults
import kueue_tpu.utils.clock as j_clock
import kueue_tpu_torch.admissionchecks.multikueue as p_mk
import kueue_tpu_torch.admissionchecks.multikueue_transport as p_tr
import kueue_tpu_torch.controllers as p_ctrl
import kueue_tpu_torch.federation as p_fed
import kueue_tpu_torch.models as p_models
import kueue_tpu_torch.models.cluster_queue as p_cqm
import kueue_tpu_torch.models.constants as p_const
import kueue_tpu_torch.models.workload as p_wlm
import kueue_tpu_torch.perf.multikueue as p_perf
import kueue_tpu_torch.planner as p_planner
import kueue_tpu_torch.serialization as p_ser
import kueue_tpu_torch.testing.faults as p_faults
import kueue_tpu_torch.utils.clock as p_clock
from kueue_tpu_torch.ops import _build


def _ns(mk, tr, ctrl, fed, models, cqm, const, wlm, perf, planner, ser, faults, clock,
        runtime):
    return SimpleNamespace(
        MultiKueueCluster=mk.MultiKueueCluster, MultiKueueController=mk.MultiKueueController,
        MultiKueueConfig=mk.MultiKueueConfig, RemoteClient=tr.RemoteClient,
        FlakyTransport=tr.FlakyTransport, InProcessTransport=tr.InProcessTransport,
        TransportError=tr.TransportError, ClusterUnreachable=tr.ClusterUnreachable,
        ORIGIN_LABEL=tr.ORIGIN_LABEL, ClusterRuntime=runtime,
        FederationDispatcher=fed.FederationDispatcher, GlobalScheduler=fed.GlobalScheduler,
        collect_global_snapshot=fed.collect_global_snapshot, GANG_LABEL=fed.GANG_LABEL,
        FENCE_LABEL=fed.FENCE_LABEL, WINNER_LABEL=fed.WINNER_LABEL,
        ResourceFlavor=models.ResourceFlavor, ClusterQueue=models.ClusterQueue,
        LocalQueue=models.LocalQueue, FlavorQuotas=models.FlavorQuotas,
        Workload=models.Workload, AdmissionCheck=models.AdmissionCheck,
        ResourceGroup=cqm.ResourceGroup, WCT=const.WorkloadConditionType,
        MULTIKUEUE_CONTROLLER_NAME=const.MULTIKUEUE_CONTROLLER_NAME, PodSet=wlm.PodSet,
        perf=perf, forecast=planner.forecast_time_to_admission, ser=ser, faults=faults,
        FakeClock=clock.FakeClock,
    )


JAXP = _ns(j_mk, j_tr, j_ctrl, j_fed, j_models, j_cqm, j_const, j_wlm, j_perf, j_planner,
           j_ser, j_faults, j_clock, j_ctrl.ClusterRuntime)
PORT = _ns(p_mk, p_tr, p_ctrl, p_fed, p_models, p_cqm, p_const, p_wlm, p_perf, p_planner,
           p_ser, p_faults, p_clock, functools.partial(p_ctrl.ClusterRuntime, device="cpu"))


@pytest.fixture(autouse=True)
def _clean_faults():
    for m in (JAXP, PORT):
        m.faults.reset()
    yield
    for m in (JAXP, PORT):
        m.faults.reset()


def both(scenario, *args, **kw):
    """The scenario's observations in the JAX package and in the port,
    asserted equal; returns the port's."""
    ref = scenario(JAXP, *args, **kw)
    JAXP.faults.reset()
    got = scenario(PORT, *args, **kw)
    PORT.faults.reset()
    assert got == ref
    return got


# ---- builders (one code path, either package) -----------------------------


def build_worker(m, clock, cpu="10"):
    rt = m.ClusterRuntime(clock=clock)
    rt.add_flavor(m.ResourceFlavor(name="default"))
    rt.add_cluster_queue(
        m.ClusterQueue(
            name="cq", namespace_selector={},
            resource_groups=(
                m.ResourceGroup(("cpu",), (m.FlavorQuotas.build("default", {"cpu": cpu}),)),
            ),
        )
    )
    rt.add_local_queue(m.LocalQueue(namespace="ns", name="lq", cluster_queue="cq"))
    return rt


def wl(m, name, cpu="1", **kw):
    return m.Workload(namespace="ns", name=name, queue_name="lq",
                      pod_sets=(m.PodSet.build("main", 1, {"cpu": cpu}),), **kw)


def finish(m, rt, key, clock):
    w = rt.workloads[key]
    w.set_condition(m.WCT.FINISHED, True, "JobFinished", "done", now=clock.now())
    rt.on_workload_finished(w)


def federation(m, n_workers=2, worker_cpu="10", cpus=None, **disp_kw):
    clock = m.FakeClock(0.0)
    workers, clusters = {}, {}
    for i in range(n_workers):
        name = f"w{i + 1}"
        rt = build_worker(m, clock, cpu=cpus[i] if cpus else worker_cpu)
        workers[name] = rt
        clusters[name] = m.MultiKueueCluster(name=name, runtime=rt)
    mgr = m.ClusterRuntime(clock=clock)
    disp_kw.setdefault("worker_lost_timeout", 20.0)
    disp_kw.setdefault("max_backoff_s", 8.0)
    disp_kw.setdefault("drive_inprocess", True)
    disp = m.FederationDispatcher(mgr, clusters=clusters, **disp_kw)
    return mgr, disp, workers, clock


def congested_federation(m, n_workers=2, fanout=1, hysteresis_s=10.0, n_wl=1, **gs_kw):
    """Every worker saturated by a local hog, ``n_wl`` federated
    workloads parked on their single-target placements."""
    clock = m.FakeClock(0.0)
    workers, clusters = {}, {}
    for i in range(n_workers):
        name = f"w{i + 1}"
        rt = build_worker(m, clock)
        hog = wl(m, f"hog-{name}", cpu="10")
        rt.add_workload(hog)
        rt.run_until_idle()
        assert hog.is_admitted
        workers[name] = rt
        clusters[name] = m.MultiKueueCluster(name=name, runtime=rt)
    mgr = m.ClusterRuntime(clock=clock)
    disp = m.FederationDispatcher(
        mgr, clusters=clusters, drive_inprocess=True, fanout=fanout,
        worker_lost_timeout=1e9, heartbeat_interval_s=1e9,
    )
    gs = m.GlobalScheduler(disp, hysteresis_s=hysteresis_s, rescore_interval_s=0.0, **gs_kw)
    fed = []
    for i in range(n_wl):
        w = wl(m, f"fed-{i}", cpu="4")
        mgr.add_workload(w)
        fed.append(w)
    mgr.run_until_idle()
    assert not any(w.is_admitted for w in fed)
    return mgr, disp, gs, workers, clock, fed


def drive(mgr, clock, passes=6, advance=10.0):
    for _ in range(passes):
        mgr.run_until_idle()
        clock.advance(advance)
    mgr.run_until_idle()


def holders(workers, key):
    return sorted(n for n, rt in workers.items() if key in rt.workloads)


def free_other(m, disp, workers, clock, key):
    cur = disp.states[key].winner or disp.states[key].clusters[0]
    other = next(n for n in workers if n != cur)
    finish(m, workers[other], f"ns/hog-{other}", clock)
    return cur, other


# ---- observations ---------------------------------------------------------

_COUNTERS = re.compile(
    r"^(kueue_multikueue_(?:dispatches|retractions|clusters_active)\S*|"
    r"kueue_global_(?:rebalances|rescore)_total\S*) (\S+)$", re.M)


def report_view(r):
    """A rescore report without its host-clock fields."""
    return {k: v for k, v in r.items() if k not in ("durationMs", "aggregateMs")}


def observe(mgr, disp, workers):
    states = {
        k: (st.winner, st.fence, list(st.clusters), st.finished)
        for k, st in sorted(disp.states.items())
    }
    retractions = sorted(
        (r.key, r.cluster, r.fence, r.acked) for r in disp.retractions.values()
    )
    keys = sorted(set(mgr.workloads) | {k for rt in workers.values() for k in rt.workloads})
    return {
        "states": states,
        "retractions": retractions,
        "holders": {k: holders(workers, k) for k in keys},
        "admitted": sorted(k for k, w in mgr.workloads.items() if w.is_admitted),
        "events": [(e.kind, e.object_key) for e in mgr.events],
        "counters": sorted(_COUNTERS.findall(mgr.metrics.registry.expose())),
        "invariants": [mgr.check_invariants()] + [rt.check_invariants()
                                                   for _, rt in sorted(workers.items())],
    }


def converged(obs, keys):
    assert obs["admitted"] == sorted(keys)
    for k in keys:
        assert len(obs["holders"][k]) == 1, (k, obs["holders"][k])
    assert all(inv == [] for inv in obs["invariants"])


# ---- aggregation (tests/test_global_scheduler.py TestAggregation) ---------


def sc_snapshot(m):
    mgr, disp, gs, workers, clock, fed = congested_federation(m)
    key = fed[0].key
    cur = disp.states[key].clusters[0]
    other = next(n for n in workers if n != cur)
    finish(m, workers[other], f"ns/hog-{other}", clock)
    snap = m.collect_global_snapshot(disp)
    return {
        "dict": snap.to_dict(), "clusters": snap.clusters, "keys": snap.keys,
        "fences": snap.fences, "current": snap.current,
        "tta": snap.tta_ms.tolist(), "valid": snap.valid.tolist(),
        "encode": [np.asarray(a).tolist() for a in snap.encode()],
        "workers": {n: v.to_dict() for n, v in snap.workers.items()},
        "cur": cur, "other": other,
    }


def test_snapshot_standings_capacities_and_forecasts():
    got = both(sc_snapshot)
    j_cur, j_other = got["clusters"].index(got["cur"]), got["clusters"].index(got["other"])
    assert got["tta"][0][j_other] == 0 and got["tta"][0][j_cur] == 600_000
    view = got["workers"][got["cur"]]
    assert view["reachable"] and view["source"] == "inprocess"


def sc_admitted_not_rows(m):
    clock = m.FakeClock(0.0)
    w1 = build_worker(m, clock)
    mgr = m.ClusterRuntime(clock=clock)
    disp = m.FederationDispatcher(
        mgr, clusters={"w1": m.MultiKueueCluster(name="w1", runtime=w1)}, drive_inprocess=True)
    m.GlobalScheduler(disp, rescore_interval_s=0.0)
    w = wl(m, "runs")
    mgr.add_workload(w)
    drive(mgr, clock, passes=2, advance=0.0)
    return {"admitted": w.is_admitted, "keys": m.collect_global_snapshot(disp).keys,
            **observe(mgr, disp, {"w1": w1})}


def test_admitted_workloads_are_not_rows():
    got = both(sc_admitted_not_rows)
    assert got["admitted"] and got["keys"] == []


def sc_partitioned(m):
    mgr, disp, gs, workers, clock, fed = congested_federation(m)

    def _raise():
        raise m.TransportError("aggregation partitioned")

    m.faults.arm("global.partition", action=_raise)
    snap = m.collect_global_snapshot(disp)
    rep = gs.rescore()
    return {"reachable": [v.reachable for v in snap.workers.values()],
            "valid": snap.valid.tolist(), "report": report_view(rep)}


def test_partitioned_worker_degrades_not_fails():
    got = both(sc_partitioned)
    assert not any(got["reachable"]) and got["report"]["rebalanced"] == []


# ---- rebalancing (TestRebalancing) ----------------------------------------


def sc_rebalance(m):
    mgr, disp, gs, workers, clock, fed = congested_federation(m)
    key = fed[0].key
    cur, other = free_other(m, disp, workers, clock, key)
    report = gs.rescore()
    st = disp.states[key]
    after_move = (st.fence, list(st.clusters))
    drive(mgr, clock, passes=4)
    return {"report": report_view(report), "after_move": after_move, "cur": cur,
            "other": other, "rebalances": gs.rebalances, **observe(mgr, disp, workers)}


def test_rebalance_moves_parked_workload_and_converges():
    got = both(sc_rebalance)
    key = "ns/fed-0"
    assert got["report"]["path"] == "device"
    assert got["report"]["rebalanced"] == [
        {"workload": key, "from": got["cur"], "to": got["other"], "gainS": 600.0}]
    assert got["after_move"] == (2, [got["other"]])
    converged(got, [key])
    assert ("MultiKueueRebalanced", key) in got["events"]
    assert got["rebalances"] == 1


def sc_rebalance_trace(m):
    mgr, disp, gs, workers, clock, fed = congested_federation(m)
    key = fed[0].key
    free_other(m, disp, workers, clock, key)
    gs.rescore()
    tid = mgr.tracer.workload_trace_id(key)
    return sorted({s.name for s in mgr.tracer.trace(tid)})


def test_rebalance_span_joins_lifecycle_trace():
    names = both(sc_rebalance_trace)
    assert "global.rescore" in names and "federation.dispatch" in names


def sc_gs_variant(m, free=True, **kw):
    mgr, disp, gs, workers, clock, fed = congested_federation(m, **kw)
    if free:
        free_other(m, disp, workers, clock, fed[0].key)
    report = gs.rescore()
    return {"report": report_view(report), **observe(mgr, disp, workers)}


@pytest.mark.parametrize("kw", [
    {"hysteresis_s": 10_000.0},  # > the 600 s runtime-hint gain
    {"fanout": 2},  # the better cluster is already a target
    {"use_device": False},
    {"degraded_penalty_s": 5000.0},
], ids=["hysteresis", "covered-target", "host-mirror", "penalty"])
def test_rescore_variants(kw):
    got = both(sc_gs_variant, **kw)
    if "hysteresis_s" in kw or "fanout" in kw:
        assert got["report"]["rebalanced"] == []
    assert got["report"]["path"] == ("host" if kw.get("use_device") is False else "device")


def test_host_mirror_path_decides_identically():
    dev = sc_gs_variant(PORT)
    host = sc_gs_variant(PORT, use_device=False)
    assert dev["report"]["workloads"] == host["report"]["workloads"]
    assert dev["report"]["rebalanced"] == host["report"]["rebalanced"]


def sc_stale_fence(m):
    mgr, disp, gs, workers, clock, fed = congested_federation(m)
    key = fed[0].key
    free_other(m, disp, workers, clock, key)
    m.faults.arm("global.stale_fence", action=lambda t: t + 1)
    first = report_view(gs.rescore())
    fence = disp.states[key].fence
    m.faults.reset()
    second = report_view(gs.rescore())
    drive(mgr, clock, passes=4)
    return {"first": first, "fence": fence, "second": second, **observe(mgr, disp, workers)}


def test_stale_fence_cas_drops_the_move():
    got = both(sc_stale_fence)
    assert got["first"]["rebalanced"] == [] and got["fence"] == 1
    converged(got, ["ns/fed-0"])


def sc_max_rebalances(m):
    mgr, disp, gs, workers, clock, fed = congested_federation(
        m, n_workers=3, n_wl=3, max_rebalances_per_pass=1)
    targets = {(disp.states[w.key].winner or disp.states[w.key].clusters[0]) for w in fed}
    for name in workers:
        if name not in targets:
            finish(m, workers[name], f"ns/hog-{name}", clock)
    return {"report": report_view(gs.rescore()), **observe(mgr, disp, workers)}


def test_max_rebalances_per_pass_caps_churn():
    got = both(sc_max_rebalances)
    assert len(got["report"]["rebalanced"]) <= 1


def sc_interval(m):
    mgr, disp, gs, workers, clock, fed = congested_federation(m)
    gs.rescore_interval_s = 30.0
    gs.rescore()
    n = [gs.rescores]
    mgr.run_until_idle()
    n.append(gs.rescores)
    clock.advance(31.0)
    mgr.run_until_idle()
    n.append(gs.rescores)
    return n


def test_interval_gating():
    n = both(sc_interval)
    assert n[1] == n[0] and n[2] == n[0] + 1


def sc_standings(m):
    mgr, disp, gs, workers, clock, fed = congested_federation(m)
    key = fed[0].key
    free_other(m, disp, workers, clock, key)
    before = m.ser.runtime_to_state(mgr)
    body = gs.standings()
    return {"unchanged": m.ser.runtime_to_state(mgr) == before,
            "fence": disp.states[key].fence, "body": report_view(body)}


def test_standings_is_read_only():
    got = both(sc_standings)
    assert got["unchanged"] and got["fence"] == 1
    (row,) = got["body"]["workloads"]
    assert row["rebalance"] is True and row["best"] is not None


# ---- dispatch (tests/test_federation.py) ----------------------------------


def sc_first_reserving(m):
    mgr, disp, workers, clock = federation(m)
    w = wl(m, "job-a")
    mgr.add_workload(w)
    drive(mgr, clock, passes=3)
    st = disp.states[w.key]
    return {"fence_label": workers[st.winner].workloads[w.key].labels[m.FENCE_LABEL],
            "winner_label": w.labels[m.WINNER_LABEL], **observe(mgr, disp, workers)}


def test_first_reserving_wins_and_losers_are_retracted():
    got = both(sc_first_reserving)
    winner = got["states"]["ns/job-a"][0]
    assert got["holders"]["ns/job-a"] == [winner] and got["winner_label"] == winner
    assert got["fence_label"] == "1"
    converged(got, ["ns/job-a"])


def sc_many(m, n_workers=3, n_wl=6, cpus=None, **kw):
    mgr, disp, workers, clock = federation(m, n_workers=n_workers, cpus=cpus, **kw)
    for i in range(n_wl):
        mgr.add_workload(wl(m, f"ref-{i}", cpu=str(1 + i % 3)))
    drive(mgr, clock)
    return observe(mgr, disp, workers)


@pytest.mark.parametrize("kw", [
    {}, {"fanout": 1}, {"rank_cache": False}, {"cpus": ["4", "7", "10", "13"], "n_workers": 4},
], ids=["default", "fanout-1", "no-rank-cache", "uneven"])
def test_dispatch_converges(kw):
    got = both(sc_many, **kw)
    converged(got, [f"ns/ref-{i}" for i in range(6)])


def sc_finish_and_delete(m):
    mgr, disp, workers, clock = federation(m)
    a, b = wl(m, "job-fin"), wl(m, "job-del")
    mgr.add_workload(a)
    mgr.add_workload(b)
    drive(mgr, clock, passes=3)
    winner = disp.states[a.key].winner
    finish(m, workers[winner], a.key, clock)
    mgr.delete_workload(b)
    drive(mgr, clock, passes=3)
    return {"finished": a.is_finished, **observe(mgr, disp, workers)}


def test_finish_propagates_and_delete_retracts():
    got = both(sc_finish_and_delete)
    assert got["finished"]
    assert got["holders"].get("ns/job-fin", []) == []
    assert got["holders"].get("ns/job-del", []) == []
    assert "ns/job-fin" not in got["states"]


def sc_planner_ranks(m):
    mgr, disp, workers, clock = federation(m, n_workers=2)
    big = wl(m, "hog", cpu="10")
    workers["w1"].add_workload(big)
    workers["w1"].run_until_idle()
    winners = []
    for i in range(3):
        w = wl(m, f"placed-{i}")
        mgr.add_workload(w)
        drive(mgr, clock, passes=2, advance=0.0)
        winners.append(disp.states[w.key].winner)
    return {"winners": winners, **observe(mgr, disp, workers)}


def test_planner_ranks_cluster_with_free_quota_first():
    assert both(sc_planner_ranks)["winners"] == ["w2"] * 3


def sc_forecast(m):
    clock = m.FakeClock(0.0)
    rt = build_worker(m, clock)
    out = [m.forecast(rt, wl(m, "fits"))]
    rt.add_workload(wl(m, "hog", cpu="10"))
    rt.run_until_idle()
    out.append(m.forecast(rt, wl(m, "queued"), runtime_hint_s=600.0))
    out.append(m.forecast(rt, wl(m, "never"), runtime_hint_s=600.0, horizon_s=10.0))
    stray = m.Workload(namespace="ns", name="stray", queue_name="nope",
                       pod_sets=(m.PodSet.build("main", 1, {"cpu": "1"}),))
    out.append(m.forecast(rt, stray))
    before = m.ser.runtime_to_state(rt)
    m.forecast(rt, wl(m, "probe"))
    out.append(m.ser.runtime_to_state(rt) == before)
    return out


def test_forecast_time_to_admission():
    assert both(sc_forecast) == [0.0, 600.0, None, None, True]


# ---- partitions and fencing -----------------------------------------------


def sc_winner_lost(m):
    mgr, disp, workers, clock = federation(m)
    w = wl(m, "job-p")
    mgr.add_workload(w)
    drive(mgr, clock, passes=2, advance=0.0)
    first = disp.states[w.key].winner
    disp.clusters[first].mark_lost(clock.now())
    clock.advance(21.0)
    drive(mgr, clock, passes=3)
    mid = observe(mgr, disp, workers)
    disp.clusters[first].mark_connected()
    drive(mgr, clock, passes=3)
    return {"first": first, "mid": mid, **observe(mgr, disp, workers)}


def test_winner_lost_past_timeout_redispatches_with_fence_bump():
    got = both(sc_winner_lost)
    key = "ns/job-p"
    assert got["mid"]["states"][key][1] == 2 and got["mid"]["states"][key][0] != got["first"]
    converged(got, [key])


def sc_stale_token(m):
    mgr, disp, workers, clock = federation(m)
    w = wl(m, "job-stale")
    mgr.add_workload(w)
    drive(mgr, clock, passes=2, advance=0.0)
    m.faults.arm("multikueue.stale_token", action=lambda t: t + 1000)
    mgr.run_until_idle()
    st = disp.states[w.key]
    deposed = (st.winner, st.fence)
    m.faults.reset()
    drive(mgr, clock, passes=4)
    return {"deposed": deposed, **observe(mgr, disp, workers)}


def test_stale_fencing_token_is_refused():
    got = both(sc_stale_token)
    assert got["deposed"][0] is None and got["deposed"][1] >= 2
    converged(got, ["ns/job-stale"])


def sc_lost_retraction(m):
    mgr, disp, workers, clock = federation(m)
    w = wl(m, "job-r")
    mgr.add_workload(w)

    def lose_it():
        raise m.TransportError("retraction lost to partition")

    m.faults.arm("multikueue.lost_retraction", action=lose_it)
    drive(mgr, clock, passes=3)
    mid = observe(mgr, disp, workers)
    fired = m.faults.disarm("multikueue.lost_retraction")
    drive(mgr, clock, passes=4)
    return {"mid": mid, "fired": fired, **observe(mgr, disp, workers)}


def test_lost_retraction_retried_until_acked():
    got = both(sc_lost_retraction)
    assert got["fired"] >= 1 and any(not r[3] for r in got["mid"]["retractions"])
    assert all(r[3] for r in got["retractions"])
    converged(got, ["ns/job-r"])


def sc_redelivery(m):
    mgr, disp, workers, clock = federation(m)
    w = wl(m, "job-idem")
    mgr.add_workload(w)
    drive(mgr, clock, passes=3)
    loser = next(n for n in workers if n != disp.states[w.key].winner)
    for r in disp.retractions.values():
        if r.cluster == loser:
            r.acked = False
    disp.pump_retractions()
    dedup = (w.key, loser, 1)
    disp._enqueue_retraction(w.key, loser, 1)
    reopened = disp.retractions[dedup].acked
    disp.pump_retractions()
    return {"reopened_acked": reopened, **observe(mgr, disp, workers)}


def test_retraction_is_idempotent_and_reopens():
    got = both(sc_redelivery)
    assert got["reopened_acked"] is False and all(r[3] for r in got["retractions"])
    converged(got, ["ns/job-idem"])


def sc_replay_records(m):
    clock = m.FakeClock(0.0)
    fresh = m.FederationDispatcher(m.ClusterRuntime(clock=clock), clusters={})
    records = [
        ("federation_retract_enqueue", {"key": "ns/x", "cluster": "w2", "fence": 1}),
        ("federation_retract_done", {"key": "ns/x", "cluster": "w2", "fence": 1}),
    ]
    fresh.restore(records + records)
    return sorted((r.key, r.cluster, r.fence, r.acked) for r in fresh.retractions.values())


def test_duplicated_records_restore_to_single_entries():
    assert both(sc_replay_records) == [("ns/x", "w2", 1, True)]


def sc_quarantine(m):
    mgr, disp, workers, clock = federation(
        m, cluster_quarantine_threshold=2, cluster_quarantine_ttl_s=100.0)
    bad = "w1"
    for i in range(2):
        w = wl(m, f"flap-{i}")
        mgr.add_workload(w)
        drive(mgr, clock, passes=2, advance=0.0)
        if disp.states[w.key].winner != bad:
            disp.clusters["w2"].mark_lost(clock.now())
            disp.clusters["w2"].mark_connected()
        disp.clusters[bad].mark_lost(clock.now())
        clock.advance(21.0)
        mgr.run_until_idle()
        disp.clusters[bad].mark_connected()
        drive(mgr, clock, passes=2)
    h = disp.health[bad]
    mid = (h.strikes, h.quarantined(clock.now()))
    clock.advance(200.0)
    mgr.run_until_idle()
    return {"mid": mid, "after": disp.health[bad].quarantined(clock.now()),
            **observe(mgr, disp, workers)}


def test_cluster_quarantined_after_repeated_deposals():
    assert both(sc_quarantine)["after"] is False


# ---- rank cache, gangs, observability -------------------------------------


def sc_placement_memo(m):
    calls = []
    clock = m.FakeClock(0.0)
    rt = build_worker(m, clock)
    mgr = m.ClusterRuntime(clock=clock)
    disp = m.FederationDispatcher(
        mgr, clusters={"w1": m.MultiKueueCluster(name="w1", runtime=rt)},
        placement=lambda cluster, w: calls.append((cluster.name, w.key)) or 1.0)
    w = wl(m, "memo")
    mgr.add_workload(w)
    disp._step_seq += 1
    disp.rank_clusters(w)
    disp.rank_clusters(w)
    n = [calls.count(("w1", w.key))]
    disp._step_seq += 1
    disp.rank_clusters(w)
    n.append(calls.count(("w1", w.key)))
    disp.health["w1"].quarantined_until = clock.now() + 100.0
    return {"calls": n, "healthy": disp._healthy_names(clock.now())}


def test_placement_scored_once_per_pair_per_step():
    assert both(sc_placement_memo) == {"calls": [1, 2], "healthy": []}


def sc_gang(m, depose=True):
    mgr, disp, workers, clock = federation(m)
    members = []
    for i in range(2):
        w = wl(m, f"gang-{i}")
        w.labels["kueue.x-k8s.io/multikueue-gang"] = "ns/jobset-a"
        mgr.add_workload(w)
        members.append(w)
    drive(mgr, clock, passes=3)
    winner = disp.states[members[0].key].winner
    labels = [workers[disp.states[w.key].winner].workloads[w.key].labels[m.GANG_LABEL]
              for w in members]
    first = observe(mgr, disp, workers)
    disp.clusters[winner].mark_lost(clock.now())
    clock.advance(21.0)
    mgr.run_until_idle()
    mid = observe(mgr, disp, workers)
    disp.clusters[winner].mark_connected()
    drive(mgr, clock, passes=4)
    return {"labels": labels, "first": first, "mid": mid, **observe(mgr, disp, workers)}


def test_gang_sync_and_atomic_retract():
    got = both(sc_gang)
    keys = ["ns/gang-0", "ns/gang-1"]
    assert got["labels"] == ["ns/jobset-a"] * 2
    assert len({got["first"]["states"][k][0] for k in keys}) == 1
    assert all(got["mid"]["states"][k][1] == 2 for k in keys)
    converged(got, keys)


def sc_observability(m):
    mgr, disp, workers, clock = federation(m)
    mgr.add_workload(wl(m, "job-m"))
    drive(mgr, clock, passes=3)
    status = disp.status()
    rep = disp.health_report()
    disp.clusters["w1"].mark_lost(clock.now())
    rep2 = disp.health_report()
    status_view = {
        "workloads": [{k: v for k, v in s.items() if k in ("workload", "winner", "fence")}
                      for s in status["workloads"]],
        "clusters": sorted(c["name"] for c in status["clusters"]),
    }
    return {"status": status_view,
            "health": [(r["clusters"], r["lost"], r["degraded"]) for r in (rep, rep2)],
            **observe(mgr, disp, workers)}


def test_metrics_health_and_status():
    got = both(sc_observability)
    assert got["health"] == [(2, [], False), (2, ["w1"], True)]
    assert ("kueue_multikueue_clusters_active", "2") in got["counters"]


# ---- transports (tests/test_multikueue_transport.py) ----------------------


def sc_remote_client(m):
    clock = m.FakeClock(0.0)
    rt = build_worker(m, clock)
    flaky = m.FlakyTransport(m.InProcessTransport(rt))
    client = m.RemoteClient(flaky, clock, base_backoff_s=1.0, max_backoff_s=8.0, jitter=0.0)
    flaky.down = True
    trail = []
    for _ in range(6):
        try:
            client.call("get_workload", "ns/x")
        except (m.TransportError, m.ClusterUnreachable) as exc:
            trail.append((type(exc).__name__, client.active, client.failed_attempts,
                          client.next_retry_at))
        clock.advance(client.next_retry_at - clock.now() if client.next_retry_at else 1.0)
    flaky.down = False
    clock.advance(10.0)
    trail.append((client.call("get_workload", "ns/x"), client.active, client.failed_attempts))
    return trail


def test_remote_client_backoff_state_machine():
    trail = both(sc_remote_client)
    assert trail[-1] == (None, True, 0)


def sc_batched_controller(m, n_wl=12):
    clock = m.FakeClock(0.0)
    mgr = m.ClusterRuntime(clock=clock)
    mgr.add_flavor(m.ResourceFlavor(name="default"))
    mgr.add_admission_check(m.AdmissionCheck(
        name="mk", controller_name=m.MULTIKUEUE_CONTROLLER_NAME, parameters="cfg"))
    mgr.add_cluster_queue(m.ClusterQueue(
        name="cq", namespace_selector={}, admission_checks=("mk",),
        resource_groups=(m.ResourceGroup(("cpu",), (m.FlavorQuotas.build("default",
                                                                          {"cpu": "100"}),)),)))
    mgr.add_local_queue(m.LocalQueue(namespace="ns", name="lq", cluster_queue="cq"))
    workers = {n: build_worker(m, clock, cpu="4") for n in ("w1", "w2")}
    clusters = {n: m.MultiKueueCluster(name=n, runtime=rt) for n, rt in workers.items()}
    ctrl = m.MultiKueueController(
        mgr, clusters=clusters,
        configs={"cfg": m.MultiKueueConfig(name="cfg", clusters=tuple(clusters))},
        batch_dispatch=True)
    mgr.admission_check_controllers.append(ctrl)
    for i in range(n_wl):
        mgr.add_workload(wl(m, f"mk-{i}"))
    for _ in range(8):
        mgr.run_until_idle()
        for rt in workers.values():
            rt.run_until_idle()
    # a foreign-origin copy stays; the copies of a deleted owner go
    foreign = wl(m, "foreign")
    foreign.labels[m.ORIGIN_LABEL] = "someone-else"
    workers["w1"].add_workload(foreign)
    gone = mgr.workloads["ns/mk-0"]
    mgr.delete_workload(gone)
    removed = ctrl.gc_orphans()
    orphan_gone = all(gone.key not in rt.workloads for rt in workers.values())
    orphan_gone = orphan_gone and foreign.key in workers["w1"].workloads and removed >= 1
    return {
        "admitted": sorted(k for k, w in mgr.workloads.items() if w.is_admitted),
        "remote": {n: sorted(k for k, w in rt.workloads.items() if w.has_quota_reservation)
                   for n, rt in workers.items()},
        "orphan_gone": orphan_gone,
        "removed": removed,
        "events": [(e.kind, e.object_key) for e in mgr.events],
    }


def test_batched_dispatch_and_orphan_gc():
    got = both(sc_batched_controller)
    assert got["admitted"] and got["orphan_gone"]


def test_http_transport_refuses_in_the_port():
    with pytest.raises(NotImplementedError, match="A9"):
        p_tr.HTTPTransport("http://127.0.0.1:1")


def test_feed_reader_refuses_in_the_port():
    mgr, disp, gs, workers, clock, fed = congested_federation(PORT)
    with pytest.raises(NotImplementedError, match="A9"):
        gs.attach_feed_reader("w9", "http://127.0.0.1:1")


def test_rescore_raises_what_the_kernel_raises(monkeypatch):
    """No containment: a KernelError of B15 leaves GlobalScheduler.rescore
    and nothing re-solves the pass on the host."""
    import kueue_tpu_torch.ops.global_kernel as gk
    import kueue_tpu_torch.ops.global_np as gnp

    mgr, disp, gs, workers, clock, fed = congested_federation(PORT)
    free_other(PORT, disp, workers, clock, fed[0].key)

    def boom(*a, **k):
        raise _build.KernelError("B15 failed")

    host = []
    n = gs.rescores
    monkeypatch.setattr(gk, "rescore_packed", boom)
    monkeypatch.setattr(gnp, "rescore_np", lambda *a, **k: host.append(a))
    with pytest.raises(_build.KernelError):
        gs.rescore()
    assert host == [] and gs.rescores == n


# ---- the scale run (bench.py's federation stage, cut) ---------------------


@pytest.mark.parametrize("use_device", [True, False], ids=["device", "host"])
def test_federation_scale_cut_matches(use_device):
    jrep, prep = [], []
    jres = _jax_fed_scale(jrep, n_workers=8, n_workloads=40, use_device=use_device)
    pres = p_perf.run_federation_scale(n_workers=8, n_workloads=40, device="cpu",
                                       use_device=use_device,
                                       on_scheduler=p_perf.record_rescores(prep))
    assert p_perf.fed_scale_summary(pres) == p_perf.fed_scale_summary(jres)
    assert [report_view(r) for r in prep] == [report_view(r) for r in jrep]
    assert p_perf.rebalance_digest(prep) == p_perf.rebalance_digest(jrep)
    assert pres.admitted == pres.total
    paths = {r["path"] for r in prep if r["pending"]}
    assert paths == ({"device"} if use_device else {"host"})


def _jax_fed_scale(reports, use_device=True, **kw):
    """The JAX package's run_federation_scale with its GlobalScheduler's
    rescore reports recorded (and its device choice set)."""
    real_init = j_fed.GlobalScheduler.__init__

    def init(self, *a, **k):
        real_init(self, *a, **k, use_device=use_device)
        p_perf.record_rescores(reports)(self)

    j_fed.GlobalScheduler.__init__ = init
    try:
        return j_perf.run_federation_scale(**kw)
    finally:
        j_fed.GlobalScheduler.__init__ = real_init


@pytest.mark.slow
def test_federation_50_constants_from_the_jax_package():
    """``FED_SCALE_EXPECT``, ``FED_REBALANCE_DIGEST`` and
    ``FED_RESCORE_PENDING``, which chip_smoke.py holds the card's
    federation-50 run to, recomputed from the JAX package's
    ``run_federation_scale(n_workers=50)`` (bench.py's federation stage)."""
    reports = []
    res = _jax_fed_scale(reports, n_workers=50)
    assert p_perf.fed_scale_summary(res) == p_perf.FED_SCALE_EXPECT
    assert p_perf.rebalance_digest(reports) == p_perf.FED_REBALANCE_DIGEST
    assert tuple(r["pending"] for r in reports if r["pending"]) == p_perf.FED_RESCORE_PENDING
