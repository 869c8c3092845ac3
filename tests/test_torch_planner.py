"""The what-if planner in kueue_tpu_torch (``Planner.plan`` with its B14
solve on the CPU: the plain versions) against kueue_tpu's, exactly: the
reports' ``to_dict()`` (timings aside) and every scenario's raw
per-head outcome.

Covers the specs of tests/test_planner.py's TestScenarioDeltas,
TestNoOpDifferential, TestWhatWouldItTake and TestForecast (the forecast
against the JAX package's forecast), ``include_reasons`` none / baseline
/ all, ``heads_mode`` backlog and cycle, ``use_device=False`` and
``verify_host=True``, every scenario delta kind (policy and priority
included), ``plan_request`` and ``forecast_time_to_admission`` through a
stand-in runtime, the wire codec, planner-stage-500 cut to 9 scenarios
and, in full, held to ``PLANNER_STAGE_EXPECT``; planner-sweep-50k and
the Gavel forecast at policy-48x64 run under ``slow``.

Both packages build the same clusters from plain data; the JAX side's
Scheduler runs with ``use_solver=False`` (ROADMAP Queue C, PR 4).
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

from kueue_tpu_torch.perf import planner as pp

TIMINGS = ("durationMs", "sweepMs", "scenariosPerSecond")
RAW = ("chosen", "admitted", "borrows", "reserved", "preempt_k", "usage")


def _pkg(root: str) -> SimpleNamespace:
    def m(name):
        return importlib.import_module(f"{root}.{name}")

    return SimpleNamespace(
        api=pp.planner_api(
            m("models"), m("models.cluster_queue"), m("models.workload"), m("core.cache"),
            m("core.queue_manager"), m("utils.clock"), m("planner"), m("policy"),
            m("core.snapshot"),
        ),
        Scheduler=m("core.scheduler").Scheduler,
        planner=m("planner"),
        scen=m("planner.scenarios"),
        encode=m("core.encode"),
        policy=m("policy"),
        port=root == "kueue_tpu_torch",
    )


JAX = _pkg("kueue_tpu")
PORT = _pkg("kueue_tpu_torch")


def _env(p, workloads=(), settle=True, policy=None):
    """tests/test_planner.py's runtime: a cohort of two ClusterQueues
    (cq-a cannot borrow, cq-b can lend) and the workloads, settled by
    the Scheduler's cycles when ``settle``; a stand-in runtime."""
    a = p.api
    clock = a.FakeClock(1000.0)
    cache, mgr = a.Cache(), a.QueueManager(clock)
    cache.add_or_update_flavor(a.ResourceFlavor(name="default"))
    for name, borrowing in (("cq-a", "0"), ("cq-b", None)):
        cq = a.ClusterQueue(
            name=name, cohort="co", namespace_selector={},
            resource_groups=(a.ResourceGroup(
                ("cpu",), (a.FlavorQuotas.build("default", {"cpu": ("4", borrowing, None)}),)
            ),),
        )
        cache.add_or_update_cluster_queue(cq)
        mgr.add_cluster_queue(cq)
        lq = a.LocalQueue(namespace="ns", name=f"lq-{name[-1]}", cluster_queue=name)
        cache.add_or_update_local_queue(lq)
        mgr.add_local_queue(lq)
    for name, cpu, lq, prio, created, labels in workloads:
        mgr.add_or_update_workload(a.Workload(
            namespace="ns", name=name, queue_name=lq, priority=prio, creation_time=created,
            labels=dict(labels), pod_sets=(a.PodSet.build("main", 1, {"cpu": cpu}),),
        ))
    kw = {"device": "cpu"} if p.port else {"use_solver": False}
    sched = p.Scheduler(queues=mgr, cache=cache, clock=clock, policy=policy, **kw)
    if settle:
        for _ in range(6):
            sched.schedule()
    return SimpleNamespace(
        cache=cache, queues=mgr, scheduler=sched, transform_config=None, metrics=None,
        policy=policy, clock=clock, elastic=None, device="cpu",
    )


def _wl(name, cpu="2", lq="lq-a", priority=0, created=0.0, labels=()):
    return (name, cpu, lq, priority, created, labels)


STUCK = [_wl("small", "2", created=0.0), _wl("big", "8", created=1.0)]
PENDING = [
    _wl("a1", "2", "lq-a", 10, 0.0, (("kueue.tpu/deadline", "1500"),)),
    _wl("a2", "8", "lq-a", 5, 1.0),
    _wl("b1", "3", "lq-b", 0, 2.0, (("kueue.tpu/throughput-default", "2.5"),)),
    _wl("b2", "3", "lq-b", 0, 3.0),
]


def _both(workloads, settle=True, plan_kw=None, scenarios=None, policy=None):
    """(JAX report, port report) of the same plan on the same cluster."""
    out = []
    for p in (JAX, PORT):
        rt = _env(p, workloads, settle, policy=None if policy is None
                  else p.policy.resolve_policy(policy))
        scen = scenarios(p) if scenarios is not None else None
        out.append(p.planner.Planner.for_runtime(rt).plan(
            scenarios=scen, **(plan_kw or {})
        ))
    return out


def _strip(d: dict) -> dict:
    return {k: v for k, v in d.items() if k not in TIMINGS}


def assert_reports_equal(jrep, prep):
    assert _strip(prep.to_dict()) == _strip(jrep.to_dict())
    for jo, po in zip(jrep.scenarios, prep.scenarios):
        assert po.name == jo.name
        for k in RAW:
            np.testing.assert_array_equal(np.asarray(po.raw[k]), np.asarray(jo.raw[k]),
                                          err_msg=f"{po.name} {k}")
        if "order" in jo.raw:
            np.testing.assert_array_equal(po.raw["order"], jo.raw["order"])


def _mixed_scenarios(p, heads_mode="backlog"):
    """One scenario of every delta kind, plus two no-ops."""
    s = p.scen
    deltas = [
        ("noop-0", ()),
        ("noop-1", ()),
        ("quota", (s.NominalQuotaDelta("cq-a", "default", "cpu", 4000),)),
        ("cut", (s.NominalQuotaDelta("cq-b", "default", "cpu", -3000),)),
        ("capacity", (s.FlavorCapacityDelta.build("cq-a", "default", {"cpu": 6000}),)),
        ("remove", (s.FlavorCapacityDelta.build("cq-b", "default", None),)),
        ("lend", (s.LendingLimitDelta("cq-b", "default", "cpu", 1000),)),
        ("borrow", (s.BorrowingLimitDelta("cq-a", "default", "cpu", None),)),
        ("weight", (s.FairShareWeightDelta("cq-b", 2500),)),
        ("priority", (s.PriorityDelta("ns/b2" if heads_mode == "backlog" else "ns/b1", 50),)),
        ("drain", (s.DrainDomainDelta.build("default", {"cpu": 5000}, domain="rack-1"),)),
        ("gavel", (s.PolicyDelta("gavel"),)),
        ("deadline", (s.PolicyDelta("deadline", now=1400.0),)),
    ]
    return [p.api.PlanScenario(name=n, deltas=d) for n, d in deltas]


class TestScenarioDeltas:
    def _view(self, p):
        rt = _env(p, STUCK)
        snap = p.api.take_snapshot(rt.cache)
        enc = p.encode.encode_snapshot(snap)
        row_index = {name: i for i, name in enumerate(enc.cq_names)}
        for j, name in enumerate(enc.cohort_names):
            row_index[name] = enc.n_cq + j
        return p.scen.ArrayView(
            nominal=enc.nominal.copy(), lending=enc.lending_limit.copy(),
            borrowing=enc.borrowing_limit.copy(), usage=enc.local_usage.copy(),
            priority=np.zeros(4, dtype=np.int64), weight=enc.weight_milli.copy(),
            row_index=row_index, fr_index=snap.fr_index, head_slots={"ns/big": [1]},
            n_cq=enc.n_cq,
        )

    def test_deltas_edit_the_same_cells(self):
        views = {}
        for p in (JAX, PORT):
            view = self._view(p)
            for scen in _mixed_scenarios(p):
                if scen.name in ("priority", "gavel", "deadline"):
                    continue
                scen.apply(view)
            p.scen.PriorityDelta("ns/big", 100).apply(view)
            p.scen.NominalQuotaDelta("cq-a", "default", "cpu", -10**9).apply(view)
            views[p.port] = view
        for f in ("nominal", "lending", "borrowing", "usage", "priority", "weight"):
            np.testing.assert_array_equal(getattr(views[True], f), getattr(views[False], f))
        assert views[True].nominal[views[True].row("cq-a")].sum() == 0

    def test_unknown_references_raise(self):
        view = self._view(PORT)
        s = PORT.scen
        for bad in (s.NominalQuotaDelta("ghost", "default", "cpu", 1),
                    s.NominalQuotaDelta("cq-a", "default", "gpu", 1),
                    s.PriorityDelta("ns/ghost", 1),
                    s.PolicyDelta("gavel")):  # no lowered backlog on this view
            with pytest.raises(s.ScenarioApplyError):
                bad.apply(view)
        with pytest.raises(s.ScenarioApplyError):
            s.delta_from_dict({"kind": "warp-drive"})
        with pytest.raises(s.ScenarioApplyError):
            s.PolicyDelta("no-such-policy").apply(view)

    def test_wire_codec_round_trip(self):
        for p in (JAX, PORT):
            scens = _mixed_scenarios(p)
            for scen in scens:
                for d in scen.deltas:
                    back = p.scen.delta_from_dict(d.to_dict())
                    assert back.to_dict() == d.to_dict()
                assert p.scen.scenario_from_dict(scen.to_dict()).to_dict() == scen.to_dict()
                assert len(scen.describe()) == len(scen.deltas)
        wire = [s.to_dict() for s in _mixed_scenarios(JAX)]
        assert [s.to_dict() for s in _mixed_scenarios(PORT)] == wire
        assert [PORT.scen.scenario_from_dict(d).describe() for d in wire] == [
            JAX.scen.scenario_from_dict(d).describe() for d in wire
        ]


@pytest.mark.parametrize("heads_mode", ["backlog", "cycle"])
@pytest.mark.parametrize("include_reasons", ["none", "baseline", "all"])
def test_every_delta_kind_equals_jax(heads_mode, include_reasons):
    jrep, prep = _both(
        PENDING, settle=False, scenarios=lambda p: _mixed_scenarios(p, heads_mode),
        plan_kw=dict(heads_mode=heads_mode, include_reasons=include_reasons),
    )
    assert prep.backend == "device" and prep.launches == 1
    assert_reports_equal(jrep, prep)
    if include_reasons == "all":
        assert any(o.reasons for o in prep.scenarios)


@pytest.mark.parametrize("use_device,verify_host", [(False, False), (True, True)])
def test_host_mirror_and_verify_host_equal_jax(use_device, verify_host):
    jrep, prep = _both(
        PENDING, settle=False, scenarios=_mixed_scenarios,
        plan_kw=dict(use_device=use_device, verify_host=verify_host, include_reasons="all"),
    )
    assert prep.backend == ("device" if use_device else "host")
    assert_reports_equal(jrep, prep)


class TestNoOpDifferential:
    def test_noop_scenarios_equal_next_cycle(self):
        rt = _env(PORT, PENDING, settle=False)
        planner = PORT.planner.Planner.for_runtime(rt)
        noops = [PORT.api.PlanScenario(name=f"noop-{i}") for i in range(6)]
        report = planner.plan(scenarios=noops, heads_mode="cycle", include_reasons="all",
                              verify_host=True)
        base = report.baseline
        for o in report.scenarios:
            assert (o.admitted, o.pending, o.newly_admitted, o.lost) == (
                base.admitted, base.pending, [], [])
            assert o.utilization == base.utilization
        host = planner.plan(scenarios=noops, heads_mode="cycle", include_reasons="all",
                            use_device=False)
        assert [(o.admitted, o.reasons) for o in host.scenarios] == [
            (o.admitted, o.reasons) for o in report.scenarios
        ]
        result = rt.scheduler.schedule()
        assert base.admitted == sorted(e.workload.key for e in result.admitted)
        for key in base.pending:
            recs = rt.scheduler.audit.for_workload(key)
            assert recs and base.reasons[key]["reason"] == recs[-1].reason.value, key

    def test_noop_differential_full_backlog(self):
        jrep, prep = _both(
            PENDING, settle=False,
            scenarios=lambda p: [p.api.PlanScenario(name=f"noop-{i}") for i in range(4)],
            plan_kw=dict(heads_mode="backlog", verify_host=True),
        )
        assert_reports_equal(jrep, prep)
        rt = _env(PORT, PENDING, settle=True)
        admitted = sorted(PORT.api.take_snapshot(rt.cache).workloads)
        for o in prep.scenarios:
            assert o.admitted == admitted
        assert "ns/a2" in prep.baseline.pending


class TestWhatWouldItTake:
    def test_target_workload_recommendation(self):
        jrep, prep = _both(STUCK, plan_kw=dict(
            target_workload="ns/big", include_reasons="all", verify_host=True))
        assert_reports_equal(jrep, prep)
        assert "ns/big" in prep.baseline.pending and prep.recommended is not None
        assert "ns/big" in prep.scenario(prep.recommended).newly_admitted

    def test_cluster_queue_sweep(self):
        jrep, prep = _both([_wl("big", "8")], plan_kw=dict(target_cq="cq-a",
                                                            verify_host=True))
        assert_reports_equal(jrep, prep)
        assert any("ns/big" in o.newly_admitted for o in prep.scenarios)

    def test_ranking_prefers_cheapest_admitting_scenario(self):
        jrep, prep = _both(
            STUCK,
            scenarios=lambda p: p.api.Planner.quota_sweep("cq-a", "default", "cpu",
                                                          [2000, 8000, 64000]),
            plan_kw=dict(target_workload="ns/big"),
        )
        assert_reports_equal(jrep, prep)
        assert prep.recommended == "cq-a/default/cpu +8000"

    def test_scenario_apply_error_does_not_crash_plan(self):
        rt = _env(PORT, STUCK)
        bad = PORT.api.PlanScenario(
            name="bad", deltas=(PORT.scen.NominalQuotaDelta("ghost", "default", "cpu", 1),))
        with pytest.raises(PORT.scen.ScenarioApplyError):
            PORT.planner.Planner.for_runtime(rt).plan(scenarios=[bad])


class TestForecast:
    def _world(self, p):
        """tests/test_planner.py's forecast world: one cohort, two
        ClusterQueues of 8 cpu without borrowing, 12 pending 4-cpu
        workloads each, 60 s runtimes."""
        a = p.api
        cache, mgr = a.Cache(), a.QueueManager(a.FakeClock(0.0))
        cache.add_or_update_flavor(a.ResourceFlavor(name="default"))
        for i in range(2):
            cq = a.ClusterQueue(
                name=f"cq-{i}", cohort="cohort", namespace_selector={},
                resource_groups=(a.ResourceGroup(
                    ("cpu",), (a.FlavorQuotas.build("default", {"cpu": ("8", "0", None)}),)
                ),),
            )
            cache.add_or_update_cluster_queue(cq)
            mgr.add_cluster_queue(cq)
            mgr.add_local_queue(a.LocalQueue(namespace="ns", name=f"lq-{i}",
                                             cluster_queue=f"cq-{i}"))
            for w in range(12):
                mgr.add_or_update_workload(a.Workload(
                    namespace="ns", name=f"w-{i}-{w}", queue_name=f"lq-{i}",
                    creation_time=float(w), pod_sets=(a.PodSet.build("main", 1, {"cpu": "4"}),),
                ))
        planner = a.Planner(cache=cache, queues=mgr, **({"device": "cpu"} if p.port else {}))
        bump = a.PlanScenario(name="double both CQs", deltas=tuple(
            p.scen.NominalQuotaDelta(f"cq-{i}", "default", "cpu", 8000) for i in range(2)))
        return planner, [bump, a.PlanScenario(name="gavel", deltas=(a.PolicyDelta("gavel"),))]

    def test_forecast_equals_jax(self):
        reps = []
        for p in (JAX, PORT):
            planner, scens = self._world(p)
            reps.append(planner.plan(scenarios=scens, forecast=True,
                                     runtime_hint=lambda wl: 60.0, verify_host=True))
        assert_reports_equal(*reps)
        fc = reps[1].scenario("double both CQs").forecast
        assert fc["band"][1] > fc["band"][0] >= 0.0 and fc["perWorkload"]

    def test_forecast_improves_with_quota(self):
        jrep, prep = _both(
            [_wl(f"w{i}", "2", created=float(i)) for i in range(8)],
            scenarios=lambda p: p.api.Planner.quota_sweep("cq-a", "default", "cpu", [0, 8000]),
            plan_kw=dict(forecast=True, runtime_hint=lambda wl: 100.0),
        )
        assert_reports_equal(jrep, prep)
        base = prep.scenario("cq-a/default/cpu +0").forecast
        more = prep.scenario("cq-a/default/cpu +8000").forecast
        assert more["mean"] <= base["mean"]


def test_active_policy_scores_the_baseline():
    """A Planner under the runtime's Gavel-deadline policy: its baseline
    scores with it, and equals the JAX package's."""
    jrep, prep = _both(
        PENDING, settle=False, policy="gavel-deadline",
        scenarios=lambda p: _mixed_scenarios(p)[:4], plan_kw=dict(include_reasons="all"),
    )
    assert_reports_equal(jrep, prep)
    reps = []
    for p in (JAX, PORT):
        rt = _env(p, PENDING, settle=False)
        reps.append(p.api.Planner(
            cache=rt.cache, queues=rt.queues, clock=rt.clock,
            policy=p.policy.resolve_policy("gavel-deadline"),
            **({"device": "cpu"} if p.port else {}),
        ).plan(scenarios=_mixed_scenarios(p)[:4], forecast=True,
               runtime_hint=lambda wl: 30.0))
    assert_reports_equal(*reps)
    assert reps[1].baseline.forecast["policy"] == "gavel-deadline"


def _strip_request(d: dict) -> dict:
    d = _strip(d)
    d.pop("elastic", None)
    return d


def test_plan_request_and_forecast_tta_through_a_runtime():
    bodies = [
        (STUCK, {"target": {"workload": "ns/big"},
                 "options": {"includeReasons": "all", "verifyHost": True}}),
        (STUCK, {"target": {"clusterQueue": "cq-a"}, "options": {"heads": "cycle"}}),
        (PENDING, {"scenarios": [s.to_dict() for s in _mixed_scenarios(PORT)],
                   "options": {"forecast": True, "runtimeHintSeconds": 120,
                               "useDevice": False}}),
    ]
    for workloads, body in bodies:
        outs = [p.planner.plan_request(_env(p, workloads, settle=False), body)
                for p in (JAX, PORT)]
        assert _strip_request(outs[1]) == _strip_request(outs[0])
    for p_cpu, hint in (("4", 600.0), ("8", 30.0), ("64", 600.0)):
        outs = []
        for p in (JAX, PORT):
            rt = _env(p, STUCK)
            wl = p.api.Workload(namespace="ns", name="next", queue_name="lq-b",
                                pod_sets=(p.api.PodSet.build("main", 1, {"cpu": p_cpu}),))
            outs.append(p.planner.forecast_time_to_admission(rt, wl, runtime_hint_s=hint))
        assert outs[1] == outs[0]
    assert outs[1] is None  # 64 cpu never fits


def test_stage_cut_to_nine_scenarios_equals_jax():
    reps = []
    for p in (JAX, PORT):
        planner, sweep, cache, mgr = pp.build_stage(
            p.api, n_scenarios=8, **({"device": "cpu"} if p.port else {}))
        keys = [wl.key for wl, _ in planner.backlog(p.api.take_snapshot(cache), "backlog")]
        rep = planner.plan(scenarios=sweep, include_reasons="none")
        reps.append((rep, pp.plan_summary(rep, keys)))
    assert_reports_equal(reps[0][0], reps[1][0])
    assert reps[1][1] == reps[0][1] and reps[1][1]["scenarios"] == 9


@pytest.mark.parametrize("p", [JAX, PORT], ids=["jax", "port"])
def test_stage_equals_expect(p):
    planner, sweep, cache, mgr = pp.build_stage(
        p.api, **({"device": "cpu"} if p.port else {}))
    keys = [wl.key for wl, _ in planner.backlog(p.api.take_snapshot(cache), "backlog")]
    rep = planner.plan(scenarios=sweep, include_reasons="none")
    assert pp.plan_summary(rep, keys) == pp.PLANNER_STAGE_EXPECT


def test_the_card_is_the_default():
    import torch

    rt = _env(PORT, STUCK)
    planner = PORT.api.Planner(cache=rt.cache, queues=rt.queues)
    # the host mirror needs no card
    assert planner.plan(target_workload="ns/big", use_device=False).backend == "host"
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py runs the kernels")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        planner.plan(target_workload="ns/big")


@pytest.mark.slow
def test_sweep_equals_expect():
    planner, sweep, cache, mgr = pp.build_sweep(np.random.default_rng(pp.SWEEP_SEED),
                                                device="cpu")
    keys = [wl.key for wl, _ in planner.backlog(PORT.api.take_snapshot(cache), "backlog")]
    rep = planner.plan(scenarios=sweep, heads_mode="backlog", include_reasons="none")
    assert pp.plan_summary(rep, keys) == pp.PLANNER_SWEEP_EXPECT


@pytest.mark.slow
def test_jax_sweep_and_policy_give_the_constants():
    """Where PLANNER_SWEEP_EXPECT and POLICY_EXPECT come from: the JAX
    package at bench.py's builders (its own build_cluster/build_backlog
    for the sweep)."""
    import bench
    from kueue_tpu.core.drain import run_drain

    rng = np.random.default_rng(pp.SWEEP_SEED)
    cache, mgr = bench.build_cluster(rng)
    for wl, _ in bench.build_backlog(rng):
        mgr.add_or_update_workload(wl)
    planner = JAX.api.Planner(cache, mgr, max_cells=pp.SWEEP_MAX_CELLS)
    keys = [wl.key for wl, _ in planner.backlog(JAX.api.take_snapshot(cache), "backlog")]
    rep = planner.plan(scenarios=pp.sweep_scenarios(JAX.api), heads_mode="backlog",
                       include_reasons="none")
    assert pp.plan_summary(rep, keys) == pp.PLANNER_SWEEP_EXPECT
    env = pp.build_policy(np.random.default_rng(pp.POLICY_SEED), JAX.api)
    got = {}
    for key, name in (("first_fit", None), ("gavel", "gavel")):
        got[key] = pp.drain_summary(run_drain(
            JAX.api.take_snapshot(env.cache), env.pending, env.cache.flavors,
            timestamp_fn=env.ts_fn, policy=name and JAX.policy.resolve_policy(name)))
    got.update(pp.forecast_gain(pp.policy_plan(env)))
    assert got == pp.POLICY_EXPECT


@pytest.mark.slow
def test_policy_forecast_equals_expect():
    env = pp.build_policy(np.random.default_rng(pp.POLICY_SEED))
    gain = pp.forecast_gain(pp.policy_plan(env, device="cpu"))
    want = {k: pp.POLICY_EXPECT[k] for k in gain}
    assert gain == want
