"""The planner's and the admission policies' clusters (ports of bench.py's
``planner_bench`` and ``policy_drain_bench`` builders, and the headline
cluster under a quota sweep) and what the JAX package decides on them.

planner-sweep-50k (``build_sweep``): bench.py's headline cluster and
backlog (``perf/headline.py``), seed 0: 1000 ClusterQueues in 50
cohorts and 50,000 pending workloads, all queued in the QueueManager;
``Planner(cache, queues, max_cells=3)`` (the default 8 candidates)
plans ``SWEEP_SCENARIOS`` quota sweeps, scenario i
``quota_sweep(f"cq-{i}", "fl-0", "cpu", [(4000, 8000, 16000)[i % 3]])``
(bench.py's planner stage's cycle of deltas), in the default
``backlog`` mode with ``include_reasons="none"``: 129 scenarios against
W = 50,000 heads (Wp = 65,536), K=8, C=3 in one B14 call.

planner-stage-500 (``build_stage``): bench.py's ``planner_bench``
unchanged (seed 8, which it does not draw from): 50 ClusterQueues, each
its own root, 8 cpu each, 10 workloads a queue with the last one
oversized (500 pending); 128 sweep scenarios, ``max_candidates=2``,
``max_cells=3``.

policy-48x64 (``build_policy``): bench.py's ``policy_drain_bench``
unchanged (seed 21): 48 ClusterQueues with flavors ``slow`` then
``fast``, 64 workloads a queue that declare 2-4x throughput on
``fast`` (3072 pending); drained under first-fit and under Gavel, and
planned with ``PolicyDelta("gavel")`` and a forecast at a 600 s
runtime hint.

The RNG draws happen in bench.py's order, so a seed gives the same
cluster in both packages: ``planner_api`` takes one package's modules
(the tests pass the JAX package's) and this module imports nothing of
it. The ``*_EXPECT`` constants are what the JAX package gives on the
CPU; tests/test_torch_planner.py and tests/test_torch_policy.py hold the
port to them (the full widths under ``slow``) and chip_smoke.py holds
the port on the card to them.
"""

from __future__ import annotations

import hashlib
import json
from types import SimpleNamespace
from typing import List, Sequence

import numpy as np

SWEEP_SEED = 0  # bench.py's headline seed
STAGE_SEED = 8  # bench.py's _stage_planner
POLICY_SEED = 21  # bench.py's _stage_policy
SWEEP_SCENARIOS = 128
SWEEP_DELTAS = (4000, 8000, 16000)  # bench.py's planner stage's cycle
SWEEP_MAX_CELLS = 3
POLICY_HINT_S = 600.0  # bench.py's policy stage's runtime hint

# the JAX package's Planner.plan at planner-sweep-50k on the CPU
# (``plan_summary``)
PLANNER_SWEEP_EXPECT = {
    "scenarios": 129,
    "launches": 1,
    "heads": 50000,
    "baseline_admitted": 4382,
    "newly_admitting": 99,
    "recommended": "cq-4/fl-0/cpu +8000",
    "digest": "85fe1a74fe30d3fc",
    "usage_digest": "087f5bcea548d23f",
}
# the JAX package's Planner.plan at planner-stage-500 on the CPU
PLANNER_STAGE_EXPECT = {
    "scenarios": 129,
    "launches": 1,
    "heads": 500,
    "baseline_admitted": 400,
    "newly_admitting": 128,
    "recommended": "pcq-0/default/cpu +4000#0",
    "digest": "cafc53d0ccb7b5ed",
    "usage_digest": "783dfc88bfe2119c",
}
# the JAX package's drains (``drain_summary``) and Gavel plan
# (``forecast_gain``) at policy-48x64 on the CPU: bench.py's policy
# stage prints the two percentages
POLICY_EXPECT = {
    "first_fit": {"cycles": 64, "admitted": 350, "digest": "399fd10c5f569934"},
    "gavel": {"cycles": 64, "admitted": 343, "digest": "e128a28f55049c58"},
    "makespan": [7800.0, 3750.0],
    "tta_mean": [2116.016, 815.548],
    "makespan_pct": 51.92,
    "tta_pct": 61.46,
}


def planner_api(models, cluster_queue, workload, cache, queue_manager, clock, planner,
                policy, snapshot) -> SimpleNamespace:
    """The classes and functions the builders need, from one package's
    modules (``models``, ``models.cluster_queue``, ``models.workload``,
    ``core.cache``, ``core.queue_manager``, ``utils.clock``,
    ``planner``, ``policy``, ``core.snapshot``)."""
    return SimpleNamespace(
        ClusterQueue=models.ClusterQueue, FlavorQuotas=models.FlavorQuotas,
        LocalQueue=models.LocalQueue, ResourceFlavor=models.ResourceFlavor,
        Workload=models.Workload, ResourceGroup=cluster_queue.ResourceGroup,
        PodSet=workload.PodSet, Cache=cache.Cache, QueueManager=queue_manager.QueueManager,
        queue_order_timestamp=queue_manager.queue_order_timestamp,
        FakeClock=clock.FakeClock, Planner=planner.Planner,
        PlanScenario=planner.PlanScenario, PolicyDelta=planner.scenarios.PolicyDelta,
        resolve_policy=policy.resolve_policy,
        THROUGHPUT_LABEL_PREFIX=policy.THROUGHPUT_LABEL_PREFIX,
        take_snapshot=snapshot.take_snapshot,
    )


def port_api() -> SimpleNamespace:
    from kueue_tpu_torch import models, planner, policy
    from kueue_tpu_torch.core import cache, queue_manager, snapshot
    from kueue_tpu_torch.models import cluster_queue, workload
    from kueue_tpu_torch.utils import clock

    return planner_api(models, cluster_queue, workload, cache, queue_manager, clock,
                       planner, policy, snapshot)


# ---- planner-sweep-50k ---------------------------------------------------


def sweep_scenarios(api, n: int = SWEEP_SCENARIOS) -> list:
    """Scenario i raises cq-i's fl-0 cpu nominal quota by
    SWEEP_DELTAS[i % 3]."""
    return [
        api.Planner.quota_sweep(f"cq-{i}", "fl-0", "cpu", [SWEEP_DELTAS[i % 3]])[0]
        for i in range(n)
    ]


def build_sweep(rng: np.random.Generator, device=None):
    """planner-sweep-50k on this package: (planner, scenarios, cache,
    queues); the Planner solves on ``device`` (the card unless "cpu")."""
    from kueue_tpu_torch.perf import headline
    from kueue_tpu_torch.utils.clock import FakeClock

    api = port_api()
    cache = headline.build_cluster(rng)
    mgr = headline.build_queues(cache, FakeClock(0.0))
    for wl, _ in headline.build_backlog(rng):
        mgr.add_or_update_workload(wl)
    planner = api.Planner(cache, mgr, max_cells=SWEEP_MAX_CELLS, device=device)
    return planner, sweep_scenarios(api), cache, mgr


# ---- planner-stage-500 -----------------------------------------------------


def build_stage(api=None, n_cq: int = 50, wl_per_cq: int = 10,
                n_scenarios: int = SWEEP_SCENARIOS, **planner_kw):
    """bench.py's planner stage: (planner, scenarios, cache, queues).
    ``planner_kw`` goes to the Planner (``device=`` for the port)."""
    a = api or port_api()
    cache = a.Cache()
    mgr = a.QueueManager(a.FakeClock(0.0))
    cache.add_or_update_flavor(a.ResourceFlavor(name="default"))
    for i in range(n_cq):
        name = f"pcq-{i}"
        cq = a.ClusterQueue(
            name=name,
            namespace_selector={},
            resource_groups=(
                a.ResourceGroup(("cpu",), (a.FlavorQuotas.build("default", {"cpu": "8"}),)),
            ),
        )
        cache.add_or_update_cluster_queue(cq)
        mgr.add_cluster_queue(cq)
        mgr.add_local_queue(a.LocalQueue(namespace="ns", name=f"lq-{name}", cluster_queue=name))
        for w in range(wl_per_cq):
            # last head per CQ is oversized: quota-rejected at baseline
            cpu = "16" if w == wl_per_cq - 1 else "1"
            mgr.add_or_update_workload(a.Workload(
                namespace="ns", name=f"pwl-{i}-{w}", queue_name=f"lq-{name}", priority=0,
                creation_time=float(i * wl_per_cq + w),
                pod_sets=(a.PodSet.build("main", 1, {"cpu": cpu}),),
            ))
    planner = a.Planner(cache=cache, queues=mgr, max_candidates=2, max_cells=3, **planner_kw)
    sweep = []
    si = 0
    while len(sweep) < n_scenarios:
        scen = a.Planner.quota_sweep(
            f"pcq-{si % n_cq}", "default", "cpu", [SWEEP_DELTAS[si % 3]]
        )[0]
        sweep.append(type(scen)(name=f"{scen.name}#{si}", deltas=scen.deltas))
        si += 1
    return planner, sweep, cache, mgr


# ---- policy-48x64 -----------------------------------------------------------


def build_policy(rng: np.random.Generator, api=None, n_cq: int = 48, wl_per_cq: int = 64):
    """bench.py's policy stage cluster: cache, mgr, clock, pending (per-CQ
    heap order), ts_fn and api."""
    a = api or port_api()
    clock = a.FakeClock(0.0)
    cache = a.Cache()
    mgr = a.QueueManager(clock)
    cache.add_or_update_flavor(a.ResourceFlavor(name="slow"))
    cache.add_or_update_flavor(a.ResourceFlavor(name="fast"))
    w_rng = np.random.default_rng(int(rng.integers(1 << 30)))
    t = 0.0
    for i in range(n_cq):
        name = f"pcq-{i}"
        cq = a.ClusterQueue(
            name=name,
            cohort=None,
            namespace_selector={},
            resource_groups=(
                a.ResourceGroup(
                    ("cpu",),
                    (
                        a.FlavorQuotas.build(
                            "slow", {"cpu": (str(int(w_rng.integers(8, 24))), None, None)}
                        ),
                        a.FlavorQuotas.build(
                            "fast", {"cpu": (str(int(w_rng.integers(8, 24))), None, None)}
                        ),
                    ),
                ),
            ),
        )
        cache.add_or_update_cluster_queue(cq)
        mgr.add_cluster_queue(cq)
        mgr.add_local_queue(a.LocalQueue(namespace="ns", name=f"lq-{name}", cluster_queue=name))
        for wi in range(wl_per_cq):
            t += 1.0
            tput = round(float(w_rng.uniform(2.0, 4.0)), 1)
            mgr.add_or_update_workload(a.Workload(
                namespace="ns",
                name=f"pwl-{i}-{wi}",
                queue_name=f"lq-{name}",
                creation_time=t,
                labels={a.THROUGHPUT_LABEL_PREFIX + "fast": f"{tput:.1f}"},
                pod_sets=(a.PodSet.build("main", 1, {"cpu": str(int(w_rng.integers(2, 8)))}),),
            ))
    pending = [
        (wl, cq_name)
        for cq_name, pq in mgr.cluster_queues.items()
        for wl in pq.snapshot_sorted()
    ]
    return SimpleNamespace(
        cache=cache, mgr=mgr, clock=clock, pending=pending, api=a,
        ts_fn=lambda wl: a.queue_order_timestamp(wl, mgr._ts_policy),
    )


def policy_plan(env, **planner_kw):
    """The Gavel what-if at policy-48x64: ``Planner.plan`` with one
    ``PolicyDelta("gavel")`` scenario and a forecast at POLICY_HINT_S."""
    a = env.api
    planner = a.Planner(cache=env.cache, queues=env.mgr, clock=env.clock, **planner_kw)
    return planner.plan(
        scenarios=[a.PlanScenario(name="gavel", deltas=(a.PolicyDelta("gavel"),))],
        forecast=True,
        runtime_hint=lambda wl: POLICY_HINT_S,
        use_device=True,
    )


def forecast_gain(report) -> dict:
    """bench.py's benefit numbers of a Gavel plan: the baseline's and
    the Gavel scenario's makespan and mean time-to-admission, and how
    much shorter Gavel's are, in percent."""
    base = report.baseline.forecast or {}
    gv = (report.scenario("gavel").forecast or {})
    mk_b, mk_g = base.get("makespan", 0.0), gv.get("makespan", 0.0)
    tta_b, tta_g = base.get("mean", 0.0), gv.get("mean", 0.0)
    return {
        "makespan": [mk_b, mk_g],
        "tta_mean": [tta_b, tta_g],
        "makespan_pct": round((1.0 - mk_g / mk_b) * 100, 2) if mk_b > 0 else 0.0,
        "tta_pct": round((1.0 - tta_g / tta_b) * 100, 2) if tta_b > 0 else 0.0,
    }


# ---- what a plan decides ----------------------------------------------------


def _digest(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()).hexdigest()[:16]


def plan_summary(report, head_keys: Sequence[str]) -> dict:
    """The *_EXPECT keys of a PlanReport (either package's): counts,
    the recommendation, a digest of every scenario's (admitted, reserved,
    preempt-needed) sets and one of every scenario's final usage tree.
    ``head_keys`` are the planned heads' workload keys in slot order
    (``Planner.backlog``'s)."""
    by_name = {o.name: o for o in report.scenarios}
    rows: List[list] = []
    h = hashlib.sha256()
    for name in sorted(by_name):
        o = by_name[name]
        raw = o.raw
        w = len(raw["chosen"])
        reserved = sorted(head_keys[i] for i in range(w) if raw["reserved"][i])
        pre = sorted(
            head_keys[i] for i in range(w) if raw["chosen"][i] < 0 and raw["preempt_k"][i] >= 0
        )
        rows.append([name, sorted(o.admitted), reserved, pre])
        usage = np.ascontiguousarray(raw["usage"], dtype="<i8")
        h.update(repr(usage.shape).encode())
        h.update(usage.tobytes())
    return {
        "scenarios": len(report.scenarios),
        "launches": report.launches,
        "heads": report.heads,
        "baseline_admitted": len(report.baseline.admitted),
        "newly_admitting": sum(1 for o in report.scenarios if o.newly_admitted),
        "recommended": report.recommended,
        "digest": _digest(rows),
        "usage_digest": h.hexdigest()[:16],
    }


def drain_summary(outcome) -> dict:
    """cycles, admitted and the decision digest of a DrainOutcome."""
    from kueue_tpu_torch.perf.headline import outcome_digest

    return {
        "cycles": int(outcome.cycles),
        "admitted": len(outcome.admitted),
        "digest": outcome_digest(outcome)[:16],
    }


# ---- a small case with every delta kind -------------------------------------


def every_kind_case(seed: int = 0, device=None):
    """A small planner case for the kernels' lockstep: ``perf.cases.
    cycle_spec(seed)``'s depth-3 cohort forest with cohort quotas,
    borrowing and lending limits and reclaimWithinCohort Never (blocked
    heads reserve), three of its Scheduler's cycles admitted, and the
    rest of its single-podset backlog (throughput labels on every other
    workload, deadlines on every third), and one scenario
    of every delta
    kind: nominal quota on a ClusterQueue and on a cohort, flavor
    capacity added and removed, lending and borrowing limits, a
    fair-share weight, a priority, a drained domain and three policies.
    Returns (planner, scenarios, cache, queues); the Planner solves on
    ``device`` (the card unless "cpu")."""
    from kueue_tpu_torch.core.snapshot import take_snapshot
    from kueue_tpu_torch.perf import cases
    from kueue_tpu_torch.planner import scenarios as sc
    from kueue_tpu_torch.policy import DEADLINE_LABEL, THROUGHPUT_LABEL_PREFIX

    api = port_api()
    sched, mgr, cache = cases.build_scheduler(cases.cycle_spec(seed), device="cpu")
    for _ in range(3):  # admitted usage: blocked heads turn preempt-mode
        sched.schedule()
    snap = take_snapshot(cache)
    pending = [wl for _, pq in sorted(mgr.cluster_queues.items()) for wl in pq.snapshot_sorted()]
    flavors = sorted({fr.flavor for fr in snap.fr_list})
    for i, wl in enumerate(pending):
        labels = dict(wl.labels or {})
        if i % 2 == 0:
            labels[THROUGHPUT_LABEL_PREFIX + flavors[i % len(flavors)]] = f"{1.5 + i % 3}"
        if i % 3 == 0:
            labels[DEADLINE_LABEL] = f"{900.0 + 10 * i}"
        wl.labels = labels
    cq = snap.flat.cq_names[0]
    row = snap.row(cq)
    fr = next(f for j, f in enumerate(snap.fr_list) if snap.nominal[row, j] > 0)
    cohort = snap.flat.cohort_names[0]
    half = int(snap.nominal[: snap.flat.n_cq, snap.fr_index[fr]].sum()) // 2
    kinds = [
        ("noop", ()),
        ("quota", (sc.NominalQuotaDelta(cq, fr.flavor, fr.resource, 4000),)),
        ("cohort-quota", (sc.NominalQuotaDelta(cohort, fr.flavor, fr.resource, 8000),)),
        ("capacity", (sc.FlavorCapacityDelta.build(cq, fr.flavor, {fr.resource: 2000}),)),
        ("remove", (sc.FlavorCapacityDelta.build(cq, fr.flavor, None),)),
        ("lend", (sc.LendingLimitDelta(cq, fr.flavor, fr.resource, 0),)),
        ("borrow", (sc.BorrowingLimitDelta(cq, fr.flavor, fr.resource, None),)),
        ("weight", (sc.FairShareWeightDelta(cq, 3000),)),
        ("priority", (sc.PriorityDelta(pending[-1].key, 1000),)),
        ("drain", (sc.DrainDomainDelta.build(fr.flavor, {fr.resource: half}, "rack-0"),)),
        ("gavel", (sc.PolicyDelta("gavel"),)),
        ("deadline", (sc.PolicyDelta("deadline", now=950.0),)),
        ("gavel-deadline", (sc.PolicyDelta("gavel-deadline", now=950.0),)),
    ]
    scenarios = [api.PlanScenario(name=n, deltas=d) for n, d in kinds]
    planner = api.Planner(cache, mgr, max_cells=6, device=device)
    return planner, scenarios, cache, mgr
