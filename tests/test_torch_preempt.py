"""The batched victim search of the admission cycle (kernel B8) in both
packages, exactly (int64, tolerance 0):

- B8's plain version (ops/preempt_kernel.solve_preempt) against the JAX
  package's solve_preempt_packed_jit on the problems its
  lower_preemption builds from tests/test_preempt_batch.py's scenarios
  and random_preempt_cache seeds;
- the port's batched_get_targets against the JAX package's and against
  the port's host Preemptor, on seeded scenarios built in both;
- the port's Scheduler against the JAX Scheduler, cycle for cycle, with
  use_preempt_solver=True (decisions, targets, victim_search) and with
  the default None (decisions on every cycle; victim_search on the
  first cycle that defers enough heads to batch, later ones are timed
  choices);
- the contended cycles (perf/contended.py) give CONTENDED_CYCLE_EXPECT
  in both packages.

The JAX package's Scheduler runs with use_solver=False: on the CPU its
resident cycle buffer can alias the snapshot's usage array, which the
admit loop then edits in place, so its batched-nomination runs can
differ from run to run (ROADMAP Queue C); its own parity tests hold
both nomination paths to the same decisions.
"""

import numpy as np
import pytest

from kueue_tpu._jax import jnp
from kueue_tpu.core.flavor_assigner import FlavorAssigner as JaxAssigner
from kueue_tpu.core.flavor_assigner import Mode as JaxMode
from kueue_tpu.core.preempt_batch import _pad_rows as jax_pad_rows
from kueue_tpu.core.preempt_batch import batched_get_targets as jax_batched
from kueue_tpu.core.preempt_batch import lower_preemption as jax_lower
from kueue_tpu.core.preemption import Preemptor as JaxPreemptor
from kueue_tpu.core.snapshot import take_snapshot as jax_take_snapshot
from kueue_tpu.core.solver import _bucket
from kueue_tpu.ops.preempt_kernel import PreemptProblem as JaxProblem
from kueue_tpu.ops.preempt_kernel import solve_preempt_packed_jit
from kueue_tpu.utils.clock import FakeClock as JaxClock
from kueue_tpu_torch.core.flavor_assigner import FlavorAssigner, Mode
from kueue_tpu_torch.core.preempt_batch import batched_get_targets, lower_preemption
from kueue_tpu_torch.core.preemption import Preemptor
from kueue_tpu_torch.core.snapshot import take_snapshot
from kueue_tpu_torch.interop import preempt_problem
from kueue_tpu_torch.ops.preempt_kernel import solve_preempt, solve_preempt_packed
from kueue_tpu_torch.perf import contended
from kueue_tpu_torch.perf.cases import build_cache
from kueue_tpu_torch.utils.clock import FakeClock

import tests.test_preempt_batch as tpb
from tests.test_drain import build_preempt_env
from tests.test_solver_path import build_env, drain_and_trace, random_spec
from tests.test_torch_preempt_drain import jax_api
from tests.test_torch_scheduler import jax_spec, port_spec


def _items(snap, cache, incoming, assigner_cls, mode):
    assigner = assigner_cls(snap, cache.flavors)
    out = []
    for wl, cq_name in incoming:
        a = assigner.assign(wl, cq_name)
        if a.representative_mode() == mode.PREEMPT:
            out.append((wl, cq_name, a))
    return out


def assert_b8_matches_jax(cache, incoming):
    """The JAX lowering of the scenario's preempt-mode heads, solved by
    the JAX package's kernel and by the port's plain B8 on the same
    arrays. Returns the number of attempt rows."""
    snap = jax_take_snapshot(cache)
    items = _items(snap, cache, incoming, JaxAssigner, JaxMode)
    lowered = jax_lower(snap, items, JaxPreemptor(JaxClock()))
    if not lowered.attempts:
        return 0
    arrays = jax_pad_rows(lowered.arrays, _bucket(len(lowered.attempts), minimum=8))
    want = np.asarray(solve_preempt_packed_jit(
        JaxProblem(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        depth=lowered.depth, n_cand=lowered.n_cand,
    ))
    got = solve_preempt_packed(
        preempt_problem(arrays, "cpu"), depth=lowered.depth, n_cand=lowered.n_cand
    ).numpy()
    np.testing.assert_array_equal(got, want)
    return len(lowered.attempts)


@pytest.mark.parametrize("name", [
    "test_within_cq_minimal_set", "test_reclaim_within_cohort",
    "test_borrow_within_cohort_threshold", "test_fill_back_keeps_unnecessary_victims",
    "test_multiple_heads_one_dispatch",
])
def test_b8_on_the_reference_scenarios(name, monkeypatch):
    """tests/test_preempt_batch.py's deterministic scenarios, taken from
    its tests by wrapping their parity assertion."""
    seen = []
    real = tpb.assert_target_parity

    def record(cache, incoming, fair=False):
        seen.append((cache, incoming))
        return real(cache, incoming, fair)

    monkeypatch.setattr(tpb, "assert_target_parity", record)
    getattr(tpb.TestDeterministicParity(), name)()
    assert seen and all(assert_b8_matches_jax(c, i) > 0 for c, i in seen)


@pytest.mark.parametrize("seed", [0, 3, 5, 7, 9, 11, 13, 16, 18, 20, 22, 24, 26, 29, 31, 33])
def test_b8_on_random_preempt_caches(seed):
    from kueue_tpu.models import Workload
    from kueue_tpu.models.workload import PodSet

    cache, cq_names, rng, rand_requests = tpb.random_preempt_cache(seed)
    incoming = []
    for i in range(6):
        cq_name = cq_names[int(rng.integers(0, len(cq_names)))]
        incoming.append((Workload(
            namespace="ns", name=f"new-{i}", queue_name=f"lq-{cq_name}",
            priority=int(rng.integers(0, 120)), creation_time=float(100 + i),
            pod_sets=(PodSet.build("main", 1, rand_requests()),),
        ), cq_name))
    assert assert_b8_matches_jax(cache, incoming) > 0


# ---- batched_get_targets in both packages ---------------------------------


def scenario(seed):
    """A seeded preemption scenario in perf.cases' spec form, in the
    shape of tests/test_preempt_batch.random_preempt_cache: cohorts of
    ClusterQueues with mixed preemption policies (borrowWithinCohort
    thresholds included), borrowing and lending limits, an
    oversubscribed admitted population ("victims") and incoming
    workloads."""
    rng = np.random.default_rng(seed)
    within = ("NEVER", "LOWER_PRIORITY", "LOWER_OR_NEWER_EQUAL_PRIORITY")
    reclaim = ("NEVER", "ANY", "LOWER_PRIORITY")
    resources = ["cpu", "memory"] if rng.random() < 0.5 else ["cpu"]
    cqs = []
    for ci in range(int(rng.integers(1, 3))):
        for qi in range(int(rng.integers(2, 5))):
            cq = {
                "name": f"cq-{ci}-{qi}", "cohort": f"cohort-{ci}",
                "within": within[int(rng.integers(0, 3))],
                "reclaim": reclaim[int(rng.integers(0, 3))],
                "groups": [{"resources": resources, "flavors": [(
                    "default", {r: str(int(rng.integers(4, 12))) for r in resources},
                    str(int(rng.integers(0, 12))) if rng.random() < 0.5 else None,
                    str(int(rng.integers(0, 6))) if rng.random() < 0.4 else None,
                )]}],
            }
            if rng.random() < 0.4:
                cq["bwc"] = int(rng.integers(0, 60)) if rng.random() < 0.7 else None
            cqs.append(cq)

    def requests():
        return {r: str(int(rng.integers(1, 8))) for r in resources}

    victims = [
        (f"adm-{i}", cq, {r: "default" for r in resources}, requests(),
         int(rng.integers(0, 100)), float(i))
        for i in range(int(rng.integers(6, 16)))
        for cq in [cqs[int(rng.integers(0, len(cqs)))]["name"]]
    ]
    workloads = [
        {"name": f"new-{i}", "queue": f"lq-{cq}", "prio": int(rng.integers(0, 120)),
         "t": float(100 + i), "pod_sets": [{"name": "main", "count": 1,
                                            "requests": requests()}]}
        for i in range(8)
        for cq in [cqs[int(rng.integers(0, len(cqs)))]["name"]]
    ]
    return {"flavors": ["default"], "cqs": cqs, "workloads": workloads, "victims": victims}


def both_scenarios(spec):
    """(JAX cache, JAX incoming, port cache, port incoming) of a
    ``scenario``, the incoming workloads in the same order."""
    _, mgr, jcache, _ = build_preempt_env(jax_spec(spec))
    jin = [(wl, cq) for cq, pq in mgr.cluster_queues.items() for wl in pq.snapshot_sorted()]
    pcache, ppending = build_cache(spec)
    by_name = {wl.name: (wl, cq) for wl, cq in ppending}
    return jcache, jin, pcache, [by_name[wl.name] for wl, _ in jin]


def targets_of(results):
    return [sorted((t.workload.workload.name, t.reason) for t in ts) for ts in results]


@pytest.mark.parametrize("seed", range(12))
def test_batched_get_targets_matches_jax_and_the_host(seed):
    jcache, jin, pcache, pin = both_scenarios(scenario(seed))
    jsnap, psnap = jax_take_snapshot(jcache), take_snapshot(pcache)
    jitems = _items(jsnap, jcache, jin, JaxAssigner, JaxMode)
    pitems = _items(psnap, pcache, pin, FlavorAssigner, Mode)
    assert [(w.name, c) for w, c, _ in pitems] == [(w.name, c) for w, c, _ in jitems]
    assert pitems  # these seeds have preempt-mode heads
    preemptor = Preemptor(FakeClock())
    got = batched_get_targets(psnap, pitems, preemptor, device="cpu")
    assert targets_of(got) == targets_of(jax_batched(jsnap, jitems, JaxPreemptor(JaxClock())))
    host = [preemptor.get_targets(w, c, a, psnap) for w, c, a in pitems]
    assert targets_of(got) == targets_of(host)


def test_plain_b8_agrees_with_itself_row_by_row():
    """solve_preempt batches rows independently: each row alone gives
    what it gives in the batch (the plain version's rows do not leak
    into each other through the shared step loop)."""
    pcache, pin = build_cache(scenario(3))
    psnap = take_snapshot(pcache)
    items = _items(psnap, pcache, pin, FlavorAssigner, Mode)
    lowered = lower_preemption(psnap, items, Preemptor(FakeClock()))
    p = preempt_problem(lowered.arrays, "cpu")
    whole = solve_preempt(p, lowered.depth, lowered.n_cand)
    for w in range(len(lowered.attempts)):
        one = solve_preempt(type(p)(*(x[w:w + 1] for x in p)), lowered.depth, lowered.n_cand)
        assert bool(one.fits[0]) == bool(whole.fits[w])
        assert one.targets[0].tolist() == whole.targets[w].tolist()


# ---- the Scheduler, cycle for cycle -------------------------------------


def _searches(sched):
    """Per cycle, the victim_search of every entry whose search was
    deferred (admitted, preempting or requeued), in entry order."""
    seen = []
    sched.cycle_observers.append(lambda res: seen.append([
        e.victim_search for e in res.admitted + res.preempting + res.requeued if e.victim_search
    ]))
    return seen


def both_schedulers(spec, mode):
    from kueue_tpu_torch.perf import cases

    js, jm, jc, _ = build_env(spec, use_solver=False)
    ps, pm, pc = cases.build_scheduler(port_spec(spec), device="cpu")
    js.use_preempt_solver = ps.use_preempt_solver = mode
    return (js, jm, jc), (ps, pm, pc)


@pytest.mark.parametrize("seed", [12, 14, 15, 17])
def test_scheduler_with_the_batched_search_matches_jax(seed):
    jenv, penv = both_schedulers(random_spec(seed, with_preemption=True), True)
    jseen, pseen = _searches(jenv[0]), _searches(penv[0])
    assert drain_and_trace(*penv) == drain_and_trace(*jenv)
    assert pseen == jseen
    assert any(pseen) and all(s == "device" for c in pseen for s in c)


def _contended_cut(mode, n_cq=40):
    jenv = contended.build_contended(np.random.default_rng(contended.SEED), n_cq=n_cq,
                                     api=jax_api())
    penv = contended.build_contended(np.random.default_rng(contended.SEED), n_cq=n_cq)
    js = contended.build_scheduler(jenv, use_preempt_solver=mode, use_solver=False)
    ps = contended.build_scheduler(penv, use_preempt_solver=mode, device="cpu")
    return (js, jenv), (ps, penv)


@pytest.mark.parametrize("mode", [True, None])
def test_contended_cut_cycles_match_jax(mode):
    """A 40-ClusterQueue cut of the contended cluster, 8 cycles with
    the victims evicted between them: the same decisions every cycle;
    victim_search every cycle with True, and on the first cycle that
    defers preempt_solver_threshold heads with the default None (its
    first probe always batches)."""
    (js, jenv), (ps, penv) = _contended_cut(mode)
    jseen, pseen = _searches(js), _searches(ps)
    jrec = contended.run_cycles(js, jenv, 8)
    prec = contended.run_cycles(ps, penv, 8)
    strip = [{k: v for k, v in r.items() if k != "victim_search"} for r in prec]
    assert strip == [{k: v for k, v in r.items() if k != "victim_search"} for r in jrec]
    assert sum(len(r["preempting"]) for r in prec) > 0
    if mode is True:
        assert prec == jrec and pseen == jseen
    else:
        first = next(i for i, c in enumerate(pseen) if len(c) >= ps.preempt_solver_threshold)
        assert pseen[first] == jseen[first] == ["device"] * len(pseen[first])


def test_jax_contended_cycles_give_the_constants():
    (js, jenv), _ = _contended_cut(True, n_cq=contended.N_CQ)
    records = contended.run_cycles(js, jenv)
    assert contended.cycle_summary(records) == contended.CONTENDED_CYCLE_EXPECT


def test_port_contended_cycles_on_cpu_give_the_constants():
    penv = contended.build_contended(np.random.default_rng(contended.SEED))
    ps = contended.build_scheduler(penv, use_preempt_solver=True, device="cpu")
    records = contended.run_cycles(ps, penv)
    assert contended.cycle_summary(records) == contended.CONTENDED_CYCLE_EXPECT
    assert all(r["victim_search"] == ["device"] for r in records if r["preempting"])
