"""Admission policies in kueue_tpu_torch (``policy/``, the score
encoders, the policy branch of the drains and of the Scheduler) against
kueue_tpu's, exactly (int64, tolerance 0), mirroring tests/test_policy.py:

- the registry and ``resolve_policy``; every policy's hooks on the same
  labelled workloads;
- ``encode_candidate_scores`` and ``_multi`` on the same lowered
  batches;
- TestDefaultPolicyParity: first-fit decides bit for bit as no policy,
  and all-zero scores as absent scores;
- TestScoredKernels: the Gavel drain (policy-48x64 cut, seeded random
  clusters with throughput labels), and the scored cycle (both
  Schedulers' solver paths), with the Scheduler's per-head score
  breakdown (``_cycle_scores``) equal to the JAX Scheduler's;
- TestDeadlineAndPrema: the deadline boost, and PREMA's victim order in
  the preempt drain's pools and in the host Preemptor's cycles;
- policy-48x64 in full: the two drains give ``POLICY_EXPECT``.
"""

import hashlib

import numpy as np
import pytest

from kueue_tpu import policy as jpol
from kueue_tpu.core import solver as jsolver
from kueue_tpu.core.drain import plan_drain as jax_plan_drain
from kueue_tpu.core.drain import run_drain as jax_run_drain
from kueue_tpu.core.encode import encode_candidate_scores as jax_scores
from kueue_tpu.core.encode import encode_candidate_scores_multi as jax_scores_multi
from kueue_tpu.core.snapshot import take_snapshot as jax_take_snapshot
from kueue_tpu_torch import policy as ppol
from kueue_tpu_torch.core import solver as psolver
from kueue_tpu_torch.core.drain import plan_drain, run_drain
from kueue_tpu_torch.core.encode import encode_candidate_scores, encode_candidate_scores_multi
from kueue_tpu_torch.core.snapshot import take_snapshot
from kueue_tpu_torch.perf import cases
from kueue_tpu_torch.perf import planner as pp

from tests.test_solver_path import build_env, drain_and_trace, random_spec
from tests.test_torch_drain import _both as drain_inputs
from tests.test_torch_drain import _view
from tests.test_torch_planner import JAX, PORT
from tests.test_torch_preempt_drain import view
from tests.test_torch_scheduler import port_spec

POLICIES = ("first-fit", "gavel", "prema", "deadline", "gavel-deadline")


def _policy_envs(n_cq=8, wl_per_cq=16):
    """policy-48x64's builder, cut, in both packages (same draws)."""
    return (pp.build_policy(np.random.default_rng(pp.POLICY_SEED), JAX.api, n_cq, wl_per_cq),
            pp.build_policy(np.random.default_rng(pp.POLICY_SEED), PORT.api, n_cq, wl_per_cq))


def _label_all(workloads, seed):
    """Deterministic throughput, deadline and remaining-work labels by
    workload name (the same in both packages)."""
    for wl in workloads:
        h = int(hashlib.sha256(f"{seed}/{wl.name}".encode()).hexdigest()[:8], 16)
        labels = dict(wl.labels or {})
        if h % 3:
            labels[f"kueue.tpu/throughput-fl-{h % 3}"] = f"{0.5 + (h % 7) / 2:.1f}"
        if h % 5 == 0:
            labels["kueue.tpu/deadline"] = str(900 + h % 400)
        labels["kueue.tpu/remaining-seconds"] = str(h % 5000)
        wl.labels = labels


class TestPolicyRegistry:
    def test_registry_is_closed_and_equal(self):
        assert ppol.policy_names() == jpol.policy_names() == sorted(POLICIES)
        assert ppol.DEFAULT_POLICY == jpol.DEFAULT_POLICY == "first-fit"
        for const in ("SCORE_SCALE", "DEADLINE_BOOST_CAP", "THROUGHPUT_LABEL_PREFIX",
                      "REMAINING_SECONDS_LABEL", "DEADLINE_LABEL"):
            assert getattr(ppol, const) == getattr(jpol, const)

    def test_resolve_known_default_and_unknown(self):
        assert ppol.resolve_policy(None).name == ppol.resolve_policy("").name == "first-fit"
        assert ppol.resolve_policy("first-fit").is_default
        assert not ppol.resolve_policy("gavel").is_default
        with pytest.raises(ValueError, match="unknown admission policy"):
            ppol.resolve_policy("shortest-job-first")

    @pytest.mark.parametrize("name", POLICIES)
    def test_hooks_equal_jax(self, name):
        jenv, penv = _policy_envs(4, 8)
        jp, pp_ = jpol.resolve_policy(name), ppol.resolve_policy(name)
        jwls = [wl for wl, _ in jenv.pending]
        pwls = [wl for wl, _ in penv.pending]
        _label_all(jwls, 1)
        _label_all(pwls, 1)
        for jw, pw in zip(jwls, pwls):
            for sig in ((), ("slow",), ("fast",), ("fl-1", "fl-2")):
                assert pp_.candidate_score(pw, sig) == jp.candidate_score(jw, sig)
                assert pp_.runtime_scale(pw, sig) == jp.runtime_scale(jw, sig)
            for now in (0.0, 950.0, 5000.0):
                assert pp_.priority_boost(pw, now) == jp.priority_boost(jw, now)
            assert pp_.victim_cost_adjust(pw) == jp.victim_cost_adjust(jw)

    def test_default_policy_compiles_nothing(self):
        _, penv = _policy_envs(4, 8)
        snap = take_snapshot(penv.cache)
        lowered = psolver.lower_heads(snap, penv.pending, penv.cache.flavors)
        before = lowered.priority.copy()
        ppol.annotate_lowered(ppol.resolve_policy("first-fit"), lowered, now=1.0)
        assert lowered.score is None and np.array_equal(lowered.priority, before)


@pytest.mark.parametrize("name", ["gavel", "deadline", "gavel-deadline"])
def test_score_encoders_equal_jax(name):
    jenv, penv = _policy_envs()
    _label_all([wl for wl, _ in jenv.pending], 2)
    _label_all([wl for wl, _ in penv.pending], 2)
    jsnap, psnap = jax_take_snapshot(jenv.cache), take_snapshot(penv.cache)
    jl = jsolver.lower_heads(jsnap, jenv.pending, jenv.cache.flavors)
    pl = psolver.lower_heads(psnap, penv.pending, penv.cache.flavors)
    jp, pp_ = jpol.resolve_policy(name), ppol.resolve_policy(name)
    got = encode_candidate_scores(pp_, pl.heads, pl.candidate_flavors, pl.valid.shape[1])
    want = jax_scores(jp, jl.heads, jl.candidate_flavors, jl.valid.shape[1])
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    jpol.annotate_lowered(jp, jl, now=1000.0)
    ppol.annotate_lowered(pp_, pl, now=1000.0)
    np.testing.assert_array_equal(pl.priority, jl.priority)
    np.testing.assert_array_equal(pl.score, jl.score)
    jm = jsolver.lower_heads_multi(jsnap, jenv.pending, jenv.cache.flavors)
    pm = psolver.lower_heads_multi(psnap, penv.pending, penv.cache.flavors)
    np.testing.assert_array_equal(encode_candidate_scores_multi(pp_, pm),
                                  jax_scores_multi(jp, jm))
    jplan = jax_plan_drain(jsnap, jenv.pending, jenv.cache.flavors, timestamp_fn=jenv.ts_fn,
                           policy=jp, now=1000.0)
    pplan = plan_drain(psnap, penv.pending, penv.cache.flavors, timestamp_fn=penv.ts_fn,
                       policy=pp_, now=1000.0)
    for k in ("score", "priority"):
        np.testing.assert_array_equal(pplan.queues_np[k], jplan.queues_np[k])
    # Gavel scores flavors, the deadline policy only boosts priorities
    assert bool(pplan.queues_np["score"].any()) == name.startswith("gavel")
    boosted = not np.array_equal(pl.priority, psolver.lower_heads(
        psnap, penv.pending, penv.cache.flavors).priority)
    assert boosted == name.endswith("deadline")


class TestDefaultPolicyParity:
    @pytest.mark.parametrize("seed", range(3))
    def test_drain_first_fit_bit_for_bit(self, seed):
        jsnap, jpending, jcache, psnap, ppending, pcache, ts = drain_inputs(
            random_spec(seed, workloads_per_cq=8))
        ff = ppol.resolve_policy("first-fit")
        base = run_drain(psnap, ppending, pcache.flavors, timestamp_fn=ts, device="cpu")
        scored = run_drain(take_snapshot(pcache), ppending, pcache.flavors, timestamp_fn=ts,
                           policy=ff, device="cpu")
        assert _view(scored) == _view(base)
        np.testing.assert_array_equal(scored.final_usage, base.final_usage)
        j = jax_run_drain(jsnap, jpending, jcache.flavors, timestamp_fn=ts,
                          policy=jpol.resolve_policy("first-fit"))
        assert _view(scored) == _view(j)

    def test_zero_scores_equal_absent_scores(self):
        import torch

        from kueue_tpu_torch import interop
        from kueue_tpu_torch.ops import assign_kernel as tak

        b = cases.cycle_batch(0)  # an even seed: all-zero scores
        assert not b["score"].any()
        tree = interop.quota_tree(b, "cpu")
        heads = interop.heads_batch(b, "cpu")
        args = (tree, torch.as_tensor(b["local_usage"]))
        steps = dict(n_segments=b["n_segments"], n_steps=b["n_steps"])
        zero = tak.solve_cycle_segmented_packed(*args, heads, torch.as_tensor(b["paths"]),
                                                b["seg_id"], **steps)
        absent = tak.solve_cycle_segmented_packed(*args, heads._replace(score=None),
                                                  torch.as_tensor(b["paths"]), b["seg_id"],
                                                  **steps)
        assert torch.equal(zero, absent)

    def test_cycle_first_fit_bit_for_bit(self):
        def run(policy):
            sched, mgr, cache = cases.build_scheduler(
                port_spec(random_spec(3, workloads_per_cq=6)), device="cpu")
            sched.policy = policy
            trace = drain_and_trace(sched, mgr, cache)
            return trace, {k: [(r.outcome, r.flavors, r.scores)
                               for r in sched.audit.for_workload(k)]
                           for k in sched.audit.keys()}

        assert run(None) == run(ppol.resolve_policy("first-fit"))


class TestScoredKernels:
    @pytest.mark.parametrize("name", ["gavel", "gavel-deadline"])
    def test_policy_cluster_drain_equals_jax(self, name):
        jenv, penv = _policy_envs()
        jp, pp_ = jpol.resolve_policy(name), ppol.resolve_policy(name)
        j = jax_run_drain(jax_take_snapshot(jenv.cache), jenv.pending, jenv.cache.flavors,
                          timestamp_fn=jenv.ts_fn, policy=jp, now=5.0)
        p = run_drain(take_snapshot(penv.cache), penv.pending, penv.cache.flavors,
                      timestamp_fn=penv.ts_fn, policy=pp_, now=5.0, device="cpu")
        assert _view(p) == _view(j)
        np.testing.assert_array_equal(p.final_usage, j.final_usage)
        ff = run_drain(take_snapshot(penv.cache), penv.pending, penv.cache.flavors,
                       timestamp_fn=penv.ts_fn, device="cpu")
        assert _view(ff) != _view(p)  # the scores moved decisions

    @pytest.mark.parametrize("seed", range(4))
    def test_gavel_randomized_drain_parity(self, seed):
        jsnap, jpending, jcache, psnap, ppending, pcache, ts = drain_inputs(
            random_spec(seed, workloads_per_cq=6))
        _label_all([wl for wl, _ in jpending], seed)
        _label_all([wl for wl, _ in ppending], seed)
        j = jax_run_drain(jsnap, jpending, jcache.flavors, timestamp_fn=ts,
                          policy=jpol.resolve_policy("gavel"))
        p = run_drain(psnap, ppending, pcache.flavors, timestamp_fn=ts,
                      policy=ppol.resolve_policy("gavel"), device="cpu")
        assert _view(p) == _view(j)
        np.testing.assert_array_equal(p.final_usage, j.final_usage)

    def test_scored_cycles_equal_jax(self):
        """The port's Scheduler under Gavel (its solver path on the CPU)
        cycle by cycle against the JAX Scheduler's: the decisions, the
        per-head score breakdown (``_cycle_scores``) and the audit
        records that carry it."""
        from kueue_tpu.core.scheduler import Scheduler as JaxScheduler
        from kueue_tpu_torch.core.scheduler import Scheduler

        jenv, penv = _policy_envs(6, 8)
        js = JaxScheduler(queues=jenv.mgr, cache=jenv.cache, clock=jenv.clock, use_solver=True,
                          solver_threshold=1, policy=jpol.resolve_policy("gavel"))
        ps = Scheduler(queues=penv.mgr, cache=penv.cache, clock=penv.clock, use_solver=True,
                       solver_threshold=1, device="cpu", policy=ppol.resolve_policy("gavel"))
        scored = 0
        for _ in range(4):
            jr, pr = js.schedule(), ps.schedule()
            assert {e.workload.name: e.workload.admission.pod_set_assignments[0].flavors
                    for e in pr.admitted} == {
                e.workload.name: e.workload.admission.pod_set_assignments[0].flavors
                for e in jr.admitted}
            assert ps._cycle_scores == js._cycle_scores
            scored += len(ps._cycle_scores)
            for e in pr.admitted:
                assert ps.audit.for_workload(e.workload.key)[-1].scores == (
                    js.audit.for_workload(e.workload.key)[-1].scores)
        assert scored


class TestDeadlineAndPrema:
    def test_deadline_boost_monotone_and_capped(self):
        from kueue_tpu_torch.policy.engine import DEADLINE_BOOST_CAP, _deadline_boost

        far, near = _deadline_boost(10_000.0, 0.0), _deadline_boost(10.0, 0.0)
        passed = _deadline_boost(0.0, 10.0)
        assert 0 <= far < near < passed == DEADLINE_BOOST_CAP

    @pytest.mark.parametrize("seed", [5, 10])
    def test_prema_orders_the_preempt_drain_pools(self, seed, monkeypatch):
        """The preempt drain under PREMA: every queue's candidate order
        (the pools' ``perm``) and the decisions and evictions equal the
        JAX package's, and PREMA moved the order."""
        from kueue_tpu.core import drain as jdrain
        from kueue_tpu.core.drain import run_drain_preempt as jax_run_drain_preempt
        from kueue_tpu.core.queue_manager import queue_order_timestamp
        from kueue_tpu_torch.core import drain as pdrain

        from tests.test_drain import build_preempt_env, preempt_spec

        perms = []
        for mod in (jdrain, pdrain):
            inner = mod._lower_victim_pools

            def lower(*a, _inner=inner, **kw):
                low = _inner(*a, **kw)
                perms.append(low.victims_np["perm"].copy())
                return low
            monkeypatch.setattr(mod, "_lower_victim_pools", lower)

        spec = preempt_spec(seed)
        outs = []
        for name in ("first-fit", "prema"):
            _, mgr, jcache, _ = build_preempt_env(spec)
            jpending = [(wl, cq) for cq, pq in mgr.cluster_queues.items()
                        for wl in pq.snapshot_sorted()]
            pcache, ppending = cases.build_cache(port_spec(spec))
            by_name = {wl.name: (wl, cq) for wl, cq in ppending}
            ppending = [by_name[wl.name] for wl, _ in jpending]
            ts = lambda wl: queue_order_timestamp(wl, mgr._ts_policy)  # noqa: E731
            jsnap, psnap = jax_take_snapshot(jcache), take_snapshot(pcache)
            for snap, pending in ((jsnap, jpending), (psnap, ppending)):
                _label_all([ws.workload for ws in snap.workloads.values()], seed)
                _label_all([wl for wl, _ in pending], seed)
            jout = jax_run_drain_preempt(jsnap, jpending, jcache.flavors, timestamp_fn=ts,
                                         policy=jpol.resolve_policy(name))
            pout = pdrain.run_drain_preempt(psnap, ppending, pcache.flavors, timestamp_fn=ts,
                                            policy=ppol.resolve_policy(name), device="cpu")
            assert view(pout) == view(jout)
            assert jout.preempted
            outs.append(view(pout))
        # each drain lowers its pools once: (jax, port) under first-fit,
        # then under PREMA
        assert len(perms) == 4
        np.testing.assert_array_equal(perms[1], perms[0])
        np.testing.assert_array_equal(perms[3], perms[2])
        assert not np.array_equal(perms[2], perms[0])

    @pytest.mark.parametrize("seed", [21, 25])
    def test_prema_orders_the_preemptor(self, seed):
        """The host Preemptor under PREMA in the Scheduler's cycles,
        port against JAX, on seeds where PREMA changes the victims."""
        def trace(port, name):
            spec = random_spec(seed, with_preemption=True)
            if port:
                sched, mgr, cache = cases.build_scheduler(port_spec(spec), device="cpu")
            else:
                sched, mgr, cache, _ = build_env(spec, use_solver=False)
            sched.use_preempt_solver = False
            sched.preemptor.policy = (ppol if port else jpol).resolve_policy(name)
            _label_all([wl for pq in mgr.cluster_queues.values()
                        for wl in pq.snapshot_sorted()], seed)
            return drain_and_trace(sched, mgr, cache)

        prema = trace(True, "prema")
        assert prema == trace(False, "prema")
        assert any(c["preempting"] for c in prema[0])
        assert prema != trace(True, "first-fit")

    def test_preemptor_candidate_key_uses_prema_adjust(self):
        from kueue_tpu_torch.core.preemption import Preemptor
        from kueue_tpu_torch.core.snapshot import WorkloadSnapshot
        from kueue_tpu_torch.models import Workload
        from kueue_tpu_torch.utils.clock import FakeClock

        def ws(name, remaining):
            wl = Workload(namespace="ns", name=name,
                          labels={ppol.REMAINING_SECONDS_LABEL: str(remaining)})
            return WorkloadSnapshot(workload=wl, cq_name="other", cq_row=0, priority=5,
                                    quota_reserved_time=1.0,
                                    usage_vec=np.zeros(1, dtype=np.int64))

        class Ctx:
            cq_name = "cq"

        pre = Preemptor(FakeClock(0.0))
        a, b = ws("a", 10), ws("b", 5000)
        assert [w.workload.name for w in sorted([a, b], key=pre._candidate_key(Ctx()))] == [
            "a", "b"]
        pre.policy = ppol.resolve_policy("prema")
        assert [w.workload.name for w in sorted([a, b], key=pre._candidate_key(Ctx()))] == [
            "b", "a"]


def test_policy_stage_drains_equal_expect():
    env = pp.build_policy(np.random.default_rng(pp.POLICY_SEED))
    got = {}
    for key, pol in (("first_fit", None), ("gavel", ppol.resolve_policy("gavel"))):
        out = run_drain(take_snapshot(env.cache), env.pending, env.cache.flavors,
                        timestamp_fn=env.ts_fn, policy=pol, device="cpu")
        got[key] = pp.drain_summary(out)
    assert got == {k: pp.POLICY_EXPECT[k] for k in got}
