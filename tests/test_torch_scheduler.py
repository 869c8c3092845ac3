"""The port's interactive admission cycle (kueue_tpu_torch's Scheduler
on the CPU, its plain torch versions) against the JAX package's
Scheduler, exactly:

- per-cycle decision traces (admitted workloads with their flavors in
  admission order, preempting, skipped) and the final cache on
  tests/test_solver_path.py's seeded specs (fit-only, with preemption,
  two resource groups) and on perf.cases.cycle_spec's depth-3 clusters;
- the guard's host mirror (solve_lowered_host) against the JAX one and
  against the port's own dispatch;
- ResidentCycleState's delta path against a fresh upload;
- the QueueManager's pop order on the headline backlog;
- the branches the port refuses, and no silent CPU fallback: a kernel
  that cannot be built or launched raises out of the guard and the
  Scheduler instead of failing over to the host mirror.
"""

import copy

import numpy as np
import pytest
import torch

from kueue_tpu.core.guard import solve_lowered_host as jax_solve_lowered_host
from kueue_tpu.core.queue_manager import queue_order_timestamp as jax_ts
from kueue_tpu.core.snapshot import take_snapshot as jax_take_snapshot
from kueue_tpu.core.solver import lower_heads as jax_lower_heads
from kueue_tpu.models import FlavorFungibility, FlavorFungibilityPolicy
from kueue_tpu.models.cluster_queue import BorrowWithinCohort, Preemption
from kueue_tpu.models.constants import (
    BorrowWithinCohortPolicy,
    PreemptionPolicy,
    ReclaimWithinCohortPolicy,
)
from kueue_tpu_torch.core.guard import results_match, solve_lowered_host
from kueue_tpu_torch.core.queue_manager import queue_order_timestamp
from kueue_tpu_torch.core.snapshot import take_snapshot
from kueue_tpu_torch.core.solver import ResidentCycleState, dispatch_lowered, lower_heads
from kueue_tpu_torch.ops import _build
from kueue_tpu_torch.perf import cases, headline

from tests.test_solver_path import build_env, drain_and_trace, random_spec


def port_spec(spec):
    """A test_solver_path / test_drain spec with its JAX model objects
    (Preemption, FlavorFungibility) as the names perf.cases.build_cache
    reads."""
    out = copy.deepcopy({k: v for k, v in spec.items()})
    for cq in out["cqs"]:
        p = cq.pop("preemption", None)
        if p is not None:
            cq["within"] = p.within_cluster_queue.name
            cq["reclaim"] = p.reclaim_within_cohort.name
            if p.borrow_within_cohort.policy != BorrowWithinCohortPolicy.NEVER:
                cq["bwc"] = p.borrow_within_cohort.max_priority_threshold
        f = cq.get("fungibility")
        if f is not None and not isinstance(f, tuple):
            cq["fungibility"] = (f.when_can_borrow.name, f.when_can_preempt.name)
    return out


def jax_spec(spec):
    """A perf.cases spec (policy names) in test_solver_path.build_env's
    form (the JAX package's model objects)."""
    out = copy.deepcopy(spec)
    for cq in out["cqs"]:
        f = cq.pop("fungibility", None)
        if f is not None:
            cq["fungibility"] = FlavorFungibility(
                when_can_borrow=FlavorFungibilityPolicy[f[0]],
                when_can_preempt=FlavorFungibilityPolicy[f[1]],
            )
        within, reclaim = cq.pop("within", None), cq.pop("reclaim", None)
        bwc = BorrowWithinCohort()
        if "bwc" in cq:
            bwc = BorrowWithinCohort(
                policy=BorrowWithinCohortPolicy.LOWER_PRIORITY,
                max_priority_threshold=cq.pop("bwc"),
            )
        if within is not None or reclaim is not None:
            cq["preemption"] = Preemption(
                within_cluster_queue=PreemptionPolicy[within or "NEVER"],
                reclaim_within_cohort=ReclaimWithinCohortPolicy[reclaim or "NEVER"],
                borrow_within_cohort=bwc,
            )
    return out


def both_envs(spec, names=False):
    """((jax sched, mgr, cache), (port sched, mgr, cache)); ``names``:
    the spec carries policy names (perf.cases), not JAX objects."""
    jspec = jax_spec(spec) if names else spec
    pspec = spec if names else port_spec(spec)
    js, jm, jc, _ = build_env(jspec, use_solver=True)
    ps, pm, pc = cases.build_scheduler(pspec, device="cpu")
    return (js, jm, jc), (ps, pm, pc)


def assert_same_cycles(spec, names=False):
    jax_env, port_env = both_envs(spec, names)
    jt, jf = drain_and_trace(*jax_env)
    pt, pf = drain_and_trace(*port_env)
    assert pt == jt
    assert pf == jf
    resolutions = [t.resolution for t in port_env[0].last_traces]
    assert resolutions == [t.resolution for t in jax_env[0].last_traces]
    return jt, port_env[0]


class TestSchedulerParity:
    @pytest.mark.parametrize("seed", range(8))
    def test_fit_only(self, seed):
        trace, sched = assert_same_cycles(random_spec(seed))
        assert any(c["admitted"] for c in trace)
        assert "device" in [t.resolution for t in sched.last_traces]

    @pytest.mark.parametrize("seed", range(12, 20))
    def test_with_preemption(self, seed):
        assert_same_cycles(random_spec(seed, with_preemption=True))

    def test_multi_resource_groups(self, monkeypatch):
        """test_solver_path's two-resource-group spec (cpu+memory | gpu),
        taken from its test by standing in for its parity assertion."""
        import tests.test_solver_path as tsp

        spec = {}
        monkeypatch.setattr(tsp, "assert_parity", spec.update)
        tsp.TestSolverPathParity().test_multi_resource_groups()
        trace, _ = assert_same_cycles(spec)
        assert any(c["admitted"] for c in trace)

    @pytest.mark.parametrize("seed", range(4))
    def test_depth3_cohorts_limits_and_reservations(self, seed):
        trace, sched = assert_same_cycles(cases.cycle_spec(seed), names=True)
        assert any(c["admitted"] for c in trace)
        assert sched._resident_state.delta_rows > 0  # the scatter path ran

    def test_victim_search_is_host(self):
        """With the default use_preempt_solver=None, a cycle that defers
        fewer preempt-mode heads than preempt_solver_threshold searches
        them on the host, and the first cycle that defers more batches
        them on the device (the gate's first probe always passes), in
        both packages alike. The threshold is lowered to 2 because this
        spec defers one to three heads a cycle."""
        spec = random_spec(15, with_preemption=True)
        jsched, jmgr, jcache, _ = build_env(spec, use_solver=False)
        _, (sched, mgr, cache) = both_envs(spec)
        seen = {}
        for name, s in (("jax", jsched), ("port", sched)):
            s.preempt_solver_threshold = 2
            seen[name] = []
            s.cycle_observers.append(lambda res, out=seen[name]: out.append(
                [e.victim_search for e in res.admitted + res.preempting + res.requeued
                 if e.victim_search]))
        assert drain_and_trace(sched, mgr, cache) == drain_and_trace(jsched, jmgr, jcache)
        port, jax = seen["port"], seen["jax"]
        first = next(i for i, c in enumerate(jax) if len(c) >= 2)
        assert port[:first + 1] == jax[:first + 1]
        assert all(c == ["host"] * len(c) for c in port[:first])
        assert any(port[:first]) and port[first] == ["device"] * len(port[first])


def _jax_fair(spec):
    """The JAX Scheduler over a spec (policy names) with fair sharing,
    the fair-sharing Preemptor and the batched victim search; its host
    nomination path (use_solver=False, as perf/contended.py explains)."""
    from types import SimpleNamespace

    from tests.test_drain import build_preempt_env

    sched, mgr, cache, _ = build_preempt_env(jax_spec(spec))
    sched.fair_sharing = True
    sched.preemptor.enable_fair_sharing = True
    sched.use_preempt_solver = True
    return sched, SimpleNamespace(cache=cache, mgr=mgr)


def _port_fair(spec):
    from types import SimpleNamespace

    sched, mgr, cache = cases.build_scheduler(spec, device="cpu", fair_sharing=True,
                                              use_preempt_solver=True)
    return sched, SimpleNamespace(cache=cache, mgr=mgr)


class TestFairScheduler:
    """Scheduler(fair_sharing=True) against the JAX Scheduler, cycle by
    cycle (admitted with flavors, preempting heads with their targets
    and reasons, requeued, victim-search path), each cycle's victims
    evicted before the next: the lazy fair-sharing admission order, the
    non-incremental fit re-check and the batched fair victim search
    (kernel B9's plain version)."""

    @pytest.mark.parametrize("spec_fn,seed", [
        (cases.fair_spec, 2), (cases.fair_spec, 4),
        (cases.fair_preempt_spec, 1), (cases.fair_preempt_spec, 4),
    ])
    def test_small_cases_match_jax(self, spec_fn, seed):
        from kueue_tpu_torch.perf import contended

        spec = spec_fn(seed)
        jsched, jenv = _jax_fair(spec)
        psched, penv = _port_fair(spec)
        jrec = contended.run_cycles(jsched, jenv, 12)
        prec = contended.run_cycles(psched, penv, 12)
        assert prec == jrec
        assert any(r["admitted"] for r in prec)

    def test_depth3_case_preempts_on_the_batched_search(self):
        from kueue_tpu_torch.perf import contended

        psched, penv = _port_fair(cases.fair_preempt_spec(4))
        records = contended.run_cycles(psched, penv, 12)
        preempting = [r for r in records if r["preempting"]]
        assert preempting and all(r["victim_search"] == ["device"] for r in preempting)

    def test_bench_cluster_cut_matches_jax(self):
        """8 cycles of bench.py's 60-ClusterQueue fair-preempt cluster."""
        from kueue_tpu_torch.perf import contended, fairpreempt as fp
        from tests.test_torch_fair_preempt_drain import _jax_env

        jenv, penv = _jax_env(fp.SMALL_N_CQ), fp.build_fair_preempt(fp.SMALL_N_CQ)
        jsched = fp.build_scheduler(jenv, use_solver=False, use_preempt_solver=True)
        psched = fp.build_scheduler(penv, use_solver=True, use_preempt_solver=True,
                                    device="cpu")
        jrec = contended.run_cycles(jsched, jenv, fp.CYCLE_CYCLES)
        assert contended.run_cycles(psched, penv, fp.CYCLE_CYCLES) == jrec

    def test_quiescence_reaches_the_drain_sets(self):
        """bench.py's own check at its 60 ClusterQueues: the fair
        Scheduler run to quiescence, evictions applied between cycles,
        admits and evicts the sets the fair-preempt drain decides."""
        from kueue_tpu_torch.core.drain import run_drain_fair_preempt
        from kueue_tpu_torch.perf import fairpreempt as fp

        env = fp.build_fair_preempt(fp.SMALL_N_CQ)
        out = run_drain_fair_preempt(take_snapshot(env.cache), env.pending, env.cache.flavors,
                                     timestamp_fn=env.ts_fn, device="cpu")
        env = fp.build_fair_preempt(fp.SMALL_N_CQ)
        sched = fp.build_scheduler(env, use_solver=True, use_preempt_solver=True, device="cpu")
        admitted, evicted, calls = fp.run_to_quiescence(sched, env)
        assert (admitted, evicted) == fp.drain_sets(out)
        assert calls < fp.MAX_CYCLES

    def test_port_cycles_give_the_constant(self):
        """The first CYCLE_CYCLES cycles at 1000 ClusterQueues on the CPU."""
        from kueue_tpu_torch.perf import contended, fairpreempt as fp

        env = fp.build_fair_preempt(fp.N_CQ)
        sched = fp.build_scheduler(env, use_solver=True, use_preempt_solver=True, device="cpu")
        records = contended.run_cycles(sched, env, fp.CYCLE_CYCLES)
        assert contended.cycle_summary(records) == fp.FAIR_PREEMPT_CYCLE_EXPECT
        assert all(r["victim_search"] == ["device"] for r in records if r["preempting"])

    @pytest.mark.slow
    def test_jax_cycles_give_the_constant(self):
        """FAIR_PREEMPT_CYCLE_EXPECT is the JAX package's (about a minute
        on the CPU)."""
        from kueue_tpu_torch.perf import contended, fairpreempt as fp
        from tests.test_torch_fair_preempt_drain import _jax_env

        env = _jax_env(fp.N_CQ)
        sched = fp.build_scheduler(env, use_solver=False, use_preempt_solver=True)
        records = contended.run_cycles(sched, env, fp.CYCLE_CYCLES)
        assert contended.cycle_summary(records) == fp.FAIR_PREEMPT_CYCLE_EXPECT


def test_cycle_lockstep_harness_on_cpu():
    """perf.lockstep's cycle harness (what chip_smoke.py runs on the card)
    leaves decisions unchanged, checks every launch, and restores the
    solver afterwards; on the CPU both sides are the plain versions."""
    from kueue_tpu_torch.core import solver
    from kueue_tpu_torch.core.guard import GuardConfig, SolverGuard
    from kueue_tpu_torch.perf.lockstep import CYCLE_KERNELS, Lockstep, cycle_kernels_through
    from kueue_tpu_torch.utils.clock import FakeClock

    spec = cases.cycle_spec(0)
    guard = SolverGuard(clock=FakeClock(1000.0),
                        config=GuardConfig(mode="device", divergence_check_every=1))
    sched, mgr, cache = cases.build_scheduler(spec, device="cpu", guard=guard)
    errs = {}
    check = Lockstep(errs)
    saved = solver.solve_cycle_segmented_packed
    with cycle_kernels_through(check):
        checked = drain_and_trace(sched, mgr, cache)
    assert solver.solve_cycle_segmented_packed is saved
    assert checked == drain_and_trace(*cases.build_scheduler(spec, device="cpu"))
    assert set(check.launches) == set(CYCLE_KERNELS)
    assert all(e == 0 for e in errs.values()) and check.failures == []
    assert guard.divergence_checks > 0 and guard.divergences == 0


def _heads(mgr):
    return [(wl, cq) for cq, pq in mgr.cluster_queues.items() for wl in pq.snapshot_sorted()]


@pytest.mark.parametrize("seed", range(4))
def test_host_mirror_matches_jax_and_the_dispatch(seed):
    spec = cases.cycle_spec(seed)
    (_, jm, jc), (_, pm, pc) = both_envs(spec, names=True)
    jsnap, psnap = jax_take_snapshot(jc), take_snapshot(pc)
    jlow = jax_lower_heads(jsnap, _heads(jm), jc.flavors,
                           timestamp_fn=lambda wl: jax_ts(wl, jm._ts_policy))
    plow = lower_heads(psnap, _heads(pm), pc.flavors,
                       timestamp_fn=lambda wl: queue_order_timestamp(wl, pm._ts_policy))
    want = jax_solve_lowered_host(jsnap, jlow)
    got = solve_lowered_host(psnap, plow)
    for name in ("chosen", "admitted", "borrows", "reserved", "order"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    dev = dispatch_lowered(psnap, plow, device="cpu")
    assert results_match(dev, got) == []
    assert np.asarray(got.admitted).any()


def test_resident_delta_matches_a_fresh_upload():
    """The delta path (scatter of changed rows) decides as a fresh
    upload does, across usage changes and a quota edit."""
    from kueue_tpu_torch.core.workload_info import make_admission
    from kueue_tpu_torch.models import ClusterQueue, Workload, WorkloadConditionType
    from kueue_tpu_torch.models.cluster_queue import FlavorQuotas, ResourceGroup
    from kueue_tpu_torch.models.workload import PodSet

    spec = port_spec(random_spec(21))
    _, mgr, cache = cases.build_scheduler(spec, device="cpu", use_solver=False)
    resident = ResidentCycleState("cpu")
    ts = lambda wl: queue_order_timestamp(wl, mgr._ts_policy)  # noqa: E731

    def compare():
        snapshot = take_snapshot(cache)
        lowered = lower_heads(snapshot, _heads(mgr), cache.flavors, timestamp_fn=ts)
        fresh = dispatch_lowered(snapshot, lowered, device="cpu")
        res = dispatch_lowered(snapshot, lowered, resident=resident)
        for name in ("chosen", "admitted", "borrows", "reserved", "order"):
            np.testing.assert_array_equal(getattr(fresh, name), getattr(res, name))
        # the resident buffer holds exactly the snapshot's leaf usage
        np.testing.assert_array_equal(resident._usage.numpy(), snapshot.local_usage)

    compare()
    assert resident.full_uploads == 1
    cq_name = spec["cqs"][0]["name"]
    flavor = spec["cqs"][0]["groups"][0]["flavors"][0][0]
    for i, cpu in enumerate(("2", "3")):
        wl = Workload(
            namespace="ns", name=f"resident-{i}", queue_name=f"lq-{cq_name}",
            priority=0, creation_time=500.0,
            pod_sets=(PodSet.build("main", 1, {"cpu": cpu}),),
        )
        wl.admission = make_admission(cq_name, {"main": {"cpu": flavor}}, wl)
        wl.set_condition(WorkloadConditionType.QUOTA_RESERVED, True,
                         reason="QuotaReserved", now=500.0)
        cache.add_or_update_workload(wl)
        compare()
    assert resident.full_uploads == 1
    assert resident.delta_rows >= 2

    cq0 = cache.cluster_queues[cq_name].model
    cache.add_or_update_cluster_queue(
        ClusterQueue(
            name=cq_name, cohort=cq0.cohort, namespace_selector={},
            resource_groups=(ResourceGroup(("cpu",), (FlavorQuotas.build(flavor, {"cpu": "99"}),)),),
        )
    )
    compare()
    assert resident.full_uploads == 2


def test_queue_pop_order_on_the_headline_backlog():
    """The port's Python heap pops the headline backlog (priority and
    timestamp ties included) in the JAX QueueManager's order."""
    import bench
    from kueue_tpu_torch.utils.clock import FakeClock

    rng = np.random.default_rng(headline.HEADLINE_SEED)
    _, jmgr = bench.build_cluster(rng)
    for wl, _ in bench.build_backlog(rng):
        jmgr.add_or_update_workload(wl)
    rng = np.random.default_rng(headline.HEADLINE_SEED)
    pcache = headline.build_cluster(rng)
    pmgr = headline.build_queues(pcache, FakeClock(0.0))
    for wl, _ in headline.build_backlog(rng):
        pmgr.add_or_update_workload(wl)
    assert list(pmgr.cluster_queues) == list(jmgr.cluster_queues)
    for name, jpq in jmgr.cluster_queues.items():
        ppq = pmgr.cluster_queues[name]
        jorder = [jpq.heap.pop().name for _ in range(len(jpq.heap))]
        porder = [ppq.heap.pop().name for _ in range(len(ppq.heap))]
        assert porder == jorder, name


class TestRefusals:
    def _env(self):
        return cases.build_scheduler(port_spec(random_spec(0)), device="cpu")

    def test_runs_on_the_card_unless_asked(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cases.build_scheduler(port_spec(random_spec(0)))

    @pytest.mark.parametrize("kwargs", [
        {"fair_sharing": True, "policy": "gavel"},
    ])
    def test_unported_branches_raise(self, kwargs):
        """Fair sharing and admission policies are ported, together too:
        the fair Scheduler under Gavel runs its cycles."""
        from kueue_tpu_torch.core.scheduler import Scheduler
        from kueue_tpu_torch.policy import resolve_policy

        _, mgr, cache = self._env()
        kwargs = dict(kwargs, policy=resolve_policy(kwargs["policy"]))
        fair = Scheduler(queues=mgr, cache=cache, clock=mgr.clock, device="cpu", **kwargs)
        result = fair.schedule()
        assert fair.fair_sharing and fair.policy.name == "gavel"
        assert result.admitted

    def test_fair_victim_search_raises(self):
        """A fair-sharing preemptor routes to the fair victim tournament
        (kernel B9): on the CPU when asked, and without a device it
        raises where there is no card, as every entry point does."""
        from kueue_tpu_torch.core.flavor_assigner import FlavorAssigner, Mode
        from kueue_tpu_torch.core.preempt_batch import batched_get_targets
        from kueue_tpu_torch.core.preemption import Preemptor
        from kueue_tpu_torch.utils.clock import FakeClock

        from kueue_tpu_torch.perf import contended

        env = contended.build_contended(np.random.default_rng(contended.SEED), n_cq=20)
        snapshot = take_snapshot(env.cache)
        assigner = FlavorAssigner(snapshot, env.cache.flavors)
        items = [
            (wl, cq, a) for wl, cq in env.pending
            for a in [assigner.assign(wl, cq)]
            if a.representative_mode() == Mode.PREEMPT
        ]
        assert items
        fair = Preemptor(FakeClock(), enable_fair_sharing=True)
        found = batched_get_targets(snapshot, items, fair, device="cpu")
        host = [fair.get_targets(wl, cq, a, snapshot) for wl, cq, a in items]
        assert [sorted(t.workload.workload.name for t in r) for r in found] == [
            sorted(t.workload.workload.name for t in r) for r in host
        ]
        assert any(found)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                batched_get_targets(snapshot, items, fair)

    def test_non_default_policy_raises(self):
        """Admission policies are ported: the Scheduler takes every one
        of the closed registry, and a name outside it raises."""
        from kueue_tpu_torch.core.scheduler import Scheduler
        from kueue_tpu_torch.policy import policy_names, resolve_policy

        _, mgr, cache = self._env()
        for name in policy_names():
            sched = Scheduler(queues=mgr, cache=cache, clock=mgr.clock, device="cpu",
                              policy=resolve_policy(name))
            assert sched.policy.name == name
        with pytest.raises(ValueError, match="unknown admission policy"):
            Scheduler(queues=mgr, cache=cache, clock=mgr.clock, device="cpu",
                      policy=resolve_policy("scored"))

    def test_mesh_dispatch_raises(self):
        _, mgr, cache = self._env()
        snapshot = take_snapshot(cache)
        lowered = lower_heads(snapshot, _heads(mgr), cache.flavors)
        # a mesh over one device runs (tests/test_torch_parallel.py); one
        # over two cards is refused
        from tests.test_torch_preempt_drain import two_card_mesh

        with pytest.raises(NotImplementedError):
            dispatch_lowered(snapshot, lowered, mesh=two_card_mesh(), device="cpu")


class TestKernelErrorsAreNotContained:
    """A hand-written kernel that cannot be built, refuses its input or
    fails to launch raises out of the guard and the Scheduler; the
    guard's failover to the host mirror is kept for everything else."""

    def _lowered(self):
        sched, mgr, cache = cases.build_scheduler(port_spec(random_spec(0)), device="cpu")
        snapshot = take_snapshot(cache)
        return snapshot, lower_heads(snapshot, _heads(mgr), cache.flavors)

    @pytest.mark.parametrize("exc", [
        _build.KernelError("nvcc failed for csrc/cycle_phase2.cu"),
        _build.KernelError("CUDA kernel cycle_phase1 failed to launch: cudaError 700"),
        _build.KernelInputError("cycle_phase2: takes C<=32 cells, got 40"),
    ])
    def test_guard_reraises(self, exc):
        from kueue_tpu_torch.core.guard import SolverGuard
        from kueue_tpu_torch.utils.clock import FakeClock

        snapshot, lowered = self._lowered()
        guard = SolverGuard(clock=FakeClock(0.0))  # mode="auto"

        def dispatch():
            raise exc

        with pytest.raises(type(exc)):
            guard.solve(snapshot, lowered, dispatch)
        assert guard.failovers == 0 and guard.breaker.consecutive_failures == 0

    def test_guard_fails_over_on_other_errors(self):
        from kueue_tpu_torch.core.guard import SolverGuard
        from kueue_tpu_torch.utils.clock import FakeClock

        snapshot, lowered = self._lowered()
        guard = SolverGuard(clock=FakeClock(0.0))

        def dispatch():
            raise RuntimeError("transient device fault")

        out = guard.solve(snapshot, lowered, dispatch)
        assert out.via == "host-mirror" and out.result is not None
        assert guard.failovers == 1
        assert results_match(out.result, solve_lowered_host(snapshot, lowered)) == []

    def test_scheduler_does_not_contain_them(self, monkeypatch):
        from kueue_tpu_torch.core import solver

        sched, _, _ = cases.build_scheduler(port_spec(random_spec(0)), device="cpu")

        def broken(*args, **kwargs):
            raise _build.KernelError("CUDA kernel cycle_phase2 failed to launch: cudaError 700")

        monkeypatch.setattr(solver, "dispatch_lowered", broken)
        with pytest.raises(_build.KernelError):
            sched.schedule()
        assert sched.guard.failovers == 0 and sched.guard.contained_cycles == 0

    def test_device_faults_in_the_dispatch_become_kernel_errors(self, monkeypatch):
        """A kernel's fault on the card surfaces as torch.AcceleratorError
        at the next CUDA call; the dispatch raises it as a KernelError."""
        from kueue_tpu_torch.core import solver

        snapshot, lowered = self._lowered()

        def faulted(*args, **kwargs):
            raise torch.AcceleratorError("CUDA error: an illegal memory access was encountered")

        monkeypatch.setattr(solver, "solve_cycle_segmented_packed", faulted)
        with pytest.raises(_build.KernelError, match="illegal memory access"):
            dispatch_lowered(snapshot, lowered, device="cpu")

    @pytest.mark.parametrize("kind", ["classic", "fair"])
    def test_victim_search_faults_are_not_contained(self, kind, monkeypatch):
        """A fault of kernel B8 or B9 on the card surfaces as a torch
        error at the batched search's fetch: it is raised as a
        KernelError, and the Scheduler does not hand the cycle's search
        to the host Preemptor."""
        from kueue_tpu_torch.ops import fair_preempt_kernel, preempt_kernel
        from kueue_tpu_torch.perf import contended, fairpreempt as fp

        if kind == "fair":
            env = fp.build_fair_preempt(12)
            sched = fp.build_scheduler(env, use_preempt_solver=True, device="cpu")
            module, name = fair_preempt_kernel, "solve_fair_packed"
        else:
            env = contended.build_contended(np.random.default_rng(contended.SEED), n_cq=20)
            sched = contended.build_scheduler(env, use_preempt_solver=True, device="cpu")
            module, name = preempt_kernel, "solve_preempt_packed"
        launched = []

        class Faulted:
            def cpu(self):
                raise torch.AcceleratorError("CUDA error: an illegal memory access was encountered")

        def launch(*args, **kwargs):
            launched.append(name)
            return Faulted()

        host = []
        monkeypatch.setattr(module, name, launch)
        monkeypatch.setattr(sched.preemptor, "get_targets", lambda *a, **k: host.append(a))
        with pytest.raises(_build.KernelError, match="illegal memory access"):
            sched.schedule()
        assert launched and host == []

    def test_scheduler_on_card_builds_at_construction(self, monkeypatch, tmp_path):
        """Built for cuda, the Scheduler builds and loads its kernels in
        its constructor: without nvcc it raises there."""
        import shutil

        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(shutil, "which", lambda name: None)
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(_build, "_LIBS", {})
        with pytest.raises(_build.KernelError, match="nvcc not found"):
            cases.build_scheduler(port_spec(random_spec(0)), device="cuda")
