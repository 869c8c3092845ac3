"""The fair-preempt drain (kernel family B11) in both packages: the same
cluster, victims and backlog built in each, drained by kueue_tpu's
run_drain_fair_preempt (JAX on the CPU) and by kueue_tpu_torch's
run_drain_fair_preempt(device="cpu") (the plain torch versions of the
kernels). Exact agreement (tolerance 0) of the admitted workloads with
their flavors and cycles, the evictions with their cycle, evictor and
reason, parked, fallback, truncated and cycles, on:

- tests/test_drain.py TestFairPreemptDrain's specs (its in-kernel case
  and its randomized seeds), taken from its tests;
- perf.cases.fair_preempt_spec: depth-3 weighted cohorts, two
  resources, weight 0, multi-podset workloads, both strategy stacks;
- bench.py's fair_preempt_drain stage (60 ClusterQueues),
  fair-preempt-1k and the drain at the panel caps (perf/fairpreempt.py),
  whose constants are pinned to the JAX package here too;
- run_drain_for_scope("fair_preempt"), with a one-strategy stack too.
"""

import numpy as np
import pytest

import tests.test_drain as td
from kueue_tpu import models as jax_models
from kueue_tpu.core import flavor_assigner as jax_fa
from kueue_tpu.core import preempt_batch as jax_pb
from kueue_tpu.core import snapshot as jax_snapshot
from kueue_tpu.core.drain import classify_drain_scope as jax_classify
from kueue_tpu.core.drain import run_drain_fair_preempt as jax_run
from kueue_tpu.core.drain import run_drain_for_scope as jax_scope
from kueue_tpu.core.preemption import (
    LESS_THAN_INITIAL_SHARE,
    LESS_THAN_OR_EQUAL_TO_FINAL_SHARE,
)
from kueue_tpu.core.queue_manager import queue_order_timestamp
from kueue_tpu_torch.core.drain import (
    classify_drain_scope,
    fair_preempt_drain_inputs,
    run_drain_fair_preempt,
    run_drain_for_scope,
)
from kueue_tpu_torch.core.snapshot import take_snapshot
from kueue_tpu_torch.perf import cases
from kueue_tpu_torch.perf import fairpreempt as fp
from kueue_tpu_torch.perf.cases import build_cache

from tests.test_torch_preempt_drain import jax_api, two_card_mesh, view
from tests.test_torch_scheduler import jax_spec, port_spec

BOTH = [LESS_THAN_OR_EQUAL_TO_FINAL_SHARE, LESS_THAN_INITIAL_SHARE]
SMALL_CYCLES = 32  # the depth-3 cases' cycle cap (their decisions end by cycle 13)


def both_drains(spec, names=False, **kw):
    """(JAX outcome, port outcome) of one spec (JAX model objects;
    ``names``: perf.cases' policy names)."""
    pspec = spec if names else port_spec(spec)
    _, mgr, jcache, _ = td.build_preempt_env(jax_spec(spec) if names else spec)
    jpending = [
        (wl, cq) for cq, pq in mgr.cluster_queues.items() for wl in pq.snapshot_sorted()
    ]
    ts = lambda wl: queue_order_timestamp(wl, mgr._ts_policy)  # noqa: E731
    jout = jax_run(jax_snapshot.take_snapshot(jcache), jpending, jcache.flavors,
                   timestamp_fn=ts, **kw)
    pcache, ppending = build_cache(pspec)
    by_name = {wl.name: (wl, cq) for wl, cq in ppending}
    ppending = [by_name[wl.name] for wl, _ in jpending]
    pout = run_drain_fair_preempt(take_snapshot(pcache), ppending, pcache.flavors,
                                  timestamp_fn=ts, device="cpu", **kw)
    return jout, pout


def _specs_of(monkeypatch, test):
    """The specs a TestFairPreemptDrain test drains (recorded as it runs)."""
    seen = []
    real = td.device_fair_preempt_drain_trace

    def record(spec, *a, **k):
        seen.append(spec)
        return real(spec, *a, **k)

    monkeypatch.setattr(td, "device_fair_preempt_drain_trace", record)
    test()
    return seen


def test_reference_in_kernel_case(monkeypatch):
    """test_drain.py's in-kernel case: a borrowing low-weight queue
    saturates the cohort and the other queue's head starts only through
    the fair victim tournament."""
    specs = _specs_of(monkeypatch, td.TestFairPreemptDrain().test_fair_preemption_in_kernel)
    jout, pout = both_drains(specs[0])
    assert view(pout) == view(jout)
    assert pout.preempted and not pout.fallback
    assert {e.reason for e in pout.evictions if e.victim_cq != e.by_cq} == {
        "InCohortFairSharing"
    }


@pytest.mark.parametrize("seed", [
    0, 1, pytest.param(2, marks=pytest.mark.slow), pytest.param(3, marks=pytest.mark.slow),
])
def test_reference_randomized_specs(seed, monkeypatch):
    specs = _specs_of(
        monkeypatch, lambda: td.TestFairPreemptDrain().test_randomized_parity(seed)
    )
    jout, pout = both_drains(specs[0])
    assert view(pout) == view(jout)
    assert pout.admitted


@pytest.mark.parametrize("seed,strategies", [
    (1, BOTH), (8, [LESS_THAN_INITIAL_SHARE]),
    pytest.param(4, BOTH, marks=pytest.mark.slow),
    pytest.param(9, [LESS_THAN_OR_EQUAL_TO_FINAL_SHARE], marks=pytest.mark.slow),
])
def test_depth3_weighted_case_matches_jax(seed, strategies):
    """perf.cases.fair_preempt_spec: weights 0-2000 over a depth-3
    forest, two resources a victim, multi-podset heads. Its last
    decisions come by cycle 13; heads that keep re-nominating without
    a decision then hold the drain until the stagnation guard (about
    500 cycles at these retry budgets), so both drains stop at
    SMALL_CYCLES and are compared there, truncated alike."""
    jout, pout = both_drains(cases.fair_preempt_spec(seed), names=True,
                             fs_strategies=strategies, max_cycles=SMALL_CYCLES)
    assert view(pout) == view(jout)
    assert pout.admitted and pout.preempted and pout.truncated


def _jax_env(n_cq):
    return fp.build_fair_preempt(n_cq, api=fp.fair_api(jax_api(), jax_models, jax_fa,
                                                       jax_snapshot, jax_pb))


def _port_drain(n_cq, **kw):
    env = fp.build_fair_preempt(n_cq)
    return run_drain_fair_preempt(take_snapshot(env.cache), env.pending, env.cache.flavors,
                                  timestamp_fn=env.ts_fn, device="cpu", **kw)


def test_bench_stage_matches_jax():
    """bench.py's own fair_preempt_drain stage (60 ClusterQueues)."""
    env = _jax_env(fp.SMALL_N_CQ)
    jout = jax_run(jax_snapshot.take_snapshot(env.cache), env.pending, env.cache.flavors,
                   timestamp_fn=env.ts_fn)
    pout = _port_drain(fp.SMALL_N_CQ)
    assert view(pout) == view(jout)
    assert fp.drain_summary(pout) == fp.FAIR_PREEMPT_SMALL_EXPECT


def test_jax_drain_gives_the_constant():
    """FAIR_PREEMPT_EXPECT is the JAX package's at 1000 ClusterQueues
    (1500 victims, 4000 pending)."""
    env = _jax_env(fp.N_CQ)
    out = jax_run(jax_snapshot.take_snapshot(env.cache), env.pending, env.cache.flavors,
                  timestamp_fn=env.ts_fn)
    assert fp.drain_summary(out) == fp.FAIR_PREEMPT_EXPECT


def test_port_drain_gives_the_constant():
    assert fp.drain_summary(_port_drain(fp.N_CQ)) == fp.FAIR_PREEMPT_EXPECT


def _wide_env(api=None):
    return fp.build_fair_wide(np.random.default_rng(fp.WIDE_SEED), api=api)


def test_jax_wide_drain_gives_the_constant():
    """FAIR_WIDE_EXPECT is the JAX package's on the drain at the panel
    caps (M = 64 nodes, depth 3, Cu = 64 cells, two resources)."""
    env = _wide_env(fp.fair_api(jax_api(), jax_models, jax_fa, jax_snapshot, jax_pb))
    out = jax_run(jax_snapshot.take_snapshot(env.cache), env.pending, env.cache.flavors,
                  timestamp_fn=env.ts_fn)
    assert fp.drain_summary(out) == fp.FAIR_WIDE_EXPECT


def test_port_wide_drain_gives_the_constant():
    env = _wide_env()
    snap = take_snapshot(env.cache)
    plan, _, tree, _, _, _, victims, panels, fair = fair_preempt_drain_inputs(
        snap, env.pending, env.cache.flavors, "cpu", timestamp_fn=env.ts_fn)
    assert (tree.max_depth, fair.n_res) == (3, 2)
    assert tuple(victims.seg_nodes.shape[1:]) == tuple(panels.seg_cells.shape[1:]) == (64,)
    assert int((panels.seg_cells >= 0).sum(dim=1).max()) == 64
    out = run_drain_fair_preempt(snap, env.pending, env.cache.flavors, timestamp_fn=env.ts_fn,
                                 device="cpu")
    assert fp.drain_summary(out) == fp.FAIR_WIDE_EXPECT


def test_inputs_and_lockstep_harness_on_cpu():
    """The lowering's panels (active universe, inert pads) and
    perf.lockstep's fair-preempt harness, which chip_smoke.py runs on
    the card; on the CPU both sides are the plain versions."""
    from kueue_tpu_torch.perf.lockstep import FAIR_PREEMPT_KERNELS, lockstep_fair_preempt

    env = fp.build_fair_preempt(fp.SMALL_N_CQ)
    plan, _, tree, paths, local, queues, victims, panels, fair = fair_preempt_drain_inputs(
        take_snapshot(env.cache), env.pending, env.cache.flavors, "cpu",
        timestamp_fn=env.ts_fn)
    seg_cells = panels.seg_cells.numpy()
    assert (seg_cells[:, 0] >= 0).sum() == 10 and (seg_cells[:, 1:] < 0).all()
    assert (panels.res_of_cell.numpy()[seg_cells < 0] == fair.n_res).all()
    errs = {}
    _, state, cycles = lockstep_fair_preempt(
        tree, local, queues, victims, panels, paths, fair, plan.n_segments, plan.n_steps,
        plan.max_cycles, 0, True, errs, label="bench stage")
    assert cycles == fp.FAIR_PREEMPT_SMALL_EXPECT["cycles"]
    assert int(state.vevicted.sum()) == fp.FAIR_PREEMPT_SMALL_EXPECT["evicted"]
    assert set(errs) == set(FAIR_PREEMPT_KERNELS) and not any(errs.values())


def test_run_drain_for_scope_fair_preempt_runs():
    env = fp.build_fair_preempt(fp.SMALL_N_CQ)
    snap = take_snapshot(env.cache)
    kind, pending2 = classify_drain_scope(snap, env.pending, None, fair_sharing=True)
    assert kind == "fair_preempt"
    out = run_drain_for_scope(kind, snap, pending2, env.cache.flavors,
                              timestamp_fn=env.ts_fn, device="cpu")
    assert view(out) == view(_port_drain(fp.SMALL_N_CQ))



@pytest.mark.parametrize("strategies", [
    [LESS_THAN_INITIAL_SHARE], [LESS_THAN_OR_EQUAL_TO_FINAL_SHARE],
])
def test_run_drain_for_scope_forwards_the_strategies(strategies):
    """A cluster whose fairSharing.preemptionStrategies is one strategy,
    routed through the kind-to-drain mapping of both packages on
    bench.py's 60-CQ stage: equal decisions, which are not the default
    stack's."""
    jenv = _jax_env(fp.SMALL_N_CQ)
    jsnap = jax_snapshot.take_snapshot(jenv.cache)
    jkind, jpending = jax_classify(jsnap, jenv.pending, None, fair_sharing=True)
    jout = jax_scope(jkind, jsnap, jpending, jenv.cache.flavors, fs_strategies=strategies,
                     timestamp_fn=jenv.ts_fn)
    env = fp.build_fair_preempt(fp.SMALL_N_CQ)
    snap = take_snapshot(env.cache)
    kind, pending2 = classify_drain_scope(snap, env.pending, None, fair_sharing=True)
    out = run_drain_for_scope(kind, snap, pending2, env.cache.flavors, fs_strategies=strategies,
                              timestamp_fn=env.ts_fn, device="cpu")
    assert kind == jkind == "fair_preempt"
    assert view(out) == view(jout)
    assert fp.drain_summary(out) != fp.FAIR_PREEMPT_SMALL_EXPECT


def test_unported_options_raise():
    env = fp.build_fair_preempt(12)
    snap = take_snapshot(env.cache)

    # a mesh over one device runs (tests/test_torch_parallel.py); one
    # over two cards is refused
    with pytest.raises(NotImplementedError):
        run_drain_fair_preempt(snap, env.pending, env.cache.flavors, mesh=two_card_mesh(),
                               device="cpu")
    # a non-default admission policy is ported (tests/test_torch_policy.py
    # holds PREMA's victim order to the JAX package's); first-fit named
    # explicitly decides as no policy
    from kueue_tpu_torch.policy import resolve_policy

    first_fit = run_drain_fair_preempt(snap, env.pending, env.cache.flavors,
                                       policy=resolve_policy("first-fit"), device="cpu")
    none = run_drain_fair_preempt(take_snapshot(env.cache), env.pending, env.cache.flavors,
                                  device="cpu")
    assert view(first_fit) == view(none)


def test_runs_on_the_card_unless_asked():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = fp.build_fair_preempt(12)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_drain_fair_preempt(take_snapshot(env.cache), env.pending, env.cache.flavors)
