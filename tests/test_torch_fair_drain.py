"""The fair-sharing drain of kueue_tpu_torch against kueue_tpu's, on the
CPU (the plain torch versions; int64, tolerance 0):

- ``run_drain(fair_sharing=True, device="cpu")`` against the JAX
  package's ``run_drain(fair_sharing=True)`` on tests/test_drain.py's
  TestDrainFairSharing fixtures (the DRS order beating FIFO, a
  preempt-capable queue routed to fallback), ``fair_drain_spec`` seeds
  and the depth-3 weighted ``perf.cases.fair_spec``, with
  PrioritySortingWithinCohort on and off: admitted (flavors, cycle),
  parked, fallback, undecided, cycles, truncated and final usage;
- ``run_drain_for_scope("fair")`` equal to it;
- the packed result of ``_solve_drain_packed(fair=)`` against the JAX
  ``solve_drain_fair_packed_jit`` on the same numpy inputs, and the
  pieces ``_fair_chain`` and ``_fair_tournament`` on mid-drain inputs;
- the lockstep harness over the fair cycle (both sides plain here).
"""

import copy

import numpy as np
import pytest
import torch

from kueue_tpu import features as jax_features
from kueue_tpu._jax import jnp
from kueue_tpu.core.drain import _fair_lendable as jax_fair_lendable
from kueue_tpu.core.drain import run_drain as jax_run_drain
from kueue_tpu.core.snapshot import take_snapshot as jax_take_snapshot
from kueue_tpu.models.cluster_queue import Preemption
from kueue_tpu.models.constants import PreemptionPolicy
from kueue_tpu.ops import drain_kernel as jdk
from kueue_tpu_torch import features as port_features
from kueue_tpu_torch import interop
from kueue_tpu_torch.core.drain import run_drain as port_run_drain
from kueue_tpu_torch.core.drain import run_drain_for_scope
from kueue_tpu_torch.ops import drain_kernel as tdk
from kueue_tpu_torch.perf.cases import fair_spec
from kueue_tpu_torch.perf.lockstep import FAIR_KERNELS, lockstep

from tests.test_drain import fair_drain_spec
from tests.test_solver_path import build_env
from tests.test_torch_drain import _both, _view, jax_env_of


def _one_flavor_cq(name, quota, **extra):
    return dict(
        name=name,
        cohort="co",
        groups=[{"resources": ["cpu"], "flavors": [("f", {"cpu": quota}, None, None)]}],
        **extra,
    )


def _workload(name, queue, t, cpu):
    return {
        "name": name, "queue": queue, "prio": 0, "t": t,
        "pod_sets": [{"name": "main", "count": 1, "requests": {"cpu": cpu}}],
    }


# tests/test_drain.py TestDrainFairSharing.test_tournament_orders_by_drs
DRS_BEATS_FIFO = {
    "flavors": ["f"],
    "cqs": [
        _one_flavor_cq("cq-a", "2", fair_weight=500),
        _one_flavor_cq("cq-b", "2", fair_weight=2000),
    ],
    "workloads": [
        _workload("wa", "lq-cq-a", 1.0, "3"),
        _workload("wb", "lq-cq-b", 2.0, "3"),
    ],
}
# ... .test_preempt_capable_cqs_fall_back_in_fair_mode ("within" names
# the port's policy; _jax_spec makes the JAX package's object of it)
PREEMPT_CAPABLE = {
    "flavors": ["f"],
    "cqs": [_one_flavor_cq("cq", "4", within="LOWER_PRIORITY")],
    "workloads": [_workload("w", "lq-cq", 1.0, "2")],
}


def _spec(kind, seed):
    if kind == "drs_beats_fifo":
        return copy.deepcopy(DRS_BEATS_FIFO)
    if kind == "preempt_capable":
        return copy.deepcopy(PREEMPT_CAPABLE)
    if kind == "fair_drain_spec":
        return fair_drain_spec(seed)
    return fair_spec(seed)


CASES = (
    [("drs_beats_fifo", 0), ("preempt_capable", 0)]
    + [("fair_drain_spec", s) for s in range(4)]
    # seeds whose drains are short (others spin PendingFlavors heads for
    # a thousand cycles and more before they freeze as stuck)
    + [("fair_spec", s) for s in (2, 4, 5)]
)


def _jax_spec(spec):
    out = jax_env_of(spec)
    for cq in out["cqs"]:
        within = cq.pop("within", None)
        if within is not None:
            cq["preemption"] = Preemption(within_cluster_queue=PreemptionPolicy[within])
    return out


def _envs(spec):
    """_both with the "within" policy name carried to the JAX side."""
    return _both(spec, jax_env=_jax_spec)


@pytest.mark.parametrize("prio_tie", [True, False])
@pytest.mark.parametrize("kind,seed", CASES)
def test_fair_drain_matches_jax(kind, seed, prio_tie):
    jsnap, jpending, jcache, psnap, ppending, pcache, ts = _envs(_spec(kind, seed))
    gate = "PrioritySortingWithinCohort"
    with jax_features.override(gate, prio_tie), port_features.override(gate, prio_tie):
        j = jax_run_drain(jsnap, jpending, jcache.flavors, timestamp_fn=ts, fair_sharing=True)
        p = port_run_drain(
            psnap, ppending, pcache.flavors, timestamp_fn=ts, fair_sharing=True, device="cpu"
        )
    assert _view(p) == _view(j)
    np.testing.assert_array_equal(p.final_usage, j.final_usage)
    if kind == "drs_beats_fifo":
        # the tournament, not FIFO, made the call (tests/test_drain.py)
        assert [(wl.name, f, c) for wl, _, f, c in p.admitted] == [("wb", {"cpu": "f"}, 0)]
    elif kind == "preempt_capable":
        assert [wl.name for wl, _ in p.fallback] == ["w"]
    else:
        assert p.admitted


def test_fair_spec_covers_depth_weights_and_fallback():
    """Guard against a vacuous sweep: the depth-3 fair case has weight-0
    queues, preempt-capable (fallback) queues and admissions."""
    spec = fair_spec(2)
    assert {cq["fair_weight"] for cq in spec["cqs"]} == {0, 500, 1000, 2000}
    _, _, _, psnap, ppending, pcache, ts = _envs(spec)
    assert psnap.flat.level_masks().shape[0] == 4  # depth 3
    p = port_run_drain(psnap, ppending, pcache.flavors, timestamp_fn=ts,
                       fair_sharing=True, device="cpu")
    assert p.admitted and p.fallback


def test_run_drain_for_scope_fair_is_the_fair_drain():
    jsnap, jpending, jcache, psnap, ppending, pcache, ts = _envs(fair_spec(4))
    a = run_drain_for_scope("fair", psnap, ppending, pcache.flavors, timestamp_fn=ts,
                            device="cpu")
    b = port_run_drain(psnap, ppending, pcache.flavors, timestamp_fn=ts,
                       fair_sharing=True, device="cpu")
    c = port_run_drain(psnap, ppending, pcache.flavors, timestamp_fn=ts, device="cpu")
    assert _view(a) == _view(b) and _view(a) != _view(c)


def _fair_inputs(spec):
    """(enc dict, queues_np, plan, fair extras) of the JAX package's fair
    plan (preempt-capable queues routed out) for a spec."""
    from kueue_tpu.core.drain import plan_drain
    from kueue_tpu.core.encode import encode_snapshot
    from kueue_tpu.ops.assign_kernel import build_paths

    _, mgr, cache, _ = build_env(_jax_spec(spec), use_solver=False)
    pending = [(wl, cq) for cq, pq in mgr.cluster_queues.items() for wl in pq.snapshot_sorted()]
    snap = jax_take_snapshot(cache)
    plan = plan_drain(snap, pending, cache.flavors)
    for qi, cq_name in enumerate(plan.cq_order):
        if cache.cluster_queues[cq_name].model.preemption.reclaim_within_cohort.name != "NEVER":
            plan.queues_np["qlen"][qi] = 0
            plan.queues_np["cq_rows"][qi] = -1
            plan.queues_np["seg_id"][qi] = -1
    e = encode_snapshot(snap)
    enc = {
        "parent": e.parent, "level_mask": e.level_mask, "nominal": e.nominal,
        "lending_limit": e.lending_limit, "borrowing_limit": e.borrowing_limit,
        "local_usage": e.local_usage, "max_depth": e.max_depth,
    }
    depth_of, lendable, res_of_fr = jax_fair_lendable(snap, build_paths(e.parent, e.max_depth))
    extras = dict(depth_of=depth_of, weight=snap.weight_milli, lendable=lendable,
                  res_of_fr=res_of_fr, n_res=len(snap.resource_names))
    return enc, plan.queues_np, plan, extras


@pytest.mark.parametrize("seed,prio_tie", [(2, True), (4, False), (5, True)])
def test_packed_fair_drain_matches_jax(seed, prio_tie):
    from tests.test_torch_drain_kernel import _jax_inputs

    enc, queues_np, plan, x = _fair_inputs(fair_spec(seed))
    sizes = dict(n_segments=plan.n_segments, n_steps=plan.n_steps,
                 max_cycles=plan.max_cycles, n_res=x["n_res"], prio_tie=prio_tie)
    j_flat = np.asarray(jdk.solve_drain_fair_packed_jit(
        *_jax_inputs(enc, queues_np), jnp.asarray(x["depth_of"]), jnp.asarray(x["weight"]),
        jnp.asarray(x["lendable"]), jnp.asarray(x["res_of_fr"]), **sizes,
    ))
    tree, queues, local, paths = interop.drain_inputs(enc, queues_np, "cpu")
    f = interop.fair_inputs(dict(x, prio_tie=prio_tie), "cpu")
    t_flat = tdk._solve_drain_packed(
        tree, local, queues, paths, plan.n_segments, plan.n_steps, plan.max_cycles, fair=f,
    )
    assert t_flat.dtype == torch.int64
    np.testing.assert_array_equal(t_flat.numpy(), j_flat)
    assert j_flat[-1] > 0


def test_fair_chain_and_tournament_match_jax():
    """The two pieces on a mid-drain cycle's inputs (live usage after a
    few cycles, every nominated head remaining), for both tie rules."""
    enc, queues_np, plan, x = _fair_inputs(fair_spec(4))
    tree, queues, local, paths = interop.drain_inputs(enc, queues_np, "cpu")
    fair = interop.fair_inputs(dict(x, prio_tie=True), "cpu")
    ctx = tdk.DrainContext.build(tree, queues, paths, plan.n_segments, plan.n_steps,
                                 plan.max_cycles, fair=fair)
    state = tdk.DrainState.initial(local, queues, plan.max_cycles)
    buf = tdk.CycleBuffers.empty(local, queues)
    for _ in range(3):
        tdk.drain_cycle(ctx, state, buf)
    from kueue_tpu_torch.ops.quota import usage_tree

    usage = usage_tree(tree, ctx.guaranteed, state.local)
    tdk.drain_nominate(ctx, state, buf)
    n_nodes, n_res = tree.nominal.shape[0], x["n_res"]
    cq = queues.cq_rows.clamp_min(0).long()
    paths_q = paths[cq]
    cells_c = buf.cells_eff.clamp_min(0).long()
    valid = (buf.cells_eff >= 0) & (buf.qty_eff > 0)
    res_of_q = torch.where(valid, fair.res_of_fr[cells_c], n_res).to(torch.int32)
    bb = torch.zeros((n_nodes, n_res + 1), dtype=torch.int64)
    bb.index_put_(
        (torch.arange(n_nodes)[:, None].expand_as(usage), fair.res_of_fr.long()[None, :].expand_as(usage)),
        (usage - ctx.subtree).clamp_min(0), accumulate=True,
    )
    args_t = (usage, bb[:, :n_res], paths_q, buf.cells_eff, buf.qty_eff, ctx.subtree,
              ctx.guaranteed, fair.lendable, fair.weight, tree.parent, res_of_q, n_res,
              tree.max_depth)
    chain = tdk._fair_chain(*args_t)
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    j_chain = jdk._fair_chain(*[j(a) if torch.is_tensor(a) else a for a in args_t])
    np.testing.assert_array_equal(chain.numpy(), np.asarray(j_chain))
    remaining = (state.cursor < queues.qlen) & (buf.is_fit | buf.is_pre) & (queues.cq_rows >= 0)
    cur = state.cursor.clamp_max(queues.priority.shape[1] - 1).long()
    q_idx = torch.arange(queues.priority.shape[0])
    prio, ts = queues.priority[q_idx, cur], queues.timestamp[q_idx, cur]
    assert bool(remaining.any())
    for tie in (True, False):
        args = (chain, remaining, paths_q, queues.cq_rows, fair.depth_of, tree.parent,
                prio, ts, n_nodes, tree.max_depth, tie)
        win = tdk._fair_tournament(*args)
        j_win = jdk._fair_tournament(*[j(a) if torch.is_tensor(a) else a for a in args])
        np.testing.assert_array_equal(win.numpy(), np.asarray(j_win))
        assert bool(win.any())


def test_lockstep_fair_runs_every_kernel_step():
    enc, queues_np, plan, x = _fair_inputs(fair_spec(2))
    tree, queues, local, paths = interop.drain_inputs(enc, queues_np, "cpu")
    fair = interop.fair_inputs(dict(x, prio_tie=True), "cpu")
    errs = {}
    _, state, cycles = lockstep(
        tree, local, queues, paths, plan.n_segments, plan.n_steps, plan.max_cycles,
        errs, fair=fair,
    )
    assert set(errs) == set(FAIR_KERNELS) and not any(errs.values())
    r = tdk.solve_drain(
        tree, local, queues, paths, plan.n_segments, plan.n_steps, plan.max_cycles, fair=fair,
    )
    assert cycles == int(r.cycles.item()) and torch.equal(state.adm_k, r.admitted_k)
