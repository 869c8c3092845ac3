"""Entry points of the port, the counterpart of the JAX package's driver
hooks (``__graft_entry__.py``).

``entry(device=None)``     — (fn, args): one batched admission cycle
                             (``ops/assign_kernel.solve_cycle``, the
                             unsegmented cycle, kernel B3') on a
                             synthetic cohort forest, the arguments on
                             ``device`` (the card unless the caller
                             names the CPU).
``dryrun_multichip(n)``    — the same cycle through ``ShardedSolver``
                             over an n-device virtual CPU mesh (the JAX
                             hook forces its CPU mesh too), then the
                             plain, preempt and fair drains and the
                             batched fair search with ``mesh=``, each on
                             tiny real model objects, with their
                             asserts.
"""

from __future__ import annotations

import numpy as np


def _synthetic_problem(n_cq: int, n_cohort: int, fr: int, w: int, k: int = 2, c: int = 2,
                       device=None):
    """The JAX hook's synthetic problem (the same numpy draws, seed 42):
    (QuotaTree, leaf usage, HeadsBatch, paths) on ``device``."""
    from kueue_tpu_torch import interop
    from kueue_tpu_torch._torch import resolve_device, to_device
    from kueue_tpu_torch.ops.assign_kernel import build_paths
    from kueue_tpu_torch.ops.quota import NO_LIMIT

    dev = resolve_device(device)
    rng = np.random.default_rng(42)
    n = n_cq + n_cohort
    parent = np.full(n, -1, dtype=np.int32)
    parent[:n_cq] = n_cq + rng.integers(0, n_cohort, size=n_cq)
    level_mask = np.zeros((2, n), dtype=bool)
    level_mask[0, n_cq:] = True
    level_mask[1, :n_cq] = True
    nominal = np.zeros((n, fr), dtype=np.int64)
    nominal[:n_cq] = rng.integers(10, 100, size=(n_cq, fr))
    limits = np.full((n, fr), NO_LIMIT, dtype=np.int64)
    tree = interop.quota_tree(
        dict(parent=parent, level_mask=level_mask, nominal=nominal, lending_limit=limits,
             borrowing_limit=limits),
        dev,
    )
    paths = to_device(build_paths(parent, 1), dev, np.int32)
    local_usage = np.zeros((n, fr), dtype=np.int64)
    local_usage[:n_cq] = rng.integers(0, 40, size=(n_cq, fr))

    cq_row = (np.arange(w) % n_cq).astype(np.int32)
    batch = interop.heads_batch(
        dict(
            cq_row=cq_row,
            cells=rng.integers(0, fr, size=(w, k, c)).astype(np.int32),
            qty=rng.integers(1, 20, size=(w, k, c)).astype(np.int64),
            valid=np.ones((w, k), dtype=bool),
            priority=rng.integers(0, 10, size=w).astype(np.int64),
            timestamp=np.arange(w, dtype=np.int64),
            no_reclaim=np.zeros(w, dtype=bool),
        ),
        dev,
    )
    return tree, to_device(local_usage, dev, np.int64), batch, paths


def entry(device=None):
    """(fn, example_args): one admission cycle on the synthetic problem
    — the unsegmented solver and its arguments on ``device``."""
    from kueue_tpu_torch.ops.assign_kernel import solve_cycle

    args = _synthetic_problem(n_cq=16, n_cohort=4, fr=8, w=16, device=device)
    return solve_cycle, args


def dryrun_multichip(n_devices: int) -> None:
    """Run the full admission cycle over an n-device virtual CPU mesh
    and the sharded drains on tiny shapes, asserting each admits.

    Layout (kueue_tpu_torch/parallel): heads sharded along ``wl`` for
    phase 1 (one launch per shard), phase 2 on the gathered output; the
    quota tensors whole; the drains' per-queue tensors padded to a
    multiple of ``wl``."""
    from kueue_tpu_torch.parallel import ShardedSolver, make_mesh

    # bench-shaped phase 1: W = 512 x devices heads, FR = 64 quota
    # cells, a 2-D mesh where n allows it
    fr = 64
    w = 512 * n_devices
    tree, local_usage, batch, paths = _synthetic_problem(
        n_cq=64, n_cohort=8, fr=fr, w=w, device="cpu"
    )
    mesh = make_mesh(n_devices, fr_parallel=True, device="cpu")
    out = ShardedSolver(mesh)(tree, local_usage, batch, paths)
    assert out.admitted.shape == (w,)
    assert bool(out.admitted.any()), "dryrun admitted nothing"

    _dryrun_sharded_drain(mesh)
    _dryrun_sharded_preempt_drain(mesh)
    _dryrun_sharded_fair_search(mesh)
    _dryrun_sharded_fair_drain(mesh)


# ---- the dry run's fixtures, buildable in either package (``api``:
# perf/fairpreempt.port_api()'s names, from the port by default) ----


def _api(api):
    if api is not None:
        return api
    from kueue_tpu_torch.perf.fairpreempt import port_api

    return port_api()


def drain_case(api=None):
    """The sharded plain drain's fixture: 12 ClusterQueues in 3 cohorts,
    4 workloads each in per-CQ heap order (priority desc, timestamp
    asc), every other one driver+worker (the multi-podset nomination
    path). Returns (snapshot, pending, flavors)."""
    a = _api(api)
    cache = a.Cache()
    mgr = a.QueueManager(a.FakeClock(0.0))
    cache.add_or_update_flavor(a.ResourceFlavor(name="f"))
    pending = []
    for i in range(12):
        name = f"cq-{i}"
        cq = a.ClusterQueue(
            name=name, cohort=f"co-{i % 3}", namespace_selector={},
            resource_groups=(a.ResourceGroup(("cpu",), (a.FlavorQuotas.build("f", {"cpu": "8"}),)),),
        )
        cache.add_or_update_cluster_queue(cq)
        mgr.add_cluster_queue(cq)
        mgr.add_local_queue(a.LocalQueue(namespace="ns", name=f"lq-{name}", cluster_queue=name))
        for j in range(4):
            if j % 2 == 0:
                pod_sets = (a.PodSet.build("main", 1, {"cpu": "3"}),)
            else:
                pod_sets = (
                    a.PodSet.build("driver", 1, {"cpu": "1"}),
                    a.PodSet.build("worker", 2, {"cpu": "1"}),
                )
            pending.append((
                a.Workload(namespace="ns", name=f"w-{i}-{j}", queue_name=f"lq-{name}",
                           priority=3 - j, creation_time=float(j), pod_sets=pod_sets),
                name,
            ))
    return a.take_snapshot(cache), pending, cache.flavors


def preempt_drain_case(api=None):
    """The sharded preempt drain's fixture: 16 ClusterQueues in cohorts
    of 4, the even ones hoarders saturated above nominal (borrowing),
    the odd ones reclaimers (LowerPriority, reclaim Any) with two
    higher-priority heads each: cross-CQ cohort reclamation, the
    strategy ladder, part-B dynamic victims. Returns (snapshot,
    pending, flavors)."""
    a = _api(api)
    cache = a.Cache()
    mgr = a.QueueManager(a.FakeClock(0.0))
    cache.add_or_update_flavor(a.ResourceFlavor(name="f"))
    for i in range(16):
        name = f"pcq-{i}"
        hoarder = i % 2 == 0
        prem = (
            a.Preemption()
            if hoarder
            else a.Preemption(
                within_cluster_queue=a.PreemptionPolicy.LOWER_PRIORITY,
                reclaim_within_cohort=a.ReclaimWithinCohortPolicy.ANY,
            )
        )
        cq = a.ClusterQueue(
            name=name, cohort=f"pco-{i // 4}", namespace_selector={},
            resource_groups=(a.ResourceGroup(("cpu",), (a.FlavorQuotas.build("f", {"cpu": "4"}),)),),
            preemption=prem,
        )
        cache.add_or_update_cluster_queue(cq)
        mgr.add_cluster_queue(cq)
        mgr.add_local_queue(a.LocalQueue(namespace="ns", name=f"lq-{name}", cluster_queue=name))
        if hoarder:
            for v in range(3):
                wl = a.Workload(
                    namespace="ns", name=f"v-{i}-{v}", queue_name=f"lq-{name}", priority=0,
                    pod_sets=(a.PodSet.build("main", 1, {"cpu": "2"}),),
                )
                wl.admission = a.make_admission(name, {"main": {"cpu": "f"}}, wl)
                wl.set_condition(a.WorkloadConditionType.QUOTA_RESERVED, True,
                                 reason="QuotaReserved", now=float(v))
                cache.add_or_update_workload(wl)
        else:
            for j in range(2):
                mgr.add_or_update_workload(a.Workload(
                    namespace="ns", name=f"p-{i}-{j}", queue_name=f"lq-{name}", priority=50,
                    creation_time=float(j), pod_sets=(a.PodSet.build("main", 1, {"cpu": "3"}),),
                ))
    pending = []
    for cq_name, pq in mgr.cluster_queues.items():
        for wl in pq.snapshot_sorted():
            pending.append((wl, cq_name))
    return a.take_snapshot(cache), pending, cache.flavors


def fair_search_case(api=None):
    """The sharded fair victim search's fixture: 16 ClusterQueues in
    cohorts of 4 (reclaim Any), each with one admitted workload (the odd
    ones borrowing), and a high-priority head on every even one.
    Returns (snapshot, items as (workload, cq name, assignment),
    preemptor)."""
    a = _api(api)
    cache = a.Cache()
    mgr = a.QueueManager(a.FakeClock(0.0))
    cache.add_or_update_flavor(a.ResourceFlavor(name="f"))
    heads = []
    for i in range(16):
        name = f"fcq-{i}"
        cq = a.ClusterQueue(
            name=name, cohort=f"fco-{i // 4}", namespace_selector={},
            resource_groups=(a.ResourceGroup(("cpu",), (a.FlavorQuotas.build("f", {"cpu": "4"}),)),),
            preemption=a.Preemption(reclaim_within_cohort=a.ReclaimWithinCohortPolicy.ANY),
        )
        cache.add_or_update_cluster_queue(cq)
        mgr.add_cluster_queue(cq)
        mgr.add_local_queue(a.LocalQueue(namespace="ns", name=f"lq-{name}", cluster_queue=name))
        wl = a.Workload(
            namespace="ns", name=f"fv-{i}", queue_name=f"lq-{name}", priority=0,
            pod_sets=(a.PodSet.build("main", 1, {"cpu": "6" if i % 2 else "1"}),),
        )
        wl.admission = a.make_admission(name, {"main": {"cpu": "f"}}, wl)
        wl.set_condition(a.WorkloadConditionType.QUOTA_RESERVED, True,
                         reason="QuotaReserved", now=float(i))
        cache.add_or_update_workload(wl)
        if i % 2 == 0:
            heads.append((
                a.Workload(namespace="ns", name=f"fh-{i}", queue_name=f"lq-{name}",
                           priority=90, creation_time=100.0 + i,
                           pod_sets=(a.PodSet.build("main", 1, {"cpu": "4"}),)),
                name,
            ))
    snapshot = a.take_snapshot(cache)
    preemptor = a.Preemptor(a.FakeClock(0.0), enable_fair_sharing=True)
    assigner = a.FlavorAssigner(snapshot, cache.flavors, enable_fair_sharing=True)
    items = [(wl, cq_name, assigner.assign(wl, cq_name)) for wl, cq_name in heads]
    return snapshot, items, preemptor


def fair_drain_case(api=None):
    """The sharded fair drain's fixture: 12 weighted ClusterQueues
    (weights 500-1500) in 3 cohorts, 3 workloads each. Returns
    (snapshot, pending, flavors)."""
    a = _api(api)
    cache = a.Cache()
    mgr = a.QueueManager(a.FakeClock(0.0))
    cache.add_or_update_flavor(a.ResourceFlavor(name="f"))
    pending = []
    for i in range(12):
        name = f"wcq-{i}"
        cq = a.ClusterQueue(
            name=name, cohort=f"wco-{i % 3}", namespace_selector={},
            resource_groups=(a.ResourceGroup(("cpu",), (a.FlavorQuotas.build("f", {"cpu": "4"}),)),),
            fair_sharing=a.FairSharing(weight_milli=500 * (1 + i % 3)),
        )
        cache.add_or_update_cluster_queue(cq)
        mgr.add_cluster_queue(cq)
        mgr.add_local_queue(a.LocalQueue(namespace="ns", name=f"lq-{name}", cluster_queue=name))
        for j in range(3):
            pending.append((
                a.Workload(namespace="ns", name=f"fw-{i}-{j}", queue_name=f"lq-{name}",
                           priority=0, creation_time=float(i * 4 + j),
                           pod_sets=(a.PodSet.build("main", 1, {"cpu": "3"}),)),
                name,
            ))
    return a.take_snapshot(cache), pending, cache.flavors


# ---- the dry run's drives ----


def _dryrun_sharded_drain(mesh) -> None:
    """The full production step over the mesh: a multi-cycle drain
    (lowering -> per-CQ queue tensors padded to ``wl`` and placed ->
    the drain's cycles -> one fetch)."""
    from kueue_tpu_torch.core.drain import run_drain

    outcome = run_drain(*drain_case(), mesh=mesh)
    assert outcome.admitted, "sharded drain admitted nothing"
    assert not outcome.fallback


def _dryrun_sharded_preempt_drain(mesh) -> None:
    """The preemption drain over the mesh, its narrow panel widths
    certified by the harness's canary."""
    from kueue_tpu_torch.core.drain import run_drain_preempt

    outcome = run_drain_preempt(*preempt_drain_case(), mesh=mesh)
    assert outcome.admitted, "sharded preempt drain admitted nothing"
    assert outcome.preempted, "sharded preempt drain evicted nothing"
    assert not outcome.fallback


def _dryrun_sharded_fair_search(mesh) -> None:
    """The fair-sharing victim tournament over the mesh: one batched
    launch with the FairProblem head rows padded to ``wl`` and placed."""
    from kueue_tpu_torch.core.preempt_batch import batched_fair_get_targets

    snapshot, items, preemptor = fair_search_case()
    results = batched_fair_get_targets(snapshot, items, preemptor, mesh=mesh)
    assert any(r for r in results), "sharded fair search found no victims"


def _dryrun_sharded_fair_drain(mesh) -> None:
    """The fair-sharing drain over the mesh: per-queue tensors padded
    to ``wl`` and placed, the cohort tournament's node-space inputs
    whole."""
    from kueue_tpu_torch.core.drain import run_drain

    outcome = run_drain(*fair_drain_case(), fair_sharing=True, mesh=mesh)
    assert outcome.admitted, "sharded fair drain admitted nothing"
    assert not outcome.fallback
