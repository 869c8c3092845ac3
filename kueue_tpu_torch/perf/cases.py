"""A small seeded cluster that exercises every branch of the plain
drain, as pure data (a spec dict), plus its builder for this package.

``mixed_spec(seed)`` draws:
- a depth-3 cohort forest (org -> dept -> team -> ClusterQueue) with
  cohort-level quotas and lending limits, a second shallow root, and
  one ClusterQueue without a cohort;
- ClusterQueues with two resource groups (cpu+memory over up to three
  flavors, gpu over up to two), borrowing and lending limits, mixed
  flavorFungibility (whenCanPreempt=Preempt makes PendingFlavors
  retries, some of which never converge and freeze as stuck) and
  reclaimWithinCohort Any/Never (Never reserves capacity when blocked);
- workloads with one to three podsets sharing cells.

The spec format is the one tests/test_solver_path.random_spec uses,
extended with "cohorts" and per-CQ "fungibility" / "reclaim" names, so
the tests can build the same cluster in both packages.
``fair_spec(seed)`` adds fairSharing weights to ``mixed_spec``'s
ClusterQueues for the fair drain ("fair_weight", as
tests/test_solver_path.build_env names it).
``preempt_spec(seed)`` turns ``mixed_spec`` into a preemption case for
the preempt drain: every ClusterQueue's withinClusterQueue,
reclaimWithinCohort and borrowWithinCohort policies, and admitted
low-priority victims ("victims", in tests/test_drain.py's tuple form),
which ``build_cache`` admits.
``fair_preempt_spec(seed)`` is ``preempt_spec`` with fairSharing weights
(0 among them) for the fair-preempt drain and the fair cycle.
``tas_spec(seed)`` is a small Topology-Aware Scheduling case for the TAS
drain, in perf/tas.build_tas_env's spec form (build it with that): two
TAS flavors of different depth over disjoint node pools (``tas-a``:
block/rack/host, ``tas-b``: rack/host), ClusterQueues on each with tight
cpu quota, gangs in all three topology modes, and a plain quota
ClusterQueue riding along whose backlog holds plain workloads and one
topology request on its non-TAS flavor (parked in kernel, ``t_bad``),
and a second plain queue in its cohort that borrows, so blocked plain
heads reserve capacity in the TAS drain's global scan.
``global_batch(edge, seed)`` is a ``cycle_batch`` at one of the unsegmented
cycle's edges (``GLOBAL_EDGES``: a tree beyond one block's shared memory,
one root holding most heads, cohort-less ClusterQueues, depth 7, pads and
no-fit heads, W not a multiple of 32).
``tas_scan_spec(seed)`` reaches the edges of the TAS drain's step scan
(kernel B13's phase 2): four topology resources (cpu, gpu, memory and
the pods slot), gangs spread one pod a host over up to 72 leaves of a
thin flavor, heads of two queues that nominate the same leaves in one
cycle (the later one's re-validation fails on the live usage), ties on
priority and timestamp across queues, and plain queues riding along
that reserve when blocked.
``tas_edge_spec(seed)`` reaches the edges of the TAS drain's placement
(kernel B13a): hosts that non-TAS pods overcommit (negative headroom, so
domains of a split total -1 or less), an Unconstrained gang that fits no
single host and takes a whole flavor, Preferred gangs relaxing to their
flavor's top, two flavors of unequal depth and a gang larger than its
flavor.
``fair_preempt_edge_spec(seed)`` reaches the edges of the fair-preempt
drain's step scan (kernel B11b): ``fair_preempt_spec`` (weight-0 queues,
a one-queue segment, ties in the DRS) with a cohort where two reclaiming
heads target the same victim in one cycle (the later one's targets
overlap the earlier eviction) and a no-reclaim head, blocked, reserves.
``build_scheduler(spec)`` builds the interactive cycle over a spec: the
cache, a QueueManager with one LocalQueue ``lq-<cq>`` per ClusterQueue
holding the spec's workloads, and a ``Scheduler`` with the host
``Preemptor``, as tests/test_solver_path.build_env does.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from kueue_tpu_torch.perf.tas import BLOCK, HOST, RACK


def _quota(rng, lo, hi, unit=""):
    return f"{int(rng.integers(lo, hi))}{unit}"


def mixed_spec(seed: int, cqs_per_team: int = 2, workloads_per_cq: int = 6,
               extra_flavors: int = 0, podsets: int = 3, extra_levels: int = 0) -> dict:
    # podsets: a workload's most pod sets (drawn from 1 on); extra_levels:
    # cohorts chained above the org, deepening its forest, each with a
    # fixed cpu/memory quota of which a part is guaranteed (not lent)
    rng = np.random.default_rng(seed)
    cpu_flavors = ["fa", "fb", "fc"]
    # flavors of a resource no workload requests, in every ClusterQueue
    # with a fixed quota (no draw): they widen the quota tree's cells
    extra = [f"fx-{i}" for i in range(extra_flavors)]
    gpu_flavors = ["gpu-a", "gpu-b"]
    tops = [f"top-{i}" for i in range(extra_levels)]
    top_group = {"resources": ["cpu", "memory"],
                 "flavors": [("fa", {"cpu": "40", "memory": "12Gi"}, None, "10")]}
    cohorts = [{"name": top, "parent": tops[i - 1] if i else None, "groups": [top_group]}
               for i, top in enumerate(tops)]
    cohorts.append({"name": "org", "parent": tops[-1] if tops else None, "groups": []})
    teams = []
    for d in range(2):
        dept = f"dept-{d}"
        cohorts.append({
            "name": dept,
            "parent": "org",
            "groups": [{
                "resources": ["cpu", "memory"],
                "flavors": [
                    ("fa", {"cpu": _quota(rng, 2, 8), "memory": _quota(rng, 4, 16, "Gi")},
                     None, _quota(rng, 0, 4)),
                ],
            }],
        })
        for t in range(2):
            team = f"team-{d}-{t}"
            cohorts.append({"name": team, "parent": dept, "groups": []})
            teams.append(team)
    cohorts.append({"name": "lab", "parent": None, "groups": []})
    teams.append("lab")

    cqs = []
    cq_names = []
    for team in teams + [None]:
        for i in range(cqs_per_team if team is not None else 1):
            name = f"cq-{team or 'solo'}-{i}"
            cq_names.append(name)
            n_cpu = int(rng.integers(1, 4))
            n_gpu = int(rng.integers(1, 3))
            groups = [{
                "resources": ["cpu", "memory"],
                "flavors": [
                    (
                        f,
                        {"cpu": _quota(rng, 4, 12), "memory": _quota(rng, 8, 32, "Gi")},
                        (_quota(rng, 0, 8) if team is not None and rng.random() < 0.5
                         else None),
                        (_quota(rng, 0, 6) if team is not None and rng.random() < 0.4
                         else None),
                    )
                    for f in cpu_flavors[:n_cpu]
                ],
            }, {
                "resources": ["gpu"],
                "flavors": [
                    (f, {"gpu": _quota(rng, 1, 6)},
                     _quota(rng, 0, 4) if team is not None and rng.random() < 0.5 else None,
                     None)
                    for f in gpu_flavors[:n_gpu]
                ],
            }] + ([{"resources": ["ex"], "flavors": [(f, {"ex": "1"}, None, None)
                                                     for f in extra]}] if extra else [])
            cqs.append({
                "name": name,
                "cohort": team,
                "groups": groups,
                "fungibility": (
                    "BORROW" if rng.random() < 0.7 else "TRY_NEXT_FLAVOR",
                    "PREEMPT" if rng.random() < 0.5 else "TRY_NEXT_FLAVOR",
                ),
                "reclaim": "ANY" if rng.random() < 0.3 else "NEVER",
            })

    workloads = []
    t = 0.0
    for name in cq_names:
        for wi in range(workloads_per_cq):
            t += 1.0
            pod_sets = []
            for pp in range(int(rng.integers(1, podsets + 1))):
                req = {"cpu": _quota(rng, 1, 5), "memory": _quota(rng, 1, 8, "Gi")}
                if rng.random() < 0.4:
                    req["gpu"] = _quota(rng, 1, 3)
                pod_sets.append({
                    "name": ["driver", "worker", "aux"][pp] if pp < 3 else f"ps-{pp}",
                    "count": int(rng.integers(1, 3)),
                    "requests": req,
                })
            workloads.append({
                "name": f"wl-{name}-{wi}",
                "queue": f"lq-{name}",
                "cq": name,
                "prio": int(rng.integers(0, 4)) * 10,
                "t": t,
                "pod_sets": pod_sets,
            })
    return {
        "flavors": cpu_flavors + gpu_flavors + extra,
        "cohorts": cohorts,
        "cqs": cqs,
        "workloads": workloads,
    }


def cycle_spec(seed: int, workloads_per_cq: int = 10) -> dict:
    """A small seeded cluster for the interactive cycle: the depth-3
    cohort forest of ``mixed_spec`` with cohort quotas, borrowing and
    lending limits, two resource groups, reclaimWithinCohort Any/Never
    (Never reserves capacity when blocked), some queues preempting
    lower priorities within themselves (the host victim search), and
    single-podset workloads at the default flavorFungibility, so every
    head is one the cycle solver takes."""
    rng = np.random.default_rng(seed)
    spec = mixed_spec(seed, workloads_per_cq=0)
    for cq in spec["cqs"]:
        cq.pop("fungibility")
        cq["reclaim"] = "ANY" if rng.random() < 0.4 else "NEVER"
        if rng.random() < 0.3:
            cq["within"] = "LOWER_PRIORITY"
    t = 0.0
    for cq in spec["cqs"]:
        name = cq["name"]
        for wi in range(workloads_per_cq):
            t += 1.0
            req = {"cpu": _quota(rng, 1, 6), "memory": _quota(rng, 1, 10, "Gi")}
            if rng.random() < 0.4:
                req["gpu"] = _quota(rng, 1, 3)
            spec["workloads"].append({
                "name": f"wl-{name}-{wi}",
                "queue": f"lq-{name}",
                "cq": name,
                "prio": int(rng.integers(0, 4)) * 10,
                "t": t,
                "pod_sets": [{
                    "name": "main", "count": int(rng.integers(1, 4)), "requests": req,
                }],
            })
    return spec


def preempt_spec(seed: int, victims_per_cq: int = 3, workloads_per_cq: int = 5,
                 cqs_per_team: int = 2, extra_flavors: int = 0, podsets: int = 3,
                 extra_levels: int = 0) -> dict:
    """``mixed_spec``'s depth-3 forest (multi-podset workloads, two
    resource groups, limits) as a preemption case: each ClusterQueue
    preempts within itself (LowerPriority or LowerOrNewerEqualPriority)
    or not, reclaims within its cohort (Any, LowerPriority or Never) and
    may borrow within it (LowerPriority, maxPriorityThreshold 10 or
    none), and holds ``victims_per_cq`` admitted workloads of priority
    0-20 on one of its cpu/memory flavors. ``cqs_per_team`` widens the
    org's segment (four teams), ``extra_flavors`` the quota tree's cells,
    ``podsets`` a workload's pod sets, ``extra_levels`` the forest's depth
    (``mixed_spec``)."""
    rng = np.random.default_rng(seed + 2000)
    spec = mixed_spec(seed, cqs_per_team=cqs_per_team, workloads_per_cq=workloads_per_cq,
                      extra_flavors=extra_flavors, podsets=podsets, extra_levels=extra_levels)
    within = ("LOWER_PRIORITY", "LOWER_OR_NEWER_EQUAL_PRIORITY", "NEVER")
    reclaim = ("ANY", "LOWER_PRIORITY", "NEVER")
    victims = []
    t = 0.0
    for cq in spec["cqs"]:
        cq["within"] = within[int(rng.integers(0, 3))]
        cq["reclaim"] = reclaim[int(rng.integers(0, 3))]
        if rng.random() < 0.4:
            cq["bwc"] = 10 if rng.random() < 0.5 else None  # maxPriorityThreshold
        flavors = cq["groups"][0]["flavors"]
        for v in range(victims_per_cq):
            t += 1.0
            f = flavors[int(rng.integers(0, len(flavors)))][0]
            victims.append((
                f"victim-{cq['name']}-{v}", cq["name"], {"cpu": f, "memory": f},
                {"cpu": _quota(rng, 1, 5), "memory": _quota(rng, 1, 8, "Gi")},
                int(rng.integers(0, 3)) * 10, t,
            ))
    spec["victims"] = victims
    return spec


def fair_spec(seed: int, workloads_per_cq: int = 6, cqs_per_team: int = 2) -> dict:
    """``mixed_spec``'s depth-3 cohort forest with fairSharing weights on
    its ClusterQueues (0, 500, 1000 or 2000), for the fair drain: its
    cohort tournament then runs at every level of the forest (team,
    dept, org), weight 0 ranks a borrowing queue last (DRS_MAX), and
    the queues with reclaimWithinCohort Any are preempt-capable and
    route to fallback. ``cqs_per_team`` widens the org's segment (four
    teams)."""
    rng = np.random.default_rng(seed + 1000)
    spec = mixed_spec(seed, cqs_per_team=cqs_per_team, workloads_per_cq=workloads_per_cq)
    weights = (0, 500, 1000, 2000)
    for cq, w in zip(spec["cqs"], rng.permutation(len(spec["cqs"]))):
        cq["fair_weight"] = weights[int(w) % len(weights)]
    return spec


def fair_preempt_spec(seed: int, victims_per_cq: int = 3, workloads_per_cq: int = 4) -> dict:
    """``preempt_spec``'s depth-3 forest (two resources a victim, cpu and
    memory, multi-podset workloads, every preemption policy, the
    default flavorFungibility) with
    fairSharing weights 0, 500, 1000 or 2000 on its ClusterQueues, for
    the fair-preempt drain and the fair cycle: the victim tournament
    then walks three cohort levels, and weight 0 ranks a borrowing
    queue first as a target (DRS_MAX). Both strategy stacks are the
    caller's choice (``fs_strategies``)."""
    rng = np.random.default_rng(seed + 3000)
    spec = preempt_spec(seed, victims_per_cq=victims_per_cq, workloads_per_cq=workloads_per_cq)
    weights = (0, 500, 1000, 2000)
    for cq, w in zip(spec["cqs"], rng.permutation(len(spec["cqs"]))):
        cq["fair_weight"] = weights[int(w) % len(weights)]
        # the default flavorFungibility: no PendingFlavors retry loops
        cq.pop("fungibility", None)
    return spec


def build_cache(spec: dict):
    """(Cache, pending) of this package for a spec; ``pending`` is in
    per-CQ heap order (priority desc, timestamp asc). The spec's
    "victims" are admitted."""
    from kueue_tpu_torch.core.cache import Cache
    from kueue_tpu_torch.core.workload_info import make_admission
    from kueue_tpu_torch.models import (
        BorrowWithinCohort,
        BorrowWithinCohortPolicy,
        ClusterQueue,
        Cohort,
        FairSharing,
        FlavorFungibility,
        FlavorFungibilityPolicy,
        FlavorQuotas,
        Preemption,
        PreemptionPolicy,
        ReclaimWithinCohortPolicy,
        ResourceFlavor,
        ResourceGroup,
        Workload,
        WorkloadConditionType,
    )
    from kueue_tpu_torch.models.workload import PodSet

    def groups_of(gs):
        return tuple(
            ResourceGroup(
                tuple(rg["resources"]),
                tuple(
                    FlavorQuotas.build(f, {r: (v, bl, ll) for r, v in q.items()})
                    for f, q, bl, ll in rg["flavors"]
                ),
            )
            for rg in gs
        )

    cache = Cache()
    for f in spec["flavors"]:
        cache.add_or_update_flavor(ResourceFlavor(name=f))
    for c in spec.get("cohorts", []):
        cache.add_or_update_cohort(
            Cohort(name=c["name"], parent=c.get("parent"),
                   resource_groups=groups_of(c.get("groups", [])))
        )
    for cq in spec["cqs"]:
        kwargs = {}
        if cq.get("fungibility") is not None:
            wb, wp = cq["fungibility"]
            kwargs["flavor_fungibility"] = FlavorFungibility(
                when_can_borrow=FlavorFungibilityPolicy[wb],
                when_can_preempt=FlavorFungibilityPolicy[wp],
            )
        if cq.get("reclaim") is not None or cq.get("within") is not None:
            bwc = BorrowWithinCohort()
            if "bwc" in cq:
                bwc = BorrowWithinCohort(
                    policy=BorrowWithinCohortPolicy.LOWER_PRIORITY,
                    max_priority_threshold=cq["bwc"],
                )
            kwargs["preemption"] = Preemption(
                within_cluster_queue=PreemptionPolicy[cq.get("within", "NEVER")],
                reclaim_within_cohort=ReclaimWithinCohortPolicy[cq.get("reclaim", "NEVER")],
                borrow_within_cohort=bwc,
            )
        if cq.get("preemption") is not None:
            kwargs["preemption"] = cq["preemption"]  # a models.Preemption
        if cq.get("fair_weight") is not None:
            kwargs["fair_sharing"] = FairSharing(weight_milli=int(cq["fair_weight"]))
        cache.add_or_update_cluster_queue(
            ClusterQueue(
                name=cq["name"],
                cohort=cq.get("cohort"),
                namespace_selector={},
                resource_groups=groups_of(cq["groups"]),
                **kwargs,
            )
        )
    for name, cq_name, flavor, qty, prio, t in spec.get("victims", []):
        requests = qty if isinstance(qty, dict) else {"cpu": qty}
        flavors = flavor if isinstance(flavor, dict) else {"cpu": flavor}
        wl = Workload(
            namespace="ns", name=name, queue_name=f"lq-{cq_name}", priority=prio,
            creation_time=t, pod_sets=(PodSet.build("main", 1, requests),),
        )
        wl.admission = make_admission(cq_name, {"main": flavors}, wl)
        wl.set_condition(
            WorkloadConditionType.QUOTA_RESERVED, True, reason="QuotaReserved", now=t,
        )
        cache.add_or_update_workload(wl)
    pending: List[Tuple[object, str]] = []
    for w in spec["workloads"]:
        wl = Workload(
            namespace="ns",
            name=w["name"],
            queue_name=w["queue"],
            priority=w.get("prio", 0),
            creation_time=w["t"],
            pod_sets=tuple(
                PodSet.build(ps["name"], ps["count"], ps["requests"])
                for ps in w["pod_sets"]
            ),
        )
        pending.append((wl, w.get("cq") or w["queue"][len("lq-"):]))
    pending.sort(key=lambda e: (e[1], -e[0].priority, e[0].creation_time))
    return cache, pending


def build_scheduler(spec: dict, device=None, use_solver=True, guard=None, fair_sharing=False,
                    use_preempt_solver=None):
    """(Scheduler, QueueManager, Cache) of this package for a spec, the
    workloads queued in spec order; ``device`` is where the cycle solve
    runs (the card unless "cpu"). ``fair_sharing`` turns on the fair
    admission order and the fair-sharing Preemptor."""
    from kueue_tpu_torch.core.preemption import Preemptor
    from kueue_tpu_torch.core.queue_manager import QueueManager
    from kueue_tpu_torch.core.scheduler import Scheduler
    from kueue_tpu_torch.models import LocalQueue
    from kueue_tpu_torch.utils.clock import FakeClock

    clock = FakeClock(1000.0)
    cache, pending = build_cache(spec)
    mgr = QueueManager(clock=clock)
    for cq in spec["cqs"]:
        mgr.add_cluster_queue(cache.cluster_queues[cq["name"]].model)
        mgr.add_local_queue(
            LocalQueue(namespace="ns", name=f"lq-{cq['name']}", cluster_queue=cq["name"])
        )
    by_name = {wl.name: wl for wl, _ in pending}
    for w in spec["workloads"]:
        mgr.add_or_update_workload(by_name[w["name"]])
    sched = Scheduler(
        queues=mgr,
        cache=cache,
        clock=clock,
        preemptor=Preemptor(clock, enable_fair_sharing=fair_sharing),
        use_solver=use_solver,
        solver_threshold=1,
        use_preempt_solver=use_preempt_solver,
        guard=guard,
        fair_sharing=fair_sharing,
        device=device,
    )
    return sched, mgr, cache


def cycle_batch(seed: int, w: int = 24, k: int = 4, c: int = 5, depth: int = 3,
                n_cq: int = 10, fr: int = 6, drop_steps: bool = False,
                cohortless: float = 0.1, n_pad: int = None) -> dict:
    """A random cycle-solver input as numpy arrays: a cohort forest of
    ``depth`` levels with quotas, lending and borrowing limits (NO_LIMIT
    where unset), leaf usage, and a heads batch of ``w`` rows (a few of
    them pads) with ``k`` candidates of up to ``c`` distinct cells,
    zero-quantity cells, priority and timestamp ties, no_reclaim flags
    and, for odd seeds, nonzero scores. Keys: the encoded-snapshot
    fields (``parent``, ``level_mask``, ``nominal``, ``lending_limit``,
    ``borrowing_limit``, ``local_usage``, ``max_depth``), the
    HeadsBatch fields, ``paths``, ``seg_id``, ``n_segments`` and
    ``n_steps`` (below the largest segment when ``drop_steps``, so
    phase 2 drops ranks). A ClusterQueue but the first is without a
    cohort with probability ``cohortless``. The last ``n_pad`` rows are
    pads (default: an eighth of them, at least one)."""
    from kueue_tpu_torch.ops.assign_kernel import build_paths, build_roots
    from kueue_tpu_torch.ops.quota import NO_LIMIT

    rng = np.random.default_rng(seed)
    # cohorts: a chain of levels, each cohort under one of the level above
    parents_c, level = [], [-1]
    for d in range(depth):
        cur = []
        for _ in range(int(rng.integers(1, 3))):
            parents_c.append(int(rng.choice(level)))
            cur.append(len(parents_c) - 1)
        level = cur
    n_cohort = len(parents_c)
    n = n_cq + n_cohort
    parent = np.full(n, -1, dtype=np.int32)
    for j, p in enumerate(parents_c):
        parent[n_cq + j] = -1 if p < 0 else n_cq + p
    for i in range(n_cq):
        parent[i] = (-1 if (i > 0 and rng.random() < cohortless)
                     else n_cq + int(rng.integers(0, n_cohort)))
    if depth:
        parent[0] = n_cq + level[0]  # one ClusterQueue at the full depth
    dep = np.zeros(n, dtype=np.int32)
    for i in range(n):
        cur = i
        while parent[cur] >= 0:
            dep[i] += 1
            cur = parent[cur]
    max_depth = int(dep.max())
    level_mask = np.stack([dep == d for d in range(max_depth + 1)])
    nominal = rng.integers(0, 40, size=(n, fr)).astype(np.int64)
    nominal[n_cq:] *= rng.random((n_cohort, fr)) < 0.5
    nominal[0, 0] = 64 << 30  # beyond int32
    lend = np.where(rng.random((n, fr)) < 0.35, rng.integers(0, 30, (n, fr)), NO_LIMIT)
    borrow = np.where(rng.random((n, fr)) < 0.35, rng.integers(0, 30, (n, fr)), NO_LIMIT)
    local = np.zeros((n, fr), dtype=np.int64)
    local[:n_cq] = rng.integers(0, 45, size=(n_cq, fr))

    cq_row = rng.integers(0, n_cq, size=w).astype(np.int32)
    n_pad = max(1, w // 8) if n_pad is None else n_pad
    if n_pad:
        cq_row[-n_pad:] = -1
    cells = np.full((w, k, c), -1, dtype=np.int32)
    qty = np.zeros((w, k, c), dtype=np.int64)
    for i in range(w):
        for kk in range(k):
            m = int(rng.integers(1, min(c, fr) + 1))
            cells[i, kk, :m] = rng.choice(fr, size=m, replace=False)
            qty[i, kk, :m] = rng.integers(0, 25, size=m)  # some zero cells
    qty[0, 0, 0] = 1 << 33  # beyond int32
    valid = rng.random((w, k)) < 0.85
    score = (rng.integers(-3, 4, size=(w, k)) if seed % 2 else np.zeros((w, k))).astype(np.int64)
    priority = (rng.integers(0, 3, size=w) * 10).astype(np.int64)
    timestamp = rng.integers(0, 6, size=w).astype(np.int64) * 10**9
    no_reclaim = rng.random(w) < 0.6

    roots = build_roots(parent)
    seg_id = np.full(w, -1, dtype=np.int32)
    live = cq_row >= 0
    uniq, inv = np.unique(roots[cq_row[live]], return_inverse=True)
    seg_id[live] = inv
    biggest = int(np.bincount(inv).max())
    n_steps = max(1, biggest - 2) if drop_steps else biggest
    return {
        "parent": parent,
        "level_mask": level_mask,
        "nominal": nominal,
        "lending_limit": lend.astype(np.int64),
        "borrowing_limit": borrow.astype(np.int64),
        "local_usage": local,
        "max_depth": max_depth,
        "cq_row": cq_row,
        "cells": cells,
        "qty": qty,
        "valid": valid,
        "priority": priority,
        "timestamp": timestamp,
        "no_reclaim": no_reclaim,
        "score": score,
        "paths": build_paths(parent, max_depth),
        "seg_id": seg_id,
        "n_segments": len(uniq),
        "n_steps": n_steps,
    }


def nominate_batch(seed: int, q: int = 24, l: int = 3, p: int = 2, k: int = 4, c: int = 3,
                   g: int = 2, depth: int = 2, n_cq: int = 10, fr: int = 6,
                   scored: bool = True) -> dict:
    """A random input of one drain nomination (kernel drain_nominate) as
    numpy arrays: ``cycle_batch``'s cohort forest (its encoded-snapshot
    fields and ``paths``), ``q`` queues of ``l`` entries with ``p``
    podsets of ``k`` candidates over ``c`` cells in ``g`` resource
    groups (the plan's ``queues_np`` keys), and the drain state it
    meets: ``cursor`` (some past ``qlen``), ``alive`` (a few queues
    retired), ``g_start`` (group walks resumed), ``local`` and ``avail``.
    Candidates draw cells from few flavors, so podsets repeat cells;
    flavor indices and scores (``scored``) tie."""
    enc = cycle_batch(seed, w=8, depth=depth, n_cq=n_cq, fr=fr)
    rng = np.random.default_rng(seed + 7919)
    n = enc["parent"].shape[0]
    cells = np.full((q, l, p, k, c), -1, dtype=np.int32)
    qty = np.zeros((q, l, p, k, c), dtype=np.int64)
    cgrp = np.full((q, l, p, k, c), -1, dtype=np.int8)
    for idx in np.ndindex(q, l, p, k):
        m = int(rng.integers(1, min(c, fr) + 1))
        cells[idx][:m] = rng.choice(fr, size=m, replace=False)
        qty[idx][:m] = rng.integers(0, 20, size=m)  # some zero cells
        cgrp[idx][:m] = rng.integers(0, g, size=m)
    gidx = rng.integers(0, 3, size=(q, l, p, k, g)).astype(np.int32)
    cq_rows = rng.integers(0, n_cq, size=q).astype(np.int32)
    roots = enc["paths"][np.arange(n), (enc["paths"] >= 0).sum(axis=1) - 1]
    uniq, seg_id = np.unique(roots[cq_rows], return_inverse=True)
    qlen = rng.integers(0, l + 1, size=q).astype(np.int32)
    local = enc["local_usage"].copy()
    local[n_cq:] = rng.integers(0, 60, size=(n - n_cq, fr))
    return {
        **enc,
        "queues_np": {
            "cq_rows": cq_rows,
            "seg_id": seg_id.astype(np.int32),
            "qlen": qlen,
            "cells": cells,
            "qty": qty,
            "valid": rng.random((q, l, p, k)) < 0.85,
            "gidx": gidx,
            "glast": gidx == 2,
            "cgrp": cgrp,
            "n_podsets": rng.integers(1, p + 1, size=(q, l)).astype(np.int32),
            "ffb": rng.random(q) < 0.5,
            "ffp": rng.random(q) < 0.5,
            "retry_cap": np.full(q, 3, dtype=np.int32),
            "priority": rng.integers(0, 3, size=(q, l)).astype(np.int64),
            "timestamp": rng.integers(0, 6, size=(q, l)).astype(np.int64),
            "no_reclaim": rng.random(q) < 0.6,
            "score": rng.integers(-1, 2, size=(q, l, p, k)).astype(np.int64) if scored else None,
        },
        "n_segments": len(uniq),
        "cursor": np.minimum(rng.integers(0, l + 1, size=q), qlen).astype(np.int32),
        "alive": rng.random(q) < 0.9,
        "g_start": rng.integers(0, 2, size=(q, p, g)).astype(np.int32),
        "local": local,
        "avail": rng.integers(-5, 40, size=(n, fr)).astype(np.int64),
    }


def nominate_inputs(b: dict, dev, avail=None):
    """(DrainContext, DrainState, CycleBuffers) of a ``nominate_batch``
    on ``dev``: the state and buffers its nomination meets. ``avail``
    (int64[N, FR]) replaces the batch's random availability."""
    import torch

    from kueue_tpu_torch import interop
    from kueue_tpu_torch.ops import drain_kernel as dk

    tree, queues, local, paths = interop.drain_inputs(b, b["queues_np"], dev)
    q = queues.qlen.shape[0]
    ctx = dk.DrainContext.build(tree, queues, paths, b["n_segments"], q, 1,
                                seg_id=b["queues_np"]["seg_id"])
    state = dk.DrainState.initial(local, queues, 1)
    for name in ("local", "cursor", "g_start", "alive"):
        getattr(state, name).copy_(torch.as_tensor(b[name]))
    state.done.zero_()
    buf = dk.CycleBuffers.empty(local, queues)
    buf.usage.zero_()
    buf.avail.copy_(torch.as_tensor(b["avail"]) if avail is None else avail)
    return ctx, state, buf


def quota_forest(seed: int, depth: int = 3, big: int = 300, n_small: int = 40,
                 fr: int = 37) -> dict:
    """A random cohort forest for the quota recurrences (kernel 1) as
    numpy arrays: one root subtree of ``big`` nodes (0: none) reaching
    ``depth`` levels below its root, beside ``n_small`` root subtrees of
    one to six nodes of random depth up to ``depth``, node ids shuffled;
    nominal quotas (some beyond int32), lending and borrowing limits
    (NO_LIMIT where unset), and usage on every node. Keys: ``parent``,
    ``level_mask``, ``nominal``, ``lending_limit``, ``borrowing_limit``,
    ``local_usage``, ``max_depth``."""
    from kueue_tpu_torch.ops.quota import NO_LIMIT

    rng = np.random.default_rng(seed)
    parent, dep = [], []

    def add(p):
        parent.append(p)
        dep.append(0 if p < 0 else dep[p] + 1)
        return len(parent) - 1

    def subtree(size, reach):
        nodes = [add(-1)]
        for _ in range(reach):  # a chain to the full depth
            nodes.append(add(nodes[-1]))
        while len(nodes) < size:
            nodes.append(add(int(rng.choice([x for x in nodes if dep[x] < depth]))))

    if big:
        subtree(big, depth)
    for _ in range(n_small):
        reach = int(rng.integers(0, depth + 1))
        subtree(int(rng.integers(reach + 1, reach + 7)), reach)
    n = len(parent)
    perm = rng.permutation(n)
    par = np.full(n, -1, dtype=np.int32)
    d = np.zeros(n, dtype=np.int64)
    for i in range(n):
        par[perm[i]] = -1 if parent[i] < 0 else perm[parent[i]]
        d[perm[i]] = dep[i]
    max_depth = int(d.max())
    nominal = rng.integers(0, 50, size=(n, fr)).astype(np.int64)
    nominal[rng.random((n, fr)) < 0.02] = 40 << 30  # beyond int32
    lend = np.where(rng.random((n, fr)) < 0.35, rng.integers(0, 40, (n, fr)), NO_LIMIT)
    borrow = np.where(rng.random((n, fr)) < 0.35, rng.integers(0, 40, (n, fr)), NO_LIMIT)
    return {
        "parent": par,
        "level_mask": np.stack([d == k for k in range(max_depth + 1)]),
        "nominal": nominal,
        "lending_limit": lend.astype(np.int64),
        "borrowing_limit": borrow.astype(np.int64),
        "local_usage": rng.integers(0, 60, size=(n, fr)).astype(np.int64),
        "max_depth": max_depth,
    }


def phase2_batch(seed: int, q: int = 48, depth: int = 1, big: float = 0.0, fr: int = 17,
                 drop: bool = False, l: int = 3, p: int = 2, k: int = 3, c: int = 3,
                 g: int = 2) -> dict:
    """A random input of one plain drain cycle shaped for phase 2
    (kernel drain_phase2): ``nominate_batch``'s keys with ``q`` queues
    on ``q`` distinct ClusterQueues, most of them nominated (a third of
    the nodes hold six times the quota), podsets repeating cells, priority
    and timestamp ties and preempt-mode heads with and without
    reclaimWithinCohort Never. ``big``: that share of the ClusterQueues
    is moved under one root cohort (depth 1) and the rest lose their
    cohort: one segment outgrows the kernel's shared rows where enough
    of it is nominated, beside segments of one queue;
    ``drop``: n_steps is half the largest segment, so phase 2 drops
    ranks; ``depth`` 6 gives paths of 7 levels. Adds ``n_steps``."""
    from kueue_tpu_torch.ops.assign_kernel import build_paths

    b = nominate_batch(seed, q=q, l=l, p=p, k=k, c=c, g=g, depth=depth, n_cq=q, fr=fr)
    rng = np.random.default_rng(seed + 104729)
    parent = b["parent"].copy()
    n = parent.shape[0]
    if big:
        roots = [i for i in range(q, n) if parent[i] < 0]
        moved = rng.random(q) < big
        parent[:q] = np.where(moved, roots[0], -1)
    dep = np.zeros(n, dtype=np.int64)
    for i in range(n):
        cur = i
        while parent[cur] >= 0:
            dep[i] += 1
            cur = parent[cur]
    max_depth = int(dep.max())
    paths = build_paths(parent, max_depth)
    qn = dict(b["queues_np"])
    qn["cq_rows"] = rng.permutation(q).astype(np.int32)
    # most heads nominate: queues with entries, cursors inside them, a
    # third of the nodes with six times the quota, a third of the usage
    qn["qlen"] = np.maximum(qn["qlen"], 1)
    cursor = np.where(rng.random(q) < 0.9, rng.integers(0, qn["qlen"]), qn["qlen"])
    nominal = np.where((rng.random(n) < 0.3)[:, None], 6 * b["nominal"], b["nominal"])
    roots = paths[np.arange(n), (paths >= 0).sum(axis=1) - 1]
    uniq, seg_id = np.unique(roots[qn["cq_rows"]], return_inverse=True)
    qn["seg_id"] = seg_id.astype(np.int32)
    biggest = int(np.bincount(seg_id).max())
    return {
        **b,
        "parent": parent,
        "level_mask": np.stack([dep == d for d in range(max_depth + 1)]),
        "max_depth": max_depth,
        "paths": paths,
        "queues_np": qn,
        "cursor": cursor.astype(np.int32),
        "nominal": nominal,
        "local": b["local"] // 3,
        "n_segments": len(uniq),
        "n_steps": max(1, biggest // 2) if drop else biggest,
    }


def plan_batch(seed: int, s: int = 5, drop_steps: bool = False, keep_priority=(),
               all_tied: bool = False, all_nofit: bool = False, **kw) -> dict:
    """A random input of the planner's scenario-batched solve (kernel
    B14), as numpy arrays in ``interop.plan_inputs``' form: scenario 0
    is ``cycle_batch(seed)`` itself and every other scenario varies a
    few cells of nominal quota, lending and borrowing limits (NO_LIMIT
    set and lifted) and leaf usage, some heads' priorities (so the entry
    order moves) and, in odd scenarios, the candidate scores. Keys:
    ``parent``, ``level_mask``, the [S, ...] stacks (``nominal_s``,
    ``lending_s``, ``borrowing_s``, ``usage_s``, ``priority_s``,
    ``score_s``), ``heads`` (the HeadsBatch fields), ``paths``,
    ``seg_id``, ``n_segments`` and ``n_steps``. The scenarios in
    ``keep_priority`` keep scenario 0's priorities (a sweep's shared
    row beside the moved ones); ``all_tied`` gives every head the same
    priority and timestamp in every scenario (the index orders them);
    ``all_nofit`` leaves every head without a valid candidate (one
    class). Other keywords go to ``cycle_batch``."""
    from kueue_tpu_torch.ops.quota import NO_LIMIT

    b = cycle_batch(seed, drop_steps=drop_steps, **kw)
    rng = np.random.default_rng(seed + 52000)
    n, fr = b["nominal"].shape
    w, k = b["valid"].shape
    heads = {f: b[f] for f in ("cq_row", "cells", "qty", "valid", "priority", "timestamp",
                               "no_reclaim", "score")}

    def stack(a):
        return np.repeat(a[None], s, axis=0)

    nominal_s, usage_s = stack(b["nominal"]), stack(b["local_usage"])
    lending_s, borrowing_s = stack(b["lending_limit"]), stack(b["borrowing_limit"])
    priority_s, score_s = stack(b["priority"]), stack(b["score"])
    for si in range(1, s):
        cells = rng.random((n, fr)) < 0.2
        nominal_s[si] = np.where(
            cells, np.maximum(0, nominal_s[si] + rng.integers(-15, 30, (n, fr))), nominal_s[si]
        )
        usage_s[si][cells & (usage_s[si] > 0)] += 3  # leaf rows only
        for lim in (lending_s, borrowing_s):
            flip = rng.random((n, fr)) < 0.15
            lim[si] = np.where(
                flip, np.where(lim[si] < NO_LIMIT, NO_LIMIT, rng.integers(0, 30, (n, fr))),
                lim[si],
            )
        moved = rng.random(w) < 0.3
        delta = rng.integers(-20, 25, w)
        if si not in keep_priority:
            priority_s[si] = np.where(moved, priority_s[si] + delta, priority_s[si])
        if si % 2:
            score_s[si] = rng.integers(-3, 4, size=(w, k))
    if all_tied:
        priority_s[:] = 0
        heads["timestamp"] = np.zeros_like(heads["timestamp"])
    if all_nofit:
        heads["valid"] = np.zeros_like(heads["valid"])
    return {
        "parent": b["parent"], "level_mask": b["level_mask"],
        "nominal_s": nominal_s, "lending_s": lending_s, "borrowing_s": borrowing_s,
        "usage_s": usage_s, "priority_s": priority_s, "score_s": score_s,
        "heads": heads, "paths": b["paths"], "seg_id": b["seg_id"],
        "n_segments": b["n_segments"], "n_steps": b["n_steps"],
    }


# plan_batch's arguments at the edges of plan_phase2's design (one tile
# or several, the index deciding ties, shared and own priority rows, one
# class, dropped ranks and pads, a root whose walked paths hold more
# nodes than a walk block stages)
PLAN_EDGES = {
    "W=1": dict(seed=0, s=3, w=1, n_pad=0),
    "W=37": dict(seed=1, s=4, w=37),
    "W=4099, tiles and merges": dict(seed=2, s=3, w=4099, n_cq=24, keep_priority=(1,)),
    "ties": dict(seed=3, s=4, all_tied=True),
    "shared and own priority rows": dict(seed=4, s=6, keep_priority=(1, 3, 4)),
    "one class": dict(seed=5, s=3, all_nofit=True),
    "dropped ranks and pads": dict(seed=6, s=5, drop_steps=True, w=40),
    "past the walk's rows": dict(seed=7, s=3, w=96, n_cq=40, fr=64, c=6, cohortless=0.0),
}

# preempt_spec's arguments at the edges of drain_preempt_phase2's design,
# with the drain's: overlapping targets, restored rows, both reserves,
# other queues' victims at Cv >= 4 (16 ClusterQueues in the org); a pool
# of 1203 slots past a block's shared memory (its victims and its pending
# entries, under a max_victims of 2048, over 4 cycles); 12 ClusterQueues
# a team with 56 more flavors of a resource no workload requests, whose
# org segment's rows (M = 64 nodes, FR = 64 cells) are past it too
PREEMPT_EDGES = {
    "step edges": (dict(seed=4, cqs_per_team=4), {}),
    "wide pool": (dict(seed=4, workloads_per_cq=600), dict(max_victims=2048, max_cycles=4)),
    "wide rows": (dict(seed=4, cqs_per_team=12, extra_flavors=56), dict(max_cycles=6)),
}


# preempt_spec's arguments, with the drain's, at the edges of the
# preempt cycle's end (drain_preempt_motion, B10c): a drain that runs to
# the stagnation guard (527 cycles at a window of 2: untrusted searches
# freezing their queues, retry budgets reaching their caps, evictions
# reactivating parked entries, then no progress for 2 x max(retry cap)
# cycles); a drain ended by max_cycles with live queues; queues of 40
# entries, one of which sees its segment release slots while an entry
# before position 32 is parked and its cursor is past 32 (cycle 43), so
# the statuses' second run of 32 is updated with the first. The
# fair-panel fill is the fair-preempt drain's: ``fair_preempt_spec(1)``
# at 32 cycles.
MOTION_EDGES = {
    "stagnation": (dict(seed=0, cqs_per_team=4), dict(search_width=2)),
    "max_cycles": (dict(seed=3), dict(search_width=2, max_cycles=24)),
    "past 32 entries": (dict(seed=6, workloads_per_cq=40), dict(search_width=8, max_cycles=48)),
}

# preempt_spec's arguments, with the drain's, at the edges of the victim
# search (drain_preempt_search, B10a): ladder cases a, b and c, the
# borrowWithinCohort threshold, windows of 2 that truncate (a miss, a
# hit, an attempt-1 miss tainting an attempt-2 success) and attempt 2
# succeeding; a forest two levels deeper (paths of six levels, past the
# four the ladder holds in registers) at a window of 32, where nothing
# truncates; and the widest shape the kernel takes, four pod sets of
# eight cells (P*C = 32) at a window of 512, whose staged candidates
# exceed a block's shared memory, so the ladder reads them from the pool
# in device memory, on the deeper forest too (both cut at 24 cycles:
# untruncated, their heads spin ~1500).
SEARCH_EDGES = {
    "window of 2": (dict(seed=8), dict(search_width=2)),
    "deep forest": (dict(seed=8, extra_levels=2), dict(search_width=32, max_cycles=24)),
    "widest shape": (dict(seed=8, podsets=4, extra_levels=2),
                     dict(search_width=512, max_cells=8, max_cycles=24)),
}


def global_wide_batch(seed: int, w: int) -> dict:
    """A ``cycle_batch`` of ``w`` heads past the classes and member lists
    a cycle_global block holds (W >= 17,500 at C = 3, FR = 17, depth 1):
    300 ClusterQueues in a depth-1 forest."""
    return cycle_batch(seed, w=w, k=4, c=3, depth=1, n_cq=300, fr=17)


def plan_wide_batch(seed: int, w: int = 940_000, s: int = 2, n_steps: int = 48) -> dict:
    """A ``plan_batch`` of ``w`` heads in one or two root segments, past
    both the bitmap of positions (W > ~925,000) and a segment's positions
    (> ~57,800 heads) a plan_phase2 block holds: the heads of a 512-head
    batch over 40 ClusterQueues drawn ``w`` times (the generator is
    vectorized), each scenario's priority row moved at random, and
    ``n_steps`` walked heads a segment (the plain version walks that
    many steps)."""
    from kueue_tpu_torch.ops.assign_kernel import build_roots

    b = plan_batch(seed, s=s, w=512, n_cq=40, depth=1, cohortless=0.0, n_pad=0)
    rng = np.random.default_rng(seed + 73000)
    idx = rng.integers(0, 512, size=w)
    heads = {f: np.ascontiguousarray(v[idx]) for f, v in b["heads"].items()}
    heads["timestamp"] = rng.integers(0, 50, size=w).astype(np.int64) * 10**9
    heads["cq_row"][-64:] = -1  # pads
    priority_s = b["priority_s"][:, idx] + rng.integers(0, 3, size=(s, w)) * 10
    roots = build_roots(b["parent"])
    cq = heads["cq_row"]
    seg_id = np.full(w, -1, dtype=np.int32)
    uniq, inv = np.unique(roots[cq[cq >= 0]], return_inverse=True)
    seg_id[cq >= 0] = inv
    return {**b, "heads": heads, "priority_s": priority_s,
            "score_s": np.ascontiguousarray(b["score_s"][:, idx]), "seg_id": seg_id,
            "n_segments": len(uniq), "n_steps": n_steps}


def tas_spec(seed: int, n_tas_cq: int = 4, workloads_per_cq: int = 5) -> dict:
    """The small two-flavor TAS case (module docstring): 24 hosts of
    8 cpu in tas-a (2 blocks x 3 racks x 4), 12 in tas-b (4 racks x 3),
    even ClusterQueues on tas-a, odd on tas-b, each with 30 cpu; the
    plain queues ``cq-plain`` (12 cpu) and ``cq-lend`` (4 cpu) in one
    cohort on the plain flavor."""
    rng = np.random.default_rng(seed + 81000)
    nodes = []
    for b in range(2):
        for r in range(3):
            for h in range(4):
                nodes.append((f"a-{b}-{r}-{h}", {"pool": "a", BLOCK: f"b{b}", RACK: f"b{b}-r{r}",
                                                 HOST: f"ha-{b}-{r}-{h}"},
                              {"cpu": 8000, "pods": 32}))
    for r in range(4):
        for h in range(3):
            nodes.append((f"b-{r}-{h}", {"pool": "b", RACK: f"fr{r}", HOST: f"hb-{r}-{h}"},
                          {"cpu": 8000, "pods": 32}))
    cqs = [(f"cq-{i}", "tas-a" if i % 2 == 0 else "tas-b", "30") for i in range(n_tas_cq)]
    # two plain queues sharing a cohort: cq-lend's backlog borrows
    # cq-plain's idle quota, so cq-plain's later heads are blocked in
    # preempt mode and reserve (reclaimWithinCohort Never)
    cqs += [("cq-plain", "plain", "12", "plain-co"), ("cq-lend", "plain", "4", "plain-co")]
    modes = ("Required", "Preferred", "Unconstrained")
    workloads = []
    t = 0.0
    for i in range(n_tas_cq):
        levels = [BLOCK, RACK, RACK, HOST] if i % 2 == 0 else [RACK, RACK, HOST]
        for w in range(workloads_per_cq):
            t += 1.0
            workloads.append(dict(
                name=f"wl-{i}-{w}", cq=f"cq-{i}", count=int(rng.integers(1, 13)),
                cpu=str(int(rng.integers(1, 4))), mode=modes[int(rng.integers(0, 3))],
                level=levels[int(rng.integers(0, len(levels)))],
                prio=int(rng.integers(0, 3)) * 10, t=t,
            ))
    for w in range(3):
        t += 1.0
        workloads.append(dict(name=f"lend-{w}", cq="cq-lend", count=1, cpu="5", mode=None,
                              level=None, prio=0, t=t))
    for w in range(workloads_per_cq):
        t += 1.0
        bad = w == 1
        workloads.append(dict(
            name=f"plain-{w}", cq="cq-plain", count=int(rng.integers(1, 4)),
            cpu=str(int(rng.integers(1, 4))), mode="Required" if bad else None,
            level=RACK if bad else None, prio=int(rng.integers(0, 3)) * 10, t=t,
        ))
    return {
        "topologies": {"deep": (BLOCK, RACK, HOST), "flat": (RACK, HOST)},
        "flavors": [("tas-a", "deep", {"pool": "a"}), ("tas-b", "flat", {"pool": "b"}),
                    ("plain", None, {})],
        "nodes": nodes,
        "cqs": cqs,
        "workloads": workloads,
    }


def tas_edge_spec(seed: int) -> dict:
    """The TAS placement's edge case (module docstring), in
    perf/tas.build_tas_env's spec form. ``tas-a``: 2 blocks x 3 racks x
    4 hosts of 4 cpu and 8 pods, where non-TAS pods use 4, 5 or 6 cpu of
    some hosts (0, -1 or -2 one-cpu pods left): in each block one rack
    totals exactly -1, one -3 and one 16 (the block 12), their order
    drawn from the seed; ``tas-b``: 3 racks x 3 hosts of 2 cpu and 4
    pods, one level shallower. cq-a (tas-a) queues, in this order, a
    Preferred gang at the host level of 20 pods (no block holds it: the
    take at the flavor's top, over both blocks, then racks at 16, -1 and
    -3), a Required gang of 5 at a block (its racks split with the -1 and
    -3 ones), an Unconstrained gang of 6 (no host holds it), a Required
    gang of 3 at a rack and one of 200 (larger than the flavor: parked);
    cq-b (tas-b) Preferred gangs at the host level of 5 (one rack) and 7
    (the take at the flavor's top, the rack level), then an
    Unconstrained gang of 6, the rest of the flavor, over every host
    with room."""
    rng = np.random.default_rng(seed + 85000)
    nodes = []
    kinds = [(5000, 4000, 4000, 4000), (6000, 5000, 4000, 4000), (0, 0, 0, 0)]
    for b in range(2):
        for r, k in enumerate(rng.permutation(3)):
            for h, used in enumerate(kinds[int(k)]):
                nodes.append((f"a-{b}-{r}-{h}", {"pool": "a", BLOCK: f"b{b}",
                                                 RACK: f"b{b}-r{r}", HOST: f"ha-{b}-{r}-{h}"},
                              {"cpu": 4000, "pods": 8}, {"cpu": used} if used else {}))
    for r in range(3):
        for h in range(3):
            nodes.append((f"b-{r}-{h}", {"pool": "b", RACK: f"fr{r}", HOST: f"hb-{r}-{h}"},
                          {"cpu": 2000, "pods": 4}))
    cqs = [("cq-a", "tas-a", "400"), ("cq-b", "tas-b", "400")]
    gangs = [("cq-a", 20, "Preferred", HOST, 20), ("cq-a", 5, "Required", BLOCK, 20),
             ("cq-a", 6, "Unconstrained", None, 10), ("cq-a", 3, "Required", RACK, 10),
             ("cq-a", 200, "Required", BLOCK, 0),
             ("cq-b", 5, "Preferred", HOST, 20), ("cq-b", 7, "Preferred", HOST, 20),
             ("cq-b", 6, "Unconstrained", None, 10)]
    workloads = [dict(name=f"wl-{t}", cq=cq, count=count, cpu="1", mode=mode, level=level,
                      prio=prio, t=float(t))
                 for t, (cq, count, mode, level, prio) in enumerate(gangs)]
    return {
        "topologies": {"deep": (BLOCK, RACK, HOST), "flat": (RACK, HOST)},
        "flavors": [("tas-a", "deep", {"pool": "a"}), ("tas-b", "flat", {"pool": "b"})],
        "nodes": nodes,
        "cqs": cqs,
        "workloads": workloads,
    }


def fair_preempt_edge_spec(seed: int) -> dict:
    """The fair-preempt step scan's edge case (module docstring):
    ``fair_preempt_spec(seed)`` plus a root cohort ``ovl`` over four
    ClusterQueues of 2 cpu in flavor fa: ``ovl-hog`` (no preemption) holds
    one 6-cpu victim, borrowing 4; ``ovl-a`` and ``ovl-b`` (reclaim Any)
    each queue a 2-cpu workload at one priority and timestamp, so both
    target the hog's one victim in the same cycle and tie in the DRS;
    ``ovl-c`` (weight 0, within LowerPriority, reclaim Never) holds a
    1-cpu victim and queues a 4-cpu workload its own victim cannot make
    room for: blocked in preempt mode, it reserves."""
    spec = fair_preempt_spec(seed)
    spec["cohorts"].append({"name": "ovl", "parent": None, "groups": []})

    def cq(name, within, reclaim, weight):
        return {"name": name, "cohort": "ovl", "within": within, "reclaim": reclaim,
                "fair_weight": weight,
                "groups": [{"resources": ["cpu", "memory"],
                            "flavors": [("fa", {"cpu": "2", "memory": "64Gi"}, None, None)]}]}

    spec["cqs"] += [cq("ovl-hog", "NEVER", "NEVER", 1000), cq("ovl-a", "NEVER", "ANY", 1000),
                    cq("ovl-b", "NEVER", "ANY", 1000),
                    cq("ovl-c", "LOWER_PRIORITY", "NEVER", 0)]
    t = max(w["t"] for w in spec["workloads"]) + 1.0
    fa = {"cpu": "fa", "memory": "fa"}
    spec["victims"] += [("ovl-hog-v", "ovl-hog", fa, {"cpu": "6", "memory": "1Gi"}, 0, t),
                        ("ovl-c-v", "ovl-c", fa, {"cpu": "1", "memory": "1Gi"}, 0, t)]
    for name, cpu, prio in (("ovl-a", "2", 10), ("ovl-b", "2", 10), ("ovl-c", "4", 20)):
        spec["workloads"].append({
            "name": f"wl-{name}", "queue": f"lq-{name}", "cq": name, "prio": prio,
            "t": t + 1.0,
            "pod_sets": [{"name": "main", "count": 1,
                          "requests": {"cpu": cpu, "memory": "1Gi"}}],
        })
    return spec


# the unsegmented cycle's edges (kernel B3', cycle_global): ``global_batch``
GLOBAL_EDGES = ("beyond-shared-memory", "one-root", "cohortless", "depth-7",
                "pads-and-no-fit", "w-37")


def global_batch(edge: str, seed: int) -> dict:
    """A ``cycle_batch`` at one of cycle_global's edges (seed 0 or 1):
    3000 ClusterQueues x FR 12, a usage tree beyond one block's shared
    memory; one root cohort over all but a few of 200 heads (depth 1);
    ClusterQueues mostly without a cohort; paths of 8 levels; pads and
    every fifth head asking more than any ClusterQueue holds (no-fit);
    W = 37."""
    if edge == "beyond-shared-memory":
        return cycle_batch(seed, w=8, n_cq=3000, fr=12)
    if edge == "one-root":  # seeds 1 and 6 draw one root cohort
        return cycle_batch((1, 6)[seed], w=200, k=4, c=8, depth=1, n_cq=60, fr=17,
                           cohortless=0.02)
    if edge == "cohortless":
        return cycle_batch(seed, w=64, depth=1, n_cq=40, cohortless=0.9)
    if edge == "depth-7":
        return cycle_batch(seed, w=48, depth=7, n_cq=16)
    if edge == "pads-and-no-fit":
        b = cycle_batch(seed, w=40, n_cq=14)
        b["qty"][::5] = np.where(b["cells"][::5] >= 0, 1 << 40, 0)
        return b
    if edge == "w-37":
        return cycle_batch(seed, w=37, n_cq=12)
    raise ValueError(f"no cycle_global edge {edge!r}")


def tas_scan_spec(seed: int, gangs_per_cq: int = 4) -> dict:
    """The TAS step scan's edge case (module docstring), in
    perf/tas.build_tas_env's spec form. ``tas-a``: 2 blocks x 3 racks x 6
    hosts of 8 cpu, 4 gpu, 32 GiB and 32 pods; ``tas-t``: 4 racks x 24
    hosts of one pod each. cq-0 and cq-2 on tas-a ask for cpu, gpu and
    memory; cq-1 and cq-3 on tas-t for cpu and memory, their gangs
    Unconstrained or Preferred at a rack, the first of each of 40-72
    pods at one timestamp and priority, so both nominate the same
    leaves; the plain cq-plain and cq-lend share a cohort as in
    ``tas_spec``."""
    rng = np.random.default_rng(seed + 83000)
    gib = 1 << 30
    nodes = []
    for b in range(2):
        for r in range(3):
            for h in range(6):
                nodes.append((f"a-{b}-{r}-{h}", {"pool": "a", BLOCK: f"b{b}", RACK: f"b{b}-r{r}",
                                                 HOST: f"ha-{b}-{r}-{h}"},
                              {"cpu": 8000, "example.com/gpu": 4, "memory": 32 * gib,
                               "pods": 32}))
    for r in range(4):
        for h in range(24):
            nodes.append((f"t-{r}-{h}", {"pool": "t", RACK: f"tr{r}", HOST: f"ht-{r}-{h}"},
                          {"cpu": 4000, "memory": 8 * gib, "pods": 1}))
    deep = {"cpu": "80", "example.com/gpu": "40", "memory": "320Gi"}
    thin = {"cpu": "200", "memory": "400Gi"}
    cqs = [(f"cq-{i}", "tas-a" if i % 2 == 0 else "tas-t", deep if i % 2 == 0 else thin)
           for i in range(4)]
    cqs += [("cq-plain", "plain", "12", "plain-co"), ("cq-lend", "plain", "4", "plain-co")]
    workloads = []
    t = 0.0
    for w in range(gangs_per_cq):
        t += 1.0
        prio = int(rng.integers(0, 2)) * 10
        for i in range(4):
            # every queue's w-th gang at one timestamp and priority: ties
            # broken by the queue index
            name = f"wl-{i}-{w}"
            if i % 2 == 0:
                workloads.append(dict(
                    name=name, cq=f"cq-{i}", count=int(rng.integers(2, 13)),
                    cpu=str(int(rng.integers(1, 3))),
                    requests={"example.com/gpu": str(int(rng.integers(0, 2))),
                              "memory": f"{int(rng.integers(1, 5))}Gi"},
                    mode=("Required", "Preferred")[int(rng.integers(0, 2))],
                    level=(BLOCK, RACK, HOST)[int(rng.integers(0, 3))], prio=prio, t=t))
            else:
                count = int(rng.integers(40, 73)) if w == 0 else int(rng.integers(4, 30))
                workloads.append(dict(
                    name=name, cq=f"cq-{i}", count=count, cpu="1",
                    requests={"memory": f"{int(rng.integers(1, 5))}Gi"},
                    mode=("Unconstrained", "Preferred")[int(rng.integers(0, 2))] if w else
                    "Unconstrained", level=RACK, prio=prio, t=t))
    for w in range(3):
        t += 1.0
        workloads.append(dict(name=f"lend-{w}", cq="cq-lend", count=1, cpu="5", mode=None,
                              level=None, prio=0, t=t))
    for w in range(gangs_per_cq):
        t += 1.0
        workloads.append(dict(name=f"plain-{w}", cq="cq-plain", count=int(rng.integers(1, 4)),
                              cpu=str(int(rng.integers(1, 4))), mode=None, level=None,
                              prio=int(rng.integers(0, 3)) * 10, t=t))
    return {
        "topologies": {"deep": (BLOCK, RACK, HOST), "thin": (RACK, HOST)},
        "flavors": [("tas-a", "deep", {"pool": "a"}), ("tas-t", "thin", {"pool": "t"}),
                    ("plain", None, {})],
        "nodes": nodes,
        "cqs": cqs,
        "workloads": workloads,
    }


def rescore_fleet(rng, w: int = None, c: int = None, invalid: float = 0.25,
                  n_degraded: int = None, wide_rotation: bool = False,
                  current_past: bool = False) -> dict:
    """A random input of the federation's global rescore (kernel B15),
    as numpy arrays named as ``ops.global_kernel.rescore_pairs`` takes
    them: heterogeneous forecasts (instant fits, deep queues, values
    past the 30-bit cap up to 2^40, deliberate ties so the score and
    rotation tie-breaks engage), scores beyond +-2^20, ``invalid`` of
    the pairs unscorable, ``n_degraded`` degraded columns with a
    penalty (none when None and the mask omitted), rotations that are
    negative or >= C with ``wide_rotation``, and current columns up to
    C + 2 with ``current_past``. W and C are drawn (W in [0, 12), C in
    [1, 9)) when not given, as the JAX package's own parity test draws
    them."""
    w = int(rng.integers(0, 12)) if w is None else w
    c = int(rng.integers(1, 9)) if c is None else c
    tta = rng.choice([0, 1, 999, 60_000, 600_000, 10**9, 2**40], size=(w, c)).astype(np.int64)
    tta += rng.integers(0, 3, size=(w, c)) * (tta < 10**9)
    score = rng.integers(-(2**22), 2**22, size=(w, c)).astype(np.int64)
    score[rng.random((w, c)) < 0.3] = 0
    valid = rng.random((w, c)) >= invalid
    hi = c + 3 if current_past else c
    current = rng.integers(-1, hi, size=w).astype(np.int32)
    if wide_rotation:
        rotation = rng.integers(-(2**31), 2**31 - 1, size=w).astype(np.int32)
    else:
        rotation = (rng.integers(0, 2**31, size=w) % c).astype(np.int32)
    out = {
        "tta_ms": tta, "score": score, "valid": valid, "current": current,
        "rotation": rotation,
        "hysteresis_ms": int(rng.choice([0, 1, 30_000, 600_000])),
    }
    if n_degraded is not None:
        degraded = np.zeros(c, dtype=bool)
        degraded[rng.permutation(c)[:n_degraded]] = True
        out["degraded"] = degraded
        out["degraded_penalty_ms"] = int(rng.choice([1, 120_000, 2**29, 2**31]))
    return out
