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
``build_scheduler(spec)`` builds the interactive cycle over a spec: the
cache, a QueueManager with one LocalQueue ``lq-<cq>`` per ClusterQueue
holding the spec's workloads, and a ``Scheduler`` with the host
``Preemptor``, as tests/test_solver_path.build_env does.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _quota(rng, lo, hi, unit=""):
    return f"{int(rng.integers(lo, hi))}{unit}"


def mixed_spec(seed: int, cqs_per_team: int = 2, workloads_per_cq: int = 6) -> dict:
    rng = np.random.default_rng(seed)
    cpu_flavors = ["fa", "fb", "fc"]
    gpu_flavors = ["gpu-a", "gpu-b"]
    cohorts = [{"name": "org", "parent": None, "groups": []}]
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
            }]
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
            for pp in range(int(rng.integers(1, 4))):
                req = {"cpu": _quota(rng, 1, 5), "memory": _quota(rng, 1, 8, "Gi")}
                if rng.random() < 0.4:
                    req["gpu"] = _quota(rng, 1, 3)
                pod_sets.append({
                    "name": ["driver", "worker", "aux"][pp],
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
        "flavors": cpu_flavors + gpu_flavors,
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


def fair_spec(seed: int, workloads_per_cq: int = 6) -> dict:
    """``mixed_spec``'s depth-3 cohort forest with fairSharing weights on
    its ClusterQueues (0, 500, 1000 or 2000), for the fair drain: its
    cohort tournament then runs at every level of the forest (team,
    dept, org), weight 0 ranks a borrowing queue last (DRS_MAX), and
    the queues with reclaimWithinCohort Any are preempt-capable and
    route to fallback."""
    rng = np.random.default_rng(seed + 1000)
    spec = mixed_spec(seed, workloads_per_cq=workloads_per_cq)
    weights = (0, 500, 1000, 2000)
    for cq, w in zip(spec["cqs"], rng.permutation(len(spec["cqs"]))):
        cq["fair_weight"] = weights[int(w) % len(weights)]
    return spec


def build_cache(spec: dict):
    """(Cache, pending) of this package for a spec; ``pending`` is in
    per-CQ heap order (priority desc, timestamp asc)."""
    from kueue_tpu_torch.core.cache import Cache
    from kueue_tpu_torch.models import (
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
            kwargs["preemption"] = Preemption(
                within_cluster_queue=PreemptionPolicy[cq.get("within", "NEVER")],
                reclaim_within_cohort=ReclaimWithinCohortPolicy[cq.get("reclaim", "NEVER")],
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


def build_scheduler(spec: dict, device=None, use_solver=True, guard=None):
    """(Scheduler, QueueManager, Cache) of this package for a spec, the
    workloads queued in spec order; ``device`` is where the cycle solve
    runs (the card unless "cpu")."""
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
        preemptor=Preemptor(clock),
        use_solver=use_solver,
        solver_threshold=1,
        guard=guard,
        device=device,
    )
    return sched, mgr, cache


def cycle_batch(seed: int, w: int = 24, k: int = 4, c: int = 5, depth: int = 3,
                n_cq: int = 10, fr: int = 6, drop_steps: bool = False) -> dict:
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
    phase 2 drops ranks)."""
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
        parent[i] = -1 if (i > 0 and rng.random() < 0.1) else n_cq + int(rng.integers(0, n_cohort))
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
    n_pad = max(1, w // 8)
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
