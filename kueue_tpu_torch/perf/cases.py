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


def build_cache(spec: dict):
    """(Cache, pending) of this package for a spec; ``pending`` is in
    per-CQ heap order (priority desc, timestamp asc)."""
    from kueue_tpu_torch.core.cache import Cache
    from kueue_tpu_torch.models import (
        ClusterQueue,
        Cohort,
        FlavorFungibility,
        FlavorFungibilityPolicy,
        FlavorQuotas,
        Preemption,
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
        if cq.get("reclaim") is not None:
            kwargs["preemption"] = Preemption(
                reclaim_within_cohort=ReclaimWithinCohortPolicy[cq["reclaim"]]
            )
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
            priority=w["prio"],
            creation_time=w["t"],
            pod_sets=tuple(
                PodSet.build(ps["name"], ps["count"], ps["requests"])
                for ps in w["pod_sets"]
            ),
        )
        pending.append((wl, w.get("cq") or w["queue"][len("lq-"):]))
    pending.sort(key=lambda e: (e[1], -e[0].priority, e[0].creation_time))
    return cache, pending
