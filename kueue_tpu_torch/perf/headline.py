"""The headline drain's cluster and backlog (port of bench.py's
``build_cluster`` / ``build_backlog``).

BASELINE.json's north-star shape: 50k pending workloads over 1000
ClusterQueues in 50 cohorts, 8 CPU/memory flavors plus one GPU flavor in
a second resource group. The RNG draws happen in the same order as in
bench.py, so a seed gives the same cluster and backlog in both packages
(asserted by tests/test_torch_drain.py).

``outcome_digest`` hashes a drain's decisions — the sorted (workload,
flavors, cycle) admissions and the final leaf usage — so two runs (or
two packages) can be compared by one constant.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np

N_CQ = 1000
N_COHORT = 50
N_FLAVORS = 8
WL_PER_CQ = 50  # 50k total


def build_cluster(rng: np.random.Generator):
    """The headline Cache: N_CQ ClusterQueues in N_COHORT cohorts."""
    from kueue_tpu_torch.core.cache import Cache
    from kueue_tpu_torch.models import ClusterQueue, FlavorQuotas, ResourceFlavor
    from kueue_tpu_torch.models.cluster_queue import ResourceGroup

    cache = Cache()
    flavors = [f"fl-{i}" for i in range(N_FLAVORS)]
    for f in flavors + ["gpu-fl"]:
        cache.add_or_update_flavor(ResourceFlavor(name=f))
    for i in range(N_CQ):
        name = f"cq-{i}"
        quotas = tuple(
            FlavorQuotas.build(
                f,
                {
                    "cpu": (
                        str(int(rng.integers(8, 64))),
                        str(int(rng.integers(8, 32))),  # borrowingLimit
                        None,
                    ),
                    "memory": (
                        f"{int(rng.integers(16, 128))}Gi",
                        f"{int(rng.integers(16, 64))}Gi",
                        None,
                    ),
                },
            )
            for f in flavors
        )
        # second resource group: a single accelerator flavor
        gpu_quota = (
            FlavorQuotas.build(
                "gpu-fl",
                {"gpu": (str(int(rng.integers(4, 16))),
                         str(int(rng.integers(2, 8))), None)},
            ),
        )
        cq = ClusterQueue(
            name=name,
            cohort=f"cohort-{i % N_COHORT}",
            namespace_selector={},
            resource_groups=(
                ResourceGroup(("cpu", "memory"), quotas),
                ResourceGroup(("gpu",), gpu_quota),
            ),
        )
        cache.add_or_update_cluster_queue(cq)
    return cache


def build_queues(cache, clock):
    """The headline QueueManager: one LocalQueue ``lq-cq-i`` per
    ClusterQueue, as bench.py's ``build_cluster`` makes it."""
    from kueue_tpu_torch.core.queue_manager import QueueManager
    from kueue_tpu_torch.models import LocalQueue

    mgr = QueueManager(clock)
    for i in range(N_CQ):
        name = f"cq-{i}"
        mgr.add_cluster_queue(cache.cluster_queues[name].model)
        mgr.add_local_queue(
            LocalQueue(namespace="ns", name=f"lq-{name}", cluster_queue=name)
        )
    return mgr


def build_backlog(rng: np.random.Generator):
    """N_CQ x WL_PER_CQ single-podset workloads, ~a third requesting
    gpus, as (workload, cq name) in per-CQ heap order (priority desc,
    timestamp asc)."""
    from kueue_tpu_torch.models import Workload
    from kueue_tpu_torch.models.workload import PodSet

    pending = []
    n = N_CQ * WL_PER_CQ
    prios = rng.integers(0, 4, size=n) * 50
    cpus = rng.integers(1, 16, size=n)
    mems = rng.integers(1, 32, size=n)
    gpus = rng.integers(1, 3, size=n)
    wants_gpu = rng.random(size=n) < 0.33
    counts = rng.integers(1, 5, size=n)
    for i in range(n):
        cq = f"cq-{i % N_CQ}"
        requests = {"cpu": str(cpus[i]), "memory": f"{mems[i]}Gi"}
        if wants_gpu[i]:
            requests["gpu"] = str(gpus[i])  # second resource group
        wl = Workload(
            namespace="ns",
            name=f"w{i}",
            queue_name=f"lq-{cq}",
            priority=int(prios[i]),
            creation_time=float(i),
            pod_sets=(PodSet.build("main", int(counts[i]), requests),),
        )
        pending.append((wl, cq))
    pending.sort(key=lambda t: (t[1], -t[0].priority, t[0].creation_time))
    return pending


def outcome_digest(outcome) -> str:
    """sha256 of the sorted (workload, flavors, cycle) admissions and
    the final leaf usage of a DrainOutcome (either package's)."""
    rows = sorted(
        (wl.name, json.dumps(flavors, sort_keys=True), int(cycle))
        for wl, _, flavors, cycle in outcome.admitted
    )
    h = hashlib.sha256(json.dumps(rows).encode())
    usage = np.ascontiguousarray(outcome.final_usage, dtype="<i8")
    h.update(repr(usage.shape).encode())
    h.update(usage.tobytes())
    return h.hexdigest()


# What the headline drain (seed 0, max_cells=3) decides, from the JAX
# package on the CPU; tests/test_torch_drain.py holds the JAX package
# to it and chip_smoke.py holds the port on the card to it.
HEADLINE_SEED = 0
HEADLINE_MAX_CELLS = 3
HEADLINE_EXPECT = {
    "cycles": 74,
    "admitted": 15178,
    "parked": 34822,
    "fallback": 0,
    "truncated": False,
    "digest": "a3f6fca41732ea6d1827591e64ee2cf60afa6874bb32a95eb68f91d89fc3babf",
}


def outcome_summary(outcome) -> dict:
    """The HEADLINE_EXPECT keys of a DrainOutcome."""
    return {
        "cycles": int(outcome.cycles),
        "admitted": len(outcome.admitted),
        "parked": len(outcome.parked),
        "fallback": len(outcome.fallback),
        "truncated": bool(outcome.truncated),
        "digest": outcome_digest(outcome),
    }
