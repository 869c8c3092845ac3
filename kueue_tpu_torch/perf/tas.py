"""The Topology-Aware Scheduling clusters (ports of bench.py's
``tas_drain_bench`` and ``tas_placement_bench`` builders) and what the
TAS paths decide on them.

tas-drain-10k (``build_tas_drain``): bench.py's ``tas_drain`` stage
unchanged, seed 6 (``default_rng(6)``, bench.py's). One TAS flavor
``tas-flavor`` over a 3-level topology (block -> rack -> hostname) of
16 blocks x 8 racks x 8 hosts = 1024 hosts of 8 cpu and 32 pods; 100
ClusterQueues with 9999 cpu of it each; 100 single-podset gangs a
queue of 2-16 pods at 1-2 cpu, priorities 0/10/20, each Required,
Preferred (at rack, rack, block or host) or Unconstrained: 10,000
pending, decided by the TAS drain (kernel B13).

tas-placement-1k (``build_placement(PLACEMENT_SHAPE)``): bench.py's
``tas`` stage topology, 8 blocks x 16 racks x 8 hosts = 1024 hosts of
64 cpu and 64 pods, and its one 50,000-pod gang (1 cpu a pod,
Preferred at block). tas-fleet-131k (``build_placement(FLEET_SHAPE)``):
the same three levels at 32 x 64 x 64 = 131,072 hosts, above
``TASFlavorSnapshot.DEVICE_LEAF_THRESHOLD``, so the snapshot's
``find_topology_assignments`` counts pods with kernel B12.

The RNG draws happen in the order bench.py makes them, so a seed gives
the same cluster in both packages: ``tas_api`` takes one package's
modules (the tests pass the JAX package's), and this module imports
nothing of it. ``TAS_DRAIN_EXPECT`` is what the JAX package gives on
the CPU (tests/test_torch_tas_drain.py holds it to it at a cut, and
chip_smoke.py holds the port to it on the card).
"""

from __future__ import annotations

import hashlib
from types import SimpleNamespace
from typing import Dict, Tuple

import numpy as np

BLOCK = "cloud.google.com/topology-block"
RACK = "cloud.google.com/topology-rack"
HOST = "kubernetes.io/hostname"
TAS_DRAIN_SEED = 6  # bench.py's _stage_tas_drain
N_CQ, WL_PER_CQ = 100, 100
DRAIN_SHAPE = (16, 8, 8)  # blocks, racks a block, hosts a rack
PLACEMENT_SHAPE = (8, 16, 8)  # bench.py's tas stage: 1024 hosts
FLEET_SHAPE = (32, 64, 64)  # 131,072 hosts: kernel B12's path
PLACEMENT_PODS = 50_000
PLACEMENT_LEVELS = ("block", "rack", HOST)

# the JAX package's run_drain_tas at tas-drain-10k on the CPU
TAS_DRAIN_EXPECT = {
    "cycles": 490,
    "admitted": 629,
    "parked": 9371,
    "fallback": 0,
    "truncated": False,
    "digest": "3e2e4c864e0678f7",
    "usage_digest": "74b8ed898039574d",
}


def tas_api(models, topology, workload, cache, queue_manager, clock, tas) -> SimpleNamespace:
    """The classes the builders need, from one package's modules
    (``models``, ``models.topology``, ``models.workload``,
    ``core.cache``, ``core.queue_manager``, ``utils.clock``, ``tas``)."""
    return SimpleNamespace(
        ClusterQueue=models.ClusterQueue, FlavorQuotas=models.FlavorQuotas,
        LocalQueue=models.LocalQueue, ResourceFlavor=models.ResourceFlavor,
        Workload=models.Workload, ResourceGroup=models.cluster_queue.ResourceGroup,
        Topology=topology.Topology, TopologyLevel=topology.TopologyLevel,
        PodSet=workload.PodSet, PodSetTopologyRequest=workload.PodSetTopologyRequest,
        Cache=cache.Cache, QueueManager=queue_manager.QueueManager,
        queue_order_timestamp=queue_manager.queue_order_timestamp,
        FakeClock=clock.FakeClock, Node=tas.Node, TASCache=tas.TASCache,
        TASFlavorCache=tas.TASFlavorCache, TASPodSetRequest=tas.TASPodSetRequest,
        TASManager=tas.TASManager,
    )


def port_api() -> SimpleNamespace:
    from kueue_tpu_torch import models, tas
    from kueue_tpu_torch.core import cache, queue_manager
    from kueue_tpu_torch.models import topology, workload
    from kueue_tpu_torch.utils import clock

    return tas_api(models, topology, workload, cache, queue_manager, clock, tas)


def build_tas_env(spec: dict, api=None) -> SimpleNamespace:
    """A cluster from a spec (plain data, so both packages build the
    same one): ``topologies`` {name: level keys}, ``flavors`` [(name,
    topology name or None, node labels)], ``nodes`` [(name, labels,
    allocatable[, usage of pods TAS does not manage])], ``cqs``
    [(name, flavor, cpu quota or {resource: quota}[, cohort])] each
    with one LocalQueue ``lq-<name>``, and
    ``workloads`` [dict(name, cq, count, cpu, mode, level, prio, t[,
    requests])] (mode None: no topology request; ``requests``: per-pod
    requests beside the cpu).
    Returns ``cache`` (its tas_cache set), ``mgr`` (the workloads
    queued), ``tas``, ``pending`` in per-CQ heap order, ``ts_fn`` and
    ``api``."""
    a = api or port_api()
    cache = a.Cache()
    mgr = a.QueueManager(a.FakeClock(0.0))
    tas = a.TASCache()
    for name, keys in spec["topologies"].items():
        topo = a.Topology(name=name, levels=tuple(a.TopologyLevel(k) for k in keys))
        tas.add_or_update_topology(topo)
        cache.add_or_update_topology(topo)
    for name, topo_name, labels in spec["flavors"]:
        fl = a.ResourceFlavor(name=name, topology_name=topo_name, node_labels=dict(labels))
        cache.add_or_update_flavor(fl)
        tas.add_or_update_flavor(fl)
    for name, labels, alloc, *non_tas in spec["nodes"]:
        tas.add_or_update_node(a.Node(name=name, labels=dict(labels), allocatable=dict(alloc),
                                      non_tas_usage=dict(non_tas[0]) if non_tas else {}))
    cache.tas_cache = tas
    for name, flavor, quota, *cohort in spec["cqs"]:
        quotas = quota if isinstance(quota, dict) else {"cpu": quota}
        cq = a.ClusterQueue(
            name=name, namespace_selector={}, cohort=cohort[0] if cohort else None,
            resource_groups=(
                a.ResourceGroup(tuple(quotas), (a.FlavorQuotas.build(flavor, quotas),)),
            ),
        )
        cache.add_or_update_cluster_queue(cq)
        mgr.add_cluster_queue(cq)
        lq = a.LocalQueue(namespace="ns", name=f"lq-{name}", cluster_queue=name)
        cache.add_or_update_local_queue(lq)
        mgr.add_local_queue(lq)
    for w in spec["workloads"]:
        tr = None
        if w["mode"] is not None:
            tr = a.PodSetTopologyRequest(
                mode=w["mode"], level=None if w["mode"] == "Unconstrained" else w["level"]
            )
        mgr.add_or_update_workload(a.Workload(
            namespace="ns", name=w["name"], queue_name=f"lq-{w['cq']}",
            priority=w["prio"], creation_time=w["t"],
            pod_sets=(a.PodSet.build("main", w["count"],
                                     {"cpu": w["cpu"], **w.get("requests", {})},
                                     topology_request=tr),),
        ))
    pending = [(wl, cq_name) for cq_name, pq in mgr.cluster_queues.items()
               for wl in pq.snapshot_sorted()]
    return SimpleNamespace(
        cache=cache, mgr=mgr, tas=tas, pending=pending, api=a,
        ts_fn=lambda wl: a.queue_order_timestamp(wl, mgr._ts_policy),
    )


def drain_spec(rng: np.random.Generator, n_cq: int = N_CQ, wl_per_cq: int = WL_PER_CQ,
               shape: Tuple[int, int, int] = DRAIN_SHAPE) -> dict:
    """bench.py's ``tas_drain_bench`` cluster as a spec, drawing from
    ``rng`` in bench.py's order (mode, level, priority, count, cpu)."""
    n_blocks, racks, hosts = shape
    nodes = [
        (f"n-{b}-{r}-{h}", {BLOCK: f"b{b}", RACK: f"b{b}-r{r}", HOST: f"h-{b}-{r}-{h}"},
         {"cpu": 8000, "pods": 32})
        for b in range(n_blocks) for r in range(racks) for h in range(hosts)
    ]
    levels = [RACK, RACK, BLOCK, HOST]
    workloads = []
    for i in range(n_cq):
        for w in range(wl_per_cq):
            mode = ("Required", "Preferred", "Unconstrained")[int(rng.integers(0, 3))]
            level = None if mode == "Unconstrained" else levels[int(rng.integers(0, len(levels)))]
            prio = int(rng.integers(0, 3)) * 10
            count = int(rng.integers(2, 17))
            cpu = str(int(rng.integers(1, 3)))
            workloads.append(dict(name=f"twl-{i}-{w}", cq=f"tcq-{i}", count=count, cpu=cpu,
                                  mode=mode, level=level, prio=prio,
                                  t=float(i * wl_per_cq + w)))
    return {
        "topologies": {"default": (BLOCK, RACK, HOST)},
        "flavors": [("tas-flavor", "default", {})],
        "nodes": nodes,
        "cqs": [(f"tcq-{i}", "tas-flavor", "9999") for i in range(n_cq)],
        "workloads": workloads,
    }


def build_tas_drain(rng: np.random.Generator, n_cq: int = N_CQ, wl_per_cq: int = WL_PER_CQ,
                    api=None) -> SimpleNamespace:
    """tas-drain-10k (module docstring); ``n_cq``/``wl_per_cq`` cut it."""
    return build_tas_env(drain_spec(rng, n_cq, wl_per_cq), api)


def build_placement(shape: Tuple[int, int, int] = PLACEMENT_SHAPE, api=None):
    """bench.py's ``tas_placement_bench`` flavor at ``shape`` (blocks,
    racks a block, hosts a rack; hosts of 64 cpu and 64 pods) and its
    request, one 50,000-pod gang of 1 cpu pods, Preferred at block.
    Returns (TASFlavorCache, TASPodSetRequest)."""
    from kueue_tpu_torch.resources import requests_from_spec

    a = api or port_api()
    n_blocks, racks, hosts = shape
    flavor = a.ResourceFlavor(name="tas", topology_name="topo")
    topo = a.Topology(name="topo", levels=tuple(a.TopologyLevel(k) for k in PLACEMENT_LEVELS))
    fc = a.TASFlavorCache(flavor, topo)
    alloc = requests_from_spec({"cpu": "64", "pods": "64"})
    for b in range(n_blocks):
        for r in range(racks):
            for h in range(hosts):
                name = f"n{b}-{r}-{h}"
                fc.add_or_update_node(a.Node(
                    name=name, labels={"block": f"b{b}", "rack": f"r{b}-{r}", HOST: name},
                    allocatable=dict(alloc),
                ))
    req = a.TASPodSetRequest(
        podset_name="main", count=PLACEMENT_PODS,
        single_pod_requests=dict(requests_from_spec({"cpu": "1"})),
        topology_request=a.PodSetTopologyRequest(mode="Preferred", level="block"),
    )
    return fc, req


def _digest(items) -> str:
    return hashlib.sha256(repr(items).encode()).hexdigest()[:16]


def placements(out) -> list:
    """(name, cycle, sorted (values, count) domains) of every admitted
    workload, sorted."""
    return sorted(
        (wl.name, cycle, tuple(sorted((tuple(d.values), d.count) for d in ta.domains))
         if ta is not None else None)
        for (wl, _, _, cycle), ta in zip(out.admitted, out.assignments)
    )


def leaf_usage(out) -> Dict[tuple, Tuple[int, int]]:
    """(cpu, pods) charged to each assigned domain by the admitted
    workloads: the final TAS leaf usage the drain's replay holds equal
    to the kernel's."""
    usage: Dict[tuple, Tuple[int, int]] = {}
    for (wl, _, _, _), ta in zip(out.admitted, out.assignments):
        if ta is None:
            continue
        cpu = int(wl.pod_sets[0].requests.get("cpu", 0))
        for d in ta.domains:
            c, p = usage.get(tuple(d.values), (0, 0))
            usage[tuple(d.values)] = (c + cpu * d.count, p + d.count)
    return usage


def drain_summary(out) -> dict:
    """The TAS drain's outcome in TAS_DRAIN_EXPECT's form: counts, and
    digests of the placements and of the final leaf usage."""
    return {
        "cycles": int(out.cycles),
        "admitted": len(out.admitted),
        "parked": len(out.parked),
        "fallback": len(out.fallback),
        "truncated": bool(out.truncated),
        "digest": _digest(placements(out)),
        "usage_digest": _digest(sorted(leaf_usage(out).items())),
    }
