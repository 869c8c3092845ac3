"""The runtime drain loops at bench.py's pipeline and megaloop stages.

bench.py's ``_build_drain_loop_rt`` (the seeded 50k-pending x 1000-CQ
``ClusterRuntime`` both stages share), ``_drain_once`` and
``_admitted_of``, with the same seeds and shapes, on the port's
``ClusterRuntime(device=...)``: 1000 ClusterQueues in 50 cohorts, 8
flavors with cpu/memory quotas and lending limits, 50 workloads a
queue (priorities 0-150, 1-15 cpu, 1-31 Gi, 1-4 pods), drained by one
``bulk_drain`` call (serial, pipelined or megaloop rounds of ``chunk``
kernel cycles) with the latency gate pinned open and divergence
sampling off, as bench.py sets them.

The pipeline stage is seed ``default_rng(13).integers(1 << 30)`` at
chunk 16; the megaloop stage ``default_rng(17)`` at chunk 4 with K=16.
``RUNTIME_DRAIN_EXPECT`` and ``RUNTIME_MEGALOOP_EXPECT`` are
``admitted_summary`` of one drain at each, from the JAX package on the
CPU.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np

N_CQ = 1000
N_COHORT = 50
N_FLAVORS = 8
WL_PER_CQ = 50  # 50k total

PIPELINE_CHUNK = 16
MEGALOOP_CHUNK = 4
MEGALOOP_K = "16"


def stage_seed(stage_rng_seed: int) -> int:
    """The builder seed bench.py draws for a stage: 13 for the pipeline
    stage, 17 for the megaloop stage."""
    return int(np.random.default_rng(stage_rng_seed).integers(1 << 30))


def build_drain_loop_rt(mode, seed, chunk=16, megaloop="off", device=None, pkg=None,
                        n_cq=N_CQ, wl_per_cq=WL_PER_CQ, n_flavors=N_FLAVORS,
                        n_cohort=N_COHORT):
    """The seeded ClusterRuntime (identical objects per seed, so
    admitted sets compare across modes by construction). ``pkg`` is a
    package's module namespace (``modules()`` of this package, or the
    JAX package's for a parity test); ``device`` goes to the port's
    runtime only. ``n_cq``/``wl_per_cq`` cut the cluster for the CPU
    tests."""
    m = pkg or modules()

    class _OpenGate(m.LatencyEstimate):
        # pin the latency gate open: the stages measure the drain path
        # itself, not the gate's host-vs-drain routing
        @property
        def value(self):
            return None

    rng2 = np.random.default_rng(seed)
    kw = {} if pkg is not None else {"device": device}
    rt = m.ClusterRuntime(
        bulk_drain_threshold=256,
        drain_pipeline=mode,
        pipeline_chunk_cycles=chunk,
        drain_megaloop=megaloop,
        drain_gate=_OpenGate(),
        **kw,
    )
    # measured A/B: no sampled divergence re-solves in the window
    rt.guard.config.divergence_check_every = 0
    flavors = [f"fl-{i}" for i in range(n_flavors)]
    for f in flavors:
        rt.add_flavor(m.ResourceFlavor(name=f))
    for i in range(n_cq):
        quotas = tuple(
            m.FlavorQuotas.build(
                f,
                {
                    "cpu": (
                        str(int(rng2.integers(8, 64))),
                        str(int(rng2.integers(8, 32))),
                        None,
                    ),
                    "memory": (
                        f"{int(rng2.integers(16, 128))}Gi",
                        f"{int(rng2.integers(16, 64))}Gi",
                        None,
                    ),
                },
            )
            for f in flavors
        )
        rt.add_cluster_queue(
            m.ClusterQueue(
                name=f"pcq-{i}",
                cohort=f"pcohort-{i % n_cohort}",
                namespace_selector={},
                resource_groups=(m.ResourceGroup(("cpu", "memory"), quotas),),
            )
        )
        rt.add_local_queue(
            m.LocalQueue(namespace="ns", name=f"plq-{i}", cluster_queue=f"pcq-{i}")
        )
    n = n_cq * wl_per_cq
    prios = rng2.integers(0, 4, size=n) * 50
    cpus = rng2.integers(1, 16, size=n)
    mems = rng2.integers(1, 32, size=n)
    counts = rng2.integers(1, 5, size=n)
    for j in range(n):
        rt.add_workload(
            m.Workload(
                namespace="ns",
                name=f"pw{j}",
                queue_name=f"plq-{j % n_cq}",
                priority=int(prios[j]),
                creation_time=float(j),
                pod_sets=(
                    m.PodSet.build(
                        "main",
                        int(counts[j]),
                        {"cpu": str(cpus[j]), "memory": f"{mems[j]}Gi"},
                    ),
                ),
            )
        )
    rt.reconcile_once()
    return rt


def modules():
    """The port's module namespace ``build_drain_loop_rt`` builds from."""
    from types import SimpleNamespace

    from kueue_tpu_torch.controllers import ClusterRuntime
    from kueue_tpu_torch.core.scheduler import _LatencyEstimate
    from kueue_tpu_torch.models import (
        ClusterQueue,
        FlavorQuotas,
        LocalQueue,
        ResourceFlavor,
        Workload,
    )
    from kueue_tpu_torch.models.cluster_queue import ResourceGroup
    from kueue_tpu_torch.models.topology import Topology, TopologyLevel
    from kueue_tpu_torch.models.workload import PodSet, PodSetTopologyRequest
    from kueue_tpu_torch.tas.cache import Node, TASCache

    return SimpleNamespace(
        ClusterRuntime=ClusterRuntime, LatencyEstimate=_LatencyEstimate,
        ClusterQueue=ClusterQueue, FlavorQuotas=FlavorQuotas, LocalQueue=LocalQueue,
        ResourceFlavor=ResourceFlavor, Workload=Workload, ResourceGroup=ResourceGroup,
        PodSet=PodSet, Topology=Topology, TopologyLevel=TopologyLevel, Node=Node,
        TASCache=TASCache, PodSetTopologyRequest=PodSetTopologyRequest,
    )


def build_tas_runtime(spec: dict, pkg=None, device=None, **rt_kw):
    """A ``ClusterRuntime`` over a TASCache from a ``perf.cases.tas_spec``
    (the same plain data ``perf.tas.build_tas_env`` reads): topologies,
    flavors, nodes, ClusterQueues with their LocalQueues, and the
    workloads added through the runtime. ``pkg`` and ``device`` as for
    ``build_drain_loop_rt``; ``rt_kw`` goes to the runtime."""
    m = pkg or modules()
    kw = dict(rt_kw) if pkg is not None else {"device": device, **rt_kw}
    rt = m.ClusterRuntime(tas_cache=m.TASCache(), **kw)
    for name, keys in spec["topologies"].items():
        rt.add_topology(m.Topology(name=name, levels=tuple(m.TopologyLevel(k) for k in keys)))
    for name, topo_name, labels in spec["flavors"]:
        rt.add_flavor(m.ResourceFlavor(name=name, topology_name=topo_name,
                                       node_labels=dict(labels)))
    for name, labels, alloc in spec["nodes"]:
        rt.add_node(m.Node(name=name, labels=dict(labels), allocatable=dict(alloc)))
    for name, flavor, quota, *cohort in spec["cqs"]:
        rt.add_cluster_queue(m.ClusterQueue(
            name=name, namespace_selector={}, cohort=cohort[0] if cohort else None,
            resource_groups=(
                m.ResourceGroup(("cpu",), (m.FlavorQuotas.build(flavor, {"cpu": quota}),)),
            ),
        ))
        rt.add_local_queue(m.LocalQueue(namespace="ns", name=f"lq-{name}", cluster_queue=name))
    for w in spec["workloads"]:
        tr = None
        if w["mode"] is not None:
            tr = m.PodSetTopologyRequest(
                mode=w["mode"], level=None if w["mode"] == "Unconstrained" else w["level"]
            )
        rt.add_workload(m.Workload(
            namespace="ns", name=w["name"], queue_name=f"lq-{w['cq']}",
            priority=w["prio"], creation_time=w["t"],
            pod_sets=(m.PodSet.build("main", w["count"], {"cpu": w["cpu"]},
                                     topology_request=tr),),
        ))
    return rt


def drain_once(rt) -> float:
    """One ``bulk_drain`` call's wall seconds (it must run)."""
    t0 = time.perf_counter()
    res = rt.bulk_drain()
    dt = time.perf_counter() - t0
    assert res is not None, "bulk drain did not run"
    return dt


def admitted_of(rt) -> frozenset:
    return frozenset(k for k, wl in rt.workloads.items() if wl.has_quota_reservation)


def admitted_summary(rt) -> dict:
    """The admitted count and a sha256 of every admission (workload,
    ClusterQueue, flavors per podset), in key order."""
    h = hashlib.sha256()
    n = 0
    for key in sorted(admitted_of(rt)):
        adm = rt.workloads[key].admission
        flavors = [
            (psa.name, sorted(psa.flavors.items())) for psa in adm.pod_set_assignments
        ]
        h.update(repr((key, adm.cluster_queue, flavors)).encode())
        n += 1
    return {"admitted": n, "digest": h.hexdigest()}


#: ``admitted_summary`` after one ``drain_once`` at the pipeline stage
#: (seed ``stage_seed(13)``, chunk 16) and at the megaloop stage (seed
#: ``stage_seed(17)``, chunk 4), from the JAX package on the CPU; every
#: drain mode of a stage must give its stage's summary
RUNTIME_DRAIN_EXPECT = {
    "admitted": 14685,
    "digest": "8bf767cd3f6f9207c69011e7609a6030e961f94c7882c969884ad7935528ebe0",
}
RUNTIME_MEGALOOP_EXPECT = {
    "admitted": 14827,
    "digest": "eb8de3c37fa17f9a0fb0ab353d1b02c07ffe80cfe0c0e9bf26be2e0c1ac284d9",
}
