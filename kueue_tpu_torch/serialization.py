"""Object-model <-> plain-dict serialization.

The durable wire format: the CLI's state file, the importer's input,
and checkpoint/restore all speak it. Field names follow the reference
CRDs' JSON (apis/kueue/v1beta1) so manifests diff cleanly.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from kueue_tpu_torch.models import (
    AdmissionCheck,
    ClusterQueue,
    LocalQueue,
    ResourceFlavor,
    Workload,
    WorkloadPriorityClass,
)
from kueue_tpu_torch.models.cluster_queue import (
    FlavorQuotas,
    Preemption,
    ResourceGroup,
    ResourceQuota,
)
from kueue_tpu_torch.models.cohort import Cohort
from kueue_tpu_torch.models.constants import (
    BorrowWithinCohortPolicy,
    FlavorFungibilityPolicy,
    PreemptionPolicy,
    QueueingStrategy,
    ReclaimWithinCohortPolicy,
    StopPolicy,
    WorkloadConditionType,
)
from kueue_tpu_torch.models.resource_flavor import Taint, Toleration
from kueue_tpu_torch.models.topology import Topology, TopologyLevel
from kueue_tpu_torch.models.workload import (
    Admission,
    Condition,
    PodSet,
    PodSetAssignment,
    PodSetTopologyRequest,
    RequeueState,
    TopologyAssignment,
    TopologyDomainAssignment,
)
from kueue_tpu_torch.models.admission_check import AdmissionCheckState
from kueue_tpu_torch.models.constants import AdmissionCheckStateType
from kueue_tpu_torch.resources import quantity_to_int


def _canon_qty(resource: str, value) -> int:
    """Wire quantities: ints are already-canonical (what to_dict
    emits); strings are human quantities ("2", "4Gi") as written in
    hand-authored manifests — parse them the way PodSet.build does."""
    if isinstance(value, int):
        return value
    return quantity_to_int(resource, value)


# ---- nodes (TAS capacity inventory) ----
def node_to_dict(n) -> dict:
    return {
        "name": n.name,
        "labels": dict(n.labels),
        # canonical ints verbatim: a str() here would make the reload
        # re-parse milli-canonical values as human quantities (1000x
        # inflation per checkpoint round trip)
        "allocatable": dict(n.allocatable),
        "taints": [
            {"key": t.key, "value": t.value, "effect": t.effect}
            for t in n.taints
        ],
        "ready": n.ready,
        "nonTasUsage": dict(n.non_tas_usage),
    }


def node_from_dict(d: dict):
    from kueue_tpu_torch.tas.cache import Node

    return Node(
        name=d["name"],
        labels=dict(d.get("labels", {})),
        allocatable={
            r: _canon_qty(r, q) for r, q in d.get("allocatable", {}).items()
        },
        taints=tuple(
            Taint(t["key"], t.get("value", ""), t.get("effect", "NoSchedule"))
            for t in d.get("taints", [])
        ),
        ready=d.get("ready", True),
        non_tas_usage={
            r: _canon_qty(r, q) for r, q in d.get("nonTasUsage", {}).items()
        },
    )


# ---- flavors ----
def flavor_to_dict(f: ResourceFlavor) -> dict:
    return {
        "name": f.name,
        "nodeLabels": dict(f.node_labels),
        "nodeTaints": [
            {"key": t.key, "value": t.value, "effect": t.effect}
            for t in f.node_taints
        ],
        "tolerations": [
            {"key": t.key, "operator": t.operator, "value": t.value, "effect": t.effect}
            for t in f.tolerations
        ],
        "topologyName": f.topology_name,
    }


def flavor_from_dict(d: dict) -> ResourceFlavor:
    return ResourceFlavor(
        name=d["name"],
        node_labels=dict(d.get("nodeLabels", {})),
        node_taints=tuple(
            Taint(t["key"], t.get("value", ""), t.get("effect", "NoSchedule"))
            for t in d.get("nodeTaints", [])
        ),
        tolerations=tuple(
            Toleration(
                t.get("key", ""), t.get("operator", "Equal"),
                t.get("value", ""), t.get("effect", ""),
            )
            for t in d.get("tolerations", [])
        ),
        topology_name=d.get("topologyName"),
    )


# ---- cluster queues ----
def cq_to_dict(cq: ClusterQueue) -> dict:
    return {
        "name": cq.name,
        "cohort": cq.cohort,
        "queueingStrategy": cq.queueing_strategy.value,
        "namespaceSelector": cq.namespace_selector,
        "stopPolicy": cq.stop_policy.value,
        "admissionChecks": list(cq.admission_checks),
        "fairSharingWeight": cq.fair_sharing.weight_milli,
        "flavorFungibility": {
            "whenCanBorrow": cq.flavor_fungibility.when_can_borrow.value,
            "whenCanPreempt": cq.flavor_fungibility.when_can_preempt.value,
        },
        "preemption": {
            "reclaimWithinCohort": cq.preemption.reclaim_within_cohort.value,
            "withinClusterQueue": cq.preemption.within_cluster_queue.value,
            "borrowWithinCohort": {
                "policy": cq.preemption.borrow_within_cohort.policy.value,
                "maxPriorityThreshold": cq.preemption.borrow_within_cohort.max_priority_threshold,
            },
        },
        "resourceGroups": [
            {
                "coveredResources": list(rg.covered_resources),
                "flavors": [
                    {
                        "name": fq.name,
                        "resources": [
                            {
                                "name": rname,
                                "nominalQuota": rq.nominal,
                                "borrowingLimit": rq.borrowing_limit,
                                "lendingLimit": rq.lending_limit,
                            }
                            for rname, rq in fq.resources.items()
                        ],
                    }
                    for fq in rg.flavors
                ],
            }
            for rg in cq.resource_groups
        ],
    }


def cq_from_dict(d: dict) -> ClusterQueue:
    from kueue_tpu_torch.models.cluster_queue import (
        BorrowWithinCohort,
        FairSharing,
        FlavorFungibility,
    )

    preemption = d.get("preemption", {})
    borrow = preemption.get("borrowWithinCohort", {})
    ff = d.get("flavorFungibility", {})
    return ClusterQueue(
        name=d["name"],
        cohort=d.get("cohort"),
        queueing_strategy=QueueingStrategy(
            d.get("queueingStrategy", "BestEffortFIFO")
        ),
        namespace_selector=d.get("namespaceSelector"),
        stop_policy=StopPolicy(d.get("stopPolicy", "None")),
        admission_checks=tuple(d.get("admissionChecks", ())),
        fair_sharing=FairSharing(weight_milli=d.get("fairSharingWeight", 1000)),
        flavor_fungibility=FlavorFungibility(
            when_can_borrow=FlavorFungibilityPolicy(ff.get("whenCanBorrow", "Borrow")),
            when_can_preempt=FlavorFungibilityPolicy(
                ff.get("whenCanPreempt", "TryNextFlavor")
            ),
        ),
        preemption=Preemption(
            reclaim_within_cohort=ReclaimWithinCohortPolicy(
                preemption.get("reclaimWithinCohort", "Never")
            ),
            within_cluster_queue=PreemptionPolicy(
                preemption.get("withinClusterQueue", "Never")
            ),
            borrow_within_cohort=BorrowWithinCohort(
                policy=BorrowWithinCohortPolicy(borrow.get("policy", "Never")),
                max_priority_threshold=borrow.get("maxPriorityThreshold"),
            ),
        ),
        resource_groups=tuple(
            ResourceGroup(
                covered_resources=tuple(rg["coveredResources"]),
                flavors=tuple(
                    FlavorQuotas(
                        name=fq["name"],
                        resources={
                            r["name"]: ResourceQuota(
                                nominal=_canon_qty(
                                    r["name"], r.get("nominalQuota", 0)
                                ),
                                borrowing_limit=(
                                    _canon_qty(r["name"], r["borrowingLimit"])
                                    if r.get("borrowingLimit") is not None
                                    else None
                                ),
                                lending_limit=(
                                    _canon_qty(r["name"], r["lendingLimit"])
                                    if r.get("lendingLimit") is not None
                                    else None
                                ),
                            )
                            for r in fq["resources"]
                        },
                    )
                    for fq in rg["flavors"]
                ),
            )
            for rg in d.get("resourceGroups", ())
        ),
    )


# ---- local queues / cohorts / checks / topologies / priority classes ----
def lq_to_dict(lq: LocalQueue) -> dict:
    return {
        "name": lq.name,
        "namespace": lq.namespace,
        "clusterQueue": lq.cluster_queue,
        "stopPolicy": lq.stop_policy.value,
    }


def lq_from_dict(d: dict) -> LocalQueue:
    return LocalQueue(
        name=d["name"],
        namespace=d["namespace"],
        cluster_queue=d["clusterQueue"],
        stop_policy=StopPolicy(d.get("stopPolicy", "None")),
    )


def cohort_to_dict(c: Cohort) -> dict:
    return {"name": c.name, "parent": c.parent}


def cohort_from_dict(d: dict) -> Cohort:
    return Cohort(name=d["name"], parent=d.get("parent"))


def check_to_dict(ac: AdmissionCheck) -> dict:
    return {
        "name": ac.name,
        "controllerName": ac.controller_name,
        "parameters": ac.parameters,
        "active": ac.active,
        "activeMessage": ac.active_message,
    }


def check_from_dict(d: dict) -> AdmissionCheck:
    return AdmissionCheck(
        name=d["name"],
        controller_name=d["controllerName"],
        parameters=d.get("parameters"),
        # absent = status unset (spec applies must not reset the
        # controller-owned Active condition)
        active=d.get("active"),
        active_message=d.get("activeMessage", ""),
    )


def topology_to_dict(t: Topology) -> dict:
    return {"name": t.name, "levels": [lv.node_label for lv in t.levels]}


def topology_from_dict(d: dict) -> Topology:
    return Topology(
        name=d["name"],
        levels=tuple(TopologyLevel(k) for k in d["levels"]),
    )


def priority_class_to_dict(pc: WorkloadPriorityClass) -> dict:
    return {"name": pc.name, "value": pc.value}


def priority_class_from_dict(d: dict) -> WorkloadPriorityClass:
    return WorkloadPriorityClass(name=d["name"], value=d["value"])


# ---- limit ranges / runtime classes (resource adjustment inputs) ----
def limit_range_to_dict(lr) -> dict:
    return {
        "name": lr.name,
        "namespace": lr.namespace,
        "limits": [
            {
                "type": item.type,
                "max": dict(item.max),
                "min": dict(item.min),
                "default": dict(item.default),
                "defaultRequest": dict(item.default_request),
            }
            for item in lr.items
        ],
    }


def limit_range_from_dict(d: dict):
    from kueue_tpu_torch.core.limit_range import LimitRange, LimitRangeItem

    def qmap(m):
        return {r: _canon_qty(r, q) for r, q in (m or {}).items()}

    return LimitRange(
        namespace=d["namespace"],
        name=d["name"],
        items=[
            LimitRangeItem(
                type=item.get("type", "Container"),
                max=qmap(item.get("max")),
                min=qmap(item.get("min")),
                default=qmap(item.get("default")),
                default_request=qmap(item.get("defaultRequest")),
            )
            for item in d.get("limits", [])
        ],
    )


def runtime_class_to_dict(rc) -> dict:
    return {"name": rc.name, "overhead": dict(rc.overhead)}


def runtime_class_from_dict(d: dict):
    from kueue_tpu_torch.core.limit_range import RuntimeClass

    return RuntimeClass(
        name=d["name"],
        overhead={
            r: _canon_qty(r, q) for r, q in (d.get("overhead") or {}).items()
        },
    )


# ---- workloads ----
def workload_to_dict(wl: Workload) -> dict:
    out = {
        "name": wl.name,
        "namespace": wl.namespace,
        "labels": dict(wl.labels),
        "queueName": wl.queue_name,
        "priority": wl.priority,
        "priorityClassName": wl.priority_class_name,
        "active": wl.active,
        "creationTime": wl.creation_time,
        "maximumExecutionTimeSeconds": wl.maximum_execution_time_seconds,
        "podSets": [
            {
                "name": ps.name,
                "count": ps.count,
                "minCount": ps.min_count,
                "requests": dict(ps.requests),
                "limits": dict(ps.limits),
                "overhead": dict(ps.overhead),
                "runtimeClassName": ps.runtime_class_name,
                "nodeSelector": dict(ps.node_selector),
                "topologyRequest": (
                    {
                        "mode": ps.topology_request.mode,
                        "level": ps.topology_request.level,
                    }
                    if ps.topology_request
                    else None
                ),
            }
            for ps in wl.pod_sets
        ],
        "conditions": [
            {
                "type": c.type.value,
                "status": c.status,
                "reason": c.reason,
                "message": c.message,
                "lastTransitionTime": c.last_transition_time,
            }
            for c in wl.conditions.values()
        ],
        "admissionChecks": [
            {
                "name": s.name,
                "state": s.state.value,
                "message": s.message,
            }
            for s in wl.admission_check_states.values()
        ],
        "reclaimablePods": dict(wl.reclaimable_pods),
    }
    if wl.requeue_state is not None:
        out["requeueState"] = {
            "count": wl.requeue_state.count,
            "requeueAt": wl.requeue_state.requeue_at,
        }
    if wl.admission is not None:
        out["admission"] = {
            "clusterQueue": wl.admission.cluster_queue,
            "podSetAssignments": [
                {
                    "name": psa.name,
                    "flavors": dict(psa.flavors),
                    "resourceUsage": dict(psa.resource_usage),
                    "count": psa.count,
                    "topologyAssignment": (
                        {
                            "levels": list(psa.topology_assignment.levels),
                            "domains": [
                                {"values": list(dd.values), "count": dd.count}
                                for dd in psa.topology_assignment.domains
                            ],
                        }
                        if psa.topology_assignment
                        else None
                    ),
                }
                for psa in wl.admission.pod_set_assignments
            ],
        }
    return out


def workload_from_dict(d: dict) -> Workload:
    wl = Workload(
        name=d["name"],
        namespace=d["namespace"],
        labels=dict(d.get("labels", {})),
        queue_name=d.get("queueName", ""),
        priority=d.get("priority", 0),
        priority_class_name=d.get("priorityClassName", ""),
        active=d.get("active", True),
        creation_time=d.get("creationTime", 0.0),
        maximum_execution_time_seconds=d.get("maximumExecutionTimeSeconds"),
        pod_sets=tuple(
            PodSet(
                name=ps["name"],
                count=ps["count"],
                min_count=ps.get("minCount"),
                requests={
                    r: _canon_qty(r, q)
                    for r, q in ps.get("requests", {}).items()
                },
                limits={
                    r: _canon_qty(r, q)
                    for r, q in (ps.get("limits") or {}).items()
                },
                overhead={
                    r: _canon_qty(r, q)
                    for r, q in (ps.get("overhead") or {}).items()
                },
                runtime_class_name=ps.get("runtimeClassName"),
                node_selector=dict(ps.get("nodeSelector", {})),
                topology_request=(
                    PodSetTopologyRequest(
                        mode=ps["topologyRequest"]["mode"],
                        level=ps["topologyRequest"].get("level"),
                    )
                    if ps.get("topologyRequest")
                    else None
                ),
            )
            for ps in d.get("podSets", ())
        ),
    )
    for c in d.get("conditions", ()):
        wl.conditions[WorkloadConditionType(c["type"])] = Condition(
            type=WorkloadConditionType(c["type"]),
            status=c["status"],
            reason=c.get("reason", ""),
            message=c.get("message", ""),
            last_transition_time=c.get("lastTransitionTime", 0.0),
        )
    for s in d.get("admissionChecks", ()):
        wl.admission_check_states[s["name"]] = AdmissionCheckState(
            name=s["name"],
            state=AdmissionCheckStateType(s["state"]),
            message=s.get("message", ""),
        )
    wl.reclaimable_pods = dict(d.get("reclaimablePods", {}))
    rs = d.get("requeueState")
    if rs is not None:
        wl.requeue_state = RequeueState(
            count=rs.get("count", 0), requeue_at=rs.get("requeueAt")
        )
    adm = d.get("admission")
    if adm is not None:
        wl.admission = Admission(
            cluster_queue=adm["clusterQueue"],
            pod_set_assignments=tuple(
                PodSetAssignment(
                    name=psa["name"],
                    flavors=dict(psa.get("flavors", {})),
                    resource_usage={
                        r: _canon_qty(r, q)
                        for r, q in psa.get("resourceUsage", {}).items()
                    },
                    count=psa.get("count", 0),
                    topology_assignment=(
                        TopologyAssignment(
                            levels=tuple(psa["topologyAssignment"]["levels"]),
                            domains=tuple(
                                TopologyDomainAssignment(
                                    values=tuple(dd["values"]), count=dd["count"]
                                )
                                for dd in psa["topologyAssignment"]["domains"]
                            ),
                        )
                        if psa.get("topologyAssignment")
                        else None
                    ),
                )
                for psa in adm.get("podSetAssignments", ())
            ),
        )
    return wl


# ---- whole-state save/load ----
def runtime_from_state(data: dict, runtime=None, **runtime_kwargs):
    """Build (or populate) a ClusterRuntime from a serialized state
    dict (the wire format consumed by the CLI's state file and the
    server's solver endpoint). Insertion order mirrors
    cmd/kueue/main.go setupControllers: flavors/topologies/cohorts/
    checks/classes before queues, workloads last. Pass ``runtime`` to
    load into a preconfigured runtime (e.g. one built from a --config
    file)."""
    from kueue_tpu_torch.controllers import ClusterRuntime

    if data.get("nodes"):
        # a state carrying node inventory implies TAS intent — without
        # a TASCache the nodes would silently drop on load
        if runtime is None and "tas_cache" not in runtime_kwargs:
            from kueue_tpu_torch.tas import TASCache

            runtime_kwargs["tas_cache"] = TASCache()
        elif runtime is not None and runtime.cache.tas_cache is None:
            raise ValueError(
                "state carries TAS node inventory but the provided "
                "runtime has no TAS cache"
            )
    rt = runtime if runtime is not None else ClusterRuntime(**runtime_kwargs)
    for f in data.get("resourceFlavors", []):
        rt.add_flavor(flavor_from_dict(f))
    for t in data.get("topologies", []):
        rt.add_topology(topology_from_dict(t))
    for n in data.get("nodes", []):
        rt.add_node(node_from_dict(n))
    for c in data.get("cohorts", []):
        rt.add_cohort(cohort_from_dict(c))
    for a in data.get("admissionChecks", []):
        rt.add_admission_check(check_from_dict(a))
    for p in data.get("workloadPriorityClasses", []):
        rt.add_priority_class(priority_class_from_dict(p))
    for lr in data.get("limitRanges", []):
        rt.add_limit_range(limit_range_from_dict(lr))
    for rc in data.get("runtimeClasses", []):
        rt.add_runtime_class(runtime_class_from_dict(rc))
    for c in data.get("clusterQueues", []):
        rt.add_cluster_queue(cq_from_dict(c))
    for l in data.get("localQueues", []):
        rt.add_local_queue(lq_from_dict(l))
    for w in data.get("workloads", []):
        rt.add_workload(workload_from_dict(w))
    # poison-workload quarantine (core/guard.py): sidelined heads stay
    # sidelined across restarts — the journal records them, and the
    # checkpoint must too or compaction would silently release poison
    for q in data.get("quarantine", []):
        rt.quarantine.restore(
            q["key"],
            message=q.get("message", ""),
            since=float(q.get("since", 0.0)),
            until=float(q.get("until", 0.0)),
            strikes=int(q.get("strikes", 0)),
        )
    # checkpointed admission policy (kueue_tpu_torch/policy): restore WITHOUT
    # journaling (recovery replay must not re-append), so offline
    # `kueuectl explain` replays decisions under the policy the server
    # was actually running
    pol = data.get("policy")
    if pol and hasattr(rt, "set_policy"):
        try:
            rt.set_policy(pol, journal=False)
        except ValueError:
            pass  # a newer binary's policy vocabulary: keep the default
    # persistence metadata (written by checkpoints): restore the
    # monotone mutation counter so post-recovery journal records keep
    # increasing instead of restarting from zero
    persistence = data.get("persistence") or {}
    rt.resource_version = max(
        getattr(rt, "resource_version", 0),
        int(persistence.get("resourceVersion", 0)),
    )
    return rt


def runtime_to_state(rt) -> dict:
    """Dump a live ClusterRuntime back to the wire format (the durable
    checkpoint; reference: all state lives in the API server and is
    reconstructed on restart — SURVEY §5 checkpoint/resume)."""
    out = state_to_dict(
        flavors=list(rt.cache.flavors.values()),
        cluster_queues=[c.model for c in rt.cache.cluster_queues.values()],
        local_queues=list(rt.cache.local_queues.values()),
        workloads=list(rt.workloads.values()),
        cohorts=list(rt.cache.cohorts.values()),
        checks=list(rt.cache.admission_checks.values()),
        topologies=list(rt.cache.topologies.values()),
        priority_classes=list(rt.cache.priority_classes.values()),
    )
    out["limitRanges"] = [
        limit_range_to_dict(lr) for lr in rt.limit_ranges.values()
    ]
    out["runtimeClasses"] = [
        runtime_class_to_dict(rc) for rc in rt.runtime_classes.values()
    ]
    if rt.cache.tas_cache is not None and rt.cache.tas_cache.node_inventory:
        # TAS node inventory is control-plane state here (the reference
        # watches corev1.Node; a standalone restart must not forget its
        # topology capacity)
        out["nodes"] = [
            node_to_dict(n)
            for n in rt.cache.tas_cache.node_inventory.values()
        ]
    # persistence metadata: which journal prefix this checkpoint covers
    # (recovery replays only records with seq > journalSeq) and the
    # runtime's monotone mutation counter. journal=None serializes
    # seq 0 — replay-everything, the correct degenerate case.
    policy = getattr(rt, "policy", None)
    if policy is not None and not policy.is_default:
        out["policy"] = policy.name
    journal = getattr(rt, "journal", None)
    out["persistence"] = {
        "resourceVersion": getattr(rt, "resource_version", 0),
        "journalSeq": journal.last_seq if journal is not None else 0,
    }
    if journal is not None:
        # the serving fence: a journaled leader's live /state is a
        # checkpoint a replica may anchor on, and mid-chain re-anchors
        # (fan-out trees) need the fence to survive the hop —
        # fenced_checkpoint overwrites this with its snapshot-time
        # token, so disk checkpoints are unchanged
        out["persistence"]["token"] = (
            journal.token_provider()
            if journal.token_provider is not None
            else None
        )
    quarantine = getattr(rt, "quarantine", None)
    if quarantine is not None and len(quarantine):
        out["quarantine"] = [e.to_dict() for e in quarantine.items()]
    return out


def state_to_dict(
    flavors: List[ResourceFlavor],
    cluster_queues: List[ClusterQueue],
    local_queues: List[LocalQueue],
    workloads: List[Workload],
    cohorts: Optional[List[Cohort]] = None,
    checks: Optional[List[AdmissionCheck]] = None,
    topologies: Optional[List[Topology]] = None,
    priority_classes: Optional[List[WorkloadPriorityClass]] = None,
) -> dict:
    return {
        "resourceFlavors": [flavor_to_dict(f) for f in flavors],
        "clusterQueues": [cq_to_dict(c) for c in cluster_queues],
        "localQueues": [lq_to_dict(l) for l in local_queues],
        "workloads": [workload_to_dict(w) for w in workloads],
        "cohorts": [cohort_to_dict(c) for c in cohorts or []],
        "admissionChecks": [check_to_dict(a) for a in checks or []],
        "topologies": [topology_to_dict(t) for t in topologies or []],
        "workloadPriorityClasses": [
            priority_class_to_dict(p) for p in priority_classes or []
        ],
    }
