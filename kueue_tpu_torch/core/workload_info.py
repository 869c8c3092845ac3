"""Workload admission-side helpers.

Equivalent of the reference's ``pkg/workload`` Info/usage layer: the
effective per-podset resource totals a workload requests, and the
(flavor, resource) usage vector an admitted workload occupies (from its
Admission pod-set assignments), including reclaimable-pods discounting
(pkg/workload/workload.go:153-193, usage.go, resources.go).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Tuple

from kueue_tpu_torch.models import Workload
from kueue_tpu_torch.models.workload import Admission, PodSet
from kueue_tpu_torch.resources import (
    FlavorResource,
    FlavorResourceQuantities,
    Requests,
    scale_requests,
)


RETAIN = "Retain"
REPLACE = "Replace"


@dataclass
class ResourceTransform:
    """One transformation rule (configuration_types.go:432-443)."""

    outputs: Dict[str, float] = field(default_factory=dict)
    strategy: str = RETAIN  # Retain keeps the input; Replace drops it


@dataclass
class ResourceTransformConfig:
    """resources.excludeResourcePrefixes + transformations
    (apis/config/v1beta1/configuration_types.go:418-443)."""

    exclude_prefixes: Tuple[str, ...] = ()
    transformations: Dict[str, ResourceTransform] = field(default_factory=dict)

    @staticmethod
    def from_settings(settings) -> "ResourceTransformConfig":
        """Build from config.ResourceSettings (the --config file's
        resources section)."""
        from kueue_tpu_torch.resources import quantity_to_int

        transforms = {}
        for name, spec in settings.transformations.items():
            transforms[name] = ResourceTransform(
                outputs={
                    # quantity strings ("2", "5Gi") are canonical units
                    # per unit of input (ResourceList semantics);
                    # numeric values are raw factors
                    k: (
                        float(quantity_to_int(k, v))
                        if isinstance(v, str)
                        else float(v)
                    )
                    for k, v in (spec.get("outputs") or {}).items()
                },
                strategy=spec.get("strategy", RETAIN),
            )
        return ResourceTransformConfig(
            exclude_prefixes=tuple(settings.exclude_resource_prefixes),
            transformations=transforms,
        )

    def apply(self, requests: Requests) -> Requests:
        out: Requests = {}
        for name, qty in requests.items():
            tr = self.transformations.get(name)
            if tr is not None:
                for target, factor in tr.outputs.items():
                    out[target] = out.get(target, 0) + int(qty * factor)
                if tr.strategy == REPLACE:
                    continue
            if any(name.startswith(p) for p in self.exclude_prefixes):
                continue
            out[name] = out.get(name, 0) + qty
        return out


def effective_podset_count(wl: Workload, ps: PodSet) -> int:
    """Pod count minus reclaimable pods (workload_types.go:452-459)."""
    reclaimed = wl.reclaimable_pods.get(ps.name, 0)
    return max(0, ps.count - reclaimed)


def quota_per_pod(
    ps: PodSet, transform: Optional[ResourceTransformConfig] = None
) -> Requests:
    """The per-pod quantities quota accounting sees: spec requests plus
    RuntimeClass overhead, run through excludeResourcePrefixes/
    transformations (workload.Info's TotalRequests view,
    pkg/workload/resources.go + configuration_types.go:418-443)."""
    if not ps.overhead and transform is None:
        return ps.requests  # fast path: the common case allocates nothing
    merged = dict(ps.requests)
    for k, v in ps.overhead.items():
        merged[k] = merged.get(k, 0) + v
    return transform.apply(merged) if transform else merged


def podset_requests(
    wl: Workload, ps: PodSet, transform: Optional[ResourceTransformConfig] = None
) -> Requests:
    """Total effective requests of one podset (count x per-pod)."""
    return scale_requests(
        quota_per_pod(ps, transform), effective_podset_count(wl, ps)
    )


def total_requests(
    wl: Workload, transform: Optional[ResourceTransformConfig] = None
) -> Requests:
    out: Requests = {}
    for ps in wl.pod_sets:
        for name, qty in podset_requests(wl, ps, transform).items():
            out[name] = out.get(name, 0) + qty
    return out


def admission_usage(wl: Workload) -> FlavorResourceQuantities:
    """Quota usage of an admitted workload from its PodSetAssignments.

    Uses the recorded resourceUsage scaled down for reclaimable pods,
    mirroring workload.Info updates on reclaim (dynamic reclaim frees
    quota without eviction).
    """
    usage: FlavorResourceQuantities = {}
    if wl.admission is None:
        return usage
    podsets = {ps.name: ps for ps in wl.pod_sets}
    for psa in wl.admission.pod_set_assignments:
        ps = podsets.get(psa.name)
        reclaimed = wl.reclaimable_pods.get(psa.name, 0)
        count = psa.count if psa.count else (ps.count if ps else 0)
        effective = max(0, count - reclaimed)
        for rname, flavor in psa.flavors.items():
            total = psa.resource_usage.get(rname, 0)
            if count > 0 and reclaimed > 0:
                per_pod = total // count
                total = per_pod * effective
            fr = FlavorResource(flavor, rname)
            usage[fr] = usage.get(fr, 0) + total
    return usage


def make_admission(
    cq_name: str,
    assignments: Mapping[str, Mapping[str, str]],
    wl: Workload,
    counts: Optional[Mapping[str, int]] = None,
) -> Admission:
    """Convenience builder: podset name -> {resource -> flavor}."""
    from kueue_tpu_torch.models.workload import PodSetAssignment

    podsets = {ps.name: ps for ps in wl.pod_sets}
    psas = []
    for ps_name, flavors in assignments.items():
        ps = podsets[ps_name]
        count = counts.get(ps_name, ps.count) if counts else ps.count
        usage = scale_requests(ps.requests, count)
        psas.append(
            PodSetAssignment(
                name=ps_name,
                flavors=dict(flavors),
                resource_usage={r: usage.get(r, 0) for r in ps.requests},
                count=count,
            )
        )
    return Admission(cluster_queue=cq_name, pod_set_assignments=tuple(psas))
