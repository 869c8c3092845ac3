"""Resource adjustment pipeline — LimitRange, RuntimeClass overhead,
limits-as-requests, and validation.

Behavioral port of pkg/workload/resources.go (AdjustResources /
ValidateResources / ValidateLimitRange) and pkg/util/limitrange
(Summarize + ValidatePodSpec). The granularity differs by design:
this framework's PodSet carries one per-pod request vector rather
than a pod template with containers, so Container-type LimitRange
defaults/bounds apply to the pod-level vector (a PodSet is a set of
homogeneous single-container-equivalent pods); Pod-type bounds apply to the
same vector plus overhead.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

from kueue_tpu_torch.models import Workload
from kueue_tpu_torch.resources import Requests, requests_from_spec

LIMIT_TYPE_CONTAINER = "Container"
LIMIT_TYPE_POD = "Pod"

REQUESTS_MUST_NOT_EXCEED_LIMITS = "requests must not exceed its limits"
ABOVE_MAX = "requests must not be above the limitRange max"
BELOW_MIN = "requests must not be below the limitRange min"


@dataclass
class LimitRangeItem:
    """One spec.limits entry (corev1.LimitRangeItem)."""

    type: str = LIMIT_TYPE_CONTAINER
    max: Requests = field(default_factory=dict)
    min: Requests = field(default_factory=dict)
    default: Requests = field(default_factory=dict)  # default limits
    default_request: Requests = field(default_factory=dict)

    @staticmethod
    def build(type=LIMIT_TYPE_CONTAINER, max=None, min=None, default=None,
              default_request=None) -> "LimitRangeItem":
        return LimitRangeItem(
            type=type,
            max=requests_from_spec(max or {}),
            min=requests_from_spec(min or {}),
            default=requests_from_spec(default or {}),
            default_request=requests_from_spec(default_request or {}),
        )


@dataclass
class LimitRange:
    """Namespaced LimitRange object."""

    namespace: str
    name: str
    items: List[LimitRangeItem] = field(default_factory=list)

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class RuntimeClass:
    """node.k8s.io RuntimeClass: name + pod-fixed overhead."""

    name: str
    overhead: Requests = field(default_factory=dict)

    @staticmethod
    def build(name: str, overhead=None) -> "RuntimeClass":
        return RuntimeClass(name=name, overhead=requests_from_spec(overhead or {}))


def _merge_keep_first(dst: Requests, src: Requests) -> Requests:
    """resource.MergeResourceListKeepFirst."""
    out = dict(dst)
    for k, v in src.items():
        out.setdefault(k, v)
    return out


def _merge_keep_min(dst: Requests, src: Requests) -> Requests:
    out = dict(dst)
    for k, v in src.items():
        out[k] = min(out[k], v) if k in out else v
    return out


def _merge_keep_max(dst: Requests, src: Requests) -> Requests:
    out = dict(dst)
    for k, v in src.items():
        out[k] = max(out[k], v) if k in out else v
    return out


def summarize(ranges: Iterable[LimitRange]) -> Dict[str, LimitRangeItem]:
    """limitrange.Summarize: fold every item into one per-type summary
    (max keep-min, min keep-max, defaults keep-first)."""
    out: Dict[str, LimitRangeItem] = {}
    for lr in ranges:
        for item in lr.items:
            s = out.setdefault(item.type, LimitRangeItem(type=item.type))
            s.max = _merge_keep_min(s.max, item.max)
            s.min = _merge_keep_max(s.min, item.min)
            s.default = _merge_keep_first(s.default, item.default)
            s.default_request = _merge_keep_first(
                s.default_request, item.default_request
            )
    return out


def adjust_workload_resources(
    wl: Workload,
    limit_ranges: Iterable[LimitRange] = (),
    runtime_classes: Optional[Dict[str, RuntimeClass]] = None,
) -> None:
    """workload.AdjustResources: mutate the spec in place —

    1. RuntimeClass overhead: fill podSet.overhead from the class when
       runtimeClassName is set and overhead is empty (handlePodOverhead);
    2. LimitRange Container defaults: default missing limits/requests
       (handlePodLimitRange);
    3. limits as missing requests (handleLimitsToRequests).
    """
    summary = summarize(lr for lr in limit_ranges if lr.namespace == wl.namespace)
    container = summary.get(LIMIT_TYPE_CONTAINER)
    for ps in wl.pod_sets:
        if ps.runtime_class_name and not ps.overhead and runtime_classes:
            rc = runtime_classes.get(ps.runtime_class_name)
            if rc is not None:
                ps.overhead = dict(rc.overhead)
        if container is not None:
            ps.limits = _merge_keep_first(ps.limits, container.default)
            ps.requests = _merge_keep_first(
                ps.requests, container.default_request
            )
        ps.requests = _merge_keep_first(ps.requests, ps.limits)


def _greater_keys(a: Requests, b: Requests) -> List[str]:
    """resource.GetGreaterKeys: keys present in both where a > b."""
    return sorted(k for k, v in a.items() if k in b and v > b[k])


def validate_resources(wl: Workload) -> List[str]:
    """workload.ValidateResources: requests <= limits."""
    errs: List[str] = []
    for i, ps in enumerate(wl.pod_sets):
        over = _greater_keys(ps.requests, ps.limits)
        if over:
            errs.append(
                f"spec.podSets[{i}]: {over}: {REQUESTS_MUST_NOT_EXCEED_LIMITS}"
            )
    return errs


def validate_limit_range(
    wl: Workload, limit_ranges: Iterable[LimitRange]
) -> List[str]:
    """workload.ValidateLimitRange via Summary.ValidatePodSpec: the
    per-pod vector must sit within Container bounds; the vector plus
    overhead within Pod bounds."""
    summary = summarize(lr for lr in limit_ranges if lr.namespace == wl.namespace)
    errs: List[str] = []
    container = summary.get(LIMIT_TYPE_CONTAINER)
    pod = summary.get(LIMIT_TYPE_POD)
    for i, ps in enumerate(wl.pod_sets):
        path = f"spec.podSets[{i}]"
        if container is not None:
            c_min = _merge_keep_min(ps.requests, ps.limits)
            c_max = _merge_keep_max(ps.requests, ps.limits)
            over = _greater_keys(c_max, container.max)
            if over:
                errs.append(f"{path}: {over}: {ABOVE_MAX}")
            under = _greater_keys(container.min, c_min)
            if under:
                errs.append(f"{path}: {under}: {BELOW_MIN}")
        if pod is not None:
            total = dict(ps.requests)
            for k, v in ps.overhead.items():
                total[k] = total.get(k, 0) + v
            over = _greater_keys(total, pod.max)
            if over:
                errs.append(f"{path}: {over}: {ABOVE_MAX}")
            under = _greater_keys(pod.min, total)
            if under:
                errs.append(f"{path}: {under}: {BELOW_MIN}")
    return errs
