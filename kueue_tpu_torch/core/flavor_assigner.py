"""Flavor assignment — the per-workload quota bin-pack.

Behavioral equivalent of the reference's
``pkg/scheduler/flavorassigner/flavorassigner.go``: for every podset and
resource group, walk the group's flavors (resuming from the cursor
remembered in the workload's last attempt), filter by TAS
compatibility, taints/tolerations and node-selector labels, classify
quota fit per resource into granular modes (noFit < preempt < reclaim <
fit), apply the flavor-fungibility short-circuit rules, and accumulate
the workload's usage per chosen (flavor, resource) cell.

This host-path implementation operates on the dense Snapshot (vector
availability) and is the decision oracle; ops/assign_kernel.py is the
batched jit formulation of the same search used by the TPU solver.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from kueue_tpu_torch.models import ClusterQueue, ResourceFlavor, Workload
from kueue_tpu_torch.models.cluster_queue import ResourceGroup
from kueue_tpu_torch.models.constants import (
    BorrowWithinCohortPolicy,
    FlavorFungibilityPolicy,
    ReclaimWithinCohortPolicy,
)
from kueue_tpu_torch.models.resource_flavor import (
    group_label_keys,
    selector_matches,
    taints_tolerated,
)
from kueue_tpu_torch.models.workload import (
    Admission,
    PodSet,
    PodSetAssignment,
    TopologyAssignment,
)
from kueue_tpu_torch.core.snapshot import Snapshot
from kueue_tpu_torch.core.workload_info import effective_podset_count
from kueue_tpu_torch.resources import PODS, FlavorResource, FlavorResourceQuantities, Requests


class Mode(IntEnum):
    """Public assignment modes, lowest to highest preference."""

    NO_FIT = 0
    PREEMPT = 1
    FIT = 2


def normalize_reasons(reasons: Sequence[str]) -> List[str]:
    """Canonical presentation order for rejection reasons: sorted and
    de-duplicated. The flavor walk appends reasons in iteration order
    (which differs between the cursor-resume and fresh-start paths and
    between host and device nomination), so decision records, condition
    messages and events all normalize through here to stay byte-stable
    across runs and resolution paths."""
    return sorted(set(reasons))


class GranularMode(IntEnum):
    """Internal modes distinguishing cohort reclamation from preemption."""

    NO_FIT = 0
    PREEMPT = 1
    RECLAIM = 2
    FIT = 3

    def public(self) -> Mode:
        if self == GranularMode.FIT:
            return Mode.FIT
        if self in (GranularMode.PREEMPT, GranularMode.RECLAIM):
            return Mode.PREEMPT
        return Mode.NO_FIT


@dataclass
class FlavorChoice:
    name: str
    mode: GranularMode
    tried_flavor_idx: int = -1
    borrow: bool = False


@dataclass
class PodSetResult:
    name: str
    count: int
    flavors: Dict[str, FlavorChoice] = field(default_factory=dict)
    reasons: List[str] = field(default_factory=list)
    topology_assignment: Optional[TopologyAssignment] = None

    def representative_mode(self) -> Mode:
        if not self.flavors:
            return Mode.NO_FIT if self.reasons else Mode.FIT
        mode = Mode.FIT
        for choice in self.flavors.values():
            mode = min(mode, choice.mode.public())
        return mode

    def update_mode(self, new_mode: GranularMode) -> None:
        for choice in self.flavors.values():
            choice.mode = new_mode


@dataclass
class AssignmentState:
    """LastAssignment analog (workload.AssignmentClusterQueueState)."""

    last_tried_flavor_idx: List[Dict[str, int]] = field(default_factory=list)
    cluster_queue_generation: int = 0

    def pending_flavors(self) -> bool:
        """True if some podset resource still has untried flavors."""
        return any(
            idx != -1
            for per_ps in self.last_tried_flavor_idx
            for idx in per_ps.values()
        )

    def next_flavor_to_try(self, ps_idx: int, resource: str) -> int:
        if ps_idx < len(self.last_tried_flavor_idx):
            last = self.last_tried_flavor_idx[ps_idx].get(resource, -1)
            return last + 1
        return 0


@dataclass
class AssignmentResult:
    pod_sets: List[PodSetResult]
    borrowing: bool = False
    usage: FlavorResourceQuantities = field(default_factory=dict)
    last_state: Optional[AssignmentState] = None

    def representative_mode(self) -> Mode:
        if not self.pod_sets:
            return Mode.NO_FIT
        return min((ps.representative_mode() for ps in self.pod_sets), default=Mode.NO_FIT)

    def message(self) -> str:
        parts = []
        for ps in self.pod_sets:
            # score-outranked reasons (kueue_tpu/policy) are
            # informational — the flavor FIT, a higher-scoring flavor
            # won — so they ride flavor_reasons/the audit trail but
            # never the blocking inadmissibility message (an Admitted
            # decision must not read "couldn't assign")
            blocking = [
                r
                for r in normalize_reasons(ps.reasons)
                if " lost on score to " not in r
            ]
            if blocking:
                parts.append(
                    f"couldn't assign flavors to pod set {ps.name}: "
                    + ", ".join(blocking)
                )
        return "; ".join(parts)

    def to_admission(
        self, cq_name: str, wl: Workload, transform=None
    ) -> Admission:
        podsets = {ps.name: ps for ps in wl.pod_sets}
        psas = []
        for psr in self.pod_sets:
            ps = podsets[psr.name]
            scaled = _scaled_requests(wl, ps, psr.count, transform)
            if PODS in psr.flavors:
                # the implicit pods resource is charged too
                scaled[PODS] = psr.count
            psas.append(
                PodSetAssignment(
                    name=psr.name,
                    flavors={r: c.name for r, c in psr.flavors.items()},
                    resource_usage=scaled,
                    count=psr.count,
                    topology_assignment=psr.topology_assignment,
                )
            )
        return Admission(cluster_queue=cq_name, pod_set_assignments=tuple(psas))


def _scaled_requests(
    wl: Workload, ps: PodSet, count: int, transform=None
) -> Requests:
    from kueue_tpu_torch.core.workload_info import quota_per_pod

    return {r: v * count for r, v in quota_per_pod(ps, transform).items()}


# TAS compatibility hook: (cq, podset, flavor) -> error message or None.
TASCheck = Callable[[ClusterQueue, PodSet, ResourceFlavor], Optional[str]]
# Preemption oracle: (cq_name, wl, fr, quantity) -> reclaim possible?
ReclaimOracle = Callable[[str, Workload, FlavorResource, int], bool]


class FlavorAssigner:
    def __init__(
        self,
        snapshot: Snapshot,
        flavors: Dict[str, ResourceFlavor],
        enable_fair_sharing: bool = False,
        reclaim_oracle: Optional[ReclaimOracle] = None,
        tas_check: Optional[TASCheck] = None,
        flavor_fungibility_enabled: bool = True,
        transform=None,  # ResourceTransformConfig for the quota view
        policy=None,  # kueue_tpu/policy AdmissionPolicy: with a scoring
        #               policy the walk evaluates EVERY stop-eligible
        #               flavor and picks the best score (ties keep walk
        #               order); fitting-but-outranked flavors get the
        #               canonical ScoreOutrankedFlavor reason
    ):
        self.snapshot = snapshot
        self.flavors = flavors
        self.enable_fair_sharing = enable_fair_sharing
        self.reclaim_oracle = reclaim_oracle or (lambda cq, wl, fr, q: False)
        self.tas_check = tas_check
        self.fungibility_enabled = flavor_fungibility_enabled
        self.transform = transform
        self.policy = policy

    @property
    def _scoring(self) -> bool:
        return self.policy is not None and not self.policy.is_default

    # ---- public entry (flavorassigner.go:367-379) ----
    def assign(
        self, wl: Workload, cq_name: str, counts: Optional[Sequence[int]] = None
    ) -> AssignmentResult:
        cq = self.snapshot.cq_models[cq_name]
        gen = self.snapshot.generations.get(cq_name, 0)
        state: Optional[AssignmentState] = wl.last_assignment
        if state is not None and gen > state.cluster_queue_generation:
            # AllocatableResourceGeneration moved: the remembered flavor
            # cursor is stale (flavorassigner.go:359-377).
            wl.last_assignment = None
            state = None
        return self._assign_flavors(wl, cq, cq_name, state, counts, gen)

    def _assign_flavors(
        self,
        wl: Workload,
        cq: ClusterQueue,
        cq_name: str,
        state: Optional[AssignmentState],
        counts: Optional[Sequence[int]],
        generation: int,
    ) -> AssignmentResult:
        result = AssignmentResult(pod_sets=[])
        new_state = AssignmentState(cluster_queue_generation=generation)
        assignment_usage: FlavorResourceQuantities = {}

        rg_by_resource = self._rg_index(cq)

        for ps_idx, ps in enumerate(wl.pod_sets):
            count = counts[ps_idx] if counts is not None else effective_podset_count(wl, ps)
            requests = _scaled_requests(wl, ps, count, self.transform)
            if PODS in rg_by_resource:
                requests[PODS] = count

            psr = PodSetResult(name=ps.name, count=count)
            failed = False
            for res_name in sorted(requests):
                if res_name in psr.flavors:
                    continue  # assigned together with its resource group
                choices, reasons = self._find_flavor_for_resource(
                    wl, cq, cq_name, ps, ps_idx, requests, res_name,
                    assignment_usage, state, rg_by_resource,
                )
                psr.reasons.extend(reasons)
                if not choices:
                    psr.flavors = {}
                    failed = True
                    break
                psr.flavors.update(choices)

            # accumulate usage + cursor state
            flavor_idx: Dict[str, int] = {}
            for res, choice in psr.flavors.items():
                if choice.borrow:
                    result.borrowing = True
                fr = FlavorResource(choice.name, res)
                result.usage[fr] = result.usage.get(fr, 0) + requests.get(res, 0)
                assignment_usage[fr] = assignment_usage.get(fr, 0) + requests.get(res, 0)
                flavor_idx[res] = choice.tried_flavor_idx
            new_state.last_tried_flavor_idx.append(flavor_idx)

            # store normalized (sorted, de-duplicated) reasons so every
            # consumer — message(), decision records, events — sees the
            # same stable ordering regardless of flavor-walk order
            psr.reasons = normalize_reasons(psr.reasons)
            result.pod_sets.append(psr)
            if failed or (requests and not psr.flavors):
                result.last_state = new_state
                return result

        result.last_state = new_state
        return result

    def _rg_index(self, cq: ClusterQueue) -> Dict[str, ResourceGroup]:
        out: Dict[str, ResourceGroup] = {}
        for rg in cq.resource_groups:
            for r in rg.covered_resources:
                out[r] = rg
        return out

    # ---- per-resource-group flavor search (flavorassigner.go:499-618) ----
    def _find_flavor_for_resource(
        self,
        wl: Workload,
        cq: ClusterQueue,
        cq_name: str,
        ps: PodSet,
        ps_idx: int,
        requests: Requests,
        res_name: str,
        assignment_usage: FlavorResourceQuantities,
        state: Optional[AssignmentState],
        rg_by_resource: Dict[str, ResourceGroup],
    ) -> Tuple[Dict[str, FlavorChoice], List[str]]:
        rg = rg_by_resource.get(res_name)
        if rg is None:
            return {}, [f"resource {res_name} unavailable in ClusterQueue"]

        group_requests = {
            r: v for r, v in requests.items() if r in rg.covered_resources
        }
        reasons: List[str] = []
        best: Dict[str, FlavorChoice] = {}
        best_mode = GranularMode.NO_FIT

        label_keys = group_label_keys(rg.flavors, self.flavors)

        start = state.next_flavor_to_try(ps_idx, res_name) if state else 0
        attempted_idx = -1
        avail_row = None  # computed lazily once
        scoring = self._scoring and self.fungibility_enabled
        # scored walk: (idx, flavor, assignments, mode) of every flavor
        # the default walk would have STOPPED at — the policy argmaxes
        # over them instead of taking the first
        stops: List = []
        outranked: List[str] = []
        for idx in range(start, len(rg.flavors)):
            attempted_idx = idx
            f_name = rg.flavors[idx].name
            flavor = self.flavors.get(f_name)
            if flavor is None:
                reasons.append(f"flavor {f_name} not found")
                continue
            if self.tas_check is not None:
                msg = self.tas_check(cq, ps, flavor)
                if msg is not None:
                    reasons.append(msg)
                    continue
            if not taints_tolerated(
                flavor.node_taints, tuple(ps.tolerations) + tuple(flavor.tolerations)
            ):
                reasons.append(f"untolerated taint in flavor {f_name}")
                continue
            if not selector_matches(ps.node_selector, flavor, label_keys):
                reasons.append(f"flavor {f_name} doesn't match node affinity")
                continue

            needs_borrowing = False
            assignments: Dict[str, FlavorChoice] = {}
            representative = GranularMode.FIT
            if avail_row is None:
                avail_row = self.snapshot.available_for(cq_name)
                potential_row = self.snapshot.potential_available()[self.snapshot.row(cq_name)]
                usage_row = self.snapshot.local_usage[self.snapshot.row(cq_name)]
                nominal_row = self.snapshot.nominal[self.snapshot.row(cq_name)]
            for r_name, val in group_requests.items():
                fr = FlavorResource(f_name, r_name)
                j = self.snapshot.fr_index.get(fr)
                total = val + assignment_usage.get(fr, 0)
                mode, borrow, reason = self._fits_resource_quota(
                    cq, cq_name, fr, j, total,
                    avail_row, potential_row, usage_row, nominal_row, wl,
                )
                if reason:
                    reasons.append(reason)
                representative = min(representative, mode)
                needs_borrowing = needs_borrowing or borrow
                if representative == GranularMode.NO_FIT:
                    break
                assignments[r_name] = FlavorChoice(name=f_name, mode=mode, borrow=borrow)

            if self.fungibility_enabled:
                if not _should_try_next_flavor(
                    representative, cq.flavor_fungibility, needs_borrowing
                ):
                    if scoring:
                        # don't stop: the policy ranks every stop-
                        # eligible flavor after the full walk
                        stops.append(
                            (idx, f_name, assignments, representative)
                        )
                        if representative > best_mode:
                            best = assignments
                            best_mode = representative
                        continue
                    best = assignments
                    best_mode = representative
                    break
                if representative > best_mode:
                    best = assignments
                    best_mode = representative
            else:
                if representative > best_mode:
                    best = assignments
                    best_mode = representative
                    if best_mode == GranularMode.FIT:
                        return best, []

        if scoring and stops:
            ranked = [
                (self.policy.candidate_score(wl, (fn,)), -i, i, fn, asg, rep)
                for (i, fn, asg, rep) in stops
            ]
            fit_ranked = [t for t in ranked if t[5] == GranularMode.FIT]
            pool = fit_ranked or ranked
            winner = max(pool)  # highest score, ties -> earliest flavor
            best, best_mode = winner[4], winner[5]
            for t in fit_ranked:
                if t[2] != winner[2]:
                    outranked.append(
                        f"flavor {t[3]} fits but lost on score to "
                        f"flavor {winner[3]} under policy "
                        f"{self.policy.name} ({t[0]} vs {winner[0]})"
                    )
            reasons.extend(outranked)
        if self.fungibility_enabled:
            n_flavors = len(rg.flavors)
            tried = -1 if attempted_idx == n_flavors - 1 else attempted_idx
            for choice in best.values():
                choice.tried_flavor_idx = tried
            if best_mode == GranularMode.FIT:
                return best, list(outranked)
        if not best and not reasons:
            # No flavor was attempted (exhausted cursor with no retryable
            # flavor); never report an empty-reason failure, which would
            # read as Fit upstream.
            reasons.append(
                f"no flavor of resource group for {res_name} could be attempted"
            )
        return best, reasons

    # ---- quota fit classification (flavorassigner.go:692-726) ----
    def _fits_resource_quota(
        self,
        cq: ClusterQueue,
        cq_name: str,
        fr: FlavorResource,
        j: Optional[int],
        val: int,
        avail_row: np.ndarray,
        potential_row: np.ndarray,
        usage_row: np.ndarray,
        nominal_row: np.ndarray,
        wl: Workload,
    ) -> Tuple[GranularMode, bool, Optional[str]]:
        if j is None:
            return (
                GranularMode.NO_FIT,
                False,
                f"no quota defined for {fr.resource} in flavor {fr.flavor}",
            )
        borrow = bool(usage_row[j] + val > nominal_row[j]) and self.snapshot.has_cohort(cq_name)
        available = max(0, int(avail_row[j]))
        max_capacity = int(potential_row[j])

        if val > max_capacity:
            return (
                GranularMode.NO_FIT,
                False,
                f"insufficient quota for {fr.resource} in flavor {fr.flavor},"
                f" request > maximum capacity ({val} > {max_capacity})",
            )
        if val <= available:
            return GranularMode.FIT, borrow, None

        mode = GranularMode.NO_FIT
        if val <= int(nominal_row[j]):
            mode = GranularMode.PREEMPT
            if self.reclaim_oracle(cq_name, wl, fr, val):
                mode = GranularMode.RECLAIM
        elif self._can_preempt_while_borrowing(cq):
            mode = GranularMode.PREEMPT
        return (
            mode,
            borrow,
            f"insufficient unused quota for {fr.resource} in flavor {fr.flavor},"
            f" {val - available} more needed",
        )

    def _can_preempt_while_borrowing(self, cq: ClusterQueue) -> bool:
        return (
            cq.preemption.borrow_within_cohort.policy != BorrowWithinCohortPolicy.NEVER
            or (
                self.enable_fair_sharing
                and cq.preemption.reclaim_within_cohort != ReclaimWithinCohortPolicy.NEVER
            )
        )


def _should_try_next_flavor(
    representative: GranularMode,
    fungibility,
    needs_borrowing: bool,
) -> bool:
    """flavorassigner.go:620-638."""
    policy_preempt = fungibility.when_can_preempt
    policy_borrow = fungibility.when_can_borrow
    if representative in (GranularMode.PREEMPT, GranularMode.RECLAIM) and (
        policy_preempt == FlavorFungibilityPolicy.PREEMPT
    ):
        if not needs_borrowing or policy_borrow == FlavorFungibilityPolicy.BORROW:
            return False
    if (
        representative == GranularMode.FIT
        and needs_borrowing
        and policy_borrow == FlavorFungibilityPolicy.BORROW
    ):
        return False
    if representative == GranularMode.FIT and not needs_borrowing:
        return False
    return True


def find_max_counts(
    assign_fn: Callable[[Sequence[int]], AssignmentResult],
    wl: Workload,
) -> Optional[List[int]]:
    """Partial-admission search, mirroring the reference's reducer
    exactly (podset_reducer.go:56-86): scale DOWN from the full counts
    by ``delta_j * i / totalDelta`` and binary-search the smallest
    reduction index i whose assignment fits — the per-unit granularity
    makes the found total exact (e.g. the reducer's 150k-pod cases),
    where a fixed-denominator fraction would under-shoot."""
    full = [effective_podset_count(wl, ps) for ps in wl.pod_sets]
    mins = [
        ps.min_count if ps.min_count is not None else effective_podset_count(wl, ps)
        for ps in wl.pod_sets
    ]
    deltas = [f - m for f, m in zip(full, mins)]
    total_delta = sum(deltas)
    if total_delta == 0:
        return None

    def counts_at(i: int) -> List[int]:
        return [f - d * i // total_delta for f, d in zip(full, deltas)]

    # Go sort.Search: smallest i in [0, totalDelta] with fit(i); the
    # last-good check detects a non-monotone predicate the same way the
    # reference's `idx == lastGoodIdx` does
    last_good = -1
    lo, hi = 0, total_delta + 1
    while lo < hi:
        mid = (lo + hi) // 2
        if assign_fn(counts_at(mid)).representative_mode() == Mode.FIT:
            last_good = mid
            hi = mid
        else:
            lo = mid + 1
    if lo > total_delta or lo != last_good:
        return None
    return counts_at(lo)
