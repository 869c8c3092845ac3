"""Preemption — classic minimal-set and fair-sharing victim search.

Behavioral equivalent of ``pkg/scheduler/preemption``:

- candidate discovery respecting withinClusterQueue / reclaimWithinCohort
  policies and the flavor-resources actually needing preemption
  (preemption.go:480-524)
- candidate ordering: evicted first, other-CQ first, lowest priority,
  most recently reserved (preemption.go:591-618)
- classic strategy ladder: same-queue-with-borrowing /
  borrowWithinCohort thresholds / cohort-reclaim-without-borrowing /
  same-queue fallback (preemption.go:144-191)
- minimalPreemptions remove-then-fill-back heuristic over the snapshot
  (preemption.go:275-342) — here simulate/undo is vector add/sub on the
  dense usage matrix instead of object-graph mutation
- fair sharing: the cohort-tree tournament picking the highest-DRS
  subtree, almost-LCA share comparisons, strategies S2-a
  (LessThanOrEqualToFinalShare) and S2-b (LessThanInitialShare)
  (fairsharing/ordering.go, least_common_ancestor.go, strategy.go)
- the reclaim oracle answering flavor assignment's "is reclaim
  possible" (preemption_oracle.go)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from kueue_tpu_torch.models import Workload
from kueue_tpu_torch.models.constants import (
    EVICTED_BY_PREEMPTION,
    BorrowWithinCohortPolicy,
    PreemptionPolicy,
    ReclaimWithinCohortPolicy,
    WorkloadConditionType,
)
from kueue_tpu_torch.core.flavor_assigner import AssignmentResult, Mode
from kueue_tpu_torch.core.queue_manager import RequeueTimestamp, queue_order_timestamp
from kueue_tpu_torch.core.scheduler import PreemptionTarget, Preemptor as PreemptorBase
from kueue_tpu_torch.core.snapshot import Snapshot, WorkloadSnapshot
from kueue_tpu_torch.resources import FlavorResource
from kueue_tpu_torch.utils.clock import Clock

# Preemption reasons (workload_types.go Preempted condition reasons).
IN_CLUSTER_QUEUE = "InClusterQueue"
IN_COHORT_RECLAMATION = "InCohortReclamation"
IN_COHORT_FAIR_SHARING = "InCohortFairSharing"
IN_COHORT_RECLAIM_WHILE_BORROWING = "InCohortReclaimWhileBorrowing"

# Fair-sharing preemption strategies (config fairSharing.preemptionStrategies).
LESS_THAN_OR_EQUAL_TO_FINAL_SHARE = "LessThanOrEqualToFinalShare"
LESS_THAN_INITIAL_SHARE = "LessThanInitialShare"


@dataclass
class _Ctx:
    preemptor: Workload
    cq_name: str
    cq_row: int
    snapshot: Snapshot
    frs_need_preemption: Set[FlavorResource]
    usage_vec: np.ndarray


def can_always_reclaim(cq) -> bool:
    """preemption.CanAlwaysReclaim: reclaimWithinCohort=Any guarantees
    capacity can be taken back later, so no reservation is needed."""
    return cq.preemption.reclaim_within_cohort == ReclaimWithinCohortPolicy.ANY


class Preemptor(PreemptorBase):
    def __init__(
        self,
        clock: Clock,
        enable_fair_sharing: bool = False,
        fs_strategies: Optional[Sequence[str]] = None,
        apply_preemption: Optional[Callable[[Workload, str, str], bool]] = None,
        timestamp_policy: RequeueTimestamp = RequeueTimestamp.EVICTION,
        events: Optional[Callable[[str, Workload, str], None]] = None,
    ):
        self.clock = clock
        self.enable_fair_sharing = enable_fair_sharing
        self.fs_strategies = list(
            fs_strategies
            or [LESS_THAN_OR_EQUAL_TO_FINAL_SHARE, LESS_THAN_INITIAL_SHARE]
        )
        self.apply_preemption = apply_preemption or (lambda wl, reason, msg: True)
        self._ts_policy = timestamp_policy
        self.events = events or (lambda kind, wl, msg: None)
        # (preempting_cq, reason, victim) -> None; set by the runtime to
        # report preempted_workloads_total / evicted_workloads_total
        self.metrics_hook = None
        # admission policy (kueue_tpu/policy): PREMA-style victim-cost
        # adjustments in the candidate ordering; None/first-fit = the
        # unadjusted reference order
        self.policy = None

    # ---- entry point (preemption.go:127-191) ----
    def get_targets(
        self, wl: Workload, cq_name: str, assignment: AssignmentResult, snapshot: Snapshot
    ) -> List[PreemptionTarget]:
        frs = self._frs_need_preemption(assignment)
        ctx = _Ctx(
            preemptor=wl,
            cq_name=cq_name,
            cq_row=snapshot.row(cq_name),
            snapshot=snapshot,
            frs_need_preemption=frs,
            usage_vec=snapshot.vector_of(assignment.usage),
        )
        return self._get_targets(ctx)

    def _get_targets(self, ctx: _Ctx) -> List[PreemptionTarget]:
        candidates = self._find_candidates(ctx)
        if not candidates:
            return []
        candidates.sort(key=self._candidate_key(ctx))
        if self.enable_fair_sharing:
            return self._fair_preemptions(ctx, candidates)

        cq = ctx.snapshot.cq_models[ctx.cq_name]
        same_queue = [c for c in candidates if c.cq_name == ctx.cq_name]

        if len(same_queue) == len(candidates):
            return self._minimal_preemptions(ctx, candidates, True, None)

        allowed, threshold = self._can_borrow_within_cohort(cq, ctx)
        if allowed:
            if not self._queue_under_nominal(ctx):
                candidates = [
                    c
                    for c in candidates
                    if c.cq_name == ctx.cq_name or c.priority < threshold
                ]
            return self._minimal_preemptions(ctx, candidates, True, threshold)

        if self._queue_under_nominal(ctx):
            targets = self._minimal_preemptions(ctx, candidates, False, None)
            if targets:
                return targets

        return self._minimal_preemptions(ctx, same_queue, True, None)

    # ---- issue (preemption.go:232-265) ----
    def issue_preemptions(
        self, preemptor: Workload, targets: List[PreemptionTarget],
        preempting_cq: str = "",
    ) -> int:
        count = 0
        now = self.clock.now()
        for t in targets:
            wl = t.workload.workload
            if wl.condition_true(WorkloadConditionType.EVICTED):
                count += 1  # preemption already ongoing
                continue
            msg = (
                f"Preempted to accommodate a workload (UID: {preemptor.uid}) "
                f"due to {t.reason}"
            )
            if self.apply_preemption(wl, t.reason, msg):
                wl.set_condition(
                    WorkloadConditionType.EVICTED, True,
                    reason=EVICTED_BY_PREEMPTION, message=msg, now=now,
                )
                wl.set_condition(
                    WorkloadConditionType.PREEMPTED, True,
                    reason=t.reason, message=msg, now=now,
                )
                # checks reset on eviction (ResetChecksOnEviction)
                for st in wl.admission_check_states.values():
                    from kueue_tpu_torch.models.constants import AdmissionCheckStateType

                    st.state = AdmissionCheckStateType.PENDING
                self.events("Preempted", wl, msg)
                if self.metrics_hook is not None:
                    self.metrics_hook(preempting_cq, t.reason, wl)
                count += 1
        return count

    # ---- oracle (preemption_oracle.go) ----
    def is_reclaim_possible(
        self, snapshot: Snapshot, cq_name: str, wl: Optional[Workload], fr: FlavorResource, quantity: int
    ) -> bool:
        j = snapshot.fr_index.get(fr)
        if j is None:
            return False
        r = snapshot.row(cq_name)
        if int(snapshot.local_usage[r, j]) + quantity > int(snapshot.nominal[r, j]):
            return False  # would borrow: not pure reclamation
        usage_vec = np.zeros(len(snapshot.fr_list), dtype=np.int64)
        usage_vec[j] = quantity
        ctx = _Ctx(
            preemptor=wl,
            cq_name=cq_name,
            cq_row=r,
            snapshot=snapshot,
            frs_need_preemption={fr},
            usage_vec=usage_vec,
        )
        for t in self._get_targets(ctx):
            if t.workload.cq_name == cq_name:
                return False
        return True

    # ---- candidates (preemption.go:480-547) ----
    def _frs_need_preemption(self, assignment: AssignmentResult) -> Set[FlavorResource]:
        out: Set[FlavorResource] = set()
        for ps in assignment.pod_sets:
            for res, choice in ps.flavors.items():
                if choice.mode.public() == Mode.PREEMPT:
                    out.add(FlavorResource(choice.name, res))
        return out

    def _workload_uses(self, ws: WorkloadSnapshot, frs: Set[FlavorResource]) -> bool:
        if ws.workload.admission is None:
            return False
        for psa in ws.workload.admission.pod_set_assignments:
            for res, flavor in psa.flavors.items():
                if FlavorResource(flavor, res) in frs:
                    return True
        return False

    def _cq_is_borrowing(
        self, snapshot: Snapshot, cq_name: str, frs: Set[FlavorResource]
    ) -> bool:
        if not snapshot.has_cohort(cq_name):
            return False
        r = snapshot.row(cq_name)
        for fr in frs:
            j = snapshot.fr_index.get(fr)
            if j is not None and int(snapshot.local_usage[r, j]) > int(
                snapshot.nominal[r, j]
            ):
                return True
        return False

    def _find_candidates(self, ctx: _Ctx) -> List[WorkloadSnapshot]:
        snapshot = ctx.snapshot
        cq = snapshot.cq_models[ctx.cq_name]
        out: List[WorkloadSnapshot] = []
        from kueue_tpu_torch.utils.priority import priority_of

        wl_priority = priority_of(ctx.preemptor, snapshot.priority_classes)
        preemptor_ts = queue_order_timestamp(ctx.preemptor, self._ts_policy)

        if cq.preemption.within_cluster_queue != PreemptionPolicy.NEVER:
            consider_same_prio = (
                cq.preemption.within_cluster_queue
                == PreemptionPolicy.LOWER_OR_NEWER_EQUAL_PRIORITY
            )
            for ws in snapshot.workloads_in_cq(ctx.cq_name):
                if ws.priority > wl_priority:
                    continue
                if ws.priority == wl_priority and not (
                    consider_same_prio
                    and preemptor_ts
                    < queue_order_timestamp(ws.workload, self._ts_policy)
                ):
                    continue
                if not self._workload_uses(ws, ctx.frs_need_preemption):
                    continue
                out.append(ws)

        if (
            snapshot.has_cohort(ctx.cq_name)
            and cq.preemption.reclaim_within_cohort != ReclaimWithinCohortPolicy.NEVER
        ):
            only_lower = (
                cq.preemption.reclaim_within_cohort != ReclaimWithinCohortPolicy.ANY
            )
            for member in snapshot.cohort_members(ctx.cq_name):
                if member == ctx.cq_name:
                    continue
                if not self._cq_is_borrowing(snapshot, member, ctx.frs_need_preemption):
                    continue
                for ws in snapshot.workloads_in_cq(member):
                    if only_lower and ws.priority >= wl_priority:
                        continue
                    if not self._workload_uses(ws, ctx.frs_need_preemption):
                        continue
                    out.append(ws)
        return out

    def _candidate_key(self, ctx: _Ctx):
        policy = self.policy
        scoring = policy is not None and not policy.is_default

        def key(ws: WorkloadSnapshot):
            evicted = ws.workload.condition_true(WorkloadConditionType.EVICTED)
            in_cq = ws.cq_name == ctx.cq_name
            # PREMA victim-cost adjustment (kueue_tpu/policy): between
            # the (evicted, other-CQ) tiers and priority; zero under
            # the default policy, so the order is exactly the
            # reference's (preemption.go:591-618)
            adjust = (
                policy.victim_cost_adjust(ws.workload) if scoring else 0
            )
            return (
                0 if evicted else 1,
                0 if not in_cq else 1,
                adjust,
                ws.priority,
                -ws.quota_reserved_time,
                ws.workload.uid,
            )

        return key

    def _can_borrow_within_cohort(self, cq, ctx: _Ctx) -> Tuple[bool, Optional[int]]:
        policy = cq.preemption.borrow_within_cohort
        if policy.policy == BorrowWithinCohortPolicy.NEVER:
            return False, None
        from kueue_tpu_torch.utils.priority import priority_of

        threshold = priority_of(ctx.preemptor, ctx.snapshot.priority_classes)
        if (
            policy.max_priority_threshold is not None
            and policy.max_priority_threshold < threshold
        ):
            threshold = policy.max_priority_threshold + 1
        return True, threshold

    def _queue_under_nominal(self, ctx: _Ctx) -> bool:
        """True if the CQ is under nominal quota in every resource
        needing preemption (preemption.go:576-583)."""
        r = ctx.cq_row
        for fr in ctx.frs_need_preemption:
            j = ctx.snapshot.fr_index.get(fr)
            if j is not None and int(ctx.snapshot.local_usage[r, j]) >= int(
                ctx.snapshot.nominal[r, j]
            ):
                return False
        return True

    # ---- fit check under simulation (preemption.go:552-574) ----
    def _workload_fits(self, ctx: _Ctx, allow_borrowing: bool) -> bool:
        snapshot = ctx.snapshot
        r = ctx.cq_row
        avail = snapshot.available()[r]
        need = ctx.usage_vec > 0
        if not allow_borrowing:
            after = snapshot.local_usage[r] + ctx.usage_vec
            if bool(np.any((after > snapshot.nominal[r]) & need)):
                return False
        return bool(np.all(np.maximum(avail, 0)[need] >= ctx.usage_vec[need]))

    # ---- classic minimal preemptions (preemption.go:275-342) ----
    def _minimal_preemptions(
        self,
        ctx: _Ctx,
        candidates: List[WorkloadSnapshot],
        allow_borrowing: bool,
        allow_borrowing_below_priority: Optional[int],
    ) -> List[PreemptionTarget]:
        snapshot = ctx.snapshot
        targets: List[PreemptionTarget] = []
        fits = False
        for ws in candidates:
            reason = IN_CLUSTER_QUEUE
            if ws.cq_name != ctx.cq_name:
                if not self._cq_is_borrowing(
                    snapshot, ws.cq_name, ctx.frs_need_preemption
                ):
                    continue
                reason = IN_COHORT_RECLAMATION
                if allow_borrowing_below_priority is not None:
                    if ws.priority >= allow_borrowing_below_priority:
                        allow_borrowing = False
                    else:
                        reason = IN_COHORT_RECLAIM_WHILE_BORROWING
            snapshot.remove_workload(ws.workload.key)
            targets.append(PreemptionTarget(workload=ws, reason=reason))
            if self._workload_fits(ctx, allow_borrowing):
                fits = True
                break
        if not fits:
            self._restore(snapshot, targets)
            return []
        targets = self._fill_back(ctx, targets, allow_borrowing)
        self._restore(snapshot, targets)
        return targets

    def _fill_back(
        self, ctx: _Ctx, targets: List[PreemptionTarget], allow_borrowing: bool
    ) -> List[PreemptionTarget]:
        snapshot = ctx.snapshot
        i = len(targets) - 2
        while i >= 0:
            snapshot.add_workload(targets[i].workload)
            if self._workload_fits(ctx, allow_borrowing):
                targets[i] = targets[-1]
                targets.pop()
            else:
                snapshot.remove_workload(targets[i].workload.workload.key)
            i -= 1
        return targets

    def _restore(self, snapshot: Snapshot, targets: List[PreemptionTarget]) -> None:
        for t in targets:
            snapshot.add_workload(t.workload)

    # ---- fair sharing (preemption.go:372-463 + fairsharing/) ----
    def _fair_preemptions(
        self, ctx: _Ctx, candidates: List[WorkloadSnapshot]
    ) -> List[PreemptionTarget]:
        snapshot = ctx.snapshot
        # DRS values must include the incoming workload's usage.
        snapshot.add_usage(ctx.cq_name, ctx.usage_vec)
        try:
            fits, targets, retry = self._run_first_fs_strategy(
                ctx, candidates, self.fs_strategies[0]
            )
            if not fits and len(self.fs_strategies) > 1:
                fits, targets = self._run_second_fs_strategy(ctx, retry, targets)
        finally:
            snapshot.remove_usage(ctx.cq_name, ctx.usage_vec)
        if not fits:
            self._restore(snapshot, targets)
            return []
        targets = self._fill_back(ctx, targets, True)
        self._restore(snapshot, targets)
        return targets

    def _fits_for_fair_sharing(self, ctx: _Ctx) -> bool:
        ctx.snapshot.remove_usage(ctx.cq_name, ctx.usage_vec)
        try:
            return self._workload_fits(ctx, True)
        finally:
            ctx.snapshot.add_usage(ctx.cq_name, ctx.usage_vec)

    def _run_first_fs_strategy(
        self, ctx: _Ctx, candidates: List[WorkloadSnapshot], strategy: str
    ):
        snapshot = ctx.snapshot
        targets: List[PreemptionTarget] = []
        retry: List[WorkloadSnapshot] = []
        ordering = _CohortTournament(ctx, candidates)
        while True:
            pick = ordering.next_target()
            if pick is None:
                return False, targets, retry
            if pick == ctx.cq_row:
                ws = ordering.pop_workload(pick)
                snapshot.remove_workload(ws.workload.key)
                targets.append(PreemptionTarget(workload=ws, reason=IN_CLUSTER_QUEUE))
                if self._fits_for_fair_sharing(ctx):
                    return True, targets, retry
                continue

            preemptor_share, target_old_share = ordering.compute_shares(pick)
            while ordering.has_workload(pick):
                ws = ordering.pop_workload(pick)
                snapshot.remove_workload(ws.workload.key)
                target_new_share = ordering.almost_lca_drs(pick)
                snapshot.add_workload(ws)
                if _strategy_allows(
                    strategy, preemptor_share, target_old_share, target_new_share
                ):
                    snapshot.remove_workload(ws.workload.key)
                    targets.append(
                        PreemptionTarget(workload=ws, reason=IN_COHORT_FAIR_SHARING)
                    )
                    if self._fits_for_fair_sharing(ctx):
                        return True, targets, retry
                    break  # re-pick the CQ: shares changed
                retry.append(ws)

    def _run_second_fs_strategy(
        self, ctx: _Ctx, retry: List[WorkloadSnapshot], targets: List[PreemptionTarget]
    ):
        snapshot = ctx.snapshot
        ordering = _CohortTournament(ctx, retry)
        while True:
            pick = ordering.next_target()
            if pick is None:
                return False, targets
            preemptor_share, target_old_share = ordering.compute_shares(pick)
            if preemptor_share < target_old_share:
                ws = ordering.pop_workload(pick)
                snapshot.remove_workload(ws.workload.key)
                targets.append(
                    PreemptionTarget(workload=ws, reason=IN_COHORT_FAIR_SHARING)
                )
                if self._fits_for_fair_sharing(ctx):
                    return True, targets
            ordering.drop_queue(pick)


def _strategy_allows(
    strategy: str, preemptor_new: int, target_old: int, target_new: int
) -> bool:
    if strategy == LESS_THAN_OR_EQUAL_TO_FINAL_SHARE:
        return preemptor_new <= target_new
    if strategy == LESS_THAN_INITIAL_SHARE:
        return preemptor_new < target_old
    raise ValueError(f"unknown fair-sharing strategy {strategy}")


class _CohortTournament:
    """The cohort-tree target ordering (fairsharing/ordering.go).

    Walks from the root picking the child subtree with the highest
    DominantResourceShare until reaching a ClusterQueue with remaining
    candidates. DRS values are recomputed per ``next_target`` call
    because removals during simulation shift usage at every ancestor —
    but only once per call: pruning between picks doesn't change usage.
    """

    def __init__(self, ctx: _Ctx, candidates: List[WorkloadSnapshot]):
        self.ctx = ctx
        self.snapshot = ctx.snapshot
        self.per_cq: Dict[int, List[WorkloadSnapshot]] = {}
        for ws in candidates:
            self.per_cq.setdefault(ws.cq_row, []).append(ws)
        self.pruned: Set[int] = set()
        self.preemptor_ancestors = set(self.snapshot.path_to_root(ctx.cq_row))
        # children adjacency, built once: O(N) instead of O(N) per query
        self.children: Dict[int, Tuple[List[int], List[int]]] = {}
        n_cq = self.snapshot.flat.n_cq
        for i, p in enumerate(self.snapshot.flat.parent):
            p = int(p)
            if p >= 0:
                entry = self.children.setdefault(p, ([], []))
                entry[0 if i < n_cq else 1].append(i)

    def has_workload(self, row: int) -> bool:
        return bool(self.per_cq.get(row))

    def pop_workload(self, row: int) -> WorkloadSnapshot:
        return self.per_cq[row].pop(0)

    def drop_queue(self, row: int) -> None:
        self.pruned.add(row)

    def next_target(self) -> Optional[int]:
        ctx = self.ctx
        if not self.snapshot.has_cohort(ctx.cq_name):
            return ctx.cq_row if self.has_workload(ctx.cq_row) else None
        root = self.snapshot.path_to_root(ctx.cq_row)[-1]
        drs = self.snapshot.all_node_drs()
        while root not in self.pruned:
            pick = self._next_in(root, drs)
            if pick is not None:
                return pick
        return None

    def _next_in(self, cohort_row: int, drs: np.ndarray) -> Optional[int]:
        cq_children, cohort_children = self.children.get(cohort_row, ([], []))
        best_cq, best_cq_drs = None, -1
        for row in cq_children:
            if row in self.pruned:
                continue
            d = int(drs[row])
            if (d == 0 and row != self.ctx.cq_row) or not self.has_workload(row):
                self.pruned.add(row)
            elif d >= best_cq_drs:
                best_cq_drs = d
                best_cq = row
        best_cohort, best_cohort_drs = None, -1
        for row in cohort_children:
            if row in self.pruned:
                continue
            d = int(drs[row])
            if d == 0 and row not in self.preemptor_ancestors:
                self.pruned.add(row)
            elif d >= best_cohort_drs:
                best_cohort_drs = d
                best_cohort = row
        if best_cohort is None and best_cq is None:
            self.pruned.add(cohort_row)
            return None
        if best_cohort is not None and best_cohort_drs >= best_cq_drs:
            return self._next_in(best_cohort, drs)
        return best_cq

    # ---- almost-LCA share computations (least_common_ancestor.go) ----
    def _lca(self, target_row: int) -> int:
        for anc in self.snapshot.path_to_root(target_row):
            if anc in self.preemptor_ancestors:
                return anc
        raise AssertionError("no common ancestor in cohort tree")

    def _almost_lca(self, row: int, lca: int) -> int:
        a = row
        for anc in self.snapshot.path_to_root(row):
            if anc == lca:
                return a
            a = anc
        raise AssertionError("lca not on path to root")

    def compute_shares(self, target_row: int) -> Tuple[int, int]:
        lca = self._lca(target_row)
        drs = self.snapshot.all_node_drs()
        return (
            int(drs[self._almost_lca(self.ctx.cq_row, lca)]),
            int(drs[self._almost_lca(target_row, lca)]),
        )

    def almost_lca_drs(self, target_row: int) -> int:
        lca = self._lca(target_row)
        drs = self.snapshot.all_node_drs()
        return int(drs[self._almost_lca(target_row, lca)])
