"""What-if capacity planner — scenario-batched admission forecasting
(port of kueue_tpu/planner/engine.py).

The admission hot path already runs as batched device kernels over the
encoded snapshot (core/encode.py), so evaluating S hypothetical cluster
configurations against the SAME pending backlog is one extra scenario
axis (ops/plan_kernel.py, kernel B14: three launches on the card), not
S scheduler runs: encode the snapshot once, lower the backlog once,
stack S variants of the quota tensors with the scenario deltas applied,
solve once, fetch once, decode per-scenario outcomes.

Per scenario the planner reports the admitted set, the per-CQ
utilization after that admission wave, how many heads would need
preemption, capacity reservations, canonical inadmissibility reasons
(the ``InadmissibleReason`` enum, via the host FlavorAssigner run
against the scenario's decoded snapshot), and an optional virtual-time
time-to-admission forecast for the still-pending backlog (a host-side
discrete-event simulation on the decoded scenario snapshot, driven by
a FakeClock).

Correctness: ``use_device=False`` (or ``verify_host=True``) runs a
pure-numpy mirror of the device solve (``solve_scenario_host``, also the
solver guard's host authority, ``core/guard.solve_lowered_host``) —
identical int64 math over the identical arrays — so the batched path is
differentially testable bit-for-bit. The planner is strictly READ-ONLY
over the live runtime: it snapshots, encodes, and works on copies.

Where it runs: the device path runs B14 on the Planner's ``device``,
the card unless the caller names the CPU (``device="cpu"``: the plain
torch versions); without one it raises where there is no GPU. A
kernel's fault on the card is raised as a ``KernelError``, never
solved on the host instead.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from kueue_tpu_torch.models.constants import (
    InadmissibleReason,
    classify_inadmissible_message,
)
from kueue_tpu_torch.core.encode import (
    EncodedSnapshot,
    decode_snapshot,
    encode_snapshot,
)
from kueue_tpu_torch.core.snapshot import Snapshot, take_snapshot
from kueue_tpu_torch.core.solver import Lowered, _bucket, lower_heads, pack_heads
from kueue_tpu_torch.ops.quota import NO_LIMIT
from kueue_tpu_torch.ops.quota_np import (
    available_all_np,
    potential_available_all_np,
    subtree_quota_np,
    usage_tree_np,
)
from kueue_tpu_torch.planner.scenarios import (
    ArrayView,
    BorrowingLimitDelta,
    NominalQuotaDelta,
    PlanScenario,
    scenario_from_dict,
)

__all__ = [
    "Planner",
    "PlanReport",
    "ScenarioOutcome",
    "forecast_time_to_admission",
    "plan_request",
]

BASELINE_NAME = "baseline"


@dataclass
class ScenarioOutcome:
    """One scenario's decoded result."""

    name: str
    deltas: List[str] = field(default_factory=list)
    admitted: List[str] = field(default_factory=list)  # workload keys
    newly_admitted: List[str] = field(default_factory=list)  # vs baseline
    lost: List[str] = field(default_factory=list)  # admitted at baseline only
    pending: List[str] = field(default_factory=list)
    borrowing: int = 0
    preemption_candidates: int = 0  # heads admissible only by preempting
    reserved: int = 0
    utilization: Dict[str, Dict[str, float]] = field(default_factory=dict)
    reasons: Dict[str, dict] = field(default_factory=dict)
    forecast: Optional[dict] = None
    cost: float = 0.0
    baseline: bool = False
    # raw per-head arrays (host/device parity checks); not serialized
    raw: Optional[dict] = None

    def to_dict(self) -> dict:
        out = {
            "name": self.name,
            "deltas": self.deltas,
            "admitted": self.admitted,
            "newlyAdmitted": self.newly_admitted,
            "lost": self.lost,
            "pending": self.pending,
            "borrowing": self.borrowing,
            "preemptionCandidates": self.preemption_candidates,
            "reserved": self.reserved,
            "utilization": self.utilization,
            "baseline": self.baseline,
            "cost": self.cost,
        }
        if self.reasons:
            out["reasons"] = self.reasons
        if self.forecast is not None:
            out["forecast"] = self.forecast
        return out


@dataclass
class PlanReport:
    scenarios: List[ScenarioOutcome]  # ranked, baseline included
    baseline: ScenarioOutcome
    recommended: Optional[str]
    target_workload: str = ""
    target_cluster_queue: str = ""
    heads: int = 0
    heads_mode: str = "backlog"
    unmodeled: List[str] = field(default_factory=list)  # fallback head keys
    backend: str = "device"
    duration_s: float = 0.0
    # the per-scenario portion of duration_s: quota-array stacking,
    # the batched launch, result decode — excludes the shared setup
    # (snapshot/backlog/lowering) a sequential re-solve needs identically
    sweep_s: float = 0.0
    launches: int = 0

    def scenario(self, name: str) -> Optional[ScenarioOutcome]:
        for s in self.scenarios:
            if s.name == name:
                return s
        return None

    def to_dict(self) -> dict:
        n = len(self.scenarios)
        return {
            "scenarios": [s.to_dict() for s in self.scenarios],
            "baseline": self.baseline.to_dict(),
            "recommended": self.recommended,
            "targetWorkload": self.target_workload,
            "targetClusterQueue": self.target_cluster_queue,
            "heads": self.heads,
            "headsMode": self.heads_mode,
            "unmodeled": self.unmodeled,
            "backend": self.backend,
            "durationMs": round(self.duration_s * 1e3, 3),
            "sweepMs": round(self.sweep_s * 1e3, 3),
            "launches": self.launches,
            "scenariosPerSecond": (
                round(n / self.duration_s, 2) if self.duration_s > 0 else None
            ),
        }


# ---- host reference solve (numpy mirror of ops/plan_kernel) ----
def _avail_along_path_np(
    path: np.ndarray,  # int32[D+1], -1 padded
    cells: np.ndarray,  # int32[C] (clamped by caller)
    usage: np.ndarray,  # int64[N, FR] full tree
    subtree: np.ndarray,
    guaranteed: np.ndarray,
    borrowing_limit: np.ndarray,
    max_depth: int,
) -> np.ndarray:
    valid = path >= 0
    root_pos = int(valid.sum()) - 1
    avail = np.zeros(cells.shape[0], dtype=np.int64)
    for d in range(max_depth, -1, -1):
        if not valid[d]:
            continue
        node = int(path[d])
        if d == root_pos:
            avail = subtree[node, cells] - usage[node, cells]
            continue
        stored = subtree[node, cells] - guaranteed[node, cells]
        used = np.maximum(0, usage[node, cells] - guaranteed[node, cells])
        with_max = stored - used + borrowing_limit[node, cells]
        has_borrow = borrowing_limit[node, cells] < NO_LIMIT
        clamped = np.where(has_borrow, np.minimum(with_max, avail), avail)
        avail = np.maximum(0, guaranteed[node, cells] - usage[node, cells]) + clamped
    return avail


def _bubble_usage_np(
    path: np.ndarray,
    cells: np.ndarray,
    delta: np.ndarray,  # int64[C], already masked by cell validity
    usage: np.ndarray,
    guaranteed: np.ndarray,
    max_depth: int,
) -> None:
    delta = delta.copy()
    for d in range(0, max_depth + 1):
        if path[d] < 0:
            break
        node = int(path[d])
        old = usage[node, cells].copy()
        g = guaranteed[node, cells]
        new = old + delta
        np.add.at(usage, (node, cells), delta)
        delta = np.maximum(0, new - g) - np.maximum(0, old - g)
        if not delta.any():
            break


def solve_scenario_host(
    parent: np.ndarray,
    level_mask: np.ndarray,
    nominal: np.ndarray,
    lending: np.ndarray,
    borrowing: np.ndarray,
    local_usage: np.ndarray,
    batch,  # numpy HeadsBatch
    paths: np.ndarray,
    max_depth: int,
) -> dict:
    """Pure-numpy mirror of one scenario's device solve — identical
    int64 recurrences over identical arrays, so the device path is
    verifiable bit-for-bit. Sequential over the global entry order
    (solve_cycle semantics; segmented interleavings touch disjoint
    trees, so final state matches — property-tested for the kernel)."""
    w = batch.cq_row.shape[0]
    subtree, guaranteed = subtree_quota_np(parent, level_mask, nominal, lending)
    usage = usage_tree_np(parent, level_mask, guaranteed, local_usage)
    avail = available_all_np(
        parent, level_mask, subtree, guaranteed, borrowing, usage
    )
    potential = potential_available_all_np(
        parent, level_mask, subtree, guaranteed, borrowing
    )

    cq = np.maximum(batch.cq_row, 0)
    cell_need = (batch.cells >= 0) & (batch.qty > 0)
    cells = np.maximum(batch.cells, 0)
    avail_wkc = avail[cq[:, None, None], cells]
    subtree_wkc = subtree[cq[:, None, None], cells]
    local_wkc = local_usage[cq[:, None, None], cells]
    potential_wkc = potential[cq[:, None, None], cells]
    nominal_wkc = nominal[cq[:, None, None], cells]

    fits = np.all(np.where(cell_need, avail_wkc >= batch.qty, True), axis=-1)
    pot_fits = np.all(
        np.where(
            cell_need,
            (batch.qty <= potential_wkc) & (batch.qty <= nominal_wkc),
            True,
        ),
        axis=-1,
    )
    has_cohort = (parent[cq] >= 0)[:, None]
    borrows_wk = (
        np.any(
            np.where(cell_need, local_wkc + batch.qty > subtree_wkc, False),
            axis=-1,
        )
        & has_cohort
    )

    populated = batch.cq_row >= 0
    # masked score-argmax (kueue_tpu_torch/policy) — np.argmax's first-max
    # tie-break keeps the walk order, so all-zero/absent scores are
    # the boolean first-fit argmax bit-for-bit (the kernel's rule)
    score = getattr(batch, "score", None)
    if score is None:
        score = np.int64(0)
    neg = np.int64(-(2**62))
    fit_ok = fits & batch.valid
    first_fit = np.argmax(np.where(fit_ok, score, neg), axis=1)
    chosen = np.where(
        fit_ok.any(axis=1) & populated, first_fit, -1
    ).astype(np.int32)
    pre_ok = pot_fits & batch.valid
    preempt_k = np.where(
        pre_ok.any(axis=1) & populated & (chosen < 0),
        np.argmax(np.where(pre_ok, score, neg), axis=1),
        -1,
    ).astype(np.int32)

    eff_k = np.where(chosen >= 0, chosen, preempt_k)
    eff_safe = np.maximum(eff_k, 0)
    head_borrow = (
        np.take_along_axis(borrows_wk, eff_safe[:, None], axis=1)[:, 0]
        & (eff_k >= 0)
    )
    nofit = eff_k < 0
    order = np.lexsort(
        (
            batch.timestamp,
            -batch.priority,
            head_borrow.astype(np.int64),
            nofit.astype(np.int64),
        )
    )
    cells_eff = np.take_along_axis(
        batch.cells, eff_safe[:, None, None], axis=1
    )[:, 0]
    qty_eff = np.take_along_axis(batch.qty, eff_safe[:, None, None], axis=1)[:, 0]

    usage_t = usage.copy()
    admitted = np.zeros(w, dtype=bool)
    reserved = np.zeros(w, dtype=bool)
    for wi in order:
        if batch.cq_row[wi] < 0:
            continue
        cqs = int(cq[wi])
        path = paths[cqs]
        ccells = np.maximum(cells_eff[wi], 0)
        qty = qty_eff[wi]
        cell_valid = (cells_eff[wi] >= 0) & (qty > 0)

        a = _avail_along_path_np(
            path, ccells, usage_t, subtree, guaranteed, borrowing, max_depth
        )
        step_fits = bool(np.all(np.where(cell_valid, a >= qty, True)))
        if chosen[wi] >= 0 and step_fits:
            admitted[wi] = True
            _bubble_usage_np(
                path, ccells, np.where(cell_valid, qty, 0),
                usage_t, guaranteed, max_depth,
            )
            continue
        if chosen[wi] < 0 and preempt_k[wi] >= 0 and batch.no_reclaim[wi]:
            reserved[wi] = True
            nominal_c = nominal[cqs, ccells]
            bl_c = borrowing[cqs, ccells]
            leaf_c = usage_t[cqs, ccells]
            borrow_cap = np.where(
                bl_c < NO_LIMIT,
                np.minimum(qty, nominal_c + bl_c - leaf_c),
                qty,
            )
            nominal_cap = np.maximum(0, np.minimum(qty, nominal_c - leaf_c))
            reserve_qty = borrow_cap if head_borrow[wi] else nominal_cap
            _bubble_usage_np(
                path, ccells, np.where(cell_valid, reserve_qty, 0),
                usage_t, guaranteed, max_depth,
            )
    return {
        "chosen": chosen,
        "admitted": admitted,
        "borrows": head_borrow,
        "reserved": reserved,
        "order": order.astype(np.int32),
        "preempt_k": preempt_k,
        "usage": usage_t,
    }


class Planner:
    """Read-only capacity planner over a live (or replayed) runtime.

    ``plan()`` never mutates the cache, queues, workloads or metrics it
    reads — every computation runs on the per-call snapshot, its
    encoded arrays, and decoded copies (guardrail-tested server-side:
    a /debug/plan request leaves the state dump and resourceVersion
    byte-identical)."""

    def __init__(
        self,
        cache,
        queues,
        scheduler=None,
        flavors: Optional[dict] = None,
        transform=None,
        tas_cache=None,
        metrics=None,
        max_candidates: int = 8,
        max_cells: int = 16,
        policy=None,  # the runtime's ACTIVE AdmissionPolicy: the
        #               baseline scenario scores with it, so a plan's
        #               baseline always reflects live behavior
        clock=None,
        device=None,  # torch device of the B14 solve (cuda unless "cpu")
    ):
        self.cache = cache
        self.queues = queues
        self.scheduler = scheduler
        self.flavors = flavors if flavors is not None else cache.flavors
        self.transform = transform
        self.tas_cache = tas_cache
        self.metrics = metrics
        self.policy = policy
        self.clock = clock

        self.max_candidates = max_candidates
        self.max_cells = max_cells
        # resolved where the device path runs, so a host-only plan
        # (use_device=False) needs no card
        self.device = device

    @classmethod
    def for_runtime(cls, rt) -> "Planner":
        return cls(
            cache=rt.cache,
            queues=rt.queues,
            scheduler=rt.scheduler,
            transform=rt.transform_config,
            tas_cache=rt.cache.tas_cache,
            metrics=rt.metrics,
            policy=getattr(rt, "policy", None),
            clock=getattr(rt, "clock", None),
            device=getattr(rt, "device", None),
        )

    def _now(self) -> float:
        if self.clock is not None:
            return self.clock.now()
        return 0.0

    # ---- backlog collection (read-only) ----
    def backlog(
        self, snapshot: Snapshot, heads_mode: str = "backlog"
    ) -> List[tuple]:
        """The pending heads the plan evaluates: ``backlog`` = every
        pending workload in heap order INCLUDING the inadmissible
        parking lot (a stuck workload — the planner's whole audience —
        is usually parked, and any scenario delta would requeue it);
        ``cycle`` = one active head per ClusterQueue (the next
        scheduling cycle's nomination set, which parked workloads don't
        join). Uses heap SNAPSHOTS, never pops."""
        raw: List = []
        for name in sorted(self.queues.cluster_queues):
            pq = self.queues.cluster_queues[name]
            if not pq.active:
                continue
            if heads_mode == "cycle":
                ordered = pq.snapshot_active_sorted()[:1]
            else:
                ordered = pq.snapshot_sorted()
            raw.extend(ordered)
        if self.scheduler is not None:
            _, to_assign = self.scheduler._prevalidate(raw, snapshot)
            return [(e.workload, e.cq_name) for e in to_assign]
        out = []
        for wl in raw:
            cq_name = self.queues.cluster_queue_for_workload(wl) or ""
            if cq_name in snapshot.cq_models:
                out.append((wl, cq_name))
        return out

    def _timestamp_fn(self):
        from kueue_tpu_torch.core.queue_manager import queue_order_timestamp

        policy = self.queues._ts_policy
        return lambda wl: queue_order_timestamp(wl, policy)

    # ---- scenario generation ----
    def auto_scenarios(
        self,
        snapshot: Snapshot,
        target_workload=None,  # Workload model
        target_cq: str = "",
        max_scenarios: int = 24,
    ) -> List[PlanScenario]:
        """Candidate fixes for "what would it take?": per eligible
        flavor, nominal-quota bumps sized from the target's own request
        (x1, x2) plus a borrowing-limit lift; for a ClusterQueue target,
        proportional sweeps over its quota cells."""
        from kueue_tpu_torch.core.workload_info import (
            effective_podset_count,
            quota_per_pod,
        )

        out: List[PlanScenario] = []
        if target_workload is not None:
            cq_name = self.queues.cluster_queue_for_workload(target_workload)
            if cq_name is None or cq_name not in snapshot.cq_models:
                return out
            cq = snapshot.cq_models[cq_name]
            ps = target_workload.pod_sets[0]
            count = effective_podset_count(target_workload, ps)
            per_pod = quota_per_pod(ps, self.transform)
            need = {r: q * count for r, q in per_pod.items()}
            for rg in cq.resource_groups:
                touched = sorted(set(need) & set(rg.covered_resources))
                if not touched:
                    continue
                for fq in rg.flavors:
                    for mult, tag in ((1, "+request"), (2, "+2x request")):
                        out.append(
                            PlanScenario(
                                name=f"{cq_name}/{fq.name} quota {tag}",
                                deltas=tuple(
                                    NominalQuotaDelta(
                                        node=cq_name, flavor=fq.name,
                                        resource=r, delta=need[r] * mult,
                                    )
                                    for r in touched
                                ),
                            )
                        )
                    if snapshot.has_cohort(cq_name):
                        out.append(
                            PlanScenario(
                                name=f"{cq_name}/{fq.name} unlimited borrowing",
                                deltas=tuple(
                                    BorrowingLimitDelta(
                                        node=cq_name, flavor=fq.name,
                                        resource=r, limit=None,
                                    )
                                    for r in touched
                                ),
                            )
                        )
        elif target_cq and target_cq in snapshot.cq_models:
            r = snapshot.row(target_cq)
            for j, fr in enumerate(snapshot.fr_list):
                nom = int(snapshot.nominal[r, j])
                if nom <= 0:
                    continue
                for frac, tag in ((0.25, "+25%"), (0.5, "+50%"), (1.0, "+100%")):
                    out.append(
                        PlanScenario(
                            name=(
                                f"{target_cq}/{fr.flavor}/{fr.resource} "
                                f"quota {tag}"
                            ),
                            deltas=(
                                NominalQuotaDelta(
                                    node=target_cq, flavor=fr.flavor,
                                    resource=fr.resource,
                                    delta=max(1, int(nom * frac)),
                                ),
                            ),
                        )
                    )
        return out[:max_scenarios]

    @staticmethod
    def quota_sweep(
        cq: str, flavor: str, resource: str, deltas: Sequence[int]
    ) -> List[PlanScenario]:
        """One scenario per delta — the simple sweep shape the bench and
        the acceptance test use."""
        out = []
        for d in deltas:
            sign = "+" if d >= 0 else ""
            out.append(
                PlanScenario(
                    name=f"{cq}/{flavor}/{resource} {sign}{d}",
                    deltas=(
                        NominalQuotaDelta(
                            node=cq, flavor=flavor, resource=resource, delta=d
                        ),
                    ),
                )
            )
        return out

    # ---- the plan ----
    def plan(
        self,
        scenarios: Optional[Sequence[PlanScenario]] = None,
        target_workload: str = "",
        target_cq: str = "",
        heads_mode: str = "backlog",
        use_device: Optional[bool] = None,
        include_reasons: str = "baseline",  # "none" | "baseline" | "all"
        runtime_hint: Optional[Callable] = None,
        forecast: bool = False,
        forecast_horizon_s: float = 1e6,
        verify_host: bool = False,
        snapshot: Optional[Snapshot] = None,
    ) -> PlanReport:
        t0 = _time.perf_counter()
        if snapshot is None:
            snapshot = take_snapshot(self.cache)
        enc = encode_snapshot(snapshot)
        heads = self.backlog(snapshot, heads_mode)
        target_wl_model = None
        if target_workload:
            for wl, _cq in heads:
                if wl.key == target_workload:
                    target_wl_model = wl
                    break

        scen_list: List[PlanScenario] = [PlanScenario(name=BASELINE_NAME)]
        if scenarios:
            scen_list.extend(scenarios)
        elif target_workload or target_cq:
            scen_list.extend(
                self.auto_scenarios(
                    snapshot,
                    target_workload=target_wl_model,
                    target_cq=target_cq,
                )
            )
        s = len(scen_list)

        lowered = lower_heads(
            snapshot,
            heads,
            self.flavors,
            max_candidates=self.max_candidates,
            max_cells=self.max_cells,
            timestamp_fn=self._timestamp_fn(),
            transform=self.transform,
        )
        if self.policy is not None and not self.policy.is_default:
            # baseline = the runtime's ACTIVE policy (kueue_tpu_torch/policy)
            from kueue_tpu_torch.policy import annotate_lowered

            annotate_lowered(self.policy, lowered, now=self._now())
        unmodeled = sorted({lowered.heads[i].key for i in lowered.fallback})
        w = len(lowered.heads)
        w_pad = _bucket(w) if w else 0

        from kueue_tpu_torch.ops.assign_kernel import build_paths, build_roots

        roots = build_roots(enc.parent)
        paths_np = build_paths(enc.parent, enc.max_depth)
        batch_np, seg_id, n_segments, n_steps = pack_heads(lowered, roots, w_pad)

        # the scenario sweep proper starts here: everything above is
        # shared setup a sequential re-solve needs identically (the
        # snapshot, backlog and lowered batch are scenario-invariant);
        # sweep_s isolates the per-scenario cost — stack, launch, decode
        t_sweep = _time.perf_counter()
        stacks, scenario_policy = self._stack(
            enc, snapshot, lowered, scen_list, batch_np, w, w_pad
        )
        nominal_s, lending_s, borrowing_s = stacks[:3]
        usage_s, priority_s, score_s = stacks[3:]

        device = use_device if use_device is not None else True
        launches = 0
        if device and w:
            raws = self._device_raws(
                enc, stacks, batch_np, paths_np, seg_id, n_segments, n_steps, w
            )
            launches = 1
            backend = "device"
        else:
            raws = [
                self._host_raw(
                    enc, nominal_s[si], lending_s[si], borrowing_s[si],
                    usage_s[si], priority_s[si], batch_np, paths_np, w,
                    score=score_s[si],
                )
                for si in range(s)
            ]
            backend = "host"

        if verify_host and device and w:
            for si in range(s):
                host = self._host_raw(
                    enc, nominal_s[si], lending_s[si], borrowing_s[si],
                    usage_s[si], priority_s[si], batch_np, paths_np, w,
                    score=score_s[si],
                )
                for k in ("chosen", "admitted", "borrows", "reserved"):
                    if not np.array_equal(raws[si][k], host[k]):
                        raise AssertionError(
                            f"device/host divergence in scenario "
                            f"{scen_list[si].name!r} field {k!r}"
                        )

        outcomes = self._decode(scen_list, raws, lowered, enc, nominal_s, w)
        sweep_s = _time.perf_counter() - t_sweep
        self._attach_reasons(
            outcomes, scen_list, include_reasons, enc,
            nominal_s, lending_s, borrowing_s, usage_s, lowered, heads,
        )
        if forecast and runtime_hint is not None:
            for si, o in enumerate(outcomes):
                pol = self._scenario_policy(scenario_policy[si])
                o.forecast = self._forecast(
                    enc, nominal_s[si], lending_s[si], borrowing_s[si],
                    lowered, raws[si], runtime_hint, forecast_horizon_s,
                    policy=pol, score=score_s[si],
                )

        ranked = self._rank(outcomes, target_workload)
        baseline = outcomes[0]
        recommended = None
        for o in ranked:
            if o.baseline:
                continue
            if target_workload:
                if target_workload in o.admitted:
                    recommended = o.name
                    break
            elif o.newly_admitted:
                recommended = o.name
                break
        dt = _time.perf_counter() - t0
        report = PlanReport(
            scenarios=ranked,
            baseline=baseline,
            recommended=recommended,
            target_workload=target_workload,
            target_cluster_queue=target_cq,
            heads=w,
            heads_mode=heads_mode,
            unmodeled=unmodeled,
            backend=backend,
            duration_s=dt,
            sweep_s=sweep_s,
            launches=launches,
        )
        if self.metrics is not None:
            target_kind = (
                "workload"
                if target_workload
                else "clusterqueue" if target_cq else "adhoc"
            )
            self.metrics.report_planner(target_kind, s, dt, backend)
        return report

    # ---- internals ----
    def _stack(self, enc, snapshot, lowered, scen_list, batch_np, w, w_pad):
        """Per-scenario arrays: stacked copies of the encoded quota
        state, priorities and scores with each scenario's deltas
        applied. Returns ((nominal_s, lending_s, borrowing_s, usage_s,
        priority_s, score_s), the scenarios' policy names)."""
        s = len(scen_list)
        head_slots: Dict[str, List[int]] = {}
        for i, wl in enumerate(lowered.heads):
            head_slots.setdefault(wl.key, []).append(i)
        row_index = {name: i for i, name in enumerate(enc.cq_names)}
        for j, name in enumerate(enc.cohort_names):
            row_index[name] = enc.n_cq + j

        def _stack(a: np.ndarray) -> np.ndarray:
            # np.repeat already yields a fresh per-scenario copy; only
            # convert when the source isn't int64 yet
            return np.repeat(a.astype(np.int64, copy=False)[None], s, axis=0)

        nominal_s = _stack(enc.nominal)
        lending_s = _stack(enc.lending_limit)
        borrowing_s = _stack(enc.borrowing_limit)
        usage_s = _stack(enc.local_usage)
        weight_s = _stack(enc.weight_milli)
        priority_pad = np.zeros(w_pad, dtype=np.int64)
        priority_pad[:w] = lowered.priority
        priority_s = np.repeat(priority_pad[None], s, axis=0)
        # per-scenario policy score matrices: the baseline row carries
        # the active policy's scores (pack_heads padded them); the
        # ``policy`` scenario kind overwrites its own copy
        score_s = np.repeat(batch_np.score[None], s, axis=0)
        scenario_policy: List[str] = []
        for si, scen in enumerate(scen_list):
            view = ArrayView(
                nominal=nominal_s[si],
                lending=lending_s[si],
                borrowing=borrowing_s[si],
                usage=usage_s[si],
                priority=priority_s[si],
                weight=weight_s[si],
                row_index=row_index,
                fr_index=snapshot.fr_index,
                head_slots=head_slots,
                n_cq=enc.n_cq,
                score=score_s[si],
                lowered=lowered,
            )
            scen.apply(view)
            scenario_policy.append(view.policy_name)
        stacks = (nominal_s, lending_s, borrowing_s, usage_s, priority_s, score_s)
        return stacks, scenario_policy

    def _device_raws(
        self, enc, stacks, batch_np, paths_np, seg_id, n_segments, n_steps, w,
    ) -> List[dict]:
        """The sweep's solve (kernel B14) on the Planner's device: the
        stacked arrays uploaded, three launches on the card, ONE fetch
        of the packed result, then per-scenario views of whole-matrix
        conversions."""
        from kueue_tpu_torch._torch import resolve_device, torch
        from kueue_tpu_torch.interop import plan_inputs
        from kueue_tpu_torch.ops._build import KernelError
        from kueue_tpu_torch.ops.plan_kernel import solve_scenarios_packed, unpack

        dev = resolve_device(self.device)
        nominal_s, lending_s, borrowing_s, usage_s, priority_s, score_s = stacks
        s, n, fr = nominal_s.shape
        w_pad = priority_s.shape[1]
        inputs = plan_inputs(
            {
                "parent": enc.parent, "level_mask": enc.level_mask,
                "nominal_s": nominal_s, "lending_s": lending_s,
                "borrowing_s": borrowing_s, "usage_s": usage_s,
                "priority_s": priority_s, "score_s": score_s, "heads": batch_np,
                "paths": paths_np, "seg_id": seg_id,
            },
            dev,
        )
        try:
            buf = solve_scenarios_packed(
                **inputs, n_segments=n_segments, n_steps=n_steps
            ).cpu().numpy()  # ONE device->host copy for the whole sweep
        except torch.AcceleratorError as exc:
            # a kernel's fault on the card surfaces at the fetch: never
            # contained
            raise KernelError(f"the planner's kernels failed on {dev}: {exc}") from exc
        per_head, usage_final = unpack(buf, s, w_pad, n, fr)  # [S, 6, Wp], [S, N, FR]
        # one whole-matrix conversion per field, then per-scenario
        # VIEWS — S separate astype copies dominated decode time
        chosen_all = per_head[:, 0, :w].astype(np.int32)
        admitted_all = per_head[:, 1, :w] != 0
        borrows_all = per_head[:, 2, :w] != 0
        reserved_all = per_head[:, 3, :w] != 0
        order_all = per_head[:, 4].astype(np.int32)  # over Wp
        preempt_all = per_head[:, 5, :w].astype(np.int32)
        return [
            {
                "chosen": chosen_all[si],
                "admitted": admitted_all[si],
                "borrows": borrows_all[si],
                "reserved": reserved_all[si],
                "order": order_all[si],
                "preempt_k": preempt_all[si],
                "usage": usage_final[si],
            }
            for si in range(s)
        ]

    def _host_raw(
        self, enc, nominal, lending, borrowing, usage, priority,
        batch_np, paths_np, w, score=None,
    ) -> dict:
        batch = batch_np._replace(priority=priority)
        if score is not None:
            batch = batch._replace(score=score)
        out = solve_scenario_host(
            enc.parent, enc.level_mask, nominal, lending, borrowing,
            usage, batch, paths_np, enc.max_depth,
        )
        return {
            "chosen": out["chosen"][:w],
            "admitted": out["admitted"][:w],
            "borrows": out["borrows"][:w],
            "reserved": out["reserved"][:w],
            "preempt_k": out["preempt_k"][:w],
            "usage": out["usage"],
        }

    def _decode(
        self, scen_list, raws, lowered: Lowered, enc: EncodedSnapshot,
        nominal_s: np.ndarray, w: int,
    ) -> List[ScenarioOutcome]:
        fallback = set(lowered.fallback)
        head_keys = [wl.key for wl in lowered.heads]
        model_idx = np.array(
            [i for i in range(w) if i not in fallback], dtype=np.int64
        )
        # per-resource aggregation, vectorized over ALL scenarios at
        # once: used/nominal [S, n_cq, R] via one FR->resource one-hot
        # matmul (the python per-cell loop dominated decode wall time)
        res_names = sorted({fr.resource for fr in enc.fr_list})
        r_idx = {r: x for x, r in enumerate(res_names)}
        onehot = np.zeros((len(enc.fr_list), len(res_names)), dtype=np.int64)
        for j, fr in enumerate(enc.fr_list):
            onehot[j, r_idx[fr.resource]] = 1
        n_cq = enc.n_cq
        usage_all = np.stack([raw["usage"][:n_cq] for raw in raws])
        used_scr = usage_all @ onehot  # [S, n_cq, R]
        nom_scr = nominal_s[:, :n_cq, :] @ onehot
        nom_pos = nom_scr > 0
        with np.errstate(divide="ignore", invalid="ignore"):
            frac_scr = np.round(
                np.where(nom_pos, used_scr / np.maximum(nom_scr, 1), np.nan), 4
            )
        frac_list = frac_scr.tolist()  # one C-level pass, not S*cells
        # whole-batch matrices, then per-scenario fancy indexing — the
        # per-scenario python listcomps over every head dominated wall
        # time at bench scale (S=128, W=500)
        admitted_all = np.stack([raw["admitted"] for raw in raws])  # [S, w]
        key_arr = np.array([head_keys[i] for i in model_idx], dtype=object)
        ksort = np.argsort(key_arr)  # selections come out pre-sorted
        key_sorted = key_arr[ksort]
        adm_m = admitted_all[:, model_idx][:, ksort]  # [S, M]
        base_m = adm_m[0]
        new_m = adm_m & ~base_m
        lost_m = ~adm_m & base_m
        borrowing_ct = np.stack(
            [raw["borrows"][:w] for raw in raws]
        ).sum(axis=1)
        reserved_ct = np.stack(
            [raw["reserved"][:w] for raw in raws]
        ).sum(axis=1)
        preempt_ct = np.stack(
            [(raw["chosen"] < 0) & (raw["preempt_k"] >= 0) for raw in raws]
        ).sum(axis=1)
        outcomes: List[ScenarioOutcome] = []
        for si, (scen, raw) in enumerate(zip(scen_list, raws)):
            util: Dict[str, Dict[str, float]] = {}
            rows, cols = np.nonzero(nom_pos[si])
            frac_si = frac_list[si]
            for r, x in zip(rows.tolist(), cols.tolist()):
                util.setdefault(enc.cq_names[r], {})[res_names[x]] = frac_si[
                    r
                ][x]
            o = ScenarioOutcome(
                name=scen.name,
                deltas=scen.describe(),
                admitted=key_sorted[adm_m[si]].tolist(),
                pending=key_sorted[~adm_m[si]].tolist(),
                borrowing=int(borrowing_ct[si]),
                preemption_candidates=int(preempt_ct[si]),
                reserved=int(reserved_ct[si]),
                utilization=util,
                cost=scen.cost(),
                baseline=si == 0,
                raw=raw,
            )
            o.newly_admitted = key_sorted[new_m[si]].tolist()
            o.lost = key_sorted[lost_m[si]].tolist()
            outcomes.append(o)
        return outcomes

    def _attach_reasons(
        self, outcomes, scen_list, include_reasons, enc,
        nominal_s, lending_s, borrowing_s, usage_s, lowered, heads,
    ) -> None:
        if include_reasons == "none":
            return
        idx = range(len(outcomes)) if include_reasons == "all" else (0,)
        from kueue_tpu_torch.core.flavor_assigner import FlavorAssigner

        key_to_head = {wl.key: (wl, cqn) for wl, cqn in heads}
        for si in idx:
            o = outcomes[si]
            scen_snap = decode_snapshot(
                enc.with_quota(
                    nominal=nominal_s[si],
                    lending_limit=lending_s[si],
                    borrowing_limit=borrowing_s[si],
                    local_usage=usage_s[si],
                )
            )
            assigner = FlavorAssigner(
                scen_snap, self.flavors, transform=self.transform
            )
            raw = o.raw
            reasons: Dict[str, dict] = {}
            for key in o.pending:
                wl, cq_name = key_to_head[key]
                slot = None
                for i in self._slots_of(lowered, key):
                    slot = i
                    break
                if (
                    slot is not None
                    and raw is not None
                    and raw["chosen"][slot] >= 0
                ):
                    # fit at cycle start, displaced by an earlier entry
                    msg = (
                        "Workload no longer fits after processing another "
                        "workload"
                    )
                    reasons[key] = {
                        "reason": InadmissibleReason.LOST_QUOTA_RACE.value,
                        "message": msg,
                    }
                    continue
                saved = wl.last_assignment
                try:
                    a = assigner.assign(wl, cq_name)
                    msg = a.message()
                finally:
                    wl.last_assignment = saved  # strictly read-only
                reason = classify_inadmissible_message(msg)
                reasons[key] = {"reason": reason.value, "message": msg}
            o.reasons = reasons

    @staticmethod
    def _slots_of(lowered: Lowered, key: str):
        for i, wl in enumerate(lowered.heads):
            if wl.key == key:
                yield i

    def _scenario_policy(self, name: str):
        """Resolve one scenario's effective policy for the forecast:
        the PolicyDelta's pick, else the planner's active policy."""
        if name:
            from kueue_tpu_torch.policy import resolve_policy

            return resolve_policy(name)
        return self.policy

    def _forecast(
        self, enc, nominal, lending, borrowing, lowered: Lowered, raw,
        runtime_hint, horizon_s: float, policy=None, score=None,
    ) -> dict:
        """Virtual-time time-to-admission forecast for the scenario's
        still-pending backlog: a discrete-event simulation on the
        decoded scenario snapshot — capacity releases as admitted work
        finishes (per ``runtime_hint`` seconds), pending heads re-try
        their lowered candidates in entry order, on a virtual clock.

        With a scoring ``policy`` (kueue_tpu_torch/policy) the simulation is
        heterogeneity-aware: pending heads try candidates in score
        order (best flavor first, the kernels' argmax rule) and every
        admitted workload's virtual runtime scales by the policy's
        throughput model — so a Gavel scenario's makespan/TTA deltas vs
        the first-fit baseline are visible in one report."""
        import heapq

        from kueue_tpu_torch.utils.clock import FakeClock

        snap = decode_snapshot(
            enc.with_quota(
                nominal=nominal, lending_limit=lending,
                borrowing_limit=borrowing,
            )
        )
        clock = FakeClock(0.0)
        fallback = set(lowered.fallback)
        w = len(lowered.heads)
        scoring = policy is not None and not policy.is_default

        def vec_of(i: int, k: int) -> np.ndarray:
            vec = np.zeros(len(snap.fr_list), dtype=np.int64)
            cells, qty = lowered.cells[i, k], lowered.qty[i, k]
            for c in range(cells.shape[0]):
                if cells[c] >= 0:
                    vec[int(cells[c])] += int(qty[c])
            return vec

        def runtime_of(i: int, k: int) -> float:
            rt_s = float(runtime_hint(lowered.heads[i]))
            if scoring and 0 <= k < len(lowered.candidate_flavors[i]):
                fmap = lowered.candidate_flavors[i][k]
                if fmap:
                    fsig = tuple(sorted(set(fmap.values())))
                    rt_s *= float(
                        policy.runtime_scale(lowered.heads[i], fsig)
                    )
            return rt_s

        def candidate_order(i: int) -> List[int]:
            ks = [
                k
                for k in range(lowered.valid.shape[1])
                if lowered.valid[i, k]
            ]
            if scoring and score is not None:
                ks.sort(key=lambda k: (-int(score[i, k]), k))
            return ks

        events: List[tuple] = []  # (finish_t, seq, cq_name, usage_vec)
        seq = 0
        # running workloads release their usage after runtime_hint
        for key, ws in snap.workloads.items():
            rt_s = float(runtime_hint(ws.workload))
            heapq.heappush(
                events, (rt_s, seq, ws.cq_name, ws.usage_vec.copy())
            )
            seq += 1
        tta: Dict[str, float] = {}
        done_at: Dict[str, float] = {}  # completion time of backlog work
        pending: List[int] = []
        order = raw.get("order")
        order_iter = (
            [int(x) for x in order if 0 <= int(x) < w]
            if order is not None
            else list(range(w))
        )
        for i in order_iter:
            key = lowered.heads[i].key
            if i in fallback:
                continue
            if raw["admitted"][i]:
                tta[key] = 0.0
                k = int(raw["chosen"][i])
                vec = vec_of(i, max(k, 0))
                rt_s = runtime_of(i, max(k, 0))
                done_at[key] = rt_s
                heapq.heappush(
                    events, (rt_s, seq, lowered.cq_names[i], vec)
                )
                seq += 1
            else:
                pending.append(i)

        max_rt = 0.0
        while pending and events and clock.now() < horizon_s:
            t, _, cq_name, vec = heapq.heappop(events)
            clock.set(t)
            snap.remove_usage(cq_name, vec)
            # drain every event at this instant before re-admitting
            while events and events[0][0] == t:
                _, _, cqn2, vec2 = heapq.heappop(events)
                snap.remove_usage(cqn2, vec2)
            still: List[int] = []
            for i in pending:
                admitted_now = False
                for k in candidate_order(i):
                    vec_k = vec_of(i, k)
                    if snap.fits(lowered.cq_names[i], vec_k):
                        snap.add_usage(lowered.cq_names[i], vec_k)
                        rt_s = runtime_of(i, k)
                        max_rt = max(max_rt, rt_s)
                        heapq.heappush(
                            events,
                            (t + rt_s, seq, lowered.cq_names[i], vec_k),
                        )
                        seq += 1
                        tta[lowered.heads[i].key] = t
                        done_at[lowered.heads[i].key] = t + rt_s
                        admitted_now = True
                        break
                if not admitted_now:
                    still.append(i)
            pending = still

        per_wl = {}
        vals = []
        for key, t in tta.items():
            rt_s = float(
                runtime_hint(lowered.heads[self._first_slot(lowered, key)])
            )
            max_rt = max(max_rt, rt_s)
            per_wl[key] = {
                "estimate": round(t, 3),
                "low": round(0.5 * t, 3),
                "high": round(2.0 * t + rt_s, 3),
            }
            vals.append(t)
        mean = sum(vals) / len(vals) if vals else 0.0
        out = {
            "perWorkload": per_wl,
            "mean": round(mean, 3),
            "band": [round(0.5 * mean, 3), round(2.0 * mean + max_rt, 3)],
            # virtual completion time of the last backlog workload to
            # finish — the Gavel-vs-FIFO makespan comparison surface
            "makespan": round(max(done_at.values()), 3) if done_at else 0.0,
            "unadmitted": sorted(
                lowered.heads[i].key for i in pending
            ),
        }
        if scoring:
            out["policy"] = policy.name
        return out

    @staticmethod
    def _first_slot(lowered: Lowered, key: str) -> int:
        for i, wl in enumerate(lowered.heads):
            if wl.key == key:
                return i
        raise KeyError(key)

    def _rank(
        self, outcomes: List[ScenarioOutcome], target_workload: str
    ) -> List[ScenarioOutcome]:
        def score(o: ScenarioOutcome):
            admits_target = (
                0 if target_workload and target_workload in o.admitted else 1
            )
            return (
                admits_target if target_workload else 0,
                -len(o.newly_admitted),
                len(o.lost),
                o.preemption_candidates,
                o.borrowing,
                o.cost,
                o.name,
            )

        return sorted(outcomes, key=score)


# ---- wire entry (POST /debug/plan) ----
def plan_request(rt, body: dict) -> dict:
    """Run one plan against a live runtime from the wire body:

    ``{"scenarios": [{"name", "deltas": [...]}, ...],
       "target": {"workload": "ns/name"} | {"clusterQueue": "cq"},
       "options": {"heads": "backlog"|"cycle", "useDevice": bool,
                   "includeReasons": "none"|"baseline"|"all",
                   "forecast": bool, "runtimeHintSeconds": float,
                   "verifyHost": bool}}``

    Scenarios may be omitted when a target is given — the planner
    generates the candidate-fix sweep itself."""
    planner = Planner.for_runtime(rt)
    scenarios = None
    if body.get("scenarios"):
        scenarios = [
            scenario_from_dict(sd, default_name=f"scenario-{i}")
            for i, sd in enumerate(body["scenarios"])
        ]
    target = body.get("target") or {}
    options = body.get("options") or {}
    runtime_hint = None
    forecast = bool(options.get("forecast", False))
    if forecast:
        hint_s = float(options.get("runtimeHintSeconds", 600.0))
        runtime_hint = lambda wl: hint_s  # noqa: E731
    report = planner.plan(
        scenarios=scenarios,
        target_workload=target.get("workload", ""),
        target_cq=target.get("clusterQueue", ""),
        heads_mode=options.get("heads", "backlog"),
        use_device=options.get("useDevice"),
        include_reasons=options.get("includeReasons", "baseline"),
        runtime_hint=runtime_hint,
        forecast=forecast,
        verify_host=bool(options.get("verifyHost", False)),
    )
    out = report.to_dict()
    plane = getattr(rt, "elastic", None)
    if plane is not None:
        # the elastic plane runs candidate scale-ups through this same
        # planner — surface its standings next to the what-if report so
        # it explains both what a config change would do AND what
        # capacity the plane already chose to stand up
        out["elastic"] = plane.status()
    return out


def forecast_time_to_admission(
    rt,
    wl,
    runtime_hint_s: float = 600.0,
    horizon_s: float = 1e6,
) -> Optional[float]:
    """Virtual-time forecast of WHEN a cluster would admit one
    not-yet-submitted workload — the federation dispatcher's placement
    score ("which cluster *would* admit this gang, and when").

    Strictly read-only over ``rt`` (a ClusterRuntime): the candidate's
    lowered flavor candidates are tested against the live snapshot
    (0.0 = quota clears on the next cycle), then against a
    discrete-event release simulation where every admitted workload
    frees its usage after ``runtime_hint_s`` — the same virtual-clock
    discipline as ``Planner._forecast``. Returns seconds until the
    earliest fit, or None when the cluster cannot admit the workload
    within ``horizon_s`` (unknown queue, unrepresentable shape, or no
    capacity ever frees up).
    """
    import heapq

    snapshot = take_snapshot(rt.cache)
    cq_name = rt.queues.cluster_queue_for_workload(wl)
    if cq_name is None or cq_name not in snapshot.cq_models:
        return None
    saved_cursor = wl.last_assignment
    try:
        lowered = lower_heads(
            snapshot,
            [(wl, cq_name)],
            rt.cache.flavors,
            transform=getattr(rt, "transform_config", None),
        )
    except Exception:  # noqa: BLE001 — an unscorable head must never
        # take the dispatch path down; the dispatcher treats None as
        # "rank last", not as an error
        return None
    finally:
        wl.last_assignment = saved_cursor
    if lowered.fallback or not len(lowered.heads):
        return None

    def vec_of(k: int) -> np.ndarray:
        vec = np.zeros(len(snapshot.fr_list), dtype=np.int64)
        cells, qty = lowered.cells[0, k], lowered.qty[0, k]
        for c in range(cells.shape[0]):
            if cells[c] >= 0:
                vec[int(cells[c])] += int(qty[c])
        return vec

    candidates = [
        vec_of(k)
        for k in range(lowered.valid.shape[1])
        if lowered.valid[0, k]
    ]
    if not candidates:
        return None
    if any(snapshot.fits(cq_name, vec) for vec in candidates):
        return 0.0
    # release simulation: admitted usage frees after runtime_hint_s
    events: List[tuple] = []
    seq = 0
    for ws in snapshot.workloads.values():
        heapq.heappush(
            events, (runtime_hint_s, seq, ws.cq_name, ws.usage_vec.copy())
        )
        seq += 1
    while events:
        t, _, name, vec = heapq.heappop(events)
        if t > horizon_s:
            return None
        snapshot.remove_usage(name, vec)
        while events and events[0][0] == t:
            _, _, name2, vec2 = heapq.heappop(events)
            snapshot.remove_usage(name2, vec2)
        if any(snapshot.fits(cq_name, v) for v in candidates):
            return float(t)
    return None
