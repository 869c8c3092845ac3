"""Scenario deltas — the what-if vocabulary of the capacity planner
(port of kueue_tpu/planner/scenarios.py; host-only code, copied).

A ``PlanScenario`` is a named list of deltas applied to one scenario's
copy of the encoded quota arrays (core/encode.py layout). Every delta
is a pure array edit on the existing (node x flavor-resource) grid:
capacity planning changes QUANTITIES, never the forest shape, which is
exactly what lets the planner sweep hundreds of scenarios as one extra
scenario axis (ops/plan_kernel.py, kernel B14) instead of hundreds of
scheduler runs.

Supported delta kinds (wire ``kind`` in parentheses):

- ``NominalQuotaDelta`` (quota): bump/cut one (node, flavor, resource)
  nominal quota cell.
- ``FlavorCapacityDelta`` (flavorCapacity): add capacity across a
  flavor's cells at a node, or zero the flavor out entirely
  (``deltas=None`` — the removed-flavor what-if).
- ``LendingLimitDelta`` / ``BorrowingLimitDelta`` (lendingLimit /
  borrowingLimit): set a cohort lending/borrowing limit cell
  (``limit=None`` = unlimited).
- ``FairShareWeightDelta`` (weight): set a node's fair-sharing weight
  (affects host-side ranking/DRS views; the admission kernel itself is
  weight-free).
- ``PriorityDelta`` (priority): boost/cut a pending workload's
  priority — reorders the scenario's admission entry order.
- ``DrainDomainDelta`` (drainDomain): remove a TAS domain's allocatable
  capacity from the flavor's nominal cells (greedy across CQ rows in
  row order) — the quota-level model of draining those nodes.
- ``PolicyDelta`` (policy): switch the admission policy (the closed
  kueue_tpu_torch/policy registry) for the scenario — per-candidate score
  tensors + deadline priority boosts compiled onto the scenario's copy
  of the lowered backlog, the safe what-if before ``--policy`` is
  enabled live.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from kueue_tpu_torch.ops.quota import NO_LIMIT
from kueue_tpu_torch.resources import FlavorResource

__all__ = [
    "PlanScenario",
    "ScenarioDelta",
    "NominalQuotaDelta",
    "FlavorCapacityDelta",
    "LendingLimitDelta",
    "BorrowingLimitDelta",
    "FairShareWeightDelta",
    "PriorityDelta",
    "DrainDomainDelta",
    "PolicyDelta",
    "delta_from_dict",
    "scenario_from_dict",
]


class ScenarioApplyError(ValueError):
    """A delta references a node / cell / workload the snapshot lacks."""


@dataclass
class ArrayView:
    """One scenario's mutable array slice plus the lookup context.

    ``nominal``/``lending``/``borrowing``/``usage`` are int64[N, FR]
    copies owned by this scenario; ``priority`` is int64[W] over the
    lowered head batch; ``weight`` is int64[N].
    """

    nominal: np.ndarray
    lending: np.ndarray
    borrowing: np.ndarray
    usage: np.ndarray
    priority: np.ndarray
    weight: np.ndarray
    row_index: Dict[str, int]
    fr_index: Dict[FlavorResource, int]
    head_slots: Dict[str, List[int]]  # workload key -> head row(s)
    n_cq: int = 0
    # admission-policy what-if surface (the ``policy`` scenario kind):
    # per-head x per-candidate score matrix int64[W_pad, K] owned by
    # this scenario, the lowered cycle batch (read-only context the
    # delta compiles scores from), and the name of the policy applied
    # (read back by the planner for forecast runtime scaling)
    score: Optional[np.ndarray] = None
    lowered: Optional[object] = None
    policy_name: str = ""

    def row(self, name: str) -> int:
        r = self.row_index.get(name)
        if r is None:
            raise ScenarioApplyError(f"unknown ClusterQueue/cohort {name!r}")
        return r

    def cell(self, flavor: str, resource: str) -> int:
        j = self.fr_index.get(FlavorResource(flavor, resource))
        if j is None:
            raise ScenarioApplyError(
                f"no quota cell for flavor {flavor!r} resource {resource!r}"
            )
        return j

    def flavor_cells(self, flavor: str) -> List[int]:
        return [j for fr, j in self.fr_index.items() if fr.flavor == flavor]


class ScenarioDelta:
    kind = ""

    def apply(self, view: ArrayView) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def cost(self) -> float:
        """Magnitude of the change — the ranking tiebreak preferring
        the smallest intervention that achieves the same outcome."""
        return 1.0

    def describe(self) -> str:
        return self.kind

    def to_dict(self) -> dict:
        return {"kind": self.kind}


@dataclass(frozen=True)
class NominalQuotaDelta(ScenarioDelta):
    node: str  # ClusterQueue or cohort name
    flavor: str
    resource: str
    delta: int  # canonical units (milli-CPU / bytes); may be negative

    kind = "quota"

    def apply(self, view: ArrayView) -> None:
        r, j = view.row(self.node), view.cell(self.flavor, self.resource)
        view.nominal[r, j] = max(0, int(view.nominal[r, j]) + self.delta)

    def cost(self) -> float:
        return abs(self.delta)

    def describe(self) -> str:
        sign = "+" if self.delta >= 0 else ""
        return (
            f"{self.node}: nominal {self.flavor}/{self.resource} "
            f"{sign}{self.delta}"
        )

    def to_dict(self) -> dict:
        return {
            "kind": self.kind, "node": self.node, "flavor": self.flavor,
            "resource": self.resource, "delta": self.delta,
        }


@dataclass(frozen=True)
class FlavorCapacityDelta(ScenarioDelta):
    node: str
    flavor: str
    # resource -> canonical delta; None = remove the flavor's capacity
    deltas: Optional[Tuple[Tuple[str, int], ...]] = None

    kind = "flavorCapacity"

    @staticmethod
    def build(node: str, flavor: str, deltas: Optional[Mapping[str, int]]):
        return FlavorCapacityDelta(
            node=node,
            flavor=flavor,
            deltas=None if deltas is None else tuple(sorted(deltas.items())),
        )

    def apply(self, view: ArrayView) -> None:
        r = view.row(self.node)
        if self.deltas is None:
            cells = view.flavor_cells(self.flavor)
            if not cells:
                raise ScenarioApplyError(f"unknown flavor {self.flavor!r}")
            view.nominal[r, cells] = 0
            return
        for resource, d in self.deltas:
            j = view.cell(self.flavor, resource)
            view.nominal[r, j] = max(0, int(view.nominal[r, j]) + d)

    def cost(self) -> float:
        if self.deltas is None:
            return float(NO_LIMIT)  # removal is the most disruptive ask
        return sum(abs(d) for _, d in self.deltas)

    def describe(self) -> str:
        if self.deltas is None:
            return f"{self.node}: remove flavor {self.flavor} capacity"
        parts = ", ".join(
            f"{r}{'+' if d >= 0 else ''}{d}" for r, d in self.deltas
        )
        return f"{self.node}: flavor {self.flavor} capacity {parts}"

    def to_dict(self) -> dict:
        return {
            "kind": self.kind, "node": self.node, "flavor": self.flavor,
            "deltas": None if self.deltas is None else dict(self.deltas),
        }


class _LimitDelta(ScenarioDelta):
    """Shared shape of the lending/borrowing limit edits."""

    node: str
    flavor: str
    resource: str
    limit: Optional[int]

    def _target(self, view: ArrayView) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError

    def apply(self, view: ArrayView) -> None:
        r, j = view.row(self.node), view.cell(self.flavor, self.resource)
        self._target(view)[r, j] = (
            NO_LIMIT if self.limit is None else max(0, int(self.limit))
        )

    def cost(self) -> float:
        return 1.0 if self.limit is None else abs(self.limit)

    def describe(self) -> str:
        v = "unlimited" if self.limit is None else str(self.limit)
        return (
            f"{self.node}: {self.kind.replace('Limit', ' limit')} "
            f"{self.flavor}/{self.resource} = {v}"
        )

    def to_dict(self) -> dict:
        return {
            "kind": self.kind, "node": self.node, "flavor": self.flavor,
            "resource": self.resource, "limit": self.limit,
        }


@dataclass(frozen=True)
class LendingLimitDelta(_LimitDelta):
    node: str
    flavor: str
    resource: str
    limit: Optional[int]

    kind = "lendingLimit"

    def _target(self, view: ArrayView) -> np.ndarray:
        return view.lending


@dataclass(frozen=True)
class BorrowingLimitDelta(_LimitDelta):
    node: str
    flavor: str
    resource: str
    limit: Optional[int]

    kind = "borrowingLimit"

    def _target(self, view: ArrayView) -> np.ndarray:
        return view.borrowing


@dataclass(frozen=True)
class FairShareWeightDelta(ScenarioDelta):
    node: str
    weight_milli: int

    kind = "weight"

    def apply(self, view: ArrayView) -> None:
        view.weight[view.row(self.node)] = max(0, int(self.weight_milli))

    def describe(self) -> str:
        return f"{self.node}: fair-share weight {self.weight_milli}m"

    def to_dict(self) -> dict:
        return {
            "kind": self.kind, "node": self.node,
            "weightMilli": self.weight_milli,
        }


@dataclass(frozen=True)
class PriorityDelta(ScenarioDelta):
    workload: str  # "namespace/name" key
    delta: int

    kind = "priority"

    def apply(self, view: ArrayView) -> None:
        slots = view.head_slots.get(self.workload)
        if not slots:
            raise ScenarioApplyError(
                f"workload {self.workload!r} is not in the planned backlog"
            )
        for w in slots:
            view.priority[w] += self.delta

    def cost(self) -> float:
        return abs(self.delta)

    def describe(self) -> str:
        sign = "+" if self.delta >= 0 else ""
        return f"{self.workload}: priority {sign}{self.delta}"

    def to_dict(self) -> dict:
        return {
            "kind": self.kind, "workload": self.workload, "delta": self.delta,
        }


@dataclass(frozen=True)
class DrainDomainDelta(ScenarioDelta):
    flavor: str
    # resource -> capacity leaving with the drained domain (canonical)
    amounts: Tuple[Tuple[str, int], ...] = ()
    domain: str = ""  # display only (e.g. "rack-2" or a hostname)

    kind = "drainDomain"

    @staticmethod
    def build(flavor: str, amounts: Mapping[str, int], domain: str = ""):
        return DrainDomainDelta(
            flavor=flavor, amounts=tuple(sorted(amounts.items())), domain=domain
        )

    def apply(self, view: ArrayView) -> None:
        for resource, amount in self.amounts:
            j = view.cell(self.flavor, resource)
            remaining = int(amount)
            # the domain's capacity leaves the cluster: subtract it from
            # the flavor's nominal cells greedily across CQ rows (row
            # order — deterministic, documented quota-level model; TAS
            # placement feasibility is out of this forecast's scope)
            for r in range(view.n_cq):
                if remaining <= 0:
                    break
                have = int(view.nominal[r, j])
                take = min(have, remaining)
                view.nominal[r, j] = have - take
                remaining -= take

    def cost(self) -> float:
        return sum(a for _, a in self.amounts)

    def describe(self) -> str:
        parts = ", ".join(f"{r}-{a}" for r, a in self.amounts)
        dom = f" (domain {self.domain})" if self.domain else ""
        return f"drain {self.flavor}{dom}: {parts}"

    def to_dict(self) -> dict:
        return {
            "kind": self.kind, "flavor": self.flavor,
            "amounts": dict(self.amounts), "domain": self.domain,
        }


class PolicyDelta(ScenarioDelta):
    """Switch the admission policy for one scenario — the what-if an
    operator runs BEFORE enabling ``--policy`` on a live control plane.

    Compiles the named policy (closed kueue_tpu_torch/policy.POLICY registry)
    onto the scenario's copy of the lowered backlog: per-candidate
    flavor scores into ``view.score`` and deadline boosts into
    ``view.priority``; the planner's forecast then also scales each
    admitted workload's virtual runtime by the policy's throughput
    model, so makespan/TTA deltas vs the baseline are visible in the
    same report."""

    kind = "policy"

    def __init__(self, policy: str, now: float = 0.0):
        self.policy = policy
        self.now = now

    def apply(self, view: ArrayView) -> None:
        from kueue_tpu_torch.policy import resolve_policy

        try:
            pol = resolve_policy(self.policy)
        except ValueError as e:
            raise ScenarioApplyError(str(e))
        view.policy_name = pol.name
        lowered = view.lowered
        if lowered is None or view.score is None:
            raise ScenarioApplyError(
                "policy scenario requires a lowered backlog "
                "(no score surface on this plan)"
            )
        if pol.is_default:
            view.score[:] = 0
            return
        from kueue_tpu_torch.core.encode import encode_candidate_scores

        w = len(lowered.heads)
        view.score[:w] = encode_candidate_scores(
            pol, lowered.heads, lowered.candidate_flavors,
            view.score.shape[1],
        )
        view.score[w:] = 0
        for i, wl in enumerate(lowered.heads):
            boost = pol.priority_boost(wl, self.now)
            if boost:
                view.priority[i] += boost

    def cost(self) -> float:
        # a policy switch is config-only: the cheapest intervention
        return 0.0

    def describe(self) -> str:
        return f"admission policy -> {self.policy}"

    def to_dict(self) -> dict:
        return {"kind": self.kind, "policy": self.policy, "now": self.now}


@dataclass(frozen=True)
class PlanScenario:
    name: str
    deltas: Tuple[ScenarioDelta, ...] = ()

    def apply(self, view: ArrayView) -> None:
        for d in self.deltas:
            d.apply(view)

    def cost(self) -> float:
        return sum(d.cost() for d in self.deltas)

    def describe(self) -> List[str]:
        return [d.describe() for d in self.deltas]

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "deltas": [d.to_dict() for d in self.deltas],
        }


def delta_from_dict(d: dict) -> ScenarioDelta:
    """Wire dict -> delta (the POST /debug/plan body codec)."""
    kind = d.get("kind", "")
    if kind == "quota":
        return NominalQuotaDelta(
            node=d["node"], flavor=d["flavor"], resource=d["resource"],
            delta=int(d["delta"]),
        )
    if kind == "flavorCapacity":
        deltas = d.get("deltas")
        return FlavorCapacityDelta.build(
            d["node"], d["flavor"],
            None if deltas is None else {k: int(v) for k, v in deltas.items()},
        )
    if kind == "lendingLimit":
        lim = d.get("limit")
        return LendingLimitDelta(
            node=d["node"], flavor=d["flavor"], resource=d["resource"],
            limit=None if lim is None else int(lim),
        )
    if kind == "borrowingLimit":
        lim = d.get("limit")
        return BorrowingLimitDelta(
            node=d["node"], flavor=d["flavor"], resource=d["resource"],
            limit=None if lim is None else int(lim),
        )
    if kind == "weight":
        return FairShareWeightDelta(
            node=d["node"], weight_milli=int(d["weightMilli"])
        )
    if kind == "priority":
        return PriorityDelta(workload=d["workload"], delta=int(d["delta"]))
    if kind == "drainDomain":
        return DrainDomainDelta.build(
            d["flavor"],
            {k: int(v) for k, v in (d.get("amounts") or {}).items()},
            domain=d.get("domain", ""),
        )
    if kind == "policy":
        return PolicyDelta(d["policy"], now=float(d.get("now", 0.0)))
    raise ScenarioApplyError(f"unknown scenario delta kind {kind!r}")


def scenario_from_dict(d: dict, default_name: str = "scenario") -> PlanScenario:
    return PlanScenario(
        name=d.get("name") or default_name,
        deltas=tuple(delta_from_dict(x) for x in d.get("deltas", [])),
    )
