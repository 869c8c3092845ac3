"""Pluggable admission-policy subsystem — heterogeneity- and
deadline-aware scoring through the batched kernels (port of
kueue_tpu/policy/engine.py; host-only code, copied).

The control plane's policy surface was reference-Kueue (first-fit
flavor walks, priority/FIFO nomination, cost-ordered preemption).
PAPERS.md names the next tier and this module implements it as a
CLOSED registry of declarative policies (``POLICY`` is the single
source of truth):

- ``first-fit`` (default): score-free. Compiles all-zero score
  tensors, zero priority boosts and zero victim-cost adjustments, so
  the scored kernels' masked score-argmax degenerates to exactly the
  boolean first-fit argmax — **bit-for-bit identical** to the
  pre-policy decisions.
- ``gavel`` (arXiv:2008.09213): heterogeneity-aware allocation. A
  workload declares per-flavor relative throughput
  (``kueue.tpu/throughput-<flavor>`` labels); a candidate's score is
  the milli-scaled throughput of its slowest flavor, so the kernels
  admit each gang to the flavor where its *normalized* throughput is
  best, not just where it first fits.
- ``prema`` (arXiv:1909.04548): predictive preemption. A workload
  declares estimated remaining work (``kueue.tpu/remaining-seconds``);
  victim candidate ordering prefers victims with the MOST remaining
  work (least completed work wasted by the eviction).
- ``deadline``: SLO-aware nomination. A workload declares an absolute
  deadline (``kueue.tpu/deadline``, epoch seconds); its entry-order
  priority is boosted monotonically as the deadline approaches, so
  ordering tightens without starving undeadlined work.
- ``gavel-deadline``: the Gavel flavor scoring and the deadline boost
  composed.

A policy COMPILES its declarative inputs into dense per-head tensors
(``core/encode.py`` packs them; ``pack_heads`` / ``plan_drain`` ship
them): the kernels never see labels, only int64 score tensors, which
keeps the device path data-independent and the host mirrors bit-exact.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

__all__ = [
    "POLICY",
    "DEFAULT_POLICY",
    "AdmissionPolicy",
    "resolve_policy",
    "policy_names",
    "annotate_lowered",
    "annotate_multi",
    "THROUGHPUT_LABEL_PREFIX",
    "REMAINING_SECONDS_LABEL",
    "DEADLINE_LABEL",
    "SCORE_SCALE",
    "DEADLINE_BOOST_CAP",
]

# ---- declarative workload inputs (object labels) ----
# relative throughput of this workload on flavor <flavor> (float > 0;
# absent = 1.0 — the flavor is neither preferred nor penalized)
THROUGHPUT_LABEL_PREFIX = "kueue.tpu/throughput-"
# estimated remaining work in seconds (PREMA)
REMAINING_SECONDS_LABEL = "kueue.tpu/remaining-seconds"
# absolute deadline, epoch seconds (SLO)
DEADLINE_LABEL = "kueue.tpu/deadline"

# scores are integral milli-units: float label inputs quantize ONCE at
# compile time, so device and host mirrors compare identical int64
SCORE_SCALE = 1000
# deadline boost saturates here (a missed deadline cannot outrank an
# explicitly higher priority class by more than this)
DEADLINE_BOOST_CAP = 1_000_000

# remaining-work adjustments clamp here (about 11.5 days) so a absurd
# label cannot overflow the int64 sort key arithmetic
_REMAINING_CAP_S = 1_000_000.0


def _label_float(wl, key: str) -> Optional[float]:
    raw = (getattr(wl, "labels", None) or {}).get(key)
    if raw is None:
        return None
    try:
        return float(raw)
    except (TypeError, ValueError):
        return None


def workload_throughput(wl, flavor: str) -> float:
    """The workload's declared relative throughput on ``flavor``
    (1.0 when undeclared or invalid — neutral)."""
    v = _label_float(wl, THROUGHPUT_LABEL_PREFIX + flavor)
    if v is None or v <= 0:
        return 1.0
    return v


def _candidate_throughput(wl, flavor_names: Sequence[str]) -> float:
    """A candidate assigns one flavor per resource group; the gang runs
    at the pace of its SLOWEST flavor."""
    if not flavor_names:
        return 1.0
    return min(workload_throughput(wl, f) for f in flavor_names)


def _deadline_boost(deadline_s: float, now_s: float) -> int:
    """Monotone urgency boost: 0 far from the deadline, saturating at
    DEADLINE_BOOST_CAP once the deadline passes. Deterministic in
    (deadline, now) so replayed decisions reproduce."""
    left = deadline_s - now_s
    if left <= 0:
        return DEADLINE_BOOST_CAP
    return min(DEADLINE_BOOST_CAP, int(DEADLINE_BOOST_CAP / (1.0 + left)))


class AdmissionPolicy:
    """One admission policy: pure functions from a workload's
    declarative inputs to the score tensors the kernels consume.

    The base class IS the default ``first-fit`` policy: every hook
    returns the neutral element, which compiles to all-zero tensors —
    the scored kernels then reproduce the boolean first-fit decisions
    bit-for-bit."""

    name = "first-fit"

    @property
    def is_default(self) -> bool:
        return self.name == DEFAULT_POLICY

    # flavor choice: the score of one candidate (its distinct flavor
    # names, one per touched resource group). Higher wins; ties keep
    # the first-fit walk order.
    def candidate_score(self, wl, flavor_names: Sequence[str]) -> int:
        return 0

    # nomination order: added to the head's priority in the entry-order
    # lexsort (borrowing asc, priority desc, timestamp asc)
    def priority_boost(self, wl, now: float) -> int:
        return 0

    # preemption: added to the victim candidate sort key AFTER the
    # (evicted, other-CQ) tiers and BEFORE priority; lower = preferred
    def victim_cost_adjust(self, wl) -> int:
        return 0

    # virtual-time forecasting: multiplier on the workload's runtime
    # hint when placed on this candidate's flavors (Gavel: a 2x-
    # throughput flavor halves the runtime)
    def runtime_scale(self, wl, flavor_names: Sequence[str]) -> float:
        return 1.0

    def to_dict(self) -> dict:
        return {"policy": self.name}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<AdmissionPolicy {self.name}>"


class FirstFitPolicy(AdmissionPolicy):
    name = "first-fit"


class GavelPolicy(AdmissionPolicy):
    name = "gavel"

    def candidate_score(self, wl, flavor_names: Sequence[str]) -> int:
        return int(round(SCORE_SCALE * _candidate_throughput(wl, flavor_names)))

    def runtime_scale(self, wl, flavor_names: Sequence[str]) -> float:
        return 1.0 / max(_candidate_throughput(wl, flavor_names), 1e-6)


class PremaPolicy(AdmissionPolicy):
    name = "prema"

    def victim_cost_adjust(self, wl) -> int:
        remaining = _label_float(wl, REMAINING_SECONDS_LABEL)
        if remaining is None or remaining < 0:
            return 0
        # more remaining work = cheaper victim (less completed work is
        # thrown away); negative adjust sorts it earlier
        return -int(min(remaining, _REMAINING_CAP_S) * SCORE_SCALE)


class DeadlinePolicy(AdmissionPolicy):
    name = "deadline"

    def priority_boost(self, wl, now: float) -> int:
        deadline = _label_float(wl, DEADLINE_LABEL)
        if deadline is None:
            return 0
        return _deadline_boost(deadline, now)


class GavelDeadlinePolicy(GavelPolicy):
    name = "gavel-deadline"

    def priority_boost(self, wl, now: float) -> int:
        deadline = _label_float(wl, DEADLINE_LABEL)
        if deadline is None:
            return 0
        return _deadline_boost(deadline, now)


DEFAULT_POLICY = "first-fit"

# THE closed registry: every ``policy=`` argument and the planner's
# ``policy`` scenario kind share this vocabulary.
POLICY: Dict[str, type] = {
    "first-fit": FirstFitPolicy,
    "gavel": GavelPolicy,
    "prema": PremaPolicy,
    "deadline": DeadlinePolicy,
    "gavel-deadline": GavelDeadlinePolicy,
}


def policy_names() -> list:
    return sorted(POLICY)


def resolve_policy(name: Optional[str]) -> AdmissionPolicy:
    """Name -> policy instance. ``None``/empty resolves to the default;
    unknown names raise (the registry is closed — no ad-hoc policies)."""
    if not name:
        name = DEFAULT_POLICY
    cls = POLICY.get(name)
    if cls is None:
        raise ValueError(
            f"unknown admission policy {name!r}; registered policies: "
            + ", ".join(policy_names())
        )
    return cls()


# ---- compilation onto lowered batches ----
def annotate_lowered(policy: AdmissionPolicy, lowered, now: float) -> None:
    """Compile the policy onto a cycle batch (core/solver.Lowered) IN
    PLACE: ``lowered.score`` int64[W, K] and the per-head priority
    boosts. A default policy compiles nothing (score stays None =
    all-zero on the device), so the annotated batch is byte-identical
    to an unannotated one."""
    if policy is None or policy.is_default:
        return
    from kueue_tpu_torch.core.encode import encode_candidate_scores

    lowered.score = encode_candidate_scores(
        policy, lowered.heads, lowered.candidate_flavors,
        lowered.valid.shape[1],
    )
    _boost_priority(policy, lowered, now)


def annotate_multi(policy: AdmissionPolicy, lowered, now: float) -> None:
    """``annotate_lowered`` for the drain batch (core/solver.
    MultiLowered): ``lowered.score`` int64[W, P, K]."""
    if policy is None or policy.is_default:
        return
    from kueue_tpu_torch.core.encode import encode_candidate_scores_multi

    lowered.score = encode_candidate_scores_multi(policy, lowered)
    _boost_priority(policy, lowered, now)


def _boost_priority(policy: AdmissionPolicy, lowered, now: float) -> None:
    # policies without a boost hook (e.g. plain gavel) skip the
    # per-head python walk entirely — bulk lowering cost discipline
    if type(policy).priority_boost is AdmissionPolicy.priority_boost:
        return
    for i, wl in enumerate(lowered.heads):
        boost = policy.priority_boost(wl, now)
        if boost:
            lowered.priority[i] += boost
