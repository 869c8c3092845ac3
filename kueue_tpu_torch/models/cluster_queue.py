"""ClusterQueue — cluster-scoped quota pool.

Mirrors apis/kueue/v1beta1/clusterqueue_types.go: resourceGroups of
flavors x resources with nominal/borrowing/lending limits, cohort
membership, queueing strategy, namespace selector, flavor fungibility,
preemption policies, admission checks, stop policy and fair-sharing
weight. Validation reproduces the CEL rules called out in SURVEY.md
(borrowingLimit/lendingLimit require a cohort, flavor sets must be
consistent within a resource group, at most 16 resource groups).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from kueue_tpu_torch.models.constants import (
    MAX_RESOURCE_GROUPS,
    BorrowWithinCohortPolicy,
    FlavorFungibilityPolicy,
    PreemptionPolicy,
    QueueingStrategy,
    ReclaimWithinCohortPolicy,
    StopPolicy,
)
from kueue_tpu_torch.resources import quantity_to_int


@dataclass
class ResourceQuota:
    """Per (flavor, resource) quota triple (clusterqueue_types.go:205-246).

    Values are canonical int64 units; ``None`` limits mean unlimited
    borrowing / full lending respectively.
    """

    nominal: int = 0
    borrowing_limit: Optional[int] = None
    lending_limit: Optional[int] = None


@dataclass
class FlavorQuotas:
    name: str  # ResourceFlavor reference
    resources: Dict[str, ResourceQuota] = field(default_factory=dict)

    @staticmethod
    def build(name: str, quotas: Dict[str, object]) -> "FlavorQuotas":
        """Convenience constructor taking quantity strings.

        ``quotas`` maps resource name -> nominal, or -> (nominal,
        borrowingLimit, lendingLimit) tuples.
        """
        out: Dict[str, ResourceQuota] = {}
        for rname, spec in quotas.items():
            if isinstance(spec, (tuple, list)):
                nominal, borrow, lend = (list(spec) + [None, None])[:3]
            else:
                nominal, borrow, lend = spec, None, None
            out[rname] = ResourceQuota(
                nominal=quantity_to_int(rname, nominal),
                borrowing_limit=None if borrow is None else quantity_to_int(rname, borrow),
                lending_limit=None if lend is None else quantity_to_int(rname, lend),
            )
        return FlavorQuotas(name=name, resources=out)


@dataclass
class ResourceGroup:
    covered_resources: Tuple[str, ...]
    flavors: Tuple[FlavorQuotas, ...]

    def __post_init__(self):
        if not self.flavors:
            raise ValueError("ResourceGroup requires at least one flavor")
        if not self.covered_resources:
            raise ValueError("ResourceGroup requires coveredResources")
        cov = set(self.covered_resources)
        for fq in self.flavors:
            if set(fq.resources) != cov:
                raise ValueError(
                    f"flavor {fq.name} must define quotas exactly for coveredResources {sorted(cov)}"
                )


@dataclass
class BorrowWithinCohort:
    policy: BorrowWithinCohortPolicy = BorrowWithinCohortPolicy.NEVER
    max_priority_threshold: Optional[int] = None


@dataclass
class Preemption:
    """clusterqueue_types.go:424-495."""

    within_cluster_queue: PreemptionPolicy = PreemptionPolicy.NEVER
    reclaim_within_cohort: ReclaimWithinCohortPolicy = ReclaimWithinCohortPolicy.NEVER
    borrow_within_cohort: BorrowWithinCohort = field(default_factory=BorrowWithinCohort)


@dataclass
class FlavorFungibility:
    """clusterqueue_types.go:379-401."""

    when_can_borrow: FlavorFungibilityPolicy = FlavorFungibilityPolicy.BORROW
    when_can_preempt: FlavorFungibilityPolicy = FlavorFungibilityPolicy.TRY_NEXT_FLAVOR


@dataclass
class FairSharing:
    """apis/kueue/v1beta1/fairsharing_types.go:27-52; weight in milli-units."""

    weight_milli: int = 1000


@dataclass
class ClusterQueue:
    name: str
    resource_groups: Tuple[ResourceGroup, ...] = ()
    cohort: Optional[str] = None
    queueing_strategy: QueueingStrategy = QueueingStrategy.BEST_EFFORT_FIFO
    namespace_selector: Optional[Dict[str, str]] = None  # None selects nothing; {} selects all
    flavor_fungibility: FlavorFungibility = field(default_factory=FlavorFungibility)
    preemption: Preemption = field(default_factory=Preemption)
    admission_checks: Tuple[str, ...] = ()
    admission_checks_strategy: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    # check name -> flavor names it applies to ({} entry = all flavors)
    stop_policy: StopPolicy = StopPolicy.NONE
    fair_sharing: FairSharing = field(default_factory=FairSharing)

    def __post_init__(self):
        if not self.name:
            raise ValueError("ClusterQueue.name is required")
        if len(self.resource_groups) > MAX_RESOURCE_GROUPS:
            raise ValueError(f"at most {MAX_RESOURCE_GROUPS} resourceGroups allowed")
        seen_resources = set()
        seen_flavors = set()
        for rg in self.resource_groups:
            for r in rg.covered_resources:
                if r in seen_resources:
                    raise ValueError(f"resource {r} covered by more than one resourceGroup")
                seen_resources.add(r)
            for fq in rg.flavors:
                if fq.name in seen_flavors:
                    raise ValueError(f"flavor {fq.name} appears in more than one resourceGroup")
                seen_flavors.add(fq.name)
                if self.cohort is None:
                    for rname, q in fq.resources.items():
                        if q.borrowing_limit is not None:
                            raise ValueError(
                                f"borrowingLimit for {fq.name}/{rname} requires cohort"
                            )
                        if q.lending_limit is not None:
                            raise ValueError(
                                f"lendingLimit for {fq.name}/{rname} requires cohort"
                            )

    def flavor_names(self) -> Tuple[str, ...]:
        return tuple(fq.name for rg in self.resource_groups for fq in rg.flavors)

    def selects_namespace(self, ns_labels: Dict[str, str]) -> bool:
        if self.namespace_selector is None:
            return False
        return all(ns_labels.get(k) == v for k, v in self.namespace_selector.items())
