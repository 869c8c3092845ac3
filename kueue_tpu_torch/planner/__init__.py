"""Capacity planning — scenario-batched admission forecasting (port of
kueue_tpu/planner).

The read-only "what would it take?" subsystem over the admission hot
path: encode the live snapshot once (core/encode.py), lower the pending
backlog once (core/solver.py), then solve S hypothetical cluster
configurations — quota bumps, flavor capacity changes, lending /
borrowing limit edits, TAS-domain drains, priority shifts, admission
policies — in ONE batched solve (ops/plan_kernel.py, kernel B14: three
launches on the card, one fetch).
"""

from kueue_tpu_torch.planner.engine import (
    Planner,
    PlanReport,
    ScenarioOutcome,
    forecast_time_to_admission,
    plan_request,
    solve_scenario_host,
)
from kueue_tpu_torch.planner.scenarios import (
    BorrowingLimitDelta,
    DrainDomainDelta,
    FairShareWeightDelta,
    FlavorCapacityDelta,
    LendingLimitDelta,
    NominalQuotaDelta,
    PlanScenario,
    PriorityDelta,
    delta_from_dict,
    scenario_from_dict,
)

__all__ = [
    "Planner",
    "PlanReport",
    "ScenarioOutcome",
    "forecast_time_to_admission",
    "plan_request",
    "solve_scenario_host",
    "PlanScenario",
    "NominalQuotaDelta",
    "FlavorCapacityDelta",
    "LendingLimitDelta",
    "BorrowingLimitDelta",
    "FairShareWeightDelta",
    "PriorityDelta",
    "DrainDomainDelta",
    "delta_from_dict",
    "scenario_from_dict",
]
