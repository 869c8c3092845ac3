"""Fault-tolerant MultiKueue federation — multi-cluster dispatch as a
first-class scenario.

A ``FederationDispatcher`` fronts N worker control planes (each a full
ClusterRuntime with its own journal, lease and guarded solver — or a
remote ``kueue_tpu_torch.server`` reached over the existing HTTP surface),
mirrors every pending workload to the clusters the planner ranks best
by forecast time-to-admission, admits wherever quota clears first, and
retracts the losers through an idempotent, journaled retraction
protocol (dedup keys + at-least-once retries): a retraction lost to a
partition is retried until acknowledged, so it can never leave a gang
admitted twice.

Split-brain is fenced with per-workload epoch tokens: every mirrored
copy carries the dispatch fence in its labels, every sync-back echoes
it, and a stale token — a deposed winner healing after the workload
moved on — is refused and retracted instead of double-admitting. The
dispatcher's own crash windows are closed by the journal: dispatch
intent, winner picks and the retraction queue are journaled WAL-style
and replayed by ``storage.recover``, so a dispatcher killed
mid-dispatch converges to the same federated admitted set.
"""

from kueue_tpu_torch.federation.aggregate import (
    GlobalSnapshot,
    WorkerView,
    collect_global_snapshot,
)
from kueue_tpu_torch.federation.dispatcher import (
    DISPATCH_RECORD,
    FEDERATION_RECORD_TYPES,
    FENCE_LABEL,
    GANG_LABEL,
    RETRACT_DONE_RECORD,
    RETRACT_ENQUEUE_RECORD,
    WINNER_LABEL,
    WINNER_RECORD,
    ClusterHealth,
    DispatchState,
    FederationDispatcher,
    Retraction,
)
from kueue_tpu_torch.federation.global_scheduler import GlobalScheduler
from kueue_tpu_torch.federation.placement import planner_placement_score

__all__ = [
    "FederationDispatcher",
    "GlobalScheduler",
    "GlobalSnapshot",
    "WorkerView",
    "collect_global_snapshot",
    "DispatchState",
    "Retraction",
    "ClusterHealth",
    "planner_placement_score",
    "FENCE_LABEL",
    "WINNER_LABEL",
    "GANG_LABEL",
    "DISPATCH_RECORD",
    "WINNER_RECORD",
    "RETRACT_ENQUEUE_RECORD",
    "RETRACT_DONE_RECORD",
    "FEDERATION_RECORD_TYPES",
]
