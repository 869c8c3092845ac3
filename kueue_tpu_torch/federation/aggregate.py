"""Federation-wide state aggregation — the ``GlobalSnapshot``.

The global scheduler needs one coherent view of every worker control
plane: pending positions, per-cohort fair-share standings, flavor
capacities, and — the scoring input — a forecast time-to-admission for
every (pending workload, cluster) pair. This module collects that view
WITHOUT a new wire protocol: an in-process worker is read directly
through its runtime; a remote worker is read through the replica feed
it already serves (a ``JournalTailer`` over ``HTTPTailSource`` keeps a
live read-only twin, exactly the read-replica machinery — the
global scheduler is just one more tailer in the fan-out tree).

The snapshot is device-encodable: ``encode()`` lays the per-pair
forecasts and policy scores out as the dense int64 ``[W, C]`` tensors
``ops/global_kernel.solve_rescore`` consumes, with the per-workload
current-winner column and crc32 rotation offsets the kernel's
tie-break key packs in. Aggregation is strictly read-only over every
runtime it touches (the planner forecast contract), and a worker that
cannot be read — partitioned, feedless, or mid-resync — degrades to
"unscorable" columns instead of failing the pass.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from kueue_tpu_torch.admissionchecks.multikueue_transport import (
    ClusterUnreachable,
    TransportError,
)
from kueue_tpu_torch.testing import faults

__all__ = [
    "WorkerView",
    "GlobalSnapshot",
    "collect_global_snapshot",
    "readable_runtime",
]


@dataclass
class WorkerView:
    """One worker cluster's aggregated standing."""

    name: str
    reachable: bool = False
    source: str = "none"  # inprocess | feed | none
    pending: int = 0
    admitted: int = 0
    #: per-CQ fair-share standings: clusterQueue, cohort, weightMilli,
    #: dominantShareMilli, pending
    queues: List[dict] = field(default_factory=list)
    #: per (flavor, resource) capacity totals across CQs
    capacities: List[dict] = field(default_factory=list)
    error: str = ""

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "reachable": self.reachable,
            "source": self.source,
            "pending": self.pending,
            "admitted": self.admitted,
            "queues": list(self.queues),
            "capacities": list(self.capacities),
            "error": self.error,
        }


@dataclass
class GlobalSnapshot:
    """The federation at one instant, scored rows ready to encode.

    Row order is ``keys`` (sorted workload keys); column order is
    ``clusters`` (sorted worker names). ``tta_ms``/``score``/``valid``
    are the kernel tensors; ``fences`` carries the dispatch fence each
    row was OBSERVED at — the rebalancer's compare-and-swap token (a
    fence that moved between aggregation and apply means the placement
    changed under us and the move must be dropped).
    """

    created_at: float
    clusters: List[str]
    workers: Dict[str, WorkerView]
    keys: List[str]
    fences: Dict[str, int]
    current: Dict[str, Optional[str]]
    tta_ms: np.ndarray  # int64[W, C]
    score: np.ndarray  # int64[W, C]
    valid: np.ndarray  # bool[W, C]

    def encode(self):
        """Kernel inputs: (tta_ms, score, valid, current_col, rotation)."""
        c = len(self.clusters)
        col = {name: j for j, name in enumerate(self.clusters)}
        current = np.array(
            [col.get(self.current.get(k) or "", -1) for k in self.keys],
            dtype=np.int32,
        )
        rotation = np.array(
            [
                zlib.crc32(k.encode()) % c if c else 0
                for k in self.keys
            ],
            dtype=np.int32,
        )
        return self.tta_ms, self.score, self.valid, current, rotation

    def to_dict(self) -> dict:
        rows = []
        for i, key in enumerate(self.keys):
            by_cluster = {}
            for j, name in enumerate(self.clusters):
                by_cluster[name] = (
                    round(int(self.tta_ms[i, j]) / 1000.0, 3)
                    if self.valid[i, j]
                    else None
                )
            rows.append(
                {
                    "workload": key,
                    "fence": self.fences.get(key, 0),
                    "current": self.current.get(key),
                    "ttaByClusterS": by_cluster,
                }
            )
        return {
            "createdAt": self.created_at,
            "clusters": list(self.clusters),
            "workers": {
                name: view.to_dict() for name, view in self.workers.items()
            },
            "workloads": rows,
        }


def readable_runtime(cluster, reader=None):
    """The runtime a worker can be READ through: its in-process runtime
    (InProcessTransport), or the live twin a feed reader (JournalTailer
    or plain runtime) maintains. Returns (runtime, source)."""
    rt = getattr(cluster.transport, "runtime", None)
    if rt is not None:
        return rt, "inprocess"
    if reader is None:
        return None, "none"
    rt = getattr(reader, "runtime", None)
    if rt is not None:
        return rt, "feed"
    if hasattr(reader, "workloads"):  # a bare ClusterRuntime
        return reader, "feed"
    return None, "none"


def _fill_worker_view(view: WorkerView, rt) -> None:
    """Pending positions, fair-share standings and flavor capacities
    for one readable worker runtime — all read-only."""
    from kueue_tpu_torch.core.snapshot import take_snapshot

    view.admitted = sum(
        1 for wl in rt.workloads.values() if wl.is_admitted
    )
    snapshot = take_snapshot(rt.cache)
    total_pending = 0
    for cq_name in sorted(snapshot.cq_models):
        model = snapshot.cq_models[cq_name]
        pending = int(rt.queues.pending_workloads(cq_name))
        total_pending += pending
        view.queues.append(
            {
                "clusterQueue": cq_name,
                "cohort": model.cohort,
                "weightMilli": int(model.fair_sharing.weight_milli),
                "dominantShareMilli": int(
                    snapshot.dominant_resource_share(cq_name)
                ),
                "pending": pending,
            }
        )
    view.pending = total_pending
    # flavor capacities: nominal/usage summed over CQ rows per cell
    n_cq = len(snapshot.cq_models)
    nominal = snapshot.nominal[:n_cq].clip(min=0).sum(axis=0)
    usage = snapshot.local_usage[:n_cq].sum(axis=0)
    for j, fr in enumerate(snapshot.fr_list):
        view.capacities.append(
            {
                "flavor": fr.flavor,
                "resource": fr.resource,
                "nominal": int(nominal[j]),
                "usage": int(usage[j]),
                "available": int(max(0, nominal[j] - usage[j])),
            }
        )


def collect_global_snapshot(
    disp,
    readers: Optional[dict] = None,
    keys: Optional[List[str]] = None,
) -> GlobalSnapshot:
    """Aggregate every worker + score every (pending workload, cluster)
    pair. ``disp`` is the FederationDispatcher; ``readers`` maps worker
    name -> feed reader for wire-only clusters.

    Rows are the federation's REBALANCEABLE pending set: workloads with
    a dispatch state, not finished and not yet admitted (an admitted
    gang is running — moving it is preemption, which stays with the
    deposal path). The ``global.partition`` fault point fires once per
    worker read; a TransportError/ClusterUnreachable there degrades the
    worker to unscorable, anything armed as "crash" kills the pass.
    """
    from kueue_tpu_torch.planner import forecast_time_to_admission

    readers = readers or {}
    now = disp.runtime.clock.now()
    clusters = sorted(disp.clusters)
    workers: Dict[str, WorkerView] = {}
    runtimes: Dict[str, object] = {}
    for name in clusters:
        cluster = disp.clusters[name]
        view = WorkerView(name=name)
        try:
            faults.fire("global.partition")
            rt, source = readable_runtime(cluster, readers.get(name))
        except (TransportError, ClusterUnreachable) as e:
            rt, source = None, "none"
            view.error = str(e) or "partitioned"
        view.source = source
        if rt is None:
            if not view.error:
                view.error = "no readable runtime (in-process or feed)"
        else:
            view.reachable = True
            runtimes[name] = rt
            try:
                _fill_worker_view(view, rt)
            except Exception as e:  # noqa: BLE001 — a half-applied feed
                # twin must degrade this worker, never break the pass
                view.reachable = False
                view.error = f"aggregation failed: {e!r}"
                runtimes.pop(name, None)
        workers[name] = view

    def _placement_of(st):
        return st.winner or (st.clusters[0] if st.clusters else None)

    def _reserving_remotely(key, st) -> bool:
        """The copy on the workload's current placement already holds a
        quota reservation: it WON the race, the winner pick just has
        not observed it yet. Rescoring it would read the copy's own
        admitted usage as congestion and retract a placement that is
        de-facto final — the oscillation the rebalanceable set must
        exclude (moving reserved work is preemption, not rebalancing)."""
        rt = runtimes.get(_placement_of(st) or "")
        if rt is None:
            return False
        rwl = rt.workloads.get(key)
        return rwl is not None and rwl.has_quota_reservation

    if keys is None:
        keys = sorted(
            key
            for key, st in disp.states.items()
            if not st.finished
            and key in disp.runtime.workloads
            and not disp.runtime.workloads[key].is_finished
            and not disp.runtime.workloads[key].is_admitted
            and not _reserving_remotely(key, st)
        )
    w, c = len(keys), len(clusters)
    tta_ms = np.zeros((w, c), dtype=np.int64)
    score = np.zeros((w, c), dtype=np.int64)
    valid = np.zeros((w, c), dtype=bool)
    policy = getattr(disp.runtime, "policy", None)
    for i, key in enumerate(keys):
        wl = disp.runtime.workloads.get(key)
        if wl is None:
            continue
        for j, name in enumerate(clusters):
            rt = runtimes.get(name)
            if rt is None:
                continue
            try:
                tta = forecast_time_to_admission(rt, wl)
            except Exception:  # noqa: BLE001 — scoring is advisory
                tta = None
            if tta is None:
                continue
            tta_ms[i, j] = int(round(float(tta) * 1000.0))
            valid[i, j] = True
            if policy is not None and not policy.is_default:
                flavor_names = sorted(
                    getattr(rt.cache, "flavors", {}) or {}
                )
                score[i, j] = int(
                    policy.candidate_score(wl, flavor_names)
                )
    return GlobalSnapshot(
        created_at=now,
        clusters=clusters,
        workers=workers,
        keys=list(keys),
        fences={
            k: disp.states[k].fence for k in keys if k in disp.states
        },
        current={
            # a reserving winner is THE placement; a still-racing
            # workload's placement is its best-ranked target cluster
            # (with --federation-fanout that is where it is queued)
            k: (
                disp.states[k].winner
                or (
                    disp.states[k].clusters[0]
                    if disp.states[k].clusters
                    else None
                )
            )
            for k in keys
            if k in disp.states
        },
        tta_ms=tta_ms,
        score=score,
        valid=valid,
    )
