"""The federation dispatcher — partition-tolerant multi-cluster
dispatch with cross-cluster fencing and a journaled retraction
protocol.

Shape of one workload's life, N worker clusters:

1. **Rank.** The planner scores every healthy cluster by forecast
   time-to-admission (placement.py); the dispatcher mirrors copies to
   the top ``fanout`` clusters. The dispatch intent — epoch fence +
   target set — is journaled BEFORE the first wire call (WAL), so a
   dispatcher killed mid-dispatch replays the record and re-probes
   idempotently (create only where no copy exists).
2. **Race.** Each worker is a full control plane admitting on its own;
   the first cluster observed holding a quota reservation with the
   CURRENT fence echoed in its copy's labels wins. The winner pick is
   journaled; every loser gets a retraction.
3. **Retract.** Retractions are dedup-keyed (workload, cluster, fence),
   journaled on enqueue AND on ack, and retried at-least-once until the
   target acknowledges (a 404 — copy already gone — IS the ack, which
   is what makes retries idempotent). A retraction lost to a partition
   therefore cannot leave a gang admitted twice: the intent survives
   in the journal and in memory until the partition heals.
4. **Fence.** A winner lost past ``worker_lost_timeout`` is deposed:
   the fence bumps, the workload re-dispatches to the remaining
   clusters, and a retraction against the old winner is queued. When
   the deposed winner heals, its copy still carries the OLD fence —
   every sync-back echoes the fence, stale tokens are refused, and the
   stale copy is retracted instead of counting as an admission.
5. **Sync.** The winner's reservation/admission/finish flow back onto
   the local workload; finish triggers retract-everywhere GC.

Per-cluster failure handling rides the existing ``RemoteClient``
backoff machinery (now jittered); a cluster deposed repeatedly is
quarantined from NEW dispatches for ``cluster_quarantine_ttl_s`` — the
guard/quarantine pattern of core/guard.py applied to remotes.
Retractions still pump to a quarantined cluster: the fence cleanup must
reach a deposed winner the moment it heals.
"""

from __future__ import annotations

import time as _time
import zlib
from copy import deepcopy
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from kueue_tpu_torch.admissionchecks.multikueue import MultiKueueCluster
from kueue_tpu_torch.admissionchecks.multikueue_transport import (
    ORIGIN_LABEL,
    ClusterUnreachable,
    RemoteClient,
    RemoteRejected,
    TransportError,
)
from kueue_tpu_torch.federation.health import DEGRADED, HealthPlane
from kueue_tpu_torch.models import Workload
from kueue_tpu_torch.models.constants import WorkloadConditionType
from kueue_tpu_torch.testing import faults

#: operations safe to hedge: reads and heartbeats are pure, copy-create
#: is absorbed by name+fence dedup on the worker, and delete is already
#: at-least-once with 404==ack — but delete rides the retraction pump's
#: own retry loop, so hedging it buys nothing
HEDGEABLE_OPS = frozenset(
    {"get_workload", "list_workload_keys", "create_workload",
     "create_workloads"}
)

#: fence epoch stamped into every mirrored copy's labels and echoed in
#: every sync-back — the cross-cluster split-brain guard
FENCE_LABEL = "kueue.x-k8s.io/multikueue-fence"
#: set on the LOCAL workload once a winner is picked (kueuectl explain
#: and `kueuectl clusters list` read it)
WINNER_LABEL = "kueue.x-k8s.io/multikueue-winner"
#: gang co-placement id (the JobSet/gang parent's key): members share
#: a rotation offset (same starting cluster), are mirrored with the
#: label intact over the wire, and a deposed winner's gang children
#: are retracted atomically with the member that tripped the deposal
GANG_LABEL = "kueue.x-k8s.io/multikueue-gang"

# journal record vocabulary (replayed by storage.recovery into
# runtime.federation_replay, consumed by FederationDispatcher.restore)
DISPATCH_RECORD = "federation_dispatch"
WINNER_RECORD = "federation_winner"
RETRACT_ENQUEUE_RECORD = "federation_retract_enqueue"
RETRACT_DONE_RECORD = "federation_retract_done"
FEDERATION_RECORD_TYPES = (
    DISPATCH_RECORD,
    WINNER_RECORD,
    RETRACT_ENQUEUE_RECORD,
    RETRACT_DONE_RECORD,
)


@dataclass
class DispatchState:
    """One workload's federation epoch."""

    key: str
    fence: int = 0  # 0 = never dispatched; first epoch is 1
    clusters: List[str] = field(default_factory=list)  # ranked targets
    mirrored: Set[str] = field(default_factory=set)  # confirmed copies
    winner: Optional[str] = None
    finished: bool = False

    def to_dict(self) -> dict:
        return {
            "workload": self.key,
            "fence": self.fence,
            "clusters": list(self.clusters),
            "mirrored": sorted(self.mirrored),
            "winner": self.winner,
            "finished": self.finished,
        }


@dataclass
class Retraction:
    """One at-least-once remote delete. The dedup key (workload,
    cluster, fence) makes re-enqueue idempotent across journal replay
    and across the sync loop re-discovering the same loser."""

    key: str
    cluster: str
    fence: int
    attempts: int = 0
    acked: bool = False

    @property
    def dedup(self) -> Tuple[str, str, int]:
        return (self.key, self.cluster, self.fence)

    def to_dict(self) -> dict:
        return {
            "workload": self.key,
            "cluster": self.cluster,
            "fence": self.fence,
            "attempts": self.attempts,
            "acked": self.acked,
        }


@dataclass
class ClusterHealth:
    """Per-remote guard state: strikes accumulate on deposals
    (worker_lost_timeout expiries), the threshold quarantines the
    cluster from NEW dispatches for a TTL."""

    strikes: int = 0
    quarantined_until: Optional[float] = None
    dispatches: int = 0
    wins: int = 0

    def quarantined(self, now: float) -> bool:
        return self.quarantined_until is not None and now < self.quarantined_until


class FederationDispatcher:
    def __init__(
        self,
        runtime,
        clusters: Optional[Dict[str, MultiKueueCluster]] = None,
        worker_lost_timeout: float = 900.0,
        fanout: Optional[int] = None,
        placement=None,  # callable(cluster, wl) -> score | None
        origin: str = "manager",
        base_backoff_s: float = 1.0,
        max_backoff_s: float = 300.0,
        cluster_quarantine_threshold: int = 3,
        cluster_quarantine_ttl_s: float = 600.0,
        heartbeat_interval_s: float = 30.0,
        drive_inprocess: bool = False,
        rank_cache: bool = True,
        adaptive_deadlines: bool = True,
        deadline_floor_s: float = 1.0,
        deadline_cap_s: float = 10.0,
        deadline_k: float = 3.0,
        hedging: bool = True,
        hedge_budget: float = 0.05,
        probe_deadline_s: float = 2.0,
        heartbeat_probe_budget: int = 1,
        health_plane_kw: Optional[dict] = None,
    ):
        from kueue_tpu_torch.federation.placement import planner_placement_score

        self.runtime = runtime
        self.worker_lost_timeout = worker_lost_timeout
        self.fanout = fanout
        self.placement = placement or planner_placement_score
        self.origin = origin
        self.base_backoff_s = base_backoff_s
        self.max_backoff_s = max_backoff_s
        self.cluster_quarantine_threshold = cluster_quarantine_threshold
        self.cluster_quarantine_ttl_s = cluster_quarantine_ttl_s
        self.heartbeat_interval_s = heartbeat_interval_s
        self._last_contact: Dict[str, float] = {}
        # gray-failure immunity: the latency-aware health plane owns
        # per-worker RTT telemetry, the healthy→degraded→lost state
        # machine (probation), adaptive deadlines and the hedge budget
        self.adaptive_deadlines = adaptive_deadlines
        self.hedging = hedging
        self.probe_deadline_s = probe_deadline_s
        self.heartbeat_probe_budget = heartbeat_probe_budget
        self.worker_health = HealthPlane(
            runtime.clock,
            deadline_floor_s=deadline_floor_s,
            deadline_cap_s=deadline_cap_s,
            deadline_k=deadline_k,
            hedge_budget=hedge_budget,
            heartbeat_interval_s=heartbeat_interval_s,
            **(health_plane_kw or {}),
        )
        # in-process worker runtimes advance inside the manager's pass
        # (the analog of remote servers auto-reconciling on POST)
        self.drive_inprocess = drive_inprocess
        self.clusters: Dict[str, MultiKueueCluster] = {}
        self.states: Dict[str, DispatchState] = {}
        self.retractions: Dict[Tuple[str, str, int], Retraction] = {}
        self.health: Dict[str, ClusterHealth] = {}
        # dynamic membership (kueue_tpu_torch/elastic): cordoned workers get
        # no NEW dispatches; drain_worker additionally retracts their
        # placements ahead of removal (scale-down drain-ahead)
        self.cordoned: Set[str] = set()
        # the global scheduler (federation/global_scheduler.py) attaches
        # itself here; every step() then runs its interval-gated rescore
        self.global_scheduler = None
        # per-step rank cache: (step_seq, health fingerprint, filtered
        # names, placement-score memo). Invalidated when the step
        # advances OR any cluster's connectivity/quarantine state flips
        # (a heartbeat marking a worker lost mid-step must re-filter)
        self.rank_cache = rank_cache
        self._step_seq = 0
        self._rank_memo: Optional[tuple] = None
        for cluster in (clusters or {}).values():
            self.add_cluster(cluster)
        # adopt journal records recovery replayed before we existed
        replay = getattr(runtime, "federation_replay", None)
        if replay:
            self.restore(replay)
            runtime.federation_replay = []
        runtime.federation = self

    # ---- wiring ----
    def add_cluster(self, cluster: MultiKueueCluster) -> None:
        if cluster.client is None:
            cluster.client = RemoteClient(
                cluster.transport,
                self.runtime.clock,
                base_backoff_s=self.base_backoff_s,
                max_backoff_s=self.max_backoff_s,
            )
        self.clusters[cluster.name] = cluster
        self.health.setdefault(cluster.name, ClusterHealth())
        m = getattr(self.runtime, "metrics", None)
        if m is not None:
            # pre-materialize this cluster's RTT series so the scrape
            # surface is complete before the first exchange
            m.multikueue_remote_rtt_seconds.touch(cluster=cluster.name)

    # ---- dynamic membership (scale-up join / drain-ahead scale-down) ----
    def _membership_metric(self, kind: str) -> None:
        m = getattr(self.runtime, "metrics", None)
        if m is not None:
            m.elastic_membership_changes_total.inc(kind=kind)

    def add_worker(self, cluster: MultiKueueCluster) -> None:
        """Runtime join: the worker becomes dispatchable on the next
        pass (rank-cache fingerprint changes with the cluster set)."""
        self.add_cluster(cluster)
        self.cordoned.discard(cluster.name)
        self._membership_metric("join")

    def cordon(self, name: str) -> bool:
        """Stop NEW dispatches to ``name``; existing placements stay
        (kubectl-cordon semantics — use drain_worker to move them)."""
        if name not in self.clusters:
            return False
        if name not in self.cordoned:
            self.cordoned.add(name)
            self.runtime.events.record(
                "ElasticWorkerCordoned", f"cluster/{name}",
                f"worker cluster {name} cordoned: no new dispatches; "
                "existing placements unaffected until drained",
                regarding_kind="Cluster",
            )
            self._membership_metric("cordon")
        return True

    def uncordon(self, name: str) -> bool:
        if name not in self.clusters:
            return False
        self.cordoned.discard(name)
        self._membership_metric("uncordon")
        return True

    def drain_worker(self, name: str) -> int:
        """Drain-ahead for scale-down: cordon ``name`` and move every
        placement off it under the fencing protocol — winners are
        deposed (fence bump + at-least-once retraction of the old
        epoch's copy + re-dispatch onto surviving capacity), pending
        mirrors are retracted and dropped from target sets. No strike:
        the operator chose this, the worker did nothing wrong. Returns
        how many placements were deposed."""
        if name not in self.clusters:
            return 0
        self.cordon(name)
        now = self.runtime.clock.now()
        deposed = 0
        for key in sorted(self.states):
            st = self.states[key]
            if st.finished:
                continue
            if st.winner == name:
                wl = self.runtime.workloads.get(key)
                if wl is None:
                    continue
                self._depose_winner(
                    wl, st, now,
                    f'worker cluster "{name}" draining for scale-down',
                    strike=False, cascade=False,
                )
                deposed += 1
            elif name in st.clusters or name in st.mirrored:
                if name in st.clusters:
                    st.clusters.remove(name)
                st.mirrored.discard(name)
                self._enqueue_retraction(key, name, st.fence)
        self._membership_metric("drain")
        return deposed

    def remove_worker(self, name: str) -> bool:
        """Scale-down: drain, flush retractions while the wire still
        exists, then drop the worker. Retractions that could not be
        delivered auto-ack on the next pump (the cluster left the
        federation — nothing to retract)."""
        if name not in self.clusters:
            return False
        self.drain_worker(name)
        self.pump_retractions()
        del self.clusters[name]
        self.health.pop(name, None)
        self.worker_health.forget(name)
        self.cordoned.discard(name)
        self._last_contact.pop(name, None)
        self._membership_metric("leave")
        return True

    # ---- journal plumbing (rides the journal's WAL) ----
    def _journal(self, rtype: str, data: dict) -> None:
        self.runtime._journal_append(rtype, data)

    def _trace_span(self, name: str, key: str, attrs: dict) -> None:
        """One federation hop on the workload's lifecycle trace."""
        tracer = getattr(self.runtime, "tracer", None)
        if tracer is not None:
            tracer.add_workload_span(name, key, attrs)

    def restore(self, records: List[tuple]) -> None:
        """Rebuild dispatch state from replayed journal records (in
        append order). Mirrors are NOT assumed to exist — the first
        pass after recovery re-probes every target and re-creates only
        where no copy answers, which is exactly the crash-mid-dispatch
        convergence story."""
        for rtype, data in records:
            key = data.get("key", data.get("workload", ""))
            if rtype == DISPATCH_RECORD:
                st = self.states.setdefault(key, DispatchState(key=key))
                if int(data["fence"]) >= st.fence:
                    st.fence = int(data["fence"])
                    st.clusters = list(data.get("clusters", []))
                    st.mirrored = set()
                    st.winner = None
            elif rtype == WINNER_RECORD:
                st = self.states.get(key)
                if st is not None and int(data["fence"]) == st.fence:
                    st.winner = data["cluster"]
            elif rtype == RETRACT_ENQUEUE_RECORD:
                r = Retraction(
                    key=key, cluster=data["cluster"], fence=int(data["fence"])
                )
                existing = self.retractions.get(r.dedup)
                if existing is None:
                    self.retractions[r.dedup] = r
                else:
                    # an enqueue AFTER an ack re-opens the entry (the
                    # copy was recreated under the same fence) — replay
                    # must land on the same at-least-once obligation
                    # the live dispatcher had
                    existing.acked = False
            elif rtype == RETRACT_DONE_RECORD:
                dedup = (key, data["cluster"], int(data["fence"]))
                r = self.retractions.get(dedup)
                if r is None:
                    r = Retraction(
                        key=key, cluster=data["cluster"],
                        fence=int(data["fence"]),
                    )
                    self.retractions[dedup] = r
                r.acked = True

    # ---- transport (timeout + backoff + fault surface) ----
    def _deadline_for(self, name: str, cap_s: Optional[float] = None):
        """Per-call adaptive deadline clamp(k*p99, floor, cap), or None
        (transport constructor default) when adaptive deadlines are
        off — the fixed-timeout baseline the grayfail bench A/Bs."""
        if not self.adaptive_deadlines:
            return None  # fixed-timeout baseline: constructor default
        return self.worker_health.deadline_s(name, cap_s=cap_s)

    def _hedge_for(self, name: str, op: str, deadline):
        """p95 hedge delay for idempotent ops, gated on the fleet-wide
        hedge budget; None disables hedging for this exchange."""
        if not self.hedging or op not in HEDGEABLE_OPS:
            return None
        hd = self.worker_health.hedge_delay_s(name)
        if hd is None or (deadline is not None and hd >= deadline):
            return None
        return hd

    def _report_hedge(self, cluster: MultiKueueCluster, m) -> None:
        outcome = cluster.client.last_hedge
        if outcome not in ("won", "lost"):
            return
        self.worker_health.record_hedge()
        if m is not None:
            m.report_hedge(outcome)

    def _call(
        self, cluster: MultiKueueCluster, op: str, *args,
        fault_point: str = "multikueue.partition",
        deadline_cap_s: Optional[float] = None,
    ):
        """One guarded wire exchange: the named fault point fires first
        (an armed TransportError models a partition on this wire and is
        charged to the cluster's reconnect state machine), then the
        call flows through the RemoteClient backoff gate under the
        adaptive per-call deadline (hedged for idempotent ops); every
        outcome lands in the kueue_multikueue_* metrics AND the
        latency-aware health plane.

        RTT is the max of the wall duration (perf_counter — the
        allowlisted telemetry timer) and the injected-clock delta: in
        production the two agree, under FakeClock chaos the injected
        latency only shows up on the clock — and the health plane must
        see the limp the chaos layer injected."""
        m = getattr(self.runtime, "metrics", None)
        deadline = self._deadline_for(cluster.name, deadline_cap_s)
        hedge = self._hedge_for(cluster.name, op, deadline)
        self.worker_health.record_call()
        t0 = _time.perf_counter()
        c0 = self.runtime.clock.now()
        try:
            try:
                faults.fire(fault_point)
            except TransportError as e:
                cluster.client._record_failure()
                raise ClusterUnreachable(str(e))
            result = cluster.client.call(
                op, *args, deadline_s=deadline, hedge_delay_s=hedge
            )
        except ClusterUnreachable:
            rtt = max(
                _time.perf_counter() - t0, self.runtime.clock.now() - c0
            )
            self._last_contact[cluster.name] = self.runtime.clock.now()
            self.worker_health.observe_rtt(cluster.name, rtt, ok=False)
            self._report_hedge(cluster, m)
            if m is not None:
                m.report_dispatch(cluster.name, "unreachable")
            raise
        except RemoteRejected:
            rtt = max(
                _time.perf_counter() - t0, self.runtime.clock.now() - c0
            )
            self._last_contact[cluster.name] = self.runtime.clock.now()
            # the wire answered — a rejection is a healthy exchange as
            # far as latency health is concerned
            self.worker_health.observe_rtt(cluster.name, rtt, ok=True)
            self._report_hedge(cluster, m)
            if m is not None:
                m.report_dispatch(cluster.name, "rejected", rtt)
            raise
        rtt = max(_time.perf_counter() - t0, self.runtime.clock.now() - c0)
        self._last_contact[cluster.name] = self.runtime.clock.now()
        self.worker_health.observe_rtt(cluster.name, rtt, ok=True)
        self._report_hedge(cluster, m)
        if m is not None:
            m.report_dispatch(cluster.name, "ok", rtt)
        return result

    # ---- placement ----
    def _health_fingerprint(self, now: float) -> tuple:
        """Connectivity + quarantine + latency-health state of every
        configured cluster — the rank cache's invalidation key. A
        heartbeat (or any wire exchange) that flips a cluster's
        reachability OR its probation state changes this fingerprint
        and drops the cached filtered list mid-step."""
        return tuple(
            (
                n,
                c.client.active if c.client is not None else True,
                self.health[n].quarantined(now),
                n in self.cordoned,
                self.worker_health.state(n),
            )
            for n, c in self.clusters.items()
        )

    def _healthy_names(self, now: float) -> List[str]:
        """The health-filtered cluster list, cached per federation step
        (rank_clusters used to rebuild it per WORKLOAD per step). The
        cache also scopes the per-(cluster, workload) placement-score
        memo: an invalidation drops both.

        Probation (latency-health DEGRADED) removes a worker from NEW
        dispatches the way quarantine does — but unlike quarantine it
        is latency-driven and self-clearing, and it falls back: if
        probation would leave NOTHING dispatchable, the degraded
        workers stay in rotation (a slow federation beats a stalled
        one)."""
        fp = self._health_fingerprint(now)
        if (
            not self.rank_cache
            or self._rank_memo is None
            or self._rank_memo[0] != self._step_seq
            or self._rank_memo[1] != fp
        ):
            eligible = [
                n for n, _active, quarantined, cordoned, _hs in fp
                if not quarantined and not cordoned
            ]
            preferred = [
                n for n, _active, quarantined, cordoned, hstate in fp
                if not quarantined and not cordoned and hstate != DEGRADED
            ]
            names = preferred or eligible
            self._rank_memo = (self._step_seq, fp, names, {})
        return self._rank_memo[2]

    def _placement_score(self, name: str, wl: Workload):
        """``self.placement`` through the per-step memo: within one
        step the same (cluster, workload) pair is forecast once even
        when dispatch and a deposal both rank it."""
        if not self.rank_cache or self._rank_memo is None:
            return self.placement(self.clusters[name], wl)
        memo = self._rank_memo[3]
        mkey = (name, wl.key)
        if mkey not in memo:
            memo[mkey] = self.placement(self.clusters[name], wl)
        return memo[mkey]

    def rank_clusters(self, wl: Workload) -> List[MultiKueueCluster]:
        """Healthy clusters, best placement first: planner-scored
        clusters ascending by forecast time-to-admission, then
        unscorable ones in a stable per-workload rotation (no
        structural favorite, same as the MultiKueue cluster scan).
        Gang members rotate on their shared gang id, so a gang's
        unscored tie-break starts every member on the SAME cluster."""
        now = self.runtime.clock.now()
        names = list(self._healthy_names(now))
        if len(names) > 1:
            spin = (wl.labels or {}).get(GANG_LABEL) or wl.key
            off = zlib.crc32(spin.encode()) % len(names)
            names = names[off:] + names[:off]
        scored: List[Tuple[float, int, str]] = []
        unscored: List[str] = []
        for i, name in enumerate(names):
            s = self._placement_score(name, wl)
            if s is None:
                unscored.append(name)
            else:
                scored.append((float(s), i, name))
        scored.sort()
        ordered = [name for _, _, name in scored] + unscored
        return [self.clusters[n] for n in ordered]

    # ---- the pass ----
    def step(self) -> None:
        """One federation pass (driven by ClusterRuntime.reconcile_once
        or the server's reconcile loop)."""
        faults.fire("multikueue.worker_crash")
        self._step_seq += 1
        now = self.runtime.clock.now()
        self._sweep_cluster_quarantine(now)
        self._heartbeat(now)
        self.pump_retractions()
        for key in sorted(self.runtime.workloads):
            self._reconcile(self.runtime.workloads[key], now)
        # a locally deleted workload's remote copies must not outlive
        # it: whatever the state still names gets a retraction. Already-
        # finished states are skipped — their retractions were enqueued
        # once and re-enqueueing every pass would re-open acked entries
        # (see _enqueue_retraction) and starve the finished-state GC
        for key in list(self.states):
            if key not in self.runtime.workloads:
                st = self.states[key]
                if st.finished:
                    continue
                for name in set(st.clusters) | st.mirrored:
                    self._enqueue_retraction(key, name, st.fence)
                st.finished = True
        self.pump_retractions()
        self._gc_states()
        if self.drive_inprocess:
            for cluster in self.clusters.values():
                rt = getattr(cluster.transport, "runtime", None)
                if rt is not None:
                    # a partitioned worker keeps scheduling on its own —
                    # only the wire is down — so this runs regardless of
                    # the connectivity state
                    rt.run_until_idle()
        if self.global_scheduler is not None:
            # the global rescore loop (federation/global_scheduler.py)
            # rides the federation pass: interval-gated, so most passes
            # pay one clock read
            self.global_scheduler.maybe_step()
        self._update_gauges()

    def _heartbeat(self, now: float) -> None:
        """Probe clusters the dispatch traffic hasn't touched lately —
        an idle loser must still be detected as lost so /healthz and
        kueue_multikueue_clusters_active tell the truth about the
        federation, not just about the wires the winners use.

        Heartbeats must never stall the dispatch step: each probe is
        bounded by ``probe_deadline_s`` (tighter than the full
        adaptive cap — a heartbeat carries no payload worth waiting
        for), and at most ``heartbeat_probe_budget`` probes per step
        go to NOT-active clusters (reconnect probes into a black hole
        each burn a full probe deadline; active-wire heartbeats are
        effectively free and stay unbudgeted)."""
        probes_left = self.heartbeat_probe_budget
        for name, cluster in self.clusters.items():
            last = self._last_contact.get(name, float("-inf"))
            if now - last < self.heartbeat_interval_s:
                continue
            if not cluster.client.reachable():
                continue
            if not cluster.client.active:
                if probes_left <= 0:
                    continue
                probes_left -= 1
            try:
                self._call(
                    cluster, "list_workload_keys", self.origin,
                    fault_point="multikueue.partition",
                    deadline_cap_s=self.probe_deadline_s,
                )
            except (ClusterUnreachable, RemoteRejected):
                continue

    def _reconcile(self, wl: Workload, now: float) -> None:
        st = self.states.get(wl.key)
        if wl.is_finished:
            if st is not None and not st.finished:
                self._finish_state(st)
            return
        if st is None or st.fence == 0:
            self._dispatch(wl, now)
            return
        if st.finished:
            return
        if st.winner is None:
            self._ensure_mirrors(wl, st)
            self._pick_winner(wl, st, now)
        else:
            self._sync_winner(wl, st, now)

    # ---- dispatch (mirror + WAL) ----
    def _dispatch(self, wl: Workload, now: float) -> None:
        order = self.rank_clusters(wl)
        targets = order[: self.fanout] if self.fanout else order
        if not targets:
            self._set_pending(
                wl, "no worker clusters available for dispatch", now
            )
            return
        st = DispatchState(
            key=wl.key, fence=1, clusters=[c.name for c in targets]
        )
        self.states[wl.key] = st
        # WAL: the intent is durable before the first wire call — a
        # crash anywhere past this line replays the record and
        # re-probes the same target set idempotently
        self._journal(
            DISPATCH_RECORD,
            {"key": st.key, "fence": st.fence, "clusters": st.clusters},
        )
        self._trace_span(
            "federation.dispatch", wl.key,
            {"clusters": list(st.clusters), "fence": st.fence},
        )
        self._set_pending(
            wl,
            "The workload is pending reservation in the worker clusters",
            now,
        )
        self._ensure_mirrors(wl, st)
        self._pick_winner(wl, st, now)

    def _remote_copy(self, wl: Workload, fence: int) -> Workload:
        labels = {ORIGIN_LABEL: self.origin, FENCE_LABEL: str(fence)}
        # gang/job sync adapter: the JobSet/gang parent id crosses the
        # wire with the copy, so a worker (or an operator reading it)
        # sees which mirrored workloads form one gang — and the
        # dispatcher's own sync-back can group them after a restart
        gang = (wl.labels or {}).get(GANG_LABEL)
        if gang:
            labels[GANG_LABEL] = gang
        # W3C trace-context propagation: the mirrored copy carries the
        # manager's lifecycle trace as a traceparent label, so the
        # winning worker's runtime JOINS that trace instead of minting
        # a fresh id — one trace spans manager, worker and replica
        tracer = getattr(self.runtime, "tracer", None)
        if tracer is not None:
            tid = tracer.workload_trace_id(wl.key)
            root = tracer.workload_root(wl.key)
            if tid is not None and root is not None:
                from kueue_tpu_torch.tracing import (
                    TRACEPARENT_LABEL,
                    format_traceparent,
                )

                labels[TRACEPARENT_LABEL] = format_traceparent(
                    tid, root.span_id
                )
        return Workload(
            namespace=wl.namespace,
            name=wl.name,
            queue_name=wl.queue_name,
            pod_sets=deepcopy(wl.pod_sets),
            priority=wl.priority,
            priority_class_name=wl.priority_class_name,
            priority_class_source=wl.priority_class_source,
            creation_time=wl.creation_time,
            labels=labels,
        )

    def _retraction_outstanding(self, key: str, cluster: str) -> bool:
        return any(
            not r.acked
            for r in self.retractions.values()
            if r.key == key and r.cluster == cluster
        )

    def _ensure_mirrors(self, wl: Workload, st: DispatchState) -> None:
        for name in list(st.clusters):
            if name in st.mirrored:
                continue
            if self._retraction_outstanding(st.key, name):
                # retraction barrier: never create a copy while an
                # unacked delete is queued against the same (workload,
                # cluster) — the delete is by key and would otherwise
                # race the fresh copy away
                continue
            cluster = self.clusters.get(name)
            if cluster is None or not cluster.client.reachable():
                continue
            try:
                rwl = self._call(cluster, "get_workload", wl.key)
                if rwl is None:
                    self._call(
                        cluster, "create_workload",
                        self._remote_copy(wl, st.fence),
                    )
                    self.health[name].dispatches += 1
                else:
                    token = self._echoed_fence(rwl)
                    if token != st.fence:
                        # a previous epoch's copy: fence cleanup first,
                        # recreate after the retraction acks
                        self._enqueue_retraction(st.key, name, token)
                        continue
                st.mirrored.add(name)
            except ClusterUnreachable:
                continue
            except RemoteRejected as e:
                # the remote refused the object (its webhook chain):
                # per-workload, not connectivity — drop the target
                st.clusters.remove(name)
                self.runtime.event(
                    "MultiKueueRejected", wl, f"rejected by {name}: {e}"
                )

    # ---- winner pick + fencing ----
    def _echoed_fence(self, rwl: Workload) -> int:
        """The fence token a remote copy echoes back in its labels;
        the transform point models a corrupted/stale echo."""
        try:
            token = int(rwl.labels.get(FENCE_LABEL, 0) or 0)
        except (TypeError, ValueError):
            token = 0
        return int(faults.transform("multikueue.stale_token", token))

    def _pick_winner(self, wl: Workload, st: DispatchState, now: float) -> None:
        reserving: List[str] = []
        for name in st.clusters:
            cluster = self.clusters.get(name)
            if cluster is None or not cluster.client.reachable():
                continue
            try:
                rwl = self._call(cluster, "get_workload", wl.key)
            except (ClusterUnreachable, RemoteRejected):
                continue
            if rwl is None:
                st.mirrored.discard(name)
                continue
            token = self._echoed_fence(rwl)
            if token != st.fence:
                # stale fence: refuse the copy, queue its cleanup
                self._enqueue_retraction(st.key, name, token)
                st.mirrored.discard(name)
                continue
            if rwl.has_quota_reservation:
                reserving.append(name)
        if not reserving:
            return
        # the duplicate-admission window: >1 cluster may hold a
        # reservation right now; a crash here must recover to exactly
        # one admission (the winner record below is what closes it)
        faults.fire("multikueue.duplicate_admit")
        winner = reserving[0]
        st.winner = winner
        self._journal(
            WINNER_RECORD,
            {"key": st.key, "cluster": winner, "fence": st.fence},
        )
        self.health[winner].wins += 1
        wl.labels[WINNER_LABEL] = winner
        self._trace_span(
            "federation.winner", st.key,
            {"cluster": winner, "fence": st.fence},
        )
        self.runtime.event(
            "MultiKueueReserved", wl,
            f'The workload got reservation on "{winner}" (fence {st.fence})',
        )
        for name in st.clusters:
            if name != winner:
                self._enqueue_retraction(st.key, name, st.fence)
                st.mirrored.discard(name)
        st.clusters = [winner]
        self._sync_winner(wl, st, now)

    # ---- winner sync-back ----
    def _sync_winner(self, wl: Workload, st: DispatchState, now: float) -> None:
        # a crash between the winner record and the loser retractions
        # replays to a state where losers are still listed: re-derive
        # the retractions here (dedup-keyed, so steady state no-ops)
        for name in list(st.clusters):
            if name != st.winner:
                self._enqueue_retraction(st.key, name, st.fence)
                st.clusters.remove(name)
        cluster = self.clusters.get(st.winner or "")
        if cluster is None:
            self._depose_winner(wl, st, now, "winner cluster removed")
            return
        rwl = None
        got_answer = False
        if cluster.client.reachable():
            try:
                rwl = self._call(cluster, "get_workload", wl.key)
                got_answer = True
            except (ClusterUnreachable, RemoteRejected):
                pass
        if not got_answer:
            lost_for = (
                now - cluster.lost_since
                if cluster.lost_since is not None
                else 0.0
            )
            if lost_for >= self.worker_lost_timeout:
                self._depose_winner(
                    wl, st, now,
                    f"worker cluster {st.winner} lost for {lost_for:.0f}s",
                )
            return
        if rwl is None:
            # the winner's copy vanished (remote GC / operator delete):
            # restart the epoch
            self._depose_winner(wl, st, now, "remote copy lost")
            return
        token = self._echoed_fence(rwl)
        if token != st.fence:
            # split-brain guard: the copy answering for the winner
            # carries a stale fence — refuse it and retract
            self._enqueue_retraction(st.key, st.winner, token)
            self._depose_winner(
                wl, st, now,
                f"stale fencing token {token} (expected {st.fence})",
                strike=False,
            )
            return
        if rwl.is_finished:
            fin = rwl.conditions[WorkloadConditionType.FINISHED]
            wl.set_condition(
                WorkloadConditionType.FINISHED, True, fin.reason, fin.message,
                now=now,
            )
            self.runtime.on_workload_finished(wl)
            self._finish_state(st)
            return
        if rwl.has_quota_reservation:
            if not wl.has_quota_reservation:
                self._trace_span(
                    "federation.sync_back", st.key,
                    {"cluster": st.winner, "fence": st.fence,
                     "observed": "QuotaReserved"},
                )
                wl.set_condition(
                    WorkloadConditionType.QUOTA_RESERVED, True,
                    reason="QuotaReserved",
                    message=f'Quota reserved on cluster "{st.winner}"',
                    now=now,
                )
                self.runtime.event(
                    "QuotaReserved", wl,
                    f'Quota reserved on cluster "{st.winner}"',
                )
            if rwl.is_admitted and not wl.is_admitted:
                wl.set_condition(
                    WorkloadConditionType.ADMITTED, True, reason="Admitted",
                    message=f'Admitted by cluster "{st.winner}"', now=now,
                )
                self.runtime.event(
                    "Admitted", wl, f'Admitted by cluster "{st.winner}"'
                )
        elif wl.has_quota_reservation:
            # the worker evicted/requeued its copy: reflect reality
            # locally and wait for it to re-reserve
            self._set_pending(
                wl,
                f'reservation lost on cluster "{st.winner}"; waiting',
                now,
            )

    def _depose_winner(
        self, wl: Workload, st: DispatchState, now: float, why: str,
        strike: bool = True,
        cascade: bool = True,
    ) -> None:
        """Fence bump: the current winner is no longer trusted. The old
        epoch's copy gets an at-least-once retraction (delivered when
        the partition heals — the healed deposed winner CANNOT keep the
        gang, its token is stale everywhere), the workload re-disperses
        to the surviving clusters under the new fence.

        Gang atomicity (the JobSet/gang sync adapter): when the deposed
        workload carries a ``GANG_LABEL``, every sibling whose winner is
        the SAME deposed cluster is deposed in the same pass — their
        retractions enqueue together, so a partial gang can never stay
        reserved on a cluster the rest of the gang just left."""
        old = st.winner
        st.winner = None
        st.fence += 1
        wl.labels.pop(WINNER_LABEL, None)
        if old is not None:
            self._enqueue_retraction(st.key, old, st.fence - 1)
            if strike:
                self._strike_cluster(old, now)
        order = [
            c.name for c in self.rank_clusters(wl) if c.name != old
        ]
        if (
            not order
            and old is not None
            and old in self.clusters
            and old not in self.cordoned
        ):
            order = [old]  # last cluster standing: keep trying it
        st.clusters = order[: self.fanout] if self.fanout else order
        st.mirrored = set()
        self._journal(
            DISPATCH_RECORD,
            {"key": st.key, "fence": st.fence, "clusters": st.clusters},
        )
        self._set_pending(
            wl, f"{why}; requeued for re-dispatch (fence {st.fence})", now
        )
        self.runtime.event(
            "MultiKueueClusterLost", wl,
            f"{why}; re-dispatching under fence {st.fence}",
        )
        if cascade and old is not None:
            self._depose_gang_siblings(wl, st, old, now)

    def _depose_gang_siblings(
        self, wl: Workload, st: DispatchState, old: str, now: float
    ) -> None:
        """Retract a deposed winner's gang children atomically: every
        non-finished sibling sharing the gang label and placed on the
        same deposed cluster fence-bumps in this pass (no strike — the
        cluster was already charged once)."""
        gang = (wl.labels or {}).get(GANG_LABEL)
        if not gang:
            return
        for key in sorted(self.states):
            if key == st.key:
                continue
            sib_st = self.states[key]
            if sib_st.finished or sib_st.winner != old:
                continue
            sib = self.runtime.workloads.get(key)
            if sib is None or (sib.labels or {}).get(GANG_LABEL) != gang:
                continue
            self._depose_winner(
                sib, sib_st, now,
                f'gang "{gang}" member {st.key} deposed from "{old}"',
                strike=False, cascade=False,
            )

    def _set_pending(self, wl: Workload, message: str, now: float) -> None:
        qr = wl.conditions.get(WorkloadConditionType.QUOTA_RESERVED)
        if qr is None or qr.status or qr.message != message:
            wl.set_condition(
                WorkloadConditionType.QUOTA_RESERVED, False,
                reason="Pending", message=message, now=now,
            )
        if wl.conditions.get(WorkloadConditionType.ADMITTED) is not None:
            adm = wl.conditions[WorkloadConditionType.ADMITTED]
            if adm.status:
                wl.set_condition(
                    WorkloadConditionType.ADMITTED, False,
                    reason="NoReservation",
                    message="The workload has no reservation", now=now,
                )

    # ---- the retraction protocol ----
    def _enqueue_retraction(self, key: str, cluster: str, fence: int) -> None:
        """Ensure a delete is delivered to ``cluster`` AFTER this
        point. An in-flight (unacked) entry with the same dedup key
        absorbs the request; an ACKED entry is RE-OPENED — a copy can
        legitimately be recreated under the same fence after its first
        retraction acked (crash-recovery re-mirrors, then a rebalance
        moves the placement), and an old ack must not satisfy a new
        delete. The local-delete sweep in step() skips finished states
        so re-opening cannot live-lock the finished-state GC."""
        r = Retraction(key=key, cluster=cluster, fence=fence)
        m = getattr(self.runtime, "metrics", None)
        existing = self.retractions.get(r.dedup)
        if existing is not None and not existing.acked:
            if m is not None:
                m.report_retraction("deduped")
            return
        if existing is not None:
            existing.acked = False
            r = existing
        else:
            self.retractions[r.dedup] = r
        self._journal(
            RETRACT_ENQUEUE_RECORD,
            {"key": key, "cluster": cluster, "fence": fence},
        )
        if m is not None:
            m.report_retraction("enqueued")

    def pump_retractions(self) -> int:
        """Send every unacked retraction whose target is reachable.
        At-least-once: an unreachable target keeps the entry queued
        (and journaled) until a later pump lands it; a 404 on the
        remote — the copy already gone — counts as the ack, which makes
        redelivery after a lost ack harmless. Returns acks this pump."""
        m = getattr(self.runtime, "metrics", None)
        acked = 0
        for r in list(self.retractions.values()):
            if r.acked:
                continue
            cluster = self.clusters.get(r.cluster)
            if cluster is None:
                # the cluster left the federation: nothing to retract
                self._ack_retraction(r)
                acked += 1
                continue
            if not cluster.client.reachable():
                continue
            try:
                self._call(
                    cluster, "delete_workload", r.key,
                    fault_point="multikueue.lost_retraction",
                )
            except ClusterUnreachable:
                r.attempts += 1
                if m is not None:
                    m.report_retraction("retried")
                continue
            except RemoteRejected:
                r.attempts += 1
                if m is not None:
                    m.report_retraction("retried")
                continue
            self._ack_retraction(r)
            acked += 1
        return acked

    def _ack_retraction(self, r: Retraction) -> None:
        r.acked = True
        self._trace_span(
            "federation.retract", r.key,
            {"cluster": r.cluster, "fence": r.fence},
        )
        self._journal(
            RETRACT_DONE_RECORD,
            {"key": r.key, "cluster": r.cluster, "fence": r.fence},
        )
        m = getattr(self.runtime, "metrics", None)
        if m is not None:
            m.report_retraction("acked")
        self.runtime.events.record(
            "MultiKueueRetracted", r.key,
            f'retracted from cluster "{r.cluster}" (fence {r.fence})',
            regarding_kind="Workload",
        )

    # ---- finish / GC ----
    def _finish_state(self, st: DispatchState) -> None:
        for name in set(st.clusters) | st.mirrored | (
            {st.winner} if st.winner else set()
        ):
            self._enqueue_retraction(st.key, name, st.fence)
        st.finished = True

    def _gc_states(self) -> None:
        """Drop finished states once every retraction they spawned has
        acked — the dedup set must not grow with every workload the
        federation has ever seen."""
        for key in list(self.states):
            st = self.states[key]
            if not st.finished:
                continue
            if self._retractions_for(key, unacked_only=True):
                continue
            del self.states[key]
            for dedup in [
                d for d, r in self.retractions.items() if r.key == key
            ]:
                del self.retractions[dedup]

    def _retractions_for(self, key: str, unacked_only: bool = False):
        return [
            r for r in self.retractions.values()
            if r.key == key and (not unacked_only or not r.acked)
        ]

    # ---- cluster guard (quarantine for persistently failing remotes) ----
    def _strike_cluster(self, name: str, now: float) -> None:
        h = self.health.get(name)
        if h is None:
            return
        h.strikes += 1
        if (
            h.strikes >= self.cluster_quarantine_threshold
            and not h.quarantined(now)
        ):
            h.quarantined_until = now + self.cluster_quarantine_ttl_s
            self.runtime.events.record(
                "MultiKueueClusterQuarantined", f"cluster/{name}",
                f"worker cluster {name} quarantined from new dispatches "
                f"after {h.strikes} deposals (until "
                f"t={h.quarantined_until:.0f}); retractions still flow",
                regarding_kind="Cluster",
            )

    def _sweep_cluster_quarantine(self, now: float) -> None:
        for name, h in self.health.items():
            if h.quarantined_until is not None and now >= h.quarantined_until:
                h.quarantined_until = None
                h.strikes = 0
                self.runtime.events.record(
                    "MultiKueueClusterRecovered", f"cluster/{name}",
                    f"worker cluster {name} re-eligible for dispatch",
                    regarding_kind="Cluster",
                )

    # ---- observability ----
    def _update_gauges(self) -> None:
        m = getattr(self.runtime, "metrics", None)
        if m is None:
            return
        now = self.runtime.clock.now()
        active = sum(
            1
            for name, c in self.clusters.items()
            if c.client.active and not self.health[name].quarantined(now)
        )
        m.multikueue_clusters_active.set(active)
        m.elastic_workers_cordoned.set(
            len(self.cordoned & set(self.clusters))
        )
        for name in self.clusters:
            m.report_worker_health(name, self.worker_health.snapshot(name))
        m.hedge_rate.set(self.worker_health.hedge_rate())

    def health_report(self) -> dict:
        """The /healthz "federation" detail: degraded while any
        configured worker is lost, quarantined, or in latency
        probation (gray — slow but alive)."""
        now = self.runtime.clock.now()
        lost = sorted(
            name for name, c in self.clusters.items() if not c.client.active
        )
        quarantined = sorted(
            name for name, h in self.health.items() if h.quarantined(now)
        )
        cordoned = sorted(self.cordoned & set(self.clusters))
        probation = sorted(
            name for name in self.clusters
            if self.worker_health.state(name) == DEGRADED
        )
        pending_retractions = sum(
            1 for r in self.retractions.values() if not r.acked
        )
        return {
            "clusters": len(self.clusters),
            "active": len(self.clusters) - len(lost),
            "lost": lost,
            "quarantined": quarantined,
            # cordon is an operator intent, not a failure: visible here
            # but never flips "degraded"
            "cordoned": cordoned,
            # latency probation: slow-but-alive workers — no NEW
            # dispatches, still syncing and retracting
            "probation": probation,
            "hedgeRate": round(self.worker_health.hedge_rate(), 4),
            "pendingRetractions": pending_retractions,
            "workloads": len(self.states),
            "degraded": bool(lost or quarantined or probation),
        }

    def cluster_report(self) -> List[dict]:
        """`kueuectl clusters list` / GET federation clusters."""
        now = self.runtime.clock.now()
        out = []
        for name in sorted(self.clusters):
            c = self.clusters[name]
            h = self.health[name]
            snap = self.worker_health.snapshot(name)
            out.append(
                {
                    "name": name,
                    "active": c.client.active,
                    "lostSince": c.client.lost_since,
                    "quarantinedUntil": (
                        h.quarantined_until if h.quarantined(now) else None
                    ),
                    "cordoned": name in self.cordoned,
                    "strikes": h.strikes,
                    "dispatches": h.dispatches,
                    "wins": h.wins,
                    "failedAttempts": c.client.failed_attempts,
                    "health": snap["state"],
                    "rttP95": snap["rttP95"],
                    "rttP99": snap["rttP99"],
                    "errorRate": snap["errorRate"],
                    "rttSamples": snap["samples"],
                }
            )
        return out

    def status(self) -> dict:
        return {
            "health": self.health_report(),
            "clusters": self.cluster_report(),
            "workloads": [
                self.states[k].to_dict() for k in sorted(self.states)
            ],
            "retractions": [
                r.to_dict()
                for _, r in sorted(self.retractions.items())
                if not r.acked
            ],
        }
