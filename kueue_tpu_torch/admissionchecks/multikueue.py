"""MultiKueue — multi-cluster dispatch admission-check controller.

Reference: pkg/controller/admissionchecks/multikueue (≈1.7k LoC):
multikueuecluster.go:76-187 (remote clients + reconnect backoff),
workload.go:159-425 (remote copies, first-reserving wins, status
sync-back, finish propagation, workerLostTimeout, GC).

TPU-native shape: a "remote cluster" is another ClusterRuntime (the
in-process analog of a kubeconfig-built client; in a deployment this
boundary is the gRPC/DCN link between control planes). The controller:

1. creates remote Workload copies on every configured cluster,
2. the first remote to reserve quota wins — copies elsewhere are
   deleted,
3. syncs the job to the winner via a MultiKueueAdapter and flips the
   local check Ready (local job stays suspended under managedBy),
4. copies Finished back to the local workload and GCs remote objects,
5. on cluster loss past worker_lost_timeout, requeues the workload
   (check -> Retry).
"""

from __future__ import annotations

import zlib
from copy import deepcopy
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kueue_tpu_torch.models import Workload
from kueue_tpu_torch.models.constants import (
    MULTIKUEUE_CONTROLLER_NAME,
    AdmissionCheckStateType,
    WorkloadConditionType,
)


@dataclass
class MultiKueueCluster:
    """multikueue_types.go:61-137 — one worker cluster.

    ``runtime`` (an in-process ClusterRuntime) or ``transport`` (any
    RemoteTransport — HTTPTransport for a real remote control plane)
    names the wire; the controller attaches a RemoteClient that owns
    the reconnect/backoff state machine. ``mark_lost``/``mark_connected``
    force the state (tests; the production path flips it from observed
    transport failures/successes)."""

    name: str
    runtime: object = None  # legacy in-process shorthand
    transport: object = None  # RemoteTransport
    client: object = None  # RemoteClient, attached by the controller

    def __post_init__(self):
        if self.transport is None and self.runtime is not None:
            from kueue_tpu_torch.admissionchecks.multikueue_transport import (
                InProcessTransport,
            )

            self.transport = InProcessTransport(self.runtime)
        elif self.runtime is None and self.transport is not None:
            self.runtime = self.transport.runtime

    @property
    def active(self) -> bool:
        return self.client.active if self.client is not None else True

    @property
    def lost_since(self) -> Optional[float]:
        return self.client.lost_since if self.client is not None else None

    def _flaky(self):
        from kueue_tpu_torch.admissionchecks.multikueue_transport import (
            FlakyTransport,
        )

        if not isinstance(self.transport, FlakyTransport):
            self.transport = FlakyTransport(self.transport)
            if self.client is not None:
                self.client.transport = self.transport
        return self.transport

    def mark_lost(self, now: float) -> None:
        """Take the wire down (fault injection) and flip the client's
        state — subsequent calls fail until mark_connected."""
        self._flaky().down = True
        if self.client is not None and self.client.active:
            self.client.active = False
            self.client.lost_since = now
            self.client.failed_attempts = 1
            self.client.next_retry_at = now + self.client.base_backoff_s

    def mark_connected(self) -> None:
        self._flaky().down = False
        if self.client is not None:
            self.client._record_success()

    def call(self, op: str, *args, deadline_s: Optional[float] = None):
        return self.client.call(op, *args, deadline_s=deadline_s)


@dataclass
class MultiKueueConfig:
    name: str
    clusters: Tuple[str, ...] = ()


class MultiKueueAdapter:
    """MultiKueueAdapter SPI (jobframework/interface.go:235-252)."""

    def sync_job(self, local_job, remote_runtime, wl: Workload) -> None:
        """Create/update the job object on the remote cluster."""
        raise NotImplementedError

    def delete_remote_job(self, local_job, remote_runtime) -> None:
        raise NotImplementedError

    def copy_status(self, local_job, remote_runtime) -> None:
        """Copy remote job status back into the local job."""
        raise NotImplementedError


class BatchJobAdapter(MultiKueueAdapter):
    """MultiKueue adapter for batch/Job (jobs/job/job_multikueue_adapter)."""

    def _remote_key(self, local_job):
        return local_job.key

    def sync_job(self, local_job, remote_runtime, wl: Workload) -> None:
        if local_job.key in remote_runtime.jobs:
            return
        remote_job = deepcopy(local_job)
        remote_job.managed_by = None  # remote kueue manages its copy
        remote_job.suspended = True
        remote_job.active_pods = 0
        remote_runtime.add_job(remote_job)

    def delete_remote_job(self, local_job, remote_runtime) -> None:
        remote_runtime.delete_job(local_job.key)

    def copy_status(self, local_job, remote_runtime) -> None:
        remote_job = remote_runtime.jobs.get(local_job.key)
        if remote_job is None:
            return
        local_job.succeeded = remote_job.succeeded
        local_job.failed = remote_job.failed
        local_job.ready_pods = remote_job.ready_pods


class MultiKueueController:
    def __init__(
        self,
        runtime,
        clusters: Optional[Dict[str, MultiKueueCluster]] = None,
        configs: Optional[Dict[str, MultiKueueConfig]] = None,
        adapters: Optional[Dict[str, MultiKueueAdapter]] = None,
        worker_lost_timeout: float = 900.0,  # config multiKueue.workerLostTimeout
        origin: str = "local",
        batch_dispatch: bool = False,
        base_backoff_s: float = 1.0,
        max_backoff_s: float = 300.0,
        gc_interval_s: float = 60.0,  # config multiKueue.gcInterval
        call_deadline_s: float = 10.0,
    ):
        self.runtime = runtime
        self.clusters = {}
        self.configs = configs or {}
        self.adapters = adapters or {"Job": BatchJobAdapter()}
        self.worker_lost_timeout = worker_lost_timeout
        self.origin = origin
        # Batched cross-cluster dispatch: remote creates accumulate per
        # cluster during a reconcile pass and go out in ONE transport
        # exchange per cluster on flush() (the runtime loop calls it
        # after each pass) — amortizing per-request DCN latency the way
        # the drain amortizes device dispatches.
        self.batch_dispatch = batch_dispatch
        self.base_backoff_s = base_backoff_s
        self.max_backoff_s = max_backoff_s
        # explicit per-call transport deadline (deadline-discipline
        # lint): every remote exchange below names its bound instead
        # of riding whatever timeout the transport was built with
        self.call_deadline_s = call_deadline_s
        # cluster -> workload key -> buffered copy (keyed so the dedup
        # check at buffering time and _unbuffer at winner pick are O(1)
        # — at 10k-workload dispatch waves a list scan per pick is
        # O(picks x backlog))
        self._create_buffer: Dict[str, Dict[str, Workload]] = {}
        # pass-boundary detection for the lazy flush backstop
        self._seen_this_pass: set = set()
        self.gc_interval_s = gc_interval_s
        self._last_gc = float("-inf")
        # dispatch telemetry (the perf harness's at-scale scenario
        # asserts the first-reserving race path actually runs and the
        # winner load spreads): workloads observed with >1 cluster
        # reserving at pick time, and winner picks per cluster.
        # winner_counts aggregates (finished workloads stay counted);
        # _winner_by_key only tracks IN-FLIGHT picks so a re-pick after
        # worker loss moves the count instead of double-counting, and is
        # pruned at reap — the telemetry must not grow with every
        # workload the controller has ever seen
        self.first_reserving_races = 0
        self.winner_counts: Dict[str, int] = {}
        self._winner_by_key: Dict[str, str] = {}
        # workload key -> winning cluster name
        self._reserving: Dict[str, str] = {}
        # workload key -> clusters that ever received copies; non-winner
        # members are cleaned up as soon as they are reachable (covers a
        # lost winner reconnecting after the workload moved elsewhere)
        self._dispatched: Dict[str, set] = {}
        for cluster in (clusters or {}).values():
            self.add_cluster(cluster)

    def __call__(self, wl: Workload) -> None:
        """Registered directly on runtime.admission_check_controllers."""
        self.reconcile(wl)

    # ---- wiring ----
    def add_cluster(self, cluster: MultiKueueCluster) -> None:
        if cluster.client is None:
            from kueue_tpu_torch.admissionchecks.multikueue_transport import (
                RemoteClient,
            )

            cluster.client = RemoteClient(
                cluster.transport,
                self.runtime.clock,
                base_backoff_s=self.base_backoff_s,
                max_backoff_s=self.max_backoff_s,
            )
        self.clusters[cluster.name] = cluster

    def add_config(self, cfg: MultiKueueConfig) -> None:
        self.configs[cfg.name] = cfg

    def _relevant_checks(self, wl: Workload) -> List[str]:
        out = []
        for name in wl.admission_check_states:
            ac = self.runtime.cache.admission_checks.get(name)
            if ac is not None and ac.controller_name == MULTIKUEUE_CONTROLLER_NAME:
                out.append(name)
        return out

    def _clusters_for_check(
        self, check_name: str, rotate_for: str = ""
    ) -> List[MultiKueueCluster]:
        ac = self.runtime.cache.admission_checks.get(check_name)
        cfg = self.configs.get(ac.parameters or "") if ac else None
        if cfg is None:
            return []
        out = [self.clusters[c] for c in cfg.clusters if c in self.clusters]
        if rotate_for and len(out) > 1:
            # The reference reads the cluster set out of a Go map, so the
            # scan order — and with it which of several simultaneous
            # reservers "wins first" — is arbitrary per reconcile
            # (multikueue_types.go cluster set; workload.go:381 takes the
            # first found). Rotating by a stable workload-key hash keeps
            # that no-structural-favorite property while staying
            # deterministic for tests: in a symmetric lockstep system a
            # fixed order would funnel every win to cluster[0].
            off = zlib.crc32(rotate_for.encode()) % len(out)
            out = out[off:] + out[:off]
        return out

    def _local_job_for(self, wl: Workload):
        # O(1) via the runtime's workload->job index (the reference
        # resolves this through a field index, reconciler.go ownership)
        return self.runtime.job_for(wl)

    def _remote_copy(self, wl: Workload) -> Workload:
        from kueue_tpu_torch.admissionchecks.multikueue_transport import ORIGIN_LABEL

        return Workload(
            namespace=wl.namespace,
            name=wl.name,
            queue_name=wl.queue_name,
            pod_sets=deepcopy(wl.pod_sets),
            priority=wl.priority,
            priority_class_name=wl.priority_class_name,
            priority_class_source=wl.priority_class_source,
            creation_time=wl.creation_time,
            labels={ORIGIN_LABEL: self.origin},
        )

    def _unbuffer(self, wl_key: str) -> None:
        """Drop pending batched creates for a workload whose dispatch
        intent is gone (deleted/finished/un-reserved locally, or a
        winner was picked) — a stale buffered create must never
        materialize an orphan remote."""
        for batch in self._create_buffer.values():
            batch.pop(wl_key, None)

    # ---- reconcile (workload.go:159-425) ----
    def reconcile(self, wl: Workload) -> None:
        from kueue_tpu_torch.admissionchecks.multikueue_transport import (
            ClusterUnreachable,
            RemoteRejected,
        )

        # lazy flush backstop: reaching the same workload again means a
        # new pass started (covers bound-method registration where the
        # runtime's flush hook can't fire)
        if self.batch_dispatch and wl.key in self._seen_this_pass:
            self.flush()
            self._seen_this_pass.clear()
        self._seen_this_pass.add(wl.key)

        checks = self._relevant_checks(wl)
        if not checks:
            return
        if (
            wl.is_finished
            and wl.key not in self._reserving
            and not self._dispatched.get(wl.key)
        ):
            # fully reaped: no remote copies, no buffered creates with
            # intent recorded — skip the per-cluster GC probing (at 10k
            # finished workloads that's 4 wire calls per workload per
            # pass for nothing)
            return
        now = self.runtime.clock.now()
        check = checks[0]
        state = wl.admission_check_states[check]
        clusters = self._clusters_for_check(check, rotate_for=wl.key)
        job = self._local_job_for(wl)
        adapter = self.adapters.get(job.kind if job is not None else "Job")

        if wl.is_finished:
            self._unbuffer(wl.key)
            self._gc_remotes(wl, clusters, job, adapter)
            return
        if not wl.has_quota_reservation:
            # reservation lost locally: drop remote copies
            self._unbuffer(wl.key)
            self._gc_remotes(wl, clusters, job, adapter)
            self._reserving.pop(wl.key, None)
            return

        self._cleanup_stale_dispatches(wl, job, adapter)

        winner_name = self._reserving.get(wl.key)
        if winner_name is not None:
            cluster = self.clusters.get(winner_name)
            if cluster is not None and cluster.client.reachable():
                # sync doubles as the reconnect probe: success restores
                # the cluster, failure records it and falls to the timer
                self._sync_winner(wl, state, cluster, job, adapter)
                if cluster.active:
                    return
            lost_for = (
                now - cluster.lost_since
                if cluster is not None and cluster.lost_since is not None
                else self.worker_lost_timeout
            )
            if lost_for >= self.worker_lost_timeout:
                # worker lost: requeue locally (workload.go:421-425)
                self._reserving.pop(wl.key, None)
                state.state = AdmissionCheckStateType.RETRY
                state.message = f"Worker cluster {winner_name} lost"
                self.runtime.event("MultiKueueClusterLost", wl, winner_name)
            return

        # no winner yet: ensure remote copies exist, look for a reserver
        reserving = []
        for cluster in clusters:
            if not cluster.client.reachable():
                continue
            try:
                rwl = cluster.call(
                    "get_workload", wl.key, deadline_s=self.call_deadline_s
                )
                if rwl is None:
                    copy = self._remote_copy(wl)
                    if self.batch_dispatch:
                        buf = self._create_buffer.setdefault(cluster.name, {})
                        buf.setdefault(copy.key, copy)
                    else:
                        cluster.call(
                            "create_workload", copy,
                            deadline_s=self.call_deadline_s,
                        )
                self._dispatched.setdefault(wl.key, set()).add(cluster.name)
                if rwl is not None and rwl.has_quota_reservation:
                    reserving.append(cluster)
            except ClusterUnreachable:
                continue
            except RemoteRejected as e:
                # the remote refused this object (its webhook chain):
                # per-workload condition, not a connectivity event
                state.state = AdmissionCheckStateType.PENDING
                state.message = f"Rejected by {cluster.name}: {e}"
                self.runtime.event("MultiKueueRejected", wl, str(e))
                continue
        if not reserving:
            if state.state != AdmissionCheckStateType.PENDING:
                state.state = AdmissionCheckStateType.PENDING
                state.message = (
                    "The workload is pending reservation in the worker clusters"
                )
            return

        winner = reserving[0]  # FirstReserving wins (workload.go:381)
        if len(reserving) > 1:
            self.first_reserving_races += 1
        prev = self._winner_by_key.get(wl.key)
        if prev is not None:  # re-pick: move the count, don't double it
            self.winner_counts[prev] -= 1
        self._winner_by_key[wl.key] = winner.name
        self.winner_counts[winner.name] = (
            self.winner_counts.get(winner.name, 0) + 1
        )
        self._reserving[wl.key] = winner.name
        # a loser whose create is still only BUFFERED (it was
        # unreachable at the last flush) has no remote copy for
        # _delete_on to remove — drop the pending create too, or the
        # end-of-pass flush materializes an untracked duplicate that
        # reserves quota and runs the job alongside the winner
        self._unbuffer(wl.key)
        for cluster in clusters:
            if cluster.name != winner.name:
                self._delete_on(cluster, wl.key, job, adapter)
        self.runtime.event("MultiKueueReserved", wl, winner.name)
        self._sync_winner(wl, state, winner, job, adapter)

    def flush(self) -> None:
        """Send buffered remote creates, one batched exchange per
        cluster (batched cross-cluster dispatch)."""
        from kueue_tpu_torch.admissionchecks.multikueue_transport import (
            ClusterUnreachable,
            RemoteRejected,
        )

        for name, batch in list(self._create_buffer.items()):
            cluster = self.clusters.get(name)
            if cluster is None:
                del self._create_buffer[name]  # cluster removed: drop
                continue
            if not batch or not cluster.client.reachable():
                continue
            try:
                cluster.call(
                    "create_workloads", list(batch.values()),
                    deadline_s=self.call_deadline_s,
                )
                self._create_buffer[name] = {}
            except ClusterUnreachable:
                pass  # retried next pass; dispatch sets keep the intent
            except RemoteRejected:
                # some object in the batch was refused: resolve per-item
                # (rejected items drop; unreachable keeps the remainder)
                remaining = dict(batch)
                for key, w in list(remaining.items()):
                    try:
                        cluster.call(
                            "create_workload", w,
                            deadline_s=self.call_deadline_s,
                        )
                    except RemoteRejected:
                        pass  # refused: dropped (reconcile re-reports)
                    except ClusterUnreachable:
                        break
                    remaining.pop(key)
                self._create_buffer[name] = remaining
        self._seen_this_pass.clear()
        # periodic orphan GC (multiKueue.gcInterval; workload.go GC of
        # remote objects whose local owner is gone)
        now = self.runtime.clock.now()
        if now - self._last_gc >= self.gc_interval_s:
            self._last_gc = now
            self.gc_orphans()

    def gc_orphans(self) -> int:
        """Delete remote workloads labeled with this origin whose local
        owner no longer exists (workload.go orphan GC under churn —
        e.g. the local workload deleted while the worker was lost)."""
        from kueue_tpu_torch.admissionchecks.multikueue_transport import (
            ClusterUnreachable,
        )

        deleted = 0
        for cluster in self.clusters.values():
            if not cluster.client.reachable():
                continue
            try:
                keys = cluster.call(
                    "list_workload_keys", self.origin,
                    deadline_s=self.call_deadline_s,
                )
                for key in keys:
                    if key not in self.runtime.workloads:
                        cluster.call(
                            "delete_workload", key,
                            deadline_s=self.call_deadline_s,
                        )
                        deleted += 1
                        self._dispatched.get(key, set()).discard(cluster.name)
            except ClusterUnreachable:
                continue
        return deleted

    def _sync_winner(self, wl, state, cluster, job, adapter) -> None:
        from kueue_tpu_torch.admissionchecks.multikueue_transport import (
            ClusterUnreachable,
        )

        try:
            rwl = cluster.call(
                "get_workload", wl.key, deadline_s=self.call_deadline_s
            )
        except ClusterUnreachable:
            return  # worker-lost timer runs in reconcile
        if rwl is None:
            # remote copy disappeared: retry from scratch
            self._reserving.pop(wl.key, None)
            state.state = AdmissionCheckStateType.PENDING
            state.message = "Remote workload lost; recreating"
            return
        # job sync needs an in-process remote runtime (adapters operate
        # on job objects; over the HTTP transport only workload dispatch
        # and status sync-back flow — the remote kueue manages its jobs)
        remote = cluster.transport.runtime
        if job is not None and adapter is not None and remote is not None:
            adapter.sync_job(job, remote, wl)
            adapter.copy_status(job, remote)
        if rwl.is_finished:
            fin = rwl.conditions[WorkloadConditionType.FINISHED]
            wl.set_condition(
                WorkloadConditionType.FINISHED, True, fin.reason, fin.message,
                now=self.runtime.clock.now(),
            )
            self.runtime.on_workload_finished(wl)
            self._gc_remotes(
                wl, self._clusters_for_check(state.name), job, adapter
            )
            return
        if state.state != AdmissionCheckStateType.READY:
            state.state = AdmissionCheckStateType.READY
            state.message = f'The workload got reservation on "{cluster.name}"'

    def _delete_on(self, cluster, wl_key: str, job, adapter) -> bool:
        """Remove the remote job + workload copy from one cluster.
        True when the cluster acknowledged (dispatch intent cleared);
        False when unreachable (retried once it reconnects)."""
        from kueue_tpu_torch.admissionchecks.multikueue_transport import (
            ClusterUnreachable,
        )

        if cluster is None or not cluster.client.reachable():
            return False
        try:
            if (
                job is not None
                and adapter is not None
                and cluster.transport.runtime is not None
            ):
                adapter.delete_remote_job(job, cluster.transport.runtime)
            cluster.call(
                "delete_workload", wl_key, deadline_s=self.call_deadline_s
            )
        except ClusterUnreachable:
            return False
        self._dispatched.get(wl_key, set()).discard(cluster.name)
        return True

    def _cleanup_stale_dispatches(self, wl, job, adapter) -> None:
        """Delete copies on any reachable cluster that is not the
        current winner (workload.go:381-421 drop-others + GC of orphan
        remotes after reconnect)."""
        winner = self._reserving.get(wl.key)
        if winner is None:
            return
        for name in list(self._dispatched.get(wl.key, set())):
            if name != winner:
                self._delete_on(self.clusters.get(name), wl.key, job, adapter)

    def _gc_remotes(self, wl, clusters, job, adapter) -> None:
        for cluster in clusters:
            self._delete_on(cluster, wl.key, job, adapter)
        self._reserving.pop(wl.key, None)
        self._winner_by_key.pop(wl.key, None)
        if not self._dispatched.get(wl.key):
            self._dispatched.pop(wl.key, None)
