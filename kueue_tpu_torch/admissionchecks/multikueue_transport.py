"""MultiKueue remote transports + reconnect state machine.

Reference: pkg/controller/admissionchecks/multikueue/multikueuecluster.go
:76-187 — each worker cluster is reached through a remoteClient built
from a kubeconfig; operations flow through it, a failure flips the
cluster to an inactive state, and reconnects retry with exponential
backoff (:67-73). Here the wire is a ``RemoteTransport``:

- ``InProcessTransport``: another ClusterRuntime in this process (unit
  scale, and the MultiKueue tests' fast path);
- ``HTTPTransport``: a remote server over HTTP/JSON; its wire client
  comes with the serving plane, so the port's raises at construction;
- ``FlakyTransport``: fault-injection wrapper driving the reconnect
  machinery in tests.

``RemoteClient`` owns the per-cluster connectivity state machine:
every transport call goes through it; errors mark the cluster lost and
gate retries behind ``b * 2^(n-1)`` backoff (capped), and the first
successful call restores it.
"""

from __future__ import annotations

import random
import threading
from copy import deepcopy
from typing import Dict, List, Optional

from kueue_tpu_torch.models import Workload
from kueue_tpu_torch.testing import faults

ORIGIN_LABEL = "kueue.x-k8s.io/multikueue-origin"


class TransportError(Exception):
    """The remote control plane could not be reached / answered 5xx."""


class RemoteRejected(Exception):
    """The remote control plane REFUSED the request (4xx — e.g. the
    remote webhook chain rejected the object). Not a connectivity
    problem: the cluster stays active; the caller handles it
    per-workload."""


class ClusterUnreachable(Exception):
    """Raised by RemoteClient while the cluster is lost (callers treat
    the cluster as inactive for this pass)."""


class RemoteTransport:
    """Operations MultiKueue needs from a worker cluster."""

    #: in-process runtime when the transport wraps one (job adapters
    #: need it; None over the wire)
    runtime = None

    #: per-call deadline threaded by RemoteClient.call immediately
    #: before each exchange (None = the transport's constructor
    #: default). An attribute rather than a parameter so the five
    #: operation signatures stay wire-shaped; the dispatcher is
    #: single-threaded per cluster, and chaos wrappers forward it
    #: inward so the innermost HTTP hop still honors it.
    deadline_s = None

    def get_workload(self, key: str) -> Optional[Workload]:
        raise NotImplementedError

    def create_workload(self, wl: Workload) -> None:
        raise NotImplementedError

    def create_workloads(self, wls: List[Workload]) -> None:
        """Batched dispatch: one wire exchange for many creates."""
        for wl in wls:
            self.create_workload(wl)

    def delete_workload(self, key: str) -> None:
        raise NotImplementedError

    def list_workload_keys(self, origin: str) -> List[str]:
        """Keys of remote workloads labeled with this origin."""
        raise NotImplementedError


class InProcessTransport(RemoteTransport):
    def __init__(self, runtime):
        self.runtime = runtime

    def get_workload(self, key: str) -> Optional[Workload]:
        return self.runtime.workloads.get(key)

    def create_workload(self, wl: Workload) -> None:
        if wl.key not in self.runtime.workloads:
            self.runtime.add_workload(wl)

    def delete_workload(self, key: str) -> None:
        rwl = self.runtime.workloads.get(key)
        if rwl is not None:
            self.runtime.delete_workload(rwl)

    def list_workload_keys(self, origin: str) -> List[str]:
        return [
            key
            for key, wl in self.runtime.workloads.items()
            if wl.labels.get(ORIGIN_LABEL) == origin
        ]


class HTTPTransport(RemoteTransport):
    """A worker cluster served over HTTP by the serving plane's server.

    The port has no ``server`` package (and so no ``server.client``
    wire client) yet: constructing one raises. In-process workers go
    through ``InProcessTransport``.
    """

    def __init__(
        self,
        base_url: str,
        timeout: float = 10.0,
        token=None,
        ca_cert=None,
        insecure: bool = False,
    ):
        raise NotImplementedError(
            "HTTPTransport: the wire client (server/client) is not ported "
            "yet (ROADMAP A9); use InProcessTransport"
        )


class FlakyTransport(RemoteTransport):
    """Fault injection: ``down=True`` fails every call."""

    def __init__(self, inner: RemoteTransport):
        self.inner = inner
        self.down = False
        self.calls = 0
        self.failures = 0

    @property
    def runtime(self):  # type: ignore[override]
        return self.inner.runtime

    @property
    def deadline_s(self):  # type: ignore[override]
        return getattr(self.inner, "deadline_s", None)

    @deadline_s.setter
    def deadline_s(self, value):
        self.inner.deadline_s = value

    def _fwd(self, name, *args):
        self.calls += 1
        if self.down:
            self.failures += 1
            raise TransportError("injected fault")
        return getattr(self.inner, name)(*args)

    def get_workload(self, key):
        return self._fwd("get_workload", key)

    def create_workload(self, wl):
        return self._fwd("create_workload", wl)

    def create_workloads(self, wls):
        return self._fwd("create_workloads", wls)

    def delete_workload(self, key):
        return self._fwd("delete_workload", key)

    def list_workload_keys(self, origin):
        return self._fwd("list_workload_keys", origin)


class RemoteClient:
    """Per-cluster connectivity state machine
    (multikueuecluster.go:76-187).

    Every transport call flows through ``call``: while lost, calls are
    refused until the backoff window elapses; the next attempt is the
    reconnect probe — success restores the cluster, failure doubles
    the wait (b * 2^(n-1), capped). The backoff carries multiplicative
    ``jitter``: after a shared partition heals, N clusters whose
    clients failed in lockstep must NOT retry in lockstep (a
    synchronized reconnect storm against the recovering control
    plane), so each window is stretched by an independent factor in
    [1, 1+jitter). While lost, at most ``max_inflight_probes``
    concurrent calls may act as the reconnect probe — every other
    caller is refused immediately, capping the in-flight retries a
    slow half-open remote can accumulate.

    Gray-failure extensions: ``call`` accepts a per-exchange
    ``deadline_s`` (threaded onto the transport for the duration of
    the exchange) and an optional ``hedge_delay_s`` for idempotent
    operations — the primary attempt is bounded by the hedge delay,
    and when it misses, ONE backup attempt fires with the full
    deadline ('first success wins' collapsed to its synchronous
    equivalent: the primary that missed its hedge delay has already
    lost). A primary that merely missed the hedge delay is NOT
    charged to the connectivity machine; only the backup's verdict
    counts. ``last_hedge`` exposes the outcome of the most recent
    call (None / 'won' / 'lost') for the dispatcher's budget and
    metrics accounting."""

    def __init__(
        self,
        transport: RemoteTransport,
        clock,
        base_backoff_s: float = 1.0,
        max_backoff_s: float = 300.0,
        jitter: float = 0.1,
        max_inflight_probes: int = 1,
        rng: Optional[random.Random] = None,
    ):
        self.transport = transport
        self.clock = clock
        self.base_backoff_s = base_backoff_s
        self.max_backoff_s = max_backoff_s
        self.jitter = jitter
        self.max_inflight_probes = max_inflight_probes
        self._rng = rng if rng is not None else random.Random()
        self.active = True
        self.lost_since: Optional[float] = None
        self.failed_attempts = 0
        self.next_retry_at = 0.0
        self._mu = threading.Lock()
        self._inflight_probes = 0
        #: outcome of the most recent call's hedge: None (no hedge
        #: fired), "won" (backup succeeded / was answered) or "lost"
        #: (backup failed too)
        self.last_hedge: Optional[str] = None

    def _record_failure(self) -> None:
        now = self.clock.now()
        if self.active:
            self.active = False
            self.lost_since = now
        self.failed_attempts += 1
        delay = min(
            self.max_backoff_s,
            self.base_backoff_s * (2 ** (self.failed_attempts - 1)),
        )
        if self.jitter:
            delay *= 1.0 + self.jitter * self._rng.random()
        self.next_retry_at = now + delay

    def _record_success(self) -> None:
        self.active = True
        self.lost_since = None
        self.failed_attempts = 0
        self.next_retry_at = 0.0

    def reachable(self) -> bool:
        """Active, or lost with the backoff window elapsed (a call now
        would be the reconnect probe)."""
        return self.active or self.clock.now() >= self.next_retry_at

    def _invoke(self, op: str, args, deadline_s: Optional[float]):
        """One exchange under one deadline (restored on every path)."""
        prev = self.transport.deadline_s
        self.transport.deadline_s = deadline_s
        try:
            return getattr(self.transport, op)(*args)
        finally:
            self.transport.deadline_s = prev

    def call(
        self,
        op: str,
        *args,
        deadline_s: Optional[float] = None,
        hedge_delay_s: Optional[float] = None,
    ):
        self.last_hedge = None
        probing = False
        with self._mu:
            if not self.active:
                if self.clock.now() < self.next_retry_at:
                    raise ClusterUnreachable(
                        f"backoff until t={self.next_retry_at:.1f}"
                    )
                if self._inflight_probes >= self.max_inflight_probes:
                    # another caller already holds the reconnect probe:
                    # refuse instead of stacking retries on a remote
                    # that may be answering slowly
                    raise ClusterUnreachable(
                        "reconnect probe already in flight"
                    )
                self._inflight_probes += 1
                probing = True
        try:
            try:
                first = (
                    hedge_delay_s
                    if hedge_delay_s is not None
                    else deadline_s
                )
                result = self._invoke(op, args, first)
            except TransportError:
                if hedge_delay_s is None:
                    raise
                # primary missed the hedge delay — not charged to the
                # connectivity machine; the backup gets the full
                # deadline and its verdict is the call's verdict
                self.last_hedge = "fired"
                faults.fire("multikueue.hedge")
                result = self._invoke(op, args, deadline_s)
                self.last_hedge = "won"
        except TransportError as e:
            if self.last_hedge == "fired":
                self.last_hedge = "lost"
            self._record_failure()
            raise ClusterUnreachable(str(e))
        except RemoteRejected:
            # the wire works; the request was refused — connectivity
            # state recovers, the rejection propagates per-workload
            if self.last_hedge == "fired":
                self.last_hedge = "won"
            self._record_success()
            raise
        finally:
            if probing:
                with self._mu:
                    self._inflight_probes -= 1
        self._record_success()
        return result
