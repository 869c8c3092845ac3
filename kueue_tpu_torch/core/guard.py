"""Resilient solver executor — the self-healing admission hot path.

The journal makes admission STATE crash-consistent; this module makes the
per-cycle hot path itself degrade instead of die. Production schedulers
for accelerator fleets treat scheduler availability as more important
than any single decision (Gavel; topology-aware preemptive scheduling
for co-located LLM workloads), so every failure mode of the batched
device path has a containment story here:

- ``CircuitBreaker``: N consecutive device failures (raise, or a
  dispatch past the wall-clock deadline) flip the solver from the
  device kernel to the HOST MIRROR — the same numpy recurrences
  (ops/quota_np via planner.solve_scenario_host) over the same encoded
  batch, bit-for-bit equal by construction — with half-open re-probe
  after a ``b * 2^(n-1)`` backoff (the multikueue_transport reconnect
  discipline). Clock-injected throughout, so tests drive it with a
  FakeClock.

- Sampled differential verification: every K-th device solve is
  re-solved on the host mirror and compared bit-for-bit; a mismatch
  QUARANTINES the device path (sticky — a diverging kernel cannot be
  trusted again without operator action), emits a ``SolverDiverged``
  event, journals the verdict, and the host result becomes the cycle's
  authority.

- ``QuarantineList``: a head whose presence makes scheduling raise
  repeatedly (attributed per-head by the contained nomination loop, or
  bisected by ``bisect_poison`` when only a batch-level probe exists)
  is sidelined with a ``WorkloadQuarantined`` condition/event and the
  canonical ``InadmissibleReason``, durably recorded via the
  journal, and re-admitted to nomination after a TTL or ``kueuectl
  quarantine clear``.

Fault points (testing/faults.py registry): ``solver.device_raise``,
``solver.device_hang``, ``solver.device_wrong_answer``,
``cycle.phase_deadline`` drive the chaos suite in tests/test_guard.py.

In the port, a ``KernelError`` (one of its hand-written kernels could
not be built, refused its input or failed to launch) is never contained:
failing over would move the cycle's work to the host while the card
sits idle, so it propagates out of ``device_call`` and the Scheduler.
The runtime's drain rounds (``device_launch``/``device_join``) contain
only the injected device faults of ``testing/faults``: anything else
their launch or fetch raises (a ``KernelError``, a failed CUDA call, an
out-of-memory, a torch op's error in lowering or upload) leaves the
guard and the drain loop. A round that answers past its deadline is
counted against the breaker as in the reference, but its answer is
kept, and a sampled round that differs from the numpy mirror raises
``KernelError`` naming the fields: no drain round is handed to the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from kueue_tpu_torch.ops._build import KernelError
from kueue_tpu_torch.utils.clock import Clock


# ---- host mirror of the cycle batch solve ----

def solve_lowered_host(snapshot, lowered):
    """Pure-numpy solve of an already-lowered cycle heads batch — the
    HOST AUTHORITY twin of core/solver.dispatch_lowered.

    Routes through the shared snapshot codec (core/encode.py) and the
    planner's ``solve_scenario_host`` mirror (identical int64
    recurrences as ops/assign_kernel over identical arrays), so the
    device path is differentially verifiable bit-for-bit: identical
    ``chosen``/``admitted``/``borrows``/``reserved`` per head. The
    ``order`` permutation may legally differ on padded rows (both sorts
    are stable over the same keys, but pad rows tie), so comparisons
    key on the decision fields.
    """
    from kueue_tpu_torch.core.encode import encode_snapshot
    from kueue_tpu_torch.core.solver import _bucket, pack_heads
    from kueue_tpu_torch.ops.assign_kernel import SolveResult, build_paths, build_roots
    from kueue_tpu_torch.planner.engine import solve_scenario_host

    enc = encode_snapshot(snapshot)
    roots = build_roots(enc.parent)
    paths = build_paths(enc.parent, enc.max_depth)
    w = len(lowered.heads)
    w_pad = _bucket(w)
    batch_np, _seg_id, _n_segments, _n_steps = pack_heads(lowered, roots, w_pad)
    out = solve_scenario_host(
        enc.parent,
        enc.level_mask,
        enc.nominal.astype(np.int64, copy=False),
        enc.lending_limit.astype(np.int64, copy=False),
        enc.borrowing_limit.astype(np.int64, copy=False),
        enc.local_usage.astype(np.int64, copy=False),
        batch_np,
        paths,
        enc.max_depth,
    )
    return SolveResult(
        chosen=out["chosen"].astype(np.int32),
        admitted=out["admitted"].astype(bool),
        borrows=out["borrows"].astype(bool),
        reserved=out["reserved"].astype(bool),
        usage=None,
        order=out["order"].astype(np.int32),
    )


def results_match(a, b) -> List[str]:
    """Bit-for-bit decision comparison of two SolveResults. Returns the
    names of mismatching fields (empty = identical decisions)."""
    bad: List[str] = []
    for name in ("chosen", "admitted", "borrows", "reserved"):
        if not np.array_equal(
            np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        ):
            bad.append(name)
    return bad


# ---- poison bisection ----
def bisect_poison(items: Sequence, probe: Callable[[Sequence], None]) -> list:
    """Find the items whose presence makes ``probe`` raise.

    ``probe(subset)`` must be side-effect-free (nomination against a
    throwaway snapshot). Recursively halves failing subsets; singleton
    failures are poison. An irreducible failing group none of whose
    halves fails alone (a pure interaction) is returned whole — the
    guard must make progress even then. Items are probed O(log n) times
    each, never more."""
    items = list(items)
    if not items:
        return []

    def failing(subset) -> bool:
        try:
            probe(subset)
            return False
        except Exception:  # noqa: BLE001 — the probe's raise IS the signal
            return True

    def recurse(subset: list) -> list:
        if not failing(subset):
            return []
        if len(subset) == 1:
            return list(subset)
        mid = len(subset) // 2
        left, right = subset[:mid], subset[mid:]
        found = recurse(left) + recurse(right)
        if found:
            return found
        return list(subset)  # interaction: neither half fails alone

    return recurse(items)


# ---- quarantine ----
@dataclass
class QuarantineEntry:
    key: str
    message: str
    since: float
    until: float  # TTL release time (clock domain of the owning runtime)
    strikes: int = 0

    def to_dict(self) -> dict:
        return {
            "key": self.key,
            "message": self.message,
            "since": self.since,
            "until": self.until,
            "strikes": self.strikes,
        }


class QuarantineList:
    """Sidelined poison workloads + per-workload strike accounting.

    Strikes accumulate on contained scheduling failures; at
    ``threshold`` the workload is quarantined for ``ttl_s`` seconds
    (clock-injected — the owner passes ``now``). ``active`` answers the
    scheduler's per-head gate; ``expired`` feeds the runtime's TTL
    sweep; ``release`` serves both the sweep and ``kueuectl quarantine
    clear``.
    """

    def __init__(self, threshold: int = 3, ttl_s: float = 300.0):
        self.threshold = threshold
        self.ttl_s = ttl_s
        self._entries: Dict[str, QuarantineEntry] = {}
        self._strikes: Dict[str, int] = {}

    def strike(self, key: str) -> int:
        n = self._strikes.get(key, 0) + 1
        self._strikes[key] = n
        return n

    def strikes(self, key: str) -> int:
        return self._strikes.get(key, 0)

    def add(self, key: str, message: str, now: float) -> QuarantineEntry:
        entry = QuarantineEntry(
            key=key,
            message=message,
            since=now,
            until=now + self.ttl_s,
            strikes=self._strikes.get(key, 0),
        )
        self._entries[key] = entry
        return entry

    def restore(
        self,
        key: str,
        message: str = "",
        since: float = 0.0,
        until: float = 0.0,
        strikes: int = 0,
    ) -> None:
        """Recovery/replay path: re-instate a journaled entry verbatim."""
        self._entries[key] = QuarantineEntry(key, message, since, until, strikes)
        if strikes:
            self._strikes[key] = strikes

    def active(self, key: str, now: float) -> bool:
        entry = self._entries.get(key)
        return entry is not None and now < entry.until

    def get(self, key: str) -> Optional[QuarantineEntry]:
        return self._entries.get(key)

    def expired(self, now: float) -> List[QuarantineEntry]:
        return [e for e in self._entries.values() if now >= e.until]

    def release(self, key: str) -> Optional[QuarantineEntry]:
        self._strikes.pop(key, None)
        return self._entries.pop(key, None)

    def forget(self, key: str) -> None:
        """Object deleted: drop its quarantine state and strikes."""
        self._entries.pop(key, None)
        self._strikes.pop(key, None)

    def items(self) -> List[QuarantineEntry]:
        return sorted(self._entries.values(), key=lambda e: e.key)

    def __len__(self) -> int:
        return len(self._entries)


# ---- device-path circuit breaker ----
class CircuitBreaker:
    """Closed → (N consecutive failures) → open → (backoff elapses) →
    half-open probe → closed on success / open with doubled backoff on
    failure. ``b * 2^(n-1)`` capped, the multikueue_transport reconnect
    discipline. A DIVERGENCE quarantine is sticky: a kernel that
    answered wrong cannot be re-probed back — only ``reset()``
    (operator action / process restart) clears it."""

    def __init__(
        self,
        clock: Clock,
        failure_threshold: int = 3,
        base_backoff_s: float = 1.0,
        max_backoff_s: float = 300.0,
    ):
        self.clock = clock
        self.failure_threshold = failure_threshold
        self.base_backoff_s = base_backoff_s
        self.max_backoff_s = max_backoff_s
        self.consecutive_failures = 0
        self.open_count = 0  # times the circuit opened (backoff exponent)
        self.next_probe_at = 0.0
        self._open = False
        self.quarantined = False
        self.last_failure = ""

    @property
    def state(self) -> str:
        if self.quarantined:
            return "quarantined"
        if not self._open:
            return "closed"
        if self.clock.now() >= self.next_probe_at:
            return "half_open"
        return "open"

    def allow_device(self) -> bool:
        """May the next solve try the device? Closed always; open only
        once the backoff elapsed (that attempt IS the half-open probe);
        quarantined never."""
        if self.quarantined:
            return False
        if not self._open:
            return True
        return self.clock.now() >= self.next_probe_at

    def record_failure(self, reason: str) -> bool:
        """Returns True when this failure OPENED (or re-opened) the
        circuit — the operator-visible transition."""
        self.consecutive_failures += 1
        self.last_failure = reason
        opened = False
        if self._open or self.consecutive_failures >= self.failure_threshold:
            # already open (a failed half-open probe) or threshold hit
            opened = not self._open
            self._open = True
            self.open_count += 1
            delay = min(
                self.max_backoff_s,
                self.base_backoff_s * (2 ** (self.open_count - 1)),
            )
            self.next_probe_at = self.clock.now() + delay
        return opened

    def record_success(self) -> bool:
        """Returns True when this success CLOSED an open circuit."""
        recovered = self._open
        self._open = False
        self.consecutive_failures = 0
        self.open_count = 0
        self.next_probe_at = 0.0
        return recovered

    def quarantine(self, reason: str) -> None:
        self.quarantined = True
        self._open = True
        self.last_failure = reason

    def reset(self) -> None:
        self.quarantined = False
        self.record_success()


@dataclass
class GuardConfig:
    """Knobs of the resilient executor (server: --solver-path et al.).

    ``mode``: "auto" (device with breaker + failover), "host" (force the
    numpy mirror — operator runbook escape hatch), "device" (never fail
    over; faults propagate — the debugging mode).
    ``device_deadline_s``: wall-clock budget for ONE device dispatch,
    measured on the injected clock (FakeClock-disciplined); a late
    launch counts as a failure and its result is discarded.
    ``cycle_deadline_s``: whole-cycle budget checked at phase
    boundaries (cycle.phase_deadline); breaches with the device in play
    count against the breaker.
    ``divergence_check_every``: K — every K-th device solve re-solves
    on the host mirror and compares bit-for-bit (0 disables).
    """

    mode: str = "auto"
    device_deadline_s: float = 30.0
    cycle_deadline_s: float = 60.0
    failure_threshold: int = 3
    base_backoff_s: float = 1.0
    max_backoff_s: float = 300.0
    divergence_check_every: int = 16
    poison_threshold: int = 3
    quarantine_ttl_s: float = 300.0


@dataclass
class DeviceLaunch:
    """One guarded ASYNC device dispatch (the pipelined drain's
    prefetch window): the unfetched handle plus the deadline clock's
    start. ``failed=True`` means an injected device fault was contained
    at the launch — the matching join returns an empty GuardOutcome.
    ``deadline_s`` overrides the config deadline for THIS launch (the
    megaloop legitimately runs K rounds of device work in one
    dispatch, so its budget scales with K — the deadline still covers
    the whole launch→fetch window)."""

    handle: object = None
    t0: float = 0.0
    t0_wall: float = 0.0
    label: str = ""
    failed: bool = False
    deadline_s: Optional[float] = None


class RoundsTuner:
    """Online rounds-per-launch (K) search for the megaloop — the
    PanelTuner's sibling: per-workload-mix coordinate descent
    (arXiv:2406.20037) reduced to the one live coordinate, the fused
    round count.

    The trade: a bigger K amortizes the fixed dispatch round trip over
    more drain rounds, but every round past a conflict-check mismatch
    (host interference, stuck queues, structural fallback re-entering
    the backlog) is wasted device work — the host truncates the batch
    there and re-solves from the real state. So per backlog-size
    bucket the tuner walks the K ladder: a launch whose batch
    truncated early shrinks K; ``grow_after`` consecutive launches
    that committed every round and STILL had work left grow it. State
    only ever changes how many rounds one launch fuses — the per-round
    conflict-check contract makes every K equally correct."""

    LADDER = (2, 4, 8, 16, 32, 64)

    def __init__(self, default_k: int = 8, grow_after: int = 2):
        self.default_k = default_k
        self.grow_after = grow_after
        self._k: Dict[int, int] = {}  # backlog bucket -> current K
        self._clean: Dict[int, int] = {}  # consecutive exhausted-clean
        self.launches = 0
        self.truncations = 0

    @staticmethod
    def _bucket(backlog: int) -> int:
        b = 256
        while b < backlog:
            b *= 4
        return b

    def k_for(self, backlog: int) -> int:
        """The fused round count for a launch over ``backlog`` heads."""
        return self._k.get(self._bucket(backlog), self.default_k)

    def observe(self, backlog: int, committed: int, truncated: bool) -> None:
        """One finished launch: ``committed`` rounds shipped, and
        ``truncated`` when a conflict-check mismatch cut the batch
        before the device's log ran out."""
        self.launches += 1
        b = self._bucket(backlog)
        k = self._k.get(b, self.default_k)
        if truncated:
            self.truncations += 1
            self._clean[b] = 0
            # shrink: don't compute rounds the host will discard; keep
            # at least the smallest rung (K=1 would be the pipeline)
            down = [w for w in self.LADDER if w < k]
            self._k[b] = max(down) if down else self.LADDER[0]
        elif committed >= k:
            # the whole batch shipped and work remained: a taller
            # launch would have amortized more
            n = self._clean.get(b, 0) + 1
            self._clean[b] = n
            up = [w for w in self.LADDER if w > k]
            if n >= self.grow_after and up:
                self._k[b] = min(up)
                self._clean[b] = 0
        else:
            self._clean[b] = 0

    def to_dict(self) -> dict:
        return {
            "launches": self.launches,
            "truncations": self.truncations,
            "k": {str(b): k for b, k in sorted(self._k.items())},
        }


@dataclass
class GuardOutcome:
    """One guarded batch solve: the result (None = both paths failed —
    callers fall back to per-head host assignment), which path produced
    it, and the device wall time when a real dispatch ran (feeds the
    scheduler's latency gate)."""

    result: object = None
    via: str = "device"  # "device" | "host-mirror"
    device_dt: Optional[float] = None


class SolverGuard:
    """Owns the breaker, the divergence sampler and the failure
    bookkeeping for BOTH guarded device surfaces: the interactive cycle
    batch (``solve``) and the runtime's bulk drain (``device_launch``/
    ``device_join``/``allow_device``). Hooks (events / metrics / journal) are wired by
    ClusterRuntime; a bare Scheduler gets a hookless guard that still
    contains failures."""

    def __init__(
        self,
        clock: Optional[Clock] = None,
        config: Optional[GuardConfig] = None,
        record_event: Optional[Callable[[str, str], None]] = None,
        metrics=None,
        journal_hook: Optional[Callable[[str, dict], None]] = None,
    ):
        self.clock = clock or Clock()
        self.config = config or GuardConfig()
        self.breaker = CircuitBreaker(
            self.clock,
            failure_threshold=self.config.failure_threshold,
            base_backoff_s=self.config.base_backoff_s,
            max_backoff_s=self.config.max_backoff_s,
        )
        # hooks: record_event(reason, message) lands on the runtime's
        # control-plane event stream; journal_hook(rtype, data) appends
        # a durable record (the journal)
        self.record_event = record_event or (lambda reason, msg: None)
        self.metrics = metrics
        self.journal_hook = journal_hook or (lambda rtype, data: None)
        # tracing hook (kueue_tpu_torch/tracing): failovers and divergence
        # checks land as spans on the in-flight cycle's span tree.
        # None until the owning Scheduler/ClusterRuntime wires it.
        self.tracer = None
        # counters (mirrored into kueue_solver_* when metrics attached)
        self.device_solves = 0
        self.failovers = 0
        self.divergence_checks = 0
        self.divergences = 0
        self.contained_cycles = 0
        self.deadline_breaches = 0
        self.last_divergence: Optional[dict] = None
        # wall time spent inside sampled divergence checks (the mirror
        # re-solve + compare) — bench.py --failover reports it as a
        # fraction of cycle time against the <=10% budget
        self.divergence_check_s = 0.0
        # per-cycle deadline tracking (begin_cycle/phase_checkpoint)
        self._cycle_t0: Optional[float] = None
        self._cycle_breached = False
        self._mirror_of = solve_lowered_host
        # online rounds-per-launch (K) tuner for the fused megaloop —
        # owned here so its verdicts ride the same health/dump surface
        # as the rest of the solver's self-tuning state
        self.rounds_tuner = RoundsTuner()
        self._report_path()

    # ---- path selection ----
    @property
    def path(self) -> str:
        """Which path the NEXT solve will take ("device" | "host")."""
        if self.config.mode == "host":
            return "host"
        if self.config.mode == "device":
            return "device"
        return "device" if self.breaker.allow_device() else "host"

    def allow_device(self) -> bool:
        """Gate for device-only surfaces with a host twin elsewhere
        (the bulk drain: its host fallback is the cycle loop)."""
        if self.config.mode == "host":
            return False
        if self.config.mode == "device":
            return True
        return self.breaker.allow_device()

    # ---- failure/success bookkeeping shared by both surfaces ----
    def _note_failure(self, reason: str, label: str) -> None:
        self.failovers += 1
        if self.metrics is not None:
            self.metrics.solver_failovers_total.inc(reason=label)
        if self.tracer is not None:
            self.tracer.add_cycle_span(
                "cycle.guard_failover", attrs={"cause": label}
            )
        opened = self.breaker.record_failure(reason)
        if opened:
            self.record_event(
                "SolverFailover",
                f"device solver circuit OPEN after "
                f"{self.breaker.consecutive_failures} consecutive "
                f"failure(s) ({reason}); admission continues on the "
                f"host mirror, re-probe at "
                f"t={self.breaker.next_probe_at:.1f}",
            )
        self._report_path()

    def _note_success(self) -> None:
        if self.breaker.record_success():
            self.record_event(
                "SolverRecovered",
                "device solver re-probe succeeded; circuit CLOSED, "
                "device path restored",
            )
        self._report_path()

    def _report_path(self) -> None:
        if self.metrics is None:
            return
        path = self.path
        self.metrics.solver_path.set(1 if path == "device" else 0, path="device")
        self.metrics.solver_path.set(1 if path == "host" else 0, path="host")

    # ---- the guarded device call (shared: cycle dispatch, bulk drain) ----
    def device_call(self, fn: Callable[[], object], label: str) -> GuardOutcome:
        """Run one device launch under exception containment + the
        wall-clock deadline. Returns GuardOutcome with ``result=None``
        on failure (the caller's host fallback takes over); the fault
        points ``solver.device_raise`` / ``solver.device_hang`` fire
        inside the guarded window."""
        from kueue_tpu_torch.testing import faults

        if self.config.mode == "device":
            # debugging mode: no containment, faults still fire
            faults.fire("solver.device_raise")
            out = fn()
            faults.fire("solver.device_hang")
            return GuardOutcome(result=out, via="device", device_dt=None)
        t0 = self.clock.now()
        import time as _time

        t0_wall = _time.perf_counter()
        try:
            faults.fire("solver.device_raise")
            out = fn()
            faults.fire("solver.device_hang")
        except faults.InjectedCrash:
            raise  # simulated power loss must never be contained
        except KernelError:
            # the port's own kernel could not be built, refused its
            # input or failed to launch: a fault of the port or of the
            # card's toolchain, never a reason to solve on the host
            # while the card sits idle
            raise
        except Exception as exc:  # noqa: BLE001 — the containment IS the point
            self._note_failure(f"{label} raised: {exc!r}", "raise")
            return GuardOutcome(result=None, via="device", device_dt=None)
        dt_clock = self.clock.now() - t0
        dt_wall = _time.perf_counter() - t0_wall
        if dt_clock > self.config.device_deadline_s:
            # a launch past the deadline is a failure even though it
            # eventually answered: discard the result (the caller falls
            # back) so a wedged tunnel can't stall every cycle behind it
            self._note_failure(
                f"{label} exceeded device deadline "
                f"({dt_clock:.3f}s > {self.config.device_deadline_s}s)",
                "deadline",
            )
            return GuardOutcome(result=None, via="device", device_dt=None)
        self.device_solves += 1
        self._note_success()
        return GuardOutcome(result=out, via="device", device_dt=dt_wall)

    # ---- the guarded ASYNC device call (pipelined drain prefetch) ----
    def device_launch(
        self,
        fn: Callable[[], object],
        label: str,
        deadline_s: Optional[float] = None,
    ):
        """Async half of ``device_call``: run the dispatch (which
        returns an unfetched handle — the launch enqueues on the card
        and returns) and START the deadline clock. The matching
        ``device_join`` applies the deadline to the WHOLE launch→fetch
        window, so a prefetched solve lives under exactly the
        wall-clock budget a synchronous one does. ``deadline_s``
        overrides the config budget for this launch — the megaloop's
        fused K-round dispatch scales it by K while the window still
        covers the entire launch. Only the injected fault
        ``solver.device_raise`` is contained (``failed=True``); what the
        dispatch itself raises leaves the guard."""
        import time as _time

        t0 = self.clock.now()
        t0_wall = _time.perf_counter()
        if not self._injected("solver.device_raise", label):
            return DeviceLaunch(failed=True, label=label)
        return DeviceLaunch(
            handle=fn(), t0=t0, t0_wall=t0_wall, label=label,
            deadline_s=deadline_s,
        )

    def device_join(
        self, launch: "DeviceLaunch", fetch_fn: Callable[[object], object]
    ) -> GuardOutcome:
        """Blocking half: fetch the launched result. What the fetch
        raises leaves the guard; the injected fault
        ``solver.device_hang`` is contained as in ``device_call``. A
        fetch past the deadline counts against the breaker as in
        ``device_call``, but the round keeps the card's answer: it is
        late, not wrong, and dropping it would hand the round to the
        host."""
        import time as _time

        if launch.failed:
            return GuardOutcome(result=None, via="device")
        out = fetch_fn(launch.handle)
        if not self._injected("solver.device_hang", launch.label):
            return GuardOutcome(result=None, via="device")
        if self.config.mode == "device":
            return GuardOutcome(result=out, via="device", device_dt=None)
        dt_clock = self.clock.now() - launch.t0
        dt_wall = _time.perf_counter() - launch.t0_wall
        deadline = (
            launch.deadline_s
            if launch.deadline_s is not None
            else self.config.device_deadline_s
        )
        if dt_clock > deadline:
            self._note_failure(
                f"{launch.label} exceeded device deadline "
                f"({dt_clock:.3f}s > {deadline}s)",
                "deadline",
            )
            return GuardOutcome(result=out, via="device", device_dt=dt_wall)
        self.device_solves += 1
        self._note_success()
        return GuardOutcome(result=out, via="device", device_dt=dt_wall)

    def _injected(self, point: str, label: str) -> bool:
        """Fire the injected device fault ``point`` inside a drain
        round's guarded window. False when it raised and was contained
        (a strike on the breaker); in debugging mode it propagates."""
        from kueue_tpu_torch.testing import faults

        try:
            faults.fire(point)
        except faults.InjectedCrash:
            raise  # simulated power loss must never be contained
        except Exception as exc:  # noqa: BLE001 — the injected fault IS the point
            if self.config.mode == "device":
                raise
            self._note_failure(f"{label} raised: {exc!r}", "raise")
            return False
        return True

    # ---- sampled drain divergence (pipelined rounds) ----
    def should_sample_drain(self, committed: int) -> bool:
        """Every K-th COMMITTED prefetched drain round is differentially
        verified against the numpy drain mirror (K =
        divergence_check_every, 0 disables) — the PR-5 sampling
        discipline extended to the prefetched launch surface."""
        k = self.config.divergence_check_every
        return bool(k) and committed > 0 and committed % k == 0

    def pick_replay_round(self, n_committed: int) -> int:
        """Deterministic pseudo-random pick of WHICH committed megaloop
        round a sampled divergence check replays — a Weyl sequence over
        the check counter (no host RNG: chaos/property tests must
        replay identically), uniform over the batch across launches."""
        if n_committed <= 1:
            return 0
        return (self.divergence_checks * 2654435761) % n_committed

    def check_drain_divergence(
        self,
        device_sig: dict,
        host_sig_of: Callable[[], dict],
        heads: int,
        surface: str = "drain-prefetch",
    ) -> None:
        """Compare a committed drain round's decision signature against
        the host mirror's (ops/drain_np via run_drain(use_device=False)
        — bit-for-bit by construction). ``surface`` labels the guarded
        producer: "drain-prefetch" for pipelined speculative rounds,
        "drain-megaloop" for a replayed round of a fused launch. A
        mismatch is a fault of the port's drain on any device: it
        raises ``KernelError`` naming the differing fields, and the
        round is neither applied nor re-decided on the host."""
        import time as _time

        t0 = _time.perf_counter()
        self.divergence_checks += 1
        if self.metrics is not None:
            self.metrics.solver_divergence_checks_total.inc()
        host_sig = host_sig_of()
        dt = _time.perf_counter() - t0
        self.divergence_check_s += dt
        if self.tracer is not None:
            self.tracer.add_cycle_span(
                "cycle.divergence_check", dt,
                attrs={"surface": surface,
                       "diverged": host_sig != device_sig},
            )
        if host_sig == device_sig:
            return
        bad = sorted(
            k for k in device_sig if device_sig.get(k) != host_sig.get(k)
        )
        self.divergences += 1
        self.last_divergence = {
            "fields": bad,
            "surface": surface,
            "deviceSolves": self.device_solves,
            "heads": heads,
        }
        if self.metrics is not None:
            self.metrics.solver_divergences_total.inc()
        self.record_event(
            "SolverDiverged",
            f"{surface} solve diverged from the host mirror in {bad}; "
            "the drain raised",
        )
        raise KernelError(
            f"{surface}: a drain round of {heads} heads differs from the "
            f"numpy mirror in {bad}"
        )

    # ---- the guarded cycle batch solve ----
    def solve(self, snapshot, lowered, dispatch: Callable[[], object]) -> GuardOutcome:
        """Resolve one lowered cycle batch: device (guarded) when the
        breaker allows it, host mirror otherwise — including after an
        in-flight device failure. Every K-th successful device solve is
        differentially verified against the mirror; a mismatch
        quarantines the device path and the HOST result is returned as
        the authority."""
        from kueue_tpu_torch.testing import faults

        if self.path == "device":
            out = self.device_call(lambda: dispatch(), label="cycle solve")
            if out.result is not None:
                res = faults.transform("solver.device_wrong_answer", out.result)
                k = self.config.divergence_check_every
                if k and self.device_solves % k == 0:
                    host = self._divergence_check(snapshot, lowered, res)
                    if host is not None:
                        return GuardOutcome(
                            result=host, via="host-mirror",
                            device_dt=out.device_dt,
                        )
                return GuardOutcome(
                    result=res, via="device", device_dt=out.device_dt
                )
            if self.config.mode == "device":
                return out  # no failover in debugging mode
        # host authority: the numpy mirror over the same batch
        try:
            res = self._mirror_of(snapshot, lowered)
        except faults.InjectedCrash:
            raise
        except Exception:  # noqa: BLE001 — mirror failure (likely a
            # poison head corrupting the lowering) → per-head host path
            return GuardOutcome(result=None, via="host-mirror")
        return GuardOutcome(result=res, via="host-mirror")

    def _divergence_check(self, snapshot, lowered, device_res):
        """Returns the host result when it DIVERGES from the device's
        (the caller must adopt it); None when the paths agree."""
        import time as _time

        t0 = _time.perf_counter()
        self.divergence_checks += 1
        if self.metrics is not None:
            self.metrics.solver_divergence_checks_total.inc()
        host = self._mirror_of(snapshot, lowered)
        bad = results_match(device_res, host)
        dt = _time.perf_counter() - t0
        self.divergence_check_s += dt
        if self.tracer is not None:
            self.tracer.add_cycle_span(
                "cycle.divergence_check", dt,
                attrs={"surface": "cycle", "diverged": bool(bad)},
            )
        if not bad:
            return None
        self.divergences += 1
        self.breaker.quarantine(f"divergence in {bad}")
        verdict = {
            "fields": bad,
            "deviceSolves": self.device_solves,
            "heads": len(lowered.heads),
            "authority": "host",
        }
        self.last_divergence = verdict
        if self.metrics is not None:
            self.metrics.solver_divergences_total.inc()
        self.record_event(
            "SolverDiverged",
            f"device solver diverged from the host mirror in {bad}; "
            "device path quarantined, host mirror is now the decision "
            "authority",
        )
        # durable verdict: recovery (and the operator) can tell which
        # path produced the admitted state on disk
        self.journal_hook("solver_verdict", dict(verdict))
        self._report_path()
        return host

    # ---- cycle deadline (cycle.phase_deadline) ----
    def begin_cycle(self) -> None:
        self._cycle_t0 = self.clock.now()
        self._cycle_breached = False

    def phase_checkpoint(self, phase: str, device_used: bool = False) -> bool:
        """Fire the phase-boundary fault point and check the whole-cycle
        deadline. A breach with the device in play counts against the
        breaker (a late device launch must fail over); host-only
        breaches are recorded but the cycle finishes its bookkeeping
        either way. Returns True on breach."""
        from kueue_tpu_torch.testing import faults

        faults.fire("cycle.phase_deadline")
        if self._cycle_t0 is None or self._cycle_breached:
            return self._cycle_breached
        elapsed = self.clock.now() - self._cycle_t0
        if elapsed <= self.config.cycle_deadline_s:
            return False
        self._cycle_breached = True
        self.deadline_breaches += 1
        if device_used and self.config.mode == "auto":
            self._note_failure(
                f"cycle phase {phase!r} breached the "
                f"{self.config.cycle_deadline_s}s cycle deadline "
                f"({elapsed:.3f}s elapsed)",
                "deadline",
            )
        return True

    def note_contained_cycle(self, exc: BaseException) -> None:
        self.contained_cycles += 1
        self.record_event(
            "SchedulingCycleFailed",
            f"scheduling cycle raised and was contained: {exc!r}; heads "
            "requeued, admission continues next cycle",
        )

    # ---- surfaces ----
    def health(self) -> dict:
        """The /healthz + dashboard solver detail."""
        return {
            "path": self.path,
            "mode": self.config.mode,
            "breaker": self.breaker.state,
            "consecutiveFailures": self.breaker.consecutive_failures,
            "nextProbeAt": self.breaker.next_probe_at,
            "lastFailure": self.breaker.last_failure,
            "deviceSolves": self.device_solves,
            "failovers": self.failovers,
            "divergenceChecks": self.divergence_checks,
            "divergences": self.divergences,
            "containedCycles": self.contained_cycles,
            "deadlineBreaches": self.deadline_breaches,
        }

    @property
    def degraded(self) -> bool:
        """True while the circuit is open/quarantined in auto mode —
        the /healthz "degraded" signal (a forced --solver-path host is
        an operator choice, not a degradation)."""
        return self.config.mode == "auto" and self.breaker.state != "closed"
