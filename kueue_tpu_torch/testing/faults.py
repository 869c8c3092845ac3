"""Named fault-injection points for crash-consistency and failover
testing.

The durable-state subsystem (kueue_tpu/storage) and the resilient
solver executor (kueue_tpu/core/guard.py) make exact promises about
which failure windows are survivable: "record appended but not yet
applied", "checkpoint tmp written but not yet renamed", "solve finished
but outcome not yet applied", "device launch raised/hung/answered
wrong". Each of those windows is marked in production code with
``fire("<point name>")`` (or ``transform`` for result-corruption
points) — a no-op unless a test armed the point — so the chaos suites
can kill the process / fail the device at every registered point and
prove recovery (or failover) converges.

Every point carried by a production call site MUST be registered in
``FAULT_POINTS`` below; ``list_fault_points()`` exposes the registry
and tests/test_guard.py lints the tree so no call site can introduce an
undocumented point (mirroring the reason-enum lint).

Crashes are raised as ``InjectedCrash(BaseException)`` on purpose:
broad ``except Exception`` recovery paths in the server — including the
cycle guard's exception containment — must NOT be able to swallow a
simulated power loss — only the test harness catches it.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, List, Optional

# ---- the fault-point registry ----
# name -> where it fires and which failure window it models. The chaos
# suites enumerate this table; the lint test asserts every
# ``faults.fire("...")`` / ``faults.transform("...")`` /
# ``fault_point="..."`` call site in the tree names a registered point.
FAULT_POINTS: Dict[str, str] = {
    "journal.post_append_pre_apply": (
        "a journal record is durable but the in-memory mutation it "
        "describes has not completed (ClusterRuntime journal hooks)"
    ),
    "journal.fsync": (
        "immediately before os.fsync on the journal segment — arm with "
        "an OSError action to simulate ENOSPC/EIO and drive the "
        "degraded-persistence path"
    ),
    "checkpoint.mid_write": (
        "checkpoint tmp file fully written + fsynced, os.replace not "
        "yet executed (utils/lease.atomic_write_text)"
    ),
    "checkpoint.delta_write": (
        "delta-checkpoint chain write: the anchor/delta tmp file is "
        "durably written, os.replace not yet executed "
        "(storage/checkpoint.DeltaCheckpointer.commit via "
        "atomic_write_text) — arm with an OSError action to model "
        "ENOSPC on the state volume (the PREVIOUS chain must stay "
        "valid and the checkpointer flips degraded until the next "
        "success), or 'crash' to kill the process mid-commit"
    ),
    "journal.rotate": (
        "journal segment rotation: the next segment file is about to "
        "be created (storage/journal._start_segment) — arm with an "
        "OSError action to model ENOSPC on the volume's metadata "
        "path; appends must degrade (record dropped, flag flipped) "
        "and self-heal once the volume recovers, and a compaction-"
        "driven rotation must degrade instead of failing the "
        "checkpoint that triggered it"
    ),
    "cycle.post_solve_pre_apply": (
        "scheduler nomination / drain solve complete, outcome not yet "
        "applied (core/scheduler.schedule, controllers.bulk_drain)"
    ),
    "cycle.prefetch_launched": (
        "pipelined drain: round t+1's speculative encode + device solve "
        "just dispatched, round t's outcome NOT yet applied or "
        "journaled (controllers._pipelined_bulk_drain) — a crash here "
        "must recover exactly like a crash before the serial apply; "
        "the in-flight speculative result is lost, never shipped"
    ),
    "cycle.commit_pre_apply": (
        "pipelined drain: the conflict check just proved the "
        "speculative inputs equal the real post-apply state, the "
        "prefetched decisions are NOT yet fetched/applied/journaled — "
        "a crash here leaves rounds <= t durable and round t+1 "
        "undecided; recovery + rerun must converge to the serial "
        "loop's admitted set"
    ),
    "cycle.megaloop_launched": (
        "megaloop drain: a fused K-round dispatch "
        "(ops/megaloop_kernel) just launched, NOTHING of its batched "
        "decision log applied or journaled yet "
        "(controllers._megaloop_bulk_drain) — a crash here must "
        "recover exactly like a crash before a serial round's apply; "
        "the in-flight fused log is lost, never shipped"
    ),
    "cycle.megaloop_commit_round": (
        "megaloop drain: the per-round conflict check just proved "
        "round r's implied inputs (previous round's kernel usage over "
        "its undecided backlog) equal the real post-apply state; "
        "round r is NOT yet applied or journaled — a crash here "
        "leaves rounds < r durable and the rest of the batch "
        "undecided; recovery + rerun must converge to the serial "
        "loop's admitted set"
    ),
    "solver.device_raise": (
        "immediately before a device solver dispatch (cycle batch or "
        "bulk drain) — arm to make the launch raise; the guard must "
        "contain it and fail over to the host mirror"
    ),
    "solver.device_hang": (
        "immediately after a device dispatch returns — arm with a "
        "clock-advancing action to simulate a hang past the guard's "
        "device deadline (FakeClock-disciplined)"
    ),
    "solver.device_wrong_answer": (
        "transform point over the device SolveResult — arm with a "
        "corrupting callable to model a silently diverging kernel; the "
        "sampled differential check must catch it"
    ),
    "cycle.phase_deadline": (
        "at each schedule()/bulk_drain phase boundary — arm with a "
        "clock-advancing action to push the cycle past its wall-clock "
        "deadline"
    ),
    # ---- MultiKueue federation (kueue_tpu/federation) ----
    "multikueue.partition": (
        "immediately before every federation transport exchange "
        "(mirror / poll / sync-back) — arm with a TransportError-raising "
        "action to model a network partition on that wire, or 'crash' "
        "to kill the dispatcher mid-exchange"
    ),
    "multikueue.lost_retraction": (
        "immediately before a retraction's remote delete is sent — arm "
        "with a TransportError-raising action to model the retraction "
        "lost to a partition (must be retried, at-least-once), or "
        "'crash' to kill the dispatcher between send and ack"
    ),
    "multikueue.duplicate_admit": (
        "in the winner pick, after remote reservations were observed "
        "and before the winner record is journaled — the window where "
        "more than one cluster may hold a reservation; a crash here "
        "must still converge to exactly one admission after recovery"
    ),
    "multikueue.worker_crash": (
        "at the top of every federation pass — arm with an action that "
        "crashes + journal-recovers a worker control plane in place; "
        "the dispatcher must converge to the same federated admitted "
        "set against the recovered worker"
    ),
    "multikueue.stale_token": (
        "transform point over the fencing token echoed in every remote "
        "sync-back — arm with a corrupting callable to model a deposed "
        "winner's stale copy; the dispatcher must refuse the token and "
        "retract the copy instead of double-admitting"
    ),
    # ---- global scheduler (kueue_tpu/federation/global_scheduler.py) ----
    "global.partition": (
        "once per worker read during global-snapshot aggregation — arm "
        "with a TransportError-raising action to model the worker "
        "partitioned away from the rescore loop (its columns degrade "
        "to unscorable, the pass continues), or 'crash' to kill the "
        "manager mid-aggregation"
    ),
    "global.stale_fence": (
        "transform point over the fencing epoch a rebalance decision "
        "was computed against — arm with a corrupting callable to "
        "model the placement moving (deposal/heal/concurrent "
        "rebalance) between aggregation and apply; the CAS must DROP "
        "the move instead of retracting the wrong epoch"
    ),
    "global.rebalance_retract": (
        "inside a rebalance apply, after the old winner's retraction "
        "is journaled and before the new dispatch intent is — a crash "
        "here replays to 'old winner still named, unacked retraction "
        "queued'; the pump + deposal + re-dispatch must converge to "
        "exactly one admission"
    ),
    # ---- elastic capacity plane (kueue_tpu/elastic) ----
    "provisioning.mid_flip": (
        "two-phase admission: the ProvisioningRequest just turned "
        "Provisioned and the check is about to flip Ready "
        "(admissionchecks/provisioning._sync_check_state) — the torn "
        "window where the provider granted capacity but the check "
        "state/pod_set_updates are not yet applied or journaled; a "
        "crash here must recover to the no-crash admitted set"
    ),
    "elastic.grant_mid_apply": (
        "elastic capacity grant: the elastic_grant record is durable "
        "in the journal, the flavor-quota mutation + parked-head "
        "requeue NOT yet applied (elastic/plane._apply_grant) — "
        "recovery must re-apply the post-state record idempotently and "
        "converge to the no-crash admitted set"
    ),
    # ---- gateway serving tier (kueue_tpu/gateway/batcher.py) ----
    "gateway.flush_mid_batch": (
        "inside the write-gateway's coalescing flush, between two "
        "consecutive request applies of one batch — records for "
        "earlier items are journaled (possibly not yet fsynced under "
        "group commit), later items never applied, no client was "
        "acked; journal recovery plus client re-submit must converge to "
        "the serial reference with no lost or duplicated workload"
    ),
    # ---- gray-failure chaos layer (this module's transports) ----
    "chaos.latency": (
        "immediately before a latency-injected federation exchange "
        "(LatencyTransport/SlowDripTransport) delays or times out the "
        "wire — arm with 'crash' to kill the dispatcher while a gray "
        "worker is mid-limp, or a callable to reshape the schedule"
    ),
    "chaos.drop_request": (
        "asymmetric loss, request direction: the request is about to "
        "be dropped BEFORE it reaches the worker (the mutation never "
        "lands; the caller burns its full deadline) — arm with 'crash' "
        "to kill the dispatcher inside the loss window"
    ),
    "chaos.drop_response": (
        "asymmetric loss, response direction: the mutation has LANDED "
        "on the worker and the response is about to be dropped (the "
        "caller sees a timeout for an exchange that succeeded — the "
        "window where duplicate-create dedup and 404==ack retraction "
        "semantics are load-bearing) — arm with 'crash' to kill the "
        "dispatcher between the landing and the ack"
    ),
    "multikueue.hedge": (
        "hedged dispatch: the primary attempt missed its p95 hedge "
        "delay and the backup attempt is about to fire "
        "(multikueue_transport.RemoteClient.call) — a crash here must "
        "still converge to exactly one admission (the primary may have "
        "landed, the backup may land again)"
    ),
    # ---- journal-tailing read replicas (kueue_tpu/storage/tailer.py) ----
    "replica.tail_gap": (
        "the tailer just detected that the leader can no longer serve "
        "its resume position (compaction deleted the segment under it, "
        "the leader's head regressed, or the feed skipped a seq) and is "
        "about to fall back to a checkpoint resync — arm with 'crash' "
        "to kill the replica in the window, or a raising action to "
        "model the detection racing a concurrent compact()"
    ),
    "replica.resync": (
        "checkpoint resync: the leader's state dump is fetched and a "
        "fresh runtime is about to be rebuilt from it (first attach, "
        "compaction jump, or fencing-token re-anchor after a leader "
        "handover) — arm to fail or crash the rebuild; the tailer must "
        "keep serving the previous runtime and retry on the next poll"
    ),
}


def list_fault_points() -> List[str]:
    """Sorted names of every registered fault point."""
    return sorted(FAULT_POINTS)


class InjectedCrash(BaseException):
    """Simulated process death at a named fault point."""


class _Armed:
    __slots__ = ("action", "skip", "fired")

    def __init__(self, action, skip: int):
        self.action = action
        self.skip = skip  # fire() calls to let through before acting
        self.fired = 0  # times the ACTION ran


_lock = threading.Lock()
_armed: Dict[str, _Armed] = {}


def fire(name: str) -> None:
    """Production-side hook. Free when nothing is armed (one falsy dict
    probe); runs the armed action otherwise. ``action="crash"`` raises
    InjectedCrash; a callable action is invoked (and may raise, e.g.
    OSError for a simulated fsync failure)."""
    if not _armed:
        return
    with _lock:
        a = _armed.get(name)
        if a is None:
            return
        if a.skip > 0:
            a.skip -= 1
            return
        a.fired += 1
        action = a.action
    if action == "crash":
        raise InjectedCrash(f"injected crash at fault point {name!r}")
    action()


def transform(name: str, value):
    """Result-corruption hook (``solver.device_wrong_answer``-style
    points): returns ``value`` untouched unless the point is armed with
    a callable, which receives the value and returns its replacement.
    ``action="crash"`` still raises, so every point is also usable as a
    plain crash site."""
    if not _armed:
        return value
    with _lock:
        a = _armed.get(name)
        if a is None:
            return value
        if a.skip > 0:
            a.skip -= 1
            return value
        a.fired += 1
        action = a.action
    if action == "crash":
        raise InjectedCrash(f"injected crash at fault point {name!r}")
    return action(value)


def arm(name: str, action="crash", skip: int = 0) -> None:
    """Arm ``name``: the (skip+1)-th fire() runs ``action`` (and every
    later one too, until reset/disarm)."""
    with _lock:
        _armed[name] = _Armed(action, skip)


def disarm(name: str) -> int:
    """Disarm one point; returns how many times its action ran."""
    with _lock:
        a = _armed.pop(name, None)
        return a.fired if a is not None else 0


def fired(name: str) -> int:
    with _lock:
        a = _armed.get(name)
        return a.fired if a is not None else 0


def reset() -> None:
    """Disarm everything (test teardown)."""
    with _lock:
        _armed.clear()


def fire_count(name: str) -> Optional[int]:
    """How many fire() calls remain before the action triggers (None
    when not armed) — lets sweeps enumerate occurrence indices."""
    with _lock:
        a = _armed.get(name)
        return a.skip if a is not None else None


def make_failing_fsync(errno_: int = 28) -> Callable[[], None]:
    """Action for ``journal.fsync``: raise ENOSPC (default) the way a
    full volume would."""

    def _raise():
        raise OSError(errno_, os.strerror(errno_))

    return _raise


def corrupt_tail(segment_path: str, nbytes: int = 7) -> None:
    """Torn-tail corruptor: truncate the last ``nbytes`` of a journal
    segment, simulating a power loss mid-append (the kernel got part of
    the frame to disk). ``nbytes`` larger than the file empties it."""
    size = os.path.getsize(segment_path)
    with open(segment_path, "rb+") as f:
        f.truncate(max(0, size - nbytes))


def garble_tail(segment_path: str, nbytes: int = 4) -> None:
    """Bit-rot corruptor: flip the last ``nbytes`` in place (frame
    length intact, CRC now wrong) — the other torn-tail shape."""
    size = os.path.getsize(segment_path)
    if size == 0:
        return
    n = min(nbytes, size)
    with open(segment_path, "rb+") as f:
        f.seek(size - n)
        tail = f.read(n)
        f.seek(size - n)
        f.write(bytes(b ^ 0xFF for b in tail))

