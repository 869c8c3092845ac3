"""The interactive admission cycle at the headline size.

bench.py's headline cluster and backlog (seed 0: 1000 ClusterQueues in
50 cohorts, 50k pending workloads) queued in a QueueManager with one
LocalQueue per ClusterQueue, and ``Scheduler(use_solver=True)`` run for
``CYCLES`` cycles. Every cycle pops one head per ClusterQueue (1000
heads, W = 1024 after bucketing, K = 8, C = 16), so it is the shape of
the reference's "p99 schedule-cycle latency" headline.

``cycle_digest`` hashes each cycle's admitted (workload, ClusterQueue,
flavor per resource) in admission order, its requeued count and its
resolution, plus the cache's final usage, so two runs (or two packages)
compare by one constant. ``CYCLE_EXPECT`` is what the JAX package
decides (tests/test_torch_cycle_headline.py holds the JAX package to
it; chip_smoke.py holds the port on the card to it).
"""

from __future__ import annotations

import hashlib
import json
from typing import List

import numpy as np

from kueue_tpu_torch.perf import headline

CYCLES = 16

# What the headline cycle run decides, from the JAX package on the CPU.
CYCLE_EXPECT = {
    "cycles": CYCLES,
    "admitted": [
        995, 991, 947, 879, 867, 844, 820, 756, 709, 619, 560, 465, 426, 383,
        389, 353,
    ],
    "digest": "a1957c8e710c380a3dc904ed946e441622b7ad9edf9bebc120931cb1f9db0fcb",
}


def build_headline_scheduler(device=None, guard=None):
    """(Scheduler, Cache) over the headline cluster with the whole
    backlog queued; the cycle solve runs on ``device``."""
    from kueue_tpu_torch.core.scheduler import Scheduler
    from kueue_tpu_torch.utils.clock import FakeClock

    rng = np.random.default_rng(headline.HEADLINE_SEED)
    cache = headline.build_cluster(rng)
    pending = headline.build_backlog(rng)
    clock = FakeClock(0.0)
    mgr = headline.build_queues(cache, clock)
    for wl, _ in pending:
        mgr.add_or_update_workload(wl)
    sched = Scheduler(
        queues=mgr, cache=cache, clock=clock, use_solver=True, guard=guard,
        device=device,
    )
    return sched, cache


def cycle_record(result) -> dict:
    """One CycleResult (either package's) as plain data."""
    return {
        "admitted": [
            [
                e.workload.name,
                e.cq_name,
                [
                    [psa.name, sorted(psa.flavors.items())]
                    for psa in e.workload.admission.pod_set_assignments
                ],
            ]
            for e in result.admitted
        ],
        "requeued": len(result.requeued),
        "resolution": result.resolution,
    }


def run_cycles(sched, n: int = CYCLES) -> List[dict]:
    return [cycle_record(sched.schedule()) for _ in range(n)]


def run_until_quiet(sched, mgr, max_cycles: int = 60) -> List[dict]:
    """Cycles until one admits and preempts nothing and no parked
    workload moves back (as tests/test_solver_path.drain_and_trace),
    at most ``max_cycles``; the records, with the preempting workloads."""
    records = []
    for _ in range(max_cycles):
        res = sched.schedule()
        rec = cycle_record(res)
        rec["preempting"] = sorted(e.workload.name for e in res.preempting)
        records.append(rec)
        if not res.admitted and not res.preempting:
            moved = False
            for cq_name in list(mgr.cluster_queues):
                moved = mgr.queue_associated_inadmissible_workloads_after(cq_name) or moved
            if not moved:
                break
    return records


def cycle_digest(records: List[dict], cache, take_snapshot) -> str:
    """sha256 of the cycle records and the cache's final leaf usage
    (``take_snapshot`` of the cache's own package)."""
    h = hashlib.sha256(json.dumps(records).encode())
    usage = np.ascontiguousarray(take_snapshot(cache).local_usage, dtype="<i8")
    h.update(repr(usage.shape).encode())
    h.update(usage.tobytes())
    return h.hexdigest()


def cycle_summary(records: List[dict], cache, take_snapshot) -> dict:
    """The CYCLE_EXPECT keys of a run."""
    return {
        "cycles": len(records),
        "admitted": [len(r["admitted"]) for r in records],
        "digest": cycle_digest(records, cache, take_snapshot),
    }
