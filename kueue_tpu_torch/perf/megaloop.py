"""The headline megaloop chain (bench.py's 50k pending x 1000
ClusterQueues, seed 0, ``max_cells=3``) and what it decides.

The chain is the one a pipelined drain loop makes: launch the megaloop,
fetch its log, and while the log is truncated relaunch over the last
round's undecided backlog on ``speculative_snapshot(snapshot,
final_usage)``. It takes the launch and snapshot functions as
arguments, so the same code drives either package.

``chunk_cycles=8, max_rounds=8``: bench.py's megaloop setting is
``chunk_cycles=4, max_rounds=16``, but at 4 cycles a round the headline
chain never ends, in the JAX package as in the port: heads whose flavor
walk needs more than 4 cycles restart it each round, and the third
launch admits nothing and leaves the backlog and the usage as it found
them, so every relaunch repeats it (``chain_readings``;
tests/test_torch_headline_drains.py pins it on the JAX package). At
8 x 8 the same 64-cycle bound a launch gives two launches (8 rounds,
then 2), so truncation and the relaunch run at full width.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np

from kueue_tpu_torch.perf.headline import HEADLINE_MAX_CELLS

CHUNK_CYCLES = 8
MAX_ROUNDS = 8
MAX_LAUNCHES = 8  # a chain longer than this is a fault


def iter_chain(launch_megaloop, speculative_snapshot, snapshot, pending, flavors,
               chunk_cycles=CHUNK_CYCLES, max_rounds=MAX_ROUNDS, **kwargs):
    """Yield ``(snapshot, pending, log)`` for each launch of the chain:
    what the launch started from and the log it fetched. Ends after the
    first log that is not truncated."""
    s, p = snapshot, pending
    while True:
        log = launch_megaloop(
            s, p, flavors, max_cells=HEADLINE_MAX_CELLS,
            chunk_cycles=chunk_cycles, max_rounds=max_rounds, **kwargs,
        ).fetch()
        yield s, p, log
        if not log.truncated:
            return
        last = log.rounds[-1]
        s, p = speculative_snapshot(s, last.final_usage), last.undecided


def run_chain(launch_megaloop, speculative_snapshot, snapshot, pending, flavors,
              chunk_cycles=CHUNK_CYCLES, max_rounds=MAX_ROUNDS, **kwargs):
    """The megaloop logs of the chain, one per launch."""
    logs = []
    for _, _, log in iter_chain(launch_megaloop, speculative_snapshot, snapshot, pending,
                                flavors, chunk_cycles, max_rounds, **kwargs):
        logs.append(log)
        if log.truncated and len(logs) >= MAX_LAUNCHES:
            raise RuntimeError(f"the megaloop chain did not end in {MAX_LAUNCHES} launches")
    return logs


def chain_readings(launch_megaloop, speculative_snapshot, snapshot, pending, flavors,
                   chunk_cycles: int, max_rounds: int, n_launches: int):
    """The first ``n_launches`` launches of the chain, one dict each:
    rounds, cycles, admitted, truncated, the undecided backlog left,
    and ``fixed``: the launch left the backlog and the leaf usage as it
    found them, so every relaunch from there repeats it and the chain
    never ends."""
    out = []
    chain = iter_chain(launch_megaloop, speculative_snapshot, snapshot, pending, flavors,
                       chunk_cycles, max_rounds)
    for s, p, log in chain:
        last = log.rounds[-1]
        out.append({
            "rounds": int(log.n_rounds),
            "cycles": int(log.cycles),
            "admitted": sum(len(o.admitted) for o in log.rounds),
            "truncated": bool(log.truncated),
            "undecided": len(last.undecided),
            "fixed": bool(
                sorted(wl.name for wl, _ in last.undecided) == sorted(wl.name for wl, _ in p)
                and np.array_equal(last.final_usage, s.local_usage)
            ),
        })
        if len(out) >= n_launches:
            break
    return out


def serial_chain(launch_drain, speculative_snapshot, snapshot, pending, flavors,
                 n_rounds: int, chunk_cycles=CHUNK_CYCLES, **kwargs):
    """The same rounds as ``n_rounds`` serial ``launch_drain(max_cycles=
    chunk_cycles)`` launches, each over the previous one's undecided
    backlog; returns their DrainOutcomes."""
    outs = []
    s, p = snapshot, pending
    for _ in range(n_rounds):
        out = launch_drain(
            s, p, flavors, max_cells=HEADLINE_MAX_CELLS, max_cycles=chunk_cycles, **kwargs,
        ).fetch()
        outs.append(out)
        if not out.undecided:
            break
        s, p = speculative_snapshot(s, out.final_usage), out.undecided
    return outs


def chain_digest(logs) -> str:
    """sha256 of every round's admissions (workload, flavors, launch,
    round, in-round cycle), sorted, and each launch's final leaf
    usage."""
    rows = sorted(
        (wl.name, json.dumps(flavors, sort_keys=True), li, ri, int(cycle))
        for li, log in enumerate(logs)
        for ri, out in enumerate(log.rounds)
        for wl, _, flavors, cycle in out.admitted
    )
    h = hashlib.sha256(json.dumps(rows).encode())
    for log in logs:
        usage = np.ascontiguousarray(log.rounds[-1].final_usage, dtype="<i8")
        h.update(repr(usage.shape).encode())
        h.update(usage.tobytes())
    return h.hexdigest()


def chain_summary(logs) -> dict:
    """The MEGALOOP_EXPECT keys of a chain: launches, rounds per launch,
    cycles in all, and over all rounds the admitted, the parked, the
    terminal fallback (fallback that is not carried on as undecided)
    and the digest."""
    rounds = [out for log in logs for out in log.rounds]
    return {
        "launches": len(logs),
        "rounds_per_launch": [int(log.n_rounds) for log in logs],
        "cycles": sum(int(log.cycles) for log in logs),
        "admitted": sum(len(out.admitted) for out in rounds),
        "parked": sum(len(out.parked) for out in rounds),
        "fallback": sum(len(out.fallback) - len(out.undecided) for out in rounds),
        "digest": chain_digest(logs),
    }


# What the headline chain decides, from the JAX package on the CPU;
# tests/test_torch_headline_drains.py holds the JAX package to it and
# chip_smoke.py holds the port on the card to it.
MEGALOOP_EXPECT = {
    "launches": 2,
    "rounds_per_launch": [8, 2],
    "cycles": 78,
    "admitted": 15260,
    "parked": 34740,
    "fallback": 0,
    "digest": "c9b2de49eabc709a4a443ae2503703a835b8c5936d4e541c62d73c4c9eedd912",
}
