"""NumPy mirror of the megaloop (port of kueue_tpu/ops/megaloop_np.py;
only the imports differ).

Not a transliteration of the fused loop: this mirror IS the serial
chunked drain, one ``solve_drain_np`` call per round over queue tensors
suffix-trimmed to exactly what a fresh re-plan over the round's
undecided backlog would ship (entries repacked from the previous
round's cursor, stuck queues dropped, retry budgets re-derived from the
remaining suffix). Equality of the megaloop with this mirror is
therefore the proof that K fused rounds decide what K serial launches
decide: round stamps, in-round cycle stamps, cursors, stuck sets and
per-round final usage included.

Why trimming equals a fresh re-plan: plan_drain's per-entry tensors
are copied straight from the lowering, identical for the same entry in
any round; the per-queue config bits are ClusterQueue constants;
retry_cap is min(4096, max walk_states + 1) over the queue's remaining
entries, which the ``cap_suffix`` input precomputes per starting
position. Row compaction and re-bucketed n_segments/n_steps change
capacity only, never decisions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from kueue_tpu_torch.ops.drain_np import solve_drain_np

#: [Q, L, ...] per-entry fields shifted at a round boundary; everything
#: else in the DrainQueues layout is per-queue config and stays put
_ENTRY_FIELDS = (
    "cells", "qty", "valid", "n_podsets", "gidx", "glast", "cgrp",
    "priority", "timestamp", "score",
)


class MegaloopResultNP(NamedTuple):
    """megaloop_kernel.MegaloopResult with numpy arrays."""

    admitted_k: np.ndarray  # int32[Q,L,P]
    admitted_cycle: np.ndarray  # int32[Q,L] in-round stamp
    admitted_round: np.ndarray  # int32[Q,L]
    round_cursor: np.ndarray  # int32[R,Q]
    round_stuck: np.ndarray  # bool[R,Q]
    round_cycles: np.ndarray  # int32[R]
    round_usage: np.ndarray  # int64[R,N,FR]
    rounds: int
    cycles: int


def _trim_queues(queues_np: dict, cursor: np.ndarray, dead: np.ndarray,
                 cap_suffix: np.ndarray) -> dict:
    """The queue tensors a fresh re-plan over the undecided suffix
    would ship: entries repacked from ``cursor`` to position 0, retired
    (stuck/drained) queues emptied, retry budgets re-derived."""
    q, l = queues_np["priority"].shape[:2]
    out = {
        name: (arr.copy() if name in _ENTRY_FIELDS or name in
               ("qlen", "cq_rows", "seg_id", "retry_cap") else arr)
        for name, arr in queues_np.items()
        if arr is not None
    }
    qlen = queues_np["qlen"]
    for qi in range(q):
        start = int(cursor[qi])
        rem = int(qlen[qi]) - start
        if dead[qi] or rem <= 0:
            out["qlen"][qi] = 0
            out["cq_rows"][qi] = -1
            out["seg_id"][qi] = -1
            # a retired queue is absent from a real re-plan: its stale
            # budget must not feed the stagnation guard's max
            out["retry_cap"][qi] = 0
            continue
        out["qlen"][qi] = rem
        out["retry_cap"][qi] = cap_suffix[qi, start]
        if start == 0:
            continue
        for name in _ENTRY_FIELDS:
            arr = out.get(name)
            if arr is None:
                continue
            arr[qi, :rem] = arr[qi, start : start + rem].copy()
            # pad the vacated tail with inert values (never active)
            tail = arr[qi, rem:]
            if name == "cells" or name == "cgrp":
                tail[...] = -1
            elif name == "n_podsets":
                tail[...] = 1
            else:
                tail[...] = 0
    return out


def solve_megaloop_np(
    parent: np.ndarray,
    level_mask: np.ndarray,
    nominal: np.ndarray,
    lending: np.ndarray,
    borrowing: np.ndarray,
    local_usage: np.ndarray,  # int64[N,FR] starting leaf usage
    queues_np: dict,  # DrainQueues layout (plan_drain.queues_np)
    paths: np.ndarray,  # int32[N, D+1]
    max_depth: int,
    chunk_cycles: int,
    max_rounds: int,
    cap_suffix: np.ndarray,  # int32[Q, L] suffix retry budgets
) -> MegaloopResultNP:
    """K serial chunked rounds on the host — the megaloop's authority."""
    q, l, pmax = queues_np["cells"].shape[:3]
    n, fr = local_usage.shape
    qlen = queues_np["qlen"]

    local = local_usage.copy()
    cursor = np.zeros(q, dtype=np.int32)
    dead = np.zeros(q, dtype=bool)
    adm_k = np.full((q, l, pmax), -1, dtype=np.int32)
    adm_cycle = np.full((q, l), -1, dtype=np.int32)
    adm_round = np.full((q, l), -1, dtype=np.int32)
    r_cursor = np.zeros((max_rounds, q), dtype=np.int32)
    r_stuck = np.zeros((max_rounds, q), dtype=bool)
    r_cycles = np.zeros(max_rounds, dtype=np.int32)
    r_usage = np.zeros((max_rounds, n, fr), dtype=np.int64)

    rounds = 0
    cycles = 0
    while rounds < max_rounds and bool(np.any((cursor < qlen) & ~dead)):
        trimmed = _trim_queues(queues_np, cursor, dead, cap_suffix)
        res = solve_drain_np(
            parent, level_mask, nominal, lending, borrowing, local,
            trimmed, paths, max_depth, chunk_cycles,
        )
        for qi in range(q):
            start = int(cursor[qi])
            for pos_t in range(int(trimmed["qlen"][qi])):
                if res.admitted_k[qi, pos_t, 0] < 0:
                    continue
                adm_k[qi, start + pos_t] = res.admitted_k[qi, pos_t]
                adm_cycle[qi, start + pos_t] = res.admitted_cycle[
                    qi, pos_t
                ]
                adm_round[qi, start + pos_t] = rounds
        cursor = cursor + res.cursor
        local = np.asarray(res.local_usage)
        r_cursor[rounds] = cursor
        r_stuck[rounds] = res.stuck | dead
        r_cycles[rounds] = res.cycles
        r_usage[rounds] = local
        dead = dead | res.stuck
        cycles += int(res.cycles)
        rounds += 1

    return MegaloopResultNP(
        admitted_k=adm_k,
        admitted_cycle=adm_cycle,
        admitted_round=adm_round,
        round_cursor=r_cursor,
        round_stuck=r_stuck,
        round_cycles=r_cycles,
        round_usage=r_usage,
        rounds=rounds,
        cycles=cycles,
    )
