"""The admission megaloop: K drain rounds in one launch, on the card.

Port of kueue_tpu/ops/megaloop_kernel.py. The plain drain cycle
(ops/drain_kernel.drain_cycle: four launches) runs with a fifth launch
after it, ``megaloop_boundary`` (csrc/megaloop_boundary.cu), that
closes a round every ``chunk_cycles`` cycles or when the round
quiesces, so that each round decides exactly what a serial
``launch_drain(max_cycles=chunk_cycles)`` over the previous round's
undecided backlog would:

- the round's walk state starts afresh: per-group flavor cursors,
  retries, the stagnation counter and the stuck flags are zeroed;
- queues stuck at the boundary retire (``alive``): a serial round
  reports their entries as fallback and never feeds them on;
- the retry budget of each remaining queue is re-derived from its
  remaining entries: ``cap_suffix[q, p]`` is the budget a fresh plan
  over positions >= p computes, gathered at the round's starting
  cursor into the state's ``cap`` buffer, which nomination and queue
  motion read (0 for retired and drained queues).

The loop state carries the round-stamped log: the round of each
admission (``adm_round``), its in-round cycle (``adm_cycle``, stamped
from the state's cycle slot, which here counts cycles within the
round), and per-round snapshots of the cursors, the stuck-or-retired
queues, the cycle count and the leaf usage. The host enqueues all
``chunk_cycles x max_rounds`` cycles (up to
``drain_kernel.ENQUEUE_ALL_CYCLES``) with no read of the device
``done`` flag; the boundary launch owns that flag, and every launch
after it returns at once. The packed log is the JAX
``_solve_drain_megaloop_packed`` layout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

from kueue_tpu_torch._torch import BOOL, I32, I64, torch
from kueue_tpu_torch.ops import drain_kernel as dk
from kueue_tpu_torch.ops.drain_kernel import (
    CycleBuffers,
    DrainContext,
    DrainQueues,
    DrainState,
)
from kueue_tpu_torch.ops.quota import QuotaTree

KERNEL = "megaloop_boundary"


class MegaloopResult(NamedTuple):
    """The round-stamped decision log of one fused launch.

    admitted_k:     int32[Q,L,P] chosen candidate per entry (-1 never);
    admitted_cycle: int32[Q,L]   in-round cycle of the admission;
    admitted_round: int32[Q,L]   round of the admission (-1);
    round_cursor:   int32[R,Q]   cursor at each round's end;
    round_stuck:    bool[R,Q]    stuck or retired at each round's end;
    round_cycles:   int32[R]     cycles run within each round;
    round_usage:    int64[R,N,FR] leaf usage at each round's end;
    rounds:         int32[1]     rounds run;
    cycles:         int32[1]     kernel cycles in all."""

    admitted_k: torch.Tensor
    admitted_cycle: torch.Tensor
    admitted_round: torch.Tensor
    round_cursor: torch.Tensor
    round_stuck: torch.Tensor
    round_cycles: torch.Tensor
    round_usage: torch.Tensor
    rounds: torch.Tensor
    cycles: torch.Tensor


@dataclass
class MegaloopState(DrainState):
    """DrainState plus the megaloop's round log (all on one device)."""

    cap_suffix: torch.Tensor = None  # int32[Q,L] suffix retry budgets (input)
    adm_round: torch.Tensor = None  # int32[Q,L]
    round_idx: torch.Tensor = None  # int32[1]
    total: torch.Tensor = None  # int32[1] kernel cycles over all rounds
    r_cursor: torch.Tensor = None  # int32[R,Q]
    r_stuck: torch.Tensor = None  # bool[R,Q]
    r_cycles: torch.Tensor = None  # int32[R]
    r_usage: torch.Tensor = None  # int64[R,N,FR]

    @classmethod
    def initial_rounds(cls, local_usage, queues: DrainQueues, cap_suffix, max_rounds: int):
        """The state before the first cycle, built on the device with no
        host read."""
        base = DrainState.initial(local_usage, queues, max_cycles=1)
        q, l = queues.priority.shape
        n, fr = local_usage.shape
        dev = local_usage.device
        has = queues.qlen > 0
        go = has.any() & (max_rounds > 0)
        fields_ = {f: getattr(base, f) for f in base.__dataclass_fields__}
        fields_["done"] = (~go).to(I32).reshape(1)
        fields_["cap"] = torch.where(has, cap_suffix[:, 0], 0).to(I32)
        return cls(
            **fields_,
            cap_suffix=cap_suffix,
            adm_round=torch.full((q, l), -1, dtype=I32, device=dev),
            round_idx=torch.zeros(1, dtype=I32, device=dev),
            total=torch.zeros(1, dtype=I32, device=dev),
            r_cursor=torch.zeros((max_rounds, q), dtype=I32, device=dev),
            r_stuck=torch.zeros((max_rounds, q), dtype=BOOL, device=dev),
            r_cycles=torch.zeros(max_rounds, dtype=I32, device=dev),
            r_usage=torch.zeros((max_rounds, n, fr), dtype=I64, device=dev),
        )


def megaloop_boundary_plain(ctx: DrainContext, state: MegaloopState, buf: CycleBuffers) -> None:
    """The round bookkeeping after one cycle (the JAX megaloop body after
    ``_plain_cycle``, ops/megaloop_kernel.py:128-173): stamp the round
    of fresh admissions, count the cycle, close the round when it
    quiesced or ran ``chunk_cycles`` cycles (snapshot its cursors,
    stuck-or-retired queues, cycles and leaf usage at index
    min(round, R-1); retire stuck queues; zero the walk state; gather
    the next budgets), then the loop condition into ``done``."""
    if dk._done(state):
        return
    queues = ctx.queues
    q, l = queues.priority.shape
    rr = ctx.max_rounds
    fresh = (state.adm_k[:, :, 0] >= 0) & (state.adm_round < 0)
    state.adm_round.copy_(torch.where(fresh, state.round_idx, state.adm_round))
    state.total.add_(1)
    cursor, stuck, alive = state.cursor, state.stuck, state.alive
    rem = (cursor < queues.qlen) & alive
    quiesced = not bool((rem & ~stuck).any())
    if quiesced or int(state.cycle.item()) >= ctx.chunk_cycles:
        ri = min(int(state.round_idx.item()), rr - 1)
        state.r_cursor[ri] = cursor
        state.r_stuck[ri] = stuck | ~alive
        state.r_cycles[ri] = state.cycle[0]
        state.r_usage[ri] = state.local
        alive &= ~stuck
        state.g_start.zero_()
        state.retries.zero_()
        state.no_prog.zero_()
        stuck.zero_()
        q_idx = torch.arange(q, device=cursor.device)
        budget = state.cap_suffix[q_idx, cursor.clamp_max(l - 1).long()]
        state.cap.copy_(torch.where((cursor < queues.qlen) & alive, budget, 0))
        state.round_idx.add_(1)
        state.cycle.zero_()
    more = ((cursor < queues.qlen) & ~stuck & alive).any() & (state.round_idx[0] < rr)
    state.done.copy_((~more).to(I32).reshape(1))


def megaloop_boundary(ctx: DrainContext, state: MegaloopState, buf: CycleBuffers) -> None:
    """Kernel 6: the round boundary (one block striding over the
    queues and the usage snapshot)."""
    if not state.local.is_cuda:
        return megaloop_boundary_plain(ctx, state, buf)
    dk._launch(KERNEL, ctx, state, buf)


def megaloop_cycle(ctx: DrainContext, state: MegaloopState, buf: CycleBuffers) -> None:
    """One megaloop cycle: the plain drain cycle, then the boundary."""
    dk.drain_cycle(ctx, state, buf)
    megaloop_boundary(ctx, state, buf)


def solve_drain_megaloop(
    tree: QuotaTree,
    local_usage: torch.Tensor,  # int64[N, FR] starting leaf usage
    queues: DrainQueues,
    paths: torch.Tensor,  # int32[N, D+1]
    cap_suffix: torch.Tensor,  # int32[Q, L] suffix retry budgets
    n_segments: int,
    n_steps: int,
    chunk_cycles: int,
    max_rounds: int,
    seg_id=None,  # host copy of queues.seg_id
) -> MegaloopResult:
    """Up to ``max_rounds`` rounds of at most ``chunk_cycles`` cycles.
    On the card every cycle of that bound is enqueued with no host read
    (up to dk.ENQUEUE_ALL_CYCLES; beyond it the flag is read every few
    cycles), so nothing here waits for the card."""
    bound = int(chunk_cycles) * int(max_rounds)
    ctx = DrainContext.build(
        tree, queues, paths, n_segments, n_steps, bound, seg_id=seg_id,
        chunk_cycles=int(chunk_cycles), max_rounds=int(max_rounds),
    )
    state = MegaloopState.initial_rounds(local_usage, queues, cap_suffix, int(max_rounds))
    buf = CycleBuffers.empty(local_usage, queues)
    dk.run_cycles(ctx, state, buf, megaloop_cycle, bound)
    return result_of(state)


def _solve_drain_megaloop_packed(
    tree, local_usage, queues, paths, cap_suffix,
    n_segments: int, n_steps: int, chunk_cycles: int, max_rounds: int, seg_id=None,
) -> torch.Tensor:
    """solve_drain_megaloop with the whole log flattened into ONE int64
    vector: K rounds of decisions retrieved in a single fetch."""
    return pack_megaloop(solve_drain_megaloop(
        tree, local_usage, queues, paths, cap_suffix,
        n_segments, n_steps, chunk_cycles, max_rounds, seg_id=seg_id,
    ))


def result_of(state: MegaloopState) -> MegaloopResult:
    """The log a megaloop run left in its state."""
    return MegaloopResult(
        admitted_k=state.adm_k,
        admitted_cycle=state.adm_cycle,
        admitted_round=state.adm_round,
        round_cursor=state.r_cursor,
        round_stuck=state.r_stuck,
        round_cycles=state.r_cycles,
        round_usage=state.r_usage,
        rounds=state.round_idx,
        cycles=state.total,
    )


def pack_megaloop(r: MegaloopResult) -> torch.Tensor:
    """The log as ONE int64 vector (the JAX packed layout)."""
    return torch.cat(
        [
            r.admitted_k.reshape(-1).to(I64),
            r.admitted_cycle.reshape(-1).to(I64),
            r.admitted_round.reshape(-1).to(I64),
            r.round_cursor.reshape(-1).to(I64),
            r.round_stuck.reshape(-1).to(I64),
            r.round_cycles.reshape(-1).to(I64),
            r.round_usage.reshape(-1),
            r.rounds.reshape(1).to(I64),
            r.cycles.reshape(1).to(I64),
        ]
    )

