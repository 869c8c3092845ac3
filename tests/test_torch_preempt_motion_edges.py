"""The plain versions the preempt drain's two redesigned kernels are held
to on the card (the victim search, ``drain_preempt_search``, B10a; the
cycle's end and queue motion, ``drain_preempt_motion``, B10c, which also
ends every cycle of the fair-preempt drain) against the JAX package at
the shapes that reach the new designs' edges, exactly (tolerance 0), on
the same seeded inputs: the port's drain (``run_drain_preempt``,
device="cpu") against the JAX package's on ``perf.cases.MOTION_EDGES``
and ``SEARCH_EDGES``, and the fair-preempt drain's on
``fair_preempt_spec(1)``. Each port run records, from the plain steps'
inputs and outputs, the edges it meets, and the test asserts its case's:

- the cycle's end: the stagnation freeze (no head advanced and nothing
  evicted for 2 x max(retry cap) cycles), an untrusted search freezing
  its queue, a retry budget reaching its cap, an eviction reactivating
  its root cohort's parked entries (also one before position 32 while
  the queue's cursor is past it), ``max_cycles`` ending a drain with
  live queues, the fair panels' fill of an admitted entry's slot;
- the search: ladder cases a (no other-ClusterQueue candidate), b
  (borrowWithinCohort) and c (reclaim without borrowing, then the
  same-queue attempt), a candidate at or above the borrowWithinCohort
  threshold, a search truncated at ``search_width`` that misses and one
  that hits, an attempt-1 miss that taints an attempt-2 success, an
  attempt 2 that succeeds, paths deeper than the four levels the
  kernel's ladder holds in registers, and the widest shape (P*C = 32,
  a window of 512), whose candidates the kernel reads from device
  memory.

The card twins (``tests/test_torch_cuda.py``) hold both kernels to these
plain versions at every launch on the same cases.
"""

import pytest
import torch

from kueue_tpu_torch.ops import drain_kernel as tdk
from kueue_tpu_torch.perf import cases

from tests.test_torch_fair_preempt_drain import both_drains as fair_both_drains
from tests.test_torch_preempt_drain import both_drains, view

SEARCH = {"case a", "case b", "case c", "borrowWithinCohort threshold", "truncated miss",
          "truncated hit", "attempt 2 succeeds", "attempt-1 miss taints attempt 2"}
# the edges each case must meet
EXPECT = {
    "stagnation": {"stagnation freeze", "untrusted freeze", "retry cap", "reactivation"}
    | SEARCH,
    "max_cycles": {"max_cycles ends", "untrusted freeze", "reactivation"},
    "past 32 entries": {"reactivation past 32"},
    "window of 2": SEARCH - {"truncated hit"},
    "deep forest": {"case a", "case b", "case c", "borrowWithinCohort threshold"},
    "widest shape": {"case a", "case b", "case c", "borrowWithinCohort threshold"},
}


def motion_edges(ctx, state, buf, seen) -> None:
    """The edges of one drain_preempt_motion call, from its inputs."""
    queues = ctx.queues
    q, l = queues.priority.shape
    rows = torch.arange(q)
    active = (state.cursor < queues.qlen) & state.alive
    cur = state.cursor.clamp_max(l - 1).long()
    pre_skipped = buf.psuccess & ~buf.preempt_ok
    undecided = active & ~buf.is_fit & ~buf.preempt_ok & ~pre_skipped
    if bool((buf.untrusted & active & ~state.stuck).any()):
        seen.add("untrusted freeze")
    capped = undecided & buf.pend & (state.retries >= state.cap) & ~state.stuck & ~buf.untrusted
    if bool(capped.any()):
        seen.add("retry cap")
    status = torch.where(buf.admitted, 2, torch.where(undecided & ~buf.pend, 1, 0))
    advanced = active & (status != 0)
    no_prog = 0 if bool(advanced.any() | buf.ev_now.any()) else int(state.no_prog) + 1
    stuck = (state.stuck | buf.untrusted | capped) & ~advanced
    if no_prog >= 2 * int(state.cap.max()) and bool((active & ~advanced & ~stuck).any()):
        seen.add("stagnation freeze")
    seg = queues.seg_id
    released = buf.ev_now.any(dim=1)[seg.clamp_min(0).long()] & (seg >= 0)
    st = state.status.clone()
    st[rows, cur] = torch.where(active, status.to(st.dtype), st[rows, cur])
    if bool((released[:, None] & (st == 1)).any()):
        seen.add("reactivation")
    # a parked entry before position 32 reactivated while the head's new
    # status or another parked entry lies past it
    late = (active & (cur >= 32)) | (st[:, 32:] == 1).any(dim=1)
    if bool((released & (st[:, :32] == 1).any(dim=1) & late).any()):
        seen.add("reactivation past 32")
    slot = ctx.preempt.victims.entry_slot[rows, cur]
    if ctx.fair_preempt is not None and bool((buf.admitted & active & (slot >= 0)).any()):
        seen.add("fair-panel fill")


def search_edges(run, seen) -> None:
    """The edges of one drain_preempt_search_plain call (``run``), from
    the pool eligibility, compactions and attempts it makes."""
    pools, calls = [], []
    pool0, compact0, solve0 = (tdk._pool_eligibility, tdk._compact_candidates,
                               tdk.solve_preempt)

    def pool(*args):
        pools.append(pool0(*args))
        return pools[-1]

    def compact(cand_ord, width):
        comp, over = compact0(cand_ord, width)
        calls.append({"over": over})
        return comp, over

    def solve(p, depth, n_cand):
        r = solve0(p, depth, n_cand)
        calls[-1].update(p=p, fits=r.fits)
        return r

    tdk._pool_eligibility, tdk._compact_candidates, tdk.solve_preempt = pool, compact, solve
    try:
        run()
    finally:
        tdk._pool_eligibility, tdk._compact_candidates, tdk.solve_preempt = pool0, compact0, solve0
    (a1, a2), elig = calls, pools[0]
    p, row1, found1 = a1["p"], a1["p"].row_valid, a1["fits"]
    row2, found2 = a2["p"].row_valid, a2["fits"]
    case_b, case_c = row1 & p.has_thr, row1 & ~p.allow_borrow
    flags = {
        "case a": row1 & ~(elig.elig & ~elig.same_q).any(dim=1),
        "case b": case_b,
        "case c": case_c,
        "borrowWithinCohort threshold": (case_b[:, None] & p.cvalid & ~p.csame
                                         & (p.cprio >= p.thr[:, None])).any(dim=1),
        "truncated miss": row1 & a1["over"] & ~found1,
        "truncated hit": row1 & a1["over"] & found1,
        "attempt 2 succeeds": row2 & ~found1 & found2,
        "attempt-1 miss taints attempt 2": row2 & a1["over"] & ~found1 & found2,
    }
    seen.update(name for name, hit in flags.items() if bool(hit.any()))


def recording(monkeypatch, seen) -> None:
    """The port's plain search and motion record their edges as they
    run (the CPU drain calls them through the module)."""
    motion0, search0 = tdk.drain_preempt_motion_plain, tdk.drain_preempt_search_plain

    def motion(ctx, state, buf):
        if not tdk._done(state):
            motion_edges(ctx, state, buf, seen)
        motion0(ctx, state, buf)
        live = bool(((state.cursor < ctx.queues.qlen) & ~state.stuck).any())
        if tdk._done(state) and live and int(state.cycle) >= ctx.max_cycles:
            seen.add("max_cycles ends")

    def search(ctx, state, buf):
        if tdk._done(state):
            return search0(ctx, state, buf)
        search_edges(lambda: search0(ctx, state, buf), seen)

    monkeypatch.setattr(tdk, "drain_preempt_motion_plain", motion)
    monkeypatch.setattr(tdk, "drain_preempt_search_plain", search)


def _edge_drain(monkeypatch, spec_kw, drain_kw):
    seen = set()
    recording(monkeypatch, seen)
    jout, pout, _, _ = both_drains(cases.preempt_spec(**spec_kw), names=True,
                                   panel_widths=(drain_kw["search_width"],), **drain_kw)
    assert view(pout) == view(jout)
    return seen, pout


@pytest.mark.parametrize("edge", sorted(cases.MOTION_EDGES))
def test_preempt_drain_matches_jax_at_the_motion_edges(edge, monkeypatch):
    seen, pout = _edge_drain(monkeypatch, *cases.MOTION_EDGES[edge])
    assert seen >= EXPECT[edge], EXPECT[edge] - seen
    assert pout.admitted and pout.evictions


@pytest.mark.parametrize("edge", sorted(cases.SEARCH_EDGES))
def test_preempt_drain_matches_jax_at_the_search_edges(edge, monkeypatch):
    seen, pout = _edge_drain(monkeypatch, *cases.SEARCH_EDGES[edge])
    assert seen >= EXPECT[edge], EXPECT[edge] - seen
    assert pout.admitted and pout.evictions


def test_fair_preempt_drain_matches_jax_at_the_panel_fill(monkeypatch):
    """The fair-preempt drain ends its cycles with the same kernel: an
    admitted entry's slot takes its row of the fair panels."""
    seen = set()
    recording(monkeypatch, seen)
    jout, pout = fair_both_drains(cases.fair_preempt_spec(1), names=True, max_cycles=12)
    assert view(pout) == view(jout)
    assert "fair-panel fill" in seen and pout.preempted
