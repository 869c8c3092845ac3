"""The K-round megaloop of kueue_tpu_torch against kueue_tpu's, on the
CPU (the plain torch versions of the six per-cycle launches; int64,
tolerance 0):

- ``launch_drain_megaloop(device="cpu").fetch()`` against the JAX
  package's on tests/test_solver_path.random_spec seeds 0-2 at
  chunk_cycles 2 and 3: rounds, cycles, truncated, and each round's
  outcome_signature, undecided and final_usage;
- the same log against the port's numpy twin (run_drain_megaloop_host)
  and against the port's serial chain of launch_drain(max_cycles=chunk);
- truncation at chunk_cycles=1, max_rounds=2;
- perf.cases.mixed_spec(7), whose stuck queues retire at boundaries;
- the packed log (ops/megaloop_kernel._solve_drain_megaloop_packed)
  against the JAX packed log on the same numpy plan tensors;
- ResidentEncoder: refresh byte-identical to a fresh encode, and adopt
  after a fully committed launch.
"""

import numpy as np
import pytest
import torch

from kueue_tpu._jax import jnp
from kueue_tpu.core import drain as jd
from kueue_tpu.core.pipeline import outcome_signature as jax_signature
from kueue_tpu.ops.megaloop_kernel import solve_drain_megaloop_packed_jit
from kueue_tpu_torch import interop
from kueue_tpu_torch.core import drain as pd
from kueue_tpu_torch.core.encode import ResidentEncoder, device_arrays, encode_snapshot
from kueue_tpu_torch.core.pipeline import outcome_signature as port_signature
from kueue_tpu_torch.core.pipeline import speculative_snapshot
from kueue_tpu_torch.ops import megaloop_kernel as ml
from kueue_tpu_torch.perf.cases import mixed_spec
from kueue_tpu_torch.perf.lockstep import MEGALOOP_KERNELS, lockstep_megaloop

from tests.test_solver_path import random_spec
from tests.test_torch_drain import _both
from tests.test_torch_drain_kernel import _jax_inputs, _plan_inputs


def _round_view(outcome, signature):
    sig = signature(outcome)
    sig["undecided"] = [(wl.key, cq) for wl, cq in outcome.undecided]
    return sig


def _assert_logs_equal(a, b, sig_a, sig_b):
    assert (a.n_rounds, a.cycles, a.truncated) == (b.n_rounds, b.cycles, b.truncated)
    assert len(a.rounds) == len(b.rounds)
    for r, (x, y) in enumerate(zip(a.rounds, b.rounds)):
        assert _round_view(x, sig_a) == _round_view(y, sig_b), r
        np.testing.assert_array_equal(x.final_usage, y.final_usage, err_msg=str(r))


def _launch_both(spec, **kw):
    jsnap, jpending, jcache, psnap, ppending, pcache, ts = _both(spec)
    j = jd.launch_drain_megaloop(jsnap, jpending, jcache.flavors, timestamp_fn=ts, **kw)
    p = pd.launch_drain_megaloop(
        psnap, ppending, pcache.flavors, timestamp_fn=ts, device="cpu", **kw
    )
    return j.fetch(), p.fetch(), (psnap, ppending, pcache, ts)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("chunk,rounds", [(2, 16), (3, 8)])
def test_megaloop_matches_jax(seed, chunk, rounds):
    j, p, _ = _launch_both(
        random_spec(seed, workloads_per_cq=8), chunk_cycles=chunk, max_rounds=rounds
    )
    assert p.n_rounds >= 2, "too shallow to exercise the round boundary"
    _assert_logs_equal(p, j, port_signature, jax_signature)


@pytest.mark.parametrize("seed", range(3))
def test_megaloop_matches_host_twin_and_serial_chain(seed):
    spec = random_spec(seed, workloads_per_cq=8)
    _, p, (snap, pending, cache, ts) = _launch_both(spec, chunk_cycles=3, max_rounds=8)
    host = pd.run_drain_megaloop_host(
        snap, pending, cache.flavors, timestamp_fn=ts, chunk_cycles=3, max_rounds=8
    )
    _assert_logs_equal(p, host, port_signature, port_signature)

    s, q = snap, pending
    for r, round_out in enumerate(p.rounds):
        serial = pd.launch_drain(
            s, q, cache.flavors, timestamp_fn=ts, max_cycles=3, device="cpu"
        ).fetch()
        assert _round_view(serial, port_signature) == _round_view(round_out, port_signature), r
        np.testing.assert_array_equal(serial.final_usage, round_out.final_usage)
        if not serial.undecided:
            break
        s, q = speculative_snapshot(s, serial.final_usage), serial.undecided


def test_round_budget_truncates_the_log():
    j, p, _ = _launch_both(
        random_spec(0, workloads_per_cq=8), chunk_cycles=1, max_rounds=2
    )
    assert p.truncated and p.n_rounds == 2 and p.rounds[-1].undecided
    _assert_logs_equal(p, j, port_signature, jax_signature)


def test_stuck_queues_retire_at_boundaries():
    """mixed_spec(7) freezes PendingFlavors queues as stuck (its plain
    drain runs 60 cycles): at 56 cycles a round, the second round's
    boundary retires them and reports their entries as terminal
    fallback, as the JAX package does."""
    j, p, _ = _launch_both(mixed_spec(7), chunk_cycles=56, max_rounds=6)
    assert p.n_rounds == 2
    _assert_logs_equal(p, j, port_signature, jax_signature)
    terminal = sum(len(r.fallback) - len(r.undecided) for r in p.rounds)
    assert terminal > 0, "no queue went stuck: the case lost its coverage"


@pytest.mark.parametrize("seed,chunk,rounds", [(0, 2, 16), (1, 3, 8), (2, 1, 2)])
def test_packed_log_matches_jax(seed, chunk, rounds):
    enc, queues_np, plan = _plan_inputs(random_spec(seed, workloads_per_cq=8))
    cap = jd._cap_suffix_of(plan)
    j_flat = np.asarray(
        solve_drain_megaloop_packed_jit(
            *_jax_inputs(enc, queues_np), jnp.asarray(cap),
            n_segments=plan.n_segments, n_steps=plan.n_steps,
            chunk_cycles=chunk, max_rounds=rounds,
        )
    )
    tree, queues, local, paths = interop.drain_inputs(enc, queues_np, "cpu")
    t_flat = ml._solve_drain_megaloop_packed(
        tree, local, queues, paths, torch.as_tensor(cap),
        plan.n_segments, plan.n_steps, chunk, rounds,
    )
    assert t_flat.dtype == torch.int64
    np.testing.assert_array_equal(t_flat.numpy(), j_flat)


def test_lockstep_megaloop_runs_every_kernel_step():
    """The harness chip_smoke.py runs on the card, here with both sides
    plain: every step of every cycle compared, ending as the solve."""
    enc, queues_np, plan = _plan_inputs(mixed_spec(7, workloads_per_cq=4))
    cap = torch.as_tensor(jd._cap_suffix_of(plan))
    tree, queues, local, paths = interop.drain_inputs(enc, queues_np, "cpu")
    errs = {}
    _, state, cycles = lockstep_megaloop(
        tree, local, queues, paths, cap, plan.n_segments, plan.n_steps, 3, 8, errs
    )
    assert set(errs) == set(MEGALOOP_KERNELS) and not any(errs.values())
    packed = ml.pack_megaloop(ml.result_of(state))
    expect = ml._solve_drain_megaloop_packed(
        tree, local, queues, paths, cap, plan.n_segments, plan.n_steps, 3, 8
    )
    assert torch.equal(packed, expect) and cycles == int(state.total.item())


def _fresh(snapshot):
    tree, paths, _ = device_arrays(encode_snapshot(snapshot), "cpu")
    return tree, paths, torch.as_tensor(snapshot.local_usage)


def _assert_same(got, want):
    (t1, p1, u1), (t2, p2, u2) = got, want
    for f in ("parent", "level_mask", "nominal", "lending_limit", "borrowing_limit"):
        assert torch.equal(getattr(t1, f), getattr(t2, f)), f
        assert getattr(t1, f).dtype == getattr(t2, f).dtype, f
    assert torch.equal(p1, p2) and p1.dtype == p2.dtype
    assert torch.equal(u1, u2) and u1.dtype == u2.dtype


def test_resident_refresh_is_byte_identical_to_a_fresh_encode():
    *_, snap, pending, cache, ts = _both(random_spec(1, workloads_per_cq=8))
    res = ResidentEncoder(device="cpu")
    _assert_same(res.refresh(snap), _fresh(snap))
    # a few rows change: a row scatter, not a re-upload
    usage = snap.local_usage.copy()
    usage[[0, 2]] += 1000
    spec = speculative_snapshot(snap, usage)
    _assert_same(res.refresh(spec), _fresh(spec))
    assert (res.full_encodes, res.delta_rounds, res.delta_rows) == (1, 1, 2)
    # a launch through the resident buffers decides as a fresh one
    a = pd.launch_drain(spec, pending, cache.flavors, timestamp_fn=ts,
                        resident=res, device="cpu").fetch()
    b = pd.launch_drain(spec, pending, cache.flavors, timestamp_fn=ts,
                        device="cpu").fetch()
    assert port_signature(a) == port_signature(b)


def test_resident_adopts_a_fully_committed_launch():
    *_, snap, pending, cache, ts = _both(random_spec(2, workloads_per_cq=8))
    res = ResidentEncoder(device="cpu")
    launch = pd.launch_drain_megaloop(
        snap, pending, cache.flavors, timestamp_fn=ts, chunk_cycles=8, max_rounds=16,
        resident=res, device="cpu",
    )
    log = launch.fetch()
    assert not log.truncated
    last = log.rounds[-1]
    res.adopt(launch.usage_dev(log.n_rounds - 1), last.final_usage)
    after = speculative_snapshot(snap, last.final_usage)
    rows_before = res.delta_rows
    _assert_same(res.refresh(after), _fresh(after))
    assert res.adopts == 1 and res.delta_rows == rows_before  # zero rows shipped
