"""The rest of the drain family at the headline (bench.py's 50k pending
x 1000 ClusterQueues, seed 0, max_cells=3) in both packages:

- the megaloop chain (perf/megaloop.py: chunk_cycles=8, max_rounds=8,
  relaunched over the last round's undecided backlog until a log is not
  truncated): the JAX package gives ``MEGALOOP_EXPECT``, and the port's
  CPU run equals it round for round; at bench.py's 4 x 16 the JAX
  package's chain reaches a fixed point on its third launch and never
  ends;
- the fair-sharing drain: the JAX package gives ``FAIR_EXPECT``, and
  the port's CPU run equals it.

chip_smoke.py holds the port on the card to the same constants.
"""

import numpy as np
import pytest

from kueue_tpu.core.drain import launch_drain_megaloop as jax_launch_megaloop
from kueue_tpu.core.drain import run_drain as jax_run_drain
from kueue_tpu.core.pipeline import speculative_snapshot as jax_speculative
from kueue_tpu.core.snapshot import take_snapshot as jax_take_snapshot
from kueue_tpu_torch.core.drain import launch_drain_megaloop as port_launch_megaloop
from kueue_tpu_torch.core.drain import run_drain as port_run_drain
from kueue_tpu_torch.core.pipeline import speculative_snapshot as port_speculative
from kueue_tpu_torch.core.snapshot import take_snapshot as port_take_snapshot
from kueue_tpu_torch.perf import headline, megaloop

from tests.test_torch_drain import _view


@pytest.fixture(scope="module")
def jax_headline():
    import bench

    rng = np.random.default_rng(headline.HEADLINE_SEED)
    cache, _ = bench.build_cluster(rng)
    return cache, bench.build_backlog(rng)


@pytest.fixture(scope="module")
def port_headline():
    rng = np.random.default_rng(headline.HEADLINE_SEED)
    cache = headline.build_cluster(rng)
    return cache, headline.build_backlog(rng)


@pytest.fixture(scope="module")
def jax_chain(jax_headline):
    cache, pending = jax_headline
    return megaloop.run_chain(
        jax_launch_megaloop, jax_speculative, jax_take_snapshot(cache), pending, cache.flavors
    )


def test_jax_megaloop_chain_gives_the_expected_digest(jax_chain):
    assert megaloop.chain_summary(jax_chain) == megaloop.MEGALOOP_EXPECT


def test_jax_chain_at_bench_setting_never_ends(jax_headline):
    """Why the chain is 8 x 8 and not bench.py's 4 x 16: at 4 cycles a
    round the JAX package's third launch admits nothing and leaves the
    backlog and the leaf usage as it found them, so the chain repeats
    it forever."""
    cache, pending = jax_headline
    readings = megaloop.chain_readings(
        jax_launch_megaloop, jax_speculative, jax_take_snapshot(cache), pending,
        cache.flavors, chunk_cycles=4, max_rounds=16, n_launches=3,
    )
    assert [r["rounds"] for r in readings] == [16, 16, 16]
    assert [r["truncated"] for r in readings] == [True, True, True]
    assert [r["fixed"] for r in readings] == [False, False, True]
    assert readings[2]["admitted"] == 0
    assert readings[1]["undecided"] == readings[2]["undecided"] > 0


def test_port_megaloop_chain_on_cpu_matches(jax_chain, port_headline):
    cache, pending = port_headline
    logs = megaloop.run_chain(
        port_launch_megaloop, port_speculative, port_take_snapshot(cache), pending,
        cache.flavors, device="cpu",
    )
    assert megaloop.chain_summary(logs) == megaloop.MEGALOOP_EXPECT
    for log, jlog in zip(logs, jax_chain):
        assert (log.n_rounds, log.cycles, log.truncated) == (
            jlog.n_rounds, jlog.cycles, jlog.truncated)
        for out, jout in zip(log.rounds, jlog.rounds):
            assert _view(out) == _view(jout)
            np.testing.assert_array_equal(out.final_usage, jout.final_usage)


@pytest.fixture(scope="module")
def jax_fair(jax_headline):
    cache, pending = jax_headline
    return jax_run_drain(
        jax_take_snapshot(cache), pending, cache.flavors,
        max_cells=headline.HEADLINE_MAX_CELLS, fair_sharing=True,
    )


def test_jax_fair_drain_gives_the_expected_digest(jax_fair):
    assert headline.outcome_summary(jax_fair) == headline.FAIR_EXPECT


def test_port_fair_drain_on_cpu_matches(jax_fair, port_headline):
    cache, pending = port_headline
    out = port_run_drain(
        port_take_snapshot(cache), pending, cache.flavors,
        max_cells=headline.HEADLINE_MAX_CELLS, fair_sharing=True, device="cpu",
    )
    assert headline.outcome_summary(out) == headline.FAIR_EXPECT
    assert _view(out) == _view(jax_fair)
