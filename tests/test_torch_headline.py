"""The headline drain (bench.py's 50k pending x 1000 ClusterQueues,
seed 0) in both packages.

- kueue_tpu_torch/perf/headline.py builds exactly bench.py's cluster
  and backlog (same RNG draw order);
- the JAX package's headline drain gives the counts and the decision
  digest that chip_smoke.py holds the port to on the card;
- the port's plain CPU run of the same drain equals it exactly.
"""

import numpy as np
import pytest

from kueue_tpu.core.drain import run_drain as jax_run_drain
from kueue_tpu.core.snapshot import take_snapshot as jax_take_snapshot
from kueue_tpu_torch.core.drain import run_drain as port_run_drain
from kueue_tpu_torch.core.snapshot import take_snapshot as port_take_snapshot
from kueue_tpu_torch.perf import headline

from tests.test_torch_drain import _view


def _cq_view(cq):
    return (
        cq.name,
        cq.cohort,
        tuple(
            (rg.covered_resources,
             tuple((fq.name, tuple(sorted(
                 (r, q.nominal, q.borrowing_limit, q.lending_limit)
                 for r, q in fq.resources.items()))) for fq in rg.flavors))
            for rg in cq.resource_groups
        ),
    )


def _wl_view(wl, cq):
    return (
        wl.name, cq, wl.queue_name, wl.priority, wl.creation_time,
        tuple((ps.name, ps.count, tuple(sorted(ps.requests.items())))
              for ps in wl.pod_sets),
    )


def test_headline_generators_match_bench():
    import bench

    rng_j = np.random.default_rng(headline.HEADLINE_SEED)
    jcache, _ = bench.build_cluster(rng_j)
    jpending = bench.build_backlog(rng_j)
    rng_p = np.random.default_rng(headline.HEADLINE_SEED)
    pcache = headline.build_cluster(rng_p)
    ppending = headline.build_backlog(rng_p)
    assert (headline.N_CQ, headline.N_COHORT, headline.N_FLAVORS,
            headline.WL_PER_CQ) == (bench.N_CQ, bench.N_COHORT,
                                    bench.N_FLAVORS, bench.WL_PER_CQ)
    assert sorted(pcache.flavors) == sorted(jcache.flavors)
    assert sorted(pcache.cluster_queues) == sorted(jcache.cluster_queues)
    for name, cached in jcache.cluster_queues.items():
        assert _cq_view(pcache.cluster_queues[name].model) == _cq_view(cached.model)
    assert [_wl_view(w, c) for w, c in ppending] == [_wl_view(w, c) for w, c in jpending]


@pytest.fixture(scope="module")
def jax_headline_outcome():
    import bench

    rng = np.random.default_rng(headline.HEADLINE_SEED)
    cache, _ = bench.build_cluster(rng)
    pending = bench.build_backlog(rng)
    return jax_run_drain(
        jax_take_snapshot(cache), pending, cache.flavors,
        max_cells=headline.HEADLINE_MAX_CELLS,
    )


def test_jax_headline_drain_gives_the_expected_digest(jax_headline_outcome):
    """The constants chip_smoke.py holds the port to on the card come
    from the JAX package."""
    assert headline.outcome_summary(jax_headline_outcome) == headline.HEADLINE_EXPECT


def test_port_headline_drain_on_cpu_matches(jax_headline_outcome):
    rng = np.random.default_rng(headline.HEADLINE_SEED)
    cache = headline.build_cluster(rng)
    pending = headline.build_backlog(rng)
    out = port_run_drain(
        port_take_snapshot(cache), pending, cache.flavors,
        max_cells=headline.HEADLINE_MAX_CELLS, device="cpu",
    )
    assert headline.outcome_summary(out) == headline.HEADLINE_EXPECT
    assert _view(out) == _view(jax_headline_outcome)
