"""The interactive cycle at the headline size (bench.py's cluster and
50k backlog, seed 0, 1000 heads a cycle) in both packages:

- the JAX package's Scheduler gives kueue_tpu_torch.perf.cycle's
  CYCLE_EXPECT over 16 cycles (the constants chip_smoke.py holds the
  port to on the card);
- the port's Scheduler on the CPU makes the same decisions, cycle for
  cycle.
"""

import numpy as np
import pytest

from kueue_tpu.core.scheduler import Scheduler as JaxScheduler
from kueue_tpu.core.snapshot import take_snapshot as jax_take_snapshot
from kueue_tpu_torch.core.snapshot import take_snapshot
from kueue_tpu_torch.perf import cycle, headline


@pytest.fixture(scope="module")
def jax_run():
    import bench

    rng = np.random.default_rng(headline.HEADLINE_SEED)
    cache, mgr = bench.build_cluster(rng)
    for wl, _ in bench.build_backlog(rng):
        mgr.add_or_update_workload(wl)
    sched = JaxScheduler(queues=mgr, cache=cache, clock=mgr.clock, use_solver=True)
    records = cycle.run_cycles(sched)
    return records, cycle.cycle_summary(records, cache, jax_take_snapshot)


@pytest.fixture(scope="module")
def port_run():
    sched, cache = cycle.build_headline_scheduler(device="cpu")
    records = cycle.run_cycles(sched)
    return records, cycle.cycle_summary(records, cache, take_snapshot), sched


def test_jax_headline_cycles_give_the_expected_digest(jax_run):
    _, summary = jax_run
    assert summary == cycle.CYCLE_EXPECT


def test_port_headline_cycles_on_cpu_match(jax_run, port_run):
    records, summary, sched = port_run
    assert summary == cycle.CYCLE_EXPECT
    assert records == jax_run[0]
    # every cycle nominated on the solver: cycle 0 resolved by the
    # phase-2 scan, the rest by the host loop over its nominations
    assert [r["resolution"] for r in records] == ["device"] + ["host"] * (cycle.CYCLES - 1)
    assert sched.guard.divergences == 0 and sched.guard.failovers == 0
