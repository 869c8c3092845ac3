"""The batched fair-sharing victim search of the admission cycle
(kernel B9) in both packages, exactly (int64, tolerance 0):

- B9's plain version (ops/fair_preempt_kernel.solve_fair) against the
  JAX package's solve_fair_packed_jit on the problem its
  lower_fair_preemption builds, and the port's
  batched_fair_get_targets(device="cpu") against the JAX package's and
  against the port's host Preemptor, on tests/test_fair_preempt.py's
  seeds 0-37 with every strategy stack, deep trees and two resources
  (its build_fair_cluster and fair_items run a second time with this
  package's classes in place of the JAX package's);
- split_panel_rows against the JAX function;
- bench.py's fair stage (perf/fairpreempt.build_fair_search) gives
  FAIR_SEARCH_EXPECT in both packages, and batched_get_targets routes
  a fair preemptor there.
"""

import numpy as np
import pytest

import kueue_tpu.core.flavor_assigner as jax_fa_mod
import kueue_tpu.models as jax_models_mod
import tests.test_fair_preempt as tfp
from kueue_tpu import models as jax_models
from kueue_tpu._jax import jnp
from kueue_tpu.core import flavor_assigner as jax_fa
from kueue_tpu.core import preempt_batch as jax_pb
from kueue_tpu.core import snapshot as jax_snapshot
from kueue_tpu.core.preemption import (
    LESS_THAN_INITIAL_SHARE,
    LESS_THAN_OR_EQUAL_TO_FINAL_SHARE,
)
from kueue_tpu.core.preemption import Preemptor as JaxPreemptor
from kueue_tpu.core.solver import _bucket
from kueue_tpu.ops.fair_preempt_kernel import FairProblem as JaxProblem
from kueue_tpu.ops.fair_preempt_kernel import solve_fair_packed_jit
from kueue_tpu.ops.fair_preempt_kernel import split_panel_rows as jax_split
from kueue_tpu.utils.clock import FakeClock as JaxClock
from kueue_tpu_torch import models as port_models
from kueue_tpu_torch.core import cache as port_cache
from kueue_tpu_torch.core import flavor_assigner as port_fa
from kueue_tpu_torch.core import snapshot as port_snapshot
from kueue_tpu_torch.core import workload_info as port_workload_info
from kueue_tpu_torch.core.preempt_batch import (
    batched_fair_get_targets,
    batched_get_targets,
    fair_tiers,
    lower_fair_preemption,
)
from kueue_tpu_torch.core.preemption import Preemptor
from kueue_tpu_torch.interop import fair_problem
from kueue_tpu_torch.models import cohort as port_cohort
from kueue_tpu_torch.models import workload as port_workload
from kueue_tpu_torch.ops.fair_preempt_kernel import solve_fair_packed, split_panel_rows
from kueue_tpu_torch.perf import fairpreempt as fp
from kueue_tpu_torch.utils.clock import FakeClock

from tests.test_torch_preempt_drain import jax_api

BOTH = (LESS_THAN_OR_EQUAL_TO_FINAL_SHARE, LESS_THAN_INITIAL_SHARE)
# tests/test_fair_preempt.py's sweeps: (seed, strategies, cluster options)
SWEEP = (
    [(s, BOTH, {}) for s in range(12)]
    + [(s, (LESS_THAN_OR_EQUAL_TO_FINAL_SHARE,), {}) for s in range(12, 18)]
    + [(s, (LESS_THAN_INITIAL_SHARE,), {}) for s in range(18, 24)]
    + [(s, BOTH, {"deep": True, "n_cohorts": 2}) for s in range(24, 32)]
    + [(s, BOTH, {"n_res": 2}) for s in range(32, 38)]
)


def _port_scenario(monkeypatch, seed, **cluster_kw):
    """tests/test_fair_preempt.py's cluster and heads built with this
    package's classes: (snapshot, items)."""
    names = {
        "Cache": port_cache.Cache, "ResourceFlavor": port_models.ResourceFlavor,
        "Preemption": port_models.Preemption, "Cohort": port_cohort.Cohort,
        "FlavorQuotas": port_models.FlavorQuotas, "ClusterQueue": port_models.ClusterQueue,
        "ResourceGroup": port_models.ResourceGroup, "FairSharing": port_models.FairSharing,
        "Workload": port_models.Workload, "PodSet": port_workload.PodSet,
        "make_admission": port_workload_info.make_admission,
        "take_snapshot": port_snapshot.take_snapshot,
        "FlavorAssigner": port_fa.FlavorAssigner,
        "PreemptionPolicy": port_models.PreemptionPolicy,
        "ReclaimWithinCohortPolicy": port_models.ReclaimWithinCohortPolicy,
    }
    with monkeypatch.context() as m:
        for name, obj in names.items():
            m.setattr(tfp, name, obj)
        # the builders import these two inside their bodies
        m.setattr(jax_models_mod, "WorkloadConditionType", port_models.WorkloadConditionType)
        m.setattr(jax_fa_mod, "Mode", port_fa.Mode)
        cache, cq_names = tfp.build_fair_cluster(seed, **cluster_kw)
        return tfp.fair_items(cache, cq_names, seed)


def _target_sets(results):
    return [sorted((t.workload.workload.name, t.reason) for t in res) for res in results]


@pytest.mark.parametrize("seed,strategies,kw", SWEEP)
def test_fair_search_matches_jax_and_the_host(seed, strategies, kw, monkeypatch):
    jcache, jcq = tfp.build_fair_cluster(seed, **kw)
    jsnap, jitems = tfp.fair_items(jcache, jcq, seed)
    psnap, pitems = _port_scenario(monkeypatch, seed, **kw)
    assert [wl.name for wl, _, _ in pitems] == [wl.name for wl, _, _ in jitems]
    if not jitems:
        return  # the JAX test skips this seed: no preempt-mode head
    jpre = JaxPreemptor(JaxClock(0.0), enable_fair_sharing=True, fs_strategies=strategies)
    ppre = Preemptor(FakeClock(0.0), enable_fair_sharing=True, fs_strategies=strategies)

    # B9's plain version on the JAX lowering, every panel tier
    arrays, meta = jax_pb.lower_fair_preemption(jsnap, jitems, jpre)
    parrays, pmeta = lower_fair_preemption(psnap, pitems, ppre)
    assert (arrays is None) == (parrays is None)
    if arrays is not None:
        for k in ("s", "cu", "v", "r", "depth", "strategy1", "has_second", "fallback"):
            assert pmeta[k] == meta[k], k
        for k, x in arrays.items():
            np.testing.assert_array_equal(parrays[k], x, err_msg=k)
        for rows, v_dim, padded in fair_tiers(arrays, meta):
            kw2 = dict(depth=meta["depth"], n_cand=v_dim, n_local=meta["s"], n_res=meta["r"],
                       strategy1=meta["strategy1"], has_second=meta["has_second"])
            want = np.asarray(solve_fair_packed_jit(
                JaxProblem(**{k: jnp.asarray(x) for k, x in padded.items()}), **kw2))
            got = solve_fair_packed(fair_problem(padded, "cpu"), **kw2).numpy()
            np.testing.assert_array_equal(got, want)

    # the batched search against the JAX package's and the host's
    got = _target_sets(batched_fair_get_targets(psnap, pitems, ppre, device="cpu"))
    assert got == _target_sets(jax_pb.batched_fair_get_targets(jsnap, jitems, jpre))
    host = [ppre.get_targets(wl, cq, a, psnap) for wl, cq, a in pitems]
    assert got == _target_sets(host)


def test_the_sweep_preempts_and_splits_panels(monkeypatch):
    """Across the sweep's default-strategy seeds some heads find victims,
    and some batch solves in two panel tiers."""
    victims = tiers = 0
    for seed, strategies, kw in SWEEP[:12]:
        snap, items = _port_scenario(monkeypatch, seed, **kw)
        pre = Preemptor(FakeClock(0.0), enable_fair_sharing=True, fs_strategies=strategies)
        victims += sum(len(r) for r in batched_fair_get_targets(snap, items, pre, device="cpu"))
        arrays, meta = lower_fair_preemption(snap, items, pre)
        if arrays is not None:
            tiers = max(tiers, len(fair_tiers(arrays, meta)))
    assert victims > 0
    assert tiers == 2


@pytest.mark.parametrize("counts,v_full", [
    ([], 8), ([3], 4), ([1, 1, 1, 9], 16), ([2, 3, 4, 5, 30, 31], 32), ([7, 7, 7], 8),
    ([0, 0, 12], 16),
])
def test_split_panel_rows_matches_jax(counts, v_full):
    assert split_panel_rows(counts, v_full, _bucket) == jax_split(counts, v_full, _bucket)


def _jax_fair_api():
    return fp.fair_api(jax_api(), jax_models, jax_fa, jax_snapshot, jax_pb)


def test_jax_fair_search_gives_the_constant():
    snap, items, pre = fp.build_fair_search(np.random.default_rng(fp.SEARCH_SEED),
                                            api=_jax_fair_api())
    _, meta = jax_pb.lower_fair_preemption(snap, items, pre)
    res = jax_pb.batched_fair_get_targets(snap, items, pre)
    assert fp.search_summary(items, res, meta) == fp.FAIR_SEARCH_EXPECT


def test_port_fair_search_gives_the_constant():
    """bench.py's fair stage on the CPU: 256 heads in one launch, and
    batched_get_targets routes the fair preemptor to the same search."""
    snap, items, pre = fp.build_fair_search(np.random.default_rng(fp.SEARCH_SEED))
    _, meta = lower_fair_preemption(snap, items, pre)
    res = batched_fair_get_targets(snap, items, pre, device="cpu")
    assert fp.search_summary(items, res, meta) == fp.FAIR_SEARCH_EXPECT
    routed = batched_get_targets(snap, items, pre, device="cpu")
    assert _target_sets(routed) == _target_sets(res)
