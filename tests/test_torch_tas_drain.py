"""The TAS drain in the port (kueue_tpu_torch.core.drain.run_drain_tas,
device="cpu": the plain torch versions of kernel B13's two launches)
against the JAX package's run_drain_tas, on the CPU, tolerance 0:

- tests/test_tas_drain.py's scenarios built in both packages from one
  spec: the five TestTASDrain cases, its randomized backlogs, and the
  widened scope (Preferred relaxing to the block, the multi-domain
  take at the top, Unconstrained splitting at the leaves, two flavors
  of different depth, tight quota), plus perf/cases.tas_spec (two
  flavors, plain queues riding along that reserve, a topology request
  on a non-TAS flavor parked in kernel): the same admitted workloads
  with their cycle and topology domains, parked, fallback, cycles,
  truncation and final leaf usage;
- run_drain_for_scope("tas") returning run_drain_tas's outcome;
- the placement step ``_tas_fit_and_place`` against the JAX one over
  seeded random forests in all three modes, with negative leaf
  capacity, gangs that do not fit and an all-masked flavor;
- tas-drain-10k (bench.py's tas_drain stage) at a cut; the full width
  (TAS_DRAIN_EXPECT, ~50 s a package on the CPU) under ``slow``.
"""

import numpy as np
import pytest

from kueue_tpu.core.drain import run_drain_tas as jax_run_drain_tas
from kueue_tpu.core.snapshot import take_snapshot as jax_take_snapshot
from kueue_tpu.ops import drain_kernel as jdk
from kueue_tpu_torch._torch import to_device
from kueue_tpu_torch.core import drain as pd
from kueue_tpu_torch.core.snapshot import take_snapshot as port_take_snapshot
from kueue_tpu_torch.ops import drain_kernel as pdk
from kueue_tpu_torch.perf import cases
from kueue_tpu_torch.perf import tas as pt
from kueue_tpu_torch.perf.tas import BLOCK, HOST, RACK

from tests.test_tas_drain import ALL_MODES, tas_spec as jax_tas_spec, two_flavor_spec
from tests.test_torch_tas import JAX


def env_spec(wls, n_cq=3, quota="999", two_flavors=False, blocks=2, racks=3, hosts=4):
    """tests/test_tas_drain.py's build_env (or build_env_two_flavors) and
    workloads in perf/tas.build_tas_env's spec form."""
    if two_flavors:
        nodes = [(f"a-{b}-{r}-{h}", {"pool": "a", BLOCK: f"b{b}", RACK: f"b{b}-r{r}",
                                     HOST: f"ha-{b}-{r}-{h}"}, {"cpu": 8000, "pods": 32})
                 for b in range(blocks) for r in range(racks) for h in range(hosts)]
        nodes += [(f"b-{r}-{h}", {"pool": "b", RACK: f"fr{r}", HOST: f"hb-{r}-{h}"},
                   {"cpu": 8000, "pods": 32}) for r in range(4) for h in range(3)]
        topologies = {"deep": (BLOCK, RACK, HOST), "flat": (RACK, HOST)}
        flavors = [("tas-a", "deep", {"pool": "a"}), ("tas-b", "flat", {"pool": "b"})]
        cqs = [(f"cq-{i}", "tas-a" if i % 2 == 0 else "tas-b", quota) for i in range(n_cq)]
    else:
        nodes = [(f"n-{b}-{r}-{h}", {BLOCK: f"b{b}", RACK: f"b{b}-r{r}", HOST: f"h-{b}-{r}-{h}"},
                  {"cpu": 8000, "pods": 32})
                 for b in range(blocks) for r in range(racks) for h in range(hosts)]
        topologies = {"default": (BLOCK, RACK, HOST)}
        flavors = [("tas-flavor", "default", {})]
        cqs = [(f"cq-{i}", "tas-flavor", quota) for i in range(n_cq)]
    workloads = [dict(name=w["name"], cq=w["lq"].replace("lq-", "cq-"), count=w["count"],
                      cpu=w["cpu"], mode=w.get("mode", "Required"), level=w["level"],
                      prio=w.get("prio", 0), t=w["t"]) for w in wls]
    return {"topologies": topologies, "flavors": flavors, "nodes": nodes, "cqs": cqs,
            "workloads": workloads}


def both(spec, **kw):
    """(JAX outcome, port outcome) of run_drain_tas over ``spec``."""
    je = pt.build_tas_env(spec, JAX)
    pe = pt.build_tas_env(spec)
    jo = jax_run_drain_tas(jax_take_snapshot(je.cache), je.pending, je.cache.flavors, je.tas,
                           timestamp_fn=je.ts_fn, **kw)
    po = pd.run_drain_tas(port_take_snapshot(pe.cache), pe.pending, pe.cache.flavors, pe.tas,
                          timestamp_fn=pe.ts_fn, device="cpu", **kw)
    return jo, po


def view(out):
    """Everything the drain decides, order-free."""
    return (pt.placements(out), sorted(wl.name for wl, _ in out.parked),
            sorted(wl.name for wl, _ in out.fallback), out.cycles, out.truncated,
            sorted(pt.leaf_usage(out).items()))


def check(spec, **kw):
    jo, po = both(spec, **kw)
    assert view(po) == view(jo)
    assert not po.fallback
    return po


W = dict
TAS_DRAIN_CASES = {
    "basic_rack_placement": ([
        W(name="w1", lq="lq-0", count=8, cpu="2", level=RACK, t=1.0),
        W(name="w2", lq="lq-1", count=4, cpu="2", level=RACK, t=2.0)], {}),
    "contended_rack_defers_to_next_cycle": ([
        W(name="w1", lq="lq-0", count=16, cpu="2", level=RACK, t=1.0),
        W(name="w2", lq="lq-1", count=16, cpu="2", level=RACK, t=2.0),
        W(name="w3", lq="lq-2", count=16, cpu="2", level=RACK, t=3.0)], {}),
    "block_level_gang": ([
        W(name="big", lq="lq-0", count=40, cpu="2", level=BLOCK, t=1.0),
        W(name="small", lq="lq-1", count=6, cpu="1", level=HOST, t=2.0)], {}),
    "quota_and_topology_interact": ([
        W(name="a1", lq="lq-0", count=8, cpu="2", level=RACK, t=1.0),
        W(name="a2", lq="lq-0", count=8, cpu="2", level=RACK, t=2.0)], {"quota": "20"}),
    "preferred_relaxes_to_block": ([
        W(name="pref", lq="lq-0", count=20, cpu="2", level=RACK, t=1.0, mode="Preferred"),
        W(name="reqd", lq="lq-1", count=20, cpu="2", level=RACK, t=2.0)], {}),
    "preferred_multi_domain_at_top": ([
        W(name="huge", lq="lq-0", count=50, cpu="2", level=RACK, t=1.0, mode="Preferred")], {}),
    "unconstrained_splits_at_leaf": ([
        W(name="u-small", lq="lq-0", count=3, cpu="2", level=HOST, t=1.0, mode="Unconstrained"),
        W(name="u-big", lq="lq-1", count=10, cpu="2", level=HOST, t=2.0, mode="Unconstrained")],
        {}),
    "two_flavors_segment_by_queue": ([
        W(name="a1", lq="lq-0", count=6, cpu="2", level=RACK, t=1.0),
        W(name="b1", lq="lq-1", count=6, cpu="2", level=RACK, t=2.0),
        W(name="a2", lq="lq-2", count=4, cpu="1", level=HOST, t=3.0),
        W(name="b2", lq="lq-3", count=4, cpu="1", level=HOST, t=4.0)],
        {"n_cq": 4, "two_flavors": True}),
}


@pytest.mark.parametrize("name", sorted(TAS_DRAIN_CASES))
def test_tas_drain_matches_jax(name):
    wls, env_kw = TAS_DRAIN_CASES[name]
    out = check(env_spec(wls, **env_kw))
    assigned = {v[0]: v[2] for v in pt.placements(out)}
    if name == "preferred_relaxes_to_block":
        assert "pref" in assigned and len({d[0][:2] for d in assigned["pref"]}) > 1
    if name == "preferred_multi_domain_at_top":
        assert len({d[0][:1] for d in assigned["huge"]}) > 1
    if name == "unconstrained_splits_at_leaf":
        assert len(assigned["u-small"]) == 1 and len(assigned["u-big"]) > 1
    if name == "two_flavors_segment_by_queue":
        assert set(assigned) == {"a1", "b1", "a2", "b2"}
        for n, prefix in (("a1", "ha-"), ("a2", "ha-"), ("b1", "hb-"), ("b2", "hb-")):
            assert all(d[0][-1].startswith(prefix) for d in assigned[n])


def test_topology_request_on_non_tas_flavor_parks_in_kernel():
    spec = env_spec([W(name="w", lq="lq-plain", count=2, cpu="1", level=RACK, t=1.0)])
    spec["flavors"].append(("plain", None, {}))
    spec["cqs"].append(("cq-plain", "plain", "99"))
    out = check(spec)
    assert [wl.name for wl, _ in out.parked] == ["w"] and not out.admitted


@pytest.mark.parametrize("seed", range(8))
def test_randomized(seed):
    check(env_spec(jax_tas_spec(seed)))


@pytest.mark.parametrize("seed", range(6))
def test_randomized_all_modes(seed):
    check(env_spec(jax_tas_spec(seed + 100, modes=ALL_MODES)))


@pytest.mark.parametrize("seed", range(4))
def test_randomized_two_flavors(seed):
    check(env_spec(two_flavor_spec(seed, modes=ALL_MODES), n_cq=4, two_flavors=True))


@pytest.mark.parametrize("seed", range(4))
def test_randomized_tight_quota(seed):
    check(env_spec(jax_tas_spec(seed, n_cq=4, wl_per_cq=4), n_cq=4, quota="30"))


@pytest.mark.parametrize("seed", range(3))
def test_tas_spec_case(seed):
    """perf/cases.tas_spec: two flavors, plain queues that reserve, and
    a topology request parked through t_bad."""
    out = check(cases.tas_spec(seed))
    assert any(wl.name == "plain-1" for wl, _ in out.parked)
    assert any(wl.name.startswith("plain") for wl, *_ in out.admitted)


def test_run_drain_for_scope_tas():
    pe = pt.build_tas_env(cases.tas_spec(0))
    snap = port_take_snapshot(pe.cache)
    kind, pending2 = pd.classify_drain_scope(snap, pe.pending, set(pe.tas.flavors), False)
    assert kind == "tas" and len(pending2) == len(pe.pending)
    routed = pd.run_drain_for_scope(kind, snap, pending2, pe.cache.flavors, pe.tas,
                                    timestamp_fn=pe.ts_fn, device="cpu")
    direct = pd.run_drain_tas(port_take_snapshot(pe.cache), pe.pending, pe.cache.flavors,
                              pe.tas, timestamp_fn=pe.ts_fn, device="cpu")
    assert view(routed) == view(direct)


def test_tas_drain_10k_cut_matches_jax():
    """bench.py's tas_drain cluster (seed 6), cut to 12 ClusterQueues of
    12 gangs over 2 x 4 x 8 hosts."""
    spec = pt.drain_spec(np.random.default_rng(pt.TAS_DRAIN_SEED), 12, 12, shape=(2, 4, 8))
    jo, po = both(spec)
    assert view(po) == view(jo)
    assert po.admitted and po.parked


@pytest.mark.slow
def test_tas_drain_10k_full_width():
    """tas-drain-10k at full width: both packages give TAS_DRAIN_EXPECT."""
    je = pt.build_tas_drain(np.random.default_rng(pt.TAS_DRAIN_SEED), api=JAX)
    pe = pt.build_tas_drain(np.random.default_rng(pt.TAS_DRAIN_SEED))
    jo = jax_run_drain_tas(jax_take_snapshot(je.cache), je.pending, je.cache.flavors, je.tas,
                           timestamp_fn=je.ts_fn)
    po = pd.run_drain_tas(port_take_snapshot(pe.cache), pe.pending, pe.cache.flavors, pe.tas,
                          timestamp_fn=pe.ts_fn, device="cpu")
    assert pt.drain_summary(jo) == pt.TAS_DRAIN_EXPECT
    assert pt.drain_summary(po) == pt.TAS_DRAIN_EXPECT


def test_run_drain_tas_without_device_raises_without_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pe = pt.build_tas_env(cases.tas_spec(0))
    for call in (
        lambda: pd.run_drain_tas(port_take_snapshot(pe.cache), pe.pending, pe.cache.flavors,
                                 pe.tas),
        lambda: pd.run_drain_for_scope("tas", port_take_snapshot(pe.cache), pe.pending,
                                       pe.cache.flavors, pe.tas),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # a mesh over one device runs (tests/test_torch_parallel.py); one over
    # two cards is refused
    from tests.test_torch_preempt_drain import two_card_mesh

    with pytest.raises(NotImplementedError):
        pd.run_drain_tas(port_take_snapshot(pe.cache), pe.pending, pe.cache.flavors, pe.tas,
                         mesh=two_card_mesh(), device="cpu")


# ---- the placement step ------------------------------------------------------


def random_forest(rng, depth=3):
    """A random domain forest in the merged-forest layout: seg_ids
    [D, Lf], n_domains, parent_map [D, ND] (children in index order)."""
    sizes = [int(rng.integers(2, 4))]
    parents = [None]
    for _ in range(1, depth):
        kids = [int(rng.integers(1, 4)) for _ in range(sizes[-1])]
        parents.append(np.repeat(np.arange(sizes[-1]), kids))
        sizes.append(int(sum(kids)))
    n_lf, nd = sizes[-1], max(sizes)
    seg_ids = np.zeros((depth, n_lf), dtype=np.int32)
    seg_ids[depth - 1] = np.arange(n_lf)
    for d in range(depth - 2, -1, -1):
        seg_ids[d] = parents[d + 1][seg_ids[d + 1]]
    parent_map = np.zeros((depth, nd), dtype=np.int32)
    for d in range(1, depth):
        parent_map[d, : sizes[d]] = parents[d]
    return seg_ids, tuple(sizes), parent_map


@pytest.mark.parametrize("seed", range(6))
def test_tas_fit_and_place_matches_jax(seed):
    from kueue_tpu._jax import jax, jnp

    rng = np.random.default_rng(seed + 9100)
    seg_ids, n_domains, parent_map = random_forest(rng)
    n_lf, d_t = seg_ids.shape[1], len(n_domains)
    free = rng.integers(0, 9, (n_lf, 2)) * np.array([1000, 4])
    usage = rng.integers(0, 9, (n_lf, 2)) * np.array([1000, 3])  # some leaves go negative
    rows = []
    for i in range(24):
        mode = i % 3
        top = int(rng.integers(0, 2))
        level = d_t - 1 if mode == 2 else int(rng.integers(top, d_t))
        count = int(rng.integers(1, 30)) if i % 5 else int(rng.integers(60, 200))
        req = np.array([int(rng.integers(0, 3)) * 1000, 1])
        sel = rng.random(n_lf) < 0.8 if i % 7 else np.zeros(n_lf, dtype=bool)  # all masked
        rows.append((req, count, level, mode, top, sel))
    cols = [np.stack([r[j] for r in rows]) for j in range(6)]
    for place in (True, False):
        # the JAX drain's own batching of the step (solve_drain_tas's vmap)
        jfits, jtaken = jax.jit(jax.vmap(
            lambda req, count, level, mode, top, sel: jdk._tas_fit_and_place(
                jnp.asarray(free), jnp.asarray(usage), jnp.asarray(seg_ids), n_domains,
                jnp.asarray(parent_map), req, count, level, place, mode=mode, top_level=top,
                leaf_sel=sel,
            )
        ))(*(jnp.asarray(c, dtype=t) for c, t in zip(
            cols, (jnp.int64, jnp.int32, jnp.int32, jnp.int32, jnp.int32, bool))))
        jfits, jtaken = np.asarray(jfits).tolist(), np.asarray(jtaken)
        cpu = "cpu"
        pf, ptk = pdk._tas_fit_and_place(
            to_device(free, cpu, np.int64), to_device(usage, cpu, np.int64),
            to_device(seg_ids, cpu, np.int32), n_domains, to_device(parent_map, cpu, np.int32),
            to_device(np.stack([r[0] for r in rows]), cpu, np.int64),
            to_device([r[1] for r in rows], cpu, np.int32),
            to_device([r[2] for r in rows], cpu, np.int32), place,
            mode=to_device([r[3] for r in rows], cpu, np.int32),
            top_level=to_device([r[4] for r in rows], cpu, np.int32),
            leaf_sel=to_device(np.stack([r[5] for r in rows]), cpu, np.bool_),
        )
        assert pf.tolist() == jfits
        np.testing.assert_array_equal(ptk.numpy(), jtaken)
        assert any(jfits) and not all(jfits)
