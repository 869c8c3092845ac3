"""The fair-sharing reductions over the quota tree (kernel B1',
``quota_drs``) in both packages, exactly (int64, tolerance 0):
kueue_tpu_torch.ops.quota's lendable_per_resource and
dominant_resource_share (their CPU path is the plain version the kernel
is held to on the card) against kueue_tpu.ops.quota's, and against the
port's numpy dominant_resource_share_np:

- the three DRS cases of tests/test_quota_ops.py (a borrowing
  ClusterQueue, a zero weight while borrowing, a workload request that
  makes a node borrow), with their expected values;
- seeded depth-3 forests with lending and borrowing limits, zero
  weights, a zero and a seeded nonzero workload request, and one to
  four resources over the cells;
- a node that borrows where the parent lends nothing (drs -1, dominant
  -1, the share truncated toward zero as Go divides) and a tie between
  two resources (the lower resource id wins).
"""

import numpy as np
import pytest
import torch

from kueue_tpu._jax import jnp
from kueue_tpu.ops import quota as jq
from kueue_tpu_torch import interop
from kueue_tpu_torch.ops import quota as tq
from kueue_tpu_torch.ops.quota_np import dominant_resource_share_np
from tests.test_quota_ops import ROOT, Node, build_tree_arrays
from tests.test_torch_quota import random_forest

TREE_FIELDS = ("parent", "level_mask", "nominal", "lending_limit", "borrowing_limit")


def both(enc, local, wl_req, weight, resource_index, n_res):
    """((lendable, dws, dominant) of JAX, of the port) on one input, the
    port's also checked against dominant_resource_share_np."""
    jtree = jq.QuotaTree(**{k: jnp.asarray(enc[k]) for k in TREE_FIELDS})
    js, jg = jq.subtree_quota(jtree)
    ju = jq.usage_tree(jtree, jg, jnp.asarray(local))
    ri = jnp.asarray(resource_index, dtype=jnp.int32)
    jl = jq.lendable_per_resource(jtree, js, jg, ri, n_res)
    jd, jdom = jq.dominant_resource_share(
        jtree, js, jg, ju, jnp.asarray(wl_req), jnp.asarray(weight), ri, n_res
    )
    tree = interop.quota_tree(enc, "cpu")
    ps, pg = tq.subtree_quota(tree)
    pu = tq.usage_tree(tree, pg, torch.tensor(local))
    x = interop.drs_inputs(
        dict(resource_index=resource_index, weight_milli=weight, wl_req=wl_req), "cpu"
    )
    pl = tq.lendable_per_resource(tree, ps, pg, x["resource_index"], n_res)
    pd, pdom = tq.dominant_resource_share(
        tree, ps, pg, pu, x["wl_req"], x["weight_milli"], x["resource_index"], n_res
    )
    nd, ndom = dominant_resource_share_np(
        np.asarray(enc["parent"]), np.asarray(enc["level_mask"]), ps.numpy(), pg.numpy(),
        np.asarray(enc["borrowing_limit"]), pu.numpy(), np.asarray(wl_req),
        np.asarray(weight), np.asarray(resource_index), n_res,
    )
    np.testing.assert_array_equal(pd.numpy(), nd)
    np.testing.assert_array_equal(pdom.numpy(), ndom)
    assert pd.dtype == torch.int64 and pdom.dtype == torch.int32 and pl.dtype == torch.int64
    return ((np.asarray(jl), np.asarray(jd), np.asarray(jdom)),
            (pl.numpy(), pd.numpy(), pdom.numpy()))


def assert_equal(j, p):
    for name, a, b in zip(("lendable", "dws", "dominant"), j, p):
        np.testing.assert_array_equal(b, a, err_msg=name)


def _enc(tree):
    return {k: np.asarray(getattr(tree, k)) for k in TREE_FIELDS}


# the three cases of tests/test_quota_ops.py: (local usage of cq0,
# wl_req of cq0, weights, expected dws of cq0)
QUOTA_OPS_CASES = [
    ("basic", 15, 0, [1000, 1000, 1000], 166),
    ("zero_weight_borrowing", 15, 0, [0, 1000, 1000], tq.DRS_MAX),
    ("workload_request", 8, 8, [1000, 1000, 1000], 200),
]


@pytest.mark.parametrize("case", QUOTA_OPS_CASES, ids=lambda c: c[0])
def test_quota_ops_cases(case):
    _, used, req, weight, expect = case
    nodes = [Node({"f/cpu": 10}), Node({"f/cpu": 20}), Node({})]
    tree, _ = build_tree_arrays(nodes, [2, 2, ROOT], {"f/cpu"})
    local = np.array([[used], [0], [0]], dtype=np.int64)
    wl_req = np.array([[req], [0], [0]], dtype=np.int64)
    j, p = both(_enc(tree), local, wl_req, np.array(weight, dtype=np.int64),
                np.zeros(1, dtype=np.int32), 1)
    assert_equal(j, p)
    assert p[1][0] == expect
    assert p[1][1] == 0 and p[2][1] == -1  # cq1 does not borrow
    assert p[1][2] == 0 and p[2][2] == -1  # the root cohort
    np.testing.assert_array_equal(p[0][:, 0], [30, 30, 0])


@pytest.mark.parametrize("n_res", [1, 2, 4])
@pytest.mark.parametrize("seed", range(6))
def test_seeded_depth3_forests(seed, n_res):
    enc = random_forest(seed, 3, n_cq=14, fr=6)
    n, fr = enc["nominal"].shape
    rng = np.random.default_rng(100 + seed)
    resource_index = np.sort(rng.integers(0, n_res, size=fr)).astype(np.int32)
    weight = rng.choice([0, 250, 1000, 3000], size=n).astype(np.int64)
    local = enc["local_usage"] * 2  # more borrowing
    for wl_req in (np.zeros((n, fr), dtype=np.int64),
                   (rng.integers(0, 30, size=(n, fr)) * (rng.random((n, fr)) < 0.4))
                   .astype(np.int64)):
        j, p = both(enc, local, wl_req, weight, resource_index, n_res)
        assert_equal(j, p)
        assert (p[2] >= 0).any(), "no node borrows: the case lost its coverage"


def test_borrowing_without_lendable_and_resource_ties():
    """cq0 borrows cpu and mem in equal ratio (a tie: resource 0 wins);
    cq1 borrows gpu under a cohort that lends no gpu (ratio -1 only: drs
    -1, dominant -1, share -1000 // 3 truncated to -333); cq2's zero
    weight while borrowing gives DRS_MAX."""
    # cells: cpu, mem, gpu; resources 0, 1, 2
    parent = np.array([3, 3, 3, -1], dtype=np.int32)
    level_mask = np.array([[0, 0, 0, 1], [1, 1, 1, 0]], dtype=bool)
    nominal = np.array([[10, 10, 0], [10, 10, 0], [10, 10, 0], [0, 0, 0]], dtype=np.int64)
    limits = np.full((4, 3), jq.NO_LIMIT, dtype=np.int64)
    enc = dict(parent=parent, level_mask=level_mask, nominal=nominal, lending_limit=limits,
               borrowing_limit=limits)
    local = np.array([[15, 15, 0], [0, 0, 4], [12, 0, 0], [0, 0, 0]], dtype=np.int64)
    weight = np.array([1000, 3, 0, 1000], dtype=np.int64)
    j, p = both(enc, local, np.zeros((4, 3), dtype=np.int64), weight,
                np.arange(3, dtype=np.int32), 3)
    assert_equal(j, p)
    lendable, dws, dominant = p
    assert lendable[1, 2] == 0
    assert dominant[0] == 0 and dws[0] == 166  # 5 * 1000 // 30, weight 1
    assert dominant[1] == -1 and dws[1] == -333  # Go truncation of -1000 / 3
    assert dws[2] == tq.DRS_MAX


def test_cpu_tensors_run_the_plain_versions_and_count_no_launch():
    """On CPU tensors the wrappers run the plain versions: no kernel
    launch is counted."""
    from kueue_tpu_torch.ops import _build

    enc = random_forest(0, 2)
    before = _build.launch_counts()["quota_drs"]
    tree = interop.quota_tree(enc, "cpu")
    s, g = tq.subtree_quota(tree)
    ri = torch.zeros(enc["nominal"].shape[1], dtype=torch.int32)
    tq.lendable_per_resource(tree, s, g, ri, 1)
    assert _build.launch_counts()["quota_drs"] == before
