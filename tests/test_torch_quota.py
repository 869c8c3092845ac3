"""Quota recurrences: kueue_tpu_torch.ops.quota (the plain torch versions
kernel 1 is held to on the card) against kueue_tpu.ops.quota, exactly
(int64, tolerance 0), on seeded random cohort forests of depth 1-3 with
NO_LIMIT sentinels in the lending and borrowing limits."""

import numpy as np
import pytest
import torch

from kueue_tpu._jax import jnp
from kueue_tpu.ops import quota as jq
from kueue_tpu_torch import interop
from kueue_tpu_torch.ops import quota as tq


def random_forest(seed: int, depth: int, n_cq: int = 12, fr: int = 5):
    """Encoded-snapshot arrays of a random forest: ClusterQueue rows
    first, then cohorts; cohorts at levels 0..depth-1, CQs attached to
    a random cohort (or none) so node depths reach ``depth``."""
    rng = np.random.default_rng(seed)
    levels = [list(range(int(rng.integers(1, 3))))]
    n_cohort = len(levels[0])
    parents_c = [-1] * n_cohort
    for _ in range(1, depth):
        prev = levels[-1]
        cur = []
        for _ in range(int(rng.integers(1, 4))):
            parents_c.append(int(rng.choice(prev)))
            cur.append(n_cohort)
            n_cohort += 1
        levels.append(cur)
    n = n_cq + n_cohort
    parent = np.full(n, -1, dtype=np.int32)
    for j, p in enumerate(parents_c):
        parent[n_cq + j] = -1 if p < 0 else n_cq + p
    deepest = [n_cq + j for j in levels[-1]]
    for i in range(n_cq):
        r = rng.random()
        if i == 0:
            parent[i] = int(rng.choice(deepest))  # reach the full depth
        elif r < 0.15:
            parent[i] = -1
        else:
            parent[i] = n_cq + int(rng.integers(0, n_cohort))
    dep = np.zeros(n, dtype=np.int32)
    for i in range(n):
        cur = i
        while parent[cur] >= 0:
            dep[i] += 1
            cur = parent[cur]
    level_mask = np.stack([dep == d for d in range(int(dep.max()) + 1)])
    nominal = rng.integers(0, 40, size=(n, fr)).astype(np.int64)
    nominal[n_cq:] *= rng.random((n_cohort, fr)) < 0.5  # some cohort quota
    nominal[0, 0] = 64 << 30  # 64Gi: beyond int32
    lend = np.where(
        rng.random((n, fr)) < 0.35, rng.integers(0, 30, (n, fr)), jq.NO_LIMIT
    ).astype(np.int64)
    borrow = np.where(
        rng.random((n, fr)) < 0.35, rng.integers(0, 30, (n, fr)), jq.NO_LIMIT
    ).astype(np.int64)
    local = np.zeros((n, fr), dtype=np.int64)
    local[:n_cq] = rng.integers(0, 50, size=(n_cq, fr))
    return {
        "parent": parent,
        "level_mask": level_mask,
        "nominal": nominal,
        "lending_limit": lend,
        "borrowing_limit": borrow,
        "local_usage": local,
        "max_depth": int(dep.max()),
    }


def _jax_tree(enc):
    return jq.QuotaTree(
        parent=jnp.asarray(enc["parent"]),
        level_mask=jnp.asarray(enc["level_mask"]),
        nominal=jnp.asarray(enc["nominal"]),
        lending_limit=jnp.asarray(enc["lending_limit"]),
        borrowing_limit=jnp.asarray(enc["borrowing_limit"]),
    )


def _eq(t: torch.Tensor, j) -> None:
    assert t.dtype == torch.int64
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("seed", range(6))
def test_four_recurrences_match_jax(seed, depth):
    enc = random_forest(seed * 10 + depth, depth)
    assert enc["max_depth"] == depth
    jt = _jax_tree(enc)
    tt = interop.quota_tree(enc, "cpu")

    j_sub, j_g = jq.subtree_quota(jt)
    t_sub, t_g = tq.subtree_quota(tt)
    _eq(t_sub, j_sub)
    _eq(t_g, j_g)

    j_u = jq.usage_tree(jt, j_g, jnp.asarray(enc["local_usage"]))
    t_u = tq.usage_tree(tt, t_g, torch.as_tensor(enc["local_usage"]))
    _eq(t_u, j_u)

    _eq(tq.available_all(tt, t_sub, t_g, t_u), jq.available_all(jt, j_sub, j_g, j_u))
    _eq(
        tq.potential_available_all(tt, t_sub, t_g),
        jq.potential_available_all(jt, j_sub, j_g),
    )


def test_out_buffer_and_done_flag():
    enc = random_forest(99, 2)
    tt = interop.quota_tree(enc, "cpu")
    sub, g = tq.subtree_quota(tt)
    local = torch.as_tensor(enc["local_usage"])
    out = torch.full_like(local, -7)
    done = torch.ones(1, dtype=torch.int32)
    # a set done flag leaves the buffers untouched
    assert tq.usage_tree(tt, g, local, out=out, done=done) is out
    assert bool((out == -7).all())
    tq.available_all(tt, sub, g, local, out=out, done=done)
    assert bool((out == -7).all())
    done.zero_()
    tq.usage_tree(tt, g, local, out=out, done=done)
    assert torch.equal(out, tq.usage_tree_plain(tt, g, local))


def test_sentinels_are_jax_package_values():
    assert tq.NO_LIMIT == jq.NO_LIMIT == 1 << 60
    assert tq.DRS_MAX == jq.DRS_MAX == (1 << 63) - 1
