"""The unsegmented admission cycle (kernel B3', ``cycle_global``) in both
packages, exactly (int64, tolerance 0):

- kueue_tpu_torch.ops.assign_kernel.solve_cycle_plain (the plain torch
  version the kernel is held to on the card) against the JAX package's
  solve_cycle_jit on the seeded problems of tests/test_assign_kernel.py's
  segmented property test (ten seeds, with and without reservations),
  on __graft_entry__.entry()'s synthetic problem (the port's
  entry(device="cpu") gives the same arguments) and on the port's
  depth-3 perf.cases.cycle_batch (limits, pads, scores, ties): every
  field of SolveResult, the usage tree included;
- the port's solve_cycle (the wrapper's CPU path), solve_cycle_packed
  and the segmented solve_cycle_segmented against the same, head for
  head.
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from kueue_tpu._jax import jnp
from kueue_tpu.ops.assign_kernel import HeadsBatch as JaxHeads
from kueue_tpu.ops.assign_kernel import solve_cycle_jit
from kueue_tpu.ops.quota import QuotaTree as JaxTree
from kueue_tpu_torch import entry, interop
from kueue_tpu_torch.ops import assign_kernel as ak
from kueue_tpu_torch.perf import cases
from tests.test_assign_kernel import TestSegmentedEquivalence

FIELDS = ("chosen", "admitted", "borrows", "reserved", "usage", "order")
TREE_FIELDS = ("parent", "level_mask", "nominal", "lending_limit", "borrowing_limit")


def port_args(tree, usage, heads, paths):
    """The JAX problem's arrays as the port's inputs on the CPU."""
    t = interop.quota_tree({k: np.asarray(getattr(tree, k)) for k in TREE_FIELDS}, "cpu")
    h = interop.heads_batch(
        {k: None if getattr(heads, k) is None else np.asarray(getattr(heads, k))
         for k in heads._fields},
        "cpu",
    )
    return (t, torch.tensor(np.asarray(usage)), h,
            torch.tensor(np.asarray(paths), dtype=torch.int32))


def assert_same(got, ref, label):
    for f in FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, f)), np.asarray(getattr(ref, f)), err_msg=f"{label}: {f}"
        )


def check_all(args, ref, label, seg=None):
    """solve_cycle_plain, solve_cycle, solve_cycle_packed (and, given
    (seg_id, n_segments, n_steps), solve_cycle_segmented) equal ``ref``."""
    assert_same(ak.solve_cycle_plain(*args), ref, f"{label} plain")
    assert_same(ak.solve_cycle(*args), ref, f"{label} solve_cycle")
    tree, _, heads, _ = args
    w, (n, fr) = heads.cq_row.shape[0], tree.nominal.shape
    buf = ak.solve_cycle_packed(*args)
    assert buf.shape == (5 * w + n * fr,)
    assert_same(ak.unpack_cycle(buf, w, n, fr), ref, f"{label} packed")
    if seg is not None:
        assert_same(ak.solve_cycle_segmented(*args, *seg), ref, f"{label} segmented")


@pytest.mark.parametrize("with_reserve", [True, False])
@pytest.mark.parametrize("seed", range(10))
def test_matches_jax_on_the_segmented_property_problems(seed, with_reserve):
    tree, usage, heads, paths, seg_id, n_seg = TestSegmentedEquivalence._problem(
        seed, with_reserve=with_reserve
    )
    ref = solve_cycle_jit(tree, usage, heads, paths)
    assert bool(np.asarray(ref.admitted).any())
    if with_reserve and seed == 0:
        assert bool(np.asarray(ref.reserved).any()), "the case lost its reservations"
    check_all(port_args(tree, usage, heads, paths), ref, f"seed {seed}",
              (np.asarray(seg_id), n_seg, 64))


def test_matches_jax_on_the_graft_entry_problem():
    fn, args = graft.entry()
    ref = solve_cycle_jit(*args)
    pfn, pargs = entry.entry(device="cpu")
    assert pfn is ak.solve_cycle
    mine = port_args(*args)
    for a, b in zip(pargs[1:], mine[1:]):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    for f in TREE_FIELDS:
        assert torch.equal(getattr(pargs[0], f), getattr(mine[0], f))
    assert_same(pfn(*pargs), ref, "entry")
    check_all(mine, ref, "graft entry")


@pytest.mark.parametrize("seed", range(4))
def test_matches_jax_on_depth3_batches(seed):
    """perf.cases.cycle_batch: depth-3 forests, lending and borrowing
    limits, pad rows, zero-quantity cells, priority and timestamp
    ties, reservations and (odd seeds) nonzero scores."""
    b = cases.cycle_batch(seed, w=40, n_cq=14)
    jtree = JaxTree(**{k: jnp.asarray(b[k]) for k in TREE_FIELDS})
    jheads = JaxHeads(**{k: jnp.asarray(b[k]) for k in JaxHeads._fields})
    ref = solve_cycle_jit(jtree, jnp.asarray(b["local_usage"]), jheads, jnp.asarray(b["paths"]))
    assert bool(np.asarray(ref.admitted).any()) and bool(np.asarray(ref.reserved).any())
    args = (interop.quota_tree(b, "cpu"), torch.tensor(b["local_usage"]),
            interop.heads_batch(b, "cpu"), torch.tensor(b["paths"]))
    check_all(args, ref, f"cycle_batch {seed}",
              (b["seg_id"], max(b["n_segments"], 1), max(b["n_steps"], 1)))


def test_cycle_global_is_the_phase2_of_solve_cycle():
    """cycle_global over the phase-1 outputs equals solve_cycle's
    outcome and leaves the usage tree where solve_cycle does; the
    caller's leaf usage is never written."""
    b = cases.cycle_batch(5)
    tree, heads = interop.quota_tree(b, "cpu"), interop.heads_batch(b, "cpu")
    local, paths = torch.tensor(b["local_usage"]), torch.tensor(b["paths"])
    local0 = local.clone()
    ref = ak.solve_cycle_plain(tree, local, heads, paths)
    sub, g = ak.subtree_quota(tree)
    usage = ak.usage_tree(tree, g, local)
    phase1 = ak.phase1_classify(tree, sub, g, local, heads)
    packed = ak.cycle_global(tree, sub, g, usage, paths, heads, *phase1)
    assert_same(ak._unpack(packed, usage), ref, "cycle_global")
    assert torch.equal(local, local0)
