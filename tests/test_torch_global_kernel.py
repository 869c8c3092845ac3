"""The federation's global rescore (kernel B15) in the PyTorch port
against the JAX package, exactly.

The port's plain version (``kueue_tpu_torch.ops.global_kernel``:
``rescore_pairs(device="cpu")``, which runs ``rescore_plain``) and its
numpy mirror (``kueue_tpu_torch.ops.global_np.rescore_np``) are held to
the JAX package's jitted ``rescore_pairs`` (run on the CPU, as
tests/test_global_scheduler.py runs it) and its ``rescore_np``, field
by field, at:

- seeds 0-7 x 12 fleets drawn as the JAX package's parity test draws
  them (tta up to 2^40, scores beyond +-2^20, 25% of the pairs
  invalid);
- degraded masks with penalties;
- rotations that are negative or >= C, current columns >= C;
- W = 0, C = 0, an all-invalid row, the hysteresis boundary, ties on
  TTA and score, the key's corner (a valid pair whose key is
  INVALID_KEY), and C = 4097 raising in both packages.

The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 14).
"""

import numpy as np
import pytest
import torch

from kueue_tpu.ops import global_kernel as jgk
from kueue_tpu.ops import global_np as jnp_mirror
from kueue_tpu_torch.ops import global_kernel as pgk
from kueue_tpu_torch.ops import global_np as pnp_mirror
from kueue_tpu_torch.perf.cases import rescore_fleet

FIELDS = ("best", "best_key", "gain_ms", "rebalance")


def _all_four(args):
    """(JAX kernel, JAX mirror, port plain, port mirror) on ``args``."""
    return (
        jgk.rescore_pairs(**args),
        jnp_mirror.rescore_np(**args),
        pgk.rescore_pairs(**args, device="cpu"),
        pnp_mirror.rescore_np(**args),
    )


def _assert_equal(results, label=""):
    ref = results[0]
    for res in results[1:]:
        for f in FIELDS:
            a, b = np.asarray(getattr(ref, f)), np.asarray(getattr(res, f))
            assert a.dtype == b.dtype, (label, f, a.dtype, b.dtype)
            assert a.shape == b.shape, (label, f)
            assert np.array_equal(a, b), (label, f, a, b)


@pytest.mark.parametrize("seed", range(8))
def test_random_fleets_match(seed):
    rng = np.random.default_rng(seed)
    for i in range(12):
        args = rescore_fleet(rng)
        _assert_equal(_all_four(args), (seed, i))


@pytest.mark.parametrize("seed", range(4))
def test_degraded_penalties_match(seed):
    rng = np.random.default_rng(100 + seed)
    for i in range(10):
        c = int(rng.integers(2, 9))
        args = rescore_fleet(rng, w=int(rng.integers(1, 12)), c=c,
                             n_degraded=int(rng.integers(0, c + 1)))
        _assert_equal(_all_four(args), (seed, i))


@pytest.mark.parametrize("seed", range(4))
def test_wide_rotations_and_current_past_the_fleet(seed):
    rng = np.random.default_rng(200 + seed)
    for i in range(10):
        args = rescore_fleet(rng, wide_rotation=True, current_past=True,
                             n_degraded=1 if i % 2 else None)
        _assert_equal(_all_four(args), (seed, i))
    # at least one draw moved a workload whose current column is past C
    args = rescore_fleet(np.random.default_rng(7), w=8, c=3, current_past=True)
    args["current"][:] = 4
    _assert_equal(_all_four(args))


def test_degenerate_shapes():
    for w, c in ((0, 3), (2, 0), (0, 0)):
        args = dict(
            tta_ms=np.zeros((w, c), np.int64), score=np.zeros((w, c), np.int64),
            valid=np.zeros((w, c), bool), current=np.full(w, -1, np.int32),
            rotation=np.zeros(w, np.int32), hysteresis_ms=0,
        )
        res = _all_four(args)
        _assert_equal(res, (w, c))
        assert list(res[2].best) == [-1] * w


def test_all_invalid_row_and_key_corner():
    # row 0: nothing scorable; row 1: the only valid pair packs to
    # INVALID_KEY (tta at the cap, the least score, rotated index 4095
    # needs C = 4096) — both give best = -1 as jnp.argmin + the has_best
    # test do
    c = 4096
    tta = np.full((2, c), pgk.TTA_CAP_MS, np.int64)
    score = np.full((2, c), -(2**21), np.int64)
    valid = np.zeros((2, c), bool)
    valid[1, 4095] = True
    args = dict(tta_ms=tta, score=score, valid=valid, current=np.array([0, 4095], np.int32),
                rotation=np.zeros(2, np.int32), hysteresis_ms=0)
    res = _all_four(args)
    _assert_equal(res)
    assert list(res[2].best) == [-1, -1]
    assert list(res[2].best_key) == [pgk.INVALID_KEY] * 2


def test_ties_on_tta_and_score():
    tta = np.array([[100, 100, 50], [100, 100, 100], [100, 100, 100]], np.int64)
    score = np.array([[5, 9, 0], [5, 9, 0], [0, 0, 0]], np.int64)
    args = dict(tta_ms=tta, score=score, valid=np.ones((3, 3), bool),
                current=np.array([0, 0, 0], np.int32),
                rotation=np.array([0, 0, 2], np.int32), hysteresis_ms=0)
    res = _all_four(args)
    _assert_equal(res)
    assert list(res[2].best) == [2, 1, 2]


def test_hysteresis_boundary():
    base = dict(tta_ms=np.array([[100_000, 0]], np.int64), score=np.zeros((1, 2), np.int64),
                valid=np.ones((1, 2), bool), current=np.array([0], np.int32),
                rotation=np.array([0], np.int32))
    at = _all_four({**base, "hysteresis_ms": 100_000})
    _assert_equal(at)
    assert not at[2].rebalance[0]
    above = _all_four({**base, "hysteresis_ms": 99_999})
    _assert_equal(above)
    assert above[2].rebalance[0] and above[2].gain_ms[0] == 100_000


def test_too_many_clusters_raises_in_both_packages():
    c = pgk.MAX_CLUSTERS + 1
    args = dict(tta_ms=np.zeros((1, c), np.int64), score=np.zeros((1, c), np.int64),
                valid=np.ones((1, c), bool), current=np.array([-1], np.int32),
                rotation=np.zeros(1, np.int32), hysteresis_ms=0)
    msgs = []
    for fn in (jgk.rescore_pairs, jnp_mirror.rescore_np, pnp_mirror.rescore_np,
               lambda **a: pgk.rescore_pairs(**a, device="cpu")):
        with pytest.raises(ValueError) as e:
            fn(**args)
        msgs.append(str(e.value))
    assert len(set(msgs)) == 1


def test_plain_version_returns_the_packed_buffer():
    args = rescore_fleet(np.random.default_rng(3), w=9, c=5, n_degraded=2)
    t = pgk.rescore_inputs(args["tta_ms"], args["score"], args["valid"], args["current"],
                           args["rotation"], args["degraded"], "cpu")
    packed = pgk.rescore_packed(*t, args["hysteresis_ms"], args["degraded_penalty_ms"])
    assert packed.dtype == torch.int64 and tuple(packed.shape) == (4, 9)
    _assert_equal([jgk.rescore_pairs(**args), pgk.decode(packed.numpy())])


def test_entry_point_needs_a_card_unless_told_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    args = rescore_fleet(np.random.default_rng(0), w=2, c=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        pgk.rescore_pairs(**args)
