"""Global rescore (port of kueue_tpu/ops/global_kernel.py, kernel B15):
one pass over every (pending workload x worker cluster) pair of the
federation.

The host aggregates a ``GlobalSnapshot`` (federation/aggregate.py) into
dense tensors, one launch scores every pair and picks the best cluster
per workload, and a hysteresis threshold gates retract-and-redispatch
so forecast noise cannot thrash placements.

Inputs, shapes ``[W, C]`` (W pending workloads, C worker clusters):

  tta_ms   int64 — forecast time-to-admission on that cluster, in
                   milliseconds; clamped to ``TTA_CAP_MS``.
  score    int64 — admission-policy cluster score (all-zero under the
                   default first-fit policy).
  valid    bool  — the pair is scorable.
  current  int32[W] — column of the workload's current winner, -1 when
                   undispatched.
  rotation int32[W] — per-workload stable tie-break offset.

The per-pair sort key is ONE int64, lexicographic by construction —
(tta asc, policy score desc, rotated cluster index asc):

  key = tta<<33 | (2^21-1 - (score+2^20))<<12 | rotated_index

Budget: 30 bits tta, 21 bits score, 12 bits index (4096 clusters), 63
bits in all. A placement moves only when the best cluster's forecast
beats the current cluster's by more than ``hysteresis_ms``. Columns of
an optional ``degraded`` bool[C] mask get ``degraded_penalty_ms``
added to their clipped TTA before packing, clipped again.

``rescore_packed`` launches kernel ``global_rescore``
(``csrc/global_rescore.cu``) for CUDA tensors and runs the plain torch
version ``rescore_plain`` for CPU ones; both return one int64 [4, W]
buffer (best, best_key, gain_ms, rebalance as 0/1). ``rescore_pairs``
keeps the JAX package's host signature (numpy in, ``RescoreResult`` of
numpy arrays out) and fetches that buffer in one copy. It needs no
power-of-two padding of W: there is no compile cache to bound.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np

from kueue_tpu_torch._torch import BOOL, I32, I64, resolve_device, to_device, torch
from kueue_tpu_torch.ops import _build

__all__ = [
    "TTA_CAP_MS",
    "SCORE_HALF",
    "IDX_BITS",
    "SCORE_BITS",
    "MAX_CLUSTERS",
    "INVALID_KEY",
    "RescoreResult",
    "rescore_plain",
    "rescore_packed",
    "rescore_pairs",
]

KERNEL = "global_rescore"

#: tta clamp: 30 bits of milliseconds (~12.4 days)
TTA_CAP_MS = (1 << 30) - 1
#: policy scores clip to [-SCORE_HALF, SCORE_HALF - 1]
SCORE_HALF = 1 << 20
SCORE_BITS = 21
#: rotated cluster index occupies the low bits
IDX_BITS = 12
MAX_CLUSTERS = 1 << IDX_BITS
#: key for unscorable pairs: sorts after every real key
INVALID_KEY = (1 << 63) - 1

_IDX_SHIFT = 1 << IDX_BITS
_TTA_SHIFT = 1 << (SCORE_BITS + IDX_BITS)


class RescoreResult(NamedTuple):
    """One rescore pass, decoded per workload (numpy arrays).

    best:      int32[W] — argmin column (best cluster), -1 when no
               pair was scorable.
    best_key:  int64[W] — the winning packed key (INVALID_KEY when
               best == -1).
    gain_ms:   int64[W] — current TTA minus best TTA (0 when the
               current placement is unscorable or nothing is better).
    rebalance: bool[W]  — move the workload: current is scorable, a
               DIFFERENT cluster wins, and the gain clears hysteresis.
    """

    best: np.ndarray
    best_key: np.ndarray
    gain_ms: np.ndarray
    rebalance: np.ndarray


def rescore_plain(tta_ms, score, valid, current, rotation, degraded,
                  hysteresis_ms: int, degraded_penalty_ms: int) -> torch.Tensor:
    """The kernel's arithmetic in torch, on the inputs' device: the
    packed int64 [4, W] result (best, best_key, gain_ms, rebalance)."""
    w, c = tta_ms.shape
    cols = torch.arange(c, dtype=I64, device=tta_ms.device)[None, :]
    idx = torch.remainder(cols - rotation.to(I64)[:, None], c)
    penalty = degraded.to(I64)[None, :] * int(degraded_penalty_ms)
    tta_c = torch.clamp(torch.clamp(tta_ms, 0, TTA_CAP_MS) + penalty, 0, TTA_CAP_MS)
    score_c = torch.clamp(score, -SCORE_HALF, SCORE_HALF - 1) + SCORE_HALF
    key = tta_c * _TTA_SHIFT + ((1 << SCORE_BITS) - 1 - score_c) * _IDX_SHIFT + idx
    key = torch.where(valid, key, torch.full_like(key, INVALID_KEY))
    best = torch.argmin(key, dim=1)
    best_key = torch.gather(key, 1, best[:, None])[:, 0]
    has_best = best_key < INVALID_KEY
    best = torch.where(has_best, best, torch.full_like(best, -1))
    cur = current.to(I64)
    cur_col = torch.clamp(cur, 0, c - 1)[:, None]
    cur_valid = (cur >= 0) & torch.gather(valid, 1, cur_col)[:, 0]
    cur_tta = torch.gather(tta_c, 1, cur_col)[:, 0]
    best_tta = torch.gather(tta_c, 1, torch.clamp(best, 0, c - 1)[:, None])[:, 0]
    movable = cur_valid & has_best
    gain = torch.where(movable, cur_tta - best_tta, torch.zeros_like(cur_tta))
    rebalance = movable & (best != cur) & (gain > int(hysteresis_ms))
    return torch.stack([best, best_key, gain, rebalance.to(I64)])


def rescore_packed(tta_ms, score, valid, current, rotation, degraded,
                   hysteresis_ms: int, degraded_penalty_ms: int) -> torch.Tensor:
    """The packed int64 [4, W] rescore: kernel ``global_rescore`` for
    CUDA tensors (or it raises), ``rescore_plain`` for CPU ones."""
    w, c = tta_ms.shape
    if not tta_ms.is_cuda:
        return rescore_plain(tta_ms, score, valid, current, rotation, degraded,
                             hysteresis_ms, degraded_penalty_ms)
    out = torch.empty((4, w), dtype=I64, device=tta_ms.device)
    fn = _build.c_function(
        KERNEL,
        KERNEL,
        [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    )
    args = (
        _build.ptr(KERNEL, "tta_ms", tta_ms, I64, (w, c)),
        _build.ptr(KERNEL, "score", score, I64, (w, c)),
        _build.ptr(KERNEL, "valid", valid, BOOL, (w, c)),
        _build.ptr(KERNEL, "current", current, I32, (w,)),
        _build.ptr(KERNEL, "rotation", rotation, I32, (w,)),
        _build.ptr(KERNEL, "degraded", degraded, BOOL, (c,)),
        int(hysteresis_ms),
        int(degraded_penalty_ms),
        _build.ptr(KERNEL, "out", out, I64, (4, w)),
        w,
        c,
        _build.stream_ptr(tta_ms.device),
    )
    _build.note_launch(KERNEL)
    _build.check(fn(*args), KERNEL)
    return out


def rescore_inputs(tta_ms, score, valid, current, rotation, degraded, device):
    """The numpy inputs of one rescore as tensors on ``device``."""
    return (
        to_device(tta_ms, device, np.int64),
        to_device(score, device, np.int64),
        to_device(valid, device, np.bool_),
        to_device(current, device, np.int32),
        to_device(rotation, device, np.int32),
        to_device(degraded, device, np.bool_),
    )


def decode(packed) -> RescoreResult:
    """The ``RescoreResult`` of a fetched packed [4, W] buffer."""
    packed = np.asarray(packed)
    return RescoreResult(
        packed[0].astype(np.int32),
        packed[1].astype(np.int64),
        packed[2].astype(np.int64),
        packed[3].astype(bool),
    )


def rescore_pairs(
    tta_ms, score, valid, current, rotation, hysteresis_ms: int,
    degraded=None, degraded_penalty_ms: int = 0, device=None,
) -> RescoreResult:
    """Host entry point: numpy in, numpy out, one launch and one fetch.

    Runs on the card (``device`` defaults to ``cuda`` and raises where
    there is none); ``device="cpu"`` runs ``rescore_plain``. W = 0 or
    C = 0 returns the empty result without a launch; C above
    ``MAX_CLUSTERS`` raises ValueError before any launch. ``degraded``
    is an optional bool[C] mask; omitting it is an all-healthy fleet.
    """
    w, c = np.shape(tta_ms)
    if degraded is None:
        degraded = np.zeros(c, dtype=bool)
    if w == 0 or c == 0:
        return RescoreResult(
            np.full(w, -1, dtype=np.int32),
            np.full(w, INVALID_KEY, dtype=np.int64),
            np.zeros(w, dtype=np.int64),
            np.zeros(w, dtype=bool),
        )
    if c > MAX_CLUSTERS:
        raise ValueError(
            f"{c} clusters exceeds the {MAX_CLUSTERS}-cluster key budget"
        )
    dev = resolve_device(device)
    packed = rescore_packed(
        *rescore_inputs(tta_ms, score, valid, current, rotation, degraded, dev),
        int(hysteresis_ms), int(degraded_penalty_ms),
    )
    return decode(_build.fetch(packed, f"kernel {KERNEL}"))  # the one fetch
