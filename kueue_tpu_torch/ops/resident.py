"""Resident usage row scatter (port of the jitted ``_scatter_rows`` of
kueue_tpu/core/solver.py:504-518 and kueue_tpu/core/encode.py:334-344).

``scatter_rows(usage, idx, rows)`` sets ``usage[idx[i], :] = rows[i, :]``
in place on the device-resident leaf usage buffer that
``core/solver.ResidentCycleState`` keeps between cycles, so a cycle
ships only the rows that changed. Kernel ``scatter_rows``
(``csrc/scatter_rows.cu``) for a CUDA buffer, the plain torch version
for a CPU one. Repeated indices must carry equal rows (the caller pads
by repeating its first changed row), which makes the writes
idempotent in any order. Indices follow the JAX scatter's rules: a
negative index counts from the end, and one still out of range is
dropped.
"""

from __future__ import annotations

import ctypes

from kueue_tpu_torch._torch import I32, I64, torch
from kueue_tpu_torch.ops import _build

KERNEL = "scatter_rows"


def scatter_rows_plain(usage: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> None:
    n_rows = usage.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n_rows, idx)
    keep = (idx >= 0) & (idx < n_rows)
    usage[idx[keep]] = rows[keep]


def scatter_rows(usage: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> None:
    """usage[idx] = rows, in place (usage int64[N, FR], idx int32[n],
    rows int64[n, FR])."""
    n_rows, fr = usage.shape
    n = idx.shape[0]
    if not usage.is_cuda:
        return scatter_rows_plain(usage, idx, rows)
    fn = _build.c_function(
        KERNEL,
        KERNEL,
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    )
    args = (
        _build.ptr(KERNEL, "usage", usage, I64, (n_rows, fr)),
        _build.ptr(KERNEL, "idx", idx, I32, (n,)),
        _build.ptr(KERNEL, "rows", rows, I64, (n, fr)),
        n_rows,
        n,
        fr,
        _build.stream_ptr(usage.device),
    )
    _build.note_launch(KERNEL)
    _build.check(fn(*args), KERNEL)
