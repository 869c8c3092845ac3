"""Central torch import and device choice for kueue_tpu_torch.

The counterpart of ``kueue_tpu/_jax.py``. Quota quantities are canonical
int64 (milli-CPU / bytes): values like 64Gi overflow int32, so every
quota and usage tensor of the port is int64 end to end, and every
tensor is built with an explicit dtype.

Entry points run on the card. ``resolve_device(None)`` is ``cuda`` and
raises where there is none; only an explicit ``device="cpu"`` runs the
plain torch versions on the host (what the CPU tests do). There is no
silent fallback.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["torch", "resolve_device", "to_device", "I64", "I32", "BOOL"]

I64 = torch.int64
I32 = torch.int32
BOOL = torch.bool


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another. Raises when CUDA is asked for (or implied) and no
    card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "kueue_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain torch versions on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_device(a, device, dtype=None) -> torch.Tensor:
    """A copy of the array ``a`` (numpy dtype ``dtype`` when given) on
    ``device``. The copy to a card does not wait for the card's queued
    work: the host buffer is staged before the call returns and the
    transfer runs in stream order, so a launch path that uploads its
    inputs makes no host sync."""
    t = torch.from_numpy(np.array(a, dtype=dtype, copy=True))
    return t.to(device, non_blocking=True)
