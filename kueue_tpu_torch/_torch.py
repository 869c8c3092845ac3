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

import torch

__all__ = ["torch", "resolve_device", "I64", "I32", "BOOL"]

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
