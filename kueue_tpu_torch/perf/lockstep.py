"""Hold every kernel of the drain to its plain version, step by step.

``lockstep`` runs a drain on the kernels and, before every kernel step,
copies the state; the plain version of that step runs on the copy, and
the two results must be equal in every field (int64, tolerance 0). On
the card this checks each CUDA kernel at every cycle of a real drain;
on the CPU both sides are the plain versions (a check of the harness).
chip_smoke.py and tests/test_torch_cuda.py use it.
"""

from __future__ import annotations

import time
from dataclasses import fields
from typing import Dict, List, Optional

from kueue_tpu_torch._torch import torch
from kueue_tpu_torch.ops import drain_kernel as dk
from kueue_tpu_torch.ops import quota


class LockstepMismatch(AssertionError):
    """A kernel step disagreed with its plain version."""


def _usage_kernel(ctx, s, b):
    quota.usage_tree(ctx.tree, ctx.guaranteed, s.local, out=b.usage, done=s.done)


def _usage_plain(ctx, s, b):
    if not s.done.item():
        b.usage.copy_(quota.usage_tree_plain(ctx.tree, ctx.guaranteed, s.local))


def _avail_kernel(ctx, s, b):
    quota.available_all(
        ctx.tree, ctx.subtree, ctx.guaranteed, b.usage, out=b.avail, done=s.done
    )


def _avail_plain(ctx, s, b):
    if not s.done.item():
        b.avail.copy_(
            quota.available_all_plain(ctx.tree, ctx.subtree, ctx.guaranteed, b.usage)
        )


# (kernel name, kernel step, plain step) of one drain cycle, in order;
# each acts in place on (ctx, state, buf)
STEPS = (
    ("quota_tree", _usage_kernel, _usage_plain),
    ("quota_tree", _avail_kernel, _avail_plain),
    ("drain_nominate", dk.drain_nominate, dk.drain_nominate_plain),
    ("drain_phase2", dk.drain_phase2, dk.drain_phase2_plain),
    ("drain_queue_motion", dk.drain_queue_motion, dk.drain_queue_motion_plain),
)


def max_abs_diff(a, b, skip=()) -> int:
    """Largest |a.f - b.f| over the tensor fields of two dataclasses."""
    err = 0
    for f in fields(a):
        if f.name in skip:
            continue
        x = getattr(a, f.name).to(torch.int64)
        y = getattr(b, f.name).to(torch.int64)
        if x.shape != y.shape:
            raise LockstepMismatch(f"{f.name}: shapes {tuple(x.shape)} vs {tuple(y.shape)}")
        if x.numel():
            err = max(err, int((x - y).abs().max().item()))
    return err


def lockstep(
    tree, local, queues, paths, n_segments, n_steps, max_cycles,
    errs: Dict[str, int], label: str = "",
    plain_ms: Optional[Dict[str, List[float]]] = None,
):
    """Drain on the kernels, checking every step against its plain
    version; ``errs`` collects the largest difference per kernel (0 on
    success). When ``plain_ms`` is given, it collects each plain step's
    wall time in ms (host and card, synchronised on both sides).
    Returns (ctx, final state, cycles). Raises LockstepMismatch on the
    first difference."""
    sub_k, g_k = quota.subtree_quota(tree)
    sub_p, g_p = quota.subtree_quota_plain(tree)
    pot_k = quota.potential_available_all(tree, sub_k, g_k)
    pot_p = quota.potential_available_all_plain(tree, sub_p, g_p)
    e = max(
        int((sub_k - sub_p).abs().max()),
        int((g_k - g_p).abs().max()),
        int((pot_k - pot_p).abs().max()),
    )
    errs["quota_tree"] = max(errs.get("quota_tree", 0), e)
    if e:
        raise LockstepMismatch(f"{label}: quota_tree subtree/potential differ by {e}")

    ctx = dk.DrainContext.build(tree, queues, paths, n_segments, n_steps, max_cycles)
    state = dk.DrainState.initial(local, queues, max_cycles)
    buf = dk.CycleBuffers.empty(local, queues)
    buf.usage.zero_()
    buf.avail.zero_()
    cycles = 0
    while not state.done.item():
        if cycles > max_cycles:
            raise LockstepMismatch(f"{label}: the drain ran past max_cycles")
        for name, kern, plain in STEPS:
            ps, pb = state.clone(), buf.clone()
            kern(ctx, state, buf)
            if plain_ms is None:
                plain(ctx, ps, pb)
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                plain(ctx, ps, pb)
                torch.cuda.synchronize()
                plain_ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
            # buf.order is kernel 3's scratch; the plain version has none
            e = max(max_abs_diff(state, ps), max_abs_diff(buf, pb, skip=("order",)))
            errs[name] = max(errs.get(name, 0), e)
            if e:
                raise LockstepMismatch(
                    f"{label}: {name} differs from its plain version by {e} "
                    f"at cycle {cycles}"
                )
        cycles += 1
    return ctx, state, cycles
