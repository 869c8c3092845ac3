"""Planner-backed cluster placement scoring.

Tesserae (PAPERS.md) treats cluster selection as a placement-policy
problem; here the what-if planner is the placement brain: for each
candidate worker cluster the dispatcher asks "when would this cluster
admit the gang?" and mirrors to the best-ranked clusters first. A
cluster reachable only over the wire (no in-process runtime to
snapshot) scores None and ranks after every scored cluster — the
dispatcher still mirrors to it, it just never jumps the queue on a
forecast it cannot make.
"""

from __future__ import annotations

from typing import Optional


def planner_placement_score(cluster, wl) -> Optional[float]:
    """Forecast seconds until ``cluster`` would admit ``wl`` (0.0 =
    its quota clears on the next cycle), or None when unknowable —
    unreachable cluster, wire-only transport, or a shape the planner
    cannot represent. Lower is better."""
    transport = getattr(cluster, "transport", None)
    rt = getattr(transport, "runtime", None)
    if rt is None:
        return None
    client = getattr(cluster, "client", None)
    if client is not None and not client.active:
        return None
    from kueue_tpu_torch.planner import forecast_time_to_admission

    try:
        return forecast_time_to_admission(rt, wl)
    except Exception:  # noqa: BLE001 — scoring is advisory; a raising
        # score must degrade to "unranked", never break the dispatch
        return None
