"""Shared mesh harness for the cycle and the drain family (port of
kueue_tpu/parallel/harness.py).

The one place every drain (plain / megaloop / fair / preempt /
fair-preempt / TAS) and the cycle dispatch route their mesh concerns
through:

  - **mesh resolution** (``resolve_mesh``): the ``--mesh auto|N|off``
    spec -> a ``Mesh`` (or None below two devices: a one-device "mesh"
    buys nothing). ``auto`` counts CUDA cards; on the CPU ``auto`` gives
    one device (None) and ``N`` gives N virtual devices;
  - **size-bucket accounting** (``note_bucket``): every sharded solve
    registers its (kernel, padded static shapes, mesh) key, so the
    bucket reuse rate can be read (``bucket_stats``);
  - **placement accounting** (``note_place_seconds``): cumulative host
    seconds spent padding and placing drain inputs on the mesh;
  - **the narrow-panel probe** (``narrow_panels_supported``): the
    preempt drain's ``PanelTuner`` width ladder is enabled under a mesh
    only after a canary drain proves the drain at that width on that
    mesh reproduces the drain without it — see the function docstring;
  - **the sharded-entry-point registry** (``SHARDED_KERNELS``): every
    kernel module with a mesh path names its placement entry, and the
    same module must be registered in ``ops.KERNEL_PORTS`` (a sharded
    launch answers to the same plain version as its single-device
    twin; tests/test_torch_parallel.py lints it).
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

__all__ = [
    "SHARDED_KERNELS",
    "bucket_stats",
    "mesh_fingerprint",
    "mesh_shape_str",
    "narrow_panels_supported",
    "note_bucket",
    "note_panel_schedule",
    "note_place_seconds",
    "place_seconds",
    "reset_stats",
    "resolve_mesh",
]


# ---- sharded entry points ----
# JAX kernel module under ops/ -> dotted "module:attr" of the port's
# placement entry that shards it. Every key must also appear in
# ops.KERNEL_PORTS.
SHARDED_KERNELS = {
    "assign_kernel": "kueue_tpu_torch.parallel.sharded_solver:place_cycle_inputs",
    "drain_kernel": "kueue_tpu_torch.parallel.sharded_solver:place_drain_inputs",
    "preempt_kernel": "kueue_tpu_torch.parallel.sharded_solver:place_preempt_drain_inputs",
    "fair_preempt_kernel": (
        "kueue_tpu_torch.parallel.sharded_solver:place_fair_preempt_drain_inputs"
    ),
    "tas_kernel": "kueue_tpu_torch.parallel.sharded_solver:place_tas_drain_inputs",
}


# ---- mesh resolution (--mesh auto|N|off) ----
def resolve_mesh(spec, fr_parallel: bool = False, device=None):
    """Operator spec -> Mesh or None.

    ``None``/``"off"``/``""`` -> None; ``"auto"`` -> every CUDA card
    (on the CPU: one device); ``N`` (int or digit string) -> the first
    N cards (on the CPU: N virtual devices). Any resolution with fewer
    than 2 devices returns None — a one-device mesh buys nothing."""
    if spec is None or spec in ("off", ""):
        return None
    from kueue_tpu_torch._torch import resolve_device, torch
    from kueue_tpu_torch.parallel.sharded_solver import make_mesh

    dev = resolve_device(device)
    have = torch.cuda.device_count() if dev.type == "cuda" else None
    if spec == "auto":
        n = have if have is not None else 1
    else:
        n = int(spec)
        if have is not None:
            n = min(n, have)
    if n < 2:
        return None
    return make_mesh(n, fr_parallel=fr_parallel, device=dev)


def mesh_fingerprint(mesh) -> tuple:
    """Hashable identity of a mesh: (axis layout, devices as (type,
    index)). Keys the narrow-panel verdicts and the bucket accounting."""
    shape = mesh.shape
    return (
        tuple((a, int(shape[a])) for a in mesh.axis_names),
        tuple((d.type, -1 if d.index is None else int(d.index)) for d in mesh.devices.flat),
    )


def mesh_shape_str(mesh) -> str:
    """Human/metric label: "off", "wl=8", "wl=4,fr=2"."""
    if mesh is None:
        return "off"
    shape = mesh.shape
    return ",".join(f"{a}={int(shape[a])}" for a in mesh.axis_names)


# ---- size-bucket + placement accounting ----
_LOCK = threading.Lock()
# (kernel, shapes-key, mesh-fingerprint-or-None) -> times seen
_BUCKETS: Dict[tuple, int] = {}
_PLACE_SECONDS = [0.0]
# the last panel schedule the preempt drain ran under a mesh:
# {"widths": tuple, "fenced": bool}
_LAST_PANEL: Dict[str, object] = {}


def note_bucket(kernel: str, shapes_key: tuple, mesh=None) -> bool:
    """Register one solve's shape key; True = the bucket was seen
    before."""
    key = (kernel, shapes_key, mesh_fingerprint(mesh) if mesh is not None else None)
    with _LOCK:
        seen = _BUCKETS.get(key, 0)
        _BUCKETS[key] = seen + 1
    return seen > 0


def bucket_stats() -> dict:
    """{"buckets", "hits", "misses", "perKernel": {kernel: {...}}} —
    one miss per distinct key, the rest are hits."""
    with _LOCK:
        items = list(_BUCKETS.items())
    per: Dict[str, Dict[str, int]] = {}
    for (kernel, _k, _m), n in items:
        st = per.setdefault(kernel, {"buckets": 0, "hits": 0, "misses": 0})
        st["buckets"] += 1
        st["misses"] += 1
        st["hits"] += n - 1
    return {
        "buckets": sum(s["buckets"] for s in per.values()),
        "hits": sum(s["hits"] for s in per.values()),
        "misses": sum(s["misses"] for s in per.values()),
        "perKernel": per,
    }


def note_place_seconds(dt: float) -> None:
    with _LOCK:
        _PLACE_SECONDS[0] += float(dt)


def place_seconds() -> float:
    """Cumulative host seconds spent placing sharded inputs."""
    with _LOCK:
        return _PLACE_SECONDS[0]


def note_panel_schedule(widths: Tuple[int, ...], fenced: bool) -> None:
    with _LOCK:
        _LAST_PANEL["widths"] = tuple(int(w) for w in widths)
        _LAST_PANEL["fenced"] = bool(fenced)


def last_panel_schedule() -> dict:
    with _LOCK:
        return dict(_LAST_PANEL)


def reset_stats() -> None:
    """Test hook: clear bucket/placement accounting (NOT the probe
    verdicts — those are per-mesh facts, not run state)."""
    with _LOCK:
        _BUCKETS.clear()
        _PLACE_SECONDS[0] = 0.0
        _LAST_PANEL.clear()


# ---- the narrow-panel probe ----
# (mesh fingerprint, width) -> bool (that panel width safe on this mesh)
_NARROW_VERDICTS: Dict[tuple, bool] = {}


def _canary_preempt_case():
    """A minimal contended cohort exercising the narrow-panel victim
    search end to end: one hoarder ClusterQueue saturated ABOVE nominal
    (borrowing; never preempts) and one reclaimer whose higher-priority
    backlog can only start by cross-CQ reclaim — so the probe drain
    runs the strategy ladder, the candidate compaction, and at least
    one eviction. Returns (snapshot, pending, flavors)."""
    from kueue_tpu_torch.core.cache import Cache
    from kueue_tpu_torch.core.snapshot import take_snapshot
    from kueue_tpu_torch.core.workload_info import make_admission
    from kueue_tpu_torch.models import (
        ClusterQueue,
        FlavorQuotas,
        Preemption,
        ResourceFlavor,
        Workload,
    )
    from kueue_tpu_torch.models.cluster_queue import ResourceGroup
    from kueue_tpu_torch.models.constants import (
        PreemptionPolicy,
        ReclaimWithinCohortPolicy,
        WorkloadConditionType,
    )
    from kueue_tpu_torch.models.workload import PodSet

    cache = Cache()
    cache.add_or_update_flavor(ResourceFlavor(name="probe-fl"))
    specs = [
        ("probe-hoard", Preemption()),
        (
            "probe-reclaim",
            Preemption(
                within_cluster_queue=PreemptionPolicy.LOWER_PRIORITY,
                reclaim_within_cohort=ReclaimWithinCohortPolicy.ANY,
            ),
        ),
    ]
    for name, prem in specs:
        cache.add_or_update_cluster_queue(
            ClusterQueue(
                name=name,
                cohort="probe-cohort",
                namespace_selector={},
                resource_groups=(
                    ResourceGroup(
                        ("cpu",),
                        (FlavorQuotas.build("probe-fl", {"cpu": "8"}),),
                    ),
                ),
                preemption=prem,
            )
        )
    # hoarder: 6 x 2 = 12 > nominal 8 (borrows 4 from the cohort)
    for v in range(6):
        wl = Workload(
            namespace="probe", name=f"victim-{v}",
            queue_name="lq-probe-hoard", priority=v % 3,
            creation_time=float(v),
            pod_sets=(PodSet.build("main", 1, {"cpu": "2"}),),
        )
        wl.admission = make_admission("probe-hoard", {"main": {"cpu": "probe-fl"}}, wl)
        wl.set_condition(
            WorkloadConditionType.QUOTA_RESERVED, True,
            reason="QuotaReserved", now=float(v),
        )
        cache.add_or_update_workload(wl)
    pending = [
        (
            Workload(
                namespace="probe", name=f"head-{w}",
                queue_name="lq-probe-reclaim", priority=100,
                creation_time=100.0 + w,
                pod_sets=(PodSet.build("main", 1, {"cpu": "5"}),),
            ),
            "probe-reclaim",
        )
        for w in range(3)
    ]
    return take_snapshot(cache), pending, dict(cache.flavors)


def _preempt_sig(outcome) -> tuple:
    return (
        frozenset((wl.name, cyc) for wl, _, _, cyc in outcome.admitted),
        frozenset((wl.name, cyc) for wl, _, cyc in outcome.preempted),
        frozenset(wl.name for wl, _ in outcome.parked),
        outcome.cycles,
    )


def narrow_panels_supported(mesh, width: int = 8) -> bool:
    """Is THIS narrow panel width trustworthy on this mesh?

    In the JAX package the GSPMD partitioner miscompiled the
    narrow-panel candidate compaction at small static widths, which
    would silently change preemption decisions — the one failure the
    ``overflowed`` escape hatch cannot catch (a wrong answer is not an
    overflow). The port keeps the fence as a contract of
    ``run_drain_preempt`` under a mesh: each ladder rung is enabled only
    after a canary proves it. A tiny contended drain runs at that width
    on the mesh (the port's own kernels on the mesh's device) and must
    reproduce the drain without the mesh bit for bit. A mismatch — or
    any error other than a kernel's own failure (``KernelError``, which
    propagates) — marks the width unsupported, and ``mesh_safe_widths``
    clamps the schedule to the next supported rung (ending at the exact
    ``search_width``). Verdicts are memoized per (mesh fingerprint,
    width): one probe per process per pair."""
    key = (mesh_fingerprint(mesh), int(width))
    verdict = _NARROW_VERDICTS.get(key)
    if verdict is None:
        verdict = _probe_narrow_panels(mesh, int(width))
        _NARROW_VERDICTS[key] = verdict
    return verdict


def probe_verdicts() -> Dict[tuple, bool]:
    """The memoized canary verdicts: (mesh fingerprint, width) -> safe."""
    return dict(_NARROW_VERDICTS)


def demote_panel_width(mesh, width: int) -> None:
    """Mark a panel width unsupported on this mesh after a live failure
    at it; future schedules clamp past the width without re-trying it."""
    _NARROW_VERDICTS[(mesh_fingerprint(mesh), int(width))] = False


def mesh_safe_widths(mesh, widths: Tuple[int, ...]) -> Tuple[int, ...]:
    """Clamp a panel schedule's narrow rungs to mesh-supported widths.

    Each narrow rung walks UP (doubling) until a probed-safe width is
    found; rungs that reach the final (exact) width drop out. The final
    width is never probed or dropped — it is the trusted exact width,
    and an escalated run at it IS the single-width launch. Returns the
    original schedule when every rung is safe."""
    final = int(widths[-1])
    out = []
    for w in widths[:-1]:
        ww = int(w)
        while ww < final and not narrow_panels_supported(mesh, ww):
            ww = min(final, max(ww * 2, 8))
        if ww < final and ww not in out:
            out.append(ww)
    return tuple(out) + (final,)


def _probe_narrow_panels(mesh, width: int) -> bool:
    from kueue_tpu_torch.core.drain import run_drain_preempt
    from kueue_tpu_torch.ops._build import KernelError
    from kueue_tpu_torch.parallel.sharded_solver import mesh_device

    dev = mesh_device(mesh)
    try:
        snap_ref, pending_ref, flavors = _canary_preempt_case()
        ref = run_drain_preempt(
            snap_ref, pending_ref, flavors, panel_widths=(width,), device=dev,
        )
        snap_m, pending_m, flavors_m = _canary_preempt_case()
        got = run_drain_preempt(
            snap_m, pending_m, flavors_m, panel_widths=(width,),
            mesh=mesh, _trust_panel_widths=True,
        )
    except KernelError:
        raise  # a kernel that fails is no verdict on the mesh: never contained
    except Exception:  # noqa: BLE001 — a canary that errs IS a verdict
        return False
    if not ref.preempted:
        # a canary that exercised no eviction proves nothing: refuse to
        # certify the mesh on vacuous evidence
        return False
    return _preempt_sig(ref) == _preempt_sig(got)
