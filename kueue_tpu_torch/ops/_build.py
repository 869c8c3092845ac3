"""Build and load the hand-written CUDA kernels (``kueue_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``.
Nothing is built at import: the first ``library(name)`` (or an explicit
``build_all()``) builds every source in parallel, one ``nvcc`` process
per source, all started together. Libraries land in
``kueue_tpu_torch/_build/`` (git-ignored), named by a hash of their
source, so an edited source rebuilds and an unchanged one is reused.

Every C entry point takes its pointers and the CUDA stream as
``void*``, launches on that stream, does not synchronise, and returns
``cudaGetLastError()``; ``check(rc, name)`` raises when it is not 0.

A kernel that cannot be built or loaded, refuses its input or fails to
launch raises ``KernelError`` (``KernelInputError`` for refused input,
also a ValueError). Nothing in the port contains it: the cycle's guard
re-raises it rather than solving on the host while the card sits idle.

``LAUNCHES`` counts kernel launches per kernel name. A wrapper adds one
where it launches its kernel and nowhere else, so a run can show that
its main path really went through the kernels (``reset_launches`` /
``launch_counts``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

KERNELS = (
    "quota_tree", "drain_nominate", "drain_phase2", "drain_queue_motion",
    "cycle_phase1", "cycle_phase2", "scatter_rows",
    "megaloop_boundary", "drain_fair_phase2",
)
# the kernels of each path: the plain drain (ops/drain_kernel.solve_drain),
# the megaloop (ops/megaloop_kernel.solve_drain_megaloop), the fair drain
# (ops/drain_kernel.solve_drain with fair=), and the interactive cycle
# (core/solver.dispatch_lowered and the resident row scatter)
DRAIN_KERNELS = ("quota_tree", "drain_nominate", "drain_phase2", "drain_queue_motion")
MEGALOOP_KERNELS = DRAIN_KERNELS + ("megaloop_boundary",)
FAIR_KERNELS = ("quota_tree", "drain_nominate", "drain_fair_phase2", "drain_queue_motion")
CYCLE_KERNELS = ("quota_tree", "cycle_phase1", "cycle_phase2", "scatter_rows")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[tuple, object] = {}
_LOCK = threading.Lock()


class KernelError(RuntimeError):
    """A hand-written kernel could not be built or loaded, or failed to
    launch."""


class KernelInputError(KernelError, ValueError):
    """A kernel refused its input (device, dtype, layout or shape)."""


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def note_launch(name: str) -> None:
    LAUNCHES[name] += 1


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    """The library path, named by a hash of the source, the shared
    headers and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """(target, Popen or None when already built)."""
    target = _target(name)
    if target.exists():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return target, (proc, tmp)


def _finish(name: str, target: Path, pending) -> None:
    if pending is None:
        return
    proc, tmp = pending
    out, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(out)
    if proc.returncode != 0:
        raise KernelError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, target)


def build_all(names: List[str] = KERNELS) -> float:
    """Build every kernel library (in parallel); returns the seconds it
    took. Already-built, unchanged sources are reused."""
    t0 = time.perf_counter()
    with _LOCK:
        started = [(n, *_start(n)) for n in names]
        try:
            for n, target, pending in started:
                _finish(n, target, pending)
        finally:
            for _, _, pending in started:
                if pending is not None and pending[0].poll() is None:
                    pending[0].kill()
                    pending[0].wait()
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, spills) of the last
    build of ``name``, or '' when it was reused."""
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``. The first use builds every
    kernel that is not built yet, in parallel."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        try:
            lib = ctypes.CDLL(str(_target(name)))
        except OSError as exc:
            raise KernelError(f"cannot load the library of {name}: {exc}") from exc
        _LIBS[name] = lib
    return lib


def load(names=KERNELS) -> None:
    """Build (where needed) and load the libraries of ``names`` now, so
    that a missing or broken toolchain raises here and not at the first
    launch."""
    for name in names:
        library(name)


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise KernelError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def ptr(kernel: str, name: str, t, dtype, shape=None):
    """data_ptr of ``t`` after checking that a kernel can take it: a
    contiguous CUDA tensor of ``dtype`` (and ``shape`` when given).
    None passes through as a NULL pointer."""
    if t is None:
        return None
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
        raise KernelInputError(
            f"{kernel}: {name} must be a contiguous CUDA {dtype} tensor, "
            f"got {t.dtype} on {t.device}"
        )
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise KernelInputError(
            f"{kernel}: {name} has shape {tuple(t.shape)}, want {tuple(shape)}"
        )
    return t.data_ptr()


def c_function(kernel: str, symbol: str, argtypes):
    """The C entry ``symbol`` of kernel ``kernel``'s library, with its
    argument types declared (cached)."""
    key = (kernel, symbol)
    fn = _FNS.get(key)
    if fn is None:
        fn = getattr(library(kernel), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        _FNS[key] = fn
    return fn
