"""kueue_tpu_torch — the PyTorch/CUDA port of kueue_tpu.

The same admission semantics as ``kueue_tpu`` (the JAX reference, which
stays beside it unchanged), with the device work done by PyTorch
tensors and by CUDA C++ kernels written by hand for Hopper (sm_90a).
The port imports no JAX and nothing of ``kueue_tpu``: host-only
modules are copied here with the same layout and public names, so one
parity harness can drive both packages.

Package layout (two slices: the plain bulk drain and the interactive
admission cycle):
  models/      API object model (copied from kueue_tpu.models)
  core/        cache, snapshot, encode, queue manager, flavor assigner,
               preemption, solver lowering and dispatch, guard,
               scheduler, drain glue
  ops/         quota recurrences, the cycle solver, the resident row
               scatter and the plain drain: plain torch versions plus
               the wrappers that launch the CUDA kernels
  csrc/        the CUDA C++ kernels (built by ops/_build.py at first use)
  planner/     the cycle solve's host mirror (solve_scenario_host)
  tracing/, testing/, features.py, utils/   host support (copied)
  perf/        the headline cluster, backlog and cycle run, seeded cases,
               the kernel-vs-plain lockstep
  interop.py   numpy arrays -> the port's device inputs

Entry points run on the card; ``device="cpu"`` asks for the plain torch
versions on the host instead (see ``_torch.resolve_device``).
"""

__version__ = "0.1.0"
