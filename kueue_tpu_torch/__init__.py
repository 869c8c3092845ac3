"""kueue_tpu_torch — the PyTorch/CUDA port of kueue_tpu.

The same admission semantics as ``kueue_tpu`` (the JAX reference, which
stays beside it unchanged), with the device work done by PyTorch
tensors and by CUDA C++ kernels written by hand for Hopper (sm_90a).
The port imports no JAX and nothing of ``kueue_tpu``: host-only
modules are copied here with the same layout and public names, so one
parity harness can drive both packages.

Package layout (six slices: the plain bulk drain; the interactive
admission cycle; the megaloop and the fair-sharing drain; classic
preemption; fair-sharing preemption; Topology-Aware Scheduling):
  models/      API object model (copied from kueue_tpu.models)
  core/        cache, snapshot, encode (with the resident encoder),
               queue manager, flavor assigner, preemption and its
               batched lowering, the fair-sharing iterator, solver
               lowering and dispatch, guard, scheduler, drain glue, the
               drain rounds' conflict checks (pipeline)
  tas/         Topology-Aware Scheduling: the TAS cache, the per-cycle
               flavor snapshot and its placement, the Scheduler's TAS
               hooks (copied host code; fleet-size pod counting on the
               card)
  ops/         quota recurrences, the cycle solver, the resident row
               scatter, the batched classic and fair victim searches,
               the plain, fair, preempt, fair-preempt and TAS drains,
               the megaloop and TAS pod counting: plain torch versions
               plus the wrappers that launch the CUDA kernels; numpy
               mirrors of the drain and megaloop
  csrc/        the CUDA C++ kernels (built by ops/_build.py at first use)
  planner/     the cycle solve's host mirror (solve_scenario_host)
  tracing/, testing/, features.py, utils/   host support (copied)
  perf/        the headline, contended, fair-preempt and TAS clusters,
               backlog, megaloop chain and cycle runs, seeded cases,
               the kernel-vs-plain lockstep
  interop.py   numpy arrays -> the port's device inputs

Entry points run on the card; ``device="cpu"`` asks for the plain torch
versions on the host instead (see ``_torch.resolve_device``).
"""

__version__ = "0.1.0"
