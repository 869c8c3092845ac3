"""The port's hand-written CUDA kernels and their plain versions.

``KERNEL_PORTS`` is the registry of what the port has of each JAX
kernel module (the counterpart of the JAX package's
``kueue_tpu.ops.KERNEL_MIRRORS``): for each module, the JAX entry points
it ports (dotted strings, never imported here), the port's wrappers
(which launch the CUDA kernel for a CUDA tensor, or raise) and their
plain torch versions, the ``csrc/`` sources, the ``ops/_build.KERNELS``
names that count their launches, and the parity tests that hold the two
packages equal. ``kueue_tpu_torch.parallel.SHARDED_KERNELS`` names the
mesh placement entry of a module; every module there is registered
here, and tests/test_torch_parallel.py lints both registries (every
name resolves, every file exists).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple


class KernelPort(NamedTuple):
    jax: Tuple[str, ...]  # "kueue_tpu.ops.<module>:<entry>"
    wrappers: Tuple[str, ...]  # "kueue_tpu_torch.<module>:<wrapper>"
    plain: Tuple[str, ...]  # "kueue_tpu_torch.<module>:<plain version>"
    sources: Tuple[str, ...]  # repo paths under kueue_tpu_torch/csrc
    kernels: Tuple[str, ...]  # ops/_build.KERNELS names
    tests: Tuple[str, ...]  # parity test files (JAX against the port)


_OPS = "kueue_tpu_torch.ops."
_CSRC = "kueue_tpu_torch/csrc/"
# the drain family's kernels: one source, wrapper and plain version each
_DRAIN = (
    "drain_nominate", "drain_phase2", "drain_queue_motion", "drain_fair_phase2",
    "drain_preempt_search", "drain_preempt_phase2", "drain_preempt_motion",
    "drain_fair_preempt_search", "drain_fair_preempt_phase2", "drain_tas_place",
    "drain_tas_phase2",
)

KERNEL_PORTS = {
    "quota": KernelPort(
        jax=("kueue_tpu.ops.quota:subtree_quota", "kueue_tpu.ops.quota:usage_tree",
             "kueue_tpu.ops.quota:available_all",
             "kueue_tpu.ops.quota:potential_available_all",
             "kueue_tpu.ops.quota:lendable_per_resource",
             "kueue_tpu.ops.quota:dominant_resource_share"),
        wrappers=(_OPS + "quota:subtree_quota", _OPS + "quota:usage_tree",
                  _OPS + "quota:available_all", _OPS + "quota:potential_available_all",
                  _OPS + "quota:lendable_per_resource",
                  _OPS + "quota:dominant_resource_share"),
        plain=(_OPS + "quota:subtree_quota_plain", _OPS + "quota:usage_tree_plain",
               _OPS + "quota:available_all_plain",
               _OPS + "quota:potential_available_all_plain",
               _OPS + "quota:lendable_per_resource_plain",
               _OPS + "quota:dominant_resource_share_plain"),
        sources=(_CSRC + "quota_tree.cu", _CSRC + "quota_drs.cu"),
        kernels=("quota_tree", "quota_drs"),
        tests=("tests/test_torch_quota.py", "tests/test_torch_drs.py"),
    ),
    "assign_kernel": KernelPort(
        jax=("kueue_tpu.ops.assign_kernel:phase1_classify",
             "kueue_tpu.ops.assign_kernel:solve_cycle_segmented",
             "kueue_tpu.ops.assign_kernel:solve_cycle"),
        wrappers=(_OPS + "assign_kernel:phase1_classify", _OPS + "assign_kernel:cycle_phase2",
                  _OPS + "assign_kernel:cycle_global", _OPS + "resident:scatter_rows"),
        plain=(_OPS + "assign_kernel:phase1_classify_plain",
               _OPS + "assign_kernel:cycle_phase2_plain",
               _OPS + "assign_kernel:cycle_global_plain",
               _OPS + "assign_kernel:solve_cycle_plain",
               _OPS + "resident:scatter_rows_plain"),
        sources=(_CSRC + "cycle_phase1.cu", _CSRC + "cycle_phase2.cu",
                 _CSRC + "cycle_global.cu", _CSRC + "scatter_rows.cu"),
        kernels=("cycle_phase1", "cycle_phase2", "cycle_global", "scatter_rows"),
        tests=("tests/test_torch_cycle_kernel.py", "tests/test_torch_solve_cycle.py"),
    ),
    "drain_kernel": KernelPort(
        jax=("kueue_tpu.ops.drain_kernel:solve_drain",
             "kueue_tpu.ops.drain_kernel:solve_drain_fair",
             "kueue_tpu.ops.drain_kernel:solve_drain_preempt",
             "kueue_tpu.ops.drain_kernel:solve_drain_fair_preempt",
             "kueue_tpu.ops.drain_kernel:solve_drain_tas"),
        wrappers=tuple(_OPS + "drain_kernel:" + n for n in _DRAIN),
        plain=tuple(_OPS + "drain_kernel:" + n + "_plain" for n in _DRAIN),
        sources=tuple(_CSRC + n + ".cu" for n in _DRAIN),
        kernels=_DRAIN,
        tests=("tests/test_torch_drain_kernel.py", "tests/test_torch_fair_drain.py",
               "tests/test_torch_preempt_drain.py", "tests/test_torch_fair_preempt_drain.py",
               "tests/test_torch_tas_drain.py"),
    ),
    "megaloop_kernel": KernelPort(
        jax=("kueue_tpu.ops.megaloop_kernel:solve_drain_megaloop",),
        wrappers=(_OPS + "megaloop_kernel:megaloop_boundary",),
        plain=(_OPS + "megaloop_kernel:megaloop_boundary_plain",),
        sources=(_CSRC + "megaloop_boundary.cu",),
        kernels=("megaloop_boundary",),
        tests=("tests/test_torch_megaloop.py",),
    ),
    "preempt_kernel": KernelPort(
        jax=("kueue_tpu.ops.preempt_kernel:solve_preempt",),
        wrappers=(_OPS + "preempt_kernel:solve_preempt_packed",),
        plain=(_OPS + "preempt_kernel:solve_preempt",),
        sources=(_CSRC + "preempt_search.cu",),
        kernels=("preempt_search",),
        tests=("tests/test_torch_preempt.py",),
    ),
    "fair_preempt_kernel": KernelPort(
        jax=("kueue_tpu.ops.fair_preempt_kernel:solve_fair",),
        wrappers=(_OPS + "fair_preempt_kernel:solve_fair_packed",),
        plain=(_OPS + "fair_preempt_kernel:solve_fair",),
        sources=(_CSRC + "fair_search.cu",),
        kernels=("fair_search",),
        tests=("tests/test_torch_fair_preempt.py",),
    ),
    "tas_kernel": KernelPort(
        jax=("kueue_tpu.ops.tas_kernel:leaf_counts", "kueue_tpu.ops.tas_kernel:level_counts"),
        wrappers=(_OPS + "tas_kernel:leaf_counts", _OPS + "tas_kernel:level_counts"),
        plain=(_OPS + "tas_kernel:leaf_counts_plain", _OPS + "tas_kernel:level_counts_plain"),
        sources=(_CSRC + "tas_leaf_counts.cu",),
        kernels=("tas_leaf_counts",),
        tests=("tests/test_torch_tas.py",),
    ),
    "plan_kernel": KernelPort(
        jax=("kueue_tpu.ops.plan_kernel:_solve_scenarios",),
        wrappers=(_OPS + "plan_kernel:plan_quota_tree", _OPS + "plan_kernel:plan_phase1",
                  _OPS + "plan_kernel:plan_phase2"),
        plain=(_OPS + "plan_kernel:plan_quota_tree_plain", _OPS + "plan_kernel:plan_phase1_plain",
               _OPS + "plan_kernel:plan_phase2_plain"),
        sources=(_CSRC + "plan_quota_tree.cu", _CSRC + "plan_phase1.cu",
                 _CSRC + "plan_phase2.cu"),
        kernels=("plan_quota_tree", "plan_phase1", "plan_phase2"),
        tests=("tests/test_torch_plan_kernel.py",),
    ),
    "global_kernel": KernelPort(
        jax=("kueue_tpu.ops.global_kernel:solve_rescore",
             "kueue_tpu.ops.global_kernel:rescore_pairs"),
        wrappers=(_OPS + "global_kernel:rescore_packed", _OPS + "global_kernel:rescore_pairs"),
        plain=(_OPS + "global_kernel:rescore_plain", _OPS + "global_np:rescore_np"),
        sources=(_CSRC + "global_rescore.cu",),
        kernels=("global_rescore",),
        tests=("tests/test_torch_global_kernel.py", "tests/test_torch_federation.py"),
    ),
}
