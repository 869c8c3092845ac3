"""Device-mesh placement of the admission cycle and the drain family
(port of kueue_tpu/parallel).

``sharded_solver`` owns the mesh, the placement entries and
``ShardedSolver`` (the unsegmented cycle, kernel B3', over a mesh);
``harness`` owns what is shared around them: mesh resolution for a
``--mesh`` spec, size-bucket and placement accounting, the narrow-panel
canary of the preempt drain, and the sharded-entry-point registry
linted against ``ops.KERNEL_PORTS``. A mesh over one device (a card, or
the CPU's virtual devices) runs every path; a mesh over several
distinct devices raises NotImplementedError (ROADMAP A11).
"""

from kueue_tpu_torch.parallel.harness import (
    SHARDED_KERNELS,
    bucket_stats,
    mesh_safe_widths,
    mesh_shape_str,
    narrow_panels_supported,
    resolve_mesh,
)
from kueue_tpu_torch.parallel.sharded_solver import ShardedSolver, make_mesh

__all__ = [
    "SHARDED_KERNELS",
    "ShardedSolver",
    "bucket_stats",
    "make_mesh",
    "mesh_safe_widths",
    "mesh_shape_str",
    "narrow_panels_supported",
    "resolve_mesh",
]
