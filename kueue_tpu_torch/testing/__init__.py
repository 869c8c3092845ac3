"""Test-support machinery shipped with the package.

``faults`` is the named fault-injection harness the durability chaos
tests drive: production code calls ``faults.fire("<point>")`` at its
registered crash/fault points (a no-op dict probe unless a test armed
the point), so the exact crash windows the recovery story depends on
are exercisable without monkeypatching internals.
"""

from kueue_tpu_torch.testing import faults  # noqa: F401

__all__ = ["faults"]
