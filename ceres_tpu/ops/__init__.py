"""Kernel-level operations: segment-reduction plans and small-block algebra.

The analog of the reference's ``small_blas.h`` / ``block_random_access_*``
layer: host-built reduction plans replace lock-guarded random-access
accumulation, and batched closed-form small-block algebra replaces
per-block dense kernels.
"""

from ceres_tpu.ops.reduce import (
    ReducePlan,
    apply_reduce,
    build_reduce_plan,
)

__all__ = ["ReducePlan", "apply_reduce", "build_reduce_plan"]
