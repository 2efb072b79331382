"""CGNR: conjugate gradients on the normal equations.

JAX analog of ``internal/ceres/cgnr_solver.{h,cc}:84-121``: solves

    (J'J + D'D) y = J'f

matrix-free through the batched-block Jacobian (JacobianContext.normal_matvec
— two fused einsum passes per CG iteration, the analog of the reference's
SpMV + transposed SpMV). The whole Krylov loop is one XLA while_loop, like
the reference's all-on-GPU CudaCgnrSolver.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp

from ceres_tpu.evaluator import JacobianContext
from ceres_tpu.linear.cg import CGResult, conjugate_gradients
from ceres_tpu.linear import preconditioners as precond
from ceres_tpu.types import PreconditionerType


def solve_cgnr(
    ctx: JacobianContext,
    D: jax.Array,
    preconditioner_type: PreconditionerType = PreconditionerType.JACOBI,
    bd_groups: Optional[Dict[int, jax.Array]] = None,
    max_num_iterations: int = 500,
    min_num_iterations: int = 1,
    q_tolerance: float = 0.1,
    r_tolerance: float = -1.0,
    rhs: Optional[jax.Array] = None,
    subset_masks=None,
) -> CGResult:
    """Returns CGResult whose .x solves min ||J y - f||^2 + ||D y||^2,
    or (J'J + D'D) y = rhs when an explicit tangent rhs is given."""

    def operator(v):
        return ctx.normal_matvec(v) + (D * D) * v

    if preconditioner_type == PreconditionerType.IDENTITY:
        M = precond.identity_preconditioner()
    elif preconditioner_type == PreconditionerType.JACOBI:
        if bd_groups is not None:
            M = precond.block_jacobi_preconditioner(ctx, bd_groups, D)
        else:
            M = precond.scalar_jacobi_preconditioner(ctx, D)
    elif (
        preconditioner_type == PreconditionerType.SUBSET
        and subset_masks is not None
    ):
        M = precond.subset_preconditioner(ctx, subset_masks, D)
    else:
        raise ValueError(
            f"CGNR supports IDENTITY/JACOBI/SUBSET, got {preconditioner_type}"
        )

    if rhs is None:
        rhs = ctx.gradient()  # J'f
    return conjugate_gradients(
        operator,
        rhs,
        preconditioner=M,
        max_num_iterations=max_num_iterations,
        min_num_iterations=min_num_iterations,
        q_tolerance=q_tolerance,
        r_tolerance=r_tolerance,
    )
