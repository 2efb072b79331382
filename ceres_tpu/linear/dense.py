"""Dense linear solvers: QR and normal-equations Cholesky.

JAX analog of ``internal/ceres/dense_qr_solver.{h,cc}`` /
``dense_qr.h:62-152`` and ``dense_normal_cholesky_solver.{h,cc}`` /
``dense_cholesky.h:58-246``. The reference dispatches to
Eigen/LAPACK/cuSOLVER; here both paths are single XLA computations
(``jnp.linalg``) so they fuse with the Jacobian materialization and run on
device. Used for small/medium dense problems (NIST, curve fitting) and the
reduced camera system of DENSE_SCHUR.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ceres_tpu.evaluator import JacobianContext


def solve_dense_normal_cholesky(
    ctx: JacobianContext, D: jax.Array, rhs: jax.Array | None = None
) -> jax.Array:
    """Solve (J'J + D'D) y = rhs (default rhs = J'f) via Cholesky.

    Analog of DenseNormalCholeskySolver (dense_normal_cholesky_solver.cc):
    forms the normal equations (the reference uses small_blas GEMM; here one
    matmul) and factorizes. The arbitrary-rhs form backs mixed-precision
    iterative refinement (iterative_refiner.{h,cc}).
    """
    J = ctx.to_dense()
    lhs = J.T @ J + jnp.diag(D * D)
    if rhs is None:
        rhs = J.T @ ctx.residual_vector()
    chol, lower = jax.scipy.linalg.cho_factor(lhs, lower=True)
    return jax.scipy.linalg.cho_solve((chol, lower), rhs)


def solve_dense_qr(
    ctx: JacobianContext, D: jax.Array, rhs: jax.Array | None = None
) -> jax.Array:
    """Solve min ||J y - f||^2 + ||D y||^2 via QR of the stacked system.

    Analog of DenseQRSolver (dense_qr_solver.cc): appends the diagonal D as
    extra rows [J; diag(D)] with zero rhs rows, then QR + triangular solve.
    More numerically robust than the normal equations (used by the NIST
    experiments, examples/nist.cc).

    With an explicit ``rhs`` (tangent space), solves
    (J'J + D'D) y = rhs = R'R y through two triangular solves with the
    same R factor.
    """
    J = ctx.to_dense()
    f = ctx.residual_vector()
    n = J.shape[1]
    A = jnp.concatenate([J, jnp.diag(D)], axis=0)
    if rhs is not None:
        R = jnp.linalg.qr(A, mode="r")
        z = jax.scipy.linalg.solve_triangular(
            R.T, rhs, lower=True
        )
        return jax.scipy.linalg.solve_triangular(R, z, lower=False)
    b = jnp.concatenate([f, jnp.zeros((n,), dtype=f.dtype)])
    Q, R = jnp.linalg.qr(A, mode="reduced")
    qtb = Q.T @ b
    return jax.scipy.linalg.solve_triangular(R, qtb, lower=False)
