"""Linear solvers for the trust-region subproblem.

JAX analog of the reference's linear solver layer
(``internal/ceres/linear_solver.h``, §2.5 of SURVEY.md). All solvers solve

    min_y || J y - f ||^2 + || D y ||^2

(the reference's convention — levenberg_marquardt_strategy.cc:112-116 solves
``Jy = r`` then negates), where J arrives as a
:class:`ceres_tpu.evaluator.JacobianContext` (batched block form), f is the
corrected residual vector and D the LM diagonal.
"""

from ceres_tpu.linear.dense import (
    solve_dense_normal_cholesky,
    solve_dense_qr,
)
from ceres_tpu.linear.cg import conjugate_gradients
from ceres_tpu.linear.cgnr import solve_cgnr

__all__ = [
    "solve_dense_normal_cholesky",
    "solve_dense_qr",
    "conjugate_gradients",
    "solve_cgnr",
]
