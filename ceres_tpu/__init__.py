"""ceres_tpu — a JAX nonlinear least-squares framework.

A from-scratch JAX/XLA re-design of the capabilities of Ceres Solver
(reference: /root/reference, C++/CUDA). Not a port: the pointer-graph of
parameter/residual blocks becomes batched pytree "residual families", Jet
dual-number autodiff becomes `jax.jacfwd` over `vmap`ped residual kernels,
the threaded evaluator becomes one jitted evaluation, and linear solvers are
built from batched dense blocks + segment reductions + XLA collectives.

Main entry points
-----------------
- :class:`ceres_tpu.Problem` — build a problem from residual families
  (analog of ``include/ceres/problem.h``).
- :func:`ceres_tpu.solve` / :class:`ceres_tpu.SolverOptions` — solve it
  (analog of ``include/ceres/solver.h``).
- :mod:`ceres_tpu.loss` — robust losses (``include/ceres/loss_function.h``).
- :mod:`ceres_tpu.manifold` — manifolds (``include/ceres/manifold.h``).
- :mod:`ceres_tpu.rotation` — rotation toolbox (``include/ceres/rotation.h``).
"""

import os

import jax

# Precision policy, in one place:
# - Nonlinear least squares at Ceres-equivalent tolerances (1e-6 relative
#   cost, NIST LRE ~9-10 digits) requires float64, so x64 is on.
# - float32 (``SolverOptions.evaluation_dtype``) is an opt-in per solve.
#   Its matrix products run in full f32: "highest" keeps GPUs from
#   rounding f32 operands to TF32 (~3 decimal digits), which would break
#   the symmetry and accuracy of the Schur complement and of the one-hot
#   reductions of gradients and J'J blocks.
if os.environ.get("CERES_TPU_NO_X64", "0") != "1":
    jax.config.update("jax_enable_x64", True)
jax.config.update("jax_default_matmul_precision", "highest")

from ceres_tpu.types import (  # noqa: E402
    LinearSolverOrderingType,
    LinearSolverType,
    PreconditionerType,
    TrustRegionStrategyType,
    LineSearchDirectionType,
    LineSearchType,
    MinimizerType,
    TerminationType,
    CallbackReturnType,
    DoglegType,
    CovarianceAlgorithmType,
    NumericDiffMethodType,
    NonlinearConjugateGradientType,
    LoggingType,
)
from ceres_tpu import loss  # noqa: E402
from ceres_tpu import manifold  # noqa: E402
from ceres_tpu import rotation  # noqa: E402
from ceres_tpu.loss import (  # noqa: E402
    TrivialLoss,
    HuberLoss,
    SoftLOneLoss,
    CauchyLoss,
    ArctanLoss,
    TolerantLoss,
    TukeyLoss,
    ScaledLoss,
    ComposedLoss,
    LossFunctionWrapper,
)
from ceres_tpu.manifold import (  # noqa: E402
    EuclideanManifold,
    SubsetManifold,
    QuaternionManifold,
    EigenQuaternionManifold,
    SphereManifold,
    LineManifold,
    ProductManifold,
)
from ceres_tpu.problem import Problem  # noqa: E402
from ceres_tpu.solver import SolverOptions, SolverSummary, solve  # noqa: E402
from ceres_tpu.gradient_problem import (  # noqa: E402
    GradientProblem,
    GradientProblemOptions,
    solve_gradient_problem,
)
from ceres_tpu.covariance import Covariance, CovarianceOptions  # noqa: E402
from ceres_tpu.tiny_solver import TinySolver, tiny_solve  # noqa: E402
from ceres_tpu.numeric_diff import (  # noqa: E402
    NumericDiffOptions,
    numeric_diff,
    numeric_diff_jacobian,
)
from ceres_tpu.interpolation import (  # noqa: E402
    BiCubicInterpolator,
    CubicInterpolator,
    Grid1D,
    Grid2D,
)
from ceres_tpu import cost_functions  # noqa: E402
from ceres_tpu.cost_functions import (  # noqa: E402
    EvaluationCallback,
    analytic_cost,
)
from ceres_tpu.fused_lm import fused_solve  # noqa: E402
from ceres_tpu.ordered_groups import OrderedGroups  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "Problem",
    "SolverOptions",
    "SolverSummary",
    "solve",
    "GradientProblem",
    "GradientProblemOptions",
    "solve_gradient_problem",
    "Covariance",
    "CovarianceOptions",
    "TinySolver",
    "tiny_solve",
    "NumericDiffOptions",
    "numeric_diff",
    "numeric_diff_jacobian",
    "CubicInterpolator",
    "BiCubicInterpolator",
    "Grid1D",
    "Grid2D",
    "cost_functions",
    "EvaluationCallback",
    "analytic_cost",
    "fused_solve",
    "loss",
    "manifold",
    "rotation",
    "LinearSolverOrderingType",
    "LinearSolverType",
    "PreconditionerType",
    "TrustRegionStrategyType",
    "LineSearchDirectionType",
    "LineSearchType",
    "MinimizerType",
    "TerminationType",
    "CallbackReturnType",
    "DoglegType",
    "TrivialLoss",
    "HuberLoss",
    "SoftLOneLoss",
    "CauchyLoss",
    "ArctanLoss",
    "TolerantLoss",
    "TukeyLoss",
    "ScaledLoss",
    "ComposedLoss",
    "LossFunctionWrapper",
    "EuclideanManifold",
    "SubsetManifold",
    "QuaternionManifold",
    "EigenQuaternionManifold",
    "SphereManifold",
    "LineManifold",
    "ProductManifold",
]
