"""General unconstrained minimization of f(x) with optional manifold.

JAX analog of ``include/ceres/gradient_problem.h:92``,
``gradient_problem_solver.{h,cc}:99-150`` and
``internal/ceres/gradient_problem_evaluator.h``: wraps a first-order
function in an oracle and runs the line-search minimizer. The gradient
defaults to JAX reverse-mode of the cost (replacing the user-supplied
analytic gradient of FirstOrderFunction), mapped into the tangent space
through the manifold chart.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ceres_tpu.line_search import LineSearchMinimizer, Oracle
from ceres_tpu.manifold import Manifold
from ceres_tpu.solver import SolverOptions, SolverSummary


class GradientProblem:
    """min f(x), x in R^n or on a manifold (gradient_problem.h:92)."""

    def __init__(
        self,
        fn: Callable,
        num_parameters: int,
        manifold: Optional[Manifold] = None,
        gradient_fn: Optional[Callable] = None,
    ):
        self.fn = fn
        self.num_parameters = int(num_parameters)
        self.manifold = manifold
        if manifold is not None and manifold.ambient_size != num_parameters:
            raise ValueError("manifold ambient size mismatch")
        self.gradient_fn = gradient_fn

    @property
    def num_tangent(self) -> int:
        return (
            self.manifold.tangent_size
            if self.manifold is not None
            else self.num_parameters
        )


class _GradientProblemOracle(Oracle):
    """Analog of GradientProblemEvaluator (gradient_problem_evaluator.h)."""

    def __init__(self, gp: GradientProblem):
        self.gp = gp
        self.num_tangent = gp.num_tangent
        m = gp.manifold

        def plus(x, delta):
            if m is None:
                return x + delta
            return m.plus(x, delta)

        def cost_grad(x):
            def f_of_delta(d):
                return gp.fn(plus(x, d))

            zero = jnp.zeros((self.num_tangent,), dtype=jnp.float64)
            if gp.gradient_fn is not None:
                c = gp.fn(x)
                g_amb = gp.gradient_fn(x)
                if m is None:
                    return c, g_amb
                return c, m.plus_jacobian(x).T @ g_amb
            return jax.value_and_grad(f_of_delta)(zero)

        self._plus = jax.jit(plus)
        self._cost_grad = jax.jit(cost_grad)

    def cost_and_gradient(self, x):
        c, g = self._cost_grad(x)
        return float(c), np.asarray(g)

    def plus(self, x, delta):
        return self._plus(x, jnp.asarray(delta))


@dataclasses.dataclass
class GradientProblemOptions(SolverOptions):
    """Analog of GradientProblemSolver::Options — the line-search subset."""


def solve_gradient_problem(
    options: GradientProblemOptions,
    problem: GradientProblem,
    parameters: np.ndarray,
) -> SolverSummary:
    """Analog of GradientProblemSolver::Solve (gradient_problem_solver.cc:99).

    Mutates ``parameters`` in place with the solution and returns a summary.
    """
    summary = SolverSummary()
    summary.num_parameters = problem.num_parameters
    summary.num_effective_parameters = problem.num_tangent
    t0 = time.time()
    oracle = _GradientProblemOracle(problem)
    minimizer = LineSearchMinimizer(oracle, options, summary)
    x0 = jnp.asarray(np.asarray(parameters, dtype=np.float64))
    x_final = minimizer.minimize(x0)
    parameters[...] = np.asarray(x_final)
    if summary.iterations:
        summary.initial_cost = summary.iterations[0].cost
        summary.final_cost = min(i.cost for i in summary.iterations)
    summary.total_time_in_seconds = time.time() - t0
    summary.minimizer_time_in_seconds = summary.total_time_in_seconds
    return summary
