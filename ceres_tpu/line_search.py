"""Line-search minimizer: L-BFGS / BFGS / nonlinear CG / steepest descent.

JAX analog of ``internal/ceres/line_search_minimizer.cc:87-481``,
``line_search_direction.cc:44-230``, ``line_search.{h,cc}`` (Armijo and
strong-Wolfe searches with polynomial interpolation) and
``low_rank_inverse_hessian.{h,cc}`` (L-BFGS two-loop recursion).

The minimizer is generic over an *oracle* so the same loop serves both
nonlinear least-squares problems (gradient via one fused VJP —
Evaluator.cost_and_gradient) and user GradientProblems
(gradient_problem_solver.cc:99-150). Vector math runs on device; the
scalar bracketing logic stays on host like the reference's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ceres_tpu.types import (
    CallbackReturnType,
    LineSearchDirectionType,
    LineSearchType,
    NonlinearConjugateGradientType,
    TerminationType,
)
from ceres_tpu.trust_region import IterationSummary


class Oracle:
    """Evaluation interface for line-search minimization."""

    num_tangent: int

    def cost_and_gradient(self, x) -> Tuple[float, np.ndarray]:
        raise NotImplementedError

    def plus(self, x, delta):
        raise NotImplementedError


class ProgramOracle(Oracle):
    def __init__(self, program):
        from ceres_tpu.evaluator import Evaluator

        self._program = program
        self._ev = Evaluator(program)
        self.num_tangent = program.num_tangent

    def cost_and_gradient(self, x):
        c, g = self._ev.cost_and_gradient(x)
        return float(c), np.asarray(g)

    def plus(self, x, delta):
        return self._program.plus(x, jnp.asarray(delta))


# -- line searches -----------------------------------------------------------


@dataclasses.dataclass
class _PhiEval:
    a: float
    value: float
    gradient: float  # directional derivative phi'(a)
    x: object = None
    g: object = None  # full gradient at x (tangent), for reuse


def _interpolate_cubic(lo: _PhiEval, hi: _PhiEval) -> float:
    """Cubic minimizer of phi on [lo.a, hi.a] using values+derivatives
    (polynomial.cc MinimizeInterpolatingPolynomial specialization;
    shared implementation in ops/polynomial.py)."""
    from ceres_tpu.ops.polynomial import cubic_minimizer_two_points

    return cubic_minimizer_two_points(
        lo.a, lo.value, lo.gradient, hi.a, hi.value, hi.gradient
    )


class _LineSearchFunction:
    """phi(a) = f(plus(x, a d)) (line_search.h:213 LineSearchFunction)."""

    def __init__(self, oracle: Oracle, x, direction):
        self.oracle = oracle
        self.x = x
        self.d = direction
        self.evals = 0

    def __call__(self, a: float) -> _PhiEval:
        self.evals += 1
        xa = self.oracle.plus(self.x, a * self.d)
        c, g = self.oracle.cost_and_gradient(xa)
        dg = float(np.dot(g, np.asarray(self.d)))
        return _PhiEval(a=a, value=c, gradient=dg, x=xa, g=g)


def armijo_search(
    phi: _LineSearchFunction,
    phi0: _PhiEval,
    initial_step: float,
    options,
) -> Optional[_PhiEval]:
    """Backtracking Armijo with cubic interpolation (line_search.cc
    ArmijoLineSearch::DoSearch)."""
    c1 = options.line_search_sufficient_function_decrease
    a = initial_step
    prev = None
    for _ in range(options.max_num_line_search_step_size_iterations):
        cur = phi(a)
        if np.isfinite(cur.value) and cur.value <= (
            phi0.value + c1 * a * phi0.gradient
        ):
            return cur
        # Contract: cubic if we have two points, else quadratic/bisection.
        if prev is not None and np.isfinite(cur.value):
            a_new = _interpolate_cubic(prev, cur)
        else:
            a_new = 0.5 * a
        lo = options.max_line_search_step_contraction * a
        hi = options.min_line_search_step_contraction * a
        a = float(np.clip(a_new, lo, hi))
        if a < options.min_line_search_step_size:
            return None
        prev = cur if np.isfinite(cur.value) else prev
    return None


def wolfe_search(
    phi: _LineSearchFunction,
    phi0: _PhiEval,
    initial_step: float,
    options,
) -> Optional[_PhiEval]:
    """Strong Wolfe search: bracketing + zoom with cubic interpolation
    (line_search.cc WolfeLineSearch, Nocedal & Wright Alg 3.5/3.6)."""
    c1 = options.line_search_sufficient_function_decrease
    c2 = options.line_search_sufficient_curvature_decrease
    max_iter = options.max_num_line_search_step_size_iterations

    def sufficient_decrease(e: _PhiEval) -> bool:
        return e.value <= phi0.value + c1 * e.a * phi0.gradient

    def curvature_ok(e: _PhiEval) -> bool:
        return abs(e.gradient) <= c2 * abs(phi0.gradient)

    prev = phi0
    a = initial_step
    bracket_lo = bracket_hi = None
    for i in range(max_iter):
        cur = phi(a)
        if not np.isfinite(cur.value):
            # Shrink into the known-good region.
            a = 0.5 * (prev.a + a) if prev.a < a else 0.5 * a
            continue
        if (not sufficient_decrease(cur)) or (i > 0 and cur.value >= prev.value):
            bracket_lo, bracket_hi = prev, cur
            break
        if curvature_ok(cur):
            return cur
        if cur.gradient >= 0:
            bracket_lo, bracket_hi = cur, prev
            break
        prev_a = 0.0 if i == 0 else prev.a
        prev = cur
        a = min(
            options.max_line_search_step_expansion * a,
            a + (a - prev_a) * 4.0,
        )
    if bracket_lo is None:
        return prev if prev is not phi0 and sufficient_decrease(prev) else None

    # Zoom.
    lo, hi = bracket_lo, bracket_hi
    best = None
    for _ in range(max_iter):
        a = _interpolate_cubic(lo, hi)
        if (
            abs(hi.a - lo.a) < options.min_line_search_step_size
            or not np.isfinite(a)
        ):
            break
        cur = phi(a)
        if not np.isfinite(cur.value):
            hi = _PhiEval(a=a, value=np.inf, gradient=0.0)
            continue
        if (not sufficient_decrease(cur)) or cur.value >= lo.value:
            hi = cur
        else:
            if curvature_ok(cur):
                return cur
            best = cur
            if cur.gradient * (hi.a - lo.a) >= 0:
                hi = lo
            lo = cur
    if best is not None:
        return best
    if lo is not phi0 and np.isfinite(lo.value) and sufficient_decrease(lo):
        return lo
    return None


# -- search directions -------------------------------------------------------


class _LBFGS:
    """Two-loop recursion (low_rank_inverse_hessian.{h,cc})."""

    def __init__(self, rank: int):
        self.rank = rank
        self.s: List[np.ndarray] = []
        self.y: List[np.ndarray] = []

    def update(self, s: np.ndarray, y: np.ndarray) -> bool:
        sy = float(np.dot(s, y))
        if sy <= 1e-14:
            return False  # skip update, curvature condition violated
        if len(self.s) >= self.rank:
            self.s.pop(0)
            self.y.pop(0)
        self.s.append(s)
        self.y.append(y)
        return True

    def apply(self, g: np.ndarray) -> np.ndarray:
        q = g.copy()
        alphas = []
        for s, y in zip(reversed(self.s), reversed(self.y)):
            rho = 1.0 / np.dot(s, y)
            a = rho * np.dot(s, q)
            alphas.append((a, rho, s, y))
            q -= a * y
        if self.s:
            s, y = self.s[-1], self.y[-1]
            q *= np.dot(s, y) / np.dot(y, y)
        for a, rho, s, y in reversed(alphas):
            b = rho * np.dot(y, q)
            q += (a - b) * s
        return q


class _BFGS:
    """Dense inverse-Hessian BFGS (line_search_direction.cc:145-230)."""

    def __init__(self, n: int):
        self.H = np.eye(n)
        self.initialized = False

    def update(self, s: np.ndarray, y: np.ndarray) -> bool:
        sy = float(np.dot(s, y))
        if sy <= 1e-14:
            return False
        if not self.initialized:
            self.H *= sy / np.dot(y, y)
            self.initialized = True
        rho = 1.0 / sy
        I = np.eye(len(s))
        V = I - rho * np.outer(s, y)
        self.H = V @ self.H @ V.T + rho * np.outer(s, s)
        return True

    def apply(self, g: np.ndarray) -> np.ndarray:
        return self.H @ g


class LineSearchMinimizer:
    """Analog of LineSearchMinimizer::Minimize (line_search_minimizer.cc:87)."""

    def __init__(self, program_or_oracle, options, summary):
        if isinstance(program_or_oracle, Oracle):
            self.oracle = program_or_oracle
        else:
            self.oracle = ProgramOracle(program_or_oracle)
        self.options = options
        self.summary = summary
        # Evaluator::Statistics surface (solve() folds these into the
        # Summary counters post-minimize); GradientProblem oracles have
        # no Evaluator — solve() handles the absence.
        self.evaluator = getattr(self.oracle, "_ev", None)

    def minimize(self, x0):
        opts = self.options
        oracle = self.oracle
        summary = self.summary
        start = time.time()
        direction_type = opts.line_search_direction_type

        x = x0
        cost, g = oracle.cost_and_gradient(x)
        if not np.isfinite(cost):
            summary.termination_type = TerminationType.FAILURE
            summary.message = "Initial cost is not finite."
            return np.asarray(x)

        lbfgs = _LBFGS(opts.max_lbfgs_rank)
        bfgs = (
            _BFGS(oracle.num_tangent)
            if direction_type == LineSearchDirectionType.BFGS
            else None
        )
        prev_g = None
        prev_d = None
        restarts = 0

        it = IterationSummary(
            iteration=0,
            cost=cost,
            gradient_max_norm=float(np.max(np.abs(g))) if g.size else 0.0,
            gradient_norm=float(np.linalg.norm(g)),
            cumulative_time_in_seconds=time.time() - start,
            step_is_valid=True,
            step_is_successful=True,
        )
        summary.iterations.append(it)
        if it.gradient_max_norm <= opts.gradient_tolerance:
            summary.termination_type = TerminationType.CONVERGENCE
            summary.message = "Gradient tolerance reached."
            return np.asarray(x)

        prev_cost_change = 0.0
        for iteration in range(1, opts.max_num_iterations + 1):
            iter_t0 = time.time()

            # Direction (line_search_direction.cc:44-230).
            if direction_type == LineSearchDirectionType.STEEPEST_DESCENT:
                d = -g
            elif (
                direction_type
                == LineSearchDirectionType.NONLINEAR_CONJUGATE_GRADIENT
            ):
                if prev_g is None:
                    d = -g
                else:
                    t = opts.nonlinear_conjugate_gradient_type
                    if t == NonlinearConjugateGradientType.FLETCHER_REEVES:
                        beta = np.dot(g, g) / np.dot(prev_g, prev_g)
                    elif t == NonlinearConjugateGradientType.POLAK_RIBIERE:
                        beta = max(
                            0.0, np.dot(g, g - prev_g) / np.dot(prev_g, prev_g)
                        )
                    else:  # HESTENES_STIEFEL
                        dy = np.dot(prev_d, g - prev_g)
                        beta = (
                            np.dot(g, g - prev_g) / dy if dy != 0.0 else 0.0
                        )
                    d = -g + beta * prev_d
            elif direction_type == LineSearchDirectionType.LBFGS:
                d = -lbfgs.apply(g)
            else:  # BFGS
                d = -bfgs.apply(g)

            dg = float(np.dot(d, g))
            if dg >= 0:
                # Not a descent direction: restart from steepest descent
                # (line_search_minimizer.cc direction restart logic).
                restarts += 1
                if restarts > opts.max_num_line_search_direction_restarts:
                    summary.termination_type = TerminationType.FAILURE
                    summary.message = (
                        "Line search direction failure: exceeded "
                        "max_num_line_search_direction_restarts."
                    )
                    return np.asarray(x)
                lbfgs = _LBFGS(opts.max_lbfgs_rank)
                if bfgs is not None:
                    bfgs = _BFGS(oracle.num_tangent)
                d = -g
                dg = float(np.dot(d, g))

            # Initial step size (line_search_minimizer.cc:200-230).
            if direction_type in (
                LineSearchDirectionType.LBFGS,
                LineSearchDirectionType.BFGS,
            ) and iteration > 1:
                initial_step = 1.0
            elif iteration == 1:
                gmax = np.max(np.abs(g))
                initial_step = min(1.0, 1.0 / gmax) if gmax > 0 else 1.0
            else:
                initial_step = min(
                    1.0, 2.0 * abs(prev_cost_change) / abs(dg)
                ) if dg != 0 else 1.0
            if initial_step <= 0 or not np.isfinite(initial_step):
                initial_step = 1.0

            phi = _LineSearchFunction(oracle, x, d)
            phi0 = _PhiEval(a=0.0, value=cost, gradient=dg, x=x, g=g)
            if opts.line_search_type == LineSearchType.ARMIJO:
                result = armijo_search(phi, phi0, initial_step, opts)
            else:
                result = wolfe_search(phi, phi0, initial_step, opts)

            if result is None:
                summary.termination_type = TerminationType.NO_CONVERGENCE
                summary.message = (
                    f"Line search failed at iteration {iteration}; "
                    "no step satisfying the search conditions found."
                )
                return np.asarray(x)

            new_x, new_cost, new_g = result.x, result.value, result.g
            s = result.a * np.asarray(d)
            y = new_g - g
            if direction_type == LineSearchDirectionType.LBFGS:
                lbfgs.update(s, y)
            elif direction_type == LineSearchDirectionType.BFGS:
                bfgs.update(s, y)

            prev_g, prev_d = g, d
            cost_change = cost - new_cost
            prev_cost_change = cost_change
            step_norm = float(np.linalg.norm(np.asarray(new_x) - np.asarray(x)))
            x_norm = float(np.linalg.norm(np.asarray(x)))
            x, cost, g = new_x, new_cost, new_g

            it = IterationSummary(
                iteration=iteration,
                cost=cost,
                cost_change=cost_change,
                gradient_max_norm=float(np.max(np.abs(g))) if g.size else 0.0,
                gradient_norm=float(np.linalg.norm(g)),
                step_norm=step_norm,
                step_size=result.a,
                line_search_function_evaluations=phi.evals,
                step_is_valid=True,
                step_is_successful=True,
                iteration_time_in_seconds=time.time() - iter_t0,
                cumulative_time_in_seconds=time.time() - start,
            )
            summary.iterations.append(it)

            for cb in opts.callbacks:
                ret = cb(it)
                if ret == CallbackReturnType.SOLVER_ABORT:
                    summary.termination_type = TerminationType.USER_FAILURE
                    summary.message = "User callback returned SOLVER_ABORT."
                    return np.asarray(x)
                if ret == CallbackReturnType.SOLVER_TERMINATE_SUCCESSFULLY:
                    summary.termination_type = TerminationType.USER_SUCCESS
                    summary.message = (
                        "User callback returned SOLVER_TERMINATE_SUCCESSFULLY."
                    )
                    return np.asarray(x)

            if it.gradient_max_norm <= opts.gradient_tolerance:
                summary.termination_type = TerminationType.CONVERGENCE
                summary.message = (
                    f"Gradient tolerance reached. Gradient max norm: "
                    f"{it.gradient_max_norm:e} <= {opts.gradient_tolerance:e}"
                )
                return np.asarray(x)
            if abs(cost_change) <= opts.function_tolerance * (
                cost + cost_change
            ):
                summary.termination_type = TerminationType.CONVERGENCE
                summary.message = (
                    f"Function tolerance reached. |cost_change|/cost: "
                    f"{abs(cost_change) / max(cost, 1e-300):e} <= "
                    f"{opts.function_tolerance:e}"
                )
                return np.asarray(x)
            tol = opts.parameter_tolerance * (x_norm + opts.parameter_tolerance)
            if step_norm <= tol:
                summary.termination_type = TerminationType.CONVERGENCE
                summary.message = "Parameter tolerance reached."
                return np.asarray(x)
            if time.time() - start > opts.max_solver_time_in_seconds:
                summary.termination_type = TerminationType.NO_CONVERGENCE
                summary.message = "Maximum solver time reached."
                return np.asarray(x)

        summary.termination_type = TerminationType.NO_CONVERGENCE
        summary.message = (
            "Maximum number of iterations reached. "
            f"Number of iterations: {opts.max_num_iterations}."
        )
        return np.asarray(x)
