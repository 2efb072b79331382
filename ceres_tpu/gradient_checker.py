"""Gradient checking: analytic vs numeric Jacobians.

JAX analog of ``include/ceres/gradient_checker.h:66`` and
``internal/ceres/gradient_checking_cost_function.{h,cc}:105``: compares the
autodiff Jacobian of every residual family against central finite
differences, in the tangent space (local jacobians), and reports the worst
relative error. Wired into the solver via
SolverOptions.check_gradients (solver.cc:765-780).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ceres_tpu.evaluator import family_residuals_and_jacobians
from ceres_tpu.problem import Problem


def numeric_jacobian(
    fn: Callable,
    args: Sequence[np.ndarray],
    argnum: int,
    step: float = 1e-6,
) -> np.ndarray:
    """Central-difference Jacobian of fn w.r.t. args[argnum]."""
    args = [np.asarray(a, dtype=np.float64) for a in args]
    x = args[argnum]
    r0 = np.asarray(fn(*[jnp.asarray(a) for a in args]))
    J = np.zeros((r0.shape[0], x.shape[0]))
    for i in range(x.shape[0]):
        h = step * max(1.0, abs(x[i]))
        xp, xm = x.copy(), x.copy()
        xp[i] += h
        xm[i] -= h
        ap = [jnp.asarray(a) if k != argnum else jnp.asarray(xp) for k, a in enumerate(args)]
        am = [jnp.asarray(a) if k != argnum else jnp.asarray(xm) for k, a in enumerate(args)]
        J[:, i] = (np.asarray(fn(*ap)) - np.asarray(fn(*am))) / (2 * h)
    return J


class GradientChecker:
    """Check one residual function's Jacobians (gradient_checker.h:66)."""

    def __init__(
        self,
        fn: Callable,
        block_sizes: Sequence[int],
        relative_precision: float = 1e-8,
        step: float = 1e-6,
    ):
        self.fn = fn
        self.block_sizes = tuple(block_sizes)
        self.relative_precision = relative_precision
        self.step = step

    def probe(self, args: Sequence[np.ndarray]) -> Tuple[bool, float, str]:
        """Returns (ok, max_relative_error, message)."""
        max_err = 0.0
        for j in range(len(args)):
            analytic = np.asarray(
                jax.jacfwd(self.fn, argnums=j)(*[jnp.asarray(a) for a in args])
            )
            numeric = numeric_jacobian(self.fn, args, j, self.step)
            scale = max(np.max(np.abs(analytic)), np.max(np.abs(numeric)), 1.0)
            err = np.max(np.abs(analytic - numeric)) / scale
            max_err = max(max_err, err)
        ok = max_err <= self.relative_precision
        msg = (
            ""
            if ok
            else f"max relative jacobian error {max_err:e} > "
            f"{self.relative_precision:e}"
        )
        return ok, max_err, msg


def check_problem_gradients(
    problem: Problem, relative_precision: float = 1e-8, max_blocks_per_family: int = 4
) -> Tuple[bool, str]:
    """Check every residual family at the current parameter values.

    Analog of wrapping every cost function in a
    GradientCheckingCostFunction (gradient_checking_cost_function.h:105);
    sampling a few instances per family keeps it cheap on batched problems.
    """
    program = problem.program()
    return check_program_gradients_at(
        program,
        program.initial_ambient(),
        relative_precision,
        max_blocks_per_family,
    )


def check_program_gradients_at(
    program,
    x,
    relative_precision: float = 1e-8,
    max_blocks_per_family: int = 4,
) -> Tuple[bool, str]:
    """Gradient check at an arbitrary iterate ``x`` — the during-solve
    form: the reference wraps every evaluation in a
    GradientCheckingCostFunction and aborts the solve on the first
    mismatch at ANY iterate (gradient_checking_cost_function.h:105,
    solver.cc:765-780)."""
    x = jnp.asarray(x, dtype=jnp.float64)
    for fam in program.families:
        r, jacs = family_residuals_and_jacobians(fam, x)
        st = fam.structure
        n_check = min(fam.batch, max_blocks_per_family)
        for i in range(n_check):
            blocks = [np.asarray(x)[np.asarray(idx[i])] for idx in fam.ambient_idx]
            data_i = (
                jax.tree_util.tree_map(lambda leaf: leaf[i], fam.data)
                if fam.data is not None
                else None
            )

            def tangent_fn(*deltas):
                new_blocks = []
                for b, d, m in zip(blocks, deltas, st.manifolds):
                    b = jnp.asarray(b)
                    new_blocks.append(b + d if m is None else m.plus(b, d))
                if st.has_data:
                    return st.fn(*new_blocks, data_i)
                return st.fn(*new_blocks)

            zero_args = [np.zeros(t) for t in st.tangent_sizes]
            for j in range(len(zero_args)):
                numeric = numeric_jacobian(tangent_fn, zero_args, j)
                analytic = np.asarray(jacs[j][i])
                scale = max(
                    np.max(np.abs(analytic)), np.max(np.abs(numeric)), 1.0
                )
                err = np.max(np.abs(analytic - numeric)) / scale
                if err > relative_precision:
                    return False, (
                        f"family {st.fn.__name__ if hasattr(st.fn, '__name__') else st.fn}"
                        f" instance {i} arg {j}: relative error {err:e}"
                    )
    return True, ""
