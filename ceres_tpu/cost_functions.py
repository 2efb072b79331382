"""Cost-function adapters and stock residuals.

JAX analog of the reference's functor machinery. In this
framework a "cost function" is any jnp-pure callable, so the wrapper
zoo collapses into higher-order functions:

- ``normal_prior``          — include/ceres/normal_prior.h: r = A (x - b)
- ``conditioned``           — include/ceres/conditioned_cost_function.h:
                              apply per-row conditioner functions
- ``scaled``                — scale residuals by a constant matrix/scalar
- ``fixed_arguments``       — bind some arguments to constants (the
                              analog of marking blocks constant at the
                              cost-function level)
- ``to_functor``            — cost_function_to_functor.h is the identity
                              here (functions already compose); kept for
                              API parity.
- ``evaluation_callback``-aware evaluation lives in Problem/Evaluator.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np


def normal_prior(A, b) -> Callable:
    """r(x) = A (x - b) (normal_prior.h:43-58). A may be rectangular
    (rank-deficient covariance)."""
    A = jnp.asarray(A, dtype=jnp.float64)
    b = jnp.asarray(b, dtype=jnp.float64)
    if A.ndim != 2 or A.shape[1] != b.shape[0]:
        raise ValueError(
            f"A must be (r, {b.shape[0]}), got {A.shape}"
        )

    def fn(x):
        return A @ (x - b)

    return fn


def conditioned(fn: Callable, conditioners: Sequence[Callable]) -> Callable:
    """Apply scalar conditioners per residual row
    (conditioned_cost_function.h:46-100): out[i] = c_i(r[i])."""

    def wrapped(*args):
        r = fn(*args)
        rows = [c(r[i]) for i, c in enumerate(conditioners)]
        return jnp.stack(rows)

    return wrapped


def scaled(fn: Callable, scale) -> Callable:
    """Residuals premultiplied by a scalar or matrix (the residual-space
    analog of ScaledLoss)."""
    scale = jnp.asarray(scale, dtype=jnp.float64)

    def wrapped(*args):
        r = fn(*args)
        if scale.ndim == 2:
            return scale @ r
        return scale * r

    return wrapped


def fixed_arguments(
    fn: Callable, fixed: dict[int, np.ndarray]
) -> Callable:
    """Bind argument positions to constants; remaining args shift left.
    The functional analog of CostFunctionToFunctor over a problem slice."""
    fixed = {int(k): jnp.asarray(v) for k, v in fixed.items()}

    def wrapped(*args):
        full = []
        it = iter(args)
        total = len(args) + len(fixed)
        for i in range(total):
            if i in fixed:
                full.append(fixed[i])
            else:
                full.append(next(it))
        return fn(*full)

    return wrapped


def to_functor(fn: Callable) -> Callable:
    """cost_function_to_functor.h analog — identity, for API parity."""
    return fn


def analytic_cost(residual_fn: Callable, jacobian_fn: Callable) -> Callable:
    """User-supplied analytic Jacobians (SizedCostFunction::Evaluate,
    include/ceres/sized_cost_function.h + examples/helloworld_analytic_diff.cc).

    The batched formulation: attach the hand-written Jacobian as a
    ``jax.custom_jvp`` rule, so the evaluator's fused ``vmap(jacfwd)``
    pipeline consumes it transparently — same batching, same manifold
    chain rule, no separate evaluation path.

    ``jacobian_fn(*args)`` must return one Jacobian per argument, each of
    shape ``(num_residuals, arg.size)`` (or ``None`` to treat that
    argument as constant data with zero derivative — the analog of a
    NULL jacobians[i] pointer in the reference's Evaluate contract).
    """

    @jax.custom_jvp
    def fn(*args):
        return residual_fn(*args)

    @fn.defjvp
    def _jvp(primals, tangents):
        r = residual_fn(*primals)
        jacs = jacobian_fn(*primals)
        if not isinstance(jacs, (tuple, list)):
            jacs = (jacs,)
        if len(jacs) != len(primals):
            raise ValueError(
                f"jacobian_fn returned {len(jacs)} Jacobians for "
                f"{len(primals)} arguments"
            )
        out_t = jnp.zeros_like(r)
        for J, t in zip(jacs, tangents):
            if J is None:
                continue
            J = jnp.asarray(J)
            t = jnp.ravel(jnp.asarray(t))
            out_t = out_t + jnp.reshape(J @ t, r.shape)
        return r, out_t

    return fn


class EvaluationCallback:
    """Analog of ceres::EvaluationCallback (evaluation_callback.h:63):
    ``prepare_for_evaluation(new_evaluation_point, evaluate_jacobians)``
    fires before every residual/Jacobian evaluation the solver performs.
    Attach via ``SolverOptions.evaluation_callback``."""

    def prepare_for_evaluation(
        self, new_evaluation_point: bool, evaluate_jacobians: bool
    ) -> None:
        raise NotImplementedError
