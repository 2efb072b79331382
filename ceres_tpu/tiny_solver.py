"""TinySolver: self-contained fixed-size dense Levenberg-Marquardt.

JAX analog of ``include/ceres/tiny_solver.h:30-398`` and
``tiny_solver_autodiff_function.h``: a zero-allocation dense LM for small
fixed-size problems — but here the *entire* solve (Jacobian via jacfwd,
normal equations, damping update, convergence tests) is one
``lax.while_loop`` inside jit, so it can be ``vmap``ped to solve thousands
of independent small problems in parallel on the device (the replacement
for calling TinySolver in a loop).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class TinySolverResults(NamedTuple):
    x: jax.Array
    cost: jax.Array
    initial_cost: jax.Array
    iterations: jax.Array
    gradient_max_norm: jax.Array
    converged: jax.Array  # 0 = no convergence, 1 = grad tol, 2 = cost tol,
    # 3 = param tol (mirrors tiny_solver.h Status enum)


class _State(NamedTuple):
    x: jax.Array
    u: jax.Array  # LM damping
    v: jax.Array  # damping growth factor
    cost: jax.Array
    it: jax.Array
    done: jax.Array
    status: jax.Array


@partial(jax.jit, static_argnums=(0, 2, 3, 4, 5))
def tiny_solve(
    fn: Callable,
    x0: jax.Array,
    max_num_iterations: int = 50,
    gradient_tolerance: float = 1e-10,
    parameter_tolerance: float = 1e-8,
    cost_threshold: float = float(jnp.finfo(jnp.float64).eps),
):
    """Minimize 0.5 ||fn(x)||^2 with dense LM (Madsen-Nielsen-Tingleff).

    ``fn`` maps (n,) -> (m,) and must be jax-traceable (the analog of
    TinySolverAutoDiffFunction: the Jacobian comes from jacfwd).
    Fully jittable and vmappable over a batch of x0's.
    """
    dtype = x0.dtype

    def res_jac(x):
        def f(z):
            out = fn(z)
            return out, out

        J, r = jax.jacfwd(f, has_aux=True)(x)
        return r, J

    r0, J0 = res_jac(x0)
    cost0 = 0.5 * jnp.dot(r0, r0)
    jtj0 = J0.T @ J0
    u0 = 1e-4 * jnp.max(jnp.diag(jtj0))

    init = _State(
        x=x0,
        u=jnp.asarray(u0, dtype),
        v=jnp.asarray(2.0, dtype),
        cost=cost0,
        it=jnp.asarray(0, jnp.int32),
        done=jnp.asarray(False),
        status=jnp.asarray(0, jnp.int32),
    )

    def cond(s: _State):
        return jnp.logical_not(s.done) & (s.it < max_num_iterations)

    def body(s: _State):
        r, J = res_jac(s.x)
        g = J.T @ r
        gmax = jnp.max(jnp.abs(g))
        jtj = J.T @ J
        n = x0.shape[0]
        lhs = jtj + s.u * jnp.eye(n, dtype=dtype)
        # Solve (JtJ + uI) dx = -g (tiny_solver.h Update/Solve).
        L, low = jax.scipy.linalg.cho_factor(lhs, lower=True)
        dx = -jax.scipy.linalg.cho_solve((L, low), g)
        x_new = s.x + dx
        r_new = fn(x_new)
        cost_new = 0.5 * jnp.dot(r_new, r_new)
        # Gain ratio rho (Nielsen): predicted = 0.5 dx'(u dx - g).
        predicted = 0.5 * jnp.dot(dx, s.u * dx - g)
        safe_pred = jnp.where(predicted == 0, 1.0, predicted)
        rho = (s.cost - cost_new) / safe_pred
        accept = (rho > 0) & jnp.isfinite(cost_new) & (predicted > 0)

        u_acc = s.u * jnp.maximum(
            1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3
        )
        u_new = jnp.where(accept, u_acc, s.u * s.v)
        v_new = jnp.where(accept, 2.0, 2.0 * s.v)

        x_next = jnp.where(accept, x_new, s.x)
        cost_next = jnp.where(accept, cost_new, s.cost)

        dx_norm = jnp.linalg.norm(dx)
        x_norm = jnp.linalg.norm(s.x)
        grad_conv = gmax <= gradient_tolerance
        param_conv = accept & (
            dx_norm <= parameter_tolerance * (x_norm + parameter_tolerance)
        )
        cost_conv = cost_next <= cost_threshold
        status = jnp.where(
            grad_conv,
            1,
            jnp.where(cost_conv, 2, jnp.where(param_conv, 3, 0)),
        ).astype(jnp.int32)
        done = grad_conv | param_conv | cost_conv

        return _State(
            x=x_next,
            u=u_new,
            v=v_new,
            cost=cost_next,
            it=s.it + 1,
            done=done,
            status=status,
        )

    final = jax.lax.while_loop(cond, body, init)
    r_f, J_f = res_jac(final.x)
    return TinySolverResults(
        x=final.x,
        cost=final.cost,
        initial_cost=cost0,
        iterations=final.it,
        gradient_max_norm=jnp.max(jnp.abs(J_f.T @ r_f)),
        converged=final.status,
    )


class TinySolver:
    """Object wrapper mirroring the reference class shape (tiny_solver.h)."""

    def __init__(
        self,
        max_num_iterations: int = 50,
        gradient_tolerance: float = 1e-10,
        parameter_tolerance: float = 1e-8,
        cost_threshold: float = float(jnp.finfo(jnp.float64).eps),
    ):
        self.max_num_iterations = max_num_iterations
        self.gradient_tolerance = gradient_tolerance
        self.parameter_tolerance = parameter_tolerance
        self.cost_threshold = cost_threshold

    def solve(self, fn: Callable, x0) -> TinySolverResults:
        return tiny_solve(
            fn,
            jnp.asarray(x0, dtype=jnp.float64),
            self.max_num_iterations,
            self.gradient_tolerance,
            self.parameter_tolerance,
            self.cost_threshold,
        )
