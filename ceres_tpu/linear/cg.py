"""Generic preconditioned conjugate gradients, fully on-device.

JAX analog of the reference's templated PCG
(``internal/ceres/conjugate_gradients_solver.h:108-300``): same update
order, Nash & Sofer Q-based termination (zeta test), r-tolerance test,
residual refresh every ``residual_reset_period`` iterations, and the
indefiniteness / numerical-failure guards — expressed as one
``lax.while_loop`` so the whole Krylov loop compiles into a single XLA
computation with no host round-trips (the reference's CUDA CGNR path,
cgnr_solver.h:84, does the same on-GPU; here it is the only path).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

# Termination codes (match LinearSolverTerminationType semantics,
# linear_solver.h:57-74). Ordered so that jnp.maximum combines codes
# with the worst outcome winning.
CG_NO_CONVERGENCE = 0
CG_SUCCESS = 1
CG_FAILURE = 2
CG_FATAL_ERROR = 3


def direct_termination(y: jax.Array) -> jax.Array:
    """Termination code for a direct (factorization) solve: FAILURE when
    the solve produced non-finite values (indefinite or numerically
    singular lhs — the reference's Eigen/LAPACK failure reporting,
    dense_cholesky.cc / linear_solver.h:57-74)."""
    ok = jnp.all(jnp.isfinite(y))
    return jnp.where(ok, CG_SUCCESS, CG_FAILURE).astype(jnp.int32)


class CGResult(NamedTuple):
    x: jax.Array
    num_iterations: jax.Array
    termination: jax.Array  # CG_* code
    final_norm_r: jax.Array


class _CGState(NamedTuple):
    x: jax.Array
    r: jax.Array
    p: jax.Array
    rho: jax.Array
    Q0: jax.Array
    i: jax.Array
    done: jax.Array
    termination: jax.Array
    norm_r: jax.Array


def conjugate_gradients(
    operator: Callable[[jax.Array], jax.Array],
    rhs: jax.Array,
    preconditioner: Optional[Callable[[jax.Array], jax.Array]] = None,
    x0: Optional[jax.Array] = None,
    max_num_iterations: int = 50,
    min_num_iterations: int = 1,
    q_tolerance: float = 0.0,
    r_tolerance: float = 1e-6,
    residual_reset_period: int = 10,
) -> CGResult:
    """Solve A x = rhs with PCG; A given as a matvec closure.

    Jit-safe: all control flow is lax; tolerances/max iters are static.
    """
    M = preconditioner if preconditioner is not None else (lambda v: v)
    x = jnp.zeros_like(rhs) if x0 is None else x0

    norm_rhs = jnp.linalg.norm(rhs)
    tol_r = r_tolerance * norm_rhs

    r = rhs - operator(x)
    norm_r0 = jnp.linalg.norm(r)
    Q0 = -jnp.dot(x, rhs + r)

    init = _CGState(
        x=x,
        r=r,
        p=jnp.zeros_like(rhs),
        rho=jnp.asarray(1.0, rhs.dtype),
        Q0=Q0,
        i=jnp.asarray(0, jnp.int32),
        done=jnp.asarray(False),
        termination=jnp.asarray(CG_NO_CONVERGENCE, jnp.int32),
        norm_r=norm_r0,
    )

    def is_zero_or_inf(v):
        return (v == 0.0) | jnp.isinf(v)

    def cond(s: _CGState):
        return jnp.logical_not(s.done) & (s.i < max_num_iterations)

    def body(s: _CGState):
        i = s.i + 1
        z = M(s.r)
        last_rho = s.rho
        rho = jnp.dot(s.r, z)
        fail_rho = is_zero_or_inf(rho)

        beta = rho / last_rho
        fail_beta = (i > 1) & is_zero_or_inf(beta)
        p = jnp.where(i == 1, z, z + beta * s.p)

        q = operator(p)
        pq = jnp.dot(p, q)
        indefinite = (pq <= 0.0) | jnp.isinf(pq)
        safe_pq = jnp.where(indefinite, 1.0, pq)
        alpha = rho / safe_pq
        fail_alpha = jnp.isinf(alpha)

        x = s.x + alpha * p

        # Residual refresh (conjugate_gradients_solver.h:222-237).
        refresh = (i % residual_reset_period) == 0
        r = jnp.where(refresh, rhs - operator(x), s.r - alpha * q)

        Q1 = -jnp.dot(x, rhs + r)
        safe_Q1 = jnp.where(Q1 == 0.0, 1.0, Q1)
        zeta = i.astype(rhs.dtype) * (Q1 - s.Q0) / safe_Q1
        norm_r = jnp.linalg.norm(r)

        converged_q = (zeta < q_tolerance) & (i >= min_num_iterations)
        converged_r = (norm_r <= tol_r) & (i >= min_num_iterations)

        failed = fail_rho | fail_beta | fail_alpha
        done = failed | indefinite | converged_q | converged_r
        # Indefiniteness (pq <= 0) is FAILURE like the reference's
        # "Matrix is indefinite" return (conjugate_gradients_solver.h).
        termination = jnp.where(
            failed | indefinite,
            CG_FAILURE,
            jnp.where(
                converged_q | converged_r, CG_SUCCESS, CG_NO_CONVERGENCE
            ),
        ).astype(jnp.int32)

        # On failure/indefiniteness keep the previous iterate (the reference
        # breaks before applying the bad update for rho/beta failures).
        bad_update = fail_rho | fail_beta
        x = jnp.where(bad_update | indefinite, s.x, x)
        r = jnp.where(bad_update | indefinite, s.r, r)

        return _CGState(
            x=x,
            r=r,
            p=p,
            rho=rho,
            Q0=jnp.where(done, s.Q0, Q1),
            i=i,
            done=done,
            termination=termination,
            norm_r=norm_r,
        )

    # Early exit when |b| = 0 or already converged.
    trivially_done = (norm_rhs == 0.0) | (
        (min_num_iterations == 0) & (norm_r0 <= tol_r)
    )

    def run(_):
        final = jax.lax.while_loop(cond, body, init)
        return CGResult(
            x=final.x,
            num_iterations=final.i,
            termination=final.termination,
            final_norm_r=final.norm_r,
        )

    def trivial(_):
        return CGResult(
            x=jnp.where(norm_rhs == 0.0, jnp.zeros_like(rhs), x),
            num_iterations=jnp.asarray(0, jnp.int32),
            termination=jnp.asarray(CG_SUCCESS, jnp.int32),
            final_norm_r=norm_r0,
        )

    return jax.lax.cond(trivially_done, trivial, run, operand=None)
