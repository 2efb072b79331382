"""Dogleg trust-region strategy (traditional + two-dimensional subspace).

JAX analog of ``internal/ceres/dogleg_strategy.{h,cc}`` (Shultz,
Schnabel & Byrd subspace dogleg): the Cauchy point, Gauss-Newton step and
interpolants are jitted XLA computations over the batched Jacobian
context; the scalar state machine (radius, regularization mu, reuse flag)
stays on the host like the reference's, and the 2-D boundary problem's
quartic is solved with a 4x4 companion eigensolve on host (the analog of
``polynomial.cc`` FindPolynomialRoots) since it is O(1) work.

Scaling convention matches dogleg_strategy.cc:168-175: the elliptical
trust region ||D step|| <= r is handled by working in the scaled space
step' = D step with D = sqrt(clamped diag(J'J)).
"""

from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ceres_tpu.evaluator import JacobianContext
from ceres_tpu.types import DoglegType

_MIN_MU = 1e-8
_MAX_MU = 1.0
_MU_INCREASE = 10.0


class DoglegStrategy:
    """Host state machine + jitted kernels. Interface mirrors
    LevenbergMarquardtStrategy plus compute_step()."""

    def __init__(self, options, linear_solve, solve_aux=None):
        self.options = options
        self.radius = options.initial_trust_region_radius
        self.max_radius = options.max_trust_region_radius
        self.mu = _MIN_MU
        self.reuse = False
        self.dogleg_type = options.dogleg_type
        self.dogleg_step_norm = 0.0
        self._cache = None  # (ctx, diagonal, gradient, alpha, gn_step)
        self._solve_aux = solve_aux
        min_d, max_d = options.min_lm_diagonal, options.max_lm_diagonal

        @jax.jit
        def precompute(ctx: JacobianContext, mu: jax.Array, solve_aux):
            """diag scaling, scaled gradient, Cauchy alpha, scaled GN step
            (dogleg_strategy.cc:120-134, 176-195, ComputeGaussNewtonStep)."""
            diagonal = jnp.sqrt(
                jnp.clip(ctx.squared_column_norms(), min_d, max_d)
            )
            gradient = ctx.gradient() / diagonal
            Jg = ctx.matvec(gradient / diagonal)
            jg_sq = sum(jnp.sum(w * w) for w in Jg)
            alpha = jnp.sum(gradient * gradient) / jg_sq
            # Regularized GN solve with D = diagonal * sqrt(mu)
            # (dogleg_strategy.cc:560-568).
            y, lin_iters, term = linear_solve(
                ctx, diagonal * jnp.sqrt(mu), solve_aux
            )
            gn_step = -diagonal * y  # scaled space
            return diagonal, gradient, alpha, gn_step, lin_iters, term

        @jax.jit
        def traditional(diagonal, gradient, alpha, gn_step, radius):
            """ComputeTraditionalDoglegStep (dogleg_strategy.cc:199-257),
            branchless."""
            gn_norm = jnp.linalg.norm(gn_step)
            g_norm = jnp.linalg.norm(gradient)
            # Case 3 interpolation quantities.
            b_dot_a = -alpha * jnp.sum(gradient * gn_step)
            a_sq = (alpha * g_norm) ** 2
            b_minus_a_sq = a_sq - 2 * b_dot_a + gn_norm**2
            c = b_dot_a - a_sq
            d = jnp.sqrt(
                jnp.maximum(
                    c * c + b_minus_a_sq * (radius**2 - a_sq), 0.0
                )
            )
            beta = jnp.where(
                c <= 0,
                (d - c) / jnp.where(b_minus_a_sq == 0, 1.0, b_minus_a_sq),
                (radius**2 - a_sq) / jnp.where(d + c == 0, 1.0, d + c),
            )
            interp = (-alpha * (1.0 - beta)) * gradient + beta * gn_step
            cauchy = -(radius / jnp.where(g_norm == 0, 1.0, g_norm)) * gradient
            step_scaled = jnp.where(
                gn_norm <= radius,
                gn_step,
                jnp.where(g_norm * alpha >= radius, cauchy, interp),
            )
            norm = jnp.linalg.norm(step_scaled)
            return step_scaled / diagonal, norm

        @jax.jit
        def subspace_model(ctx, diagonal, gradient, gn_step):
            """Orthonormal 2-D basis + reduced model (B, g)
            (ComputeSubspaceModel, dogleg_strategy.cc:648-715)."""
            basis = jnp.stack([gradient, gn_step], axis=1)  # (n, 2)
            Q, R = jnp.linalg.qr(basis)
            Jb0 = ctx.matvec(Q[:, 0] / diagonal)
            Jb1 = ctx.matvec(Q[:, 1] / diagonal)
            B = jnp.empty((2, 2), dtype=jnp.float64)
            b00 = sum(jnp.sum(a * b) for a, b in zip(Jb0, Jb0))
            b01 = sum(jnp.sum(a * b) for a, b in zip(Jb0, Jb1))
            b11 = sum(jnp.sum(a * b) for a, b in zip(Jb1, Jb1))
            B = jnp.array([[b00, b01], [b01, b11]])
            g2 = Q.T @ gradient
            rdiag = jnp.abs(jnp.diag(R))
            return Q, B, g2, rdiag

        @jax.jit
        def model_cost_change(ctx, step):
            Js = ctx.matvec(step)
            mcc = jnp.asarray(0.0, jnp.float64)
            for fi in range(len(ctx.families)):
                mcc = mcc - jnp.sum(
                    Js[fi].astype(jnp.float64)
                    * (
                        ctx.residuals[fi].astype(jnp.float64)
                        + Js[fi].astype(jnp.float64) / 2.0
                    )
                )
            return mcc

        self._precompute = precompute
        self._traditional = traditional
        self._subspace_model = subspace_model
        self._model_cost_change = model_cost_change

    # -- step computation ----------------------------------------------------

    def compute_step(self, ctx: JacobianContext):
        """Returns (step, model_cost_change, lin_iters, lin_termination)."""
        from ceres_tpu.linear.cg import CG_FAILURE, CG_SUCCESS

        lin_iters = 0
        lin_term = CG_SUCCESS
        if not self.reuse or self._cache is None:
            # Fresh Cauchy/GN computation, escalating mu on invalid or
            # FAILURE-terminated solves (ComputeGaussNewtonStep,
            # dogleg_strategy.cc:676-601 — the reference's LM
            # regularization retry).
            while True:
                diagonal, gradient, alpha, gn_step, li, term = (
                    self._precompute(
                        ctx, jnp.asarray(self.mu, jnp.float64),
                        self._solve_aux,
                    )
                )
                lin_iters = int(li)
                lin_term = int(term)
                if (
                    bool(jnp.all(jnp.isfinite(gn_step)))
                    and lin_term < CG_FAILURE
                ):
                    break
                self.mu *= _MU_INCREASE
                if self.mu >= _MAX_MU:
                    return None, 0.0, lin_iters, lin_term
            self._cache = (ctx, diagonal, gradient, alpha, gn_step)
        ctx, diagonal, gradient, alpha, gn_step = self._cache

        radius = jnp.asarray(self.radius, jnp.float64)
        if self.dogleg_type == DoglegType.SUBSPACE_DOGLEG:
            step, norm = self._subspace_step(
                ctx, diagonal, gradient, alpha, gn_step, radius
            )
        else:
            step, norm = self._traditional(
                diagonal, gradient, alpha, gn_step, radius
            )
        self.dogleg_step_norm = float(norm)
        mcc = self._model_cost_change(ctx, step)
        return step, float(mcc), lin_iters, lin_term

    def _subspace_step(self, ctx, diagonal, gradient, alpha, gn_step, radius):
        """ComputeSubspaceDoglegStep (dogleg_strategy.cc:265-343)."""
        gn_norm = float(jnp.linalg.norm(gn_step))
        if gn_norm <= float(radius):
            return gn_step / diagonal, jnp.asarray(gn_norm)

        Q, B, g2, rdiag = self._subspace_model(ctx, diagonal, gradient, gn_step)
        rd = np.asarray(rdiag)
        rank = int((rd > 1e-12 * max(rd.max(), 1e-300)).sum())
        if rank < 2:
            # 1-D subspace: move along the gradient to the boundary.
            g_norm = float(jnp.linalg.norm(gradient))
            step_scaled = -(float(radius) / g_norm) * gradient
            return step_scaled / diagonal, radius

        minimum = self._find_boundary_minimum(
            np.asarray(B), np.asarray(g2), float(radius)
        )
        if minimum is None:
            return self._traditional(diagonal, gradient, alpha, gn_step, radius)

        # First-order optimality check (dogleg_strategy.cc:322-343).
        Bnp, gnp = np.asarray(B), np.asarray(g2)
        grad_min = Bnp @ minimum + gnp
        denom = np.linalg.norm(minimum) * np.linalg.norm(grad_min)
        if denom == 0 or (-minimum @ grad_min) / denom < 0.99:
            return self._traditional(diagonal, gradient, alpha, gn_step, radius)

        step_scaled = Q @ jnp.asarray(minimum)
        return step_scaled / diagonal, radius

    @staticmethod
    def _find_boundary_minimum(B, g, radius):
        """Quartic-in-y Lagrange multiplier roots via companion matrix
        (MakePolynomialForBoundaryConstrainedProblem +
        FindMinimumOnTrustRegionBoundary)."""
        detB = float(np.linalg.det(B))
        trB = float(np.trace(B))
        r2 = radius * radius
        B_adj = np.array([[B[1, 1], -B[0, 1]], [-B[1, 0], B[0, 0]]])
        poly = np.array(
            [
                r2,
                2.0 * r2 * trB,
                r2 * (trB * trB + 2.0 * detB) - g @ g,
                -2.0 * (g @ B_adj @ g - r2 * detB * trB),
                r2 * detB * detB - float((B_adj @ g) @ (B_adj @ g)),
            ]
        )
        if not np.all(np.isfinite(poly)):
            return None
        from ceres_tpu.ops.polynomial import polynomial_roots

        roots = polynomial_roots(poly, real_parts=True)
        best, best_val = None, np.inf
        for y in roots:
            M = B + y * np.eye(2)
            try:
                x = -np.linalg.solve(M, g)
            except np.linalg.LinAlgError:
                continue
            nx = np.linalg.norm(x)
            if nx > 0:
                xb = (radius / nx) * x
                val = 0.5 * xb @ B @ xb + g @ xb
                if val < best_val:
                    best_val, best = val, x
        return best

    # -- radius state machine (dogleg_strategy.cc:617-643) -------------------

    def step_accepted(self, step_quality: float) -> None:
        if step_quality < 0.25:
            self.radius *= 0.5
        if step_quality > 0.75:
            self.radius = max(self.radius, 3.0 * self.dogleg_step_norm)
        self.radius = min(self.radius, self.max_radius)
        self.mu = max(_MIN_MU, 2.0 * self.mu / _MU_INCREASE)
        self.reuse = False
        self._cache = None

    def step_rejected(self, step_quality: float) -> None:
        del step_quality
        self.radius *= 0.5
        self.reuse = True

    def step_is_invalid(self, step_quality: float = 0.0) -> None:
        del step_quality
        self.mu *= _MU_INCREASE
        self.reuse = False
        self._cache = None
