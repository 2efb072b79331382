"""Robust loss functions rho(s) and the Triggs corrector.

JAX analog of the reference's ``include/ceres/loss_function.h:86-432``
and ``internal/ceres/corrector.{h,cc}``. Each loss evaluates
``rho(s) -> (rho, rho', rho'')`` elementwise on a JAX array of squared
residual norms, so a whole residual family is robustified in one fused
vectorized op instead of a per-block virtual call.

All formulas match ``internal/ceres/loss_function.cc:46-176`` and the
corrector matches ``internal/ceres/corrector.cc`` (clamped Triggs correction,
BAMS eq. 10-12), including the rho'' <= 0 and s == 0 special cases.

Losses are registered as pytrees, so they can be passed through jit
boundaries and stored inside jitted problem state.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

_DBL_MIN = float(np.finfo(np.float64).tiny)


class LossFunction:
    """Base class. ``evaluate(s)`` returns ``(rho0, rho1, rho2)`` elementwise.

    Analog of LossFunction::Evaluate (loss_function.h:86-127): out[0] = rho(s),
    out[1] = rho'(s), out[2] = rho''(s). The cost of a residual block is
    ``0.5 * rho(||r||^2)`` (residual_block.cc).
    """

    def evaluate(self, s: jax.Array) -> Tuple[jax.Array, jax.Array, jax.Array]:
        raise NotImplementedError

    # pytree protocol: default = no array leaves ------------------------------
    def tree_flatten(self):
        return (), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        del aux, children
        return cls()

    def __repr__(self) -> str:  # pragma: no cover
        return f"{type(self).__name__}()"


def _register(cls):
    jax.tree_util.register_pytree_node(
        cls, cls.tree_flatten, cls.tree_unflatten
    )
    return cls


@_register
class TrivialLoss(LossFunction):
    """rho(s) = s (loss_function.h:131, loss_function.cc:46-49)."""

    def evaluate(self, s):
        s = jnp.asarray(s)
        return s, jnp.ones_like(s), jnp.zeros_like(s)


class _ScalarParamLoss(LossFunction):
    """Base for losses with a single scale parameter ``a``."""

    def __init__(self, a):
        self.a = jnp.asarray(a, dtype=jnp.float64)

    def tree_flatten(self):
        return (self.a,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        del aux
        obj = cls.__new__(cls)
        obj.a = children[0]
        return obj

    def __repr__(self) -> str:  # pragma: no cover
        return f"{type(self).__name__}({self.a})"


@_register
class HuberLoss(_ScalarParamLoss):
    """Huber: rho(s) = s for s<=a^2 else 2a sqrt(s) - a^2.

    loss_function.h:174, loss_function.cc:52-65.
    """

    def evaluate(self, s):
        s = jnp.asarray(s)
        a, b = self.a, self.a * self.a
        out = s > b
        r = jnp.sqrt(jnp.where(out, s, 1.0))  # safe sqrt
        rho0 = jnp.where(out, 2.0 * a * r - b, s)
        rho1_out = jnp.maximum(_DBL_MIN, a / r)
        rho1 = jnp.where(out, rho1_out, 1.0)
        rho2 = jnp.where(out, -rho1_out / (2.0 * jnp.where(out, s, 1.0)), 0.0)
        return rho0, rho1, rho2


@_register
class SoftLOneLoss(_ScalarParamLoss):
    """rho(s) = 2 b (sqrt(1 + s/b) - 1), b = a^2 (loss_function.cc:68-75)."""

    def evaluate(self, s):
        s = jnp.asarray(s)
        b = self.a * self.a
        c = 1.0 / b
        total = 1.0 + s * c
        tmp = jnp.sqrt(total)
        rho0 = 2.0 * b * (tmp - 1.0)
        rho1 = jnp.maximum(_DBL_MIN, 1.0 / tmp)
        rho2 = -(c * rho1) / (2.0 * total)
        return rho0, rho1, rho2


@_register
class CauchyLoss(_ScalarParamLoss):
    """rho(s) = b log(1 + s/b), b = a^2 (loss_function.cc:77-84)."""

    def evaluate(self, s):
        s = jnp.asarray(s)
        b = self.a * self.a
        c = 1.0 / b
        total = 1.0 + s * c
        inv = 1.0 / total
        rho0 = b * jnp.log(total)
        rho1 = jnp.maximum(_DBL_MIN, inv)
        rho2 = -c * (inv * inv)
        return rho0, rho1, rho2


@_register
class ArctanLoss(_ScalarParamLoss):
    """rho(s) = a atan2(s, a) (loss_function.h:228, loss_function.cc:86-93)."""

    def evaluate(self, s):
        s = jnp.asarray(s)
        a = self.a
        b = 1.0 / (a * a)
        total = 1.0 + s * s * b
        inv = 1.0 / total
        rho0 = a * jnp.arctan2(s, a)
        rho1 = jnp.maximum(_DBL_MIN, inv)
        rho2 = -2.0 * s * b * (inv * inv)
        return rho0, rho1, rho2


@_register
class TolerantLoss(LossFunction):
    """rho(s) = b log(1 + exp((s - a) / b)) - b log(1 + exp(-a / b)).

    loss_function.h:267, loss_function.cc:95-120; the large-x overflow branch
    reproduces the reference's x > log(DBL_MAX) - 1 guard.
    """

    def __init__(self, a, b):
        self.a = jnp.asarray(a, dtype=jnp.float64)
        self.b = jnp.asarray(b, dtype=jnp.float64)

    def tree_flatten(self):
        return (self.a, self.b), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        del aux
        obj = cls.__new__(cls)
        obj.a, obj.b = children
        return obj

    def evaluate(self, s):
        s = jnp.asarray(s)
        a, b = self.a, self.b
        c = b * jnp.log1p(jnp.exp(-a / b))
        x = (s - a) / b
        big = x > (np.log(np.finfo(np.float64).max) - 1.0)
        x_safe = jnp.where(big, 0.0, x)
        e_x = jnp.exp(x_safe)
        rho0 = jnp.where(big, s - a - c, b * jnp.log1p(e_x) - c)
        rho1 = jnp.where(big, 1.0, jnp.maximum(_DBL_MIN, e_x / (1.0 + e_x)))
        rho2 = jnp.where(big, 0.0, 0.5 / (b * (1.0 + jnp.cosh(x_safe))))
        return rho0, rho1, rho2


@_register
class TukeyLoss(_ScalarParamLoss):
    """Tukey biweight (loss_function.h:286, loss_function.cc:122-136)."""

    def evaluate(self, s):
        s = jnp.asarray(s)
        a2 = self.a * self.a
        inlier = s <= a2
        value = 1.0 - s / a2
        value_sq = value * value
        rho0 = jnp.where(inlier, a2 / 3.0 * (1.0 - value_sq * value), a2 / 3.0)
        rho1 = jnp.where(inlier, value_sq, 0.0)
        rho2 = jnp.where(inlier, -2.0 / a2 * value, 0.0)
        return rho0, rho1, rho2


@_register
class ScaledLoss(LossFunction):
    """a * rho(s) for a wrapped loss, or a * s if none.

    loss_function.h:329, loss_function.cc:167-177.
    """

    def __init__(self, inner, a):
        self.inner = inner
        self.a = jnp.asarray(a, dtype=jnp.float64)

    def tree_flatten(self):
        return (self.inner, self.a), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        del aux
        obj = cls.__new__(cls)
        obj.inner, obj.a = children
        return obj

    def evaluate(self, s):
        s = jnp.asarray(s)
        if self.inner is None:
            return self.a * s, self.a * jnp.ones_like(s), jnp.zeros_like(s)
        r0, r1, r2 = self.inner.evaluate(s)
        return self.a * r0, self.a * r1, self.a * r2


@_register
class ComposedLoss(LossFunction):
    """rho(s) = f(g(s)) (loss_function.h:298, loss_function.cc:156-165)."""

    def __init__(self, f, g):
        self.f = f
        self.g = g

    def tree_flatten(self):
        return (self.f, self.g), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        del aux
        obj = cls.__new__(cls)
        obj.f, obj.g = children
        return obj

    def evaluate(self, s):
        g0, g1, g2 = self.g.evaluate(jnp.asarray(s))
        f0, f1, f2 = self.f.evaluate(g0)
        return f0, f1 * g1, f2 * g1 * g1 + f1 * g2


@_register
class LossFunctionWrapper(LossFunction):
    """Mutable holder so the loss can be swapped between solves.

    Analog of loss_function.h:391. In the functional world this is only a
    convenience delegator; rebuilding the family spec picks up the new loss.
    """

    def __init__(self, inner):
        self.inner = inner

    def reset(self, inner):
        self.inner = inner

    def tree_flatten(self):
        return (self.inner,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        del aux
        obj = cls.__new__(cls)
        obj.inner = children[0]
        return obj

    def evaluate(self, s):
        if self.inner is None:
            return TrivialLoss().evaluate(s)
        return self.inner.evaluate(s)


# ---------------------------------------------------------------------------
# Corrector (internal/ceres/corrector.cc) — clamped Triggs correction
# ---------------------------------------------------------------------------


def corrector_coefficients(sq_norm, rho1, rho2):
    """Per-block correction factors, batched.

    Returns ``(residual_scaling, alpha_sq_norm)`` such that

        r_corrected = residual_scaling * r
        J_corrected = sqrt(rho') * (J - alpha_sq_norm * r r^T J)

    matching corrector.cc:40-131: the clamped Triggs second-order correction,
    degrading to pure sqrt(rho') scaling when s == 0 or rho'' <= 0.
    """
    sq_norm = jnp.asarray(sq_norm)
    sqrt_rho1 = jnp.sqrt(rho1)
    trivial = (sq_norm == 0.0) | (rho2 <= 0.0)
    safe_sq_norm = jnp.where(trivial, 1.0, sq_norm)
    # Smaller root of 0.5 alpha^2 - alpha - (rho''/rho') s = 0.
    D = 1.0 + 2.0 * safe_sq_norm * rho2 / rho1
    D = jnp.where(trivial, 1.0, D)
    alpha = 1.0 - jnp.sqrt(D)
    residual_scaling = jnp.where(trivial, sqrt_rho1, sqrt_rho1 / (1.0 - alpha))
    alpha_sq_norm = jnp.where(trivial, 0.0, alpha / safe_sq_norm)
    return residual_scaling, alpha_sq_norm


def correct_residuals(residuals, residual_scaling):
    """r *= residual_scaling (corrector.cc CorrectResiduals, BAMS eq. 11).

    residuals: (..., num_rows); residual_scaling: (...,).
    """
    return residuals * residual_scaling[..., None]


def correct_jacobian(jacobian, residuals, sqrt_rho1, alpha_sq_norm):
    """J <- sqrt(rho') (J - alpha/s r r^T J) (corrector.cc, BAMS eq. 12).

    jacobian: (..., num_rows, num_cols) — the *uncorrected* residuals must be
    passed (the reference corrects the jacobian before the residuals).
    """
    rTJ = jnp.einsum("...r,...rc->...c", residuals, jacobian)
    outer = residuals[..., :, None] * rTJ[..., None, :]
    return sqrt_rho1[..., None, None] * (
        jacobian - alpha_sq_norm[..., None, None] * outer
    )
