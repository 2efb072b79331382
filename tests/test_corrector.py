"""Triggs corrector unit tests (corrector.cc / corrector_test.cc).

The corrected residual/Jacobian pair must reproduce the robustified
cost's value, gradient and Gauss-Newton Hessian:
  0.5 ||r_c||^2        == 0.5 rho(||r||^2)
  J_c' r_c             == rho' J' r
  J_c' J_c             == rho' J'J + 2 rho'' (J'r)(J'r)'   (when the
                          second-order term is kept; clamped otherwise)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ceres_tpu as ct
from ceres_tpu.loss import (
    corrector_coefficients,
    correct_jacobian,
    correct_residuals,
)

pytestmark = pytest.mark.device

LOSSES = [
    ct.HuberLoss(0.7),
    ct.SoftLOneLoss(1.3),
    ct.CauchyLoss(1.1),
    ct.ArctanLoss(0.9),
    ct.TukeyLoss(2.5),
    ct.TolerantLoss(0.4, 1.0),
]


def _rand_case(seed, rows=4, cols=3):
    rng = np.random.default_rng(seed)
    r = jnp.asarray(rng.standard_normal(rows))
    J = jnp.asarray(rng.standard_normal((rows, cols)))
    return r, J


def _corrected(loss, r, J):
    sq = jnp.sum(r * r)
    rho0, rho1, rho2 = loss.evaluate(sq)
    scale, alpha_sq = corrector_coefficients(sq, rho1, rho2)
    J_c = correct_jacobian(J[None], r[None], jnp.sqrt(rho1)[None], alpha_sq[None])[0]
    r_c = correct_residuals(r[None], scale[None])[0]
    return rho0, rho1, rho2, r_c, J_c


@pytest.mark.parametrize("loss", LOSSES, ids=lambda l: type(l).__name__)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_corrected_norm_identity(loss, seed):
    """||r_c||^2 = rho' s / (1 - alpha)^2 with alpha = alpha_sq * s
    (corrector.cc:40-131); in the clamped regime (rho'' <= 0) alpha = 0
    so r_c = sqrt(rho') r exactly. The robustified COST itself is taken
    from rho0, not from ||r_c||^2 (same as the reference evaluator)."""
    r, J = _rand_case(seed)
    sq = float(jnp.sum(r * r))
    rho0, rho1, rho2 = (float(v) for v in loss.evaluate(jnp.asarray(sq)))
    scale, alpha_sq = corrector_coefficients(
        jnp.asarray(sq), jnp.asarray(rho1), jnp.asarray(rho2)
    )
    r_c = correct_residuals(r[None], scale[None])[0]
    alpha = float(alpha_sq) * sq
    expect = rho1 * sq / (1.0 - alpha) ** 2
    np.testing.assert_allclose(float(jnp.sum(r_c * r_c)), expect, rtol=1e-10)
    if rho2 <= 0:
        np.testing.assert_allclose(
            np.asarray(r_c), np.sqrt(rho1) * np.asarray(r), atol=1e-12
        )
        assert alpha == 0.0


@pytest.mark.parametrize("loss", LOSSES, ids=lambda l: type(l).__name__)
@pytest.mark.parametrize("seed", [0, 3])
def test_corrected_gradient_matches_rho_prime(loss, seed):
    """J_c' r_c == rho' J'r (corrector_test.cc MultidimensionalGaussNewton
    first-order identity) — holds in both the full and clamped regimes."""
    r, J = _rand_case(seed)
    _, rho1, _, r_c, J_c = _corrected(loss, r, J)
    lhs = np.asarray(J_c.T @ r_c)
    rhs = np.asarray(float(rho1) * (J.T @ r))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("loss", LOSSES, ids=lambda l: type(l).__name__)
def test_corrected_gauss_newton_when_convex(loss):
    """With rho'' >= 0 inactive clamping, J_c'J_c equals the BAMS eq. 11
    Gauss-Newton approximation rho' J'J + 2 rho'' (J'r)(J'r)'."""
    # small residuals keep most losses in their convex region
    rng = np.random.default_rng(9)
    r = jnp.asarray(0.05 * rng.standard_normal(4))
    J = jnp.asarray(rng.standard_normal((4, 3)))
    sq = float(jnp.sum(r * r))
    rho0, rho1, rho2 = (float(v) for v in loss.evaluate(jnp.asarray(sq)))
    if rho2 < 0:
        pytest.skip("loss concave at this point; clamped regime")
    _, _, _, r_c, J_c = _corrected(loss, r, J)
    lhs = np.asarray(J_c.T @ J_c)
    Jr = np.asarray(J.T @ r)
    rhs = rho1 * np.asarray(J.T @ J) + 2.0 * rho2 * np.outer(Jr, Jr)
    np.testing.assert_allclose(lhs, rhs, rtol=1e-6, atol=1e-9)


def test_trivial_loss_is_identity_correction():
    r, J = _rand_case(4)
    _, _, _, r_c, J_c = _corrected(ct.TrivialLoss(), r, J)
    np.testing.assert_allclose(np.asarray(r_c), np.asarray(r), atol=1e-14)
    np.testing.assert_allclose(np.asarray(J_c), np.asarray(J), atol=1e-14)


def test_zero_residual_degrades_to_sqrt_scaling():
    """s == 0: alpha = 0, correction is pure sqrt(rho') (corrector.cc:47)."""
    J = jnp.asarray(np.random.default_rng(5).standard_normal((4, 3)))
    r = jnp.zeros((4,))
    loss = ct.CauchyLoss(1.0)
    _, rho1, _, r_c, J_c = _corrected(loss, r, J)
    np.testing.assert_allclose(
        np.asarray(J_c), np.sqrt(float(rho1)) * np.asarray(J), atol=1e-12
    )


@pytest.mark.parametrize("loss", LOSSES, ids=lambda l: type(l).__name__)
def test_rho_derivatives_match_autodiff(loss):
    """evaluate()'s rho', rho'' must equal autodiff of rho (loss_function
    _test.cc AssertLossFunctionIsValid)."""
    for s in (0.1, 0.5, 1.0, 4.0, 25.0):
        rho0, rho1, rho2 = (
            float(v) for v in loss.evaluate(jnp.asarray(s))
        )
        g = jax.grad(lambda t: loss.evaluate(t)[0])(jnp.asarray(s))
        h = jax.grad(lambda t: loss.evaluate(t)[1])(jnp.asarray(s))
        np.testing.assert_allclose(rho1, float(g), rtol=1e-8)
        np.testing.assert_allclose(rho2, float(h), rtol=1e-8, atol=1e-12)


def test_scaled_loss_scales_all_derivatives():
    base = ct.CauchyLoss(1.0)
    scaled = ct.ScaledLoss(base, 3.5)
    s = jnp.asarray(2.0)
    b = [float(v) for v in base.evaluate(s)]
    sc = [float(v) for v in scaled.evaluate(s)]
    np.testing.assert_allclose(sc, [3.5 * v for v in b], rtol=1e-12)


def test_composed_loss_chain_rule():
    f = ct.HuberLoss(1.0)
    g = ct.CauchyLoss(2.0)
    comp = ct.ComposedLoss(f, g)  # f(g(s))
    s = jnp.asarray(3.0)
    rho0, rho1, rho2 = (float(v) for v in comp.evaluate(s))
    g0, g1, g2 = (float(v) for v in g.evaluate(s))
    f0, f1, f2 = (float(v) for v in f.evaluate(jnp.asarray(g0)))
    np.testing.assert_allclose(rho0, f0, rtol=1e-12)
    np.testing.assert_allclose(rho1, f1 * g1, rtol=1e-12)
    np.testing.assert_allclose(rho2, f2 * g1 * g1 + f1 * g2, rtol=1e-10)


def test_loss_wrapper_hot_swap():
    w = ct.LossFunctionWrapper(ct.HuberLoss(1.0))
    s = jnp.asarray(9.0)
    before = float(w.evaluate(s)[0])
    w.reset(ct.TrivialLoss())
    after = float(w.evaluate(s)[0])
    assert after == pytest.approx(9.0)
    assert before != after
