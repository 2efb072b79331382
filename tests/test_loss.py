"""Loss function + corrector tests (mirrors loss_function_test.cc,
corrector_test.cc strategy: value/derivative consistency checks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ceres_tpu
from ceres_tpu.loss import (
    ArctanLoss,
    CauchyLoss,
    ComposedLoss,
    HuberLoss,
    LossFunctionWrapper,
    ScaledLoss,
    SoftLOneLoss,
    TolerantLoss,
    TrivialLoss,
    TukeyLoss,
    corrector_coefficients,
    correct_jacobian,
    correct_residuals,
)

pytestmark = pytest.mark.device

LOSSES = [
    TrivialLoss(),
    HuberLoss(0.7),
    SoftLOneLoss(0.7),
    CauchyLoss(1.3),
    ArctanLoss(1.3),
    TolerantLoss(0.7, 0.4),
    TukeyLoss(2.0),
    ScaledLoss(CauchyLoss(1.3), 0.5),
    ScaledLoss(None, 0.5),
    ComposedLoss(CauchyLoss(1.3), SoftLOneLoss(0.7)),
    LossFunctionWrapper(HuberLoss(0.7)),
]


def _assert_loss_derivatives(loss, s):
    """rho' and rho'' must match numeric derivatives of rho (the invariant
    loss_function_test.cc AssertLossFunctionIsValid checks)."""
    s = float(s)
    rho0, rho1, rho2 = [float(v) for v in loss.evaluate(jnp.asarray(s))]
    h = 1e-6 * max(1.0, abs(s))
    r_plus = float(loss.evaluate(jnp.asarray(s + h))[0])
    r_minus = float(loss.evaluate(jnp.asarray(s - h))[0])
    num_rho1 = (r_plus - r_minus) / (2 * h)
    assert rho1 == pytest.approx(num_rho1, rel=1e-4, abs=1e-7)
    g_plus = float(loss.evaluate(jnp.asarray(s + h))[1])
    g_minus = float(loss.evaluate(jnp.asarray(s - h))[1])
    num_rho2 = (g_plus - g_minus) / (2 * h)
    assert rho2 == pytest.approx(num_rho2, rel=1e-4, abs=1e-7)


@pytest.mark.parametrize("loss", LOSSES, ids=lambda l: type(l).__name__)
@pytest.mark.parametrize("s", [0.25, 1.0, 2.5, 10.0])
def test_loss_derivative_consistency(loss, s):
    _assert_loss_derivatives(loss, s)


def test_trivial_loss_identity():
    s = jnp.asarray([0.0, 1.0, 5.0])
    rho0, rho1, rho2 = TrivialLoss().evaluate(s)
    np.testing.assert_allclose(rho0, s)
    np.testing.assert_allclose(rho1, 1.0)
    np.testing.assert_allclose(rho2, 0.0)


def test_huber_matches_formula():
    # loss_function.cc:52-65
    a = 0.7
    loss = HuberLoss(a)
    s_in = 0.25  # inlier
    rho0, rho1, rho2 = [float(v) for v in loss.evaluate(jnp.asarray(s_in))]
    assert rho0 == pytest.approx(s_in)
    s_out = 4.0
    rho0, rho1, rho2 = [float(v) for v in loss.evaluate(jnp.asarray(s_out))]
    assert rho0 == pytest.approx(2 * a * np.sqrt(s_out) - a * a)


def test_batched_evaluation():
    loss = CauchyLoss(1.0)
    s = jnp.asarray([0.5, 1.0, 2.0])
    rho0, rho1, rho2 = loss.evaluate(s)
    assert rho0.shape == (3,)
    for i, si in enumerate([0.5, 1.0, 2.0]):
        v = float(loss.evaluate(jnp.asarray(si))[0])
        assert float(rho0[i]) == pytest.approx(v)


def test_loss_is_pytree():
    loss = HuberLoss(0.5)
    leaves, treedef = jax.tree_util.tree_flatten(loss)
    rebuilt = jax.tree_util.tree_unflatten(treedef, leaves)
    assert float(rebuilt.a) == 0.5


def test_corrector_gradient_identity():
    """J_corr^T r_corr must equal rho' J^T r (the gradient identity the
    Triggs correction is designed to preserve, corrector_test.cc)."""
    rng = np.random.default_rng(42)
    r = jnp.asarray(rng.standard_normal((5, 3)))
    J = jnp.asarray(rng.standard_normal((5, 3, 4)))
    loss = CauchyLoss(1.0)
    s = jnp.sum(r * r, axis=-1)
    rho0, rho1, rho2 = loss.evaluate(s)
    scale, alpha = corrector_coefficients(s, rho1, rho2)
    r_c = correct_residuals(r, scale)
    J_c = correct_jacobian(J, r, jnp.sqrt(rho1), alpha)
    g_corr = jnp.einsum("brc,br->bc", J_c, r_c)
    g_true = rho1[:, None] * jnp.einsum("brc,br->bc", J, r)
    np.testing.assert_allclose(np.asarray(g_corr), np.asarray(g_true), rtol=1e-10)


def test_corrector_outlier_region_clamps():
    """rho'' < 0 (outlier region) must degrade to sqrt(rho') scaling
    (corrector.cc:60-104)."""
    loss = CauchyLoss(1.0)
    s = jnp.asarray([4.0])
    _, rho1, rho2 = loss.evaluate(s)
    assert float(rho2[0]) < 0
    scale, alpha = corrector_coefficients(s, rho1, rho2)
    assert float(alpha[0]) == 0.0
    assert float(scale[0]) == pytest.approx(float(jnp.sqrt(rho1[0])))


def test_corrector_zero_residual():
    scale, alpha = corrector_coefficients(
        jnp.asarray([0.0]), jnp.asarray([1.0]), jnp.asarray([0.5])
    )
    assert float(alpha[0]) == 0.0
    assert float(scale[0]) == 1.0
