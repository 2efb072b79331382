"""Covariance estimation depth tests (covariance_test.cc, 2000+ LoC).

Covers: covariance of a linear problem against the closed form
(J'J)^{-1}, block extraction symmetry, constant blocks (zero covariance),
manifold blocks (tangent-space covariance), algorithm agreement
(DENSE_SVD vs QR), null-space handling on rank-deficient problems, and
scaling with loss functions.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import ceres_tpu as ct
from ceres_tpu.covariance import Covariance, CovarianceOptions

pytestmark = pytest.mark.device


def _linear_problem(sigma=1.0):
    """r_i = A_i x - b_i with known A: covariance = (J'J)^{-1}."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((12, 3))
    b = rng.standard_normal(12)
    p = ct.Problem()
    x = p.add_parameter_block(np.zeros(3))
    p.add_residual_block(
        lambda v, d: jnp.asarray(A) @ v - d, None, [x], data=jnp.asarray(b)
    )
    ct.solve(ct.SolverOptions(max_num_iterations=10), p)
    return p, x, A


def test_linear_problem_matches_closed_form():
    p, x, A = _linear_problem()
    cov = Covariance(CovarianceOptions())
    assert cov.compute([(x, x)], p)
    got = cov.get_covariance_block(x, x)
    expect = np.linalg.inv(A.T @ A)
    np.testing.assert_allclose(got, expect, rtol=1e-8, atol=1e-10)


def test_cross_block_symmetry():
    rng = np.random.default_rng(1)
    A = rng.standard_normal((10, 4))
    b = rng.standard_normal(10)
    p = ct.Problem()
    u = p.add_parameter_block(np.zeros(2))
    v = p.add_parameter_block(np.zeros(2))

    def r(uu, vv, d):
        z = jnp.concatenate([uu, vv])
        return jnp.asarray(A) @ z - d

    p.add_residual_block(r, None, [u, v], data=jnp.asarray(b))
    ct.solve(ct.SolverOptions(max_num_iterations=10), p)
    cov = Covariance(CovarianceOptions())
    assert cov.compute([(u, u), (u, v), (v, v)], p)
    full = np.linalg.inv(A.T @ A)
    np.testing.assert_allclose(
        cov.get_covariance_block(u, u), full[:2, :2], rtol=1e-7, atol=1e-9
    )
    np.testing.assert_allclose(
        cov.get_covariance_block(u, v), full[:2, 2:], rtol=1e-7, atol=1e-9
    )
    np.testing.assert_allclose(
        cov.get_covariance_block(v, u).T,
        cov.get_covariance_block(u, v),
        rtol=1e-10,
    )


def test_constant_block_zero_covariance():
    p, x, A = _linear_problem()
    c = p.add_parameter_block(np.array([5.0]))
    p.add_residual_block(lambda v, cc: v + cc, None, [x, c])
    p.set_parameter_block_constant(c)
    ct.solve(ct.SolverOptions(max_num_iterations=10), p)
    cov = Covariance(CovarianceOptions())
    assert cov.compute([(c, c), (x, c)], p)
    np.testing.assert_allclose(cov.get_covariance_block(c, c), 0.0)
    np.testing.assert_allclose(cov.get_covariance_block(x, c), 0.0)


def test_manifold_block_tangent_covariance():
    """Quaternion block: tangent covariance is (3, 3), ambient is (4, 4)
    lifted through the plus-jacobian (covariance_impl.cc:125-160)."""
    rng = np.random.default_rng(2)
    p = ct.Problem()
    q0 = rng.standard_normal(4)
    q0 /= np.linalg.norm(q0)
    q = p.add_parameter_block(q0, ct.QuaternionManifold())
    target = jnp.asarray(q0 + 0.01 * rng.standard_normal(4))

    def r(quat):
        return quat - target

    p.add_residual_block(r, None, [q])
    ct.solve(ct.SolverOptions(max_num_iterations=30), p)
    cov = Covariance(CovarianceOptions())
    assert cov.compute([(q, q)], p)
    tangent = cov.get_covariance_block_in_tangent_space(q, q)
    assert tangent.shape == (3, 3)
    ambient = cov.get_covariance_block(q, q)
    assert ambient.shape == (4, 4)
    # ambient covariance is rank <= 3 (gauge direction has none)
    w = np.linalg.eigvalsh(ambient)
    assert w[0] < 1e-8 * max(w[-1], 1.0)


def test_algorithms_agree():
    p, x, A = _linear_problem()
    out = {}
    for alg in ("DENSE_SVD", "SPARSE_QR"):
        cov = Covariance(CovarianceOptions(algorithm_type=alg))
        assert cov.compute([(x, x)], p)
        out[alg] = cov.get_covariance_block(x, x)
    np.testing.assert_allclose(
        out["DENSE_SVD"], out["SPARSE_QR"], rtol=1e-7, atol=1e-9
    )


def test_rank_deficient_rejected_without_null_space():
    """Gauge-deficient problem: compute() must fail unless null-space
    truncation is requested (covariance_impl.cc null_space_rank)."""
    p = ct.Problem()
    a = p.add_parameter_block(np.array([1.0]))
    b = p.add_parameter_block(np.array([2.0]))
    # only the difference is observable -> J'J singular
    p.add_residual_block(lambda u, v: u - v - 1.0, None, [a, b])
    ct.solve(ct.SolverOptions(max_num_iterations=5), p)
    cov = Covariance(CovarianceOptions(algorithm_type="DENSE_SVD"))
    assert not cov.compute([(a, a)], p)
    cov2 = Covariance(
        CovarianceOptions(algorithm_type="DENSE_SVD", null_space_rank=-1)
    )
    assert cov2.compute([(a, a)], p)
    blk = cov2.get_covariance_block(a, a)
    assert np.all(np.isfinite(blk))


def test_covariance_scales_inverse_with_information():
    """Doubling the residual count halves the covariance."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((8, 2))

    def make(repeat):
        p = ct.Problem()
        x = p.add_parameter_block(np.zeros(2))
        for _ in range(repeat):
            p.add_residual_block(
                lambda v, d: jnp.asarray(A) @ v - d,
                None,
                [x],
                data=jnp.zeros(8),
            )
        ct.solve(ct.SolverOptions(max_num_iterations=5), p)
        cov = Covariance(CovarianceOptions())
        assert cov.compute([(x, x)], p)
        return cov.get_covariance_block(x, x)

    c1, c2 = make(1), make(2)
    np.testing.assert_allclose(c2, c1 / 2.0, rtol=1e-7)
