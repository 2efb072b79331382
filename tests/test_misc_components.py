"""TinySolver, GradientProblem, Covariance, GradientChecker tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ceres_tpu as ct
from ceres_tpu.gradient_checker import GradientChecker, check_problem_gradients

pytestmark = pytest.mark.device


def test_tiny_solver_rosenbrock_residuals():
    def fn(x):
        return jnp.asarray([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]])

    res = ct.tiny_solve(fn, jnp.asarray([-1.2, 1.0]), 100)
    np.testing.assert_allclose(np.asarray(res.x), [1.0, 1.0], atol=1e-6)
    assert float(res.cost) < 1e-12
    assert int(res.converged) in (1, 2, 3)


def test_tiny_solver_vmappable():
    def fn(x):
        return x - jnp.asarray([1.0, 2.0, 3.0])

    x0s = jnp.asarray(np.random.default_rng(0).standard_normal((8, 3)))
    batched = jax.vmap(lambda x0: ct.tiny_solve(fn, x0, 20))(x0s)
    assert batched.x.shape == (8, 3)
    np.testing.assert_allclose(
        np.asarray(batched.x), np.tile([1.0, 2.0, 3.0], (8, 1)), atol=1e-8
    )


def test_gradient_problem_rosenbrock():
    """Mirrors examples/rosenbrock.cc via GradientProblemSolver."""

    def f(x):
        return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2

    gp = ct.GradientProblem(f, num_parameters=2)
    params = np.array([-1.2, 1.0])
    opts = ct.GradientProblemOptions(max_num_iterations=500)
    summary = ct.solve_gradient_problem(opts, gp, params)
    assert summary.termination_type == ct.TerminationType.CONVERGENCE
    np.testing.assert_allclose(params, [1.0, 1.0], atol=1e-5)


@pytest.mark.parametrize(
    "direction",
    [
        ct.LineSearchDirectionType.LBFGS,
        ct.LineSearchDirectionType.BFGS,
        ct.LineSearchDirectionType.NONLINEAR_CONJUGATE_GRADIENT,
        ct.LineSearchDirectionType.STEEPEST_DESCENT,
    ],
)
def test_gradient_problem_directions(direction):
    def f(x):
        return jnp.sum((x - jnp.asarray([1.0, -2.0, 3.0])) ** 2)

    gp = ct.GradientProblem(f, num_parameters=3)
    params = np.zeros(3)
    opts = ct.GradientProblemOptions(
        max_num_iterations=300, line_search_direction_type=direction
    )
    summary = ct.solve_gradient_problem(opts, gp, params)
    assert summary.is_solution_usable()
    np.testing.assert_allclose(params, [1.0, -2.0, 3.0], atol=1e-4)


def test_gradient_problem_with_manifold():
    """Minimize distance to a target rotation on the quaternion manifold."""
    target = np.array([0.5, 0.5, 0.5, 0.5])

    def f(q):
        return jnp.sum((q - jnp.asarray(target)) ** 2)

    gp = ct.GradientProblem(
        f, num_parameters=4, manifold=ct.QuaternionManifold()
    )
    params = np.array([1.0, 0.0, 0.0, 0.0])
    opts = ct.GradientProblemOptions(max_num_iterations=200)
    summary = ct.solve_gradient_problem(opts, gp, params)
    assert summary.is_solution_usable()
    np.testing.assert_allclose(params, target, atol=1e-4)
    assert np.linalg.norm(params) == pytest.approx(1.0, abs=1e-10)


def test_covariance_linear_problem():
    """For r = A x - b, covariance = (A'A)^-1 (covariance_test.cc pattern)."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((10, 3))
    b = rng.standard_normal(10)

    p = ct.Problem()
    xb = p.add_parameter_block(np.zeros(3))

    def r(x, data):
        Ad, bd = data
        return Ad @ x - bd

    p.add_residual_block(r, None, [xb], data=(A, b))
    cov = ct.Covariance()
    assert cov.compute([(xb, xb)], p)
    got = cov.get_covariance_block(xb, xb)
    expected = np.linalg.inv(A.T @ A)
    np.testing.assert_allclose(got, expected, rtol=1e-8)

    cov_svd = ct.Covariance(
        ct.CovarianceOptions(
            algorithm_type=ct.CovarianceAlgorithmType.DENSE_SVD
        )
    )
    assert cov_svd.compute([(xb, xb)], p)
    np.testing.assert_allclose(
        cov_svd.get_covariance_block(xb, xb), expected, rtol=1e-8
    )


def test_covariance_rank_deficient_fails():
    p = ct.Problem()
    xb = p.add_parameter_block(np.zeros(2))

    def r(x):
        return jnp.asarray([x[0] + x[1]])  # rank 1

    p.add_residual_block(r, None, [xb])
    cov = ct.Covariance(
        ct.CovarianceOptions(
            algorithm_type=ct.CovarianceAlgorithmType.DENSE_SVD
        )
    )
    assert not cov.compute([(xb, xb)], p)


def test_gradient_checker():
    def good(x, y):
        return jnp.asarray([x[0] * y[0], x[1] + y[0]])

    gc = GradientChecker(good, [2, 1])
    ok, err, _ = gc.probe([np.array([1.0, 2.0]), np.array([3.0])])
    assert ok

    p = ct.Problem()
    a = p.add_parameter_block(np.array([1.0, 2.0]))

    def r(x):
        return jnp.sin(x)

    p.add_residual_block(r, None, [a])
    ok, msg = check_problem_gradients(p)
    assert ok, msg


def test_solver_check_gradients_option():
    p = ct.Problem()
    a = p.add_parameter_block(np.array([1.0]))

    def r(x):
        return x * x

    p.add_residual_block(r, None, [a])
    opts = ct.SolverOptions(
        check_gradients=True,
        linear_solver_type=ct.LinearSolverType.DENSE_QR,
    )
    summary = ct.solve(opts, p)
    assert summary.termination_type != ct.TerminationType.FAILURE
