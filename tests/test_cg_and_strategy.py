"""Unit tests: conjugate gradients (conjugate_gradients_solver_test.cc)
and the LM radius state machine (levenberg_marquardt_strategy_test.cc).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import ceres_tpu as ct
from ceres_tpu.linear.cg import (
    CG_FAILURE,
    CG_NO_CONVERGENCE,
    CG_SUCCESS,
    conjugate_gradients,
)
from ceres_tpu.trust_region import LevenbergMarquardtStrategy

pytestmark = pytest.mark.device


def _op(A):
    A = jnp.asarray(A)
    return lambda v: A @ v


def test_cg_identity_one_iteration():
    rhs = jnp.asarray([1.0, 2.0, 3.0])
    res = conjugate_gradients(_op(np.eye(3)), rhs, r_tolerance=1e-12)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(rhs), atol=1e-12)
    assert int(res.num_iterations) <= 2
    assert int(res.termination) == CG_SUCCESS


def test_cg_solves_known_spd_system():
    # conjugate_gradients_solver_test.cc SolvesLinearSystem
    A = np.array([[2.0, -1.0, 0.0], [-1.0, 2.0, -1.0], [0.0, -1.0, 2.0]])
    b = np.array([1.0, 0.5, 3.0])
    res = conjugate_gradients(
        _op(A), jnp.asarray(b), r_tolerance=1e-12, max_num_iterations=20
    )
    np.testing.assert_allclose(np.asarray(res.x), np.linalg.solve(A, b), atol=1e-9)
    assert int(res.termination) == CG_SUCCESS


def test_cg_exact_in_n_iterations():
    rng = np.random.default_rng(0)
    M = rng.standard_normal((6, 6))
    A = M @ M.T + 0.5 * np.eye(6)
    b = rng.standard_normal(6)
    res = conjugate_gradients(
        _op(A), jnp.asarray(b), r_tolerance=1e-10, max_num_iterations=12
    )
    assert int(res.num_iterations) <= 8
    np.testing.assert_allclose(np.asarray(res.x), np.linalg.solve(A, b), atol=1e-7)


def test_cg_preconditioner_reduces_iterations():
    rng = np.random.default_rng(1)
    d = np.logspace(0, 4, 40)
    A = np.diag(d)
    b = rng.standard_normal(40)
    plain = conjugate_gradients(
        _op(A), jnp.asarray(b), r_tolerance=1e-8, max_num_iterations=200
    )
    precond = conjugate_gradients(
        _op(A),
        jnp.asarray(b),
        preconditioner=lambda v: v / jnp.asarray(d),
        r_tolerance=1e-8,
        max_num_iterations=200,
    )
    assert int(precond.num_iterations) < int(plain.num_iterations)
    np.testing.assert_allclose(
        np.asarray(precond.x), b / d, rtol=1e-6, atol=1e-10
    )


def test_cg_indefinite_matrix_reports_failure():
    A = np.diag([1.0, -1.0])
    b = np.array([0.3, 1.0])
    res = conjugate_gradients(
        _op(A), jnp.asarray(b), r_tolerance=1e-12, max_num_iterations=10
    )
    assert int(res.termination) == CG_FAILURE


def test_cg_zero_rhs_trivial():
    res = conjugate_gradients(
        _op(np.eye(4)), jnp.zeros(4), r_tolerance=1e-12
    )
    np.testing.assert_allclose(np.asarray(res.x), 0.0)
    assert int(res.num_iterations) == 0
    assert int(res.termination) == CG_SUCCESS


def test_cg_iteration_cap_reports_no_convergence():
    rng = np.random.default_rng(2)
    d = np.logspace(0, 6, 100)
    A = np.diag(d)
    b = rng.standard_normal(100)
    res = conjugate_gradients(
        _op(A), jnp.asarray(b), r_tolerance=1e-14, q_tolerance=-1.0,
        max_num_iterations=3,
    )
    assert int(res.num_iterations) == 3
    assert int(res.termination) == CG_NO_CONVERGENCE


def test_cg_warm_start_x0():
    A = np.diag([1.0, 2.0, 3.0])
    b = np.array([1.0, 2.0, 3.0])
    x_star = np.array([1.0, 1.0, 1.0])
    res = conjugate_gradients(
        _op(A),
        jnp.asarray(b),
        x0=jnp.asarray(x_star),
        r_tolerance=1e-10,
        min_num_iterations=0,
    )
    assert int(res.num_iterations) == 0
    np.testing.assert_allclose(np.asarray(res.x), x_star, atol=1e-12)


def test_cg_q_tolerance_terminates_early():
    rng = np.random.default_rng(3)
    M = rng.standard_normal((50, 50))
    A = M @ M.T + np.eye(50)
    b = rng.standard_normal(50)
    loose = conjugate_gradients(
        _op(A), jnp.asarray(b), q_tolerance=0.5, r_tolerance=-1.0,
        max_num_iterations=100,
    )
    tight = conjugate_gradients(
        _op(A), jnp.asarray(b), q_tolerance=1e-9, r_tolerance=-1.0,
        max_num_iterations=100,
    )
    assert int(loose.num_iterations) < int(tight.num_iterations)


# -- LM strategy (levenberg_marquardt_strategy_test.cc) ----------------------


def _opts(**kw):
    o = ct.SolverOptions()
    for k, v in kw.items():
        setattr(o, k, v)
    return o


def test_lm_radius_grows_on_good_step():
    s = LevenbergMarquardtStrategy(_opts(initial_trust_region_radius=10.0))
    s.step_accepted(1.0)  # perfect model agreement
    assert s.radius == pytest.approx(30.0)  # 10 / (1/3)


def test_lm_radius_fixed_on_mediocre_step():
    s = LevenbergMarquardtStrategy(_opts(initial_trust_region_radius=10.0))
    s.step_accepted(0.5)  # 2*rho-1 = 0 -> divisor 1
    assert s.radius == pytest.approx(10.0)


def test_lm_radius_respects_max():
    s = LevenbergMarquardtStrategy(
        _opts(initial_trust_region_radius=10.0, max_trust_region_radius=20.0)
    )
    s.step_accepted(1.0)
    assert s.radius == pytest.approx(20.0)


def test_lm_rejection_halves_then_quarters():
    """Consecutive rejections use 2, 4, 8, ... decrease factors
    (levenberg_marquardt_strategy.cc:167-171)."""
    s = LevenbergMarquardtStrategy(_opts(initial_trust_region_radius=16.0))
    s.step_rejected(0.0)
    assert s.radius == pytest.approx(8.0)
    s.step_rejected(0.0)
    assert s.radius == pytest.approx(2.0)
    s.step_rejected(0.0)
    assert s.radius == pytest.approx(0.25)


def test_lm_acceptance_resets_decrease_factor():
    s = LevenbergMarquardtStrategy(_opts(initial_trust_region_radius=16.0))
    s.step_rejected(0.0)
    s.step_rejected(0.0)  # factor now 8
    s.step_accepted(0.5)
    s.step_rejected(0.0)  # factor back to 2
    assert s.radius == pytest.approx(1.0)  # 16/2/4 = 2, then /2 = 1


# --- CG termination-path coverage (VERDICT r2 item #9) ----------------------
# Every exit of conjugate_gradients (linear/cg.py): trivial-rhs, r-tol,
# q-tol, iteration cap, warm-start-already-converged, min-iteration floor,
# residual refresh, rho breakdown, indefiniteness, non-finite operator.


def test_cg_reference_3x3_symmetric_fixture():
    """Exact port of conjugate_gradients_solver_test.cc:90-160 (same A, b,
    warm start x0=1, r_tolerance 1e-9)."""
    A = np.array([[2.0, -1.0, 0.0], [-1.0, 2.0, -1.0], [0.0, -1.0, 2.0]])
    b = np.array([-1.0, 0.0, 3.0])
    res = conjugate_gradients(
        _op(A), jnp.asarray(b), x0=jnp.ones(3),
        min_num_iterations=1, max_num_iterations=10,
        residual_reset_period=20, q_tolerance=0.0, r_tolerance=1e-9,
    )
    assert int(res.termination) == CG_SUCCESS
    np.testing.assert_allclose(np.asarray(res.x), np.linalg.solve(A, b),
                               atol=1e-8)


def test_cg_min_iterations_floor():
    """min_num_iterations forbids the r-tolerance exit before the floor:
    a loose r_tolerance that would exit at iteration 1 must still run 3
    iterations when min_num_iterations=3."""
    A = np.array([[2.0, -1.0, 0.0], [-1.0, 2.0, -1.0], [0.0, -1.0, 2.0]])
    b = np.array([-1.0, 0.0, 3.0])
    loose = conjugate_gradients(
        _op(A), jnp.asarray(b), min_num_iterations=1, max_num_iterations=10,
        r_tolerance=0.9,
    )
    floored = conjugate_gradients(
        _op(A), jnp.asarray(b), min_num_iterations=3, max_num_iterations=10,
        r_tolerance=0.9,
    )
    assert int(loose.num_iterations) == 1
    assert int(floored.num_iterations) == 3
    assert int(floored.termination) == CG_SUCCESS


def test_cg_warm_start_already_converged():
    """x0 = exact solution and min_num_iterations=0: the pre-loop check
    exits with 0 iterations (conjugate_gradients_solver.h early exit)."""
    A = np.array([[2.0, -1.0, 0.0], [-1.0, 2.0, -1.0], [0.0, -1.0, 2.0]])
    b = np.array([-1.0, 0.0, 3.0])
    xstar = np.linalg.solve(A, b)
    res = conjugate_gradients(
        _op(A), jnp.asarray(b), x0=jnp.asarray(xstar),
        min_num_iterations=0, r_tolerance=1e-8,
    )
    assert int(res.num_iterations) == 0
    assert int(res.termination) == CG_SUCCESS


def test_cg_residual_refresh_still_converges():
    """A long solve with residual_reset_period=3 (refresh every 3 iters,
    conjugate_gradients_solver.h:222-237) reaches the same answer."""
    rng = np.random.default_rng(7)
    M = rng.standard_normal((24, 24))
    A = M @ M.T + 1e-2 * np.eye(24)
    b = rng.standard_normal(24)
    res = conjugate_gradients(
        _op(A), jnp.asarray(b), r_tolerance=1e-10, max_num_iterations=200,
        residual_reset_period=3,
    )
    assert int(res.termination) == CG_SUCCESS
    np.testing.assert_allclose(np.asarray(res.x), np.linalg.solve(A, b),
                               rtol=1e-6, atol=1e-8)


def test_cg_rho_breakdown_reports_failure():
    """A zero preconditioner makes rho = r'z = 0 on the first iteration —
    the rho-breakdown guard must exit with FAILURE, not NaN."""
    A = np.array([[2.0, -1.0], [-1.0, 2.0]])
    res = conjugate_gradients(
        _op(A), jnp.asarray([1.0, 1.0]),
        preconditioner=lambda v: jnp.zeros_like(v),
        max_num_iterations=5, r_tolerance=1e-10,
    )
    assert int(res.termination) == CG_FAILURE
    assert np.all(np.isfinite(np.asarray(res.x)))


def test_cg_nonfinite_operator_reports_failure():
    """An operator returning +inf must trip the pq/alpha guards and exit
    FAILURE with the previous (finite) iterate retained."""
    def bad_op(v):
        return jnp.full_like(v, jnp.inf)

    res = conjugate_gradients(
        bad_op, jnp.asarray([1.0, 2.0]), max_num_iterations=5,
        r_tolerance=1e-10,
    )
    assert int(res.termination) == CG_FAILURE


def test_cg_q_and_r_disabled_runs_to_cap():
    """q_tolerance=0 and r_tolerance=-1 disable both convergence tests:
    the loop runs exactly max_num_iterations and reports NO_CONVERGENCE."""
    rng = np.random.default_rng(3)
    M = rng.standard_normal((16, 16))
    A = M @ M.T + 1e-3 * np.eye(16)
    b = rng.standard_normal(16)
    res = conjugate_gradients(
        _op(A), jnp.asarray(b), q_tolerance=0.0, r_tolerance=-1.0,
        max_num_iterations=4,
    )
    assert int(res.num_iterations) == 4
    assert int(res.termination) == CG_NO_CONVERGENCE
