"""During-solve gradient checking (gradient_checking_cost_function.h:105
parity): with check_gradients=True the solve must abort at the FIRST
iterate where the analytic Jacobian disagrees with finite differences —
not only at x0 (VERDICT r1 missing #7)."""

import jax
import pytest
import jax.numpy as jnp
import numpy as np

import ceres_tpu as ct

pytestmark = pytest.mark.device


# A residual term whose hand-written (custom_jvp) derivative is correct
# near the start point but wrong once the iterate crosses t >= 1 — the
# classic "bug that only shows up mid-solve".
@jax.custom_jvp
def _sneaky(t):
    return 0.5 * t


@_sneaky.defjvp
def _sneaky_jvp(primals, tangents):
    (t,), (dt,) = primals, tangents
    good = 0.5 * dt
    bad = 7.0 * dt  # wrong derivative past t = 1
    return 0.5 * t, jnp.where(t < 1.0, good, bad)


def _bad_mid_solve_problem():
    p = ct.Problem()
    pid = p.add_parameter_block(np.array([0.0]))

    def resid(x):
        return jnp.asarray([x[0] - 3.0, _sneaky(x[0])])

    p.add_residual_block(resid, None, [pid])
    return p


def test_pre_solve_check_passes_at_x0():
    from ceres_tpu.gradient_checker import check_problem_gradients

    ok, msg = check_problem_gradients(_bad_mid_solve_problem(), 1e-6)
    assert ok, msg


def test_solve_aborts_on_mid_solve_gradient_mismatch():
    problem = _bad_mid_solve_problem()
    opts = ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.DENSE_QR,
        max_num_iterations=20,
        check_gradients=True,
        gradient_check_relative_precision=1e-6,
    )
    summary = ct.solve(opts, problem)
    assert summary.termination_type == ct.TerminationType.FAILURE
    assert "Gradient check failed at iteration" in summary.message


def test_healthy_solve_passes_with_checking_enabled():
    p = ct.Problem()
    pid = p.add_parameter_block(np.array([0.0, 0.0]))
    p.add_residual_block(
        lambda x: jnp.asarray([x[0] - 1.0, x[1] + 2.0, x[0] * x[1]]),
        None,
        [pid],
    )
    opts = ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.DENSE_QR,
        max_num_iterations=30,
        check_gradients=True,
    )
    summary = ct.solve(opts, p)
    assert summary.termination_type == ct.TerminationType.CONVERGENCE
