"""End-to-end system tests.

Mirrors the reference's SystemTest strategy (system_test.cc:30-110,
test_util.h:86-127): solve well-known problems under multiple solver
configurations and require matching final residuals/costs.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import ceres_tpu as ct

pytestmark = pytest.mark.device


def _solve_powell(linear_solver, **kw):
    """Powell's singular function (system_test.cc:30-110)."""
    p = ct.Problem()
    x1 = p.add_parameter_block(np.array([3.0]))
    x2 = p.add_parameter_block(np.array([-1.0]))
    x3 = p.add_parameter_block(np.array([0.0]))
    x4 = p.add_parameter_block(np.array([1.0]))

    p.add_residual_block(lambda a, b: a + 10.0 * b, None, [x1, x2])
    p.add_residual_block(
        lambda c, d: jnp.sqrt(5.0) * (c - d), None, [x3, x4]
    )
    p.add_residual_block(lambda b, c: (b - 2.0 * c) ** 2, None, [x2, x3])
    p.add_residual_block(
        lambda a, d: jnp.sqrt(10.0) * (a - d) ** 2, None, [x1, x4]
    )

    opts = ct.SolverOptions(
        linear_solver_type=linear_solver,
        max_num_iterations=100,
        **kw,
    )
    summary = ct.solve(opts, p)
    return p, summary, [x1, x2, x3, x4]


@pytest.mark.parametrize(
    "solver",
    [
        ct.LinearSolverType.DENSE_QR,
        ct.LinearSolverType.DENSE_NORMAL_CHOLESKY,
        ct.LinearSolverType.CGNR,
    ],
)
def test_powell(solver):
    p, summary, blocks = _solve_powell(solver)
    assert summary.termination_type == ct.TerminationType.CONVERGENCE
    # Minimum is at the origin with cost 0 (system_test.cc:88 uses 1e-8 on
    # residuals; cost is the square).
    assert summary.final_cost < 1e-10
    for b in blocks:
        assert abs(p.parameter_block_value(b)[0]) < 2e-2


def _curve_fit_problem(loss=None, batched=False):
    """y = exp(m x + c) fit (examples/curve_fitting.cc data shape)."""
    x_data = np.linspace(0, 5, 67)
    rng = np.random.default_rng(0)
    y_data = np.exp(0.3 * x_data + 0.1) + 0.01 * rng.standard_normal(67)

    p = ct.Problem()
    m = p.add_parameter_block(np.array([0.0]))
    c = p.add_parameter_block(np.array([0.0]))

    def resid(mb, cb, data):
        xx, yy = data
        return yy - jnp.exp(mb[0] * xx + cb[0])

    if batched:
        p.add_residual_blocks(
            resid,
            loss,
            [np.full(67, m), np.full(67, c)],
            data=(x_data.reshape(67, 1), y_data.reshape(67, 1)),
        )
    else:
        for i in range(67):
            p.add_residual_block(
                resid,
                loss,
                [m, c],
                data=(np.array([x_data[i]]), np.array([y_data[i]])),
            )
    return p, m, c


@pytest.mark.parametrize("batched", [False, True])
def test_curve_fitting(batched):
    p, m, c = _curve_fit_problem(batched=batched)
    opts = ct.SolverOptions(linear_solver_type=ct.LinearSolverType.DENSE_QR)
    summary = ct.solve(opts, p)
    assert summary.termination_type == ct.TerminationType.CONVERGENCE
    assert p.parameter_block_value(m)[0] == pytest.approx(0.3, abs=1e-2)
    assert p.parameter_block_value(c)[0] == pytest.approx(0.1, abs=2e-2)


def test_robust_curve_fitting():
    """With outliers + CauchyLoss (examples/robust_curve_fitting.cc)."""
    x_data = np.linspace(0, 5, 67)
    y_data = np.exp(0.3 * x_data + 0.1)
    y_data[::9] += 5.0  # outliers

    p = ct.Problem()
    m = p.add_parameter_block(np.array([0.0]))
    c = p.add_parameter_block(np.array([0.0]))

    def resid(mb, cb, data):
        xx, yy = data
        return yy - jnp.exp(mb[0] * xx + cb[0])

    p.add_residual_blocks(
        resid,
        ct.CauchyLoss(0.5),
        [np.full(67, m), np.full(67, c)],
        data=(x_data.reshape(67, 1), y_data.reshape(67, 1)),
    )
    opts = ct.SolverOptions(linear_solver_type=ct.LinearSolverType.DENSE_QR)
    summary = ct.solve(opts, p)
    assert summary.termination_type == ct.TerminationType.CONVERGENCE
    assert p.parameter_block_value(m)[0] == pytest.approx(0.3, abs=2e-2)
    assert p.parameter_block_value(c)[0] == pytest.approx(0.1, abs=5e-2)


def test_bounds_projection():
    """Box-constrained quadratic: solution must hit the bound
    (problem.h:333-341 + projected line search)."""
    p = ct.Problem()
    a = p.add_parameter_block(np.array([5.0]))
    p.set_parameter_lower_bound(a, 0, 2.0)

    def r(x):
        return x  # min at 0, but bounded below by 2

    p.add_residual_block(r, None, [a])
    opts = ct.SolverOptions(linear_solver_type=ct.LinearSolverType.DENSE_QR)
    summary = ct.solve(opts, p)
    assert p.parameter_block_value(a)[0] == pytest.approx(2.0, abs=1e-8)
    assert summary.is_solution_usable()


def test_solver_respects_max_iterations():
    p, m, c = _curve_fit_problem()
    opts = ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.DENSE_QR,
        max_num_iterations=1,
        function_tolerance=1e-30,
        parameter_tolerance=1e-30,
        gradient_tolerance=1e-30,
    )
    summary = ct.solve(opts, p)
    assert summary.termination_type == ct.TerminationType.NO_CONVERGENCE


def test_callbacks():
    p, m, c = _curve_fit_problem()
    seen = []

    def cb(it):
        seen.append(it.iteration)
        if it.iteration >= 2:
            return ct.CallbackReturnType.SOLVER_TERMINATE_SUCCESSFULLY
        return ct.CallbackReturnType.SOLVER_CONTINUE

    opts = ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.DENSE_QR, callbacks=[cb]
    )
    summary = ct.solve(opts, p)
    assert summary.termination_type == ct.TerminationType.USER_SUCCESS
    assert max(seen) == 2


def test_summary_reports():
    p, m, c = _curve_fit_problem()
    opts = ct.SolverOptions(linear_solver_type=ct.LinearSolverType.DENSE_QR)
    summary = ct.solve(opts, p)
    brief = summary.brief_report()
    assert "Final cost" in brief
    full = summary.full_report()
    assert "Residual blocks" in full
    assert summary.num_residuals == 67
    assert summary.num_effective_parameters == 2


def test_all_constant_problem():
    p = ct.Problem()
    a = p.add_parameter_block(np.array([1.0]))
    p.set_parameter_block_constant(a)

    def r(x):
        return x

    p.add_residual_block(r, None, [a])
    summary = ct.solve(ct.SolverOptions(), p)
    assert summary.termination_type == ct.TerminationType.CONVERGENCE
    assert summary.final_cost == pytest.approx(0.5)


def test_line_search_minimizer_on_problem():
    p, m, c = _curve_fit_problem()
    opts = ct.SolverOptions(
        minimizer_type=ct.MinimizerType.LINE_SEARCH,
        max_num_iterations=200,
    )
    summary = ct.solve(opts, p)
    assert summary.is_solution_usable()
    assert p.parameter_block_value(m)[0] == pytest.approx(0.3, abs=2e-2)
