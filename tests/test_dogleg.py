"""Dogleg strategy tests (dogleg_strategy_test.cc analog)."""

import jax.numpy as jnp
import numpy as np
import pytest

import ceres_tpu as ct
from ceres_tpu.evaluator import Evaluator

pytestmark = pytest.mark.device


def _powell_problem():
    def powell_fn(x1, x2, x3, x4):
        return jnp.stack(
            [
                x1[0] + 10 * x2[0],
                5**0.5 * (x3[0] - x4[0]),
                (x2[0] - 2 * x3[0]) ** 2,
                10**0.5 * (x1[0] - x4[0]) ** 2,
            ]
        )

    p = ct.Problem()
    ids = [p.add_parameter_block(np.array([v])) for v in (3.0, -1.0, 0.0, 1.0)]
    p.add_residual_block(powell_fn, None, ids)
    return p


@pytest.mark.parametrize(
    "dtype", ["TRADITIONAL_DOGLEG", "SUBSPACE_DOGLEG"]
)
def test_powell_converges(dtype):
    p = _powell_problem()
    opts = ct.SolverOptions(
        trust_region_strategy_type=ct.TrustRegionStrategyType.DOGLEG,
        dogleg_type=getattr(ct.DoglegType, dtype),
        linear_solver_type=ct.LinearSolverType.DENSE_QR,
        max_num_iterations=100,
    )
    s = ct.solve(opts, p)
    assert s.termination_type == ct.TerminationType.CONVERGENCE
    # system_test.cc:88 accuracy bar analog
    assert s.final_cost < 1e-8


@pytest.mark.parametrize(
    "dtype", ["TRADITIONAL_DOGLEG", "SUBSPACE_DOGLEG"]
)
def test_curve_fitting_matches_lm(dtype):
    """Dogleg reaches the same minimum as LM on the curve-fitting data."""

    def make():
        rng = np.random.default_rng(5)
        x = np.linspace(0, 5, 67)
        y = np.exp(0.3 * x + 0.1) + 0.05 * rng.standard_normal(67)

        def resid(mc, data):
            xx, yy = data
            return yy - jnp.exp(mc[0] * xx + mc[1])

        p = ct.Problem()
        b = p.add_parameter_block(np.zeros(2))
        p.add_residual_block(
            resid, None, [b], data=(jnp.asarray(x), jnp.asarray(y))
        )
        return p

    lm = ct.solve(ct.SolverOptions(max_num_iterations=100), make())
    opts = ct.SolverOptions(
        trust_region_strategy_type=ct.TrustRegionStrategyType.DOGLEG,
        dogleg_type=getattr(ct.DoglegType, dtype),
        max_num_iterations=200,
    )
    dl = ct.solve(opts, make())
    np.testing.assert_allclose(dl.final_cost, lm.final_cost, rtol=1e-6)


def test_traditional_step_cases():
    """The three dogleg cases: GN inside, Cauchy outside, interpolation.

    Checked against the closed-form solution of the scaled trust-region
    subproblem on a small random dense system."""
    from ceres_tpu.dogleg import DoglegStrategy
    from ceres_tpu.trust_region import _make_linear_solve

    rng = np.random.default_rng(0)
    p = ct.Problem()
    ids = p.add_parameter_blocks(rng.standard_normal((3, 2)))

    def resid(a, b, data):
        A1, A2, rhs = data
        return A1 @ a + A2 @ b - rhs

    data = (
        rng.standard_normal((8, 3, 2)),
        rng.standard_normal((8, 3, 2)),
        rng.standard_normal((8, 3)),
    )
    i = rng.integers(0, 3, 8)
    j = (i + 1) % 3
    p.add_residual_blocks(resid, None, [ids[i], ids[j]], data=data)
    program = p.program()
    ev = Evaluator(program)
    full = ev.cost_gradient_jacobian(program.initial_ambient())
    ctx = full.jacobian_context

    opts = ct.SolverOptions(
        trust_region_strategy_type=ct.TrustRegionStrategyType.DOGLEG,
        linear_solver_type=ct.LinearSolverType.DENSE_QR,
    )
    linear_solve, solve_aux = _make_linear_solve(opts, program)
    strat = DoglegStrategy(opts, linear_solve, solve_aux)

    # Huge radius -> pure (regularized) Gauss-Newton step.
    strat.radius = 1e12
    step_gn, mcc, _, _ = strat.compute_step(ctx)
    J = np.asarray(ctx.to_dense())
    f = np.asarray(ctx.residual_vector())
    gn_expected = -np.linalg.solve(
        J.T @ J + strat.mu * np.diag(np.clip((J * J).sum(0), 1e-6, None)),
        J.T @ f,
    )
    np.testing.assert_allclose(
        np.asarray(step_gn), gn_expected, rtol=1e-6, atol=1e-10
    )
    assert mcc > 0

    # Tiny radius -> scaled Cauchy step with ||D step|| == radius.
    strat.reuse = False
    strat._cache = None
    strat.radius = 1e-6
    step_c, _, _, _ = strat.compute_step(ctx)
    D = np.sqrt(np.clip((J * J).sum(0), 1e-6, None))
    np.testing.assert_allclose(
        np.linalg.norm(D * np.asarray(step_c)), 1e-6, rtol=1e-8
    )


def test_radius_update_rules():
    """StepAccepted/StepRejected semantics (dogleg_strategy.cc:617-643)."""
    from ceres_tpu.dogleg import DoglegStrategy

    opts = ct.SolverOptions(
        trust_region_strategy_type=ct.TrustRegionStrategyType.DOGLEG,
        initial_trust_region_radius=4.0,
    )
    s = DoglegStrategy(opts, lambda ctx, D, aux: (None, 0))
    s.dogleg_step_norm = 10.0
    s.step_accepted(0.9)  # quality > 0.75 -> radius >= 3 * step_norm
    assert s.radius == 30.0
    s.step_accepted(0.1)  # quality < 0.25 -> radius halves
    assert s.radius == 15.0
    s.step_rejected(0.0)
    assert s.radius == 7.5 and s.reuse
    s.step_is_invalid()
    assert not s.reuse
