"""Moré–Garbow–Hillstrom test battery (selection).

Analog of examples/more_garbow_hillstrom.cc: canonical unconstrained
minimization test functions with documented minima, run through both the
trust-region and line-search minimizers. "Testing Unconstrained
Optimization Software", TOMS 7(1) 1981.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import ceres_tpu as ct

pytestmark = pytest.mark.device


# name -> (residual fn, x0, expected minimal cost 0.5*||r||^2, blocks)
def _rosenbrock():
    def f(x):
        return jnp.stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]])

    return f, np.array([-1.2, 1.0]), 0.0


def _freudenstein_roth():
    def f(x):
        return jnp.stack(
            [
                -13.0 + x[0] + ((5.0 - x[1]) * x[1] - 2.0) * x[1],
                -29.0 + x[0] + ((x[1] + 1.0) * x[1] - 14.0) * x[1],
            ]
        )

    # global min 0 at (5, 4); local min 0.5*48.98425368 = 24.49212684
    return f, np.array([0.5, -2.0]), 24.49212684

def _powell_badly_scaled():
    def f(x):
        return jnp.stack(
            [1e4 * x[0] * x[1] - 1.0, jnp.exp(-x[0]) + jnp.exp(-x[1]) - 1.0001]
        )

    return f, np.array([0.0, 1.0]), 0.0


def _beale():
    def f(x):
        return jnp.stack(
            [
                1.5 - x[0] * (1.0 - x[1]),
                2.25 - x[0] * (1.0 - x[1] ** 2),
                2.625 - x[0] * (1.0 - x[1] ** 3),
            ]
        )

    return f, np.array([1.0, 1.0]), 0.0


def _helical_valley():
    def f(x):
        theta = jnp.arctan2(x[1], x[0]) / (2.0 * jnp.pi)
        return jnp.stack(
            [
                10.0 * (x[2] - 10.0 * theta),
                10.0 * (jnp.sqrt(x[0] ** 2 + x[1] ** 2) - 1.0),
                x[2],
            ]
        )

    return f, np.array([-1.0, 0.0, 0.0]), 0.0


def _wood():
    def f(x):
        return jnp.stack(
            [
                10.0 * (x[1] - x[0] ** 2),
                1.0 - x[0],
                jnp.sqrt(90.0) * (x[3] - x[2] ** 2),
                1.0 - x[2],
                jnp.sqrt(10.0) * (x[1] + x[3] - 2.0),
                (x[1] - x[3]) / jnp.sqrt(10.0),
            ]
        )

    return f, np.array([-3.0, -1.0, -3.0, -1.0]), 0.0


def _box3d():
    t = np.arange(1, 11) * 0.1

    def f(x):
        return (
            jnp.exp(-jnp.asarray(t) * x[0])
            - jnp.exp(-jnp.asarray(t) * x[1])
            - x[2] * (jnp.exp(-jnp.asarray(t)) - jnp.exp(-10.0 * jnp.asarray(t)))
        )

    return f, np.array([0.0, 10.0, 20.0]), 0.0


def _brown_badly_scaled():
    def f(x):
        return jnp.stack(
            [x[0] - 1e6, x[1] - 2e-6, x[0] * x[1] - 2.0]
        )

    return f, np.array([1.0, 1.0]), 0.0


BATTERY = {
    "rosenbrock": _rosenbrock,
    "freudenstein_roth": _freudenstein_roth,
    "powell_badly_scaled": _powell_badly_scaled,
    "beale": _beale,
    "helical_valley": _helical_valley,
    "wood": _wood,
    "box3d": _box3d,
    "brown_badly_scaled": _brown_badly_scaled,
}


def _solve(name, minimizer):
    fn, x0, expected = BATTERY[name]()
    p = ct.Problem()
    b = p.add_parameter_block(x0.copy())
    p.add_residual_block(fn, None, [b])
    opts = ct.SolverOptions(
        minimizer_type=getattr(ct.MinimizerType, minimizer),
        max_num_iterations=2000,
        function_tolerance=1e-14,
        gradient_tolerance=1e-14,
        parameter_tolerance=1e-14,
    )
    s = ct.solve(opts, p)
    return s, expected


@pytest.mark.parametrize("name", sorted(BATTERY))
def test_trust_region(name):
    s, expected = _solve(name, "TRUST_REGION")
    # reach the documented minimum (global or the known local one)
    assert s.final_cost <= expected + 1e-6, (name, s.final_cost, expected)


@pytest.mark.parametrize(
    "name", ["rosenbrock", "beale", "helical_valley", "wood"]
)
def test_line_search(name):
    s, expected = _solve(name, "LINE_SEARCH")
    assert s.final_cost <= expected + 1e-4, (name, s.final_cost, expected)
