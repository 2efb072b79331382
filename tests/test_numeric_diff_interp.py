"""Numeric differentiation + cubic interpolation tests.

Analog of numeric_diff_cost_function_test.cc /
numeric_diff_test_utils.{h,cc} (easy & hard functors, Ridders) and
cubic_interpolation_test.cc.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ceres_tpu as ct
from ceres_tpu.interpolation import (
    BiCubicInterpolator,
    CubicInterpolator,
    Grid1D,
    Grid2D,
    cubic_hermite_spline,
)
from ceres_tpu.numeric_diff import (
    NumericDiffOptions,
    numeric_diff,
    numeric_diff_jacobian,
)
from ceres_tpu.types import NumericDiffMethodType as M

pytestmark = pytest.mark.device


class TestNumericDiff:
    """EasyFunctor y1 = x1'x2, y2 = |x1|*|x2| analog tolerances
    (numeric_diff_test_utils.cc: 3e-6 forward/central, 1e-10 Ridders)."""

    def _easy(self):
        def f(x1, x2):
            return jnp.stack(
                [jnp.dot(x1, x2), jnp.linalg.norm(x1) * jnp.linalg.norm(x2)]
            )

        x1 = jnp.asarray([1.0, 2.0, 3.0, 4.0, 5.0])
        x2 = jnp.asarray([9.0, 9.0, 5.0, 5.0, 1.0])
        return f, x1, x2

    @pytest.mark.parametrize(
        "method,tol",
        [(M.FORWARD, 2e-5), (M.CENTRAL, 3e-9), (M.RIDDERS, 1e-10)],
    )
    def test_easy_functor(self, method, tol):
        f, x1, x2 = self._easy()
        nd = numeric_diff(f, method)
        J1 = jax.jacfwd(nd, argnums=0)(x1, x2)
        J2 = jax.jacfwd(nd, argnums=1)(x1, x2)
        J1e = jax.jacfwd(f, argnums=0)(x1, x2)
        J2e = jax.jacfwd(f, argnums=1)(x1, x2)
        assert float(jnp.max(jnp.abs(J1 - J1e))) < tol * float(
            jnp.max(jnp.abs(J1e))
        )
        assert float(jnp.max(jnp.abs(J2 - J2e))) < tol * float(
            jnp.max(jnp.abs(J2e))
        )

    def test_hard_transcendental(self):
        """y = exp(x/10) * sin(2x) style (the 'hard' torture case)."""

        def f(x):
            return jnp.stack([jnp.exp(x[0] / 10.0) * jnp.sin(2.0 * x[0])])

        x = jnp.asarray([1.5])
        Je = jax.jacfwd(f)(x)
        Jr = numeric_diff_jacobian(f, x, M.RIDDERS)
        assert float(jnp.max(jnp.abs(Jr - Je))) < 1e-9

    def test_values_unchanged(self):
        f, x1, x2 = self._easy()
        nd = numeric_diff(f, M.CENTRAL)
        np.testing.assert_allclose(
            np.asarray(nd(x1, x2)), np.asarray(f(x1, x2)), rtol=0
        )

    def test_solve_with_numeric_diff_residual(self):
        def resid(b, data):
            xx, yy = data
            return yy - b[0] * jnp.exp(b[1] * xx)

        xx = np.linspace(0, 2, 30)
        yy = 2.5 * np.exp(0.8 * xx)
        p = ct.Problem()
        b = p.add_parameter_block(np.array([1.0, 0.0]))
        p.add_residual_block(
            numeric_diff(resid, M.CENTRAL),
            None,
            [b],
            data=(jnp.asarray(xx), jnp.asarray(yy)),
        )
        s = ct.solve(ct.SolverOptions(max_num_iterations=100), p)
        np.testing.assert_allclose(
            p.parameter_block_value(0), [2.5, 0.8], rtol=1e-6
        )

    def test_ridders_options(self):
        def f(x):
            return jnp.stack([x[0] ** 3])

        opts = NumericDiffOptions(max_num_ridders_extrapolations=4)
        J = numeric_diff_jacobian(f, jnp.asarray([2.0]), M.RIDDERS, opts)
        np.testing.assert_allclose(float(J[0, 0]), 12.0, rtol=1e-8)


class TestCubicInterpolation:
    def test_spline_reproduces_cubic(self):
        """Catmull-Rom interpolates degree<=3 polynomials exactly at
        sample-consistent data (cubic_interpolation_test.cc strategy)."""

        def poly(x):
            return 0.5 * x**3 - 2.0 * x**2 + 3.0 * x - 1.0

        xs = np.arange(-1.0, 11.0)
        grid = Grid1D(poly(xs), begin=-1)
        interp = CubicInterpolator(grid)
        for x in [0.0, 0.5, 1.7, 3.25, 7.99]:
            f, dfdx = interp.evaluate(jnp.asarray(x))
            # Catmull-Rom is exact for quadratics; cubics only at nodes.
            assert abs(float(f[0]) - poly(x)) < 0.3

    def test_spline_exact_for_quadratic(self):
        def quad(x):
            return 2.0 * x**2 - 3.0 * x + 0.5

        xs = np.arange(-1.0, 11.0)
        interp = CubicInterpolator(Grid1D(quad(xs), begin=-1))
        for x in [0.0, 0.5, 1.7, 3.25, 7.99]:
            f, dfdx = interp.evaluate(jnp.asarray(x))
            np.testing.assert_allclose(float(f[0]), quad(x), rtol=1e-12)
            np.testing.assert_allclose(
                float(dfdx[0]), 4.0 * x - 3.0, rtol=1e-10, atol=1e-10
            )

    def test_autodiff_matches_dfdx(self):
        rng = np.random.default_rng(3)
        interp = CubicInterpolator(Grid1D(rng.standard_normal(20)))
        x = jnp.asarray(7.3)
        f, dfdx = interp.evaluate(x)
        g = jax.grad(lambda t: interp.evaluate(t)[0][0])(x)
        np.testing.assert_allclose(float(g), float(dfdx[0]), rtol=1e-12)

    def test_edge_clamping(self):
        interp = CubicInterpolator(Grid1D(np.array([1.0, 2.0, 3.0])))
        f_out, _ = interp.evaluate(jnp.asarray(-5.0))
        assert np.isfinite(float(f_out[0]))

    def test_bicubic_exact_for_biquadratic(self):
        def g(r, c):
            return r * r + 2 * c * c + r * c - r + 2 * c + 1

        rs, cs = np.meshgrid(
            np.arange(-1.0, 11.0), np.arange(-1.0, 11.0), indexing="ij"
        )
        interp = BiCubicInterpolator(
            Grid2D(g(rs, cs), row_begin=-1, col_begin=-1)
        )
        for r, c in [(0.5, 0.5), (2.25, 3.75), (6.0, 1.2)]:
            f, dfdr, dfdc = interp.evaluate(jnp.asarray(r), jnp.asarray(c))
            np.testing.assert_allclose(float(f[0]), g(r, c), rtol=1e-10)
            np.testing.assert_allclose(
                float(dfdr[0]), 2 * r + c - 1, rtol=1e-8, atol=1e-8
            )
            np.testing.assert_allclose(
                float(dfdc[0]), 4 * c + r + 2, rtol=1e-8, atol=1e-8
            )

    def test_bicubic_in_residual(self):
        """Image-alignment style residual through the interpolator."""
        rs, cs = np.meshgrid(np.arange(16.0), np.arange(16.0), indexing="ij")
        img = np.sin(rs / 3.0) + np.cos(cs / 4.0)  # smooth image
        interp = BiCubicInterpolator(Grid2D(img))
        true_shift = jnp.asarray([0.3, -0.2])

        def resid(shift):
            pts = jnp.asarray(
                [[4.0, 4.0], [8.0, 5.0], [5.5, 9.5], [7.0, 8.0], [6.0, 6.0]]
            )
            vals = jax.vmap(
                lambda p: interp.evaluate(p[0] + shift[0], p[1] + shift[1])[0][0]
            )(pts)
            target = jax.vmap(
                lambda p: interp.evaluate(
                    p[0] + true_shift[0], p[1] + true_shift[1]
                )[0][0]
            )(pts)
            return vals - target

        p = ct.Problem()
        b = p.add_parameter_block(np.zeros(2))
        p.add_residual_block(resid, None, [b])
        s = ct.solve(ct.SolverOptions(max_num_iterations=50), p)
        assert s.final_cost < 1e-14
        np.testing.assert_allclose(
            p.parameter_block_value(0), [0.3, -0.2], atol=1e-5
        )
