"""Cubic Hermite (Catmull-Rom) interpolation of sampled functions/images.

JAX analog of ``include/ceres/cubic_interpolation.h``:
``CubicHermiteSpline`` (:65-91), ``Grid1D`` (:184), ``CubicInterpolator``
(:124), ``Grid2D`` (:381), ``BiCubicInterpolator`` (:252).

Everything is pure jnp and autodiff-transparent: the reference threads
Jets through Evaluate; here ``jax.jacfwd``/``grad`` differentiate through
the spline automatically (the cell index has zero derivative, the local
polynomial carries it — identical values and derivatives). Evaluations
vectorize with ``vmap`` and the 4-point gathers batch onto the VPU, so an
image-warp residual family evaluates as one kernel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def cubic_hermite_spline(p0, p1, p2, p3, x):
    """f and dfdx of the Catmull-Rom spline on [0,1]
    (cubic_interpolation.h:65-91). Returns (f, dfdx); p* may be vectors."""
    a = 0.5 * (-p0 + 3.0 * p1 - 3.0 * p2 + p3)
    b = 0.5 * (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3)
    c = 0.5 * (-p0 + p2)
    d = p1
    f = d + x * (c + x * (b + x * a))
    dfdx = c + x * (2.0 * b + 3.0 * a * x)
    return f, dfdx


class Grid1D:
    """Bounded 1-D grid of (possibly vector-valued) samples with edge
    clamping (cubic_interpolation.h:184-247).

    data: (N,) or (N, D) array; x outside [begin, end) clamps to the edge
    sample like the reference's Grid1D::GetValue.
    """

    def __init__(self, data, begin: int = 0):
        data = jnp.asarray(data, dtype=jnp.float64)
        if data.ndim == 1:
            data = data[:, None]
        self.data = data
        self.begin = begin
        self.num = data.shape[0]

    def value(self, n):
        idx = jnp.clip(n - self.begin, 0, self.num - 1)
        return self.data[idx]


class CubicInterpolator:
    """f(x), f'(x) anywhere on the real line (cubic_interpolation.h:124).

    ``evaluate(x)`` returns (f, dfdx) with shapes (D,). Use inside residual
    functions directly — autodiff flows through.
    """

    def __init__(self, grid: Grid1D):
        self.grid = grid

    def evaluate(self, x):
        n = jnp.floor(x).astype(jnp.int32)
        p0 = self.grid.value(n - 1)
        p1 = self.grid.value(n)
        p2 = self.grid.value(n + 1)
        p3 = self.grid.value(n + 2)
        f, dfdx = cubic_hermite_spline(p0, p1, p2, p3, x - n)
        return f, dfdx

    def __call__(self, x):
        return self.evaluate(x)[0]


class Grid2D:
    """Bounded 2-D grid (cubic_interpolation.h:381-436).

    data: (R, C) or (R, C, D). row-major semantics of the reference's
    interleaved/stacked layouts collapse to one array here.
    """

    def __init__(self, data, row_begin: int = 0, col_begin: int = 0):
        data = jnp.asarray(data, dtype=jnp.float64)
        if data.ndim == 2:
            data = data[:, :, None]
        self.data = data
        self.row_begin = row_begin
        self.col_begin = col_begin
        self.rows = data.shape[0]
        self.cols = data.shape[1]

    def value(self, r, c):
        ri = jnp.clip(r - self.row_begin, 0, self.rows - 1)
        ci = jnp.clip(c - self.col_begin, 0, self.cols - 1)
        return self.data[ri, ci]


class BiCubicInterpolator:
    """f(r, c), df/dr, df/dc via row-then-column cubic Hermite splines
    (cubic_interpolation.h:252-379)."""

    def __init__(self, grid: Grid2D):
        self.grid = grid

    def evaluate(self, r, c):
        row = jnp.floor(r).astype(jnp.int32)
        col = jnp.floor(c).astype(jnp.int32)
        cf = c - col
        rf = r - row

        # Interpolate 4 rows along the column direction, then interpolate
        # the resulting values (and their d/dc) along the row direction —
        # the same double-spline the reference uses.
        def row_spline(ri):
            p0 = self.grid.value(ri, col - 1)
            p1 = self.grid.value(ri, col)
            p2 = self.grid.value(ri, col + 1)
            p3 = self.grid.value(ri, col + 2)
            return cubic_hermite_spline(p0, p1, p2, p3, cf)

        f0, df0 = row_spline(row - 1)
        f1, df1 = row_spline(row)
        f2, df2 = row_spline(row + 1)
        f3, df3 = row_spline(row + 2)

        f, dfdr = cubic_hermite_spline(f0, f1, f2, f3, rf)
        dfdc, _ = cubic_hermite_spline(df0, df1, df2, df3, rf)
        return f, dfdr, dfdc

    def __call__(self, r, c):
        return self.evaluate(r, c)[0]
