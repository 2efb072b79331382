"""Batched small-block linear algebra in closed form.

The reference hand-rolls fixed-size dense kernels for the tiny blocks at
the heart of bundle adjustment (``internal/ceres/small_blas.h:386,472``,
``invert_psd_matrix.h:44-78``): 2x2/3x3/4x4 point blocks, 6..16-wide
camera blocks. XLA's generic ``Cholesky``/``TriangularSolve`` HLOs lower
to blocked loop algorithms built for large matrices, not for huge
batches of tiny ones.

This module provides batched equivalents as pure elementwise /
einsum code that XLA fuses into neighbouring ops:

- ``spd_inverse``: batched SPD inverse. Closed-form cofactor expansion
  for n <= 3 (exactly what InvertPSDMatrix<2,3> does via Eigen), and an
  unrolled, branch-free Cholesky + triangular inversion for moderate n
  (<= 32). Everything is (batched) elementwise math and matmuls — no XLA
  Cholesky/TriangularSolve in sight.
- ``spd_solve``: apply a precomputed inverse (one einsum).

For LM-regularized normal-equation blocks (E'E + D^2) the explicit
inverse is as stable as a factor-solve: the reference makes the same
call (schur_eliminator_impl.h uses InvertPSDMatrix on the e-blocks).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Above this block size, fall back to XLA's Cholesky (unrolled code size
# would grow as n^3 and large blocks amortize the library call anyway).
UNROLL_MAX_N = 32


def _inv1(m):
    return 1.0 / m


def _inv2(m):
    a = m[..., 0, 0]
    b = m[..., 0, 1]
    c = m[..., 1, 0]
    d = m[..., 1, 1]
    det = a * d - b * c
    inv_det = 1.0 / det
    row0 = jnp.stack([d, -b], axis=-1)
    row1 = jnp.stack([-c, a], axis=-1)
    return jnp.stack([row0, row1], axis=-2) * inv_det[..., None, None]


def _inv3(m):
    a = m[..., 0, 0]
    b = m[..., 0, 1]
    c = m[..., 0, 2]
    d = m[..., 1, 0]
    e = m[..., 1, 1]
    f = m[..., 1, 2]
    g = m[..., 2, 0]
    h = m[..., 2, 1]
    i = m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d
    det = a * A + b * B + c * C
    inv_det = 1.0 / det
    rows = [
        jnp.stack([A, D, G], axis=-1),
        jnp.stack([B, E, H], axis=-1),
        jnp.stack([C, F, I], axis=-1),
    ]
    return jnp.stack(rows, axis=-2) * inv_det[..., None, None]


def _unrolled_chol(m, n: int):
    """Cholesky factor L (lower) of batched (..., n, n) SPD matrices via
    a fully unrolled column algorithm — pure elementwise ops, no loops in
    the compiled program beyond the n^2/2 fused instructions."""
    cols = [[m[..., i, j] for j in range(n)] for i in range(n)]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = cols[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        diag = jnp.sqrt(s)
        L[j][j] = diag
        inv_diag = 1.0 / diag
        for i in range(j + 1, n):
            s = cols[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_diag
    return L


def _unrolled_spd_inverse(m, n: int):
    """inv(m) = Linv' Linv with Linv from unrolled forward substitution."""
    L = _unrolled_chol(m, n)
    # Invert the lower-triangular L column by column (unrolled).
    Linv = [[None] * n for _ in range(n)]
    for j in range(n):
        for i in range(n):
            if i < j:
                continue
            if i == j:
                Linv[i][j] = 1.0 / L[i][i]
            else:
                s = 0.0
                for k in range(j, i):
                    s = s + L[i][k] * Linv[k][j]
                Linv[i][j] = -s / L[i][i]
    rows = []
    for i in range(n):
        row = []
        for j in range(n):
            s = 0.0
            lo = max(i, j)
            for k in range(lo, n):
                s = s + Linv[k][i] * Linv[k][j]
            row.append(s)
        rows.append(jnp.stack(row, axis=-1))
    return jnp.stack(rows, axis=-2)


def spd_inverse(m: jax.Array) -> jax.Array:
    """Batched inverse of SPD matrices (..., n, n).

    Analog of invert_psd_matrix.h:44 — explicit inverse so downstream
    solves become einsums that fuse into the CG loop body.
    """
    n = m.shape[-1]
    if n == 1:
        return _inv1(m)
    if n == 2:
        return _inv2(m)
    if n == 3:
        return _inv3(m)
    if n <= UNROLL_MAX_N:
        return _unrolled_spd_inverse(m, n)
    eye = jnp.eye(n, dtype=m.dtype)
    chol = jax.scipy.linalg.cho_factor(m, lower=True)
    return jax.scipy.linalg.cho_solve(chol, jnp.broadcast_to(eye, m.shape))


def spd_solve(inv_m: jax.Array, b: jax.Array) -> jax.Array:
    """Apply precomputed inverses: (..., n, n) x (..., n) -> (..., n)."""
    return jnp.einsum("...ij,...j->...i", inv_m, b)
