"""Linear solver layer tests.

Mirrors the reference's strategy of testing every linear solver against a
golden dense factorization (linear_least_squares_problems.h fixtures +
cross-implementation equivalence, SURVEY.md §4.2/4.4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ceres_tpu as ct
from ceres_tpu.evaluator import Evaluator
from ceres_tpu.linear.cg import CG_SUCCESS, conjugate_gradients
from ceres_tpu.linear.dense import solve_dense_normal_cholesky, solve_dense_qr
from ceres_tpu.linear.cgnr import solve_cgnr
from ceres_tpu.linear.preconditioners import (
    block_jacobi_preconditioner,
    scalar_jacobi_preconditioner,
)

pytestmark = pytest.mark.device


def _random_problem(seed=0, n_blocks=6, block=3, n_res=40):
    """Random well-conditioned least-squares problem via the Problem API."""
    rng = np.random.default_rng(seed)
    p = ct.Problem()
    ids = p.add_parameter_blocks(rng.standard_normal((n_blocks, block)))

    def resid(a, b, data):
        A1, A2, rhs = data
        return A1 @ a + A2 @ b - rhs

    i_idx = rng.integers(0, n_blocks, n_res)
    j_idx = (i_idx + 1 + rng.integers(0, n_blocks - 1, n_res)) % n_blocks
    data = (
        rng.standard_normal((n_res, 2, block)),
        rng.standard_normal((n_res, 2, block)),
        rng.standard_normal((n_res, 2)),
    )
    p.add_residual_blocks(resid, None, [ids[i_idx], ids[j_idx]], data=data)
    prog = p.program()
    ev = Evaluator(prog)
    full = ev.cost_gradient_jacobian(prog.initial_ambient())
    return prog, full.jacobian_context


def test_dense_solvers_agree_with_numpy():
    prog, ctx = _random_problem()
    J = np.asarray(ctx.to_dense())
    f = np.asarray(ctx.residual_vector())
    D = np.full(J.shape[1], 0.5)
    lhs = J.T @ J + np.diag(D * D)
    expected = np.linalg.solve(lhs, J.T @ f)

    y_chol = np.asarray(solve_dense_normal_cholesky(ctx, jnp.asarray(D)))
    np.testing.assert_allclose(y_chol, expected, rtol=1e-8)

    y_qr = np.asarray(solve_dense_qr(ctx, jnp.asarray(D)))
    np.testing.assert_allclose(y_qr, expected, rtol=1e-8)


def test_matvec_consistency():
    """Matrix-free products must match the dense materialization
    (the reference's cross-implementation equivalence pattern)."""
    prog, ctx = _random_problem(seed=1)
    J = np.asarray(ctx.to_dense())
    rng = np.random.default_rng(2)
    v = rng.standard_normal(J.shape[1])
    Jv_blocks = ctx.matvec(jnp.asarray(v))
    Jv = np.concatenate([np.asarray(b).reshape(-1) for b in Jv_blocks])
    np.testing.assert_allclose(Jv, J @ v, rtol=1e-10)

    ntv = np.asarray(ctx.normal_matvec(jnp.asarray(v)))
    np.testing.assert_allclose(ntv, J.T @ (J @ v), rtol=1e-10)

    d = np.asarray(ctx.squared_column_norms())
    np.testing.assert_allclose(d, np.sum(J * J, axis=0), rtol=1e-10)

    g = np.asarray(ctx.gradient())
    f = np.asarray(ctx.residual_vector())
    np.testing.assert_allclose(g, J.T @ f, rtol=1e-10)


def test_scale_columns():
    prog, ctx = _random_problem(seed=3)
    J = np.asarray(ctx.to_dense())
    s = np.linspace(0.5, 2.0, J.shape[1])
    ctx_s = ctx.scale_columns(jnp.asarray(s))
    Js = np.asarray(ctx_s.to_dense())
    np.testing.assert_allclose(Js, J * s[None, :], rtol=1e-12)


def test_block_jtj():
    prog, ctx = _random_problem(seed=4)
    J = np.asarray(ctx.to_dense())
    JtJ = J.T @ J
    group_sizes = {T: idx.shape[0] for T, idx in prog.bd_groups.items()}
    blocks = ctx.block_jtj(group_sizes)
    for T, idx in prog.bd_groups.items():
        got = np.asarray(blocks[T])
        for gi in range(idx.shape[0]):
            sl = idx[gi]
            np.testing.assert_allclose(
                got[gi], JtJ[np.ix_(sl, sl)], rtol=1e-10
            )


def test_cg_solves_spd_system():
    rng = np.random.default_rng(5)
    n = 30
    A = rng.standard_normal((n, n))
    A = A @ A.T + n * np.eye(n)
    b = rng.standard_normal(n)
    Aj = jnp.asarray(A)

    res = conjugate_gradients(
        lambda v: Aj @ v,
        jnp.asarray(b),
        max_num_iterations=200,
        r_tolerance=1e-12,
        q_tolerance=-1.0,
    )
    assert int(res.termination) == CG_SUCCESS
    np.testing.assert_allclose(np.asarray(res.x), np.linalg.solve(A, b), rtol=1e-6)


def test_cg_zero_rhs():
    res = conjugate_gradients(lambda v: v, jnp.zeros(4))
    assert int(res.termination) == CG_SUCCESS
    np.testing.assert_allclose(np.asarray(res.x), np.zeros(4))


def test_cgnr_matches_dense():
    prog, ctx = _random_problem(seed=6)
    D = jnp.full((prog.num_tangent,), 0.3)
    expected = np.asarray(solve_dense_normal_cholesky(ctx, D))

    bd = {T: jnp.asarray(idx) for T, idx in prog.bd_groups.items()}
    res = solve_cgnr(
        ctx,
        D,
        bd_groups=bd,
        max_num_iterations=500,
        q_tolerance=-1.0,
        r_tolerance=1e-12,
    )
    np.testing.assert_allclose(np.asarray(res.x), expected, rtol=1e-5, atol=1e-8)


def test_preconditioners_are_spd_inverses():
    prog, ctx = _random_problem(seed=7)
    J = np.asarray(ctx.to_dense())
    D = jnp.full((prog.num_tangent,), 0.1)
    JtJ = J.T @ J + np.diag(np.asarray(D) ** 2)

    M = scalar_jacobi_preconditioner(ctx, D)
    v = np.ones(prog.num_tangent)
    out = np.asarray(M(jnp.asarray(v)))
    np.testing.assert_allclose(out, v / np.diag(JtJ), rtol=1e-10)

    bd = {T: jnp.asarray(idx) for T, idx in prog.bd_groups.items()}
    Mb = block_jacobi_preconditioner(ctx, bd, D)
    out_b = np.asarray(Mb(jnp.asarray(v)))
    # Build expected block-diagonal inverse.
    expected = np.zeros_like(v)
    for T, idx in prog.bd_groups.items():
        for gi in range(idx.shape[0]):
            sl = idx[gi]
            expected[sl] = np.linalg.solve(JtJ[np.ix_(sl, sl)], v[sl])
    np.testing.assert_allclose(out_b, expected, rtol=1e-8)
