"""Matrix-free (CG) covariance path: the scalable generic analog of the
reference's sparse-QR covariance (covariance_impl.cc:361,536-796) —
columns of inverse(J'J) solved per requested block with preconditioned
CG, no dense Jacobian materialization."""

import jax.numpy as jnp
import numpy as np
import pytest

import ceres_tpu as ct
import ceres_tpu.covariance as cov_mod
from ceres_tpu.covariance import Covariance, CovarianceOptions

pytestmark = pytest.mark.device


def _chain_problem(n_blocks=12, seed=0):
    """Sparse chain: blocks x_i (size 2), residuals couple neighbors."""
    rng = np.random.default_rng(seed)
    problem = ct.Problem()
    xs = [problem.add_parameter_block(rng.normal(size=2)) for _ in range(n_blocks)]
    targets = rng.normal(size=(n_blocks, 2))
    for i in range(n_blocks):
        # anchor residual keeps J'J nonsingular
        problem.add_residual_block(
            lambda x, t=jnp.asarray(targets[i]): 1.3 * (x - t), None, [xs[i]]
        )
    for i in range(n_blocks - 1):
        problem.add_residual_block(
            lambda a, b: 0.7 * (a - 2.0 * b) + 0.1, None, [xs[i], xs[i + 1]]
        )
    return problem, xs


def _force_matrix_free(monkeypatch):
    monkeypatch.setattr(cov_mod, "DENSE_COVARIANCE_MAX_TANGENT", 1)
    monkeypatch.setattr(
        Covariance, "_compute_schur_marginals", lambda self, *a: None
    )


def test_matrix_free_matches_dense(monkeypatch):
    problem, xs = _chain_problem()
    pids = problem.parameter_block_ids()
    blocks = [(pids[0], pids[0]), (pids[1], pids[3]), (pids[5], pids[5])]

    dense = Covariance(CovarianceOptions(algorithm_type="SPARSE_QR"))
    assert dense.compute(blocks, problem)

    _force_matrix_free(monkeypatch)
    mf = Covariance(CovarianceOptions(algorithm_type="SPARSE_QR"))
    assert mf.compute(blocks, problem)
    assert mf._mf_Z is not None  # the matrix-free path actually ran

    for p1, p2 in blocks:
        a = dense.get_covariance_block(p1, p2)
        b = mf.get_covariance_block(p1, p2)
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-10)
        at = dense.get_covariance_block_in_tangent_space(p1, p2)
        bt = mf.get_covariance_block_in_tangent_space(p1, p2)
        np.testing.assert_allclose(bt, at, rtol=1e-6, atol=1e-10)


def test_matrix_free_transposed_pair(monkeypatch):
    problem, xs = _chain_problem()
    pids = problem.parameter_block_ids()
    blocks = [(pids[1], pids[3])]

    dense = Covariance()
    assert dense.compute(blocks + [(pids[3], pids[1])], problem)

    _force_matrix_free(monkeypatch)
    mf = Covariance()
    assert mf.compute(blocks, problem)
    # (p3, p1) was not requested, but its transpose was: symmetric access.
    a = dense.get_covariance_block(pids[3], pids[1])
    b = mf.get_covariance_block(pids[3], pids[1])
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-10)


def test_matrix_free_unrequested_pair_raises(monkeypatch):
    problem, xs = _chain_problem()
    pids = problem.parameter_block_ids()
    _force_matrix_free(monkeypatch)
    mf = Covariance()
    assert mf.compute([(pids[0], pids[0])], problem)
    with pytest.raises(RuntimeError):
        mf.get_covariance_block(pids[2], pids[3])


def test_matrix_free_constant_block_zero(monkeypatch):
    problem, xs = _chain_problem()
    pids = problem.parameter_block_ids()
    problem.set_parameter_block_constant(xs[2])
    _force_matrix_free(monkeypatch)
    mf = Covariance()
    assert mf.compute([(pids[2], pids[2]), (pids[0], pids[0])], problem)
    np.testing.assert_array_equal(
        mf.get_covariance_block(pids[2], pids[2]), np.zeros((2, 2))
    )
    # the non-constant block still gets a real (nonzero) covariance
    assert np.linalg.norm(mf.get_covariance_block(pids[0], pids[0])) > 0


def test_matrix_free_rank_deficient_fails(monkeypatch):
    """A parameter with a zero Jacobian column => J'J singular => the
    computation must fail like the reference's rank-deficiency report."""
    problem = ct.Problem()
    x = problem.add_parameter_block(np.array([1.0, 2.0]))
    y = problem.add_parameter_block(np.array([3.0]))
    problem.add_residual_block(lambda a: a - 1.0, None, [x])
    problem.add_residual_block(lambda b: 0.0 * b, None, [y])  # zero column
    pids = problem.parameter_block_ids()
    _force_matrix_free(monkeypatch)
    mf = Covariance()
    assert not mf.compute([(pids[0], pids[0])], problem)


def test_matrix_free_with_manifold(monkeypatch):
    """Ambient-space lift through the plus-Jacobian matches the dense
    path when a manifold is attached (covariance_impl.cc:129)."""
    problem = ct.Problem()
    rng = np.random.default_rng(3)
    qv = rng.normal(size=4)
    qv /= np.linalg.norm(qv)
    q = problem.add_parameter_block(qv, manifold=ct.QuaternionManifold())
    v = problem.add_parameter_block(rng.normal(size=3))
    target = jnp.asarray(rng.normal(size=4))

    def res_q(qq):
        return 2.0 * (qq - target)

    problem.add_residual_block(res_q, None, [q])
    problem.add_residual_block(lambda a: 1.5 * (a - 1.0), None, [v])
    pids = problem.parameter_block_ids()
    blocks = [(pids[0], pids[0]), (pids[1], pids[1])]

    dense = Covariance()
    assert dense.compute(blocks, problem)
    _force_matrix_free(monkeypatch)
    mf = Covariance()
    assert mf.compute(blocks, problem)
    for p1, p2 in blocks:
        np.testing.assert_allclose(
            mf.get_covariance_block(p1, p2),
            dense.get_covariance_block(p1, p2),
            rtol=1e-6,
            atol=1e-10,
        )
