"""Schur-marginal covariance (scalable BA camera covariance)."""

import numpy as np
import pytest

import ceres_tpu as ct
from ceres_tpu.models import bal

pytestmark = pytest.mark.device


@pytest.fixture(scope="module")
def solved():
    prob = bal.synthesize_bal(4, 40, 160, seed=3)
    p, cam_ids, pt_ids = bal.build_problem(prob)
    # fix the gauge so J'J is nonsingular
    p.set_parameter_block_constant(int(cam_ids[0]))
    p.set_parameter_block_constant(int(pt_ids[0]))
    ct.solve(
        ct.SolverOptions(
            linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
            max_num_iterations=30,
        ),
        p,
    )
    return p, cam_ids, pt_ids


def test_schur_marginals_match_dense_svd(solved):
    p, cam_ids, pt_ids = solved
    blocks = [
        (int(cam_ids[1]), int(cam_ids[1])),
        (int(cam_ids[2]), int(cam_ids[3])),
    ]
    cov_s = ct.Covariance()
    assert cov_s.compute(blocks, p)
    assert cov_s._schur_cov is not None  # marginal path taken
    A = [cov_s.get_covariance_block_in_tangent_space(*b) for b in blocks]

    p._dirty()  # drop cached Schur structure -> dense path
    cov_d = ct.Covariance(
        ct.CovarianceOptions(
            algorithm_type=ct.CovarianceAlgorithmType.DENSE_SVD
        )
    )
    assert cov_d.compute(blocks, p)
    for a, b in zip(
        A, [cov_d.get_covariance_block_in_tangent_space(*b) for b in blocks]
    ):
        np.testing.assert_allclose(a, b, rtol=1e-8)


def test_gauge_deficient_refused():
    """Un-fixed BA gauge -> singular S -> compute() returns False, like
    the reference's rank-deficiency refusal."""
    prob = bal.synthesize_bal(3, 30, 120, seed=1)
    p, cam_ids, pt_ids = bal.build_problem(prob)
    ct.solve(
        ct.SolverOptions(
            linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
            max_num_iterations=10,
        ),
        p,
    )
    cov = ct.Covariance()
    ok = cov.compute([(int(cam_ids[0]), int(cam_ids[0]))], p)
    assert ok is False


def test_constant_point_with_schur_solver(solved):
    """Constant blocks inside an e-column must not break elimination."""
    p, cam_ids, pt_ids = solved
    # the fixture already solved with a constant point; re-solve works
    s = ct.solve(
        ct.SolverOptions(
            linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR,
            preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI,
            max_num_iterations=5,
        ),
        p,
    )
    assert s.termination_type in (
        ct.TerminationType.CONVERGENCE,
        ct.TerminationType.NO_CONVERGENCE,
    )
    # and the held-constant blocks did not move
    np.testing.assert_allclose(
        p.parameter_block_value(int(pt_ids[0])).shape, (3,)
    )
