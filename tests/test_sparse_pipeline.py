"""Pipelined host-driven sparse steps (r5, VERDICT #8).

The SPARSE_NORMAL_CHOLESKY step caches the radius-free (cells, rhs,
diag) transfer across rejected iterations and pre-factors at the
predicted post-reject radius on a worker thread; SPARSE_SCHUR
speculatively dispatches the next device prep during host
factorization. These tests force reject streaks (absurd initial trust
region) and check the pipelined paths still reproduce the exact-path
answers.
"""

import numpy as np
import pytest

import ceres_tpu as ct
from ceres_tpu.types import LinearSolverType
from ceres_tpu.utils import native

pytestmark = pytest.mark.device

needs_native = pytest.mark.skipif(
    native.get_lib() is None, reason="native core unavailable"
)


def _problem(seed=3):
    from ceres_tpu.models import bal

    prob = bal.synthesize_bal(
        num_cameras=5, num_points=80, num_observations=320,
        noise=6.0, perturb=2.5, seed=seed,
    )
    problem, _, _ = bal.build_problem(prob)
    return problem


def _solve(lst, radius0=1e4, mixed=False, min_rel_decrease=None):
    opts = ct.SolverOptions()
    opts.linear_solver_type = lst
    opts.initial_trust_region_radius = radius0
    opts.use_mixed_precision_solves = mixed
    opts.max_num_iterations = 30
    if min_rel_decrease is not None:
        opts.min_relative_decrease = min_rel_decrease
    return ct.solve(opts, _problem())


@needs_native
@pytest.mark.parametrize(
    "lst",
    [LinearSolverType.SPARSE_NORMAL_CHOLESKY, LinearSolverType.SPARSE_SCHUR],
)
def test_reject_streak_matches_reference_path(lst):
    """A huge initial radius plus a strict step-quality bar
    (min_relative_decrease, trust_region_minimizer.cc relative_decrease
    gate) forces a DETERMINISTIC reject streak; the streak exercises the
    cached-transfer + speculative-factor path. (Radius alone is not
    enough: near-Gauss-Newton steps on a well-posed problem can all be
    accepted, and whether one is rejected flips with the platform's
    rounding.) The final cost must match the
    DENSE reference to solver precision."""
    ref = _solve(LinearSolverType.DENSE_NORMAL_CHOLESKY)
    aggressive = _solve(lst, radius0=1e14, min_rel_decrease=0.9)
    assert any(not it.step_is_successful for it in aggressive.iterations), (
        "expected at least one rejected step with radius0=1e14 and "
        "min_relative_decrease=0.9"
    )
    assert (
        abs(aggressive.final_cost - ref.final_cost)
        / max(ref.final_cost, 1e-30)
        < 1e-5
    )


@needs_native
def test_sparse_pipeline_default_radius_unchanged(lst=None):
    """Sanity: the pipelined step at the default radius matches dense."""
    ref = _solve(LinearSolverType.DENSE_NORMAL_CHOLESKY)
    got = _solve(LinearSolverType.SPARSE_NORMAL_CHOLESKY)
    assert (
        abs(got.final_cost - ref.final_cost) / max(ref.final_cost, 1e-30)
        < 1e-6
    )


@needs_native
def test_mixed_pipeline_reject_streak():
    """Mixed precision + reject streak: the speculative factor is a
    single-precision refactor + refinement; results stay at tolerance."""
    ref = _solve(LinearSolverType.SPARSE_NORMAL_CHOLESKY, radius0=1e14)
    got = _solve(
        LinearSolverType.SPARSE_NORMAL_CHOLESKY, radius0=1e14, mixed=True
    )
    assert (
        abs(got.final_cost - ref.final_cost) / max(ref.final_cost, 1e-30)
        < 1e-5
    )
