"""Fields-of-Experts denoising convergence (denoising.cc parity).

The FoE normal equations are ill-conditioned grid systems. This gates:
  - the solve converges (no silent CG stall) at reference tolerances,
  - SPARSE_NORMAL_CHOLESKY and CGNR+JACOBI reach the same cost,
  - CLUSTER-free preconditioning is enough to reach gradient-tolerance
    quality on a real noisy crop,
  - the MAP estimate actually denoises (cost and residual diagnostics).
"""

import numpy as np
import pytest

import ceres_tpu as ct
from ceres_tpu.models import denoising as dn

FOE = "/root/reference/data/2x2.foe"
IMG = "/root/reference/data/ceres_noisy.pgm"


@pytest.fixture(scope="module")
def crop_problem():
    img = dn.read_pgm(IMG)[:24, :24]
    foe = dn.load_foe_file(FOE)
    return img, foe


def _solve(img, foe, **kw):
    problem, pix2d = dn.build_problem(img, foe, sigma=20.0)
    opts = dn.default_options()
    for k, v in kw.items():
        setattr(opts, k, v)
    summary = ct.solve(opts, problem)
    return problem, pix2d, summary


def test_cgnr_jacobi_converges(crop_problem):
    img, foe = crop_problem
    problem, pix2d, s = _solve(img, foe, max_num_iterations=60)
    assert s.is_solution_usable()
    # At the noisy init the data term is exactly zero, so only the FoE
    # prior can decrease — expect a modest but strict improvement.
    assert s.final_cost < s.initial_cost * 0.995
    # no silent linear-solver stall: solution is a stationary point to
    # the solver's own tolerance
    assert s.termination_type == ct.TerminationType.CONVERGENCE


def test_sparse_normal_cholesky_standin_matches_cgnr(crop_problem):
    """SPARSE_NORMAL_CHOLESKY (exact host Cholesky) must land at the same
    cost as plain CGNR+JACOBI on the FoE system."""
    img, foe = crop_problem
    _, _, s1 = _solve(img, foe, max_num_iterations=40)
    _, _, s2 = _solve(
        img,
        foe,
        max_num_iterations=40,
        linear_solver_type=ct.LinearSolverType.SPARSE_NORMAL_CHOLESKY,
    )
    assert s2.is_solution_usable()
    rel = abs(s1.final_cost - s2.final_cost) / max(s1.final_cost, 1.0)
    assert rel < 1e-3, (s1.final_cost, s2.final_cost)


def test_denoised_image_changes_and_stays_in_range(crop_problem):
    img, foe = crop_problem
    problem, pix2d, s = _solve(img, foe, max_num_iterations=40)
    out = dn.solution_image(problem, pix2d)
    # moved away from the noisy input, but stays near the image range
    assert np.abs(out - img).mean() > 0.5
    assert out.min() > -50 and out.max() < 305
