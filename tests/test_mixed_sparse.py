"""Mixed-precision sparse refinement (RefinedSparseCholesky analog).

Reference: ``sparse_cholesky.h:118`` RefinedSparseCholesky — a float
sparse factorization wrapped in double-precision iterative refinement
(``iterative_refiner.{h,cc}``) — selected by
``Solver::Options::use_mixed_precision_solves`` for
SPARSE_NORMAL_CHOLESKY and SPARSE_SCHUR. Round-5 closes the r4 gap:
mixed+sparse no longer degrades to CGNR / dense-S.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import ceres_tpu as ct
from ceres_tpu.linear import sparse_cholesky as sc
from ceres_tpu.utils import native

needs_native = pytest.mark.skipif(
    native.get_lib() is None, reason="native core unavailable"
)


def random_spd_csc(n, density, seed):
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=density, random_state=rng, format="csc")
    Ad = A.toarray()
    H = Ad @ Ad.T + n * np.eye(n)
    Hs = sp.csc_matrix(H)
    Hu = sp.triu(Hs, format="csc")
    Hu.sort_indices()
    return Hu, H


class TestSingleFactor:
    @needs_native
    @pytest.mark.parametrize("n,density,seed", [(30, 0.2, 0), (120, 0.05, 1)])
    def test_f32_factor_plus_refinement_matches_f64(self, n, density, seed):
        Hu, H = random_spd_csc(n, density, seed)
        b = np.arange(1.0, n + 1.0)
        x64 = np.linalg.solve(H, b)

        f32 = sc.SparseCholesky(n, Hu.indptr, Hu.indices, precision="single")
        assert f32.Lx.dtype == np.float32
        assert f32.factorize(Hu.data) == 0
        # raw f32 backsolve: ~1e-6 relative accuracy
        x_raw = f32.solve(b)
        raw_err = np.linalg.norm(x_raw - x64) / np.linalg.norm(x64)
        assert raw_err < 1e-4
        # refined: the f64-residual loop recovers ~f64 accuracy
        x_ref = f32.refined_solve(Hu, b, num_refinement_iterations=3)
        ref_err = np.linalg.norm(x_ref - x64) / np.linalg.norm(x64)
        assert ref_err < 1e-11
        assert ref_err < raw_err or raw_err < 1e-12

    @needs_native
    def test_factor_solve_csc_mixed_route(self):
        n = 60
        Hu, H = random_spd_csc(n, 0.1, 2)
        b = np.ones(n)
        cache = {}
        x, term = sc.factor_solve_csc(
            cache, n, Hu.indptr, Hu.indices, Hu.data, b,
            mixed_precision=True, num_refinement_iterations=3,
        )
        from ceres_tpu.linear.cg import CG_SUCCESS

        assert term == CG_SUCCESS
        np.testing.assert_allclose(x, np.linalg.solve(H, b), rtol=1e-9)
        # cache holds a single-precision factor under the mixed key
        (chol,) = [v for k, v in cache.items() if k[2]]
        assert chol.precision == "single"

    @needs_native
    def test_not_positive_definite_f32(self):
        n = 10
        Hu, H = random_spd_csc(n, 0.4, 3)
        chol = sc.SparseCholesky(n, Hu.indptr, Hu.indices, precision="single")
        data = Hu.data.copy()
        # zero out the last diagonal entry -> non-SPD
        diag_positions = [
            p
            for j in range(n)
            for p in range(Hu.indptr[j], Hu.indptr[j + 1])
            if Hu.indices[p] == j and j == n - 1
        ]
        data[diag_positions[0]] = -1e6
        assert chol.factorize(data) != 0


def _bal_problem(seed=11):
    from ceres_tpu.models import bal

    prob = bal.synthesize_bal(
        num_cameras=6, num_points=120, num_observations=480,
        noise=1.0, perturb=0.3, seed=seed,
    )
    problem, _, _ = bal.build_problem(prob)
    return problem


def _solve(problem, lst, mixed, eval_dtype="float64"):
    opts = ct.SolverOptions()
    opts.linear_solver_type = lst
    opts.use_mixed_precision_solves = mixed
    opts.max_num_refinement_iterations = 3
    opts.max_num_iterations = 12
    opts.evaluation_dtype = eval_dtype
    return ct.solve(opts, problem)


class TestWiredMixedSparse:
    @needs_native
    def test_mixed_sparse_normal_cholesky_matches_exact(self):
        from ceres_tpu.types import LinearSolverType

        exact = _solve(
            _bal_problem(), LinearSolverType.SPARSE_NORMAL_CHOLESKY, False
        )
        mixed = _solve(
            _bal_problem(), LinearSolverType.SPARSE_NORMAL_CHOLESKY, True
        )
        assert mixed.termination_type == exact.termination_type
        assert (
            abs(mixed.final_cost - exact.final_cost)
            / max(exact.final_cost, 1e-30)
            < 1e-5
        )

    @needs_native
    def test_mixed_sparse_schur_matches_exact(self):
        from ceres_tpu.types import LinearSolverType

        exact = _solve(_bal_problem(), LinearSolverType.SPARSE_SCHUR, False)
        mixed = _solve(_bal_problem(), LinearSolverType.SPARSE_SCHUR, True)
        assert (
            abs(mixed.final_cost - exact.final_cost)
            / max(exact.final_cost, 1e-30)
            < 1e-5
        )

    @needs_native
    def test_mixed_sparse_uses_host_step_not_cgnr(self):
        """The r4 gap: mixed+SPARSE_NORMAL_CHOLESKY must route to the
        host sparse step (lin_iters == 1 per LM iteration), not CGNR."""
        from ceres_tpu.types import LinearSolverType

        s = _solve(
            _bal_problem(), LinearSolverType.SPARSE_NORMAL_CHOLESKY, True
        )
        # direct solves report exactly one linear iteration each
        assert s.num_linear_solver_iterations == len(s.iterations) or (
            s.num_linear_solver_iterations <= len(s.iterations) + 1
        )

    @needs_native
    def test_mixed_f32_eval_sparse_schur(self):
        """f32 evaluation + f32-factor + f64 refinement still converges
        to the f64 answer at bench tolerance (the bench's f32 configuration)."""
        from ceres_tpu.types import LinearSolverType

        exact = _solve(_bal_problem(), LinearSolverType.SPARSE_SCHUR, False)
        mixed32 = _solve(
            _bal_problem(), LinearSolverType.SPARSE_SCHUR, True,
            eval_dtype="float32",
        )
        assert (
            abs(mixed32.final_cost - exact.final_cost)
            / max(exact.final_cost, 1e-30)
            < 1e-4
        )
