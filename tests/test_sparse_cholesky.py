"""SPARSE_NORMAL_CHOLESKY: exact host simplicial Cholesky path.

Analog of internal/ceres/sparse_normal_cholesky_solver_test.cc,
sparse_cholesky_test.cc and dynamic_sparse_normal_cholesky_solver_test.cc:
the factorization is validated against dense solves, the wired solver
path is validated against DENSE_NORMAL_CHOLESKY solutions, and the
no-native fallback (reference: Eigen fallback when CHOLMOD is absent)
is exercised explicitly.
"""

import jax
import jax.numpy as jnp
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
    """Random sparse SPD matrix; returns (upper CSC, dense)."""
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=density, random_state=rng, format="csc")
    Ad = A.toarray()
    H = Ad @ Ad.T + n * np.eye(n)
    Hs = sp.csc_matrix(H)
    Hu = sp.triu(Hs, format="csc")
    Hu.sort_indices()
    return Hu, H


class TestSparseCholesky:
    @needs_native
    @pytest.mark.parametrize("n,density,seed", [(5, 0.6, 0), (40, 0.1, 1), (120, 0.03, 2)])
    def test_factor_solve_matches_dense(self, n, density, seed):
        Hu, H = random_spd_csc(n, density, seed)
        chol = sc.SparseCholesky(n, Hu.indptr, Hu.indices)
        assert chol.factorize(Hu.data) == 0
        b = np.arange(1.0, n + 1.0)
        x = chol.solve(b)
        np.testing.assert_allclose(x, np.linalg.solve(H, b), rtol=1e-10)

    @needs_native
    def test_refactorize_many_same_pattern(self):
        # analyze-once / refactor-many (sparse_cholesky.h:71-112): the
        # numeric values change, the pattern (and symbolic handle) do not.
        n = 30
        Hu, H = random_spd_csc(n, 0.15, 3)
        chol = sc.SparseCholesky(n, Hu.indptr, Hu.indices)
        b = np.ones(n)
        for scale in (1.0, 2.5, 0.3):
            assert chol.factorize(Hu.data * scale) == 0
            np.testing.assert_allclose(
                chol.solve(b), np.linalg.solve(H * scale, b), rtol=1e-10
            )

    @needs_native
    def test_multiple_rhs(self):
        n = 25
        Hu, H = random_spd_csc(n, 0.2, 4)
        chol = sc.SparseCholesky(n, Hu.indptr, Hu.indices)
        assert chol.factorize(Hu.data) == 0
        B = np.random.default_rng(0).normal(size=(3, n))
        X = chol.solve(B)
        np.testing.assert_allclose(X, np.linalg.solve(H, B.T).T, rtol=1e-9)

    @needs_native
    def test_natural_ordering(self):
        n = 20
        Hu, H = random_spd_csc(n, 0.2, 5)
        chol = sc.SparseCholesky(n, Hu.indptr, Hu.indices, ordering="NATURAL")
        assert chol.factorize(Hu.data) == 0
        b = np.ones(n)
        np.testing.assert_allclose(chol.solve(b), np.linalg.solve(H, b), rtol=1e-10)

    @needs_native
    def test_not_positive_definite_reports_column(self):
        # indefinite matrix -> rc = failed permuted column + 1
        # (LinearSolverTerminationType FAILURE, not a crash).
        n = 6
        Hu, H = random_spd_csc(n, 0.5, 6)
        chol = sc.SparseCholesky(n, Hu.indptr, Hu.indices)
        bad = Hu.data.copy()
        # flip the sign of every diagonal entry
        for j in range(n):
            seg = slice(Hu.indptr[j], Hu.indptr[j + 1])
            rows = Hu.indices[seg]
            bad[seg][rows == j] *= -1.0
            dloc = np.where(rows == j)[0]
            bad[Hu.indptr[j] + dloc[0]] = -abs(bad[Hu.indptr[j] + dloc[0]])
        assert chol.factorize(bad) > 0
        with pytest.raises(RuntimeError):
            chol.solve(np.ones(n))


def _tiny_residual_problem(seed=0, n_blocks=6):
    """Chain problem with overlapping 2-vectors -> banded sparse J'J."""
    rng = np.random.default_rng(seed)
    p = ct.Problem()
    blocks = [p.add_parameter_block(rng.normal(size=2)) for _ in range(n_blocks)]
    data = jnp.asarray(rng.normal(size=(n_blocks - 1, 2)))

    def chain(a, b, data):
        return jnp.asarray([a[0] * b[1] - data[0], a[1] + b[0] ** 2 - data[1]])

    p.add_residual_blocks(
        chain,
        None,
        [np.asarray(blocks[:-1]), np.asarray(blocks[1:])],
        data=data,
    )
    return p


class TestHostSparseNormalSolve:
    def _pairs_and_dense(self, p):
        """Evaluate J at the current state; return (nt, pairs, J dense, rhs)."""
        from ceres_tpu.evaluator import Evaluator

        program = p.program()
        ev = Evaluator(program)
        x = program.initial_ambient()
        full = ev.cost_gradient_jacobian(x)
        ctx = full.jacobian_context
        pairs = [
            [
                (np.asarray(fam.tangent_idx[j]), np.asarray(ctx.jacs[fi][j]))
                for j in range(fam.num_args)
            ]
            for fi, fam in enumerate(ctx.families)
        ]
        Jd = np.asarray(ctx.to_dense())
        rhs = np.asarray(full.gradient)
        return program.num_tangent, pairs, Jd, rhs

    @pytest.mark.parametrize("dynamic", [False, True])
    def test_matches_dense_normal_equations(self, dynamic):
        p = _tiny_residual_problem()
        nt, pairs, Jd, rhs = self._pairs_and_dense(p)
        D = np.linspace(0.5, 1.5, nt)
        y, iters, term = sc.host_sparse_normal_solve(nt, dynamic, D, rhs, pairs)
        H = Jd.T @ Jd + np.diag(D**2)
        np.testing.assert_allclose(y, np.linalg.solve(H, rhs), rtol=1e-8)
        assert int(term) == sc.CG_SUCCESS

    def test_superlu_fallback_when_native_absent(self, monkeypatch):
        # The reference falls back to Eigen's simplicial factorization
        # when CHOLMOD is absent; we fall back to SuperLU.
        monkeypatch.setattr(native, "get_lib", lambda: None)
        sc._SYMBOLIC_CACHE.clear()
        p = _tiny_residual_problem(seed=1)
        nt, pairs, Jd, rhs = self._pairs_and_dense(p)
        D = np.full(nt, 0.7)
        y, iters, term = sc.host_sparse_normal_solve(nt, False, D, rhs, pairs)
        H = Jd.T @ Jd + np.diag(D**2)
        np.testing.assert_allclose(y, np.linalg.solve(H, rhs), rtol=1e-8)

    def test_pure_callback_in_jit(self):
        # In-graph variant: solve_sparse_normal_cholesky under jit must
        # match the host result.
        from ceres_tpu.evaluator import Evaluator

        p = _tiny_residual_problem(seed=2)
        program = p.program()
        ev = Evaluator(program)
        x = program.initial_ambient()
        ctx = ev.cost_gradient_jacobian(x).jacobian_context
        nt = program.num_tangent
        D = jnp.full((nt,), 0.9, dtype=jnp.float64)

        @jax.jit
        def step(ctx, D):
            y, it, term = sc.solve_sparse_normal_cholesky(ctx, D)
            return y, term

        y, term = step(ctx, D)
        Jd = np.asarray(ctx.to_dense())
        H = Jd.T @ Jd + np.diag(np.asarray(D) ** 2)
        rhs = np.asarray(ctx.gradient())
        np.testing.assert_allclose(np.asarray(y), np.linalg.solve(H, rhs), rtol=1e-8)
        assert int(term) == sc.CG_SUCCESS


class TestWiredSolverPath:
    @pytest.mark.parametrize("dynamic", [False, True])
    def test_solution_matches_dense_cholesky(self, dynamic):
        results = {}
        for lst in (
            ct.LinearSolverType.SPARSE_NORMAL_CHOLESKY,
            ct.LinearSolverType.DENSE_NORMAL_CHOLESKY,
        ):
            p = _tiny_residual_problem(seed=3, n_blocks=8)
            opts = ct.SolverOptions(
                linear_solver_type=lst,
                dynamic_sparsity=(
                    dynamic
                    and lst == ct.LinearSolverType.SPARSE_NORMAL_CHOLESKY
                ),
                max_num_iterations=200,
            )
            s = ct.solve(opts, p)
            results[lst] = (s.final_cost, np.concatenate(
                [np.asarray(b) for b in p.parameter_block_values()]
            ) if hasattr(p, "parameter_block_values") else s.final_cost)
        a = results[ct.LinearSolverType.SPARSE_NORMAL_CHOLESKY][0]
        b = results[ct.LinearSolverType.DENSE_NORMAL_CHOLESKY][0]
        assert a == pytest.approx(b, rel=1e-8, abs=1e-12)

    def test_lm_step_equals_dense_step(self):
        # The wired host step must reproduce the dense-solver step
        # exactly (1e-10): same (J'J + D^2) y = g system.
        from ceres_tpu.trust_region import (
            _config_from_options,
            _make_lm_step_fn,
            _make_sparse_lm_step_fn,
        )
        from ceres_tpu.evaluator import Evaluator

        p = _tiny_residual_problem(seed=4, n_blocks=7)
        program = p.program()
        ev = Evaluator(program)
        x = program.initial_ambient()
        ctx = ev.cost_gradient_jacobian(x).jacobian_context

        opts_s = ct.SolverOptions(
            linear_solver_type=ct.LinearSolverType.SPARSE_NORMAL_CHOLESKY
        )
        step_sparse = _make_lm_step_fn(opts_s, program)
        opts_d = ct.SolverOptions(
            linear_solver_type=ct.LinearSolverType.DENSE_NORMAL_CHOLESKY
        )
        step_dense = _make_lm_step_fn(opts_d, program)

        radius = jnp.asarray(1e4, jnp.float64)
        ys, mccs, _, terms = step_sparse(ctx, radius)
        yd, mccd, _, termd = step_dense(ctx, radius)
        np.testing.assert_allclose(
            np.asarray(ys), np.asarray(yd), rtol=1e-9, atol=1e-12
        )
        assert float(mccs) == pytest.approx(float(mccd), rel=1e-8)
        assert int(terms) == sc.CG_SUCCESS

    def test_fallback_solve_without_native(self, monkeypatch):
        monkeypatch.setattr(native, "get_lib", lambda: None)
        sc._SYMBOLIC_CACHE.clear()
        p = _tiny_residual_problem(seed=5)
        opts = ct.SolverOptions(
            linear_solver_type=ct.LinearSolverType.SPARSE_NORMAL_CHOLESKY,
            max_num_iterations=200,
        )
        s = ct.solve(opts, p)
        assert s.termination_type == ct.TerminationType.CONVERGENCE

    def test_nist_problem_through_sparse_path(self):
        # A curved NIST-style exponential fit: exact sparse path reaches
        # the same minimum as DENSE_QR.
        rng = np.random.default_rng(7)
        t = np.linspace(0.0, 3.0, 50)
        y_obs = 2.0 * np.exp(0.8 * t) + rng.normal(scale=1e-3, size=t.shape)

        def make():
            p = ct.Problem()
            b = p.add_parameter_block(np.array([1.0, 0.1]))

            def resid(beta, data):
                tt, yy = data
                return beta[0] * jnp.exp(beta[1] * tt) - yy

            p.add_residual_block(
                resid, None, [b], data=(jnp.asarray(t), jnp.asarray(y_obs))
            )
            return p

        finals = []
        for lst in (
            ct.LinearSolverType.SPARSE_NORMAL_CHOLESKY,
            ct.LinearSolverType.DENSE_QR,
        ):
            p = make()
            s = ct.solve(
                ct.SolverOptions(linear_solver_type=lst, max_num_iterations=60),
                p,
            )
            finals.append(s.final_cost)
        assert finals[0] == pytest.approx(finals[1], rel=1e-6)


class TestInnerProductAssembly:
    """Device-side H = J'J cell assembly (linear/inner_product.py, the
    inner_product_computer.h:64 analog): the host receives O(nnz(H))
    cell values instead of O(nnz(J)) Jacobian entries."""

    def test_device_assembled_H_matches_dense(self):
        from ceres_tpu.evaluator import Evaluator
        from ceres_tpu.linear.inner_product import (
            build_normal_assembly,
            build_normal_plan,
            compute_normal_cells,
        )

        p = _tiny_residual_problem(seed=7, n_blocks=9)
        program = p.program()
        ev = Evaluator(program)
        full = ev.cost_gradient_jacobian(program.initial_ambient())
        ctx = full.jacobian_context
        plan = build_normal_plan(program)
        assembly = build_normal_assembly(plan)
        blocks = compute_normal_cells(ctx, plan)
        vals = np.concatenate(
            [np.asarray(b, dtype=np.float64).ravel() for b in blocks]
        )
        data = np.bincount(
            assembly.pos, weights=vals, minlength=assembly.nnz + 1
        )[: assembly.nnz]
        Hu = sp.csc_matrix(
            (data, assembly.indices, assembly.indptr),
            shape=(assembly.n, assembly.n),
        ).toarray()
        H_sparse = Hu + np.triu(Hu, k=1).T
        Jd = np.asarray(ctx.to_dense())
        np.testing.assert_allclose(
            H_sparse, Jd.T @ Jd, rtol=1e-10, atol=1e-12
        )

    def test_step_matches_jacobian_shipping_path(self):
        from ceres_tpu.evaluator import Evaluator
        from ceres_tpu.trust_region import (
            _config_from_options,
            _make_sparse_lm_step_fn,
        )

        p = _tiny_residual_problem(seed=9, n_blocks=8)
        program = p.program()
        ev = Evaluator(program)
        ctx = ev.cost_gradient_jacobian(
            program.initial_ambient()
        ).jacobian_context
        opts = ct.SolverOptions(
            linear_solver_type=ct.LinearSolverType.SPARSE_NORMAL_CHOLESKY
        )
        config = _config_from_options(opts, program)
        new_fn = _make_sparse_lm_step_fn(config, program)
        old_fn = _make_sparse_lm_step_fn(config, None)  # J-shipping path
        radius = jnp.asarray(3e3, jnp.float64)
        y_new, mcc_new, _, term_new = new_fn(ctx, radius)
        y_old, mcc_old, _, term_old = old_fn(ctx, radius)
        np.testing.assert_allclose(
            np.asarray(y_new), np.asarray(y_old), rtol=1e-9, atol=1e-12
        )
        assert float(mcc_new) == pytest.approx(float(mcc_old), rel=1e-8)
        assert int(term_new) == int(term_old) == sc.CG_SUCCESS

    def test_transfer_scales_with_nnz_H_not_nnz_J(self):
        # Many residuals per block pair: cells deduplicate on device, so
        # the per-iteration transfer is independent of the number of
        # observations (inner_product_computer.h semantics).
        from ceres_tpu.linear.inner_product import build_normal_plan

        rng = np.random.default_rng(0)
        p = ct.Problem()
        blocks = [
            p.add_parameter_block(rng.normal(size=2)) for _ in range(4)
        ]
        n_obs = 500  # 500 residuals over only 3 block pairs
        ai = rng.integers(0, 3, size=n_obs)
        data = jnp.asarray(rng.normal(size=(n_obs, 2)))

        def chain(a, b, data):
            return jnp.asarray(
                [a[0] * b[1] - data[0], a[1] + b[0] ** 2 - data[1]]
            )

        p.add_residual_blocks(
            chain,
            None,
            [np.asarray(blocks)[ai], np.asarray(blocks)[ai + 1]],
            data=data,
        )
        program = p.program()
        plan = build_normal_plan(program)
        cell_scalars = sum(
            s.rows.shape[0] * s.rows.shape[1] * s.cols.shape[1]
            for s in plan.sites
        )
        nnz_J = n_obs * 2 * 4  # rows x (2 args x 2 cols)
        # Block cells: per arg-pair site, at most 3 cells each for
        # (a,a), (b,b), (a,b) -> 9 cells of 2x2 (diagonal cells shared
        # between the two self-pair sites are counted once per site).
        assert cell_scalars <= 9 * 4
        assert cell_scalars < nnz_J / 10


class TestOrderings:
    """Fill-reducing ordering options (solver.h:410-455 parity):
    NESDIS nested dissection and etree postordering must produce the
    same solutions as AMD on the same systems."""

    @needs_native
    @pytest.mark.parametrize("ordering", ["AMD", "NESDIS", "NATURAL"])
    @pytest.mark.parametrize("post", [False, True])
    def test_orderings_solve_identically(self, ordering, post):
        n = 80
        Hu, H = random_spd_csc(n, 0.06, 7)
        chol = sc.SparseCholesky(
            n, Hu.indptr, Hu.indices, ordering=ordering,
            use_postordering=post,
        )
        # perm must be a permutation of 0..n-1
        assert sorted(chol.perm.tolist()) == list(range(n))
        assert chol.factorize(Hu.data) == 0
        b = np.arange(1.0, n + 1.0)
        np.testing.assert_allclose(
            chol.solve(b), np.linalg.solve(H, b), rtol=1e-9
        )

    def test_nested_dissection_order_banded(self):
        # banded graph: ND must recurse and produce a valid permutation
        import scipy.sparse as sp2

        n = 500
        diags = sp2.diags(
            [np.ones(n), np.ones(n - 1), np.ones(n - 1)], [0, 1, -1]
        )
        Hu = sp2.triu(diags.tocsc(), format="csc")
        perm = sc.nested_dissection_order(n, Hu.indptr, Hu.indices)
        assert sorted(perm.tolist()) == list(range(n))

    @needs_native
    def test_ordering_option_through_solver(self):
        import ceres_tpu as ct2

        p = _tiny_residual_problem(seed=12, n_blocks=10)
        opts = ct.SolverOptions(
            linear_solver_type=ct.LinearSolverType.SPARSE_NORMAL_CHOLESKY,
            linear_solver_ordering_type=(
                ct2.LinearSolverOrderingType.NESDIS
            ),
            use_postordering=True,
            max_num_iterations=50,
        )
        s = ct.solve(opts, p)
        assert s.is_solution_usable()
