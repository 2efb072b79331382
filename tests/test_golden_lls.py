"""Golden linear least-squares fixtures.

Analog of internal/ceres/linear_least_squares_problems.{h,cc} (canned
problems with documented solutions, shared by all linear-solver and
eliminator tests, SURVEY.md §4.2). Problems 0 and 1 are reproduced with
their documented matrices/solutions (linear_least_squares_problems.cc:
74-89 and :139-175) and solved through the Problem API, so the whole
evaluator → solver path is covered, not just the linear algebra.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import ceres_tpu as ct
from ceres_tpu.evaluator import Evaluator
from ceres_tpu.linear.dense import solve_dense_normal_cholesky, solve_dense_qr
from ceres_tpu.linear.schur import SchurOperator, build_schur_structure

pytestmark = pytest.mark.device


def lls_problem0():
    """A=[[1,2],[3,4],[6,-10]], b=[8,18,-18]; x*=[2,3];
    with D=[1,2]: x_D=[1.78448275, 2.82327586]
    (linear_least_squares_problems.cc:74-89)."""
    A = np.array([[1.0, 2.0], [3.0, 4.0], [6.0, -10.0]])
    b = np.array([8.0, 18.0, -18.0])
    p = ct.Problem()
    xb = p.add_parameter_block(np.zeros(2))

    def resid(x, data):
        row, rhs = data
        return (row @ x - rhs)[None]

    p.add_residual_blocks(
        resid,
        None,
        [np.full(3, xb)],
        data=(jnp.asarray(A), jnp.asarray(b)),
    )
    return p, A, b


def lls_problem1():
    """The canonical 6x5 BA-structured problem with 2 e-blocks and the
    documented Schur complement (linear_least_squares_problems.cc:139-175).
    """
    rows = [
        # (e_pid_idx, f_pid_idx, coeff_e, coeff_f, rhs)
        (0, 0, 1.0, 2.0, 0.0),  # x0, x2
        (0, 1, 3.0, 4.0, 1.0),  # x0, x3
        (1, 2, 5.0, 6.0, 2.0),  # x1, x4
        (1, 0, 7.0, 8.0, 3.0),  # x1, x2
        (1, 0, 9.0, 1.0, 4.0),  # x1, x2
    ]
    p = ct.Problem()
    e = [p.add_parameter_block(np.zeros(1)) for _ in range(2)]
    f = [p.add_parameter_block(np.zeros(1)) for _ in range(3)]

    def pair(u, v, data):
        ce, cf, rhs = data
        return ce * u + cf * v - rhs

    p.add_residual_blocks(
        pair,
        None,
        [
            np.asarray([e[r[0]] for r in rows]),
            np.asarray([f[r[1]] for r in rows]),
        ],
        data=(
            jnp.asarray([r[2] for r in rows]),
            jnp.asarray([r[3] for r in rows]),
            jnp.asarray([[r[4]] for r in rows]),
        ),
    )

    def triple(a, b_, c, data):
        return a + b_ + c - data

    p.add_residual_block(triple, None, [f[0], f[1], f[2]], data=jnp.asarray([5.0]))

    # dense A for brute force checks
    A = np.zeros((6, 5))
    b = np.zeros(6)
    for i, (ei, fi, ce, cf, rhs) in enumerate(rows):
        A[i, ei] = ce
        A[i, 2 + fi] = cf
        b[i] = rhs
    A[5, 2:] = 1.0
    b[5] = 5.0
    return p, A, b, e, f


S_DOCUMENTED = np.array(
    [
        [42.3419, -1.4000, -11.5806],
        [-1.4000, 2.6000, 1.0000],
        [-11.5806, 1.0000, 31.1935],
    ]
)


class TestProblem0:
    def test_undamped_solution(self):
        p, A, b = lls_problem0()
        program = p.program()
        ev = Evaluator(program)
        ctx = ev.cost_gradient_jacobian(
            program.initial_ambient()
        ).jacobian_context
        y = solve_dense_qr(ctx, jnp.zeros(2) + 1e-15)
        # residual = Ax - b at x=0 => -b; solve gives -x*
        np.testing.assert_allclose(-np.asarray(y), [2.0, 3.0], rtol=1e-8)

    def test_damped_solution(self):
        p, A, b = lls_problem0()
        program = p.program()
        ev = Evaluator(program)
        ctx = ev.cost_gradient_jacobian(
            program.initial_ambient()
        ).jacobian_context
        D = jnp.asarray([1.0, 2.0])
        for solver in (solve_dense_qr, solve_dense_normal_cholesky):
            y = solver(ctx, D)
            np.testing.assert_allclose(
                -np.asarray(y),
                [1.78448275, 2.82327586],
                rtol=1e-7,
            )

    def test_full_solve_reaches_exact_solution(self):
        p, A, b = lls_problem0()
        s = ct.solve(ct.SolverOptions(max_num_iterations=5), p)
        assert s.termination_type == ct.TerminationType.CONVERGENCE
        # block 0 is the only one
        np.testing.assert_allclose(
            p.parameter_block_value(0), [2.0, 3.0], rtol=1e-8
        )


class TestProblem1:
    def test_schur_complement_matches_documented(self):
        p, A, b, e, f = lls_problem1()
        program = p.program()
        ev = Evaluator(program)
        ctx = ev.cost_gradient_jacobian(
            program.initial_ambient()
        ).jacobian_context
        # The reference's problem 1 explicitly eliminates blocks {0, 1}
        # (num_eliminate_blocks = 2); the automatic MIS would pick the
        # highest-degree block x2 instead.
        ss = build_schur_structure(program, ordering=[e[0], e[1]])
        # points must be the two e-blocks
        assert ss.num_points == 2 and ss.e_tangent_size == 1
        op = SchurOperator(ctx, jnp.zeros(5) + 1e-300, ss)
        S, rhs, f_idx = op.dense_reduced_system()
        np.testing.assert_allclose(
            np.asarray(S), S_DOCUMENTED, atol=1e-3
        )

    def test_schur_solution_matches_dense(self):
        p, A, b, e, f = lls_problem1()
        program = p.program()
        ev = Evaluator(program)
        ctx = ev.cost_gradient_jacobian(
            program.initial_ambient()
        ).jacobian_context
        D = jnp.full(5, 0.5)
        from ceres_tpu.linear.schur import solve_schur

        opts = ct.SolverOptions(
            linear_solver_type=ct.LinearSolverType.DENSE_SCHUR
        )
        ss = build_schur_structure(program, ordering=[e[0], e[1]])
        y, _, _ = solve_schur(ctx, D, program, opts, ss=ss)
        expected = np.linalg.solve(
            A.T @ A + np.diag(np.full(5, 0.25)), A.T @ (-b)
        )
        np.testing.assert_allclose(
            np.asarray(y), expected, rtol=1e-8, atol=1e-10
        )

    @pytest.mark.parametrize(
        "solver",
        ["DENSE_QR", "DENSE_NORMAL_CHOLESKY", "CGNR", "DENSE_SCHUR",
         "ITERATIVE_SCHUR", "SPARSE_NORMAL_CHOLESKY"],
    )
    def test_all_solvers_find_least_squares_solution(self, solver):
        p, A, b, e, f = lls_problem1()
        opts = ct.SolverOptions(
            linear_solver_type=getattr(ct.LinearSolverType, solver),
            preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI
            if "SCHUR" in solver
            else ct.PreconditionerType.JACOBI,
            max_num_iterations=50,
            linear_solver_ordering=[[e[0], e[1]], list(f)]
            if "SCHUR" in solver and solver != "SPARSE_NORMAL_CHOLESKY"
            else None,
        )
        s = ct.solve(opts, p)
        x_star, *_ = np.linalg.lstsq(A, b, rcond=None)
        x_sol = np.concatenate(
            [p.parameter_block_value(pid) for pid in e + f]
        )
        # iterative paths stop at eta/function tolerance, not machine eps
        tol = 1e-5 if solver.startswith("DENSE") else 2e-3
        np.testing.assert_allclose(x_sol, x_star, rtol=tol, atol=1e-6)
