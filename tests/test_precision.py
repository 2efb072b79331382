"""Precision policy + mixed-precision solve tests.

Analog of the reference's float/mixed-precision coverage
(dense_cholesky_test.cc FP32 variants, iterative_refiner_test.cc):
f32 evaluation must track f64 within f32 conditioning limits, and
f64-refined mixed solves must beat plain f32 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ceres_tpu as ct
from ceres_tpu.models import bal

pytestmark = pytest.mark.device


@pytest.fixture(scope="module")
def instance():
    return bal.synthesize_bal(4, 120, 460, seed=31)


def _solve(instance, **kwargs):
    p, _, _ = bal.build_problem(instance)
    kwargs.setdefault(
        "linear_solver_type", ct.LinearSolverType.ITERATIVE_SCHUR
    )
    kwargs.setdefault(
        "preconditioner_type", ct.PreconditionerType.SCHUR_JACOBI
    )
    opts = ct.SolverOptions(max_num_iterations=25, **kwargs)
    return ct.solve(opts, p)


def test_f32_matches_f64_cost(instance):
    f64 = _solve(instance)
    f32 = _solve(instance, evaluation_dtype="float32")
    assert abs(f32.final_cost - f64.final_cost) / f64.final_cost < 1e-5


def test_mixed_precision_refinement(instance):
    f64 = _solve(instance)
    mixed = _solve(
        instance,
        evaluation_dtype="float32",
        use_mixed_precision_solves=True,
        max_num_refinement_iterations=2,
    )
    assert abs(mixed.final_cost - f64.final_cost) / f64.final_cost < 1e-5


def test_refined_step_more_accurate_than_f32():
    """One LM step: f32+refine step must be closer to the f64 step than
    the plain f32 step (iterative_refiner_test.cc semantics)."""
    import dataclasses

    from ceres_tpu.evaluator import Evaluator
    from ceres_tpu.problem import cast_program
    from ceres_tpu.trust_region import _make_lm_step_fn

    prob = bal.synthesize_bal(3, 40, 150, seed=5)

    def step_for(eval_dtype, mixed):
        p, _, _ = bal.build_problem(prob)
        program = p.program()
        if eval_dtype is not None:
            cast_program(program, eval_dtype)
        opts = ct.SolverOptions(
            linear_solver_type=ct.LinearSolverType.DENSE_NORMAL_CHOLESKY,
            use_mixed_precision_solves=mixed,
            max_num_refinement_iterations=3,
            jacobi_scaling=False,
        )
        opts = dataclasses.replace(
            opts,
            linear_solver_type=opts.resolved_linear_solver_type(
                program.num_tangent
            ),
        )
        ev = Evaluator(program)
        x = program.initial_ambient()
        if eval_dtype is not None:
            x = x.astype(eval_dtype)
        full = ev.cost_gradient_jacobian(x)
        step_fn = _make_lm_step_fn(opts, program)
        step, mcc, _, _ = step_fn(
            full.jacobian_context, jnp.asarray(1e4, jnp.float64)
        )
        return np.asarray(step, dtype=np.float64)

    s64 = step_for(None, False)
    s32 = step_for("float32", False)
    s_mixed = step_for("float32", True)
    err32 = np.linalg.norm(s32 - s64) / np.linalg.norm(s64)
    err_mixed = np.linalg.norm(s_mixed - s64) / np.linalg.norm(s64)
    assert err_mixed < err32
    # Refinement recovers the solve's accuracy; what remains is the f32
    # Jacobian's own rounding, which differs by backend (FMA contraction,
    # transcendental implementations): < 1e-5 on the CPU, 1.43e-5 on an
    # H100 (err32 9.9e-5 there).
    bound = 1e-5 if jax.default_backend() == "cpu" else 2e-5
    assert err_mixed < bound, (err32, err_mixed)


@pytest.mark.parametrize("solver", ["DENSE_QR", "CGNR", "DENSE_SCHUR"])
def test_mixed_precision_all_solvers(instance, solver):
    f64 = _solve(instance)
    kwargs = dict(
        evaluation_dtype="float32",
        use_mixed_precision_solves=True,
        max_num_refinement_iterations=1,
        linear_solver_type=getattr(ct.LinearSolverType, solver),
    )
    if solver == "CGNR":
        kwargs["preconditioner_type"] = ct.PreconditionerType.JACOBI
    mixed = _solve(instance, **kwargs)
    assert abs(mixed.final_cost - f64.final_cost) / f64.final_cost < 1e-4


def test_dtype_flows_through_context(instance):
    from ceres_tpu.evaluator import Evaluator
    from ceres_tpu.problem import cast_program

    p, _, _ = bal.build_problem(instance)
    program = p.program()
    cast_program(program, "float32")
    ev = Evaluator(program)
    full = ev.cost_gradient_jacobian(
        program.initial_ambient().astype(jnp.float32)
    )
    ctx = full.jacobian_context
    assert ctx.residuals[0].dtype == jnp.float32
    assert ctx.jacs[0][0].dtype == jnp.float32
    assert ctx.squared_column_norms().dtype == jnp.float32
    assert ctx.to_dense().dtype == jnp.float32
