"""Fused on-device LM loop vs the host-loop minimizer."""

import numpy as np
import pytest

import ceres_tpu as ct
from ceres_tpu.models import bal

pytestmark = pytest.mark.device


@pytest.fixture(scope="module")
def instance():
    return bal.synthesize_bal(4, 100, 400, seed=2)


@pytest.mark.parametrize(
    "solver", ["ITERATIVE_SCHUR", "DENSE_SCHUR", "CGNR", "DENSE_QR"]
)
def test_fused_matches_host_loop(instance, solver):
    kwargs = dict(
        linear_solver_type=getattr(ct.LinearSolverType, solver),
        preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI
        if "SCHUR" in solver
        else ct.PreconditionerType.JACOBI,
        max_num_iterations=40,
    )
    p1, _, _ = bal.build_problem(instance)
    host = ct.solve(ct.SolverOptions(**kwargs), p1)
    p2, _, _ = bal.build_problem(instance)
    fused = ct.fused_solve(ct.SolverOptions(**kwargs), p2)
    assert fused.termination_type == ct.TerminationType.CONVERGENCE
    np.testing.assert_allclose(
        fused.final_cost, host.final_cost, rtol=1e-6
    )
    # solutions written back agree up to BA gauge slack
    np.testing.assert_allclose(
        p2.parameter_block_value(0),
        p1.parameter_block_value(0),
        rtol=1e-2,
        atol=1e-3,
    )


def test_fused_with_loss_and_f32(instance):
    p1, _, _ = bal.build_problem(instance, loss=ct.HuberLoss(1.0))
    host = ct.solve(ct.SolverOptions(max_num_iterations=40), p1)
    p2, _, _ = bal.build_problem(instance, loss=ct.HuberLoss(1.0))
    fused = ct.fused_solve(
        ct.SolverOptions(
            max_num_iterations=40,
            evaluation_dtype="float32",
            use_mixed_precision_solves=True,
        ),
        p2,
    )
    np.testing.assert_allclose(
        fused.final_cost, host.final_cost, rtol=1e-5
    )


def test_fused_gradient_at_start():
    """Starting at the minimum terminates immediately via gradient tol."""
    import jax.numpy as jnp

    p = ct.Problem()
    b = p.add_parameter_block(np.array([3.0]))
    p.add_residual_block(lambda x: x - 3.0, None, [b])
    s = ct.fused_solve(ct.SolverOptions(max_num_iterations=10), p)
    assert s.termination_type == ct.TerminationType.CONVERGENCE
    assert len(s.iterations) <= 1
