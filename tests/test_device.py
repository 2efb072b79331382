"""Real-device equivalence tests — the analog of the reference's
CUDA-vs-CPU tests (cuda_dense_cholesky_test.cc, cuda_vector_test.cc:1-442,
cuda_sparse_matrix_test.cc): the same computations that the CPU suite
checks numerically are run compiled on the accelerator platform and
compared against host (numpy, f64) ground truth.

They run on the CPU in the default suite too; the ``device`` marker puts
them in the curated set that one command runs on the accelerator:

    CERES_DEVICE_TESTS=1 python -m pytest tests/ -q -m device -p no:xdist
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.device


def test_f64_dot_accuracy():
    """f64 products are native f64: an ill-conditioned dot that f32
    gets wrong comes out f64-accurate, and the f32 one does not."""
    n = 4096
    # random (asymmetric) values: a symmetric grid like linspace lets
    # low-precision rounding errors cancel pairwise and fakes accuracy
    x = ((1.0 + np.random.RandomState(7).rand(n)) * 1e8).astype(
        np.float64
    )
    y = (1.0 + np.random.RandomState(8).rand(n)) * 1e-8
    exact = float(np.dot(x, y))
    got = float(jnp.dot(jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64)))
    assert abs(got - exact) / abs(exact) < 1e-14
    got32 = float(
        jnp.dot(jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32))
    )
    assert abs(got32 - exact) / abs(exact) > 1e-12


def test_fused_bal_solve_on_device():
    """End-to-end fused LM on the device platform converges to the same
    cost the CPU suite expects (BAL 8cam/500pt, Huber)."""
    import ceres_tpu as ct
    from ceres_tpu.fused_lm import fused_solve
    from ceres_tpu.models import bal

    prob = bal.synthesize_bal(num_cameras=8, num_points=500,
                              num_observations=2000, seed=42)
    problem, _, _ = bal.build_problem(prob, loss=ct.loss.HuberLoss(1.0))
    opts = bal.default_options(iterative=True)
    opts.evaluation_dtype = "float32"
    opts.max_num_iterations = 40
    # Tolerances must match the evaluation precision: with f32
    # residuals the cost plateaus ~1e-2 above the f64 optimum, so the
    # f64-grade default ftol=1e-6 is unreachable — the solve grinds to
    # the f32 noise floor and ends in the invalid-step ladder (the
    # reference would do the same given f32 arithmetic). ftol=1e-5 is
    # the f32-realistic setting; the device trace converges via the
    # function-tolerance test at the cost plateau.
    opts.function_tolerance = 1e-5
    s = fused_solve(opts, problem)
    assert s.termination_type == ct.TerminationType.CONVERGENCE
    assert s.final_cost < 0.1 * s.initial_cost


def test_dense_cholesky_device_vs_host():
    """DENSE_NORMAL_CHOLESKY on device equals numpy lstsq (the direct
    analog of cuda_dense_cholesky_test.cc)."""
    from ceres_tpu.linear.dense import solve_dense_normal_cholesky
    from ceres_tpu.models import bal
    from ceres_tpu.evaluator import _full_impl

    prob = bal.synthesize_bal(num_cameras=4, num_points=60,
                              num_observations=300, seed=3)
    problem, _, _ = bal.build_problem(prob)
    program = problem.program()
    x0 = program.initial_ambient()
    _, _, ctx = jax.jit(
        lambda x: _full_impl(x, program.families, True,
                             program.num_tangent, program.jnp_bd_groups())
    )(x0)
    D = 1e-3 * jnp.ones((program.num_tangent,), x0.dtype)
    y = solve_dense_normal_cholesky(ctx, D)
    J = np.asarray(ctx.to_dense())
    g = np.asarray(ctx.gradient())
    H = J.T @ J + np.diag(np.asarray(D) ** 2)
    ref = np.linalg.solve(H, g)
    np.testing.assert_allclose(np.asarray(y), ref, rtol=2e-5, atol=1e-6)
