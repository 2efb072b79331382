"""ct.solve's traced fused path vs the host trust-region loop.

The default-config solve runs the whole LM loop on device and
reconstructs the per-iteration records from a device-side trace
(fused_lm.minimize_fused_traced); forcing any host-interaction feature
(here: a callback) runs the step-by-step loop instead. Both must
produce the same trajectory and bookkeeping.
"""

import numpy as np
import pytest

import ceres_tpu as ct
from ceres_tpu.models import bal

pytestmark = pytest.mark.device


def _solve_pair(opts_kw=None, n=(4, 200, 800), seed=9):
    results = []
    for force_host in (False, True):
        prob = bal.synthesize_bal(*n, noise=1.5, perturb=0.5, seed=seed)
        p, _, _ = bal.build_problem(prob)
        opts = ct.SolverOptions(**(opts_kw or {}))
        if force_host:
            opts.callbacks = [lambda it: None]
        results.append(ct.solve(opts, p))
    return results


def test_traced_matches_host_records():
    fused, host = _solve_pair({"max_num_iterations": 12})
    assert fused.termination_type == host.termination_type
    # Same trajectory: record-by-record comparison.
    assert len(fused.iterations) == len(host.iterations)
    for f, h in zip(fused.iterations, host.iterations):
        assert f.iteration == h.iteration
        assert f.cost == pytest.approx(h.cost, rel=1e-10, abs=1e-12)
        assert f.step_is_successful == h.step_is_successful
        assert f.trust_region_radius == pytest.approx(
            h.trust_region_radius, rel=1e-8
        )
        if f.iteration > 0:
            assert f.cost_change == pytest.approx(
                h.cost_change, rel=1e-8, abs=1e-10
            )
            assert f.step_norm == pytest.approx(
                h.step_norm, rel=1e-8, abs=1e-12
            )
            assert f.relative_decrease == pytest.approx(
                h.relative_decrease, rel=1e-8
            )
            assert f.linear_solver_iterations == h.linear_solver_iterations
        assert f.gradient_max_norm == pytest.approx(
            h.gradient_max_norm, rel=1e-8
        )
    assert fused.final_cost == pytest.approx(host.final_cost, rel=1e-10)
    assert fused.message == host.message
    assert (
        fused.num_linear_solver_iterations
        == host.num_linear_solver_iterations
    )
    assert fused.num_successful_steps == host.num_successful_steps
    assert fused.num_unsuccessful_steps == host.num_unsuccessful_steps


def test_traced_max_iterations_termination():
    fused, host = _solve_pair({"max_num_iterations": 3})
    assert fused.termination_type == host.termination_type
    assert fused.message == host.message
    assert len(fused.iterations) == len(host.iterations)


def test_traced_final_parameters_match():
    prob = bal.synthesize_bal(4, 200, 800, noise=1.5, perturb=0.5, seed=3)
    p1, c1, pt1 = bal.build_problem(prob)
    p2, c2, pt2 = bal.build_problem(prob)
    o1 = ct.SolverOptions(max_num_iterations=10)
    o2 = ct.SolverOptions(max_num_iterations=10, callbacks=[lambda it: None])
    s1 = ct.solve(o1, p1)
    s2 = ct.solve(o2, p2)
    v1 = p1.parameter_block_value(int(c1[0]))
    v2 = p2.parameter_block_value(int(c2[0]))
    np.testing.assert_allclose(v1, v2, rtol=1e-9, atol=1e-12)


def test_features_fall_back_to_host_loop():
    from ceres_tpu.fused_lm import fused_traced_eligible
    from ceres_tpu.trust_region import _config_from_options

    prob = bal.synthesize_bal(2, 40, 120, seed=1)
    p, _, _ = bal.build_problem(prob)
    program = p.program()
    # solve() always resolves the linear solver type before the
    # eligibility check; mirror that here.
    base = ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR
    )
    cfg = _config_from_options(base, program)
    assert fused_traced_eligible(base, program, cfg)
    for kw in (
        {"callbacks": [lambda it: None]},
        {"use_inner_iterations": True},
        {"check_gradients": True},
        {"use_nonmonotonic_steps": True},
        {"minimizer_progress_to_stdout": True},
        {"update_state_every_iteration": True},
        {"linear_solver_type": ct.LinearSolverType.SPARSE_NORMAL_CHOLESKY},
        {
            "trust_region_strategy_type": (
                ct.TrustRegionStrategyType.DOGLEG
            )
        },
    ):
        o = ct.SolverOptions(**kw)
        c = _config_from_options(o, program)
        assert not fused_traced_eligible(o, program, c), kw
