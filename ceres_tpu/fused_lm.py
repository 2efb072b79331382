"""Fully-fused Levenberg-Marquardt: the whole minimizer in one XLA loop.

The host-loop minimizer (trust_region.py) mirrors the reference's
control flow and bookkeeping, and pays host↔device round-trips (~2 per
iteration after fusion).
This module is the speed-of-light alternative: the COMPLETE LM loop —
evaluation, linear solve, step quality, accept/reject, radius update,
convergence tests — as one ``lax.while_loop`` that runs start-to-finish
on device with a single host transfer at the end. The full-scale analog
of TinySolver (tiny_solver.h:30-398) built on the real solver stack.

Trade-offs vs the host loop: no per-iteration callbacks, no
non-monotonic steps, no bounds, no inner iterations. Semantics otherwise
match LevenbergMarquardtStrategy + TrustRegionMinimizer's convergence
tests (function/gradient/parameter tolerance, min radius).

Since r4 the loop can also carry a device-side per-iteration TRACE
(:class:`_FusedTrace`), from which :func:`minimize_fused_traced`
reconstructs the host loop's exact IterationSummary records — ct.solve
rides this path by default (see fused_traced_eligible), so the
API-faithful entry point pays ONE host round-trip per solve.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ceres_tpu.evaluator import _cost_impl, _full_impl
from ceres_tpu.problem import Program, plus_apply
from ceres_tpu.trust_region import (
    _SolveConfig,
    _build_solve_aux,
    _config_from_options,
    _linear_solve,
)
from ceres_tpu.types import TerminationType


class _FusedState(NamedTuple):
    x: jax.Array
    cost: jax.Array  # f64 scalar
    radius: jax.Array
    decrease_factor: jax.Array
    iteration: jax.Array
    successful_steps: jax.Array
    unsuccessful_steps: jax.Array
    invalid_in_a_row: jax.Array
    termination: jax.Array  # 0 = running, else TerminationType-ish code
    linear_iterations: jax.Array  # cumulative CG/linear iterations
    # gradient norms of the CURRENT iterate (for the iteration trace and
    # the final summary record) — f64 scalars.
    gmax: jax.Array
    gnorm: jax.Array
    # whether the previous trip accepted its step: the gradient-tolerance
    # test only fires on the iterate an ACCEPTED step produced
    # (trust_region_minimizer.cc:826-837 checks after HandleSuccessfulStep)
    last_accept: jax.Array


class _FusedTrace(NamedTuple):
    """Device-side per-iteration log (trace_len slots). ``state_*`` rows
    describe the iterate ENTERING iteration t (= the host loop's record
    t's post-step state); ``step_*`` rows describe the step taken DURING
    iteration t (= host record t+1's step fields). solve() reconstructs
    the exact IterationSummary list from the two halves."""

    state_cost: jax.Array  # (L,) f64
    state_gmax: jax.Array
    state_gnorm: jax.Array
    state_radius: jax.Array
    step_norm: jax.Array  # (L,)
    step_rho: jax.Array
    step_cost_change: jax.Array
    step_lin_iters: jax.Array  # (L,) i32
    step_valid: jax.Array  # (L,) bool
    step_accept: jax.Array  # (L,) bool
    step_xnorm: jax.Array  # (L,) ||x|| entering the step (param tol)


_RUNNING = 0
_CONVERGENCE = 1
_NO_CONVERGENCE = 2
_FAILURE = 3


@dataclasses.dataclass(frozen=True)
class _FusedConfig:
    solve: _SolveConfig
    function_tolerance: float
    gradient_tolerance: float
    parameter_tolerance: float
    min_relative_decrease: float
    initial_trust_region_radius: float
    max_trust_region_radius: float
    min_trust_region_radius: float
    max_invalid_steps: int
    jacobi_scaling: bool
    apply_loss: bool
    num_tangent: int


@functools.partial(jax.jit, static_argnames=("config", "trace_len"))
def _fused_minimize(
    x0,
    families,
    plus_struct,
    solve_aux,
    max_num_iterations,
    config: _FusedConfig,
    groups=None,
    trace_len: int = 0,
):
    # max_num_iterations is a DEVICE scalar (not static): warm-up solves
    # with a different budget share the compiled while_loop.
    # ``trace_len`` > 0 additionally carries a _FusedTrace of per-
    # iteration records (see solve()'s fused path) — the device-side
    # replacement for the host loop's IterationSummary bookkeeping.
    sc = config.solve

    def eval_full(x):
        return _full_impl(
            x, families, config.apply_loss, config.num_tangent, groups
        )

    cost0, grad0, _ = eval_full(x0)
    g0 = grad0.astype(jnp.float64)
    gmax0 = jnp.max(jnp.abs(g0)) if g0.size else jnp.asarray(0.0)
    gnorm0 = jnp.linalg.norm(g0)

    def body_traced(carry):
        s, tr = carry
        s2, tr2 = _body(s, tr)
        return s2, tr2

    def _body(s: _FusedState, tr):
        cost, grad, ctx = eval_full(s.x)

        scaling = None
        if config.jacobi_scaling:
            # ONE column-norm pass: the scaled ctx's norms are exactly
            # scaling^2 * unscaled norms — recomputing them after
            # scale_columns costs a second full Jacobian sweep.
            norms0 = ctx.squared_column_norms()
            scaling = 1.0 / (1.0 + jnp.sqrt(norms0))
            ctx = ctx.scale_columns(scaling)
            scaled_norms = scaling * scaling * norms0
        else:
            scaled_norms = ctx.squared_column_norms()

        diag = jnp.clip(
            scaled_norms, sc.min_lm_diagonal, sc.max_lm_diagonal
        )
        from ceres_tpu.trust_region import _lm_damping

        D = _lm_damping(diag, s.radius)
        y, lin_iters, lin_term = _linear_solve(ctx, D, solve_aux, sc)
        step_scaled = -y.astype(diag.dtype)
        Js = ctx.matvec(step_scaled)
        mcc = jnp.asarray(0.0, jnp.float64)
        for fi in range(len(ctx.families)):
            # f64 accumulation: f32 cancellation here makes tiny steps
            # near the optimum look invalid (mcc <= 0 noise).
            mcc = mcc - jnp.sum(
                Js[fi].astype(jnp.float64)
                * (
                    ctx.residuals[fi].astype(jnp.float64)
                    + Js[fi].astype(jnp.float64) / 2.0
                )
            )

        step = (
            step_scaled * scaling if config.jacobi_scaling else step_scaled
        )
        # Linear-solver FAILURE (breakdown/indefiniteness) invalidates the
        # step like the host loop's HandleInvalidStep (linear_solver.h:57).
        from ceres_tpu.linear.cg import CG_FAILURE

        step_is_valid = (
            jnp.isfinite(mcc) & (mcc > 0.0) & (lin_term < CG_FAILURE)
        )

        candidate = plus_apply(plus_struct, s.x, step)
        # Cost-only candidate evaluation (the reference's cost-only
        # Evaluate in ComputeCandidatePointAndEvaluateCost) — no Jacobian.
        cand_cost = _cost_impl(candidate, families, config.apply_loss)
        cand_cost = jnp.where(
            jnp.isfinite(cand_cost), cand_cost, jnp.asarray(np.inf)
        )

        rho = (cost - cand_cost) / mcc
        accept = step_is_valid & (rho > config.min_relative_decrease)

        # LM radius update (levenberg_marquardt_strategy.cc:158-171).
        r_acc = s.radius / jnp.maximum(
            1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3
        )
        r_acc = jnp.minimum(r_acc, config.max_trust_region_radius)
        r_rej = s.radius / s.decrease_factor
        radius = jnp.where(accept, r_acc, r_rej)
        decrease_factor = jnp.where(accept, 2.0, s.decrease_factor * 2.0)

        invalid_in_a_row = jnp.where(
            step_is_valid, 0, s.invalid_in_a_row + 1
        )

        # Convergence tests (trust_region_minimizer.cc:640-764).
        x_norm = jnp.linalg.norm(s.x.astype(jnp.float64))
        step_norm = jnp.linalg.norm(
            (candidate - s.x).astype(jnp.float64)
        )
        cost_change = jnp.abs(cost - cand_cost)
        g64 = grad.astype(jnp.float64)
        gmax = jnp.max(jnp.abs(g64))
        gnorm = jnp.linalg.norm(g64)

        param_tol = step_is_valid & (
            step_norm
            <= config.parameter_tolerance
            * (x_norm + config.parameter_tolerance)
        ) & (s.successful_steps > 0)
        func_tol = step_is_valid & (
            cost_change <= config.function_tolerance * cost
        )

        # Host-loop parity (traced mode): the reference checks the
        # parameter/function tolerances BEFORE accepting the candidate
        # and returns the pre-step iterate
        # (trust_region_minimizer.cc:720-766) — revert the accept when
        # one of them fires. The plain fused solver keeps the candidate
        # (it is never worse by more than the tolerance).
        keep = accept
        if tr is not None:
            keep = accept & ~(param_tol | func_tol)
        new_x = jnp.where(keep, candidate, s.x)
        new_cost = jnp.where(keep, cand_cost, cost)
        # Host-loop parity: the gradient test fires only on iterates a
        # successful step just produced (the loop-top gradient belongs
        # to the previous trip's accepted candidate).
        grad_tol = s.last_accept & (gmax <= config.gradient_tolerance)
        radius_tol = radius <= config.min_trust_region_radius
        too_invalid = invalid_in_a_row >= config.max_invalid_steps

        termination = jnp.where(
            param_tol | func_tol | grad_tol | radius_tol,
            _CONVERGENCE,
            jnp.where(too_invalid, _FAILURE, _RUNNING),
        ).astype(jnp.int32)

        new_state = _FusedState(
            x=new_x,
            cost=new_cost,
            radius=radius,
            decrease_factor=decrease_factor,
            iteration=s.iteration + 1,
            successful_steps=s.successful_steps + accept.astype(jnp.int32),
            unsuccessful_steps=s.unsuccessful_steps
            + (1 - accept.astype(jnp.int32)),
            invalid_in_a_row=invalid_in_a_row,
            termination=termination,
            linear_iterations=s.linear_iterations
            + lin_iters.astype(jnp.int32),
            gmax=gmax,
            gnorm=gnorm,
            last_accept=accept,
        )
        if tr is None:
            return new_state, None
        t = s.iteration
        tr2 = _FusedTrace(
            state_cost=tr.state_cost.at[t].set(cost, mode="drop"),
            state_gmax=tr.state_gmax.at[t].set(gmax, mode="drop"),
            state_gnorm=tr.state_gnorm.at[t].set(gnorm, mode="drop"),
            state_radius=tr.state_radius.at[t].set(s.radius, mode="drop"),
            step_norm=tr.step_norm.at[t].set(step_norm, mode="drop"),
            step_rho=tr.step_rho.at[t].set(rho, mode="drop"),
            step_cost_change=tr.step_cost_change.at[t].set(
                cost - cand_cost, mode="drop"
            ),
            step_lin_iters=tr.step_lin_iters.at[t].set(
                lin_iters.astype(jnp.int32), mode="drop"
            ),
            step_valid=tr.step_valid.at[t].set(step_is_valid, mode="drop"),
            step_accept=tr.step_accept.at[t].set(accept, mode="drop"),
            step_xnorm=tr.step_xnorm.at[t].set(x_norm, mode="drop"),
        )
        return new_state, tr2

    init = _FusedState(
        x=x0,
        cost=cost0,
        radius=jnp.asarray(
            config.initial_trust_region_radius, jnp.float64
        ),
        decrease_factor=jnp.asarray(2.0, jnp.float64),
        iteration=jnp.asarray(0, jnp.int32),
        successful_steps=jnp.asarray(0, jnp.int32),
        unsuccessful_steps=jnp.asarray(0, jnp.int32),
        invalid_in_a_row=jnp.asarray(0, jnp.int32),
        termination=jnp.where(
            jnp.max(jnp.abs(grad0)) <= config.gradient_tolerance,
            _CONVERGENCE,
            _RUNNING,
        ).astype(jnp.int32),
        linear_iterations=jnp.asarray(0, jnp.int32),
        gmax=gmax0,
        gnorm=gnorm0,
        # grad0 is checked by the init-termination below; body checks
        # start from trip 1, whose loop-top iterate is x0 again only if
        # trip 0... (True keeps the host behavior: it0 counts successful).
        last_accept=jnp.asarray(True),
    )
    if trace_len > 0:
        L = trace_len
        f64z = jnp.zeros((L,), jnp.float64)
        tr0 = _FusedTrace(
            state_cost=f64z,
            state_gmax=f64z,
            state_gnorm=f64z,
            state_radius=f64z,
            step_norm=f64z,
            step_rho=f64z,
            step_cost_change=f64z,
            step_lin_iters=jnp.zeros((L,), jnp.int32),
            step_valid=jnp.zeros((L,), bool),
            step_accept=jnp.zeros((L,), bool),
            step_xnorm=f64z,
        )
        final, trace = jax.lax.while_loop(
            lambda c: (c[0].termination == _RUNNING)
            & (c[0].iteration < max_num_iterations),
            body_traced,
            (init, tr0),
        )
        return final, cost0, trace

    def cond(s: _FusedState):
        return (s.termination == _RUNNING) & (
            s.iteration < max_num_iterations
        )

    final = jax.lax.while_loop(cond, lambda s: _body(s, None)[0], init)
    return final, cost0


def fused_solve(options, problem):
    """Solve with the fused on-device LM loop; returns a SolverSummary
    and writes the solution back (the fast-path analog of ct.solve)."""
    from ceres_tpu.solver import SolverSummary

    t0 = time.time()
    program = problem.program()
    if options.evaluation_dtype is not None:
        from ceres_tpu.problem import cast_program

        cast_program(program, options.evaluation_dtype)
    if options.mesh is not None:
        from ceres_tpu.parallel import shard_program

        shard_program(program, options.mesh)

    resolved = dataclasses.replace(
        options,
        linear_solver_type=options.resolved_linear_solver_type(
            program.num_tangent
        ),
    )
    config = _FusedConfig(
        solve=_config_from_options(resolved, program),
        function_tolerance=resolved.function_tolerance,
        gradient_tolerance=resolved.gradient_tolerance,
        parameter_tolerance=resolved.parameter_tolerance,
        min_relative_decrease=resolved.min_relative_decrease,
        initial_trust_region_radius=resolved.initial_trust_region_radius,
        max_trust_region_radius=resolved.max_trust_region_radius,
        min_trust_region_radius=resolved.min_trust_region_radius,
        max_invalid_steps=resolved.max_num_consecutive_invalid_steps,
        jacobi_scaling=resolved.jacobi_scaling,
        apply_loss=True,
        num_tangent=program.num_tangent,
    )
    solve_aux = _build_solve_aux(resolved, program)
    x0 = program.initial_ambient()
    if options.evaluation_dtype is not None:
        x0 = x0.astype(options.evaluation_dtype)
    if options.mesh is not None:
        from ceres_tpu.parallel import replicate

        x0 = replicate(x0, options.mesh)

    final, cost0 = _fused_minimize(
        x0,
        program.families,
        program.plus_struct,
        solve_aux,
        jnp.asarray(resolved.max_num_iterations, jnp.int32),
        config,
        program.jnp_bd_groups(),
    )
    (x, cost, term, iters, succ, unsucc, lin_iters, c0) = jax.device_get(
        (
            final.x,
            final.cost,
            final.termination,
            final.iteration,
            final.successful_steps,
            final.unsuccessful_steps,
            final.linear_iterations,
            cost0,
        )
    )

    summary = SolverSummary()
    summary.fixed_cost = program.fixed_cost
    summary.initial_cost = float(c0) + program.fixed_cost
    summary.final_cost = float(cost) + program.fixed_cost
    summary.num_successful_steps = int(succ)
    summary.num_unsuccessful_steps = int(unsucc)
    summary.minimizer_type = resolved.minimizer_type
    summary.linear_solver_type_used = resolved.linear_solver_type
    term = int(term)
    if term == _CONVERGENCE:
        summary.termination_type = TerminationType.CONVERGENCE
        summary.message = "Fused minimizer converged."
    elif term == _FAILURE:
        summary.termination_type = TerminationType.FAILURE
        summary.message = "Too many consecutive invalid steps."
    else:
        summary.termination_type = TerminationType.NO_CONVERGENCE
        summary.message = f"Maximum iterations reached ({int(iters)})."
    summary.num_linear_solver_iterations = int(lin_iters)
    summary.num_parameter_blocks = program.num_parameter_blocks()
    summary.num_parameters = program.num_ambient
    summary.num_effective_parameters = program.num_tangent
    summary.num_residuals = program.num_residuals()
    summary.total_time_in_seconds = time.time() - t0
    summary.iterations = [None] * int(iters)  # count only; no per-iter data
    if summary.is_solution_usable():
        problem.write_back(np.asarray(x, dtype=np.float64))
    return summary


# ---------------------------------------------------------------------------
# Traced fused minimize: ct.solve()'s fast path
# ---------------------------------------------------------------------------

_HOST_DRIVEN = ("SPARSE_NORMAL_CHOLESKY", "SPARSE_SCHUR")

_TRACE_BUCKETS = (64, 128, 256, 512, 1024, 2048)


def fused_traced_eligible(options, program, config: _SolveConfig) -> bool:
    """Whether ct.solve can run the fully-fused on-device loop and still
    produce the complete Summary/IterationSummary record. Any feature
    that needs HOST work between step and candidate (bounds projection,
    inner iterations, callbacks, gradient checks, dumps, host-driven
    sparse factorizations, live progress printing, non-monotonic step
    bookkeeping, wall-clock budgets) falls back to the host loop."""
    from ceres_tpu.types import MinimizerType, TrustRegionStrategyType

    return (
        options.minimizer_type == MinimizerType.TRUST_REGION
        and options.trust_region_strategy_type
        == TrustRegionStrategyType.LEVENBERG_MARQUARDT
        and not program.has_bounds
        and not options.use_inner_iterations
        and not options.callbacks
        and options.evaluation_callback is None
        and not options.check_gradients
        and not options.update_state_every_iteration
        and not options.use_nonmonotonic_steps
        and not options.minimizer_progress_to_stdout
        and not (
            options.trust_region_problem_dump_directory
            and options.trust_region_minimizer_iterations_to_dump
        )
        and options.max_solver_time_in_seconds >= 1e6
        and config.linear_solver_type is not None
        and config.linear_solver_type.name not in _HOST_DRIVEN
        and 0 < options.max_num_iterations <= _TRACE_BUCKETS[-1]
    )


def minimize_fused_traced(resolved, program, x0, summary):
    """Run the fused on-device LM loop with a per-iteration trace and
    fill ``summary`` with the SAME records/termination the host loop
    would produce (one device round-trip for the whole solve). Returns
    the final parameter vector (np.ndarray)."""
    from ceres_tpu.trust_region import IterationSummary

    config = _FusedConfig(
        solve=_config_from_options(resolved, program),
        function_tolerance=resolved.function_tolerance,
        gradient_tolerance=resolved.gradient_tolerance,
        parameter_tolerance=resolved.parameter_tolerance,
        min_relative_decrease=resolved.min_relative_decrease,
        initial_trust_region_radius=resolved.initial_trust_region_radius,
        max_trust_region_radius=resolved.max_trust_region_radius,
        min_trust_region_radius=resolved.min_trust_region_radius,
        max_invalid_steps=resolved.max_num_consecutive_invalid_steps,
        jacobi_scaling=resolved.jacobi_scaling,
        apply_loss=True,
        num_tangent=program.num_tangent,
    )
    solve_aux = _build_solve_aux(resolved, program)
    trace_len = next(
        b for b in _TRACE_BUCKETS if b >= resolved.max_num_iterations
    )
    t0 = time.time()
    final, cost0, trace = _fused_minimize(
        x0,
        program.families,
        program.plus_struct,
        solve_aux,
        jnp.asarray(resolved.max_num_iterations, jnp.int32),
        config,
        program.jnp_bd_groups(),
        trace_len=trace_len,
    )
    final_h, cost0_h, tr = jax.device_get((final, cost0, trace))
    device_s = time.time() - t0
    T = int(final_h.iteration)
    fixed = summary.fixed_cost

    # -- termination reason (host-loop priority order) ---------------------
    opts = resolved
    term_code = int(final_h.termination)
    last = max(T - 1, 0)
    reason = None
    if T == 0:
        # converged at iteration zero (gradient tolerance)
        reason = "grad"
    elif term_code == _CONVERGENCE:
        snorm = float(tr.step_norm[last])
        xnorm = float(tr.step_xnorm[last])
        cchange = abs(float(tr.step_cost_change[last]))
        prev_cost = float(tr.state_cost[last])
        valid = bool(tr.step_valid[last])
        had_success = (
            int(final_h.successful_steps)
            - int(bool(tr.step_accept[last]))
            > 0
        )
        if (
            valid
            and had_success
            and snorm
            <= opts.parameter_tolerance * (xnorm + opts.parameter_tolerance)
        ):
            reason = "param"
        elif valid and cchange <= opts.function_tolerance * prev_cost:
            reason = "func"
        elif float(final_h.gmax) <= opts.gradient_tolerance:
            reason = "grad"
        else:
            reason = "radius"
    elif term_code == _FAILURE:
        reason = "invalid"
    else:
        reason = "max_iters"

    # -- reconstruct the IterationSummary list -----------------------------
    # Records the host loop appends: it_0 .. it_T, EXCEPT the final trip's
    # record when the loop returned before appending (param/func/invalid).
    emit_last = reason in ("grad", "radius", "max_iters")
    records = []
    it0 = IterationSummary(
        iteration=0,
        cost=float(tr.state_cost[0]) + fixed if T > 0 else float(cost0_h) + fixed,
        gradient_max_norm=float(tr.state_gmax[0]) if T > 0 else float(final_h.gmax),
        gradient_norm=float(tr.state_gnorm[0]) if T > 0 else float(final_h.gnorm),
        trust_region_radius=float(tr.state_radius[0])
        if T > 0
        else opts.initial_trust_region_radius,
        eta=opts.eta,
        step_is_valid=True,
        step_is_successful=True,
    )
    records.append(it0)
    n_emit = T if emit_last else max(T - 1, 0)
    for k in range(1, n_emit + 1):
        if k < T:
            cost_k = float(tr.state_cost[k])
            gmax_k = float(tr.state_gmax[k])
            gnorm_k = float(tr.state_gnorm[k])
            radius_k = float(tr.state_radius[k])
        else:
            cost_k = float(final_h.cost)
            gmax_k = float(final_h.gmax)
            gnorm_k = float(final_h.gnorm)
            radius_k = float(final_h.radius)
        records.append(
            IterationSummary(
                iteration=k,
                cost=cost_k + fixed,
                cost_change=float(tr.step_cost_change[k - 1]),
                gradient_max_norm=gmax_k,
                gradient_norm=gnorm_k,
                step_norm=float(tr.step_norm[k - 1]),
                relative_decrease=float(tr.step_rho[k - 1]),
                trust_region_radius=radius_k,
                eta=opts.eta,
                linear_solver_iterations=int(tr.step_lin_iters[k - 1]),
                step_is_valid=bool(tr.step_valid[k - 1]),
                step_is_successful=bool(tr.step_accept[k - 1]),
            )
        )
    summary.iterations = records

    # -- termination type + message (host-loop formats) --------------------
    if reason == "param":
        snorm = float(tr.step_norm[last])
        xnorm = float(tr.step_xnorm[last])
        summary.termination_type = TerminationType.CONVERGENCE
        summary.message = (
            f"Parameter tolerance reached. Relative step_norm: "
            f"{snorm / (xnorm + opts.parameter_tolerance):e} <= "
            f"{opts.parameter_tolerance:e}."
        )
    elif reason == "func":
        cchange = abs(float(tr.step_cost_change[last]))
        prev_cost = float(tr.state_cost[last])
        summary.termination_type = TerminationType.CONVERGENCE
        summary.message = (
            f"Function tolerance reached. |cost_change|/cost: "
            f"{cchange / prev_cost if prev_cost else 0.0:e} <= "
            f"{opts.function_tolerance:e}"
        )
    elif reason == "grad":
        summary.termination_type = TerminationType.CONVERGENCE
        summary.message = (
            f"Gradient tolerance reached. Gradient max norm: "
            f"{float(final_h.gmax):e} <= {opts.gradient_tolerance:e}"
        )
    elif reason == "radius":
        summary.termination_type = TerminationType.CONVERGENCE
        summary.message = (
            "Minimum trust region radius reached. Trust region radius: "
            f"{float(final_h.radius):e} <= "
            f"{opts.min_trust_region_radius:e}"
        )
    elif reason == "invalid":
        summary.termination_type = TerminationType.FAILURE
        summary.message = (
            "Number of consecutive invalid steps more than "
            "Solver::Options::max_num_consecutive_invalid_steps: "
            f"{opts.max_num_consecutive_invalid_steps}"
        )
    else:
        summary.termination_type = TerminationType.NO_CONVERGENCE
        summary.message = (
            "Maximum number of iterations reached. "
            f"Number of iterations: {T}."
        )

    # Statistics: the whole solve is one device computation.
    summary.linear_solver_time_in_seconds += device_s
    summary.num_linear_solves += T
    summary.num_residual_evaluations += T + 1
    summary.num_jacobian_evaluations += T + 1
    summary.num_linear_solver_iterations = int(final_h.linear_iterations)
    return np.asarray(final_h.x)
