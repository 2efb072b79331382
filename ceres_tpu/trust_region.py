"""Trust-region minimizer: Levenberg-Marquardt outer loop.

JAX analog of ``internal/ceres/trust_region_minimizer.{h,cc}:68-841``,
``levenberg_marquardt_strategy.cc`` and
``trust_region_step_evaluator.{h,cc}``.

Design split: the *data-dependent scalar control flow* (accept/reject,
radius update, convergence tests) stays on the host exactly like the
reference's loop, while every heavy computation — residual+Jacobian
evaluation, LM diagonal, the linear solve, model-cost-change — is a handful
of jitted XLA computations with static shapes, so nothing recompiles across
iterations. (A fully fused `lax.while_loop` variant lives in
``ceres_tpu.models.bal`` for benchmark workloads.)
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ceres_tpu.evaluator import Evaluator, JacobianContext
from ceres_tpu.linear.cgnr import solve_cgnr
from ceres_tpu.linear.dense import (
    solve_dense_normal_cholesky,
    solve_dense_qr,
)
from ceres_tpu.problem import Program
from ceres_tpu.types import (
    CallbackReturnType,
    LinearSolverType,
    PreconditionerType,
    TerminationType,
)

_DBL_MAX = float(np.finfo(np.float64).max)


class TrustRegionStepEvaluator:
    """Non-monotonic step acceptance (trust_region_step_evaluator.cc,
    Conn/Gould/Toint Algorithm 10.1.2)."""

    def __init__(self, initial_cost: float, max_consecutive_nonmonotonic_steps: int):
        self.max_nonmonotonic = max_consecutive_nonmonotonic_steps
        self.minimum_cost = initial_cost
        self.current_cost = initial_cost
        self.reference_cost = initial_cost
        self.candidate_cost = initial_cost
        self.accumulated_reference_model_cost_change = 0.0
        self.accumulated_candidate_model_cost_change = 0.0
        self.num_consecutive_nonmonotonic_steps = 0

    def step_quality(self, cost: float, model_cost_change: float) -> float:
        if cost >= _DBL_MAX:
            return -_DBL_MAX
        relative_decrease = (self.current_cost - cost) / model_cost_change
        historical = (self.reference_cost - cost) / (
            self.accumulated_reference_model_cost_change + model_cost_change
        )
        return max(relative_decrease, historical)

    def step_accepted(self, cost: float, model_cost_change: float) -> None:
        self.current_cost = cost
        self.accumulated_candidate_model_cost_change += model_cost_change
        self.accumulated_reference_model_cost_change += model_cost_change
        if self.current_cost < self.minimum_cost:
            self.minimum_cost = self.current_cost
            self.num_consecutive_nonmonotonic_steps = 0
            self.candidate_cost = self.current_cost
            self.accumulated_candidate_model_cost_change = 0.0
        else:
            self.num_consecutive_nonmonotonic_steps += 1
            if self.current_cost > self.candidate_cost:
                self.candidate_cost = self.current_cost
                self.accumulated_candidate_model_cost_change = 0.0
        if self.num_consecutive_nonmonotonic_steps == self.max_nonmonotonic:
            self.reference_cost = self.candidate_cost
            self.accumulated_reference_model_cost_change = (
                self.accumulated_candidate_model_cost_change
            )


@dataclasses.dataclass
class IterationSummary:
    """Analog of ceres::IterationSummary (iteration_callback.h)."""

    iteration: int = 0
    step_is_valid: bool = False
    step_is_nonmonotonic: bool = False
    step_is_successful: bool = False
    cost: float = 0.0
    cost_change: float = 0.0
    gradient_max_norm: float = 0.0
    gradient_norm: float = 0.0
    step_norm: float = 0.0
    relative_decrease: float = 0.0
    trust_region_radius: float = 0.0
    eta: float = 0.0
    step_size: float = 0.0
    line_search_function_evaluations: int = 0
    linear_solver_iterations: int = 0
    iteration_time_in_seconds: float = 0.0
    step_solver_time_in_seconds: float = 0.0
    cumulative_time_in_seconds: float = 0.0


class LevenbergMarquardtStrategy:
    """Radius/damping state machine (levenberg_marquardt_strategy.cc)."""

    def __init__(self, options):
        self.radius = options.initial_trust_region_radius
        self.max_radius = options.max_trust_region_radius
        self.decrease_factor = 2.0

    def step_accepted(self, step_quality: float) -> None:
        # levenberg_marquardt_strategy.cc:158-165
        self.radius = self.radius / max(
            1.0 / 3.0, 1.0 - (2.0 * step_quality - 1.0) ** 3
        )
        self.radius = min(self.max_radius, self.radius)
        self.decrease_factor = 2.0

    def step_rejected(self, step_quality: float) -> None:
        # levenberg_marquardt_strategy.cc:167-171
        del step_quality
        self.radius = self.radius / self.decrease_factor
        self.decrease_factor *= 2.0

    step_is_invalid = step_rejected


@dataclasses.dataclass(frozen=True)
class _SolveConfig:
    """Hashable static configuration for the module-level jitted step:
    the scalar/enum subset of SolverOptions the linear solve needs.
    Sharing one jit cache keyed on this config means repeated ct.solve
    calls with equal-shaped problems never recompile."""

    linear_solver_type: LinearSolverType
    preconditioner_type: PreconditionerType
    eta: float
    max_linear_solver_iterations: int
    min_linear_solver_iterations: int
    max_num_spse_iterations: int
    spse_tolerance: float
    use_spse_initialization: bool
    use_explicit_schur_complement: bool
    min_lm_diagonal: float
    max_lm_diagonal: float
    use_mixed_precision_solves: bool
    num_refinement_iterations: int
    num_tangent: int
    dynamic_sparsity: bool = False
    ordering_type: str = "AMD"  # LinearSolverOrderingType name
    use_postordering: bool = False


def _config_from_options(options, program: Program) -> _SolveConfig:
    return _SolveConfig(
        linear_solver_type=options.linear_solver_type,
        preconditioner_type=options.preconditioner_type,
        eta=options.eta,
        max_linear_solver_iterations=options.max_linear_solver_iterations,
        min_linear_solver_iterations=options.min_linear_solver_iterations,
        max_num_spse_iterations=options.max_num_spse_iterations,
        spse_tolerance=options.spse_tolerance,
        use_spse_initialization=options.use_spse_initialization,
        use_explicit_schur_complement=options.use_explicit_schur_complement,
        min_lm_diagonal=options.min_lm_diagonal,
        max_lm_diagonal=options.max_lm_diagonal,
        use_mixed_precision_solves=options.use_mixed_precision_solves,
        num_refinement_iterations=max(
            options.max_num_refinement_iterations, 1
        ),
        num_tangent=program.num_tangent,
        dynamic_sparsity=getattr(options, "dynamic_sparsity", False),
        ordering_type=getattr(
            options, "linear_solver_ordering_type", None
        ).name
        if getattr(options, "linear_solver_ordering_type", None)
        is not None
        else "AMD",
        use_postordering=getattr(options, "use_postordering", False),
    )


def _solve_aux_cache_key(options):
    """Option fields that change the aux structures (everything else —
    tolerances, iteration budgets — is numerically threaded, not
    structural)."""
    from ceres_tpu.ordered_groups import normalize_ordering

    groups = normalize_ordering(options.linear_solver_ordering)
    ordering_key = (
        tuple(tuple(sorted(g)) for g in groups) if groups else None
    )
    subset = options.residual_blocks_for_subset_preconditioner
    subset_key = tuple(sorted(int(r) for r in subset)) if subset else None
    return (
        options.linear_solver_type,
        options.preconditioner_type,
        getattr(options, "use_explicit_schur_complement", False),
        ordering_key,
        subset_key,
    )


def _build_solve_aux(options, program: Program):
    """Preprocessor-built index structures (block-Jacobi groups, Schur
    elimination structure) as a pytree. Threaded through jit as an
    ARGUMENT — captured as closure constants these arrays become large
    HLO literals that blow up compile times.

    Memoized per (program, structural-options): the aux arrays for a large
    BAL problem are hundreds of MB of indices, and rebuilding them per
    solve would redo the host build and re-upload everything
    host->device."""
    cache = getattr(program, "_solve_aux_cache", None)
    if cache is None:
        cache = {}
        program._solve_aux_cache = cache
    key = _solve_aux_cache_key(options)
    hit = cache.get(key)
    if hit is not None:
        return hit
    bd_groups = program.jnp_bd_groups()
    schur_structure = None
    if options.linear_solver_type in (
        LinearSolverType.DENSE_SCHUR,
        LinearSolverType.ITERATIVE_SCHUR,
        LinearSolverType.SPARSE_SCHUR,
    ):
        from ceres_tpu.linear.schur import build_schur_structure
        from ceres_tpu.ordered_groups import (
            normalize_ordering,
            validate_ordering_partition,
        )

        ordering = None
        user_groups = normalize_ordering(options.linear_solver_ordering)
        if user_groups:
            if len(user_groups) > 1:
                # Multi-group semantics (ordered_groups.h): the ordering
                # must partition the active blocks; group 0 is eliminated
                # first. Remaining groups order the reduced system — a
                # fill-in concern for the reference's sparse
                # factorizations, numerically inert here.
                validate_ordering_partition(program, user_groups)
            ordering = list(user_groups[0])
        with_clusters = options.preconditioner_type in (
            PreconditionerType.CLUSTER_JACOBI,
            PreconditionerType.CLUSTER_TRIDIAGONAL,
        )
        with_forest = (
            options.preconditioner_type
            == PreconditionerType.CLUSTER_TRIDIAGONAL
        )
        with_explicit = options.linear_solver_type in (
            LinearSolverType.DENSE_SCHUR,
            LinearSolverType.SPARSE_SCHUR,
        ) or getattr(options, "use_explicit_schur_complement", False)
        schur_structure = getattr(program, "_schur_structure", None)
        if (
            schur_structure is None
            or ordering is not None
            or (with_clusters and schur_structure.cluster_groups is None)
            or (with_forest and schur_structure.chain_clusters is None)
        ):
            schur_structure = build_schur_structure(
                program,
                ordering=ordering,
                with_clusters=with_clusters,
                with_explicit=with_explicit,
                with_forest=with_forest,
            )
            program._schur_structure = schur_structure
        elif with_explicit and schur_structure.explicit is None:
            from ceres_tpu.linear.schur import ensure_explicit_plan

            ensure_explicit_plan(program, schur_structure)
        # Auto-explicit-S for small reduced systems (linear/schur.py
        # EXPLICIT_S_AUTO_MAX_NF): attach the assembly plan so the
        # iterative path can materialize S instead of running implicit
        # S·x sweeps per CG trip.
        if (
            options.linear_solver_type == LinearSolverType.ITERATIVE_SCHUR
            and schur_structure is not None
            and schur_structure.explicit is None
        ):
            from ceres_tpu.linear.schur import (
                EXPLICIT_S_AUTO_MAX_NF,
                ensure_explicit_plan,
            )

            if (
                int(schur_structure.f_idx.shape[0])
                <= EXPLICIT_S_AUTO_MAX_NF
            ):
                ensure_explicit_plan(program, schur_structure)
    subset_masks = None
    if (
        options.preconditioner_type == PreconditionerType.SUBSET
        and options.residual_blocks_for_subset_preconditioner
    ):
        import numpy as _np

        rid_set = set(
            int(r) for r in options.residual_blocks_for_subset_preconditioner
        )
        subset_masks = tuple(
            jnp.asarray(
                _np.asarray(
                    [1.0 if int(r) in rid_set else 0.0 for r in f.residual_ids]
                )
            )
            if f.residual_ids is not None
            else None
            for f in program.families
        )
    aux = {
        "bd_groups": bd_groups,
        "ss": schur_structure,
        "subset_masks": subset_masks,
    }
    cache[key] = aux
    return aux


from ceres_tpu.linear.cg import direct_termination as _direct_termination


def _lm_damping(diag, radius):
    """LM damping D = sqrt(diag / radius)
    (levenberg_marquardt_strategy.cc:78-95), floored at the evaluation
    precision's resolution: in f32, D^2 < eps_f32 * diag adds NOTHING
    representable to the J'J diagonal, leaving gauge-singular systems
    (BA without gauge fixing) entirely undamped — observed in f32
    as CG returning garbage steps at radius > ~1e7 no matter how far
    the invalid-step ladder shrinks it. The floor is equivalent to an
    effective trust-region cap of ~1/eps, far beyond where LM steps
    are distinguishable from Gauss-Newton. No-op in f64."""
    D = jnp.sqrt(diag / radius.astype(diag.dtype))
    if D.dtype == jnp.float32:
        # sqrt(f32 machine epsilon 1.19e-7)
        D = jnp.maximum(D, jnp.sqrt(diag) * jnp.asarray(3.5e-4, D.dtype))
    return D


def _base_linear_solve(ctx, D, solve_aux, config: _SolveConfig, rhs=None):
    """LinearSolver::Solve dispatch (linear_solver.cc:75), pure.

    Returns (y, num_iterations, termination) with termination following
    LinearSolverTerminationType (linear_solver.h:57-74): iterative solvers
    report their CG termination (FAILURE on breakdown), direct solvers
    report FAILURE on a non-finite factorization result.
    """
    lst = config.linear_solver_type
    bd = solve_aux["bd_groups"]
    one = jnp.asarray(1, jnp.int32)
    if lst == LinearSolverType.DENSE_QR:
        y = solve_dense_qr(ctx, D, rhs=rhs)
        return y, one, _direct_termination(y)
    if lst == LinearSolverType.DENSE_NORMAL_CHOLESKY:
        y = solve_dense_normal_cholesky(ctx, D, rhs=rhs)
        return y, one, _direct_termination(y)
    if lst == LinearSolverType.CGNR:
        res = solve_cgnr(
            ctx,
            D,
            preconditioner_type=config.preconditioner_type,
            bd_groups=bd
            if config.preconditioner_type == PreconditionerType.JACOBI
            else None,
            max_num_iterations=config.max_linear_solver_iterations,
            min_num_iterations=config.min_linear_solver_iterations,
            q_tolerance=config.eta,
            r_tolerance=-1.0,
            rhs=rhs,
            subset_masks=solve_aux.get("subset_masks"),
        )
        return res.x, res.num_iterations, res.termination
    if lst in (
        LinearSolverType.DENSE_SCHUR,
        LinearSolverType.ITERATIVE_SCHUR,
        LinearSolverType.SPARSE_SCHUR,
    ):
        from ceres_tpu.linear.schur import solve_schur

        return solve_schur(
            ctx, D, None, config, ss=solve_aux["ss"], rhs=rhs
        )
    if lst == LinearSolverType.SPARSE_NORMAL_CHOLESKY:
        # Exact host simplicial Cholesky
        # (sparse_normal_cholesky_solver.cc:51-120, sparse_cholesky.h:71-112)
        # embedded through jax.pure_callback. The trust-region LM loop
        # uses a host-driven step instead (_make_sparse_lm_step_fn), so
        # this in-jit branch is reached only from fully-jitted callers
        # (dogleg, refinement).
        from ceres_tpu.linear import sparse_cholesky as _sc

        return _sc.solve_sparse_normal_cholesky(
            ctx, D, rhs=rhs, dynamic=config.dynamic_sparsity
        )
    raise ValueError(f"unsupported linear solver {lst}")


def _cast_tree(t, dtype):
    return jax.tree_util.tree_map(
        lambda a: a.astype(dtype)
        if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating)
        else a,
        t,
    )


def _linear_solve(ctx, D, solve_aux, config: _SolveConfig, rhs=None):
    """Dispatch incl. the mixed-precision wrapper: factor/solve in f32,
    residual + accumulation in f64 — the analog of
    RefinedDenseCholesky / use_mixed_precision_solves
    (dense_cholesky.h:104-246, iterative_refiner.{h,cc}): refinement buys
    back f64 step accuracy for an f32 factorization."""
    if not config.use_mixed_precision_solves:
        return _base_linear_solve(ctx, D, solve_aux, config, rhs=rhs)

    ctx32 = _cast_tree(ctx, jnp.float32)
    D32 = D.astype(jnp.float32)
    aux32 = _cast_tree(solve_aux, jnp.float32)
    # The refinement residual must be computed in HIGHER precision than
    # the factorization (iterative_refiner.h): upcast the (f32-stored)
    # Jacobian blocks to f64 for the matvec passes.
    ctx64 = _cast_tree(ctx, jnp.float64)
    D64 = D.astype(jnp.float64)
    rhs64 = ctx64.gradient() if rhs is None else rhs.astype(jnp.float64)
    y32, lin_iters, term = _base_linear_solve(
        ctx32, D32, aux32, config, rhs=rhs64.astype(jnp.float32)
    )
    y = y32.astype(jnp.float64)
    total_iters = lin_iters
    for _ in range(config.num_refinement_iterations):
        r = rhs64 - (ctx64.normal_matvec(y) + (D64 * D64) * y)
        dy32, li, t2 = _base_linear_solve(
            ctx32, D32, aux32, config, rhs=r.astype(jnp.float32)
        )
        y = y + dy32.astype(jnp.float64)
        total_iters = total_iters + li
        term = jnp.maximum(term, t2)
    return y, total_iters, term


from ceres_tpu.problem import plus_apply

_plus_jit = jax.jit(plus_apply)


@functools.partial(
    jax.jit,
    static_argnames=("apply_loss", "has_bounds", "use_scaling"),
)
def _candidate_impl(
    x,
    step_scaled,
    scaling,
    families,
    plus_struct,
    lower,
    upper,
    apply_loss,
    has_bounds,
    use_scaling,
):
    """Candidate point + cost + norms in ONE device computation with one
    host transfer: the loop's per-iteration scalar reads otherwise cost a
    device round-trip each (trust_region_minimizer.cc:775-793 fused)."""
    from ceres_tpu.evaluator import _cost_impl

    delta = step_scaled * scaling if use_scaling else step_scaled
    cand = plus_apply(plus_struct, x, delta)
    if has_bounds:
        cand = jnp.clip(cand, lower, upper)
    cost = _cost_impl(cand, families, apply_loss)
    step_norm = jnp.linalg.norm((x - cand).astype(jnp.float64))
    x_norm = jnp.linalg.norm(x.astype(jnp.float64))
    return cand, cost, step_norm, x_norm


@jax.jit
def _grad_norms(grad):
    g = grad.astype(jnp.float64)
    return jnp.max(jnp.abs(g)) if g.size else jnp.asarray(0.0), jnp.linalg.norm(g)


@functools.partial(
    jax.jit, static_argnames=("config", "apply_loss", "use_scaling")
)
def _tr_iteration_impl(
    x,
    ctx,
    radius,
    scaling,
    plus_struct,
    solve_aux,
    config: _SolveConfig,
    apply_loss,
    use_scaling,
):
    """One COMPLETE trust-region iteration as a single XLA computation:
    LM step + candidate point + candidate cost + norms + a *speculative*
    full evaluation (gradient + Jacobian) at the candidate.

    The reference's loop (trust_region_minimizer.cc:68-136) makes the
    accept/reject decision on host scalars; every scalar read is a
    device round-trip, so the unfused loop paid 3+ transfers
    per iteration (step scalars, candidate scalars, new gradient norms).
    Fusing everything — including the re-evaluation the reference only
    performs on accepted steps (HandleSuccessfulStep) — costs one wasted
    Jacobian evaluation on rejected steps but brings the loop to exactly
    ONE device->host transfer per iteration. Control flow stays on host.

    Returns (candidate_x, candidate_ctx, candidate_grad, scalars) with
    scalars = (mcc, lin_iters, lin_term, cand_cost, step_norm, x_norm,
    cand_gmax, cand_gnorm) fetched by the host in a single device_get.
    """
    from ceres_tpu.evaluator import _full_impl

    if use_scaling:
        # One column-norm pass (see fused_lm._body): scaled norms are
        # scaling^2 * unscaled norms.
        norms0 = ctx.squared_column_norms()
        ctx_used = ctx.scale_columns(scaling)
        scaled_norms = scaling * scaling * norms0
    else:
        ctx_used = ctx
        scaled_norms = ctx.squared_column_norms()
    diag = jnp.clip(
        scaled_norms,
        config.min_lm_diagonal,
        config.max_lm_diagonal,
    )
    D = _lm_damping(diag, radius)
    y, lin_iters, lin_term = _linear_solve(ctx_used, D, solve_aux, config)
    step_scaled = -y.astype(diag.dtype)
    Js = ctx_used.matvec(step_scaled)
    mcc = jnp.asarray(0.0, jnp.float64)
    for fi in range(len(ctx_used.families)):
        mcc = mcc - jnp.sum(
            Js[fi].astype(jnp.float64)
            * (
                ctx_used.residuals[fi].astype(jnp.float64)
                + Js[fi].astype(jnp.float64) / 2.0
            )
        )

    delta = step_scaled * scaling if use_scaling else step_scaled
    cand = plus_apply(plus_struct, x, delta)
    step_norm = jnp.linalg.norm((x - cand).astype(jnp.float64))
    x_norm = jnp.linalg.norm(x.astype(jnp.float64))

    # Speculative evaluation at the candidate (cost comes free with it).
    cand_cost, cand_grad, cand_ctx = _full_impl(
        cand, ctx.families, apply_loss, config.num_tangent, ctx.groups
    )
    g = cand_grad.astype(jnp.float64)
    gmax = jnp.max(jnp.abs(g)) if g.size else jnp.asarray(0.0, jnp.float64)
    gnorm = jnp.linalg.norm(g)
    scalars = (
        mcc,
        lin_iters,
        lin_term,
        cand_cost,
        step_norm,
        x_norm,
        gmax,
        gnorm,
    )
    return cand, cand_ctx, cand_grad, scalars


@jax.jit
def _scale_columns_jit(ctx, s):
    return ctx.scale_columns(s)


@functools.partial(jax.jit, static_argnames=("config",))
def _lm_step_impl(ctx, radius, solve_aux, config: _SolveConfig):
    """One LM step (module-level: shared jit cache across solves).
    levenberg_marquardt_strategy.cc:78-95 + model cost change
    (trust_region_minimizer.cc:424-438)."""
    diag = jnp.clip(
        ctx.squared_column_norms(), config.min_lm_diagonal,
        config.max_lm_diagonal,
    )
    D = _lm_damping(diag, radius)
    y, lin_iters, term = _linear_solve(ctx, D, solve_aux, config)
    # mixed-precision solves return an f64-refined y; the step is
    # applied to the evaluation-dtype state, so cast back.
    step = -y.astype(diag.dtype)
    Js = ctx.matvec(step)
    mcc = jnp.asarray(0.0, jnp.float64)
    for fi in range(len(ctx.families)):
        mcc = mcc - jnp.sum(
            Js[fi].astype(jnp.float64)
            * (
                ctx.residuals[fi].astype(jnp.float64)
                + Js[fi].astype(jnp.float64) / 2.0
            )
        )
    return step, mcc, lin_iters, term


def _make_linear_solve(options, program: Program):
    """Back-compat factory: returns (linear_solve(ctx, D, aux, rhs=None),
    solve_aux) bound to this options/program pair."""
    config = _config_from_options(options, program)
    solve_aux = _build_solve_aux(options, program)

    def linear_solve(ctx, D, solve_aux, rhs=None):
        return _linear_solve(ctx, D, solve_aux, config, rhs=rhs)

    return linear_solve, solve_aux


@functools.partial(jax.jit, static_argnames=("config",))
def _sparse_prep_impl(ctx, radius, config: _SolveConfig):
    """Device half 1 of the host-driven SPARSE_NORMAL_CHOLESKY step:
    LM diagonal + rhs (levenberg_marquardt_strategy.cc:78-95)."""
    diag = jnp.clip(
        ctx.squared_column_norms(), config.min_lm_diagonal,
        config.max_lm_diagonal,
    )
    D = _lm_damping(diag, radius)
    return D, ctx.gradient()


@functools.partial(jax.jit, static_argnames=("config",))
def _sparse_prep_radius_free_impl(ctx, config: _SolveConfig):
    """Radius-free device half of the pipelined sparse step: clipped LM
    diagonal + rhs. The damping D = sqrt(diag/radius) is applied on the
    HOST (numpy mirror of _lm_damping), so rejected steps re-damp the
    cached transfer instead of re-running the device prep."""
    diag = jnp.clip(
        ctx.squared_column_norms(), config.min_lm_diagonal,
        config.max_lm_diagonal,
    )
    return diag, ctx.gradient()


@jax.jit
def _sparse_finish_impl(ctx, y):
    """Device half 2: step + model cost change
    (trust_region_minimizer.cc:424-438)."""
    step = -y
    Js = ctx.matvec(step)
    mcc = jnp.asarray(0.0, jnp.float64)
    for fi in range(len(ctx.families)):
        mcc = mcc - jnp.sum(
            Js[fi].astype(jnp.float64)
            * (
                ctx.residuals[fi].astype(jnp.float64)
                + Js[fi].astype(jnp.float64) / 2.0
            )
        )
    return step, mcc


def _make_sparse_lm_step_fn(config: _SolveConfig, program=None):
    """Host-driven SPARSE_NORMAL_CHOLESKY LM step: the normal equations
    are factorized on the HOST between jitted device computations, with
    no pure_callback. Mirrors sparse_normal_cholesky_solver.cc:51-120
    with the symbolic factorization cached across iterations
    (sparse_cholesky.h:71-112).

    Static sparsity (the default): H = J'J is assembled ON DEVICE into
    unique block-pair cells (linear/inner_product.py, the
    inner_product_computer.h:64 analog) and only O(nnz(H)) cell values +
    rhs cross to the host per iteration. ``dynamic_sparsity`` ships the
    Jacobian instead and re-analyzes every iteration
    (dynamic_sparse_normal_cholesky_solver.cc semantics — the pattern
    itself is data-dependent there)."""
    from ceres_tpu.linear import sparse_cholesky as _sc

    if not config.dynamic_sparsity and program is not None:
        from ceres_tpu.linear.inner_product import (
            _normal_cells_impl,
            build_normal_assembly,
            build_normal_plan,
            host_normal_factor_solve,
        )

        cached = getattr(program, "_normal_assembly", None)
        if cached is None:
            plan = build_normal_plan(program)
            assembly = build_normal_assembly(plan)
            program._normal_assembly = (plan, assembly)
        else:
            plan, assembly = cached

        # Pipelined host step (r5, VERDICT #8): the H cells, rhs and LM
        # diagonal are all RADIUS-FREE for the normal equations, so a
        # rejected step (same ctx, smaller radius) skips the device prep
        # and the device->host transfer entirely — only the damping
        # changes, recomputed on the host. A single-worker executor
        # additionally pre-factors at the PREDICTED post-reject radius
        # (levenberg_marquardt_strategy.cc radius/decrease_factor with
        # the doubling schedule) while the device runs the finish +
        # candidate work, hiding the host factor latency inside reject
        # streaks. Speculation only arms inside a streak, so accepted
        # steps never queue behind a wasted factorization.
        import concurrent.futures as _cf

        state: dict = {"ctx_ref": None}
        executor = _cf.ThreadPoolExecutor(max_workers=1)

        def _damping_np(diag_h, radius_f):
            D = np.sqrt(diag_h / radius_f)
            if diag_h.dtype == np.float32:
                D = np.maximum(D, np.sqrt(diag_h) * np.float32(3.5e-4))
            return D.astype(diag_h.dtype)

        def _host_solve(D_h, cells_h, rhs_h):
            return host_normal_factor_solve(
                assembly, cells_h, D_h, rhs_h,
                ordering=config.ordering_type,
                use_postordering=config.use_postordering,
                mixed_precision=config.use_mixed_precision_solves,
                num_refinement_iterations=config.num_refinement_iterations,
            )

        def step_fn(ctx, radius):
            radius_f = float(radius)
            in_streak = state.get("ctx_ref") is ctx
            if not in_streak:
                diag, rhs = _sparse_prep_radius_free_impl(ctx, config)
                blocks = _normal_cells_impl(ctx, plan)
                for leaf in jax.tree_util.tree_leaves((blocks, diag, rhs)):
                    if hasattr(leaf, "copy_to_host_async"):
                        leaf.copy_to_host_async()  # overlap D2H with compute
                blocks_h, diag_h, rhs_h = jax.device_get(
                    (blocks, diag, rhs)
                )
                sp = state.pop("spec", None)
                if sp is not None:
                    sp[1].cancel()
                state.update(
                    ctx_ref=ctx,
                    cells=[np.asarray(b) for b in blocks_h],
                    diag=np.asarray(diag_h),
                    rhs=np.asarray(rhs_h),
                    pred_factor=2.0,
                    prev_radius=None,
                )
            else:
                prev = state.get("prev_radius")
                if prev and radius_f < prev:
                    # learn the strategy's doubling decrease schedule
                    state["pred_factor"] = (prev / radius_f) * 2.0
            diag_h, cells_h, rhs_h = (
                state["diag"], state["cells"], state["rhs"]
            )
            sp = state.pop("spec", None)
            if (
                sp is not None
                and abs(sp[0] - radius_f) <= 1e-9 * max(radius_f, 1.0)
            ):
                y, term = sp[1].result()  # pre-factored during the reject
            else:
                if sp is not None:
                    sp[1].cancel()
                y, term = executor.submit(
                    _host_solve, _damping_np(diag_h, radius_f), cells_h,
                    rhs_h,
                ).result()
            if in_streak:
                # arm the next speculative factor for the predicted
                # post-reject radius; runs while the device finishes.
                r_pred = radius_f / state.get("pred_factor", 2.0)
                state["spec"] = (
                    r_pred,
                    executor.submit(
                        _host_solve, _damping_np(diag_h, r_pred), cells_h,
                        rhs_h,
                    ),
                )
            state["prev_radius"] = radius_f
            step, mcc = _sparse_finish_impl(
                ctx, jnp.asarray(y).astype(diag_h.dtype)
            )
            return (
                step,
                mcc,
                jnp.asarray(1, jnp.int32),
                jnp.asarray(term, jnp.int32),
            )

        return step_fn

    def step_fn(ctx, radius):
        D, rhs = _sparse_prep_impl(ctx, radius, config)
        args = [
            [
                (
                    np.asarray(fam.tangent_idx[j]),
                    np.asarray(ctx.jacs[fi][j], dtype=np.float64),
                )
                for j in range(fam.num_args)
            ]
            for fi, fam in enumerate(ctx.families)
        ]
        y, lin_iters, term = _sc.host_sparse_normal_solve(
            config.num_tangent,
            config.dynamic_sparsity,
            np.asarray(D, dtype=np.float64),
            np.asarray(rhs, dtype=np.float64),
            args,
            ordering=config.ordering_type,
            use_postordering=config.use_postordering,
            mixed_precision=config.use_mixed_precision_solves,
            num_refinement_iterations=config.num_refinement_iterations,
        )
        step, mcc = _sparse_finish_impl(ctx, jnp.asarray(y).astype(D.dtype))
        return step, mcc, jnp.asarray(lin_iters), jnp.asarray(term)

    return step_fn


def _make_lm_step_fn(options, program: Program):
    """Returns f(ctx, radius) -> (step, model_cost_change, lin_iters,
    lin_termination) bound to the shared module-level jitted impl."""
    config = _config_from_options(options, program)
    if config.linear_solver_type == LinearSolverType.SPARSE_NORMAL_CHOLESKY:
        # Host-driven exact sparse step; with use_mixed_precision_solves
        # the host factors in f32 and refines in f64 (the
        # RefinedSparseCholesky route, sparse_cholesky.h:118).
        return _make_sparse_lm_step_fn(config, program)
    solve_aux = _build_solve_aux(options, program)
    if config.linear_solver_type == LinearSolverType.SPARSE_SCHUR:
        # True sparse reduced camera system: device eliminator cells +
        # host block-sparse Cholesky (schur_complement_solver.h:169-183);
        # mixed precision factors S in f32 + refines in f64. (Fully-
        # jitted callers use the in-graph dense-S route in
        # linear/schur.py instead.)
        from ceres_tpu.linear.sparse_schur import make_sparse_schur_step_fn

        return make_sparse_schur_step_fn(config, solve_aux)
    return lambda ctx, radius: _lm_step_impl(ctx, radius, solve_aux, config)


class TrustRegionMinimizer:
    """The outer loop (trust_region_minimizer.cc:68-136)."""

    def __init__(self, program: Program, options, summary):
        from ceres_tpu.types import TrustRegionStrategyType

        self.program = program
        self.options = options
        self.summary = summary
        self.evaluator = Evaluator(
            program, evaluation_callback=options.evaluation_callback
        )
        self.use_dogleg = (
            options.trust_region_strategy_type
            == TrustRegionStrategyType.DOGLEG
        )
        if self.use_dogleg:
            from ceres_tpu.dogleg import DoglegStrategy

            linear_solve, solve_aux = _make_linear_solve(options, program)
            self._dogleg = DoglegStrategy(options, linear_solve, solve_aux)
        else:
            self.step_fn = _make_lm_step_fn(options, program)
        self._plus = lambda x, d: _plus_jit(program.plus_struct, x, d)
        self._scale_columns = _scale_columns_jit

        # Fully-fused iteration (one device->host transfer per loop trip,
        # see _tr_iteration_impl). Falls back to the step-by-step path
        # whenever a feature needs host work *between* the step and the
        # candidate evaluation (bounds line search, inner iterations,
        # host-driven sparse Cholesky, dumps, gradient checks, callbacks
        # that read intermediate state).
        config = _config_from_options(options, program)
        self._fused_config = config
        self._use_fused_iteration = (
            not self.use_dogleg
            and not program.has_bounds
            and not options.use_inner_iterations
            and options.evaluation_callback is None
            and not options.check_gradients
            and not options.update_state_every_iteration
            and not (
                options.trust_region_problem_dump_directory
                and options.trust_region_minimizer_iterations_to_dump
            )
            and config.linear_solver_type
            not in (
                LinearSolverType.SPARSE_NORMAL_CHOLESKY,
                LinearSolverType.SPARSE_SCHUR,
            )
        )
        self._fused_aux = (
            _build_solve_aux(options, program)
            if self._use_fused_iteration
            else None
        )
        # Remember the factory-made step_fn: tests (and advanced users)
        # may swap self.step_fn; the fused path must then stand down so
        # the override is actually exercised.
        self._default_step_fn = getattr(self, "step_fn", None)

        # Inner iterations (solver.h:560-600, coordinate descent).
        self.inner_minimizer = None
        self._inner_enabled = False
        if options.use_inner_iterations:
            from ceres_tpu.inner_iterations import CoordinateDescentMinimizer

            self.inner_minimizer = CoordinateDescentMinimizer(
                program, options, self.evaluator
            )
            self._inner_enabled = True

    def minimize(self, x0: jax.Array):
        opts = self.options
        program = self.program
        summary = self.summary
        start_time = time.time()

        x = program.clamp(x0)
        strategy = self._dogleg if self.use_dogleg else (
            LevenbergMarquardtStrategy(opts)
        )

        # Iteration zero (trust_region_minimizer.cc:196-283).
        _t0 = time.time()
        full = self.evaluator.cost_gradient_jacobian(x)
        x_cost = float(full.cost)
        summary.jacobian_evaluation_time_in_seconds += time.time() - _t0
        summary.num_jacobian_evaluations += 1
        if not np.isfinite(x_cost):
            summary.termination_type = TerminationType.FAILURE
            summary.message = "Initial cost evaluation failed (non-finite)."
            return np.asarray(x)
        grad = full.gradient
        ctx = full.jacobian_context

        jacobi_scaling = None
        if opts.jacobi_scaling:
            # scale_i = 1 / (1 + sqrt(diag(J'J)_i))
            # (trust_region_minimizer.cc:263-279)
            jacobi_scaling = 1.0 / (1.0 + jnp.sqrt(ctx.squared_column_norms()))

        step_evaluator = TrustRegionStepEvaluator(
            x_cost,
            opts.max_consecutive_nonmonotonic_steps
            if opts.use_nonmonotonic_steps
            else 0,
        )

        it = IterationSummary(
            iteration=0,
            cost=x_cost + summary.fixed_cost,
            gradient_max_norm=float(jnp.max(jnp.abs(grad))) if grad.size else 0.0,
            gradient_norm=float(jnp.linalg.norm(grad)),
            trust_region_radius=strategy.radius,
            eta=opts.eta,
            step_is_valid=True,
            step_is_successful=True,
            cumulative_time_in_seconds=time.time() - start_time,
        )
        summary.iterations.append(it)
        self._log_progress(it)

        if it.gradient_max_norm <= opts.gradient_tolerance:
            summary.termination_type = TerminationType.CONVERGENCE
            summary.message = (
                f"Gradient tolerance reached. Gradient max norm: "
                f"{it.gradient_max_norm:e} <= {opts.gradient_tolerance:e}"
            )
            return self._finish(x)

        num_consecutive_invalid_steps = 0
        atleast_one_successful_step = False

        while True:
            iter_start = time.time()
            prev = summary.iterations[-1]
            it = IterationSummary(
                iteration=prev.iteration + 1,
                trust_region_radius=strategy.radius,
                eta=opts.eta,
            )

            if self._check_termination_pre(it):
                return self._finish(x)

            # Compute step with the (scaled) jacobian.
            solver_t0 = time.time()
            fused = self._use_fused_iteration and (
                getattr(self, "step_fn", None) is self._default_step_fn
            )
            if fused:
                # One XLA call: step + candidate + cost + speculative
                # re-evaluation; one device_get for every host scalar.
                cand_x_dev, cand_ctx, cand_grad, scalar_pack = (
                    _tr_iteration_impl(
                        x,
                        ctx,
                        jnp.asarray(strategy.radius, jnp.float64),
                        jacobi_scaling
                        if jacobi_scaling is not None
                        else x,
                        program.plus_struct,
                        self._fused_aux,
                        self._fused_config,
                        self.evaluator.apply_loss,
                        jacobi_scaling is not None,
                    )
                )
                (
                    model_cost_change,
                    lin_iters,
                    lin_term,
                    f_cand_cost,
                    f_step_norm,
                    f_x_norm,
                    f_gmax,
                    f_gnorm,
                ) = jax.device_get(scalar_pack)
                step_scaled = True  # not None: validity checked below
            else:
                # Memoized column scaling: rejected iterations keep the
                # SAME scaled-ctx object, so the pipelined sparse steps'
                # identity-keyed transfer cache (VERDICT r5 #8) hits.
                if jacobi_scaling is None:
                    ctx_used = ctx
                else:
                    memo = getattr(self, "_scaled_ctx_memo", None)
                    if (
                        memo is None
                        or memo[0] is not ctx
                        or memo[1] is not jacobi_scaling
                    ):
                        memo = (
                            ctx,
                            jacobi_scaling,
                            self._scale_columns(ctx, jacobi_scaling),
                        )
                        self._scaled_ctx_memo = memo
                    ctx_used = memo[2]
                if self.use_dogleg:
                    step_scaled, model_cost_change, lin_iters, lin_term = (
                        strategy.compute_step(ctx_used)
                    )
                else:
                    step_scaled, model_cost_change, lin_iters, lin_term = (
                        self.step_fn(
                            ctx_used,
                            jnp.asarray(strategy.radius, jnp.float64),
                        )
                    )
                model_cost_change, lin_iters, lin_term = jax.device_get(
                    (model_cost_change, lin_iters, lin_term)
                )
            model_cost_change = float(model_cost_change)
            lin_term = int(lin_term)
            it.linear_solver_iterations = int(lin_iters)
            it.step_solver_time_in_seconds = time.time() - solver_t0
            # Statistics (execution_summary.h analog): on the fused path
            # one call covers step + candidate + re-evaluation, so its
            # whole time lands under "linear solver" and the evaluation
            # counters still tick (see SolverSummary field comment).
            summary.linear_solver_time_in_seconds += (
                it.step_solver_time_in_seconds
            )
            summary.num_linear_solves += 1
            if fused:
                summary.num_residual_evaluations += 1
                summary.num_jacobian_evaluations += 1

            # Problem dumps (solver.h:725-735,
            # trust_region_minimizer.cc:386-396).
            if (
                not fused
                and opts.trust_region_problem_dump_directory
                and it.iteration
                in opts.trust_region_minimizer_iterations_to_dump
            ):
                from ceres_tpu.utils.observability import (
                    dump_trust_region_problem,
                )

                diag = jnp.clip(
                    ctx_used.squared_column_norms(),
                    opts.min_lm_diagonal,
                    opts.max_lm_diagonal,
                )
                dump_trust_region_problem(
                    f"{opts.trust_region_problem_dump_directory}/lm_problem",
                    it.iteration,
                    ctx_used,
                    jnp.sqrt(diag / strategy.radius),
                    step_scaled,
                )
            from ceres_tpu.linear.cg import CG_FAILURE, CG_FATAL_ERROR

            if lin_term >= CG_FATAL_ERROR:
                # linear_solver.h:69-74: unrecoverable — abort the solve.
                summary.termination_type = TerminationType.FAILURE
                summary.message = (
                    "Terminating: linear solver reported FATAL_ERROR."
                )
                return self._finish(x)
            # FAILURE -> invalid step (retry with a smaller trust region),
            # the reference's HandleInvalidStep path.
            it.step_is_valid = (
                step_scaled is not None
                and lin_term < CG_FAILURE
                and np.isfinite(model_cost_change)
                and model_cost_change > 0.0
            )
            if lin_term >= CG_FAILURE:
                summary.num_linear_solver_failures += 1

            if not it.step_is_valid:
                # HandleInvalidStep (trust_region_minimizer.cc:466-500)
                num_consecutive_invalid_steps += 1
                if (
                    num_consecutive_invalid_steps
                    >= opts.max_num_consecutive_invalid_steps
                ):
                    summary.termination_type = TerminationType.FAILURE
                    summary.message = (
                        "Number of consecutive invalid steps more than "
                        "Solver::Options::max_num_consecutive_invalid_steps: "
                        f"{opts.max_num_consecutive_invalid_steps}"
                    )
                    return self._finish(x)
                strategy.step_is_invalid(0.0)
                it.cost = x_cost + summary.fixed_cost
                it.gradient_max_norm = prev.gradient_max_norm
                it.gradient_norm = prev.gradient_norm
                it.iteration_time_in_seconds = time.time() - iter_start
                it.cumulative_time_in_seconds = time.time() - start_time
                summary.iterations.append(it)
                self._log_progress(it)
                if self._run_callbacks(it, x):
                    return self._finish(x)
                continue

            num_consecutive_invalid_steps = 0

            if fused:
                # Everything already computed inside _tr_iteration_impl.
                candidate_x = cand_x_dev
                candidate_cost = float(f_cand_cost)
                step_norm = float(f_step_norm)
                x_norm = float(f_x_norm)
            elif program.has_bounds:
                # Projected line search for bounds
                # (trust_region_minimizer.cc:103-108).
                delta = (
                    step_scaled * jacobi_scaling
                    if jacobi_scaling is not None
                    else step_scaled
                )
                delta = self._projected_line_search(x, x_cost, delta, grad)
                candidate_x = program.clamp(self._plus(x, delta))
                _t0 = time.time()
                candidate_cost = float(self.evaluator.cost(candidate_x))
                summary.residual_evaluation_time_in_seconds += (
                    time.time() - _t0
                )
                summary.num_residual_evaluations += 1
                x_norm = float(jnp.linalg.norm(x))
                step_norm = float(jnp.linalg.norm(x - candidate_x))
            else:
                # Fused candidate + cost + norms: one jit call, one
                # host transfer (trust_region_minimizer.cc:775-793).
                _t0 = time.time()
                self.evaluator._notify(None, False)
                candidate_x, cc, sn, xn = _candidate_impl(
                    x,
                    step_scaled,
                    jacobi_scaling
                    if jacobi_scaling is not None
                    else step_scaled,
                    program.families,
                    program.plus_struct,
                    program.lower,
                    program.upper,
                    self.evaluator.apply_loss,
                    False,
                    jacobi_scaling is not None,
                )
                cc, sn, xn = jax.device_get((cc, sn, xn))
                candidate_cost, step_norm, x_norm = (
                    float(cc), float(sn), float(xn),
                )
                summary.residual_evaluation_time_in_seconds += (
                    time.time() - _t0
                )
                summary.num_residual_evaluations += 1
            if not np.isfinite(candidate_cost):
                candidate_cost = _DBL_MAX

            # DoInnerIterationsIfNeeded (trust_region_minimizer.cc:509-581):
            # polish the candidate with coordinate descent, disabling the
            # machinery once its relative progress drops below tolerance.
            if (
                self._inner_enabled
                and np.isfinite(candidate_cost)
                and candidate_cost > 0.0
            ):
                _t0 = time.time()
                inner_x, inner_cost = self.inner_minimizer.minimize(
                    candidate_x
                )
                summary.inner_iteration_time_in_seconds += time.time() - _t0
                summary.num_inner_iteration_steps += 1
                if np.isfinite(inner_cost) and inner_cost < candidate_cost:
                    rel_progress = (
                        candidate_cost - inner_cost
                    ) / candidate_cost
                    candidate_x = program.clamp(inner_x)
                    candidate_cost = float(
                        self.evaluator.cost(candidate_x)
                    )
                    if rel_progress <= opts.inner_iteration_tolerance:
                        self._inner_enabled = False
                else:
                    self._inner_enabled = False

            it.step_norm = step_norm
            it.cost_change = x_cost - candidate_cost

            # Parameter tolerance (trust_region_minimizer.cc:720-742).
            step_size_tolerance = opts.parameter_tolerance * (
                x_norm + opts.parameter_tolerance
            )
            if atleast_one_successful_step and it.step_norm <= step_size_tolerance:
                summary.termination_type = TerminationType.CONVERGENCE
                summary.message = (
                    f"Parameter tolerance reached. Relative step_norm: "
                    f"{it.step_norm / (x_norm + opts.parameter_tolerance):e} <= "
                    f"{opts.parameter_tolerance:e}."
                )
                return self._finish(x)

            # Function tolerance (trust_region_minimizer.cc:744-766).
            if abs(it.cost_change) <= opts.function_tolerance * x_cost:
                summary.termination_type = TerminationType.CONVERGENCE
                summary.message = (
                    f"Function tolerance reached. |cost_change|/cost: "
                    f"{abs(it.cost_change) / x_cost if x_cost else 0.0:e} <= "
                    f"{opts.function_tolerance:e}"
                )
                return self._finish(x)

            # Step quality (IsStepSuccessful, trust_region_minimizer.cc:795-821).
            it.relative_decrease = step_evaluator.step_quality(
                candidate_cost, model_cost_change
            )
            it.step_is_successful = (
                it.relative_decrease > opts.min_relative_decrease
            )
            it.step_is_nonmonotonic = (
                it.step_is_successful and candidate_cost > step_evaluator.minimum_cost
            )

            if it.step_is_successful and fused:
                atleast_one_successful_step = True
                x = candidate_x
                x_cost = candidate_cost
                # Reuse the speculative candidate evaluation — this is
                # the reference's HandleSuccessfulStep re-evaluation
                # (trust_region_minimizer.cc:826), already done on device.
                grad = cand_grad
                ctx = cand_ctx
                it.gradient_max_norm = float(f_gmax)
                it.gradient_norm = float(f_gnorm)
                strategy.step_accepted(it.relative_decrease)
                step_evaluator.step_accepted(candidate_cost, model_cost_change)
            elif it.step_is_successful:
                atleast_one_successful_step = True
                x = candidate_x
                x_cost = candidate_cost
                if opts.check_gradients:
                    # During-solve gradient checking: the reference wraps
                    # every evaluation in a GradientCheckingCostFunction
                    # and aborts the solve on the first mismatch at any
                    # iterate (gradient_checking_cost_function.h:105).
                    from ceres_tpu.gradient_checker import (
                        check_program_gradients_at,
                    )

                    ok, msg = check_program_gradients_at(
                        program, x,
                        opts.gradient_check_relative_precision,
                    )
                    if not ok:
                        summary.termination_type = TerminationType.FAILURE
                        summary.message = (
                            f"Gradient check failed at iteration "
                            f"{it.iteration}: {msg}"
                        )
                        return self._finish(x)
                _t0 = time.time()
                full = self.evaluator.cost_gradient_jacobian(x)
                grad = full.gradient
                ctx = full.jacobian_context
                gmax, gnorm = jax.device_get(_grad_norms(grad))
                summary.jacobian_evaluation_time_in_seconds += (
                    time.time() - _t0
                )
                summary.num_jacobian_evaluations += 1
                it.gradient_max_norm = float(gmax)
                it.gradient_norm = float(gnorm)
                strategy.step_accepted(it.relative_decrease)
                step_evaluator.step_accepted(candidate_cost, model_cost_change)
            else:
                strategy.step_rejected(it.relative_decrease)
                it.gradient_max_norm = prev.gradient_max_norm
                it.gradient_norm = prev.gradient_norm

            it.cost = x_cost + summary.fixed_cost
            it.trust_region_radius = strategy.radius
            it.iteration_time_in_seconds = time.time() - iter_start
            it.cumulative_time_in_seconds = time.time() - start_time
            summary.iterations.append(it)
            self._log_progress(it)
            if self._run_callbacks(it, x):
                return self._finish(x)

            if (
                it.step_is_successful
                and it.gradient_max_norm <= opts.gradient_tolerance
            ):
                summary.termination_type = TerminationType.CONVERGENCE
                summary.message = (
                    f"Gradient tolerance reached. Gradient max norm: "
                    f"{it.gradient_max_norm:e} <= {opts.gradient_tolerance:e}"
                )
                return self._finish(x)

            if strategy.radius <= opts.min_trust_region_radius:
                summary.termination_type = TerminationType.CONVERGENCE
                summary.message = (
                    "Minimum trust region radius reached. Trust region radius: "
                    f"{strategy.radius:e} <= {opts.min_trust_region_radius:e}"
                )
                return self._finish(x)

    # -- helpers ------------------------------------------------------------

    def _check_termination_pre(self, it: IterationSummary) -> bool:
        opts = self.options
        summary = self.summary
        if it.iteration > opts.max_num_iterations:
            summary.termination_type = TerminationType.NO_CONVERGENCE
            summary.message = (
                "Maximum number of iterations reached. "
                f"Number of iterations: {it.iteration - 1}."
            )
            return True
        total = it.cumulative_time_in_seconds = (
            summary.iterations[-1].cumulative_time_in_seconds
        )
        if total >= opts.max_solver_time_in_seconds:
            summary.termination_type = TerminationType.NO_CONVERGENCE
            summary.message = "Maximum solver time reached."
            return True
        return False

    def _projected_line_search(self, x, x_cost, delta, gradient):
        """Projected Armijo backtracking with polynomial interpolation.

        Analog of TrustRegionMinimizer::DoLineSearch
        (trust_region_minimizer.cc:290-379,590-635): sufficient-decrease
        condition phi(a) <= phi(0) + c*a*phi'(0) on the projected step,
        with the next trial step chosen by quadratic (first backtrack)
        then cubic (subsequent) interpolation of the sampled values —
        the reference's ArmijoLineSearch + polynomial.cc minimization —
        safeguarded to [0.1a, 0.5a] like line_search.cc's
        min/max_relative_step_size_change defaults.
        """
        program, opts = self.program, self.options
        c1 = opts.line_search_sufficient_function_decrease
        phi0 = x_cost
        dphi0 = float(jnp.vdot(gradient.astype(jnp.float64),
                               delta.astype(jnp.float64)))
        if not np.isfinite(dphi0) or dphi0 >= 0.0:
            # Scaling/projection degraded descent: keep the full step and
            # let the step-quality test reject it (the reference treats a
            # non-descent direction as line search failure).
            return delta
        alpha = 1.0
        prev = None  # (alpha, phi) of the previous trial
        for _ in range(opts.max_num_line_search_step_size_iterations):
            if alpha < opts.min_line_search_step_size:
                # Degenerate step (line_search.cc ArmijoLineSearch's
                # min_step_size abort): a rounding-level alpha can
                # satisfy the sufficient-decrease test spuriously and
                # trip the parameter-tolerance check. Treat as failure.
                break
            cand = program.clamp(self._plus(x, alpha * delta))
            phi = float(self.evaluator.cost(cand))
            if np.isfinite(phi) and phi <= phi0 + c1 * alpha * dphi0:
                return alpha * delta
            from ceres_tpu.ops.polynomial import (
                cubic_minimizer_from_samples,
                quadratic_minimizer,
            )

            if prev is None or not np.isfinite(phi):
                # Quadratic through phi(0), phi'(0), (alpha, phi).
                a_next = quadratic_minimizer(phi0, dphi0, alpha, phi)
            else:
                # Cubic through phi(0), phi'(0) and the last two samples
                # (Nocedal & Wright eq. 3.43; polynomial.cc analog;
                # shared implementation in ops/polynomial.py).
                a0, f0 = prev
                a_next = cubic_minimizer_from_samples(
                    phi0, dphi0, a0, f0, alpha, phi
                )
            if not np.isfinite(a_next):
                a_next = 0.5 * alpha
            a_next = min(max(a_next, 0.1 * alpha), 0.5 * alpha)
            if np.isfinite(phi):
                prev = (alpha, phi)
            alpha = a_next
        # Line search failed: keep the FULL step, exactly like the
        # reference (line_search_summary.success == false leaves delta
        # unscaled, trust_region_minimizer.cc:633-635). The clamped
        # candidate is then rejected by the step-quality test and the
        # radius shrinks until the direction follows the projected
        # gradient — returning the best tiny step instead would trip the
        # parameter-tolerance test and report false convergence at an
        # active bound.
        return delta

    def _run_callbacks(self, it: IterationSummary, x=None) -> bool:
        """Returns True if minimization should stop (callbacks.h:45-75)."""
        if (
            self.options.update_state_every_iteration
            and x is not None
            and self.options.callbacks
        ):
            # solver.h:786-815: expose current parameters to callbacks.
            self.program._problem.write_back(np.asarray(x))
        for cb in self.options.callbacks:
            ret = cb(it)
            if ret == CallbackReturnType.SOLVER_ABORT:
                self.summary.termination_type = TerminationType.USER_FAILURE
                self.summary.message = "User callback returned SOLVER_ABORT."
                return True
            if ret == CallbackReturnType.SOLVER_TERMINATE_SUCCESSFULLY:
                self.summary.termination_type = TerminationType.USER_SUCCESS
                self.summary.message = (
                    "User callback returned SOLVER_TERMINATE_SUCCESSFULLY."
                )
                return True
        return False

    def _log_progress(self, it: IterationSummary) -> None:
        opts = self.options
        if not opts.minimizer_progress_to_stdout:
            return
        if it.iteration == 0:
            print(
                "iter      cost      cost_change  |gradient|   |step|  "
                "  tr_ratio  tr_radius  ls_iter  iter_time  total_time"
            )
        print(
            f"{it.iteration:4d} {it.cost:.6e} {it.cost_change:.2e} "
            f"{it.gradient_max_norm:.2e} {it.step_norm:.2e} "
            f"{it.relative_decrease:.2e} {it.trust_region_radius:.2e} "
            f"{it.linear_solver_iterations:7d} {it.iteration_time_in_seconds:.2e} "
            f"{it.cumulative_time_in_seconds:.2e}"
        )

    def _finish(self, x):
        return np.asarray(x)
