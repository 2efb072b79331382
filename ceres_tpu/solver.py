"""Solver entry point: options, summary, and solve().

JAX analog of ``include/ceres/solver.h:61-1127`` and
``internal/ceres/solver.cc:646-960``: the same option vocabulary and
defaults, option cross-validation (solver.cc:714-730), the
preprocess -> minimize -> summarize pipeline, and Brief/Full reports.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np

from ceres_tpu.problem import Problem
from ceres_tpu.types import (
    DoglegType,
    LinearSolverOrderingType,
    LinearSolverType,
    LineSearchDirectionType,
    LineSearchType,
    LoggingType,
    MinimizerType,
    NonlinearConjugateGradientType,
    PreconditionerType,
    TerminationType,
    TrustRegionStrategyType,
)


@dataclasses.dataclass
class SolverOptions:
    """Analog of Solver::Options (solver.h:61-816); defaults match."""

    minimizer_type: MinimizerType = MinimizerType.TRUST_REGION
    trust_region_strategy_type: TrustRegionStrategyType = (
        TrustRegionStrategyType.LEVENBERG_MARQUARDT
    )
    dogleg_type: DoglegType = DoglegType.TRADITIONAL_DOGLEG

    # Line search options (solver.h:114-306).
    line_search_direction_type: LineSearchDirectionType = (
        LineSearchDirectionType.LBFGS
    )
    line_search_type: LineSearchType = LineSearchType.WOLFE
    nonlinear_conjugate_gradient_type: NonlinearConjugateGradientType = (
        NonlinearConjugateGradientType.FLETCHER_REEVES
    )
    max_lbfgs_rank: int = 20
    use_approximate_eigenvalue_bfgs_scaling: bool = False
    min_line_search_step_size: float = 1e-9
    line_search_sufficient_function_decrease: float = 1e-4
    max_line_search_step_contraction: float = 1e-3
    min_line_search_step_contraction: float = 0.6
    max_num_line_search_step_size_iterations: int = 20
    max_num_line_search_direction_restarts: int = 5
    line_search_sufficient_curvature_decrease: float = 0.9
    max_line_search_step_expansion: float = 10.0

    # Trust region options (solver.h:307-470).
    max_num_iterations: int = 50
    max_solver_time_in_seconds: float = 1e6
    function_tolerance: float = 1e-6
    gradient_tolerance: float = 1e-10
    parameter_tolerance: float = 1e-8
    initial_trust_region_radius: float = 1e4
    max_trust_region_radius: float = 1e16
    min_trust_region_radius: float = 1e-32
    min_relative_decrease: float = 1e-3
    min_lm_diagonal: float = 1e-6
    max_lm_diagonal: float = 1e32
    max_num_consecutive_invalid_steps: int = 5
    use_nonmonotonic_steps: bool = False
    max_consecutive_nonmonotonic_steps: int = 5
    jacobi_scaling: bool = True

    # Linear solver options (solver.h:471-660).
    linear_solver_type: Optional[LinearSolverType] = None  # None = auto
    preconditioner_type: PreconditionerType = PreconditionerType.JACOBI
    min_linear_solver_iterations: int = 0
    max_linear_solver_iterations: int = 500
    eta: float = 1e-1
    use_explicit_schur_complement: bool = False
    # dynamic_sparsity (solver.h, DynamicSparseNormalCholesky): the
    # reference re-analyzes factorization sparsity every iteration for
    # numerically-sparse problems. The device path is matrix-free (CGNR),
    # so sparsity changes are free; the flag is accepted and routes to CGNR.
    dynamic_sparsity: bool = False
    use_mixed_precision_solves: bool = False
    max_num_refinement_iterations: int = 0
    # Fill-reducing ordering of the host sparse factorization
    # (solver.h:410-455): AMD (native lazy-heap minimum degree) or
    # NESDIS (recursive BFS-separator nested dissection). Applies to
    # SPARSE_NORMAL_CHOLESKY and SPARSE_SCHUR.
    linear_solver_ordering_type: LinearSolverOrderingType = (
        LinearSolverOrderingType.AMD
    )
    # Post-order the elimination tree after the fill-reducing ordering
    # (solver.h use_postordering; reorder_program.cc:114-180): improves
    # factor locality at the cost of a second symbolic pass.
    use_postordering: bool = False
    # Evaluation dtype policy (extension): None keeps the Ceres default of
    # float64. "float32" evaluates residuals/Jacobians and runs linear
    # solves in f32 (matrix products at full f32 precision, see
    # ceres_tpu/__init__.py); use_mixed_precision_solves recovers step
    # accuracy via f64 iterative refinement. Pair f32 with an
    # f32-realistic function_tolerance (~1e-5).
    evaluation_dtype: Optional[str] = None
    use_spse_initialization: bool = False
    max_num_spse_iterations: int = 5
    spse_tolerance: float = 0.1
    # Elimination-order hint (include/ceres/ordered_groups.h,
    # Solver::Options::linear_solver_ordering): list of groups of
    # parameter-block ids; group 0 is eliminated first (the e-blocks of
    # Schur solvers). None = automatic (greedy maximal independent set).
    linear_solver_ordering: Optional[List[List[int]]] = None
    # Residual block ids whose rows form the SUBSET preconditioner
    # (subset_preconditioner.h:44-80; Solver::Options::
    # residual_blocks_for_subset_preconditioner).
    residual_blocks_for_subset_preconditioner: Optional[List[int]] = None

    # Inner iterations (solver.h:560-600).
    use_inner_iterations: bool = False
    inner_iteration_tolerance: float = 1e-3
    # User-specified coordinate-descent groups (Solver::Options::
    # inner_iteration_ordering): each group must be an independent set;
    # groups are optimized in increasing order. OrderedGroups or list of
    # lists of parameter-block ids. None = automatic greedy coloring.
    inner_iteration_ordering: Optional[object] = None

    # Trust region problem dumps (solver.h:725-735).
    trust_region_problem_dump_directory: str = ""
    trust_region_minimizer_iterations_to_dump: List[int] = dataclasses.field(
        default_factory=list
    )

    # Logging / callbacks (solver.h:717-815).
    logging_type: LoggingType = LoggingType.PER_MINIMIZER_ITERATION
    minimizer_progress_to_stdout: bool = False
    check_gradients: bool = False
    gradient_check_relative_precision: float = 1e-8
    gradient_check_numeric_derivative_relative_step_size: float = 1e-6
    callbacks: List[Callable] = dataclasses.field(default_factory=list)
    # Write the current parameter values back into the Problem's blocks
    # every iteration so IterationCallbacks can observe them
    # (solver.h:786-815).
    update_state_every_iteration: bool = False
    # Pre-evaluation hook (evaluation_callback.h:63): called with
    # (new_evaluation_point, evaluate_jacobians) before every residual /
    # Jacobian evaluation the minimizer performs.
    evaluation_callback: Optional[object] = None

    # Multi-device execution (the analog of num_threads, solver.h:429).
    mesh: Optional[object] = None  # jax.sharding.Mesh for sharded evaluation
    num_threads: int = 1  # accepted for API parity; ignored

    def validate(self, num_tangent: int) -> Optional[str]:
        """Cross-validation analog of Solver::Options::IsValid
        (solver.cc:714, CommonOptionsAreValid / TrustRegionOptionsAreValid /
        LineSearchOptionsAreValid / OptionsAreValidForLinearSolver,
        solver.cc:99-452). One documented divergence:
        ``use_mixed_precision_solves`` is valid with EVERY linear solver
        here (the refinement wrapper is generic normal-equation f64
        refinement, trust_region.py:_linear_solve), where the reference
        rejects it for DENSE_QR / CGNR / ITERATIVE_SCHUR because its
        backends lack single-precision paths."""
        err = self._validate_common()
        if err is not None:
            return err
        if self.minimizer_type == MinimizerType.TRUST_REGION:
            err = self._validate_trust_region()
            if err is not None:
                return err
        # Line-search options are checked for BOTH minimizer types: a
        # bounds-constrained trust-region solve uses the line search for
        # the projection onto the box (solver.cc:724-729).
        err = self._validate_line_search()
        if err is not None:
            return err
        if self.evaluation_dtype is not None and self.evaluation_dtype not in (
            "float32",
            "float64",
        ):
            return (
                "evaluation_dtype must be 'float32' or 'float64', got "
                f"{self.evaluation_dtype!r} (lower precisions lack the "
                "factorization kernels)"
            )
        return None

    def _validate_common(self) -> Optional[str]:
        """CommonOptionsAreValid (solver.cc:99-111)."""
        for name, v, lo in (
            ("max_num_iterations", self.max_num_iterations, 0),
            ("max_solver_time_in_seconds", self.max_solver_time_in_seconds, 0.0),
            ("function_tolerance", self.function_tolerance, 0.0),
            ("gradient_tolerance", self.gradient_tolerance, 0.0),
            ("parameter_tolerance", self.parameter_tolerance, 0.0),
        ):
            if v < lo:
                return f"{name} must be >= {lo}, got {v}"
        if self.num_threads <= 0:
            return "num_threads must be > 0"
        if self.check_gradients:
            if self.gradient_check_relative_precision <= 0:
                return "gradient_check_relative_precision must be > 0"
            if self.gradient_check_numeric_derivative_relative_step_size <= 0:
                return (
                    "gradient_check_numeric_derivative_relative_step_size "
                    "must be > 0"
                )
        return None

    def _validate_trust_region(self) -> Optional[str]:
        """TrustRegionOptionsAreValid (solver.cc:405-452)."""
        for name, v in (
            ("initial_trust_region_radius", self.initial_trust_region_radius),
            ("min_trust_region_radius", self.min_trust_region_radius),
            ("max_trust_region_radius", self.max_trust_region_radius),
            ("eta", self.eta),
        ):
            if v <= 0:
                return f"{name} must be > 0, got {v}"
        if self.min_trust_region_radius > self.max_trust_region_radius:
            return "min_trust_region_radius > max_trust_region_radius"
        if self.min_trust_region_radius > self.initial_trust_region_radius:
            return "min_trust_region_radius > initial_trust_region_radius"
        if self.initial_trust_region_radius > self.max_trust_region_radius:
            return "initial_trust_region_radius > max_trust_region_radius"
        if self.min_relative_decrease < 0:
            return "min_relative_decrease must be >= 0"
        if self.min_lm_diagonal < 0 or self.max_lm_diagonal < 0:
            return "min/max_lm_diagonal must be >= 0"
        if self.min_lm_diagonal > self.max_lm_diagonal:
            return "min_lm_diagonal > max_lm_diagonal"
        if self.max_num_consecutive_invalid_steps < 0:
            return "max_num_consecutive_invalid_steps must be >= 0"
        if self.min_linear_solver_iterations < 0:
            return "min_linear_solver_iterations must be >= 0"
        if self.max_linear_solver_iterations < 0:
            return "max_linear_solver_iterations must be >= 0"
        if self.min_linear_solver_iterations > self.max_linear_solver_iterations:
            return "min_linear_solver_iterations > max_linear_solver_iterations"
        if self.use_inner_iterations and self.inner_iteration_tolerance < 0:
            return "inner_iteration_tolerance must be >= 0"
        if (
            self.use_nonmonotonic_steps
            and self.max_consecutive_nonmonotonic_steps <= 0
        ):
            return "max_consecutive_nonmonotonic_steps must be > 0"
        lst = self.linear_solver_type
        if (
            self.trust_region_strategy_type == TrustRegionStrategyType.DOGLEG
            and lst in (LinearSolverType.CGNR, LinearSolverType.ITERATIVE_SCHUR)
        ):
            return (
                "DOGLEG only supports exact factorization based linear "
                "solvers; use LEVENBERG_MARQUARDT with iterative solvers "
                "(solver.cc:431-438)"
            )
        if (
            self.trust_region_minimizer_iterations_to_dump
            and not self.trust_region_problem_dump_directory
        ):
            return "trust_region_problem_dump_directory is empty"
        return self._validate_linear_solver()

    def _validate_linear_solver(self) -> Optional[str]:
        """OptionsAreValidForLinearSolver (solver.cc:377-403) adapted to
        this backend set (no vendor sparse libraries: every solver is
        always 'built')."""
        lst = self.linear_solver_type
        pt = self.preconditioner_type
        if self.dynamic_sparsity and lst not in (
            None,
            LinearSolverType.SPARSE_NORMAL_CHOLESKY,
        ):
            return (
                "dynamic sparsity is only supported with "
                "SPARSE_NORMAL_CHOLESKY"
            )
        if lst == LinearSolverType.CGNR:
            if pt not in (
                PreconditionerType.IDENTITY,
                PreconditionerType.JACOBI,
                PreconditionerType.SUBSET,
            ):
                return f"Can't use CGNR with preconditioner_type = {pt.name}"
        if lst == LinearSolverType.ITERATIVE_SCHUR:
            if pt == PreconditionerType.SUBSET:
                return "Can't use SUBSET preconditioner with ITERATIVE_SCHUR"
            if self.use_explicit_schur_complement:
                if pt != PreconditionerType.SCHUR_JACOBI:
                    return (
                        "use_explicit_schur_complement only supports "
                        "SCHUR_JACOBI as the preconditioner"
                    )
                if self.use_spse_initialization:
                    return (
                        "use_explicit_schur_complement does not support "
                        "use_spse_initialization"
                    )
            if (
                self.use_spse_initialization
                or pt == PreconditionerType.SCHUR_POWER_SERIES_EXPANSION
            ):
                if self.max_num_spse_iterations < 1:
                    return "max_num_spse_iterations must be >= 1"
                if self.spse_tolerance < 0:
                    return "spse_tolerance must be >= 0"
        if pt == PreconditionerType.SUBSET and not (
            self.residual_blocks_for_subset_preconditioner
        ):
            return (
                "When using SUBSET preconditioner, "
                "residual_blocks_for_subset_preconditioner cannot be empty"
            )
        return None

    def _validate_line_search(self) -> Optional[str]:
        """LineSearchOptionsAreValid (solver.cc:454-503)."""
        if self.max_lbfgs_rank <= 0:
            return "max_lbfgs_rank must be > 0"
        if self.min_line_search_step_size <= 0:
            return "min_line_search_step_size must be > 0"
        if not (0.0 < self.max_line_search_step_contraction < 1.0):
            return "max_line_search_step_contraction must be in (0, 1)"
        if not (
            self.max_line_search_step_contraction
            < self.min_line_search_step_contraction
            <= 1.0
        ):
            return (
                "require max_line_search_step_contraction < "
                "min_line_search_step_contraction <= 1"
            )
        min_ls_iters = (
            0 if self.minimizer_type == MinimizerType.TRUST_REGION else 1
        )
        if self.max_num_line_search_step_size_iterations < min_ls_iters:
            return (
                "max_num_line_search_step_size_iterations must be >= "
                f"{min_ls_iters}"
            )
        if self.line_search_sufficient_function_decrease <= 0:
            return "line_search_sufficient_function_decrease must be > 0"
        if not (
            self.line_search_sufficient_function_decrease
            < self.line_search_sufficient_curvature_decrease
            < 1.0
        ):
            return (
                "require line_search_sufficient_function_decrease < "
                "line_search_sufficient_curvature_decrease < 1"
            )
        if self.max_line_search_step_expansion <= 1.0:
            return "max_line_search_step_expansion must be > 1"
        if (
            self.line_search_direction_type
            in (LineSearchDirectionType.BFGS, LineSearchDirectionType.LBFGS)
            and self.line_search_type != LineSearchType.WOLFE
        ):
            return (
                "When using (L)BFGS, line_search_type must be WOLFE "
                "(solver.cc:471-484)"
            )
        return None

    def resolved_linear_solver_type(self, problem_info) -> LinearSolverType:
        if self.linear_solver_type is not None:
            return self.linear_solver_type
        # Auto (preprocessor heuristic): dense for small tangent spaces,
        # CGNR otherwise (the reference defaults to sparse Cholesky,
        # trust_region_preprocessor.cc:160-260; here that path is a host
        # solve per step, so the matrix-free CGNR stays on the device).
        if problem_info <= 1024:
            return LinearSolverType.DENSE_NORMAL_CHOLESKY
        return LinearSolverType.CGNR


@dataclasses.dataclass
class SolverSummary:
    """Analog of Solver::Summary (solver.h:818-1106)."""

    termination_type: TerminationType = TerminationType.FAILURE
    message: str = ""
    initial_cost: float = 0.0
    final_cost: float = 0.0
    fixed_cost: float = 0.0
    iterations: List = dataclasses.field(default_factory=list)
    num_parameter_blocks: int = 0
    num_parameters: int = 0
    num_effective_parameters: int = 0
    num_residual_blocks: int = 0
    num_residuals: int = 0
    num_successful_steps: int = 0
    num_unsuccessful_steps: int = 0
    num_inner_iteration_steps: int = 0
    # Linear solves that terminated with FAILURE (breakdown /
    # indefiniteness; each becomes an invalid step) — linear_solver.h:57-74.
    num_linear_solver_failures: int = 0
    # Total inner (CG/Krylov) iterations across the solve.
    num_linear_solver_iterations: int = 0
    preprocessor_time_in_seconds: float = 0.0
    minimizer_time_in_seconds: float = 0.0
    postprocessor_time_in_seconds: float = 0.0
    total_time_in_seconds: float = 0.0
    # Per-phase minimizer times (solver.h:967-1006 / solver.cc:890-960
    # FullReport time table). On the fused one-call-per-iteration path
    # the evaluation is inside the step computation, so its time is
    # accounted under the linear solver (see trust_region.py).
    residual_evaluation_time_in_seconds: float = 0.0
    jacobian_evaluation_time_in_seconds: float = 0.0
    linear_solver_time_in_seconds: float = 0.0
    inner_iteration_time_in_seconds: float = 0.0
    num_residual_evaluations: int = 0
    num_jacobian_evaluations: int = 0
    num_linear_solves: int = 0
    # Phase log (EventLogger) and the Evaluator's ExecutionSummary,
    # attached post-solve for programmatic inspection.
    event_log: Optional[object] = None
    evaluator_statistics: Optional[object] = None
    linear_solver_type_used: Optional[LinearSolverType] = None
    preconditioner_type_used: Optional[PreconditionerType] = None
    trust_region_strategy_type_used: Optional[TrustRegionStrategyType] = None
    evaluation_dtype: Optional[str] = None
    num_devices: int = 1
    minimizer_type: MinimizerType = MinimizerType.TRUST_REGION
    trust_region_strategy_type: TrustRegionStrategyType = (
        TrustRegionStrategyType.LEVENBERG_MARQUARDT
    )

    def is_solution_usable(self) -> bool:
        """solver.h IsSolutionUsable."""
        return self.termination_type in (
            TerminationType.CONVERGENCE,
            TerminationType.NO_CONVERGENCE,
            TerminationType.USER_SUCCESS,
        )

    def brief_report(self) -> str:
        """Analog of Summary::BriefReport (solver.cc:864)."""
        return (
            f"ceres_tpu Solver Report: Iterations: {len(self.iterations)}, "
            f"Initial cost: {self.initial_cost:e}, "
            f"Final cost: {self.final_cost:e}, "
            f"Termination: {self.termination_type}"
        )

    def full_report(self) -> str:
        """Analog of Summary::FullReport (solver.cc:890-960)."""
        lines = [
            "",
            "Solver Summary (ceres_tpu)",
            "",
            f"{'Parameter blocks':<30}{self.num_parameter_blocks:>12}",
            f"{'Parameters':<30}{self.num_parameters:>12}",
            f"{'Effective parameters':<30}{self.num_effective_parameters:>12}",
            f"{'Residual blocks':<30}{self.num_residual_blocks:>12}",
            f"{'Residuals':<30}{self.num_residuals:>12}",
            "",
            f"{'Minimizer type':<30}{str(self.minimizer_type):>12}",
            f"{'Trust region strategy':<30}"
            f"{str(self.trust_region_strategy_type_used):>12}",
            f"{'Linear solver':<30}"
            f"{str(self.linear_solver_type_used):>12}",
            f"{'Preconditioner':<30}"
            f"{str(self.preconditioner_type_used):>12}",
            f"{'Evaluation dtype':<30}"
            f"{str(self.evaluation_dtype or 'float64'):>12}",
            f"{'Devices':<30}{self.num_devices:>12}",
            "",
            f"{'Initial cost':<30}{self.initial_cost:>12.6e}",
            f"{'Final cost':<30}{self.final_cost:>12.6e}",
            f"{'Fixed cost':<30}{self.fixed_cost:>12.6e}",
            "",
            f"{'Successful steps':<30}{self.num_successful_steps:>12}",
            f"{'Unsuccessful steps':<30}{self.num_unsuccessful_steps:>12}",
            f"{'Linear solver failures':<30}{self.num_linear_solver_failures:>12}",
            f"{'Linear solver iterations':<30}"
            f"{self.num_linear_solver_iterations:>12}",
            "",
            "Time (in seconds):",
            f"{'Preprocessor':<34}{self.preprocessor_time_in_seconds:>10.4f}",
            "",
            f"  {'Residual only evaluation':<28}"
            f"{self.residual_evaluation_time_in_seconds:>14.4f}"
            f" ({self.num_residual_evaluations})",
            f"  {'Jacobian & residual evaluation':<28}"
            f"{self.jacobian_evaluation_time_in_seconds:>14.4f}"
            f" ({self.num_jacobian_evaluations})",
            f"  {'Linear solver':<28}"
            f"{self.linear_solver_time_in_seconds:>14.4f}"
            f" ({self.num_linear_solves})",
            f"  {'Inner iterations':<28}"
            f"{self.inner_iteration_time_in_seconds:>14.4f}"
            f" ({self.num_inner_iteration_steps})",
            f"{'Minimizer':<34}{self.minimizer_time_in_seconds:>10.4f}",
            "",
            f"{'Postprocessor':<34}"
            f"{self.postprocessor_time_in_seconds:>10.4f}",
            f"{'Total':<34}{self.total_time_in_seconds:>10.4f}",
            "",
            f"Termination: {self.termination_type} ({self.message})",
        ]
        return "\n".join(lines)


def solve(options: SolverOptions, problem: Problem) -> SolverSummary:
    """Analog of ceres::Solve (solver.cc:857, Solver::Solve solver.cc:734).

    Solves in place: final parameter values are written back into the
    problem's parameter blocks.
    """
    from ceres_tpu.utils.observability import EventLogger

    total_t0 = time.time()
    summary = SolverSummary()
    summary.minimizer_type = options.minimizer_type
    summary.trust_region_strategy_type = options.trust_region_strategy_type
    # Scoped phase log (event_logger.h:41-75); attached to the summary so
    # callers can inspect phase deltas programmatically.
    event_logger = EventLogger("Solver::Solve")
    summary.event_log = event_logger

    # Preprocess: freeze program, resolve config (solver.cc:789-793).
    pre_t0 = time.time()
    program = problem.program()
    summary.num_parameter_blocks = program.num_parameter_blocks()
    summary.num_parameters = program.num_ambient
    summary.num_effective_parameters = program.num_tangent
    summary.num_residual_blocks = program.num_residual_blocks()
    summary.num_residuals = program.num_residuals()
    # Cost of residual blocks dropped by the reduced program
    # (program.cc:291-415): constant for the whole solve.
    summary.fixed_cost = program.fixed_cost

    err = options.validate(program.num_tangent)
    if err is not None:
        summary.termination_type = TerminationType.FAILURE
        summary.message = f"Invalid options: {err}"
        return summary

    if program.num_tangent == 0 or program.num_residuals() == 0:
        # All blocks constant / no residual blocks: nothing to optimize
        # (solver.cc:795-812; the reference terminates with CONVERGENCE
        # and the message below, solver_test.cc:235-327).
        c = program.fixed_cost
        if program.num_residuals() > 0:
            from ceres_tpu.evaluator import Evaluator

            ev = Evaluator(program)
            c += float(ev.cost(program.initial_ambient()))
        summary.initial_cost = summary.final_cost = c
        summary.termination_type = TerminationType.CONVERGENCE
        summary.message = (
            "Function tolerance reached. "
            "No non-constant parameter blocks found."
        )
        summary.total_time_in_seconds = time.time() - total_t0
        return summary

    if not program.is_feasible():
        summary.termination_type = TerminationType.FAILURE
        summary.message = "Initial point infeasible (violates bounds)."
        return summary

    resolved = dataclasses.replace(
        options,
        linear_solver_type=options.resolved_linear_solver_type(
            program.num_tangent
        ),
    )
    summary.linear_solver_type_used = resolved.linear_solver_type
    summary.preconditioner_type_used = resolved.preconditioner_type
    summary.trust_region_strategy_type_used = (
        resolved.trust_region_strategy_type
    )
    summary.evaluation_dtype = options.evaluation_dtype
    if options.mesh is not None:
        summary.num_devices = int(np.prod(list(options.mesh.shape.values())))

    if options.evaluation_dtype is not None:
        from ceres_tpu.problem import cast_program

        cast_program(program, options.evaluation_dtype)

    if options.mesh is not None:
        # Shard residual families over the mesh — the analog of
        # context()->EnsureMinimumThreads (solver.cc:787).
        from ceres_tpu.parallel import shard_program

        shard_program(program, options.mesh)

    if options.check_gradients:
        from ceres_tpu.gradient_checker import check_problem_gradients

        ok, msg = check_problem_gradients(
            problem, options.gradient_check_relative_precision
        )
        if not ok:
            summary.termination_type = TerminationType.FAILURE
            summary.message = f"Gradient check failed: {msg}"
            return summary

    summary.preprocessor_time_in_seconds = time.time() - pre_t0
    event_logger.add_event("Preprocess")

    # Minimize.
    min_t0 = time.time()
    x0 = program.initial_ambient()
    if options.evaluation_dtype is not None:
        import jax.numpy as jnp

        x0 = x0.astype(jnp.dtype(options.evaluation_dtype))
    if options.mesh is not None:
        from ceres_tpu.parallel import replicate

        x0 = replicate(x0, options.mesh)
    minimizer = None
    if options.minimizer_type == MinimizerType.TRUST_REGION:
        from ceres_tpu.fused_lm import (
            fused_traced_eligible,
            minimize_fused_traced,
        )
        from ceres_tpu.trust_region import (
            TrustRegionMinimizer,
            _config_from_options,
        )

        # Fast path: when no option needs host work inside the loop, the
        # whole minimize runs as ONE device computation with a per-
        # iteration trace, and the Summary/IterationSummary records are
        # reconstructed from the trace — identical bookkeeping, one
        # host round-trip total instead of one per iteration.
        _cfg = _config_from_options(resolved, program)
        if fused_traced_eligible(resolved, program, _cfg):
            x_final = minimize_fused_traced(resolved, program, x0, summary)
        else:
            minimizer = TrustRegionMinimizer(program, resolved, summary)
            x_final = minimizer.minimize(x0)
    else:
        from ceres_tpu.line_search import LineSearchMinimizer

        minimizer = LineSearchMinimizer(program, resolved, summary)
        x_final = minimizer.minimize(x0)
    summary.minimizer_time_in_seconds = time.time() - min_t0
    event_logger.add_event("Minimize")

    # Statistics from the evaluator (Evaluator::Statistics,
    # program_evaluator.h:143-147): fold the line-search/gradient-probe
    # evaluations the minimizer routed through the Evaluator into the
    # summary counters (the trust-region loop accounts its own fused
    # calls directly).
    ev = getattr(minimizer, "evaluator", None) if minimizer else None
    if ev is not None and hasattr(ev, "execution_summary"):
        es = ev.execution_summary
        if options.minimizer_type != MinimizerType.TRUST_REGION:
            summary.num_residual_evaluations += es.calls.get(
                "Evaluator::Residual", 0
            )
            summary.residual_evaluation_time_in_seconds += es.times.get(
                "Evaluator::Residual", 0.0
            )
            summary.num_jacobian_evaluations += es.calls.get(
                "Evaluator::Gradient", 0
            ) + es.calls.get("Evaluator::Jacobian", 0)
            summary.jacobian_evaluation_time_in_seconds += es.times.get(
                "Evaluator::Gradient", 0.0
            ) + es.times.get("Evaluator::Jacobian", 0.0)
        summary.evaluator_statistics = es

    # Postprocess (solver.cc:834-855).
    post_t0 = time.time()
    if summary.iterations:
        summary.initial_cost = summary.iterations[0].cost
        summary.final_cost = min(i.cost for i in summary.iterations)
        summary.num_successful_steps = sum(
            1 for i in summary.iterations if i.step_is_successful
        )
        summary.num_unsuccessful_steps = sum(
            1 for i in summary.iterations if not i.step_is_successful
        )
        # Total inner linear-solver (CG/Krylov) iterations, accumulated
        # from the per-iteration records the way the reference's Summary
        # reports num_linear_solves/iterations (solver.cc:890-960).
        summary.num_linear_solver_iterations = sum(
            i.linear_solver_iterations for i in summary.iterations
        )
    if summary.is_solution_usable():
        problem.write_back(x_final)
    summary.postprocessor_time_in_seconds = time.time() - post_t0
    summary.total_time_in_seconds = time.time() - total_t0
    event_logger.finish()
    return summary
