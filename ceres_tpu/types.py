"""Enums and shared type vocabulary.

JAX analog of the reference's ``include/ceres/types.h:57-467``: the
same solver/preconditioner/strategy/termination vocabulary, expressed as
Python enums with string round-tripping (``types.cc`` StringToXxxType).
"""

from __future__ import annotations

import enum


class _StrEnum(enum.Enum):
    """Enum with case-insensitive string conversion, like types.cc:60-466."""

    def __str__(self) -> str:  # pragma: no cover - trivial
        return self.name

    @classmethod
    def from_string(cls, name: str):
        try:
            return cls[name.strip().upper()]
        except KeyError:
            raise ValueError(
                f"Unknown {cls.__name__}: {name!r}; "
                f"valid: {[m.name for m in cls]}"
            ) from None


class LinearSolverType(_StrEnum):
    """Analog of LinearSolverType (types.h:57-88)."""

    DENSE_NORMAL_CHOLESKY = enum.auto()
    DENSE_QR = enum.auto()
    SPARSE_NORMAL_CHOLESKY = enum.auto()
    DENSE_SCHUR = enum.auto()
    SPARSE_SCHUR = enum.auto()
    ITERATIVE_SCHUR = enum.auto()
    CGNR = enum.auto()


class LinearSolverOrderingType(_StrEnum):
    """Fill-reducing ordering for the host sparse factorization
    (types.h:204-209): AMD = approximate minimum degree (here: the
    native core's lazy-heap minimum-degree analog), NESDIS = nested
    dissection (here: recursive BFS-separator bisection)."""

    AMD = enum.auto()
    NESDIS = enum.auto()


class PreconditionerType(_StrEnum):
    """Analog of PreconditionerType (types.h:93-119)."""

    IDENTITY = enum.auto()
    JACOBI = enum.auto()
    SCHUR_JACOBI = enum.auto()
    SCHUR_POWER_SERIES_EXPANSION = enum.auto()
    CLUSTER_JACOBI = enum.auto()
    CLUSTER_TRIDIAGONAL = enum.auto()
    SUBSET = enum.auto()


class TrustRegionStrategyType(_StrEnum):
    """Analog of TrustRegionStrategyType (types.h)."""

    LEVENBERG_MARQUARDT = enum.auto()
    DOGLEG = enum.auto()


class DoglegType(_StrEnum):
    """Analog of DoglegType (types.h): traditional vs 2D subspace dogleg."""

    TRADITIONAL_DOGLEG = enum.auto()
    SUBSPACE_DOGLEG = enum.auto()


class MinimizerType(_StrEnum):
    TRUST_REGION = enum.auto()
    LINE_SEARCH = enum.auto()


class LineSearchDirectionType(_StrEnum):
    """Analog of LineSearchDirectionType (types.h)."""

    STEEPEST_DESCENT = enum.auto()
    NONLINEAR_CONJUGATE_GRADIENT = enum.auto()
    LBFGS = enum.auto()
    BFGS = enum.auto()


class NonlinearConjugateGradientType(_StrEnum):
    FLETCHER_REEVES = enum.auto()
    POLAK_RIBIERE = enum.auto()
    HESTENES_STIEFEL = enum.auto()


class LineSearchType(_StrEnum):
    ARMIJO = enum.auto()
    WOLFE = enum.auto()


class LineSearchInterpolationType(_StrEnum):
    BISECTION = enum.auto()
    QUADRATIC = enum.auto()
    CUBIC = enum.auto()


class TerminationType(_StrEnum):
    """Analog of TerminationType (types.h:359-411)."""

    CONVERGENCE = enum.auto()
    NO_CONVERGENCE = enum.auto()
    FAILURE = enum.auto()
    USER_SUCCESS = enum.auto()
    USER_FAILURE = enum.auto()


class CallbackReturnType(_StrEnum):
    """Analog of CallbackReturnType (types.h)."""

    SOLVER_CONTINUE = enum.auto()
    SOLVER_ABORT = enum.auto()
    SOLVER_TERMINATE_SUCCESSFULLY = enum.auto()


class LinearSolverTerminationType(_StrEnum):
    """Analog of LinearSolverTerminationType (linear_solver.h:57-74)."""

    NO_CONVERGENCE = enum.auto()
    SUCCESS = enum.auto()
    FAILURE = enum.auto()
    FATAL_ERROR = enum.auto()


class NumericDiffMethodType(_StrEnum):
    """Analog of NumericDiffMethodType (types.h)."""

    CENTRAL = enum.auto()
    FORWARD = enum.auto()
    RIDDERS = enum.auto()


class CovarianceAlgorithmType(_StrEnum):
    """Analog of CovarianceAlgorithmType (covariance.h)."""

    DENSE_SVD = enum.auto()
    SPARSE_QR = enum.auto()


class LoggingType(_StrEnum):
    SILENT = enum.auto()
    PER_MINIMIZER_ITERATION = enum.auto()
