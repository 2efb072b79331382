"""Post-solve covariance estimation.

JAX analog of ``include/ceres/covariance.h:247-470`` and
``internal/ceres/covariance_impl.cc``: computes blocks of
inverse(J'J) at the solution. Two algorithms:

- DENSE_SVD (covariance_impl.cc:705): SVD of the dense Jacobian with
  reciprocal-condition-number thresholding and null-space handling —
  the rank-deficient-safe path.
- SPARSE_QR analog (covariance_impl.cc:536,796): the reference factors J
  with SuiteSparse/Eigen QR; here one dense QR of the (tall)
  Jacobian — XLA QR runs on device — which serves the same
  full-rank fast path.

Covariance blocks are returned in tangent space and lifted to ambient
space through the manifold plus-Jacobian when requested
(covariance_impl.cc:129-277 GetCovarianceBlockInTangentOrAmbientSpace).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ceres_tpu.problem import Problem
from ceres_tpu.types import CovarianceAlgorithmType

# Above this tangent dimension the dense-J algorithms are infeasible and
# the scalable paths (Schur marginals, matrix-free CG) take over.
DENSE_COVARIANCE_MAX_TANGENT = 4096


@dataclasses.dataclass
class CovarianceOptions:
    """Analog of Covariance::Options (covariance.h:247-360)."""

    algorithm_type: CovarianceAlgorithmType = CovarianceAlgorithmType.SPARSE_QR
    min_reciprocal_condition_number: float = 1e-14
    null_space_rank: int = 0
    apply_loss_function: bool = True

    def __post_init__(self):
        if isinstance(self.algorithm_type, str):
            self.algorithm_type = CovarianceAlgorithmType.from_string(
                self.algorithm_type
            )


class Covariance:
    """Analog of ceres::Covariance (covariance.h)."""

    def __init__(self, options: Optional[CovarianceOptions] = None):
        self.options = options or CovarianceOptions()
        self._cov_tangent: Optional[np.ndarray] = None
        self._schur_cov: Optional[np.ndarray] = None
        self._schur_pos = None
        self._mf_Z: Optional[np.ndarray] = None  # matrix-free columns (n, k)
        self._mf_pos = None  # tangent coord -> column index in _mf_Z
        self._program = None
        self._problem = None

    def compute(
        self,
        covariance_blocks: List[Tuple[int, int]],
        problem: Problem,
    ) -> bool:
        """Compute covariance for the requested block pairs.

        The reference computes only the requested sparsity
        (covariance_impl.cc:361); at moderate sizes the full tangent
        covariance is one device matmul, so we form inverse(J'J) once and
        slice blocks out of it.
        """
        from ceres_tpu.evaluator import Evaluator

        self._cov_tangent = None
        self._schur_cov = None
        self._schur_pos = None
        self._mf_Z = None
        self._mf_pos = None
        self._problem = problem
        program = problem.program()
        self._program = program
        ev = Evaluator(program, apply_loss_function=self.options.apply_loss_function)
        full = ev.cost_gradient_jacobian(program.initial_ambient())

        # Large problems: dense J'J inversion is infeasible; when every
        # requested block is an f-block (cameras) of a Schur-structured
        # problem, the exact marginal covariance of the f-blocks is
        # S^{-1} (points marginalized out) — computed from the reduced
        # camera system. The scalable BA covariance path (the reference
        # needs SuiteSparseQR of the full Jacobian here).
        if program.num_tangent > DENSE_COVARIANCE_MAX_TANGENT or self._requested_schur(
            covariance_blocks, program
        ):
            ok = self._compute_schur_marginals(
                covariance_blocks, program, full
            )
            if ok is not None:
                return ok

        # Scalable generic path: when the dense-J algorithms are
        # infeasible (large tangent space) and specific blocks were
        # requested, solve (J'J) z = e_k matrix-free per requested
        # column with preconditioned CG — the reference computes only
        # the requested sparsity with sparse QR
        # (covariance_impl.cc:361,536-796); this is the O(nnz)-memory
        # analog.
        if (
            self.options.algorithm_type == CovarianceAlgorithmType.SPARSE_QR
            and covariance_blocks
            and program.num_tangent > DENSE_COVARIANCE_MAX_TANGENT
        ):
            ok = self._compute_matrix_free(covariance_blocks, program, full)
            if ok is not None:
                return ok

        del covariance_blocks  # full tangent covariance is computed
        J = np.asarray(full.jacobian_context.to_dense())

        opts = self.options
        if opts.algorithm_type == CovarianceAlgorithmType.DENSE_SVD:
            # covariance_impl.cc:705-760: SVD of J, invert singular values
            # above the threshold; drop null_space_rank smallest.
            # full_matrices so a wide/rank-deficient J exposes its zero
            # singular values (rank < num_cols must be detected).
            _, s, vt = np.linalg.svd(J, full_matrices=True)
            n = vt.shape[0]
            if n == 0:
                return False
            s = np.concatenate([s, np.zeros(n - s.shape[0])])
            max_sv = s[0]
            eps = opts.min_reciprocal_condition_number
            inv_s2 = np.zeros_like(s)
            for i in range(n):
                if opts.null_space_rank < 0:
                    # covariance_impl.cc: null_space_rank = -1 means drop
                    # every singular value below the automatic threshold.
                    keep = s[i] > np.sqrt(eps) * max_sv if max_sv > 0 else False
                    if not keep:
                        continue
                elif opts.null_space_rank == 0:
                    keep = s[i] > np.sqrt(eps) * max_sv if max_sv > 0 else False
                else:
                    keep = i < n - opts.null_space_rank
                if keep and s[i] > 0:
                    inv_s2[i] = 1.0 / (s[i] * s[i])
                elif opts.null_space_rank == 0 and s[i] <= np.sqrt(eps) * max_sv:
                    # Rank deficiency without explicit null space handling
                    # is an error in the reference.
                    return False
            self._cov_tangent = (vt.T * inv_s2) @ vt
            return True

        # SPARSE_QR analog: QR of J, covariance = R^-1 R^-T.
        if J.shape[0] < J.shape[1]:
            # Underdetermined: J'J is singular; SuiteSparseQR reports
            # rank deficiency and the reference fails the computation
            # (covariance_impl.cc:536-580).
            return False
        R = np.linalg.qr(J, mode="r")
        diag = np.abs(np.diag(R))
        if diag.size == 0 or np.min(diag) == 0.0:
            return False
        if np.min(diag) / np.max(diag) < opts.min_reciprocal_condition_number:
            return False
        Rinv = np.linalg.solve(R, np.eye(R.shape[0]))
        self._cov_tangent = Rinv @ Rinv.T
        return True

    def _requested_schur(self, covariance_blocks, program) -> bool:
        """True if the user explicitly asked for the Schur marginal path
        by requesting only non-eliminated (camera) blocks of a problem
        that has a cached Schur structure."""
        ss = getattr(program, "_schur_structure", None)
        if ss is None or not covariance_blocks:
            return False
        e_coords = set(int(v) for v in np.asarray(ss.e_group).reshape(-1))
        for p1, p2 in covariance_blocks:
            for pid in (p1, p2):
                off = program.tangent_offset.get(pid)
                if off is None or off in e_coords:
                    return False
        return True

    def _compute_schur_marginals(self, covariance_blocks, program, full):
        """Camera-marginal covariance via inverse of the (damping-free)
        Schur complement S = F'F - F'E (E'E)^{-1} E'F. Returns True/False
        on success/failure, or None to fall through to the dense path."""
        import jax.numpy as jnp

        from ceres_tpu.linear.schur import (
            SchurOperator,
            build_schur_structure,
            ensure_explicit_plan,
        )

        try:
            ss = getattr(program, "_schur_structure", None)
            if ss is None:
                ss = build_schur_structure(program)
                program._schur_structure = ss
            ensure_explicit_plan(program, ss)
        except ValueError:
            return None  # no Schur structure — dense path
        ctx = full.jacobian_context
        tiny = jnp.full(
            (program.num_tangent,), 1e-150, dtype=ctx.residuals[0].dtype
        )
        op = SchurOperator(ctx, tiny, ss)
        S, _, f_idx = op.dense_reduced_system()
        S = np.asarray(S, dtype=np.float64)
        diag = np.abs(np.diag(S))
        if diag.size == 0 or np.min(diag) <= 0:
            return False
        try:
            # SPD gate: a gauge-deficient problem (un-fixed BA similarity
            # freedom) has singular S — refuse like the reference refuses
            # rank deficiency without null_space_rank
            # (covariance_impl.cc:705-760).
            np.linalg.cholesky(S)
            rcond = np.min(diag) / np.max(diag)
            if rcond < self.options.min_reciprocal_condition_number:
                # Conditioning gate matching the reference's rank /
                # min_reciprocal_condition_number refusal.
                return False
            S_inv = np.linalg.inv(S)
            # residual check catches numerically singular S
            err = np.linalg.norm(S @ S_inv - np.eye(S.shape[0]), ord=np.inf)
            if not np.isfinite(err) or err > 1e-4:
                return False
        except np.linalg.LinAlgError:
            return False
        # embed into a sparse map: tangent coord -> position in f_idx
        self._cov_tangent = None
        self._schur_cov = S_inv
        self._schur_pos = {
            int(c): i for i, c in enumerate(np.asarray(f_idx))
        }
        return True

    def _compute_matrix_free(self, covariance_blocks, program, full):
        """Scalable generic covariance: columns of inverse(J'J) via
        Jacobi-preconditioned CG on the normal equations, matrix-free
        (JacobianContext.normal_matvec) — O(nnz) memory, no dense J.
        The analog of the reference computing only the requested
        covariance sparsity with sparse QR (covariance_impl.cc:361,536).
        Returns True/False on success/failure, or None to fall through.
        """
        from ceres_tpu.linear.cg import CG_SUCCESS, conjugate_gradients

        ctx = full.jacobian_context
        n = program.num_tangent

        # Union of tangent coords needed as columns (second block of each
        # pair; rows come free because inverse(J'J) columns are full).
        cols: List[int] = []
        seen = set()
        for p1, p2 in covariance_blocks:
            s1, _ = self._tangent_slice(p1)
            s2, _ = self._tangent_slice(p2)
            if s1 is None or s2 is None:
                continue  # constant block: zero covariance, no solve
            for c in range(s2.start, s2.stop):
                if c not in seen:
                    seen.add(c)
                    cols.append(c)
        cols.sort()
        if not cols:
            self._mf_Z = np.zeros((n, 0))
            self._mf_pos = {}
            return True

        d = np.asarray(ctx.squared_column_norms(), dtype=np.float64)
        if not np.all(np.isfinite(d)) or np.any(d <= 0.0):
            # A zero column of J means J'J is singular — the reference
            # reports rank deficiency and fails (covariance_impl.cc:536).
            return False
        dtype = ctx.dtype
        inv_d = jnp.asarray(1.0 / d, dtype=dtype)
        max_iters = int(min(10 * n, 20_000))

        def solve_one(e):
            res = conjugate_gradients(
                ctx.normal_matvec,
                e,
                preconditioner=lambda v: v * inv_d,
                max_num_iterations=max_iters,
                min_num_iterations=1,
                r_tolerance=1e-10,
                residual_reset_period=100,
            )
            return res.x, res.termination

        solve_batch = jax.jit(jax.vmap(solve_one))

        K = 8  # columns per batched CG solve
        Z = np.zeros((n, len(cols)), dtype=np.float64)
        for start in range(0, len(cols), K):
            chunk = cols[start : start + K]
            E = np.zeros((K, n), dtype=np.float64)
            for j, c in enumerate(chunk):
                E[j, c] = 1.0
            xs, terms = solve_batch(jnp.asarray(E, dtype=dtype))
            terms = np.asarray(terms)
            if not np.all(terms[: len(chunk)] == CG_SUCCESS):
                # CG breakdown/indefiniteness or no convergence: treat as
                # rank deficiency like the reference's QR failure.
                return False
            Z[:, start : start + len(chunk)] = (
                np.asarray(xs[: len(chunk)], dtype=np.float64).T
            )
        self._mf_Z = Z
        self._mf_pos = {c: i for i, c in enumerate(cols)}
        return True

    def _block_from_mf(self, s1, s2):
        pos = self._mf_pos
        i2 = [pos.get(c) for c in range(s2.start, s2.stop)]
        if all(i is not None for i in i2):
            return self._mf_Z[s1, :][:, i2].copy()
        # Symmetric fallback: the transposed pair was requested.
        i1 = [pos.get(c) for c in range(s1.start, s1.stop)]
        if all(i is not None for i in i1):
            return self._mf_Z[s2, :][:, i1].T.copy()
        raise RuntimeError(
            "matrix-free covariance holds only block pairs passed to "
            "compute(); request this pair in covariance_blocks"
        )

    # -- block access --------------------------------------------------------

    def _tangent_slice(self, pid: int):
        program = self._program
        rec = program._problem._param_blocks[pid]
        if rec.constant:
            return None, rec
        off = program.tangent_offset[pid]
        return slice(off, off + rec.tangent_size), rec

    def _block_from_schur(self, s1, s2, rec1, rec2):
        pos = self._schur_pos
        try:
            i1 = [pos[c] for c in range(s1.start, s1.stop)]
            i2 = [pos[c] for c in range(s2.start, s2.stop)]
        except KeyError:
            raise RuntimeError(
                "Schur-marginal covariance holds only non-eliminated "
                "(camera) blocks; request eliminated blocks with the "
                "dense algorithms"
            )
        return self._schur_cov[np.ix_(i1, i2)].copy()

    def get_covariance_block_in_tangent_space(
        self, pid1: int, pid2: int
    ) -> np.ndarray:
        """covariance.h GetCovarianceBlockInTangentSpace."""
        if (
            self._cov_tangent is None
            and self._schur_cov is None
            and self._mf_Z is None
        ):
            raise RuntimeError("call compute() first")
        s1, rec1 = self._tangent_slice(pid1)
        s2, rec2 = self._tangent_slice(pid2)
        if s1 is None or s2 is None:
            return np.zeros((rec1.tangent_size, rec2.tangent_size))
        if self._cov_tangent is not None:
            return self._cov_tangent[s1, s2].copy()
        if self._schur_cov is not None:
            return self._block_from_schur(s1, s2, rec1, rec2)
        return self._block_from_mf(s1, s2)

    def get_covariance_block(self, pid1: int, pid2: int) -> np.ndarray:
        """Ambient-space block: J_plus C J_plus' (covariance_impl.cc:129)."""
        if (
            self._cov_tangent is None
            and self._schur_cov is None
            and self._mf_Z is None
        ):
            raise RuntimeError("call compute() first")
        s1, rec1 = self._tangent_slice(pid1)
        s2, rec2 = self._tangent_slice(pid2)
        if s1 is None or s2 is None:
            return np.zeros((rec1.size, rec2.size))
        if self._cov_tangent is not None:
            C = self._cov_tangent[s1, s2]
        elif self._schur_cov is not None:
            C = self._block_from_schur(s1, s2, rec1, rec2)
        else:
            C = self._block_from_mf(s1, s2)

        def lift(rec):
            if rec.manifold is None:
                return None
            return np.asarray(
                rec.manifold.plus_jacobian(jnp.asarray(rec.values))
            )

        J1, J2 = lift(rec1), lift(rec2)
        if J1 is not None:
            C = J1 @ C
        if J2 is not None:
            C = C @ J2.T
        return C
