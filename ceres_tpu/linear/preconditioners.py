"""Preconditioners for the iterative solvers.

JAX analog of ``internal/ceres/preconditioner.h:51`` and
``block_jacobi_preconditioner.{h,cc}``. The block-Jacobi preconditioner
inverts the block diagonal of J'J + D'D: blocks are grouped by tangent size
into (G, T, T) batches, factorized with one vmapped Cholesky per size group
(one batched op instead of the reference's per-block loop).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp

from ceres_tpu.evaluator import JacobianContext


def identity_preconditioner() -> Callable[[jax.Array], jax.Array]:
    """preconditioner.h IdentityPreconditioner."""
    return lambda v: v


def scalar_jacobi_preconditioner(
    ctx: JacobianContext, D: Optional[jax.Array] = None
) -> Callable[[jax.Array], jax.Array]:
    """M = diag(J'J + D'D)^-1 — cheapest option."""
    d = ctx.squared_column_norms()
    if D is not None:
        d = d + D * D
    inv = 1.0 / jnp.maximum(d, 1e-300)
    return lambda v: inv * v


def block_jacobi_preconditioner(
    ctx: JacobianContext,
    bd_groups: Dict[int, jax.Array],
    D: Optional[jax.Array] = None,
) -> Callable[[jax.Array], jax.Array]:
    """M = blockdiag(J'J + D'D)^-1 (block_jacobi_preconditioner.h:55).

    ``bd_groups`` maps tangent size T -> (G_T, T) int32 tangent-index
    matrix (Program.bd_groups). Factorizations are batched per size group.
    """
    from ceres_tpu.ops.small_linalg import spd_inverse

    slice_of = getattr(bd_groups, "slice_of", lambda _T: None)

    def rows_of(v, T, idx):
        # contiguous group -> slice+reshape (free to compile) instead of
        # a 200k-row 2-D gather, which is slow to compile.
        sl = slice_of(T)
        if sl is not None:
            start, G = sl
            return jax.lax.dynamic_slice(v, (start,), (G * T,)).reshape(
                G, T
            )
        return v[jnp.asarray(idx)]

    group_sizes = {T: idx.shape[0] for T, idx in bd_groups.items()}
    blocks = ctx.block_jtj(group_sizes)
    inverses = {}
    for T, idx in bd_groups.items():
        mat = blocks[T]
        if D is not None:
            Db = rows_of(D, T, idx)  # (G, T)
            mat = mat + jax.vmap(jnp.diag)(Db * Db)
        # Closed-form/unrolled SPD inverses (invert_psd_matrix.h analog):
        # the apply becomes one einsum instead of a batched
        # TriangularSolve of tiny blocks inside the CG loop.
        inverses[T] = spd_inverse(mat)

    def apply(v: jax.Array) -> jax.Array:
        out = jnp.zeros_like(v)
        for T, idx in bd_groups.items():
            vb = rows_of(v, T, idx)  # (G, T)
            sol = jnp.einsum("gij,gj->gi", inverses[T], vb)
            sl = slice_of(T)
            if sl is not None:
                start, G = sl
                out = jax.lax.dynamic_update_slice(
                    out, sol.reshape(G * T).astype(out.dtype), (start,)
                )
            else:
                out = out.at[jnp.asarray(idx)].set(sol)
        return out

    return apply


def subset_preconditioner(
    ctx: JacobianContext,
    subset_masks,
    D: Optional[jax.Array] = None,
) -> Callable[[jax.Array], jax.Array]:
    """M = (J_subset' J_subset + D'D)^-1 for a user-chosen subset of
    residual rows (subset_preconditioner.h:44-80): useful when a small
    well-conditioned subset (e.g. odometry residuals in SLAM) captures
    the spectrum of the full problem. ``subset_masks`` is a per-family
    (B,) 0/1 array selecting member instances.

    The reference factors the subset normal matrix with sparse Cholesky;
    here it is one dense assembly via masked scatter-adds + one dense
    Cholesky — the accelerator trade (SURVEY.md §7 hard part (b)).
    """
    n = ctx.num_tangent
    dt = ctx.residuals[0].dtype
    H = jnp.zeros((n + 1, n + 1), dtype=dt)
    for fi, fam in enumerate(ctx.families):
        m = subset_masks[fi]
        if m is None:
            continue
        for j in range(fam.num_args):
            Jm_j = ctx.jacs[fi][j] * m[:, None, None]
            tj = fam.tangent_idx[j]
            for k in range(fam.num_args):
                Jk = ctx.jacs[fi][k]
                tk = fam.tangent_idx[k]
                contrib = jnp.einsum("bri,brj->bij", Jm_j, Jk)
                H = H.at[tj[:, :, None], tk[:, None, :]].add(
                    contrib, mode="drop"
                )
    H = H[:n, :n]
    if D is not None:
        H = H + jnp.diag(D * D)
    chol, low = jax.scipy.linalg.cho_factor(H, lower=True)

    def apply(v: jax.Array) -> jax.Array:
        return jax.scipy.linalg.cho_solve((chol, low), v)

    return apply
