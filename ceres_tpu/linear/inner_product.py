"""Device-side assembly of the normal-equation blocks H = J'J.

JAX analog of the reference's ``InnerProductComputer``
(``inner_product_computer.h:64``): instead of shipping the whole block
Jacobian to the host every LM iteration (O(nnz(J)) transfer — the r3
SPARSE_NORMAL_CHOLESKY path), the DEVICE reduces the per-instance
``J_i' J_j`` products into the unique parameter-block-pair cells of H
with host-planned segment reductions, and only the reduced cell values
(O(nnz(H))) cross to the host, where the native simplicial Cholesky
factorizes (``sparse_normal_cholesky_solver.cc:51-120``).

Structure mirrors linear/sparse_schur.py: a host-built plan enumerates
cell sites (per family arg-pair, split diagonal / upper / transposed-to-
upper), a jitted pass computes the reduced blocks, and a host assembly
scalarizes them into upper-triangular CSC with one ``np.bincount``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ceres_tpu.ops.reduce import ReducePlan, apply_reduce, build_reduce_plan


@dataclasses.dataclass(frozen=True)
class NormalSite:
    """Cells for one (family, arg-pair, orientation) combination.

    ``transpose``: the per-instance contribution is J_{j1}'J_{j2}; for
    instances whose j1-block sits at a HIGHER tangent offset than the
    j2-block, the transposed block belongs in the upper triangle at the
    swapped cell — the device swaps axes before reduction.
    """

    fi: int
    j1: int
    j2: int
    diagonal: bool
    transpose: bool
    plan: ReducePlan
    rows: jax.Array  # (C, Tr) tangent coords of the cell's row block
    cols: jax.Array  # (C, Tc)


jax.tree_util.register_dataclass(
    NormalSite,
    data_fields=["plan", "rows", "cols"],
    meta_fields=["fi", "j1", "j2", "diagonal", "transpose"],
)


@dataclasses.dataclass
class NormalPlan:
    sites: Tuple[NormalSite, ...]
    num_tangent: int


jax.tree_util.register_dataclass(
    NormalPlan, data_fields=["sites"], meta_fields=["num_tangent"]
)


def build_normal_plan(program) -> NormalPlan:
    """Host-side: enumerate the unique block-pair cells of H per family
    arg-pair and build the segment-reduction plans (the symbolic half of
    inner_product_computer.cc ComputeOffsetsAndCreateResultMatrix)."""
    nt = program.num_tangent
    sites: List[NormalSite] = []
    for fi, fam in enumerate(program.families):
        # Host copies of the tangent index tables (B, T_j).
        tidx = [np.asarray(fam.tangent_idx[j]) for j in range(fam.num_args)]
        B = fam.batch
        for a in range(fam.num_args):
            for b in range(a, fam.num_args):
                t1, t2 = tidx[a], tidx[b]
                T1, T2 = t1.shape[1], t2.shape[1]
                o1, o2 = t1[:, 0].astype(np.int64), t2[:, 0].astype(np.int64)
                valid = (o1 < nt) & (o2 < nt)  # drop constant/padded
                same = valid & (o1 == o2)
                upper = valid & (o1 < o2)
                lower = valid & (o1 > o2)

                def make(sel, key_rows, key_cols, rows_src, cols_src,
                         diagonal, transpose):
                    idx = np.nonzero(sel)[0]
                    if idx.size == 0:
                        return
                    keys = list(
                        zip(key_rows[idx].tolist(), key_cols[idx].tolist())
                    )
                    uniq = {}
                    ids = np.empty(idx.size, dtype=np.int64)
                    for i, k in enumerate(keys):
                        if k not in uniq:
                            uniq[k] = len(uniq)
                        ids[i] = uniq[k]
                    C = len(uniq)
                    seg = np.full(B, C, dtype=np.int64)
                    seg[idx] = ids
                    Tr = rows_src.shape[1]
                    Tc = cols_src.shape[1]
                    rows = np.empty((C, Tr), dtype=np.int32)
                    cols = np.empty((C, Tc), dtype=np.int32)
                    # any representative instance per cell works: all
                    # instances of a cell share the same two blocks
                    first = np.full(C, -1, dtype=np.int64)
                    for i, cid in enumerate(ids):
                        if first[cid] < 0:
                            first[cid] = idx[i]
                    rows[:] = rows_src[first]
                    cols[:] = cols_src[first]
                    sites.append(
                        NormalSite(
                            fi=fi,
                            j1=a,
                            j2=b,
                            diagonal=diagonal,
                            transpose=transpose,
                            plan=build_reduce_plan(seg, C),
                            rows=jnp.asarray(rows),
                            cols=jnp.asarray(cols),
                        )
                    )

                make(same, o1, o2, t1, t2, True, False)
                make(upper, o1, o2, t1, t2, False, False)
                # transposed contribution placed at swapped cell
                make(lower, o2, o1, t2, t1, False, True)
    return NormalPlan(sites=tuple(sites), num_tangent=nt)


def compute_normal_cells(ctx, plan: NormalPlan):
    """Device pass: reduced H cell blocks, one (C, Tr, Tc) array per
    site, matching build_normal_assembly's site order."""
    out = []
    for site in plan.sites:
        J1 = ctx.jacs[site.fi][site.j1]
        J2 = ctx.jacs[site.fi][site.j2]
        X = jnp.einsum("bri,brj->bij", J1, J2)
        if site.transpose:
            X = jnp.swapaxes(X, 1, 2)
        blocks = apply_reduce(site.plan, X)[: site.rows.shape[0]]
        if site.diagonal and site.j1 != site.j2:
            # (j1, j2) and (j2, j1) both land on this diagonal cell
            blocks = blocks + jnp.swapaxes(blocks, 1, 2)
        out.append(blocks)
    return tuple(out)


@dataclasses.dataclass
class NormalAssembly:
    """Upper-CSC symbolic assembly of H (same shape as
    sparse_schur.SparseSchurAssembly but over the full tangent space)."""

    n: int
    indptr: np.ndarray
    indices: np.ndarray
    pos: np.ndarray  # concatenated per-site value -> data position
    diag_pos: np.ndarray  # (n,)
    nnz: int
    cholesky: Optional[object] = None


def build_normal_assembly(plan: NormalPlan) -> NormalAssembly:
    n = plan.num_tangent
    keys_parts, valid_parts = [], []
    for site in plan.sites:
        rows = np.asarray(site.rows)
        cols = np.asarray(site.cols)
        C, T1 = rows.shape
        T2 = cols.shape[1]
        r = np.broadcast_to(rows[:, :, None], (C, T1, T2)).astype(np.int64)
        c = np.broadcast_to(cols[:, None, :], (C, T1, T2)).astype(np.int64)
        in_range = (r < n) & (c < n)
        if site.diagonal:
            valid = in_range & (r <= c)
        else:
            valid = in_range
        keys_parts.append((c * n + r).reshape(-1))
        valid_parts.append(valid.reshape(-1))
    all_keys = (
        np.concatenate(keys_parts) if keys_parts else np.zeros(0, np.int64)
    )
    all_valid = (
        np.concatenate(valid_parts) if valid_parts else np.zeros(0, bool)
    )
    diag_keys = np.arange(n, dtype=np.int64) * (n + 1)
    uniq, inverse = np.unique(
        np.concatenate([all_keys[all_valid], diag_keys]), return_inverse=True
    )
    nnz = uniq.shape[0]
    pos = np.full(all_keys.shape[0], nnz, dtype=np.int64)
    n_valid = int(all_valid.sum())
    pos[all_valid] = inverse[:n_valid]
    diag_pos = inverse[n_valid:]
    cols_u = uniq // n
    rows_u = (uniq % n).astype(np.int32)
    indptr = np.searchsorted(cols_u, np.arange(n + 1)).astype(np.int64)
    return NormalAssembly(
        n=n,
        indptr=indptr,
        indices=rows_u,
        pos=pos,
        diag_pos=diag_pos,
        nnz=nnz,
    )


def host_normal_factor_solve(
    assembly: NormalAssembly,
    cell_values,
    D: np.ndarray,
    rhs: np.ndarray,
    ordering: str = "AMD",
    use_postordering: bool = False,
    mixed_precision: bool = False,
    num_refinement_iterations: int = 3,
):
    """Host: bincount-scatter cell values into CSC data, add D^2,
    refactorize on the cached symbolic handle, solve
    (``mixed_precision``: f32 factor + f64 refinement — the
    RefinedSparseCholesky analog, sparse_cholesky.h:118). Returns
    (y, termination) with sparse_cholesky's termination codes."""
    from ceres_tpu.linear.sparse_cholesky import factor_solve_csc

    vals = np.concatenate(
        [np.asarray(b, dtype=np.float64).ravel() for b in cell_values]
    )
    data = np.bincount(
        assembly.pos, weights=vals, minlength=assembly.nnz + 1
    )[: assembly.nnz]
    D64 = np.asarray(D, dtype=np.float64)
    if mixed_precision:
        # f32-factor damping floor (the _lm_damping f32 branch applied at
        # the factorization precision): D^2 < eps_f32 * diag(H) adds
        # nothing representable once the values are cast to f32, leaving
        # gauge-singular systems undamped no matter the radius.
        hdiag = np.maximum(data[assembly.diag_pos], 0.0)
        D64 = np.maximum(D64, np.sqrt(hdiag) * 3.5e-4)
    data[assembly.diag_pos] += D64 * D64

    if assembly.cholesky is None:
        assembly.cholesky = {}
    return factor_solve_csc(
        assembly.cholesky,
        assembly.n,
        assembly.indptr,
        assembly.indices,
        data,
        rhs,
        ordering=ordering,
        use_postordering=use_postordering,
        mixed_precision=mixed_precision,
        num_refinement_iterations=num_refinement_iterations,
    )


@jax.jit
def _normal_cells_impl(ctx, plan):
    return compute_normal_cells(ctx, plan)
