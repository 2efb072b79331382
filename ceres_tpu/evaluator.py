"""Batched residual/Jacobian evaluation — the hot path.

JAX re-design of the reference's evaluation layer:
``internal/ceres/program_evaluator.h:118-397`` (threaded residual-block
fan-out with per-thread scratch), ``residual_block.cc:70-217`` (gather
states -> CostFunction::Evaluate -> manifold PlusJacobian -> loss Corrector)
and the Jet forward-mode engine (``include/ceres/jet.h``,
``internal/autodiff.h:304``).

Design: each residual family is evaluated with one
``vmap(jacfwd(residual_of_tangent_deltas))`` call —

    r_i(delta) = fn(plus(x_j, delta_j), ...)   differentiated at delta = 0

which fuses the cost-function Jacobian and the manifold PlusJacobian chain
rule into a single forward-mode pass (what the reference does in two steps at
residual_block.cc:136-159). The robust-loss Triggs correction
(corrector.cc) is applied vectorized over the batch. Gradients are
scatter-adds into the tangent vector (the reference's per-thread gradient
accumulation + reduction, program_evaluator.h:266-304, becomes one
segment-sum that XLA lowers efficiently).

The Jacobian is never materialized globally unless a dense solver asks for
it: it stays as per-family batched dense blocks (B, r, T_j) — the analog of
BlockSparseMatrix (block_sparse_matrix.h:60-160) laid out for batched products.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ceres_tpu.loss import (
    corrector_coefficients,
    correct_jacobian,
    correct_residuals,
)
from ceres_tpu.problem import Family, Program


# -- Family as pytree --------------------------------------------------------


def _family_flatten(f: Family):
    children = (
        f.ambient_idx,
        f.tangent_idx,
        f.data,
        f.loss,
        f.bd_pos,
        f.mask,
        f.amb_pos,
        f.amb_tab,
        f.reduce_plans,
    )
    aux = (f.structure, f.batch, f.amb_slice)
    return children, aux


def _family_unflatten(aux, children):
    structure, batch, amb_slice = aux
    (
        ambient_idx,
        tangent_idx,
        data,
        loss,
        bd_pos,
        mask,
        amb_pos,
        amb_tab,
        reduce_plans,
    ) = children
    return Family(
        structure=structure,
        loss=loss,
        batch=batch,
        ambient_idx=ambient_idx,
        tangent_idx=tangent_idx,
        data=data,
        residual_ids=None,
        block_ids=None,
        bd_pos=bd_pos,
        mask=mask,
        amb_pos=amb_pos,
        amb_tab=amb_tab,
        amb_slice=amb_slice,
        reduce_plans=reduce_plans,
    )


jax.tree_util.register_pytree_node(Family, _family_flatten, _family_unflatten)


# -- per-family primitives ----------------------------------------------------


def _instance_fn(structure):
    """Single-instance residual as a function of tangent deltas."""
    fn = structure.fn
    manifolds = structure.manifolds
    has_data = structure.has_data

    def inst(blocks, deltas, data):
        new_blocks = []
        for b, d, m in zip(blocks, deltas, manifolds):
            if m is None:
                new_blocks.append(b + d)
            else:
                new_blocks.append(m.plus(b, d))
        if has_data:
            return fn(*new_blocks, data)
        return fn(*new_blocks)

    return inst


def _gather_blocks(family: Family, x: jax.Array):
    """Gather the per-instance parameter blocks (B, A_j) per arg.

    Grouped path: one small (G_A, A) table gather + a (B,) row gather per
    arg instead of a (B, A) elementwise gather (row gathers move whole
    rows)."""
    if family.amb_pos and family.amb_tab:
        out = []
        for j in range(len(family.amb_pos)):
            sl = (
                family.amb_slice[j]
                if j < len(family.amb_slice)
                else None
            )
            if sl is not None:
                start, G, A = sl
                # contiguous group: the table is a free slice+reshape
                tab = jax.lax.dynamic_slice(x, (start,), (G * A,)).reshape(
                    G, A
                )
            else:
                tab = x[family.amb_tab[j]]  # (G_A, A): small
            out.append(tab[family.amb_pos[j]])  # (B, A): row gather
        return tuple(out)
    return tuple(x[idx] for idx in family.ambient_idx)


def family_residuals(family: Family, x: jax.Array) -> jax.Array:
    """Raw residuals (B, r)."""
    st = family.structure
    blocks = _gather_blocks(family, x)
    B = family.batch
    bucket = EVAL_BUCKET_SIZE
    if bucket > 0 and B > bucket and B % bucket == 0:
        k = B // bucket

        def shard(a):
            return a.reshape((k, bucket) + a.shape[1:])

        blocks_b = tuple(shard(b) for b in blocks)
        data_b = (
            jax.tree_util.tree_map(shard, family.data)
            if st.has_data
            else None
        )

        def one_bucket(args):
            bs, data = args
            if st.has_data:
                return jax.vmap(lambda b_, d_: st.fn(*b_, d_))(bs, data)
            return jax.vmap(lambda b_: st.fn(*b_))(bs)

        r = jax.lax.map(one_bucket, (blocks_b, data_b))
        r = r.reshape((B,) + r.shape[2:])
    elif st.has_data:
        r = jax.vmap(lambda bs, d: st.fn(*bs, d))(blocks, family.data)
    else:
        r = jax.vmap(lambda bs: st.fn(*bs))(blocks)
    if family.mask is not None:
        r = r * family.mask[:, None]
    return r


# Bucketed evaluation: XLA compile time for the fused vmap(jacfwd(...))
# evaluation can grow superlinearly with the batch size. Splitting the
# batch into fixed-size buckets evaluated with lax.map compiles ONE
# bucket body — compile cost becomes independent of problem size, at a
# small dispatch overhead per bucket. Enabled per-family when the batch
# divides the bucket size; ``bucket_program`` pads families to make it
# so (SURVEY.md §7 hard part (a): pad/bucket vs recompile).
EVAL_BUCKET_SIZE = int(
    __import__("os").environ.get("CERES_TPU_EVAL_BUCKET", "131072")
)


def family_residuals_and_jacobians(
    family: Family, x: jax.Array
) -> Tuple[jax.Array, Tuple[jax.Array, ...]]:
    """Raw residuals (B, r) and tangent jacobians per arg (B, r, T_j).

    One fused vmapped forward-mode pass (replaces Jets + PlusJacobian)."""
    st = family.structure
    inst = _instance_fn(st)
    blocks = _gather_blocks(family, x)

    def res_and_jac(bs, ds, data):
        def f(deltas):
            out = inst(bs, deltas, data)
            return out, out

        J, r = jax.jacfwd(f, has_aux=True)(ds)
        return r, J

    B = family.batch
    bucket = EVAL_BUCKET_SIZE
    if bucket > 0 and B > bucket and B % bucket == 0:
        k = B // bucket

        def shard(a):
            return a.reshape((k, bucket) + a.shape[1:])

        blocks_b = tuple(shard(b) for b in blocks)
        data_b = (
            jax.tree_util.tree_map(shard, family.data)
            if st.has_data
            else None
        )
        zeros = tuple(
            jnp.zeros((bucket, t), dtype=x.dtype) for t in st.tangent_sizes
        )

        def one_bucket(args):
            bs, data = args
            return jax.vmap(
                res_and_jac, in_axes=(0, 0, 0 if st.has_data else None)
            )(bs, zeros, data)

        r, jacs = jax.lax.map(one_bucket, (blocks_b, data_b))
        r = r.reshape((B,) + r.shape[2:])
        jacs = tuple(J.reshape((B,) + J.shape[2:]) for J in jacs)
    else:
        zeros = tuple(
            jnp.zeros((B, t), dtype=x.dtype) for t in st.tangent_sizes
        )
        r, jacs = jax.vmap(
            res_and_jac, in_axes=(0, 0, 0 if st.has_data else None)
        )(blocks, zeros, family.data)
    if family.mask is not None:
        m = family.mask
        r = r * m[:, None]
        jacs = tuple(J * m[:, None, None] for J in jacs)
    return r, jacs


def _apply_loss(family: Family, r: jax.Array, jacs):
    """Triggs-correct residuals and jacobians; return (cost, r_c, jacs_c).

    Mirrors residual_block.cc:160-196 + corrector.cc. With no loss,
    cost = 0.5 ||r||^2 and arrays pass through.
    """
    sq_norm = jnp.sum(r * r, axis=-1)
    if family.loss is None:
        # f64 accumulation: see _cost_impl.
        cost = 0.5 * jnp.sum(sq_norm.astype(jnp.float64))
        return cost, r, jacs
    rho0, rho1, rho2 = family.loss.evaluate(sq_norm)
    cost = 0.5 * jnp.sum(rho0.astype(jnp.float64))
    scale, alpha_sq_norm = corrector_coefficients(sq_norm, rho1, rho2)
    sqrt_rho1 = jnp.sqrt(rho1)
    if jacs is not None:
        jacs = tuple(
            correct_jacobian(J, r, sqrt_rho1, alpha_sq_norm) for J in jacs
        )
    r_c = correct_residuals(r, scale)
    return cost, r_c, jacs


# -- Jacobian context ---------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class JacobianContext:
    """The problem Jacobian as batched per-family blocks.

    Analog of BlockSparseMatrix (block_sparse_matrix.h:60): values are
    per-family (B, r, T_j) dense tensors; structure is the family index
    maps. All linear-solver access is matrix-free through these tensors.

    ``residuals`` are the loss-corrected residuals per family (B, r).
    """

    families: List[Family]
    jacs: Tuple[Tuple[jax.Array, ...], ...]
    residuals: Tuple[jax.Array, ...]
    num_tangent: int
    # Block-diagonal group coordinates {tangent_size: (G_T, T) int32}
    # (Program.jnp_bd_groups). When present (and families carry
    # reduce_plans), the transpose products run plan-based — one-hot
    # matmuls / ELL gathers + a single unique-index scatter — instead of
    # colliding scatter-adds.
    groups: Optional[dict] = None

    def tree_flatten(self):
        return (self.families, self.jacs, self.residuals, self.groups), (
            self.num_tangent,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        families, jacs, residuals, groups = children
        return cls(families, jacs, residuals, aux[0], groups)

    # -- core products (all pure) ------------------------------------------

    def _gather_tangent(self, v_pad: jax.Array, fi: int, j: int) -> jax.Array:
        return v_pad[self.families[fi].tangent_idx[j]]

    def _grouped(self) -> bool:
        return self.groups is not None and all(
            f.reduce_plans is not None for f in self.families
        )

    def _group_slice_of(self, T):
        return getattr(self.groups, "slice_of", lambda _T: None)(T)

    def _group_rows(self, v: jax.Array, T: int, idx) -> jax.Array:
        """(G_T, T) view of a group's coordinates of the flat vector v.
        Contiguous groups (BlockGroups.slice_of) lower to a free
        dynamic_slice+reshape instead of a general 2-D gather, which at
        200k rows is slow to compile."""
        sl = self._group_slice_of(T)
        if sl is not None:
            start, G = sl
            return jax.lax.dynamic_slice(v, (start,), (G * T,)).reshape(
                G, T
            )
        return v[idx]

    def _group_pad(self, v: jax.Array) -> dict:
        """Flat tangent vector -> {T: (G_T+1, T)} grouped view (+ zero
        dummy row for constant blocks / padding)."""
        out = {}
        for T, idx in self.groups.items():
            out[T] = jnp.concatenate(
                [self._group_rows(v, T, idx), jnp.zeros((1, T), v.dtype)],
                axis=0,
            )
        return out

    def _ungroup_add(self, acc: dict, dtype) -> jax.Array:
        """{T: (G_T+1, T)} group sums -> flat tangent vector (rows are
        disjoint coordinate sets, so the scatter is unique-index; for
        contiguous groups it is a dynamic-update-slice)."""
        g = jnp.zeros((self.num_tangent,), dtype=dtype)
        for T, a in acc.items():
            idx = self.groups[T]
            G = idx.shape[0]
            sl = self._group_slice_of(T)
            if sl is not None:
                start, _ = sl
                cur = jax.lax.dynamic_slice(g, (start,), (G * T,))
                g = jax.lax.dynamic_update_slice(
                    g, cur + a[:G].astype(dtype).reshape(G * T), (start,)
                )
            else:
                g = g.at[idx].add(
                    a[:G], mode="drop", unique_indices=True
                )
        return g

    def matvec(self, v: jax.Array, skip=None) -> Tuple[jax.Array, ...]:
        """J v -> per-family residual-space blocks (B, r).

        Analog of BlockSparseMatrix::RightMultiplyAndAccumulate
        (block_sparse_matrix.cc:239). Grouped path: one row-gather per
        size group + per-instance row gathers (instead of elementwise
        gathers).

        ``skip``: optional per-family arg index to exclude (static tuple,
        -1 = none). With the Schur e-arg skipped this is the partitioned
        F-product (partitioned_matrix_view.h RightMultiplyAndAccumulateF)
        — the implicit Schur loop never pays for the E columns it would
        immediately mask away.
        """
        if self._grouped():
            vg = self._group_pad(v)
            out = []
            for fi, fam in enumerate(self.families):
                acc = jnp.zeros(
                    (fam.batch, fam.residual_size), dtype=v.dtype
                )
                for j in range(fam.num_args):
                    if skip is not None and j == skip[fi]:
                        continue
                    T = fam.structure.tangent_sizes[j]
                    if T in vg:
                        vj = vg[T][fam.bd_pos[j]]  # (B, T_j) row gather
                    else:
                        vj = jnp.zeros((fam.batch, T), v.dtype)
                    acc = acc + jnp.einsum(
                        "brt,bt->br", self.jacs[fi][j], vj
                    )
                out.append(acc)
            return tuple(out)
        v_pad = jnp.concatenate([v, jnp.zeros((1,), v.dtype)])
        out = []
        for fi, fam in enumerate(self.families):
            acc = jnp.zeros((fam.batch, fam.residual_size), dtype=v.dtype)
            for j in range(fam.num_args):
                if skip is not None and j == skip[fi]:
                    continue
                vj = v_pad[fam.tangent_idx[j]]  # (B, T_j)
                acc = acc + jnp.einsum(
                    "brt,bt->br", self.jacs[fi][j], vj
                )
            out.append(acc)
        return tuple(out)

    def rmatvec(self, w: Sequence[jax.Array], skip=None) -> jax.Array:
        """J^T w for per-family residual-space blocks -> tangent vector.

        Analog of LeftMultiplyAndAccumulate; the per-thread accumulation +
        locks of the reference become plan-based segment reductions
        (ceres_tpu.ops.reduce) + one unique-index scatter per size group.

        ``skip``: optional per-family arg index to exclude (static tuple,
        -1 = none) — the partitioned F'-product
        (partitioned_matrix_view.h LeftMultiplyAndAccumulateF). Skipping
        the e-arg avoids the point-side segment reduction entirely.
        """
        if self._grouped():
            from ceres_tpu.ops.reduce import apply_reduce

            acc: dict = {}
            for fi, fam in enumerate(self.families):
                for j in range(fam.num_args):
                    if skip is not None and j == skip[fi]:
                        continue
                    T = fam.structure.tangent_sizes[j]
                    if T not in self.groups:
                        continue  # all blocks of this size are constant
                    contrib = jnp.einsum(
                        "brt,br->bt", self.jacs[fi][j], w[fi]
                    )
                    red = apply_reduce(fam.reduce_plans[j], contrib)
                    acc[T] = red if T not in acc else acc[T] + red
            return self._ungroup_add(acc, w[0].dtype)
        g = jnp.zeros((self.num_tangent,), dtype=w[0].dtype)
        for fi, fam in enumerate(self.families):
            for j in range(fam.num_args):
                if skip is not None and j == skip[fi]:
                    continue
                contrib = jnp.einsum("brt,br->bt", self.jacs[fi][j], w[fi])
                g = g.at[fam.tangent_idx[j]].add(contrib, mode="drop")
        return g

    def normal_matvec(self, v: jax.Array) -> jax.Array:
        """J^T J v in one pass (the CGNR/implicit-Schur hot op)."""
        return self.rmatvec(self.matvec(v))

    def gradient(self) -> jax.Array:
        """g = J^T r (with corrected arrays this equals rho' J^T r)."""
        return self.rmatvec(self.residuals)

    @property
    def dtype(self):
        return self.residuals[0].dtype if self.residuals else jnp.float64

    def squared_column_norms(self) -> jax.Array:
        """diag(J^T J) (BlockSparseMatrix::SquaredColumnNorm)."""
        if self._grouped():
            from ceres_tpu.ops.reduce import apply_reduce

            acc: dict = {}
            for fi, fam in enumerate(self.families):
                for j in range(fam.num_args):
                    T = fam.structure.tangent_sizes[j]
                    if T not in self.groups:
                        continue
                    contrib = jnp.sum(self.jacs[fi][j] ** 2, axis=1)
                    red = apply_reduce(fam.reduce_plans[j], contrib)
                    acc[T] = red if T not in acc else acc[T] + red
            return self._ungroup_add(acc, self.dtype)
        d = jnp.zeros((self.num_tangent,), dtype=self.dtype)
        for fi, fam in enumerate(self.families):
            for j in range(fam.num_args):
                contrib = jnp.sum(self.jacs[fi][j] ** 2, axis=1)  # (B, T_j)
                d = d.at[fam.tangent_idx[j]].add(contrib, mode="drop")
        return d

    def scale_columns(self, scale: jax.Array) -> "JacobianContext":
        """Return a context with columns scaled (ScaleColumns,
        block_sparse_matrix.cc; used for Jacobi scaling,
        trust_region_minimizer.cc:263-279)."""
        sg = None
        if self._grouped():
            sg = {}
            for T, idx in self.groups.items():
                sg[T] = jnp.concatenate(
                    [
                        self._group_rows(scale, T, idx),
                        jnp.ones((1, T), scale.dtype),
                    ],
                    axis=0,
                )
        else:
            s_pad = jnp.concatenate([scale, jnp.ones((1,), scale.dtype)])
        new_jacs = []
        for fi, fam in enumerate(self.families):
            js = []
            for j in range(fam.num_args):
                T = fam.structure.tangent_sizes[j]
                if sg is not None:
                    if T in sg:
                        sj = sg[T][fam.bd_pos[j]]  # (B, T_j) row gather
                    else:
                        sj = jnp.ones((fam.batch, T), scale.dtype)
                else:
                    sj = s_pad[fam.tangent_idx[j]]  # (B, T_j)
                js.append(self.jacs[fi][j] * sj[:, None, :])
            new_jacs.append(tuple(js))
        return JacobianContext(
            self.families,
            tuple(new_jacs),
            self.residuals,
            self.num_tangent,
            self.groups,
        )

    def block_jtj(self, group_sizes) -> dict:
        """Block diagonal of J^T J grouped by tangent size.

        Analog of BlockJacobiPreconditioner's block diagonal assembly
        (block_jacobi_preconditioner.h:55) and InnerProductComputer restricted
        to diagonal blocks: returns {T: (G_T, T, T)} batched SPD matrices,
        built with one einsum + segment scatter per family arg.
        ``group_sizes`` is {tangent_size: num_blocks} (Program.bd_groups).
        """
        out = {
            T: jnp.zeros((G, T, T), dtype=self.dtype)
            for T, G in group_sizes.items()
        }
        use_plans = all(f.reduce_plans is not None for f in self.families)
        if use_plans:
            from ceres_tpu.ops.reduce import apply_reduce
        for fi, fam in enumerate(self.families):
            for j in range(fam.num_args):
                T = fam.structure.tangent_sizes[j]
                if T not in out:
                    continue
                Jj = self.jacs[fi][j]
                contrib = jnp.einsum("bri,brj->bij", Jj, Jj)
                if use_plans:
                    red = apply_reduce(fam.reduce_plans[j], contrib)
                    out[T] = out[T] + red[: out[T].shape[0]]
                else:
                    out[T] = out[T].at[fam.bd_pos[j]].add(
                        contrib, mode="drop"
                    )
        return out

    def residual_vector(self) -> jax.Array:
        """Flat corrected residual vector (M,)."""
        return jnp.concatenate([r.reshape(-1) for r in self.residuals])

    @property
    def num_rows(self) -> int:
        return sum(f.batch * f.residual_size for f in self.families)

    def to_dense(self) -> jax.Array:
        """Materialize the dense Jacobian (M, num_tangent) — dense solvers
        and covariance only (dense_jacobian_writer.h analog)."""
        M = self.num_rows
        dense = jnp.zeros((M, self.num_tangent), dtype=self.dtype)
        row = 0
        for fi, fam in enumerate(self.families):
            B, r = fam.batch, fam.residual_size
            rows = row + jnp.arange(B * r, dtype=jnp.int32).reshape(B, r)
            for j in range(fam.num_args):
                dense = dense.at[rows[:, :, None], fam.tangent_idx[j][:, None, :]].add(
                    self.jacs[fi][j], mode="drop"
                )
            row += B * r
        return dense


@dataclasses.dataclass
class FullEval:
    cost: jax.Array
    gradient: jax.Array
    jacobian_context: JacobianContext


class Evaluator:
    """Jitted evaluation entry points over a frozen Program.

    Analog of Evaluator (evaluator.h) + ProgramEvaluator
    (program_evaluator.h:118): `cost`, `residuals`, and
    `cost_gradient_jacobian` are each one XLA computation.

    The jitted implementations are MODULE-LEVEL functions (below) so the
    compile cache is shared across Evaluator instances and ct.solve
    calls: same family structure => no recompile. The reference pays a
    per-solve preprocessor cost instead; recompiling 100k-residual
    kernels per solve would cost far more.
    """

    def __init__(
        self,
        program: Program,
        apply_loss_function: bool = True,
        evaluation_callback=None,
    ):
        from ceres_tpu.utils.observability import ExecutionSummary

        self.program = program
        self.apply_loss = apply_loss_function
        self.evaluation_callback = evaluation_callback
        self._last_x = None
        self._families = program.families
        self._num_tangent = program.num_tangent
        # Evaluator::Statistics parity (execution_summary.h:44-84,
        # program_evaluator.h:143-147): per-entry-point call counts and
        # host-side dispatch wall time. Device execution is async, so a
        # time here is the dispatch cost unless the caller synchronizes
        # right after (the host minimizer does, via its device_get).
        self.execution_summary = ExecutionSummary()

        # Bound entry points with the static arguments filled in.
        nt = program.num_tangent
        al = apply_loss_function
        grp = program.jnp_bd_groups()
        self._cost_fn = lambda x, fams: _cost_impl(x, fams, al)
        self._residuals_fn = lambda x, fams: _residuals_impl(x, fams, al)
        self._full_fn = lambda x, fams: _full_impl(x, fams, al, nt, grp)
        self._cost_grad_fn = lambda x, fams, ps: _cost_grad_impl(
            x, fams, ps, al, nt
        )

    def _notify(self, x, evaluate_jacobians: bool) -> None:
        """EvaluationCallback hook (evaluation_callback.h:63-80):
        new_evaluation_point is derived from x identity like the
        reference derives it from the parameter pointer state."""
        if self.evaluation_callback is None:
            return
        new_point = self._last_x is not x
        self._last_x = x
        self.evaluation_callback.prepare_for_evaluation(
            new_point, evaluate_jacobians
        )

    def cost(self, x: jax.Array) -> jax.Array:
        from ceres_tpu.utils.observability import ScopedExecutionTimer

        self._notify(x, False)
        with ScopedExecutionTimer(
            "Evaluator::Residual", self.execution_summary
        ):
            return self._cost_fn(x, self._families)

    def residuals(self, x: jax.Array) -> jax.Array:
        from ceres_tpu.utils.observability import ScopedExecutionTimer

        self._notify(x, False)
        with ScopedExecutionTimer(
            "Evaluator::Residual", self.execution_summary
        ):
            return self._residuals_fn(x, self._families)

    def cost_and_gradient(self, x: jax.Array):
        """(cost, tangent gradient) without forming the Jacobian."""
        from ceres_tpu.utils.observability import ScopedExecutionTimer

        self._notify(x, False)
        with ScopedExecutionTimer(
            "Evaluator::Gradient", self.execution_summary
        ):
            return self._cost_grad_fn(
                x, self._families, self.program.plus_struct
            )

    def cost_gradient_jacobian(self, x: jax.Array) -> FullEval:
        from ceres_tpu.utils.observability import ScopedExecutionTimer

        self._notify(x, True)
        with ScopedExecutionTimer(
            "Evaluator::Jacobian", self.execution_summary
        ):
            cost, grad, ctx = self._full_fn(x, self._families)
        return FullEval(cost=cost, gradient=grad, jacobian_context=ctx)

    def statistics(self):
        """Evaluator::Statistics analog: the ExecutionSummary of call
        counts/times (program_evaluator.h:143-147)."""
        return self.execution_summary

    def plus(self, x: jax.Array, delta: jax.Array) -> jax.Array:
        return self.program.plus(x, delta)


# -- module-level jitted implementations (shared compile cache) --------------


@functools.partial(jax.jit, static_argnames=("apply_loss",))
def _cost_impl(x, families, apply_loss):
    # Accumulate in f64 even for f32 evaluation: the LM accept/reject
    # and function-tolerance tests compare COST DIFFERENCES, and an f32
    # sum over 10^5+ residuals has ~1e-7-relative noise that swamps
    # those differences near the optimum (observed as spurious invalid
    # steps). One f64 reduction per evaluation is noise in the iteration
    # budget.
    total = jnp.asarray(0.0, dtype=jnp.float64)
    for fam in families:
        r = family_residuals(fam, x)
        if apply_loss and fam.loss is not None:
            rho0, _, _ = fam.loss.evaluate(jnp.sum(r * r, axis=-1))
            total = total + 0.5 * jnp.sum(rho0.astype(jnp.float64))
        else:
            total = total + 0.5 * jnp.sum(
                (r * r).astype(jnp.float64)
            )
    return total


@functools.partial(jax.jit, static_argnames=("apply_loss",))
def _residuals_impl(x, families, apply_loss):
    outs = []
    for fam in families:
        r = family_residuals(fam, x)
        if apply_loss and fam.loss is not None:
            sq = jnp.sum(r * r, axis=-1)
            _, rho1, rho2 = fam.loss.evaluate(sq)
            scale, _ = corrector_coefficients(sq, rho1, rho2)
            r = correct_residuals(r, scale)
        outs.append(r.reshape(-1))
    return jnp.concatenate(outs) if outs else jnp.zeros((0,))


@functools.partial(jax.jit, static_argnames=("apply_loss", "num_tangent"))
def _full_impl(x, families, apply_loss, num_tangent, groups=None):
    cost = jnp.asarray(0.0, dtype=jnp.float64)
    all_jacs = []
    all_res = []
    for fam in families:
        r, jacs = family_residuals_and_jacobians(fam, x)
        if apply_loss:
            c, r, jacs = _apply_loss(fam, r, jacs)
        else:
            c = 0.5 * jnp.sum(r * r)
        cost = cost + c
        all_jacs.append(tuple(jacs))
        all_res.append(r)
    ctx = JacobianContext(
        list(families), tuple(all_jacs), tuple(all_res), num_tangent, groups
    )
    grad = ctx.gradient()
    return cost, grad, ctx


@functools.partial(jax.jit, static_argnames=("apply_loss", "num_tangent"))
def _cost_grad_impl(x, families, plus_struct, apply_loss, num_tangent):
    """Reverse-mode tangent gradient: differentiate cost(plus(x, delta))
    at delta = 0 — one VJP pass, no Jacobian materialization
    (program_evaluator.h:266-284 analog)."""
    from ceres_tpu.problem import plus_apply

    def cost_of_delta(delta):
        return _cost_impl(plus_apply(plus_struct, x, delta), families, apply_loss)

    zero = jnp.zeros((num_tangent,), dtype=x.dtype)
    return jax.value_and_grad(cost_of_delta)(zero)
