"""Problem construction: parameter blocks + residual families.

JAX re-design of the reference's modeling layer
(``include/ceres/problem.h:70-553``, ``internal/ceres/problem_impl.{h,cc}``,
``program.{h,cc}``, ``parameter_block.h``, ``residual_block.h``).

Instead of a mutable pointer graph of ParameterBlock*/ResidualBlock* with
virtual CostFunction dispatch, residual blocks are grouped into **residual
families**: all blocks sharing the same (residual function, parameter block
sizes, manifolds, loss structure) are stacked along a batch axis and
evaluated with one ``vmap``/``jacfwd`` call. Parameters live in one flat
ambient vector; per-family int32 gather/scatter index matrices connect block
instances to it. This is the static-shape, gather/scatter formulation XLA
needs to batch the work instead of chasing pointers.

The reference's Program::CreateReducedProgram (program.cc:291-415) drops
constant/unused blocks; here constant blocks simply map to a dummy tangent
slot that is discarded after scatter-adds, so the evaluation stays one fused
kernel with no data-dependent shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ceres_tpu.loss import LossFunction, TrivialLoss
from ceres_tpu.manifold import EuclideanManifold, Manifold


@dataclasses.dataclass
class _ParameterBlockRec:
    """Host-side record (analog of parameter_block.h:65)."""

    pid: int
    values: np.ndarray  # current ambient values, shape (size,)
    manifold: Optional[Manifold]
    constant: bool = False
    lower: Optional[np.ndarray] = None  # lazily allocated bound arrays
    upper: Optional[np.ndarray] = None
    removed: bool = False

    @property
    def size(self) -> int:
        return int(self.values.shape[0])

    @property
    def tangent_size(self) -> int:
        if self.manifold is not None:
            return self.manifold.tangent_size
        return self.size


@dataclasses.dataclass
class _ResidualBlockRec:
    """Host-side record (analog of residual_block.h:69)."""

    rid: int
    fn: Callable
    loss: Optional[LossFunction]
    param_ids: Tuple[int, ...]
    data: Any  # per-instance pytree (leaves without batch axis)
    removed: bool = False


@dataclasses.dataclass
class _ResidualBatchRec:
    """One bulk add_residual_blocks call: B residual blocks stored as
    arrays instead of B Python records — the construction-side fast path
    that makes 100k-block problems build in milliseconds (the reference
    pays per-block heap allocations, problem_impl.cc AddResidualBlock).
    """

    rid_base: int
    fn: Callable
    loss: Optional[LossFunction]
    cols: np.ndarray  # (B, k) parameter block ids
    data: Any  # batched pytree (leading axis B)
    removed: np.ndarray  # (B,) bool mask


@dataclasses.dataclass
class PlusStructure:
    """Index arrays for the batched plus operator, registered as a pytree
    so jitted code receives them as arguments (never HLO constants —
    large embedded literals cripple compile times).

    ``eu_identity`` (static): the Euclidean part is the full identity
    map (every coordinate Euclidean-active, ambient == tangent order) —
    the common all-Euclidean/no-constant case, where plus is a plain
    vector add with no gather/scatter."""

    eu_amb: jax.Array  # (nE,) ambient coords of Euclidean blocks
    eu_tan: jax.Array  # (nE,) matching tangent coords
    groups: Tuple[Tuple[jax.Array, jax.Array], ...]  # per-manifold (amb, tan)
    manifolds: Tuple[Manifold, ...]  # static
    eu_identity: bool = False  # static


jax.tree_util.register_dataclass(
    PlusStructure,
    data_fields=["eu_amb", "eu_tan", "groups"],
    meta_fields=["manifolds", "eu_identity"],
)


def plus_apply(ps: PlusStructure, x: jax.Array, delta: jax.Array) -> jax.Array:
    """x [+] delta over all active blocks (program.cc:114), pure."""
    if ps.eu_identity and not ps.manifolds:
        return x + delta.astype(x.dtype)
    x_new = x.at[ps.eu_amb].add(
        delta[ps.eu_tan], mode="drop", unique_indices=True
    )
    for m, (amb, tan) in zip(ps.manifolds, ps.groups):
        xb = x[amb]  # (G, A)
        db = delta[tan]  # (G, T)
        x_new = x_new.at[amb].set(jax.vmap(m.plus)(xb, db))
    return x_new


def cast_program(program: "Program", dtype) -> "Program":
    """Cast a Program's evaluation arrays (family data, masks, loss
    parameters, bounds) to ``dtype`` in place — the implementation of
    ``SolverOptions.evaluation_dtype``. Integer index arrays are kept.

    No-op when the program is already at ``dtype``: repeated solves must
    not invalidate the cached Schur structure / solve-aux arrays (each
    rebuild re-uploads hundreds of MB of indices to the device)."""
    dtype = jnp.dtype(dtype)
    if getattr(program, "eval_dtype", None) == dtype:
        return program

    def cast(a):
        if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating):
            return jnp.asarray(a, dtype=dtype)
        return a

    new_families = []
    for f in program.families:
        nf = jax.tree_util.tree_map(cast, f)
        # tree flattening drops the host-side id arrays; keep them.
        nf.residual_ids = f.residual_ids
        nf.block_ids = f.block_ids
        new_families.append(nf)
    program.families = new_families
    program.lower = cast(program.lower)
    program.upper = cast(program.upper)
    program.eval_dtype = dtype
    if hasattr(program, "_schur_structure"):
        del program._schur_structure  # rebuild with the new dtype
    if hasattr(program, "_solve_aux_cache"):
        del program._solve_aux_cache  # holds the stale structure
    return program


def _loss_structure(loss: Optional[LossFunction]):
    """Losses with identical pytree structure can share a family."""
    if loss is None:
        return None
    return jax.tree_util.tree_structure(loss)


class BlockGroups:
    """Block-diagonal group coordinates {tangent_size: (G_T, T) int32}
    plus STATIC contiguity metadata.

    When a size-group's coordinates form one contiguous ascending range
    of the tangent vector (``slice_of(T) = (start, G)``), gathers and
    scatters against that group lower to ``dynamic_slice`` /
    ``dynamic_update_slice`` instead of general gather/scatter, which
    is slow to compile at 200k rows; runtime also favors the slice.
    Duck-types the old plain-dict interface.
    """

    def __init__(self, idx, slices):
        self.idx = dict(idx)
        self.slices = dict(slices)

    def items(self):
        return self.idx.items()

    def keys(self):
        return self.idx.keys()

    def __contains__(self, T):
        return T in self.idx

    def __getitem__(self, T):
        return self.idx[T]

    def slice_of(self, T):
        return self.slices.get(T)

    def tree_flatten(self):
        keys = tuple(sorted(self.idx))
        children = tuple(self.idx[k] for k in keys)
        aux = (keys, tuple(self.slices.get(k) for k in keys))
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        keys, slices = aux
        return cls(dict(zip(keys, children)), dict(zip(keys, slices)))


jax.tree_util.register_pytree_node(
    BlockGroups,
    lambda g: g.tree_flatten(),
    BlockGroups.tree_unflatten,
)


def _group_slices(groups) -> dict:
    """{T: (start, G) | None}: contiguity of each coordinate group."""
    out = {}
    for T, tab in groups.items():
        tab = np.asarray(tab)
        flat = tab.ravel()
        start = int(flat[0]) if flat.size else 0
        if flat.size and np.array_equal(
            flat, np.arange(start, start + flat.size, dtype=flat.dtype)
        ):
            out[T] = (start, tab.shape[0])
        else:
            out[T] = None
    return out


class Problem:
    """Nonlinear least-squares problem: min 0.5 sum_i rho_i(||r_i||^2).

    Analog of ceres::Problem (problem.h:70-553), with both block-at-a-time
    and batched construction. Batched construction
    (:meth:`add_parameter_blocks`, :meth:`add_residual_blocks`) is the
    batched fast path — one call creates a whole residual family.
    """

    def __init__(self):
        self._param_blocks: List[_ParameterBlockRec] = []
        self._residual_blocks: List[_ResidualBlockRec] = []
        self._residual_batches: List[_ResidualBatchRec] = []
        self._next_rid = 0
        # rid -> ('s', index into _residual_blocks) | ('b', batch, row)
        self._rid_index: Dict[int, Tuple] = {}
        self._program_cache = None
        self._rb_eval_cache = {}

    # -- parameter blocks ---------------------------------------------------

    def add_parameter_block(
        self,
        values: np.ndarray,
        manifold: Optional[Manifold] = None,
        constant: bool = False,
    ) -> int:
        """Add one parameter block; returns its id (problem.h:258-270)."""
        values = np.atleast_1d(np.asarray(values, dtype=np.float64)).copy()
        if values.ndim != 1:
            raise ValueError("parameter block must be a vector")
        if manifold is not None and manifold.ambient_size != values.shape[0]:
            raise ValueError(
                f"manifold ambient size {manifold.ambient_size} != "
                f"block size {values.shape[0]}"
            )
        pid = len(self._param_blocks)
        self._param_blocks.append(
            _ParameterBlockRec(pid, values, manifold, constant=constant)
        )
        self._dirty()
        return pid

    def add_parameter_blocks(
        self,
        values: np.ndarray,
        manifold: Optional[Manifold] = None,
        constant: bool = False,
    ) -> np.ndarray:
        """Batched: values (B, size) -> array of B block ids."""
        values = np.asarray(values, dtype=np.float64)
        if values.ndim != 2:
            raise ValueError("expected (num_blocks, block_size)")
        ids = np.empty(values.shape[0], dtype=np.int64)
        base = len(self._param_blocks)
        for i in range(values.shape[0]):
            self._param_blocks.append(
                _ParameterBlockRec(base + i, values[i].copy(), manifold, constant)
            )
            ids[i] = base + i
        self._dirty()
        return ids

    def _pb(self, pid: int) -> _ParameterBlockRec:
        rec = self._param_blocks[pid]
        if rec.removed:
            raise KeyError(f"parameter block {pid} was removed")
        return rec

    def set_parameter_block_constant(self, pid) -> None:
        for p in np.atleast_1d(pid):
            self._pb(int(p)).constant = True
        self._dirty()

    def set_parameter_block_variable(self, pid) -> None:
        for p in np.atleast_1d(pid):
            self._pb(int(p)).constant = False
        self._dirty()

    def is_parameter_block_constant(self, pid: int) -> bool:
        return self._pb(pid).constant

    def set_manifold(self, pid: int, manifold: Optional[Manifold]) -> None:
        rec = self._pb(pid)
        if manifold is not None and manifold.ambient_size != rec.size:
            raise ValueError("manifold ambient size mismatch")
        rec.manifold = manifold
        self._dirty()

    def get_manifold(self, pid: int) -> Optional[Manifold]:
        return self._pb(pid).manifold

    def _check_bound_index(self, rec, index: int) -> None:
        if not (0 <= int(index) < rec.size):
            raise ValueError(
                f"bound index {index} out of range for block of size "
                f"{rec.size} (problem.h:333 CHECK)"
            )

    def set_parameter_lower_bound(self, pid: int, index: int, value: float) -> None:
        """problem.h:333-341."""
        rec = self._pb(pid)
        self._check_bound_index(rec, index)
        if rec.lower is None:
            rec.lower = np.full(rec.size, -np.inf)
        rec.lower[index] = value
        self._dirty()

    def set_parameter_upper_bound(self, pid: int, index: int, value: float) -> None:
        rec = self._pb(pid)
        self._check_bound_index(rec, index)
        if rec.upper is None:
            rec.upper = np.full(rec.size, np.inf)
        rec.upper[index] = value
        self._dirty()

    def get_parameter_lower_bound(self, pid: int, index: int) -> float:
        rec = self._pb(pid)
        return float(rec.lower[index]) if rec.lower is not None else -np.inf

    def get_parameter_upper_bound(self, pid: int, index: int) -> float:
        rec = self._pb(pid)
        return float(rec.upper[index]) if rec.upper is not None else np.inf

    def parameter_block_value(self, pid: int) -> np.ndarray:
        return self._pb(pid).values.copy()

    def set_parameter_block_value(self, pid: int, values: np.ndarray) -> None:
        rec = self._pb(pid)
        values = np.asarray(values, dtype=np.float64)
        if values.shape != rec.values.shape:
            raise ValueError("shape mismatch")
        rec.values[:] = values
        self._dirty()

    def remove_parameter_block(self, pid: int) -> None:
        """problem.h:291-305: also removes residual blocks that use it."""
        rec = self._pb(pid)
        rec.removed = True
        for rb in self._residual_blocks:
            if not rb.removed and pid in rb.param_ids:
                rb.removed = True
        for batch in self._residual_batches:
            batch.removed |= (batch.cols == pid).any(axis=1)
        self._dirty()

    # -- residual blocks ----------------------------------------------------

    def add_residual_block(
        self,
        fn: Callable,
        loss: Optional[LossFunction],
        param_ids: Sequence[int],
        data: Any = None,
    ) -> int:
        """Add one residual block (problem.h:230-253).

        ``fn(*blocks)`` or ``fn(*blocks, data)`` must return the residual
        vector for ONE instance, in pure jnp. Blocks arrive as 1-D arrays.
        """
        pids = tuple(int(p) for p in np.atleast_1d(np.asarray(param_ids)).ravel())
        if len(set(pids)) != len(pids):
            # problem_impl.cc CHECK: a residual block may not reference
            # the same parameter block twice (fuse the arguments instead).
            raise ValueError(
                f"duplicate parameter blocks in residual block: {pids}"
            )
        for p in pids:
            self._pb(p)  # validate
        rid = self._next_rid
        self._next_rid += 1
        self._rid_index[rid] = ("s", len(self._residual_blocks))
        self._residual_blocks.append(_ResidualBlockRec(rid, fn, loss, pids, data))
        self._dirty()
        return rid

    def add_residual_blocks(
        self,
        fn: Callable,
        loss: Optional[LossFunction],
        param_ids: Sequence[np.ndarray],
        data: Any = None,
    ) -> np.ndarray:
        """Batched: param_ids is a list of per-argument id arrays (len B each);
        data leaves must have leading axis B. Creates B residual blocks that
        will share one family."""
        cols = [np.atleast_1d(np.asarray(c, dtype=np.int64)) for c in param_ids]
        B = cols[0].shape[0]
        for c in cols:
            if c.shape[0] != B:
                raise ValueError("param id arrays must have equal length")
        cols = np.stack(cols, axis=1)  # (B, k)

        # Vectorized validation: ids in range, blocks live, and each column
        # structurally uniform (size + manifold) so one family can hold it.
        if cols.size:
            if cols.min() < 0 or cols.max() >= len(self._param_blocks):
                raise KeyError("parameter block id out of range")
            for j in range(cols.shape[1]):
                col = cols[:, j]
                first = self._pb(int(col[0]))
                sizes = {self._param_blocks[int(p)].size for p in np.unique(col)}
                if len(sizes) != 1:
                    raise ValueError(
                        f"argument {j}: mixed block sizes {sizes} in one "
                        "add_residual_blocks call; split into separate calls"
                    )
                mans = {
                    id(self._param_blocks[int(p)].manifold)
                    for p in np.unique(col)
                }
                if len(mans) != 1:
                    raise ValueError(
                        f"argument {j}: blocks with different manifolds in "
                        "one add_residual_blocks call"
                    )
                for p in np.unique(col):
                    self._pb(int(p))  # raises if removed

        base = self._next_rid
        self._next_rid += B
        bi = len(self._residual_batches)
        self._residual_batches.append(
            _ResidualBatchRec(
                rid_base=base,
                fn=fn,
                loss=loss,
                cols=cols,
                data=None
                if data is None
                else jax.tree_util.tree_map(np.asarray, data),
                removed=np.zeros(B, dtype=bool),
            )
        )
        ids = base + np.arange(B, dtype=np.int64)
        for i in range(B):
            self._rid_index[base + i] = ("b", bi, i)
        self._dirty()
        return ids

    def remove_residual_block(self, rid: int) -> None:
        kind = self._rid_index[int(rid)]
        if kind[0] == "s":
            self._residual_blocks[kind[1]].removed = True
        else:
            self._residual_batches[kind[1]].removed[kind[2]] = True
        self._dirty()

    # -- introspection ------------------------------------------------------

    def num_parameter_blocks(self) -> int:
        return sum(1 for p in self._param_blocks if not p.removed)

    def num_parameters(self) -> int:
        return sum(p.size for p in self._param_blocks if not p.removed)

    def num_residual_blocks(self) -> int:
        return sum(1 for r in self._residual_blocks if not r.removed) + sum(
            int((~b.removed).sum()) for b in self._residual_batches
        )

    def num_residuals(self) -> int:
        prog = self.program()
        return int(sum(f.batch * f.residual_size for f in prog.families))

    def parameter_block_ids(self) -> List[int]:
        return [p.pid for p in self._param_blocks if not p.removed]

    # -- program ------------------------------------------------------------

    def _dirty(self):
        self._program_cache = None

    def program(self) -> "Program":
        """Freeze into an evaluation-ready Program (analog program.{h,cc})."""
        if self._program_cache is None:
            self._program_cache = Program(self)
        return self._program_cache

    def evaluate_residual_block(
        self,
        rid: int,
        apply_loss_function: bool = True,
    ):
        """Evaluate one residual block at the current parameter values.

        Analog of Problem::EvaluateResidualBlock (problem.h:514-537).
        Returns dict with 'cost', 'residuals', and 'jacobians' (list of
        per-argument ambient-space jacobians)."""
        kind = self._rid_index[int(rid)]
        if kind[0] == "s":
            rb = self._residual_blocks[kind[1]]
            if rb.removed:
                raise KeyError(f"residual block {rid} was removed")
            fn, loss, pids, data = rb.fn, rb.loss, rb.param_ids, rb.data
        else:
            batch = self._residual_batches[kind[1]]
            row = kind[2]
            if batch.removed[row]:
                raise KeyError(f"residual block {rid} was removed")
            fn, loss = batch.fn, batch.loss
            pids = tuple(int(v) for v in batch.cols[row])
            data = (
                None
                if batch.data is None
                else jax.tree_util.tree_map(
                    lambda a: a[row], batch.data
                )
            )
        values = [jnp.asarray(self._pb(p).values) for p in pids]
        args = values + ([data] if data is not None else [])
        # One cached jitted (residual, all-jacobians) evaluation per
        # (cost function, signature): repeated calls — e.g. a user looping
        # over blocks, problem_test.cc EvaluateResidualBlock patterns —
        # reuse the compiled primal+jacfwd instead of re-tracing
        # jax.jacfwd once per argument per call.
        key = (
            id(fn),
            len(values),
            tuple(v.shape for v in values),
            None
            if data is None
            else tuple(
                (getattr(a, "shape", None), str(getattr(a, "dtype", "")))
                for a in jax.tree_util.tree_leaves(data)
            ),
        )
        cached = self._rb_eval_cache.get(key)
        if cached is None:
            argnums = tuple(range(len(values)))

            def primal_and_jacs(*a):
                return fn(*a), jax.jacfwd(fn, argnums=argnums)(*a)

            cached = jax.jit(primal_and_jacs)
            self._rb_eval_cache[key] = cached
        r, jacs = cached(*args)
        sq = float(jnp.sum(r * r))
        if apply_loss_function and loss is not None:
            rho0 = float(loss.evaluate(jnp.asarray(sq))[0])
            cost = 0.5 * rho0
        else:
            cost = 0.5 * sq
        return {
            "cost": cost,
            "residuals": np.asarray(r),
            "jacobians": [np.asarray(J) for J in jacs],
        }

    def evaluate(
        self,
        residuals: bool = False,
        gradient: bool = False,
        jacobian: bool = False,
        apply_loss_function: bool = True,
    ):
        """Standalone evaluation at current parameter values.

        Analog of Problem::Evaluate (problem.h:477-481). Returns a dict with
        keys 'cost' and optionally 'residuals', 'gradient' (tangent space),
        'jacobian' (dense, rows = residuals, cols = tangent).
        """
        from ceres_tpu.evaluator import Evaluator

        prog = self.program()
        if getattr(prog, "mesh", None) is not None:
            # A sharded solve mutated the cached program (padded, masked
            # batches); rebuild a clean single-device program so the
            # returned residual vector has the user's row count.
            self._dirty()
            prog = self.program()
        ev = Evaluator(prog, apply_loss_function=apply_loss_function)
        x = prog.initial_ambient()
        # Problem::Evaluate covers ALL residual blocks, including those
        # the reduced program drops (problem_impl.cc builds its own full
        # Program): add the fixed families' contribution back.
        out = {"cost": float(ev.cost(x))}
        fixed = tuple(prog.fixed_families)
        if fixed:
            from ceres_tpu.evaluator import _cost_impl, _residuals_impl

            if apply_loss_function:
                out["cost"] += prog.fixed_cost
            else:
                out["cost"] += float(_cost_impl(x, fixed, False))
        if residuals:
            r = np.asarray(ev.residuals(x))
            if fixed:
                from ceres_tpu.evaluator import _residuals_impl

                rf = np.asarray(
                    _residuals_impl(x, fixed, apply_loss_function)
                )
                r = np.concatenate([r, rf])
            out["residuals"] = r
        if gradient or jacobian:
            full = ev.cost_gradient_jacobian(x)
            if gradient:
                out["gradient"] = np.asarray(full.gradient)
            if jacobian:
                J = np.asarray(full.jacobian_context.to_dense())
                Jc = _to_crs(full.jacobian_context)
                if fixed:
                    # Fixed blocks have no varying columns: zero rows
                    # (matches the reference, where constant blocks get
                    # no jacobian columns).
                    import scipy.sparse as sp

                    nf = sum(f.batch * f.residual_size for f in fixed)
                    J = np.vstack([J, np.zeros((nf, J.shape[1]))])
                    Jc = sp.vstack(
                        [Jc, sp.csr_matrix((nf, Jc.shape[1]))]
                    ).tocsr()
                out["jacobian"] = J
                out["jacobian_crs"] = Jc
        return out

    def write_back(self, x_ambient: np.ndarray) -> None:
        """Copy a solved flat ambient vector back into the user blocks."""
        prog = self.program()
        x_ambient = np.asarray(x_ambient)
        for rec in self._param_blocks:
            if rec.removed:
                continue
            off = prog.ambient_offset[rec.pid]
            rec.values[:] = x_ambient[off : off + rec.size]


def _to_crs(ctx):
    """Scipy CSR of the block Jacobian (include/ceres/crs_matrix.h
    analog for Problem::Evaluate): assembled host-side from the
    per-family (B, r, T_j) blocks without materializing the dense
    matrix."""
    import scipy.sparse as sp

    rows_l, cols_l, vals_l = [], [], []
    row0 = 0
    nt = ctx.num_tangent
    for fi, fam in enumerate(ctx.families):
        B, r = fam.batch, fam.residual_size
        rows_f = row0 + np.arange(B * r).reshape(B, r)
        for j in range(fam.num_args):
            tj = np.asarray(fam.tangent_idx[j])  # (B, T)
            Jj = np.asarray(ctx.jacs[fi][j])  # (B, r, T)
            T = tj.shape[1]
            keep = tj < nt  # drop constant-block dummy columns
            rr = np.broadcast_to(rows_f[:, :, None], (B, r, T))
            cc = np.broadcast_to(tj[:, None, :], (B, r, T))
            kk = np.broadcast_to(keep[:, None, :], (B, r, T))
            rows_l.append(rr[kk])
            cols_l.append(cc[kk])
            vals_l.append(Jj[kk])
        row0 += B * r
    if not rows_l:
        return sp.csr_matrix((0, nt))
    return sp.csr_matrix(
        (
            np.concatenate(vals_l),
            (np.concatenate(rows_l), np.concatenate(cols_l)),
        ),
        shape=(row0, nt),
    )


def _build_arg_plan(bd_pos: np.ndarray, num_groups: int):
    """Segment-reduction plan for one family argument (group = block's row
    in its block-diagonal size group, dummy = num_groups)."""
    from ceres_tpu.ops.reduce import build_reduce_plan

    return build_reduce_plan(np.asarray(bd_pos), int(num_groups))


@dataclasses.dataclass(frozen=True)
class FamilyStructure:
    """Static (hashable) part of a residual family."""

    fn: Callable
    residual_size: int
    block_sizes: Tuple[int, ...]
    tangent_sizes: Tuple[int, ...]
    manifolds: Tuple[Optional[Manifold], ...]
    has_data: bool
    loss_struct: Any


@dataclasses.dataclass
class Family:
    """One batched residual family.

    The dynamic arrays are device-ready; `structure` drives tracing.
    - ambient_idx[j]: (B, A_j) int32 gather indices into x_ambient
    - tangent_idx[j]: (B, T_j) int32 scatter indices into the tangent
      gradient (constant blocks point at the dummy slot = num_tangent)
    - data: pytree with leading batch axis B
    """

    structure: FamilyStructure
    loss: Optional[LossFunction]
    batch: int
    ambient_idx: Tuple[jax.Array, ...]
    tangent_idx: Tuple[jax.Array, ...]
    data: Any
    residual_ids: np.ndarray  # original residual block ids, shape (B,)
    block_ids: np.ndarray  # (B, k) parameter block ids
    # Per-arg position of each instance's block in the block-diagonal group
    # of its tangent size (constant blocks -> group size = dummy, dropped).
    # Used by the block-Jacobi preconditioner and the Schur eliminator.
    bd_pos: Tuple[jax.Array, ...] = ()
    # Row validity mask (B,) or None. Padded instances (added so the batch
    # divides a device-mesh axis, ceres_tpu.parallel) carry mask 0.0: their
    # residuals and jacobian blocks are zeroed in the evaluator so every
    # downstream reduction ignores them. None means all rows are valid.
    mask: Optional[jax.Array] = None
    # Grouped ambient gather: per-arg (B,) row index into the ambient
    # size-group table (Program.amb_groups) and the (G_A, A) table
    # itself. When present the evaluator gathers blocks as
    # x[amb_tab][amb_pos] (one small table gather + a row gather) instead
    # of the near-serial (B, A) elementwise gather x[ambient_idx].
    amb_pos: Tuple = ()
    amb_tab: Tuple = ()
    # Static per-arg (start, G, A) when the size-group's ambient
    # coordinates are one contiguous range (the usual layout): the table
    # gather then compiles to a free slice+reshape. () / None entries
    # fall back to the table gather.
    amb_slice: Tuple = ()
    # Per-arg segment-reduction plans (ceres_tpu.ops.reduce) turning the
    # batch -> block-diagonal-group accumulations (gradient, diag(J'J),
    # block Jacobi) into one-hot matmuls / ELL gathers instead of scatter-adds.
    # None falls back to scatter (built lazily by Program).
    reduce_plans: Optional[Tuple[Any, ...]] = None

    @property
    def residual_size(self) -> int:
        return self.structure.residual_size

    @property
    def num_args(self) -> int:
        return len(self.structure.block_sizes)


class Program:
    """Frozen, evaluation-ready view of a Problem.

    Analog of internal/ceres/program.{h,cc}: flat ambient vector layout,
    tangent layout over non-constant blocks, residual families, bounds,
    and the batched plus() operator.
    """

    def __init__(self, problem: Problem):
        self._problem = problem
        blocks = [p for p in problem._param_blocks if not p.removed]
        self.blocks = blocks

        # Ambient layout over ALL live blocks (constant ones included so the
        # residual functions can read them).
        self.ambient_offset: Dict[int, int] = {}
        off = 0
        for rec in blocks:
            self.ambient_offset[rec.pid] = off
            off += rec.size
        self.num_ambient = off

        # Tangent layout over active (non-constant) blocks.
        self.tangent_offset: Dict[int, int] = {}
        t = 0
        for rec in blocks:
            if not rec.constant:
                self.tangent_offset[rec.pid] = t
                t += rec.tangent_size
        self.num_tangent = t

        # Block-diagonal grouping of active blocks by tangent size: the layout
        # for block-Jacobi preconditioning (block_jacobi_preconditioner.h:55)
        # and per-block operations. bd_groups[T] is a (G_T, T) int32 matrix of
        # tangent indices; bd_pos_of_pid maps pid -> (T, row in that matrix).
        self.bd_groups: Dict[int, np.ndarray] = {}
        self.bd_pos_of_pid: Dict[int, Tuple[int, int]] = {}
        group_rows: Dict[int, List[np.ndarray]] = {}
        for rec in blocks:
            if rec.constant:
                continue
            T = rec.tangent_size
            toff = self.tangent_offset[rec.pid]
            rows = group_rows.setdefault(T, [])
            self.bd_pos_of_pid[rec.pid] = (T, len(rows))
            rows.append(np.arange(toff, toff + T, dtype=np.int32))
        for T, rows in group_rows.items():
            self.bd_groups[T] = np.stack(rows)

        # Ambient grouping of ALL blocks (constant included — the
        # evaluator gathers their values too) by ambient size: families
        # gather parameter blocks as table-row gathers
        # (x[amb_group] -> (G_A, A) table, then (B,) row picks) instead
        # of (B, A) elementwise gathers of B*A scalars.
        self.amb_groups: Dict[int, np.ndarray] = {}
        self.amb_pos_of_pid: Dict[int, Tuple[int, int]] = {}
        agroup_rows: Dict[int, List[np.ndarray]] = {}
        for rec in blocks:
            A = rec.size
            aoff = self.ambient_offset[rec.pid]
            rows = agroup_rows.setdefault(A, [])
            self.amb_pos_of_pid[rec.pid] = (A, len(rows))
            rows.append(np.arange(aoff, aoff + A, dtype=np.int32))
        for A, rows in agroup_rows.items():
            self.amb_groups[A] = np.stack(rows)
        # Contiguity: when a group's coordinates are one flat range the
        # evaluator's table gather becomes a slice+reshape.
        self.amb_slice_of: Dict[int, Optional[Tuple[int, int, int]]] = {}
        for A, tab in self.amb_groups.items():
            flat = tab.ravel()
            start = int(flat[0])
            if np.array_equal(
                flat, np.arange(start, start + flat.size, dtype=flat.dtype)
            ):
                self.amb_slice_of[A] = (start, tab.shape[0], A)
            else:
                self.amb_slice_of[A] = None

        self._build_bounds()
        self._build_plus()
        self._build_families()
        self._jnp_bd_groups = None

    def jnp_bd_groups(self) -> "BlockGroups":
        """Device copies of the block-diagonal group coordinate matrices
        {tangent_size: (G_T, T) int32} — the grouped-vector layout used by
        the plan-based reductions in the evaluator — wrapped in
        :class:`BlockGroups` with static contiguity metadata."""
        if self._jnp_bd_groups is None:
            self._jnp_bd_groups = BlockGroups(
                {T: jnp.asarray(idx) for T, idx in self.bd_groups.items()},
                _group_slices(self.bd_groups),
            )
        return self._jnp_bd_groups

    # -- state vectors ------------------------------------------------------

    def initial_ambient(self) -> jax.Array:
        x = np.empty(self.num_ambient, dtype=np.float64)
        for rec in self.blocks:
            off = self.ambient_offset[rec.pid]
            x[off : off + rec.size] = rec.values
        return jnp.asarray(x)

    def _build_bounds(self):
        lower = np.full(self.num_ambient, -np.inf)
        upper = np.full(self.num_ambient, np.inf)
        has = False
        for rec in self.blocks:
            off = self.ambient_offset[rec.pid]
            if rec.lower is not None:
                lower[off : off + rec.size] = rec.lower
                has = True
            if rec.upper is not None:
                upper[off : off + rec.size] = rec.upper
                has = True
        self.has_bounds = has
        self.lower = jnp.asarray(lower)
        self.upper = jnp.asarray(upper)

    def clamp(self, x: jax.Array) -> jax.Array:
        if not self.has_bounds:
            return x
        return jnp.clip(x, self.lower, self.upper)

    def is_feasible(self) -> bool:
        """Initial-point feasibility check (program.cc:194-236)."""
        x = np.asarray(self.initial_ambient())
        return bool(
            np.all(x >= np.asarray(self.lower)) and np.all(x <= np.asarray(self.upper))
        )

    # -- plus ---------------------------------------------------------------

    def _build_plus(self):
        """Group active blocks for the batched plus operator (program.cc:114)."""
        eu_amb: List[int] = []
        eu_tan: List[int] = []
        manifold_groups: Dict[Manifold, List[Tuple[int, int]]] = {}
        for rec in self.blocks:
            if rec.constant:
                continue
            aoff = self.ambient_offset[rec.pid]
            toff = self.tangent_offset[rec.pid]
            if rec.manifold is None or isinstance(rec.manifold, EuclideanManifold):
                eu_amb.extend(range(aoff, aoff + rec.size))
                eu_tan.extend(range(toff, toff + rec.size))
            else:
                manifold_groups.setdefault(rec.manifold, []).append((aoff, toff))

        groups = []
        manifolds = []
        for m, offs in manifold_groups.items():
            A, T = m.ambient_size, m.tangent_size
            amb = jnp.asarray(
                [[a + i for i in range(A)] for a, _ in offs], dtype=jnp.int32
            )
            tan = jnp.asarray(
                [[t + i for i in range(T)] for _, t in offs], dtype=jnp.int32
            )
            groups.append((amb, tan))
            manifolds.append(m)
        eu_amb_np = np.asarray(eu_amb, dtype=np.int64)
        eu_tan_np = np.asarray(eu_tan, dtype=np.int64)
        eu_identity = (
            not manifolds
            and eu_amb_np.shape[0] == self.num_ambient
            and self.num_ambient == self.num_tangent
            and np.array_equal(eu_amb_np, np.arange(self.num_ambient))
            and np.array_equal(eu_tan_np, np.arange(self.num_tangent))
        )
        self.plus_struct = PlusStructure(
            eu_amb=jnp.asarray(eu_amb, dtype=jnp.int32),
            eu_tan=jnp.asarray(eu_tan, dtype=jnp.int32),
            groups=tuple(groups),
            manifolds=tuple(manifolds),
            eu_identity=bool(eu_identity),
        )

    def plus(self, x: jax.Array, delta: jax.Array) -> jax.Array:
        """x_new = x [+] delta: batched manifold plus over all active blocks.

        Inside jit, prefer ``plus_apply(program.plus_struct, x, delta)``
        with the struct passed as an argument — this convenience form
        captures the index arrays as constants."""
        return plus_apply(self.plus_struct, x, delta)

    # -- families -----------------------------------------------------------

    def _family_key(self, rb: _ResidualBlockRec):
        sizes = tuple(self._problem._param_blocks[p].size for p in rb.param_ids)
        manifolds = tuple(
            self._problem._param_blocks[p].manifold for p in rb.param_ids
        )
        data_struct = (
            None
            if rb.data is None
            else jax.tree_util.tree_structure(rb.data)
        )
        return (rb.fn, sizes, manifolds, _loss_structure(rb.loss), data_struct)

    def _build_families(self):
        groups: Dict[Any, List[_ResidualBlockRec]] = {}
        order: List[Any] = []
        for rb in self._problem._residual_blocks:
            if rb.removed:
                continue
            key = self._family_key(rb)
            if key not in groups:
                groups[key] = []
                order.append(key)
            groups[key].append(rb)

        pblocks = self._problem._param_blocks
        families: List[Family] = []
        for key in order:
            rbs = groups[key]
            fn, sizes, manifolds, _, _ = key
            B = len(rbs)
            k = len(sizes)
            tangent_sizes = tuple(
                (m.tangent_size if m is not None else s)
                for s, m in zip(sizes, manifolds)
            )
            amb_idx = []
            tan_idx = []
            for j in range(k):
                aj = np.empty((B, sizes[j]), dtype=np.int32)
                tj = np.empty((B, tangent_sizes[j]), dtype=np.int32)
                for i, rb in enumerate(rbs):
                    pid = rb.param_ids[j]
                    aoff = self.ambient_offset[pid]
                    aj[i] = np.arange(aoff, aoff + sizes[j], dtype=np.int32)
                    if pblocks[pid].constant:
                        tj[i] = self.num_tangent  # dummy slot, dropped
                    else:
                        toff = self.tangent_offset[pid]
                        tj[i] = np.arange(
                            toff, toff + tangent_sizes[j], dtype=np.int32
                        )
                amb_idx.append(jnp.asarray(aj))
                tan_idx.append(jnp.asarray(tj))

            if rbs[0].data is not None:
                data = jax.tree_util.tree_map(
                    lambda *leaves: jnp.stack([jnp.asarray(l) for l in leaves]),
                    *[rb.data for rb in rbs],
                )
            else:
                data = None

            loss = rbs[0].loss
            if loss is not None and B > 1:
                # Batch loss parameters across instances when they differ;
                # identical leaves collapse to broadcastable scalars.
                leaves0 = jax.tree_util.tree_leaves(loss)
                all_same = all(
                    all(
                        np.array_equal(
                            np.asarray(a), np.asarray(b)
                        )
                        for a, b in zip(
                            leaves0, jax.tree_util.tree_leaves(rb.loss)
                        )
                    )
                    for rb in rbs[1:]
                )
                if not all_same:
                    loss = jax.tree_util.tree_map(
                        lambda *leaves: jnp.stack(
                            [jnp.asarray(l) for l in leaves]
                        ),
                        *[rb.loss for rb in rbs],
                    )

            bd_pos = []
            reduce_plans = []
            amb_pos = []
            amb_tab = []
            amb_slice = []
            for j in range(k):
                T = tangent_sizes[j]
                dummy = self.bd_groups.get(T, np.zeros((0, T))).shape[0]
                pj = np.empty((B,), dtype=np.int32)
                apj = np.empty((B,), dtype=np.int32)
                for i, rb in enumerate(rbs):
                    pid = rb.param_ids[j]
                    if pblocks[pid].constant:
                        pj[i] = dummy
                    else:
                        pj[i] = self.bd_pos_of_pid[pid][1]
                    apj[i] = self.amb_pos_of_pid[pid][1]
                bd_pos.append(jnp.asarray(pj))
                reduce_plans.append(_build_arg_plan(pj, dummy))
                amb_pos.append(jnp.asarray(apj))
                amb_tab.append(jnp.asarray(self.amb_groups[sizes[j]]))
                amb_slice.append(self.amb_slice_of[sizes[j]])

            residual_size = self._infer_residual_size(fn, sizes, data)
            structure = FamilyStructure(
                fn=fn,
                residual_size=residual_size,
                block_sizes=sizes,
                tangent_sizes=tangent_sizes,
                manifolds=manifolds,
                has_data=data is not None,
                loss_struct=_loss_structure(loss),
            )
            families.append(
                Family(
                    structure=structure,
                    loss=loss,
                    batch=B,
                    ambient_idx=tuple(amb_idx),
                    tangent_idx=tuple(tan_idx),
                    data=data,
                    residual_ids=np.asarray([rb.rid for rb in rbs]),
                    block_ids=np.asarray([rb.param_ids for rb in rbs]),
                    bd_pos=tuple(bd_pos),
                    amb_pos=tuple(amb_pos),
                    amb_tab=tuple(amb_tab),
                    amb_slice=tuple(amb_slice),
                    reduce_plans=tuple(reduce_plans),
                )
            )

        # Vectorized path for bulk add_residual_blocks batches: index
        # construction is numpy array arithmetic over (B, k) id matrices —
        # no per-block Python work (the whole point of the batch API).
        if self._problem._residual_batches:
            n_pid = len(pblocks)
            amb_off = np.full(n_pid, -1, dtype=np.int64)
            tan_off = np.full(n_pid, -1, dtype=np.int64)
            const_by_pid = np.zeros(n_pid, dtype=bool)
            bd_row = np.zeros(n_pid, dtype=np.int64)
            for rec in self.blocks:
                amb_off[rec.pid] = self.ambient_offset[rec.pid]
                const_by_pid[rec.pid] = rec.constant
                if not rec.constant:
                    tan_off[rec.pid] = self.tangent_offset[rec.pid]
                    bd_row[rec.pid] = self.bd_pos_of_pid[rec.pid][1]

        for batch in self._problem._residual_batches:
            keep = ~batch.removed
            if not keep.any():
                continue
            cols = batch.cols[keep]
            B, k = cols.shape
            sizes = tuple(pblocks[int(cols[0, j])].size for j in range(k))
            manifolds = tuple(
                pblocks[int(cols[0, j])].manifold for j in range(k)
            )
            tangent_sizes = tuple(
                (m.tangent_size if m is not None else s)
                for s, m in zip(sizes, manifolds)
            )
            amb_idx, tan_idx, bd_pos, reduce_plans = [], [], [], []
            amb_pos, amb_tab, amb_slice = [], [], []
            amb_row = np.zeros(n_pid, dtype=np.int64)
            for rec in self.blocks:
                amb_row[rec.pid] = self.amb_pos_of_pid[rec.pid][1]
            for j in range(k):
                col = cols[:, j]
                aj = amb_off[col][:, None] + np.arange(sizes[j], dtype=np.int64)
                cj = const_by_pid[col]
                T = tangent_sizes[j]
                tj = np.where(
                    cj[:, None],
                    self.num_tangent,
                    tan_off[col][:, None] + np.arange(T, dtype=np.int64),
                )
                dummy = self.bd_groups.get(T, np.zeros((0, T))).shape[0]
                pj = np.where(cj, dummy, bd_row[col])
                amb_idx.append(jnp.asarray(aj.astype(np.int32)))
                tan_idx.append(jnp.asarray(tj.astype(np.int32)))
                bd_pos.append(jnp.asarray(pj.astype(np.int32)))
                reduce_plans.append(_build_arg_plan(pj, dummy))
                amb_pos.append(jnp.asarray(amb_row[col].astype(np.int32)))
                amb_tab.append(jnp.asarray(self.amb_groups[sizes[j]]))
                amb_slice.append(self.amb_slice_of[sizes[j]])

            if batch.data is None:
                data = None
            elif keep.all():
                data = jax.tree_util.tree_map(jnp.asarray, batch.data)
            else:
                data = jax.tree_util.tree_map(
                    lambda a: jnp.asarray(a[keep]), batch.data
                )

            residual_size = self._infer_residual_size(batch.fn, sizes, data)
            structure = FamilyStructure(
                fn=batch.fn,
                residual_size=residual_size,
                block_sizes=sizes,
                tangent_sizes=tangent_sizes,
                manifolds=manifolds,
                has_data=data is not None,
                loss_struct=_loss_structure(batch.loss),
            )
            families.append(
                Family(
                    structure=structure,
                    loss=batch.loss,
                    batch=B,
                    ambient_idx=tuple(amb_idx),
                    tangent_idx=tuple(tan_idx),
                    data=data,
                    residual_ids=batch.rid_base + np.nonzero(keep)[0],
                    block_ids=cols,
                    bd_pos=tuple(bd_pos),
                    amb_pos=tuple(amb_pos),
                    amb_tab=tuple(amb_tab),
                    amb_slice=tuple(amb_slice),
                    reduce_plans=tuple(reduce_plans),
                )
            )
        # Reduced program (program.cc:291-415 CreateReducedProgram):
        # residual blocks whose every parameter block is constant
        # contribute a CONSTANT cost — drop them from the jitted
        # evaluation and fold their cost into ``fixed_cost`` once.
        active, fixed = self._split_fixed_families(families)
        self.families: List[Family] = active
        self.fixed_families: List[Family] = fixed
        self.fixed_cost: float = 0.0
        if fixed:
            from ceres_tpu.evaluator import _cost_impl

            self.fixed_cost = float(
                _cost_impl(self.initial_ambient(), tuple(fixed), True)
            )

    def _split_fixed_families(self, families):
        """Partition family instances into active (>=1 varying block) and
        fixed (all blocks constant) rows."""
        const_by_pid = {
            rec.pid: rec.constant for rec in self.blocks
        }
        active, fixed = [], []
        for fam in families:
            ids = np.asarray(fam.block_ids)
            fixed_mask = np.ones(ids.shape[0], dtype=bool)
            for j in range(ids.shape[1]):
                fixed_mask &= np.asarray(
                    [const_by_pid[int(p)] for p in ids[:, j]]
                )
            if not fixed_mask.any():
                active.append(fam)
            elif fixed_mask.all():
                fixed.append(fam)
            else:
                active.append(self._family_take_rows(fam, ~fixed_mask))
                fixed.append(self._family_take_rows(fam, fixed_mask))
        return active, fixed

    def _family_take_rows(self, fam: Family, mask: np.ndarray) -> Family:
        """Row-subset of a batched family (rebuilds reduce plans)."""
        B = fam.batch
        take = lambda a: a[np.asarray(mask)]
        loss = fam.loss
        if loss is not None:
            loss = jax.tree_util.tree_map(
                lambda a: take(jnp.asarray(a))
                if hasattr(a, "shape")
                and getattr(a, "ndim", 0) >= 1
                and a.shape[0] == B
                else a,
                loss,
            )
        data = (
            None
            if fam.data is None
            else jax.tree_util.tree_map(lambda a: take(a), fam.data)
        )
        bd_pos, reduce_plans = [], []
        for j in range(fam.num_args):
            T = fam.structure.tangent_sizes[j]
            dummy = self.bd_groups.get(T, np.zeros((0, T))).shape[0]
            pj = np.asarray(fam.bd_pos[j])[mask]
            bd_pos.append(jnp.asarray(pj))
            reduce_plans.append(_build_arg_plan(pj, dummy))
        return Family(
            structure=fam.structure,
            loss=loss,
            batch=int(mask.sum()),
            ambient_idx=tuple(take(a) for a in fam.ambient_idx),
            tangent_idx=tuple(take(a) for a in fam.tangent_idx),
            data=data,
            residual_ids=np.asarray(fam.residual_ids)[mask],
            block_ids=np.asarray(fam.block_ids)[mask],
            bd_pos=tuple(bd_pos),
            amb_pos=tuple(take(a) for a in fam.amb_pos),
            amb_tab=fam.amb_tab,
            amb_slice=fam.amb_slice,
            reduce_plans=tuple(reduce_plans),
        )

    @staticmethod
    def _infer_residual_size(fn, sizes, data) -> int:
        args = [jax.ShapeDtypeStruct((s,), jnp.float64) for s in sizes]
        if data is not None:
            inst = jax.tree_util.tree_map(
                lambda leaf: jax.ShapeDtypeStruct(leaf.shape[1:], leaf.dtype), data
            )
            out = jax.eval_shape(fn, *args, inst)
        else:
            out = jax.eval_shape(fn, *args)
        if len(out.shape) != 1:
            raise ValueError(
                f"residual function must return a 1-D vector, got {out.shape}"
            )
        return int(out.shape[0])

    # -- reporting ----------------------------------------------------------

    def num_residuals(self) -> int:
        return sum(
            f.batch * f.residual_size
            for f in self.families + self.fixed_families
        )

    def num_residual_blocks(self) -> int:
        return sum(f.batch for f in self.families + self.fixed_families)

    def num_residuals_reduced(self) -> int:
        """Rows in the reduced program (program.cc:291 analog)."""
        return sum(f.batch * f.residual_size for f in self.families)

    def num_residual_blocks_reduced(self) -> int:
        return sum(f.batch for f in self.families)

    def num_parameter_blocks(self) -> int:
        return len(self.blocks)

    def num_active_parameter_blocks(self) -> int:
        return sum(1 for b in self.blocks if not b.constant)
