"""Residual-block sharding over a device mesh.

Parallelism model (SURVEY.md §2.12, mapped onto a device mesh):

1. **Residual-block data parallelism** — the reference's
   ``ParallelFor(residual blocks)`` fan-out (program_evaluator.h:189)
   becomes: shard every family's batch axis over the mesh's ``obs``
   axis. The parameter vector stays replicated; gathers are local;
   the gradient/J'J scatter-adds and cost sums become ``psum``-style
   collectives that GSPMD inserts where the reference takes locks
   (program_evaluator.h:266-284).
2. **Chunk parallelism in Schur elimination** — e-block (point)
   contributions are additive (schur_eliminator.h:143-152), so the
   per-point batched ``E'E`` assembly and the reduced camera system
   reduce across the same sharded batch axis with no extra code.

Batches are padded to a multiple of the mesh axis size with mask-0 rows
(zeroed residuals/jacobians, see ``Family.mask``) so shapes divide
evenly — the padding-vs-recompile trade called out in SURVEY.md §7.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ceres_tpu.problem import Family, Program

OBS_AXIS = "obs"


PT_AXIS = "pt"


def make_mesh(
    n_devices: Optional[int] = None, axis_name: str = OBS_AXIS
) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (all by default).

    Axes are ``Auto`` (GSPMD-propagated): the solve's gathers/scatters keep
    their single-device form and XLA inserts the collectives — JAX 0.9's
    default ``Explicit`` mode would instead demand out_shardings on every
    indexed gather in the evaluator.
    """
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return jax.make_mesh(
        (len(devs),),
        (axis_name,),
        axis_types=(jax.sharding.AxisType.Auto,),
        devices=devs,
    )


def make_mesh_2d(
    obs: int,
    pt: int,
    axis_names: Sequence[str] = (OBS_AXIS, PT_AXIS),
) -> Mesh:
    """2-D mesh (obs x pt): residual batches shard over BOTH axes (pure
    data parallelism over observations), while the point (e-block) system
    — E'E inverses, point-space vectors, the ELL reduction table — is
    constrained to shard over ``pt`` only. With observations sorted by
    point (models/bal.py), each (obs-row, pt-col) device owns the point
    slots its own observations feed, so the E'w reduction stays local to
    the pt column and only the small reduced camera system is
    all-reduced across the full mesh (schur_eliminator.h:143-152
    additivity). Every device reaches every other at the same rate
    (NVLink, all to all), so the split between ``obs`` and ``pt`` follows
    the algorithm alone: a larger ``pt`` axis shards the point system
    further at the price of a wider camera-system all-reduce.
    """
    devs = jax.devices()[: obs * pt]
    return jax.make_mesh(
        (obs, pt),
        tuple(axis_names),
        axis_types=(jax.sharding.AxisType.Auto,) * 2,
        devices=devs,
    )


def _pad_batch(a: jax.Array, pad: int) -> jax.Array:
    """Append ``pad`` copies of row 0 (valid indices, masked to zero)."""
    rep = jnp.repeat(a[:1], pad, axis=0)
    return jnp.concatenate([a, rep], axis=0)


def _family_float_dtype(fam: Family, dtype=None):
    """The dtype validity masks must use: the program's evaluation dtype.

    A float64 mask silently promotes every masked residual/Jacobian product
    to f64, and with it the whole f32 pipeline.
    Infer from the existing mask, then any float data leaf, else f64."""
    if dtype is not None:
        return jnp.dtype(dtype)
    if fam.mask is not None:
        return fam.mask.dtype
    if fam.data is not None:
        for leaf in jax.tree_util.tree_leaves(fam.data):
            if hasattr(leaf, "dtype") and jnp.issubdtype(
                leaf.dtype, jnp.floating
            ):
                return leaf.dtype
    return jnp.dtype(jnp.float64)


def pad_family(fam: Family, multiple: int, dtype=None) -> Family:
    """Pad a family's batch to a multiple; padded rows carry mask 0."""
    B = fam.batch
    Bp = int(math.ceil(B / multiple) * multiple)
    if Bp == B and fam.mask is None:
        return fam
    pad = Bp - B
    mdt = _family_float_dtype(fam, dtype)
    mask = jnp.concatenate(
        [
            jnp.ones((B,), mdt) if fam.mask is None else fam.mask.astype(mdt),
            jnp.zeros((pad,), mdt),
        ]
    )
    loss = fam.loss
    if loss is not None and pad:
        # Batched (per-instance) loss parameters must pad too.
        loss = jax.tree_util.tree_map(
            lambda leaf: _pad_batch(jnp.asarray(leaf), pad)
            if getattr(leaf, "ndim", 0) >= 1 and leaf.shape[0] == B
            else leaf,
            loss,
        )
    bd_pos = tuple(_pad_batch(b, pad) for b in fam.bd_pos)
    # Rebuild the segment-reduction plans for the padded batch. Padded
    # rows repeat row 0's (valid) group id — harmless, their
    # contributions are mask-zeroed before any reduction.
    reduce_plans = None
    if fam.reduce_plans is not None:
        from ceres_tpu.ops.reduce import build_reduce_plan

        reduce_plans = tuple(
            build_reduce_plan(np.asarray(b), p.num_groups)
            if p is not None
            else None
            for b, p in zip(bd_pos, fam.reduce_plans)
        )
    return Family(
        structure=fam.structure,
        loss=loss,
        batch=Bp,
        ambient_idx=tuple(_pad_batch(a, pad) for a in fam.ambient_idx),
        tangent_idx=tuple(_pad_batch(a, pad) for a in fam.tangent_idx),
        data=None
        if fam.data is None
        else jax.tree_util.tree_map(lambda a: _pad_batch(a, pad), fam.data),
        residual_ids=None
        if fam.residual_ids is None
        else np.concatenate(
            [fam.residual_ids, np.full((pad,), -1, dtype=np.int64)]
        ),
        block_ids=None
        if fam.block_ids is None
        else np.concatenate([fam.block_ids, np.repeat(fam.block_ids[:1], pad, 0)]),
        bd_pos=bd_pos,
        mask=mask,
        amb_pos=tuple(_pad_batch(a, pad) for a in fam.amb_pos),
        amb_tab=fam.amb_tab,
        amb_slice=fam.amb_slice,
        reduce_plans=reduce_plans,
    )


def _shard_family(fam: Family, mesh: Mesh, axis_name: str) -> Family:
    """device_put the batch-axis arrays with NamedSharding(axis, ...)."""

    def put(a):
        if a is None:
            return None
        spec = P(axis_name, *([None] * (a.ndim - 1)))
        return jax.device_put(a, NamedSharding(mesh, spec))

    loss = fam.loss
    if loss is not None:
        # Shard per-instance (batched) loss leaves, replicate scalars.
        loss = jax.tree_util.tree_map(
            lambda leaf: put(jnp.asarray(leaf))
            if getattr(leaf, "ndim", 0) >= 1 and leaf.shape[0] == fam.batch
            else jax.device_put(
                jnp.asarray(leaf), NamedSharding(mesh, P())
            ),
            loss,
        )
    reduce_plans = None
    if fam.reduce_plans is not None:
        from ceres_tpu.ops.reduce import ReducePlan

        def put_plan(p):
            if p is None:
                return None
            if p.kind == "onehot":
                # (G+1, B): shard the contraction (batch) axis; the
                # reduction matmul then psums partial group sums — the
                # GSPMD analog of per-thread accumulation + reduction.
                oh = jax.device_put(
                    p.onehot, NamedSharding(mesh, P(None, axis_name))
                )
                return ReducePlan(
                    kind="onehot", num_groups=p.num_groups, onehot=oh
                )
            if p.kind == "ell":
                return ReducePlan(
                    kind="ell",
                    num_groups=p.num_groups,
                    ell=jax.device_put(p.ell, NamedSharding(mesh, P())),
                )
            return ReducePlan(
                kind=p.kind, num_groups=p.num_groups, seg=put(p.seg)
            )

        reduce_plans = tuple(put_plan(p) for p in fam.reduce_plans)
    return Family(
        structure=fam.structure,
        loss=loss,
        batch=fam.batch,
        ambient_idx=tuple(put(a) for a in fam.ambient_idx),
        tangent_idx=tuple(put(a) for a in fam.tangent_idx),
        data=None
        if fam.data is None
        else jax.tree_util.tree_map(put, fam.data),
        residual_ids=fam.residual_ids,
        block_ids=fam.block_ids,
        bd_pos=tuple(put(b) for b in fam.bd_pos),
        mask=put(fam.mask),
        amb_pos=tuple(put(a) for a in fam.amb_pos),
        amb_tab=tuple(
            jax.device_put(t, NamedSharding(mesh, P())) for t in fam.amb_tab
        ),
        amb_slice=fam.amb_slice,
        reduce_plans=reduce_plans,
    )


def bucket_program(program: Program, bucket_size: Optional[int] = None):
    """Pad each family batch to a multiple of the evaluation bucket so
    large problems compile one fixed-size bucket body (see
    evaluator.EVAL_BUCKET_SIZE) instead of a problem-sized graph."""
    from ceres_tpu import evaluator as _ev

    b = bucket_size or _ev.EVAL_BUCKET_SIZE
    if b <= 0:
        return program
    dt = getattr(program, "eval_dtype", None)
    program.families = [
        pad_family(f, b, dtype=dt) if f.batch > b else f
        for f in program.families
    ]
    _invalidate_structure_caches(program)
    return program


def _invalidate_structure_caches(program: Program) -> None:
    """Drop every cached structure built on the OLD batch sizes /
    placements: the Schur structure, the per-options solve-aux cache
    (whose SchurStructure + reduce plans are batch-sized — stale entries
    would shape-error or silently mis-gather), and the device-resident
    block-diagonal group tables (their placement matters under a mesh)."""
    if hasattr(program, "_schur_structure"):
        del program._schur_structure
    if hasattr(program, "_solve_aux_cache"):
        del program._solve_aux_cache
    program._jnp_bd_groups = None


def replicate(x: jax.Array, mesh: Mesh) -> jax.Array:
    """Replicate an array over the whole mesh (the parameter vector)."""
    return jax.device_put(x, NamedSharding(mesh, P()))


def shard_program(
    program: Program, mesh: Mesh, axis_name: str = OBS_AXIS
) -> Program:
    """Shard a Program's residual families over ``mesh`` in place.

    Each family batch is padded to a multiple of the axis size and its
    batch-axis arrays are placed with ``NamedSharding``; subsequent jitted
    evaluations (Evaluator, trust-region step, Schur solves) are GSPMD-
    partitioned with collectives over the mesh — the whole-solve analog of
    ``Context::EnsureMinimumThreads`` + ``ParallelFor``.

    On a 2-D mesh (make_mesh_2d) the batch axis shards over BOTH mesh
    axes and the point (Schur e-block) system is constrained to the
    ``pt`` axis (see SchurStructure.point_sharding).
    """
    axes = [axis_name]
    if PT_AXIS in mesh.shape and axis_name != PT_AXIS:
        axes.append(PT_AXIS)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    batch_axes = tuple(axes) if len(axes) > 1 else axis_name
    dt = getattr(program, "eval_dtype", None)
    program.families = [
        _shard_family(
            pad_family(f, n, dtype=dt),
            mesh,
            batch_axes,
        )
        for f in program.families
    ]
    program.mesh = mesh
    program.mesh_axis = axis_name
    program.point_axis = PT_AXIS if len(axes) > 1 else None
    # Invalidate every cached structure built on unpadded/unsharded
    # batches (Schur structure, solve-aux cache, bd-group tables).
    _invalidate_structure_caches(program)
    return program
