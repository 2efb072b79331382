"""Schur-complement solvers for bundle-adjustment-structured problems.

JAX analog of the reference's Schur stack:
``schur_eliminator.h:52-216`` / ``schur_eliminator_impl.h`` (chunked
elimination of e-blocks), ``implicit_schur_complement.{h,cc}:75-145``
(matrix-free S·x), ``iterative_schur_complement_solver.cc:64-155`` (PCG on
the reduced camera system), ``schur_complement_solver.{h,cc}`` (dense
Schur), ``schur_jacobi_preconditioner.h:78`` and
``power_series_expansion_preconditioner.h:44``.

Design: the elimination ordering (e-blocks = points) is found by a greedy
maximal independent set over the block-sharing graph
(parameter_block_ordering.h:74-82). Everything else is expressed as
batched gathers + segment scatter-adds over the residual families:

    S x = (F'F + D_f^2) x - F'E (E'E + D_e^2)^{-1} E'F x

is four family-sized einsum passes plus one batched (Te,Te) Cholesky —
no per-chunk loop, no locks (the reference's rhs_locks_,
schur_eliminator.h:345-358, disappear because the scatter-add is one XLA
op). The dense S for DENSE_SCHUR is vmap(S·e_i) over identity columns:
one big batched computation instead of 43 generated specializations.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ceres_tpu.evaluator import JacobianContext
from ceres_tpu.linear.cg import CGResult, conjugate_gradients
from ceres_tpu.types import LinearSolverType, PreconditionerType


# ---------------------------------------------------------------------------
# Elimination ordering
# ---------------------------------------------------------------------------


# Auto-explicit-S bar: with few f coordinates (small camera count), CG's
# per-trip implicit S·x (4 family-wide Jacobian sweeps,
# implicit_schur_complement.cc:106-145) costs far more than ONE explicit
# assembly per linear solve + dense (nf, nf) matvecs. The reference
# leaves this to the user (use_explicit_schur_complement, solver.h:540-556
# "can result in a significant performance boost when the number of
# cameras is small"); here it is the default policy below this
# reduced-system size. The value is to be re-tuned on the GPU.
EXPLICIT_S_AUTO_MAX_NF = 2048


def compute_schur_ordering(program) -> List[int]:
    """Greedy maximal independent set of parameter blocks -> e-block pids.

    Analog of ComputeStableSchurOrdering (parameter_block_ordering.cc):
    e-blocks must not share a residual block with each other. Visiting
    blocks with the smallest tangent size first makes BA problems pick the
    points (3) over the cameras (9). Dispatches to the native C++ core
    (native/ceres_tpu_core.cpp schur_ordering) when available.
    """
    from ceres_tpu.utils import native

    nat = native.schur_ordering(program)
    if nat is not None:
        return nat
    # block -> list of (family_idx, instance) occurrences
    occurrences: Dict[int, List[Tuple[int, int]]] = {}
    for fi, fam in enumerate(program.families):
        for j in range(fam.block_ids.shape[1]):
            for i, pid in enumerate(fam.block_ids[:, j]):
                occurrences.setdefault(int(pid), []).append((fi, i))

    active = {
        rec.pid: rec for rec in program.blocks if not rec.constant
    }
    order = sorted(
        active.keys(),
        key=lambda pid: (active[pid].tangent_size, -len(occurrences.get(pid, []))),
    )
    instance_blocked: Dict[Tuple[int, int], bool] = {}
    e_blocks: List[int] = []
    for pid in order:
        occs = occurrences.get(pid, [])
        if any(instance_blocked.get(o, False) for o in occs):
            continue
        e_blocks.append(pid)
        for o in occs:
            instance_blocked[o] = True
    return e_blocks


@dataclasses.dataclass
class SchurStructure:
    """Index structure for Schur elimination (host-built once).

    Registered as a pytree and passed through jit as an ARGUMENT, never
    captured in closures: embedding these (P,Te)/(B,) index arrays as HLO
    literal constants makes compilation of large problems
    pathologically slow."""

    num_points: int
    e_tangent_size: int
    e_group: jax.Array  # (P, Te) tangent indices of e-blocks
    f_mask: jax.Array  # (num_tangent,) 1.0 on f coords, 0.0 on e coords
    f_idx: jax.Array  # (nf,) tangent indices of f coords
    # Per family: which arg is the e-block (or -1), and per-instance point
    # index (P = dropped/dummy for non-e or constant).
    e_arg: Tuple[int, ...]
    e_pos: Tuple[Optional[jax.Array], ...]  # (B,) int32 per family
    # f block-diagonal groups for SCHUR_JACOBI: {T: (G,T) idx}, plus per
    # family/arg positions and validity.
    f_groups: Dict[int, jax.Array]
    f_pos: Tuple[Tuple[Optional[jax.Array], ...], ...]  # [fam][arg] -> (B,)
    # Visibility clusters of f-blocks for CLUSTER_JACOBI/_TRIDIAGONAL
    # (canonical-views over shared e-blocks, single-linkage fallback):
    # (C, m) tangent coordinate index matrix padded with num_tangent, or
    # None.
    cluster_groups: Optional[jax.Array] = None
    # CLUSTER_TRIDIAGONAL chain structure: (num_chains, L) cluster ids
    # padded with C (dummy). Chains are the paths of the maximum-weight
    # linear forest over the cluster visibility graph
    # (visibility_based_preconditioner.h:127's forest, degree-limited to
    # 2 so the preconditioner is literally block tridiagonal and solves
    # with a batched block-Thomas scan).
    chain_clusters: Optional[jax.Array] = None
    # Segment-reduction plans (ceres_tpu.ops.reduce): per family for the
    # point (e) reductions, per family/arg for the camera (f) block
    # reductions — the scatter-free analog of the eliminator's per-chunk
    # accumulation (schur_eliminator_impl.h:228-330).
    e_plan: Optional[Tuple] = None
    f_plan: Optional[Tuple] = None
    # One-pass explicit assembly plan (schur_explicit.ExplicitSchurPlan),
    # built on demand for DENSE/SPARSE_SCHUR, explicit-S ITERATIVE_SCHUR
    # and Schur-marginal covariance.
    explicit: Optional[object] = None
    # 2-D mesh: NamedSharding constraining point-space intermediates
    # ((P, ...) arrays) to the 'pt' axis (parallel/sharding.make_mesh_2d).
    # Meta field: hashable, not traced.
    point_sharding: Optional[object] = None
    # Static contiguity of the e coordinates: (start,) when e_group is
    # one ascending range (BAL layout). Point-space gathers/scatters
    # then lower to dynamic slices instead of (P, Te) general
    # gathers/scatters, which are slow to compile at 200k points. Meta
    # field.
    e_slice: Optional[Tuple[int]] = None


jax.tree_util.register_dataclass(
    SchurStructure,
    data_fields=[
        "e_group", "f_mask", "f_idx", "e_pos", "f_groups", "f_pos",
        "cluster_groups", "chain_clusters", "e_plan", "f_plan", "explicit",
    ],
    meta_fields=[
        "num_points", "e_tangent_size", "e_arg", "point_sharding",
        "e_slice",
    ],
)


def build_schur_structure(
    program,
    ordering: Optional[List[int]] = None,
    with_clusters: bool = False,
    cluster_threshold: float = 0.1,
    with_explicit: bool = False,
    with_forest: bool = False,
) -> SchurStructure:
    """Build the index structure; ordering overrides the automatic one
    (the user elimination-group hint, include/ceres/ordered_groups.h).
    ``with_clusters`` additionally computes visibility clusters of the
    f-blocks (single_linkage_clustering.h:58) for the clustered
    preconditioners."""
    if ordering is None:
        e_pids = compute_schur_ordering(program)
    else:
        e_pids = [int(p) for p in ordering]
    if not e_pids:
        raise ValueError("no e-blocks found for Schur elimination")

    pblocks = {rec.pid: rec for rec in program.blocks}
    # Uniform e tangent size: keep the majority size.
    sizes = {}
    for pid in e_pids:
        sizes.setdefault(pblocks[pid].tangent_size, []).append(pid)
    Te, e_pids = max(sizes.items(), key=lambda kv: len(kv[1]))
    e_set = set(e_pids)

    point_index = {pid: i for i, pid in enumerate(e_pids)}
    P = len(e_pids)
    e_group = np.empty((P, Te), dtype=np.int32)
    for pid, i in point_index.items():
        off = program.tangent_offset[pid]
        e_group[i] = np.arange(off, off + Te, dtype=np.int32)

    eval_dtype = getattr(program, "eval_dtype", np.float64)
    f_mask = np.ones(program.num_tangent, dtype=eval_dtype)
    f_mask[e_group.reshape(-1)] = 0.0
    f_idx = np.nonzero(f_mask > 0)[0].astype(np.int32)

    # f block-diagonal groups (f blocks only).
    f_rows: Dict[int, List[np.ndarray]] = {}
    f_pos_of_pid: Dict[int, Tuple[int, int]] = {}
    for rec in program.blocks:
        if rec.constant or rec.pid in e_set:
            continue
        T = rec.tangent_size
        off = program.tangent_offset[rec.pid]
        rows = f_rows.setdefault(T, [])
        f_pos_of_pid[rec.pid] = (T, len(rows))
        rows.append(np.arange(off, off + T, dtype=np.int32))
    f_groups = {T: jnp.asarray(np.stack(rows)) for T, rows in f_rows.items()}
    f_group_sizes = {T: len(rows) for T, rows in f_rows.items()}

    const_set = {rec.pid for rec in program.blocks if rec.constant}
    # pid -> flag/index lookup tables so the per-observation scans below
    # are vectorized numpy gathers, not Python loops over 10^5 elements
    # (and never touch the device: structure building is host-only).
    max_pid = max(rec.pid for rec in program.blocks)
    in_e_lut = np.zeros(max_pid + 2, dtype=bool)
    in_e_lut[np.fromiter(e_set, dtype=np.int64)] = True
    const_lut = np.zeros(max_pid + 2, dtype=bool)
    if const_set:
        const_lut[np.fromiter(const_set, dtype=np.int64)] = True
    pt_idx_lut = np.full(max_pid + 2, P, dtype=np.int32)
    for pid, i in point_index.items():
        pt_idx_lut[pid] = i
    fpos_lut = {
        T: np.full(max_pid + 2, n, dtype=np.int32)
        for T, n in f_group_sizes.items()
    }
    for pid, (T, row) in f_pos_of_pid.items():
        fpos_lut[T][pid] = row

    e_arg: List[int] = []
    e_pos: List[Optional[np.ndarray]] = []
    f_pos: List[Tuple[Optional[np.ndarray], ...]] = []
    for fam in program.families:
        bids = np.asarray(fam.block_ids)
        ea = -1
        ep = None
        for j in range(bids.shape[1]):
            col = bids[:, j]
            in_e = in_e_lut[col]
            if in_e.any():
                # Constant blocks are variable-free: they may share an
                # e-column (their contributions drop at the dummy index).
                if not np.all(in_e | const_lut[col]):
                    raise ValueError(
                        "mixed e/f blocks in one family argument position; "
                        "regroup the problem or provide an explicit ordering"
                    )
                if ea != -1:
                    raise ValueError(
                        "two e-blocks in one residual block — invalid "
                        "elimination ordering (schur_eliminator.h:143)"
                    )
                ea = j
                ep = pt_idx_lut[col]
        e_arg.append(ea)
        e_pos.append(ep)

        fp: List[Optional[np.ndarray]] = []
        for j in range(bids.shape[1]):
            if j == ea:
                fp.append(None)
                continue
            col = bids[:, j]
            T = fam.structure.tangent_sizes[j]
            dummy = f_group_sizes.get(T, 0)
            lut = fpos_lut.get(T)
            if lut is None:
                pos = np.full(col.shape[0], dummy, dtype=np.int32)
            else:
                pos = lut[col]
            fp.append(pos)
        f_pos.append(tuple(fp))

    cluster_groups = None
    chain_clusters = None
    if with_clusters:
        built = _build_cluster_groups(
            program,
            e_set,
            point_index,
            f_pos_of_pid,
            cluster_threshold,
            with_forest=with_forest,
        )
        if built is not None:
            cluster_groups, chain_clusters = built

    # Scatter-free reduction plans (one-hot matmul / ELL gather+sum).
    from ceres_tpu.ops.reduce import build_reduce_plan

    e_plan = tuple(
        build_reduce_plan(np.asarray(ep), P)
        if ep is not None
        else None
        for ep in e_pos
    )
    f_plan = []
    for fi, fam in enumerate(program.families):
        plans = []
        for j in range(fam.block_ids.shape[1]):
            fp = f_pos[fi][j]
            if fp is None:
                plans.append(None)
            else:
                T = fam.structure.tangent_sizes[j]
                plans.append(
                    build_reduce_plan(
                        np.asarray(fp), f_group_sizes.get(T, 0)
                    )
                )
        f_plan.append(tuple(plans))

    e_flat = e_group.ravel()
    e_slice = None
    if e_flat.size and np.array_equal(
        e_flat,
        np.arange(e_flat[0], e_flat[0] + e_flat.size, dtype=e_flat.dtype),
    ):
        e_slice = (int(e_flat[0]),)

    ss = SchurStructure(
        num_points=P,
        e_tangent_size=Te,
        e_slice=e_slice,
        e_group=jnp.asarray(e_group),
        f_mask=jnp.asarray(f_mask),
        f_idx=jnp.asarray(f_idx),
        e_arg=tuple(e_arg),
        # one-way host->device: pytree leaves must be device arrays (a
        # numpy leaf would re-transfer on every jitted call).
        e_pos=tuple(
            jnp.asarray(ep) if ep is not None else None for ep in e_pos
        ),
        f_groups=f_groups,
        f_pos=tuple(
            tuple(jnp.asarray(p) if p is not None else None for p in fp)
            for fp in f_pos
        ),
        cluster_groups=cluster_groups,
        chain_clusters=chain_clusters,
        e_plan=e_plan,
        f_plan=tuple(f_plan),
        point_sharding=_point_sharding_of(program),
    )
    # Host-side numpy copies for plan builders (schur_explicit,
    # covariance): plain attributes, not pytree fields — they never cross
    # into jit and avoid device->host round trips over slow links.
    ss._host_e_pos = tuple(e_pos)
    ss._host_f_pos = tuple(f_pos)
    if with_explicit:
        from ceres_tpu.linear.schur_explicit import build_explicit_plan

        ss.explicit = build_explicit_plan(program, ss)
    return ss


def _point_sharding_of(program):
    """NamedSharding for point-space (P, ...) arrays when the program is
    sharded over a 2-D mesh with a 'pt' axis; None otherwise."""
    mesh = getattr(program, "mesh", None)
    pt = getattr(program, "point_axis", None)
    if mesh is None or pt is None:
        return None
    from jax.sharding import NamedSharding, PartitionSpec

    return NamedSharding(mesh, PartitionSpec(pt))


def ensure_explicit_plan(program, ss: SchurStructure) -> SchurStructure:
    """Attach the one-pass assembly plan to ``ss`` if missing."""
    if ss.explicit is None:
        from ceres_tpu.linear.schur_explicit import build_explicit_plan

        ss.explicit = build_explicit_plan(program, ss)
    return ss


def _build_cluster_groups(
    program, e_set, point_index, f_pos_of_pid, threshold, with_forest=False
):
    """Visibility clusters of f-blocks -> padded (C, m) tangent
    coordinate matrix, plus (optionally) the CLUSTER_TRIDIAGONAL chain
    structure.

    Clustering is canonical views (canonical_views_clustering.h:98, the
    algorithm visibility_based_preconditioner.cc actually uses) with
    single-linkage (single_linkage_clustering.h:58) as fallback, both in
    the native core. With ``with_forest`` the maximum-weight linear
    forest over the cluster graph is decomposed into paths -> a padded
    (num_chains, L) cluster-id matrix (singleton clusters are length-1
    chains, so every cluster appears in exactly one chain).
    Returns (cluster_mat, chains_mat_or_None) or None.
    """
    from ceres_tpu.utils import native

    f_pids = sorted(f_pos_of_pid.keys())
    cam_dense = {pid: i for i, pid in enumerate(f_pids)}
    cam_idx, pt_idx = [], []
    for fam in program.families:
        ids = np.asarray(fam.block_ids)
        e_cols = [
            j
            for j in range(ids.shape[1])
            if int(ids[0, j]) in e_set
        ]
        if not e_cols:
            continue
        ej = e_cols[0]
        for j in range(ids.shape[1]):
            if j == ej:
                continue
            for b in range(ids.shape[0]):
                pid = int(ids[b, j])
                if pid in cam_dense:
                    cam_idx.append(cam_dense[pid])
                    pt_idx.append(point_index.get(int(ids[b, ej]), 0))
    if not cam_idx:
        return None
    cam_arr = np.asarray(cam_idx, dtype=np.int64)
    pt_arr = np.asarray(pt_idx, dtype=np.int64)
    n_pt = int(pt_arr.max()) + 1
    out = native.canonical_views_clusters(
        len(f_pids), n_pt, cam_arr, pt_arr
    )
    if out is None:
        out = native.camera_clusters(
            len(f_pids), n_pt, cam_arr, pt_arr, threshold=threshold
        )
    if out is None:
        # native core unavailable: every f-block is its own cluster
        # (degenerates to SCHUR_JACOBI semantics)
        nclusters, cluster = len(f_pids), np.arange(len(f_pids))
    else:
        nclusters, cluster = out
    # gather tangent coords per cluster, pad with num_tangent (dummy)
    pblocks = {rec.pid: rec for rec in program.blocks}
    members = [[] for _ in range(nclusters)]
    for pid in f_pids:
        members[cluster[cam_dense[pid]]].append(pid)
    rows = []
    for pids in members:
        coords = []
        for pid in pids:
            off = program.tangent_offset[pid]
            coords.extend(range(off, off + pblocks[pid].tangent_size))
        rows.append(coords)
    m = max(len(r) for r in rows)
    mat = np.full((nclusters, m), program.num_tangent, dtype=np.int32)
    for i, r in enumerate(rows):
        mat[i, : len(r)] = r

    chains_mat = None
    if with_forest and nclusters > 1:
        forest = native.cluster_linear_forest(
            nclusters,
            n_pt,
            np.asarray(cluster, dtype=np.int64)[cam_arr],
            pt_arr,
        )
        ea, eb = forest if forest is not None else (
            np.zeros(0, np.int32), np.zeros(0, np.int32)
        )
        # Decompose the linear forest into paths: degree <= 2 and
        # acyclic, so following edges from degree-<=1 endpoints walks
        # every chain; untouched clusters are singletons.
        adj = [[] for _ in range(nclusters)]
        for a, b in zip(ea, eb):
            adj[int(a)].append(int(b))
            adj[int(b)].append(int(a))
        visited = [False] * nclusters
        chains = []
        for c in range(nclusters):
            if visited[c] or len(adj[c]) > 1:
                continue
            path = [c]
            visited[c] = True
            cur = c
            while True:
                nxt = [n for n in adj[cur] if not visited[n]]
                if not nxt:
                    break
                cur = nxt[0]
                visited[cur] = True
                path.append(cur)
            chains.append(path)
        for c in range(nclusters):  # leftover (shouldn't happen: acyclic)
            if not visited[c]:
                visited[c] = True
                chains.append([c])
        L = max(len(ch) for ch in chains)
        chains_mat = np.full((len(chains), L), nclusters, dtype=np.int32)
        for i, ch in enumerate(chains):
            chains_mat[i, : len(ch)] = ch
        chains_mat = jnp.asarray(chains_mat)
    return jnp.asarray(mat), chains_mat


# ---------------------------------------------------------------------------
# Implicit Schur operators (implicit_schur_complement.cc:49-230)
# ---------------------------------------------------------------------------


class SchurOperator:
    """Bundle of Schur-space linear maps for one (ctx, D) pair.

    Vectors live in full tangent length; e coords are kept at zero for
    f-space vectors. One instance per LM solve (factors the (Te,Te)
    point blocks once, implicit_schur_complement.cc:49 Init).
    """

    def __init__(self, ctx: JacobianContext, D: jax.Array, ss: SchurStructure):
        self.ctx = ctx
        self.ss = ss
        self.D = D
        Te, P = ss.e_tangent_size, ss.num_points

        # Assemble E'E + D_e^2 per point, FLAT (P, Te*Te) until the tiny
        # final reshape (a materialized (B, Te, Te) trailing pair
        # tile-pads to (8,128) in XLA — the r5 layout rule).
        from ceres_tpu.linear.schur_explicit import _flat_pair_product

        dt = ctx.residuals[0].dtype
        self.dtype = dt
        ete_f = jnp.zeros((P, Te * Te), dtype=dt)
        for fi, fam in enumerate(ctx.families):
            ea = ss.e_arg[fi]
            if ea < 0:
                continue
            E = ctx.jacs[fi][ea]  # (B, r, Te)
            contrib = _flat_pair_product(E, E)  # (B, Te*Te)
            ete_f = ete_f + self._reduce_e(fi, contrib)
        ete = ete_f.reshape(P, Te, Te)
        De = self._gather_e(D)  # (P, Te)
        ete = ete + jax.vmap(jnp.diag)(De * De)
        # Explicit SPD inverse of the point blocks (invert_psd_matrix.h:44,
        # schur_eliminator_impl.h e-block inversion): closed-form for the
        # tiny sizes, so every downstream solve is one einsum that XLA
        # fuses into the CG loop, instead of a batched XLA
        # Cholesky/TriangularSolve on (P, 3, 3) operands.
        from ceres_tpu.ops.small_linalg import spd_inverse

        self._ete_inv = self._constrain_pt(spd_inverse(ete))

    def _constrain_pt(self, a: jax.Array) -> jax.Array:
        """Pin a point-space (P, ...) array to the mesh's 'pt' axis (2-D
        mesh layout, parallel/sharding.make_mesh_2d): with observations
        sorted by point, the E'w reductions and (E'E)^-1 applies stay
        local to the pt column and only the reduced camera system is
        all-reduced across the mesh."""
        if self.ss.point_sharding is None:
            return a
        return jax.lax.with_sharding_constraint(a, self.ss.point_sharding)

    def _gather_e(self, v: jax.Array) -> jax.Array:
        """(P, Te) view of the e coordinates of a tangent vector —
        dynamic_slice when e_slice says they are contiguous (cheaper to
        compile than a (P, Te) general gather)."""
        ss = self.ss
        if ss.e_slice is not None:
            (start,) = ss.e_slice
            n = ss.num_points * ss.e_tangent_size
            return jax.lax.dynamic_slice(v, (start,), (n,)).reshape(
                ss.num_points, ss.e_tangent_size
            )
        return v[ss.e_group]

    def _reduce_e(self, fi: int, contrib: jax.Array) -> jax.Array:
        """Sum per-instance contributions into per-point slots (P, ...):
        plan-based when available, scatter-add fallback."""
        ss = self.ss
        if ss.e_plan is not None and ss.e_plan[fi] is not None:
            from ceres_tpu.ops.reduce import apply_reduce

            return self._constrain_pt(
                apply_reduce(ss.e_plan[fi], contrib)[: ss.num_points]
            )
        out = jnp.zeros(
            (ss.num_points,) + contrib.shape[1:], dtype=contrib.dtype
        )
        return self._constrain_pt(
            out.at[ss.e_pos[fi]].add(contrib, mode="drop")
        )

    # -- primitive products -------------------------------------------------

    def _edot(self, w: Tuple[jax.Array, ...]) -> jax.Array:
        """E' w aggregated per point -> (P, Te)."""
        ss, ctx = self.ss, self.ctx
        t = jnp.zeros(
            (ss.num_points, ss.e_tangent_size), dtype=self.dtype
        )
        for fi, fam in enumerate(ctx.families):
            ea = ss.e_arg[fi]
            if ea < 0:
                continue
            E = ctx.jacs[fi][ea]
            t = t + self._reduce_e(
                fi, jnp.einsum("bri,br->bi", E, w[fi])
            )
        return t

    def _solve_ete(self, t: jax.Array) -> jax.Array:
        """(E'E + D_e^2)^{-1} t, batched (P, Te) — one einsum."""
        return jnp.einsum("pij,pj->pi", self._ete_inv, t)

    def _embed_e(self, u: jax.Array) -> jax.Array:
        """(P, Te) point vector -> full tangent vector (zero on f)."""
        z = jnp.zeros((self.ctx.num_tangent,), dtype=self.dtype)
        ss = self.ss
        if ss.e_slice is not None:
            (start,) = ss.e_slice
            return jax.lax.dynamic_update_slice(
                z, u.astype(self.dtype).reshape(-1), (start,)
            )
        return z.at[ss.e_group].set(u, unique_indices=True)

    def _e_times(self, u: jax.Array) -> Tuple[jax.Array, ...]:
        """E u for a point-space vector u (P, Te) -> per-family (B, r)
        residual blocks (partitioned_matrix_view.h
        RightMultiplyAndAccumulateE): one row gather of u per family —
        no full-tangent embed/gather round trip."""
        ctx, ss = self.ctx, self.ss
        u_pad = jnp.concatenate(
            [u, jnp.zeros((1, ss.e_tangent_size), u.dtype)], axis=0
        )
        out = []
        for fi, fam in enumerate(ctx.families):
            ea = ss.e_arg[fi]
            if ea < 0:
                out.append(
                    jnp.zeros((fam.batch, fam.residual_size), u.dtype)
                )
                continue
            uj = u_pad[ss.e_pos[fi]]  # (B, Te)
            out.append(jnp.einsum("brt,bt->br", ctx.jacs[fi][ea], uj))
        return tuple(out)

    # -- Schur products (implicit_schur_complement.cc:106-145) --------------
    # All products are PARTITIONED (partitioned_matrix_view.h): the F side
    # skips the e-arg columns, the E side touches only the e-arg — the
    # implicit CG loop never evaluates full-J products.

    def s_times(self, x: jax.Array) -> jax.Array:
        """S x for x supported on f coords (full-length vector)."""
        ctx, ss, D = self.ctx, self.ss, self.D
        x = x * ss.f_mask
        w1 = ctx.matvec(x, skip=ss.e_arg)  # F x (per family, (B, r))
        t = self._edot(w1)
        u = self._solve_ete(t)
        w2 = self._e_times(u)  # E (E'E)^-1 E' F x
        diff = tuple(a - b for a, b in zip(w1, w2))
        out = ctx.rmatvec(diff, skip=ss.e_arg) + (D * D) * x
        return out * ss.f_mask

    def rhs(self) -> jax.Array:
        """Reduced rhs: F'f - F'E (E'E)^{-1} E'f
        (implicit_schur_complement.cc:160-180)."""
        ctx, ss = self.ctx, self.ss
        t = self._edot(ctx.residuals)
        u = self._solve_ete(t)
        w2 = self._e_times(u)
        diff = tuple(a - b for a, b in zip(ctx.residuals, w2))
        return ctx.rmatvec(diff, skip=ss.e_arg) * ss.f_mask

    def rhs_from_tangent(self, r: jax.Array) -> jax.Array:
        """Reduced rhs for an arbitrary tangent-space rhs r = [r_e; r_f]:
        r_f - F'E (E'E + De^2)^{-1} r_e. Backs mixed-precision iterative
        refinement of Schur solves."""
        ss = self.ss
        r_e = self._gather_e(r)  # (P, Te)
        u = self._solve_ete(r_e)
        w = self._e_times(u)  # E u in residual space
        corr = self.ctx.rmatvec(w, skip=ss.e_arg)  # F'E u
        return (r - corr) * ss.f_mask

    def back_substitute_tangent(self, x_f: jax.Array, r: jax.Array) -> jax.Array:
        """e-part for arbitrary tangent rhs: y_e = (E'E+De^2)^{-1}
        (r_e - E'F x_f)."""
        ss = self.ss
        x_f = x_f * ss.f_mask
        EtFx = self._edot(self.ctx.matvec(x_f, skip=ss.e_arg))  # (P, Te)
        u = self._solve_ete(self._gather_e(r) - EtFx)
        return x_f + self._embed_e(u)

    def back_substitute(self, x_f: jax.Array) -> jax.Array:
        """Recover e (point) part: y = (E'E)^{-1} E'(f - F x)
        (implicit_schur_complement.cc:208)."""
        ctx, ss = self.ctx, self.ss
        x_f = x_f * ss.f_mask
        Jx = ctx.matvec(x_f, skip=ss.e_arg)
        diff = tuple(r - w for r, w in zip(ctx.residuals, Jx))
        t = self._edot(diff)
        u = self._solve_ete(t)
        return x_f + self._embed_e(u)

    # -- preconditioners -----------------------------------------------------

    def schur_jacobi_blocks(self) -> Dict[int, jax.Array]:
        """Block diagonal of S over f blocks (schur_jacobi_preconditioner.h:78).

        Exact when each (e-block, f-block) pair shares at most one residual
        instance (true for BA: one observation per camera-point pair).
        """
        ctx, ss, D = self.ctx, self.ss, self.D
        out = {
            T: jnp.zeros((idx.shape[0], T, T), dtype=self.dtype)
            for T, idx in ss.f_groups.items()
        }
        inv_ete = self._ete_inv
        # zero row at index P: instances whose e-slot is a constant block
        # (e_pos == num_points) must contribute no correction
        inv_ete = jnp.concatenate(
            [inv_ete, jnp.zeros((1,) + inv_ete.shape[1:], inv_ete.dtype)]
        )
        from ceres_tpu.ops.reduce import apply_reduce

        from ceres_tpu.linear.schur_explicit import (
            _flat_apply_minv,
            _flat_outer,
            _flat_pair_product,
        )

        Te = ss.e_tangent_size
        inv_flat = inv_ete.reshape(inv_ete.shape[0], -1)
        for fi, fam in enumerate(ctx.families):
            ea = ss.e_arg[fi]
            for j in range(fam.num_args):
                if j == ea:
                    continue
                T = fam.structure.tangent_sizes[j]
                if T not in out:
                    continue
                F = ctx.jacs[fi][j]  # (B, r, T)
                # FLAT (B, T*T) contributions end-to-end: a trailing
                # (.., T, T) pair of dims tile-pads to (8,128)+ in XLA
                # (the r5 layout rule, see schur_explicit.py).
                contrib = _flat_pair_product(F, F)
                if ea >= 0:
                    E = ctx.jacs[fi][ea]  # (B, r, Te)
                    w = _flat_pair_product(E, F)  # (B, Te*T)
                    m = inv_flat[ss.e_pos[fi]]  # (B, Te*Te)
                    y = _flat_apply_minv(m, w, Te, T)
                    contrib = contrib - _flat_outer(w, y, Te, T, T)
                if ss.f_plan is not None and ss.f_plan[fi][j] is not None:
                    red = apply_reduce(ss.f_plan[fi][j], contrib)[
                        : out[T].shape[0]
                    ]
                    out[T] = out[T] + red.reshape(-1, T, T)
                else:
                    out[T] = out[T].at[ss.f_pos[fi][j]].add(
                        contrib.reshape(-1, T, T), mode="drop"
                    )
        # Add D^2 on the f diagonal.
        for T, idx in ss.f_groups.items():
            Df = D[idx]
            out[T] = out[T] + jax.vmap(jnp.diag)(Df * Df)
        return out

    def schur_jacobi_preconditioner(self):
        from ceres_tpu.ops.small_linalg import spd_inverse

        blocks = self.schur_jacobi_blocks()
        inverses = {T: spd_inverse(b) for T, b in blocks.items()}
        return self._block_diag_apply(inverses)

    def schur_jacobi_preconditioner_from_dense(self, S: jax.Array):
        """SCHUR_JACOBI built by EXTRACTING the f block diagonal from an
        already-materialized dense S (damping included) instead of
        re-running the implicit block pass — the blocks ARE S's diagonal
        cells (schur_jacobi_preconditioner.h:78 semantics). Used on the
        explicit-S iterative path, where S is in hand anyway."""
        from ceres_tpu.ops.small_linalg import spd_inverse

        ss = self.ss
        fr = ss.explicit.f_reduced  # tangent coord -> reduced (nf = none)
        nf = S.shape[0]
        inverses = {}
        for T, idx in ss.f_groups.items():
            r = fr[idx]  # (G, T) reduced coords
            valid = jnp.all(r < nf, axis=1)
            rc = jnp.where(r < nf, r, 0)
            blocks = S[rc[:, :, None], rc[:, None, :]]
            eye = jnp.eye(T, dtype=S.dtype)
            # constant/inactive blocks: identity (masked out at apply)
            blocks = jnp.where(valid[:, None, None], blocks, eye)
            inverses[T] = spd_inverse(blocks)
        return self._block_diag_apply(inverses)

    def _block_diag_apply(self, inverses: Dict[int, jax.Array]):
        ss = self.ss

        def apply(v: jax.Array) -> jax.Array:
            out = jnp.zeros_like(v)
            for T, idx in ss.f_groups.items():
                vb = v[idx]
                sol = jnp.einsum("gij,gj->gi", inverses[T], vb)
                out = out.at[idx].set(sol)
            return out * ss.f_mask

        return apply

    def clustered_preconditioner(self, cluster_groups):
        """Visibility-clustered block preconditioner
        (visibility_based_preconditioner.h:127, CLUSTER_JACOBI):
        block-diagonal of S over camera CLUSTERS instead of single
        cameras. ``cluster_groups`` is a (C, m) int32 matrix of tangent
        coordinate indices per cluster, padded with ``num_tangent``
        (dummy). Blocks are extracted exactly by batched S·e_i products
        (one vmapped computation — the replacement for the
        reference's per-cluster sparse factorization) and factorized with
        a batched Cholesky.
        """
        n = self.ctx.num_tangent
        dt = self.dtype
        C, m = cluster_groups.shape

        def column(i):
            e = jnp.zeros((n + 1,), dtype=dt).at[i].set(1.0)[:n]
            return self.s_times(e)

        # (C, m, n) columns of S for every cluster coordinate.
        cols = jax.vmap(jax.vmap(column))(cluster_groups)
        pad = jnp.concatenate([cols, jnp.zeros((C, m, 1), dtype=dt)], axis=2)
        # Extract the (m, m) cluster blocks; dummy coords get identity.
        sub = jax.vmap(lambda block, idx: block[:, idx])(pad, cluster_groups)
        is_dummy = cluster_groups >= n  # (C, m)
        eye = jnp.eye(m, dtype=dt)
        sub = jnp.where(
            (is_dummy[:, :, None] | is_dummy[:, None, :]),
            eye[None, :, :],
            sub,
        )
        from ceres_tpu.ops.small_linalg import spd_inverse

        inverses = spd_inverse(sub)
        ss = self.ss

        def apply(v: jax.Array) -> jax.Array:
            v_pad = jnp.concatenate([v, jnp.zeros((1,), v.dtype)])
            vb = v_pad[cluster_groups]  # (C, m)
            sol = jnp.einsum("cij,cj->ci", inverses, vb)
            out = jnp.zeros((n + 1,), dtype=v.dtype)
            out = out.at[cluster_groups].set(sol)
            return out[:n] * ss.f_mask

        return apply

    def cluster_tridiagonal_preconditioner(
        self, cluster_groups: jax.Array, chain_clusters: jax.Array
    ):
        """CLUSTER_TRIDIAGONAL (visibility_based_preconditioner.h:127):
        M = block tridiagonal part of S along the maximum-weight linear
        forest of the cluster visibility graph.

        Batched shape: the forest is degree-limited to paths (host side), so
        M decomposes into independent block-tridiagonal chains. Diagonal
        blocks A_k and sub-diagonal blocks B_k are extracted with batched
        S.e_i probes, factorized as a block LDL' via one lax.scan per
        chain level (vmapped over chains, batched m x m matmuls), and
        applied with forward/backward block-Thomas sweeps — the batched
        analog of the reference's sparse Cholesky of M
        (visibility_based_preconditioner.cc Factorize).
        """
        from ceres_tpu.ops.small_linalg import spd_inverse

        n = self.ctx.num_tangent
        dt = self.dtype
        C, m = cluster_groups.shape
        K, L = chain_clusters.shape

        def column(i):
            e = jnp.zeros((n + 1,), dtype=dt).at[i].set(1.0)[:n]
            return self.s_times(e)

        # (C, m, n) probed columns of S per cluster coordinate.
        cols = jax.vmap(jax.vmap(column))(cluster_groups)
        pad_cols = jnp.concatenate(
            [cols, jnp.zeros((C, m, 1), dtype=dt)], axis=2
        )
        is_dummy = cluster_groups >= n  # (C, m)
        eye = jnp.eye(m, dtype=dt)

        # Diagonal blocks A_c = S[coords_c, coords_c], identity on dummies.
        diag = jax.vmap(lambda block, idx: block[:, idx])(
            pad_cols, cluster_groups
        )
        diag = jnp.where(
            (is_dummy[:, :, None] | is_dummy[:, None, :]), eye[None], diag
        )
        # Dummy cluster row (id C): identity block, dummy coords.
        diag = jnp.concatenate([diag, eye[None]], axis=0)  # (C+1, m, m)
        coords_pad = jnp.concatenate(
            [cluster_groups, jnp.full((1, m), n, jnp.int32)], axis=0
        )
        dummy_pad = jnp.concatenate(
            [is_dummy, jnp.ones((1, m), bool)], axis=0
        )
        cols_pad = jnp.concatenate(
            [pad_cols, jnp.zeros((1, m, n + 1), dtype=dt)], axis=0
        )

        # Per chain: A_seq (L, m, m), B_seq (L, m, m) with
        # B_k = S[coords_{k}, coords_{k-1}] (B_0 = 0).
        A_seq = diag[chain_clusters]  # (K, L, m, m)

        def chain_offdiag(chain):
            prev = chain[:-1]
            cur = chain[1:]
            # S[coords_cur, coords_prev] = cols[prev][:, coords_cur].T
            blocks = cols_pad[prev]  # (L-1, m, n+1)
            cc = coords_pad[cur]  # (L-1, m)
            sub = jax.vmap(lambda b, idx: b[:, idx].T)(blocks, cc)
            # zero when either side is dummy
            dz = dummy_pad[prev][:, None, :] | dummy_pad[cur][:, :, None]
            sub = jnp.where(dz, 0.0, sub)
            return jnp.concatenate(
                [jnp.zeros((1, m, m), dtype=dt), sub], axis=0
            )  # (L, m, m)

        B_seq = jax.vmap(chain_offdiag)(chain_clusters)  # (K, L, m, m)

        # Block LDL' along each chain: D_1 = A_1,
        # W_k = B_k D_{k-1}^{-1}, D_k = A_k - W_k B_k'.
        #
        # The tridiagonal truncation of an SPD matrix need not be SPD
        # (strong coupling through dropped blocks) — the reference's
        # sparse Cholesky of M fails there too
        # (visibility_based_preconditioner.cc Factorize returning
        # failure). Guard per link: when a chain Schur complement D_k
        # stops being SPD, drop that link's coupling (W_k = 0) and
        # restart from A_k — the chain splits, degrading locally toward
        # CLUSTER_JACOBI while M stays SPD.
        def factor(A_seq, B_seq):
            def step(Dinv_prev, inp):
                A, B = inp
                W = B @ Dinv_prev
                D = A - W @ jnp.swapaxes(B, -1, -2)
                Dinv = spd_inverse(D)
                bad = ~jnp.all(jnp.isfinite(Dinv))
                # cheap positive-definiteness probe: v'Dv > 0 for a few
                # deterministic directions (diag must be positive too)
                bad = bad | jnp.any(jnp.diagonal(D) <= 0.0)
                Dinv_safe = jnp.where(bad, spd_inverse(A), Dinv)
                W_safe = jnp.where(bad, jnp.zeros_like(W), W)
                return Dinv_safe, (Dinv_safe, W_safe)

            Dinv0 = spd_inverse(A_seq[0])
            _, (Dinvs, Ws) = jax.lax.scan(
                step, Dinv0, (A_seq[1:], B_seq[1:])
            )
            Dinvs = jnp.concatenate([Dinv0[None], Dinvs], axis=0)
            Ws = jnp.concatenate([jnp.zeros((1, m, m), dt), Ws], axis=0)
            return Dinvs, Ws

        Dinvs, Ws = jax.vmap(factor)(A_seq, B_seq)  # (K, L, m, m)

        def apply(v: jax.Array) -> jax.Array:
            v_pad = jnp.concatenate([v, jnp.zeros((1,), v.dtype)])
            vc = v_pad[cluster_groups]  # (C, m)
            vc = jnp.concatenate([vc, jnp.zeros((1, m), v.dtype)], axis=0)
            vk = vc[chain_clusters]  # (K, L, m)

            def solve_chain(vk, Dinvs, Ws):
                # forward: y_k = v_k - W_k y_{k-1}
                def fwd(y_prev, inp):
                    v_k, W_k = inp
                    y = v_k - W_k @ y_prev
                    return y, y

                y0 = vk[0]
                _, ys = jax.lax.scan(fwd, y0, (vk[1:], Ws[1:]))
                ys = jnp.concatenate([y0[None], ys], axis=0)
                zs = jnp.einsum("lij,lj->li", Dinvs, ys)

                # backward: x_k = z_k - W_{k+1}' x_{k+1}
                def bwd(x_next, inp):
                    z_k, W_next = inp
                    x = z_k - jnp.swapaxes(W_next, -1, -2) @ x_next
                    return x, x

                xL = zs[-1]
                _, xs = jax.lax.scan(
                    bwd, xL, (zs[:-1], Ws[1:]), reverse=True
                )
                return jnp.concatenate([xs, xL[None]], axis=0)

            xk = jax.vmap(solve_chain)(vk, Dinvs, Ws)  # (K, L, m)
            # scatter back: every real cluster appears exactly once
            out = jnp.zeros((n + 1,), dtype=v.dtype)
            flat_coords = coords_pad[chain_clusters]  # (K, L, m)
            out = out.at[flat_coords.reshape(-1)].set(
                xk.reshape(-1), mode="drop"
            )
            return out[:n] * self.ss.f_mask

        return apply

    def power_series_preconditioner(
        self, num_terms: int, tolerance: float = 0.0
    ):
        """Truncated Neumann series S^{-1} ~ sum_k (I - M^-1 S)^k M^-1 with
        M = block-Jacobi of S (power_series_expansion_preconditioner.h:44,
        Weber et al. power bundle adjustment).

        Truncation follows the reference
        (power_series_expansion_preconditioner.cc:60-84): after the
        leading M^{-1} v term, series terms are accumulated until either
        ``num_terms`` terms were added or the latest term's norm drops
        below ``tolerance * ||M^{-1} v||``. ``tolerance = 0`` reproduces
        the fixed-count truncation exactly.
        """
        bj = self.schur_jacobi_preconditioner()

        def apply(v: jax.Array) -> jax.Array:
            y0 = bj(v)
            threshold = jnp.asarray(tolerance, y0.dtype) * jnp.linalg.norm(
                y0
            )

            def cond(state):
                i, _, term_norm = state
                return (i < num_terms) & (term_norm >= threshold)

            def body(state):
                i, acc, _ = state
                term = bj(v - self.s_times(acc))
                return i + 1, acc + term, jnp.linalg.norm(term)

            _, acc, _ = jax.lax.while_loop(
                cond,
                body,
                (jnp.asarray(0, jnp.int32), y0, jnp.asarray(jnp.inf, y0.dtype)),
            )
            return acc

        return apply

    # -- dense S -------------------------------------------------------------

    def dense_reduced_system(self) -> Tuple[jax.Array, jax.Array, jax.Array]:
        """Materialize S on the f coordinates as a dense matrix.

        One-pass explicit assembly (schur_explicit.assemble_reduced_system,
        the analog of schur_eliminator_impl.h:177-330) when the structure
        carries an assembly plan; falls back to probing S column-by-column
        with vmap(S . e_i) otherwise. Returns (S (nf, nf), rhs (nf,),
        f_idx (nf,)).
        """
        ss = self.ss
        if ss.explicit is not None:
            from ceres_tpu.linear.schur_explicit import (
                assemble_reduced_system,
            )

            S = assemble_reduced_system(self, ss.explicit)
            rhs = self.rhs()[ss.f_idx]
            return S, rhs, ss.f_idx
        return self.dense_reduced_system_probe()

    def dense_reduced_system_probe(
        self,
    ) -> Tuple[jax.Array, jax.Array, jax.Array]:
        """Reference/debug path: S via vmap(S . e_i) identity probes —
        O(nf) full Jacobian passes; kept for cross-checking the one-pass
        assembler (cross-implementation equivalence, SURVEY §4.4)."""
        ss = self.ss
        f_idx = ss.f_idx
        n = self.ctx.num_tangent

        def col(i):
            e = jnp.zeros((n,), dtype=self.ctx.residuals[0].dtype).at[i].set(1.0)
            return self.s_times(e)[f_idx]

        S = jax.vmap(col)(f_idx).T  # columns stacked
        rhs = self.rhs()[f_idx]
        return S, rhs, f_idx


# ---------------------------------------------------------------------------
# Entry point used by the trust-region step function
# ---------------------------------------------------------------------------


def solve_schur(
    ctx: JacobianContext,
    D: jax.Array,
    program,
    options,
    ss: Optional[SchurStructure] = None,
    rhs: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Solve min ||J y - f||^2 + ||D y||^2 by eliminating the e-blocks.

    Returns (y, linear_iterations, termination) with termination codes
    from linear/cg.py (LinearSolverTerminationType semantics,
    linear_solver.h:57-74). Dispatches on options.linear_solver_type:
    DENSE_SCHUR/SPARSE_SCHUR build the dense reduced system
    (schur_complement_solver.cc); ITERATIVE_SCHUR runs PCG on the
    implicit S (iterative_schur_complement_solver.cc:64-155).
    """
    if ss is None:
        ss = getattr(program, "_schur_structure", None)
        if ss is None:
            ss = build_schur_structure(program)
            program._schur_structure = ss
        if (
            options.linear_solver_type
            in (
                LinearSolverType.DENSE_SCHUR,
                LinearSolverType.SPARSE_SCHUR,
            )
            or getattr(options, "use_explicit_schur_complement", False)
            or (
                options.linear_solver_type
                == LinearSolverType.ITERATIVE_SCHUR
                and int(ss.f_idx.shape[0]) <= EXPLICIT_S_AUTO_MAX_NF
            )
        ):
            ensure_explicit_plan(program, ss)

    op = SchurOperator(ctx, D, ss)
    lst = options.linear_solver_type
    tangent_rhs = rhs

    if lst in (LinearSolverType.DENSE_SCHUR, LinearSolverType.SPARSE_SCHUR):
        S, rhs_red, f_idx = op.dense_reduced_system()
        if tangent_rhs is not None:
            rhs_red = op.rhs_from_tangent(tangent_rhs)[f_idx]
        chol, low = jax.scipy.linalg.cho_factor(S, lower=True)
        xf_red = jax.scipy.linalg.cho_solve((chol, low), rhs_red)
        x_f = jnp.zeros(
            (ctx.num_tangent,), dtype=ctx.residuals[0].dtype
        ).at[f_idx].set(
            xf_red
        )
        if tangent_rhs is not None:
            y = op.back_substitute_tangent(x_f, tangent_rhs)
        else:
            y = op.back_substitute(x_f)
        from ceres_tpu.linear.cg import direct_termination

        return y, jnp.asarray(1, jnp.int32), direct_termination(y)

    # ITERATIVE_SCHUR
    # Explicit-S policy: user flag, or automatic when the reduced camera
    # system is small (see EXPLICIT_S_AUTO_MAX_NF). S is materialized
    # ONCE per linear solve and reused for both the CG operator and the
    # SCHUR_JACOBI block extraction.
    use_explicit_s = getattr(
        options, "use_explicit_schur_complement", False
    ) or (
        ss.explicit is not None
        and int(ss.f_idx.shape[0]) <= EXPLICIT_S_AUTO_MAX_NF
    )
    S_dense = None
    f_idx_d = None
    if use_explicit_s:
        S_dense, _, f_idx_d = op.dense_reduced_system()
        # S is mathematically symmetric; the assembled f32 matrix is not
        # exactly so (~1e-6 relative from independent lower/upper
        # accumulation orders). CG requires a symmetric operator — with
        # the raw matrix, near-converged solves produce steps with
        # model_cost_change <= 0 (invalid-step FAILURE observed on the
        # 16-cam flagship). Symmetrize once; O(nf^2), negligible here.
        S_dense = 0.5 * (S_dense + S_dense.T)

    if options.preconditioner_type == PreconditionerType.SCHUR_JACOBI:
        if S_dense is not None and ss.explicit is not None:
            M = op.schur_jacobi_preconditioner_from_dense(S_dense)
        else:
            M = op.schur_jacobi_preconditioner()
    elif options.preconditioner_type == PreconditionerType.CLUSTER_JACOBI:
        if ss.cluster_groups is not None:
            M = op.clustered_preconditioner(ss.cluster_groups)
        else:
            M = op.schur_jacobi_preconditioner()
    elif (
        options.preconditioner_type
        == PreconditionerType.CLUSTER_TRIDIAGONAL
    ):
        if (
            ss.cluster_groups is not None
            and ss.chain_clusters is not None
        ):
            M = op.cluster_tridiagonal_preconditioner(
                ss.cluster_groups, ss.chain_clusters
            )
        elif ss.cluster_groups is not None:
            M = op.clustered_preconditioner(ss.cluster_groups)
        else:
            M = op.schur_jacobi_preconditioner()
    elif (
        options.preconditioner_type
        == PreconditionerType.SCHUR_POWER_SERIES_EXPANSION
    ):
        # As a PRECONDITIONER the series runs a FIXED term count —
        # spse_tolerance is deliberately ignored so M stays the same
        # linear operator on every CG application
        # (iterative_schur_complement_solver.cc:179-183: "Ignoring the
        # value of spse_tolerance to ensure preconditioner stays the
        # same for each iteration"); a data-dependent truncation makes
        # M nonlinear and destabilizes CG's convergence floor. The
        # tolerance-based truncation belongs to the SPSE
        # INITIALIZATION below (use_spse_initialization, cc:101-111).
        M = op.power_series_preconditioner(
            options.max_num_spse_iterations, 0.0
        )
    elif options.preconditioner_type == PreconditionerType.JACOBI:
        # block-Jacobi of S
        if S_dense is not None and ss.explicit is not None:
            M = op.schur_jacobi_preconditioner_from_dense(S_dense)
        else:
            M = op.schur_jacobi_preconditioner()
    else:
        M = None

    if tangent_rhs is not None:
        rhs = op.rhs_from_tangent(tangent_rhs)
    else:
        rhs = op.rhs()
    # Power-series initial guess for the reduced system
    # (iterative_schur_complement_solver.cc:101-111, use_spse_initialization).
    x0 = None
    if getattr(options, "use_spse_initialization", False):
        # The reference seeds the initialization PSE solver with the same
        # (max_num_spse_iterations, spse_tolerance) pair
        # (iterative_schur_complement_solver.cc:100-111).
        x0 = op.power_series_preconditioner(
            options.max_num_spse_iterations,
            getattr(options, "spse_tolerance", 0.0),
        )(rhs)
    # use_explicit_schur_complement (solver.h:540-556 /
    # iterative_schur_complement_solver.cc CreatePreconditioner path):
    # materialize S once and run CG against the dense matrix — wins when
    # cameras are few and S·x would otherwise repeat the elimination.
    s_apply = op.s_times
    if S_dense is not None:
        nt = ctx.num_tangent

        def s_apply(v):
            red = S_dense @ v[f_idx_d]
            return jnp.zeros((nt,), dtype=v.dtype).at[f_idx_d].set(red)

    res: CGResult = conjugate_gradients(
        s_apply,
        rhs,
        x0=x0,
        preconditioner=M,
        max_num_iterations=options.max_linear_solver_iterations,
        min_num_iterations=options.min_linear_solver_iterations,
        q_tolerance=options.eta,
        r_tolerance=-1.0,
    )
    if tangent_rhs is not None:
        y = op.back_substitute_tangent(res.x, tangent_rhs)
    else:
        y = op.back_substitute(res.x)
    return y, res.num_iterations, res.termination
