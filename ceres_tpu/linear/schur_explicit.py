"""One-pass explicit Schur-complement assembly.

JAX analog of the reference's chunked explicit eliminator
(``schur_eliminator.h:108-152`` math, ``schur_eliminator_impl.h:177-330``
implementation): the reduced camera system

    S = F'F + D_f^2 - W' (E'E + D_e^2)^{-1} W,      W = E'F

is assembled in ONE pass over the residual blocks instead of probing S
column-by-column with vmapped ``S . e_i`` products. The reference loops
over e-block chunks under locks; here every term is a flat-batched
product plus a host-planned segment reduction (``ops/reduce.py``):

- the ``F'F`` term permutes the per-instance Jacobian rows into
  cell-sorted order (host-built permutation) and segment-reduces the
  per-instance ``F_i' F_j`` products into camera-pair cells;
- the correction term enumerates, per point, the pairs of observations
  (the reference's chunk outer product, schur_eliminator_impl.h:228-330)
  as FLAT cell-sorted index arrays and segment-reduces the per-pair
  ``-W_a' M_p^{-1} W_b`` products into camera-pair cells.

Layout rule (r5): contributions and cell blocks are kept FLAT —
``(N, T1*T2)`` — end to end, so no layout ever tiles a trailing
``(.., 9, 9)`` pair of dims: a materialized (3M, 9, 9) intermediate can
pad to many times its size and push the fused solve into
rematerialization.

All pair/cell structures are built once on the host from the (static)
visibility pattern; assembly itself is pure XLA with unique-index
placement only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ceres_tpu.ops.reduce import ReducePlan, apply_reduce, build_reduce_plan


@dataclasses.dataclass(frozen=True)
class FtFSite:
    """F'F cell reduction for one (family, oriented arg-pair, kind).

    Device compute: gather the valid instance rows of jacs[fi][jA] /
    jacs[fi][jB] through ``perm`` (cell-sorted order; invalid/masked
    instances are simply absent), contract to flat (B, T1*T2) blocks,
    segment-reduce by sorted cell id. ``sym`` adds the transposed block
    after reduction (diagonal cells receive both (j1,j2) and (j2,j1)).
    """

    fi: int
    jA: int
    jB: int
    diagonal: bool
    sym: bool
    # ``perm`` is None when the reduce plan consumes the contributions
    # in NATURAL instance order (gather-free: onehot/ell). The cell-sorting
    # row gather at BAL scale costs more than the reduction itself, so
    # the builder prefers a natural-order plan whenever one exists.
    perm: Optional[jax.Array]  # (Bp,) int32 cell-sorted rows, or None
    plan: ReducePlan
    rows: jax.Array  # (C, T1) reduced row coords
    cols: jax.Array  # (C, T2)
    inv: Optional[jax.Array] = None  # (n1, n2) grid -> cell (dummy = C)
    offs: Optional[Tuple[int, int]] = None


jax.tree_util.register_dataclass(
    FtFSite,
    data_fields=["perm", "plan", "rows", "cols", "inv"],
    meta_fields=["fi", "jA", "jB", "diagonal", "sym", "offs"],
)


@dataclasses.dataclass(frozen=True)
class PairGroup:
    """Correction-term cells for one (T1, T2, diagonal) group.

    ``a_idx``/``b_idx`` are FLAT cell-sorted pair lists into the
    concatenated W slot spaces of f sizes T1/T2 (pad index = the zero
    pad row N). ``diagonal`` cells already contain every ordered pair;
    strict-lower cells are mirrored into the upper triangle by the
    assembler.
    """

    T1: int
    T2: int
    diagonal: bool
    num_cells: int
    a_idx: jax.Array  # (Pp,) int32 into T1 slot space
    b_idx: jax.Array  # (Pp,) int32 into T2 slot space
    plan: ReducePlan  # sorted cell ids -> num_cells groups
    rows: jax.Array  # (C, T1)
    cols: jax.Array  # (C, T2)
    inv: Optional[jax.Array] = None
    offs: Optional[Tuple[int, int]] = None
    # Self-pair fast path (a_idx == b_idx elementwise, T1 == T2 — the
    # block-diagonal cells of every single-observation problem): the
    # outer products are computed in NATURAL slot order (no gather) and
    # permuted to cell order with ONE wide (N, T1*T2) row gather instead
    # of two narrow (N, Te*T) ones. Row gathers are issue-bound (~3
    # cycles/row regardless of width), so halving the row count halves
    # the gather time.
    self_pairs: bool = False
    # Self-pair fast path only: the plan consumes the NATURAL slot-order
    # outer products directly (gather-free; see FtFSite.perm).
    natural: bool = False


jax.tree_util.register_dataclass(
    PairGroup,
    data_fields=[
        "a_idx", "b_idx", "plan", "rows", "cols", "inv",
    ],
    meta_fields=[
        "T1", "T2", "diagonal", "num_cells", "offs", "self_pairs",
        "natural",
    ],
)


@dataclasses.dataclass(frozen=True)
class ExplicitSchurPlan:
    nf: int
    # W slot spaces: per f tangent size, the (fi, j) args concatenated.
    slot_args: Tuple[Tuple[int, Tuple[Tuple[int, int], ...]], ...]  # meta
    ftf: Tuple[FtFSite, ...]
    corr: Tuple[PairGroup, ...]
    f_reduced: jax.Array  # (num_tangent+1,) tangent coord -> reduced (or nf)
    # Gather-placement support: assembly happens in a size-grouped
    # permutation of the reduced basis (all f-blocks of one tangent size
    # contiguous); g_of_r maps reduced coord -> grouped coord. When
    # grid_ok every scatter site carries an inv map and assembly is
    # scatter-free; grouped_identity skips the final unpermute.
    g_of_r: Optional[jax.Array] = None
    grid_ok: bool = False
    grouped_identity: bool = True


jax.tree_util.register_dataclass(
    ExplicitSchurPlan,
    data_fields=["ftf", "corr", "f_reduced", "g_of_r"],
    meta_fields=["nf", "slot_args", "grid_ok", "grouped_identity"],
)


def _host_pos(ss, fi, j=None):
    """Host numpy copy of ss.e_pos[fi] (j=None) / ss.f_pos[fi][j] without a
    device->host transfer when build_schur_structure stashed one."""
    if j is None:
        h = getattr(ss, "_host_e_pos", None)
        return h[fi] if h is not None else np.asarray(ss.e_pos[fi])
    h = getattr(ss, "_host_f_pos", None)
    return h[fi][j] if h is not None else np.asarray(ss.f_pos[fi][j])


# Cap on the transient (n1, n2, T1, T2) gather grid used by the
# scatter-free placement (elements; 64M f32 = 256 MB). Above it the
# legacy scatter path assembles that plan.
GRID_MAX_ELEMS = 64_000_000


def _grid_inverse(uniq, n1, n2, T1, T2):
    """(n1, n2) int32 grid mapping block ordinals to cell ids (dummy =
    len(uniq)); None when the grid exceeds GRID_MAX_ELEMS."""
    if n1 * n2 * T1 * T2 > GRID_MAX_ELEMS:
        return None
    inv = np.full((n1, n2), len(uniq), dtype=np.int32)
    for (p1, p2), c in uniq.items():
        inv[p1, p2] = c
    return jnp.asarray(inv)


def build_explicit_plan(program, ss) -> ExplicitSchurPlan:
    """Host-side construction of the one-pass assembly plan."""
    families = program.families
    f_idx = np.asarray(ss.f_idx)
    nf = f_idx.shape[0]
    nt = program.num_tangent

    # tangent coord -> reduced coordinate (nf for non-f coords & dummy).
    f_reduced = np.full(nt + 1, nf, dtype=np.int32)
    f_reduced[f_idx] = np.arange(nf, dtype=np.int32)

    f_groups = {T: np.asarray(g) for T, g in ss.f_groups.items()}

    def reduced_coords(T, pos):
        return f_reduced[f_groups[T][pos]]

    def start(T, pos):
        return int(f_reduced[f_groups[T][pos][0]])

    # Size-grouped basis for scatter-free placement: the ACTIVE (all
    # tangent coords in the reduced f space — constant blocks excluded)
    # f-blocks of one tangent size packed contiguously, ordered by group
    # position. ordinal_of_pos maps a group position to its packed
    # ordinal (-1 = inactive).
    size_row_off: Dict[int, int] = {}
    num_active: Dict[int, int] = {}
    ordinal_of_pos: Dict[int, np.ndarray] = {}
    g_of_r = np.full(nf, -1, dtype=np.int32)
    _off = 0
    for T in sorted(f_groups):
        red = f_reduced[f_groups[T]]  # (G, T) reduced coords per block
        G = red.shape[0]
        active = np.all(red < nf, axis=1) if G else np.zeros(0, bool)
        ords = np.full(G, -1, dtype=np.int32)
        ords[active] = np.arange(int(active.sum()), dtype=np.int32)
        ordinal_of_pos[T] = ords
        size_row_off[T] = _off
        nA = int(active.sum())
        num_active[T] = nA
        gro = _off + (
            ords[active][:, None].astype(np.int64) * T
            + np.arange(T, dtype=np.int64)[None, :]
        )
        g_of_r[red[active]] = gro
        _off += nA * T
    grid_allowed = _off == nf and not np.any(g_of_r < 0)
    grouped_identity = grid_allowed and bool(
        np.array_equal(g_of_r, np.arange(nf, dtype=np.int32))
    )

    def cell_maps(keys_ab, Ta, Tb):
        """Unique cells from (pa, pb) keys: ids per item, count, coord
        matrices, ordinal-grid inverse + offsets (when allowed)."""
        uniq: Dict[Tuple[int, int], int] = {}
        ids = np.empty(len(keys_ab), dtype=np.int64)
        for i, k in enumerate(keys_ab):
            if k not in uniq:
                uniq[k] = len(uniq)
            ids[i] = uniq[k]
        C = len(uniq)
        rows = np.empty((C, Ta), dtype=np.int32)
        cols = np.empty((C, Tb), dtype=np.int32)
        for (p1, p2), c in uniq.items():
            rows[c] = reduced_coords(Ta, p1)
            cols[c] = reduced_coords(Tb, p2)
        inv = offs = None
        if grid_allowed:
            oa, ob = ordinal_of_pos[Ta], ordinal_of_pos[Tb]
            ord_uniq = {
                (int(oa[pa]), int(ob[pb])): c
                for (pa, pb), c in uniq.items()
            }
            if all(a >= 0 and b >= 0 for a, b in ord_uniq):
                inv = _grid_inverse(
                    ord_uniq, num_active[Ta], num_active[Tb], Ta, Tb
                )
                if inv is not None:
                    offs = (size_row_off[Ta], size_row_off[Tb])
        return ids, C, rows, cols, inv, offs

    # ---- F'F sites ---------------------------------------------------------
    ftf_sites: List[FtFSite] = []
    for fi, fam in enumerate(families):
        ea = ss.e_arg[fi]
        f_args = [
            j
            for j in range(fam.num_args)
            if j != ea and ss.f_pos[fi][j] is not None
        ]
        B = fam.batch
        for a_i, j1 in enumerate(f_args):
            for j2 in f_args[a_i:]:
                T1 = fam.structure.tangent_sizes[j1]
                T2 = fam.structure.tangent_sizes[j2]
                p1 = _host_pos(ss, fi, j1)
                p2 = _host_pos(ss, fi, j2)
                G1 = f_groups.get(T1, np.zeros((0, T1))).shape[0]
                G2 = f_groups.get(T2, np.zeros((0, T2))).shape[0]
                valid = (p1 < G1) & (p2 < G2)
                # Orient each instance: diagonal / lower / transposed
                # (the transposed kind contributes F_j2' F_j1 at the
                # SWAPPED cell, replacing the old post-hoc X^T).
                s1 = np.full(B, -1, dtype=np.int64)
                s2 = np.full(B, -1, dtype=np.int64)
                vidx = np.nonzero(valid)[0]
                for b in vidx:
                    s1[b] = start(T1, int(p1[b]))
                    s2[b] = start(T2, int(p2[b]))
                kinds = np.full(B, -1, dtype=np.int8)
                kinds[vidx] = np.where(
                    s1[vidx] == s2[vidx],
                    0,
                    np.where(s1[vidx] > s2[vidx], 1, 2),
                )

                def make_site(kind, jA, jB, Ta, Tb, key_fn, diagonal, sym):
                    sel = np.nonzero(kinds == kind)[0]
                    if sel.size == 0:
                        return
                    keys = [key_fn(b) for b in sel]
                    ids, C, rows, cols, inv, offs = cell_maps(keys, Ta, Tb)
                    # Gather-free preference: when this kind covers every
                    # instance, try a NATURAL-order plan first — any kind
                    # that does not require sortedness skips the
                    # cell-sorting row gather (the gather costs more than
                    # the reduction at BAL scale).
                    perm = None
                    plan = None
                    if sel.size == B:
                        plan0 = build_reduce_plan(ids, C)
                        if plan0.kind != "scatter":
                            plan = plan0
                    if plan is None:
                        order = np.argsort(ids, kind="stable")
                        perm = jnp.asarray(sel[order].astype(np.int32))
                        plan = build_reduce_plan(ids[order], C)
                    ftf_sites.append(
                        FtFSite(
                            fi=fi,
                            jA=jA,
                            jB=jB,
                            diagonal=diagonal,
                            sym=sym,
                            perm=perm,
                            plan=plan,
                            rows=jnp.asarray(rows),
                            cols=jnp.asarray(cols),
                            inv=inv,
                            offs=offs,
                        )
                    )

                make_site(
                    0, j1, j2, T1, T2,
                    lambda b: (int(p1[b]), int(p2[b])),
                    True, j1 != j2,
                )
                make_site(
                    1, j1, j2, T1, T2,
                    lambda b: (int(p1[b]), int(p2[b])),
                    False, False,
                )
                # transposed: F_j2' F_j1 at cell (p2, p1) (strict lower).
                make_site(
                    2, j2, j1, T2, T1,
                    lambda b: (int(p2[b]), int(p1[b])),
                    False, False,
                )

    # ---- W slot spaces and correction pairs -------------------------------
    # Slot space per f size: concat of (fi, j) args (instances stacked).
    slot_args: Dict[int, List[Tuple[int, int]]] = {}
    slot_offset: Dict[Tuple[int, int], int] = {}
    slot_count: Dict[int, int] = {}
    for fi, fam in enumerate(families):
        ea = ss.e_arg[fi]
        if ea < 0:
            continue
        for j in range(fam.num_args):
            if j == ea or ss.f_pos[fi][j] is None:
                continue
            T = fam.structure.tangent_sizes[j]
            slot_offset[(fi, j)] = slot_count.get(T, 0)
            slot_count[T] = slot_count.get(T, 0) + fam.batch
            slot_args.setdefault(T, []).append((fi, j))

    # Per point: list of (T, slot, pos, sstart) over observing slots.
    P = ss.num_points
    point_obs: List[List[Tuple[int, int, int, int]]] = [[] for _ in range(P)]
    for fi, fam in enumerate(families):
        ea = ss.e_arg[fi]
        if ea < 0:
            continue
        epos = _host_pos(ss, fi)
        mask = (
            np.asarray(fam.mask) > 0
            if fam.mask is not None
            else np.ones(fam.batch, bool)
        )
        for j in range(fam.num_args):
            if j == ea or ss.f_pos[fi][j] is None:
                continue
            T = fam.structure.tangent_sizes[j]
            G = f_groups.get(T, np.zeros((0, T))).shape[0]
            fpos = _host_pos(ss, fi, j)
            off = slot_offset[(fi, j)]
            ok = mask & (epos < P) & (fpos < G)
            for b in np.nonzero(ok)[0]:
                point_obs[int(epos[b])].append(
                    (
                        T,
                        off + int(b),
                        int(fpos[b]),
                        start(T, int(fpos[b])),
                    )
                )

    # Uniform-window detection (single slot space, every point exactly n
    # consecutive slots, no distinct-arg aliasing, no masking): the
    # off-diagonal pairs specialize to gather-free slice combos.
    uniform_n = 0
    uniform_T = 0
    if len(slot_args) == 1 and P > 0:
        (uT,) = slot_args.keys()
        counts = {len(o) for o in point_obs}
        if len(counts) == 1:
            n0 = counts.pop()
            if n0 >= 1:
                ok_u = True
                for p, obs in enumerate(point_obs):
                    for t, (Tt, st, _, _) in enumerate(obs):
                        if Tt != uT or st != p * n0 + t:
                            ok_u = False
                            break
                    if not ok_u:
                        break
                if ok_u and n0 * P == slot_count.get(uT, -1):
                    uniform_n = n0
                    uniform_T = uT

    # Enumerate pairs into flat per-(T1, T2, diagonal?) streams.
    # diag cells: same camera block -> all ordered pairs (incl. a == b).
    # lower cells: distinct blocks, oriented row-start > col-start.
    # (Off-diagonal pairs are skipped here when the uniform-window
    # specialization below covers them.)
    skip_offdiag = uniform_n >= 2
    group_pairs: Dict[
        Tuple[int, int, bool],
        Tuple[List[int], List[int], List[Tuple[int, int]]],
    ] = {}
    for obs in point_obs:
        n = len(obs)
        for ai in range(n):
            Ta, sa, pa, ssa = obs[ai]
            for bi in range(n):
                Tb, sb, pb, ssb = obs[bi]
                same_block = Ta == Tb and pa == pb
                if same_block:
                    key = (Ta, Tb, True)
                elif ssa > ssb:
                    if skip_offdiag:
                        continue
                    key = (Ta, Tb, False)
                else:
                    continue  # upper triangle: mirrored by assembler
                acc = group_pairs.setdefault(key, ([], [], []))
                acc[0].append(sa)
                acc[1].append(sb)
                acc[2].append((pa, pb))

    corr: List[PairGroup] = []

    if skip_offdiag:
        # Uniform windows: the off-diagonal pair lists are built with
        # VECTORIZED numpy (the python per-pair loop costs tens of
        # seconds at BAL scale). Orientation is free here — the pair is
        # emitted as (a, b) with the row camera's start above the
        # column camera's, so the device computes W_a' Y_b directly at
        # the strict-lower cell; no per-row select, no post-transpose.
        T = uniform_T
        n0 = uniform_n
        N = n0 * P
        slot_pos = np.empty(N, dtype=np.int64)
        slot_start = np.empty(N, dtype=np.int64)
        for p, obs in enumerate(point_obs):
            for (_Tt, st, pos, sst) in obs:
                slot_pos[st] = pos
                slot_start[st] = sst
        p_idx = np.arange(P, dtype=np.int64)
        sa_parts: List[np.ndarray] = []
        sb_parts: List[np.ndarray] = []
        pa_parts: List[np.ndarray] = []
        pb_parts: List[np.ndarray] = []
        degenerate = False
        for i in range(n0):
            for j in range(i + 1, n0):
                s_i = p_idx * n0 + i
                s_j = p_idx * n0 + j
                pi_ = slot_pos[s_i]
                pj_ = slot_pos[s_j]
                if np.any(pi_ == pj_):
                    # same f block twice in one window: belongs to the
                    # DIAGONAL cell; rare — fall back to the generic
                    # python enumeration for all off-diagonal pairs.
                    degenerate = True
                    break
                direct = slot_start[s_i] > slot_start[s_j]
                sa_parts.append(np.where(direct, s_i, s_j))
                sb_parts.append(np.where(direct, s_j, s_i))
                pa_parts.append(np.where(direct, pi_, pj_))
                pb_parts.append(np.where(direct, pj_, pi_))
            if degenerate:
                break
        if not degenerate and sa_parts:
            sa = np.concatenate(sa_parts)
            sb = np.concatenate(sb_parts)
            pa = np.concatenate(pa_parts)
            pb = np.concatenate(pb_parts)
            G = f_groups[T].shape[0]
            packed = pa * G + pb
            uniq_keys, ids = np.unique(packed, return_inverse=True)
            C = uniq_keys.shape[0]
            pa_u = (uniq_keys // G).astype(np.int64)
            pb_u = (uniq_keys % G).astype(np.int64)
            rows = f_reduced[f_groups[T][pa_u]].astype(np.int32)
            cols = f_reduced[f_groups[T][pb_u]].astype(np.int32)
            inv = offs = None
            if grid_allowed:
                oa = ordinal_of_pos[T]
                oau = oa[pa_u]
                obu = oa[pb_u]
                if np.all(oau >= 0) and np.all(obu >= 0):
                    nA = num_active[T]
                    if nA * nA * T * T <= GRID_MAX_ELEMS:
                        inv_np = np.full((nA, nA), C, dtype=np.int32)
                        inv_np[oau, obu] = np.arange(C, dtype=np.int32)
                        inv = jnp.asarray(inv_np)
                        offs = (size_row_off[T], size_row_off[T])
            order = np.argsort(ids, kind="stable")
            corr.append(
                PairGroup(
                    T1=T,
                    T2=T,
                    diagonal=False,
                    num_cells=C,
                    a_idx=jnp.asarray(sa[order].astype(np.int32)),
                    b_idx=jnp.asarray(sb[order].astype(np.int32)),
                    plan=build_reduce_plan(ids[order], C),
                    rows=jnp.asarray(rows),
                    cols=jnp.asarray(cols),
                    inv=inv,
                    offs=offs,
                )
            )
        elif degenerate:
            # degenerate windows: redo the generic enumeration for the
            # off-diagonal pairs after all.
            for p in range(P):
                obs = point_obs[p]
                n = len(obs)
                for ai in range(n):
                    Ta, sa_, pa_, ssa = obs[ai]
                    for bi in range(n):
                        Tb, sb_, pb_, ssb = obs[bi]
                        if (Ta == Tb and pa_ == pb_) or ssa <= ssb:
                            continue
                        acc = group_pairs.setdefault(
                            (Ta, Tb, False), ([], [], [])
                        )
                        acc[0].append(sa_)
                        acc[1].append(sb_)
                        acc[2].append((pa_, pb_))
    for (T1, T2, diag), (sa_l, sb_l, keys) in group_pairs.items():
        ids, C, rows, cols, inv, offs = cell_maps(keys, T1, T2)
        sa = np.asarray(sa_l, dtype=np.int64)
        sb = np.asarray(sb_l, dtype=np.int64)
        # Gather-free self-pair mode: every slot appears exactly once as
        # its own pair partner -> reduce the NATURAL slot-order outer
        # products with per-slot cell ids (plus the dummy pad row), no
        # a_idx gather (see FtFSite.perm).
        if (
            T1 == T2
            and np.array_equal(sa, sb)
            and sa.shape[0] == slot_count.get(T1, -1)
            and np.array_equal(np.sort(sa), np.arange(sa.shape[0]))
        ):
            seg_nat = np.full(sa.shape[0] + 1, C, dtype=np.int64)
            seg_nat[sa] = ids
            plan0 = build_reduce_plan(seg_nat, C)
            if plan0.kind != "scatter":
                corr.append(
                    PairGroup(
                        T1=T1,
                        T2=T2,
                        diagonal=diag,
                        num_cells=C,
                        a_idx=jnp.zeros((0,), jnp.int32),
                        b_idx=jnp.zeros((0,), jnp.int32),
                        plan=plan0,
                        rows=jnp.asarray(rows),
                        cols=jnp.asarray(cols),
                        inv=inv,
                        offs=offs,
                        self_pairs=True,
                        natural=True,
                    )
                )
                continue
        order = np.argsort(ids, kind="stable")
        a_idx = np.asarray(sa_l, dtype=np.int32)[order]
        b_idx = np.asarray(sb_l, dtype=np.int32)[order]
        seg_sorted = ids[order]
        corr.append(
            PairGroup(
                T1=T1,
                T2=T2,
                diagonal=diag,
                num_cells=C,
                a_idx=jnp.asarray(a_idx),
                b_idx=jnp.asarray(b_idx),
                plan=build_reduce_plan(seg_sorted, C),
                rows=jnp.asarray(rows),
                cols=jnp.asarray(cols),
                inv=inv,
                offs=offs,
                self_pairs=bool(
                    T1 == T2 and np.array_equal(a_idx, b_idx)
                ),
            )
        )

    grid_ok = (
        grid_allowed
        and all(s.inv is not None for s in ftf_sites)
        and all(g.inv is not None for g in corr)
    )

    return ExplicitSchurPlan(
        nf=nf,
        slot_args=tuple(
            (T, tuple(args)) for T, args in sorted(slot_args.items())
        ),
        ftf=tuple(ftf_sites),
        corr=tuple(corr),
        f_reduced=jnp.asarray(f_reduced),
        g_of_r=jnp.asarray(g_of_r) if grid_allowed else None,
        grid_ok=grid_ok,
        grouped_identity=grouped_identity,
    )


@dataclasses.dataclass(frozen=True)
class CellSite:
    """One placement site of the assembly: a batch of reduced cell
    blocks — FLAT (C, T1*T2) values — plus where they go. ``diagonal``
    sites land on block-diagonal cells (each block symmetric after
    accumulation); non-diagonal sites land strictly below the diagonal
    and are mirrored into the upper triangle by the consumer."""

    diagonal: bool
    T1: int
    T2: int
    rows: jax.Array  # (C, T1) reduced row coordinates
    cols: jax.Array  # (C, T2) reduced col coordinates
    inv: Optional[jax.Array]  # grid inverse (scatter-free placement)
    offs: Optional[Tuple[int, int]]


# Python-loop bound for the flat contraction helpers: beyond this the
# graph-size tradeoff flips and the einsum fallback wins.
_FLAT_LOOP_MAX = 16

def _flat_outer(A: jax.Array, Bm: jax.Array, K: int, T1: int, T2: int):
    """Flat batched outer-product contraction
    ``out[p, i*T2+j] = sum_k A[p, k*T1+i] * B[p, k*T2+j]``
    built from 2-D repeat/tile broadcasts ONLY: XLA fuses the K terms
    into one elementwise kernel with exact f32 products.

    The einsum('pki,pkj->pij') + reshape form is mathematically
    identical, but XLA's fusion boundary can materialize the (P, T1, T2)
    intermediate with padded trailing dims. Every array here is rank-2
    with a T1*T2 minor. (A selection-matmul form ((A@Sa)*(B@Sb))@S was
    8.5x slower over the whole assembly on an H100; see PERF.md.)
    """
    out = None
    for k in range(K):
        a = jax.lax.slice_in_dim(A, k * T1, (k + 1) * T1, axis=1)
        b = jax.lax.slice_in_dim(Bm, k * T2, (k + 1) * T2, axis=1)
        term = jnp.repeat(a, T2, axis=1) * jnp.tile(b, (1, T1))
        out = term if out is None else out + term
    return out


def _flat_pair_product(E: jax.Array, F: jax.Array) -> jax.Array:
    """Flat ``w[b, e*T+t] = sum_r E[b,r,e] F[b,r,t]`` from (B, r, Te) x
    (B, r, T) without materializing a (B, Te, T) tail (see _flat_outer)."""
    B, r, Te = E.shape
    T = F.shape[2]
    if r > _FLAT_LOOP_MAX:
        return jnp.einsum("bre,brt->bet", E, F).reshape(B, Te * T)
    out = None
    for rr in range(r):
        term = jnp.repeat(E[:, rr, :], T, axis=1) * jnp.tile(
            F[:, rr, :], (1, Te)
        )
        out = term if out is None else out + term
    return out


def _flat_apply_minv(minv_flat: jax.Array, w_flat: jax.Array, Te: int,
                     T: int) -> jax.Array:
    """Flat ``y[b, e*T+t] = sum_f minv[b, e*Te+f] * w[b, f*T+t]``."""
    out = None
    for e in range(Te):
        acc = None
        for f in range(Te):
            m = jax.lax.slice_in_dim(
                minv_flat, e * Te + f, e * Te + f + 1, axis=1
            )  # (B, 1)
            wf = jax.lax.slice_in_dim(w_flat, f * T, (f + 1) * T, axis=1)
            term = m * wf
            acc = term if acc is None else acc + term
        out = acc if out is None else jnp.concatenate([out, acc], axis=1)
    return out


def plan_sites(plan: ExplicitSchurPlan) -> List[CellSite]:
    """The deterministic placement-site list matching
    :func:`compute_cell_blocks` value order (host-side, no device work).
    Consumers that scalarize the pattern (linear/sparse_schur.py) build
    their symbolic assembly from this."""
    sites: List[CellSite] = []
    for s in plan.ftf:
        sites.append(
            CellSite(
                s.diagonal, s.rows.shape[1], s.cols.shape[1],
                s.rows, s.cols, s.inv, s.offs,
            )
        )
    for g in plan.corr:
        sites.append(
            CellSite(g.diagonal, g.T1, g.T2, g.rows, g.cols, g.inv, g.offs)
        )
    return sites


def compute_cell_blocks(op, plan: ExplicitSchurPlan):
    """Compute every reduced cell block of S (without damping) in one
    pass, WITHOUT placing them.

    Returns (sites, blocks): :class:`CellSite` descriptors and matching
    FLAT (C, T1*T2) value arrays. The dense assembler places them into
    an (nf, nf) matrix; the SPARSE_SCHUR exporter
    (linear/sparse_schur.py) ships them to the host and assembles the
    block-sparse reduced system instead — the analog split of
    SchurEliminator (produces cells) vs the
    BlockRandomAccess{Dense,Sparse}Matrix target it writes to
    (schur_complement_solver.h:113-183).
    """
    ctx, ss = op.ctx, op.ss
    dt = op.dtype
    Te = ss.e_tangent_size
    sites = plan_sites(plan)
    blocks_out: List[jax.Array] = []

    # ---- F'F: permuted instance products, sorted segment reduce -----------
    for s in plan.ftf:
        FA = ctx.jacs[s.fi][s.jA]
        FB = ctx.jacs[s.fi][s.jB]
        T1 = FA.shape[2]
        T2 = FB.shape[2]
        C = s.rows.shape[0]
        # flat (B, T1*T2) product in NATURAL instance order; the
        # cell-sorting row gather only happens when the natural-order
        # plan would be a scatter (perm is None for onehot/ell plans).
        X = _flat_pair_product(FA, FB)
        if s.perm is not None:
            X = X[s.perm]
        blocks = apply_reduce(s.plan, X)[:C]
        if s.sym:
            # both (j1, j2) and (j2, j1) hit this diagonal cell; C here
            # is block-diagonal-sized, so the tiny reshape is fine.
            b3 = blocks.reshape(C, T1, T2)
            blocks = (b3 + jnp.swapaxes(b3, 1, 2)).reshape(C, T1 * T2)
        blocks_out.append(blocks)

    # ---- correction W' M^{-1} W -------------------------------------------
    # Minv kept FLAT (P+1, Te*Te) with a zero dummy row (constant-point
    # instances); row gathers stay lane-packed.
    Minv = op._ete_inv.reshape(-1, Te * Te)
    Minv = jnp.concatenate(
        [Minv, jnp.zeros((1, Te * Te), dtype=dt)], axis=0
    )

    W: Dict[int, jax.Array] = {}
    Y: Dict[int, jax.Array] = {}
    for T, args in plan.slot_args:
        ws, ys = [], []
        for fi, j in args:
            ea = ss.e_arg[fi]
            E = ctx.jacs[fi][ea]  # (B, r, Te)
            F = ctx.jacs[fi][j]  # (B, r, T)
            w = _flat_pair_product(E, F)  # (B, Te*T) flat
            m = Minv[ss.e_pos[fi]]  # (B, Te*Te) flat
            ws.append(w)
            ys.append(_flat_apply_minv(m, w, Te, T))
        pad = jnp.zeros((1, Te * T), dtype=dt)
        # FLAT (N+1, Te*T) slot slabs: row gathers stay lane-packed.
        W[T] = jnp.concatenate(ws + [pad], axis=0)
        Y[T] = jnp.concatenate(ys + [pad], axis=0)

    for g in plan.corr:
        if g.self_pairs:
            # natural-order outer over the whole slot slab; gather-free
            # when the plan consumes slot order directly (g.natural),
            # else one wide permutation gather (see PairGroup.self_pairs).
            nat = _flat_outer(W[g.T1], Y[g.T1], Te, g.T1, g.T1)
            contrib = nat if g.natural else nat[g.a_idx]
            blocks_out.append(
                -apply_reduce(g.plan, contrib)[: g.num_cells]
            )
            continue
        Wa = W[g.T1][g.a_idx]  # (Pp, Te*T1) flat — narrow operand rows
        Yb = Y[g.T2][g.b_idx]
        contrib = _flat_outer(Wa, Yb, Te, g.T1, g.T2)
        blocks_out.append(-apply_reduce(g.plan, contrib)[: g.num_cells])

    return sites, blocks_out


def assemble_reduced_system(op, plan: ExplicitSchurPlan):
    """Assemble the dense reduced system S (nf, nf) in one pass.

    ``op`` is a SchurOperator (provides jacobians, (E'E+De^2)^-1 factors
    and the damping vector). Returns S with damping included.

    Placement: when ``plan.grid_ok``, per-cell FLAT blocks are GATHERED
    into a dense (n1, n2, T1*T2) grid per size-group rectangle, unpacked
    to the (n1*T1, n2*T2) rectangle, and placed with a static-offset
    dynamic-update-slice instead of an element-at-a-time scatter; the
    grid gather + slice write streams at memory bandwidth. Assembly then happens in the
    size-grouped basis and is unpermuted once at the end (identity for
    single-f-size problems like BAL).
    """
    ss, D = op.ss, op.D
    dt = op.dtype
    nf = plan.nf
    grid_mode = plan.grid_ok

    S_d = jnp.zeros((nf, nf), dtype=dt)  # diagonal cells
    S_l = jnp.zeros((nf, nf), dtype=dt)  # strict lower cells

    def scatter_legacy(S, site, blocks):
        C = blocks.shape[0]
        b3 = blocks.reshape(C, site.T1, site.T2)
        return S.at[
            site.rows[:, :, None], site.cols[:, None, :]
        ].add(b3, mode="drop", unique_indices=True)

    def place_grid(S, site, blocks):
        # blocks (C, T1*T2); inv (n1, n2) with dummy = C -> zero block.
        C = blocks.shape[0]
        T1, T2 = site.T1, site.T2
        bp = jnp.concatenate(
            [blocks, jnp.zeros((1, T1 * T2), blocks.dtype)], axis=0
        )
        grid = bp[site.inv]  # (n1, n2, T1*T2) — flat tail, lane-packed
        rect = (
            grid.reshape(site.inv.shape[0], site.inv.shape[1], T1, T2)
            .transpose(0, 2, 1, 3)
            .reshape(site.inv.shape[0] * T1, site.inv.shape[1] * T2)
        )
        r0, c0 = site.offs
        cur = jax.lax.dynamic_slice(S, (r0, c0), rect.shape)
        return jax.lax.dynamic_update_slice(S, cur + rect, (r0, c0))

    sites, cell_blocks = compute_cell_blocks(op, plan)
    for site, blocks in zip(sites, cell_blocks):
        if grid_mode:
            placed = place_grid(S_d if site.diagonal else S_l, site, blocks)
        else:
            placed = scatter_legacy(
                S_d if site.diagonal else S_l, site, blocks
            )
        if site.diagonal:
            S_d = placed
        else:
            S_l = placed

    S = S_d + S_l + S_l.T
    if grid_mode and not plan.grouped_identity:
        # Unpermute from the size-grouped basis back to reduced order.
        g = plan.g_of_r
        S = S[g][:, g]
    # Damping D_f^2 on the reduced diagonal.
    df = D[ss.f_idx]
    S = S + jnp.diag((df * df).astype(dt))
    return S
