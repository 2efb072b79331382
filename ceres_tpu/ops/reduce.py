"""Segment-reduction plans: host-planned replacements for scatter-add.

The reference accumulates per-residual contributions into shared matrices
behind locks (``internal/ceres/block_random_access_matrix.h``,
``program_evaluator.h:266-304`` per-thread gradient buffers,
``schur_eliminator_impl.h:228-330`` ``rhs_locks_``). The functional analog
is ``out.at[idx].add(contrib)`` with colliding indices. A ``ReducePlan``
is built ONCE on the host from the integer segment ids and picks how that
accumulation is expressed:

- ``onehot``: one matrix product against a precomputed one-hot matrix.
  Used when the number of groups is small (e.g. BA cameras).
- ``ell``: an ELL-style padded adjacency — for each group, the (padded)
  list of contributing batch rows; reduction = row gather + sum. Used when
  groups are many but the per-group fan-in is bounded (e.g. BA points:
  observations per point <= number of cameras).
- ``sorted_segment``: sorted segment sum (``jax.ops.segment_sum`` with
  ``indices_are_sorted``). Used for sorted ids whose fan-in varies enough
  that ELL would pad (e.g. the Schur correction cells, one per
  co-observing camera pair).
- ``scatter``: scatter-add, for pathological fan-in skew.

All plans reduce a ``(B, ...)`` contribution array to ``(G+1, ...)`` where
row ``G`` is the dummy group (contributions to drop: constant blocks,
padded instances).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

# Selection thresholds (host-side heuristics, see build_reduce_plan).
ONEHOT_MAX_GROUPS = 288  # one-hot product: B x (G+1) operand stays small
ELL_MAX_WASTE = 8.0  # ELL padding waste factor bound vs perfect packing
ELL_MAX_FANIN = 4096  # hard bound on padded per-group fan-in
# Sorted ids whose ELL padding waste exceeds this use sorted_segment: at
# the 1.2M-observation BAL shapes on an H100, sorted segment sums beat
# ELL 3.5x on the correction cells (waste ~2) and lose slightly on the
# uniform point rows (waste 1.0); see PERF.md.
SORTED_MIN_WASTE = 1.5

KINDS = ("onehot", "ell", "sorted_segment", "scatter")


@dataclasses.dataclass(frozen=True)
class ReducePlan:
    """Host-built plan reducing (B, ...) by segment id to (G+1, ...)."""

    kind: str
    num_groups: int
    # onehot: (G+1, B) in int8 (cast to the contribution dtype at apply).
    onehot: Optional[jax.Array] = None
    # ell: (G+1, K) int32 rows into the padded (B+1) batch; pad value B.
    ell: Optional[jax.Array] = None
    # sorted_segment / scatter: (B,) int32 segment ids (dummy = G).
    seg: Optional[jax.Array] = None


jax.tree_util.register_dataclass(
    ReducePlan,
    data_fields=["onehot", "ell", "seg"],
    meta_fields=["kind", "num_groups"],
)


def build_reduce_plan(
    seg_ids: np.ndarray, num_groups: int, kind: Optional[str] = None
) -> ReducePlan:
    """Build a plan for reducing B rows into ``num_groups`` groups.

    ``seg_ids`` is (B,) int; ids outside [0, num_groups) go to the dummy
    group (dropped by convention — callers slice ``[:G]``). ``kind``
    forces one of :data:`KINDS` instead of the size heuristic.
    """
    seg = np.asarray(seg_ids, dtype=np.int64).reshape(-1)
    B = seg.shape[0]
    G = int(num_groups)
    seg = np.where((seg < 0) | (seg >= G), G, seg)
    if kind is not None and kind not in KINDS:
        raise ValueError(f"unknown reduce plan kind {kind!r}")

    if kind == "onehot" or (kind is None and G + 1 <= ONEHOT_MAX_GROUPS):
        onehot = np.zeros((G + 1, B), dtype=np.int8)
        onehot[seg, np.arange(B)] = 1
        return ReducePlan(
            kind="onehot", num_groups=G, onehot=jnp.asarray(onehot)
        )

    counts = np.bincount(seg, minlength=G + 1)
    kmax = int(counts[:G].max()) if G > 0 else 0
    waste = kmax * G / max(int(counts[:G].sum()), 1)
    is_sorted = bool(np.all(seg[1:] >= seg[:-1]))
    if kind == "sorted_segment" and not is_sorted:
        raise ValueError("sorted_segment needs sorted segment ids")
    if kind == "sorted_segment" or (
        kind is None and is_sorted and waste > SORTED_MIN_WASTE
    ):
        return ReducePlan(
            kind="sorted_segment",
            num_groups=G,
            seg=jnp.asarray(seg.astype(np.int32)),
        )
    if kind == "ell" or (
        kind is None and kmax <= ELL_MAX_FANIN and waste <= ELL_MAX_WASTE
    ):
        ell = np.full((G + 1, max(kmax, 1)), B, dtype=np.int32)
        order = np.argsort(seg, kind="stable")
        sorted_seg = seg[order]
        starts = np.searchsorted(sorted_seg, np.arange(G + 1))
        rank = np.arange(B, dtype=np.int64) - starts[sorted_seg]
        valid = sorted_seg < G
        ell[sorted_seg[valid], rank[valid]] = order[valid]
        return ReducePlan(kind="ell", num_groups=G, ell=jnp.asarray(ell))

    return ReducePlan(
        kind="scatter", num_groups=G, seg=jnp.asarray(seg.astype(np.int32))
    )


def apply_reduce(plan: ReducePlan, contrib: jax.Array) -> jax.Array:
    """Reduce (B, ...) contributions to (G+1, ...) group sums.

    The trailing row (index G) is the dummy group and should be dropped by
    the caller (it holds constant-block / padding contributions).
    """
    B = contrib.shape[0]
    tail = contrib.shape[1:]
    G = plan.num_groups
    flat = contrib.reshape(B, -1)
    if plan.kind == "onehot":
        # f32 sums stay f32-exact: the package pins the default matmul
        # precision to "highest" (ceres_tpu/__init__.py).
        out = jnp.matmul(
            plan.onehot.astype(contrib.dtype),
            flat,
            preferred_element_type=flat.dtype,
        )
    elif plan.kind == "ell":
        # Flatten the tail BEFORE the gather: the (rows, d) gather keeps
        # the contribution lane-packed instead of tiling a (rows, 9, 9)
        # tail.
        pad = jnp.zeros((1, flat.shape[1]), dtype=flat.dtype)
        cp = jnp.concatenate([flat, pad], axis=0)
        out = jnp.sum(cp[plan.ell], axis=1)  # (G+1, K, d) -> (G+1, d)
    elif plan.kind == "sorted_segment":
        out = jax.ops.segment_sum(
            flat, plan.seg, num_segments=G + 1, indices_are_sorted=True
        )
    else:
        out = jnp.zeros((G + 1, flat.shape[1]), dtype=flat.dtype)
        out = out.at[plan.seg].add(flat, mode="drop")
    return out.reshape((G + 1,) + tail)
