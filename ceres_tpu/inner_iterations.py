"""Inner iterations: coordinate descent over independent sets.

JAX analog of ``internal/ceres/coordinate_descent_minimizer.{h,cc}``
(+ ``parameter_block_ordering.cc`` independent-set construction): the
reference partitions parameter blocks into independent sets (no two
blocks of a set share a residual) and runs a full per-block trust-region
solve for every block, threads fanning out over blocks
(coordinate_descent_minimizer.cc:150-205).

Redesign: because blocks in a set are independent, *all* of them can be
advanced simultaneously by one global evaluation — each residual instance
sees exactly one set-block. A batched per-block LM with per-block radii
and per-block accept/reject is therefore: global residual+jacobian eval →
per-block gradient/J'J via segment reductions → batched (T,T) solves →
per-block cost deltas via segment sums → masked update. The reference's
per-block thread fan-out becomes a handful of fused XLA kernels per inner
step; its per-thread evaluators disappear.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ceres_tpu.evaluator import Evaluator


def compute_independent_sets(program) -> List[List[int]]:
    """Greedy coloring of the block-sharing graph → independent sets,
    largest (by block count) first. Analog of the recursive independent
    set decomposition in coordinate_descent_minimizer.h:49-86. Dispatches
    to the native C++ core when available."""
    from ceres_tpu.utils import native

    nat = native.independent_sets(program)
    if nat is not None:
        return nat
    # adjacency via shared residual instances
    neighbors: Dict[int, set] = {}
    active = {rec.pid for rec in program.blocks if not rec.constant}
    for fam in program.families:
        ids = np.asarray(fam.block_ids)
        for row in ids:
            live = [int(p) for p in row if int(p) in active]
            for a in live:
                s = neighbors.setdefault(a, set())
                for b in live:
                    if b != a:
                        s.add(b)
    color: Dict[int, int] = {}
    # visit high-degree blocks first for better colorings
    order = sorted(active, key=lambda p: -len(neighbors.get(p, ())))
    for pid in order:
        used = {color[n] for n in neighbors.get(pid, ()) if n in color}
        c = 0
        while c in used:
            c += 1
        color[pid] = c
    ncolors = max(color.values()) + 1 if color else 0
    sets = [[] for _ in range(ncolors)]
    for pid, c in color.items():
        sets[c].append(pid)
    sets.sort(key=len, reverse=True)
    return sets


class CoordinateDescentMinimizer:
    """Batched inner-iteration minimizer over one Program."""

    def __init__(self, program, options, evaluator: Evaluator):
        self.program = program
        self.options = options
        self.evaluator = evaluator
        user = getattr(options, "inner_iteration_ordering", None)
        if user is not None:
            # User groups (Solver::Options::inner_iteration_ordering):
            # validated as independent sets, visited in group order
            # (coordinate_descent_minimizer.cc IsOrderingValid).
            from ceres_tpu.ordered_groups import (
                normalize_ordering,
                validate_independent_set,
            )

            groups = normalize_ordering(user)
            active = {rec.pid for rec in program.blocks if not rec.constant}
            self.sets = []
            for g in groups:
                g = [int(p) for p in g if int(p) in active]
                if not g:
                    continue
                validate_independent_set(program, g)
                self.sets.append(g)
        else:
            self.sets = compute_independent_sets(program)
        self.num_steps = 3  # batched LM steps per set per pass

        pblocks = {rec.pid: rec for rec in program.blocks}
        # Per set, per tangent-size group: (G, T) tangent index matrix and
        # per-family/arg instance positions (for segment reductions).
        self._set_structs = []
        for s in self.sets:
            by_T: Dict[int, List[int]] = {}
            for pid in s:
                by_T.setdefault(pblocks[pid].tangent_size, []).append(pid)
            groups = {}
            pos_of_pid: Dict[int, Tuple[int, int]] = {}
            for T, pids in by_T.items():
                rows = np.stack(
                    [
                        np.arange(
                            program.tangent_offset[p],
                            program.tangent_offset[p] + T,
                            dtype=np.int32,
                        )
                        for p in pids
                    ]
                )
                groups[T] = jnp.asarray(rows)
                for i, p in enumerate(pids):
                    pos_of_pid[p] = (T, i)
            # per family/arg: position of the instance's block within its
            # group (dummy = group size → dropped)
            fam_pos = []
            for fam in program.families:
                ids = np.asarray(fam.block_ids)
                per_arg = []
                for j in range(ids.shape[1]):
                    T_j = fam.structure.tangent_sizes[j]
                    dummy = len(by_T.get(T_j, []))
                    pj = np.asarray(
                        [
                            pos_of_pid.get(int(p), (None, dummy))[1]
                            if int(p) in pos_of_pid
                            else dummy
                            for p in ids[:, j]
                        ],
                        dtype=np.int32,
                    )
                    per_arg.append(jnp.asarray(pj))
                fam_pos.append(tuple(per_arg))
            # per family: segment id of each instance within the set's
            # per-T group (an instance touches at most one set block/arg
            # of a given T — independence)
            self._set_structs.append((groups, tuple(fam_pos)))

        self._step_fns = [
            self._make_set_step(i) for i in range(len(self.sets))
        ]

    def _make_set_step(self, si: int):
        groups, fam_pos = self._set_structs[si]
        evaluator = self.evaluator
        program = self.program
        families = program.families
        min_d = self.options.min_lm_diagonal
        max_d = self.options.max_lm_diagonal

        @jax.jit
        def set_step(x, radii):
            """One batched LM step for every block of set si.

            radii: {T: (G_T,)} per-block trust radii. Returns
            (new_x, new_radii, total_cost_after)."""
            cost, grad, ctx = evaluator._full_fn(x, families)

            new_x = x
            delta = jnp.zeros((program.num_tangent,), dtype=jnp.float64)
            for T, rows in groups.items():
                G = rows.shape[0]
                # per-block gradient and J'J via segment scatter-adds
                g = jnp.zeros((G + 1, T), dtype=jnp.float64)
                H = jnp.zeros((G + 1, T, T), dtype=jnp.float64)
                for fi, fam in enumerate(families):
                    for j in range(fam.num_args):
                        if fam.structure.tangent_sizes[j] != T:
                            continue
                        Jj = ctx.jacs[fi][j]  # (B, r, T)
                        pj = fam_pos[fi][j]  # (B,)
                        g = g.at[pj].add(
                            jnp.einsum("brt,br->bt", Jj, ctx.residuals[fi]),
                            mode="drop",
                        )
                        H = H.at[pj].add(
                            jnp.einsum("bri,brj->bij", Jj, Jj), mode="drop"
                        )
                g, H = g[:G], H[:G]
                diag = jnp.clip(
                    jax.vmap(jnp.diag)(H), min_d, max_d
                )  # (G, T)
                damped = H + jax.vmap(jnp.diag)(diag / radii[T][:, None])
                step = -jnp.linalg.solve(damped, g[..., None])[..., 0]
                delta = delta.at[rows].set(step)

            candidate = program.plus(x, delta)
            # Per-block accept: compare per-instance cost segments.
            accept = {}
            cost_new_total = evaluator._cost_fn(candidate, families)
            for T, rows in groups.items():
                G = rows.shape[0]
                c_old = jnp.zeros((G + 1,), dtype=jnp.float64)
                c_new = jnp.zeros((G + 1,), dtype=jnp.float64)
                # cost segments need per-instance costs at x and candidate
                for fi, fam in enumerate(families):
                    from ceres_tpu.evaluator import family_residuals

                    r_old = ctx.residuals[fi]
                    r_new = family_residuals(fam, candidate)
                    sq_old = jnp.sum(r_old * r_old, axis=-1)
                    sq_new = jnp.sum(r_new * r_new, axis=-1)
                    if fam.loss is not None:
                        # ctx.residuals are corrected; use raw for both
                        raw_old = family_residuals(fam, x)
                        sq_old = jnp.sum(raw_old * raw_old, axis=-1)
                        sq_old = fam.loss.evaluate(sq_old)[0]
                        sq_new = fam.loss.evaluate(sq_new)[0]
                    for j in range(fam.num_args):
                        if fam.structure.tangent_sizes[j] != T:
                            continue
                        pj = fam_pos[fi][j]
                        c_old = c_old.at[pj].add(0.5 * sq_old, mode="drop")
                        c_new = c_new.at[pj].add(0.5 * sq_new, mode="drop")
                acc = c_new[:G] < c_old[:G]  # (G,)
                accept[T] = acc
                radii[T] = jnp.where(acc, radii[T] * 2.0, radii[T] * 0.25)
                # zero out rejected block deltas
                delta = delta.at[rows].set(
                    jnp.where(acc[:, None], delta[rows], 0.0)
                )

            new_x = program.plus(x, delta)
            new_cost = evaluator._cost_fn(new_x, families)
            return new_x, radii, new_cost

        return set_step

    def minimize(self, x: jax.Array) -> Tuple[jax.Array, float]:
        """Run one inner-iteration pass; returns (x, final_cost)."""
        cost = None
        for si in range(len(self.sets)):
            radii = {
                T: jnp.full(
                    (rows.shape[0],),
                    self.options.initial_trust_region_radius,
                    jnp.float64,
                )
                for T, rows in self._set_structs[si][0].items()
            }
            for _ in range(self.num_steps):
                x, radii, cost = self._step_fns[si](x, radii)
        return x, float(cost)
