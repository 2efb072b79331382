"""Smoke test of the BAL solve path on one GPU.

    python chip_smoke.py               # one card, phases 1-4
    python chip_smoke.py --four-cards  # four cards, the sharded phase only

Phases, each printed on its own line with its wall time:

1. device: ``jax.devices()``, the device kind, and the card's name and
   power limit from ``nvidia-smi``;
2. kernel parity: every ``ReducePlan`` kind and the flat bilinear helpers
   of the Schur assembly, run on the card at the large cell's widths and
   counts, against numpy float64;
3. flagship: BAL 16 cameras / 22106 points / 83718 observations, LM +
   ITERATIVE_SCHUR, through ``ct.solve`` and ``ct.fused_solve`` in float32
   and ``ct.fused_solve`` in float64 as the reference;
4. large: BAL 464 / 200000 / 1200000, ``ct.fused_solve`` with DENSE_SCHUR
   in float32 and float64.

``--four-cards`` runs the large cell on ``make_mesh(4)`` and
``make_mesh_2d(2, 2)`` against the single-card solve, plus
``__graft_entry__.dryrun_multichip(4)``, and nothing else.

Every check raises on failure, so the script exits non-zero and never
prints its last line, ``{"ok": true, "device": {...}}``. It needs a GPU:
on any other backend it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

REQUIRED_PLATFORM = "gpu"

FLAGSHIP = dict(num_cameras=16, num_points=22106, num_observations=83718,
                noise=2.0, perturb=0.7, seed=16)
LARGE = dict(num_cameras=464, num_points=200_000, num_observations=1_200_000,
             noise=2.0, perturb=0.7, seed=7)

# float32 solves stop at an f32-realistic function tolerance: with f32
# residuals the cost plateaus ~1e-2 above the f64 optimum, so the default
# 1e-6 is unreachable and the solve would grind into the invalid-step
# ladder instead of converging. The float64 reference solves to 1e-9.
F32_FTOL = 1e-5
F64_FTOL = 1e-9
# Gap bounds (relative cost). f32 vs f64 optimum: the f32 solve stops
# within ~F32_FTOL of its plateau, which sits within 1e-4 of the f64 one.
F32_VS_F64 = 1e-4
# Reported final cost vs numpy float64 at the returned parameters: the
# f32 cost is an f32 sum over 2*O residuals evaluated in f32; the f64
# cost differs only by summation order.
REPORTED_VS_NUMPY = {"float32": 1e-5, "float64": 1e-10}
# Kernel parity, per output: |out - ref| <= tol * sum(|terms|). An f32
# tree or atomic sum of n terms errs by ~u*log2(n) .. u*sqrt(n) of
# sum(|terms|) (u = 6e-8; n <= ~3000 here), so 1e-5 has ~10x headroom,
# while TF32 operands (u = 4.9e-4) would miss it by ~100x.
PARITY_TOL = {"float32": 1e-5, "float64": 1e-12}


def log(phase: str, t0: float, msg: str) -> None:
    print(f"[{phase}] {time.time() - t0:8.2f}s  {msg}", flush=True)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# Phase 2: kernel parity
# ---------------------------------------------------------------------------


def _segment_ref(seg, x, G):
    """float64 group sums and sums of |terms| (groups 0..G-1)."""
    order = np.argsort(seg, kind="stable")
    order = order[seg[order] < G]
    s = seg[order]
    x64 = x.astype(np.float64)[order]
    groups, starts = np.unique(s, return_index=True)
    ref = np.zeros((G,) + x.shape[1:])
    mag = np.zeros_like(ref)
    ref[groups] = np.add.reduceat(x64, starts, axis=0)
    mag[groups] = np.add.reduceat(np.abs(x64), starts, axis=0)
    return ref, mag


def _within(out, ref, mag, tol):
    err = np.abs(np.asarray(out, np.float64) - ref)
    bound = tol * mag + 1e-30
    return float(np.max(err / bound)) if err.size else 0.0


def reduction_cases(prob):
    """(name, seg ids, num groups, width) of the large cell's reductions:
    camera gradient and J'J/F'F cells over cameras, point rows, and the
    Schur correction cells (one per co-observing camera pair)."""
    order = np.argsort(prob.point_index, kind="stable")
    cam = prob.camera_index[order]
    pt = prob.point_index[order]
    C, P = prob.num_cameras, prob.num_points
    n = np.bincount(pt, minlength=P)
    check(np.all(n == n[0]), "parity pairs assume a uniform point fan-in")
    win = cam.reshape(P, int(n[0]))
    i, j = np.triu_indices(win.shape[1], 1)
    a, b = win[:, i].ravel(), win[:, j].ravel()
    _, cells = np.unique(
        np.maximum(a, b) * C + np.minimum(a, b), return_inverse=True
    )
    cells = np.sort(cells)
    G_cells = int(cells.max()) + 1
    return [
        ("camera gradient", cam, C, 9),
        ("point rows", pt, P, 3),
        ("point rows", pt, P, 9),
        ("F'F cells", cam, C, 81),
        ("correction cells", cells, G_cells, 81),
    ]


def phase_parity(prob):
    import jax
    import jax.numpy as jnp

    from ceres_tpu.linear.schur_explicit import (
        _flat_apply_minv,
        _flat_outer,
        _flat_pair_product,
    )
    from ceres_tpu.ops.reduce import KINDS, apply_reduce, build_reduce_plan

    t0 = time.time()
    rng = np.random.default_rng(0)
    for name, seg, G, d in reduction_cases(prob):
        B = seg.shape[0]
        x = rng.standard_normal((B, d)).astype(np.float32)
        ref, mag = _segment_ref(seg, x, G)
        ids_sorted = bool(np.all(seg[1:] >= seg[:-1]))
        for kind in KINDS:
            if kind == "onehot" and (G + 1) * B > 1.5e9:
                continue  # the (G+1, B) operand would not fit
            if kind == "sorted_segment" and not ids_sorted:
                continue
            plan = build_reduce_plan(seg, G, kind=kind)
            for dt in ("float32", "float64"):
                xd = jnp.asarray(x, dt)
                out = jax.jit(apply_reduce)(plan, xd)[:G]
                r = _within(out, ref, mag, PARITY_TOL[dt])
                log("parity", t0, f"reduce {name:16s} B={B} G={G} d={d} "
                    f"{kind:7s} {dt}: max err/bound {r:.3g}")
                check(r <= 1.0, f"reduce {name} {kind} {dt} off by {r:.3g}")
            del plan

    # The flat bilinear helpers at the assembly's shapes: per-pair W'Y
    # outer products (Te=3, T=9), per-observation E'F, and M^-1 W.
    Te, T = 3, 9
    B = prob.num_observations
    fan_in = B // prob.num_points
    npairs = fan_in * (fan_in - 1) // 2 * prob.num_points
    cases = [
        ("_flat_outer", lambda a, b: _flat_outer(a, b, Te, T, T),
         (npairs, Te * T), (npairs, Te * T),
         lambda a, b: np.einsum("pki,pkj->pij", a.reshape(-1, Te, T),
                                b.reshape(-1, Te, T))),
        ("_flat_pair_product", _flat_pair_product, (B, 2, Te), (B, 2, T),
         lambda e, f: np.einsum("bre,brt->bet", e, f)),
        ("_flat_apply_minv", lambda m, w: _flat_apply_minv(m, w, Te, T),
         (B, Te * Te), (B, Te * T),
         lambda m, w: np.einsum("bef,bft->bet", m.reshape(-1, Te, Te),
                                w.reshape(-1, Te, T))),
    ]
    for name, fn, sa, sb, ref_fn in cases:
        a = rng.standard_normal(sa).astype(np.float32)
        b = rng.standard_normal(sb).astype(np.float32)
        a64, b64 = a.astype(np.float64), b.astype(np.float64)
        ref = ref_fn(a64, b64).reshape(sa[0], -1)
        mag = ref_fn(np.abs(a64), np.abs(b64)).reshape(sa[0], -1)
        for dt in ("float32", "float64"):
            out = jax.jit(fn)(jnp.asarray(a, dt), jnp.asarray(b, dt))
            r = _within(out, ref, mag, PARITY_TOL[dt])
            log("parity", t0, f"{name:18s} rows={sa[0]} {dt}: "
                f"max err/bound {r:.3g}")
            check(r <= 1.0, f"{name} {dt} off by {r:.3g}")
    log("parity", t0, "done")


# ---------------------------------------------------------------------------
# Phases 3-5: solves
# ---------------------------------------------------------------------------


def solve_case(prob, label, dtype, iterative, fused=True, mesh=None):
    """One solve on a fresh problem; returns a dict of results after
    checking termination and reported-vs-numpy cost."""
    import ceres_tpu as ct
    from ceres_tpu.fused_lm import fused_solve
    from ceres_tpu.models import bal

    problem, cam_ids, pt_ids = bal.build_problem(prob)
    opts = bal.default_options(iterative=iterative)
    opts.max_num_iterations = 50
    opts.evaluation_dtype = dtype
    opts.function_tolerance = F32_FTOL if dtype == "float32" else F64_FTOL
    opts.mesh = mesh
    solve = fused_solve if fused else ct.solve

    # Warm-up: one iteration builds the host structures (cached on the
    # program) and compiles every step function; then restore x0.
    x0 = np.asarray(problem.program().initial_ambient())
    t0 = time.time()
    solve(dataclasses.replace(opts, max_num_iterations=1), problem)
    compile_s = time.time() - t0
    problem.write_back(x0)
    t0 = time.time()
    s = solve(opts, problem)
    solve_s = time.time() - t0

    cams, pts = bal.solution(problem, cam_ids, pt_ids)
    cost_np = bal.cost_np(prob, cams, pts)
    gap = abs(s.final_cost - cost_np) / cost_np
    out = {
        "label": label, "dtype": dtype, "compile_s": round(compile_s, 2),
        "solve_s": round(solve_s, 3), "iterations": len(s.iterations),
        "termination": str(s.termination_type.name),
        "initial_cost": s.initial_cost, "final_cost": s.final_cost,
        "numpy_cost": cost_np, "reported_vs_numpy": gap,
        "problem": problem,
    }
    check(s.termination_type == ct.TerminationType.CONVERGENCE,
          f"{label}: terminated {s.termination_type.name}")
    check(gap <= REPORTED_VS_NUMPY[dtype],
          f"{label}: reported cost {s.final_cost} vs numpy {cost_np} "
          f"(rel {gap:.3g})")
    return out


def _summary(r):
    return (f"{r['label']}: {r['termination']} in {r['iterations']} it, "
            f"compile {r['compile_s']} s, solve {r['solve_s']} s, "
            f"cost {r['initial_cost']:.6g} -> {r['final_cost']:.9g} "
            f"(numpy {r['numpy_cost']:.9g}, rel {r['reported_vs_numpy']:.2g})")


def compare_to_reference(runs, ref, phase, t0, bound=F32_VS_F64):
    for r in runs:
        gap = abs(r["final_cost"] - ref["final_cost"]) / ref["final_cost"]
        log(phase, t0, f"{r['label']} vs {ref['label']}: rel cost gap "
            f"{gap:.3g} (bound {bound:g})")
        check(gap <= bound, f"{r['label']} cost off {ref['label']} by "
              f"{gap:.3g}")


def phase_flagship(prob):
    t0 = time.time()
    runs = []
    for label, dtype, fused in (
        ("flagship f32 ct.solve", "float32", False),
        ("flagship f32 fused_solve", "float32", True),
        ("flagship f64 fused_solve", "float64", True),
    ):
        r = solve_case(prob, label, dtype, iterative=True, fused=fused)
        log("flagship", t0, _summary(r))
        runs.append(r)
    compare_to_reference(runs[:2], runs[2], "flagship", t0)


def phase_large(prob, card):
    t0 = time.time()
    f32 = solve_case(prob, "large f32 fused_solve", "float32", False)
    log("large", t0, _summary(f32) + f"  [{card}]")
    del f32["problem"]
    f64 = solve_case(prob, "large f64 fused_solve", "float64", False)
    log("large", t0, _summary(f64) + f"  [{card}]")
    compare_to_reference([f32], f64, "large", t0)


def phase_four_cards(prob):
    import jax

    import __graft_entry__
    from ceres_tpu.parallel import make_mesh, make_mesh_2d

    t0 = time.time()
    check(len(jax.devices()) >= 4, f"needs 4 devices, has {jax.devices()}")
    single = solve_case(prob, "large f32 1 card", "float32", False)
    log("four-cards", t0, _summary(single))
    del single["problem"]
    for label, mesh in (
        ("large f32 make_mesh(4)", make_mesh(4)),
        ("large f32 make_mesh_2d(2, 2)", make_mesh_2d(2, 2)),
    ):
        r = solve_case(prob, label, "float32", False, mesh=mesh)
        log("four-cards", t0, _summary(r))
        fam = r.pop("problem").program().families[0]
        ndev = len(fam.tangent_idx[0].sharding.device_set)
        log("four-cards", t0, f"{label}: family arrays span {ndev} devices")
        check(ndev == 4, f"{label}: family arrays on {ndev} devices")
        compare_to_reference([r], single, "four-cards", t0)
    __graft_entry__.dryrun_multichip(4)
    log("four-cards", t0, "dryrun_multichip(4) passed")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded large solve on 4 cards")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != REQUIRED_PLATFORM:
        print(f"chip_smoke: needs a {REQUIRED_PLATFORM} backend, JAX has "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 2

    import ceres_tpu  # noqa: F401  (x64 + precision policy)
    from ceres_tpu.models import bal
    from ceres_tpu.utils.compile_cache import enable_compile_cache

    t0 = time.time()
    cache = enable_compile_cache()
    devs = jax.devices()
    card = card_line()
    log("device", t0, f"{devs} kind={devs[0].device_kind!r} "
        f"compile cache {cache}")
    print(f"card: {card}", flush=True)

    large = bal.synthesize_bal(**LARGE)
    if args.four_cards:
        phase_four_cards(large)
    else:
        phase_parity(large)
        phase_flagship(bal.synthesize_bal(**FLAGSHIP))
        phase_large(large, card)
    log("total", t0, "all phases passed")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
