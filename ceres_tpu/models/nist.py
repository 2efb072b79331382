"""NIST StRD nonlinear regression suite.

JAX analog of ``examples/nist.cc``: parses the NIST .dat files,
builds one batched residual family per problem, solves from each certified
start, and scores the log-relative-error (LRE) against the certified
parameter values (nist.cc:67-72 reports Ceres' average LRE 9.4 / 41 wins).

Every model is evaluated as one vmapped residual over all observations —
one XLA kernel per (cost, jacobian) evaluation instead of per-datum
functors.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional

import jax.numpy as jnp
import numpy as np

import ceres_tpu as ct

PI = 3.141592653589793238462643383279


# -- model registry (formulas mirror examples/nist.cc:345-470) ---------------


def _bennett5(b, x):
    return b[0] * (b[1] + x) ** (-1.0 / b[2])


def _boxbod(b, x):
    return b[0] * (1.0 - jnp.exp(-b[1] * x))


def _chwirut(b, x):
    return jnp.exp(-b[0] * x) / (b[1] + b[2] * x)


def _danwood(b, x):
    return b[0] * x ** b[1]


def _gauss(b, x):
    return (
        b[0] * jnp.exp(-b[1] * x)
        + b[2] * jnp.exp(-(((x - b[3]) / b[4]) ** 2))
        + b[5] * jnp.exp(-(((x - b[6]) / b[7]) ** 2))
    )


def _lanczos(b, x):
    return (
        b[0] * jnp.exp(-b[1] * x)
        + b[2] * jnp.exp(-b[3] * x)
        + b[4] * jnp.exp(-b[5] * x)
    )


def _hahn1(b, x):
    return (b[0] + b[1] * x + b[2] * x**2 + b[3] * x**3) / (
        1.0 + b[4] * x + b[5] * x**2 + b[6] * x**3
    )


def _kirby2(b, x):
    return (b[0] + b[1] * x + b[2] * x**2) / (1.0 + b[3] * x + b[4] * x**2)


def _mgh09(b, x):
    return b[0] * (x * x + x * b[1]) / (x * x + x * b[2] + b[3])


def _mgh10(b, x):
    return b[0] * jnp.exp(b[1] / (x + b[2]))


def _mgh17(b, x):
    return b[0] + b[1] * jnp.exp(-x * b[3]) + b[2] * jnp.exp(-x * b[4])


def _misra1a(b, x):
    return b[0] * (1.0 - jnp.exp(-b[1] * x))


def _misra1b(b, x):
    u = 1.0 + b[1] * x / 2.0
    return b[0] * (1.0 - 1.0 / (u * u))


def _misra1c(b, x):
    return b[0] * (1.0 - (1.0 + 2.0 * b[1] * x) ** (-0.5))


def _misra1d(b, x):
    return b[0] * b[1] * x / (1.0 + b[1] * x)


def _roszman1(b, x):
    return b[0] - b[1] * x - jnp.arctan2(b[2], x - b[3]) / PI


def _rat42(b, x):
    return b[0] / (1.0 + jnp.exp(b[1] - b[2] * x))


def _rat43(b, x):
    return b[0] / (1.0 + jnp.exp(b[1] - b[2] * x)) ** (1.0 / b[3])


def _thurber(b, x):
    return (b[0] + b[1] * x + b[2] * x**2 + b[3] * x**3) / (
        1.0 + b[4] * x + b[5] * x**2 + b[6] * x**3
    )


def _enso(b, x):
    w = 2.0 * PI * x
    return (
        b[0]
        + b[1] * jnp.cos(w / 12.0)
        + b[2] * jnp.sin(w / 12.0)
        + b[4] * jnp.cos(w / b[3])
        + b[5] * jnp.sin(w / b[3])
        + b[7] * jnp.cos(w / b[6])
        + b[8] * jnp.sin(w / b[6])
    )


def _eckerle4(b, x):
    return b[0] / b[1] * jnp.exp(-0.5 * ((x - b[2]) / b[1]) ** 2)


def _nelson(b, x):
    # log(y) = b1 - b2*x1*exp(-b3*x2) (nist.cc Nelson; response is log y).
    return b[0] - b[1] * x[..., 0] * jnp.exp(-b[2] * x[..., 1])


MODELS: Dict[str, Callable] = {
    "Bennett5": _bennett5,
    "BoxBOD": _boxbod,
    "Chwirut1": _chwirut,
    "Chwirut2": _chwirut,
    "DanWood": _danwood,
    "Gauss1": _gauss,
    "Gauss2": _gauss,
    "Gauss3": _gauss,
    "Lanczos1": _lanczos,
    "Lanczos2": _lanczos,
    "Lanczos3": _lanczos,
    "Hahn1": _hahn1,
    "Kirby2": _kirby2,
    "MGH09": _mgh09,
    "MGH10": _mgh10,
    "MGH17": _mgh17,
    "Misra1a": _misra1a,
    "Misra1b": _misra1b,
    "Misra1c": _misra1c,
    "Misra1d": _misra1d,
    "Roszman1": _roszman1,
    "Rat42": _rat42,
    "Rat43": _rat43,
    "Thurber": _thurber,
    "ENSO": _enso,
    "Eckerle4": _eckerle4,
    "Nelson": _nelson,
}


@dataclasses.dataclass
class NISTProblem:
    name: str
    starts: np.ndarray  # (num_starts, num_params)
    certified: np.ndarray  # (num_params,)
    certified_cost: float  # 0.5 * residual sum of squares
    x: np.ndarray  # (num_obs,) or (num_obs, num_predictors)
    y: np.ndarray  # (num_obs,)
    model: Callable


def parse_nist_file(path: Path) -> NISTProblem:
    """Parse one NIST .dat file (same layout logic as nist.cc NISTProblem)."""
    text = Path(path).read_text()
    lines = text.splitlines()
    name = re.search(r"Dataset Name:\s+(\S+)", text).group(1)

    def line_range(label):
        m = re.search(label + r"\s+\(lines\s+(\d+)\s+to\s+(\d+)\)", text)
        return int(m.group(1)), int(m.group(2))

    sv_lo, sv_hi = line_range("Starting Values")
    data_lo, data_hi = line_range("Data")
    n_response = int(re.search(r"(\d+)\s+Response", text).group(1))
    n_predictor = int(re.search(r"(\d+)\s+Predictor", text).group(1))
    rss = float(
        re.search(r"Residual Sum of Squares:\s+(\S+)", text).group(1)
    )

    starts, certified = [], []
    for ln in lines[sv_lo - 1 : sv_hi]:
        toks = ln.replace("=", " ").split()
        # name v_start... certified stddev
        vals = [float(t) for t in toks[1:]]
        certified.append(vals[-2])
        starts.append(vals[:-2])
    starts = np.asarray(starts).T  # (num_starts, num_params)
    certified = np.asarray(certified)

    data = []
    for ln in lines[data_lo - 1 : data_hi]:
        toks = ln.split()
        if toks:
            data.append([float(t) for t in toks])
    data = np.asarray(data)
    y = data[:, :n_response].reshape(-1)
    x = data[:, n_response : n_response + n_predictor]
    if n_predictor == 1:
        x = x.reshape(-1)
    if name == "Nelson":
        y = np.log(y)
    return NISTProblem(
        name=name,
        starts=starts,
        certified=certified,
        certified_cost=0.5 * rss,
        x=x,
        y=y,
        model=MODELS[name],
    )


def build_problem(nist: NISTProblem, start_index: int) -> ct.Problem:
    p = ct.Problem()
    b = p.add_parameter_block(nist.starts[start_index].copy())
    model = nist.model

    def resid(bb, data):
        xx, yy = data
        return yy - model(bb, xx)

    p.add_residual_block(
        resid, None, [b], data=(jnp.asarray(nist.x), jnp.asarray(nist.y))
    )
    return p


def lre(estimate: np.ndarray, certified: np.ndarray) -> float:
    """Log relative error, min over parameters, clamped to [0, 11]
    (nist.cc ComputeLRE)."""
    out = 11.0
    for e, c in zip(estimate, certified):
        if c == 0.0:
            v = -np.log10(abs(e)) if e != 0 else 11.0
        else:
            rel = abs(e - c) / abs(c)
            v = 11.0 if rel == 0 else -np.log10(rel)
        out = min(out, max(0.0, min(11.0, v)))
    return out


def default_options() -> ct.SolverOptions:
    """nist.cc flags: LM + DENSE_QR (equivalently levenberg_marquardt,
    trust region), 10000 iterations, tight tolerances."""
    return ct.SolverOptions(
        linear_solver_type=ct.LinearSolverType.DENSE_QR,
        max_num_iterations=10000,
        function_tolerance=1e-18,
        gradient_tolerance=1e-18,
        parameter_tolerance=1e-18,
        use_nonmonotonic_steps=True,
    )


def run_suite(
    data_dir: str = "/root/reference/data/nist",
    options: Optional[ct.SolverOptions] = None,
    names: Optional[List[str]] = None,
    verbose: bool = False,
):
    """Run all problems x starts; returns list of result dicts and prints
    the nist.cc-style scoreboard."""
    data_dir = Path(data_dir)
    results = []
    files = sorted(data_dir.glob("*.dat"))
    if names:
        files = [f for f in files if f.stem in names]
    for f in files:
        nist = parse_nist_file(f)
        for si in range(nist.starts.shape[0]):
            prob = build_problem(nist, si)
            opts = options or default_options()
            summary = ct.solve(opts, prob)
            est = prob.parameter_block_value(0)
            score = lre(est, nist.certified)
            results.append(
                {
                    "name": nist.name,
                    "start": si,
                    "lre": score,
                    "final_cost": summary.final_cost,
                    "certified_cost": nist.certified_cost,
                    "iterations": len(summary.iterations),
                    "termination": str(summary.termination_type),
                }
            )
            if verbose:
                r = results[-1]
                print(
                    f"{r['name']:10s} start {si + 1}: LRE {score:5.2f}  "
                    f"cost {r['final_cost']:.10e} vs certified "
                    f"{r['certified_cost']:.10e}  ({r['iterations']} its)"
                )
    if results:
        avg = np.mean([r["lre"] for r in results])
        wins = sum(1 for r in results if r["lre"] >= 4.0)
        if verbose:
            print(f"average LRE: {avg:.2f}; starts with LRE>=4: {wins}/{len(results)}")
    return results
