"""Segment-reduction plans, the flat bilinear helpers of the Schur
assembly, the precision pin, and the chip smoke script's CPU contract.

Every ``ReducePlan`` kind must reproduce ``np.add.at`` in float64 over the
reduction shapes the solver meets (BA camera / point / cell reductions);
the plan heuristic must never pick a kind outside ``KINDS`` whatever the
backend; and every f32 matrix product on the assembly path must lower
with HIGHEST precision (no TF32 on GPUs).
"""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ceres_tpu.linear import schur_explicit as se
from ceres_tpu.ops import reduce as red

REPO = Path(__file__).resolve().parents[1]

# (B, G, d): the batch/group/width combinations of the solver's
# reductions (camera gradients and J'J blocks, point rows, cell blocks).
SHAPES = [
    (5000, 1300, 9),
    (2048, 64, 3),
    (4096, 4000, 24),
    (20000, 15000, 3),
    (8192, 9000, 9),
    (4096, 30000, 4),
    (8192, 500, 81),
    (5000, 4000, 9),
]
# one-hot plans materialize a (G+1, B) operand: only small tables.
ONEHOT_MAX_ELEMS = 4e7


def _cases():
    for B, G, d in SHAPES:
        for order in ("sorted", "unsorted"):
            for kind in red.KINDS:
                if kind == "onehot" and (G + 1) * B > ONEHOT_MAX_ELEMS:
                    continue
                if kind == "sorted_segment" and order == "unsorted":
                    continue
                yield pytest.param(
                    B, G, d, order, kind, id=f"{B}x{G}x{d}-{order}-{kind}"
                )


def _ids(rng, B, G, order):
    if order == "sorted":  # dummy id G sorts last
        return np.sort(rng.integers(0, G + 1, size=B))
    return rng.integers(-1, G + 1, size=B)  # includes both dummy ids


def _add_at(seg, x, G):
    ref = np.zeros((G + 1,) + x.shape[1:])
    np.add.at(ref, np.where((seg < 0) | (seg >= G), G, seg), x)
    return ref[:G]


@pytest.mark.parametrize("B,G,d,order,kind", list(_cases()))
def test_plan_kind_matches_add_at(B, G, d, order, kind):
    rng = np.random.default_rng(B + G + d)
    seg = _ids(rng, B, G, order)
    x = rng.standard_normal((B, d))
    plan = red.build_reduce_plan(seg, G, kind=kind)
    assert plan.kind == kind
    out = jax.jit(red.apply_reduce)(plan, jnp.asarray(x))
    assert out.shape == (G + 1, d)
    np.testing.assert_allclose(
        np.asarray(out)[:G], _add_at(seg, x, G), rtol=1e-12, atol=1e-12
    )


@pytest.mark.parametrize("kind", red.KINDS)
def test_duplicate_heavy_multidim_tail(kind):
    """Three groups take every row (fan-in ~B/3) and the tail is 2-D."""
    rng = np.random.default_rng(3)
    B, G = 3000, 3
    seg = rng.integers(0, G, size=B)
    if kind == "sorted_segment":
        seg = np.sort(seg)
    x = rng.standard_normal((B, 3, 9))
    plan = red.build_reduce_plan(seg, G, kind=kind)
    out = red.apply_reduce(plan, jnp.asarray(x))
    assert out.shape == (G + 1, 3, 9)
    np.testing.assert_allclose(
        np.asarray(out)[:G], _add_at(seg, x, G), rtol=1e-12, atol=1e-10
    )


def test_unknown_kind_rejected():
    with pytest.raises(ValueError, match="unknown reduce plan kind"):
        red.build_reduce_plan(np.zeros(4, np.int64), 2, kind="sorted")
    with pytest.raises(ValueError, match="needs sorted"):
        red.build_reduce_plan(np.array([3, 1, 2]), 4, kind="sorted_segment")


@pytest.mark.parametrize("backend", ["cpu", "gpu", "tpu"])
def test_selection_independent_of_backend(backend, monkeypatch):
    """The heuristic depends on the ids alone: same kinds on every
    backend, all of them in KINDS."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    rng = np.random.default_rng(1)
    expected = {
        (5000, 100, "unsorted"): "onehot",
        (8192, 9000, "sorted"): "sorted_segment",  # padded fan-in
        (20000, 15000, "unsorted"): "ell",
    }
    for (B, G, order), kind in expected.items():
        seg = _ids(rng, B, G, order)
        assert red.build_reduce_plan(seg, G).kind == kind
    # uniform sorted fan-in (BA point rows): no padding -> ell
    seg = np.repeat(np.arange(2000), 6)
    assert red.build_reduce_plan(seg, 2000).kind == "ell"
    # pathological skew, unsorted: one group takes almost everything
    seg = np.concatenate([np.arange(1, 1001), np.zeros(9000, np.int64)])
    assert red.build_reduce_plan(seg, 5000).kind == "scatter"


# ---- flat bilinear helpers --------------------------------------------------


def _bilinear_cases():
    Te, T = 3, 9
    return {
        "outer": (
            lambda a, b: se._flat_outer(a, b, Te, T, T),
            (257, Te * T), (257, Te * T),
            lambda a, b: np.einsum(
                "pki,pkj->pij", a.reshape(-1, Te, T), b.reshape(-1, Te, T)
            ),
        ),
        "pair_product": (
            se._flat_pair_product, (130, 2, Te), (130, 2, T),
            lambda e, f: np.einsum("bre,brt->bet", e, f),
        ),
        # r > _FLAT_LOOP_MAX takes the einsum branch
        "pair_product_einsum": (
            se._flat_pair_product, (40, se._FLAT_LOOP_MAX + 3, 4),
            (40, se._FLAT_LOOP_MAX + 3, 6),
            lambda e, f: np.einsum("bre,brt->bet", e, f),
        ),
        "apply_minv": (
            lambda m, w: se._flat_apply_minv(m, w, Te, T),
            (130, Te * Te), (130, Te * T),
            lambda m, w: np.einsum(
                "bef,bft->bet", m.reshape(-1, Te, Te), w.reshape(-1, Te, T)
            ),
        ),
    }


@pytest.mark.parametrize("name", sorted(_bilinear_cases()))
def test_bilinear_helper_matches_einsum(name):
    fn, sa, sb, ref_fn = _bilinear_cases()[name]
    rng = np.random.default_rng(7)
    a, b = rng.standard_normal(sa), rng.standard_normal(sb)
    out = jax.jit(fn)(jnp.asarray(a), jnp.asarray(b))
    ref = ref_fn(a, b).reshape(sa[0], -1)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-12, atol=1e-12)


# ---- precision pin ----------------------------------------------------------


def _dot_precisions(text):
    return re.findall(r"dot_general.*?precision = \[([A-Z_, ]+)\]", text)


def test_f32_onehot_reduce_lowers_highest():
    seg = np.random.default_rng(0).integers(0, 50, size=400)
    plan = red.build_reduce_plan(seg, 50, kind="onehot")
    x = jnp.zeros((400, 9), jnp.float32)
    text = jax.jit(red.apply_reduce).lower(plan, x).as_text()
    assert "dot_general" in text
    precs = _dot_precisions(text)
    assert precs and all(p == "HIGHEST, HIGHEST" for p in precs), precs


@pytest.mark.parametrize("name", sorted(_bilinear_cases()))
def test_f32_bilinear_helpers_lower_highest(name):
    """The loop forms are elementwise (exact f32 products, no dot); any
    dot that does appear (the einsum branch) must be HIGHEST."""
    fn, sa, sb, _ = _bilinear_cases()[name]
    text = jax.jit(fn).lower(
        jnp.zeros(sa, jnp.float32), jnp.zeros(sb, jnp.float32)
    ).as_text()
    n_dots = text.count("dot_general")
    precs = _dot_precisions(text)
    assert len(precs) == n_dots
    assert all(p == "HIGHEST, HIGHEST" for p in precs), precs
    if name == "pair_product_einsum":
        assert n_dots >= 1


# ---- chip smoke script and compile cache (subprocesses) --------------------


def _cpu_env(**extra):
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", **extra)
    return env


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_cpu(where, tmp_path):
    """No accelerator (or no repo beside it): non-zero exit, no result."""
    script = REPO / "chip_smoke.py"
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    proc = subprocess.run(
        [sys.executable, str(script)], cwd=script.parent,
        env=_cpu_env(), capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_dir(env_dir, tmp_path):
    env = _cpu_env()
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = str(REPO / ".jax_cache")
    if env_dir:
        want = str(tmp_path / "cache")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    code = (
        "import jax\n"
        "from ceres_tpu.utils.compile_cache import enable_compile_cache\n"
        "p = enable_compile_cache()\n"
        "print(p)\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == [want, want]
