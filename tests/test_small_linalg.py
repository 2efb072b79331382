"""Batched small-SPD kernels (ceres_tpu.ops.small_linalg) vs numpy."""

import jax.numpy as jnp
import numpy as np
import pytest

from ceres_tpu.ops.small_linalg import spd_inverse, spd_solve

pytestmark = pytest.mark.device


def _rand_spd(rng, b, n, cond=100.0):
    A = rng.standard_normal((b, n, n))
    return A @ np.transpose(A, (0, 2, 1)) + np.eye(n) * (1.0 / cond)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 9, 12, 16, 33])
def test_spd_inverse_matches_numpy(n):
    rng = np.random.default_rng(n)
    m = _rand_spd(rng, 7, n)
    inv = np.asarray(spd_inverse(jnp.asarray(m)))
    np.testing.assert_allclose(inv, np.linalg.inv(m), rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("n", [2, 3, 9])
def test_spd_solve(n):
    rng = np.random.default_rng(n + 50)
    m = _rand_spd(rng, 5, n)
    b = rng.standard_normal((5, n))
    inv = spd_inverse(jnp.asarray(m))
    x = np.asarray(spd_solve(inv, jnp.asarray(b)))
    expected = np.linalg.solve(m, b[..., None])[..., 0]
    np.testing.assert_allclose(x, expected, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("n", [3, 9])
def test_spd_inverse_f32(n):
    rng = np.random.default_rng(n + 9)
    m = _rand_spd(rng, 11, n, cond=10.0).astype(np.float32)
    inv = np.asarray(spd_inverse(jnp.asarray(m)))
    assert inv.dtype == np.float32
    err = np.abs(inv @ m - np.eye(n, dtype=np.float32)).max()
    assert err < 5e-4


def test_spd_inverse_jit_and_grad():
    import jax

    rng = np.random.default_rng(0)
    m = jnp.asarray(_rand_spd(rng, 4, 3))
    f = jax.jit(lambda m: jnp.sum(spd_inverse(m)))
    g = jax.grad(f)(m)
    assert np.all(np.isfinite(np.asarray(g)))


def test_unrolled_path_big_batch():
    rng = np.random.default_rng(1)
    m = _rand_spd(rng, 2000, 9)
    inv = np.asarray(spd_inverse(jnp.asarray(m)))
    np.testing.assert_allclose(inv, np.linalg.inv(m), rtol=1e-7, atol=1e-7)
