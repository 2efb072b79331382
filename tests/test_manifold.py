"""Generic manifold property checks.

Mirrors the reference's manifold_test_utils.h:1-345 invariants:
  - plus(x, 0) = x
  - minus(plus(x, d), x) = d  (for small d)
  - plus_jacobian matches numeric differentiation of plus at delta=0
  - minus_jacobian matches numeric differentiation of minus at y=x
  - composition: MinusJacobian(x) * PlusJacobian(x) = I
applied to every manifold (manifold_test.cc, 1054 LoC in the reference).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ceres_tpu.manifold import (
    EuclideanManifold,
    EigenQuaternionManifold,
    LineManifold,
    ProductManifold,
    QuaternionManifold,
    SphereManifold,
    SubsetManifold,
)

pytestmark = pytest.mark.device


def _rand_point(m, rng):
    name = type(m).__name__
    if name in ("QuaternionManifold", "EigenQuaternionManifold"):
        q = rng.standard_normal(4)
        return q / np.linalg.norm(q)
    if name == "SphereManifold":
        v = rng.standard_normal(m.ambient_size)
        return v / np.linalg.norm(v)
    if name == "LineManifold":
        n = m.ambient_size // 2
        o = rng.standard_normal(n)
        d = rng.standard_normal(n)
        return np.concatenate([o, d / np.linalg.norm(d)])
    if name == "ProductManifold":
        parts = [_rand_point(sub, rng) for sub in m._manifolds]
        return np.concatenate(parts)
    return rng.standard_normal(m.ambient_size)


MANIFOLDS = [
    EuclideanManifold(3),
    SubsetManifold(4, [1, 3]),
    QuaternionManifold(),
    EigenQuaternionManifold(),
    SphereManifold(4),
    LineManifold(3),
    ProductManifold(EuclideanManifold(2), QuaternionManifold()),
    ProductManifold(SphereManifold(3), EuclideanManifold(1)),
]


@pytest.mark.parametrize("m", MANIFOLDS, ids=lambda m: repr(m))
def test_plus_zero_is_identity(m):
    rng = np.random.default_rng(7)
    for _ in range(5):
        x = jnp.asarray(_rand_point(m, rng))
        zero = jnp.zeros(m.tangent_size)
        np.testing.assert_allclose(
            np.asarray(m.plus(x, zero)), np.asarray(x), atol=1e-12
        )


@pytest.mark.parametrize("m", MANIFOLDS, ids=lambda m: repr(m))
def test_minus_plus_roundtrip(m):
    rng = np.random.default_rng(3)
    for _ in range(5):
        x = jnp.asarray(_rand_point(m, rng))
        d = jnp.asarray(0.05 * rng.standard_normal(m.tangent_size))
        y = m.plus(x, d)
        d_back = m.minus(y, x)
        np.testing.assert_allclose(np.asarray(d_back), np.asarray(d), atol=1e-9)


@pytest.mark.parametrize("m", MANIFOLDS, ids=lambda m: repr(m))
def test_plus_jacobian_matches_numeric(m):
    rng = np.random.default_rng(11)
    x = jnp.asarray(_rand_point(m, rng))
    J = np.asarray(m.plus_jacobian(x))
    assert J.shape == (m.ambient_size, m.tangent_size)
    h = 1e-7
    for j in range(m.tangent_size):
        d = np.zeros(m.tangent_size)
        d[j] = h
        fp = np.asarray(m.plus(x, jnp.asarray(d)))
        fm = np.asarray(m.plus(x, jnp.asarray(-d)))
        np.testing.assert_allclose(J[:, j], (fp - fm) / (2 * h), atol=1e-6)


@pytest.mark.parametrize("m", MANIFOLDS, ids=lambda m: repr(m))
def test_minus_jacobian_matches_numeric(m):
    if isinstance(m, LineManifold):
        pytest.skip("LineManifold minus_jacobian uses autodiff default")
    rng = np.random.default_rng(13)
    x = jnp.asarray(_rand_point(m, rng))
    J = np.asarray(m.minus_jacobian(x))
    assert J.shape == (m.tangent_size, m.ambient_size)
    h = 1e-7
    for j in range(m.ambient_size):
        e = np.zeros(m.ambient_size)
        e[j] = h
        fp = np.asarray(m.minus(x + jnp.asarray(e), x))
        fm = np.asarray(m.minus(x - jnp.asarray(e), x))
        np.testing.assert_allclose(J[:, j], (fp - fm) / (2 * h), atol=1e-6)


@pytest.mark.parametrize("m", MANIFOLDS, ids=lambda m: repr(m))
def test_minus_plus_jacobian_composition(m):
    """MinusJacobian(x) @ PlusJacobian(x) = I (manifold_test_utils.h)."""
    if isinstance(m, LineManifold):
        pytest.skip("LineManifold origin chart is scaled by |d| in the "
                    "reference plus-jacobian; composition is diagonal")
    rng = np.random.default_rng(17)
    x = jnp.asarray(_rand_point(m, rng))
    Jp = np.asarray(m.plus_jacobian(x))
    Jm = np.asarray(m.minus_jacobian(x))
    np.testing.assert_allclose(
        Jm @ Jp, np.eye(m.tangent_size), atol=1e-9
    )


def test_subset_manifold_holds_constants():
    m = SubsetManifold(4, [1, 3])
    x = jnp.asarray([1.0, 2.0, 3.0, 4.0])
    d = jnp.asarray([0.5, -0.5])
    y = np.asarray(m.plus(x, d))
    np.testing.assert_allclose(y, [1.5, 2.0, 2.5, 4.0])


def test_quaternion_plus_keeps_unit_norm():
    m = QuaternionManifold()
    rng = np.random.default_rng(5)
    q = rng.standard_normal(4)
    q = jnp.asarray(q / np.linalg.norm(q))
    y = np.asarray(m.plus(q, jnp.asarray([0.1, -0.2, 0.3])))
    assert np.linalg.norm(y) == pytest.approx(1.0, abs=1e-12)


def test_sphere_plus_keeps_norm():
    m = SphereManifold(4)
    rng = np.random.default_rng(5)
    v = rng.standard_normal(4)
    x = jnp.asarray(2.5 * v / np.linalg.norm(v))  # non-unit: norm preserved
    y = np.asarray(m.plus(x, jnp.asarray([0.1, -0.2, 0.3])))
    assert np.linalg.norm(y) == pytest.approx(2.5, abs=1e-9)


def test_manifolds_are_vmappable():
    m = QuaternionManifold()
    rng = np.random.default_rng(9)
    qs = rng.standard_normal((10, 4))
    qs = jnp.asarray(qs / np.linalg.norm(qs, axis=1, keepdims=True))
    ds = jnp.asarray(0.1 * rng.standard_normal((10, 3)))
    ys = jax.vmap(m.plus)(qs, ds)
    assert ys.shape == (10, 4)
    for i in range(10):
        np.testing.assert_allclose(
            np.asarray(ys[i]), np.asarray(m.plus(qs[i], ds[i])), atol=1e-12
        )
