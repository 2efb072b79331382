"""Manifolds: Plus/Minus charts between ambient and tangent spaces.

JAX analog of the reference's ``include/ceres/manifold.h:148-411``,
``sphere_manifold.h``, ``line_manifold.h``, ``product_manifold.h`` and
``internal/{sphere_manifold_functions.h, householder_vector.h}``.

Every operation is a pure jnp function on single-block 1-D arrays, written
branch-free (``jnp.where`` + safe denominators) so it can be ``vmap``ped over
all parameter blocks sharing a manifold and differentiated by ``jax.jacfwd``.
The evaluator composes residual functions with ``plus(x, delta)`` and
differentiates w.r.t. ``delta`` at 0 — exactly the chain-rule the reference
applies via CostFunction jacobian x PlusJacobian (residual_block.cc:136-159),
but fused into one forward-mode pass.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_EPS = float(np.finfo(np.float64).eps)


def _sinc(theta_sq: jax.Array, theta: jax.Array) -> jax.Array:
    """sin(t)/t with a Taylor branch at t ~ 0, safe under jacfwd."""
    small = theta_sq < 1e-24
    safe_theta = jnp.where(small, 1.0, theta)
    return jnp.where(small, 1.0 - theta_sq / 6.0, jnp.sin(safe_theta) / safe_theta)


class Manifold:
    """Base manifold (manifold.h:148-221).

    plus(x, delta) -> x', minus(y, x) -> delta, plus_jacobian(x) -> (A, T),
    minus_jacobian(x) -> (T, A), with A = ambient_size, T = tangent_size.
    """

    @property
    def ambient_size(self) -> int:
        raise NotImplementedError

    @property
    def tangent_size(self) -> int:
        raise NotImplementedError

    def plus(self, x: jax.Array, delta: jax.Array) -> jax.Array:
        raise NotImplementedError

    def minus(self, y: jax.Array, x: jax.Array) -> jax.Array:
        raise NotImplementedError

    def plus_jacobian(self, x: jax.Array) -> jax.Array:
        """d plus(x, delta) / d delta at delta = 0 (default: autodiff)."""
        zero = jnp.zeros((self.tangent_size,), dtype=x.dtype)
        return jax.jacfwd(lambda d: self.plus(x, d))(zero)

    def minus_jacobian(self, x: jax.Array) -> jax.Array:
        """d minus(y, x) / d y at y = x (default: autodiff)."""
        return jax.jacfwd(lambda y: self.minus(y, x))(x)

    def __repr__(self) -> str:  # pragma: no cover
        return f"{type(self).__name__}(A={self.ambient_size}, T={self.tangent_size})"

    # Manifolds act as family-grouping keys; equality = same structure.
    def _key(self):
        return (type(self).__name__, self.ambient_size, self.tangent_size)

    def __eq__(self, other):
        return isinstance(other, Manifold) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())


class EuclideanManifold(Manifold):
    """Plain vector space: plus = +, jacobians = identity (manifold.h:241)."""

    def __init__(self, size: int):
        self._size = int(size)

    ambient_size = property(lambda self: self._size)
    tangent_size = property(lambda self: self._size)

    def plus(self, x, delta):
        return x + delta

    def minus(self, y, x):
        return y - x

    def plus_jacobian(self, x):
        return jnp.eye(self._size, dtype=x.dtype)

    def minus_jacobian(self, x):
        return jnp.eye(self._size, dtype=x.dtype)


class SubsetManifold(Manifold):
    """Euclidean with some coordinates held constant (manifold.h:317)."""

    def __init__(self, size: int, constant_indices: Sequence[int]):
        self._size = int(size)
        const = sorted(set(int(i) for i in constant_indices))
        for i in const:
            if not 0 <= i < size:
                raise ValueError(f"constant index {i} out of range [0, {size})")
        self._constant = tuple(const)
        self._free = tuple(i for i in range(size) if i not in set(const))

    ambient_size = property(lambda self: self._size)
    tangent_size = property(lambda self: len(self._free))

    @property
    def constant_indices(self) -> Tuple[int, ...]:
        return self._constant

    def plus(self, x, delta):
        free = jnp.asarray(self._free, dtype=jnp.int32)
        return x.at[free].add(delta)

    def minus(self, y, x):
        free = jnp.asarray(self._free, dtype=jnp.int32)
        return (y - x)[free]

    def plus_jacobian(self, x):
        jac = jnp.zeros((self._size, len(self._free)), dtype=x.dtype)
        free = jnp.asarray(self._free, dtype=jnp.int32)
        return jac.at[free, jnp.arange(len(self._free))].set(1.0)

    def minus_jacobian(self, x):
        return self.plus_jacobian(x).T

    def _key(self):
        return ("Subset", self._size, self._constant)


def _quat_product(z, w, order):
    """Hamilton product z*w for component order (w_idx, x_idx, y_idx, z_idx)."""
    W, X, Y, Z = order
    return (
        jnp.stack(
            [
                z[W] * w[W] - z[X] * w[X] - z[Y] * w[Y] - z[Z] * w[Z],
                z[W] * w[X] + z[X] * w[W] + z[Y] * w[Z] - z[Z] * w[Y],
                z[W] * w[Y] - z[X] * w[Z] + z[Y] * w[W] + z[Z] * w[X],
                z[W] * w[Z] + z[X] * w[Y] - z[Y] * w[X] + z[Z] * w[W],
            ]
        ),
        (0, 1, 2, 3),
    )


class _QuaternionManifoldBase(Manifold):
    """Unit quaternion manifold (manifold.cc:27-130, 264-330).

    plus(x, delta) = q(delta) * x with q(delta) = [cos|d|, sinc|d| d]
    (full-angle convention); minus(y, x) = log(y * conj(x)).
    ``_order`` maps (w, x, y, z) to storage indices.
    """

    _order: Tuple[int, int, int, int]

    ambient_size = property(lambda self: 4)
    tangent_size = property(lambda self: 3)

    def plus(self, x, delta):
        W, X, Y, Z = self._order
        theta_sq = jnp.sum(delta * delta)
        theta = jnp.sqrt(jnp.where(theta_sq < 1e-24, 1.0, theta_sq))
        sinc = _sinc(theta_sq, theta)
        cos = jnp.where(theta_sq < 1e-24, 1.0 - theta_sq / 2.0, jnp.cos(theta))
        q = jnp.zeros(4, dtype=x.dtype)
        q = q.at[W].set(cos)
        q = q.at[X].set(sinc * delta[0])
        q = q.at[Y].set(sinc * delta[1])
        q = q.at[Z].set(sinc * delta[2])
        prod_wxyz, _ = _quat_product(
            (q[W], q[X], q[Y], q[Z]), (x[W], x[X], x[Y], x[Z]), (0, 1, 2, 3)
        )
        out = jnp.zeros(4, dtype=x.dtype)
        out = out.at[W].set(prod_wxyz[0])
        out = out.at[X].set(prod_wxyz[1])
        out = out.at[Y].set(prod_wxyz[2])
        out = out.at[Z].set(prod_wxyz[3])
        return out

    def minus(self, y, x):
        W, X, Y, Z = self._order
        # y * conj(x) in (w, x, y, z) components (manifold.cc:81-114).
        amb, _ = _quat_product(
            (y[W], y[X], y[Y], y[Z]), (x[W], -x[X], -x[Y], -x[Z]), (0, 1, 2, 3)
        )
        v = amb[1:]
        u_sq = jnp.sum(v * v)
        small = u_sq < 1e-300
        u = jnp.sqrt(jnp.where(small, 1.0, u_sq))
        theta_by_u = jnp.where(small, 0.0, jnp.arctan2(u, amb[0]) / u)
        return theta_by_u * v

    def plus_jacobian(self, x):
        # d(q(delta) * x)/d delta at 0 = right-multiplication matrix
        # R(x)[:, (x,y,z)] (manifold.cc QuaternionPlusJacobianImpl).
        W, X, Y, Z = self._order
        w, xx, yy, zz = x[W], x[X], x[Y], x[Z]
        rows = {
            W: jnp.stack([-xx, -yy, -zz]),
            X: jnp.stack([w, zz, -yy]),
            Y: jnp.stack([-zz, w, xx]),
            Z: jnp.stack([yy, -xx, w]),
        }
        return jnp.stack([rows[i] for i in range(4)], axis=0)

    def minus_jacobian(self, x):
        # d minus(y, x)/d y at y = x: rows (x, y, z) of right-mult by conj(x).
        W, X, Y, Z = self._order
        w, xx, yy, zz = x[W], x[X], x[Y], x[Z]
        cols = {
            W: jnp.stack([-xx, -yy, -zz]),
            X: jnp.stack([w, zz, -yy]),
            Y: jnp.stack([-zz, w, xx]),
            Z: jnp.stack([yy, -xx, w]),
        }
        return jnp.stack([cols[i] for i in range(4)], axis=1)


class QuaternionManifold(_QuaternionManifoldBase):
    """Ceres storage order [w, x, y, z] (manifold.h:366)."""

    _order = (0, 1, 2, 3)


class EigenQuaternionManifold(_QuaternionManifoldBase):
    """Eigen storage order [x, y, z, w] (manifold.h:390)."""

    _order = (3, 0, 1, 2)


def householder_vector(x: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """(v, beta) with H = I - beta v v^T orthogonal and H x = |x| e_n.

    Pivot is the *last* element, matching householder_vector.h:48-82.
    Branch-free jnp version.
    """
    n = x.shape[0]
    sigma = jnp.sum(x[:-1] * x[:-1])
    x_pivot = x[-1]
    small = sigma <= _EPS
    mu = jnp.sqrt(x_pivot * x_pivot + sigma)
    denom = jnp.where(x_pivot > 0.0, x_pivot + mu, 1.0)
    v_pivot = jnp.where(x_pivot <= 0.0, x_pivot - mu, -sigma / denom)
    v_pivot_safe = jnp.where(small | (v_pivot == 0.0), 1.0, v_pivot)
    beta = jnp.where(
        small,
        jnp.where(x_pivot < 0.0, 2.0, 0.0),
        2.0 * v_pivot * v_pivot / (sigma + v_pivot * v_pivot),
    )
    head = jnp.where(small, x[:-1], x[:-1] / v_pivot_safe)
    v = jnp.concatenate([head, jnp.ones((1,), dtype=x.dtype)])
    del n
    return v, beta


def apply_householder(y: jax.Array, v: jax.Array, beta: jax.Array) -> jax.Array:
    """H y = y - beta v (v . y) (householder_vector.h:85-90)."""
    return y - v * (beta * jnp.dot(v, y))


class SphereManifold(Manifold):
    """Unit-direction sphere S^{n-1} embedded in R^n (sphere_manifold.h).

    Chart via the Householder reflection taking x to |x| e_n
    (sphere_manifold_functions.h:64-131; Hertzberg et al. B.2 eq. 106-108).
    """

    def __init__(self, size: int):
        if size <= 1:
            raise ValueError("SphereManifold needs ambient size > 1")
        self._size = int(size)

    ambient_size = property(lambda self: self._size)
    tangent_size = property(lambda self: self._size - 1)

    def plus(self, x, delta):
        theta_sq = jnp.sum(delta * delta)
        theta = jnp.sqrt(jnp.where(theta_sq < 1e-24, 1.0, theta_sq))
        sinc = _sinc(theta_sq, theta)
        cos = jnp.where(theta_sq < 1e-24, 1.0 - theta_sq / 2.0, jnp.cos(theta))
        v, beta = householder_vector(x)
        y = jnp.concatenate([sinc * delta, cos[None]])
        return jnp.linalg.norm(x) * apply_householder(y, v, beta)

    def minus(self, y, x):
        v, beta = householder_vector(x)
        hy = apply_householder(y, v, beta) / jnp.linalg.norm(x)
        head, y_last = hy[:-1], hy[-1]
        hn_sq = jnp.sum(head * head)
        small = hn_sq == 0.0
        hn = jnp.sqrt(jnp.where(small, 1.0, hn_sq))
        scale = jnp.where(small, 0.0, jnp.arctan2(hn, y_last) / hn)
        out = scale * head
        # Degenerate antipodal case: delta = [0, ..., pi] (sphere_manifold_functions.h:124-127).
        pi_tail = jnp.zeros_like(out).at[-1].set(jnp.where(y_last >= 0, 0.0, jnp.pi))
        return jnp.where(small, pi_tail, out)

    def plus_jacobian(self, x):
        v, beta = householder_vector(x)
        H = jnp.eye(self._size, dtype=x.dtype) - beta * jnp.outer(v, v)
        return H[:, :-1] * jnp.linalg.norm(x)

    def minus_jacobian(self, x):
        v, beta = householder_vector(x)
        H = jnp.eye(self._size, dtype=x.dtype) - beta * jnp.outer(v, v)
        return H[:-1, :] / jnp.linalg.norm(x)


class LineManifold(Manifold):
    """Line in R^n as (origin, direction) with direction on the sphere.

    Ambient = 2n ([origin, direction]); tangent = 2(n-1). Mirrors
    line_manifold.h:142-270: the origin moves only perpendicular to the
    direction (through the direction's Householder frame).
    """

    def __init__(self, size: int):
        if size <= 1:
            raise ValueError("LineManifold needs spatial dim > 1")
        self._n = int(size)
        self._sphere = SphereManifold(size)

    ambient_size = property(lambda self: 2 * self._n)
    tangent_size = property(lambda self: 2 * (self._n - 1))

    def plus(self, x, delta):
        n = self._n
        o, d = x[:n], x[n:]
        delta_o, delta_d = delta[: n - 1], delta[n - 1 :]
        d_new = self._sphere.plus(d, delta_d)
        v, beta = householder_vector(d)
        y = jnp.concatenate([delta_o, jnp.zeros((1,), dtype=x.dtype)])
        o_new = o + apply_householder(y, v, beta)
        return jnp.concatenate([o_new, d_new])

    def minus(self, y, x):
        n = self._n
        y_o, y_d = y[:n], y[n:]
        x_o, x_d = x[:n], x[n:]
        d_tangent = self._sphere.minus(y_d, x_d)
        v, beta = householder_vector(x_d)
        o_tangent = apply_householder(y_o - x_o, v, beta)[: n - 1]
        return jnp.concatenate([o_tangent, d_tangent])

    def plus_jacobian(self, x):
        n = self._n
        d = x[n:]
        jac_d = self._sphere.plus_jacobian(d)  # (n, n-1)
        jac = jnp.zeros((2 * n, 2 * (n - 1)), dtype=x.dtype)
        # line_manifold.h:219-238: both diagonal blocks are the sphere
        # plus-jacobian of the direction.
        jac = jac.at[:n, : n - 1].set(jac_d)
        jac = jac.at[n:, n - 1 :].set(jac_d)
        return jac

    def minus_jacobian(self, x):
        """Analytic d minus(y, x)/dy at y = x (line_manifold.h:240-263):
        block-diagonal of the Householder head rows (origin) and the
        sphere minus-jacobian (direction). The default autodiff path is
        numerically undefined exactly at y = x (chart branch point)."""
        n = self._n
        d = x[n:]
        v, beta = householder_vector(d)
        H = jnp.eye(n, dtype=x.dtype) - beta * jnp.outer(v, v)
        jac = jnp.zeros((2 * (n - 1), 2 * n), dtype=x.dtype)
        jac = jac.at[: n - 1, :n].set(H[:-1, :])
        jac = jac.at[n - 1 :, n:].set(self._sphere.minus_jacobian(d))
        return jac


class ProductManifold(Manifold):
    """Cartesian product of manifolds (product_manifold.h)."""

    def __init__(self, *manifolds: Manifold):
        if not manifolds:
            raise ValueError("ProductManifold needs at least one manifold")
        self._manifolds = tuple(manifolds)
        self._ambient = sum(m.ambient_size for m in manifolds)
        self._tangent = sum(m.tangent_size for m in manifolds)

    ambient_size = property(lambda self: self._ambient)
    tangent_size = property(lambda self: self._tangent)
    manifolds = property(lambda self: self._manifolds)

    def _splits(self):
        a = t = 0
        for m in self._manifolds:
            yield m, a, t
            a += m.ambient_size
            t += m.tangent_size

    def plus(self, x, delta):
        parts = []
        for m, a, t in self._splits():
            parts.append(
                m.plus(x[a : a + m.ambient_size], delta[t : t + m.tangent_size])
            )
        return jnp.concatenate(parts)

    def minus(self, y, x):
        parts = []
        for m, a, _ in self._splits():
            parts.append(m.minus(y[a : a + m.ambient_size], x[a : a + m.ambient_size]))
        return jnp.concatenate(parts)

    def plus_jacobian(self, x):
        jac = jnp.zeros((self._ambient, self._tangent), dtype=x.dtype)
        for m, a, t in self._splits():
            jac = jac.at[
                a : a + m.ambient_size, t : t + m.tangent_size
            ].set(m.plus_jacobian(x[a : a + m.ambient_size]))
        return jac

    def minus_jacobian(self, x):
        jac = jnp.zeros((self._tangent, self._ambient), dtype=x.dtype)
        for m, a, t in self._splits():
            jac = jac.at[
                t : t + m.tangent_size, a : a + m.ambient_size
            ].set(m.minus_jacobian(x[a : a + m.ambient_size]))
        return jac

    def _key(self):
        return ("Product",) + tuple(m._key() for m in self._manifolds)
