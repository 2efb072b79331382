"""Rotation toolbox: conversions between angle-axis, quaternion, matrix, Euler.

JAX analog of the reference's ``include/ceres/rotation.h:1-861``. The
reference templates every routine on a scalar type so Jets can flow through;
here every routine is a plain jnp function written branch-free with safe
denominators, so it is differentiable (fwd and rev), ``vmap``-able and
jit-compatible by construction.

Conventions match Ceres: quaternions are [w, x, y, z] (scalar first, unit
norm for "unit" variants), angle-axis vectors encode axis * angle in radians,
rotation matrices are 3x3 with ``R @ p`` rotating ``p``, Euler angles are in
degrees with R = R_z(e0) R_y(e1) R_x(e2).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_SMALL = 1e-24


def cross(a: jax.Array, b: jax.Array) -> jax.Array:
    """Cross product (rotation.h CrossProduct)."""
    return jnp.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        axis=-1,
    )


def angle_axis_to_quaternion(angle_axis: jax.Array) -> jax.Array:
    """rotation.h AngleAxisToQuaternion."""
    theta_sq = jnp.sum(angle_axis * angle_axis, axis=-1, keepdims=True)
    small = theta_sq < _SMALL
    theta = jnp.sqrt(jnp.where(small, 1.0, theta_sq))
    half = 0.5 * theta
    # k = sin(theta/2)/theta; Taylor 0.5 - theta^2/48 near zero.
    k = jnp.where(small, 0.5 - theta_sq / 48.0, jnp.sin(half) / theta)
    w = jnp.where(small, 1.0 - theta_sq / 8.0, jnp.cos(half))
    return jnp.concatenate([w, k * angle_axis], axis=-1)


def quaternion_to_angle_axis(quaternion: jax.Array) -> jax.Array:
    """rotation.h QuaternionToAngleAxis."""
    q = quaternion
    sin_sq = jnp.sum(q[..., 1:] * q[..., 1:], axis=-1, keepdims=True)
    small = sin_sq < _SMALL
    sin_theta = jnp.sqrt(jnp.where(small, 1.0, sin_sq))
    cos_theta = q[..., 0:1]
    # Angle in [-pi, pi): flip both arguments when cos < 0 (rotation.h:489-506).
    two_theta = 2.0 * jnp.where(
        cos_theta < 0.0,
        jnp.arctan2(-sin_theta, -cos_theta),
        jnp.arctan2(sin_theta, cos_theta),
    )
    k = jnp.where(small, 2.0, two_theta / sin_theta)
    return k * q[..., 1:]


def quaternion_to_rotation_matrix(q: jax.Array) -> jax.Array:
    """rotation.h QuaternionToScaledRotation normalized (QuaternionToRotation)."""
    norm = jnp.sqrt(jnp.sum(q * q, axis=-1, keepdims=True))
    q = q / norm
    a, b, c, d = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    aa, ab, ac, ad = a * a, a * b, a * c, a * d
    bb, bc, bd = b * b, b * c, b * d
    cc, cd = c * c, c * d
    dd = d * d
    R = jnp.stack(
        [
            jnp.stack([aa + bb - cc - dd, 2 * (bc - ad), 2 * (ac + bd)], axis=-1),
            jnp.stack([2 * (ad + bc), aa - bb + cc - dd, 2 * (cd - ab)], axis=-1),
            jnp.stack([2 * (bd - ac), 2 * (ab + cd), aa - bb - cc + dd], axis=-1),
        ],
        axis=-2,
    )
    return R


def rotation_matrix_to_quaternion(R: jax.Array) -> jax.Array:
    """rotation.h RotationMatrixToQuaternion.

    Branch-free Shepperd's method: compute the quaternion from all four
    pivots and select the numerically best (largest pivot) with where.
    """
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    trace = r00 + r11 + r22

    def safe_sqrt(v):
        return jnp.sqrt(jnp.maximum(v, 1e-30))

    # Case 0: trace pivot.
    t0 = safe_sqrt(1.0 + trace)
    q0 = jnp.stack(
        [0.5 * t0, 0.5 * (r21 - r12) / t0, 0.5 * (r02 - r20) / t0, 0.5 * (r10 - r01) / t0],
        axis=-1,
    )
    # Case 1: r00 pivot.
    t1 = safe_sqrt(1.0 + r00 - r11 - r22)
    q1 = jnp.stack(
        [0.5 * (r21 - r12) / t1, 0.5 * t1, 0.5 * (r01 + r10) / t1, 0.5 * (r02 + r20) / t1],
        axis=-1,
    )
    # Case 2: r11 pivot.
    t2 = safe_sqrt(1.0 - r00 + r11 - r22)
    q2 = jnp.stack(
        [0.5 * (r02 - r20) / t2, 0.5 * (r01 + r10) / t2, 0.5 * t2, 0.5 * (r12 + r21) / t2],
        axis=-1,
    )
    # Case 3: r22 pivot.
    t3 = safe_sqrt(1.0 - r00 - r11 + r22)
    q3 = jnp.stack(
        [0.5 * (r10 - r01) / t3, 0.5 * (r02 + r20) / t3, 0.5 * (r12 + r21) / t3, 0.5 * t3],
        axis=-1,
    )

    pivots = jnp.stack([trace, r00, r11, r22], axis=-1)
    case = jnp.argmax(pivots, axis=-1)
    q = jnp.where(
        (case == 0)[..., None],
        q0,
        jnp.where((case == 1)[..., None], q1, jnp.where((case == 2)[..., None], q2, q3)),
    )
    # Canonical sign: w >= 0.
    return q * jnp.where(q[..., 0:1] < 0, -1.0, 1.0)


def angle_axis_to_rotation_matrix(angle_axis: jax.Array) -> jax.Array:
    """rotation.h AngleAxisToRotationMatrix (Rodrigues)."""
    theta_sq = jnp.sum(angle_axis * angle_axis, axis=-1)
    small = theta_sq < _SMALL
    theta = jnp.sqrt(jnp.where(small, 1.0, theta_sq))
    axis = angle_axis / theta[..., None]
    wx, wy, wz = axis[..., 0], axis[..., 1], axis[..., 2]
    c = jnp.cos(theta)
    s = jnp.sin(theta)
    one_c = 1.0 - c
    R_full = jnp.stack(
        [
            jnp.stack([c + wx * wx * one_c, wx * wy * one_c - wz * s, wy * s + wx * wz * one_c], axis=-1),
            jnp.stack([wz * s + wx * wy * one_c, c + wy * wy * one_c, -wx * s + wy * wz * one_c], axis=-1),
            jnp.stack([-wy * s + wx * wz * one_c, wx * s + wy * wz * one_c, c + wz * wz * one_c], axis=-1),
        ],
        axis=-2,
    )
    # Near zero: R = I + skew(angle_axis) (rotation.h:417-430).
    ax, ay, az = angle_axis[..., 0], angle_axis[..., 1], angle_axis[..., 2]
    one = jnp.ones_like(ax)
    R_small = jnp.stack(
        [
            jnp.stack([one, -az, ay], axis=-1),
            jnp.stack([az, one, -ax], axis=-1),
            jnp.stack([-ay, ax, one], axis=-1),
        ],
        axis=-2,
    )
    return jnp.where(small[..., None, None], R_small, R_full)


def rotation_matrix_to_angle_axis(R: jax.Array) -> jax.Array:
    """rotation.h RotationMatrixToAngleAxis (via quaternion)."""
    return quaternion_to_angle_axis(rotation_matrix_to_quaternion(R))


def euler_angles_to_rotation_matrix(euler_deg: jax.Array) -> jax.Array:
    """rotation.h EulerAnglesToRotationMatrix: degrees, R = Rz(e0) Ry(e1) Rx(e2)."""
    rad = euler_deg * (jnp.pi / 180.0)
    c1, c2, c3 = jnp.cos(rad[..., 0]), jnp.cos(rad[..., 1]), jnp.cos(rad[..., 2])
    s1, s2, s3 = jnp.sin(rad[..., 0]), jnp.sin(rad[..., 1]), jnp.sin(rad[..., 2])
    return jnp.stack(
        [
            jnp.stack([c1 * c2, -s1 * c3 + c1 * s2 * s3, s1 * s3 + c1 * s2 * c3], axis=-1),
            jnp.stack([s1 * c2, c1 * c3 + s1 * s2 * s3, -c1 * s3 + s1 * s2 * c3], axis=-1),
            jnp.stack([-s2, c2 * s3, c2 * c3], axis=-1),
        ],
        axis=-2,
    )


def quaternion_product(z: jax.Array, w: jax.Array) -> jax.Array:
    """rotation.h QuaternionProduct, [w, x, y, z] order."""
    return jnp.stack(
        [
            z[..., 0] * w[..., 0] - z[..., 1] * w[..., 1] - z[..., 2] * w[..., 2] - z[..., 3] * w[..., 3],
            z[..., 0] * w[..., 1] + z[..., 1] * w[..., 0] + z[..., 2] * w[..., 3] - z[..., 3] * w[..., 2],
            z[..., 0] * w[..., 2] - z[..., 1] * w[..., 3] + z[..., 2] * w[..., 0] + z[..., 3] * w[..., 1],
            z[..., 0] * w[..., 3] + z[..., 1] * w[..., 2] - z[..., 2] * w[..., 1] + z[..., 3] * w[..., 0],
        ],
        axis=-1,
    )


def unit_quaternion_rotate_point(q: jax.Array, pt: jax.Array) -> jax.Array:
    """rotation.h UnitQuaternionRotatePoint: p' = p + 2 q0 (v x p) + 2 v x (v x p)."""
    v = q[..., 1:]
    t = 2.0 * cross(v, pt)
    return pt + q[..., 0:1] * t + cross(v, t)


def quaternion_rotate_point(q: jax.Array, pt: jax.Array) -> jax.Array:
    """rotation.h QuaternionRotatePoint: normalizes first."""
    norm = jnp.sqrt(jnp.sum(q * q, axis=-1, keepdims=True))
    return unit_quaternion_rotate_point(q / norm, pt)


def angle_axis_rotate_point(angle_axis: jax.Array, pt: jax.Array) -> jax.Array:
    """rotation.h AngleAxisRotatePoint (Rodrigues, safe at theta = 0)."""
    theta_sq = jnp.sum(angle_axis * angle_axis, axis=-1, keepdims=True)
    small = theta_sq < _SMALL
    theta = jnp.sqrt(jnp.where(small, 1.0, theta_sq))
    w = angle_axis / theta
    cos_t = jnp.cos(theta)
    sin_t = jnp.sin(theta)
    w_cross_pt = cross(w, pt)
    w_dot_pt = jnp.sum(w * pt, axis=-1, keepdims=True)
    full = pt * cos_t + w_cross_pt * sin_t + w * (w_dot_pt * (1.0 - cos_t))
    # Near zero: p + aa x p, first-order exact and differentiable
    # (rotation.h:598-622).
    near = pt + cross(angle_axis, pt)
    return jnp.where(small, near, full)


def rotate_point(R: jax.Array, pt: jax.Array) -> jax.Array:
    """R @ p for batched R."""
    return jnp.einsum("...ij,...j->...i", R, pt)


# ---------------------------------------------------------------------------
# Generalized Euler angle conventions (include/ceres/rotation.h:167-216,
# internal/euler_angles.h — all 24 Shoemake conventions via sequence
# strings like "ZYX" (Tait-Bryan) or "ZXZ" (proper Euler), intrinsic or
# extrinsic).
# ---------------------------------------------------------------------------

_AXIS = {"X": 0, "Y": 1, "Z": 2}


def _axis_rotation(axis: int, theta):
    c, s = jnp.cos(theta), jnp.sin(theta)
    i = (axis + 1) % 3
    j = (axis + 2) % 3
    R = jnp.zeros((3, 3), dtype=jnp.result_type(theta, 1.0))
    R = R.at[axis, axis].set(1.0)
    R = R.at[i, i].set(c).at[j, j].set(c)
    R = R.at[i, j].set(-s).at[j, i].set(s)
    return R


def euler_to_rotation(angles, seq: str = "ZYX", intrinsic: bool = True):
    """R from three rotation angles about the axes named in ``seq``
    (EulerAnglesToRotation, rotation.h:167). Intrinsic: body-frame
    composition R = R1 R2 R3; extrinsic: world-frame, R = R3 R2 R1."""
    seq = seq.upper()
    if len(seq) != 3 or any(c not in _AXIS for c in seq):
        raise ValueError(f"bad Euler sequence {seq!r}")
    if seq[0] == seq[1] or seq[1] == seq[2]:
        raise ValueError(f"consecutive repeated axis in {seq!r}")
    Rs = [_axis_rotation(_AXIS[c], angles[n]) for n, c in enumerate(seq)]
    if intrinsic:
        return Rs[0] @ Rs[1] @ Rs[2]
    return Rs[2] @ Rs[1] @ Rs[0]


def rotation_to_euler(R, seq: str = "ZYX", intrinsic: bool = True):
    """Inverse of euler_to_rotation (RotationMatrixToEulerAngles,
    rotation.h:199): supports all 12 intrinsic and 12 extrinsic
    conventions. Returns angles in the middle-angle principal range."""
    seq = seq.upper()
    if not intrinsic:
        # extrinsic (i,j,k) with angles (a,b,c) == intrinsic (k,j,i)
        # with angles (c,b,a)
        a3, a2, a1 = rotation_to_euler(R, seq[::-1], intrinsic=True)
        return jnp.stack([a1, a2, a3])
    i, j, k = (_AXIS[c] for c in seq)
    # Gimbal-lock handling (both branches): at the singular middle angle
    # only a +/- c is observable; the convention (matching Eigen's
    # eulerAngles and rotation.h:199's principal ranges) is c = 0 with
    # the whole residual rotation folded into a. Implemented branch-free
    # with jnp.where so the function stays jit/vmap-compatible.
    i1, i2 = (i + 1) % 3, (i + 2) % 3
    if i == k:  # proper Euler (i, j, i); singular at b = 0, pi
        l = 3 - i - j
        e = 1.0 if (j - i) % 3 == 1 else -1.0
        cb = jnp.clip(R[i, i], -1.0, 1.0)
        b = jnp.arccos(cb)
        a = jnp.arctan2(R[j, i], -e * R[l, i])
        c = jnp.arctan2(R[i, j], e * R[i, l])
        degenerate = jnp.abs(cb) > 1.0 - 1e-10
        # b ~ 0: R = R_i(a + c);  b ~ pi: R_i(a) = R @ R_j(pi).
        M_pi = R @ _axis_rotation(j, jnp.asarray(jnp.pi, R.dtype))
        a_deg = jnp.where(
            cb > 0.0,
            jnp.arctan2(R[i2, i1], R[i1, i1]),
            jnp.arctan2(M_pi[i2, i1], M_pi[i1, i1]),
        )
        a = jnp.where(degenerate, a_deg, a)
        c = jnp.where(degenerate, 0.0, c)
    else:  # Tait-Bryan (i, j, k) all distinct; singular at b = +/- pi/2
        e = 1.0 if (j - i) % 3 == 1 else -1.0
        sb = jnp.clip(e * R[i, k], -1.0, 1.0)
        b = jnp.arcsin(sb)
        a = jnp.arctan2(-e * R[j, k], R[k, k])
        c = jnp.arctan2(-e * R[i, j], R[i, i])
        degenerate = jnp.abs(sb) > 1.0 - 1e-10
        # c = 0: R_i(a) = R @ R_j(-b) with b = +/- pi/2.
        half_pi = jnp.asarray(jnp.pi / 2, R.dtype)
        M_p = R @ _axis_rotation(j, -half_pi)
        M_m = R @ _axis_rotation(j, half_pi)
        a_deg = jnp.where(
            sb > 0.0,
            jnp.arctan2(M_p[i2, i1], M_p[i1, i1]),
            jnp.arctan2(M_m[i2, i1], M_m[i1, i1]),
        )
        a = jnp.where(degenerate, a_deg, a)
        c = jnp.where(degenerate, 0.0, c)
    return jnp.stack([a, b, c])
