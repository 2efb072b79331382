"""Rotation conversion torture grid.

Dense coverage of the reference's ``internal/ceres/rotation_test.cc``
(1927 LoC): round trips among angle-axis / quaternion / rotation matrix
at angles approaching the 0 and pi singularities from both sides, random
axes, axis-aligned rotations, differentiability at the singular points,
and the rotate-point kernels against matrix application.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ceres_tpu import rotation as rot

pytestmark = pytest.mark.device

# Angle grid straddling both singularities (rotation_test.cc's
# kNumTrials loops with theta near 0 and near pi).
ANGLES = [
    0.0,
    1e-16,
    1e-12,
    1e-10,
    1e-8,
    1e-6,
    1e-4,
    1e-2,
    0.5,
    1.0,
    np.pi / 2,
    2.5,
    np.pi - 1e-2,
    np.pi - 1e-6,
    np.pi - 1e-10,
    np.pi - 1e-14,
]

AXES = [
    np.array([1.0, 0.0, 0.0]),
    np.array([0.0, 1.0, 0.0]),
    np.array([0.0, 0.0, 1.0]),
    np.array([1.0, 1.0, 1.0]) / np.sqrt(3.0),
    np.array([0.3, -0.7, 0.64]),
    np.array([-0.999, 1e-3, 1e-3]),
]
AXES = [a / np.linalg.norm(a) for a in AXES]


def _aa(axis, angle):
    return jnp.asarray(angle * axis)


def _angle_of(aa):
    return float(np.linalg.norm(np.asarray(aa)))


def _same_rotation_matrix(R1, R2, atol):
    np.testing.assert_allclose(np.asarray(R1), np.asarray(R2), atol=atol)


@pytest.mark.parametrize("angle", ANGLES)
@pytest.mark.parametrize("axis_i", range(len(AXES)))
def test_aa_quat_aa_roundtrip(angle, axis_i):
    aa = _aa(AXES[axis_i], angle)
    q = rot.angle_axis_to_quaternion(aa)
    # unit quaternion out
    assert abs(float(jnp.linalg.norm(q)) - 1.0) < 1e-12
    back = rot.quaternion_to_angle_axis(q)
    # Same rotation: either same vector or (at pi) possibly flipped.
    a1, a2 = np.asarray(aa), np.asarray(back)
    err = min(np.linalg.norm(a1 - a2), np.linalg.norm(a1 + a2))
    assert err < 1e-9 * max(1.0, angle)


@pytest.mark.parametrize("angle", ANGLES)
@pytest.mark.parametrize("axis_i", range(len(AXES)))
def test_aa_matrix_aa_roundtrip(angle, axis_i):
    aa = _aa(AXES[axis_i], angle)
    R = rot.angle_axis_to_rotation_matrix(aa)
    # orthogonality + det 1
    RtR = np.asarray(R).T @ np.asarray(R)
    np.testing.assert_allclose(RtR, np.eye(3), atol=1e-12)
    assert abs(np.linalg.det(np.asarray(R)) - 1.0) < 1e-12
    back = rot.rotation_matrix_to_angle_axis(R)
    R2 = rot.angle_axis_to_rotation_matrix(back)
    _same_rotation_matrix(R, R2, 1e-9)


@pytest.mark.parametrize("angle", ANGLES)
@pytest.mark.parametrize("axis_i", range(len(AXES)))
def test_quat_matrix_quat_roundtrip(angle, axis_i):
    aa = _aa(AXES[axis_i], angle)
    q = rot.angle_axis_to_quaternion(aa)
    R = rot.quaternion_to_rotation_matrix(q)
    q2 = rot.rotation_matrix_to_quaternion(R)
    qa, qb = np.asarray(q), np.asarray(q2)
    err = min(np.linalg.norm(qa - qb), np.linalg.norm(qa + qb))
    assert err < 1e-9


@pytest.mark.parametrize("angle", ANGLES)
def test_rotate_point_all_paths_agree(angle):
    rng = np.random.default_rng(11)
    axis = AXES[4]
    aa = _aa(axis, angle)
    q = rot.angle_axis_to_quaternion(aa)
    R = rot.angle_axis_to_rotation_matrix(aa)
    for _ in range(3):
        p = jnp.asarray(rng.standard_normal(3))
        via_matrix = np.asarray(R) @ np.asarray(p)
        via_aa = np.asarray(rot.angle_axis_rotate_point(aa, p))
        via_q = np.asarray(rot.quaternion_rotate_point(q, p))
        via_uq = np.asarray(rot.unit_quaternion_rotate_point(q, p))
        np.testing.assert_allclose(via_aa, via_matrix, atol=1e-10)
        np.testing.assert_allclose(via_q, via_matrix, atol=1e-10)
        np.testing.assert_allclose(via_uq, via_matrix, atol=1e-10)


@pytest.mark.parametrize("fn_name", [
    "angle_axis_to_quaternion",
    "angle_axis_to_rotation_matrix",
])
@pytest.mark.parametrize("angle", [0.0, 1e-12, 1e-8, 1e-4])
def test_gradients_finite_near_zero(fn_name, angle):
    """jacfwd/jacrev stay finite through the theta->0 Taylor branches
    (the reference tests Jets through the same paths)."""
    fn = getattr(rot, fn_name)
    aa = _aa(AXES[3], angle)
    Jf = np.asarray(jax.jacfwd(fn)(aa))
    Jr = np.asarray(jax.jacrev(fn)(aa))
    assert np.all(np.isfinite(Jf))
    assert np.all(np.isfinite(Jr))
    np.testing.assert_allclose(Jf, Jr, atol=1e-9)


def test_gradient_of_rotate_point_matches_numeric():
    rng = np.random.default_rng(5)
    aa = jnp.asarray(rng.standard_normal(3))
    p = jnp.asarray(rng.standard_normal(3))
    J = np.asarray(jax.jacfwd(lambda a: rot.angle_axis_rotate_point(a, p))(aa))
    eps = 1e-7
    for k in range(3):
        d = np.zeros(3)
        d[k] = eps
        f1 = np.asarray(rot.angle_axis_rotate_point(aa + d, p))
        f0 = np.asarray(rot.angle_axis_rotate_point(aa - d, p))
        np.testing.assert_allclose(J[:, k], (f1 - f0) / (2 * eps), atol=1e-6)


def test_quaternion_product_associativity_and_identity():
    rng = np.random.default_rng(3)
    qs = [rng.standard_normal(4) for _ in range(3)]
    qs = [jnp.asarray(q / np.linalg.norm(q)) for q in qs]
    e = jnp.asarray([1.0, 0.0, 0.0, 0.0])
    a, b, c = qs
    np.testing.assert_allclose(
        np.asarray(rot.quaternion_product(a, e)), np.asarray(a), atol=1e-15
    )
    np.testing.assert_allclose(
        np.asarray(rot.quaternion_product(e, a)), np.asarray(a), atol=1e-15
    )
    lhs = rot.quaternion_product(rot.quaternion_product(a, b), c)
    rhs = rot.quaternion_product(a, rot.quaternion_product(b, c))
    np.testing.assert_allclose(np.asarray(lhs), np.asarray(rhs), atol=1e-14)


def test_quaternion_conjugation_inverts():
    rng = np.random.default_rng(4)
    q = rng.standard_normal(4)
    q = jnp.asarray(q / np.linalg.norm(q))
    conj = q * jnp.asarray([1.0, -1.0, -1.0, -1.0])
    prod = np.asarray(rot.quaternion_product(q, conj))
    np.testing.assert_allclose(prod, [1.0, 0.0, 0.0, 0.0], atol=1e-14)


def test_rotation_matrix_to_quaternion_all_pivots():
    """Rotations by pi about each axis exercise all 4 Shepperd pivots."""
    for axis in np.eye(3):
        aa = jnp.asarray(np.pi * axis)
        R = rot.angle_axis_to_rotation_matrix(aa)
        q = rot.rotation_matrix_to_quaternion(R)
        R2 = rot.quaternion_to_rotation_matrix(q)
        _same_rotation_matrix(R, R2, 1e-12)
    # identity hits the trace pivot
    q = rot.rotation_matrix_to_quaternion(jnp.eye(3))
    np.testing.assert_allclose(np.asarray(q), [1, 0, 0, 0], atol=1e-12)


def test_near_pi_angle_axis_recovery_precision():
    """rotation_test.cc AngleAxisRoundTrip near pi: the recovered angle
    must match to ~sqrt(eps)."""
    for eps_exp in (2, 4, 6, 8):
        angle = np.pi - 10.0 ** (-eps_exp)
        aa = _aa(AXES[1], angle)
        R = rot.angle_axis_to_rotation_matrix(aa)
        back = rot.rotation_matrix_to_angle_axis(R)
        assert abs(_angle_of(back) - angle) < 1e-7


def test_batched_conversions_match_single():
    rng = np.random.default_rng(9)
    aas = jnp.asarray(rng.standard_normal((32, 3)))
    qs = jax.vmap(rot.angle_axis_to_quaternion)(aas)
    for i in (0, 7, 31):
        np.testing.assert_allclose(
            np.asarray(qs[i]),
            np.asarray(rot.angle_axis_to_quaternion(aas[i])),
            atol=1e-15,
        )
    Rs = jax.vmap(rot.angle_axis_to_rotation_matrix)(aas)
    back = jax.vmap(rot.rotation_matrix_to_angle_axis)(Rs)
    np.testing.assert_allclose(np.asarray(back), np.asarray(aas), atol=1e-9)


def test_euler_to_rotation_degenerate_gimbal():
    """Proper-Euler and Tait-Bryan sequences at gimbal-lock angles still
    produce orthonormal matrices and consistent round trips."""
    for seq in ("ZYX", "XYZ", "ZXZ", "YZY"):
        for mid in (np.pi / 2, -np.pi / 2, 0.0):
            angles = jnp.asarray([0.3, mid, -0.4])
            R = rot.euler_to_rotation(angles, seq=seq, intrinsic=True)
            RtR = np.asarray(R).T @ np.asarray(R)
            np.testing.assert_allclose(RtR, np.eye(3), atol=1e-12)
            rec = rot.rotation_to_euler(R, seq=seq, intrinsic=True)
            R2 = rot.euler_to_rotation(rec, seq=seq, intrinsic=True)
            _same_rotation_matrix(R, R2, 1e-9)


def test_float32_roundtrip_tolerance():
    """The f32 path keeps rotations consistent to f32 precision."""
    rng = np.random.default_rng(12)
    aa = jnp.asarray(rng.standard_normal(3), dtype=jnp.float32)
    q = rot.angle_axis_to_quaternion(aa)
    assert q.dtype == jnp.float32
    back = rot.quaternion_to_angle_axis(q)
    np.testing.assert_allclose(np.asarray(back), np.asarray(aa), atol=1e-5)
