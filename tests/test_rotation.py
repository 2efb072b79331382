"""Rotation toolbox tests (mirrors rotation_test.cc invariants:
roundtrips between representations, rotation action consistency)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ceres_tpu import rotation as rot

pytestmark = pytest.mark.device


def _rand_angle_axis(rng, scale=1.0):
    v = rng.standard_normal(3)
    # Keep |angle| < pi: the angle-axis chart is only injective there
    # (rotation_test.cc uses the same restriction for roundtrips).
    return scale * v / np.linalg.norm(v)


@pytest.mark.parametrize("scale", [1e-8, 0.1, 1.0, 3.0])
def test_angle_axis_quaternion_roundtrip(scale):
    rng = np.random.default_rng(0)
    for _ in range(10):
        aa = jnp.asarray(_rand_angle_axis(rng, scale))
        q = rot.angle_axis_to_quaternion(aa)
        assert float(jnp.linalg.norm(q)) == pytest.approx(1.0, abs=1e-10)
        aa_back = rot.quaternion_to_angle_axis(q)
        np.testing.assert_allclose(np.asarray(aa_back), np.asarray(aa), atol=1e-9)


def test_quaternion_rotation_matrix_roundtrip():
    rng = np.random.default_rng(1)
    for _ in range(10):
        q = rng.standard_normal(4)
        q = jnp.asarray(q / np.linalg.norm(q))
        R = rot.quaternion_to_rotation_matrix(q)
        # R must be a rotation.
        np.testing.assert_allclose(
            np.asarray(R @ R.T), np.eye(3), atol=1e-12
        )
        assert float(jnp.linalg.det(R)) == pytest.approx(1.0, abs=1e-12)
        q_back = rot.rotation_matrix_to_quaternion(R)
        # q and -q are the same rotation; canonical sign is w >= 0.
        q_canon = np.asarray(q) * np.sign(float(q[0])) if float(q[0]) != 0 else q
        np.testing.assert_allclose(np.asarray(q_back), q_canon, atol=1e-9)


def test_angle_axis_rotation_matrix_roundtrip():
    rng = np.random.default_rng(2)
    for scale in [1e-7, 0.5, 2.0]:
        aa = jnp.asarray(_rand_angle_axis(rng, scale))
        R = rot.angle_axis_to_rotation_matrix(aa)
        aa_back = rot.rotation_matrix_to_angle_axis(R)
        np.testing.assert_allclose(np.asarray(aa_back), np.asarray(aa), atol=1e-8)


def test_rotate_point_consistency():
    """AngleAxisRotatePoint == R(aa) @ p == UnitQuaternionRotatePoint."""
    rng = np.random.default_rng(3)
    for _ in range(10):
        aa = jnp.asarray(_rand_angle_axis(rng, 1.5))
        p = jnp.asarray(rng.standard_normal(3))
        via_aa = rot.angle_axis_rotate_point(aa, p)
        via_R = rot.angle_axis_to_rotation_matrix(aa) @ p
        via_q = rot.unit_quaternion_rotate_point(
            rot.angle_axis_to_quaternion(aa), p
        )
        np.testing.assert_allclose(np.asarray(via_aa), np.asarray(via_R), atol=1e-12)
        np.testing.assert_allclose(np.asarray(via_aa), np.asarray(via_q), atol=1e-12)


def test_rotate_point_small_angle():
    p = jnp.asarray([1.0, 2.0, 3.0])
    aa = jnp.asarray([1e-12, 0.0, 0.0])
    out = rot.angle_axis_rotate_point(aa, p)
    expected = np.asarray(p) + np.cross([1e-12, 0, 0], np.asarray(p))
    np.testing.assert_allclose(np.asarray(out), expected, atol=1e-15)


def test_quaternion_product_matches_matrix_product():
    rng = np.random.default_rng(4)
    q1 = rng.standard_normal(4)
    q1 = jnp.asarray(q1 / np.linalg.norm(q1))
    q2 = rng.standard_normal(4)
    q2 = jnp.asarray(q2 / np.linalg.norm(q2))
    q12 = rot.quaternion_product(q1, q2)
    R12 = rot.quaternion_to_rotation_matrix(q12)
    R1R2 = rot.quaternion_to_rotation_matrix(q1) @ rot.quaternion_to_rotation_matrix(q2)
    np.testing.assert_allclose(np.asarray(R12), np.asarray(R1R2), atol=1e-12)


def test_euler_angles():
    # 90 degrees about z: x -> y.
    R = rot.euler_angles_to_rotation_matrix(jnp.asarray([90.0, 0.0, 0.0]))
    np.testing.assert_allclose(
        np.asarray(R @ jnp.asarray([1.0, 0.0, 0.0])), [0.0, 1.0, 0.0], atol=1e-12
    )
    # 90 about x (e2): y -> z.
    R = rot.euler_angles_to_rotation_matrix(jnp.asarray([0.0, 0.0, 90.0]))
    np.testing.assert_allclose(
        np.asarray(R @ jnp.asarray([0.0, 1.0, 0.0])), [0.0, 0.0, 1.0], atol=1e-12
    )


def test_rotation_functions_differentiable():
    """The rotation toolbox must be Jet-equivalent: differentiable
    everywhere including theta ~ 0 (rotation.h templated on Jets)."""

    def f(aa):
        return jnp.sum(rot.angle_axis_rotate_point(aa, jnp.asarray([1.0, 2.0, 3.0])))

    g_zero = jax.grad(f)(jnp.zeros(3))
    assert np.all(np.isfinite(np.asarray(g_zero)))
    g = jax.grad(f)(jnp.asarray([0.1, 0.2, 0.3]))
    assert np.all(np.isfinite(np.asarray(g)))

    def h(aa):
        return jnp.sum(rot.angle_axis_to_quaternion(aa))

    assert np.all(np.isfinite(np.asarray(jax.grad(h)(jnp.zeros(3)))))


class TestGeneralizedEuler:
    """All 24 Shoemake Euler conventions round-trip
    (rotation.h:167-216, internal/euler_angles.h)."""

    SEQS = [
        "XYZ", "XZY", "YXZ", "YZX", "ZXY", "ZYX",  # Tait-Bryan
        "XYX", "XZX", "YXY", "YZY", "ZXZ", "ZYZ",  # proper Euler
    ]

    @pytest.mark.parametrize("seq", SEQS)
    @pytest.mark.parametrize("intrinsic", [True, False])
    def test_roundtrip(self, seq, intrinsic):
        from ceres_tpu.rotation import euler_to_rotation, rotation_to_euler

        rng = np.random.default_rng(hash((seq, intrinsic)) % 2**31)
        for _ in range(5):
            if seq[0] == seq[2]:
                ang = np.array([
                    rng.uniform(-np.pi, np.pi),
                    rng.uniform(0.05, np.pi - 0.05),
                    rng.uniform(-np.pi, np.pi),
                ])
            else:
                ang = np.array([
                    rng.uniform(-np.pi, np.pi),
                    rng.uniform(-np.pi / 2 + 0.05, np.pi / 2 - 0.05),
                    rng.uniform(-np.pi, np.pi),
                ])
            R = euler_to_rotation(jnp.asarray(ang), seq, intrinsic)
            back = rotation_to_euler(R, seq, intrinsic)
            R2 = euler_to_rotation(back, seq, intrinsic)
            np.testing.assert_allclose(
                np.asarray(R), np.asarray(R2), atol=1e-10
            )
            np.testing.assert_allclose(np.asarray(back), ang, atol=1e-8)

    def test_extrinsic_is_reversed_intrinsic(self):
        from ceres_tpu.rotation import euler_to_rotation

        ang = jnp.asarray([0.3, -0.7, 1.1])
        R_ext = euler_to_rotation(ang, "XYZ", intrinsic=False)
        R_int = euler_to_rotation(ang[::-1], "ZYX", intrinsic=True)
        np.testing.assert_allclose(
            np.asarray(R_ext), np.asarray(R_int), atol=1e-14
        )

    def test_bad_sequence_raises(self):
        from ceres_tpu.rotation import euler_to_rotation

        with pytest.raises(ValueError):
            euler_to_rotation(jnp.zeros(3), "XXZ")
        with pytest.raises(ValueError):
            euler_to_rotation(jnp.zeros(3), "ABF")
