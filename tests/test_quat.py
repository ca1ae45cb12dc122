import numpy as np
import pytest

from zig_vulkan_jax.utils import quat as q


def test_identity_rotates_nothing():
    v = q.vec3(1.0, 2.0, 3.0)
    out = q.quat_rotate_vec(q.quat_identity(), v)
    np.testing.assert_allclose(out, v, atol=1e-6)


def test_axis_angle_90deg_about_y():
    qy = q.quat_from_axis_angle(90.0, [0.0, 1.0, 0.0])
    v = q.vec3(0.0, 0.0, 1.0)
    out = q.quat_rotate_vec(qy, v)
    # right-handed rotation about +y takes +z to +x
    np.testing.assert_allclose(out, [1.0, 0.0, 0.0], atol=1e-6)


def test_mul_composes_rotations():
    qa = q.quat_from_axis_angle(90.0, [0.0, 1.0, 0.0])
    qb = q.quat_from_axis_angle(90.0, [1.0, 0.0, 0.0])
    v = q.vec3(0.0, 0.0, 1.0)
    seq = q.quat_rotate_vec(qa, q.quat_rotate_vec(qb, v))
    composed = q.quat_rotate_vec(q.quat_mul(qa, qb), v)
    np.testing.assert_allclose(seq, composed, atol=1e-6)


def test_rotate_vec_preserves_length():
    rng = np.random.default_rng(0)
    for _ in range(10):
        axis = rng.normal(size=3).astype(np.float32)
        angle = rng.uniform(-180, 180)
        quat = q.quat_from_axis_angle(angle, axis)
        v = rng.normal(size=3).astype(np.float32)
        out = q.quat_rotate_vec(quat, v)
        assert np.linalg.norm(out) == pytest.approx(np.linalg.norm(v), rel=1e-5)


def test_slerp_endpoints():
    qa = q.quat_from_euler_angles(0.0, 0.0, 0.0)
    qb = q.quat_from_euler_angles(0.0, 10.0, 120.0)
    np.testing.assert_allclose(q.quat_slerp(qa, qb, 0.0), qa, atol=1e-5)
    np.testing.assert_allclose(
        np.abs(q.quat_slerp(qa, qb, 1.0)), np.abs(qb), atol=1e-5
    )


def test_slerp_halfway_about_single_axis():
    qa = q.quat_identity()
    qb = q.quat_from_axis_angle(90.0, [0.0, 1.0, 0.0])
    mid = q.quat_slerp(qa, qb, 0.5)
    expect = q.quat_from_axis_angle(45.0, [0.0, 1.0, 0.0])
    np.testing.assert_allclose(mid, expect, atol=1e-5)


def test_lerp_is_componentwise():
    qa = np.array([1.0, 0.0, 0.0, 0.0], dtype=np.float32)
    qb = np.array([0.0, 1.0, 0.0, 0.0], dtype=np.float32)
    np.testing.assert_allclose(q.quat_lerp(qa, qb, 0.25), [0.75, 0.25, 0.0, 0.0])


def test_extract_euler_x_roundtrip():
    for deg in [-80.0, -45.0, 0.0, 30.0, 89.0]:
        quat = q.quat_from_axis_angle(deg, [1.0, 0.0, 0.0])
        assert q.quat_extract_euler_x(quat) == pytest.approx(deg, abs=1e-3)


def test_euler_angles_compose_zyx():
    # z * (y * x) composition order (zalgebra fromEulerAngles)
    qx = q.quat_from_axis_angle(10.0, [1.0, 0.0, 0.0])
    qy = q.quat_from_axis_angle(20.0, [0.0, 1.0, 0.0])
    qz = q.quat_from_axis_angle(30.0, [0.0, 0.0, 1.0])
    expect = q.quat_mul(qz, q.quat_mul(qy, qx))
    got = q.quat_from_euler_angles(10.0, 20.0, 30.0)
    np.testing.assert_allclose(got, expect, atol=1e-6)
