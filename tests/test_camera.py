import numpy as np
import pytest

from zig_vulkan_jax.config import CameraConfig
from zig_vulkan_jax.core.camera import Camera


def make_camera(**kw):
    return Camera(75.0, 1024, 576, CameraConfig(**kw))


def test_init_viewport_and_basis():
    cam = make_camera()
    # viewport_height = 2 * tan(75deg / 2)
    expect_vh = 2.0 * np.tan(np.deg2rad(75.0) * 0.5)
    assert cam.viewport_height == pytest.approx(expect_vh, rel=1e-6)
    assert cam.viewport_width == pytest.approx(expect_vh * 1024.0 / 576.0, rel=1e-6)
    d = cam.d_camera
    np.testing.assert_allclose(d.horizontal, [cam.viewport_width, 0, 0], atol=1e-6)
    np.testing.assert_allclose(d.vertical, [0, cam.viewport_height, 0], atol=1e-6)
    # lower_left = origin - h/2 - v/2 - forward(0,0,1)
    np.testing.assert_allclose(
        d.lower_left_corner,
        [-cam.viewport_width / 2, -cam.viewport_height / 2, -1.0],
        atol=1e-6,
    )


def test_max_bounce_plus_one_rule():
    # user-facing max_bounce=0 means primary rays only (Camera.zig:74)
    cam = make_camera(max_bounce=0)
    assert cam.d_camera.max_bounce == 1
    cam = make_camera(max_bounce=2)
    assert cam.d_camera.max_bounce == 3


def test_translate_moves_along_basis():
    cam = make_camera()
    cam.translate(1.0, [0.0, 0.0, 1.0])
    np.testing.assert_allclose(cam.d_camera.origin, [0, 0, 1], atol=1e-6)
    # zero vector is a no-op (NaN guard, Camera.zig:117-119)
    cam.translate(1.0, [0.0, 0.0, 0.0])
    np.testing.assert_allclose(cam.d_camera.origin, [0, 0, 1], atol=1e-6)


def test_translate_respects_speed_and_sprint():
    cam = make_camera(normal_speed=2.0, sprint_speed=3.0)
    cam.activate_sprint()
    cam.translate(0.5, [1.0, 0.0, 0.0])
    np.testing.assert_allclose(cam.d_camera.origin, [3.0, 0, 0], atol=1e-5)
    cam.disable_sprint()
    cam.translate(0.5, [1.0, 0.0, 0.0])
    np.testing.assert_allclose(cam.d_camera.origin, [4.0, 0, 0], atol=1e-5)


def test_yaw_rotates_forward():
    cam = make_camera(turn_rate=1.0)
    # turn_yaw applies half-angle directly: quat (cos(a), 0, sin(a), 0)
    # rotates by 2a about y. pi/4 half-angle = 90 degrees yaw.
    cam.turn_yaw(np.pi / 4)
    fwd = cam.forward_dir()
    np.testing.assert_allclose(fwd, [1.0, 0.0, 0.0], atol=1e-5)


def test_pitch_clamp_at_90():
    cam = make_camera(turn_rate=1.0)
    # two 60-degree pitches: second should be reverted by the clamp
    cam.turn_pitch(np.pi / 6)  # 60 degrees
    fwd1 = cam.forward_dir().copy()
    cam.turn_pitch(np.pi / 6)  # would be 120 degrees -> reverted
    fwd2 = cam.forward_dir()
    np.testing.assert_allclose(fwd1, fwd2, atol=1e-5)


def test_input_disable_blocks_motion():
    cam = make_camera()
    cam.disable_input()
    cam.translate(1.0, [1.0, 0.0, 0.0])
    cam.turn_yaw(1.0)
    cam.turn_pitch(1.0)
    np.testing.assert_allclose(cam.d_camera.origin, [0, 0, 0])
    np.testing.assert_allclose(cam.forward_dir(), [0, 0, 1], atol=1e-6)
    cam.reset()
    cam.translate(1.0, [1.0, 0.0, 0.0])
    assert cam.d_camera.origin[0] != 0


def test_lower_left_tracks_origin_and_orientation():
    cam = make_camera()
    cam.set_origin([5.0, -2.0, 3.0])
    d = cam.d_camera
    expect = (
        np.array([5.0, -2.0, 3.0], dtype=np.float32)
        - d.horizontal * 0.5
        - d.vertical * 0.5
        - cam.forward_dir()
    )
    np.testing.assert_allclose(d.lower_left_corner, expect, atol=1e-6)
