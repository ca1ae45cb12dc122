"""App runner + input system tests."""

import numpy as np

from zig_vulkan_jax.app.input import Action, Input, Key
from zig_vulkan_jax.config import CameraConfig
from zig_vulkan_jax.core.camera import Camera
from zig_vulkan_jax.io import image as img_io


def test_input_bindings_translate_camera():
    cam = Camera(75.0, 64, 64, CameraConfig())
    inp = Input()
    inp.key_event(Key.W, Action.PRESS)
    inp.apply_to_camera(cam, 1.0)
    # W = forward = camera z - 1 -> world -z... camera forward is +z axis
    # rotated; origin moves along -forward direction
    np.testing.assert_allclose(cam.d_camera.origin, [0, 0, -1], atol=1e-6)
    inp.key_event(Key.W, Action.RELEASE)
    inp.key_event(Key.SPACE, Action.PRESS)
    inp.apply_to_camera(cam, 1.0)
    np.testing.assert_allclose(cam.d_camera.origin, [0, -1, -1], atol=1e-6)


def test_sprint_doubles_speed():
    cam = Camera(75.0, 64, 64, CameraConfig(normal_speed=1.0, sprint_speed=2.0))
    inp = Input()
    inp.key_event(Key.LEFT_SHIFT, Action.PRESS)
    inp.key_event(Key.D, Action.PRESS)
    inp.apply_to_camera(cam, 1.0)
    np.testing.assert_allclose(cam.d_camera.origin, [2, 0, 0], atol=1e-6)


def test_mouse_ignore_frames_and_yaw():
    cam = Camera(75.0, 64, 64, CameraConfig(turn_rate=1.0))
    inp = Input()
    # first 5 cursor events are swallowed (main.zig:294-310)
    for i in range(5):
        inp.cursor_event(float(i), 0.0)
    assert not inp.call_yaw
    inp.cursor_event(10.0, 0.0)
    inp.cursor_event(20.0, 0.0)
    assert inp.call_yaw
    fwd_before = cam.forward_dir().copy()
    inp.apply_to_camera(cam, 0.1)
    assert not np.allclose(cam.forward_dir(), fwd_before)


def test_escape_toggles_menu_mode():
    inp = Input()
    inp.key_event(Key.ESCAPE, Action.PRESS)
    cam = Camera(75.0, 64, 64, CameraConfig())
    inp.apply_to_camera(cam, 0.1)   # switches handlers to menu mode
    assert inp.menu_mode
    inp.key_event(Key.ESCAPE, Action.PRESS)  # menu handler: back to game
    assert not inp.menu_mode
    assert inp.mouse_ignore_frames == 5


def test_png_ppm_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(8, 12, 3)).astype(np.float32)
    p = str(tmp_path / "t.ppm")
    img_io.write_ppm(p, img)
    back = img_io.read_ppm(p)
    np.testing.assert_array_equal(back, img_io.to_uint8(img))
    img_io.write_png(str(tmp_path / "t.png"), img)
    assert (tmp_path / "t.png").stat().st_size > 100


def test_app_main_headless(tmp_path):
    from zig_vulkan_jax.app import run

    rc = run.main([
        "--width", "16", "--height", "16", "--grid", "4", "2", "4",
        "--no-terrain", "--frames", "3", "--script", "demo",
        "--no-denoise", "--spp", "1", "--bounces", "0",
        "--out", str(tmp_path)])
    assert rc == 0
    assert (tmp_path / "frame_0002.png").exists()


def test_app_benchmark_mode(capsys):
    from zig_vulkan_jax.app import run

    rc = run.main([
        "--width", "16", "--height", "16", "--grid", "4", "2", "4",
        "--no-terrain", "--no-denoise", "--spp", "1", "--bounces", "0",
        "--benchmark", "--benchmark-duration", "0.05", "--frames", "3"])
    assert rc == 0
    assert "BENCHMARK REPORT" in capsys.readouterr().out


def test_profiling_zones_and_frame_mark():
    from zig_vulkan_jax.utils import profiling

    events = []
    profiling.set_log_fn(lambda name, dt, extra="": events.append(name))
    profiling.enable(True)
    try:
        with profiling.zone("draw"):
            pass
        profiling.frame_mark()
    finally:
        profiling.enable(False)
        profiling.set_log_fn(None)
    assert "draw" in events and "frame" in events
