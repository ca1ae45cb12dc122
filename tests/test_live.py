"""Live terminal viewer: ANSI framebuffer painting + synthesized input."""

import io

import numpy as np

from zig_vulkan_jax.app.live import HOLD_S, LiveViewer, frame_to_ansi
from zig_vulkan_jax.app.input import Key


def test_frame_to_ansi_shapes_and_escapes():
    img = np.zeros((32, 48, 3), dtype=np.float32)
    img[:16] = [1.0, 0.0, 0.0]   # top half red
    s = frame_to_ansi(img, max_cols=24, max_rows=8)
    lines = s.split("\n")
    assert len(lines) == 8
    assert "\x1b[38;2;255;0;0m" in lines[0]      # red top half
    assert "\x1b[38;2;0;0;0m" in lines[-1]       # black bottom half
    assert "\x1b[48;2;0;0;0m" in lines[-1]
    assert lines[0].endswith("\x1b[0m")
    assert lines[0].count("▀") == 24


def test_frame_to_ansi_small_image():
    img = np.ones((4, 4, 3), dtype=np.float32) * 0.5
    s = frame_to_ansi(img, max_cols=80, max_rows=40)
    assert s.count("\n") == 1  # 4 rows -> 2 half-block lines


def _viewer():
    from tests.test_engine import small_engine

    rt = small_engine()
    return LiveViewer(rt, out=io.StringIO(), max_cols=16, max_rows=8)


def test_viewer_key_hold_and_release():
    v = _viewer()
    assert v.feed([("char", "w")], now=0.0)
    assert Key.W in v._held
    assert v.inp.held(Key.W) if hasattr(v.inp, "held") else True
    v.expire_holds(now=HOLD_S + 0.01)
    assert Key.W not in v._held
    # sprint: uppercase holds shift too
    v.feed([("char", "W")], now=1.0)
    assert Key.LEFT_SHIFT in v._held and Key.W in v._held
    # q quits
    assert not v.feed([("char", "q")], now=1.1)


def test_viewer_arrows_move_cursor_and_tuners():
    v = _viewer()
    cam = v.rt.camera
    yaw0 = np.array(cam.yaw, copy=True)
    # the reference swallows the first cursor moves (5-frame mouse-ignore,
    # main.zig:294-310) — send enough arrow events to get past it
    for i in range(7):
        v.feed([("arrow", "C")], now=0.0)
        v.inp.apply_to_camera(cam, 0.016)
    assert np.any(np.asarray(cam.yaw) != yaw0)
    spp0 = int(cam.d_camera.samples_per_pixel)
    v.feed([("char", "2")], now=0.1)
    assert int(cam.d_camera.samples_per_pixel) == spp0 + 1


def test_viewer_renders_frames_headless():
    v = _viewer()
    n = v.run(max_frames=2)
    assert n == 2
    painted = v.out.getvalue()
    assert "▀" in painted and "Mray/s" in painted


def test_parse_sgr_mouse():
    from zig_vulkan_jax.app.live import parse_sgr_mouse

    assert parse_sgr_mouse("35;10;22M") == ("mouse", (10.0, 22.0))
    assert parse_sgr_mouse("0;1;1m") == ("mouse", (1.0, 1.0))
    assert parse_sgr_mouse("") is None
    assert parse_sgr_mouse("35;10M") is None
    assert parse_sgr_mouse("a;b;cM") is None


def test_mouse_events_drive_camera_look():
    """Real mouse motion (SGR cursor positions) turns the camera exactly
    like the reference's cursorPosCallback path (main.zig:294-310)."""
    import numpy as np

    from zig_vulkan_jax.app.live import MOUSE_CELL_PIXELS

    v = _viewer()
    v.inp.mouse_ignore_frames = 0
    basis0 = np.asarray(v.rt.camera.d_camera.horizontal).copy()
    v.feed([("mouse", (10.0, 20.0))], now=0.0)
    v.feed([("mouse", (14.0, 20.0))], now=0.0)  # 4 cells right
    assert v.inp.call_yaw
    assert v.inp.mouse_delta[0] == 4.0 * MOUSE_CELL_PIXELS
    v.inp.apply_to_camera(v.rt.camera, 0.016)
    basis1 = np.asarray(v.rt.camera.d_camera.horizontal)
    assert not np.allclose(basis0, basis1), "yaw must rotate the basis"


def test_cursor_shape_and_visibility_follow_menu_mode():
    """The 9-shape cursor analog (Input.zig:245-276): hidden/captured in
    game mode, shown with the GUI-selected shape in menu mode."""
    from zig_vulkan_jax.app.input import CursorShape

    v = _viewer()
    assert len(CursorShape) == 9
    v.inp.apply_to_camera(v.rt.camera, 0.016)
    assert not v.inp.cursor_visible
    v.feed([("esc", None)], now=0.0)  # -> menu mode
    v.inp.set_cursor_shape(CursorShape.HAND)
    v.inp.apply_to_camera(v.rt.camera, 0.016)
    assert v.inp.cursor_visible
    assert v.inp.cursor_shape is CursorShape.HAND
    v.feed([("esc", None)], now=0.0)  # back to game mode
    v.inp.apply_to_camera(v.rt.camera, 0.016)
    assert not v.inp.cursor_visible
