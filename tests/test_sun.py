import numpy as np

from zig_vulkan_jax.config import SunConfig
from zig_vulkan_jax.core.sun import Sun


def test_initial_state_matches_config():
    sun = Sun(SunConfig())
    np.testing.assert_allclose(sun.device_data.position, [0, -1000, 0])
    np.testing.assert_allclose(sun.device_data.color, [1.0, 1.1, 1.0])
    assert sun.device_data.enabled
    assert sun.device_data.radius == np.float32(5.0)


def test_update_at_t0_sets_phase0_color():
    sun = Sun(SunConfig())
    sun.update(0.0)
    # slerp_pos = 0 -> exactly phase 0 values
    np.testing.assert_allclose(sun.device_data.color, [1.0, 0.99, 0.823], atol=1e-6)
    np.testing.assert_allclose(sun.device_data.position, [0, -1000, 0], atol=1e-3)


def test_update_advances_and_wraps():
    sun = Sun(SunConfig(animate_speed=0.6))
    for _ in range(2):
        sun.update(1.0)  # 0.6 then 1.2 -> wrap to 0.2, index 1
    assert sun.slerp_index == 1
    assert 0.19 < float(sun.slerp_pos) < 0.21


def test_position_distance_preserved():
    sun = Sun(SunConfig())
    for _ in range(50):
        sun.update(0.1)
        dist = np.linalg.norm(sun.device_data.position)
        assert abs(dist - 1000.0) < 1.0


def test_disabled_sun_does_not_animate():
    sun = Sun(SunConfig(enabled=False))
    before = sun.device_data.position.copy()
    sun.update(1.0)
    np.testing.assert_array_equal(sun.device_data.position, before)


def test_colors_stay_in_lerp_hull():
    sun = Sun(SunConfig())
    for _ in range(200):
        sun.update(0.05)
        c = sun.device_data.color
        assert np.all(c >= 0.0) and np.all(c <= 1.1)
