"""Control panel (ImguiGui analog) tests."""

import numpy as np

from zig_vulkan_jax.config import (
    CameraConfig, DenoiserConfig, EngineConfig, SunConfig)
from zig_vulkan_jax.engine.controls import ControlPanel
from zig_vulkan_jax.engine.engine import VoxelRT
from zig_vulkan_jax.models.scenes import flat_test_scene


def panel():
    sc = flat_test_scene(dim=8)
    cfg = EngineConfig(
        internal_resolution_width=16, internal_resolution_height=16,
        camera=CameraConfig(origin=(4.0, 6.5, 15.0), samples_per_pixel=1,
                            max_bounce=0),
        sun=SunConfig(enabled=False),
        denoiser=DenoiserConfig(enabled=False))
    return ControlPanel(VoxelRT(sc.grid, sc.materials, cfg))


def test_sliders_clamp_to_reference_ranges():
    p = panel()
    p.set_max_bounce(100)
    assert p.engine.camera.d_camera.max_bounce == 32
    p.set_max_bounce(0)
    assert p.engine.camera.d_camera.max_bounce == 1
    p.set_samples_per_pixel(64)
    assert p.engine.camera.d_camera.samples_per_pixel == 32
    assert p.engine.metrics.rays_per_frame == 16 * 16 * 32


def test_sun_and_denoiser_knobs():
    p = panel()
    p.set_sun_enabled(True)
    p.set_sun_radius(2.5)
    p.set_sun_color([1.0, 0.5, 0.25])
    p.set_denoiser(samples=8, distribution_bias=0.4)
    assert p.engine.sun.device_data.enabled
    assert float(p.engine.sun.device_data.radius) == 2.5
    assert p.engine.denoiser.samples == 8
    np.testing.assert_allclose(p.engine.sun.device_data.color, [1.0, 0.5, 0.25])


def test_benchmark_button_resets_sun_and_completes(capsys):
    p = panel()
    p.engine.sun.slerp_pos = np.float32(0.7)
    bench = p.start_benchmark(duration=0.1)
    assert float(p.engine.sun.slerp_pos) == 0.0
    assert p.engine.camera.user_input_disabled
    # drive frames until done
    for _ in range(5):
        p.new_frame(0.05)
    assert p.active_benchmark is None
    assert not p.engine.camera.user_input_disabled
    out = capsys.readouterr().out
    assert "BENCHMARK REPORT" in out
    assert bench.report.delta_time_sum_samples >= 2


def test_metrics_text_sparkline():
    p = panel()
    p.engine.draw(0.016)
    p.engine.draw(0.017)
    text = p.metrics_text()
    assert "frame ms" in text and "[" in text
    assert "16x16" in text
