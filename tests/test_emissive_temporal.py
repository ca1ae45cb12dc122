"""Superset features: emissive voxels + temporal accumulation (BASELINE config 4)."""

import numpy as np

from zig_vulkan_jax.config import (
    CameraConfig, DenoiserConfig, EngineConfig, SunConfig, TraceConfig)
from zig_vulkan_jax.core.materials import MAT_EMISSIVE
from zig_vulkan_jax.engine.engine import VoxelRT
from zig_vulkan_jax.models.scenes import flat_test_scene
from zig_vulkan_jax.oracle import cpu_tracer as oracle
from zig_vulkan_jax.core.camera import Camera
from zig_vulkan_jax.core.sun import Sun
from zig_vulkan_jax.ops import trace


def emissive_scene():
    sc = flat_test_scene(dim=8)
    sc.materials.set(20, MAT_EMISSIVE, (1.0, 0.8, 0.2), 5.0)
    # floating emissive block in open air (world ~x 2.5-3.5, y 1.7-2.8, z 6-7)
    xs, ys, zs = np.meshgrid(np.arange(10, 14), np.arange(20, 24),
                             np.arange(24, 28), indexing="ij")
    sc.grid.insert_batch(xs.ravel(), ys.ravel(), zs.ravel(),
                         np.full(xs.size, 20, dtype=np.uint8))
    return sc


def test_emissive_glows_and_matches_oracle():
    sc = emissive_scene()
    cam = Camera(75.0, 32, 32, CameraConfig(origin=(4.0, 4.5, 15.0),
                                            samples_per_pixel=1, max_bounce=1))
    sun = Sun(SunConfig(enabled=False))
    osc = oracle.OracleScene(sc.grid.static, sc.grid.arrays, sc.materials)
    img_o = oracle.render(osc, cam.d_camera, sun.device_data)
    arrays = sc.grid.device_arrays()
    mats = trace.materials_to_device(sc.materials)
    img_j = np.asarray(trace.render_image(
        sc.grid.static, arrays, mats, cam.d_camera,
        sun.device_data.position, sun.device_data.color,
        sun.device_data.radius, False))
    diff = np.abs(img_j - img_o).max(axis=-1)
    assert (diff > 1e-3).mean() < 0.01
    # emissive pixels are much brighter than plain albedo could be:
    # tone-mapped 5.0*1.0/(1+5.0)=0.833 -> sqrt ~ 0.91
    assert img_j[..., 0].max() > 0.9


def test_temporal_accumulation_converges():
    sc = emissive_scene()
    cfg = EngineConfig(
        internal_resolution_width=32, internal_resolution_height=24,
        camera=CameraConfig(origin=(4.0, 4.5, 15.0), samples_per_pixel=1,
                            max_bounce=2),
        sun=SunConfig(enabled=False, animate=False),
        denoiser=DenoiserConfig(enabled=False),
        trace=TraceConfig(max_steps=256))
    rt = VoxelRT(sc.grid, sc.materials, cfg)
    rt.set_temporal(True)

    frames = [np.asarray(rt.render()) for _ in range(6)]
    assert rt._accum_count == 6
    # successive accumulated frames change less and less
    d01 = np.abs(frames[1] - frames[0]).mean()
    d45 = np.abs(frames[5] - frames[4]).mean()
    assert d45 <= d01
    # camera move resets accumulation
    rt.camera.translate(0.1, [1.0, 0.0, 0.0])
    rt.render()
    assert rt._accum_count == 1


def test_temporal_off_is_deterministic():
    sc = emissive_scene()
    cfg = EngineConfig(
        internal_resolution_width=16, internal_resolution_height=16,
        camera=CameraConfig(origin=(4.0, 4.5, 15.0), samples_per_pixel=1,
                            max_bounce=1),
        sun=SunConfig(enabled=False, animate=False),
        denoiser=DenoiserConfig(enabled=False))
    rt = VoxelRT(sc.grid, sc.materials, cfg)
    a = np.asarray(rt.render())
    b = np.asarray(rt.render())
    np.testing.assert_array_equal(a, b)
