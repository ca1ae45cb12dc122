"""Golden-image regression tests (SURVEY.md §4 test plan item (c)).

Goldens were produced by the numpy oracle (deterministic across
environments); both the oracle and the JAX tracer must keep reproducing
them. Regenerate with the snippet in the git history if semantics
intentionally change.
"""

import os

import numpy as np

from zig_vulkan_jax.config import CameraConfig, SunConfig
from zig_vulkan_jax.core.camera import Camera
from zig_vulkan_jax.core.sun import Sun
from zig_vulkan_jax.models.scenes import flat_test_scene
from zig_vulkan_jax.oracle import cpu_tracer as oracle
from zig_vulkan_jax.ops import trace

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "flat_scene_renders.npz")


def scene():
    sc = flat_test_scene(dim=8)
    xs, zs = np.meshgrid(np.arange(6, 16), np.arange(6, 16), indexing="ij")
    sc.grid.insert_batch(xs.ravel(), np.full(xs.size, 4), zs.ravel(),
                         np.zeros(xs.size, dtype=np.uint8))
    ys = np.arange(4, 12)
    sc.grid.insert_batch(np.full(ys.size, 20), ys, np.full(ys.size, 20),
                         np.full(ys.size, 7, dtype=np.uint8))
    return sc


def _golden(name):
    return os.path.join(os.path.dirname(__file__), "golden", name)


def test_default_scene_golden():
    """The DEFAULT 512x256x512 workload scene at a 96x54 subsampled view
    (round-2 verdict item 8: one toy fixture guarded all semantics).
    Guards terrain gen + model insert + materials + tracer end-to-end.
    The scene build is the expensive part (~80 s); cached via the shared
    bench cache."""
    import pytest

    g = np.load(_golden("default_scene_render.npz"))
    from zig_vulkan_jax.models.scenes import cached_default_scene

    cache = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".bench_scene_cache.npz")
    sc = cached_default_scene(cache)
    arrays = sc.grid.device_arrays()
    mats = trace.materials_to_device(sc.materials)
    cam = Camera(75.0, 96, 54, CameraConfig(origin=(0.0, 0.0, 0.0),
                                            samples_per_pixel=1, max_bounce=0))
    sun = Sun(SunConfig(enabled=True))
    img = np.asarray(trace.render_image(
        sc.grid.static, arrays, mats, cam.d_camera,
        sun.device_data.position, sun.device_data.color,
        sun.device_data.radius, True))
    ref = g["primary_sun"]
    assert img.shape == ref.shape
    # tracer vs oracle-produced golden: grazing-ray skip flips only
    diff = np.abs(img - ref).max(axis=-1)
    assert (diff > 1e-3).mean() < 0.01, float((diff > 1e-3).mean())


def test_doom_vox_asset_golden():
    """A REAL reference asset (doom.vox) parsed + rendered; guards the
    loader, palette-material derivation, and insert path against actual
    MagicaVoxel bytes."""
    import pytest

    vox_path = "/root/reference/assets/models/doom.vox"
    if not os.path.exists(vox_path):
        pytest.skip("reference assets not mounted")
    from zig_vulkan_jax.config import GridConfig
    from zig_vulkan_jax.core.grid import BrickGrid
    from zig_vulkan_jax.core.materials import (fill_from_vox_palette,
                                               terrain_materials)
    from zig_vulkan_jax.io import vox as vox_mod
    from zig_vulkan_jax.models.scenes import insert_vox_model

    g = np.load(_golden("doom_vox_render.npz"))
    model = vox_mod.load(vox_path)
    grid = BrickGrid(24, 24, 24, GridConfig(min_point=(0.0, 0.0, 0.0),
                                            scale=1.0))
    materials = terrain_materials()
    fill_from_vox_palette(materials, model.palette)
    grid.attach_materials(materials)
    insert_vox_model(grid, model, offset=(10, 10, 10))
    osc = oracle.OracleScene(grid.static, grid.arrays, materials)
    cam = Camera(75.0, 64, 64, CameraConfig(origin=(48.0, 40.0, 120.0),
                                            samples_per_pixel=1, max_bounce=0))
    sun = Sun(SunConfig(enabled=False))
    # oracle bit-stable on the asset
    np.testing.assert_array_equal(
        oracle.render(osc, cam.d_camera, sun.device_data), g["primary"])
    # tracer matches
    img = np.asarray(trace.render_image(
        grid.static, grid.device_arrays(),
        trace.materials_to_device(materials), cam.d_camera,
        sun.device_data.position, sun.device_data.color,
        sun.device_data.radius, False))
    diff = np.abs(img - g["primary"]).max(axis=-1)
    assert (diff > 1e-3).mean() < 0.01, float((diff > 1e-3).mean())


def test_denoiser_golden():
    """Denoiser (image.frag sirBird) output pinned against the numpy
    transliteration on a fixed input."""
    from zig_vulkan_jax.ops import denoise as denoise_mod

    g = np.load(_golden("denoiser_golden.npz"))
    out = np.asarray(denoise_mod.denoise(
        g["input"], samples=20, distribution_bias=0.6,
        pixel_multiplier=1.5, inverse_hue_tolerance=20.0))
    np.testing.assert_allclose(out, g["output"], atol=2e-5)


def test_goldens_reproduced():
    g = np.load(GOLDEN)
    sc = scene()
    osc = oracle.OracleScene(sc.grid.static, sc.grid.arrays, sc.materials)
    arrays = sc.grid.device_arrays()
    mats = trace.materials_to_device(sc.materials)

    cam = Camera(75.0, 48, 48, CameraConfig(origin=(4.0, 6.5, 15.0),
                                            samples_per_pixel=1, max_bounce=0))
    sun = Sun(SunConfig(enabled=False))
    # oracle must be bit-stable
    np.testing.assert_array_equal(
        oracle.render(osc, cam.d_camera, sun.device_data), g["primary"])
    # tracer pixel-exact on primary rays
    img = np.asarray(trace.render_image(
        sc.grid.static, arrays, mats, cam.d_camera,
        sun.device_data.position, sun.device_data.color,
        sun.device_data.radius, False))
    np.testing.assert_allclose(img, g["primary"], atol=1e-5)

    cam2 = Camera(75.0, 48, 48, CameraConfig(origin=(4.0, 6.5, 15.0),
                                             samples_per_pixel=2, max_bounce=2))
    sun2 = Sun(SunConfig(enabled=True))
    np.testing.assert_array_equal(
        oracle.render(osc, cam2.d_camera, sun2.device_data), g["path_sun"])
    img2 = np.asarray(trace.render_image(
        sc.grid.static, arrays, mats, cam2.d_camera,
        sun2.device_data.position, sun2.device_data.color,
        sun2.device_data.radius, True))
    diff = np.abs(img2 - g["path_sun"]).max(axis=-1)
    assert (diff > 1e-3).mean() < 0.01
