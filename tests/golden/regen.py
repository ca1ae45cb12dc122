"""Regenerate the golden fixtures (checked in per round-2 verdict item 8).

Run from the repo root on the CPU backend:

    JAX_PLATFORMS=cpu python tests/golden/regen.py

Every fixture is produced by the NUMPY ORACLE (deterministic across
machines/backends; the oracle is the reference-semantics ground truth,
oracle/cpu_tracer.py) except the denoiser fixture, which is produced by
the numpy transliteration of image.frag used in tests/test_denoise.py.
Regenerate ONLY when semantics intentionally change, and say why in the
commit message.
"""

from __future__ import annotations

import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(os.path.dirname(_HERE))
sys.path.insert(0, _REPO)

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

# force the CPU at the config level too, so fixture generation is
# hermetic and CPU-deterministic
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def regen_flat_scene() -> None:
    """The round-1 fixture: toy flat scene, primary + path/sun renders."""
    from tests.test_golden import scene
    from zig_vulkan_jax.config import CameraConfig, SunConfig
    from zig_vulkan_jax.core.camera import Camera
    from zig_vulkan_jax.core.sun import Sun
    from zig_vulkan_jax.oracle import cpu_tracer as oracle

    sc = scene()
    osc = oracle.OracleScene(sc.grid.static, sc.grid.arrays, sc.materials)
    cam = Camera(75.0, 48, 48, CameraConfig(origin=(4.0, 6.5, 15.0),
                                            samples_per_pixel=1, max_bounce=0))
    sun = Sun(SunConfig(enabled=False))
    primary = oracle.render(osc, cam.d_camera, sun.device_data)
    cam2 = Camera(75.0, 48, 48, CameraConfig(origin=(4.0, 6.5, 15.0),
                                             samples_per_pixel=2, max_bounce=2))
    sun2 = Sun(SunConfig(enabled=True))
    path_sun = oracle.render(osc, cam2.d_camera, sun2.device_data)
    np.savez_compressed(os.path.join(_HERE, "flat_scene_renders.npz"),
                        primary=primary, path_sun=path_sun)
    print("flat_scene_renders.npz", primary.shape, path_sun.shape)


def regen_default_scene() -> None:
    """The DEFAULT 512x256x512 workload scene (main.zig:77-120), rendered
    by the oracle at a subsampled 96x54 view of the default camera pose
    (full-resolution oracle rendering of 590k pixels is prohibitive; the
    96x54 grid samples the same scene content deterministically)."""
    from zig_vulkan_jax.config import CameraConfig, SunConfig
    from zig_vulkan_jax.core.camera import Camera
    from zig_vulkan_jax.core.sun import Sun
    from zig_vulkan_jax.models.scenes import default_scene
    from zig_vulkan_jax.oracle import cpu_tracer as oracle

    sc = default_scene()
    osc = oracle.OracleScene(sc.grid.static, sc.grid.arrays, sc.materials)
    cam = Camera(75.0, 96, 54, CameraConfig(origin=(0.0, 0.0, 0.0),
                                            samples_per_pixel=1, max_bounce=0))
    sun = Sun(SunConfig(enabled=True))
    primary_sun = oracle.render(osc, cam.d_camera, sun.device_data)
    np.savez_compressed(os.path.join(_HERE, "default_scene_render.npz"),
                        primary_sun=primary_sun)
    print("default_scene_render.npz", primary_sun.shape)


def regen_vox_asset() -> None:
    """A REAL reference .vox asset (doom.vox) parsed by io.vox and rendered
    by the oracle — guards the loader + palette-material derivation +
    insert path end-to-end against the actual asset bytes."""
    vox_path = "/root/reference/assets/models/doom.vox"
    if not os.path.exists(vox_path):
        print("doom.vox not available; skipping", file=sys.stderr)
        return
    from zig_vulkan_jax.config import CameraConfig, GridConfig, SunConfig
    from zig_vulkan_jax.core.camera import Camera
    from zig_vulkan_jax.core.grid import BrickGrid
    from zig_vulkan_jax.core.materials import (fill_from_vox_palette,
                                               terrain_materials)
    from zig_vulkan_jax.core.sun import Sun
    from zig_vulkan_jax.models.scenes import insert_vox_model
    from zig_vulkan_jax.io import vox as vox_mod
    from zig_vulkan_jax.oracle import cpu_tracer as oracle

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
    img = oracle.render(osc, cam.d_camera, sun.device_data)
    np.savez_compressed(os.path.join(_HERE, "doom_vox_render.npz"),
                        primary=img)
    print("doom_vox_render.npz", img.shape, "nonbg:",
          float((img.std(axis=-1) > 0).mean()))


def regen_denoiser() -> None:
    """Denoiser (image.frag sirBird filter) input/output pair via the
    numpy transliteration oracle in tests/test_denoise.py."""
    from tests.test_denoise import _np_sirbird

    rng = np.random.default_rng(12345)
    img = rng.random((40, 40, 3), dtype=np.float32)
    out = _np_sirbird(img, samples=20, distribution_bias=0.6,
                      pixel_multiplier=1.5, inverse_hue_tolerance=20.0)
    np.savez_compressed(os.path.join(_HERE, "denoiser_golden.npz"),
                        input=img, output=out)
    print("denoiser_golden.npz", out.shape)


if __name__ == "__main__":
    which = sys.argv[1:] or ["flat", "default", "vox", "denoiser"]
    if "flat" in which:
        regen_flat_scene()
    if "default" in which:
        regen_default_scene()
    if "vox" in which:
        regen_vox_asset()
    if "denoiser" in which:
        regen_denoiser()
