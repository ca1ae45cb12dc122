"""Validation checks + streamed scene construction."""

import numpy as np
import pytest

from zig_vulkan_jax.config import (
    CameraConfig, DenoiserConfig, EngineConfig, GridConfig, SunConfig)
from zig_vulkan_jax.core.grid import BrickGrid, dense_materials
from zig_vulkan_jax.engine.engine import VoxelRT
from zig_vulkan_jax.io import streaming, terrain
from zig_vulkan_jax.models.scenes import flat_test_scene
from zig_vulkan_jax.utils import validation


def test_validate_scene_accepts_good_scene():
    sc = flat_test_scene(dim=8)
    validation.validate_scene(sc.grid.static, sc.grid.arrays)


def test_validate_scene_catches_corruption():
    sc = flat_test_scene(dim=8)
    a = sc.grid.arrays
    a.start_indices[0] = np.uint32(7)  # unaligned window
    with pytest.raises(validation.SceneValidationError):
        validation.validate_scene(sc.grid.static, a)


def test_check_image():
    validation.check_image(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(validation.SceneValidationError):
        validation.check_image(np.full((4, 4, 3), np.nan, np.float32))


def test_streamed_terrain_matches_batch_build():
    ref = BrickGrid(8, 4, 8, GridConfig())
    terrain.generate(ref, seed=5, scale=4.0, ocean_level=4)

    sc = flat_test_scene(dim=8)
    empty = BrickGrid(8, 4, 8, GridConfig())
    cfg = EngineConfig(
        internal_resolution_width=16, internal_resolution_height=16,
        camera=CameraConfig(origin=(4.0, 6.5, 15.0), samples_per_pixel=1,
                            max_bounce=0),
        sun=SunConfig(enabled=False), denoiser=DenoiserConfig(enabled=False))
    rt = VoxelRT(empty, sc.materials, cfg)

    regions = streaming.terrain_regions(empty, seed=5, scale=4.0, ocean_level=4,
                                        region_x=8)
    total = streaming.stream_into_engine(rt, regions, draw_between=True,
                                         max_batch=1024)
    assert total > 0

    # pull device arrays back and compare scene semantics with the batch build
    from zig_vulkan_jax.core.grid import GridArrays

    got = GridArrays(
        statuses=np.asarray(rt.arrays.statuses),
        indices=np.asarray(rt.arrays.indices),
        occupancy=np.asarray(rt.arrays.occupancy),
        start_indices=np.asarray(rt.arrays.start_indices),
        material_indices=np.asarray(rt.arrays.material_indices),
        active_bricks=np.uint32(rt.arrays.active_bricks),
        material_cursor=np.uint32(rt.arrays.material_cursor),
        diel_mask=np.asarray(rt.arrays.diel_mask),
        brick_ir=np.asarray(rt.arrays.brick_ir),
    )
    np.testing.assert_array_equal(
        dense_materials(ref.static, got), dense_materials(ref.static, ref.arrays))
    validation.validate_scene(ref.static, got)
