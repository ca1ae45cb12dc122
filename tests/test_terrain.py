import numpy as np

from zig_vulkan_jax.config import GridConfig
from zig_vulkan_jax.core.grid import BrickGrid
from zig_vulkan_jax.io import terrain


def test_perlin_smooth_noise_range_and_continuity():
    p = terrain.PerlinNoise(42)
    pts = np.random.default_rng(0).uniform(0, 4, size=(1000, 3))
    vals = p.smooth_noise(pts)
    assert vals.min() >= 0.0 and vals.max() <= 1.0
    # continuity: tiny perturbation -> tiny change
    eps = pts + 1e-5
    assert np.abs(p.smooth_noise(eps) - vals).max() < 1e-3


def test_perlin_deterministic_per_seed():
    pts = np.random.default_rng(1).uniform(0, 4, size=(100, 3))
    a = terrain.PerlinNoise(7).smooth_noise(pts)
    b = terrain.PerlinNoise(7).smooth_noise(pts)
    c = terrain.PerlinNoise(8).smooth_noise(pts)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 0


def test_generate_fills_grid_with_expected_structure():
    grid = BrickGrid(8, 4, 8, GridConfig(scale=1.0))
    terrain.generate(grid, seed=420, scale=4.0, ocean_level=4)
    vx, vy, vz = grid.static.voxel_dims
    assert int(grid.arrays.active_bricks) > 0

    # every column must be solid-or-water up to at least the ocean level
    # in the band [height/2, max(height, ocean)); sample a few columns
    mats = set()
    for x in range(0, vx, 5):
        for z in range(0, vz, 5):
            col = [grid.voxel_material(x, y, z) for y in range(vy)]
            present = [m for m in col if m is not None]
            mats.update(present)
    # water (0) plus at least one terrain band material
    assert 0 in mats
    assert any(m in (1, 2, 3, 4, 5, 6) for m in mats)


def test_generate_deterministic():
    g1 = BrickGrid(4, 4, 4, GridConfig())
    g2 = BrickGrid(4, 4, 4, GridConfig())
    terrain.generate(g1, seed=9, scale=4.0, ocean_level=3)
    terrain.generate(g2, seed=9, scale=4.0, ocean_level=3)
    np.testing.assert_array_equal(g1.arrays.occupancy, g2.arrays.occupancy)
    np.testing.assert_array_equal(g1.arrays.material_indices, g2.arrays.material_indices)
