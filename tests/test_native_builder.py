"""Native C++ grid builder vs the vectorized numpy builder."""

import numpy as np
import pytest

from zig_vulkan_jax.config import GridConfig
from zig_vulkan_jax.core.grid import BrickGrid, dense_materials
from zig_vulkan_jax.io import terrain
from zig_vulkan_jax.io.native_builder import NativeGridBuilder, native_available


@pytest.fixture(autouse=True)
def _needs_native_toolchain():
    # decided per test, not at import: every test worker must collect the
    # same tests whether or not the library builds
    if not native_available():
        pytest.skip("no native toolchain")


def test_insert_batch_matches_numpy():
    rng = np.random.default_rng(0)
    n = 2000
    xs = rng.integers(0, 32, n)
    ys = rng.integers(0, 16, n)
    zs = rng.integers(0, 32, n)
    # de-duplicate voxels: multithreaded last-writer order is unordered
    _, keep = np.unique(xs * 10000 + ys * 100 + zs, return_index=True)
    xs, ys, zs = xs[keep], ys[keep], zs[keep]
    ms = rng.integers(1, 255, xs.size).astype(np.uint8)

    ref = BrickGrid(8, 4, 8, GridConfig())
    ref.insert_batch(xs, ys, zs, ms)

    nat = NativeGridBuilder(8, 4, 8, GridConfig(workers_count=4))
    ok = nat.insert_batch(xs, ys, zs, ms)
    assert ok == xs.size
    got = nat.finish()

    assert int(got.arrays.active_bricks) == int(ref.arrays.active_bricks)
    np.testing.assert_array_equal(got.arrays.statuses, ref.arrays.statuses)
    np.testing.assert_array_equal(
        dense_materials(got.static, got.arrays),
        dense_materials(ref.static, ref.arrays))


def test_native_terrain_matches_numpy():
    ref = BrickGrid(8, 4, 8, GridConfig())
    terrain.generate(ref, seed=99, scale=4.0, ocean_level=4)

    nat = NativeGridBuilder(8, 4, 8, GridConfig(workers_count=3))
    nat.generate_terrain(seed=99, scale=4.0, ocean_level=4)
    got = nat.finish()

    np.testing.assert_array_equal(
        dense_materials(got.static, got.arrays),
        dense_materials(ref.static, ref.arrays))


def test_out_of_bounds_rejected():
    nat = NativeGridBuilder(4, 4, 4, GridConfig())
    ok = nat.insert_batch([999], [0], [0], np.asarray([1], np.uint8))
    assert ok == 0
    nat.finish()


def test_brick_exhaustion_does_not_hang():
    """ADVICE r1: on allocation exhaustion, waiters on the same cell must
    error out (terminal latch state) instead of spinning forever."""
    # capacity for exactly 1 brick; inserts span 3 cells, many voxels per
    # cell so multiple threads contend on the losing cells
    nat = NativeGridBuilder(4, 4, 4, GridConfig(brick_alloc=1,
                                                workers_count=4))
    xs, ys, zs, ms = [], [], [], []
    for cx in (0, 4, 8):  # 3 distinct cells
        for v in range(16):
            xs.append(cx + v % 4)
            ys.append(0)
            zs.append(v // 4)
            ms.append(1)
    ok = nat.insert_batch(np.asarray(xs), np.asarray(ys), np.asarray(zs),
                          np.asarray(ms, np.uint8))
    # exactly one cell's worth of inserts can succeed
    assert ok == 16, ok
    got = nat.finish()
    assert int(got.arrays.active_bricks) == 1
