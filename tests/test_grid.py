import numpy as np
import pytest

from zig_vulkan_jax.config import BRICK_BITS, BRICK_WORDS, GridConfig
from zig_vulkan_jax.core import grid as g


def small_grid(**kw):
    cfg = GridConfig(**kw)
    return g.BrickGrid(4, 2, 4, cfg)


def test_grid_at_and_voxel_at_layouts():
    grid = small_grid()
    st = grid.static
    # cell index = gx + dim_x*(gz + dim_z*gy)   (Grid.zig:206-211)
    assert g.grid_at(st, 0, 0, 0) == 0
    assert g.grid_at(st, 4, 0, 0) == 1
    assert g.grid_at(st, 0, 0, 4) == st.dim_x
    assert g.grid_at(st, 0, 4, 0) == st.dim_x * st.dim_z
    # voxel bit = bx + 4*(bz + 4*by)   (Grid.zig:198-203)
    assert g.voxel_at(1, 0, 0) == 1
    assert g.voxel_at(0, 0, 1) == 4
    assert g.voxel_at(0, 1, 0) == 16
    assert g.voxel_at(3, 3, 3) == 63


def test_insert_single_voxel_state():
    grid = small_grid()
    grid.insert(0, 0, 0, 7)
    a = grid.arrays
    st = grid.static
    # y flip: y=0 -> flipped = voxel_dim_y-1 = 7 -> brick y = 1 (top row)
    cell = g.grid_at(st, 0, 7, 0)
    assert (a.statuses[cell // 32] >> (cell % 32)) & 1 == 1
    assert int(a.active_bricks) == 1
    brick = int(a.indices[cell])
    assert brick == 0
    nth = g.voxel_at(0, 7, 0)
    word = brick * BRICK_WORDS + nth // 32
    assert (a.occupancy[word] >> (nth % 32)) & 1 == 1
    start = int(a.start_indices[brick])
    assert start == 0  # first window
    assert a.material_indices[start + nth] == 7
    assert grid.voxel_material(0, 0, 0) == 7
    assert grid.voxel_material(1, 0, 0) is None


def test_batch_equals_sequential():
    rng = np.random.default_rng(0)
    n = 500
    xs = rng.integers(0, 16, n)
    ys = rng.integers(0, 8, n)
    zs = rng.integers(0, 16, n)
    ms = rng.integers(1, 255, n).astype(np.uint8)

    seq = small_grid()
    for x, y, z, m in zip(xs, ys, zs, ms):
        seq.insert(int(x), int(y), int(z), int(m))

    bat = small_grid()
    bat.insert_batch(xs, ys, zs, ms)

    assert int(seq.arrays.active_bricks) == int(bat.arrays.active_bricks)
    np.testing.assert_array_equal(seq.arrays.statuses, bat.arrays.statuses)
    np.testing.assert_array_equal(seq.arrays.indices, bat.arrays.indices)
    np.testing.assert_array_equal(seq.arrays.occupancy, bat.arrays.occupancy)
    np.testing.assert_array_equal(seq.arrays.start_indices, bat.arrays.start_indices)
    np.testing.assert_array_equal(
        seq.arrays.material_indices, bat.arrays.material_indices
    )


def test_duplicate_voxel_last_material_wins():
    grid = small_grid()
    grid.insert_batch([3, 3], [4, 4], [5, 5], np.asarray([9, 13], dtype=np.uint8))
    assert grid.voxel_material(3, 4, 5) == 13


def test_out_of_bounds_raises():
    grid = small_grid()
    with pytest.raises(IndexError):
        grid.insert(16, 0, 0, 1)
    with pytest.raises(IndexError):
        grid.insert(0, -1, 0, 1)


def test_brick_alloc_exhaustion():
    grid = small_grid(brick_alloc=1)
    grid.insert(0, 0, 0, 1)
    with pytest.raises(MemoryError):
        grid.insert(8, 0, 0, 1)  # second brick


def test_remove_batch_clears_bits():
    grid = small_grid()
    grid.insert(1, 2, 3, 5)
    grid.insert(1, 2, 2, 6)
    grid.remove_batch([1], [2], [3])
    assert grid.voxel_material(1, 2, 3) is None
    assert grid.voxel_material(1, 2, 2) == 6


def test_apply_edits_matches_host_builder():
    import jax
    import jax.numpy as jnp

    host = small_grid()
    host.insert(0, 0, 0, 3)  # pre-existing brick

    dev = small_grid()
    dev.insert(0, 0, 0, 3)
    arrays = dev.device_arrays()

    rng = np.random.default_rng(1)
    n = 64
    xs = rng.integers(0, 16, n)
    ys = rng.integers(0, 8, n)
    zs = rng.integers(0, 16, n)
    # avoid in-batch duplicate voxels (unspecified material ordering)
    seen = set()
    keep = []
    for i, (x, y, z) in enumerate(zip(xs, ys, zs)):
        if (x, y, z) not in seen:
            seen.add((x, y, z))
            keep.append(i)
    keep = np.asarray(keep)
    xs, ys, zs = xs[keep], ys[keep], zs[keep]
    ms = rng.integers(1, 255, xs.size).astype(np.uint8)

    host.insert_batch(xs, ys, zs, ms)

    # pad the edit batch with invalid lanes to test masking
    pad = 17
    xyz = np.zeros((xs.size + pad, 3), dtype=np.int32)
    xyz[: xs.size, 0] = xs
    xyz[: xs.size, 1] = ys
    xyz[: xs.size, 2] = zs
    mats = np.zeros(xs.size + pad, dtype=np.uint8)
    mats[: xs.size] = ms
    valid = np.zeros(xs.size + pad, dtype=bool)
    valid[: xs.size] = True

    out = jax.jit(
        g.apply_edits, static_argnums=0
    )(dev.static, arrays, jnp.asarray(xyz), jnp.asarray(mats), jnp.asarray(valid))

    assert int(out.active_bricks) == int(host.arrays.active_bricks)
    np.testing.assert_array_equal(np.asarray(out.statuses), host.arrays.statuses)
    # brick slot numbering can differ between host (first-appearance order)
    # and device (cell-sorted order), so compare *semantics*: material at
    # every voxel coordinate.
    dev_back = small_grid()
    dev_back.arrays = g.GridArrays(
        statuses=np.asarray(out.statuses),
        indices=np.asarray(out.indices),
        occupancy=np.asarray(out.occupancy),
        start_indices=np.asarray(out.start_indices),
        material_indices=np.asarray(out.material_indices),
        active_bricks=np.uint32(out.active_bricks),
        material_cursor=np.uint32(out.material_cursor),
        diel_mask=np.asarray(out.diel_mask),
        brick_ir=np.asarray(out.brick_ir),
    )
    for x, y, z, m in zip(xs, ys, zs, ms):
        assert dev_back.voxel_material(int(x), int(y), int(z)) == int(m)
    assert dev_back.voxel_material(0, 0, 0) == 3


def test_remove_edits_device():
    import jax
    import jax.numpy as jnp

    grid = small_grid()
    grid.insert(1, 2, 3, 5)
    grid.insert(1, 2, 2, 6)
    arrays = grid.device_arrays()
    xyz = np.asarray([[1, 2, 3], [9, 9, 9]], dtype=np.int32)
    valid = np.asarray([True, False])
    out = jax.jit(g.remove_edits, static_argnums=0)(
        grid.static, arrays, jnp.asarray(xyz), jnp.asarray(valid)
    )
    back = small_grid()
    back.arrays = g.GridArrays(
        statuses=np.asarray(out.statuses),
        indices=np.asarray(out.indices),
        occupancy=np.asarray(out.occupancy),
        start_indices=np.asarray(out.start_indices),
        material_indices=np.asarray(out.material_indices),
        active_bricks=np.uint32(out.active_bricks),
        material_cursor=np.uint32(out.material_cursor),
        diel_mask=np.asarray(out.diel_mask),
        brick_ir=np.asarray(out.brick_ir),
    )
    assert back.voxel_material(1, 2, 3) is None
    assert back.voxel_material(1, 2, 2) == 6


def test_apply_edits_maintains_dielectric_masks():
    import jax
    import jax.numpy as jnp

    from zig_vulkan_jax.core.materials import terrain_materials

    mats = terrain_materials()  # material 0 = water (dielectric ir 1.333)
    grid = small_grid()
    grid.attach_materials(mats)
    arrays = grid.device_arrays()
    xyz = np.asarray([[1, 1, 1], [2, 1, 1]], dtype=np.int32)
    edit_mats = np.asarray([0, 1], dtype=np.uint8)  # water + grass
    valid = np.ones(2, dtype=bool)
    out = jax.jit(g.apply_edits, static_argnums=0)(
        grid.static, arrays, jnp.asarray(xyz), jnp.asarray(edit_mats),
        jnp.asarray(valid), jnp.asarray(mats.mtype == 2),
        jnp.asarray(mats.type_data))

    # host reference
    grid.insert_batch(xyz[:, 0], xyz[:, 1], xyz[:, 2], edit_mats)
    # same brick (voxels adjacent): masks must agree per brick content
    dm = np.asarray(out.diel_mask)
    assert dm.sum() > 0  # water voxel marked
    host_dm = grid.arrays.diel_mask
    assert dm.sum() == host_dm.sum()
    ir = np.asarray(out.brick_ir)
    assert np.nanmax(np.where(np.isnan(ir), -1, ir)) == np.float32(1.333)
