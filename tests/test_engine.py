"""Engine facade tests: render step, edits, benchmark, scene IO."""

import numpy as np

from zig_vulkan_jax.config import (
    CameraConfig,
    DenoiserConfig,
    EngineConfig,
    SunConfig,
    TraceConfig,
)
from zig_vulkan_jax.engine.engine import VoxelRT, device_name
from zig_vulkan_jax.models.scenes import flat_test_scene


def small_engine(**overrides):
    sc = flat_test_scene(dim=8)
    overrides.setdefault("trace", TraceConfig(max_steps=256))
    cfg = EngineConfig(
        internal_resolution_width=32,
        internal_resolution_height=24,
        camera=CameraConfig(origin=(4.0, 6.5, 15.0), samples_per_pixel=1,
                            max_bounce=0),
        sun=SunConfig(enabled=False),
        denoiser=DenoiserConfig(enabled=False),
        **overrides,
    )
    return VoxelRT(sc.grid, sc.materials, cfg)


def test_draw_produces_image_and_metrics():
    rt = small_engine()
    img = rt.draw(dt=0.016)
    arr = np.asarray(img)
    assert arr.shape == (24, 32, 3)
    assert np.isfinite(arr).all()
    assert rt.metrics.frame_count == 1
    assert rt.metrics.summary()["avg_ms"] > 0


def test_output_resolution_decoupled():
    rt = small_engine(output_resolution_width=64, output_resolution_height=48)
    img = np.asarray(rt.render())
    assert img.shape == (48, 64, 3)


def test_camera_motion_changes_image_without_retrace():
    rt = small_engine()
    a = np.asarray(rt.render())
    rt.camera.translate(1.0, [1.0, 0.0, 0.0])
    rt.camera.turn_yaw(0.5)
    b = np.asarray(rt.render())
    assert not np.array_equal(a, b)
    assert len(rt._step_cache) == 1  # same static config -> one trace


def test_insert_and_remove_voxels_visible():
    rt = small_engine()
    before = np.asarray(rt.render())
    # drop a big block right in front of the camera path
    xs, ys, zs = np.meshgrid(np.arange(8, 24), np.arange(8, 24),
                             np.arange(28, 31), indexing="ij")
    xyz = np.stack([xs.ravel(), ys.ravel(), zs.ravel()], axis=-1)
    rt.insert_voxels(xyz, np.full(xyz.shape[0], 7, dtype=np.uint8))
    after = np.asarray(rt.render())
    assert not np.array_equal(before, after)
    rt.remove_voxels(xyz)
    removed = np.asarray(rt.render())
    np.testing.assert_allclose(removed, before, atol=1e-6)


def test_sun_toggle_rebuilds_step():
    rt = small_engine()
    rt.render()
    rt.sun.device_data.enabled = True
    rt.render()
    assert len(rt._step_cache) == 2


def test_benchmark_runs_and_reports():
    rt = small_engine()
    bench = rt.run_benchmark(duration=0.2, max_frames=5, verbose=False)
    assert bench.report.delta_time_sum_samples >= 1
    text = bench.report.format(device_name(), rt.camera.d_camera, False)
    assert "BENCHMARK REPORT" in text
    assert "Min frame time" in text
    # camera reset after benchmark (Benchmark usage contract)
    assert not rt.camera.user_input_disabled


def test_scene_save_load_roundtrip(tmp_path):
    from zig_vulkan_jax.io.scene_io import load_scene

    rt = small_engine()
    p = str(tmp_path / "scene.npz")
    rt.save_scene(p)
    grid, mats = load_scene(p)
    assert grid.static == rt.grid_static
    np.testing.assert_array_equal(grid.arrays.occupancy,
                                  np.asarray(rt.arrays.occupancy))
    np.testing.assert_array_equal(mats.albedo, rt.materials_host.albedo)


def test_set_denoiser_knobs():
    rt = small_engine()
    rt.set_denoiser(enabled=True, samples=4)
    img = np.asarray(rt.render())
    assert img.shape == (24, 32, 3)
    assert np.isfinite(img).all()


def test_flush_grid_resyncs_scene():
    import numpy as np
    from zig_vulkan_jax.models.scenes import flat_test_scene

    rt = small_engine()
    before = np.asarray(rt.render())
    # rebuild a host grid with an extra block and flush it wholesale
    sc2 = flat_test_scene(dim=8)
    xs, ys, zs = np.meshgrid(np.arange(8, 24), np.arange(8, 24),
                             np.arange(28, 31), indexing="ij")
    sc2.grid.insert_batch(xs.ravel(), ys.ravel(), zs.ravel(),
                          np.full(xs.size, 7, dtype=np.uint8))
    rt.flush_grid(sc2.grid)
    after = np.asarray(rt.render())
    assert not np.array_equal(before, after)


def test_debug_validation_mode():
    import jax
    from zig_vulkan_jax.models.scenes import flat_test_scene
    from zig_vulkan_jax.config import EngineConfig, CameraConfig, SunConfig, DenoiserConfig

    sc = flat_test_scene(dim=8)
    cfg = EngineConfig(
        internal_resolution_width=16, internal_resolution_height=16,
        camera=CameraConfig(origin=(4.0, 6.5, 15.0), samples_per_pixel=1,
                            max_bounce=0),
        sun=SunConfig(enabled=False), denoiser=DenoiserConfig(enabled=False),
        debug_validation=True)
    rt = VoxelRT(sc.grid, sc.materials, cfg)
    try:
        assert jax.config.values["jax_debug_nans"]
        import numpy as np
        img = np.asarray(rt.render())
        assert np.isfinite(img).all()
    finally:
        from zig_vulkan_jax.utils import validation
        validation.disable_debug_mode()


def test_set_resolutions_rescale():
    """The swapchain-rebuild analog (Pipeline.zig:657-710): new shapes mean
    a new cached jit trace; camera pose survives the rescale."""
    rt = small_engine()
    rt.camera.translate(1.0, [1.0, 0.0, 0.0])
    origin_before = rt.camera.d_camera.origin.copy()
    rt.render()
    rt.set_resolutions(internal=(48, 32), output=(96, 64))
    img = np.asarray(rt.render())
    assert img.shape == (64, 96, 3)
    np.testing.assert_allclose(rt.camera.d_camera.origin, origin_before)
    assert len(rt._step_cache) == 2  # old + new static config
    assert rt.metrics.rays_per_frame == 48 * 32 * 1


def test_insert_overflow_raises():
    """ADVICE r1: apply_edits drops overflowing scatters silently; the
    engine must surface exhaustion as an error instead."""
    import pytest

    from zig_vulkan_jax.config import GridConfig
    from zig_vulkan_jax.core.grid import BrickGrid
    from zig_vulkan_jax.core.materials import terrain_materials

    grid = BrickGrid(8, 8, 8, GridConfig(brick_alloc=2))
    mats = terrain_materials()
    grid.attach_materials(mats)
    grid.insert(0, 0, 0, 1)  # one brick used on host
    cfg = EngineConfig(
        internal_resolution_width=32, internal_resolution_height=24,
        camera=CameraConfig(samples_per_pixel=1, max_bounce=0),
        sun=SunConfig(enabled=False), denoiser=DenoiserConfig(enabled=False))
    rt = VoxelRT(grid, mats, cfg)
    rt.insert_voxels(np.asarray([[8, 8, 8]]), np.asarray([1], np.uint8))
    with pytest.raises(MemoryError):
        rt.insert_voxels(np.asarray([[16, 16, 16], [24, 24, 24]]),
                         np.asarray([1, 1], np.uint8))


def test_incremental_table_refresh_matches_full_rebuild():
    """insert_voxels/remove_voxels maintain the cached trace tables
    incrementally (the dirty-range delta analog); the result must equal a
    from-scratch rebuild."""
    import jax
    import jax.numpy as jnp
    from zig_vulkan_jax.ops import trace as trace_mod

    rt = small_engine()
    rt.render()  # builds + caches tables
    assert rt._tables is not None
    rng = np.random.default_rng(7)
    xyz = np.stack([rng.integers(0, 32, 40), rng.integers(0, 32, 40),
                    rng.integers(0, 32, 40)], axis=-1).astype(np.int32)
    rt.insert_voxels(xyz, np.full(40, 5, dtype=np.uint8))
    got = np.asarray(rt._tables)
    want = np.asarray(trace_mod.build_trace_tables(rt.grid_static, rt.arrays))
    np.testing.assert_array_equal(got, want)

    rt.remove_voxels(xyz[:17])
    got = np.asarray(rt._tables)
    # removals reuse the cached dist; rebuild with the same field
    want = np.asarray(trace_mod.build_trace_tables(
        rt.grid_static, rt.arrays, rt._dist))
    np.testing.assert_array_equal(got, want)


def test_denoiser_samples_runtime_no_retrace():
    """`samples` is a runtime push constant in the reference
    (image.frag:18-23); the GUI slider must change output WITHOUT a new
    jit trace — the step key is samples-independent and the value rides
    the packed push-constant array (pc[23])."""
    sc = flat_test_scene(dim=8)
    cfg = EngineConfig(
        internal_resolution_width=32, internal_resolution_height=24,
        camera=CameraConfig(origin=(4.0, 6.5, 15.0), samples_per_pixel=1,
                            max_bounce=0),
        sun=SunConfig(enabled=False),
        denoiser=DenoiserConfig(enabled=True, samples=8),
        trace=TraceConfig(max_steps=256))
    rt = VoxelRT(sc.grid, sc.materials, cfg)
    key0 = rt._step_key()
    a = np.asarray(rt.render())
    rt.set_denoiser(samples=32)
    assert rt._step_key() == key0, "samples must not be in the step key"
    b = np.asarray(rt.render())
    assert len(rt._step_cache) == 1, "slider move must not retrace"
    assert np.abs(a - b).max() > 1e-6, "slider move must change output"
    # other runtime knobs keep riding push constants too
    rt.set_denoiser(distribution_bias=0.9, inverse_hue_tolerance=5.0)
    c = np.asarray(rt.render())
    assert len(rt._step_cache) == 1
    assert not np.array_equal(b, c)

