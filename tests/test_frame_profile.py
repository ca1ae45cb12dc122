"""benchmarks/frame_profile.py: the trace -> per-class device time
reduction, checked on a small recorded trace (the CPU backend runs XLA's
ops on the host plane)."""

import glob

import jax
import jax.numpy as jnp

import chip_smoke
from benchmarks import frame_profile
from zig_vulkan_jax.engine.engine import VoxelRT
from zig_vulkan_jax.models.scenes import flat_test_scene


def test_classify_scopes():
    c = frame_profile.classify
    assert c("jit(step_nt)/while/body/ray_color/traverse_bounce2/while/"
             "body/add") == "traverse_bounce2"
    assert c("jit(step_nt)/ray_color/traverse_shadow0/while/cond/or"
             ) == "traverse_shadow0"
    assert c("jit(step_nt)/ray_color/mul") == "shading"
    assert c("jit(step_nt)/denoise/jit(_denoise_runtime)/add") == "denoise"
    assert c("jit(step_nt)/iota") == "other"


def test_reduce_recorded_trace(tmp_path):
    sc = flat_test_scene(dim=8)
    rt = VoxelRT(sc.grid, sc.materials,
                 chip_smoke.default_workload_config(16, 8))
    rt.render().block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        rt.render().block_until_ready()
    (xplane,) = glob.glob(str(tmp_path / "plugins/profile/*/*.xplane.pb"))
    hlo = rt._build_step(rt._step_key()).lower(
        rt.arrays, rt._tables, rt.mats,
        jnp.asarray(rt._push_constants())).compile().as_text()
    r = frame_profile.reduce_trace(xplane, hlo, plane_prefix="/host:CPU")
    classes = set(r["class_ms"])
    for cls in ("traverse_primary", "traverse_bounce1", "traverse_bounce2",
                "traverse_shadow0", "denoise"):
        assert cls in classes, classes
    assert r["class_ms"]["traverse_primary"] > 0
    assert 0 < r["busy_ms"] <= r["window_ms"]
    assert 0.0 <= r["idle_share"] < 1.0
