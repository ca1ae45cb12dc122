"""The five BASELINE.json benchmark configurations, runnable end-to-end.

Each config returns a dict of measured numbers. Sizes accept a `scale` knob
so the suite smoke-runs on CPU in CI (tests) and runs full-size on the GPU.

BASELINE.json configs:
 1. primary-ray 3D-DDA render: 64^3 dense voxel grid, 256x256, flat shading
 2. sparse brickmap traversal, 512^3 scene at 720p, diffuse + sun shadows
 3. interactive camera fly-through with per-frame voxel edits at 1080p
 4. path-traced bounces + emissive voxels with temporal accumulation, 1080p
 5. multi-chip framebuffer-tile sharding: 4K render of streamed 1024^3 scene
"""

from __future__ import annotations

import os as _os
import sys as _sys

_REPO = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
if _REPO not in _sys.path:
    _sys.path.insert(0, _REPO)

import time
from typing import Callable, Dict

import numpy as np

from zig_vulkan_jax.config import (
    CameraConfig,
    DenoiserConfig,
    EngineConfig,
    GridConfig,
    SunConfig,
    TraceConfig,
)
from zig_vulkan_jax.core.grid import BrickGrid
from zig_vulkan_jax.core.materials import MAT_EMISSIVE, terrain_materials
from zig_vulkan_jax.engine.engine import VoxelRT, device_name
from zig_vulkan_jax.models import scenes


def _timed_frames(rt: VoxelRT, frames: int, move: Callable[[int], None] | None = None):
    """Frame timing: chain frames, sync once at the end. The warmup render
    is synced so compilation stays out of the timed loop."""
    np.asarray(rt.render())  # compile + execute, synced
    if move is not None:
        # compile the edit-path programs too: move(i) alternates
        # insert/remove (config 3), so BOTH warmups are needed
        move(0)
        np.asarray(rt.render())
        move(1)
        np.asarray(rt.render())
    img = None
    t0 = time.time()
    for i in range(frames):
        if move is not None:
            move(i)
        img = rt.render()
    _ = np.asarray(img)  # sync
    dt = (time.time() - t0) / frames
    w, h = rt.internal_resolution
    spp = int(rt.camera.d_camera.samples_per_pixel)
    return {
        "ms_per_frame": dt * 1e3,
        "fps": 1.0 / dt,
        "mrays_per_s": w * h * spp / dt / 1e6,
    }


def config1_dense_primary(scale: float = 1.0, frames: int = 8) -> Dict:
    """64^3 dense grid, 256x256, flat shading (primary rays)."""
    dim = max(2, int(16 * scale))  # 16 bricks = 64^3 voxels at scale 1
    res = max(32, int(256 * scale))
    grid = BrickGrid(dim, dim, dim, GridConfig(scale=1.0))
    vx, vy, vz = grid.static.voxel_dims
    xs, ys, zs = np.meshgrid(np.arange(vx), np.arange(vy // 2), np.arange(vz),
                             indexing="ij")
    grid.insert_batch(xs.ravel(), ys.ravel(), zs.ravel(),
                      np.full(xs.size, 1, dtype=np.uint8))
    rt = VoxelRT(grid, terrain_materials(), EngineConfig(
        internal_resolution_width=res, internal_resolution_height=res,
        camera=CameraConfig(origin=(dim / 2, dim * 0.9, dim * 2.5),
                            samples_per_pixel=1, max_bounce=0),
        sun=SunConfig(enabled=False), denoiser=DenoiserConfig(enabled=False)))
    return {"config": "1: dense 64^3 primary 256x256",
            **_timed_frames(rt, frames)}


def config2_sparse_diffuse_shadows(scale: float = 1.0, frames: int = 6) -> Dict:
    """512^3 sparse scene at 720p, diffuse + sun shadow rays."""
    dims = (max(4, int(128 * scale)), max(2, int(64 * scale)),
            max(4, int(128 * scale)))
    w, h = max(64, int(1280 * scale)), max(36, int(720 * scale))
    scene = scenes.default_scene(dims=dims)
    rt = VoxelRT(scene.grid, scene.materials, EngineConfig(
        internal_resolution_width=w, internal_resolution_height=h,
        camera=CameraConfig(origin=(0.0, 0.0, 0.0), samples_per_pixel=1,
                            max_bounce=0),
        sun=SunConfig(enabled=True, animate=False),
        denoiser=DenoiserConfig(enabled=False),
        trace=TraceConfig(max_steps=160)))
    return {"config": "2: sparse 512^3 diffuse+shadows 720p",
            **_timed_frames(rt, frames)}


def config3_interactive_edits(scale: float = 1.0, frames: int = 6) -> Dict:
    """Fly-through with per-frame voxel insert/remove at 1080p."""
    dims = (max(4, int(128 * scale)), max(2, int(64 * scale)),
            max(4, int(128 * scale)))
    w, h = max(64, int(1920 * scale)), max(36, int(1080 * scale))
    scene = scenes.default_scene(dims=dims)
    rt = VoxelRT(scene.grid, scene.materials, EngineConfig(
        internal_resolution_width=w, internal_resolution_height=h,
        camera=CameraConfig(origin=(0.0, 0.0, 0.0), samples_per_pixel=1,
                            max_bounce=1),
        sun=SunConfig(enabled=True, animate=True),
        denoiser=DenoiserConfig(enabled=False),
        trace=TraceConfig(max_steps=160)))
    bench = rt.create_benchmark(duration=60.0)
    rng = np.random.default_rng(0)
    vx, vy, vz = scene.grid.static.voxel_dims

    def move(i):
        bench.update(0.016)
        rt.update_sun(0.016)
        n = 512
        xyz = np.stack([rng.integers(0, vx, n), rng.integers(0, vy, n),
                        rng.integers(0, vz, n)], axis=-1)
        if i % 2 == 0:
            rt.insert_voxels(xyz, rng.integers(1, 8, n).astype(np.uint8))
        else:
            rt.remove_voxels(xyz)

    out = {"config": "3: interactive edits 1080p",
           **_timed_frames(rt, frames, move)}
    rt.camera.reset()
    return out


def config4_path_traced_emissive(scale: float = 1.0, frames: int = 6) -> Dict:
    """Path-traced bounces + emissive voxels + temporal accumulation, 1080p."""
    dims = (max(4, int(64 * scale)), max(2, int(32 * scale)),
            max(4, int(64 * scale)))
    w, h = max(64, int(1920 * scale)), max(36, int(1080 * scale))
    scene = scenes.default_scene(dims=dims, with_model=False)
    scene.materials.set(40, MAT_EMISSIVE, (1.0, 0.85, 0.4), 8.0)
    vx, vy, vz = scene.grid.static.voxel_dims
    xs, ys, zs = np.meshgrid(
        np.arange(max(0, vx // 2 - 4), vx // 2 + 4),
        np.arange(max(0, vy - 8), max(1, vy - 4)),
        np.arange(max(0, vz // 2 - 4), vz // 2 + 4), indexing="ij")
    scene.grid.insert_batch(xs.ravel(), ys.ravel(), zs.ravel(),
                            np.full(xs.size, 40, dtype=np.uint8))
    rt = VoxelRT(scene.grid, scene.materials, EngineConfig(
        internal_resolution_width=w, internal_resolution_height=h,
        camera=CameraConfig(origin=(0.0, 0.0, 0.0), samples_per_pixel=2,
                            max_bounce=3),
        sun=SunConfig(enabled=True, animate=False),
        denoiser=DenoiserConfig(enabled=True),
        trace=TraceConfig(max_steps=160)))
    rt.set_temporal(True)
    return {"config": "4: path traced + emissive + temporal 1080p",
            **_timed_frames(rt, frames)}


def config5_multichip_4k(scale: float = 1.0, frames: int = 3) -> Dict:
    """Multi-device framebuffer sharding: 4K render of a streamed big scene.

    On one device this exercises the sharded step over a 1-device mesh;
    on several the same code row-shards over all of them.
    """
    import jax
    import jax.numpy as jnp

    from zig_vulkan_jax.io import streaming
    from zig_vulkan_jax.ops import trace as trace_mod
    from zig_vulkan_jax.parallel import mesh as pmesh

    dims = (max(8, int(256 * scale)), max(4, int(64 * scale)),
            max(8, int(256 * scale)))  # 1024^3 voxels at scale 1 (x/z)
    w = max(128, int(3840 * scale))
    n_dev = len(jax.devices())
    h = max(n_dev * 8, (int(2160 * scale) // n_dev) * n_dev)

    grid = BrickGrid(*dims, GridConfig(min_point=(-64, -16, -64), scale=0.5))
    mats_table = terrain_materials()
    # streamed construction
    rt = VoxelRT(grid, mats_table, EngineConfig(
        internal_resolution_width=w, internal_resolution_height=h,
        camera=CameraConfig(origin=(0.0, 0.0, 0.0), samples_per_pixel=1,
                            max_bounce=0),
        sun=SunConfig(enabled=False), denoiser=DenoiserConfig(enabled=False)))
    t0 = time.time()
    streamed = streaming.stream_into_engine(
        rt, streaming.terrain_regions(grid, region_x=dims[0]))
    stream_s = time.time() - t0

    m = pmesh.make_mesh()
    step = pmesh.build_sharded_step(
        m, grid.static, width=w, height=h, spp=1, max_bounce=1,
        sun_enabled=False, denoiser=DenoiserConfig(enabled=False))
    arrays_r, mats_r = pmesh.replicate_scene(m, rt.arrays, rt.mats)
    # cached per-frame inputs: tables built ONCE (exact skip field) and
    # every constant pre-created, so a frame is the sharded step alone
    dist = jax.jit(trace_mod.distance_field, static_argnums=(0, 2))(
        grid.static, arrays_r, True)
    tables = jax.jit(trace_mod.build_trace_tables, static_argnums=0)(
        grid.static, arrays_r, dist)
    cam = {k: jnp.asarray(v) for k, v in
           trace_mod.camera_vectors(rt.camera.d_camera).items()}
    zeros3 = jnp.zeros(3, jnp.float32)
    ones3 = jnp.ones(3, jnp.float32)
    one = jnp.float32(1.0)
    img = step(arrays_r, mats_r, cam, zeros3, ones3, one, tables=tables)
    np.asarray(img)  # compile+sync
    t0 = time.time()
    for _ in range(frames):
        img = step(arrays_r, mats_r, cam, zeros3, ones3, one, tables=tables)
    np.asarray(img)
    dt = (time.time() - t0) / frames
    return {
        "config": "5: multi-chip 4K streamed scene",
        "devices": n_dev,
        "streamed_voxels": streamed,
        "stream_s": stream_s,
        "ms_per_frame": dt * 1e3,
        "mrays_per_s": w * h / dt / 1e6,
    }


ALL_CONFIGS = [
    config1_dense_primary,
    config2_sparse_diffuse_shadows,
    config3_interactive_edits,
    config4_path_traced_emissive,
    config5_multichip_4k,
]


def run_all(scale: float = 1.0) -> list:
    results = []
    for fn in ALL_CONFIGS:
        print(f"# running {fn.__name__}", file=_sys.stderr, flush=True)
        r = fn(scale=scale)
        r["device"] = device_name()
        results.append(r)
        print(r, flush=True)
    return results


if __name__ == "__main__":
    import sys

    from zig_vulkan_jax.utils import jitcache
    jitcache.enable()
    run_all(scale=float(sys.argv[1]) if len(sys.argv) > 1 else 1.0)
