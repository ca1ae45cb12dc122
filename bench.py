"""Benchmark entry point: primary-ray throughput at 1080p.

Renders 1920x1080 primary-ray frames of the default 512x256x512 scene
through VoxelRT, one synced frame (block_until_ready) per fly-through
waypoint, checks the engine traversal's primary hits against the CPU DDA
oracle on a 48x48 subsample of the first pose, times the reference's
default workload (1024x576, 2 spp, 2+1 bounces, sun, denoiser), and prints
ONE JSON line:

    {"metric": ..., "value": <Mray/s>, "unit": "Mray/s", "device": {...},
     "parity_vs_oracle": ..., "default_frame_ms": ...}

Exits non-zero, printing no result, when JAX finds no GPU.

Usage: python bench.py [frames]
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import chip_smoke

METRIC = "primary_ray_throughput_1080p_512^3"


def main() -> int:
    frames = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    (device,) = chip_smoke.require_gpus(1)

    from zig_vulkan_jax.engine.benchmark import PATH_POINTS
    from zig_vulkan_jax.engine.engine import VoxelRT
    from zig_vulkan_jax.utils import jitcache

    jitcache.enable()
    scene = chip_smoke.load_scene()

    rt = VoxelRT(scene.grid, scene.materials, chip_smoke.primary_config())
    t0 = time.perf_counter()
    rt.render().block_until_ready()
    print(f"# 1080p primary first frame: {time.perf_counter() - t0:.2f} s",
          file=sys.stderr)
    ms = []
    for i in range(frames):
        rt.camera.set_origin(PATH_POINTS[i % len(PATH_POINTS)])
        ms += chip_smoke.frame_ms(rt.render, 1)
    per_frame = statistics.median(ms)
    mrays = 1920 * 1080 / per_frame / 1e3

    rt.camera.set_origin(PATH_POINTS[0])
    ro, rd = chip_smoke.subsample_rays(rt.camera.d_camera, 48)
    parity = chip_smoke.primary_hit_parity(rt, scene, ro, rd, use_skip=True)

    dflt = VoxelRT(scene.grid, scene.materials,
                   chip_smoke.default_workload_config())
    dflt.render().block_until_ready()
    default_ms = statistics.median(chip_smoke.frame_ms(dflt.render, frames))

    print(json.dumps({
        "metric": METRIC, "value": mrays, "unit": "Mray/s",
        "device": {"platform": device.platform, "kind": device.device_kind,
                   "count": 1},
        "ms_per_frame": per_frame,
        "parity_vs_oracle": parity["agree"],
        "default_frame_ms": default_ms,
        "default_frame_workload": "1024x576 2spp 2+1bounce sun denoiser",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
