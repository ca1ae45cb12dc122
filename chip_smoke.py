"""Smoke run of the renderer's main path on the GPU.

    python chip_smoke.py              # one GPU
    python chip_smoke.py --four-gpus  # the sharded 4K step on four GPUs

One GPU: the default 512x256x512 scene (models.scenes.cached_default_scene,
built from its seed and cached next to this file) rendered through VoxelRT
at the reference's default workload (1024x576, 2 spp, 2+1 bounces, sun
shadows, denoiser; main.zig:23,126-128), a 1920x1080 primary-ray frame, a
batch of 512 random inserts and 512 removes each followed by a frame, a
12-frame fly-through, and temporal accumulation at 256x144. What the card
computes is compared with the CPU oracles (oracle.cpu_tracer,
oracle.cpu_denoise):

- primary hits of the engine traversal at a 48x48 subsample of the 1080p
  pose, with empty-space skipping (hit-equivalent: under 0.5% grazing
  flips, as tests/test_parity_at_scale.py holds it) and without (exact:
  the same hit set, and pixels within 1e-5, as tests/test_trace_parity.py
  holds the primary image);
- shaded RGB of VoxelRT at 256x144 (each pixel is independent of the
  image size). Primary rays with sun shadows, 2 spp: mean per-pixel
  max-channel difference under 5e-3 and under 1% of pixels off by more
  than 1e-3, the statistical bar of tests/test_trace_parity.py. The full
  default workload (2+1 bounces): each channel's image mean within 2e-3
  of the oracle's. Per pixel the bounces cannot match: hit distances
  differ from the oracle's by a few float32 ulps at this scene's world
  coordinates (multiply-add contraction, on the CPU backend as on the
  GPU), and the hash RNG, seeded by the hit position, turns that into an
  independent scatter sample; the per-pixel figures are printed beside;
- the denoiser on the default frame, to 1e-5.

Four GPUs: the row-sharded step (parallel.mesh.build_sharded_step) at
3840x2160 with config 5's trace settings (1 spp, primary rays, no sun, no
denoiser), compared with the one-GPU VoxelRT render of the same pose.

A failed comparison is reported and fails the run at its end; any other
error stops it at once. Either way the script exits non-zero and prints no
result. The last line of stdout is one JSON object,
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SCENE_CACHE = os.path.join(REPO, ".bench_scene_cache.npz")
EDIT_SEED = 0

# parity bars (see the module docstring for where each comes from)
SKIP_FLIP_MAX = 0.005
SKIP_T_TOL = 1e-2
EXACT_PIXEL_ATOL = 1e-5
SHADED_MEAN_MAX = 5e-3
SHADED_OFF_FRAC_MAX = 0.01
SHADED_OFF_ATOL = 1e-3
SHADED_IMAGE_MEAN_MAX = 2e-3
DENOISE_ATOL = 1e-5
SHARDED_OFF_FRAC_MAX = 0.005


def _log(msg: str) -> None:
    print(msg, flush=True)


class Checks:
    """Failed comparisons, collected so one run reports every phase; any
    failure fails the run at its end."""

    def __init__(self):
        self.failed = []

    def __call__(self, ok: bool, what: str) -> None:
        if not ok:
            _log(f"FAILED: {what}")
            self.failed.append(what)


# -- workloads ----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Sizes:
    """Image sizes and counts of the one-GPU run (CPU tests shrink them)."""

    default: tuple = (1024, 576)
    primary: tuple = (1920, 1080)
    shaded: tuple = (256, 144)
    parity_side: int = 48
    edits: int = 512
    frames: int = 10
    fly_frames: int = 12


def default_workload_config(width: int = 1024, height: int = 576,
                            denoise: bool = True, max_bounce: int = 2):
    """The reference's default workload (main.zig:23,126-128), sun fixed
    so repeated frames see the same pose."""
    from zig_vulkan_jax.config import (CameraConfig, DenoiserConfig,
                                       EngineConfig, SunConfig)

    return EngineConfig(
        internal_resolution_width=width, internal_resolution_height=height,
        camera=CameraConfig(origin=(0.0, 0.0, 0.0), samples_per_pixel=2,
                            max_bounce=max_bounce),
        sun=SunConfig(enabled=True, animate=False),
        denoiser=DenoiserConfig(enabled=denoise))


def primary_config(width: int = 1920, height: int = 1080):
    """Primary rays only, flat shading: the 1080p throughput frame and
    config 5's trace settings."""
    from zig_vulkan_jax.config import (CameraConfig, DenoiserConfig,
                                       EngineConfig, SunConfig)

    return EngineConfig(
        internal_resolution_width=width, internal_resolution_height=height,
        camera=CameraConfig(origin=(0.0, 0.0, 0.0), samples_per_pixel=1,
                            max_bounce=0),
        sun=SunConfig(enabled=False),
        denoiser=DenoiserConfig(enabled=False))


def frame_ms(render, frames: int) -> list:
    """Wall ms of `frames` frames, each synced with block_until_ready."""
    out = []
    for _ in range(frames):
        t0 = time.perf_counter()
        render().block_until_ready()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


# -- comparisons with the CPU oracles -----------------------------------------

def subsample_rays(camera_device, n_side: int):
    """An n_side x n_side grid of un-jittered camera rays across the image
    (the oracle parity subsample)."""
    d = camera_device
    width, height = int(d.image_width), int(d.image_height)
    xs = np.linspace(0, width - 1, n_side, dtype=np.float32)
    ys = np.linspace(0, height - 1, n_side, dtype=np.float32)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    u = (gx / np.float32(width - 1)).ravel()
    v = (gy / np.float32(height - 1)).ravel()
    rd = (d.horizontal * u[:, None] + d.lower_left_corner
          + d.vertical * v[:, None] - d.origin).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ro = np.broadcast_to(d.origin, rd.shape).astype(np.float32).copy()
    return ro, rd


def primary_hit_parity(rt, scene, ro, rd, use_skip: bool) -> dict:
    """The engine's traversal of primary rays (render_rows' call: cached
    tables, unbounded t, no dielectric key) against the oracle's GridHit."""
    import jax.numpy as jnp

    from zig_vulkan_jax.core.materials import MAT_NONE
    from zig_vulkan_jax.oracle import cpu_tracer as oracle
    from zig_vulkan_jax.ops import trace

    n = ro.shape[0]
    got = trace.grid_hit(
        rt.grid_static, rt.arrays, rt.mats, jnp.asarray(ro), jnp.asarray(rd),
        jnp.float32(np.inf), jnp.full(n, MAT_NONE, jnp.int32),
        jnp.ones(n, jnp.float32), jnp.ones(n, bool),
        max_steps=rt.trace_config.max_steps, tables=rt._tables,
        use_skip=use_skip, bounded_t=False, needs_ignore=False)
    found = np.asarray(got["found"])
    t = np.asarray(got["t"])
    osc = oracle.OracleScene(scene.grid.static, scene.grid.arrays,
                             scene.materials)
    o = oracle.grid_hit(osc, ro, rd, np.float32(1e-5), np.float32(np.inf),
                        np.full(n, MAT_NONE, np.int32),
                        np.ones(n, np.float32), np.ones(n, bool))
    both = found & o.found
    dt = np.abs(t[both] - o.t[both])
    agree = found == o.found
    agree[both] &= dt < SKIP_T_TOL
    return {"rays": int(n), "hit_frac": float(o.found.mean()),
            "found_agree": float((found == o.found).mean()),
            "agree": float(agree.mean()),
            "max_dt": float(dt.max()) if dt.size else 0.0}


def primary_pixel_parity(rt, scene, ro, rd) -> float:
    """Max |pixel| difference of flat-shaded primary rays, exact traversal
    (no empty-space skip), engine ray_color vs oracle RayColor."""
    import jax
    import jax.numpy as jnp

    from zig_vulkan_jax.oracle import cpu_tracer as oracle
    from zig_vulkan_jax.ops import trace

    sun = rt.sun.device_data
    color = jax.jit(trace.ray_color, static_argnums=(0, 5, 7),
                    static_argnames=("max_steps", "use_skip"))
    got = np.asarray(color(
        rt.grid_static, rt.arrays, rt.mats, jnp.asarray(ro), jnp.asarray(rd),
        1, jnp.asarray(sun.position), False, jnp.asarray(sun.color),
        jnp.float32(sun.radius), max_steps=rt.trace_config.max_steps,
        tables=rt._tables, use_skip=False))
    osc = oracle.OracleScene(scene.grid.static, scene.grid.arrays,
                             scene.materials)
    want = oracle.ray_color(osc, ro, rd, 1, sun.position, False, sun.color,
                            float(sun.radius))
    return float(np.abs(np.sqrt(got) - np.sqrt(want)).max())


def shaded_parity(rt, scene) -> dict:
    """Full-shading RGB of VoxelRT (denoiser off) against oracle.render."""
    from zig_vulkan_jax.oracle import cpu_tracer as oracle

    img = np.asarray(rt.render())
    osc = oracle.OracleScene(scene.grid.static, scene.grid.arrays,
                             scene.materials)
    want = oracle.render(osc, rt.camera.d_camera, rt.sun.device_data)
    diff = np.abs(img - want).max(axis=-1)
    image_mean = np.abs(img.mean(axis=(0, 1)) - want.mean(axis=(0, 1)))
    return {"pixels": int(diff.size), "mean": float(diff.mean()),
            "off_frac": float((diff > SHADED_OFF_ATOL).mean()),
            "max": float(diff.max()),
            "image_mean_diff": float(image_mean.max())}


def denoise_parity(img, denoiser) -> tuple:
    """The engine's denoiser call (runtime `samples` push constant) on the
    device against the numpy transliteration. Returns (denoised, max
    |difference|)."""
    import jax.numpy as jnp

    from zig_vulkan_jax.ops import denoise as denoise_mod
    from zig_vulkan_jax.oracle import cpu_denoise

    got = np.asarray(denoise_mod.denoise(
        jnp.asarray(img), samples=jnp.float32(denoiser.samples),
        distribution_bias=denoiser.distribution_bias,
        pixel_multiplier=denoiser.pixel_multiplier,
        inverse_hue_tolerance=denoiser.inverse_hue_tolerance,
        max_samples=denoise_mod.MAX_RUNTIME_SAMPLES))
    want = cpu_denoise.sir_bird(
        img, samples=int(denoiser.samples),
        distribution_bias=denoiser.distribution_bias,
        pixel_multiplier=denoiser.pixel_multiplier,
        inverse_hue_tolerance=denoiser.inverse_hue_tolerance)
    return got, float(np.abs(got - want).max())


def sharded_vs_single(devices, scene, width: int, height: int,
                      frames: int = 3) -> dict:
    """Row-sharded primary frame on `devices` against the one-device
    VoxelRT render of the same pose (same cached trace tables)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from zig_vulkan_jax.config import DenoiserConfig
    from zig_vulkan_jax.engine.engine import VoxelRT
    from zig_vulkan_jax.ops import trace
    from zig_vulkan_jax.parallel import mesh as pmesh

    rt = VoxelRT(scene.grid, scene.materials, primary_config(width, height))
    single = np.asarray(rt.render())
    single_ms = frame_ms(rt.render, frames)

    mesh = pmesh.make_mesh(devices)
    d = rt.camera.d_camera
    step = pmesh.build_sharded_step(
        mesh, rt.grid_static, width=width, height=height,
        spp=int(d.samples_per_pixel), max_bounce=int(d.max_bounce),
        sun_enabled=False, denoiser=DenoiserConfig(enabled=False),
        trace_config=rt.trace_config)
    arrays, mats = pmesh.replicate_scene(mesh, rt.arrays, rt.mats)
    tables = jax.device_put(rt._tables, NamedSharding(mesh, P()))
    sun = rt.sun.device_data
    args = (arrays, mats, trace.camera_vectors(d),
            jnp.asarray(sun.position, jnp.float32),
            jnp.asarray(sun.color, jnp.float32),
            jnp.asarray(sun.radius, jnp.float32))
    t0 = time.perf_counter()
    sharded = np.asarray(step(*args, tables=tables))
    compile_s = time.perf_counter() - t0
    sharded_ms = frame_ms(lambda: step(*args, tables=tables), frames)
    diff = np.abs(sharded - single).max(axis=-1)
    return {"devices": len(devices), "shape": list(sharded.shape),
            "off_frac": float((diff > SHADED_OFF_ATOL).mean()),
            "max_diff": float(diff.max()),
            "sharded_first_frame_s": compile_s,
            "sharded_ms": statistics.median(sharded_ms),
            "single_ms": statistics.median(single_ms)}


# -- the runs -----------------------------------------------------------------

def require_gpus(count: int):
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"JAX found no GPU (platform "
                         f"{devices[0].platform!r}); nothing was measured")
    if len(devices) < count:
        raise SystemExit(f"needs {count} GPUs, JAX found {len(devices)}")
    return devices[:count]


def card_lines() -> list:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def load_scene():
    from zig_vulkan_jax.models.scenes import cached_default_scene

    t0 = time.perf_counter()
    scene = cached_default_scene(SCENE_CACHE)
    _log(f"scene: {scene.grid.static.voxel_dims} voxels, "
         f"{int(scene.grid.arrays.active_bricks)} bricks, ready in "
         f"{time.perf_counter() - t0:.1f} s")
    return scene


def run_one_gpu(scene, device, check, sizes: Sizes = Sizes()) -> None:
    import jax.numpy as jnp

    from zig_vulkan_jax.engine.engine import VoxelRT
    from zig_vulkan_jax.utils import jitcache

    start = time.perf_counter()

    def phase(name):
        _log(f"== {name} (t={time.perf_counter() - start:.0f} s)")

    dw, dh = sizes.default
    phase(f"default workload: {dw}x{dh}, 2 spp, 2+1 bounces, sun, denoiser")
    cache = jitcache.cache_dir()
    n_cached = len(os.listdir(cache)) if os.path.isdir(cache) else 0
    rt = VoxelRT(scene.grid, scene.materials,
                 default_workload_config(dw, dh))
    t0 = time.perf_counter()
    first = rt.render()
    first.block_until_ready()
    _log(f"first frame (tables + trace + compile + run): "
         f"{time.perf_counter() - t0:.2f} s "
         f"(compile cache {cache}: {n_cached} entries before)")
    step = rt._build_step(rt._step_key())
    args = (rt.arrays, rt._tables, rt.mats,
            jnp.asarray(rt._push_constants()))
    t0 = time.perf_counter()
    lowered = step.lower(*args)
    lower_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    compiled = lowered.compile()
    _log(f"default step: trace+lower {lower_s:.2f} s, compile from the "
         f"persistent cache {time.perf_counter() - t0:.2f} s")
    _log(f"default step memory_analysis: {compiled.memory_analysis()}")
    ms = frame_ms(rt.render, sizes.frames)
    _log(f"default workload ms/frame: median {statistics.median(ms):.2f} "
         f"min {min(ms):.2f} max {max(ms):.2f} over {len(ms)} frames")
    denoised = np.asarray(rt.render())
    check(denoised.shape == (dh, dw, 3) and np.isfinite(denoised).all(),
           f"default frame {denoised.shape} not finite")

    phase("denoiser vs numpy transliteration (same pose, denoiser off)")
    rt.set_denoiser(enabled=False)
    traced = np.asarray(rt.render())
    rt.set_denoiser(enabled=True)
    got, err = denoise_parity(traced, rt.denoiser)
    in_step = float(np.abs(got - denoised).max())
    _log(f"denoise parity: max |device - numpy| {err:.3e} "
         f"(bar {DENOISE_ATOL:g}); vs the in-step denoiser {in_step:.3e}")
    check(err < DENOISE_ATOL, f"denoiser off by {err}")

    k = sizes.edits
    phase(f"edits: {k} random inserts, then {k} removes, each + a frame")
    rng = np.random.default_rng(EDIT_SEED)
    vx, vy, vz = rt.grid_static.voxel_dims
    for rnd in range(2):
        xyz = np.stack([rng.integers(0, vx, k), rng.integers(0, vy, k),
                        rng.integers(0, vz, k)], axis=-1)
        t0 = time.perf_counter()
        rt.insert_voxels(xyz, rng.integers(1, 8, k).astype(np.uint8))
        img = rt.render()
        img.block_until_ready()
        ins_ms = (time.perf_counter() - t0) * 1e3
        want = rt._tables_fn(rt.grid_static, rt.arrays, rt._dist)
        check(bool((want == rt._tables).all()),
               "tables after insert differ from a rebuild")
        t0 = time.perf_counter()
        rt.remove_voxels(xyz)
        img = rt.render()
        img.block_until_ready()
        rem_ms = (time.perf_counter() - t0) * 1e3
        want = rt._tables_fn(rt.grid_static, rt.arrays, rt._dist)
        check(bool((want == rt._tables).all()),
               "tables after remove differ from a rebuild")
        check(bool(np.isfinite(np.asarray(img)).all()), "edit frame")
        _log(f"edit round {rnd} ({'compiles' if rnd == 0 else 'warm'}): "
             f"insert+frame {ins_ms:.1f} ms, remove+frame {rem_ms:.1f} ms, "
             f"{int(rt.arrays.active_bricks)} bricks")

    phase(f"fly-through: run_benchmark(fixed_dt=0.5, "
          f"max_frames={sizes.fly_frames})")
    bench = rt.run_benchmark(fixed_dt=0.5, max_frames=sizes.fly_frames,
                             verbose=True)
    check(bench.report.delta_time_sum_samples >= 1, "fly-through")

    pw, ph = sizes.primary
    phase(f"{pw}x{ph} primary-ray frame")
    rt2 = VoxelRT(scene.grid, scene.materials, primary_config(pw, ph))
    t0 = time.perf_counter()
    rt2.render().block_until_ready()
    _log(f"first frame (tables + trace + compile + run): "
         f"{time.perf_counter() - t0:.2f} s")
    ms = frame_ms(rt2.render, sizes.frames)
    med = statistics.median(ms)
    _log(f"primary ms/frame: median {med:.2f} min {min(ms):.2f} "
         f"max {max(ms):.2f} over {len(ms)} frames "
         f"({pw * ph / med / 1e3:.1f} Mray/s)")

    n = sizes.parity_side
    phase(f"primary hits vs the CPU DDA oracle ({n}x{n} of that pose)")
    ro, rd = subsample_rays(rt2.camera.d_camera, n)
    skip = primary_hit_parity(rt2, scene, ro, rd, use_skip=True)
    _log(f"skip path: {skip} (bar: agree >= {1 - SKIP_FLIP_MAX})")
    check(skip["agree"] >= 1 - SKIP_FLIP_MAX, "skip-path hit parity")
    exact = primary_hit_parity(rt2, scene, ro, rd, use_skip=False)
    px = primary_pixel_parity(rt2, scene, ro, rd)
    _log(f"exact path: {exact}, max |pixel| {px:.3e} "
         f"(bar: found_agree == 1, pixels within {EXACT_PIXEL_ATOL:g})")
    check(exact["found_agree"] == 1.0 and px <= EXACT_PIXEL_ATOL,
           "exact-path parity")

    sw, sh_ = sizes.shaded
    phase(f"shading vs the CPU oracle at {sw}x{sh_}")
    rt3 = VoxelRT(scene.grid, scene.materials,
                  default_workload_config(sw, sh_, denoise=False,
                                          max_bounce=0))
    sh = shaded_parity(rt3, scene)
    _log(f"primary + sun shaded parity: {sh} (bars: mean < "
         f"{SHADED_MEAN_MAX:g}, off_frac < {SHADED_OFF_FRAC_MAX:g})")
    check(sh["mean"] < SHADED_MEAN_MAX
          and sh["off_frac"] < SHADED_OFF_FRAC_MAX, "primary+sun parity")
    rt4 = VoxelRT(scene.grid, scene.materials,
                  default_workload_config(sw, sh_, denoise=False))
    sh = shaded_parity(rt4, scene)
    _log(f"full shading parity: {sh} (bar: image_mean_diff < "
         f"{SHADED_IMAGE_MEAN_MAX:g})")
    check(sh["image_mean_diff"] < SHADED_IMAGE_MEAN_MAX,
          "full-shading parity")

    phase("temporal accumulation (donated accumulator), 3 frames")
    rt4.set_temporal(True)
    ms = frame_ms(rt4.render, 3)
    acc = np.asarray(rt4._accum)
    _log(f"temporal frames ms: {[round(m, 2) for m in ms]}, "
         f"{rt4._accum_count} accumulated")
    check(rt4._accum_count == 3 and np.isfinite(acc).all(), "temporal")

    stats = device.memory_stats() or {}
    _log(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use')} "
         f"(bytes_limit {stats.get('bytes_limit')})")
    phase("done")


def run_four_gpus(scene, devices, check) -> None:
    r = sharded_vs_single(devices, scene, 3840, 2160)
    _log(f"sharded 4K vs one GPU: {r} (bar: off_frac < "
         f"{SHARDED_OFF_FRAC_MAX:g})")
    check(r["off_frac"] < SHARDED_OFF_FRAC_MAX, "sharded 4K parity")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four-gpus", action="store_true",
                   help="run only the sharded 4K step on four GPUs")
    args = p.parse_args(argv)
    from zig_vulkan_jax.utils import jitcache

    devices = require_gpus(4 if args.four_gpus else 1)
    jitcache.enable()
    card = card_lines()
    scene = load_scene()
    check = Checks()
    if args.four_gpus:
        run_four_gpus(scene, devices, check)
    else:
        run_one_gpu(scene, devices[0], check)
    for line in card:
        _log(f"card: {line}")
    if check.failed:
        raise SystemExit(f"chip_smoke: {len(check.failed)} check(s) "
                         f"failed: {check.failed}")
    import jax

    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
