"""VoxelRT — the engine facade.

The JAX equivalent of the reference's public renderer API
(reference: src/modules/VoxelRT.zig + the per-frame orchestration of
voxel_rt/Pipeline.zig). Everything the reference does with Vulkan machinery
collapses into ONE jitted render step:

- compute dispatch + blit + denoise (Pipeline.draw, Pipeline.zig:432-541)
  -> a single XLA program: trace -> tone map -> denoise/resample (XLA fuses
  the handoff the reference manages with semaphores and queue-ownership
  barriers, SURVEY.md §5.8);
- staging-ramp uploads of camera/sun push constants -> traced scalar args;
- `updateGridDelta` dirty-range uploads (VoxelRT.zig:107-172) -> donated
  functional `apply_edits` scatter updates on device-resident arrays;
- swapchain rescale (Pipeline.zig:657-710) -> a new jit trace for the new
  static resolution (cached per resolution).

Host-side mutable state is only the camera/sun (a handful of floats, like
the reference's push constants) plus the metrics ring.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EngineConfig
from ..core.camera import Camera
from ..core.grid import BrickGrid, GridArrays, apply_edits, remove_edits
from ..core.materials import MaterialTable
from ..core.sun import Sun
from ..ops import denoise as denoise_mod
from ..ops import trace as trace_mod
from ..utils import profiling
from .benchmark import Benchmark
from .metrics import FrameMetrics

F = jnp.float32


class VoxelRT:
    """Engine facade (reference VoxelRT.zig:39-172).

    Example:
        scene = models.scenes.default_scene()
        rt = VoxelRT(scene.grid, scene.materials, EngineConfig())
        rt.camera.translate(dt, [0, 0, -1])
        image = rt.draw(dt)           # f32[out_h, out_w, 3] on device
    """

    VFOV_DEGREES = 75.0  # reference VoxelRT.init camera vfov

    def __init__(self, grid: BrickGrid, materials: MaterialTable,
                 config: EngineConfig = EngineConfig()):
        self.config = config
        self.grid_static = grid.static
        self.arrays: GridArrays = grid.device_arrays()
        self.materials_host = materials
        self.mats = trace_mod.materials_to_device(materials)

        iw = int(config.internal_resolution_width)
        ih = int(config.internal_resolution_height)
        self.internal_resolution = (iw, ih)
        ow = int(config.output_resolution_width or iw)
        oh = int(config.output_resolution_height or ih)
        self.output_resolution = (ow, oh)

        self.camera = Camera(self.VFOV_DEGREES, iw, ih, config.camera)
        self.sun = Sun(config.sun)
        self.denoiser = config.denoiser
        self.trace_config = config.trace

        self.metrics = FrameMetrics()
        self.metrics.rays_per_frame = iw * ih * int(config.camera.samples_per_pixel)

        if config.debug_validation:
            from ..utils import validation

            validation.enable_debug_mode()
            validation.validate_scene(self.grid_static, grid.arrays)

        self._step_cache = {}
        self._edit_step = None
        self._remove_step = None
        # conservative host-side brick-count bound: apply_edits drops
        # overflowing scatters silently (mode='drop'), so insert_voxels
        # raises BEFORE an edit batch could exhaust the allocation — without
        # a per-batch device sync (the bound only triggers a real device
        # read when it crosses capacity)
        self._bricks_upper = int(grid.arrays.active_bricks)
        self._tables = None
        self._dist = None
        self._tables_fn = jax.jit(trace_mod.build_trace_tables, static_argnums=0)
        self._dist_fn = jax.jit(trace_mod.distance_field,
                                static_argnums=(0, 2))
        self._refresh_insert_fn = jax.jit(
            trace_mod.refresh_tables_after_insert, static_argnums=0)
        self._refresh_remove_fn = jax.jit(
            trace_mod.refresh_tables_after_remove, static_argnums=0)

        # temporal accumulation (superset; BASELINE config 4): running
        # average of traced frames while the camera/sun pose is static,
        # with fresh per-frame jitter seeds
        self.temporal_enabled = False
        self._accum = None
        self._accum_count = 0
        self._pose_key = None

    # -- render step -----------------------------------------------------------

    def _build_step(self, key):
        """Trace+(accumulate)+postprocess jitted for one static config."""
        (iw, ih, ow, oh, spp, max_bounce, sun_enabled,
         dn_enabled, dn_pixel_multiplier, max_steps,
         empty_skip, temporal, row_bands) = key
        static = self.grid_static

        def body(arrays, tables, mats, pc, accum):
            # pc = the packed per-frame "push constants" (ONE host->device
            # transfer per frame; layout in _push_constants): the analog
            # of the reference's camera/sun/denoiser push-constant ranges
            # (ComputePipeline.zig:258-272, GraphicsPipeline push)
            cam = dict(origin=pc[0:3], horizontal=pc[3:6], vertical=pc[6:9],
                       lower_left_corner=pc[9:12])
            img = trace_mod.render_rows(
                static, arrays, mats, cam, iw, ih, spp, max_bounce,
                pc[12:15], pc[15:18], pc[18], sun_enabled,
                max_steps=max_steps, tables=tables, use_skip=empty_skip,
                sample_base=pc[21], row_bands=row_bands)
            if temporal:
                # running average over pose-static frames
                with jax.named_scope("accumulate"):
                    accum = accum + (img - accum) / (pc[22] + F(1.0))
                img = accum
            with jax.named_scope("denoise"):
                if dn_enabled:
                    # `samples` rides the push-constant array like the
                    # reference's runtime push constant (image.frag:18-23):
                    # the GUI slider changes output with NO retrace
                    out = denoise_mod.denoise(
                        img, samples=pc[23], distribution_bias=pc[19],
                        pixel_multiplier=dn_pixel_multiplier,
                        inverse_hue_tolerance=pc[20], out_shape=(oh, ow),
                        max_samples=denoise_mod.MAX_RUNTIME_SAMPLES)
                else:
                    out = denoise_mod.bilinear_resample(img, oh, ow)
            return out, accum

        if temporal:
            return jax.jit(body, donate_argnums=(4,))

        def step_nt(arrays, tables, mats, pc):
            return body(arrays, tables, mats, pc, None)[0]

        return jax.jit(step_nt)

    def _step_key(self):
        iw, ih = self.internal_resolution
        ow, oh = self.output_resolution
        d = self.camera.d_camera
        return (iw, ih, ow, oh, int(d.samples_per_pixel), int(d.max_bounce),
                bool(self.sun.device_data.enabled),
                # denoiser `samples` is deliberately NOT in the key — it
                # is a runtime push constant (pc[23]), like the reference
                bool(self.denoiser.enabled),
                float(self.denoiser.pixel_multiplier),
                int(self.trace_config.max_steps),
                bool(self.trace_config.empty_skip),
                bool(self.temporal_enabled),
                int(self.trace_config.row_bands))

    def render(self):
        """Render one frame; returns the device image f32[out_h, out_w, 3]."""
        key = self._step_key()
        step = self._step_cache.get(key)
        if step is None:
            step = self._build_step(key)
            self._step_cache[key] = step
        sun = self.sun.device_data
        if self._tables is None:
            # scene-derived traversal records, cached across frames; the
            # skip field is cached separately (removals keep it valid)
            with profiling.zone("build_tables"):
                if self._dist is None:
                    # scene (re)build: pay for the exact field once —
                    # larger skip radii cut steady-state DDA iterations;
                    # per-edit refreshes use the fast conservative build
                    self._dist = self._dist_fn(self.grid_static,
                                               self.arrays, True)
                self._tables = self._tables_fn(self.grid_static,
                                               self.arrays, self._dist)

        iw, ih = self.internal_resolution
        if self.temporal_enabled:
            pose = (tuple(np.asarray(self.camera.d_camera.origin).tolist()),
                    tuple(np.asarray(
                        self.camera.d_camera.lower_left_corner).tolist()),
                    tuple(np.asarray(sun.position).tolist()))
            if (pose != self._pose_key or self._accum is None
                    or self._accum.shape != (ih, iw, 3)):
                self._accum = jnp.zeros((ih, iw, 3), dtype=F)
                self._accum_count = 0
            self._pose_key = pose
            pc = jnp.asarray(self._push_constants())
            with profiling.zone("render_step"):
                out, self._accum = step(self.arrays, self._tables,
                                        self.mats, pc, self._accum)
            self._accum_count += 1
            return out
        pc = jnp.asarray(self._push_constants())
        with profiling.zone("render_step"):
            return step(self.arrays, self._tables, self.mats, pc)

    def _push_constants(self) -> np.ndarray:
        """Per-frame dynamic values packed into ONE f32 array (one
        host->device transfer per frame — the literal analog of the
        reference's push constants)."""
        d = self.camera.d_camera
        sun = self.sun.device_data
        pc = np.zeros(24, dtype=np.float32)
        pc[0:3] = np.asarray(d.origin, np.float32)
        pc[3:6] = np.asarray(d.horizontal, np.float32)
        pc[6:9] = np.asarray(d.vertical, np.float32)
        pc[9:12] = np.asarray(d.lower_left_corner, np.float32)
        pc[12:15] = np.asarray(sun.position, np.float32)
        pc[15:18] = np.asarray(sun.color, np.float32)
        pc[18] = np.float32(sun.radius)
        pc[19] = np.float32(self.denoiser.distribution_bias)
        pc[20] = np.float32(self.denoiser.inverse_hue_tolerance)
        spp = int(d.samples_per_pixel)
        pc[21] = np.float32(self._accum_count * spp
                            if self.temporal_enabled else 0.0)
        pc[22] = np.float32(self._accum_count)
        pc[23] = np.float32(min(int(self.denoiser.samples),
                                denoise_mod.MAX_RUNTIME_SAMPLES))
        return pc

    def draw(self, dt: float | None = None):
        """Render + record frame metrics (Pipeline.draw analog). Blocks
        until the device finishes so frame times are honest."""
        t0 = time.perf_counter()
        with profiling.zone("draw"):
            image = self.render()
            with profiling.zone("device_sync"):
                image.block_until_ready()
        elapsed = time.perf_counter() - t0
        self.metrics.record(dt if dt is not None else elapsed)
        return image

    # -- dynamic state (reference VoxelRT update methods) ------------------------

    def update_sun(self, dt: float) -> None:
        """Advance the sun animation (VoxelRT.zig:80-83)."""
        self.sun.update(dt)

    def flush_grid(self, grid: BrickGrid) -> None:
        """Full scene re-upload from a host BrickGrid (the reference's
        debugFlushGrid, VoxelRT.zig:95-104 — there Debug-only; here a
        supported resync path, e.g. after large host-side rebuilds)."""
        assert grid.static == self.grid_static, "grid geometry must match"
        self.arrays = grid.device_arrays()
        self._bricks_upper = int(grid.arrays.active_bricks)
        self._tables = None
        self._dist = None

    def push_materials(self, materials: MaterialTable) -> None:
        """Replace the material table (VoxelRT.zig:85-88)."""
        self.materials_host = materials
        self.mats = trace_mod.materials_to_device(materials)

    def push_albedo(self, index: int, albedo) -> None:
        """Update one material's albedo (VoxelRT.zig:90-92 pushAlbedo)."""
        self.materials_host.albedo[index] = np.asarray(albedo, dtype=np.float32)
        self.mats = trace_mod.materials_to_device(self.materials_host)

    def set_temporal(self, enabled: bool) -> None:
        """Toggle temporal accumulation (superset; BASELINE config 4)."""
        self.temporal_enabled = bool(enabled)
        self._accum = None
        self._accum_count = 0

    def set_denoiser(self, **knobs) -> None:
        """Tune denoiser push constants (Pipeline.zig:543-557 setters)."""
        import dataclasses as dc

        self.denoiser = dc.replace(self.denoiser, **knobs)

    def set_resolutions(self, internal: Optional[Tuple[int, int]] = None,
                        output: Optional[Tuple[int, int]] = None) -> None:
        """Rescale (the swapchain-rebuild analog, Pipeline.zig:657-710):
        new static shapes mean a new cached jit trace."""
        if internal is not None:
            iw, ih = internal
            self.internal_resolution = (int(iw), int(ih))
            cam_cfg = self.config.camera
            old = self.camera
            self.camera = Camera(self.VFOV_DEGREES, iw, ih, cam_cfg)
            # preserve pose
            self.camera.yaw = old.yaw
            self.camera.pitch = old.pitch
            self.camera.d_camera.origin = old.d_camera.origin
            self.camera.d_camera.samples_per_pixel = old.d_camera.samples_per_pixel
            self.camera.d_camera.max_bounce = old.d_camera.max_bounce
            self.camera.propagate_pitch_change()
            self.metrics.rays_per_frame = (
                int(iw) * int(ih) * int(self.camera.d_camera.samples_per_pixel))
        if output is not None:
            self.output_resolution = (int(output[0]), int(output[1]))

    # -- voxel edits (reference C4 call stack) -----------------------------------

    _EDIT_PAD = 1024

    def _cells_of(self, xyz: np.ndarray) -> np.ndarray:
        """Grid cell ids (Y-flipped, Grid.zig:135/:206-211) for a batch."""
        st = self.grid_static
        fy = (st.voxel_dims[1] - 1) - xyz[:, 1]
        return (xyz[:, 0] // 4 + st.dim_x * ((xyz[:, 2] // 4)
                                             + st.dim_z * (fy // 4))).astype(np.int32)

    def _padded(self, n: int) -> int:
        size = self._EDIT_PAD
        while size < n:
            size *= 2
        return size

    def insert_voxels(self, xyz, material_index) -> None:
        """Functional device-side voxel inserts (the updateGridDelta analog,
        VoxelRT.zig:107-172). Batches are padded to canonical sizes so
        repeated edits reuse one jit trace; arrays are donated so XLA
        updates HBM in place."""
        xyz = np.atleast_2d(np.asarray(xyz, dtype=np.int32))
        mats = np.asarray(material_index, dtype=np.uint8).ravel()
        n = xyz.shape[0]
        # capacity guard: each distinct touched cell can allocate at most
        # one brick; apply_edits drops overflowing scatters silently
        # (mode='drop'), so raise BEFORE a batch could exhaust the
        # allocation. The cheap bound assumes every touched cell is new;
        # only when it trips do we pay a device read for the precise count
        # (which cells are actually unloaded).
        st = self.grid_static
        uniq_cells = np.unique(self._cells_of(xyz))
        if self._bricks_upper + uniq_cells.size > st.brick_alloc:
            statuses = np.asarray(jax.device_get(self.arrays.statuses))
            loaded = (statuses[uniq_cells // 32]
                      >> (uniq_cells % 32).astype(np.uint32)) & 1
            actually_new = int((loaded == 0).sum())
            active = int(jax.device_get(self.arrays.active_bricks))
            if active + actually_new > st.brick_alloc:
                raise MemoryError(
                    f"brick allocation exhausted: {active} active "
                    f"+ {actually_new} new > brick_alloc={st.brick_alloc}")
            self._bricks_upper = active + actually_new
        else:
            self._bricks_upper += uniq_cells.size
        size = self._padded(n)
        pad_xyz = np.zeros((size, 3), dtype=np.int32)
        pad_xyz[:n] = xyz
        pad_mat = np.zeros(size, dtype=np.uint8)
        pad_mat[:n] = mats
        valid = np.zeros(size, dtype=bool)
        valid[:n] = True
        if self._edit_step is None:
            self._edit_step = jax.jit(
                apply_edits, static_argnums=0, donate_argnums=1)
        with profiling.zone("edit_insert"):
            self.arrays = self._edit_step(
                self.grid_static, self.arrays, jnp.asarray(pad_xyz),
                jnp.asarray(pad_mat), jnp.asarray(valid),
                jnp.asarray(self.materials_host.mtype == 2),
                jnp.asarray(self.materials_host.type_data))
        if self._tables is not None:
            # incremental maintenance (the reference's dirty-range delta
            # protocol, State.zig:14-57): scatter the touched cells' rows
            # + refresh the skip-distance lane; no full table rebuild
            with profiling.zone("refresh_tables_insert"):
                self._tables, self._dist = self._refresh_insert_fn(
                    self.grid_static, self.arrays, self._tables,
                    jnp.asarray(self._cells_of(pad_xyz)), jnp.asarray(valid))

    def remove_voxels(self, xyz) -> None:
        """Functional voxel removal (superset; BASELINE config 3)."""
        xyz = np.atleast_2d(np.asarray(xyz, dtype=np.int32))
        n = xyz.shape[0]
        size = self._padded(n)
        pad_xyz = np.zeros((size, 3), dtype=np.int32)
        pad_xyz[:n] = xyz
        valid = np.zeros(size, dtype=bool)
        valid[:n] = True
        if self._remove_step is None:
            self._remove_step = jax.jit(
                remove_edits, static_argnums=0, donate_argnums=1)
        with profiling.zone("edit_remove"):
            self.arrays = self._remove_step(
                self.grid_static, self.arrays, jnp.asarray(pad_xyz),
                jnp.asarray(valid))
        if self._tables is not None:
            # removals never free bricks (statuses untouched), so the
            # cached skip field stays valid; only touched rows change
            self._tables = self._refresh_remove_fn(
                self.grid_static, self.arrays, self._tables, self._dist,
                jnp.asarray(self._cells_of(pad_xyz)), jnp.asarray(valid))

    # -- benchmark (reference VoxelRT.createBenchmark, VoxelRT.zig:72-74) --------

    def create_benchmark(self, duration: float = 60.0) -> Benchmark:
        return Benchmark(self.camera, self.grid_static,
                         bool(self.sun.device_data.enabled), duration=duration)

    def run_benchmark(self, duration: float = 60.0,
                      max_frames: Optional[int] = None,
                      verbose: bool = True,
                      fixed_dt: Optional[float] = None) -> Benchmark:
        """Run the fly-through to completion (ImguiGui.zig:154-163 loop).

        `fixed_dt`: advance the benchmark path by this fixed virtual dt
        per frame instead of wall time — the full 60-second path is then
        covered in duration/fixed_dt frames regardless of hardware speed,
        while the report records MEASURED frame times (round-2 verdict
        item 7: the full-length report must say how many frames back it)."""
        bench = self.create_benchmark(duration)
        self.render().block_until_ready()  # warm the jit cache outside timing
        frames = 0
        prev = time.perf_counter()
        done = False
        while not done and (max_frames is None or frames < max_frames):
            now = time.perf_counter()
            dt = now - prev
            prev = now
            path_dt = fixed_dt if fixed_dt is not None else dt
            self.update_sun(path_dt)
            self.draw(dt)
            # frame 0's dt is the microseconds since `prev` was set, not a
            # rendered-frame time — recording it would print a ~0 ms Min
            # in the report; skip its sample (the reference's first frame
            # is likewise warm-up noise)
            done = bench.update(path_dt if frames > 0 else 1e-3,
                                record_dt=dt if frames > 0 else -1.0)
            frames += 1
        self.camera.reset()
        if verbose:
            bench.print_report(device_name())
        return bench

    # -- scene save/load (superset feature; SURVEY.md §5.4) ----------------------

    def save_scene(self, path: str) -> None:
        from ..io.scene_io import save_scene

        save_scene(path, self.grid_static, self.arrays, self.materials_host)

    def device_image_to_host(self, image) -> np.ndarray:
        return np.asarray(image)


def device_name() -> str:
    d = jax.devices()[0]
    return f"{d.device_kind} ({d.platform})"

