"""Multi-chip framebuffer-tile sharding.

The reference is strictly single-GPU (SURVEY.md §2b: "Multi-device: none");
this build's scaling axis is the framebuffer: shard tiles (rows) across
devices with the scene arrays replicated, gathering only at image assembly.

Design: rays are embarrassingly parallel and the scene is read-only, so the
trace runs under `jax.shard_map` with every scene input replicated (P())
and the output image partitioned over rows (P("tiles")). Each shard derives
its row band from `lax.axis_index`. XLA inserts the final all-gather when
the host consumes the image; the post-process (denoiser) runs on the
row-sharded image and its static shifted slices become halo exchanges
between devices, all inside one jitted step.

`dryrun_multichip` (driver contract, __graft_entry__.py) executes a full
sharded render + functional-edit step on an N-device mesh of virtual CPU
devices.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import DenoiserConfig, TraceConfig
from ..core.grid import GridArrays, GridStatic
from ..ops import denoise as denoise_mod
from ..ops import trace as trace_mod

F = jnp.float32

TILE_AXIS = "tiles"


def make_mesh(devices=None) -> Mesh:
    """A 1-D device mesh over framebuffer tiles (rows)."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), axis_names=(TILE_AXIS,))


def replicate_scene(mesh: Mesh, arrays: GridArrays,
                    mats: trace_mod.MaterialsDevice):
    """Place the scene arrays replicated on every device of the mesh."""
    sharding = NamedSharding(mesh, P())
    put = lambda t: jax.device_put(t, sharding)
    return jax.tree_util.tree_map(put, arrays), jax.tree_util.tree_map(put, mats)


def build_sharded_step(mesh: Mesh, static: GridStatic, *,
                       width: int, height: int, spp: int, max_bounce: int,
                       sun_enabled: bool,
                       out_width: Optional[int] = None,
                       out_height: Optional[int] = None,
                       denoiser: DenoiserConfig = DenoiserConfig(),
                       trace_config: TraceConfig = TraceConfig()):
    """Build a jitted multi-device render step.

    Returns step(arrays, mats, cam, sun_position, sun_color, sun_radius,
    tables=None) -> f32[out_h, out_w, 3] (row-sharded on the mesh)."""
    n = mesh.devices.size
    if height % n != 0:
        raise ValueError(f"internal height {height} must divide the mesh size {n}")
    rows = height // n
    out_w = out_width or width
    out_h = out_height or height

    def trace_shard(arrays, tables, mats, cam, sun_position, sun_color,
                    sun_radius):
        tile = jax.lax.axis_index(TILE_AXIS)
        row0 = (tile * rows).astype(F)
        return trace_mod.render_rows(
            static, arrays, mats, cam, width, height, spp, max_bounce,
            sun_position, sun_color, sun_radius, sun_enabled,
            row0=row0, rows=rows, max_steps=trace_config.max_steps,
            tables=tables, use_skip=trace_config.empty_skip,
            row_bands=trace_config.row_bands)

    # the DDA while_loop seeds its carries from the (tile-varying) ray
    # direction arrays so the varying-manual-axes checker accepts them
    # (see _grid_hit_soa)
    sharded_trace = jax.shard_map(
        trace_shard, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(), P()),
        out_specs=P(TILE_AXIS),
    )

    @jax.jit
    def step(arrays, mats, cam, sun_position, sun_color, sun_radius,
             tables=None):
        if tables is None:
            # caller didn't pass cached tables: build in-step (one-shot
            # convenience paths); engines/benchmarks pass the cache so the
            # per-frame cost is the trace alone
            tables = trace_mod.build_trace_tables(static, arrays)
        img = sharded_trace(arrays, tables, mats, cam,
                            sun_position, sun_color, sun_radius)
        if denoiser.enabled:
            return denoise_mod.denoise(
                img, samples=int(denoiser.samples),
                distribution_bias=denoiser.distribution_bias,
                pixel_multiplier=denoiser.pixel_multiplier,
                inverse_hue_tolerance=denoiser.inverse_hue_tolerance,
                out_shape=(out_h, out_w))
        return denoise_mod.bilinear_resample(img, out_h, out_w)

    return step


def render_image_sharded(mesh: Mesh, static: GridStatic, arrays: GridArrays,
                         mats: trace_mod.MaterialsDevice, camera_device,
                         sun_device, *, sun_enabled: Optional[bool] = None,
                         denoiser: DenoiserConfig = DenoiserConfig(enabled=False),
                         trace_config: TraceConfig = TraceConfig(),
                         out_size: Optional[tuple] = None):
    """Convenience one-shot sharded render from host camera/sun state."""
    d = camera_device
    ow, oh = out_size if out_size is not None else (None, None)
    step = build_sharded_step(
        mesh, static,
        width=int(d.image_width), height=int(d.image_height),
        spp=int(d.samples_per_pixel), max_bounce=int(d.max_bounce),
        sun_enabled=bool(sun_device.enabled if sun_enabled is None else sun_enabled),
        out_width=ow, out_height=oh,
        denoiser=denoiser, trace_config=trace_config)
    arrays_r, mats_r = replicate_scene(mesh, arrays, mats)
    return step(
        arrays_r, mats_r, trace_mod.camera_vectors(d),
        jnp.asarray(sun_device.position, dtype=F),
        jnp.asarray(sun_device.color, dtype=F),
        jnp.asarray(sun_device.radius, dtype=F),
    )
