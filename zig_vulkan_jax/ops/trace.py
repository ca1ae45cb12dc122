"""Wavefront ray tracer (the core compute path).

A JAX re-design of the reference's per-pixel megakernel (reference:
assets/shaders/brick_raytracer.comp). The GLSL kernel runs one thread per
pixel with divergent nested while-loops; here the whole frame is traced as
a *wavefront*: every ray is one lane of large arrays, and the two nested
DDA loops (grid level, brick_raytracer.comp:313-373; brick level,
:407-468) are flattened into a single `lax.while_loop` state machine with a
per-ray `level` flag — each iteration advances every active ray by exactly
one DDA step at its current level.

Design decisions:

1. **SoA lanes.** All ray state is kept as separate (N,) component arrays,
   never (N, 3), so every elementwise op reads contiguous memory.

2. **Gather minimization.** Per DDA step the traversal performs exactly
   ONE gather at grid level (a merged cell -> record table with an EMPTY
   sentinel, replacing the reference's separate status-bit + index
   fetches, State.zig:86-109) and ZERO at brick level: a brick's two
   32-bit occupancy words and its material-window start are fetched once
   at brick *entry*, after which every voxel test is a lane-local select
   + bit test. The material byte is gathered once per traversal, after
   the loop.

3. Semantics follow the GLSL bit-for-bit where float evaluation allows
   (epsilon offsets :287/:332/:431-433, DDA tie-breaking :345-372, the
   same-dielectric skip :427, `color/(color+1)` tone map :264, sqrt gamma
   :176); zig_vulkan_jax.oracle.cpu_tracer is the independent CPU oracle
   these semantics are tested against.

Sharding: per-ray arrays are embarrassingly parallel along the ray axis and
the scene tables are replicated, so the same function runs on one device or
row-sharded over a device mesh (zig_vulkan_jax.parallel.mesh).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..config import BRICK_DIMENSION, BRICK_WORDS, TraceConfig
from ..core.grid import GridArrays, GridStatic
from ..core.materials import (
    MAT_DIELECTRIC,
    MAT_EMISSIVE,
    MAT_LAMBERTIAN,
    MAT_METAL,
    MAT_NONE,
    MaterialTable,
)
from . import rng

F = jnp.float32
_BD = BRICK_DIMENSION
# NB: a *numpy* scalar, deliberately: `jnp.uint32(...)` at module import
# would create device state, and no module import may touch the device.
_EMPTY = np.uint32(0xFFFFFFFF)


@dataclasses.dataclass
class MaterialsDevice:
    """SoA material table on device (see core.materials)."""

    mtype: Any       # int32[256]
    albedo: Any      # f32[256, 3]
    type_data: Any   # f32[256]

    @property
    def info(self):
        """Packed per-material {type, bitcast(type_data)} rows — ONE gather
        fetches both fields needed by the dielectric skip test."""
        return jnp.stack(
            [self.mtype, jax.lax.bitcast_convert_type(self.type_data, jnp.int32)],
            axis=-1)


jax.tree_util.register_dataclass(
    MaterialsDevice, data_fields=["mtype", "albedo", "type_data"], meta_fields=[]
)


def materials_to_device(table: MaterialTable) -> MaterialsDevice:
    return MaterialsDevice(
        mtype=jnp.asarray(table.mtype, dtype=jnp.int32),
        albedo=jnp.asarray(table.albedo, dtype=F),
        type_data=jnp.asarray(table.type_data, dtype=F),
    )


# -- small SoA vector helpers ---------------------------------------------------

def _split3(v):
    return v[:, 0], v[:, 1], v[:, 2]


def _norm3(x, y, z):
    inv = jax.lax.rsqrt(x * x + y * y + z * z)
    return x * inv, y * inv, z * inv


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def safe_inverse(v):
    """GLSL safeInverse (brick_raytracer.comp:267-268)."""
    return jnp.where(v == 0.0, F(1e12), F(1.0) / v)


DIST_CAP = 31  # max encoded empty-space Chebyshev radius

# Distance-field accuracy/op-count tradeoff (see _distance_field): exact
# for Chebyshev distances <= _DF_EXACT_RADIUS, then doubled windows whose
# floor penalty (prev radius + 1) guarantees the value never exceeds the
# true distance. (radius, floor) with floor = previous radius + 1.
_DF_EXACT_RADIUS = 3
_DF_LEVELS = ((6, 4), (12, 7), (24, 13), (DIST_CAP - 1, 25))


def _distance_field(static: GridStatic, loaded, exact: bool = False):
    """Chebyshev distance-to-nearest-loaded-cell, capped at DIST_CAP.

    The reference leaves hierarchical acceleration as a TODO
    (brick_raytracer.comp:145 "higher level grid optimization"); the DDA
    uses this field to leap D-1 cells of empty space per lookup instead of
    stepping cell by cell.

    The L-inf distance transform is separable into three sequential 1-D
    passes — dist(p) = min_q max(|dy|,|dz|,|dx|) factors because `min` over
    one axis commutes with `max` against terms independent of that axis:
        h1(y,z,x) = min_{|k|<=C} max(h0(y,z,x+k), |k|)   (h0 = 0/CAP mask)
        h2, h3 likewise along z and y.
    Evaluating every k exactly costs 2*DIST_CAP shifted ops per axis, so
    the far field uses doubled windowed-mins with floor penalties instead:

        candidate(radius r, prev radius rp) = max(window_min_r, rp + 1)

    For a 1-D argmin at offset |k| in (rp, r], window_min_r <= h(x+k) and
    rp+1 <= |k|, so the candidate never exceeds the true transform — the
    field only ever UNDERestimates (safe: a skip of dist-1 cells can never
    jump past geometry), exactly for distances <= _DF_EXACT_RADIUS and by
    at most ~2x beyond: ~135 fused elementwise ops in total.
    """
    vol = loaded.reshape(static.dim_y, static.dim_z, static.dim_x)
    dist = jnp.where(vol, jnp.int32(0), jnp.int32(DIST_CAP))

    # exact=True evaluates every offset (3x the ops): used at scene build where the cost is paid once and larger
    # skip radii cut steady-state DDA iterations; edits use the fast
    # conservative build
    exact_r = DIST_CAP - 1 if exact else _DF_EXACT_RADIUS
    levels = () if exact else _DF_LEVELS

    def shifted(p, axis, off, shape):
        sl = [slice(None)] * 3
        sl[axis] = slice(off[0], off[0] + shape[axis])
        return p[tuple(sl)]

    def axis_pass(d, axis):
        out = d
        pad_width = [(0, 0)] * 3
        pad_width[axis] = (exact_r, exact_r)
        p = jnp.pad(d, pad_width, constant_values=DIST_CAP)
        w = d  # windowed min, radius grows as we go
        for k in range(1, exact_r + 1):
            left = shifted(p, axis, (exact_r - k,), d.shape)
            right = shifted(p, axis, (exact_r + k,), d.shape)
            near = jnp.minimum(left, right)
            out = jnp.minimum(out, jnp.maximum(near, k))
            w = jnp.minimum(w, near)
        prev_r = exact_r
        for r, floor in levels:
            step = r - prev_r
            pad_width[axis] = (step, step)
            pw = jnp.pad(w, pad_width, constant_values=DIST_CAP)
            w = jnp.minimum(
                w, jnp.minimum(shifted(pw, axis, (0,), d.shape),
                               shifted(pw, axis, (2 * step,), d.shape)))
            out = jnp.minimum(out, jnp.maximum(w, floor))
            prev_r = r
        return out

    for axis in (2, 1, 0):
        dist = axis_pass(dist, axis)
    return dist.reshape(-1)


def distance_field(static: GridStatic, arrays: GridArrays,
                   exact: bool = False):
    """Standalone skip-field build (see _distance_field). The field depends
    only on which CELLS are loaded (statuses), not on voxel contents, so
    edits that cannot allocate or free bricks (e.g. removals) can reuse a
    cached field and rebuild only the cheap record gathers."""
    cells = jnp.arange(static.cells, dtype=jnp.uint32)
    bits = arrays.statuses[(cells // 32).astype(jnp.int32)]
    loaded = ((bits >> (cells % 32)) & jnp.uint32(1)) == 1
    return _distance_field(static, loaded, exact=exact)


def build_trace_tables(static: GridStatic, arrays: GridArrays, dist=None):
    """Per-cell traversal records: int32[cells, 8] rows of
    {material window start (or -1 = empty cell), occupancy word 0,
    occupancy word 1, empty-space Chebyshev skip distance,
    dielectric-mask word 0, dielectric-mask word 1, bitcast brick ir, 0}.

    This fuses everything the traversal needs per grid cell — the
    reference's separate status-bit, brick-index, occupancy, and
    start-index fetches (State.zig:86-127) — into ONE row gather at brick
    entry, and makes every in-brick voxel test gather-free (occupancy and
    dielectric bits ride in lane-local registers; the row is 32 bytes, one
    memory sector, so the extra lanes cost no extra transaction). Lane 3 carries
    the distance field driving empty-space skipping (_distance_field);
    lanes 4-6 carry the per-brick dielectric data evaluating the
    same-material skip rule (brick_raytracer.comp:427) without per-voxel
    material gathers — exact unless a brick mixes dielectrics with
    different ir (then brick_ir is NaN and nothing in that brick is
    skipped; see core.grid.GridArrays).

    Depends only on the scene, not the camera: the engine caches it across
    frames and rebuilds after edits.
    """
    cells = jnp.arange(static.cells, dtype=jnp.uint32)
    bits = arrays.statuses[(cells // 32).astype(jnp.int32)]
    loaded = ((bits >> (cells % 32)) & jnp.uint32(1)) == 1
    brick = jnp.where(loaded, arrays.indices, jnp.uint32(0)).astype(jnp.int32)
    occ2 = arrays.occupancy.reshape(static.brick_alloc, BRICK_WORDS)
    occ_rows = occ2[brick]
    diel2 = arrays.diel_mask.reshape(static.brick_alloc, BRICK_WORDS)
    diel_rows = diel2[brick]
    ir_bits = jax.lax.bitcast_convert_type(arrays.brick_ir[brick], jnp.int32)
    start = arrays.start_indices[brick]
    start = jnp.where(loaded, start, _EMPTY)
    # cell index space is x + dim_x*(z + dim_z*y) -> volume (y, z, x)
    if dist is None:
        dist = _distance_field(static, loaded)
    return jnp.stack(
        [start.astype(jnp.int32),
         occ_rows[:, 0].astype(jnp.int32),
         occ_rows[:, 1].astype(jnp.int32),
         dist,
         diel_rows[:, 0].astype(jnp.int32),
         diel_rows[:, 1].astype(jnp.int32),
         ir_bits,
         jnp.zeros_like(dist)],
        axis=-1)


def _rows_for_cells(static: GridStatic, arrays: GridArrays, cells, dist_rows):
    """Traversal records for a subset of cells (same layout as
    build_trace_tables rows). `cells` int32[K] (clipped), `dist_rows`
    int32[K] skip distances for those cells."""
    cells_u = cells.astype(jnp.uint32)
    bits = arrays.statuses[(cells_u // 32).astype(jnp.int32)]
    loaded = ((bits >> (cells_u % 32)) & jnp.uint32(1)) == 1
    brick = jnp.where(loaded, arrays.indices[cells], jnp.uint32(0)).astype(jnp.int32)
    occ2 = arrays.occupancy.reshape(static.brick_alloc, BRICK_WORDS)
    occ_rows = occ2[brick]
    diel2 = arrays.diel_mask.reshape(static.brick_alloc, BRICK_WORDS)
    diel_rows = diel2[brick]
    ir_bits = jax.lax.bitcast_convert_type(arrays.brick_ir[brick], jnp.int32)
    start = arrays.start_indices[brick]
    start = jnp.where(loaded, start, _EMPTY)
    return jnp.stack(
        [start.astype(jnp.int32),
         occ_rows[:, 0].astype(jnp.int32),
         occ_rows[:, 1].astype(jnp.int32),
         dist_rows,
         diel_rows[:, 0].astype(jnp.int32),
         diel_rows[:, 1].astype(jnp.int32),
         ir_bits,
         jnp.zeros_like(dist_rows)],
        axis=-1)


def refresh_tables_after_insert(static: GridStatic, arrays: GridArrays,
                                tables, cells, valid):
    """Incrementally maintain cached trace tables after an insert batch.

    The reference streams min/max dirty ranges to the GPU after edits
    (State.zig:14-57, VoxelRT.zig:107-172); the analog here: only the
    touched cells' records change (start/occupancy/dielectric data), plus
    the global skip-distance lane (inserts can load new cells, lowering
    distances anywhere within DIST_CAP). The distance field is rebuilt in
    full — it is a handful of fused vector passes (see _distance_field) —
    and scattered into lane 3; the K touched rows are re-gathered and
    scattered. Returns (tables, dist).
    """
    dist = distance_field(static, arrays)
    tables = tables.at[:, 3].set(dist)
    safe = jnp.clip(cells, 0, static.cells - 1)
    rows = _rows_for_cells(static, arrays, safe, dist[safe])
    tables = tables.at[jnp.where(valid, safe, static.cells)].set(
        rows, mode="drop")
    return tables, dist


def refresh_tables_after_remove(static: GridStatic, arrays: GridArrays,
                                tables, dist, cells, valid):
    """Incremental table maintenance after removals: statuses never change
    (bricks are not freed), so the cached skip field stays valid; only the
    touched cells' occupancy/dielectric rows are re-gathered."""
    safe = jnp.clip(cells, 0, static.cells - 1)
    rows = _rows_for_cells(static, arrays, safe, dist[safe])
    tables = tables.at[jnp.where(valid, safe, static.cells)].set(
        rows, mode="drop")
    return tables


@partial(jax.jit, static_argnames=("static", "max_steps", "use_skip",
                                   "bounded_t", "needs_ignore",
                                   "brick_unroll"))
def grid_hit(static: GridStatic, arrays: GridArrays, mats: MaterialsDevice,
             origin, direction, t_max, ignore_type, internal_reflection,
             active, max_steps: int = 768, tables=None,
             use_skip: bool = False, bounded_t: bool = True,
             needs_ignore: bool = True, brick_unroll: int = 4):
    """Two-level DDA traversal for a wavefront of rays (GLSL GridHit +
    BrickHit, brick_raytracer.comp:271-471) — SoA, gather-minimized.

    Args:
      origin, direction: f32[N, 3] (direction normalized).
      t_max: f32[] scalar upper bound.
      ignore_type, internal_reflection: per-ray dielectric-skip state.
      active: bool[N] lanes to trace.
      max_steps: static bound on total DDA steps per ray.
      tables: optional cached build_trace_tables(static, arrays).

    Returns dict(found, t, point f32[N,3], normal f32[N,3], index).
    """
    ox, oy, oz = _split3(origin)
    dx, dy, dz = _split3(direction)
    out = _grid_hit_soa(static, arrays, mats, ox, oy, oz, dx, dy, dz,
                        jnp.asarray(t_max, dtype=F), ignore_type,
                        internal_reflection, active, max_steps, tables,
                        use_skip, bounded_t, needs_ignore, brick_unroll)
    return dict(
        found=out["found"],
        t=out["t"],
        point=jnp.stack([out["px"], out["py"], out["pz"]], axis=-1),
        normal=jnp.stack([out["nx"], out["ny"], out["nz"]], axis=-1),
        index=out["index"],
    )


def _grid_hit_soa(static, arrays, mats, ox, oy, oz, dx, dy, dz, t_max,
                  ignore_type, internal_reflection, active, max_steps,
                  tables=None, use_skip=False, bounded_t=True,
                  needs_ignore=True, brick_unroll=4):
    # bounded_t=False drops the per-ray `global_t` carry: every RayColor
    # call passes t_max = +inf (brick_raytracer.comp:218, :247), making the
    # GLSL `global_t_value <= t_max` check (:316) vacuous.
    n = ox.shape[0]
    gx0, gy0, gz0 = (F(v) for v in static.min_point)
    gx1, gy1, gz1 = (F(v) for v in static.max_point)
    scale = F(static.scale)
    voxel_scale = F(static.scale / _BD)
    dim_x, dim_y, dim_z = static.dims
    t_min = F(1e-5)

    if tables is None:
        tables = build_trace_tables(static, arrays)

    ix = safe_inverse(dx)
    iy = safe_inverse(dy)
    iz = safe_inverse(dz)

    # slab entry with normal (AdvNormIntersect, brick_raytracer.comp:522-536)
    tlx, tux = (gx0 - ox) * ix, (gx1 - ox) * ix
    tly, tuy = (gy0 - oy) * iy, (gy1 - oy) * iy
    tlz, tuz = (gz0 - oz) * iz, (gz1 - oz) * iz
    tminx, tmaxx = jnp.minimum(tlx, tux), jnp.maximum(tlx, tux)
    tminy, tmaxy = jnp.minimum(tly, tuy), jnp.maximum(tly, tuy)
    tminz, tmaxz = jnp.minimum(tlz, tuz), jnp.maximum(tlz, tuz)
    # indexOfMaxComponent tie-breaking (brick_raytracer.comp:501-503)
    is_y = (tminy > tminx) & (tminy > tminz)
    is_z = (tminz > tminx) & (tminz > tminy)
    is_x = ~(is_y | is_z)
    entry_tmin = jnp.where(is_x, tminx, jnp.where(is_y, tminy, tminz))
    grid_t_min = jnp.maximum(t_min, entry_tmin)
    grid_t_max = jnp.minimum(t_max, jnp.minimum(tmaxx, jnp.minimum(tmaxy, tmaxz)))
    slab_ok = grid_t_min <= grid_t_max

    # DDA constants
    adx, ady, adz = jnp.abs(ix), jnp.abs(iy), jnp.abs(iz)
    stx = jnp.sign(dx).astype(jnp.int32)
    sty = jnp.sign(dy).astype(jnp.int32)
    stz = jnp.sign(dz).astype(jnp.int32)
    stxf, styf, stzf = stx.astype(F), sty.astype(F), stz.astype(F)

    # grid-level DDA (re-)init (brick_raytracer.comp:287-311): derives the
    # DDA cursor from the ray position at t_base + 1e-4*scale. Used at slab
    # entry and again after every empty-space skip jump.
    def grid_init(t_base):
        t0 = t_base + F(1e-4) * scale
        fpx = (ox + dx * t0 - gx0) / scale
        fpy = (oy + dy * t0 - gy0) / scale
        fpz = (oz + dz * t0 - gz0) / scale
        sx = (stxf * (jnp.floor(fpx) - fpx) + (stxf * F(0.5) + F(0.5))) * adx
        sy = (styf * (jnp.floor(fpy) - fpy) + (styf * F(0.5) + F(0.5))) * ady
        sz = (stzf * (jnp.floor(fpz) - fpz) + (stzf * F(0.5) + F(0.5))) * adz
        lx = jnp.floor(fpx).astype(jnp.int32)
        ly = jnp.floor(fpy).astype(jnp.int32)
        lz = jnp.floor(fpz).astype(jnp.int32)
        return sx, sy, sz, lx, ly, lz

    sx0, sy0, sz0, lx0, ly0, lz0 = grid_init(grid_t_min)
    global_t0 = grid_t_min + F(1e-4) * scale
    # safe Chebyshev advance per unit D (normalized dir: max |component|)
    inv_max_abs_d = F(1.0) / jnp.maximum(jnp.abs(dx),
                                         jnp.maximum(jnp.abs(dy), jnp.abs(dz)))

    # normal encoding: 0 +-x by sign of inv_dir (slab), 1..6 = -x,+x,-y,+y,-z,+z
    # is overkill — encode axis (0,1,2) + sign bit (4): decode post-loop
    slab_code = jnp.where(
        is_x, jnp.where(ix >= 0, 0, 4),
        jnp.where(is_y, jnp.where(iy >= 0, 1, 5),
                  jnp.where(iz >= 0, 2, 6))).astype(jnp.int32)
    step_code_x = jnp.where(stx < 0, 0, 4)  # normal +x when stepping -x
    step_code_y = jnp.where(sty < 0, 1, 5)
    step_code_z = jnp.where(stz < 0, 2, 6)

    # carry seeds derive from the (per-shard varying) ray arrays rather
    # than plain constants: under shard_map the varying-manual-axes checker
    # requires while_loop carries to enter the loop already marked varying
    # (they become varying through the body), and `x * 0` / `x ^ x` keeps
    # the varying type where jnp.zeros would not
    # (the ray ORIGIN is a replicated broadcast under shard_map; the
    # directions vary per row shard, so derive the seeds from those)
    zf = (dx + dy) * F(0.0)
    zi = (stx + sty) ^ (stx + sty)
    zu = zi.astype(jnp.uint32)
    zb = zi != zi
    state = dict(
        running=active & slab_ok,
        in_brick=zb,
        lx=lx0, ly=ly0, lz=lz0,
        sx=sx0, sy=sy0, sz=sz0,
        t_base=grid_t_min,
        t_value=zf,
        ncode=slab_code,
        blx=zi, bly=zi, blz=zi,
        bsx=zf, bsy=zf, bsz=zf,
        b_t=zf,
        entry_t=zf,
        occ_lo=zu,
        occ_hi=zu,
        mat_start=zi,
        bminx=zf, bminy=zf, bminz=zf,
        local_t_max=zf,
        found=zb,
        out_t=zf,
        out_addr=zi,
        step=jnp.int32(0),
    )
    if needs_ignore:
        state["dmask_lo"] = zu
        state["dmask_hi"] = zu
        state["brick_key"] = zf + F(jnp.nan)
    if bounded_t:
        state["global_t"] = global_t0
    # per-ray dielectric skip key: the rule only ever triggers for
    # refracted rays (ignore_type == MAT_DIELECTRIC); NaN never compares
    # equal, so non-refracted rays skip nothing
    ray_key = jnp.where(ignore_type == MAT_DIELECTRIC, internal_reflection,
                        jnp.full(n, jnp.nan, dtype=F))

    def cond(s):
        return jnp.any(s["running"]) & (s["step"] < max_steps)

    def body(s):
        running = s["running"]
        in_brick = s["in_brick"]

        # ---------------- grid level: cell check ----------------
        g = running & ~in_brick
        in_b_g = ((s["lx"] >= 0) & (s["lx"] < dim_x)
                  & (s["ly"] >= 0) & (s["ly"] < dim_y)
                  & (s["lz"] >= 0) & (s["lz"] < dim_z))
        if bounded_t:
            in_b_g = in_b_g & (s["global_t"] <= t_max)
        g_miss = g & ~in_b_g
        g_act = g & in_b_g

        cell = s["lx"] + dim_x * (s["lz"] + dim_z * s["ly"])
        cell_c = jnp.clip(cell, 0, static.cells - 1)
        rec = tables[cell_c]            # THE grid-phase gather (one row)
        start_raw = rec[:, 0]
        enter = g_act & (start_raw != -1)

        occ_lo = jnp.where(
            enter, jax.lax.bitcast_convert_type(rec[:, 1], jnp.uint32),
            s["occ_lo"])
        occ_hi = jnp.where(
            enter, jax.lax.bitcast_convert_type(rec[:, 2], jnp.uint32),
            s["occ_hi"])
        mat_start = jnp.where(enter, start_raw & jnp.int32(0x7FFFFFFF),
                              s["mat_start"])
        if needs_ignore:
            dmask_lo = jnp.where(
                enter, jax.lax.bitcast_convert_type(rec[:, 4], jnp.uint32),
                s["dmask_lo"])
            dmask_hi = jnp.where(
                enter, jax.lax.bitcast_convert_type(rec[:, 5], jnp.uint32),
                s["dmask_hi"])
            brick_key = jnp.where(
                enter, jax.lax.bitcast_convert_type(rec[:, 6], F),
                s["brick_key"])

        # empty-space skip: leap D-1 cells and re-derive the DDA cursor
        if use_skip:
            dist = rec[:, 3]
            do_skip = g_act & ~enter & (dist >= 2)
            cur_t = s["t_base"] + F(1e-4) * scale + s["t_value"]
            new_base = cur_t + (dist.astype(F) - F(1.0)) * scale * inv_max_abs_d
            t_base = jnp.where(do_skip, new_base, s["t_base"])
            rsx, rsy, rsz, rlx, rly, rlz = grid_init(t_base)
        else:
            do_skip = jnp.zeros_like(g_act)
            t_base = s["t_base"]

        bminx = jnp.where(enter, s["lx"].astype(F) * scale + gx0, s["bminx"])
        bminy = jnp.where(enter, s["ly"].astype(F) * scale + gy0, s["bminy"])
        bminz = jnp.where(enter, s["lz"].astype(F) * scale + gz0, s["bminz"])
        new_global_t = s["t_value"] + s["t_base"] + F(0.01) * scale
        entry_t = jnp.where(enter, new_global_t, s["entry_t"])

        # brick-level DDA init on entry (brick_raytracer.comp:389-405)
        bfx = (ox + dx * entry_t - bminx) / voxel_scale
        bfy = (oy + dy * entry_t - bminy) / voxel_scale
        bfz = (oz + dz * entry_t - bminz) / voxel_scale
        bsx = jnp.where(enter, (stxf * (jnp.floor(bfx) - bfx)
                                + (stxf * F(0.5) + F(0.5))) * adx, s["bsx"])
        bsy = jnp.where(enter, (styf * (jnp.floor(bfy) - bfy)
                                + (styf * F(0.5) + F(0.5))) * ady, s["bsy"])
        bsz = jnp.where(enter, (stzf * (jnp.floor(bfz) - bfz)
                                + (stzf * F(0.5) + F(0.5))) * adz, s["bsz"])
        blx = jnp.where(enter, jnp.floor(bfx).astype(jnp.int32), s["blx"])
        bly = jnp.where(enter, jnp.floor(bfy).astype(jnp.int32), s["bly"])
        blz = jnp.where(enter, jnp.floor(bfz).astype(jnp.int32), s["blz"])
        b_t = jnp.where(enter, F(0.0), s["b_t"])
        local_t_max = jnp.where(enter, grid_t_max - entry_t, s["local_t_max"])
        in_brick = in_brick | enter

        # ------- brick level: voxel checks (unrolled; gather-free) -------
        # Without the dielectric-skip rule (needs_ignore=False) a voxel test
        # touches only registers, so several brick DDA steps run per
        # while-iteration — each iteration's fixed cost is the grid-phase
        # row gather, which runs for every lane regardless.
        found = s["found"]
        out_t = s["out_t"]
        out_addr = s["out_addr"]
        ncode = s["ncode"]
        b_exit_any = jnp.zeros_like(running)
        t_off = voxel_scale * F(0.05)
        mat_cap = arrays.material_indices.shape[0] - 1

        def adv(sv, lv, delta, st, sel):
            return (jnp.where(sel, sv + delta, sv), jnp.where(sel, lv + st, lv))

        for _u in range(brick_unroll):
            b = running & in_brick
            in_b_b = ((blx >= 0) & (blx < _BD) & (bly >= 0) & (bly < _BD)
                      & (blz >= 0) & (blz < _BD) & (b_t <= local_t_max))
            b_exit = b & ~in_b_b
            in_brick = in_brick & ~b_exit
            b_exit_any = b_exit_any | b_exit
            b_act = b & in_b_b

            vi = blx + _BD * (blz + _BD * bly)
            viu = jnp.clip(vi, 0, _BD ** 3 - 1).astype(jnp.uint32)
            occ_word = jnp.where(viu < 32, occ_lo, occ_hi)
            occ_bit = (occ_word >> (viu % 32)) & jnp.uint32(1)
            vhit = b_act & (occ_bit == 1)
            mat_addr = jnp.clip(mat_start + vi, 0, mat_cap)

            if needs_ignore:
                # same-material skip (brick_raytracer.comp:427) evaluated
                # from the brick's dielectric registers — no gathers
                d_word = jnp.where(viu < 32, dmask_lo, dmask_hi)
                d_bit = (d_word >> (viu % 32)) & jnp.uint32(1)
                ignore = (d_bit == 1) & (brick_key == ray_key)
                real_hit = vhit & ~ignore
            else:
                real_hit = vhit

            hit_t = entry_t + b_t - t_off
            found = found | real_hit
            out_t = jnp.where(real_hit, hit_t, out_t)
            out_addr = jnp.where(real_hit, mat_addr, out_addr)
            running = running & ~real_hit

            brick_steps = b_act & ~real_hit
            bax = (bsx < bsy) & (bsx < bsz)
            bay = ~(bsx < bsy) & (bsy < bsz)
            baz = ~(bax | bay)
            bt_new = jnp.where(bax, bsx, jnp.where(bay, bsy, bsz)) * voxel_scale
            bsx, blx = adv(bsx, blx, adx, stx, brick_steps & bax)
            bsy, bly = adv(bsy, bly, ady, sty, brick_steps & bay)
            bsz, blz = adv(bsz, blz, adz, stz, brick_steps & baz)
            b_t = jnp.where(brick_steps, bt_new, b_t)
            ncode = jnp.where(
                brick_steps,
                jnp.where(bax, step_code_x,
                          jnp.where(bay, step_code_y, step_code_z)),
                ncode)

        # ---------------- grid advance ----------------
        grid_steps = (g_act & ~enter & ~do_skip) | b_exit_any
        running = running & ~g_miss

        gax = (s["sx"] < s["sy"]) & (s["sx"] < s["sz"])
        gay = ~(s["sx"] < s["sy"]) & (s["sy"] < s["sz"])
        gaz = ~(gax | gay)
        gt_new = jnp.where(gax, s["sx"], jnp.where(gay, s["sy"], s["sz"])) * scale
        gsx, glx = adv(s["sx"], s["lx"], adx, stx, grid_steps & gax)
        gsy, gly = adv(s["sy"], s["ly"], ady, sty, grid_steps & gay)
        gsz, glz = adv(s["sz"], s["lz"], adz, stz, grid_steps & gaz)
        t_value = jnp.where(grid_steps, gt_new, s["t_value"])
        ncode = jnp.where(
            grid_steps,
            jnp.where(gax, step_code_x, jnp.where(gay, step_code_y, step_code_z)),
            ncode)
        if use_skip:
            gsx = jnp.where(do_skip, rsx, gsx)
            gsy = jnp.where(do_skip, rsy, gsy)
            gsz = jnp.where(do_skip, rsz, gsz)
            glx = jnp.where(do_skip, rlx, glx)
            gly = jnp.where(do_skip, rly, gly)
            glz = jnp.where(do_skip, rlz, glz)
            t_value = jnp.where(do_skip, F(0.0), t_value)

        out = dict(
            running=running, in_brick=in_brick,
            lx=glx, ly=gly, lz=glz, sx=gsx, sy=gsy, sz=gsz,
            t_base=t_base,
            t_value=t_value, ncode=ncode,
            blx=blx, bly=bly, blz=blz, bsx=bsx, bsy=bsy, bsz=bsz,
            b_t=b_t, entry_t=entry_t, occ_lo=occ_lo, occ_hi=occ_hi,
            mat_start=mat_start, bminx=bminx, bminy=bminy, bminz=bminz,
            local_t_max=local_t_max, found=found, out_t=out_t,
            out_addr=out_addr, step=s["step"] + 1,
        )
        if needs_ignore:
            out["dmask_lo"] = dmask_lo
            out["dmask_hi"] = dmask_hi
            out["brick_key"] = brick_key
        if bounded_t:
            out["global_t"] = jnp.where(enter, new_global_t, s["global_t"])
        return out

    s = jax.lax.while_loop(cond, body, state)

    # decode the normal code: axis = ncode & 3, sign = + if ncode < 4 else -
    code = s["ncode"]
    sign = jnp.where(code < 4, F(1.0), F(-1.0))
    axis = code & 3
    nx = jnp.where(axis == 0, sign, F(0.0))
    ny = jnp.where(axis == 1, sign, F(0.0))
    nz = jnp.where(axis == 2, sign, F(0.0))

    # hit point from the final normal (brick_raytracer.comp:431-433)
    t_off = voxel_scale * F(0.05)
    px = ox + dx * s["out_t"] + nx * t_off
    py = oy + dy * s["out_t"] + ny * t_off
    pz = oz + dz * s["out_t"] + nz * t_off
    # deferred material resolution: one gather for the whole traversal
    index = arrays.material_indices[
        jnp.where(s["found"], s["out_addr"], 0)].astype(jnp.int32)
    return dict(found=s["found"], t=s["out_t"], px=px, py=py, pz=pz,
                nx=nx, ny=ny, nz=nz, index=index)


def transmission_direction(n1, n2, ray_dir, normal):
    """Bec's-method refraction (brick_raytracer.comp:564-574).
    AoS convenience wrapper used by tests."""
    eta = n1 / n2
    c1 = -jnp.sum(ray_dir * normal, axis=-1)
    w = eta * c1
    c2m = (w - eta) * (w + eta)
    should = c2m >= F(-1.0)
    refrac = (eta[:, None] * ray_dir
              + (w - jnp.sqrt(jnp.maximum(F(1.0) + c2m, 0.0)))[:, None] * normal)
    return should, refrac


def background_color(direction):
    """GLSL BackgroundColor (brick_raytracer.comp:197-201)."""
    t = F(0.5) * (direction[:, 1] + F(1.0))
    white = jnp.ones(3, dtype=F)
    blue = jnp.asarray([0.5, 0.7, 1.0], dtype=F)
    return (F(1.0) - t)[:, None] * white + t[:, None] * blue


def _rand_vec3_range_soa(cox, coy, lo, hi):
    """SoA GLSL RandVec3(co, min, max) (rand.comp:15-20)."""
    x = rng.rand2(jnp.stack([cox, coy], axis=-1), xp=jnp)
    x = lo + (hi - lo) * x
    y = rng.rand2(jnp.stack([cox + x, coy + x], axis=-1), xp=jnp)
    y = lo + (hi - lo) * y
    z = rng.rand2(jnp.stack([cox + y, coy + y], axis=-1), xp=jnp)
    z = lo + (hi - lo) * z
    return x, y, z


def ray_color(static: GridStatic, arrays: GridArrays, mats: MaterialsDevice,
              origin, direction, max_bounce: int,
              sun_position, sun_enabled: bool, sun_color, sun_radius,
              max_steps: int = 768, tables=None, use_skip: bool = False):
    """Path-traced radiance for a wavefront (RayColor,
    brick_raytracer.comp:203-265), SoA. `max_bounce`/`sun_enabled` static.

    Returns f32[N, 3] tone-mapped color.
    """
    ox, oy, oz = _split3(jnp.asarray(origin, dtype=F))
    dx, dy, dz = _split3(jnp.asarray(direction, dtype=F))
    return _ray_color_soa(static, arrays, mats, ox, oy, oz, dx, dy, dz,
                          max_bounce, sun_position, sun_enabled, sun_color,
                          sun_radius, max_steps, tables, use_skip)


def _ray_color_soa(static, arrays, mats, ox, oy, oz, dx, dy, dz, max_bounce,
                   sun_position, sun_enabled, sun_color, sun_radius,
                   max_steps, tables=None, use_skip=False):
    n = ox.shape[0]
    if tables is None:
        tables = build_trace_tables(static, arrays)

    def hit(scope, hox, hoy, hoz, hdx, hdy, hdz, mask, ignore=None):
        """One traversal of a ray class. `scope` names the class
        (traverse_primary, traverse_bounce{i}, traverse_shadow{i}) so a
        profiler trace attributes device time to it. `ignore` is the
        per-ray (ignore_type, internal_reflection) pair of the dielectric
        skip rule; None for classes that cannot carry it."""
        needs_ignore = ignore is not None
        if not needs_ignore:
            ignore = (jnp.full(n, MAT_NONE, dtype=jnp.int32),
                      jnp.ones(n, dtype=F))
        with jax.named_scope(scope):
            return _grid_hit_soa(static, arrays, mats, hox, hoy, hoz,
                                 hdx, hdy, hdz, jnp.float32(jnp.inf),
                                 *ignore, mask, max_steps,
                                 tables, use_skip, bounded_t=False,
                                 needs_ignore=needs_ignore)

    dx, dy, dz = _norm3(dx, dy, dz)
    cr = jnp.zeros(n, dtype=F)
    cg = jnp.zeros(n, dtype=F)
    cb = jnp.zeros(n, dtype=F)
    internal_refl = jnp.ones(n, dtype=F)
    ignore_type = jnp.full(n, MAT_NONE, dtype=jnp.int32)
    loop_count = jnp.zeros(n, dtype=jnp.int32)
    bouncing = jnp.ones(n, dtype=jnp.bool_)
    sun_position = jnp.asarray(sun_position, dtype=F)
    sun_color = jnp.asarray(sun_color, dtype=F)
    sun_radius = jnp.asarray(sun_radius, dtype=F)

    # original direction for the background of never-hit rays
    odx, ody, odz = dx, dy, dz

    for bounce_i in range(max_bounce):
        # dielectric-skip state can only exist after a refraction, so the
        # first bounce (and all shadow rays) take the ignore-free fast path
        if bounce_i == 0:
            h = hit("traverse_primary", ox, oy, oz, dx, dy, dz, bouncing)
        else:
            h = hit(f"traverse_bounce{bounce_i}", ox, oy, oz, dx, dy, dz,
                    bouncing, ignore=(ignore_type, internal_refl))
        active = bouncing & h["found"]

        mat_idx = h["index"]
        alb = mats.albedo[mat_idx]           # one row gather per bounce
        ar, ag, ab = alb[:, 0], alb[:, 1], alb[:, 2]
        mtype = mats.mtype[mat_idx]
        type_data = mats.type_data[mat_idx]
        is_emissive = mtype == MAT_EMISSIVE
        known = (mtype <= MAT_DIELECTRIC) | is_emissive
        loop_count = loop_count + (active & known).astype(jnp.int32)

        px, py, pz = h["px"], h["py"], h["pz"]
        nx, ny, nz = h["nx"], h["ny"], h["nz"]
        cox = px + pz
        coy = py + pz

        # lambertian (brick_raytracer.comp:539-544)
        rx, ry, rz = _rand_vec3_range_soa(cox, coy, F(-0.4), F(0.4))
        lamx, lamy, lamz = _norm3(nx + rx, ny + ry, nz + rz)

        # metal (brick_raytracer.comp:546-551)
        dn = _dot3(dx, dy, dz, nx, ny, nz)
        refx = dx - F(2.0) * dn * nx
        refy = dy - F(2.0) * dn * ny
        refz = dz - F(2.0) * dn * nz
        fuzz = type_data
        mx, my, mz = _rand_vec3_range_soa(cox, coy, -fuzz, fuzz)
        metx, mety, metz = _norm3(refx + mx, refy + my, refz + mz)
        met_ok = _dot3(metx, mety, metz, nx, ny, nz) > 0

        # dielectric (brick_raytracer.comp:576-596)
        ex, ey, ez = _rand_vec3_range_soa(cox, coy, F(-0.05), F(0.05))
        dnx, dny, dnz = _norm3(nx + ex, ny + ey, nz + ez)
        ir = type_data
        eta = ir / internal_refl
        c1 = -_dot3(dx, dy, dz, dnx, dny, dnz)
        w = eta * c1
        c2m = (w - eta) * (w + eta)
        should_refract = c2m >= F(-1.0)
        wk = w - jnp.sqrt(jnp.maximum(F(1.0) + c2m, 0.0))
        tx = eta * dx + wk * dnx
        ty = eta * dy + wk * dny
        tz = eta * dz + wk * dnz
        rnd = rng.rand3(jnp.stack([px, py, pz], axis=-1), xp=jnp)
        do_refract = should_refract & (rnd > F(0.5))
        ddn = _dot3(dx, dy, dz, dnx, dny, dnz)
        rfx = dx - F(2.0) * ddn * dnx
        rfy = dy - F(2.0) * ddn * dny
        rfz = dz - F(2.0) * ddn * dnz
        diex, diey, diez = _norm3(
            jnp.where(do_refract, tx, rfx),
            jnp.where(do_refract, ty, rfy),
            jnp.where(do_refract, tz, rfz))

        is_lam = mtype == MAT_LAMBERTIAN
        is_met = mtype == MAT_METAL
        is_die = mtype == MAT_DIELECTRIC
        sdx = jnp.where(is_lam, lamx, jnp.where(is_met, metx, diex))
        sdy = jnp.where(is_lam, lamy, jnp.where(is_met, mety, diey))
        sdz = jnp.where(is_lam, lamz, jnp.where(is_met, metz, diez))
        # emissive paths terminate (superset; see core.materials)
        result = jnp.where(is_lam, True, jnp.where(is_met, met_ok, is_die))
        new_ignore = jnp.where(is_die & do_refract, MAT_DIELECTRIC,
                               MAT_NONE).astype(jnp.int32)
        new_internal = jnp.where(is_die & do_refract, ir, F(1.0))

        # emissive contribution: albedo * strength, unshadowed
        emit = active & is_emissive
        cr = cr + jnp.where(emit, ar * type_data, F(0.0))
        cg = cg + jnp.where(emit, ag * type_data, F(0.0))
        cb = cb + jnp.where(emit, ab * type_data, F(0.0))
        sun_or_diffuse = active & ~is_emissive

        if sun_enabled:
            # jittered sun-disk target, seeded by the incoming direction
            # (brick_raytracer.comp:240-249)
            scox = dx + dz
            scoy = dy + dz
            sx_, sy_, sz_ = _rand_vec3_range_soa(scox, scoy, -sun_radius,
                                                 sun_radius)
            shx = sun_position[0] + sx_ - px
            shy = sun_position[1] + sy_ - py
            shz = sun_position[2] + sz_ - pz
            shx, shy, shz = _norm3(shx, shy, shz)
            sh = hit(f"traverse_shadow{bounce_i}", px, py, pz,
                     shx, shy, shz, active)
            lit = sun_or_diffuse & ~sh["found"]
            cr = cr + jnp.where(lit, ar * sun_color[0], F(0.0))
            cg = cg + jnp.where(lit, ag * sun_color[1], F(0.0))
            cb = cb + jnp.where(lit, ab * sun_color[2], F(0.0))
        else:
            cr = cr + jnp.where(sun_or_diffuse, ar, F(0.0))
            cg = cg + jnp.where(sun_or_diffuse, ag, F(0.0))
            cb = cb + jnp.where(sun_or_diffuse, ab, F(0.0))

        bouncing = active & result
        ox = jnp.where(active, px, ox)
        oy = jnp.where(active, py, oy)
        oz = jnp.where(active, pz, oz)
        dx = jnp.where(bouncing, sdx, dx)
        dy = jnp.where(bouncing, sdy, dy)
        dz = jnp.where(bouncing, sdz, dz)
        internal_refl = jnp.where(active, new_internal, internal_refl)
        ignore_type = jnp.where(active, new_ignore, ignore_type)

    # background for never-hit rays (brick_raytracer.comp:260-262); a ray
    # that never hits keeps its original direction
    never = loop_count == 0
    t = F(0.5) * (ody + F(1.0))
    bgr = (F(1.0) - t) + t * F(0.5)
    bgg = (F(1.0) - t) + t * F(0.7)
    bgb = (F(1.0) - t) + t * F(1.0)
    if sun_enabled:
        bgr, bgg, bgb = bgr * sun_color[0], bgg * sun_color[1], bgb * sun_color[2]
    cr = cr + jnp.where(never, bgr, F(0.0))
    cg = cg + jnp.where(never, bgg, F(0.0))
    cb = cb + jnp.where(never, bgb, F(0.0))

    return jnp.stack([cr / (cr + F(1.0)), cg / (cg + F(1.0)),
                      cb / (cb + F(1.0))], axis=-1)


def camera_vectors(camera_device) -> dict:
    """Traced camera basis (the push-constant payload, Camera.zig:183-193)
    as a pytree of f32 vectors. Image size / spp / max_bounce stay
    host-side statics (they change shapes/loop counts)."""
    d = camera_device
    return dict(
        horizontal=jnp.asarray(d.horizontal, dtype=F),
        vertical=jnp.asarray(d.vertical, dtype=F),
        lower_left_corner=jnp.asarray(d.lower_left_corner, dtype=F),
        origin=jnp.asarray(d.origin, dtype=F),
    )


def _camera_rays_soa(cam: dict, width: int, height: int, sample_index,
                     row0=0, rows=None):
    w, h = int(width), int(height)
    rows = h if rows is None else int(rows)
    ys, xs = jnp.meshgrid(jnp.arange(rows, dtype=F), jnp.arange(w, dtype=F),
                          indexing="ij")
    xs = xs.ravel()
    ys = ys.ravel() + jnp.asarray(row0, dtype=F)
    # sample_index may be a traced scalar (temporal accumulation feeds a
    # per-frame sample base so successive frames draw fresh jitter)
    s = jnp.asarray(sample_index, dtype=F)
    sf = F(0.2) * (s > 0).astype(F)
    noise_x = rng.hash12(jnp.stack([(xs + s) * sf, ys * sf], axis=-1), xp=jnp)
    noise_y = rng.hash12(jnp.stack([xs * sf, (ys + s) * sf], axis=-1), xp=jnp)
    u = (xs + noise_x) / F(w - 1)
    v = (ys + noise_y) / F(h - 1)
    hvec = cam["horizontal"]
    vvec = cam["vertical"]
    ll = cam["lower_left_corner"]
    o = cam["origin"]
    rdx = hvec[0] * u + ll[0] + vvec[0] * v - o[0]
    rdy = hvec[1] * u + ll[1] + vvec[1] * v - o[1]
    rdz = hvec[2] * u + ll[2] + vvec[2] * v - o[2]
    N = rows * w
    oxs = jnp.broadcast_to(o[0], (N,))
    oys = jnp.broadcast_to(o[1], (N,))
    ozs = jnp.broadcast_to(o[2], (N,))
    return oxs, oys, ozs, rdx, rdy, rdz


def camera_rays(cam: dict, width: int, height: int, sample_index: int,
                row0=0, rows: int | None = None):
    """Per-pixel jittered camera rays (kernel main,
    brick_raytracer.comp:162-171 + CameraGetRay :474-477) — AoS convenience
    wrapper (tests); the render path uses the SoA internals."""
    oxs, oys, ozs, rdx, rdy, rdz = _camera_rays_soa(
        cam, width, height, sample_index, row0, rows)
    return (jnp.stack([oxs, oys, ozs], axis=-1),
            jnp.stack([rdx, rdy, rdz], axis=-1))


def render_rows(static: GridStatic, arrays: GridArrays, mats: MaterialsDevice,
                cam: dict, width: int, height: int, spp: int, max_bounce: int,
                sun_position, sun_color, sun_radius, sun_enabled: bool,
                row0=0, rows: int | None = None, max_steps: int = 768,
                tables=None, use_skip: bool = False, sample_base=0.0,
                row_bands: int = 1):
    """Render a band of image rows (the sharding unit). Returns
    f32[rows, W, 3] tone-mapped + gamma'd (brick_raytracer.comp:153-178).

    `sample_base` (traced scalar) offsets the per-sample jitter seed; the
    temporal accumulation mode passes frame_index * spp so every frame
    draws fresh sub-pixel samples.

    `row_bands` splits the rows into sequentially traced bands
    (`lax.map`): each band's DDA while_loop converges independently, so
    fast bands (sky) stop iterating while slow ones (surface-grazing
    horizon rays) finish. Used when the band height divides evenly."""
    w, h = int(width), int(height)
    rows = h if rows is None else int(rows)
    if tables is None:
        tables = build_trace_tables(static, arrays)

    def render_band(band_row0, band_rows):
        color = jnp.zeros((band_rows * w, 3), dtype=F)
        for s in range(spp):
            oxs, oys, ozs, rdx, rdy, rdz = _camera_rays_soa(
                cam, w, h, jnp.asarray(sample_base, dtype=F) + F(s),
                row0=band_row0, rows=band_rows)
            with jax.named_scope("ray_color"):
                color = color + _ray_color_soa(
                    static, arrays, mats, oxs, oys, ozs, rdx, rdy, rdz,
                    max_bounce,
                    jnp.asarray(sun_position, dtype=F), sun_enabled,
                    jnp.asarray(sun_color, dtype=F),
                    jnp.asarray(sun_radius, dtype=F),
                    max_steps, tables, use_skip)
        color = jnp.sqrt(color / F(spp))
        return color.reshape(band_rows, w, 3)

    if row_bands > 1 and rows % row_bands == 0 and rows // row_bands >= 8:
        band_rows = rows // row_bands
        r0s = (jnp.asarray(row0, dtype=F)
               + (jnp.arange(row_bands) * band_rows).astype(F))
        out = jax.lax.map(lambda r0: render_band(r0, band_rows), r0s)
        return out.reshape(rows, w, 3)
    return render_band(jnp.asarray(row0, dtype=F), rows)


def render_image(static: GridStatic, arrays: GridArrays, mats: MaterialsDevice,
                 camera_device, sun_position, sun_color, sun_radius,
                 sun_enabled: bool, trace_config: TraceConfig = TraceConfig()):
    """Render a full frame from a host CameraDevice (single-chip
    convenience; the engine jits render_rows directly)."""
    d = camera_device
    return render_rows(
        static, arrays, mats, camera_vectors(d),
        int(d.image_width), int(d.image_height),
        int(d.samples_per_pixel), int(d.max_bounce),
        sun_position, sun_color, sun_radius, sun_enabled,
        max_steps=trace_config.max_steps, use_skip=trace_config.empty_skip)
