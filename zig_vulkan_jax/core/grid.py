"""Sparse brick-map voxel grid (the scene database).

Re-implements the reference's brickmap ("Real-time Ray tracing and Editing of
Large Voxel Scenes", cited at reference brick/Grid.zig:1-2) with the exact
device data layout of brick/State.zig:133-156, re-packaged for JAX:

- `statuses`   uint32[ceil(cells/32)] — 1 bit per grid cell ("loaded"),
  bit i%32 of word i/32 (State.zig:86-107);
- `indices`    uint32[cells] — cell -> brick slot (State.zig:109);
- `occupancy`  uint32[brick_alloc * 2] — 64 voxel bits per brick. The
  reference stores bytes (8 per brick, Grid.zig:53); we pack the same bits
  little-endian into two u32 words per brick so device gathers stay on word
  granularity (voxel bit v of brick b = bit v%32 of word b*2 + v/32 — the
  identical bit when the reference's bytes are read little-endian);
- `start_indices` uint32[brick_alloc] — packed {u31 material window start,
  1 bit type}, sentinel 0xFFFFFFFF (State.zig:111-127);
- `material_indices` uint8[brick_alloc * 64] — per-voxel material bytes in
  bump-allocated 64-entry windows (brick/MaterialAllocator.zig:34-43).

Grid cell index = x + dim_x * (z + dim_z * y) (Grid.zig:206-211); voxel bit
within a brick = bx + 4 * (bz + 4 * by) (Grid.zig:198-203); `insert` flips Y
(Grid.zig:135).

Host-side scene construction is a vectorized numpy builder (`BrickGrid`):
the reference's worker-thread + atomics construction path (terrain.zig:113,
Grid.zig:141-148) is replaced by batch inserts, which are
order-independent except for last-writer-wins material bytes — preserved by
numpy fancy-assignment ordering. Interactive per-frame edits use the
jittable functional `apply_edits` (the reference's mutex-guarded
DeviceDataDelta upload protocol, State.zig:14-57 + VoxelRT.zig:107-172,
collapses into donated functional array updates).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..config import (
    BRICK_BITS,
    BRICK_DIMENSION,
    BRICK_WORDS,
    GridConfig,
)

UNSET_START_INDEX = np.uint32(0xFFFFFFFF)


@dataclasses.dataclass(frozen=True)
class GridStatic:
    """Trace-time constants of a grid (the reference's uniform
    `BrickGridState` (State.zig:60-79) + specialization constants).

    Hashable so it can be a `jax.jit` static argument.
    """

    dim_x: int
    dim_y: int
    dim_z: int
    brick_alloc: int
    min_point: Tuple[float, float, float]
    scale: float
    base_t: float  # kept for uniform parity; the kernel never reads it

    @property
    def dims(self) -> Tuple[int, int, int]:
        return (self.dim_x, self.dim_y, self.dim_z)

    @property
    def voxel_dims(self) -> Tuple[int, int, int]:
        return (
            self.dim_x * BRICK_DIMENSION,
            self.dim_y * BRICK_DIMENSION,
            self.dim_z * BRICK_DIMENSION,
        )

    @property
    def cells(self) -> int:
        return self.dim_x * self.dim_y * self.dim_z

    @property
    def max_point(self) -> Tuple[float, float, float]:
        return (
            self.min_point[0] + self.dim_x * self.scale,
            self.min_point[1] + self.dim_y * self.scale,
            self.min_point[2] + self.dim_z * self.scale,
        )

    @property
    def voxel_scale(self) -> float:
        return self.scale / BRICK_DIMENSION


@dataclasses.dataclass
class GridArrays:
    """The device-resident scene arrays (a pytree; numpy or jax arrays).

    The first five mirror the reference's GPU buffers (State.zig:133-156).
    `diel_mask`/`brick_ir` are derived acceleration data maintained
    incrementally alongside them: per-brick bits marking dielectric voxels
    and the brick's dielectric index of refraction (NaN if the brick has no
    dielectric, or has voxels with conflicting ir — see ops.trace). They
    let the traversal evaluate the same-material skip rule
    (brick_raytracer.comp:427) from registers instead of per-voxel gathers.
    """

    statuses: np.ndarray           # uint32[ceil(cells/32)]
    indices: np.ndarray            # uint32[cells]
    occupancy: np.ndarray          # uint32[brick_alloc * BRICK_WORDS]
    start_indices: np.ndarray      # uint32[brick_alloc]
    material_indices: np.ndarray   # uint8[brick_alloc * BRICK_BITS]
    active_bricks: np.ndarray      # uint32[] scalar
    material_cursor: np.ndarray    # uint32[] scalar (MaterialAllocator cursor)
    diel_mask: np.ndarray          # uint32[brick_alloc * BRICK_WORDS]
    brick_ir: np.ndarray           # f32[brick_alloc] (NaN = none/conflict)


def _register_pytrees() -> None:
    import jax

    jax.tree_util.register_dataclass(
        GridArrays,
        data_fields=[
            "statuses",
            "indices",
            "occupancy",
            "start_indices",
            "material_indices",
            "active_bricks",
            "material_cursor",
            "diel_mask",
            "brick_ir",
        ],
        meta_fields=[],
    )


_register_pytrees()


def grid_at(static: GridStatic, x, y, z):
    """Grid cell index from voxel coords (reference Grid.zig:206-211)."""
    gx = x // BRICK_DIMENSION
    gy = y // BRICK_DIMENSION
    gz = z // BRICK_DIMENSION
    return gx + static.dim_x * (gz + static.dim_z * gy)


def voxel_at(x, y, z):
    """Voxel bit within a brick (reference Grid.zig:198-203)."""
    bx = x % BRICK_DIMENSION
    by = y % BRICK_DIMENSION
    bz = z % BRICK_DIMENSION
    return bx + BRICK_DIMENSION * (bz + BRICK_DIMENSION * by)


class BrickGrid:
    """Host-side scene builder (reference brick/Grid.zig).

    Arrays live in numpy; call `device_arrays()` to put them on the device.
    """

    def __init__(self, dim_x: int, dim_y: int, dim_z: int,
                 config: GridConfig = GridConfig()):
        assert dim_x * dim_y * dim_z > 0
        brick_count = dim_x * dim_y * dim_z
        brick_alloc = config.brick_alloc if config.brick_alloc is not None else brick_count

        self.static = GridStatic(
            dim_x=dim_x,
            dim_y=dim_y,
            dim_z=dim_z,
            brick_alloc=brick_alloc,
            min_point=tuple(float(v) for v in config.min_point),
            scale=float(config.scale),
            base_t=float(config.base_t),
        )
        self.arrays = GridArrays(
            statuses=np.zeros((brick_count + 31) // 32, dtype=np.uint32),
            indices=np.zeros(brick_count, dtype=np.uint32),
            occupancy=np.zeros(brick_alloc * BRICK_WORDS, dtype=np.uint32),
            start_indices=np.full(brick_alloc, UNSET_START_INDEX, dtype=np.uint32),
            material_indices=np.zeros(brick_alloc * BRICK_BITS, dtype=np.uint8),
            active_bricks=np.uint32(0),
            material_cursor=np.uint32(0),
            diel_mask=np.zeros(brick_alloc * BRICK_WORDS, dtype=np.uint32),
            brick_ir=np.full(brick_alloc, np.nan, dtype=np.float32),
        )
        # material classification used to maintain diel_mask/brick_ir; set
        # via attach_materials (defaults: no dielectrics)
        self._mat_is_diel = np.zeros(256, dtype=bool)
        self._mat_ir = np.zeros(256, dtype=np.float32)

    def attach_materials(self, materials) -> None:
        """Register the material table used to classify dielectric voxels
        for the diel_mask/brick_ir acceleration data. Call before inserts
        (models.scenes does this automatically)."""
        from .materials import MAT_DIELECTRIC

        self._mat_is_diel = materials.mtype == MAT_DIELECTRIC
        self._mat_ir = materials.type_data.astype(np.float32)

    # -- single-voxel API (reference Grid.zig:129-194) -------------------------
    def insert(self, x: int, y: int, z: int, material_index: int) -> None:
        self.insert_batch(
            np.asarray([x]), np.asarray([y]), np.asarray([z]),
            np.asarray([material_index], dtype=np.uint8),
        )

    # -- vectorized batch insert ------------------------------------------------
    def insert_batch(self, x, y, z, material_index) -> None:
        """Insert many voxels at once; equivalent to sequential `insert` calls.

        Brick slots and material windows are bump-allocated in order of first
        appearance, mirroring the reference's atomic fetchAdd allocation
        (Grid.zig:141-148, MaterialAllocator.zig:34-43). Duplicate voxels keep
        the material of the LAST occurrence, like sequential inserts.
        """
        st = self.static
        a = self.arrays
        x = np.asarray(x, dtype=np.int64)
        y = np.asarray(y, dtype=np.int64)
        z = np.asarray(z, dtype=np.int64)
        material_index = np.asarray(material_index, dtype=np.uint8)
        if x.size == 0:
            return
        vx, vy, vz = st.voxel_dims
        if (x.min() < 0 or x.max() >= vx or y.min() < 0 or y.max() >= vy
                or z.min() < 0 or z.max() >= vz):
            raise IndexError("voxel out of grid bounds")

        # Y flip for intuitive coordinates (Grid.zig:135)
        fy = (vy - 1) - y

        cell = grid_at(st, x, fy, z)
        nth_bit = voxel_at(x, fy, z)

        # --- allocate brick slots for cells seen for the first time ---
        loaded = (a.statuses[cell // 32] >> (cell % 32).astype(np.uint32)) & 1
        uniq_cells, first_pos = np.unique(cell, return_index=True)
        # order of first appearance, to mirror sequential allocation order
        order = np.argsort(first_pos, kind="stable")
        uniq_cells = uniq_cells[order]
        uniq_loaded = (a.statuses[uniq_cells // 32] >> (uniq_cells % 32).astype(np.uint32)) & 1
        new_cells = uniq_cells[uniq_loaded == 0]
        n_new = new_cells.size
        if int(a.active_bricks) + n_new > st.brick_alloc:
            raise MemoryError("brick allocation exhausted")
        new_brick_ids = (int(a.active_bricks) + np.arange(n_new)).astype(np.uint32)
        a.indices[new_cells] = new_brick_ids
        np.bitwise_or.at(
            a.statuses, new_cells // 32,
            (np.uint32(1) << (new_cells % 32).astype(np.uint32)),
        )
        a.active_bricks = np.uint32(int(a.active_bricks) + n_new)

        # --- material windows for bricks that lack one ---
        brick = a.indices[cell].astype(np.int64)
        needs_window = a.start_indices[brick] == UNSET_START_INDEX
        uniq_bricks, first_b = np.unique(brick[needs_window], return_index=True)
        uniq_bricks = uniq_bricks[np.argsort(first_b, kind="stable")]
        n_windows = uniq_bricks.size
        if int(a.material_cursor) + n_windows * BRICK_BITS > a.material_indices.size:
            raise MemoryError("material window allocation exhausted")
        window_starts = (int(a.material_cursor)
                         + np.arange(n_windows) * BRICK_BITS).astype(np.uint32)
        # type bit (bit 31) = voxel_start_index (0), so the raw packed value
        # is just the window start (State.zig:117-120)
        a.start_indices[uniq_bricks] = window_starts
        a.material_cursor = np.uint32(int(a.material_cursor) + n_windows * BRICK_BITS)

        # --- material bytes (last writer wins, like sequential inserts) ---
        start_value = (a.start_indices[brick] & np.uint32(0x7FFFFFFF)).astype(np.int64)
        a.material_indices[start_value + nth_bit] = material_index

        # --- occupancy bits ---
        word = brick * BRICK_WORDS + nth_bit // 32
        bit = np.uint32(1) << (nth_bit % 32).astype(np.uint32)
        np.bitwise_or.at(a.occupancy, word, bit)

        # --- dielectric mask + per-brick ir maintenance ---
        is_d = self._mat_is_diel[material_index]
        if is_d.any():
            np.bitwise_or.at(a.diel_mask, word[is_d], bit[is_d])
            ir = self._mat_ir[material_index[is_d]]
            b_d = brick[is_d]
            prev = a.brick_ir[b_d]
            # NaN (unset) adopts the ir; conflicting ir poisons to NaN via a
            # second pass below
            a.brick_ir[b_d] = np.where(np.isnan(prev), ir, prev)
            conflict = ~np.isnan(a.brick_ir[b_d]) & (a.brick_ir[b_d] != ir)
            if conflict.any():
                a.brick_ir[b_d[conflict]] = np.nan
        # non-dielectric overwrites clear stale mask bits for those voxels
        not_d = ~is_d
        if not_d.any():
            np.bitwise_and.at(a.diel_mask, word[not_d], ~bit[not_d])

    def remove_batch(self, x, y, z) -> None:
        """Clear voxels (superset feature: the reference only inserts;
        BASELINE.json config 3 exercises insert/remove)."""
        st = self.static
        a = self.arrays
        x = np.asarray(x, dtype=np.int64)
        y = np.asarray(y, dtype=np.int64)
        z = np.asarray(z, dtype=np.int64)
        vx, vy, vz = st.voxel_dims
        fy = (vy - 1) - y
        cell = grid_at(st, x, fy, z)
        nth_bit = voxel_at(x, fy, z)
        loaded = (a.statuses[cell // 32] >> (cell % 32).astype(np.uint32)) & 1
        keep = loaded == 1
        if not keep.any():
            return
        brick = a.indices[cell[keep]].astype(np.int64)
        word = brick * BRICK_WORDS + nth_bit[keep] // 32
        np.bitwise_and.at(
            a.occupancy, word,
            ~(np.uint32(1) << (nth_bit[keep] % 32).astype(np.uint32)),
        )

    # -- queries (for tests / host logic) --------------------------------------
    def voxel_material(self, x: int, y: int, z: int) -> Optional[int]:
        """Material index at a voxel, or None if empty."""
        st = self.static
        a = self.arrays
        fy = (st.voxel_dims[1] - 1) - y
        cell = int(grid_at(st, np.int64(x), np.int64(fy), np.int64(z)))
        if not (a.statuses[cell // 32] >> np.uint32(cell % 32)) & 1:
            return None
        brick = int(a.indices[cell])
        nth = int(voxel_at(np.int64(x), np.int64(fy), np.int64(z)))
        occ = a.occupancy[brick * BRICK_WORDS + nth // 32]
        if not (occ >> np.uint32(nth % 32)) & 1:
            return None
        start = int(a.start_indices[brick] & np.uint32(0x7FFFFFFF))
        return int(a.material_indices[start + nth])

    def rebuild_dielectric_masks(self) -> None:
        """Recompute diel_mask/brick_ir from material_indices + occupancy
        (used after external builds, e.g. the native builder)."""
        a = self.arrays
        a.diel_mask[:] = 0
        a.brick_ir[:] = np.nan
        active = int(a.active_bricks)
        if active == 0:
            return
        slots = np.arange(active * BRICK_BITS)
        bricks = slots // BRICK_BITS
        starts = (a.start_indices[bricks] & np.uint32(0x7FFFFFFF)).astype(np.int64)
        addr = starts + (slots % BRICK_BITS)
        occ_w = bricks * BRICK_WORDS + (slots % BRICK_BITS) // 32
        occ_b = ((a.occupancy[occ_w] >> ((slots % BRICK_BITS) % 32).astype(np.uint32))
                 & 1) == 1
        mats = a.material_indices[np.clip(addr, 0, a.material_indices.size - 1)]
        is_d = self._mat_is_diel[mats] & occ_b
        word = bricks * BRICK_WORDS + (slots % BRICK_BITS) // 32
        bit = np.uint32(1) << ((slots % BRICK_BITS) % 32).astype(np.uint32)
        np.bitwise_or.at(a.diel_mask, word[is_d], bit[is_d])
        d_bricks = bricks[is_d]
        d_ir = self._mat_ir[mats[is_d]]
        if d_bricks.size == 0:
            return
        # first-write wins; conflicts poison to NaN
        order = np.argsort(d_bricks, kind="stable")
        db, di = d_bricks[order], d_ir[order]
        first = np.concatenate([[True], db[1:] != db[:-1]])
        a.brick_ir[db[first]] = di[first]
        conflict = ~first & (di != a.brick_ir[db])
        if conflict.any():
            a.brick_ir[db[conflict]] = np.nan

    # -- device transfer --------------------------------------------------------
    def device_arrays(self) -> GridArrays:
        """Copy the scene arrays to the default JAX device."""
        import jax

        return GridArrays(
            statuses=jax.device_put(self.arrays.statuses),
            indices=jax.device_put(self.arrays.indices),
            occupancy=jax.device_put(self.arrays.occupancy),
            start_indices=jax.device_put(self.arrays.start_indices),
            material_indices=jax.device_put(self.arrays.material_indices),
            active_bricks=jax.device_put(np.uint32(self.arrays.active_bricks)),
            material_cursor=jax.device_put(np.uint32(self.arrays.material_cursor)),
            diel_mask=jax.device_put(self.arrays.diel_mask),
            brick_ir=jax.device_put(self.arrays.brick_ir),
        )


def apply_edits(static: GridStatic, arrays: GridArrays, xyz, material_index,
                valid, mat_is_diel=None, mat_ir=None):
    """Jittable functional voxel insert batch (device-resident edits).

    The functional replacement for the reference's edit path (Grid.insert ->
    DeviceDataDelta dirty ranges -> StagingRamp upload, SURVEY.md §3 C4):
    donated scene arrays are updated in place by XLA scatter ops, so only
    touched HBM words change — the functional analog of the reference's
    min/max dirty-range coalescing.

    Args:
      static: GridStatic (jit-static).
      arrays: GridArrays of jax arrays (donate for in-place updates).
      xyz: int32[N, 3] voxel coordinates (fixed N per trace; pad + mask).
      material_index: uint8[N].
      valid: bool[N] mask — False lanes are ignored.
      mat_is_diel, mat_ir: optional bool[256]/f32[256] material classification
        used to maintain the diel_mask/brick_ir acceleration arrays; without
        them, edited voxels are treated as non-dielectric there.

    Returns: updated GridArrays.

    Note: if the same voxel appears twice in one batch, which material byte
    wins is unspecified (XLA scatter duplicate ordering); sequential
    reference semantics are last-wins. Don't rely on in-batch duplicates.
    """
    import jax.numpy as jnp

    a = arrays
    vy = static.voxel_dims[1]
    x = xyz[:, 0].astype(jnp.int32)
    y = xyz[:, 1].astype(jnp.int32)
    z = xyz[:, 2].astype(jnp.int32)
    fy = (vy - 1) - y
    cell = (x // BRICK_DIMENSION
            + static.dim_x * ((z // BRICK_DIMENSION)
                              + static.dim_z * (fy // BRICK_DIMENSION)))
    nth = ((x % BRICK_DIMENSION)
           + BRICK_DIMENSION * ((z % BRICK_DIMENSION)
                                + BRICK_DIMENSION * (fy % BRICK_DIMENSION)))
    mat = material_index.astype(jnp.uint8)

    # Sort lanes by cell so each cell's lanes are adjacent; invalid lanes
    # sort to the end as their own segment.
    sentinel = jnp.int32(static.cells)
    sort_key = jnp.where(valid, cell, sentinel)
    order = jnp.argsort(sort_key)
    s_cell = sort_key[order]
    s_valid = valid[order]
    s_nth = nth[order]
    s_mat = mat[order]
    safe_cell = jnp.clip(s_cell, 0, static.cells - 1)

    loaded = ((a.statuses[safe_cell // 32]
               >> (safe_cell % 32).astype(jnp.uint32)) & 1).astype(jnp.bool_)
    is_first = jnp.concatenate(
        [jnp.array([True]), s_cell[1:] != s_cell[:-1]])
    allocates = is_first & (~loaded) & s_valid
    rank = jnp.cumsum(allocates.astype(jnp.uint32)) - allocates.astype(jnp.uint32)
    n_new = jnp.sum(allocates.astype(jnp.uint32))
    new_brick_id = a.active_bricks + rank

    # brick slot per lane: existing bricks keep their index; lanes of a newly
    # allocated cell all use the segment-first lane's fresh id.
    seg_id = jnp.cumsum(is_first.astype(jnp.int32)) - 1
    seg_new_id = jnp.zeros((s_cell.shape[0],), dtype=jnp.uint32).at[seg_id].max(
        jnp.where(allocates, new_brick_id, jnp.uint32(0)))
    brick = jnp.where(loaded, a.indices[safe_cell], seg_new_id[seg_id])
    brick = jnp.where(s_valid, brick, jnp.uint32(0))

    # cell -> brick index + status bit for allocating lanes. Allocating lanes
    # have distinct cells and previously-clear bits, so at[].add of their
    # (disjoint) status bits is an exact bitwise OR.
    indices = a.indices.at[jnp.where(allocates, s_cell, sentinel)].set(
        new_brick_id, mode="drop")
    status_bit = jnp.where(
        allocates, jnp.uint32(1) << (safe_cell % 32).astype(jnp.uint32),
        jnp.uint32(0))
    statuses = a.statuses.at[
        jnp.where(allocates, safe_cell // 32, a.statuses.shape[0])
    ].add(status_bit, mode="drop")

    # material window bump allocation for new bricks (rank order mirrors the
    # reference's MaterialAllocator fetchAdd order)
    start_new = a.material_cursor + rank * jnp.uint32(BRICK_BITS)
    start_indices = a.start_indices.at[
        jnp.where(allocates, new_brick_id.astype(jnp.int32),
                  jnp.int32(static.brick_alloc))
    ].set(start_new, mode="drop")
    material_cursor = a.material_cursor + n_new * jnp.uint32(BRICK_BITS)
    active_bricks = a.active_bricks + n_new

    # material byte writes
    start_val = (start_indices[jnp.clip(brick, 0, static.brick_alloc - 1)]
                 & jnp.uint32(0x7FFFFFFF))
    mat_addr = start_val.astype(jnp.int32) + s_nth
    material_indices = a.material_indices.at[
        jnp.where(s_valid, mat_addr, a.material_indices.shape[0])
    ].set(s_mat, mode="drop")

    # occupancy bits: sort by (word, bit), dedupe identical pairs, clear
    # already-set bits, then a scatter-add of disjoint bits == bitwise OR.
    word = brick.astype(jnp.int32) * BRICK_WORDS + s_nth // 32
    bit = jnp.uint32(1) << (s_nth % 32).astype(jnp.uint32)
    word_key = jnp.where(s_valid, word, jnp.int32(static.brick_alloc * BRICK_WORDS))
    wb_order = jnp.lexsort((bit, word_key))
    w_s = word_key[wb_order]
    b_s = bit[wb_order]
    v_s = s_valid[wb_order]
    dup = jnp.concatenate(
        [jnp.array([False]), (w_s[1:] == w_s[:-1]) & (b_s[1:] == b_s[:-1])])
    safe_w = jnp.clip(w_s, 0, a.occupancy.shape[0] - 1)
    add_bits = jnp.where(v_s & (~dup), b_s & (~a.occupancy[safe_w]), jnp.uint32(0))
    occupancy = a.occupancy.at[
        jnp.where(v_s, w_s, a.occupancy.shape[0])
    ].add(add_bits, mode="drop")

    # dielectric mask + per-brick ir maintenance (same dedupe machinery)
    s_mat_sorted = s_mat[wb_order]
    if mat_is_diel is not None:
        lane_diel = mat_is_diel[s_mat_sorted.astype(jnp.int32)]
        lane_ir = mat_ir[s_mat_sorted.astype(jnp.int32)]
    else:
        lane_diel = jnp.zeros_like(v_s)
        lane_ir = jnp.zeros(v_s.shape, jnp.float32)
    cur_d = a.diel_mask[safe_w]
    d_add = jnp.where(v_s & (~dup) & lane_diel, b_s & (~cur_d), jnp.uint32(0))
    d_sub = jnp.where(v_s & (~dup) & (~lane_diel), b_s & cur_d, jnp.uint32(0))
    diel_mask = a.diel_mask.at[
        jnp.where(v_s, w_s, a.diel_mask.shape[0])
    ].add(d_add - d_sub, mode="drop")

    brick_sorted = brick[wb_order].astype(jnp.int32)
    safe_b = jnp.where(v_s & lane_diel, brick_sorted, a.brick_ir.shape[0])
    prev_ir = a.brick_ir[jnp.clip(safe_b, 0, a.brick_ir.shape[0] - 1)]
    new_ir = jnp.where(jnp.isnan(prev_ir), lane_ir,
                       jnp.where(prev_ir != lane_ir, jnp.float32(jnp.nan),
                                 prev_ir))
    brick_ir = a.brick_ir.at[safe_b].set(new_ir, mode="drop")

    return GridArrays(
        statuses=statuses,
        indices=indices,
        occupancy=occupancy,
        start_indices=start_indices,
        material_indices=material_indices,
        active_bricks=active_bricks,
        material_cursor=material_cursor,
        diel_mask=diel_mask,
        brick_ir=brick_ir,
    )


def remove_edits(static: GridStatic, arrays: GridArrays, xyz, valid):
    """Jittable functional voxel removal (clears occupancy bits).

    Superset feature: the reference only inserts; BASELINE.json config 3
    exercises insert/remove.
    """
    import jax.numpy as jnp

    a = arrays
    vy = static.voxel_dims[1]
    x = xyz[:, 0].astype(jnp.int32)
    y = xyz[:, 1].astype(jnp.int32)
    z = xyz[:, 2].astype(jnp.int32)
    fy = (vy - 1) - y
    cell = (x // BRICK_DIMENSION
            + static.dim_x * ((z // BRICK_DIMENSION)
                              + static.dim_z * (fy // BRICK_DIMENSION)))
    nth = ((x % BRICK_DIMENSION)
           + BRICK_DIMENSION * ((z % BRICK_DIMENSION)
                                + BRICK_DIMENSION * (fy % BRICK_DIMENSION)))
    safe_cell = jnp.clip(cell, 0, static.cells - 1)
    loaded = ((a.statuses[safe_cell // 32]
               >> (safe_cell % 32).astype(jnp.uint32)) & 1).astype(jnp.bool_)
    act = valid & loaded
    brick = a.indices[safe_cell].astype(jnp.int32)
    word = brick * BRICK_WORDS + nth // 32
    bit = jnp.uint32(1) << (nth % 32).astype(jnp.uint32)
    word_key = jnp.where(act, word, jnp.int32(static.brick_alloc * BRICK_WORDS))
    order = jnp.lexsort((bit, word_key))
    w_s = word_key[order]
    b_s = bit[order]
    v_s = act[order]
    dup = jnp.concatenate(
        [jnp.array([False]), (w_s[1:] == w_s[:-1]) & (b_s[1:] == b_s[:-1])])
    safe_w = jnp.clip(w_s, 0, a.occupancy.shape[0] - 1)
    # subtracting set bits clears them; dedupe + mask-to-set keeps it exact
    sub_bits = jnp.where(v_s & (~dup), b_s & a.occupancy[safe_w], jnp.uint32(0))
    occupancy = a.occupancy.at[
        jnp.where(v_s, w_s, a.occupancy.shape[0])
    ].add(jnp.uint32(0) - sub_bits, mode="drop")
    d_sub = jnp.where(v_s & (~dup), b_s & a.diel_mask[safe_w], jnp.uint32(0))
    diel_mask = a.diel_mask.at[
        jnp.where(v_s, w_s, a.diel_mask.shape[0])
    ].add(jnp.uint32(0) - d_sub, mode="drop")
    return dataclasses.replace(arrays, occupancy=occupancy,
                               diel_mask=diel_mask)


def dense_materials(static: GridStatic, arrays: GridArrays) -> np.ndarray:
    """Decode the scene into a dense int16[vx, vy, vz] volume (-1 = empty).

    Brick-slot-numbering independent: used to compare scenes built by
    different (e.g. multithreaded native vs vectorized numpy) builders.
    """
    vx, vy, vz = (
        static.dim_x * BRICK_DIMENSION,
        static.dim_y * BRICK_DIMENSION,
        static.dim_z * BRICK_DIMENSION,
    )
    out = np.full((vx, vy, vz), -1, dtype=np.int16)
    x, y, z = np.meshgrid(np.arange(vx), np.arange(vy), np.arange(vz),
                          indexing="ij")
    fy = (vy - 1) - y
    cell = (x // BRICK_DIMENSION
            + static.dim_x * ((z // BRICK_DIMENSION)
                              + static.dim_z * (fy // BRICK_DIMENSION)))
    nth = ((x % BRICK_DIMENSION)
           + BRICK_DIMENSION * ((z % BRICK_DIMENSION)
                                + BRICK_DIMENSION * (fy % BRICK_DIMENSION)))
    statuses = np.asarray(arrays.statuses)
    indices = np.asarray(arrays.indices)
    occupancy = np.asarray(arrays.occupancy)
    starts = np.asarray(arrays.start_indices)
    mats = np.asarray(arrays.material_indices)
    loaded = ((statuses[cell // 32] >> (cell % 32).astype(np.uint32)) & 1) == 1
    brick = indices[cell].astype(np.int64)
    word = brick * BRICK_WORDS + nth // 32
    occ = ((occupancy[word] >> (nth % 32).astype(np.uint32)) & 1) == 1
    solid = loaded & occ
    start = (starts[brick] & np.uint32(0x7FFFFFFF)).astype(np.int64)
    midx = mats[np.clip(start + nth, 0, mats.size - 1)]
    out[solid] = midx[solid].astype(np.int16)
    return out
