"""ctypes bridge to the native C++ grid builder (native/gridbuilder.cpp).

The reference's host runtime builds scenes with worker threads and atomics
(terrain.zig:113-127, Grid.zig:141-148); this wrapper drives the native
re-implementation of that path and imports the result into a
`core.grid.BrickGrid`. The library is compiled on demand with g++ and
cached; everything degrades gracefully to the vectorized numpy builder if
no toolchain is available (`native_available()`).

Because the native builder allocates brick slots in thread arrival order,
slot *numbering* differs run to run under multithreading (exactly like the
reference); scene semantics (which voxel has which material) are identical,
which is what the tests assert.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

from ..config import GridConfig
from ..core.grid import BrickGrid

_LIB: Optional[ctypes.CDLL] = None
_LIB_FAILED = False

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "gridbuilder.cpp")
_CACHE_DIR = os.environ.get("ZVT_NATIVE_CACHE", os.path.join(
    tempfile.gettempdir(), "zvt_native"))


def _build_library() -> Optional[str]:
    os.makedirs(_CACHE_DIR, exist_ok=True)
    so_path = os.path.join(_CACHE_DIR, "libzvtgrid.so")
    if (os.path.exists(so_path)
            and os.path.getmtime(so_path) >= os.path.getmtime(_SRC)):
        return so_path
    # build into a private file and rename it into place, so a process
    # that finds `so_path` never loads a half-written library while
    # another process is still compiling it
    tmp_path = f"{so_path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
           "-o", tmp_path, _SRC, "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError):
        return None
    os.replace(tmp_path, so_path)
    return so_path


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    path = _build_library()
    if path is None:
        _LIB_FAILED = True
        return None
    lib = ctypes.CDLL(path)
    lib.zvt_grid_create.restype = ctypes.c_void_p
    lib.zvt_grid_create.argtypes = [ctypes.c_uint32] * 3 + [ctypes.c_uint64]
    lib.zvt_grid_destroy.argtypes = [ctypes.c_void_p]
    lib.zvt_insert_batch.restype = ctypes.c_uint64
    lib.zvt_insert_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int]
    lib.zvt_generate_terrain.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_uint32, ctypes.c_double,
        ctypes.c_int64, ctypes.c_int]
    lib.zvt_export.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint32)]
    _LIB = lib
    return lib


def native_available() -> bool:
    return _load() is not None


class NativeGridBuilder:
    """Builds a scene natively, then exports into a BrickGrid."""

    def __init__(self, dim_x: int, dim_y: int, dim_z: int,
                 config: GridConfig = GridConfig()):
        lib = _load()
        if lib is None:
            raise RuntimeError("native grid builder unavailable (no g++)")
        self._lib = lib
        self._grid = BrickGrid(dim_x, dim_y, dim_z, config)  # layout template
        alloc = self._grid.static.brick_alloc
        self._handle = lib.zvt_grid_create(dim_x, dim_y, dim_z, alloc)
        self.threads = max(1, int(config.workers_count))

    def insert_batch(self, x, y, z, material_index) -> int:
        xs = np.ascontiguousarray(x, dtype=np.int64)
        ys = np.ascontiguousarray(y, dtype=np.int64)
        zs = np.ascontiguousarray(z, dtype=np.int64)
        ms = np.ascontiguousarray(material_index, dtype=np.uint8)
        n = xs.size
        ok = self._lib.zvt_insert_batch(
            self._handle, n,
            xs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            zs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ms.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self.threads)
        return int(ok)

    def generate_terrain(self, seed: int = 420, scale: float = 4.0,
                         ocean_level: int = 20) -> None:
        """Native perlin terrain with the same tables/hashes as io.terrain."""
        from .terrain import PerlinNoise

        p = PerlinNoise(seed)
        rf = np.ascontiguousarray(p.rand_float, dtype=np.float64)
        px = np.ascontiguousarray(p.perm_x, dtype=np.int32)
        py = np.ascontiguousarray(p.perm_y, dtype=np.int32)
        pz = np.ascontiguousarray(p.perm_z, dtype=np.int32)
        self._lib.zvt_generate_terrain(
            self._handle,
            rf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            px.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            py.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            pz.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            seed & 0xFFFFFFFF, float(scale), int(ocean_level), self.threads)

    def finish(self) -> BrickGrid:
        """Export native arrays into the BrickGrid and free the handle."""
        g = self._grid
        a = g.arrays
        counters = np.zeros(2, dtype=np.uint32)
        self._lib.zvt_export(
            self._handle,
            a.statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            a.indices.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            a.occupancy.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            a.start_indices.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            a.material_indices.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            counters.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
        a.active_bricks = np.uint32(counters[0])
        a.material_cursor = np.uint32(counters[1])
        self._lib.zvt_grid_destroy(self._handle)
        self._handle = None
        g.rebuild_dielectric_masks()
        return g
