"""Validation / debug checks.

The JAX analog of the reference's Vulkan validation layer machinery
(SURVEY.md §5.2: `VK_LAYER_KHRONOS_validation` + best-practices features
required in Debug builds, validation_layer.zig:10-49, plus GPA leak checks
and `@setRuntimeSafety` toggles):

- `enable_debug_mode()` turns on jax NaN/Inf checking and disables the
  x64-truncation silence — the "validation layers on" build;
- `validate_scene()` asserts the brickmap invariants the reference guards
  with `std.debug.assert` (insert bounds Grid.zig:130-132, material window
  alignment Grid.zig:170-171, allocator capacity MaterialAllocator.zig:40);
- `check_image()` is the per-frame NaN oracle for render outputs.

Functional purity already removes the data-race class the reference's
mutexes guard against (SURVEY.md §5.2); these checks cover numeric and
structural corruption instead.
"""

from __future__ import annotations

import numpy as np

from ..config import BRICK_BITS
from ..core.grid import GridArrays, GridStatic, UNSET_START_INDEX


def enable_debug_mode() -> None:
    """The 'Debug build with validation layers' analog."""
    import jax

    jax.config.update("jax_debug_nans", True)
    jax.config.update("jax_debug_infs", True)


def disable_debug_mode() -> None:
    import jax

    jax.config.update("jax_debug_nans", False)
    jax.config.update("jax_debug_infs", False)


class SceneValidationError(AssertionError):
    pass


def validate_scene(static: GridStatic, arrays: GridArrays) -> None:
    """Structural invariants of the brickmap (host-side, test/debug use)."""
    statuses = np.asarray(arrays.statuses)
    indices = np.asarray(arrays.indices)
    starts = np.asarray(arrays.start_indices)
    active = int(arrays.active_bricks)
    cursor = int(arrays.material_cursor)

    if active > static.brick_alloc:
        raise SceneValidationError(
            f"active_bricks {active} exceeds brick_alloc {static.brick_alloc}")
    if cursor > BRICK_BITS * static.brick_alloc:
        raise SceneValidationError("material cursor exceeds window capacity")
    if cursor % BRICK_BITS != 0:
        raise SceneValidationError("material cursor not window-aligned")

    cells = np.arange(static.cells)
    loaded = ((statuses[cells // 32] >> (cells % 32).astype(np.uint32)) & 1) == 1
    used_bricks = indices[loaded]
    if used_bricks.size:
        if used_bricks.max() >= active:
            raise SceneValidationError("cell references unallocated brick slot")
        used_starts = starts[used_bricks]
        if (used_starts == UNSET_START_INDEX).any():
            raise SceneValidationError("loaded brick without material window")
        vals = used_starts & np.uint32(0x7FFFFFFF)
        if (vals % BRICK_BITS).any():
            raise SceneValidationError(
                "material window start not 64-aligned (Grid.zig:170-171)")
        if (vals.astype(np.int64) + BRICK_BITS
                > BRICK_BITS * static.brick_alloc).any():
            raise SceneValidationError("material window exceeds capacity")


def check_image(image, what: str = "frame") -> None:
    """NaN/Inf/range oracle for rendered frames."""
    arr = np.asarray(image)
    if not np.isfinite(arr).all():
        raise SceneValidationError(f"{what}: non-finite pixels")
    if arr.min() < -1e-5 or arr.max() > 1.0 + 1e-5:
        raise SceneValidationError(
            f"{what}: pixels outside [0,1] ({arr.min()}..{arr.max()})")
