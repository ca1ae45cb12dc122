"""Nested configuration dataclasses.

Mirrors the reference's nested `Config` struct tree with identical fields and
defaults (SURVEY.md §5.6): VoxelRT.Config (reference VoxelRT.zig:22-28),
Camera.Config (Camera.zig:5-14), Sun.Config (Sun.zig:4-11),
GraphicsPipeline.Config / denoiser push constants (GraphicsPipeline.zig:27-39),
BrickGrid.Config (brick/Grid.zig:13-20), Benchmark configuration
(Benchmark.zig:141-173).

The reference splits values into comptime constants, Vulkan specialization
constants, and push constants. Here these all become Python-level values
baked at `jax.jit` trace time (static) or small device scalars (dynamic).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Reference Camera.Config (Camera.zig:5-14)."""

    viewport_height: float = 2.0
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    samples_per_pixel: int = 2
    max_bounce: int = 2
    turn_rate: float = 0.1
    normal_speed: float = 1.0
    sprint_speed: float = 2.0
    user_input_disabled: bool = False


@dataclasses.dataclass(frozen=True)
class SunConfig:
    """Reference Sun.Config (Sun.zig:4-11)."""

    animate: bool = True
    animate_speed: float = 0.1
    enabled: bool = True
    color: Tuple[float, float, float] = (1.0, 1.1, 1.0)
    radius: float = 5.0
    sun_distance: float = 1000.0


@dataclasses.dataclass(frozen=True)
class DenoiserConfig:
    """Reference GraphicsPipeline.PushConstant defaults (GraphicsPipeline.zig:27-39)."""

    samples: int = 20
    distribution_bias: float = 0.6
    pixel_multiplier: float = 1.5
    inverse_hue_tolerance: float = 20.0
    enabled: bool = True


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Reference BrickGrid.Config (brick/Grid.zig:13-20).

    `workers_count` is kept for API parity; this build's host scene
    construction is vectorized (and optionally multithreaded in the native
    C++ grid builder), so it only controls the native builder's threads.
    """

    brick_alloc: Optional[int] = None
    base_t: float = 0.01
    min_point: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    scale: float = 1.0
    workers_count: int = 4


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Knobs of the wavefront tracer that have no reference analog.

    `max_steps` bounds the flattened two-level DDA loop (the GLSL kernel's
    while loops are unbounded; XLA needs a bound for the fixed-shape path).
    """

    max_steps: int = 768
    # empty-space skipping via the Chebyshev distance field: semantically
    # hit-equivalent, but float re-derivation of the DDA cursor after a
    # jump can flip grazing-voxel outcomes in rare cases; disable for
    # bit-exact reference parity
    empty_skip: bool = True
    # sequential row bands per trace (lax.map): fast bands stop iterating
    # while slow ones finish. Used when the band height divides evenly.
    # 8 beats 1 on the default workload on an H100 (PERF.md).
    row_bands: int = 8


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Reference VoxelRT.Config (VoxelRT.zig:22-28) + Pipeline.Config knobs.

    `internal_resolution_*` decouples render resolution from output
    resolution exactly like the reference (main.zig:23, Pipeline.zig:103-127);
    the denoiser pass resamples internal -> output.
    """

    internal_resolution_width: int = 1024
    internal_resolution_height: int = 576
    output_resolution_width: Optional[int] = None   # None = same as internal
    output_resolution_height: Optional[int] = None
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    sun: SunConfig = dataclasses.field(default_factory=SunConfig)
    denoiser: DenoiserConfig = dataclasses.field(default_factory=DenoiserConfig)
    trace: TraceConfig = dataclasses.field(default_factory=TraceConfig)
    # the "Debug build with validation layers" analog (SURVEY.md §5.2):
    # enables jax NaN/Inf checks and validates the scene at engine init
    debug_validation: bool = False


# Brick geometry constants (reference brick/State.zig:5-11). These are
# Vulkan specialization constants in the reference (Pipeline.zig:293-315);
# here they are module-level constants baked into jit traces.
BRICK_DIMENSION: int = 4
BRICK_BITS: int = BRICK_DIMENSION ** 3          # 64
BRICK_BYTES: int = BRICK_BITS // 8              # 8
BRICK_WORDS: int = BRICK_BYTES // 4             # 2
BRICK_VOXEL_SCALE: float = 1.0 / BRICK_DIMENSION  # Pipeline.zig:313
