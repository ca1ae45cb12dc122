"""zig_vulkan_jax — a voxel ray tracing framework in JAX.

A brand-new JAX/XLA re-design with the capabilities of the
`Avokadoen/zig_vulkan` renderer (see SURVEY.md): sparse brick-map voxel
scenes, two-level 3D-DDA path tracing with lambertian/metal/dielectric
materials and sun shadow rays, a golden-angle spatial denoiser, MagicaVoxel
scene import, procedural Perlin terrain, interactive functional voxel edits,
a 60-second fly-through benchmark harness, and multi-device
framebuffer-tile sharding over a `jax.sharding.Mesh`.

The public facade mirrors the reference's `VoxelRT` module re-exports
(reference VoxelRT.zig:13-20). Engine classes are imported lazily so that
pure-host pieces (camera math, vox parsing, grid building) never pull in JAX.
"""

from .config import (
    CameraConfig,
    DenoiserConfig,
    EngineConfig,
    GridConfig,
    SunConfig,
    TraceConfig,
)
from .core.camera import Camera, CameraDevice
from .core.grid import BrickGrid, GridArrays, GridStatic
from .core.materials import (
    MAT_DIELECTRIC,
    MAT_LAMBERTIAN,
    MAT_METAL,
    MaterialTable,
    fill_from_vox_palette,
    terrain_materials,
)
from .core.sun import Sun, SunDevice

_LAZY = {
    "VoxelRT": ("zig_vulkan_jax.engine.engine", "VoxelRT"),
    "Benchmark": ("zig_vulkan_jax.engine.benchmark", "Benchmark"),
    "BenchmarkReport": ("zig_vulkan_jax.engine.benchmark", "BenchmarkReport"),
    "apply_edits": ("zig_vulkan_jax.core.grid", "apply_edits"),
    "remove_edits": ("zig_vulkan_jax.core.grid", "remove_edits"),
    "render_image": ("zig_vulkan_jax.ops.trace", "render_image"),
    "load_vox": ("zig_vulkan_jax.io.vox", "load"),
    "generate_terrain": ("zig_vulkan_jax.io.terrain", "generate"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Camera",
    "CameraDevice",
    "CameraConfig",
    "BrickGrid",
    "GridArrays",
    "GridStatic",
    "GridConfig",
    "apply_edits",
    "remove_edits",
    "MaterialTable",
    "terrain_materials",
    "fill_from_vox_palette",
    "MAT_LAMBERTIAN",
    "MAT_METAL",
    "MAT_DIELECTRIC",
    "Sun",
    "SunDevice",
    "SunConfig",
    "DenoiserConfig",
    "EngineConfig",
    "TraceConfig",
    "VoxelRT",
    "Benchmark",
    "BenchmarkReport",
    "render_image",
    "load_vox",
    "generate_terrain",
]

__version__ = "0.1.0"
