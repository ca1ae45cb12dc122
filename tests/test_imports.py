"""The engine's main path is plain XLA: building VoxelRT and rendering a
frame imports no Pallas module."""

import os
import subprocess
import sys

CODE = """
import sys
from zig_vulkan_jax.config import CameraConfig, EngineConfig
from zig_vulkan_jax.engine.engine import VoxelRT
from zig_vulkan_jax.models.scenes import flat_test_scene
sc = flat_test_scene(dim=8)
rt = VoxelRT(sc.grid, sc.materials, EngineConfig(
    internal_resolution_width=16, internal_resolution_height=8,
    camera=CameraConfig(samples_per_pixel=1, max_bounce=1)))
rt.render().block_until_ready()
print([m for m in sys.modules if "pallas" in m])
"""


def test_render_loads_no_pallas_module():
    r = subprocess.run([sys.executable, "-c", CODE],
                       env=dict(os.environ, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]", r.stdout
