"""Pixel parity: JAX wavefront tracer vs the independent CPU DDA oracle.

The JAX tracer (ops.trace, flattened state-machine DDA) and the oracle
(oracle.cpu_tracer, GLSL-structured nested loops) are two independent
implementations of the reference kernel's semantics. Primary-ray renders
must match bit-near-exactly; scatter/sun paths use sin-hash RNG whose ULP
divergence between libm and XLA flips a handful of scatter decisions, so
those compare statistically (SURVEY.md §7 "hard parts").
"""

import numpy as np
import pytest

import jax.numpy as jnp

from zig_vulkan_jax.config import CameraConfig, SunConfig
from zig_vulkan_jax.core.camera import Camera
from zig_vulkan_jax.core.sun import Sun
from zig_vulkan_jax.models.scenes import flat_test_scene
from zig_vulkan_jax.oracle import cpu_tracer as oracle
from zig_vulkan_jax.ops import trace


@pytest.fixture(scope="module")
def scene():
    sc = flat_test_scene(dim=8)
    g = sc.grid
    # water pool + metal pillar for full material coverage
    xs, zs = np.meshgrid(np.arange(6, 16), np.arange(6, 16), indexing="ij")
    g.insert_batch(xs.ravel(), np.full(xs.size, 4), zs.ravel(),
                   np.zeros(xs.size, dtype=np.uint8))
    ys = np.arange(4, 12)
    g.insert_batch(np.full(ys.size, 20), ys, np.full(ys.size, 20),
                   np.full(ys.size, 7, dtype=np.uint8))
    return sc


def _render_both(sc, cam_cfg, sun_cfg, size=(48, 48)):
    cam = Camera(75.0, size[0], size[1], cam_cfg)
    sun = Sun(sun_cfg)
    osc = oracle.OracleScene(sc.grid.static, sc.grid.arrays, sc.materials)
    img_o = oracle.render(osc, cam.d_camera, sun.device_data)
    arrays = sc.grid.device_arrays()
    mats = trace.materials_to_device(sc.materials)
    img_j = np.asarray(trace.render_image(
        sc.grid.static, arrays, mats, cam.d_camera,
        sun.device_data.position, sun.device_data.color,
        sun.device_data.radius, bool(sun.device_data.enabled)))
    return img_o, img_j


def test_primary_rays_pixel_exact(scene):
    """BASELINE config 1: primary rays, flat shading — exact parity."""
    img_o, img_j = _render_both(
        scene,
        CameraConfig(origin=(4.0, 6.5, 15.0), samples_per_pixel=1, max_bounce=0),
        SunConfig(enabled=False),
    )
    assert img_o.shape == img_j.shape == (48, 48, 3)
    np.testing.assert_allclose(img_j, img_o, atol=1e-5)
    # the render must actually hit geometry, not just sky
    assert np.unique((img_o * 255).astype(np.uint8).reshape(-1, 3), axis=0).shape[0] > 4


def test_bounces_and_sun_statistical(scene):
    """BASELINE config 2/4 style: diffuse + metal + dielectric + sun shadows.

    sin-hash ULP divergence flips a small fraction of scatter decisions;
    image must agree on >99% of pixels and closely on average."""
    img_o, img_j = _render_both(
        scene,
        CameraConfig(origin=(4.0, 6.5, 15.0), samples_per_pixel=2, max_bounce=2),
        SunConfig(enabled=True),
    )
    diff = np.abs(img_j - img_o).max(axis=-1)
    assert diff.mean() < 5e-3
    assert (diff > 1e-3).mean() < 0.01


def test_grid_hit_matches_oracle_hits(scene):
    """Hit records (found/t/index) must agree lane-for-lane on primary rays."""
    sc = scene
    cam = Camera(75.0, 32, 32, CameraConfig(origin=(4.0, 6.5, 15.0)))
    d = cam.d_camera
    w, h = 32, 32
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    u = (xs / np.float32(w - 1)).ravel()
    v = (ys / np.float32(h - 1)).ravel()
    rd = (d.horizontal * u[:, None] + d.lower_left_corner
          + d.vertical * v[:, None] - d.origin).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ro = np.broadcast_to(d.origin, rd.shape).astype(np.float32).copy()
    n = rd.shape[0]

    osc = oracle.OracleScene(sc.grid.static, sc.grid.arrays, sc.materials)
    oh = oracle.grid_hit(osc, ro, rd, np.float32(1e-5), np.float32(np.inf),
                         np.full(n, 3, np.int32), np.ones(n, np.float32),
                         np.ones(n, bool))

    arrays = sc.grid.device_arrays()
    mats = trace.materials_to_device(sc.materials)
    jh = trace.grid_hit(sc.grid.static, arrays, mats,
                        jnp.asarray(ro), jnp.asarray(rd), jnp.float32(np.inf),
                        jnp.full(n, 3, jnp.int32), jnp.ones(n, jnp.float32),
                        jnp.ones(n, bool))

    found_j = np.asarray(jh["found"])
    assert (found_j == oh.found).mean() > 0.999
    both = found_j & oh.found
    np.testing.assert_allclose(np.asarray(jh["t"])[both], oh.t[both], atol=1e-3)
    assert (np.asarray(jh["index"])[both] == oh.index[both]).all()
    np.testing.assert_allclose(np.asarray(jh["normal"])[both],
                               oh.normal[both], atol=1e-5)


def test_max_steps_bound_terminates():
    """A tiny max_steps must terminate and simply miss distant geometry."""
    sc = flat_test_scene(dim=8)
    arrays = sc.grid.device_arrays()
    mats = trace.materials_to_device(sc.materials)
    # ray through empty space toward the center cube (world y ~ 3.75..5.75)
    ro = jnp.asarray([[4.0, 4.5, 20.0]], dtype=jnp.float32)
    rd = jnp.asarray([[0.0, 0.0, -1.0]], dtype=jnp.float32)
    kwargs = dict()
    full = trace.grid_hit(sc.grid.static, arrays, mats, ro, rd,
                          jnp.float32(np.inf), jnp.full(1, 3, jnp.int32),
                          jnp.ones(1, jnp.float32), jnp.ones(1, bool))
    assert bool(full["found"][0])
    capped = trace.grid_hit(sc.grid.static, arrays, mats, ro, rd,
                            jnp.float32(np.inf), jnp.full(1, 3, jnp.int32),
                            jnp.ones(1, jnp.float32), jnp.ones(1, bool),
                            max_steps=2)
    assert not bool(capped["found"][0])


def test_empty_skip_matches_exact(scene):
    """Distance-field skipping must produce (near-)identical hit results."""
    sc = scene
    cam = Camera(75.0, 48, 48, CameraConfig(origin=(4.0, 10.0, 25.0)))
    d = cam.d_camera
    w, h = 48, 48
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    u = (xs / np.float32(w - 1)).ravel()
    v = (ys / np.float32(h - 1)).ravel()
    rd = (d.horizontal * u[:, None] + d.lower_left_corner
          + d.vertical * v[:, None] - d.origin).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ro = np.broadcast_to(d.origin, rd.shape).astype(np.float32).copy()
    n = rd.shape[0]

    arrays = sc.grid.device_arrays()
    mats = trace.materials_to_device(sc.materials)
    args = (jnp.asarray(ro), jnp.asarray(rd), jnp.float32(np.inf),
            jnp.full(n, 3, jnp.int32), jnp.ones(n, jnp.float32),
            jnp.ones(n, bool))
    exact = trace.grid_hit(sc.grid.static, arrays, mats, *args, use_skip=False)
    fast = trace.grid_hit(sc.grid.static, arrays, mats, *args, use_skip=True)
    f_e = np.asarray(exact["found"])
    f_f = np.asarray(fast["found"])
    assert (f_e == f_f).mean() > 0.995
    both = f_e & f_f
    assert (np.asarray(exact["index"])[both]
            == np.asarray(fast["index"])[both]).mean() > 0.995
    np.testing.assert_allclose(np.asarray(fast["t"])[both],
                               np.asarray(exact["t"])[both], atol=1e-2)


def test_refraction_through_water_matches_oracle():
    """Underwater camera looking up: every ray refracts through the water
    surface, exercising the same-material skip rule (the register-resident
    brick-mask path must match the oracle's exact per-voxel rule)."""
    sc = flat_test_scene(dim=8)
    g = sc.grid
    # a deep water pool covering the camera
    xs, ys, zs = np.meshgrid(np.arange(4, 28), np.arange(4, 12),
                             np.arange(4, 28), indexing="ij")
    g.insert_batch(xs.ravel(), ys.ravel(), zs.ravel(),
                   np.zeros(xs.size, dtype=np.uint8))  # water

    cam = Camera(75.0, 40, 40, CameraConfig(origin=(4.0, 5.5, 4.0),
                                            samples_per_pixel=1, max_bounce=3))
    # look upward out of the pool
    cam.turn_pitch(-8.0)
    sun = Sun(SunConfig(enabled=True))

    osc = oracle.OracleScene(g.static, g.arrays, sc.materials)
    img_o = oracle.render(osc, cam.d_camera, sun.device_data)
    arrays = g.device_arrays()
    mats = trace.materials_to_device(sc.materials)
    img_j = np.asarray(trace.render_image(
        g.static, arrays, mats, cam.d_camera,
        sun.device_data.position, sun.device_data.color,
        sun.device_data.radius, True))
    diff = np.abs(img_j - img_o).max(axis=-1)
    # refraction chains amplify the sin-hash ULP divergence; the structure
    # must still match on the overwhelming majority of pixels
    assert (diff > 5e-3).mean() < 0.05, (diff > 5e-3).mean()
    assert diff.mean() < 2e-2
