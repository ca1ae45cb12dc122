"""Chebyshev empty-space distance field vs a brute-force numpy oracle.

The field drives the DDA empty-space skip (ops.trace DIST_CAP leaps); a
value larger than the true L-inf distance to the nearest loaded cell would
let a ray skip past geometry, so exactness (capped) is load-bearing.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from zig_vulkan_jax.core.grid import GridStatic
from zig_vulkan_jax.ops.trace import DIST_CAP, _distance_field


def _brute_force(vol: np.ndarray) -> np.ndarray:
    """O(cells * loaded) exact capped Chebyshev distance."""
    ys, zs, xs = np.nonzero(vol)
    dist = np.full(vol.shape, DIST_CAP, dtype=np.int32)
    if ys.size == 0:
        return dist
    gy, gz, gx = np.meshgrid(
        np.arange(vol.shape[0]), np.arange(vol.shape[1]),
        np.arange(vol.shape[2]), indexing="ij")
    for y, z, x in zip(ys, zs, xs):
        d = np.maximum(np.abs(gy - y), np.maximum(np.abs(gz - z),
                                                  np.abs(gx - x)))
        dist = np.minimum(dist, d)
    return np.minimum(dist, DIST_CAP).astype(np.int32)


def _static(dy, dz, dx):
    return GridStatic(dim_x=dx, dim_y=dy, dim_z=dz, brick_alloc=1,
                      min_point=(0.0, 0.0, 0.0), scale=1.0, base_t=0.01)


@pytest.mark.parametrize("seed,density", [(0, 0.02), (1, 0.2), (2, 0.001)])
def test_safe_vs_brute_force(seed, density):
    """The field must NEVER overestimate the true distance (safety), must
    be exact in the near field (<= _DF_EXACT_RADIUS), and must keep at
    least ~half the true skip in the far field (quality floor)."""
    from zig_vulkan_jax.ops.trace import _DF_EXACT_RADIUS

    rng = np.random.default_rng(seed)
    shape = (12, 47, 23)  # deliberately non-aligned odd dims
    vol = rng.random(shape) < density
    st = _static(*shape)
    got = np.asarray(_distance_field(st, jnp.asarray(vol.reshape(-1))))
    want = _brute_force(vol).reshape(-1)
    assert (got <= want).all(), "overestimate would let rays skip geometry"
    near = want <= _DF_EXACT_RADIUS
    np.testing.assert_array_equal(got[near], want[near])
    assert (2 * got >= want).all(), "far-field quality floor"
    # loaded cells are 0, empty cells are >= 1
    np.testing.assert_array_equal(got == 0, vol.reshape(-1))


def test_empty_volume_is_all_cap():
    shape = (8, 8, 8)
    st = _static(*shape)
    got = np.asarray(_distance_field(
        st, jnp.zeros(np.prod(shape), dtype=bool)))
    assert (got == DIST_CAP).all()


def test_single_seed_far_corner_caps():
    """Distances beyond DIST_CAP must clamp to (at most) DIST_CAP and the
    near field must be exact."""
    shape = (40, 40, 40)
    vol = np.zeros(shape, dtype=bool)
    vol[0, 0, 0] = True
    st = _static(*shape)
    got = np.asarray(_distance_field(st, jnp.asarray(vol.reshape(-1))))
    vol3 = got.reshape(shape)
    assert vol3[0, 0, 0] == 0
    assert vol3[0, 0, 1] == 1
    assert vol3[0, 0, 3] == 3
    want = _brute_force(vol)
    assert (vol3 <= want).all()
    assert (2 * vol3 >= want).all()
    assert vol3[39, 39, 39] <= DIST_CAP


def test_exact_mode_matches_brute_force():
    rng = np.random.default_rng(5)
    shape = (10, 40, 21)
    vol = rng.random(shape) < 0.01
    st = _static(*shape)
    got = np.asarray(_distance_field(st, jnp.asarray(vol.reshape(-1)),
                                     exact=True))
    want = _brute_force(vol).reshape(-1)
    np.testing.assert_array_equal(got, want)
