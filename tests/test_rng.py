"""RNG hash family tests: numpy-vs-jax agreement and GLSL-semantics checks.

The reference values come from evaluating the GLSL expressions
(assets/shaders/rand.comp) by hand in float32.
"""

import numpy as np

import jax.numpy as jnp

from zig_vulkan_jax.ops import rng


def _f32(*vals):
    return np.asarray(vals, dtype=np.float32)


def test_hsin_approximates_sine():
    x = np.linspace(-50, 50, 10001).astype(np.float32)
    err = np.abs(rng.hsin(x) - np.sin(x.astype(np.float64)))
    assert err.max() < 1e-4


def test_rand2_matches_manual_f32():
    co = _f32(0.25, 0.75)
    d = np.float32(0.25) * np.float32(12.9898) + np.float32(0.75) * np.float32(78.233)
    expect = np.float32(rng.hsin(d) * np.float32(43758.5453))
    expect = expect - np.floor(expect)
    got = rng.rand2(co)
    assert abs(float(got) - float(expect)) < 1e-5


def test_hash12_zero_is_zero():
    # hash12(vec2(0,0)) == 0: this is why the reference's first sample has no
    # sub-pixel jitter (brick_raytracer.comp:167 multiplies by sample_i > 0).
    assert float(rng.hash12(_f32(0.0, 0.0))) == 0.0


def test_outputs_in_unit_interval():
    rs = np.random.default_rng(1)
    co2 = rs.uniform(-100, 100, size=(1000, 2)).astype(np.float32)
    co3 = rs.uniform(-100, 100, size=(1000, 3)).astype(np.float32)
    for v in (rng.rand2(co2), rng.hash12(co2), rng.rand3(co3), rng.hash13(co3)):
        assert np.all(v >= 0.0) and np.all(v < 1.0)
    v3 = rng.rand_vec3(co2)
    assert v3.shape == (1000, 3)
    assert np.all(v3 >= 0.0) and np.all(v3 < 1.0)


def test_rand_vec3_range_bounds():
    rs = np.random.default_rng(2)
    co2 = rs.uniform(-10, 10, size=(100, 2)).astype(np.float32)
    v = rng.rand_vec3_range(co2, -0.4, 0.4)
    assert np.all(v >= -0.4) and np.all(v <= 0.4)


def test_numpy_jax_agree():
    rs = np.random.default_rng(3)
    co2 = rs.uniform(-10, 10, size=(256, 2)).astype(np.float32)
    co3 = rs.uniform(-10, 10, size=(256, 3)).astype(np.float32)
    pairs = [
        (rng.rand2(co2), rng.rand2(jnp.asarray(co2), xp=jnp)),
        (rng.hash12(co2), rng.hash12(jnp.asarray(co2), xp=jnp)),
        (rng.rand3(co3), rng.rand3(jnp.asarray(co3), xp=jnp)),
        (rng.rand_vec3_range(co2, -1, 1), rng.rand_vec3_range(jnp.asarray(co2), -1, 1, xp=jnp)),
        (rng.hash32(co2), rng.hash32(jnp.asarray(co2), xp=jnp)),
        (rng.hash23(co3), rng.hash23(jnp.asarray(co3), xp=jnp)),
    ]
    for a, b in pairs:
        # sin-hash amplification means CPU libm vs XLA sin can diverge for a
        # tiny fraction of inputs; the vast majority must agree closely.
        diff = np.abs(np.asarray(b) - a)
        frac_close = np.mean(diff < 1e-4)
        assert frac_close > 0.97, f"only {frac_close} of hashes agree"


def test_rand_in_hemisphere_dot_positive():
    rs = np.random.default_rng(4)
    co2 = rs.uniform(-10, 10, size=(200, 2)).astype(np.float32)
    n = np.tile(_f32(0.0, 1.0, 0.0), (200, 1))
    v = rng.rand_in_hemisphere(co2, n)
    # rand2(co) == 0.5 exactly collapses the hash chain to the zero vector
    # (normalize(0) is undefined in GLSL too); skip those degenerate rows.
    finite = np.isfinite(v).all(axis=-1) & (np.abs(v).sum(axis=-1) > 0)
    assert finite.sum() > 190
    # dot can be exactly 0 when the hash lands a vector in the tangent plane
    # (sign-flip of -0.0); GLSL behaves identically.
    assert np.all(np.sum(v[finite] * n[finite], axis=-1) >= 0)
