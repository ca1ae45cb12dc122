"""Denoiser tests: numpy transliteration oracle + filter properties."""

import numpy as np

import jax.numpy as jnp

from zig_vulkan_jax.config import DenoiserConfig
from zig_vulkan_jax.ops import denoise as dn

GOLDEN_ANGLE = dn.GOLDEN_ANGLE
F = np.float32


def _np_texture(img, u, v):
    """Clamp-to-edge bilinear texture() lookup (scalar, numpy)."""
    h, w, _ = img.shape
    x = u * w - 0.5
    y = v * h - 0.5
    x0, y0 = int(np.floor(x)), int(np.floor(y))
    fx, fy = x - x0, y - y0
    xi0, xi1 = np.clip([x0, x0 + 1], 0, w - 1)
    yi0, yi1 = np.clip([y0, y0 + 1], 0, h - 1)
    top = img[yi0, xi0] * (1 - fx) + img[yi0, xi1] * fx
    bot = img[yi1, xi0] * (1 - fx) + img[yi1, xi1] * fx
    return top * (1 - fy) + bot * fy


def _np_sirbird(img, samples=20, distribution_bias=0.6, pixel_multiplier=1.5,
                inverse_hue_tolerance=20.0):
    """Direct scalar transliteration of image.frag:31-71 (the oracle)."""
    h, w, _ = img.shape
    out = np.zeros_like(img)
    c, s = np.cos(GOLDEN_ANGLE), np.sin(GOLDEN_ANGLE)
    sample_radius = np.sqrt(samples)
    sample_true_radius = 0.5 / (sample_radius ** 2)
    for py in range(h):
        for px in range(w):
            uv = ((px + 0.5) / w, (py + 0.5) / h)
            center = _np_texture(img, *uv)
            center_len = np.linalg.norm(center)
            center_norm = center / max(center_len, 1e-12)
            influence_sum = 0.0
            denoised = np.zeros(3)
            rot = np.array([0.0, 1.0])
            for x in range(samples + 1):
                rot = np.array([c * rot[0] - s * rot[1], s * rot[0] + c * rot[1]])
                off = pixel_multiplier * rot * np.sqrt(x) * 0.5
                infl = 1.0 - sample_true_radius * max(off @ off, 0.0) ** distribution_bias
                tap = _np_texture(img, uv[0] + off[0] / w, uv[1] + off[1] / h)
                infl = infl ** 3
                tap_len = np.linalg.norm(tap)
                tap_norm = tap / max(tap_len, 1e-12)
                infl *= max(0.5 + 0.5 * center_norm @ tap_norm, 0.0) ** inverse_hue_tolerance
                infl *= max(1.0 - abs(tap_len - center_len), 0.0) ** 8.0
                influence_sum += infl
                denoised += tap * infl
            out[py, px] = denoised / influence_sum
    return out


def test_matches_numpy_transliteration():
    rng = np.random.default_rng(0)
    img = rng.uniform(0.1, 0.9, size=(16, 16, 3)).astype(F)
    expect = _np_sirbird(img.astype(np.float64))
    got = np.asarray(dn.denoise(jnp.asarray(img)))
    assert np.abs(got - expect).max() < 2e-3


def test_constant_image_fixed_point():
    img = np.full((12, 12, 3), 0.5, dtype=F)
    out = np.asarray(dn.denoise(jnp.asarray(img)))
    np.testing.assert_allclose(out, img, atol=1e-5)


def test_reduces_noise_variance():
    rng = np.random.default_rng(1)
    base = np.full((32, 32, 3), 0.5, dtype=F)
    noisy = base + rng.normal(0, 0.05, base.shape).astype(F)
    out = np.asarray(dn.denoise(jnp.asarray(noisy)))
    assert out.std() < noisy.std() * 0.7


def test_resample_identity_and_upscale():
    rng = np.random.default_rng(2)
    img = rng.uniform(size=(8, 8, 3)).astype(F)
    same = np.asarray(dn.bilinear_resample(jnp.asarray(img), 8, 8))
    np.testing.assert_array_equal(same, img)
    up = np.asarray(dn.bilinear_resample(jnp.asarray(img), 16, 16))
    assert up.shape == (16, 16, 3)
    # mean preserved approximately by bilinear upscale
    assert abs(up.mean() - img.mean()) < 0.02


def test_postprocess_disabled_is_resample():
    rng = np.random.default_rng(3)
    img = jnp.asarray(rng.uniform(size=(8, 8, 3)).astype(F))
    cfg = DenoiserConfig(enabled=False)
    out = np.asarray(dn.postprocess(img, cfg, 8, 8))
    np.testing.assert_array_equal(out, np.asarray(img))


def test_denoise_with_resample_shape():
    rng = np.random.default_rng(4)
    img = jnp.asarray(rng.uniform(0.2, 0.8, size=(12, 16, 3)).astype(F))
    out = np.asarray(dn.denoise(img, out_shape=(24, 32)))
    assert out.shape == (24, 32, 3)
    assert np.isfinite(out).all()


def test_runtime_samples_matches_static_loop():
    """The runtime-`samples` path (traced scalar + masked taps — the
    reference's push constant, image.frag:18-23) must equal the static
    loop at the same value bit-for-bit: masked taps add exactly 0.0."""
    rng = np.random.default_rng(5)
    img = jnp.asarray(rng.uniform(0.1, 0.9, size=(16, 16, 3)).astype(F))
    for samples in (1, 8, 20, dn.MAX_RUNTIME_SAMPLES):
        static = np.asarray(dn.denoise(img, samples=samples))
        runtime = np.asarray(dn.denoise(
            img, samples=jnp.asarray(samples, jnp.float32),
            max_samples=dn.MAX_RUNTIME_SAMPLES))
        np.testing.assert_array_equal(runtime, static)


def test_runtime_samples_single_trace():
    """Changing the runtime `samples` value must reuse ONE compiled
    program (no retrace) and still change the output."""
    rng = np.random.default_rng(6)
    img = jnp.asarray(rng.uniform(0.1, 0.9, size=(12, 12, 3)).astype(F))
    misses0 = dn._denoise_runtime._cache_size()
    out8 = np.asarray(dn.denoise(img, samples=jnp.asarray(8, jnp.float32),
                                 max_samples=dn.MAX_RUNTIME_SAMPLES))
    out32 = np.asarray(dn.denoise(img, samples=jnp.asarray(32, jnp.float32),
                                  max_samples=dn.MAX_RUNTIME_SAMPLES))
    assert dn._denoise_runtime._cache_size() == misses0 + 1
    assert np.abs(out8 - out32).max() > 1e-6


def test_vectorized_oracle_matches_scalar_transliteration():
    """oracle.cpu_denoise (whole-image numpy, the on-card comparison's
    reference) equals the scalar per-pixel transliteration above, and
    the JAX filter agrees with it to float32 rounding."""
    from zig_vulkan_jax.oracle import cpu_denoise

    rng = np.random.default_rng(7)
    img = rng.uniform(0.0, 1.0, size=(12, 20, 3)).astype(F)
    vec = cpu_denoise.sir_bird(img)
    np.testing.assert_allclose(vec, _np_sirbird(img.astype(np.float64)),
                               atol=1e-6)
    got = np.asarray(dn.denoise(jnp.asarray(img)))
    assert np.abs(got - vec).max() < 1e-5
