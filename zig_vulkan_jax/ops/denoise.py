"""Spatial denoiser + presentation resample.

Re-implements the reference's post-process fragment shader
(reference: assets/shaders/image.frag — the "sirBirdDenoise" golden-angle
spiral filter from shadertoy 7d2SDD, cited at image.frag:15) plus the
internal->output resolution blit that the reference gets from sampling the
compute image with a bilinear sampler (GraphicsPipeline quad,
Pipeline.zig:103-127).

Design: the spiral's sample offsets are *uniform across pixels*
(image.frag:47-53 — `pixelOffset` depends only on the loop index), so each
tap is a uniformly-shifted bilinear resample of the whole image. When output
resolution == input resolution the shift decomposes into 4 static padded
slices (pure data movement, no gathers — XLA fuses the whole filter into a
few vector passes). The general resample path uses vectorized bilinear
gathers. Knobs match the reference push constants {samples,
distribution_bias, pixel_multiplier, inverse_hue_tolerance}
(GraphicsPipeline.zig:27-39). `samples` is a runtime *push constant* in
the reference (image.frag:18-23 — an int read in the loop bound), so it
is runtime-tunable here too: the engine evaluates the spiral at a static
ceiling (MAX_RUNTIME_SAMPLES, the GUI slider max) and masks taps beyond
the live value — one select per tap, no retrace when the slider moves.
Only `pixel_multiplier` stays trace-static (it fixes the slice offsets).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DenoiserConfig

F = jnp.float32

GOLDEN_ANGLE = 2.3999632  # 3PI - sqrt(5)PI (image.frag:25)


def _rot_golden(vec):
    """pixelRotated *= sample2D (image.frag:29, :49) in float32."""
    c = np.float32(np.cos(np.float64(GOLDEN_ANGLE)))
    s = np.float32(np.sin(np.float64(GOLDEN_ANGLE)))
    x, y = vec
    # GLSL mat2(c, s, -s, c) * v = (c*x - s*y, s*x + c*y)
    return (c * x - s * y, s * x + c * y)


def spiral_offsets(samples: int, pixel_multiplier: float):
    """The (samples+1) spiral offsets in *pixel* units (image.frag:47-51)."""
    offs = []
    vec = (np.float32(0.0), np.float32(1.0))
    for x in range(samples + 1):
        vec = _rot_golden(vec)
        r = np.float32(pixel_multiplier) * np.float32(np.sqrt(np.float32(x))) * np.float32(0.5)
        offs.append((vec[0] * r, vec[1] * r))
    return offs


def bilinear_sample_shifted(img, dx: float, dy: float):
    """Sample `img` at every pixel center offset by (dx, dy) pixels with
    clamp-to-edge bilinear filtering — the uniform-shift fast path
    (slices + lerps only)."""
    h, w, _ = img.shape
    x0 = int(np.floor(dx))
    y0 = int(np.floor(dy))
    fx = F(dx - x0)
    fy = F(dy - y0)

    # clamp-to-edge shifts expressed as clipped-index row/column reorders —
    # static per offset, so XLA lowers them to slices/concats (no gathers)
    ys = jnp.clip(jnp.arange(h) + y0, 0, h - 1)
    xs = jnp.clip(jnp.arange(w) + x0, 0, w - 1)
    ys1 = jnp.clip(jnp.arange(h) + y0 + 1, 0, h - 1)
    xs1 = jnp.clip(jnp.arange(w) + x0 + 1, 0, w - 1)
    i00 = img[ys][:, xs]
    i01 = img[ys][:, xs1]
    i10 = img[ys1][:, xs]
    i11 = img[ys1][:, xs1]
    top = i00 * (F(1.0) - fx) + i01 * fx
    bot = i10 * (F(1.0) - fx) + i11 * fx
    return top * (F(1.0) - fy) + bot * fy


def bilinear_resample(img, out_h: int, out_w: int):
    """Clamp-to-edge bilinear resample (the GraphicsPipeline blit analog)."""
    h, w, _ = img.shape
    if (out_h, out_w) == (h, w):
        return img
    u = (jnp.arange(out_w, dtype=F) + F(0.5)) / F(out_w)
    v = (jnp.arange(out_h, dtype=F) + F(0.5)) / F(out_h)
    x = u * F(w) - F(0.5)
    y = v * F(h) - F(0.5)
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[None, :, None]
    fy = (y - y0)[:, None, None]
    x0i = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    x1i = jnp.clip(x0.astype(jnp.int32) + 1, 0, w - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    y1i = jnp.clip(y0.astype(jnp.int32) + 1, 0, h - 1)
    i00 = img[y0i][:, x0i]
    i01 = img[y0i][:, x1i]
    i10 = img[y1i][:, x0i]
    i11 = img[y1i][:, x1i]
    top = i00 * (F(1.0) - fx) + i01 * fx
    bot = i10 * (F(1.0) - fx) + i11 * fx
    return top * (F(1.0) - fy) + bot * fy


def _pow_clamped(a, b):
    """GLSL `#define pow(a,b) pow(max(a,0.),b)` (image.frag:27)."""
    return jnp.power(jnp.maximum(a, 0.0), b)


# static tap-count ceiling for the runtime-`samples` path: the reference
# GUI slider range is 1..32 (ImguiGui.zig:275-306 binds the denoiser
# knobs; sliders cap at 32)
MAX_RUNTIME_SAMPLES = 32


def denoise(img, samples=20, distribution_bias=0.6,
            pixel_multiplier: float = 1.5, inverse_hue_tolerance=20.0,
            out_shape=None, max_samples: int | None = None):
    """sirBirdDenoise (image.frag:31-71) on an f32[H, W, 3] image.

    If `out_shape` = (out_h, out_w) differs from the input, the filter
    samples the input exactly like the reference's fragment shader running
    at output resolution over the internal-resolution texture.

    `samples` may be a Python int (static loop, exactly samples+1 taps —
    the cheap path when it never changes) or a traced scalar (the
    reference's runtime push constant, image.frag:18-23): then the spiral
    is evaluated at `max_samples`+1 taps (default MAX_RUNTIME_SAMPLES)
    and taps beyond the live value contribute zero influence — same
    output, no recompile when the GUI slider moves. `pixel_multiplier`
    stays static (it fixes the slice offsets).
    """
    if max_samples is None and isinstance(samples, (int, np.integer)):
        return _denoise_static(img, int(samples), distribution_bias,
                               float(pixel_multiplier),
                               inverse_hue_tolerance, out_shape)
    return _denoise_runtime(img, samples, distribution_bias,
                            float(pixel_multiplier), inverse_hue_tolerance,
                            out_shape,
                            int(max_samples or MAX_RUNTIME_SAMPLES))


@partial(jax.jit,
         static_argnames=("samples", "pixel_multiplier", "out_shape"))
def _denoise_static(img, samples, distribution_bias, pixel_multiplier,
                    inverse_hue_tolerance, out_shape):
    return _sir_bird(img, samples + 1, F(samples), distribution_bias,
                     pixel_multiplier, inverse_hue_tolerance, out_shape)


@partial(jax.jit,
         static_argnames=("pixel_multiplier", "out_shape", "max_samples"))
def _denoise_runtime(img, samples, distribution_bias, pixel_multiplier,
                     inverse_hue_tolerance, out_shape, max_samples):
    return _sir_bird(img, max_samples + 1, jnp.asarray(samples, F),
                     distribution_bias, pixel_multiplier,
                     inverse_hue_tolerance, out_shape, mask_taps=True)


def _sir_bird(img, n_taps: int, samples_f, distribution_bias,
              pixel_multiplier, inverse_hue_tolerance, out_shape,
              mask_taps: bool = False):
    """The filter body: `n_taps` static spiral taps; when `mask_taps`,
    taps with index > `samples_f` (traced) are zero-influence selects."""
    h, w, _ = img.shape
    out_h, out_w = out_shape if out_shape is not None else (h, w)
    same_res = (out_h, out_w) == (h, w)

    distribution_bias = F(distribution_bias)
    inverse_hue_tolerance = F(inverse_hue_tolerance)

    # sampleTrueRadius = 0.5/(sqrt(samples))^2 (image.frag:33-34) — keep
    # the sqrt-then-square rounding for bit parity with the oracle
    sample_radius = jnp.sqrt(samples_f)
    sample_true_radius = F(0.5) / (sample_radius * sample_radius)

    center = img if same_res else bilinear_resample(img, out_h, out_w)
    center_len = jnp.sqrt(jnp.sum(center * center, axis=-1, keepdims=True))
    center_norm = center / jnp.maximum(center_len, F(1e-12))

    influence_sum = jnp.zeros((out_h, out_w, 1), dtype=F)
    denoised = jnp.zeros((out_h, out_w, 3), dtype=F)

    # offsets in *input texture* uv units ('samplePixel' = 1/inputRes,
    # image.frag:37, :53); scale to input pixels for the shifted sampler
    for tap_i, (ox, oy) in enumerate(spiral_offsets(n_taps - 1,
                                                    pixel_multiplier)):
        ox = np.float32(ox)
        oy = np.float32(oy)
        pixel_influence = F(1.0) - sample_true_radius * _pow_clamped(
            F(ox * ox + oy * oy), distribution_bias)

        if same_res:
            tap = bilinear_sample_shifted(img, float(ox), float(oy))
        else:
            # uv offset relative to input resolution, sampled at output grid
            u = (jnp.arange(out_w, dtype=F) + F(0.5)) / F(out_w) + ox / F(w)
            v = (jnp.arange(out_h, dtype=F) + F(0.5)) / F(out_h) + oy / F(h)
            x = u * F(w) - F(0.5)
            y = v * F(h) - F(0.5)
            x0 = jnp.floor(x)
            y0 = jnp.floor(y)
            fx = (x - x0)[None, :, None]
            fy = (y - y0)[:, None, None]
            x0i = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
            x1i = jnp.clip(x0.astype(jnp.int32) + 1, 0, w - 1)
            y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
            y1i = jnp.clip(y0.astype(jnp.int32) + 1, 0, h - 1)
            top = img[y0i][:, x0i] * (F(1.0) - fx) + img[y0i][:, x1i] * fx
            bot = img[y1i][:, x0i] * (F(1.0) - fx) + img[y1i][:, x1i] * fx
            tap = top * (F(1.0) - fy) + bot * fy

        tap_len = jnp.sqrt(jnp.sum(tap * tap, axis=-1, keepdims=True))
        tap_norm = tap / jnp.maximum(tap_len, F(1e-12))

        influence = pixel_influence * pixel_influence * pixel_influence
        hue = _pow_clamped(
            F(0.5) + F(0.5) * jnp.sum(center_norm * tap_norm, axis=-1, keepdims=True),
            inverse_hue_tolerance)
        sat = _pow_clamped(F(1.0) - jnp.abs(tap_len - center_len), F(8.0))
        influence = influence * hue * sat
        if mask_taps:
            # runtime `samples` (the reference push constant): taps past
            # the live value contribute exactly zero influence — adding
            # 0.0 preserves the kept-prefix float sums bit-for-bit, so
            # the output equals the static-loop path at the same value
            influence = jnp.where(F(tap_i) <= samples_f, influence, F(0.0))

        influence_sum = influence_sum + influence
        denoised = denoised + tap * influence

    return denoised / influence_sum


def postprocess(img, config: DenoiserConfig, out_h: int, out_w: int):
    """The full presentation pass: denoise (if enabled) + resample."""
    if config.enabled:
        return denoise(
            img,
            samples=int(config.samples),
            distribution_bias=config.distribution_bias,
            pixel_multiplier=config.pixel_multiplier,
            inverse_hue_tolerance=config.inverse_hue_tolerance,
            out_shape=(out_h, out_w),
        )
    return bilinear_resample(img, out_h, out_w)
