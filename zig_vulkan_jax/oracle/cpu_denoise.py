"""CPU reference denoiser (the parity oracle for ops.denoise).

A numpy transliteration of the reference's post-process fragment shader
(reference: assets/shaders/image.frag:31-71, the golden-angle spiral
"sirBirdDenoise"), evaluated for every pixel at once and kept independent
of the JAX implementation: it samples with the shader's own clamp-to-edge
`texture()` arithmetic at each pixel's uv, where ops.denoise decomposes
each tap into static shifted slices.

The spiral offsets are formed in float32 as the shader forms them; the
filter arithmetic runs in float64, so the result is the shader's value to
within float32 rounding of the device code. This module must stay
numpy-only (no JAX).
"""

from __future__ import annotations

import numpy as np

F = np.float32

GOLDEN_ANGLE = 2.3999632  # 3PI - sqrt(5)PI (image.frag:25)


def _texture(img, u, v):
    """Clamp-to-edge bilinear texture() lookup at uv arrays."""
    h, w, _ = img.shape
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = np.floor(x)
    y0 = np.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    xi0 = np.clip(x0.astype(np.int64), 0, w - 1)
    xi1 = np.clip(x0.astype(np.int64) + 1, 0, w - 1)
    yi0 = np.clip(y0.astype(np.int64), 0, h - 1)
    yi1 = np.clip(y0.astype(np.int64) + 1, 0, h - 1)
    top = img[yi0, xi0] * (1 - fx) + img[yi0, xi1] * fx
    bot = img[yi1, xi0] * (1 - fx) + img[yi1, xi1] * fx
    return top * (1 - fy) + bot * fy


def sir_bird(img, samples: int = 20, distribution_bias: float = 0.6,
             pixel_multiplier: float = 1.5,
             inverse_hue_tolerance: float = 20.0) -> np.ndarray:
    """image.frag:31-71 over an f[H, W, 3] image at its own resolution.

    Returns float64[H, W, 3]."""
    img = np.asarray(img, dtype=np.float64)
    h, w, _ = img.shape
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    u = (xs + 0.5) / w
    v = (ys + 0.5) / h
    center = _texture(img, u, v)
    center_len = np.linalg.norm(center, axis=-1, keepdims=True)
    center_norm = center / np.maximum(center_len, 1e-12)

    c = F(np.cos(GOLDEN_ANGLE))
    s = F(np.sin(GOLDEN_ANGLE))
    sample_radius = np.sqrt(F(samples))
    sample_true_radius = 0.5 / (float(sample_radius) ** 2)

    influence_sum = np.zeros((h, w, 1))
    denoised = np.zeros((h, w, 3))
    rx, ry = F(0.0), F(1.0)
    for x in range(samples + 1):
        rx, ry = c * rx - s * ry, s * rx + c * ry
        r = F(pixel_multiplier) * np.sqrt(F(x)) * F(0.5)
        ox, oy = float(rx * r), float(ry * r)
        infl = 1.0 - sample_true_radius * max(ox * ox + oy * oy,
                                              0.0) ** distribution_bias
        tap = _texture(img, u + ox / w, v + oy / h)
        tap_len = np.linalg.norm(tap, axis=-1, keepdims=True)
        tap_norm = tap / np.maximum(tap_len, 1e-12)
        hue = np.maximum(
            0.5 + 0.5 * np.sum(center_norm * tap_norm, axis=-1,
                               keepdims=True), 0.0) ** inverse_hue_tolerance
        sat = np.maximum(1.0 - np.abs(tap_len - center_len), 0.0) ** 8.0
        infl = infl ** 3 * hue * sat
        influence_sum += infl
        denoised += tap * infl
    return denoised / influence_sum
