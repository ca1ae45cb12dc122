"""Stateless shader-hash random functions.

Bit-for-bit (up to float32 transcendental rounding) port of the reference's
GLSL RNG library (reference: assets/shaders/rand.comp:1-67). Every "random"
number in the renderer is a pure hash of ray/hit positions, which maps
perfectly onto JAX's functional model: no RNG state threads through the
render step.

All functions are `xp`-generic: pass ``numpy`` for the CPU oracle or
``jax.numpy`` for the device path. Inputs/outputs are float32. Vectorized:
`co` arguments take shape (..., 2) or (..., 3) and scalars broadcast.
"""

from __future__ import annotations

import numpy as np

_F32 = np.float32

_INV_TWO_PI = _F32(0.15915494309189535)
_TWO_PI = _F32(6.283185307179586)
# odd polynomial for sin on [-pi, pi] (float32 coefficients; max abs error
# ~6e-7 evaluated in float32)
_SIN_COEFFS = (
    _F32(9.999999959767e-01),
    _F32(-1.666666504360e-01),
    _F32(8.333314513021e-03),
    _F32(-1.984031122510e-04),
    _F32(2.753229478515e-06),
    _F32(-2.470163559550e-08),
    _F32(1.353335796120e-10),
)


def _f(x, xp):
    return xp.asarray(x, dtype=_F32)


def fract(x, xp=np):
    return x - xp.floor(x)


def hsin(x, xp=np):
    """Deterministic sine for the hash family.

    The GLSL `fract(sin(x) * 43758.5453)` construction amplifies ULP-level
    differences in `sin` into completely different hash values, and GLSL
    `sin` is vendor-approximate — the reference renderer itself produces
    different bits on different GPUs. We therefore *define* the framework's
    sin-hash with an explicit range-reduced odd polynomial evaluated in
    float32, so the numpy oracle, XLA:CPU, and XLA:GPU all compute the same
    function with the same statistical quality.
    """
    x = _f(x, xp)
    q = xp.floor(x * _INV_TWO_PI + _F32(0.5))
    r = x - q * _TWO_PI
    r2 = r * r
    acc = _SIN_COEFFS[-1]
    for c in _SIN_COEFFS[-2::-1]:
        acc = acc * r2 + c
    return r * acc


def rand1(co, xp=np):
    """GLSL `Rand(float)` (rand.comp:3)."""
    return fract(hsin(co * _F32(91.3458), xp=xp) * _F32(47453.5453), xp=xp)


def rand2(co, xp=np):
    """GLSL `Rand(vec2)` (rand.comp:4). `co` shape (..., 2)."""
    d = co[..., 0] * _F32(12.9898) + co[..., 1] * _F32(78.233)
    return fract(hsin(d, xp=xp) * _F32(43758.5453), xp=xp)


def rand3(co, xp=np):
    """GLSL `Rand(vec3)` (rand.comp:5). `co` shape (..., 3)."""
    r = rand1(co[..., 2], xp=xp)
    return rand2(co[..., :2] + r[..., None], xp=xp)


def rand2_range(co, lo, hi, xp=np):
    """GLSL `Rand(vec2, min, max)` (rand.comp:6-8).

    `lo`/`hi` may be scalars or arrays broadcasting against `co[..., 0]`
    (the metal scatter passes per-ray fuzz bounds)."""
    lo = _f(lo, xp)
    hi = _f(hi, xp)
    return lo + (hi - lo) * rand2(co, xp=xp)


def rand_vec3(co, xp=np):
    """GLSL `RandVec3(vec2)` (rand.comp:9-14): chained dependent hashes."""
    x = rand2(co, xp=xp)
    y = rand2(xp.stack([co[..., 0] + x, co[..., 1] + x], axis=-1), xp=xp)
    z = rand2(xp.stack([co[..., 0] + y, co[..., 1] + y], axis=-1), xp=xp)
    return xp.stack([x, y, z], axis=-1)


def rand_vec3_range(co, lo, hi, xp=np):
    """GLSL `RandVec3(vec2, min, max)` (rand.comp:15-20)."""
    x = rand2_range(co, lo, hi, xp=xp)
    y = rand2_range(xp.stack([co[..., 0] + x, co[..., 1] + x], axis=-1), lo, hi, xp=xp)
    z = rand2_range(xp.stack([co[..., 0] + y, co[..., 1] + y], axis=-1), lo, hi, xp=xp)
    return xp.stack([x, y, z], axis=-1)


def hash12(p, xp=np):
    """GLSL `hash12(vec2)` (rand.comp:22-26). `p` shape (..., 2)."""
    px, py = p[..., 0], p[..., 1]
    p3x = fract(px * _F32(0.1031), xp=xp)
    p3y = fract(py * _F32(0.1031), xp=xp)
    p3z = fract(px * _F32(0.1031), xp=xp)
    d = p3x * (p3y + _F32(33.33)) + p3y * (p3z + _F32(33.33)) + p3z * (p3x + _F32(33.33))
    p3x = p3x + d
    p3y = p3y + d
    p3z = p3z + d
    return fract((p3x + p3y) * p3z, xp=xp)


def hash12_range(p, lo, hi, xp=np):
    """GLSL `hash12(vec2, min, max)` (rand.comp:27-29)."""
    return hash12(p, xp=xp) * (_F32(hi) - _F32(lo)) + _F32(lo)


def hash13(p, xp=np):
    """GLSL `hash13(vec3)` (rand.comp:30-35). `p` shape (..., 3)."""
    p3 = fract(p * _F32(0.1031), xp=xp)
    x, y, z = p3[..., 0], p3[..., 1], p3[..., 2]
    d = x * (z + _F32(31.32)) + y * (y + _F32(31.32)) + z * (x + _F32(31.32))
    x, y, z = x + d, y + d, z + d
    return fract((x + y) * z, xp=xp)


def hash23(p, xp=np):
    """GLSL `hash23(vec3)` (rand.comp:36-41)."""
    p3 = xp.stack(
        [
            fract(p[..., 0] * _F32(0.1031), xp=xp),
            fract(p[..., 1] * _F32(0.1030), xp=xp),
            fract(p[..., 2] * _F32(0.0973), xp=xp),
        ],
        axis=-1,
    )
    x, y, z = p3[..., 0], p3[..., 1], p3[..., 2]
    d = x * (y + _F32(33.33)) + y * (z + _F32(33.33)) + z * (x + _F32(33.33))
    x, y, z = x + d, y + d, z + d
    return xp.stack(
        [fract((x + y) * z, xp=xp), fract((x + z) * y, xp=xp)], axis=-1
    )


def hash32(p, xp=np):
    """GLSL `hash32(vec2)` (rand.comp:42-47)."""
    px, py = p[..., 0], p[..., 1]
    x = fract(px * _F32(0.1031), xp=xp)
    y = fract(py * _F32(0.1030), xp=xp)
    z = fract(px * _F32(0.0973), xp=xp)
    d = x * (y + _F32(33.33)) + y * (x + _F32(33.33)) + z * (z + _F32(33.33))
    x, y, z = x + d, y + d, z + d
    # fract((p3.xxy + p3.yzz) * p3.zyx) = ((x+y)z, (x+z)y, (y+z)x)
    return xp.stack(
        [
            fract((x + y) * z, xp=xp),
            fract((x + z) * y, xp=xp),
            fract((y + z) * x, xp=xp),
        ],
        axis=-1,
    )


def rand_in_hemisphere(co, normal, xp=np):
    """GLSL `RandInHemisphere` (rand.comp:57-63)."""
    v = rand_vec3_range(co, -1.0, 1.0, xp=xp)
    n = xp.sqrt(xp.sum(v * v, axis=-1, keepdims=True))
    unit = v / n
    same = xp.sum(unit * normal, axis=-1, keepdims=True) > 0
    return xp.where(same, unit, -unit)
