"""The shader-hash random functions, for the numpy oracle.

A numpy-only copy of the functions of `zig_vulkan_tpu.ops.rng` that the
oracle uses (the reference's GLSL RNG, assets/shaders/rand.comp:1-67): the
same float32 operations in the same order, so the port's oracle equals the
JAX package's bit for bit. (The port's `ops/rng.py` is the torch version,
which the traced frames use.) Inputs and outputs are float32; `co`
arguments take shape (..., 2) or (..., 3) and scalars broadcast.
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


def _f(x):
    return np.asarray(x, dtype=_F32)


def fract(x):
    return x - np.floor(x)


def hsin(x):
    """Deterministic sine for the hash family.

    The GLSL `fract(sin(x) * 43758.5453)` construction amplifies ULP-level
    differences in `sin` into completely different hash values, and GLSL
    `sin` is vendor-approximate — the reference renderer itself produces
    different bits on different GPUs. We therefore *define* the framework's
    sin-hash with an explicit range-reduced odd polynomial evaluated in
    float32, so every implementation of the renderer computes the same
    function with the same statistical quality.
    """
    x = _f(x)
    q = np.floor(x * _INV_TWO_PI + _F32(0.5))
    r = x - q * _TWO_PI
    r2 = r * r
    acc = _SIN_COEFFS[-1]
    for c in _SIN_COEFFS[-2::-1]:
        acc = acc * r2 + c
    return r * acc


def rand1(co):
    """GLSL `Rand(float)` (rand.comp:3)."""
    return fract(hsin(co * _F32(91.3458)) * _F32(47453.5453))


def rand2(co):
    """GLSL `Rand(vec2)` (rand.comp:4). `co` shape (..., 2)."""
    d = co[..., 0] * _F32(12.9898) + co[..., 1] * _F32(78.233)
    return fract(hsin(d) * _F32(43758.5453))


def rand3(co):
    """GLSL `Rand(vec3)` (rand.comp:5). `co` shape (..., 3)."""
    r = rand1(co[..., 2])
    return rand2(co[..., :2] + r[..., None])


def rand2_range(co, lo, hi):
    """GLSL `Rand(vec2, min, max)` (rand.comp:6-8).

    `lo`/`hi` may be scalars or arrays broadcasting against `co[..., 0]`
    (the metal scatter passes per-ray fuzz bounds)."""
    lo = _f(lo)
    hi = _f(hi)
    return lo + (hi - lo) * rand2(co)


def rand_vec3_range(co, lo, hi):
    """GLSL `RandVec3(vec2, min, max)` (rand.comp:15-20)."""
    x = rand2_range(co, lo, hi)
    y = rand2_range(np.stack([co[..., 0] + x, co[..., 1] + x], axis=-1), lo, hi)
    z = rand2_range(np.stack([co[..., 0] + y, co[..., 1] + y], axis=-1), lo, hi)
    return np.stack([x, y, z], axis=-1)


def hash12(p):
    """GLSL `hash12(vec2)` (rand.comp:22-26). `p` shape (..., 2)."""
    px, py = p[..., 0], p[..., 1]
    p3x = fract(px * _F32(0.1031))
    p3y = fract(py * _F32(0.1031))
    p3z = fract(px * _F32(0.1031))
    d = p3x * (p3y + _F32(33.33)) + p3y * (p3z + _F32(33.33)) + p3z * (p3x + _F32(33.33))
    p3x = p3x + d
    p3y = p3y + d
    p3z = p3z + d
    return fract((p3x + p3y) * p3z)
