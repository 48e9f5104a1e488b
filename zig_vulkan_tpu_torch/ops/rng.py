"""Stateless shader-hash random functions on torch tensors.

The torch counterpart of `zig_vulkan_tpu.ops.rng` (the reference's GLSL
RNG library, assets/shaders/rand.comp:1-67). Every "random" number in the
renderer is a pure hash of ray/hit positions, so no RNG state threads
through a frame.

The float32 operation order is that of `zig_vulkan_tpu/ops/rng.py:43-66`,
one rounding per operation. It has to be: `fract(hsin(x) * 43758.5453)`
turns a one-ULP change of its argument into a different random number.
Each torch elementwise operation rounds once on the CPU and on CUDA (no
multiply-add contraction across operations), so the same inputs give the
same bits on both devices. Inputs and outputs are float32; `co` arguments
take shape (..., 2) or (..., 3).
"""

from __future__ import annotations

import numpy as np
import torch

_F32 = np.float32

_INV_TWO_PI = float(_F32(0.15915494309189535))
_TWO_PI = float(_F32(6.283185307179586))
# odd polynomial for sin on [-pi, pi], float32 coefficients (the reference's)
_SIN_COEFFS = tuple(float(_F32(c)) for c in (
    9.999999959767e-01,
    -1.666666504360e-01,
    8.333314513021e-03,
    -1.984031122510e-04,
    2.753229478515e-06,
    -2.470163559550e-08,
    1.353335796120e-10,
))


def fract(x):
    return x - torch.floor(x)


def hsin(x):
    """Deterministic sine for the hash family: a range-reduced odd
    polynomial in float32 (see zig_vulkan_tpu.ops.rng.hsin)."""
    q = torch.floor(x * _INV_TWO_PI + 0.5)
    r = x - q * _TWO_PI
    r2 = r * r
    acc = torch.full_like(r, _SIN_COEFFS[-1])
    for c in _SIN_COEFFS[-2::-1]:
        acc = acc * r2 + c
    return r * acc


def rand1(co):
    """GLSL `Rand(float)` (rand.comp:3)."""
    return fract(hsin(co * float(_F32(91.3458))) * float(_F32(47453.5453)))


def rand2(co):
    """GLSL `Rand(vec2)` (rand.comp:4). `co` shape (..., 2)."""
    d = co[..., 0] * float(_F32(12.9898)) + co[..., 1] * float(_F32(78.233))
    return fract(hsin(d) * float(_F32(43758.5453)))


def rand3(co):
    """GLSL `Rand(vec3)` (rand.comp:5). `co` shape (..., 3)."""
    r = rand1(co[..., 2])
    return rand2(co[..., :2] + r[..., None])


def rand2_range(co, lo, hi):
    """GLSL `Rand(vec2, min, max)` (rand.comp:6-8). `lo`/`hi` are float32
    scalars or tensors broadcasting against `co[..., 0]`; `hi - lo` is
    rounded to float32 as the reference does."""
    if torch.is_tensor(lo):
        return lo + (hi - lo) * rand2(co)
    span = float(_F32(hi) - _F32(lo))
    return float(_F32(lo)) + span * rand2(co)


def rand_vec3_range(co, lo, hi):
    """GLSL `RandVec3(vec2, min, max)` (rand.comp:15-20): chained
    dependent hashes. Returns shape (..., 3)."""
    x = rand2_range(co, lo, hi)
    y = rand2_range(torch.stack([co[..., 0] + x, co[..., 1] + x], dim=-1),
                    lo, hi)
    z = rand2_range(torch.stack([co[..., 0] + y, co[..., 1] + y], dim=-1),
                    lo, hi)
    return torch.stack([x, y, z], dim=-1)


def hash12(p):
    """GLSL `hash12(vec2)` (rand.comp:22-26). `p` shape (..., 2)."""
    k = float(_F32(0.1031))
    c = float(_F32(33.33))
    px, py = p[..., 0], p[..., 1]
    p3x = fract(px * k)
    p3y = fract(py * k)
    p3z = fract(px * k)
    d = p3x * (p3y + c) + p3y * (p3z + c) + p3z * (p3x + c)
    p3x = p3x + d
    p3y = p3y + d
    p3z = p3z + d
    return fract((p3x + p3y) * p3z)


def rand_vec3(co):
    """GLSL `RandVec3(vec2)` (rand.comp:9-14): chained dependent hashes.
    Returns shape (..., 3)."""
    x = rand2(co)
    y = rand2(torch.stack([co[..., 0] + x, co[..., 1] + x], dim=-1))
    z = rand2(torch.stack([co[..., 0] + y, co[..., 1] + y], dim=-1))
    return torch.stack([x, y, z], dim=-1)


def hash12_range(p, lo, hi):
    """GLSL `hash12(vec2, min, max)` (rand.comp:27-29); `hi - lo` is
    rounded to float32 as the reference does."""
    return hash12(p) * float(_F32(hi) - _F32(lo)) + float(_F32(lo))


def hash13(p):
    """GLSL `hash13(vec3)` (rand.comp:30-35). `p` shape (..., 3)."""
    c = float(_F32(31.32))
    p3 = fract(p * float(_F32(0.1031)))
    x, y, z = p3[..., 0], p3[..., 1], p3[..., 2]
    d = x * (z + c) + y * (y + c) + z * (x + c)
    x, y, z = x + d, y + d, z + d
    return fract((x + y) * z)


def hash23(p):
    """GLSL `hash23(vec3)` (rand.comp:36-41). Returns shape (..., 2)."""
    c = float(_F32(33.33))
    x = fract(p[..., 0] * float(_F32(0.1031)))
    y = fract(p[..., 1] * float(_F32(0.1030)))
    z = fract(p[..., 2] * float(_F32(0.0973)))
    d = x * (y + c) + y * (z + c) + z * (x + c)
    x, y, z = x + d, y + d, z + d
    return torch.stack([fract((x + y) * z), fract((x + z) * y)], dim=-1)


def hash32(p):
    """GLSL `hash32(vec2)` (rand.comp:42-47). Returns shape (..., 3)."""
    c = float(_F32(33.33))
    px, py = p[..., 0], p[..., 1]
    x = fract(px * float(_F32(0.1031)))
    y = fract(py * float(_F32(0.1030)))
    z = fract(px * float(_F32(0.0973)))
    d = x * (y + c) + y * (x + c) + z * (z + c)
    x, y, z = x + d, y + d, z + d
    # fract((p3.xxy + p3.yzz) * p3.zyx) = ((x+y)z, (x+z)y, (y+z)x)
    return torch.stack(
        [fract((x + y) * z), fract((x + z) * y), fract((y + z) * x)], dim=-1)


def rand_in_hemisphere(co, normal):
    """GLSL `RandInHemisphere` (rand.comp:57-63): a unit vector on the
    side of `normal`. The square root then the division round once each;
    a backend's `sqrt` may be off by one ULP."""
    v = rand_vec3_range(co, -1.0, 1.0)
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    unit = v / n
    same = torch.sum(unit * normal, dim=-1, keepdim=True) > 0
    return torch.where(same, unit, -unit)
