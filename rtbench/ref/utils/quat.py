"""Quaternion / small vector math.

Frozen copy of `zig_vulkan_tpu_torch/utils/quat.py` for the benchmark's plain
reference (`rtbench.ref`), which imports nothing of the port: kernel
wrappers run their plain torch twins on every device.

Replacement for the zalgebra vec/quat package used by the
reference renderer (reference: build.zig.zon pins `zalgebra`; consumers are
Camera.zig, Sun.zig, Benchmark.zig). Conventions follow zalgebra so that
camera orientation, sun animation, and the benchmark fly-through reproduce
the reference's behavior:

- quaternions are (w, x, y, z);
- `from_euler_angles` takes DEGREES and composes z * (y * x) with
  right=(1,0,0), up=(0,1,0), forward=(0,0,1) axes;
- `lerp` is component-wise (NOT normalized: the benchmark path relies on
  this, reference Benchmark.zig:62), `slerp` is the standard spherical lerp
  used by the sun (reference Sun.zig:72);
- `rotate_vec` normalizes the quaternion first (reference Camera.zig:116).

Everything is written against the ``numpy``-compatible API so the same
functions work with any NumPy-compatible array module; pass it via
``xp`` (the port calls them with ``numpy`` on the host). All math is float32 to match Zig `f32`.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "quat_identity",
    "quat_from_axis_angle",
    "quat_from_euler_angles",
    "quat_mul",
    "quat_norm",
    "quat_rotate_vec",
    "quat_slerp",
    "quat_lerp",
    "normalize",
    "cross",
    "lerp",
]

_F32 = np.float32


def normalize(v, xp=np):
    n = xp.sqrt(xp.sum(v * v, axis=-1, keepdims=True))
    return (v / n).astype(_F32)


def cross(a, b, xp=np):
    return xp.cross(a, b).astype(_F32)


def lerp(a, b, t):
    """Component-wise linear interpolation (zalgebra `lerp`)."""
    t = _F32(t) if np.isscalar(t) else t
    return a + (b - a) * t


def quat_identity(xp=np):
    return xp.asarray([1.0, 0.0, 0.0, 0.0], dtype=_F32)


def quat_from_axis_angle(degrees, axis, xp=np):
    """zalgebra `Quat.fromAxis(degrees, axis)` — axis-angle, degrees input."""
    axis = normalize(xp.asarray(axis, dtype=_F32), xp=xp)
    half = _F32(np.float32(degrees) * np.float32(np.pi) / np.float32(180.0) * np.float32(0.5))
    s = xp.sin(half).astype(_F32) if hasattr(xp.sin(half), "astype") else _F32(np.sin(half))
    c = xp.cos(half).astype(_F32) if hasattr(xp.cos(half), "astype") else _F32(np.cos(half))
    return xp.concatenate([xp.reshape(c, (1,)), axis * s]).astype(_F32)


def quat_from_euler_angles(deg_x, deg_y, deg_z, xp=np):
    """zalgebra `Quat.fromEulerAngles(vec3 degrees)` = z.mul(y.mul(x))."""
    qx = quat_from_axis_angle(deg_x, [1.0, 0.0, 0.0], xp=xp)
    qy = quat_from_axis_angle(deg_y, [0.0, 1.0, 0.0], xp=xp)
    qz = quat_from_axis_angle(deg_z, [0.0, 0.0, 1.0], xp=xp)
    return quat_mul(qz, quat_mul(qy, qx, xp=xp), xp=xp)


def quat_mul(a, b, xp=np):
    """Hamilton product a*b for (w,x,y,z) quaternions."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return xp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    ).astype(_F32)


def quat_norm(q, xp=np):
    n = xp.sqrt(xp.sum(q * q, axis=-1, keepdims=True))
    return (q / n).astype(_F32)


def quat_rotate_vec(q, v, xp=np):
    """Rotate vec3 `v` by quaternion `q` (normalizing q first, like zalgebra)."""
    q = quat_norm(q, xp=xp)
    w = q[..., 0:1]
    b = q[..., 1:4]
    b2 = xp.sum(b * b, axis=-1, keepdims=True)
    return (
        v * (w * w - b2)
        + b * (xp.sum(v * b, axis=-1, keepdims=True) * _F32(2.0))
        + cross(b, v, xp=xp) * (w * _F32(2.0))
    ).astype(_F32)


def quat_slerp(a, b, t, xp=np):
    """Spherical interpolation with shortest-path sign flip."""
    t = _F32(t)
    dot = xp.sum(a * b, axis=-1)
    b = xp.where(dot < 0, -b, b)
    dot = xp.abs(dot)
    dot = xp.minimum(dot, _F32(1.0))
    theta = xp.arccos(dot).astype(_F32)
    sin_theta = xp.sin(theta).astype(_F32)
    # fall back to lerp when nearly parallel
    use_lerp = sin_theta < _F32(1e-5)
    wa = xp.where(use_lerp, _F32(1.0) - t, xp.sin((_F32(1.0) - t) * theta) / xp.where(use_lerp, _F32(1.0), sin_theta))
    wb = xp.where(use_lerp, t, xp.sin(t * theta) / xp.where(use_lerp, _F32(1.0), sin_theta))
    return (a * wa + b * wb).astype(_F32)


def quat_lerp(a, b, t):
    """Component-wise quaternion lerp (zalgebra `Quat.lerp`); NOT normalized."""
    return lerp(a, b, t).astype(_F32)

