"""Shader-hash RNG and camera rays of zig_vulkan_tpu_torch against the JAX
package's.

The port keeps the float32 operation order of `zig_vulkan_tpu.ops.rng`,
one rounding per operation, so the results are bit-identical to the
reference evaluated op by op: eagerly on jax.numpy and on numpy. Under
`jax.jit` XLA:CPU contracts `a*b + c` into fused multiply-adds and
rewrites division by a constant as a multiply by its reciprocal, which the
sin hash amplifies into different random numbers; the port, like its CUDA
kernels (built with --fmad=false), follows the op-by-op rounding.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zig_vulkan_tpu.config import CameraConfig
from zig_vulkan_tpu.core.camera import Camera
from zig_vulkan_tpu.ops import rng as rrng
from zig_vulkan_tpu.ops import trace as rtrace
from zig_vulkan_tpu_torch.ops import rng as trng
from zig_vulkan_tpu_torch.ops import trace as ttrace

torch.set_num_threads(2)

_N = 20000


def _inputs(shape, scale, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("name,shape", [
    ("hsin", (_N,)),
    ("fract", (_N,)),
    ("rand1", (_N,)),
    ("rand2", (_N, 2)),
    ("rand3", (_N, 3)),
    ("hash12", (_N, 2)),
])
@pytest.mark.parametrize("scale", [1.0, 60.0, 3000.0])
def test_hash_bit_exact(name, shape, scale):
    x = _inputs(shape, scale, seed=len(name))
    ref_fn, port_fn = getattr(rrng, name), getattr(trng, name)
    want_jnp = np.asarray(ref_fn(jnp.asarray(x), xp=jnp))
    want_np = ref_fn(x, xp=np)
    got = port_fn(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want_jnp)
    np.testing.assert_array_equal(got.numpy(), want_np)


@pytest.mark.parametrize("bounds", ["scalar", "tensor"])
def test_rand_vec3_range_bit_exact(bounds):
    co = _inputs((_N, 2), 40.0, seed=7)
    if bounds == "scalar":
        lo_r = lo_t = -0.4
        hi_r = hi_t = 0.4
    else:  # per-lane bounds, as the metal fuzz passes them
        fuzz = np.random.default_rng(8).random(_N).astype(np.float32)
        lo_r, hi_r = -jnp.asarray(fuzz), jnp.asarray(fuzz)
        lo_t, hi_t = -torch.from_numpy(fuzz), torch.from_numpy(fuzz)
    want = np.asarray(rrng.rand_vec3_range(jnp.asarray(co), lo_r, hi_r,
                                           xp=jnp))
    got = trng.rand_vec3_range(torch.from_numpy(co), lo_t, hi_t)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sample_index", [0, 1, 5.0])
@pytest.mark.parametrize("size", [(40, 24), (17, 9)])
def test_camera_rays_bit_exact(sample_index, size):
    w, h = size
    cam = Camera(75.0, w, h, CameraConfig(origin=(1.0, 2.0, 3.0)))
    cam.turn_yaw(0.3)
    cam.turn_pitch(0.2)
    want = rtrace._camera_rays_soa(rtrace.camera_vectors(cam.d_camera), w, h,
                                   sample_index)
    tcam = ttrace.camera_vectors(cam.d_camera, "cpu")
    for name, v in tcam.items():
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(getattr(cam.d_camera, name)))
    got = ttrace._camera_rays_soa(tcam, w, h, sample_index)
    assert len(got) == 6
    for a, b in zip(got, want):
        assert a.shape == (w * h,)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

