"""Denoiser and resample of zig_vulkan_tpu_torch against the JAX package's.

On CPU tensors the port's `ops.denoise` wrappers run their plain torch
twins (on the card they launch kernel F, which tests/test_torch_kernels.py
holds against these twins bit for bit; the reference's filter is XLA, not
Pallas). Same input, same knobs: the outputs agree within 1e-5 (the
jitted reference contracts multiply-adds into FMAs and evaluates `pow`
its own way); the golden image of tests/golden/denoiser_golden.npz is
held at the reference's own 2e-5 (tests/test_golden.py).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zig_vulkan_tpu.ops import denoise as rdn
from zig_vulkan_tpu_torch.config import DenoiserConfig
from zig_vulkan_tpu_torch.ops import denoise as tdn

torch.set_num_threads(2)

F = np.float32


def _img(shape, seed, lo=0.05, hi=0.95):
    return np.random.default_rng(seed).uniform(lo, hi, size=shape).astype(F)


@pytest.mark.parametrize("out_shape", [None, (12, 16), (24, 32), (9, 10)],
                         ids=["same", "same_explicit", "upscale", "downscale"])
@pytest.mark.parametrize("samples", [1, 8, 20])
def test_denoise_static_samples(out_shape, samples):
    img = _img((12, 16, 3), seed=samples)
    want = np.asarray(rdn.denoise(jnp.asarray(img), samples=samples,
                                  out_shape=out_shape))
    got = tdn.denoise(torch.from_numpy(img), samples=samples,
                      out_shape=out_shape)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("out_shape", [None, (24, 32)],
                         ids=["same", "upscale"])
@pytest.mark.parametrize("samples", [3, 20, tdn.MAX_RUNTIME_SAMPLES])
def test_denoise_runtime_samples(monkeypatch, out_shape, samples):
    """The runtime `samples` push constant over the MAX_RUNTIME_SAMPLES
    spiral (image.frag:18-23), against the reference's masked taps. On a
    finite image the masked spiral equals the static loop at the same
    value bit for bit once both weigh the taps alike: the runtime path
    computes its influences with torch's pow from the knobs
    (`runtime_influences`), the static one with numpy's on the host, and
    those two differ by an ULP on some taps; given the host's influences,
    the masked taps add exactly nothing."""
    img = _img((12, 16, 3), seed=100 + samples)
    want = np.asarray(rdn.denoise(
        jnp.asarray(img), samples=jnp.asarray(samples, jnp.float32),
        out_shape=out_shape, max_samples=rdn.MAX_RUNTIME_SAMPLES))
    got = tdn.denoise(torch.from_numpy(img), samples=float(samples),
                      out_shape=out_shape, max_samples=tdn.MAX_RUNTIME_SAMPLES)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    static = tdn.denoise(torch.from_numpy(img), samples=samples,
                         out_shape=out_shape)
    host = tdn.spiral_taps(samples)["influence"]
    n = tdn.MAX_RUNTIME_SAMPLES + 1
    # the masked taps' influences are never read: NaN shows it
    table = torch.from_numpy(np.concatenate(
        [host, np.full(n - host.size, np.nan, F)]))
    monkeypatch.setattr(tdn, "runtime_influences", lambda s, b, r2: table)
    same = tdn.denoise(torch.from_numpy(img), samples=float(samples),
                       out_shape=out_shape,
                       max_samples=tdn.MAX_RUNTIME_SAMPLES)
    assert torch.equal(same.view(torch.int32), static.view(torch.int32))


@pytest.mark.parametrize("knobs", [
    dict(distribution_bias=0.3, pixel_multiplier=2.5,
         inverse_hue_tolerance=8.0),
    dict(distribution_bias=1.0, pixel_multiplier=1.0,
         inverse_hue_tolerance=40.0),
])
def test_denoise_knobs(knobs):
    img = _img((16, 16, 3), seed=7)
    want = np.asarray(rdn.denoise(jnp.asarray(img), samples=12, **knobs))
    got = tdn.denoise(torch.from_numpy(img), samples=12, **knobs)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_denoiser_golden():
    path = os.path.join(os.path.dirname(__file__), "golden",
                        "denoiser_golden.npz")
    g = np.load(path)
    got = tdn.denoise(torch.from_numpy(g["input"]), samples=20,
                      distribution_bias=0.6, pixel_multiplier=1.5,
                      inverse_hue_tolerance=20.0)
    np.testing.assert_allclose(got.numpy(), g["output"], atol=2e-5, rtol=0)


@pytest.mark.parametrize("shift", [(0.3, -1.7), (-2.25, 0.5), (5.0, 4.0)])
def test_bilinear_sample_shifted(shift):
    img = _img((10, 13, 3), seed=11)
    want = np.asarray(rdn.bilinear_sample_shifted(jnp.asarray(img), *shift))
    got = tdn.bilinear_sample_shifted(torch.from_numpy(img), *shift)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("out_hw", [(10, 13), (20, 26), (7, 31)])
def test_bilinear_resample(out_hw):
    img = _img((10, 13, 3), seed=12)
    want = np.asarray(rdn.bilinear_resample(jnp.asarray(img), *out_hw))
    got = tdn.bilinear_resample(torch.from_numpy(img), *out_hw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("enabled", [True, False])
def test_postprocess(enabled):
    img = _img((12, 12, 3), seed=13)
    cfg_kw = dict(enabled=enabled, samples=10)
    from zig_vulkan_tpu.config import DenoiserConfig as RDenoiserConfig

    want = np.asarray(rdn.postprocess(jnp.asarray(img),
                                      RDenoiserConfig(**cfg_kw), 18, 20))
    got = tdn.postprocess(torch.from_numpy(img), DenoiserConfig(**cfg_kw),
                          18, 20)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_spiral_offsets_identical():
    assert tdn.spiral_offsets(32, 1.5) == rdn.spiral_offsets(32, 1.5)
