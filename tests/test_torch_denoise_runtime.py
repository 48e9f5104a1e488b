"""The denoiser's runtime path of zig_vulkan_tpu_torch against the JAX
package's.

The JAX engine's step reads the denoiser's `samples`, `distribution_bias`
and `inverse_hue_tolerance` from its push constants and runs
`denoise(..., max_samples=32)`: the spiral's 33 taps, those past `samples`
masked by a zero-influence select that still adds tap * 0 (so a NaN or an
infinity under a masked tap's footprint makes the pixel NaN). The port's
runtime twin (`ops.denoise.denoise_plain` with `max_samples`, the knobs as
0-d tensors) is what kernel F's runtime builds are held against on the
card. Here the same seeded numpy images go through both, the JAX function
under `jax.disable_jit()` (op by op, as the JAX tests' references run):

- the set of non-finite output pixels is the same;
- every other value agrees within 1e-5 of the image's range, the bound of
  tests/test_torch_postprocess.py (XLA's `pow` and torch's differ in the
  last bits);

at equal size and resampled as 1024x576 to 1280x720 is (5/4 a side, at
small sizes), at `samples` 1, 8, 20 and 32, at the hue exponents ATen's
scalar pow treats apart (1, 2, 0.5, 3) and at powf's (20, 7.3), at two
biases, on finite images and on images with planted Inf and NaN pixels.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zig_vulkan_tpu.ops import denoise as rdn
from zig_vulkan_tpu_torch.config import DenoiserConfig
from zig_vulkan_tpu_torch.ops import denoise as tdn

torch.set_num_threads(2)

F = np.float32
H, W = 24, 32
SHAPES = {"same": None, "resampled": (30, 40)}  # 1024x576 -> 1280x720 is 5/4
# planted pixels: an infinity and a NaN, each more than 3.35 pixels (tap
# 20's reach at pixel_multiplier 1.5) and less than 4.24 (tap 32's) from
# some output pixels
INF_AT, NAN_AT = (6, 9), (17, 22)


def _img(kind, seed=5):
    img = np.random.default_rng(seed).uniform(0.05, 0.95, (H, W, 3)) \
        .astype(F)
    if kind == "nonfinite":
        img[INF_AT + (0,)] = np.inf
        img[NAN_AT + (2,)] = np.nan
    return img


def _jax(img, samples, bias=0.6, hue=20.0, out_shape=None):
    with jax.disable_jit():
        return np.asarray(rdn.denoise(
            jnp.asarray(img), samples=jnp.float32(samples),
            distribution_bias=jnp.float32(bias),
            inverse_hue_tolerance=jnp.float32(hue), out_shape=out_shape,
            max_samples=rdn.MAX_RUNTIME_SAMPLES))


def _port(img, samples, bias=0.6, hue=20.0, out_shape=None):
    knobs = (torch.tensor(F(v)) for v in (samples, bias, hue))
    s, b, h = knobs
    return tdn.denoise(torch.from_numpy(img), samples=s, distribution_bias=b,
                       inverse_hue_tolerance=h, out_shape=out_shape,
                       max_samples=tdn.MAX_RUNTIME_SAMPLES).numpy()


def _agree(got, want):
    """The same non-finite pixels (NaN in the same places, infinities equal),
    every finite value within 1e-5 of the image's range (at most 1)."""
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    assert np.array_equal(got[np.isinf(got)], want[np.isinf(want)])
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["finite", "nonfinite"])
@pytest.mark.parametrize("samples", [1, 8, 20, 32])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_runtime_twin_against_jax(shape, samples, kind):
    img = _img(kind, seed=samples)
    out_shape = SHAPES[shape]
    want = _jax(img, samples, out_shape=out_shape)
    _agree(_port(img, samples, out_shape=out_shape), want)
    if kind == "nonfinite":
        assert not np.isfinite(want).all() and np.isfinite(want).any()


@pytest.mark.parametrize("hue", [1.0, 2.0, 0.5, 3.0, 20.0, 7.3])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_runtime_twin_hue_exponents(shape, hue):
    """The hue's exponent as a 0-d tensor: ATen's pow runs powf for it, not
    the branches it takes for a scalar exponent, on a non-finite image."""
    img = _img("nonfinite", seed=int(hue * 10))
    out_shape = SHAPES[shape]
    _agree(_port(img, 8, hue=hue, out_shape=out_shape),
           _jax(img, 8, hue=hue, out_shape=out_shape))


@pytest.mark.parametrize("kind", ["finite", "nonfinite"])
@pytest.mark.parametrize("bias", [0.3, 1.0])
def test_runtime_twin_biases(bias, kind):
    img = _img(kind, seed=int(bias * 10))
    for out_shape in SHAPES.values():
        _agree(_port(img, 20, bias=bias, out_shape=out_shape),
               _jax(img, 20, bias=bias, out_shape=out_shape))


def test_masked_taps_spread_nan_as_jax():
    """Taps 21-32 are masked at samples 20 but still add tap * 0: the
    pixels whose masked taps read the planted Inf or NaN are NaN in the JAX
    package, and in the port (the static loop, which runs 21 taps, leaves
    them finite)."""
    img = _img("nonfinite")
    want = _jax(img, 20)
    got = _port(img, 20)
    _agree(got, want)
    static = tdn.denoise(torch.from_numpy(img), samples=20).numpy()
    bad = ~np.isfinite(want).all(axis=-1)
    assert bad.sum() > (~np.isfinite(static).all(axis=-1)).sum()
    # pixels only the masked taps reach: finite in the static loop, NaN here
    only_masked = bad & np.isfinite(static).all(axis=-1)
    assert only_masked.any()
    assert np.isnan(got[only_masked]).any(axis=-1).all()


def test_samples_zero_is_what_jax_gives():
    """samples 0: sqrt(0) makes the true radius infinite and tap 0's
    influence NaN (0.5 / 0 * 0); every tap past it is masked. Every pixel
    is NaN in both packages."""
    img = _img("finite")
    want = _jax(img, 0)
    assert np.isnan(want).all()
    _agree(_port(img, 0), want)


@pytest.mark.parametrize("bias", [0.6, 0.3, 1.0])
@pytest.mark.parametrize("samples", [1, 8, 20, 32])
def test_runtime_influences_against_jax(samples, bias):
    """Each tap's influence from the knobs (`runtime_influences`, what
    kernel F's runtime builds compute on the device) within 2^-22 of the
    JAX `_sir_bird`'s pixel_influence cubed run op by op: XLA's pow and
    torch's differ by one ULP on some taps and the cube spreads it
    (tests/test_torch_postprocess.py holds the host table the same way)."""
    offsets = rdn.spiral_offsets(rdn.MAX_RUNTIME_SAMPLES, 1.5)
    ox, oy = (np.array(v, F) for v in zip(*offsets))
    taps = tdn.spiral_taps(float(samples), bias, 1.5, W, H, max_samples=32)
    assert "influence" not in taps and len(taps["r2"]) == 33
    np.testing.assert_array_equal(taps["r2"], ox * ox + oy * oy)
    got = tdn.runtime_influences(torch.tensor(F(samples)),
                                 torch.tensor(F(bias)),
                                 torch.from_numpy(taps["r2"])).numpy()
    with jax.disable_jit():
        radius = jnp.sqrt(jnp.float32(samples))
        true_radius = F(0.5) / (radius * radius)
        p = F(1.0) - true_radius * rdn._pow_clamped(
            jnp.asarray(ox * ox + oy * oy), jnp.float32(bias))
        want = np.asarray(p * p * p)
    np.testing.assert_allclose(got, want, atol=2**-22, rtol=0)


def test_knobs_as_numbers_or_tensors():
    """The runtime path with the knobs as Python numbers equals it with
    them as 0-d tensors, bit for bit; `postprocess` with `max_samples`
    takes them from its config."""
    img = torch.from_numpy(_img("nonfinite"))
    want = tdn.denoise(img, samples=torch.tensor(12.0),
                       distribution_bias=torch.tensor(F(0.45)),
                       inverse_hue_tolerance=torch.tensor(3.0),
                       out_shape=(30, 40), max_samples=32)
    got = tdn.denoise(img, samples=12.0, distribution_bias=0.45,
                      inverse_hue_tolerance=3.0, out_shape=(30, 40),
                      max_samples=32)
    cfg = DenoiserConfig(samples=torch.tensor(12.0),
                         distribution_bias=torch.tensor(F(0.45)),
                         inverse_hue_tolerance=torch.tensor(3.0))
    post = tdn.postprocess(img, cfg, 30, 40, max_samples=32)
    plain = tdn.postprocess_plain(img, cfg, 30, 40, max_samples=32)
    for x in (got, post, plain):
        assert torch.equal(x.view(torch.int32), want.view(torch.int32))
    with pytest.raises(ValueError, match="0-d"):
        tdn.denoise(img, samples=torch.tensor([12.0]), max_samples=32)


@pytest.mark.parametrize("out_hw", [(48, 64), (60, 96)],
                         ids=["same", "resampled"])
def test_runtime_bands_equal_the_whole_image(out_hw):
    """Bands of the runtime path from slabs of `band_input_rows` with the
    33-tap spiral's halo: the rows of the whole image's result bit for bit
    (widths of whole 32-float vectors: see test_torch_parallel.py), the
    planted NaN spread as in the whole image."""
    h, w = 48, 64
    img = np.random.default_rng(9).uniform(0.05, 0.95, (h, w, 3)).astype(F)
    img[20, 30, 1] = np.nan
    out_h, out_w = out_hw
    cfg = DenoiserConfig(samples=torch.tensor(6.0),
                         distribution_bias=torch.tensor(F(0.6)),
                         inverse_hue_tolerance=torch.tensor(20.0))
    whole = tdn.postprocess(torch.from_numpy(img), cfg, out_h, out_w,
                            max_samples=32)
    taps = tdn.spiral_taps(6.0, width=w, height=h, max_samples=32)
    mode = tdn.SHIFTED if out_hw == (h, w) else tdn.RESAMPLE
    for r0, r1 in ((0, out_h // 3), (out_h // 3, out_h - 3),
                   (out_h - 3, out_h)):
        a, b = tdn.band_input_rows(r0, r1, out_h, h, cfg, max_samples=32)
        lo, hi = tdn.rows_read(taps, mode, r0, r1, out_h, h)
        assert a <= lo < hi <= b
        band = tdn.postprocess(torch.from_numpy(img[a:b].copy()), cfg,
                               out_h, out_w, band=tdn.Band(r0, r1, a, h),
                               max_samples=32)
        assert torch.equal(band.view(torch.int32),
                           whole[r0:r1].view(torch.int32))
    assert torch.isnan(whole).any()
