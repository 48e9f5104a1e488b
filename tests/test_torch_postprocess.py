"""Kernel F's host side and the plain post-process against the JAX package.

Kernel F (csrc/denoise.cu) runs only on the card; here its wrapper's host
work is held on the CPU: the tap table (`ops.denoise.spiral_taps`) against
the JAX package's spiral and the scalars the port's plain filter multiplies
in, bit for bit (the runtime path's influences from `runtime_influences`,
which tests/test_torch_denoise_runtime.py holds against the JAX package); the argument struct's ctypes layout against the C struct
parsed from the source; the rows a launch reads (`rows_read`) against
`band_input_rows`. The plain post-process (what kernel F is held against on
the card) is held against the JAX package in the cases test_torch_denoise.py
does not cover: a zero image, NaN and HDR values, the exponents ATen's pow
treats apart, a band of the resampling path and of the resample alone.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zig_vulkan_tpu.config import DenoiserConfig as RDenoiserConfig
from zig_vulkan_tpu.ops import denoise as rdn
from zig_vulkan_tpu_torch import _build
from zig_vulkan_tpu_torch.config import DenoiserConfig
from zig_vulkan_tpu_torch.ops import denoise as tdn

torch.set_num_threads(2)

F = np.float32


def _img(shape, seed, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, size=shape).astype(F)


# -- the tap table ----------------------------------------------------------------

_TABLE_CASES = [
    # (samples, max_samples): the static loop, and the runtime value over
    # the masked MAX_RUNTIME_SAMPLES spiral
    (1, None), (8, None), (20, None), (32, None),
    (1.0, 32), (8.0, 32), (20.0, 32), (32.0, 32), (5.5, 32),
]


def _weights(taps, samples, max_samples, bias=0.6):
    """Each tap's influence as the plain filter weighs it: the static
    table's `influence`; on the runtime path `runtime_influences` of the
    table's `r2`, 0 past `samples` (a masked tap)."""
    if max_samples is None:
        return taps["influence"]
    infl = tdn.runtime_influences(torch.tensor(F(samples)),
                                  torch.tensor(F(bias)),
                                  torch.from_numpy(taps["r2"])).numpy()
    live = np.arange(infl.size, dtype=F) <= F(samples)
    return np.where(live, infl, F(0.0)).astype(F)


def _sir_bird_scalars(monkeypatch, samples, max_samples, same_res,
                      pixel_multiplier=1.5, bias=0.6, table=None):
    """What the port's plain filter uses for each tap, read from a run of
    it: the offsets it samples at, and (hue and saturation replaced by
    ones, tap k's image one-hot at pixel k) output pixel k, which is then
    influence_k / the sum of the influences. On the runtime path its
    influences are `runtime_influences` of the tap table `table`'s r2,
    computed before the pow is replaced (the stand-in checks it gets that
    r2 and the knobs)."""
    n, offsets = 40, []
    if max_samples is not None:
        infl = tdn.runtime_influences(torch.tensor(F(samples)),
                                      torch.tensor(F(bias)),
                                      torch.from_numpy(table["r2"]))

        def influences(s, b, r2):
            assert torch.equal(r2, torch.from_numpy(table["r2"]))
            assert float(s) == F(samples) and float(b) == F(bias)
            return infl

        monkeypatch.setattr(tdn, "runtime_influences", influences)

    def one_hot(ox, oy):
        t = torch.zeros(1, n, 3)
        t[0, len(offsets)] = 1.0
        offsets.append((ox, oy))
        return t

    def shifted(img, dx, dy, band=None):
        return one_hot(dx, dy)

    def resampled(img, out_h, out_w, ox=None, oy=None, band=None):
        return torch.ones(1, n, 3) if ox is None else one_hot(ox, oy)

    monkeypatch.setattr(tdn, "bilinear_sample_shifted", shifted)
    monkeypatch.setattr(tdn, "_resample_taps", resampled)
    monkeypatch.setattr(tdn, "_pow_clamped", lambda a, b: torch.ones_like(a))
    img = torch.ones(1, n if same_res else 3, 3)
    out = tdn.denoise_plain(img, samples=samples, max_samples=max_samples,
                            pixel_multiplier=pixel_multiplier,
                            distribution_bias=bias, out_shape=(1, n))
    return offsets, out[0, :len(offsets), 0].numpy()


@pytest.mark.parametrize("samples,max_samples", _TABLE_CASES)
@pytest.mark.parametrize("same_res", [True, False],
                         ids=["shifted", "resampling"])
def test_tap_table_is_what_sir_bird_computes(monkeypatch, samples,
                                             max_samples, same_res):
    w, h = 37, 23
    taps = tdn.spiral_taps(samples, 0.6, 1.5, w, h, max_samples)
    offsets, ratios = _sir_bird_scalars(monkeypatch, samples, max_samples,
                                        same_res, table=taps)
    assert len(offsets) == len(taps["x0"])
    for i, (ox, oy) in enumerate(offsets):
        if same_res:  # bilinear_sample_shifted's shifts and fractions
            x0, y0 = int(np.floor(ox)), int(np.floor(oy))
            assert (taps["x0"][i], taps["y0"][i]) == (x0, y0)
            assert taps["fx"][i] == F(ox - x0) and taps["fy"][i] == F(oy - y0)
            assert taps["gx"][i] == F(1.0) - F(ox - x0)
            assert taps["gy"][i] == F(1.0) - F(oy - y0)
        else:  # _sample_coords' texture-coordinate offsets
            assert taps["ou"][i] == F(ox) / F(w)
            assert taps["ov"][i] == F(oy) / F(h)
    weights = _weights(taps, samples, max_samples)
    total = F(0.0)
    for v in weights:
        total = F(total + v)
    want = (weights / total).astype(F)
    assert np.array_equal(ratios.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("samples,max_samples", _TABLE_CASES)
@pytest.mark.parametrize("pixel_multiplier", [1.0, 1.5, 3.0])
def test_tap_table_against_the_jax_spiral(samples, max_samples,
                                          pixel_multiplier):
    """Shifts, fractions, resample offsets and r2 bit for bit from the JAX
    package's `spiral_offsets`, every tap of the spiral (the runtime path's
    table holds the masked taps too); the static table's influences within
    2^-22 (two float32 spacings below 1) of the JAX `_sir_bird`'s run op by
    op: its `jnp.power` and the port's `np.power` differ by one ULP on some
    offsets, as the plain versions do, and the cube spreads it (measured:
    1.8e-7 at most). The runtime table has no influence: the device
    computes it (tests/test_torch_denoise_runtime.py)."""
    w, h = 64, 48
    taps = tdn.spiral_taps(samples, 0.6, pixel_multiplier, w, h, max_samples)
    n_taps = (samples if max_samples is None else max_samples) + 1
    live = [(F(ox), F(oy)) for ox, oy in
            rdn.spiral_offsets(int(n_taps) - 1, pixel_multiplier)]
    ox, oy = (np.array(v, F) for v in zip(*live))
    # as the JAX bilinear_sample_shifted computes them: an int shift, the
    # fraction in float64 rounded to float32 (tap 0's -0.0 keeps its sign)
    x0 = [int(np.floor(float(v))) for v in ox]
    y0 = [int(np.floor(float(v))) for v in oy]
    assert taps["x0"].tolist() == x0 and taps["y0"].tolist() == y0
    fx = np.array([float(v) - i for v, i in zip(ox, x0)]).astype(F)
    fy = np.array([float(v) - i for v, i in zip(oy, y0)]).astype(F)
    for k, want in (("fx", fx), ("fy", fy), ("gx", F(1.0) - fx),
                    ("gy", F(1.0) - fy), ("ou", ox / F(w)),
                    ("ov", oy / F(h)), ("r2", ox * ox + oy * oy)):
        assert np.array_equal(taps[k].view(np.int32),
                              want.astype(F).view(np.int32)), k
    if max_samples is not None:
        assert "influence" not in taps
        return
    with jax.disable_jit():
        radius = jnp.sqrt(jnp.float32(samples))
        true_radius = F(0.5) / (radius * radius)
        p = F(1.0) - true_radius * rdn._pow_clamped(
            jnp.asarray(ox * ox + oy * oy), jnp.float32(0.6))
        want = np.asarray(p * p * p)
    np.testing.assert_allclose(taps["influence"], want, atol=2**-22, rtol=0)


def test_pow_branches_are_atens():
    """The exponents ATen's tensor-scalar pow treats apart on CUDA, in the
    order it tests them; powf for the rest (the saturation's 8, the hue's
    default 20)."""
    assert [tdn.pow_branch(e) for e in
            (0.0, -0.0, 1.0, 0.5, -0.5, -1.0, 2.0, 3.0, -2.0)] == [
        1, 1, 2, 3, 4, 5, 6, 7, 8]
    for e in (8.0, 20.0, 7.3, -3.0, float(F(0.1)), float("nan")):
        assert tdn.pow_branch(e) == tdn.POW_POWF
    assert tdn.SAT_EXPONENT == 8.0


# -- the argument struct ----------------------------------------------------------

_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
            "int64_t": ctypes.c_int64}


def _c_struct(path, name):
    """[(field, ctypes type)] of `struct name` in a C source: pointers,
    scalars and arrays whose length is a constexpr of the file."""
    text = path.read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", text))
    body = re.search(r"struct %s \{(.*?)\n\};" % name, text, re.S)[1]
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in body.split(";")[:-1]:
        m = re.fullmatch(r"(?:const )?(\w+)\s*(\*?)\s*(\w+)(?:\[(\w+)\])?",
                         decl.strip())
        ctype, ptr, field, length = m.groups()
        t = ctypes.c_void_p if ptr else _C_TYPES[ctype]
        if length:
            t = t * int(consts.get(length, length))
        fields.append((field, t))
    return fields


def test_denoise_args_layout_matches_the_c_struct():
    """struct DenoiseArgs in csrc/denoise.cu, field by field: names, types,
    offsets at natural alignment and the size; its tap arrays hold
    MAX_RUNTIME_SAMPLES + 1 entries."""
    fields = _c_struct(_build.CSRC / "denoise.cu", "DenoiseArgs")

    class Parsed(ctypes.Structure):
        _fields_ = fields

    args = _build.DenoiseArgs
    assert [f for f, _ in args._fields_] == [f for f, _ in fields]
    for (name, t), (_, want) in zip(args._fields_, fields):
        assert ctypes.sizeof(t) == ctypes.sizeof(want), name
        assert getattr(args, name).offset == getattr(Parsed, name).offset
    assert ctypes.sizeof(args) == ctypes.sizeof(Parsed) == 1448
    assert _build.DENOISE_MAX_TAPS == tdn.MAX_RUNTIME_SAMPLES + 1
    assert "zvt_denoise" in _build._SIGNATURES


# -- the rows a launch reads -------------------------------------------------------

@pytest.mark.parametrize("out_hw", [(48, 64), (60, 96), (36, 32)],
                         ids=["shifted", "up", "down"])
@pytest.mark.parametrize("enabled", [True, False])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_rows_read_lie_in_band_input_rows(out_hw, enabled, n):
    """The rows kernel F reads for a band lie in `band_input_rows`, the
    slab the sharded step hands it; and the plain version on a slab of
    exactly those rows gives the band's rows of the whole image's result
    (widths of whole 32-float vectors: see test_torch_parallel.py)."""
    h, w = 48, 64
    out_h, out_w = out_hw
    cfg = DenoiserConfig(enabled=enabled, samples=12)
    img = torch.from_numpy(_img((h, w, 3), n))
    whole = tdn.postprocess(img, cfg, out_h, out_w)
    if not enabled and out_hw == (h, w):
        mode, taps = tdn.SHIFTED, {"y0": []}
    elif not enabled:
        mode, taps = tdn.RESAMPLE_ONLY, None
    else:
        mode = tdn.SHIFTED if out_hw == (h, w) else tdn.RESAMPLE
        taps = tdn.spiral_taps(12, width=w, height=h)
    for i in range(n):
        r0, r1 = i * out_h // n, (i + 1) * out_h // n
        lo, hi = tdn.rows_read(taps, mode, r0, r1, out_h, h)
        a, b = tdn.band_input_rows(r0, r1, out_h, h, cfg)
        assert a <= lo < hi <= b, (i, lo, hi, a, b)
        band = tdn.postprocess(img[lo:hi].clone(), cfg, out_h, out_w,
                               band=tdn.Band(r0, r1, lo, h))
        assert torch.equal(band, whole[r0:r1]), i


def test_wrappers_run_the_plain_version_on_the_cpu_alone():
    """On a CPU tensor each wrapper is its plain twin and launches nothing;
    on a device with no kernel F it raises."""
    img = torch.from_numpy(_img((12, 16, 3), 3))
    tdn.reset_launch_counts()
    cfg = DenoiserConfig(samples=6)
    for got, want in (
            (tdn.postprocess(img, cfg, 15, 20),
             tdn.postprocess_plain(img, cfg, 15, 20)),
            (tdn.denoise(img, samples=6), tdn.denoise_plain(img, samples=6)),
            (tdn.bilinear_resample(img, 9, 10),
             tdn.bilinear_resample_plain(img, 9, 10))):
        assert torch.equal(got, want)
    assert tdn.postprocess.launches == 0
    meta = torch.empty(12, 16, 3, device="meta")
    for call in (lambda: tdn.postprocess(meta, cfg, 12, 16),
                 lambda: tdn.denoise(meta, samples=6),
                 lambda: tdn.bilinear_resample(meta, 9, 10)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()


# -- the plain post-process against the JAX package --------------------------------

def _jax_post(img, enabled=True, out_hw=None, **knobs):
    h, w, _ = img.shape
    out_h, out_w = out_hw or (h, w)
    return np.asarray(rdn.postprocess(jnp.asarray(img), RDenoiserConfig(
        enabled=enabled, **knobs), out_h, out_w))


def _torch_post(img, enabled=True, out_hw=None, band=None, **knobs):
    h, w, _ = img.shape
    out_h, out_w = out_hw or (h, w)
    return tdn.postprocess(torch.from_numpy(img), DenoiserConfig(
        enabled=enabled, **knobs), out_h, out_w, band=band).numpy()


def _close(got, want, scale=1.0):
    """NaN in the same pixels, every other value within test_torch_denoise's
    1e-5 of the jitted reference, for images of values up to `scale`."""
    assert got.shape == want.shape
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    np.testing.assert_allclose(got[~nan], want[~nan], atol=1e-5 * scale,
                               rtol=0)


@pytest.mark.parametrize("out_hw", [None, (18, 24), (8, 10)],
                         ids=["shifted", "up", "down"])
def test_plain_on_a_zero_image(out_hw):
    """A zero image: every centre has length 0 (the clamp at 1e-12 keeps
    its normal 0), every tap too; the result is 0."""
    img = np.zeros((12, 16, 3), F)
    got = _torch_post(img, out_hw=out_hw)
    _close(got, _jax_post(img, out_hw=out_hw))
    assert not got.any()


@pytest.mark.parametrize("out_hw", [None, (18, 24), (8, 10)],
                         ids=["shifted", "up", "down"])
def test_plain_with_nan_and_hdr_values(out_hw):
    """NaN in some pixels (it spreads to every pixel whose taps read it, in
    both packages alike) and HDR values up to 8 beside values near 0:
    within 1e-5 of the jitted reference for each unit of the image's range,
    8e-5, since the differences scale with the values (the jitted
    reference contracts the resampling coordinates' multiply-adds into
    FMAs; measured: 4.7e-5 upsampled, 9.5e-6 downsampled, 3.8e-6 at equal
    size)."""
    img = _img((16, 20, 3), 21, hi=8.0)
    rng = np.random.default_rng(22)
    img[rng.random((16, 20)) < 0.02, 1] = np.nan
    img[rng.random((16, 20)) < 0.2] *= F(1e-3)
    got = _torch_post(img, out_hw=out_hw)
    want = _jax_post(img, out_hw=out_hw)
    assert np.isnan(want).any() and np.isfinite(want).any()
    _close(got, want, scale=8.0)


@pytest.mark.parametrize("exponent", [2.0, 3.0, 0.5])
@pytest.mark.parametrize("out_hw", [None, (18, 24)], ids=["shifted", "up"])
def test_plain_at_atens_special_exponents(exponent, out_hw):
    img = _img((12, 16, 3), int(exponent * 10), lo=0.05, hi=0.95)
    knobs = dict(inverse_hue_tolerance=exponent, samples=10)
    _close(_torch_post(img, out_hw=out_hw, **knobs),
           _jax_post(img, out_hw=out_hw, **knobs))


@pytest.mark.parametrize("enabled", [True, False],
                         ids=["denoiser", "resample_alone"])
@pytest.mark.parametrize("out_hw", [(40, 56), (20, 28)], ids=["up", "down"])
def test_plain_band_of_the_resampling_path(enabled, out_hw):
    """A band of output rows of the resampling denoiser (and of the
    resample alone) from its `band_input_rows` slab: the JAX package's
    whole image's rows."""
    h, w = 32, 32
    img = _img((h, w, 3), 31)
    out_h, out_w = out_hw
    cfg = DenoiserConfig(enabled=enabled, samples=12)
    want = _jax_post(img, enabled, out_hw, samples=12)
    for r0, r1 in ((0, out_h // 3), (out_h // 3, out_h - 2),
                   (out_h - 2, out_h)):
        a, b = tdn.band_input_rows(r0, r1, out_h, h, cfg)
        got = tdn.postprocess(torch.from_numpy(img[a:b].copy()), cfg, out_h,
                              out_w, band=tdn.Band(r0, r1, a, h)).numpy()
        _close(got, want[r0:r1])
