"""Kernel F's shared-memory tile, held on the CPU before any card run.

The shifted denoiser's tiled build (csrc/denoise.cu, "shifted_tile")
loads a block's output tile and the taps' halo once, clamping rows and
columns at load time, and reads each tap at one uniform offset in the
tile. Here the host's plan (`ops.denoise.launch_plan`: the halo, the
block's rows of threads, the shared bytes, the build) is held against the
tap table for every spiral length, and a torch emulation of the tiled read
is held bit for bit against `bilinear_sample_shifted`, the plain version
of a shifted tap, on odd sizes and on band slabs: clamp at load equals
clamp at read.
"""

import re

import numpy as np
import pytest
import torch

from zig_vulkan_tpu_torch import _build
from zig_vulkan_tpu_torch.config import DenoiserConfig
from zig_vulkan_tpu_torch.ops import denoise as tdn

torch.set_num_threads(2)

# pixel multipliers: under, at and over the default, and one whose halo no
# tile of an sm_90 block holds
MULTIPLIERS = (0.5, 1.5, 4.0, 50.0)
UNTILED = 50.0


def _constant(name):
    text = (_build.CSRC / "denoise.cu").read_text()
    return int(re.search(r"(?:#define %s|constexpr int %s =) (\d+)"
                         % (name, name), text)[1])


def test_launch_shape_matches_the_source():
    """The host's tile constants are the kernel's; the runtime builds'
    influences take 4 bytes a tap of static shared memory."""
    assert _constant("TILE_W") == tdn.TILE_W
    assert _constant("MAX_BLOCK_ROWS") == tdn.BLOCK_ROWS
    assert tdn.SMEM_OPTIN == 227 * 1024
    text = (_build.CSRC / "denoise.cu").read_text()
    assert "constexpr int RUNTIME_SMEM = 4 * DENOISE_MAX_TAPS;" in text
    assert tdn.RUNTIME_SMEM == 4 * _constant("DENOISE_MAX_TAPS")


def _all_tap_tables(pixel_multiplier):
    """Every spiral kernel F takes: the static loop at samples 0-32 and the
    runtime value over the masked 32-tap spiral (every tap's geometry,
    whatever the value)."""
    for samples in range(33):
        yield samples, tdn.spiral_taps(samples,
                                       pixel_multiplier=pixel_multiplier)
        yield samples, tdn.spiral_taps(float(samples), max_samples=32,
                                       pixel_multiplier=pixel_multiplier)


@pytest.mark.filterwarnings("ignore::RuntimeWarning")  # samples 0: 0.5 / 0
@pytest.mark.parametrize("pixel_multiplier", MULTIPLIERS)
def test_halo_covers_every_live_tap(pixel_multiplier):
    """The tiled plan's halo covers the centre and each tap's x0, x0 + 1,
    y0 and y0 + 1 (the live taps of a static table, all 33 of a runtime
    one), and no more; its bytes are the tile's and fit the opt-in limit
    (less the runtime builds' influences); a halo no tile holds (one row of
    threads over the limit) takes the untiled build; a runtime table takes
    the runtime builds."""
    untiled = 0
    for samples, taps in _all_tap_tables(pixel_multiplier):
        x0, y0 = list(taps["x0"]), list(taps["y0"])
        halo = (min([0, *x0]), max([0, *x0]) + 1,
                min([0, *y0]), max([0, *y0]) + 1)
        plan = tdn.launch_plan(taps, tdn.SHIFTED)
        runtime = tdn.is_runtime_table(taps)
        assert runtime == ("influence" not in taps)
        suffix = "_runtime" if runtime else ""
        room = tdn.SMEM_OPTIN - (tdn.RUNTIME_SMEM if runtime else 0)
        if tdn.tile_bytes(halo, 1) > room:
            assert plan.build == "shifted_global" + suffix, samples
            assert plan.smem_bytes == 0
            untiled += 1
            continue
        assert plan.build == "shifted_tile" + suffix, samples
        assert plan.halo == halo, samples
        assert plan.smem_bytes == tdn.tile_bytes(halo, plan.block_rows)
        assert plan.smem_bytes <= room
        assert plan.tile == (tdn.TILE_W, plan.block_rows)
        if pixel_multiplier <= 4.0:
            assert plan.block_rows == tdn.BLOCK_ROWS
    if pixel_multiplier == UNTILED:
        assert untiled > 0
        assert tdn.launch_plan(tdn.spiral_taps(20, pixel_multiplier=UNTILED),
                               tdn.SHIFTED).build == "shifted_global"
    else:
        assert untiled == 0
    # the defaults: x in [-4, 3], y in [-3, 4], a 32 x 8 tile in 6.9 KB;
    # the runtime path's 33 taps: x in [-5, 4], y in [-4, 4], 7.7 KB
    plan = tdn.launch_plan(tdn.spiral_taps(20), tdn.SHIFTED)
    assert plan.halo == (-4, 3, -3, 4) and plan.tile == (32, 8)
    assert plan.smem_bytes == 7020
    plan = tdn.launch_plan(tdn.spiral_taps(20.0, max_samples=32),
                           tdn.SHIFTED)
    assert plan.build == "shifted_tile_runtime" and plan.tile == (32, 8)
    assert plan.halo == (-5, 4, -4, 4) and plan.smem_bytes == 7872


def test_a_wide_halo_takes_a_smaller_tile():
    """Between the default and the untiled build the tile loses rows of
    threads, down to one, before its bytes pass the opt-in limit."""
    seen = set()
    for pixel_multiplier in np.arange(28.5, 30.0, 0.01):
        taps = tdn.spiral_taps(20, pixel_multiplier=float(pixel_multiplier))
        plan = tdn.launch_plan(taps, tdn.SHIFTED)
        seen.add(plan.block_rows if plan.build == "shifted_tile" else 0)
        if plan.build == "shifted_tile":
            assert plan.smem_bytes <= tdn.SMEM_OPTIN
            if plan.block_rows < tdn.BLOCK_ROWS:
                assert tdn.tile_bytes(plan.halo, plan.block_rows * 2) \
                    > tdn.SMEM_OPTIN
    assert {8, 4, 2, 1, 0} <= seen


def test_other_modes_take_their_builds():
    taps = tdn.spiral_taps(20)
    assert tdn.launch_plan(taps, tdn.RESAMPLE).build == "resample"
    runtime = tdn.spiral_taps(20.0, max_samples=32)
    assert tdn.launch_plan(runtime, tdn.RESAMPLE).build == "resample_runtime"
    plan = tdn.launch_plan(None, tdn.RESAMPLE_ONLY)
    assert plan.build == "resample_only" and plan.smem_bytes == 0
    assert set(tdn.BUILDS) == {"shifted_tile", "shifted_global",
                               "resample", "shifted_tile_runtime",
                               "shifted_global_runtime", "resample_runtime",
                               "resample_only"}


# -- the tiled read, emulated -------------------------------------------------------

def _clamp(v, lo, hi):
    return torch.clamp(v, lo, hi)


def _tiled_taps(img, band, taps, plan, lo, hi, out_w):
    """Each live tap of the shifted denoiser as kernel F's tiled build
    reads it: per block, the tile loaded with its clamps (the image's
    edges, then the rows [lo, hi) the launch reads, then into the slab),
    then, per thread, the tap's two row lerps at one uniform offset and the
    pixel's sample from them. Returns f32[taps, rows, out_w, 3] of the
    band's output rows."""
    hx0, hx1, hy0, hy1 = plan.halo
    tw, th = plan.tile
    sw, sh = tw + hx1 - hx0, th + hy1 - hy0
    rows = band.r1 - band.r0
    n = len(taps["x0"])
    out = torch.empty((n, rows, out_w, 3))
    for rb in range(band.r0, band.r1, th):
        for cb in range(0, out_w, tw):
            ys = _clamp(_clamp(torch.arange(sh) + rb + hy0, 0,
                               band.height - 1), lo, hi - 1)
            assert int(ys.min()) >= lo and int(ys.max()) < hi
            xs = _clamp(torch.arange(sw) + cb + hx0, 0, img.shape[1] - 1)
            tile = img[ys - band.a][:, xs]           # [sh, sw, 3]
            for i in range(n):
                x0, y0 = int(taps["x0"][i]), int(taps["y0"][i])
                fx, gx = float(taps["fx"][i]), float(taps["gx"][i])
                fy, gy = float(taps["fy"][i]), float(taps["gy"][i])
                c0 = x0 - hx0
                c1 = min(cb + tw, out_w)
                for ty in range(th):
                    r = rb + ty
                    if r >= band.r1:
                        continue
                    s0 = ty + y0 - hy0
                    top, bot = (tile[s0 + k, c0:c0 + tw] * gx
                                + tile[s0 + k, c0 + 1:c0 + 1 + tw] * fx
                                for k in (0, 1))
                    tap = top * gy + bot * fy
                    out[i, r - band.r0, cb:c1] = tap[:c1 - cb]
    return out


def _check_tiled(img, band, samples, pixel_multiplier,
                 block_rows=tdn.BLOCK_ROWS):
    """The tiled read at `block_rows` rows of threads a block (the plan's
    at the defaults; a wide halo takes fewer) against the shifted
    sample."""
    taps = tdn.spiral_taps(samples, pixel_multiplier=pixel_multiplier)
    plan = tdn.launch_plan(taps, tdn.SHIFTED)
    assert plan.build == "shifted_tile"
    plan = tdn.LaunchPlan("shifted_tile", plan.halo, block_rows,
                          tdn.tile_bytes(plan.halo, block_rows))
    w = img.shape[1]
    lo, hi = tdn.rows_read(taps, tdn.SHIFTED, band.r0, band.r1,
                           band.height, band.height)
    assert band.a <= lo and hi <= band.a + img.shape[0]
    got = _tiled_taps(img, band, taps, plan, lo, hi, w)
    offsets = tdn.spiral_offsets(samples, pixel_multiplier)
    for i, (ox, oy) in enumerate(offsets):
        want = tdn.bilinear_sample_shifted(img, float(np.float32(ox)),
                                           float(np.float32(oy)), band)
        assert torch.equal(got[i].view(torch.int32),
                           want.view(torch.int32)), (i, ox, oy)


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0.0, 1.0, (h, w, 3))
                            .astype(np.float32))


# heights and widths: a pixel, smaller than the halo, the tile and one
# pixel either side of it, and more than a tile with a ragged edge
SHAPES = [(1, 1), (2, 3), (3, 2), (31, 33), (32, 32), (33, 31), (45, 70)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("samples, pixel_multiplier",
                         [(20, 1.5), (32, 1.5), (8, 4.0), (0, 1.5)])
@pytest.mark.parametrize("block_rows", [8, 4, 1])
@pytest.mark.filterwarnings("ignore::RuntimeWarning")  # samples 0: 0.5 / 0
def test_tiled_read_equals_the_shifted_sample(shape, samples,
                                              pixel_multiplier, block_rows):
    """The whole image: clamp at load equals clamp at read, bit for bit,
    for every live tap, at the default tile's rows of threads and at the
    fewer a wide halo takes."""
    h, w = shape
    img = _image(h, w, h * 100 + w)
    _check_tiled(img, tdn.Band(0, h, 0, h), samples, pixel_multiplier,
                 block_rows)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("samples, pixel_multiplier",
                         [(8, 1.5), (20, 1.5), (20, 3.0)])
def test_tiled_read_on_band_slabs(n, samples, pixel_multiplier):
    """The bands of tests/test_torch_parallel.py (32 x 32, 2, 4, 8 bands):
    each band's slab (`band_input_rows`, a > 0 past the first) read as the
    tiled build reads it equals the shifted sample of the band, and every
    row a tile loads lies in the rows the launch reads."""
    h = w = 32
    img = _image(h, w, n)
    cfg = DenoiserConfig(samples=samples, pixel_multiplier=pixel_multiplier)
    rows = h // n
    for i in range(n):
        r0, r1 = i * rows, (i + 1) * rows
        a, b = tdn.band_input_rows(r0, r1, h, h, cfg)
        assert (a > 0) == (i > 0) or pixel_multiplier > 1.5
        _check_tiled(img[a:b].clone(), tdn.Band(r0, r1, a, h), samples,
                     pixel_multiplier)
