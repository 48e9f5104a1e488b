"""Spatial denoiser + presentation resample on torch tensors.

The torch counterpart of `zig_vulkan_tpu.ops.denoise`: the reference's
post-process fragment shader (assets/shaders/image.frag, the sirBird
golden-angle spiral filter, image.frag:31-71) and the clamp-to-edge bilinear
blit from internal to output resolution (Pipeline.zig:103-127).

The spiral's sample offsets are uniform across pixels (image.frag:47-53),
so each tap is a uniformly shifted bilinear resample of the whole image:
at equal input and output resolution a shift is four clamped row/column
reorders and two lerps. The JAX package leaves the filter to XLA, which
fuses it into the frame's program; here it is kernel F (csrc/denoise.cu),
one launch for the whole post-process of an image: `denoise`,
`bilinear_resample` and `postprocess` launch it for CUDA tensors. The
spiral's taps depend only on the knobs and the sizes, so the wrapper
computes them on the host (`spiral_taps`) and passes them by value with
the launch. `postprocess.launches` counts kernel F's launches, whichever
wrapper made them, and `postprocess.build_launches` the same by build; the
host picks the build and the shifted denoiser's shared-memory tile from the
taps before the launch (`launch_plan`).

`samples`, `distribution_bias` and `inverse_hue_tolerance` are the
reference's runtime push constants (image.frag:18-23). With `max_samples`
(or a `samples` that is no int) the filter takes them as such, as the JAX
engine's step does (pc[23], pc[19], pc[20]): the spiral runs
max_samples + 1 taps and masks those past `samples`, and the knobs may be
0-d tensors on the image's device, which kernel F's runtime builds read in
place when they run. The engine's step passes views of its push constants,
so a captured graph serves every value of the three sliders.

Each wrapper runs its plain torch twin (`denoise_plain`,
`bilinear_resample_plain`, `postprocess_plain`: the torch code the frame
ran before) for CPU tensors, and only for those; the twins are what the
kernel is held against on the card, bit for bit.

Every function also works on a band of output rows from a slab of input
rows (`Band`): the row-sharded step (parallel.mesh) denoises each shard's
band from its own rows plus a halo of its neighbours' (`band_input_rows`).
Tap indices are computed in whole-image coordinates, clamped at the true
image edges only, then shifted into the slab, and everything else is per
pixel, so the bands equal the rows of the whole image's result bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import _build
from ..config import DenoiserConfig

F32 = torch.float32
_F = np.float32

GOLDEN_ANGLE = 2.3999632  # 3PI - sqrt(5)PI (image.frag:25)

# tap-count ceiling of the runtime-`samples` path: the reference GUI slider
# range is 1..32 (ImguiGui.zig:275-306)
MAX_RUNTIME_SAMPLES = 32


def _rot_golden(vec):
    """pixelRotated *= sample2D (image.frag:29, :49) in float32."""
    c = _F(np.cos(np.float64(GOLDEN_ANGLE)))
    s = _F(np.sin(np.float64(GOLDEN_ANGLE)))
    x, y = vec
    # GLSL mat2(c, s, -s, c) * v = (c*x - s*y, s*x + c*y)
    return (c * x - s * y, s * x + c * y)


def spiral_offsets(samples: int, pixel_multiplier: float):
    """The (samples+1) spiral offsets in *pixel* units (image.frag:47-51)."""
    offs = []
    vec = (_F(0.0), _F(1.0))
    for x in range(samples + 1):
        vec = _rot_golden(vec)
        r = _F(pixel_multiplier) * _F(np.sqrt(_F(x))) * _F(0.5)
        offs.append((vec[0] * r, vec[1] * r))
    return offs


@dataclasses.dataclass(frozen=True)
class Band:
    """Output rows [r0, r1) of a whole image, computed from a slab that
    holds the input rows from `a` on of the image's `height` input rows."""

    r0: int
    r1: int
    a: int
    height: int


def _whole(img, out_h: int) -> Band:
    return Band(0, out_h, 0, img.shape[0])


def _one_minus(f):
    return 1.0 - f if torch.is_tensor(f) else float(_F(1.0) - _F(f))


def _lerp2d(i00, i01, i10, i11, fx, fy):
    gx, gy = _one_minus(fx), _one_minus(fy)
    top = i00 * gx + i01 * fx
    bot = i10 * gx + i11 * fx
    return top * gy + bot * fy


def bilinear_sample_shifted(img, dx: float, dy: float, band: Band = None):
    """Sample `img` [H, W, 3] at every pixel centre offset by (dx, dy)
    pixels, clamp-to-edge bilinear filtering. With `band`, `img` is the
    band's slab and the result its output rows."""
    w = img.shape[1]
    band = band or _whole(img, img.shape[0])
    h = band.height
    x0 = int(np.floor(dx))
    y0 = int(np.floor(dy))
    fx = float(_F(dx - x0))
    fy = float(_F(dy - y0))
    dev = img.device
    rows = torch.arange(band.r0, band.r1, device=dev)
    ys = torch.clamp(rows + y0, 0, h - 1) - band.a
    xs = torch.clamp(torch.arange(w, device=dev) + x0, 0, w - 1)
    ys1 = torch.clamp(rows + y0 + 1, 0, h - 1) - band.a
    xs1 = torch.clamp(torch.arange(w, device=dev) + x0 + 1, 0, w - 1)
    r0, r1 = img[ys], img[ys1]
    return _lerp2d(r0[:, xs], r0[:, xs1], r1[:, xs], r1[:, xs1], fx, fy)


def _sample_coords(n_out: int, n_in: int, offset, dev, first: int = 0,
                   last: int = None):
    """Clamped integer taps and fractions of the output pixel centres
    `first`..`last`-1 (all `n_out` by default) sampled over an `n_in`-pixel
    texture, shifted by `offset` input pixels."""
    last = n_out if last is None else last
    # the divisor is filled on the device, not copied from the host
    u = (torch.arange(first, last, dtype=F32, device=dev) + 0.5) \
        / torch.full((), float(_F(n_out)), dtype=F32, device=dev)
    if offset is not None:
        u = u + float(_F(offset) / _F(n_in))
    x = u * float(n_in) - 0.5
    x0 = torch.floor(x)
    f = x - x0
    i0 = torch.clamp(x0.to(torch.int64), 0, n_in - 1)
    i1 = torch.clamp(x0.to(torch.int64) + 1, 0, n_in - 1)
    return i0, i1, f


def _resample_taps(img, out_h: int, out_w: int, ox=None, oy=None,
                   band: Band = None):
    w = img.shape[1]
    band = band or _whole(img, out_h)
    x0i, x1i, fx = _sample_coords(out_w, w, ox, img.device)
    y0i, y1i, fy = _sample_coords(out_h, band.height, oy, img.device,
                                  band.r0, band.r1)
    r0, r1 = img[y0i - band.a], img[y1i - band.a]
    return _lerp2d(r0[:, x0i], r0[:, x1i], r1[:, x0i], r1[:, x1i],
                   fx[None, :, None], fy[:, None, None])


def bilinear_resample_plain(img, out_h: int, out_w: int, band: Band = None):
    """The plain torch version of `bilinear_resample`."""
    w = img.shape[1]
    band = band or _whole(img, out_h)
    if (out_h, out_w) == (band.height, w):
        return img[band.r0 - band.a:band.r1 - band.a]
    return _resample_taps(img, out_h, out_w, band=band)


def band_input_rows(r0: int, r1: int, out_h: int, in_h: int,
                    config: DenoiserConfig, max_samples: int | None = None):
    """The input rows [a, b) that output rows [r0, r1) of `postprocess`
    read: the band's own rows, widened by the spiral's largest vertical
    offsets (1.5 * sqrt(20) * 0.5, about 3.35 pixels, at the defaults; the
    max_samples + 1 taps of the runtime path) and the bilinear neighbour,
    clamped to the image."""
    last = (int(config.samples) if max_samples is None
            else int(max_samples))
    offsets = ([oy for _, oy in spiral_offsets(last, config.pixel_multiplier)]
               if config.enabled else [])
    # the taps of the resampling path (output and input sizes differ) ...
    taps = [_sample_coords(out_h, in_h, oy, "cpu", r0, r1)
            for oy in [None, *offsets]]
    a = min(int(i0.min()) for i0, _, _ in taps)
    b = max(int(i1.max()) for _, i1, _ in taps) + 1
    if out_h == in_h:
        # ... and of the shifted path (equal sizes), whichever the widths
        # select
        shifts = [int(np.floor(oy)) for oy in offsets] or [0]
        near = int(bool(offsets))  # a shifted tap's bilinear neighbour
        a = min(a, min(max(r0 + min(shifts), 0), in_h - 1))
        b = max(b, min(max(r1 - 1 + max(shifts) + near, 0), in_h - 1) + 1)
    return a, b


def _pow_clamped(a, b):
    """GLSL `#define pow(a,b) pow(max(a,0.),b)` (image.frag:27)."""
    return torch.pow(torch.clamp(a, min=0.0), b)


def _length3(v):
    return torch.sqrt(v[..., 0:1] * v[..., 0:1] + v[..., 1:2] * v[..., 1:2]
                      + v[..., 2:3] * v[..., 2:3])


def denoise_plain(img, samples=20, distribution_bias=0.6,
                  pixel_multiplier: float = 1.5, inverse_hue_tolerance=20.0,
                  out_shape=None, max_samples: int | None = None,
                  band: Band = None):
    """The plain torch version of `denoise`: sirBirdDenoise
    (image.frag:31-71) on an f32[H, W, 3] image.

    If `out_shape` = (out_h, out_w) differs from the input, the filter
    samples the input as the reference's fragment shader does running at
    output resolution over the internal-resolution texture.

    With `max_samples=None` and an int `samples` the filter runs exactly
    samples+1 taps. Otherwise `samples`, `distribution_bias` and
    `inverse_hue_tolerance` are the reference's runtime push constants
    (image.frag:18-23), numbers or 0-d tensors: the spiral runs
    max_samples+1 taps (default MAX_RUNTIME_SAMPLES), taps past `samples`
    get zero influence and add tap * 0 (so a NaN or an infinity under a
    masked tap's footprint makes the pixel NaN, as in the JAX package), and
    the influences and the hue are computed with torch ops on the image's
    device (`_sir_bird_runtime`), with no value read back to the host. On a
    finite image this equals the static loop at the same `samples` up to
    the rounding of the influences' pow.

    With `band`, `img` is the band's slab (`band_input_rows`) and the result
    the band's rows of the whole image's result.
    """
    if not _is_runtime(samples, max_samples):
        return _sir_bird(img, int(samples) + 1, float(samples),
                         distribution_bias, float(pixel_multiplier),
                         inverse_hue_tolerance, out_shape, band=band)
    return _sir_bird_runtime(img, _n_taps(samples, max_samples), samples,
                             distribution_bias, float(pixel_multiplier),
                             inverse_hue_tolerance, out_shape, band=band)


def _is_runtime(samples, max_samples) -> bool:
    """Whether `denoise` takes the runtime path: a ceiling given, or a
    `samples` that is no int (a float or a 0-d tensor)."""
    return not (max_samples is None
                and isinstance(samples, (int, np.integer)))


def _n_taps(samples, max_samples) -> int:
    """The taps the spiral runs, as `denoise` dispatches."""
    if _is_runtime(samples, max_samples):
        return int(max_samples or MAX_RUNTIME_SAMPLES) + 1
    return int(samples) + 1


def _knob(value, device):
    """A runtime knob as a 0-d float32 tensor on `device`: the tensor itself
    where it is one there already (a launch then reads it in place)."""
    t = torch.as_tensor(value, dtype=F32, device=device)
    if t.dim() != 0:
        raise ValueError(f"denoise: a runtime knob must be a number or a "
                         f"0-d tensor, got shape {list(t.shape)}")
    return t


def _r2(offsets):
    """float32 ox * ox + oy * oy of each spiral offset, as `_sir_bird`."""
    return [_F(_F(ox) * _F(ox) + _F(oy) * _F(oy)) for ox, oy in offsets]


def runtime_influences(samples, distribution_bias, r2):
    """Each tap's pixel_influence cubed from the 0-d tensors `samples` and
    `distribution_bias` and the taps' f32[n] `r2` (ox * ox + oy * oy), as
    kernel F's runtime builds compute them on the device:
    (1 - 0.5 / (sqrt(s) * sqrt(s)) * pow(max(r2, 0), bias))^3, one
    rounding an operation in `_sir_bird`'s order, the division a tensor's.
    The exponent is expanded to r2's shape: ATen's pow runs powf for it on
    either device, never the branches it takes for a scalar exponent."""
    radius = torch.sqrt(samples)
    true_radius = torch.full_like(samples, 0.5) / (radius * radius)
    p = 1.0 - true_radius * _pow_clamped(r2, distribution_bias.expand_as(r2))
    return p * p * p


def _sir_bird_runtime(img, n_taps: int, samples, distribution_bias,
                      pixel_multiplier, inverse_hue_tolerance, out_shape,
                      band: Band = None):
    """The filter body of the runtime path: `n_taps` spiral taps; taps with
    index > `samples` get zero influence, as the JAX package's
    `_sir_bird(..., mask_taps=True)` selects it, and still add tap * 0. The
    knobs become 0-d tensors on the image's device and every value that
    depends on them is computed there."""
    w = img.shape[1]
    h = img.shape[0] if band is None else band.height
    out_h, out_w = out_shape if out_shape is not None else (h, w)
    band = band or _whole(img, out_h)
    rows = band.r1 - band.r0
    same_res = (out_h, out_w) == (h, w)
    dev = img.device
    samples, bias, hue_exp = (_knob(k, dev) for k in (
        samples, distribution_bias, inverse_hue_tolerance))
    offsets = spiral_offsets(n_taps - 1, pixel_multiplier)
    r2 = torch.tensor(_r2(offsets), dtype=F32, device=dev)
    influences = runtime_influences(samples, bias, r2)
    live = torch.arange(n_taps, dtype=F32, device=dev) <= samples
    zero = torch.zeros((), dtype=F32, device=dev)
    hue_exp = hue_exp.expand(rows, out_w, 1)

    center = bilinear_resample_plain(img, out_h, out_w, band)
    center_len = _length3(center)
    center_norm = center / torch.clamp(center_len, min=_F(1e-12).item())

    influence_sum = torch.zeros((rows, out_w, 1), dtype=F32, device=dev)
    denoised = torch.zeros((rows, out_w, 3), dtype=F32, device=dev)

    for tap_i, (ox, oy) in enumerate(offsets):
        ox = _F(ox)
        oy = _F(oy)
        if same_res:
            tap = bilinear_sample_shifted(img, float(ox), float(oy), band)
        else:
            tap = _resample_taps(img, out_h, out_w, ox, oy, band)
        tap_len = _length3(tap)
        tap_norm = tap / torch.clamp(tap_len, min=_F(1e-12).item())

        dot = (center_norm[..., 0:1] * tap_norm[..., 0:1]
               + center_norm[..., 1:2] * tap_norm[..., 1:2]
               + center_norm[..., 2:3] * tap_norm[..., 2:3])
        hue = _pow_clamped(0.5 + 0.5 * dot, hue_exp)
        sat = _pow_clamped(1.0 - torch.abs(tap_len - center_len), 8.0)
        infl = torch.where(live[tap_i], influences[tap_i] * hue * sat, zero)
        influence_sum = influence_sum + infl
        denoised = denoised + tap * infl

    return denoised / influence_sum


def _sir_bird(img, n_taps: int, samples_f: float, distribution_bias,
              pixel_multiplier, inverse_hue_tolerance, out_shape,
              band: Band = None):
    """The filter body of the static path: `n_taps` spiral taps, each
    tap's influence computed on the host."""
    w = img.shape[1]
    h = img.shape[0] if band is None else band.height
    out_h, out_w = out_shape if out_shape is not None else (h, w)
    band = band or _whole(img, out_h)
    rows = band.r1 - band.r0
    same_res = (out_h, out_w) == (h, w)
    distribution_bias = float(_F(distribution_bias))
    inverse_hue_tolerance = float(_F(inverse_hue_tolerance))
    samples_f = _F(samples_f)

    # sampleTrueRadius = 0.5/(sqrt(samples))^2 (image.frag:33-34): the
    # sqrt-then-square rounding is kept for bit parity with the reference
    sample_radius = np.sqrt(samples_f, dtype=np.float32)
    sample_true_radius = _F(0.5) / (sample_radius * sample_radius)

    center = bilinear_resample_plain(img, out_h, out_w, band)
    center_len = _length3(center)
    center_norm = center / torch.clamp(center_len, min=_F(1e-12).item())

    influence_sum = torch.zeros((rows, out_w, 1), dtype=F32, device=img.device)
    denoised = torch.zeros((rows, out_w, 3), dtype=F32, device=img.device)

    for ox, oy in spiral_offsets(n_taps - 1, pixel_multiplier):
        ox = _F(ox)
        oy = _F(oy)
        radius2 = np.power(np.maximum(_F(ox * ox + oy * oy), _F(0.0)),
                           _F(distribution_bias), dtype=np.float32)
        pixel_influence = _F(1.0) - sample_true_radius * radius2
        if same_res:
            tap = bilinear_sample_shifted(img, float(ox), float(oy), band)
        else:
            tap = _resample_taps(img, out_h, out_w, ox, oy, band)
        tap_len = _length3(tap)
        tap_norm = tap / torch.clamp(tap_len, min=_F(1e-12).item())

        influence = float(pixel_influence * pixel_influence * pixel_influence)
        dot = (center_norm[..., 0:1] * tap_norm[..., 0:1]
               + center_norm[..., 1:2] * tap_norm[..., 1:2]
               + center_norm[..., 2:3] * tap_norm[..., 2:3])
        hue = _pow_clamped(0.5 + 0.5 * dot, inverse_hue_tolerance)
        sat = _pow_clamped(1.0 - torch.abs(tap_len - center_len), 8.0)
        infl = influence * hue * sat
        influence_sum = influence_sum + infl
        denoised = denoised + tap * infl

    return denoised / influence_sum


def postprocess_plain(img, config: DenoiserConfig, out_h: int, out_w: int,
                      band: Band = None, max_samples: int | None = None):
    """The plain torch version of `postprocess`."""
    if config.enabled:
        return denoise_plain(img, out_shape=(out_h, out_w), band=band,
                             max_samples=max_samples,
                             **_knobs(config, max_samples))
    return bilinear_resample_plain(img, out_h, out_w, band)


def _knobs(config: DenoiserConfig, max_samples=None) -> dict:
    """`denoise`'s knobs from `config`: its `samples` an int for the static
    path, as it is (a number or a 0-d tensor) for the runtime path."""
    return dict(samples=(int(config.samples) if max_samples is None
                         else config.samples),
                distribution_bias=config.distribution_bias,
                pixel_multiplier=config.pixel_multiplier,
                inverse_hue_tolerance=config.inverse_hue_tolerance)


# -- kernel F ------------------------------------------------------------------

# kernel F's modes (csrc/denoise.cu)
SHIFTED = 0        # the denoiser at equal input and output size
RESAMPLE = 1       # the denoiser at another output size
RESAMPLE_ONLY = 2  # the bilinear resample alone

# the branches ATen's torch.pow(tensor, exponent) takes on CUDA
# (csrc/denoise.cu's POW_*): exponents 0 and 1 (a fill and a copy), then
# 0.5, -0.5 and -1 (sqrt, rsqrt, reciprocal), 2, 3 and -2 (products);
# every other exponent goes to powf
POW_POWF = 0
_POW_BRANCHES = {0.0: 1, 1.0: 2, 0.5: 3, -0.5: 4, -1.0: 5, 2.0: 6, 3.0: 7,
                 -2.0: 8}
SAT_EXPONENT = 8.0  # sat = pow(max(1 - |tap_len - center_len|, 0), 8)

_TAP_FIELDS = ("x0", "y0", "fx", "fy", "gx", "gy", "ou", "ov", "r2",
               "influence")

# kernel F's launch shape (csrc/denoise.cu): a block of TILE_W x block_rows
# threads, one output pixel a thread; block_rows at most BLOCK_ROWS. The
# shifted denoiser's tile (its output pixels and the taps' halo, three f32
# channel planes) lives in dynamic shared memory, which a block of an sm_90
# card may opt into up to SMEM_OPTIN bytes.
TILE_W = 32
BLOCK_ROWS = 8      # MAX_BLOCK_ROWS
SMEM_OPTIN = 232_448

# the runtime builds' influences in static shared memory (csrc/denoise.cu's
# RUNTIME_SMEM): their tiles opt into that much less
RUNTIME_SMEM = 4 * _build.DENOISE_MAX_TAPS

# kernel F's builds, each with its own launch count: the static builds, the
# runtime builds (knobs read from device memory), the resample alone
BUILDS = ("shifted_tile", "shifted_global", "resample",
          "shifted_tile_runtime", "shifted_global_runtime",
          "resample_runtime", "resample_only")


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How kernel F launches: its build, the tile's halo (columns [hx0,
    hx1] and rows [hy0, hy1] around an output pixel), threads a block along
    y (as many output rows) and the block's shared bytes."""

    build: str
    halo: tuple = (0, 0, 0, 0)
    block_rows: int = BLOCK_ROWS
    smem_bytes: int = 0

    @property
    def tile(self) -> tuple:
        """(columns, rows) of output pixels a block."""
        return TILE_W, self.block_rows


def tile_bytes(halo, block_rows: int) -> int:
    """Shared bytes of a shifted tile: three f32 planes of the block's
    output pixels and the halo."""
    hx0, hx1, hy0, hy1 = halo
    return 3 * 4 * (TILE_W + hx1 - hx0) * (block_rows + hy1 - hy0)


def is_runtime_table(taps) -> bool:
    """Whether `taps` is a runtime tap table (`spiral_taps` of the runtime
    path: every tap's geometry, no influence)."""
    return taps is not None and "influence" not in taps


def launch_plan(taps, mode: int):
    """Kernel F's `LaunchPlan` for the tap table `taps` (`spiral_taps`;
    None for the resample alone) in `mode`: a runtime table takes the
    runtime builds. The shifted denoiser takes the tile with the most rows
    of threads (BLOCK_ROWS halved down to 1) whose shared bytes fit
    SMEM_OPTIN (less the runtime builds' RUNTIME_SMEM); a halo too wide for
    any (a large pixel_multiplier) takes the untiled build, which reads the
    image in global memory. A runtime table holds every tap of the spiral,
    so its halo is the whole spiral's, whatever `samples` is."""
    if mode == RESAMPLE_ONLY:
        return LaunchPlan("resample_only")
    suffix = "_runtime" if is_runtime_table(taps) else ""
    if mode == RESAMPLE:
        return LaunchPlan("resample" + suffix)
    x0 = [int(v) for v in taps["x0"]]
    y0 = [int(v) for v in taps["y0"]]
    # the centre's offset 0 and each tap's two neighbours
    halo = (min([0, *x0]), max([0, *(x + 1 for x in x0)]),
            min([0, *y0]), max([0, *(y + 1 for y in y0)]))
    room = SMEM_OPTIN - (RUNTIME_SMEM if suffix else 0)
    rows = BLOCK_ROWS
    while rows >= 1:
        need = tile_bytes(halo, rows)
        if need <= room:
            return LaunchPlan("shifted_tile" + suffix, halo, rows, need)
        rows //= 2
    return LaunchPlan("shifted_global" + suffix)


def pow_branch(exponent) -> int:
    """Kernel F's branch for `torch.pow(x, exponent)` on CUDA."""
    return _POW_BRANCHES.get(float(exponent), POW_POWF)


def spiral_taps(samples=20, distribution_bias=0.6,
                pixel_multiplier: float = 1.5, width: int = 1,
                height: int = 1, max_samples: int | None = None) -> dict:
    """Kernel F's tap table: {field: numpy array, one entry a tap in spiral
    order}, the float32 scalars the plain filter computes for the tap of an
    image of `height` x `width` input pixels: the integer shifts `x0`, `y0`
    and the fractions `fx`, `fy`, `gx` = 1 - fx, `gy` = 1 - fy of
    `bilinear_sample_shifted`; the texture-coordinate offsets `ou` = ox /
    width and `ov` = oy / height of `_resample_taps`; `r2` = ox * ox + oy *
    oy. The static path's table (an int `samples`, no `max_samples`) holds
    its samples + 1 taps and their `influence`, pixel_influence cubed, as
    `_sir_bird` computes it. The runtime path's holds every one of the
    max_samples + 1 taps and no influence: `samples` and
    `distribution_bias`, which may be device tensors, are not read; kernel
    F's runtime builds compute the influences and the mask from them on the
    device (`runtime_influences`)."""
    runtime = _is_runtime(samples, max_samples)
    offsets = spiral_offsets(_n_taps(samples, max_samples) - 1,
                             float(pixel_multiplier))
    rows = []
    for (ox, oy), r2 in zip(offsets, _r2(offsets)):
        ox, oy = _F(ox), _F(oy)
        x0, y0 = int(np.floor(float(ox))), int(np.floor(float(oy)))
        fx, fy = _F(float(ox) - x0), _F(float(oy) - y0)
        rows.append((x0, y0, fx, fy, _F(1.0) - fx, _F(1.0) - fy,
                     ox / _F(width), oy / _F(height), r2))
    fields = _TAP_FIELDS[:-1]
    cols = list(zip(*rows)) or [()] * len(fields)
    table = {k: np.asarray(v, dtype=np.int32 if k in ("x0", "y0")
                           else np.float32)
             for k, v in zip(fields, cols)}
    if not runtime:
        radius = np.sqrt(_F(samples), dtype=np.float32)
        true_radius = _F(0.5) / (radius * radius)
        influence = []
        for r2 in table["r2"]:  # one tap at a time, as `_sir_bird`
            p = _F(1.0) - true_radius * np.power(
                np.maximum(r2, _F(0.0)), _F(distribution_bias),
                dtype=np.float32)
            influence.append(p * p * p)
        table["influence"] = np.asarray(influence, dtype=np.float32)
    return table


def _neighbours(i: int, n_out: int, n_in: int, off=None):
    """`_sample_coords`' clamped neighbours (i0, i1) of output pixel `i`,
    in float32 on the host."""
    u = (_F(i) + _F(0.5)) / _F(n_out)
    if off is not None:
        u = u + off
    x0 = int(np.floor(u * _F(n_in) - _F(0.5)))
    return min(max(x0, 0), n_in - 1), min(max(x0 + 1, 0), n_in - 1)


def rows_read(taps, mode: int, r0: int, r1: int, out_h: int, height: int):
    """The image rows [lo, hi) kernel F reads for output rows [r0, r1):
    the rows of `band_input_rows` that this launch's taps select."""
    if mode == SHIFTED:
        lo, hi = r0, r1
        for y0 in taps["y0"]:
            lo = min(lo, min(max(r0 + int(y0), 0), height - 1))
            hi = max(hi, min(max(r1 + int(y0), 0), height - 1) + 1)
        return lo, hi
    offsets = [None] + (list(taps["ov"]) if mode == RESAMPLE else [])
    lo = min(_neighbours(r0, out_h, height, off)[0] for off in offsets)
    hi = max(_neighbours(r1 - 1, out_h, height, off)[1] for off in offsets)
    return lo, hi + 1


def _launch(img, out_h: int, out_w: int, band: Band, taps=None,
            hue_exp: float = 0.0, knobs=None):
    """Kernel F on the CUDA tensor `img`: the denoiser with the tap table
    `taps` (`spiral_taps`), or the resample alone without it. A runtime
    table takes `knobs`, the 0-d float32 tensors (samples,
    distribution_bias, inverse_hue_tolerance) on the image's device whose
    addresses the launch holds (`hue_exp` is then not read)."""
    dev = img.device
    if dev.type != "cuda":
        raise ValueError(f"postprocess: unsupported device {dev}")
    if img.dtype != F32 or img.dim() != 3 or img.shape[2] != 3:
        raise ValueError(f"postprocess: the image must be float32[H, W, 3], "
                         f"got {img.dtype}{list(img.shape)}")
    if not img.is_contiguous():
        raise ValueError("postprocess: the image must be contiguous")
    if is_runtime_table(taps) and not (
            knobs is not None and len(knobs) == 3
            and all(k.device == dev and k.dtype == F32 and k.dim() == 0
                    for k in knobs)):
        raise ValueError("postprocess: a runtime launch takes its three "
                         "knobs as 0-d float32 tensors on the image's "
                         "device")
    rows_in, w = int(img.shape[0]), int(img.shape[1])
    band = band or _whole(img, out_h)
    h = int(band.height)
    if taps is None:
        mode = RESAMPLE_ONLY
    else:
        mode = SHIFTED if (out_h, out_w) == (h, w) else RESAMPLE
    n_taps = 0 if taps is None else len(taps["x0"])
    if n_taps > _build.DENOISE_MAX_TAPS:
        raise ValueError(f"postprocess: kernel F takes at most "
                         f"{_build.DENOISE_MAX_TAPS} taps, got {n_taps}")
    if not (0 <= band.r0 <= band.r1 <= out_h and 0 <= band.a
            and band.a + rows_in <= h):
        raise ValueError(f"postprocess: output rows [{band.r0}, {band.r1}) "
                         f"of {out_h}, slab rows [{band.a}, "
                         f"{band.a + rows_in}) of {h}")
    if max(rows_in * w, out_h * out_w) >= 2**31:
        raise ValueError("postprocess: kernel F takes fewer than 2^31 pixels")
    out = torch.empty((band.r1 - band.r0, out_w, 3), dtype=F32, device=dev)
    if out.numel() == 0:
        return out  # nothing to launch
    if rows_in * w == 0:
        raise ValueError("postprocess: the image has no pixel to sample")
    lo, hi = rows_read(taps, mode, band.r0, band.r1, out_h, h)
    if lo < band.a or hi > band.a + rows_in:
        raise ValueError(f"postprocess: output rows [{band.r0}, {band.r1}) "
                         f"read image rows [{lo}, {hi}), the slab holds "
                         f"[{band.a}, {band.a + rows_in})")
    plan = launch_plan(taps, mode)
    a = launch_args(img, out, out_h, band, taps, mode, hue_exp, (lo, hi),
                    plan, knobs)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.zvt_denoise(ctypes.byref(a), stream)
    _build.check(status, "zvt_denoise")
    postprocess.launches += 1
    postprocess.build_launches[plan.build] += 1
    return out


def launch_args(img, out, out_h: int, band: Band, taps, mode: int,
                hue_exp: float, rows: tuple, plan: LaunchPlan, knobs=None):
    """Kernel F's `_build.DenoiseArgs` for a checked launch on `img` into
    `out` that reads image rows `rows` (`rows_read`) as `plan` says; a
    runtime table's launch points at `knobs`."""
    n_taps = 0 if taps is None else len(taps["x0"])
    a = _build.DenoiseArgs()
    a.img, a.out = img.data_ptr(), out.data_ptr()
    if is_runtime_table(taps):
        a.runtime = 1
        a.samples, a.bias, a.hue = (k.data_ptr() for k in knobs)
        hue_exp = 0.0  # read from `knobs` on the device
    a.w_in, a.height, a.a = int(img.shape[1]), int(band.height), band.a
    a.row_lo, a.row_hi = rows
    a.w_out, a.h_out = int(out.shape[1]), out_h
    a.r0, a.r1 = band.r0, band.r1
    a.mode, a.n_taps = mode, n_taps
    a.tiled = int(plan.build.startswith("shifted_tile"))
    a.hx0, a.hx1, a.hy0, a.hy1 = plan.halo
    a.block_rows, a.smem = plan.block_rows, plan.smem_bytes
    a.hue_pow, a.hue_exp = pow_branch(hue_exp), hue_exp
    a.sat_exp = SAT_EXPONENT
    if n_taps:
        for k in _TAP_FIELDS:
            if k in taps:
                getattr(a, k)[:n_taps] = taps[k].tolist()
    return a


def _denoise(img, samples, distribution_bias, pixel_multiplier,
             inverse_hue_tolerance, out_shape, max_samples, band):
    w = img.shape[1]
    h = img.shape[0] if band is None else band.height
    out_h, out_w = out_shape if out_shape is not None else (h, w)
    taps = spiral_taps(samples, distribution_bias, pixel_multiplier, w, h,
                       max_samples)
    if is_runtime_table(taps):
        knobs = tuple(_knob(k, img.device) for k in (
            samples, distribution_bias, inverse_hue_tolerance))
        return _launch(img, int(out_h), int(out_w), band, taps, knobs=knobs)
    return _launch(img, int(out_h), int(out_w), band, taps,
                   float(_F(inverse_hue_tolerance)))


def _resample(img, out_h, out_w, band):
    band = band or _whole(img, out_h)
    if (out_h, out_w) == (band.height, img.shape[1]):
        return img[band.r0 - band.a:band.r1 - band.a]  # the rows themselves
    return _launch(img, int(out_h), int(out_w), band)


def denoise(img, samples=20, distribution_bias=0.6,
            pixel_multiplier: float = 1.5, inverse_hue_tolerance=20.0,
            out_shape=None, max_samples: int | None = None,
            band: Band = None):
    """sirBirdDenoise (image.frag:31-71) on an f32[H, W, 3] image: kernel F
    on a CUDA tensor, `denoise_plain` on a CPU one (see it for the
    arguments)."""
    if img.device.type == "cpu":
        return denoise_plain(img, samples, distribution_bias,
                             pixel_multiplier, inverse_hue_tolerance,
                             out_shape, max_samples, band)
    return _denoise(img, samples, distribution_bias, pixel_multiplier,
                    inverse_hue_tolerance, out_shape, max_samples, band)


def bilinear_resample(img, out_h: int, out_w: int, band: Band = None):
    """Clamp-to-edge bilinear resample (the GraphicsPipeline blit analog):
    kernel F on a CUDA tensor; at the input's size the rows themselves."""
    if img.device.type == "cpu":
        return bilinear_resample_plain(img, out_h, out_w, band)
    return _resample(img, out_h, out_w, band)


def postprocess(img, config: DenoiserConfig, out_h: int, out_w: int,
                band: Band = None, max_samples: int | None = None):
    """The full presentation pass: denoise (if enabled) + resample, one
    launch of kernel F on a CUDA tensor. With `band`, `img` is the band's
    slab and the result the band's rows. With `max_samples` the denoiser
    takes the runtime path (`denoise`): `config`'s `samples`,
    `distribution_bias` and `inverse_hue_tolerance` may then be 0-d
    tensors on the image's device, read when the kernel runs."""
    if img.device.type == "cpu":
        return postprocess_plain(img, config, out_h, out_w, band,
                                 max_samples)
    if config.enabled:
        return _denoise(img, out_shape=(out_h, out_w),
                        max_samples=max_samples, band=band,
                        **_knobs(config, max_samples))
    return _resample(img, out_h, out_w, band)


postprocess.launches = 0  # kernel F's launches, through any wrapper
postprocess.build_launches = dict.fromkeys(BUILDS, 0)  # the same, by build


def reset_launch_counts() -> None:
    postprocess.launches = 0
    for name in postprocess.build_launches:
        postprocess.build_launches[name] = 0
