"""Spatial denoiser + presentation resample on torch tensors.

Frozen copy of `zig_vulkan_tpu_torch/ops/denoise.py` for the benchmark's plain
reference (`rtbench.ref`), which imports nothing of the port: kernel
wrappers run their plain torch twins on every device.

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

The reference keeps the static path alone: an int `samples`, the spiral
at exactly samples + 1 taps (the program's runtime path, which reads the
knobs from its push constants, equals it on a finite image up to the
rounding of the influences' pow). `postprocess_plain` is the plain torch
twin the kernel is held against on the card, bit for bit.

The filter bodies work on a band of output rows (`Band`); the reference
passes the whole image.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import DenoiserConfig

F32 = torch.float32
_F = np.float32

GOLDEN_ANGLE = 2.3999632  # 3PI - sqrt(5)PI (image.frag:25)

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


def _pow_clamped(a, b):
    """GLSL `#define pow(a,b) pow(max(a,0.),b)` (image.frag:27)."""
    return torch.pow(torch.clamp(a, min=0.0), b)


def _length3(v):
    return torch.sqrt(v[..., 0:1] * v[..., 0:1] + v[..., 1:2] * v[..., 1:2]
                      + v[..., 2:3] * v[..., 2:3])


def denoise_plain(img, samples=20, distribution_bias=0.6,
                  pixel_multiplier: float = 1.5, inverse_hue_tolerance=20.0,
                  out_shape=None):
    """sirBirdDenoise (image.frag:31-71) on an f32[H, W, 3] image, at
    exactly `samples` + 1 taps.

    If `out_shape` = (out_h, out_w) differs from the input, the filter
    samples the input as the reference's fragment shader does running at
    output resolution over the internal-resolution texture."""
    return _sir_bird(img, int(samples) + 1, float(samples),
                     distribution_bias, float(pixel_multiplier),
                     inverse_hue_tolerance, out_shape)


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


def postprocess_plain(img, config: DenoiserConfig, out_h: int, out_w: int):
    """The full presentation pass: denoise (if enabled) + resample."""
    if config.enabled:
        return denoise_plain(img, int(config.samples),
                             config.distribution_bias,
                             config.pixel_multiplier,
                             config.inverse_hue_tolerance, (out_h, out_w))
    return bilinear_resample_plain(img, out_h, out_w)


postprocess = postprocess_plain
