"""Spatial denoiser + presentation resample on torch tensors.

The torch counterpart of `zig_vulkan_tpu.ops.denoise`: the reference's
post-process fragment shader (assets/shaders/image.frag, the sirBird
golden-angle spiral filter, image.frag:31-71) and the clamp-to-edge bilinear
blit from internal to output resolution (Pipeline.zig:103-127).

The spiral's sample offsets are uniform across pixels (image.frag:47-53),
so each tap is a uniformly shifted bilinear resample of the whole image:
at equal input and output resolution a shift is four clamped row/column
reorders and two lerps. Plain tensor operations; no kernel of the
reference's is here (the JAX version is XLA, not Pallas).
"""

from __future__ import annotations

import numpy as np
import torch

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


def _one_minus(f):
    return 1.0 - f if torch.is_tensor(f) else float(_F(1.0) - _F(f))


def _lerp2d(i00, i01, i10, i11, fx, fy):
    gx, gy = _one_minus(fx), _one_minus(fy)
    top = i00 * gx + i01 * fx
    bot = i10 * gx + i11 * fx
    return top * gy + bot * fy


def bilinear_sample_shifted(img, dx: float, dy: float):
    """Sample `img` [H, W, 3] at every pixel centre offset by (dx, dy)
    pixels, clamp-to-edge bilinear filtering."""
    h, w, _ = img.shape
    x0 = int(np.floor(dx))
    y0 = int(np.floor(dy))
    fx = float(_F(dx - x0))
    fy = float(_F(dy - y0))
    dev = img.device
    ys = torch.clamp(torch.arange(h, device=dev) + y0, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=dev) + x0, 0, w - 1)
    ys1 = torch.clamp(torch.arange(h, device=dev) + y0 + 1, 0, h - 1)
    xs1 = torch.clamp(torch.arange(w, device=dev) + x0 + 1, 0, w - 1)
    r0, r1 = img[ys], img[ys1]
    return _lerp2d(r0[:, xs], r0[:, xs1], r1[:, xs], r1[:, xs1], fx, fy)


def _sample_coords(n_out: int, n_in: int, offset, dev):
    """Clamped integer taps and fractions of output pixel centres sampled
    over an `n_in`-pixel texture, shifted by `offset` input pixels."""
    u = (torch.arange(n_out, dtype=F32, device=dev) + 0.5) \
        / torch.tensor(_F(n_out), device=dev)
    if offset is not None:
        u = u + float(_F(offset) / _F(n_in))
    x = u * float(n_in) - 0.5
    x0 = torch.floor(x)
    f = x - x0
    i0 = torch.clamp(x0.to(torch.int64), 0, n_in - 1)
    i1 = torch.clamp(x0.to(torch.int64) + 1, 0, n_in - 1)
    return i0, i1, f


def _resample_taps(img, out_h: int, out_w: int, ox=None, oy=None):
    h, w, _ = img.shape
    x0i, x1i, fx = _sample_coords(out_w, w, ox, img.device)
    y0i, y1i, fy = _sample_coords(out_h, h, oy, img.device)
    r0, r1 = img[y0i], img[y1i]
    return _lerp2d(r0[:, x0i], r0[:, x1i], r1[:, x0i], r1[:, x1i],
                   fx[None, :, None], fy[:, None, None])


def bilinear_resample(img, out_h: int, out_w: int):
    """Clamp-to-edge bilinear resample (the GraphicsPipeline blit analog)."""
    h, w, _ = img.shape
    if (out_h, out_w) == (h, w):
        return img
    return _resample_taps(img, out_h, out_w)


def _pow_clamped(a, b):
    """GLSL `#define pow(a,b) pow(max(a,0.),b)` (image.frag:27)."""
    return torch.pow(torch.clamp(a, min=0.0), b)


def _length3(v):
    return torch.sqrt(v[..., 0:1] * v[..., 0:1] + v[..., 1:2] * v[..., 1:2]
                      + v[..., 2:3] * v[..., 2:3])


def denoise(img, samples=20, distribution_bias=0.6,
            pixel_multiplier: float = 1.5, inverse_hue_tolerance=20.0,
            out_shape=None, max_samples: int | None = None):
    """sirBirdDenoise (image.frag:31-71) on an f32[H, W, 3] image.

    If `out_shape` = (out_h, out_w) differs from the input, the filter
    samples the input as the reference's fragment shader does running at
    output resolution over the internal-resolution texture.

    With `max_samples=None` and an int `samples` the filter runs exactly
    samples+1 taps. Otherwise `samples` is the reference's runtime push
    constant (image.frag:18-23): the spiral runs max_samples+1 taps
    (default MAX_RUNTIME_SAMPLES) and taps past `samples` add zero
    influence, which gives the same output bit for bit.
    """
    if max_samples is None and isinstance(samples, (int, np.integer)):
        return _sir_bird(img, int(samples) + 1, float(samples),
                         distribution_bias, float(pixel_multiplier),
                         inverse_hue_tolerance, out_shape)
    return _sir_bird(img, int(max_samples or MAX_RUNTIME_SAMPLES) + 1,
                     float(samples), distribution_bias,
                     float(pixel_multiplier), inverse_hue_tolerance,
                     out_shape, mask_taps=True)


def _sir_bird(img, n_taps: int, samples_f: float, distribution_bias,
              pixel_multiplier, inverse_hue_tolerance, out_shape,
              mask_taps: bool = False):
    """The filter body: `n_taps` spiral taps; when `mask_taps`, taps with
    index > `samples_f` get zero influence."""
    h, w, _ = img.shape
    out_h, out_w = out_shape if out_shape is not None else (h, w)
    same_res = (out_h, out_w) == (h, w)
    distribution_bias = float(_F(distribution_bias))
    inverse_hue_tolerance = float(_F(inverse_hue_tolerance))
    samples_f = _F(samples_f)

    # sampleTrueRadius = 0.5/(sqrt(samples))^2 (image.frag:33-34): the
    # sqrt-then-square rounding is kept for bit parity with the reference
    sample_radius = np.sqrt(samples_f, dtype=np.float32)
    sample_true_radius = _F(0.5) / (sample_radius * sample_radius)

    center = img if same_res else bilinear_resample(img, out_h, out_w)
    center_len = _length3(center)
    center_norm = center / torch.clamp(center_len, min=_F(1e-12).item())

    influence_sum = torch.zeros((out_h, out_w, 1), dtype=F32, device=img.device)
    denoised = torch.zeros((out_h, out_w, 3), dtype=F32, device=img.device)

    for tap_i, (ox, oy) in enumerate(spiral_offsets(n_taps - 1,
                                                    pixel_multiplier)):
        ox = _F(ox)
        oy = _F(oy)
        if mask_taps and _F(tap_i) > samples_f:
            # a masked tap adds exactly 0.0 to both sums: the kept-prefix
            # sums are unchanged bit for bit, so it is skipped
            continue
        radius2 = np.power(np.maximum(_F(ox * ox + oy * oy), _F(0.0)),
                           _F(distribution_bias), dtype=np.float32)
        pixel_influence = _F(1.0) - sample_true_radius * radius2
        if same_res:
            tap = bilinear_sample_shifted(img, float(ox), float(oy))
        else:
            tap = _resample_taps(img, out_h, out_w, ox, oy)
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


def postprocess(img, config: DenoiserConfig, out_h: int, out_w: int):
    """The full presentation pass: denoise (if enabled) + resample."""
    if config.enabled:
        return denoise(
            img,
            samples=int(config.samples),
            distribution_bias=config.distribution_bias,
            pixel_multiplier=config.pixel_multiplier,
            inverse_hue_tolerance=config.inverse_hue_tolerance,
            out_shape=(out_h, out_w),
        )
    return bilinear_resample(img, out_h, out_w)
