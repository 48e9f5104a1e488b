"""Peaks of the card and the least work of kernel F, the post-process.

A frozen copy of the kernel F arithmetic of `zig_vulkan_tpu_torch/utils/
roofline.py` (`denoise_ops`, `denoise_bytes`, `bound_ms`), counted by hand
from csrc/denoise.cu: a shifted tap is its bilinear sample (27 operations)
and its weight (31, plus two powf counted as 20 each), a pixel 13 more; the
resampling path adds a coordinate on each axis a tap (6 each) and the
centre's resample. Each input pixel is read once and each output pixel
written once, 12 bytes each. Only the live taps (`samples` + 1) are
counted: the work these inputs need, whatever the program runs besides.

Peaks: NVIDIA's data sheet for one H100 SXM, dense, at its 700 W limit:
3.35 TB/s of HBM, 67 TFLOP/s of float32 outside the tensor cores.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

POWF_OPS = 20
DENOISE_SAMPLE_OPS = 27
DENOISE_TAP_OPS = 31 + 2 * POWF_OPS
DENOISE_COORD_OPS = 6
DENOISE_CENTRE_COORD_OPS = 7
DENOISE_PIXEL_OPS = 13
PIXEL_BYTES = 3 * 4


def denoise_ops(pixels: int, taps: int, resample: bool) -> int:
    """Float operations of the sirBird filter over `pixels` output pixels
    with `taps` live taps; `resample` where the output size differs from
    the input's."""
    tap = DENOISE_SAMPLE_OPS + DENOISE_TAP_OPS
    per = DENOISE_PIXEL_OPS
    if resample:
        tap += 2 * DENOISE_COORD_OPS
        per += 2 * DENOISE_CENTRE_COORD_OPS + DENOISE_SAMPLE_OPS
    return pixels * (taps * tap + per)


def denoise_bytes(in_pixels: int, out_pixels: int) -> int:
    return PIXEL_BYTES * (in_pixels + out_pixels)


def bound_ms(n_bytes: float, n_ops: float) -> float:
    """The least time of work of `n_bytes` and `n_ops` at the peaks."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S) * 1e3


def denoise_bound_ms(engine: dict) -> float:
    """Kernel F's least time for one frame of configuration `engine` (its
    "engine" entry): the denoiser at its `samples` + 1 live taps."""
    iw = engine["internal_resolution_width"]
    ih = engine["internal_resolution_height"]
    ow = engine["output_resolution_width"]
    oh = engine["output_resolution_height"]
    taps = int(engine["denoiser"]["samples"]) + 1
    return bound_ms(denoise_bytes(iw * ih, ow * oh),
                    denoise_ops(ow * oh, taps, (iw, ih) != (ow, oh)))
