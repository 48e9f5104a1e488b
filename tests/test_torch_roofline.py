"""The bound reckoning of zig_vulkan_tpu_torch.utils.roofline.

The least time of a kernel launch on the card is computed from its shapes
and its data (chip_smoke.py reports it beside each kernel's time); these
tests hold the byte counts to a count by hand of what each build of kernel
A and kernel B and the edits read and write, and the warp-use share to hand-made step
counts. No JAX.
"""

import math

import numpy as np
import pytest
import torch

from zig_vulkan_tpu_torch.utils import roofline

torch.set_num_threads(2)


@pytest.mark.parametrize("has_key,shadow,stats,want", [
    # in: 6 f32 of ray + the active byte = 25; out: found (1) + t, px..pz,
    # nx..nz (7 f32) + index (4) = 33
    (False, False, False, 25 + 33),
    (True, False, False, 25 + 4 + 33),       # the dielectric key
    (False, True, False, 25 + 12 + 33 + 1),  # sun target in, occluded out
    (False, False, True, 25 + 33 + 4),       # n_step out
    (True, True, True, 25 + 4 + 12 + 33 + 1 + 4),
])
def test_traverse_bytes_per_lane(has_key, shadow, stats, want):
    assert roofline.traverse_bytes_per_lane(has_key, shadow, stats) == want


def test_traverse_bytes_of_the_frames_primary_launch():
    """1,179,648 lanes (2 spp at 1024x576), 395,516 hits: 68.4 MB of ray
    I/O plus one material byte a hit, 20.5 us at 3.35 TB/s."""
    n = 2 * 1024 * 576
    got = roofline.traverse_bytes(n, 395_516)
    assert got == n * 58 + 395_516
    ms, by = roofline.traverse_bound_ms(n, 395_516, 0)
    assert by == "bytes"
    assert math.isclose(ms, got / 3.35e12 * 1e3)
    assert 0.0204 < ms < 0.0206


def test_traverse_bound_turns_to_operations_with_many_steps():
    """A NO_SKIP 1080p pose: 2,073,600 lanes at 100.6 steps a lane is 4.4 G
    operations of at least 21 each (65 us at 67 TFLOP/s) against 120 MB
    (36 us)."""
    n = 1920 * 1080
    iters = int(100.6 * n)
    ms, by = roofline.traverse_bound_ms(n, 731_381, iters)
    assert by == "operations"
    assert math.isclose(ms, iters * 21 / 67e12 * 1e3)
    assert 0.065 < ms < 0.066


def test_sprayed_pose_is_bound_by_bytes():
    """The sprayed 1080p pose, 36.32 steps a lane: 1.6 G operations (24 us)
    stay under its 120 MB of ray I/O (36 us)."""
    n = 1920 * 1080
    ms, by = roofline.traverse_bound_ms(n, 731_381, int(36.32 * n))
    assert by == "bytes"
    assert math.isclose(ms, roofline.traverse_bytes(n, 731_381) / 3.35e12 * 1e3)


def test_operations_count_the_cheapest_iteration():
    """The hand count of the empty-cell step: loop test and counter, grid
    bounds, cell index, record address, record test, axis choice, step."""
    assert roofline.MIN_OPS_PER_ITERATION == 2 + 6 + 4 + 2 + 1 + 3 + 3


def test_lookup_bytes_and_bound():
    """Kernel B on the frame: 4 B in and 5 x 4 B out a lane (28.3 MB,
    8.45 us), plus the 5 KiB of tables."""
    n = 1_179_648
    got = roofline.lookup_bytes(n, 5, 256)
    assert got == n * 24 + 5 * 256 * 4
    ms, by = roofline.bound_ms(got)
    assert by == "bytes" and 0.00844 < ms < 0.00847


@pytest.mark.parametrize("op,records,want", [
    # 1,024 lanes of 16 bytes; an insert with the records current also
    # reads the 1M-cell status bits (128 KiB) and writes the field (4 MiB)
    ("insert", True, 1024 * 16 + (1 << 17) + (1 << 22)),
    ("insert", False, 1024 * 16),
    ("remove", True, 1024 * 16),
])
def test_edit_bytes_of_a_brush_stroke(op, records, want):
    """The edit cell's stroke on the 128x64x128-cell world: an insert's
    bound 1.3 us at 3.35 TB/s, a removal's 5 ns, both bytes."""
    cells = 128 * 64 * 128
    assert roofline.edit_bytes(op, 1024, cells, records) == want
    ms, by = roofline.edit_bound_ms(op, 1024, cells, records)
    assert by == "bytes" and ms == pytest.approx(want / 3.35e12 * 1e3)


@pytest.mark.parametrize("mode,prev,key,targets,want", [
    # every lane: bouncing and found in, colour in and out, bouncing out
    # (27); the state read: hit point and normal, five looked-up values,
    # direction, internal reflection, loop count in and out (68); the
    # ignore type (4)
    (0, False, False, False, 27 + 68 + 4),
    (1, False, False, True, 27 + 68 + 1 + 4 + 12),   # occluded; targets
    # the pending term and shadow mask out, the shadow directions; the
    # previous level's pending term and its shadow hit in; the key
    (2, True, True, False, 27 + 13 + 13 + 68 + 4 + 12 + 4),
])
def test_shade_bytes_of_the_build_without_queues(mode, prev, key, targets,
                                                 want):
    """Every lane moves the same bytes; the lanes that hit also write
    their origin and dielectric state (20), those that bounce on their
    direction (12); 7 frame values."""
    got = roofline.shade_bytes(1000, 300, 200, mode, prev, key, targets)
    assert got == 1000 * want + 300 * 20 + 200 * 12 + 28


@pytest.mark.parametrize("mode,prev,key,targets,every,hit,bounce", [
    (0, False, False, False, 27, 68, 0),
    (1, False, False, True, 27, 68 + 1, 12),
    (2, True, True, False, 27 + 13 + 13, 68 + 12, 4),
])
def test_shade_bytes_of_the_queued_build(mode, prev, key, targets, every,
                                         hit, bounce):
    """The build that takes or fills queues reads the state of the lanes
    that hit alone, and writes the next key and targets only for the lanes
    that bounce on: a lane that missed moves its masks, colour and pending
    term, no ignore type."""
    got = roofline.shade_bytes(1000, 300, 200, mode, prev, key, targets,
                               queued=True)
    assert got == (1000 * every + 300 * (hit + 20) + 200 * (bounce + 12)
                   + 28)
    # no lane hit: the masks, colour and pending term alone
    assert roofline.shade_bytes(1000, 0, 0, mode, prev, key, targets,
                                queued=True) == 1000 * every + 28
    # every lane hit and bounces on: the build without queues' bytes, less
    # the ignore type it reads where a lane missed
    assert (roofline.shade_bytes(1000, 1000, 1000, mode, prev, key, targets,
                                 queued=True)
            == roofline.shade_bytes(1000, 1000, 1000, mode, prev, key,
                                    targets) - 1000 * 4)


def test_queued_shade_bound_of_a_sky_lane_level():
    """A first level of 1,179,648 lanes of which a third hit: the queued
    build's bound is the bytes of the hit lanes' state and every lane's
    colour, 27.3 us at 3.35 TB/s against 48.5 us for the build without
    queues."""
    n, hit, on = 1_179_648, 395_516, 300_000
    ms, by = roofline.shade_bound_ms(n, hit, on, 2, next_key=True,
                                     queued=True)
    full, _ = roofline.shade_bound_ms(n, hit, on, 2, next_key=True)
    assert by == "bytes"
    assert math.isclose(ms, roofline.shade_bytes(
        n, hit, on, 2, next_key=True, queued=True) / 3.35e12 * 1e3)
    assert 0.0273 < ms < 0.0274 and 0.0485 < full < 0.0486


def test_bound_takes_the_larger_time():
    assert roofline.bound_ms(3.35e9, 0) == (1.0, "bytes")
    assert roofline.bound_ms(0, 67e9) == (1.0, "operations")
    assert roofline.bound_ms(3.35e9, 2 * 67e9)[1] == "operations"


@pytest.mark.parametrize("n_step,want", [
    ([5] * 32, 1.0),                              # one warp, all alike
    ([8] + [0] * 31, 8 / (32 * 8)),               # one live lane
    ([4] * 32 + [1, 3] + [0] * 30, (128 + 4) / (32 * 4 + 32 * 3)),
    ([2, 2, 2], 6 / (32 * 2)),                    # a partial warp, padded
    (list(range(32)), sum(range(32)) / (32 * 31)),
])
def test_warp_use_share(n_step, want):
    assert math.isclose(roofline.warp_use_share(np.array(n_step)), want)


def test_warp_use_share_without_work_is_nan():
    assert math.isnan(roofline.warp_use_share(np.zeros(64, np.int64)))
    assert math.isnan(roofline.warp_use_share(np.zeros(0, np.int64)))


def test_packing_the_active_lanes_raises_the_share():
    """Masked-off lanes (n_step 0) scattered among live ones waste whole
    warp lifetimes; packed, the live lanes fill their warps."""
    rng = np.random.default_rng(0)
    steps = rng.integers(5, 15, 4096)
    active = rng.random(4096) < 0.25
    scattered = np.where(active, steps, 0)
    assert (roofline.warp_use_share(steps[active])
            > 2 * roofline.warp_use_share(scattered))


def test_slowest_lanes_picks_the_active_tail():
    """The active lanes above the active lanes' 99th percentile of steps;
    masked-off lanes never count, however many steps they show."""
    n_step = torch.arange(1000, dtype=torch.int32)
    active = torch.ones(1000, dtype=torch.bool)
    active[995:] = False  # the five longest lanes are masked off
    got = roofline.slowest_lanes(n_step, active)
    q = torch.quantile(torch.arange(995, dtype=torch.float32), 0.99)
    assert torch.equal(got, active & (n_step.float() > q))
    assert int(got.sum()) == 10 and not bool(got[995:].any())
    assert int(roofline.slowest_lanes(n_step, active, share=0.1).sum()) == 100


def test_slowest_lanes_without_active_lanes():
    n_step = torch.ones(64, dtype=torch.int32)
    none = torch.zeros(64, dtype=torch.bool)
    assert not bool(roofline.slowest_lanes(n_step, none).any())


def test_denoise_bound_of_the_default_frame():
    """Kernel F on the default frame: 589,824 pixels, 21 taps of 98
    operations (powf as 20) and 13 a pixel, 1.22 G operations (18.2 us at
    67 TFLOP/s) against 14.2 MB read and written (4.2 us): bound by
    operations."""
    from zig_vulkan_tpu_torch.ops import denoise

    n = 1024 * 576
    assert roofline.DENOISE_SAMPLE_OPS + roofline.DENOISE_TAP_OPS == 98
    ops = roofline.denoise_ops(n, 21, denoise.SHIFTED)
    assert ops == n * (21 * 98 + 13)
    assert roofline.denoise_bytes(n, n) == n * 24
    ms, by = roofline.denoise_bound_ms(n, n, 21, denoise.SHIFTED)
    assert by == "operations" and math.isclose(ms, ops / 67e12 * 1e3)
    assert 0.0182 < ms < 0.0183


def test_denoise_resample_alone_is_bound_by_bytes():
    """1024x576 to 1280x720 without the denoiser: 41 operations a pixel
    (two coordinates and a sample) stay under 18.1 MB of pixels (5.4 us);
    the resampling denoiser adds 12 operations a tap and the centre."""
    from zig_vulkan_tpu_torch.ops import denoise

    n_in, n_out = 1024 * 576, 1280 * 720
    ms, by = roofline.denoise_bound_ms(n_in, n_out, 0, denoise.RESAMPLE_ONLY)
    assert by == "bytes"
    assert math.isclose(ms, 12 * (n_in + n_out) / 3.35e12 * 1e3)
    assert roofline.denoise_ops(n_out, 0, denoise.RESAMPLE_ONLY) == 41 * n_out
    assert (roofline.denoise_ops(1, 21, denoise.RESAMPLE)
            - roofline.denoise_ops(1, 21, denoise.SHIFTED)) == 21 * 12 + 41


def test_denoise_bound_of_the_runtime_path():
    """The runtime path at the default knobs: the 21 live taps as the static
    path's, plus 33 influences from the knobs once (28 operations each,
    powf as 20) and 12 bytes of knobs; 12 masked taps of 33 operations
    (the bilinear sample, three products and sums) count only at the pixels
    whose masked taps read a value that is not finite."""
    from zig_vulkan_tpu_torch.ops import denoise

    n = 1024 * 576
    static = roofline.denoise_ops(n, 21, denoise.SHIFTED)
    finite = roofline.denoise_ops(n, 21, denoise.SHIFTED, 12, 0, 33)
    assert finite == static + 33 * 28
    assert (roofline.denoise_ops(n, 21, denoise.SHIFTED, 12, 100, 33)
            - finite) == 100 * 12 * 33
    assert (roofline.denoise_ops(1, 21, denoise.RESAMPLE, 12, 1)
            - roofline.denoise_ops(1, 21, denoise.RESAMPLE)) == 12 * 45
    assert roofline.denoise_bytes(n, n, runtime=True) == n * 24 + 12
    ms, by = roofline.denoise_bound_ms(n, n, 21, denoise.SHIFTED, 12, 0, 33)
    assert by == "operations" and math.isclose(ms, finite / 67e12 * 1e3)
