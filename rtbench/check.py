"""The comparison that decides `correct`.

What is judged is the image `VoxelRT.draw()` returned for each checked
frame of the window (`traffic.Tables.checked`, drawn from the seed), kept
as the program returned it and compared once the window has closed with the
reference's image of the same frame (`ref.engine.RefEngine`, which applies
every edit up to and including that frame's to its own copy of the set-up
scene first).

Two numbers are compared for each checked frame, and the worst frame's are
reported: the widest gap of a pixel channel between the program's value and
the reference's, and the share of the pixel channels whose gap exceeds
`OFF_GAP` (a few float32 ulps). The first catches a wrong pixel, the second
a change that moves many pixels a little: a frame traced at half its
samples moves about two thirds of them by 1e-5 to 1e-4. A NaN on one side
only is an infinite gap; a NaN on both is none. Each limit sits between
what sound runs of the program read (0: they are bit for bit the
reference's) and what the control reads: the reference itself with its
traced and presented images rounded to bfloat16, the next precision below
the float32 the configurations state (PERF.md gives both readings).

Beside the images, the scene: once the window has closed, the program is
handed the edits of the frames after the last one up to a cycle's last
insert (no draws), its scene arrays are decoded by the reference's own
decoder (`dense_materials`) and compared voxel by voxel with the set-up
scene plus every stroke, exactly. An edit out of every checked frame's
view shows there. A run that checked no frame is not correct.
"""

from __future__ import annotations

import math

import torch

# the widest gap a checked pixel channel may show
MAX_ABS_DIFF_LIMIT = 1e-3
# a pixel channel is off where its gap exceeds OFF_GAP (about 8 float32
# ulps at 1.0); the worst checked frame may have at most SHARE_OFF_LIMIT %
# of its channels off
OFF_GAP = 1e-6
SHARE_OFF_LIMIT = 1.0
MIN_FRAMES_CHECKED = 1
# an exact comparison: every voxel of the scene as the edits leave it
SCENE_VOXELS_WRONG_LIMIT = 0


def frame_gaps(got, want):
    """(widest gap, % of channels off) of an image against the
    reference's: max |got - want| over every element, and the share of
    elements whose gap exceeds OFF_GAP."""
    if got.shape != want.shape:
        return math.inf, 100.0
    got = got.to(torch.float32)
    want = want.to(torch.float32).to(got.device)
    g_nan, w_nan = torch.isnan(got), torch.isnan(want)
    gap = torch.where(g_nan & w_nan, torch.zeros_like(got),
                      (got - want).abs())
    gap = torch.where(g_nan != w_nan, torch.full_like(gap, math.inf), gap)
    if not gap.numel():
        return 0.0, 0.0
    return (float(gap.max()),
            100.0 * float((gap > OFF_GAP).to(torch.float64).mean()))


def verdict(frames, scene_wrong: int) -> dict:
    """The numbers compared, each with its limit and rule, and `correct`,
    from each checked frame's `frame_gaps` (`frames`, a list) and the
    voxels the program's scene gets wrong after the window."""
    widest = max((w for w, _ in frames), default=math.inf)
    share = max((s for _, s in frames), default=100.0)
    numbers = {
        "max_abs_diff": {"value": widest, "limit": MAX_ABS_DIFF_LIMIT,
                         "rule": "<="},
        "share_off_pct": {"value": share, "limit": SHARE_OFF_LIMIT,
                          "rule": "<="},
        "frames_checked": {"value": len(frames),
                           "limit": MIN_FRAMES_CHECKED, "rule": ">="},
        "scene_voxels_wrong": {"value": int(scene_wrong),
                               "limit": SCENE_VOXELS_WRONG_LIMIT,
                               "rule": "<="},
    }
    bad = [w > MAX_ABS_DIFF_LIMIT or s > SHARE_OFF_LIMIT for w, s in frames]
    correct = (len(frames) >= MIN_FRAMES_CHECKED and not any(bad)
               and scene_wrong <= SCENE_VOXELS_WRONG_LIMIT)
    return {"correct": bool(correct), "failed": int(sum(bad)),
            "numbers": numbers}


def lines(numbers: dict):
    """The numbers as plain lines for standard error."""
    for name, n in numbers.items():
        yield f"check {name} {n['value']!r} {n['rule']} {n['limit']!r}"
