"""The comparison that decides `correct`: its arithmetic, the control (the
reference in bfloat16, which must fail), and whole runs of the harness on
the CPU with the program broken underneath, which must come out not
correct, beside the same runs unbroken."""

from __future__ import annotations

import math

import pytest
import torch

from rtbench import check, control, faults
from rtbench import run as harness
from rtbench.tests.small import small_cell

CPU = torch.device("cpu")
SECONDS = 2.0  # enough for every checked frame of the small cells


def test_frame_gaps():
    a = torch.zeros(4, 5, 3)
    b = a.clone()
    assert check.frame_gaps(a, b) == (0.0, 0.0)
    b[1, 2, 0] = 0.25
    assert check.frame_gaps(a, b) == (0.25, 100.0 / 60)
    b[3, 4, 2] = check.OFF_GAP / 2  # under the gap that counts as off
    assert check.frame_gaps(a, b) == (0.25, 100.0 / 60)
    b[0, 0, 0] = float("nan")
    assert check.frame_gaps(a, b)[0] == math.inf
    a[0, 0, 0] = float("nan")
    assert check.frame_gaps(a, b) == (0.25, 100.0 / 60)
    assert check.frame_gaps(a, b[:2]) == (math.inf, 100.0)


def test_verdict():
    ok = check.verdict([(0.0, 0.0), (1e-7, 0.0)], 0)
    assert ok["correct"] and ok["failed"] == 0
    assert list(ok["numbers"]) == ["max_abs_diff", "share_off_pct",
                                   "frames_checked", "scene_voxels_wrong"]
    assert not check.verdict([], 0)["correct"]
    assert not check.verdict([(0.0, 0.0)], 1)["correct"]
    wide = check.verdict([(0.0, 0.0), (2 * check.MAX_ABS_DIFF_LIMIT, 0.1)],
                         0)
    assert not wide["correct"] and wide["failed"] == 1
    many = check.verdict([(1e-5, 2 * check.SHARE_OFF_LIMIT)], 0)
    assert not many["correct"] and many["failed"] == 1


@pytest.mark.parametrize("name", ["default_flythrough", "edit_brush_1080p"])
def test_control_fails(name):
    """The reference presented through bfloat16 fails the comparison."""
    out = control.readings(small_cell(name), 77, CPU)
    assert not out["correct"]
    assert min(w for w, _ in out["gaps"]) > check.MAX_ABS_DIFF_LIMIT
    assert min(s for _, s in out["gaps"]) > check.SHARE_OFF_LIMIT


def _run(name, seed=31):
    out = harness.run(small_cell(name), seed, SECONDS, False, CPU)
    assert out["check"]["frames_checked"]["value"] >= 1
    return out


@pytest.mark.parametrize("name", ["default_flythrough", "edit_brush_1080p",
                                  "fly_1080p"])
def test_sound_run_is_correct(name):
    out = _run(name)
    assert out["correct"], out["check"]
    assert out["forbidden"] == []


FAULTS = [
    ("default_flythrough", "stale_frames"),
    ("default_flythrough", "half_samples"),
    ("default_flythrough", "answer_altered"),
    ("fly_1080p", "stale_frames"),
    ("fly_1080p", "half_rows"),
    ("fly_1080p", "answer_altered"),
    ("edit_brush_1080p", "stale_frames"),
    ("edit_brush_1080p", "half_edits"),
    ("edit_brush_1080p", "edits_dropped"),
    ("edit_brush_1080p", "stale_records"),
    ("edit_brush_1080p", "answer_altered"),
]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f}" for n, f in FAULTS])
def test_broken_program_is_not_correct(monkeypatch, name, fault):
    faults.FAULTS[fault](monkeypatch.setattr)
    out = _run(name)
    assert not out["correct"], out["check"]
