"""The harness on the card: the small cells and one full cell come out
correct through the kernels, the control at the small size does not, and
a traced run reads every per-layer metric of its cell. Skipped without a
CUDA device.

    python -m pytest rtbench/tests/test_rtbench_card.py -q
"""

from __future__ import annotations

import pytest
import torch

from rtbench import check, control, spec
from rtbench import run as harness
from rtbench.tests.small import small_cell


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("the benchmark's card tests need a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["default_flythrough", "edit_brush_1080p",
                                  "fly_1080p"])
def test_small_cell_on_the_card(card, name):
    out = harness.run(small_cell(name), 2**32 + 17, 1.0, False, card)
    assert out["correct"], out["check"]
    assert out["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["default_flythrough", "edit_brush_1080p"])
def test_small_control_fails_on_the_card(card, name):
    out = control.readings(small_cell(name), 23, card)
    assert not out["correct"]
    assert min(w for w, _ in out["gaps"]) > check.MAX_ABS_DIFF_LIMIT


@pytest.mark.cuda
def test_traced_full_cell(card):
    bench = spec.load()
    name = "default_flythrough"
    out = harness.run(spec.cell(bench, name), 91, 1.0, True, card,
                      spec.readers(bench, name))
    assert out["correct"], out["check"]
    assert set(out["metrics"]) == set(spec.readers(bench, name))
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert 0 < out["metrics"]["denoise_roofline"] <= 100
