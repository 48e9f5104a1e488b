"""The port's entry module (`zig_vulkan_tpu_torch.entry`) against the JAX
package's `__graft_entry__.entry()` on the same scene: the small test scene
at 64x48, 1 spp, two bounce levels with the sun, `render_rows(max_steps=256)`
then `denoise(samples=8)`.

Tolerances, as tests/test_torch_engine.py: the jitted reference contracts
multiply-adds and approximates rsqrt, and the sin hash turns a last-bit
difference of a hit point into another random number, so the traced frame
is held statistically (mean |d| < 5e-3, under 1% of pixels over 1e-3); the
denoiser spreads each differing pixel over its taps, so the step's output
is held to the mean bound alone.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from zig_vulkan_tpu.ops import trace as rtrace
from zig_vulkan_tpu_torch import entry as tentry
from zig_vulkan_tpu_torch.core.grid import GridArrays
from zig_vulkan_tpu_torch.models import scenes as tscenes
from zig_vulkan_tpu_torch.ops import trace as ttrace

REPO = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, REPO)
import __graft_entry__ as rentry  # noqa: E402  (the JAX entry module)

torch.set_num_threads(2)

FIELDS = ("statuses", "indices", "occupancy", "start_indices",
          "material_indices", "active_bricks", "material_cursor",
          "diel_mask", "brick_ir")


@pytest.fixture(scope="module")
def both():
    rfn, rargs = rentry.entry()
    tfn, targs = tentry.entry("cpu")
    return rfn, rargs, tfn, targs


def test_entry_example_args_equal_the_reference(both):
    _, rargs, _, targs = both
    want = GridArrays.to_device(rargs[0], "cpu")
    for f in FIELDS:
        a, b = getattr(targs[0], f), getattr(want, f)
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8)), f
    for k, v in rargs[2].items():  # the camera vectors
        np.testing.assert_array_equal(targs[2][k].numpy(), np.asarray(v))
    for got, exp in zip(targs[3:], rargs[3:]):  # the sun
        np.testing.assert_array_equal(np.asarray(got), np.asarray(exp))
    # the material table: albedo, type and type data of all 256 rows
    m = rargs[1]
    np.testing.assert_array_equal(targs[1][:3].numpy().T,
                                  np.asarray(m.albedo))
    np.testing.assert_array_equal(targs[1][3].numpy(),
                                  np.asarray(m.mtype, dtype=np.float32))
    np.testing.assert_array_equal(targs[1][4].numpy(),
                                  np.asarray(m.type_data))


def test_entry_traced_frame_matches_the_reference_statistically(both):
    _, rargs, _, targs = both
    sc = tscenes.small_test_scene()
    static = sc.grid.static
    want = np.asarray(jax.jit(
        lambda a, m, c, p, col, r: rtrace.render_rows(
            static, a, m, c, 64, 48, 1, 2, p, col, r, True, max_steps=256)
    )(*rargs))
    arrays, mats, cam, sun_p, sun_c, sun_r = targs
    got = ttrace.render_rows(
        static, ttrace.one_shot_tables(static, arrays),
        arrays.material_indices, mats, cam, 64, 48, 1, 2, sun_p, sun_c,
        sun_r, True, max_steps=256).numpy()
    assert got.shape == want.shape == (48, 64, 3)
    diff = np.abs(got - want).max(axis=-1)
    assert diff.mean() < 5e-3
    assert (diff > 1e-3).mean() < 0.01


def test_entry_step_matches_the_reference_step(both):
    rfn, rargs, tfn, targs = both
    want = np.asarray(jax.jit(rfn)(*rargs))
    got = tfn(*targs)
    assert got.dtype == torch.float32 and tuple(got.shape) == (48, 64, 3)
    got = got.numpy()
    assert want.shape == got.shape and np.isfinite(got).all()
    assert np.abs(got - want).max(axis=-1).mean() < 5e-3
    # a scene, not a flat colour
    assert len(np.unique((got * 255).astype(np.uint8).reshape(-1, 3),
                         axis=0)) > 64


def test_entry_has_no_cpu_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()


def _run(*args):
    return subprocess.run(
        [sys.executable, "-m", "zig_vulkan_tpu_torch.entry", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"})


def test_entry_module_runs_on_the_cpu():
    r = _run("--device", "cpu", "8")
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert lines[0] == "entry OK: (48, 64, 3)"
    assert lines[1].startswith("dryrun_multichip(8): OK")
    assert lines[1].count("'cpu'") == 8


def test_entry_module_exits_2_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    r = _run()
    assert r.returncode == 2
    assert "OK" not in r.stdout and "--device cpu" in r.stderr
