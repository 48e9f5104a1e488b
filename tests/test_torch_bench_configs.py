"""The port's BASELINE harness (`zig_vulkan_tpu_torch.benchmarks.configs`),
fly-through module and headline bench on the CPU, beside
tests/test_bench_configs.py: each config at the same small `scale` and
`frames` on `device="cpu"` against the JAX harness run at the same size.

Held: the result keys equal the JAX harness's; config 5 over 8 `cpu` shards
reports 8 devices and streams the same number of voxels; config 3's edited
scene equals the JAX engine's array for array after the same frames (the
same random stream in the same order); the fly-through's report backs its
average with 60 / fixed_dt frames; the bench line's keys, its parity with
the numpy oracle (>= 0.995: the skip path may flip grazing voxels in under
0.5% of lanes) and its non-zero exit with the zero line when a phase raises.
"""

import json
import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch

import zig_vulkan_tpu_torch.config as tconfig
from zig_vulkan_tpu_torch.benchmarks import bench as tbench
from zig_vulkan_tpu_torch.benchmarks import configs as tconfigs
from zig_vulkan_tpu_torch.benchmarks import flythrough as tfly
from zig_vulkan_tpu_torch.core.grid import GridArrays
from zig_vulkan_tpu_torch.models import scenes as tscenes
from zig_vulkan_tpu_torch.utils.device import NoCudaDevice

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmarks import configs as rconfigs  # noqa: E402  (the JAX harness)

torch.set_num_threads(2)

FIELDS = ("statuses", "indices", "occupancy", "start_indices",
          "material_indices", "active_bricks", "material_cursor",
          "diel_mask", "brick_ir")
# config: (function, scale, frames) as tests/test_bench_configs.py
CASES = {
    1: ("config1_dense_primary", 0.15, 2),
    2: ("config2_sparse_diffuse_shadows", 0.05, 2),
    3: ("config3_interactive_edits", 0.05, 2),
    4: ("config4_path_traced_emissive", 0.05, 2),
}


def _run_keeping_engine(harness, name, **kw):
    """(result, engine) of `harness.name(**kw)` for the JAX harness or the
    port's: `_timed_frames` is wrapped to keep the engine it times."""
    box = {}
    timed = harness._timed_frames

    def keep(rt, *args, **kwargs):
        box["rt"] = rt
        return timed(rt, *args, **kwargs)

    with mock.patch.object(harness, "_timed_frames", keep):
        out = getattr(harness, name)(**kw)
    return out, box["rt"]


@pytest.mark.parametrize("number", sorted(CASES))
def test_config_result_keys_equal_the_reference_harness(number):
    name, scale, frames = CASES[number]
    want, ref = _run_keeping_engine(rconfigs, name, scale=scale,
                                    frames=frames)
    got, port = _run_keeping_engine(tconfigs, name, scale=scale,
                                    frames=frames, device="cpu")
    assert set(got) == set(want)
    assert got["config"] == want["config"]
    assert got["ms_per_frame"] > 0 and got["fps"] > 0
    assert got["mrays_per_s"] > 0
    assert port.internal_resolution == ref.internal_resolution
    assert port.grid_static.voxel_dims == ref.grid_static.voxel_dims
    w, h = port.internal_resolution
    spp = int(port.camera.d_camera.samples_per_pixel)
    assert got["mrays_per_s"] == pytest.approx(
        w * h * spp / got["ms_per_frame"] / 1e3)
    if number != 3:
        return
    # config 3: warm-up edits 0 and 1, then `frames` more, the same stream
    want_arrays = GridArrays.to_device(ref.arrays, "cpu")
    for f in FIELDS:
        a, b = getattr(port.arrays, f), getattr(want_arrays, f)
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8)), f
    assert int(port.arrays.active_bricks) > 0
    # and both cameras are back at the start of the path
    np.testing.assert_array_equal(port.camera.d_camera.origin,
                                  ref.camera.d_camera.origin)


def test_config3_edit_stream_draws_in_the_reference_order():
    """x, y, z, then the materials of an insert, from default_rng(0)."""
    rt = tconfigs.build_config3(0.05, "cpu")
    edits = tconfigs.EditStream(rt)
    rng = np.random.default_rng(0)
    vx, vy, vz = rt.grid_static.voxel_dims
    for i in range(3):
        xyz, mats = edits.draw(i)
        want = np.stack([rng.integers(0, vx, 512), rng.integers(0, vy, 512),
                         rng.integers(0, vz, 512)], axis=-1)
        np.testing.assert_array_equal(xyz, want)
        if i % 2 == 0:
            np.testing.assert_array_equal(
                mats, rng.integers(1, 8, 512).astype(np.uint8))
        else:
            assert mats is None


def test_config5_over_8_cpu_shards_matches_the_reference_harness():
    want = rconfigs.config5_multichip_4k(scale=0.05, frames=1)
    got = tconfigs.config5_multichip_4k(scale=0.05, frames=1,
                                        devices=["cpu"] * 8)
    assert set(got) == set(want)
    assert got["devices"] == want["devices"] == 8
    assert got["streamed_voxels"] == want["streamed_voxels"] > 0
    assert got["config"] == want["config"]
    assert got["ms_per_frame"] > 0 and got["stream_s"] > 0


def test_config4_block_in_view_is_an_extra_cell():
    assert tconfigs.config4_emissive_block_in_view not in tconfigs.ALL_CONFIGS
    assert [f.__name__ for f in tconfigs.ALL_CONFIGS] == [
        f.__name__ for f in rconfigs.ALL_CONFIGS]
    rt = tconfigs.build_config4(0.05, "cpu")
    before = rt.render().clone()
    tconfigs.look_at_emissive_block(rt)
    view = rt.render()
    assert rt._accum_count == 1  # the new pose restarts the accumulation
    # albedo 1.0 x strength 8 tone-maps to 8/9, gamma 0.943; the sun lights
    # no albedo beyond 0.5, gamma 0.707
    assert float(view[..., 0].max()) > 0.9 > float(before[..., 0].max())


def test_run_all_names_the_device_and_needs_cuda_by_default(capsys):
    if not torch.cuda.is_available():
        with pytest.raises(NoCudaDevice):
            tconfigs.run_all(0.05)
        assert tconfigs.main(["0.05"]) == 2
    with mock.patch.object(tconfigs, "ALL_CONFIGS",
                           [tconfigs.config1_dense_primary,
                            tconfigs.config5_multichip_4k]):
        assert tconfigs.main(["0.05", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("'device': 'cpu (cpu)'") == 2
    assert "'devices': 1" in out


def _small_workload(**kw):
    return tfly.default_workload(width=64, height=36, **kw)


@pytest.mark.parametrize("fixed_dt", [10.0, 7.5])
def test_flythrough_report_counts_the_whole_path(fixed_dt, capsys):
    scene = tscenes.default_scene(dims=(8, 4, 8))
    report = tfly.fly(fixed_dt, "cpu", scene=scene, config=_small_workload())
    assert report.delta_time_sum_samples == 60 / fixed_dt
    assert len(report.samples) == report.delta_time_sum_samples
    assert sum(report.samples) == pytest.approx(report.delta_time_sum)
    assert 0 < report.min_delta_time <= report.average() \
        <= report.max_delta_time
    text = capsys.readouterr().out
    assert "BENCHMARK REPORT" in text
    assert f"Frames                   : {int(60 / fixed_dt)}" in text
    assert "samples per pixel" in text


def test_flythrough_default_workload_is_the_reference_one():
    cfg = tfly.default_workload()
    assert (cfg.internal_resolution_width,
            cfg.internal_resolution_height) == (1024, 576)
    assert cfg.camera.samples_per_pixel == 2 and cfg.camera.max_bounce == 2
    assert cfg.sun.enabled and cfg.sun.animate and cfg.denoiser.enabled
    assert cfg == tconfig.EngineConfig(
        camera=cfg.camera, sun=cfg.sun, denoiser=cfg.denoiser)
    assert not tfly.default_workload(animate_sun=False).sun.animate
    assert str(tfly.SCENE_CACHE).endswith(
        os.path.join("zig_vulkan_tpu_torch", "build",
                     "bench_scene_cache.npz"))


def _bench_line(capsys, argv):
    rc = tbench.main(argv)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    assert len(lines) == 1  # ONE JSON line on stdout
    return rc, json.loads(lines[0])


def test_bench_line_on_the_cpu(capsys):
    rc, rec = _bench_line(capsys, ["3", "--device", "cpu", "--scale", "0.1"])
    assert rc == 0
    assert set(rec) == {"metric", "value", "unit", "parity_vs_oracle",
                        "default_frame_ms", "default_frame_workload",
                        "kernel_a_launches_per_pose", "scale", "device"}
    assert "vs_baseline" not in rec
    assert rec["metric"] == tbench.METRIC == rconfigs_metric()
    assert rec["value"] > 0 and rec["unit"] == "Mray/s"
    assert rec["parity_vs_oracle"] >= 0.995
    assert rec["default_frame_ms"] > 0
    assert rec["device"] == "cpu (cpu)"
    # on the CPU the wrapper runs the plain version: no launch is counted
    assert rec["kernel_a_launches_per_pose"] == 0


def rconfigs_metric():
    """METRIC of the JAX package's bench.py, read from its source (the
    module seeds a jit cache and arms a timer when it runs)."""
    import re

    src = open(os.path.join(os.path.dirname(__file__), "..",
                            "bench.py")).read()
    return re.search(r'^METRIC = "([^"]+)"', src, re.M)[1]


@pytest.mark.parametrize("phase", ["_parity_check", "_default_frame_ms"])
def test_bench_failure_prints_the_zero_line_and_exits_non_zero(capsys, phase):
    def boom(*args, **kw):
        raise RuntimeError(f"{phase} broke")

    with mock.patch.object(tbench, phase, boom):
        rc, rec = _bench_line(capsys,
                              ["2", "--device", "cpu", "--scale", "0.05"])
    assert rc != 0
    assert rec["value"] == 0 and rec["metric"] == tbench.METRIC
    assert "RuntimeError" in rec["note"] and phase in rec["note"]
    assert "parity_vs_oracle" not in rec and "default_frame_ms" not in rec


def test_bench_timeout_is_a_failure(capsys):
    def slow(*args, **kw):
        import time
        time.sleep(5)

    with mock.patch.object(tbench, "_default_frame_ms", slow):
        rc, rec = _bench_line(capsys, ["2", "--device", "cpu", "--scale",
                                       "0.05", "--timeout", "1"])
    assert rc != 0 and rec["value"] == 0
    assert "TimeoutError" in rec["note"]


def test_bench_needs_cuda_unless_asked_for_the_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert tbench.main(["2"]) == 2
    assert capsys.readouterr().out == ""  # no line without a device
