"""The fly-through harness of zig_vulkan_tpu_torch against the JAX package's.

`engine/benchmark.py` is host-side numpy in both packages: for the same dt
sequence the camera path, the orientations and the report are identical.
"""

import numpy as np
import pytest
import torch

import zig_vulkan_tpu_torch.config as tconfig
from zig_vulkan_tpu.config import CameraConfig as RCameraConfig
from zig_vulkan_tpu.core.camera import Camera as RCamera
from zig_vulkan_tpu.engine import benchmark as rbench
from zig_vulkan_tpu.models import scenes as rscenes
from zig_vulkan_tpu_torch.core.camera import Camera
from zig_vulkan_tpu_torch.engine import benchmark as tbench
from zig_vulkan_tpu_torch.engine.engine import VoxelRT, device_name
from zig_vulkan_tpu_torch.models import scenes as tscenes

torch.set_num_threads(2)

# a fixed dt sequence: frame-like steps, a few long ones, past the end
_DTS = [0.016, 0.016, 0.5, 3.7, 0.033, 5.454, 0.0, 11.0, 2.5, 7.25, 9.0,
        13.0, 0.75, 30.0]


def test_path_tables_match_reference():
    assert tbench.PATH_POINTS == rbench.PATH_POINTS
    assert tbench.PATH_EULERS == rbench.PATH_EULERS
    assert tbench.BENCHMARK_DURATION == rbench.BENCHMARK_DURATION


@pytest.mark.parametrize("duration", [60.0, 7.5])
def test_camera_path_and_report_match_reference(duration):
    static = rscenes.flat_test_scene(dim=8).grid.static
    rcam = RCamera(75.0, 64, 36, RCameraConfig(origin=(1.0, 2.0, 3.0)))
    tcam = Camera(75.0, 64, 36, tconfig.CameraConfig(origin=(1.0, 2.0, 3.0)))
    ref = rbench.Benchmark(rcam, static, True, duration=duration)
    port = tbench.Benchmark(tcam, tscenes.flat_test_scene(dim=8).grid.static,
                            True, duration=duration)
    for i, dt in enumerate(_DTS):
        record = -1.0 if i == 0 else dt * 1.5
        assert port.update(dt, record_dt=record) == ref.update(
            dt, record_dt=record)
        for name in ("origin", "horizontal", "vertical",
                     "lower_left_corner"):
            np.testing.assert_array_equal(getattr(tcam.d_camera, name),
                                          getattr(rcam.d_camera, name),
                                          err_msg=name)
        np.testing.assert_array_equal(tcam.yaw, rcam.yaw)
        np.testing.assert_array_equal(tcam.pitch, rcam.pitch)
    assert tcam.user_input_disabled and rcam.user_input_disabled
    for field in ("min_delta_time", "max_delta_time", "delta_time_sum",
                  "delta_time_sum_samples", "voxel_dims"):
        assert getattr(port.report, field) == getattr(ref.report, field), field
    assert port.report.average() == ref.report.average()
    assert (port.report.format("card", tcam.d_camera, True)
            == ref.report.format("card", rcam.d_camera, True))


def test_run_benchmark_prints_the_report(capsys):
    sc = tscenes.flat_test_scene(dim=8)
    cfg = tconfig.EngineConfig(
        internal_resolution_width=24, internal_resolution_height=16,
        camera=tconfig.CameraConfig(samples_per_pixel=1, max_bounce=0),
        sun=tconfig.SunConfig(enabled=False),
        denoiser=tconfig.DenoiserConfig(enabled=False))
    rt = VoxelRT(sc.grid, sc.materials, cfg, device="cpu")
    bench = rt.run_benchmark(max_frames=4, fixed_dt=0.5)
    assert bench.timer == pytest.approx(3 * 0.5 + 1e-3)
    assert bench.report.delta_time_sum_samples == 3
    assert rt.metrics.summary()["frames"] == 4
    assert not rt.camera.user_input_disabled  # reset after the run
    out = capsys.readouterr().out
    assert "BENCHMARK REPORT" in out and "cpu (cpu)" in out
    assert "Frames                   : 3" in out
    assert "(x = 24, y = 16)" in out
    full = rt.run_benchmark(duration=2.0, fixed_dt=0.5, verbose=False)
    assert full.timer >= 2.0 and full.report.delta_time_sum_samples == 4


def test_device_name():
    assert device_name("cpu") == "cpu (cpu)"
