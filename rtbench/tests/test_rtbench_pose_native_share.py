"""The reader of the native pose's share (`pose.native_share`): the
program's counter `pose_native` over its zone `pose`'s count, in %, on a
filled store, on an engine's store after real frames on the CPU, and None
where there is nothing to read: no pose, no counter, a program that keeps
no store."""

from __future__ import annotations

import pytest

from rtbench import devtrace, spec
from rtbench.tests.test_rtbench_program_spans import FILLED, _read, store  # noqa: F401

# the counter over the zone `pose`'s count (4 in FILLED), in %
NATIVE_SHARE = [
    ({"host_waits": 2, "pose_native": 4}, 100.0),
    ({"pose_native": 3}, 75.0),
    ({"pose_native": 0}, 0.0),
    ({"host_waits": 2}, None),  # a program without the routine
]


def test_native_share_is_in_the_benchmark():
    named = {m.name: m for m in spec.metrics(spec.load(), "per_layer")}
    assert named["pose.native_share"].source == "program_counter"
    assert named["pose.native_share"].moves == "frame_ms"


@pytest.mark.parametrize("counters,want", NATIVE_SHARE)
def test_native_share_reads_the_store(store, counters, want):  # noqa: F811
    store.update({k: dict(v) for k, v in FILLED.items()})
    store["counters"] = counters
    assert _read("pose.native_share") == (
        None if want is None else pytest.approx(want))


def test_native_share_finds_nothing_without_a_pose_or_a_store(
        store, monkeypatch):  # noqa: F811
    from zig_vulkan_tpu_torch.utils import profiling

    store.update(zones={"draw": FILLED["zones"]["draw"]},
                 counters={"pose_native": 0}, device={})
    assert _read("pose.native_share") is None
    monkeypatch.delattr(profiling, "snapshot")
    assert _read("pose.native_share") is None


def test_native_share_on_an_engine_store():
    """A small CPU engine's frames, each posed, as the harness reads them:
    every pose through the routine where g++ built it, none where not."""
    from zig_vulkan_tpu_torch import config as pc
    from zig_vulkan_tpu_torch.core import pose_host
    from zig_vulkan_tpu_torch.engine.engine import VoxelRT
    from zig_vulkan_tpu_torch.models import scenes
    from zig_vulkan_tpu_torch.utils import profiling

    sc = scenes.flat_test_scene(dim=8)
    rt = VoxelRT(sc.grid, sc.materials, pc.EngineConfig(
        internal_resolution_width=16, internal_resolution_height=16,
        camera=pc.CameraConfig(samples_per_pixel=1, max_bounce=1),
        sun=pc.SunConfig(enabled=False),
        denoiser=pc.DenoiserConfig(enabled=False)), device="cpu")
    rt.draw()
    profiling.enable(False)
    profiling.enable(True)
    try:
        for k in range(3):
            rt.camera.turn_yaw(0.1 * k)
            rt.draw()
    finally:
        profiling.enable(False)
    got = devtrace.per_layer(
        None, {"pose.native_share": spec.reader("pose.native_share")})
    want = 100.0 if pose_host.routine() is not None else 0.0
    assert got == {"pose.native_share": pytest.approx(want)}
