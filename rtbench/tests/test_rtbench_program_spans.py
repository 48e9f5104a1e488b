"""The per-layer readers of the program's own spans and counters
(`zig_vulkan_tpu_torch.utils.profiling.snapshot()`): each on a filled
store, on an engine's store after real frames and edits on the CPU, and
None where there is nothing to read: an empty store, a store with no frame,
a program that keeps no store."""

from __future__ import annotations

import numpy as np
import pytest

from rtbench import devtrace, spec

READERS = ("engine.host_ms", "pose.host_ms", "edit.host_ms",
           "edit.device_ms", "edit.field_ms", "engine.host_waits",
           "engine.captures")

# four frames of an edit cell, by hand
FILLED = {
    "zones": {
        "draw": {"count": 4, "total_ms": 10.0, "self_ms": 1.0},
        "device_sync": {"count": 4, "total_ms": 6.0, "self_ms": 6.0},
        "pose": {"count": 4, "total_ms": 0.8, "self_ms": 0.8},
        "edit_insert": {"count": 2, "total_ms": 2.5, "self_ms": 0.1},
        "edit_remove": {"count": 2, "total_ms": 1.5, "self_ms": 0.1},
        "capture": {"count": 1, "total_ms": 20.0, "self_ms": 20.0},
    },
    "counters": {"host_waits": 2, "edit_lanes": 2048,
                 "edit_padded": 4096},
    "device": {"edit_graph": {"count": 4, "total_ms": 2.4},
               "edit_field": {"count": 2, "total_ms": 1.6}},
}
WANT = {"engine.host_ms": 1.0, "pose.host_ms": 0.2, "edit.host_ms": 1.0,
        "edit.device_ms": 0.6, "edit.field_ms": 0.4,
        "engine.host_waits": 0.5, "engine.captures": 1}


@pytest.fixture
def store(monkeypatch):
    """The program's snapshot() returning what the test puts in `held`."""
    from zig_vulkan_tpu_torch.utils import profiling

    held = {}
    monkeypatch.setattr(profiling, "snapshot", lambda: held)
    return held


def _read(name):
    return spec.reader(name).read(None)


def test_each_reader_is_in_the_benchmark():
    bench = spec.load()
    named = {m.name: m for m in spec.metrics(bench, "per_layer")}
    for name in READERS:
        assert named[name].source in ("program_span", "program_counter")


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_filled_store(store, name):
    store.update(FILLED)
    assert _read(name) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_in_an_empty_store(store, name):
    store.update(zones={}, counters={}, device={})
    assert _read(name) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_without_a_frame(store, name):
    store.update({k: dict(v) for k, v in FILLED.items()})
    del store["zones"]["draw"]
    assert _read(name) is None


def test_counts_read_zero_and_spans_none_in_a_cell_without_them(store):
    store.update(zones={"draw": FILLED["zones"]["draw"]}, counters={},
                 device={})
    got = {name: _read(name) for name in READERS}
    assert got["engine.host_waits"] == 0 and got["engine.captures"] == 0
    assert got["engine.host_ms"] == pytest.approx(2.5)
    for name in ("pose.host_ms", "edit.host_ms", "edit.device_ms",
                 "edit.field_ms"):
        assert got[name] is None, name


@pytest.mark.parametrize("name", READERS)
def test_reader_of_a_program_without_a_store(monkeypatch, name):
    """An older program, whose profiling keeps no store, has no
    snapshot(): nothing to read, and nothing raises."""
    from zig_vulkan_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "snapshot")
    assert _read(name) is None


def test_store_of_a_program_without_one(monkeypatch):
    """The readers' one way to the store: None where the program has no
    snapshot(), the store's frames where it drew some."""
    from rtbench import program_store
    from zig_vulkan_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "snapshot", lambda: FILLED)
    assert program_store.store().frames == 4
    assert program_store.per_frame(lambda s: s.zone_ms("nothing")) is None
    assert program_store.per_frame(lambda s: s.counter("nothing")) == 0
    monkeypatch.delattr(profiling, "snapshot")
    assert program_store.store() is None
    assert program_store.per_frame(lambda s: 1.0) is None


def test_readers_on_an_engine_store():
    """A small CPU engine, two frames with an edit and a pose each, read
    through devtrace.per_layer as the harness reads them: the host spans
    and counts; no device spans off the card."""
    from zig_vulkan_tpu_torch import config as pc
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
    xyz = np.array([[1, 5, 1], [2, 5, 1]])
    profiling.enable(False)
    profiling.enable(True)
    try:
        for edit in (lambda: rt.insert_voxels(xyz, [3, 4]),
                     lambda: rt.remove_voxels(xyz)):
            edit()
            rt.camera.turn_yaw(0.1)
            rt.draw()
    finally:
        profiling.enable(False)
    readers = {name: spec.reader(name) for name in READERS}
    got = devtrace.per_layer(None, readers)
    assert set(got) == {"engine.host_ms", "pose.host_ms", "edit.host_ms",
                        "engine.host_waits", "engine.captures"}
    assert got["engine.host_waits"] == 0 and got["engine.captures"] == 0
    for name in ("engine.host_ms", "pose.host_ms", "edit.host_ms"):
        assert got[name] > 0, name
