"""The port's tracing store (`zig_vulkan_tpu_torch.utils.profiling`): zones
with their counts, totals and self times, counters, host waits and device
marks kept in memory while tracing is on, and the spans the engine, the
camera and the edits record.

This file imports no JAX: its one test marked `cuda` (a replayed insert
graph's device spans) also runs on a machine with a GPU and no JAX, with
`python -m pytest --noconftest tests/test_torch_profiling.py`.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from zig_vulkan_tpu_torch import config as tconfig
from zig_vulkan_tpu_torch.core.camera import Camera
from zig_vulkan_tpu_torch.engine.engine import VoxelRT
from zig_vulkan_tpu_torch.models import scenes as tscenes
from zig_vulkan_tpu_torch.utils import profiling

FRAME_ZONES = {"draw", "step_lookup", "push_constants", "render_step",
               "device_sync"}


@pytest.fixture
def tracing():
    """Tracing on for the test (a new recording), off after it."""
    profiling.enable(False)
    profiling.enable(True)
    try:
        yield
    finally:
        profiling.enable(False)


class Clock:
    """A `perf_counter` that moves only when told to."""

    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(profiling.time, "perf_counter", c)
    return c


def _engine(device="cpu"):
    sc = tscenes.flat_test_scene(dim=8)
    cfg = tconfig.EngineConfig(
        internal_resolution_width=16, internal_resolution_height=16,
        camera=tconfig.CameraConfig(origin=(4.0, 6.5, 15.0),
                                    samples_per_pixel=1, max_bounce=1),
        sun=tconfig.SunConfig(enabled=False),
        denoiser=tconfig.DenoiserConfig(enabled=False))
    return VoxelRT(sc.grid, sc.materials, cfg, device=device)


def test_enable_starts_an_empty_recording_and_off_keeps_it():
    profiling.enable(False)
    profiling.enable(True)
    try:
        with profiling.zone("a"):
            pass
        profiling.count("c", 2)
        profiling.enable(True)  # on while on: the same recording
        assert profiling.snapshot()["zones"]["a"]["count"] == 1
    finally:
        profiling.enable(False)
    kept = profiling.snapshot()
    assert kept["zones"]["a"]["count"] == 1 and kept["counters"] == {"c": 2}
    profiling.enable(True)
    try:
        assert profiling.snapshot() == {"zones": {}, "counters": {},
                                        "device": {}}
    finally:
        profiling.enable(False)


def test_nothing_is_recorded_while_off(tracing):
    profiling.enable(False)
    before = profiling.snapshot()
    with profiling.zone("a"), profiling.wait("w"):
        pass
    profiling.count("c")
    profiling.device_mark("m", "cpu")
    assert profiling.zone("a") is profiling.zone("b")  # one shared no-op
    assert profiling.snapshot() == before


def test_nesting_gives_counts_totals_and_self_times(tracing, clock):
    with profiling.zone("outer"):
        clock.now += 1.0
        for _ in range(2):
            with profiling.zone("inner"):
                clock.now += 2.0
                with profiling.zone("leaf"):
                    clock.now += 0.5
        clock.now += 0.25
    zones = profiling.snapshot()["zones"]
    assert zones["outer"] == pytest.approx(
        {"count": 1, "total_ms": 6250.0, "self_ms": 1250.0})
    assert zones["inner"] == pytest.approx(
        {"count": 2, "total_ms": 5000.0, "self_ms": 4000.0})
    assert zones["leaf"] == pytest.approx(
        {"count": 2, "total_ms": 1000.0, "self_ms": 1000.0})


def test_wait_is_a_zone_counted_under_host_waits(tracing, clock):
    with profiling.zone("edit_guard"):
        with profiling.wait("guard_statuses"):
            clock.now += 0.003
        with profiling.wait("guard_statuses"):
            clock.now += 0.001
    profiling.count("edit_lanes", 512)
    snap = profiling.snapshot()
    assert snap["counters"] == {"host_waits": 2, "edit_lanes": 512}
    assert snap["zones"]["guard_statuses"]["count"] == 2
    assert snap["zones"]["guard_statuses"]["total_ms"] == pytest.approx(4.0)
    assert snap["zones"]["edit_guard"]["self_ms"] == pytest.approx(0.0)


class FakeEvent:
    """A timing event the card has run (or not) at time `t` ms."""

    def __init__(self, t, done=True):
        self.t, self.done, self.waited = t, done, 0

    def query(self):
        return self.done

    def synchronize(self):
        self.waited += 1
        self.done = True

    def elapsed_time(self, end):
        return end.t - self.t


def test_store_stays_bounded(tracing):
    for _ in range(20_000):
        with profiling.zone("draw"):
            with profiling.zone("device_sync"):
                pass
        profiling.count("host_waits")
    pairs = [("edit_graph", FakeEvent(0.0), FakeEvent(0.5))]
    for _ in range(3 * profiling.MAX_PENDING):
        # pairs made outside a capture, each new: read once MAX_PENDING wait
        profiling._queue([("edit_field", FakeEvent(0.0), FakeEvent(0.25))])
        assert len(profiling._store.pending) <= profiling.MAX_PENDING
    profiling.snapshot()  # reads every pending pair
    for _ in range(1000):
        profiling.replaying(pairs)  # one graph's pairs: one pending at most
        assert len(profiling._store.pending) <= 1
    st = profiling._store
    assert set(st.zones) == {"draw", "device_sync"} and st.open == []
    assert st.counters == {"host_waits": 20_000}
    snap = profiling.snapshot()
    assert snap["zones"]["draw"]["count"] == 20_000
    assert snap["device"]["edit_graph"] == pytest.approx(
        {"count": 1000, "total_ms": 500.0})
    assert snap["device"]["edit_field"] == pytest.approx(
        {"count": 3 * profiling.MAX_PENDING,
         "total_ms": 0.25 * 3 * profiling.MAX_PENDING})


def test_a_replay_reads_the_last_replay_of_its_graph_first(tracing):
    """A graph's events are recorded anew by each replay: the pairs an
    earlier replay left are read before the graph replays again, waiting
    (a host wait) where the card has not run them."""
    begin, end = FakeEvent(0.0), FakeEvent(0.75, done=False)
    pairs = [("edit_graph", begin, end)]
    profiling.replaying(pairs)
    profiling.replaying(pairs)
    assert end.waited == 1
    snap = profiling.snapshot()
    assert snap["device"]["edit_graph"] == pytest.approx(
        {"count": 2, "total_ms": 1.5})
    assert snap["counters"] == {"host_waits": 1}
    assert snap["zones"]["device_marks"]["count"] == 1


def test_untraced_records_nothing_and_its_zone_covers_it(tracing, clock):
    """Inside `untraced()` no zone, wait, counter or mark is recorded, and a
    capture's marks stay empty (no card is touched); the zone open around
    it takes its time as its own; after it, recording goes on."""
    with profiling.zone("edit_insert"):
        clock.now += 1.0
        with profiling.capture_marks() as marks, profiling.untraced():
            with profiling.zone("edit_upload"), profiling.wait("w"):
                clock.now += 2.0
            profiling.count("edit_lanes", 5)
            profiling.device_mark("edit_graph", "cuda")
            profiling.device_mark("edit_graph", "cuda")
    profiling.count("edit_lanes", 3)
    assert marks == []
    snap = profiling.snapshot()
    assert set(snap["zones"]) == {"edit_insert"}
    assert snap["zones"]["edit_insert"] == pytest.approx(
        {"count": 1, "total_ms": 3000.0, "self_ms": 3000.0})
    assert snap["counters"] == {"edit_lanes": 3}
    assert snap["device"] == {}


def test_a_key_switch_and_a_return_to_a_kept_step(tracing):
    """A frame under another step than the frame before it counts a key
    switch; one whose step was kept counts a return besides."""
    from zig_vulkan_tpu_torch.engine.controls import ControlPanel

    rt = _engine()
    ui = ControlPanel(rt)
    rt.draw()  # the first frame: a switch from none, its step built
    ui.set_samples_per_pixel(2)
    rt.draw()  # a switch, built
    ui.set_samples_per_pixel(1)
    rt.draw()  # a switch, kept: a return
    rt.draw()  # no switch
    ui.set_samples_per_pixel(2)
    rt.draw()  # a return
    counters = profiling.snapshot()["counters"]
    assert (counters["key_switches"], counters["key_returns"]) == (4, 2)


def test_device_mark_is_a_no_op_on_the_cpu(tracing):
    profiling.device_mark("edit_graph", "cpu")
    profiling.device_mark("edit_graph", torch.device("cpu"))
    with profiling.capture_marks() as marks:
        profiling.device_mark("edit_field", "cpu")
        profiling.device_mark("edit_field", "cpu")
    assert marks == []
    assert profiling.snapshot()["device"] == {}
    assert profiling._store.pending == []


def test_a_draw_records_its_spans(tracing):
    rt = _engine()
    rt.draw()
    rt.draw()
    zones = profiling.snapshot()["zones"]
    assert FRAME_ZONES <= set(zones)
    assert {zones[n]["count"] for n in FRAME_ZONES} == {2}
    assert zones["build_tables"]["count"] == 1  # the first step_lookup
    draw = zones["draw"]
    children = sum(zones[n]["total_ms"] for n in FRAME_ZONES - {"draw"})
    assert draw["self_ms"] == pytest.approx(draw["total_ms"] - children)
    assert 0 <= draw["self_ms"] <= draw["total_ms"]
    assert zones["step_lookup"]["self_ms"] <= zones["step_lookup"][
        "total_ms"] - zones["build_tables"]["total_ms"] + 1e-9
    assert "capture" not in zones  # nothing is captured on the CPU


def test_the_pose_is_a_zone(tracing):
    cam = Camera(75.0, 16, 16, tconfig.CameraConfig())
    cam.propagate_pitch_change()
    cam.turn_yaw(0.1)
    assert profiling.snapshot()["zones"]["pose"]["count"] == 2


def test_edits_record_their_spans_lanes_and_padded_lanes(tracing):
    rt = _engine()
    rt.draw()
    ins = np.array([[1, 2, 1], [2, 2, 1], [3, 2, 2], [1, 3, 1], [2, 3, 5]])
    rt.insert_voxels(ins, np.full(len(ins), 3))
    rt.remove_voxels(ins[:3])
    rt.insert_voxels_op_by_op(ins[:1], [4])
    snap = profiling.snapshot()
    zones = snap["zones"]
    assert zones["edit_insert"]["count"] == 2
    assert zones["edit_remove"]["count"] == 1
    for child in ("edit_guard", "edit_upload", "edit_launch"):
        assert zones[child]["count"] == 3, child
    for name in ("edit_insert", "edit_remove"):
        assert zones[name]["self_ms"] <= zones[name]["total_ms"]
    assert snap["counters"]["edit_lanes"] == 5 + 3 + 1
    assert snap["counters"]["edit_padded"] == 3 * VoxelRT._EDIT_PAD
    # a rejected batch records its call and guard, and launches nothing
    with pytest.raises(IndexError):
        rt.remove_voxels([[-1, 0, 0]])
    zones = profiling.snapshot()["zones"]
    assert zones["edit_remove"]["count"] == 2
    assert zones["edit_guard"]["count"] == 4
    assert zones["edit_launch"]["count"] == 3


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("device marks time the card: they run only on a CUDA "
                    "device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_replayed_insert_graph_times_the_edit_and_its_field(card):
    """The insert graph's `edit_graph` and `edit_field` marks are nodes of
    the graph, captured with tracing off: each replay while tracing is on
    gives one span of each, the field inside the edit; tracing off, a
    replay queues nothing."""
    from zig_vulkan_tpu_torch.engine.step import GraphedCall

    rt = _engine(card)
    rt.draw()
    rng = np.random.default_rng(5)
    batches = [(rng.integers(4, 28, (512, 3)),
                rng.integers(1, 8, 512).astype(np.uint8)) for _ in range(3)]
    before = GraphedCall.captures
    rt.insert_voxels(*batches[0])  # the capture, tracing off
    assert GraphedCall.captures == before + 1
    rt.draw()
    profiling.enable(True)
    try:
        rt.insert_voxels(*batches[1])
        rt.draw()
        rt.insert_voxels(*batches[2])
        rt.draw()
    finally:
        profiling.enable(False)
    snap = profiling.snapshot()
    graph, field = snap["device"]["edit_graph"], snap["device"]["edit_field"]
    assert graph["count"] == field["count"] == 2
    assert 0 < field["total_ms"] < graph["total_ms"]
    assert snap["zones"]["draw"]["count"] == 2
    assert "capture" not in snap["zones"]
    # each graph's marks were read before its next replay, with no wait;
    # the only waits are the capacity guard's reads, where its bound trips
    assert "device_marks" not in snap["zones"]
    guard = sum(v["count"] for z, v in snap["zones"].items()
                if z.startswith("guard_"))
    assert snap["counters"].get("host_waits", 0) == guard
    rt.insert_voxels(*batches[1])  # tracing off: nothing more
    torch.cuda.synchronize()
    assert profiling.snapshot()["device"] == snap["device"]
