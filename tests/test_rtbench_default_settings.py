"""The benchmark cell `default_settings` (the reference app's fly-through with
a GUI setting moved every 30 frames, in the key tour's order) at a size the
CPU runs (`rtbench.tests.small.small_cell`, with a move every frame of a
5-pose path): the
generator `settings_flips` against `engine/key_tour.py`'s setting moves, key
for key on the program's engine, its period, warm-up and checked frames,
the control and the whole harness run. Imports nothing of JAX.

    python -m pytest tests/test_rtbench_default_settings.py -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rtbench import control, program_store, scene, spec, traffic
from rtbench import run as harness
from rtbench.tests.small import small_cell
from zig_vulkan_tpu_torch.engine.controls import ControlPanel
from zig_vulkan_tpu_torch.engine.engine import VoxelRT
from zig_vulkan_tpu_torch.engine.key_tour import key_tour
from zig_vulkan_tpu_torch.io.scene_io import load_scene
from zig_vulkan_tpu_torch.utils import profiling

CELL = "default_settings"
READER = "engine.key_return_share"
CPU = torch.device("cpu")
SEED = 2**35 + 7
LEFT_OUT = ("temporal", "flipped,", "flush_grid", "insert", "remove")


@pytest.fixture(scope="module")
def cell():
    c = small_cell(CELL)
    # a move every frame on a 5-pose path: a 20-frame period
    c.traffic.update(flip_frames=1, path_dt_s=12.0, sun_dt_s=12.0)
    return c


@pytest.fixture(scope="module")
def path(cell):
    return scene.cached(cell.config["scene"])


def _engine(cell, path):
    grid, materials = load_scene(str(path))
    rt = VoxelRT(grid, materials, harness.engine_config(cell.config["engine"]),
                 device=CPU)
    harness.engine_setters(rt, cell.config["engine"])
    return rt


def _generator():
    return spec.plugin("generators", "settings_flips")


def test_moves_are_the_key_tours_setting_moves(cell, path):
    """Each move, made on one engine through the generator's action and on
    another through the key tour's own move, leaves the two with the same
    step key, in the tour's order; the tour's temporal, edit and flush
    moves are left out."""
    a, b = _engine(cell, path), _engine(cell, path)
    tour = [(name, fn) for name, fn in key_tour(
        b, lambda rt: None, ((0, 0, 0), (8, 8, 8)))
        if not name.startswith(LEFT_OUT)]
    moves = _generator().moves(cell.config["engine"])
    assert [m.label for m in moves] == [name for name, _ in tour]
    assert len(moves) == 20
    keys = {a._step_key()}
    ui = ControlPanel(b)
    for move, (name, fn) in zip(moves, tour):
        move.program(a)
        fn(b, ui)
        assert a._step_key() == b._step_key(), name
        keys.add(a._step_key())
    assert a._step_key() == _engine(cell, path)._step_key()
    assert len(keys) == 9  # the configuration's own and eight others


def test_tables_of_the_full_cell():
    """A move every 30 frames, 600 frames a period (five loops of the
    120-pose path), one period of warm-up, three checked frames, one of
    them under settings other than the configuration's own."""
    c = spec.cell(spec.load(), CELL)
    assert c.config_name == "default_workload" and c.chips == 1
    gen = _generator()
    t = traffic.build(c.traffic, c.config["engine"], SEED)
    assert (t.period, t.warmup, t.poses) == (600, 600, 120)
    acting = [g for g in range(t.period) if t.frame(g).actions]
    assert acting == list(range(0, 600, 30))
    moves = gen.moves(c.config["engine"])
    assert [t.frame(g).actions[0] for g in acting] == moves
    assert len(t.checked) == 3
    # the move in force at each checked frame: one sets another value
    later = [moves[(w // 30) % 20] for w in t.checked]
    assert any(m.value != c.config["engine"][m.group][m.key]
               for m in later)
    seeds = {tuple(traffic.build(c.traffic, c.config["engine"], s).checked)
             for s in (1, 2, 3, 2**40 + 5)}
    assert len(seeds) > 1


def test_reference_reads_each_move(cell, path):
    """A move's reference side sets the key in a copy of `ref.engine`: the
    configuration the reference was given is left as it was."""
    ref = harness.reference_engine(cell, path, CPU)
    given = ref.engine
    for move in _generator().moves(cell.config["engine"])[:3]:
        move.reference(ref)
    assert ref.engine is not given
    assert ref.engine["sun"]["enabled"] is True
    assert ref.engine["camera"]["samples_per_pixel"] == 1
    assert given == cell.config["engine"]


def test_control_is_not_correct(cell):
    out = control.readings(cell, 79, CPU, "bfloat16")
    assert not out["correct"]
    assert len(out["gaps"]) == 3


def test_harness_run_is_correct(cell):
    """A whole run of the harness on the CPU with a move every frame: the
    checked frames, one under other settings, bit for bit (the window
    long enough for the 20-frame period)."""
    out = harness.run(cell, SEED, 8.0, False, CPU)
    assert out["correct"], out["check"]
    numbers = out["check"]
    assert numbers["frames_checked"]["value"] == 3
    assert numbers["max_abs_diff"]["value"] == 0.0
    assert numbers["share_off_pct"]["value"] == 0.0
    assert numbers["scene_voxels_wrong"]["value"] == 0
    assert np.isfinite(out["metrics"]["frame_ms"])


# -- the cell's reader ---------------------------------------------------------------
@pytest.mark.parametrize("counters,want", [
    ({"key_switches": 20, "key_returns": 20}, 100.0),
    ({"key_switches": 20, "key_returns": 15}, 75.0),
    ({"key_switches": 4, "key_returns": 0}, 0.0),
    ({"key_switches": 0, "key_returns": 0}, None),
    ({"key_switches": 20}, None),
    ({"trace_launches": 60, "trace_queued": 50}, None),
])
def test_key_return_share_on_a_planted_store(monkeypatch, counters, want):
    """The share of the key switches that returned to a kept step; nothing
    to read with no switch, no such counter or no store."""
    snap = {"zones": {"draw": {"count": 10, "total_ms": 1.0,
                               "self_ms": 1.0}},
            "counters": counters, "device": {}}
    monkeypatch.setattr(program_store, "store",
                        lambda: program_store.Store(snap))
    reader = spec.reader(READER)
    got = reader.read(None)
    assert got == pytest.approx(want) if want is not None else got is None
    monkeypatch.setattr(program_store, "store", lambda: None)
    assert reader.read(None) is None


def test_key_return_share_is_the_benchmarks():
    """The entry lists only this cell, in the engine's layer; it is the
    only per-layer metric the cell reports."""
    bench = spec.load()
    m = {m.name: m for m in spec.metrics(bench, "per_layer")}[READER]
    module = spec.reader(READER)
    assert m.workloads == [CELL] == module.WORKLOADS
    assert (m.unit, m.better, m.source, m.moves) == (
        "%", "higher", "program_counter", "frame_p99_ms")
    assert (module.NAME, module.UNIT, module.SOURCE, module.MOVES) == (
        m.name, m.unit, m.source, m.moves)
    engine_layer = {e.layer for e in spec.metrics(bench, "per_layer")
                    if e.name == "engine.host_ms"}
    assert {m.layer} == {module.LAYER} == engine_layer
    assert set(spec.readers(bench, CELL)) == {READER}


def test_after_a_period_of_warm_up_every_switch_returns(cell, path):
    """The small cell's traffic on the program: after one period of
    warm-up, the traced stretch switches key at every move, and every
    switch replays a kept step: the reader reads 100."""
    rt = _engine(cell, path)
    t = traffic.build(cell.traffic, cell.config["engine"], SEED)
    prog = harness.Program(rt)
    for g in range(t.warmup):
        prog.step(t.frame(g))
    profiling.enable(False)
    profiling.enable(True)
    try:
        for g in range(t.warmup, t.warmup + t.period):
            prog.step(t.frame(g))
    finally:
        profiling.enable(False)
    counters = profiling.snapshot()["counters"]
    # a move every frame: every frame but those whose move keeps the key
    assert 0 < counters["key_switches"] <= t.period
    assert counters["key_returns"] == counters["key_switches"]
    assert spec.reader(READER).read(None) == 100.0
