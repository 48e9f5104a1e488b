"""The benchmark cell `pathtraced_4k_4cards` (the reference app's path-traced,
denoised frame of BASELINE config 5's streamed world, its rows split over
four cards) at a size the CPU runs (`rtbench.tests.small.small_cell`: a
32x16x32-brick world and 64x36 frames, every shard on the CPU): the
configuration against the two it is made of, the reference `plain_banded`
against `plain`, the cell's eight readers on planted stores, the control and
the whole harness run. Imports nothing of JAX.

    python -m pytest tests/test_rtbench_pathtraced_4k_4cards.py -q
"""

from __future__ import annotations

import pytest
import torch

from rtbench import check, control, program_store, scene, spec, traffic
from rtbench import run as harness
from rtbench.tests.small import small_cell

CELL = "pathtraced_4k_4cards"
CPU = torch.device("cpu")
SEED = 2**33 + 25
READERS = ("mesh.host_ms", "mesh.balance_share", "mesh.assemble_ms",
           "assemble_roofline", "mesh.frame_device_ms", "mesh.lead_ms",
           "mesh.halo_wait_ms", "mesh.straggler_ms")
LAYER = ("engine on a mesh (engine.py VoxelRT.draw, parallel/mesh.py "
         "ShardedStep)")
RESOLUTION = ("internal_resolution_width", "internal_resolution_height",
              "output_resolution_width", "output_resolution_height")


@pytest.fixture(scope="module")
def cell():
    return small_cell(CELL)


@pytest.fixture(scope="module")
def world(cell):
    path = scene.cached(cell.config["scene"])
    grid, _ = scene.load_reference(path)
    tables = traffic.build(cell.traffic, cell.config["engine"], SEED,
                           grid.static, grid.arrays)
    return path, tables


# -- the configuration -----------------------------------------------------------
def test_configuration_is_stream_4k_world_at_the_apps_settings():
    """The scene is `streamed_4k`'s key for key (so the scene file is
    shared); the engine is `default_workload`'s at 3840x2160 on four
    cards; nothing is reduced."""
    bench = spec.load()
    conf = spec.cell(bench, CELL).config
    world = spec.cell(bench, "stream_4k").config
    app = spec.cell(bench, "default_flythrough").config
    assert conf["scene"] == world["scene"]
    assert scene.cache_path(conf["scene"]) == scene.cache_path(world["scene"])
    engine = dict(conf["engine"])
    assert engine.pop("cards") == 4
    for key in RESOLUTION:
        assert engine.pop(key) == (3840 if "width" in key else 2160)
    assert engine == {k: v for k, v in app["engine"].items()
                      if k not in RESOLUTION}
    assert conf["reduced"] == [] and conf["reference"] == "plain_banded"
    entry = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert (entry["chips"], entry["traffic"]) == (4, "flythrough")
    assert harness.engine_config(conf["engine"]).cards == 4


# -- the reference -----------------------------------------------------------------
@pytest.mark.parametrize("block", [9, 7, 540])
def test_plain_banded_is_plain(monkeypatch, cell, world, block):
    """Blocks of 9 rows (four bands), 7 (a ragged last block) and 540 (one
    block at this size): the traced and the presented image equal `plain`'s
    bit for bit."""
    path, tables = world
    banded = spec.plugin("references", "plain_banded")
    monkeypatch.setattr(banded, "BLOCK_ROWS", block)
    ref = harness.reference_engine(cell, path, CPU)
    assert isinstance(ref, banded.Engine)
    plain = spec.plugin("references", "plain").Engine(
        *scene.load_reference(path), cell.config["engine"], CPU)
    fr = tables.frame(2)
    got = ref.traced(fr.origin, fr.yaw, fr.sun_position, fr.sun_color)
    want = plain.traced(fr.origin, fr.yaw, fr.sun_position, fr.sun_color)
    assert got.shape == (36, 64, 3) and torch.equal(got, want)
    assert torch.equal(ref.image(fr), plain.image(fr))
    assert float(got.std()) > 0.01


# -- the readers -------------------------------------------------------------------
def _store(monkeypatch, zones=None, counters=None, device=None, frames=10):
    snap = {"zones": {"draw": {"count": frames, "total_ms": 1.0,
                               "self_ms": 1.0}, **(zones or {})},
            "counters": counters or {}, "device": device or {}}
    monkeypatch.setattr(program_store, "store",
                        lambda: program_store.Store(snap))


def _read(name):
    return spec.reader(name).read(None)


def test_readers_on_a_planted_store(monkeypatch):
    """Ten frames: 5 ms of `mesh_dispatch`; the four shards' card ms 10,
    20, 30, 40; 3 ms of assembly carrying the full cell's 74,649,600 bytes a
    frame (0.156130 ms at 478.125 GB/s, 18 links of 26.5625 GB/s); the
    shards' leads 1, 4, 7, 10 ms and halo waits 2, 5, 3, 1 ms (the
    largest of each on another shard) and 17 ms of straggler wait."""
    per_frame = 3 * 540 * 3840 * 12
    leads, waits = (1.0, 4.0, 7.0, 10.0), (2.0, 5.0, 3.0, 1.0)
    _store(monkeypatch,
           zones={"mesh_dispatch": {"count": 10, "total_ms": 5.0,
                                    "self_ms": 5.0}},
           counters={"mesh_assembled_bytes": 10 * per_frame},
           device={**{f"mesh_shard.{i}": {"count": 20,
                                          "total_ms": 10.0 * (i + 1)}
                      for i in range(4)},
                   **{f"mesh_lead.{i}": {"count": 10, "total_ms": ms}
                      for i, ms in enumerate(leads)},
                   **{f"mesh_halo_wait.{i}": {"count": 10, "total_ms": ms}
                      for i, ms in enumerate(waits)},
                   "mesh_straggler": {"count": 10, "total_ms": 17.0},
                   "mesh_assemble": {"count": 10, "total_ms": 3.0}})
    assert _read("mesh.lead_ms") == pytest.approx(1.0)
    assert _read("mesh.halo_wait_ms") == pytest.approx(0.5)
    assert _read("mesh.straggler_ms") == pytest.approx(1.7)
    assert _read("mesh.host_ms") == pytest.approx(0.5)
    assert _read("mesh.balance_share") == pytest.approx(62.5)
    assert _read("mesh.assemble_ms") == pytest.approx(0.3)
    bound = spec.reader("assemble_roofline").assemble_bound_ms(per_frame)
    assert per_frame == 74_649_600
    assert bound == pytest.approx(0.15612988235, rel=1e-9)
    assert _read("assemble_roofline") == pytest.approx(100 * bound / 0.3)


def test_frame_device_ms_on_a_planted_store(monkeypatch):
    """Ten frames of 62 card ms between the `mesh_frame` marks read 6.2 ms
    a frame; a store with the mesh's other marks and no `mesh_frame` (a
    program that marks no frame) reads nothing."""
    shards = {f"mesh_shard.{i}": {"count": 20, "total_ms": 40.0}
              for i in range(4)}
    _store(monkeypatch, device={**shards,
                                "mesh_assemble": {"count": 10,
                                                  "total_ms": 3.0},
                                "mesh_frame": {"count": 10,
                                               "total_ms": 62.0}})
    assert _read("mesh.frame_device_ms") == pytest.approx(6.2)
    _store(monkeypatch, device={**shards, "mesh_assemble": {
        "count": 10, "total_ms": 3.0}})
    assert _read("mesh.frame_device_ms") is None
    assert _read("mesh.assemble_ms") == pytest.approx(0.3)


def test_the_first_cards_spans_on_a_planted_store(monkeypatch):
    """Eight frames on two shards, as the first card's spans tile its
    frame: lead 0.3, shard 4.0 (trace and post-process), halo wait 0.2,
    straggler 1.1 and assembly 0.3 ms a frame make the 5.9 ms of
    `mesh_frame`; shard 1 waits longer for its start (0.5) and less for
    its halo (0.1). A store without the halo waits (no post-process) still
    reads the leads and the straggler wait."""
    frame = {"mesh_lead.0": 0.3, "mesh_shard.0": 4.0,
             "mesh_halo_wait.0": 0.2, "mesh_straggler": 1.1,
             "mesh_assemble": 0.3}
    device = {name: {"count": 8, "total_ms": 8 * ms}
              for name, ms in frame.items()}
    device.update({"mesh_lead.1": {"count": 8, "total_ms": 8 * 0.5},
                   "mesh_halo_wait.1": {"count": 8, "total_ms": 8 * 0.1},
                   "mesh_frame": {"count": 8,
                                  "total_ms": 8 * sum(frame.values())}})
    _store(monkeypatch, device=device, frames=8)
    assert _read("mesh.lead_ms") == pytest.approx(0.5)
    assert _read("mesh.halo_wait_ms") == pytest.approx(0.2)
    assert _read("mesh.straggler_ms") == pytest.approx(1.1)
    assert _read("mesh.frame_device_ms") == pytest.approx(5.9)
    assert _read("mesh.assemble_ms") == pytest.approx(0.3)
    no_halo = {n: v for n, v in device.items()
               if not n.startswith("mesh_halo_wait.")}
    _store(monkeypatch, device=no_halo, frames=8)
    assert _read("mesh.halo_wait_ms") is None
    assert _read("mesh.lead_ms") == pytest.approx(0.5)
    assert _read("mesh.straggler_ms") == pytest.approx(1.1)


@pytest.mark.parametrize("ms_over_bound", [1.0, 1.5, 40.0])
def test_assemble_roofline_at_or_under_100(monkeypatch, ms_over_bound):
    """Where the assembly takes its bound or longer, the share reads 100%
    or less; even bands read 100% balance."""
    reader = spec.reader("assemble_roofline")
    nbytes = 10 * 74_649_600
    ms = reader.assemble_bound_ms(nbytes) * ms_over_bound
    _store(monkeypatch, counters={"mesh_assembled_bytes": nbytes},
           device={"mesh_assemble": {"count": 10, "total_ms": ms},
                   "mesh_shard.0": {"count": 20, "total_ms": 7.0},
                   "mesh_shard.1": {"count": 20, "total_ms": 7.0}})
    share = _read("assemble_roofline")
    assert 0 < share <= 100.0
    assert share == pytest.approx(100.0 / ms_over_bound)
    assert _read("mesh.balance_share") == pytest.approx(100.0)


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_without_the_mesh(monkeypatch, name):
    """A store of one card (no mesh zone, marks or counters) and no store
    at all: nothing to read, nothing raised."""
    _store(monkeypatch, zones={"render_step": {"count": 10,
                                               "total_ms": 2.0,
                                               "self_ms": 2.0}},
           device={"temporal": {"count": 10, "total_ms": 1.0}})
    assert _read(name) is None
    monkeypatch.setattr(program_store, "store", lambda: None)
    assert _read(name) is None


def test_readers_are_the_benchmarks():
    bench = spec.load()
    named = {m.name: m for m in spec.metrics(bench, "per_layer")}
    for name in READERS:
        m, module = named[name], spec.reader(name)
        assert m.workloads == [CELL] == module.WORKLOADS
        assert m.layer == LAYER == module.LAYER
        assert (m.moves, m.source) == ("frame_ms", "program_span")
        assert (module.NAME, module.UNIT) == (m.name, m.unit)
    assert set(spec.readers(bench, CELL)) == set(READERS)


# -- the control and the whole harness ---------------------------------------------
def test_control_is_not_correct(cell):
    out = control.readings(cell, 78, CPU, "bfloat16")
    assert not out["correct"]
    assert len(out["gaps"]) == 3


def test_harness_run_is_correct(cell):
    """A whole run of the harness on the CPU, the engine on four shards:
    three frames checked bit for bit, the scene exact (the window long
    enough for a loop of the small path's six poses)."""
    out = harness.run(cell, SEED, 5.0, False, CPU)
    assert out["correct"], out["check"]
    numbers = out["check"]
    assert numbers["frames_checked"]["value"] == 3
    assert numbers["max_abs_diff"]["value"] == 0.0
    assert numbers["share_off_pct"]["value"] == 0.0
    assert numbers["scene_voxels_wrong"]["value"] == 0
    assert check.verdict([(0.0, 0.0)], 0)["correct"]
