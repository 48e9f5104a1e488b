"""The engine on a mesh of cards (`EngineConfig(cards=n)`), on the CPU.

`VoxelRT` with 2 and 4 shards against the one-card engine and the plain
reference (`rtbench.ref.engine.RefEngine`) bit for bit, at a small size
(`rtbench.tests.small`: the reference app's world cut to 32x16x32 bricks,
64x36 frames, 2 spp, three levels, the sun and the denoiser on), over a key
change, an insert and a removal. A CPU tensor's device is `cpu` whatever
index it was made with, so a mesh of `cpu` and `cpu:0` (made by patching
`engine.mesh_devices`, as a test may) has two replicas, the second an
engine of one card: the edits' route to every replica, the halo copies
between "cards" and the assembly's copies run here too. The `cuda` tests
need two and four cards (`--noconftest`, `-m cuda`). Imports nothing of
JAX.

    python -m pytest tests/test_torch_engine_mesh.py -q
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from rtbench import check, scene, traffic
from rtbench import run as harness
from rtbench.ref.core.grid import dense_materials
from rtbench.tests.small import small_cell
from zig_vulkan_tpu_torch.engine import engine as engine_mod
from zig_vulkan_tpu_torch.engine.controls import ControlPanel
from zig_vulkan_tpu_torch.engine.engine import VoxelRT
from zig_vulkan_tpu_torch.io.scene_io import load_scene
from zig_vulkan_tpu_torch.parallel import mesh as pmesh
from zig_vulkan_tpu_torch.utils import profiling

CPU = torch.device("cpu")
SEED = 2**32 + 25
# two replicas on the CPU: `cpu` and `cpu:0` are distinct mesh devices
SPLITS = {2: ["cpu", "cpu:0"], 4: ["cpu", "cpu", "cpu:0", "cpu:0"]}


@pytest.fixture(scope="module")
def cell():
    return small_cell("default_flythrough")


@pytest.fixture(scope="module")
def world(cell):
    path = scene.cached(cell.config["scene"])
    grid, _ = scene.load_reference(path)
    tables = traffic.build(cell.traffic, cell.config["engine"], SEED,
                           grid.static, grid.arrays)
    return path, tables


def _engine(cell, path, cards, device=CPU):
    grid, materials = load_scene(str(path))
    conf = dataclasses.replace(
        harness.engine_config(cell.config["engine"]), cards=cards)
    return VoxelRT(grid, materials, conf, device=device)


def _wall(static):
    """An insert in view of the path's poses: a 2-voxel-thick wall across
    the world's middle (materials 1-4), and its upper half, which a
    removal takes."""
    vx, vy, vz = static.voxel_dims
    x, y, z = np.meshgrid(np.arange(0, vx, 2), np.arange(vy // 4, vy - 4),
                          np.arange(vz // 2, vz // 2 + 2), indexing="ij")
    xyz = np.stack([x.ravel(), y.ravel(), z.ravel()], -1).astype(np.int32)
    mats = (1 + np.arange(len(xyz)) % 4).astype(np.uint8)
    return xyz, mats, xyz[xyz[:, 1] >= np.median(xyz[:, 1])]


def _session(rt, ref, tables, pose=2):
    """The frames of one session, each `(name, image, reference image)`:
    a frame, a key change (spp 1), an insert, a removal, back to spp 2."""
    prog = harness.Program(rt)
    ui = ControlPanel(rt)
    fr = tables.frame(pose)
    xyz, mats, gone = _wall(rt.grid_static)
    moves = [
        ("first", lambda: None, lambda e: None),
        ("spp 1", lambda: ui.set_samples_per_pixel(1),
         lambda e: e["camera"].update(samples_per_pixel=1)),
        ("insert", lambda: rt.insert_voxels(xyz, mats),
         lambda e: ref.insert(xyz, mats)),
        ("remove", lambda: rt.remove_voxels(gone),
         lambda e: ref.remove(gone)),
        ("spp 2", lambda: ui.set_samples_per_pixel(2),
         lambda e: e["camera"].update(samples_per_pixel=2)),
    ]
    out = []
    for name, program_move, reference_move in moves:
        program_move()
        if ref is not None:
            engine = {k: dict(v) if isinstance(v, dict) else v
                      for k, v in ref.engine.items()}
            reference_move(engine)
            ref.engine = engine
        prog.pose(fr)
        image = rt.draw()
        out.append((name, image, None if ref is None else ref.image(fr)))
    return out


@pytest.fixture(scope="module")
def one_card(cell, world):
    """The one-card engine's session and the reference's."""
    path, tables = world
    rt = _engine(cell, path, 1)
    ref = harness.reference_engine(cell, path, CPU)
    return _session(rt, ref, tables), ref


def _same_bits(a, b) -> bool:
    """Whether two tensors hold the same bytes (NaN included)."""
    return torch.equal(a.reshape(-1).view(torch.uint8),
                       b.reshape(-1).view(torch.uint8))


def _split(monkeypatch, cards):
    monkeypatch.setattr(engine_mod, "mesh_devices",
                        lambda device, n: SPLITS[n])


@pytest.mark.parametrize("cards", [2, 4])
def test_mesh_engine_is_the_one_card_engine_and_the_reference(
        monkeypatch, cell, world, one_card, cards):
    """Every frame of the session, on `cards` shards over two replicas,
    equals the one-card engine's and the plain reference's bit for bit;
    the edits change the frame and the replicas stay equal."""
    _split(monkeypatch, cards)
    path, tables = world
    rt = _engine(cell, path, cards)
    assert rt.mesh.size == cards and len(rt._mirrors) == 1
    frames, _ = one_card
    got = _session(rt, None, tables)
    for (name, image, _), (_, want, ref_image) in zip(got, frames):
        assert image.shape == (36, 64, 3), name
        assert torch.equal(image, want), name
        assert check.frame_gaps(image, ref_image) == (0.0, 0.0), name
    assert not torch.equal(got[1][1], got[2][1])  # the insert is in view
    assert not torch.equal(got[2][1], got[3][1])  # so is the removal
    mirror = rt._mirrors[0]
    assert torch.equal(dense_materials(rt.grid_static, rt.arrays),
                       dense_materials(mirror.grid_static, mirror.arrays))
    for f in dataclasses.fields(rt.arrays):
        assert _same_bits(getattr(rt.arrays, f.name),
                          getattr(mirror.arrays, f.name)), f.name
    assert torch.equal(rt._tables, mirror._tables)
    # one step a key, each a sharded step
    assert len(rt._step_cache) == 2
    assert all(isinstance(s, pmesh.ShardedStep)
               for s in rt._step_cache.values())


def test_both_routes_on_a_mesh(monkeypatch, cell, world):
    """`render()` and `render_op_by_op()` give one frame, the same as the
    one-card engine's."""
    _split(monkeypatch, 4)
    path, tables = world
    rt, one = _engine(cell, path, 4), _engine(cell, path, 1)
    for e in (rt, one):
        harness.Program(e).pose(tables.frame(1))
    graphed, op_by_op = engine_mod.both_routes(rt)
    assert torch.equal(graphed, op_by_op)
    assert torch.equal(graphed, one.render())


@pytest.mark.parametrize("cards", [2, 4])
def test_mesh_frame_spans_and_counters(monkeypatch, cell, world, cards):
    """A traced frame on a mesh: the zone `mesh_dispatch` inside
    `render_step`, `mesh_shards`, the halo rows copied between the two
    replicas' devices and the band bytes the assembly copies onto the
    first. The card's marks are no-ops on the CPU."""
    _split(monkeypatch, cards)
    path, tables = world
    rt = _engine(cell, path, cards)
    prog = harness.Program(rt)
    prog.pose(tables.frame(0))
    rt.draw()
    was = profiling.enabled()
    profiling.enable(False)
    profiling.enable(True)
    try:
        for g in range(3):
            prog.step(tables.frame(g))
    finally:
        profiling.enable(was)
    snap = profiling.snapshot()
    zones, counters = snap["zones"], snap["counters"]
    assert zones["mesh_dispatch"]["count"] == 3
    assert zones["render_step"]["total_ms"] >= zones["mesh_dispatch"][
        "total_ms"]
    assert counters["mesh_shards"] == 3 * cards
    step = rt.step()
    plan = step.plan
    # the bands of the shards on `cpu:0`, 12 bytes a pixel
    assert step.assembled_bytes == 36 * 64 * 12 // 2
    assert counters["mesh_assembled_bytes"] == 3 * step.assembled_bytes
    # the halo rows copied: a CPU tensor's device is `cpu`, so every
    # neighbour's rows a shard on `cpu:0` reads are copied into its slab
    halo = sum(b - a for i, dev in enumerate(rt.mesh.devices)
               if dev == torch.device("cpu", 0)
               for j, a, b in plan.sources(i) if j != i)
    assert halo > 0
    assert counters["mesh_halo_bytes"] == 3 * halo * 64 * 12
    assert snap["device"] == {}


def _traced(fn):
    """The profiling store of `fn()`, run with a new recording."""
    was = profiling.enabled()
    profiling.enable(False)
    profiling.enable(True)
    try:
        fn()
    finally:
        profiling.enable(was)
    return profiling.snapshot()


KERNEL_COUNTERS = ("trace_launches", "trace_queued", "shade_launches",
                   "shade_queued")


@pytest.mark.parametrize("cards", [2, 4])
def test_mesh_frame_counts_each_shards_kernel_launches(monkeypatch, cell,
                                                       world, cards):
    """Each shard traces its band through the one-card frame's levels, so a
    traced frame on the mesh counts `cards` times the one-card frame's
    kernel A and D launches and queued launches."""
    _split(monkeypatch, cards)
    path, tables = world
    counts = {}
    for n in (1, cards):
        rt = _engine(cell, path, n)
        prog = harness.Program(rt)
        prog.step(tables.frame(0))
        snap = _traced(lambda: [prog.step(tables.frame(g))
                                for g in range(1, 4)])
        counts[n] = {k: snap["counters"][k] for k in KERNEL_COUNTERS}
    assert all(counts[1][k] > 0 for k in KERNEL_COUNTERS)
    assert counts[cards] == {k: cards * v for k, v in counts[1].items()}


def test_mirror_edits_count_as_one_edit(monkeypatch, cell, world):
    """An insert and a removal on a mesh of two replicas record the zones
    and counters of one edit, as the one-card engine's do: the mirror's
    edit is untraced. The mirror's brick bound follows the engine's."""
    _split(monkeypatch, 2)
    path, tables = world
    xyz, mats, gone = _wall(_engine(cell, path, 1).grid_static)
    snaps = {}
    for n in (1, 2):
        rt = _engine(cell, path, n)
        prog = harness.Program(rt)
        prog.step(tables.frame(0))
        snaps[n] = _traced(lambda: (rt.insert_voxels(xyz, mats),
                                    rt.remove_voxels(gone)))
        if n == 2:
            assert rt._mirrors[0]._bricks_upper == rt._bricks_upper
    edit_zones = ("edit_insert", "edit_remove", "edit_guard",
                  "edit_upload", "edit_launch")
    for name in edit_zones:
        assert (snaps[2]["zones"][name]["count"]
                == snaps[1]["zones"][name]["count"]), name
    assert snaps[2]["counters"] == snaps[1]["counters"]
    assert snaps[2]["counters"]["edit_lanes"] == len(xyz) + len(gone)


def test_temporal_is_not_drawn_on_a_mesh(monkeypatch, cell, world):
    _split(monkeypatch, 2)
    rt = _engine(cell, world[0], 2)
    rt.set_temporal(False)
    with pytest.raises(ValueError, match="temporal"):
        rt.set_temporal(True)
    assert not rt.temporal_enabled


def test_mesh_devices():
    """Shard i on `cuda:i` from the engine's card; every shard on the CPU
    on the CPU; more cards than the machine has refused."""
    assert engine_mod.mesh_devices("cpu", 3) == [CPU] * 3
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n:
        assert engine_mod.mesh_devices("cuda:0", n) == [
            torch.device("cuda", i) for i in range(n)]
        with pytest.raises(ValueError, match="CUDA device"):
            engine_mod.mesh_devices("cuda:0", n + 1)


def test_one_card_engine_keeps_its_step(cell, world):
    """`cards` 1 builds no mesh and draws through `engine.step.Step`."""
    from zig_vulkan_tpu_torch.engine.step import Step

    rt = _engine(cell, world[0], 1)
    assert rt.mesh is None and rt._mirrors == ()
    harness.Program(rt).pose(world[1].frame(0))
    rt.draw()
    assert all(type(s) is Step for s in rt._step_cache.values())


# -- on the cards ----------------------------------------------------------------
def _cards(n):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices")


@pytest.mark.cuda
def test_replicas_equal_card_for_card_after_edits(cell, world):
    """Two cards: after an insert and a removal every replica's arrays and
    records equal the first card's, and the frame the one-card engine's."""
    _cards(2)
    path, tables = world
    rt = _engine(cell, path, 2, "cuda:0")
    one = _engine(cell, path, 1, "cuda:0")
    assert [str(d) for d in rt.mesh.devices] == ["cuda:0", "cuda:1"]
    got = _session(rt, None, tables)
    want = _session(one, None, tables)
    for (name, a, _), (_, b, _) in zip(got, want):
        assert a.device == torch.device("cuda", 0), name
        assert torch.equal(a, b), name
    mirror = rt._mirrors[0]
    assert mirror.arrays.statuses.device == torch.device("cuda", 1)
    for f in dataclasses.fields(rt.arrays):
        assert _same_bits(getattr(rt.arrays, f.name),
                          getattr(mirror.arrays, f.name).to("cuda:0")), \
            f.name
    assert torch.equal(rt._tables, mirror._tables.to("cuda:0"))


@pytest.mark.cuda
def test_four_card_frame_is_the_one_card_frame(cell, world):
    """Four cards, graphs replayed: the session's frames equal the one-card
    engine's bit for bit."""
    _cards(4)
    path, tables = world
    rt = _engine(cell, path, 4, "cuda:0")
    one = _engine(cell, path, 1, "cuda:0")
    assert len(rt.mesh.distinct) == 4
    for (name, a, _), (_, b, _) in zip(_session(rt, None, tables),
                                       _session(one, None, tables)):
        assert torch.equal(a, b), name
