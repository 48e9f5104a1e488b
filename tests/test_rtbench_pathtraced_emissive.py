"""The benchmark cell `pathtraced_emissive_1080p` at a size the CPU runs
(`rtbench.tests.small.small_cell`: a 32x16x32-brick world, 64x36 frames;
the pose offsets follow the world's size): the scene generator
`emissive_block`, the traffic generator `pose_holds`, the plain reference
`references/temporal.py` against the program frame by frame across holds
and resets, two planted faults of the running mean, the control, the
program's temporal spans and counters and their readers, and the whole
harness run. Imports nothing of JAX.

    python -m pytest tests/test_rtbench_pathtraced_emissive.py -q

The `cuda` tests run the cell's small size and its traced full size on
the card (`--noconftest`)."""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import pytest
import torch

from rtbench import check, control, scene, spec, traffic
from rtbench import run as harness
from rtbench.ref.core.grid import dense_materials
from rtbench.ref.core.materials import MAT_EMISSIVE
from rtbench.tests.small import small_cell
from zig_vulkan_tpu_torch.engine.engine import VoxelRT
from zig_vulkan_tpu_torch.io.scene_io import load_scene
from zig_vulkan_tpu_torch.utils import profiling

CELL = "pathtraced_emissive_1080p"
CPU = torch.device("cpu")
SEED = 2**33 + 9
SEEDS = (0, 7, 2**31 + 5, 3_000_000_019)
HOLD = 8
FRAMES = 2 * HOLD + 1  # two whole holds and the first frame of a third
READERS = ("temporal.device_ms", "temporal_roofline", "temporal.reset_share")


@pytest.fixture(scope="module")
def cell():
    return small_cell(CELL)


@pytest.fixture(scope="module")
def world(cell):
    """(scene file, reference grid) of the small cell."""
    path = scene.cached(cell.config["scene"])
    grid, _ = scene.load_reference(path)
    return path, grid


@pytest.fixture(scope="module")
def tables(cell, world):
    _, grid = world
    return traffic.build(cell.traffic, cell.config["engine"], SEED,
                         grid.static, grid.arrays)


def _engine(cell, path):
    grid, materials = load_scene(str(path))
    rt = VoxelRT(grid, materials, harness.engine_config(cell.config["engine"]),
                 device=CPU)
    harness.engine_setters(rt, cell.config["engine"])
    return rt


def _program_frames(cell, path, tables, n=FRAMES):
    """The program's images of frames 0 .. n - 1 and its mean's count
    after each."""
    rt = _engine(cell, path)
    program = harness.Program(rt)
    images, counts = [], []
    for g in range(n):
        images.append(program.step(tables.frame(g)))
        counts.append(rt._accum_count)
    return images, counts


@pytest.fixture(scope="module")
def reference(cell, world, tables):
    """The reference's images of frames 0 .. FRAMES - 1 and its hold
    counts."""
    path, _ = world
    ref = harness.reference_engine(cell, path, CPU)
    images, counts = [], []
    for g in harness.reference_frames(ref, tables, range(FRAMES)):
        images.append(ref.image(tables.frame(g)))
        counts.append(ref.count)
    return images, counts


@pytest.fixture(scope="module")
def traced_program(cell, world, tables):
    """The program over FRAMES frames, tracing on for the first two holds,
    with every `profiling.device_mark` call recorded: (images, counts,
    snapshot, marks by name)."""
    path, _ = world
    marks = {}
    mark = profiling.device_mark

    def recording(name, device):
        marks[name] = marks.get(name, 0) + 1
        mark(name, device)

    mp = pytest.MonkeyPatch()
    mp.setattr(profiling, "device_mark", recording)
    rt = _engine(cell, path)
    program = harness.Program(rt)
    images, counts = [], []
    was = profiling.enabled()
    profiling.enable(False)
    profiling.enable(True)
    try:
        for g in range(FRAMES):
            if g == 2 * HOLD:
                profiling.enable(False)
            images.append(program.step(tables.frame(g)))
            counts.append(rt._accum_count)
    finally:
        profiling.enable(was)
        mp.undo()
    return images, counts, profiling.snapshot(), marks


# -- the scene -----------------------------------------------------------------
def test_scene_file_keeps_the_emissive_block(cell, world):
    """The scene file, read by the reference and by the program, holds
    material 40 as emissive at strength 8.0 and the block's 256 voxels of
    it."""
    path, grid = world
    block = spec.plugin("scenes", "emissive_block").block_voxels(grid.static)
    assert block.shape == (256, 3)
    em = cell.config["scene"]["emissive"]
    _, ref_mats = scene.load_reference(path)
    pg, pm = load_scene(str(path))
    for mats in (ref_mats, pm):
        assert int(mats.mtype[40]) == MAT_EMISSIVE
        assert float(mats.type_data[40]) == 8.0
        np.testing.assert_array_equal(
            mats.albedo[40], np.asarray(em["albedo"], np.float32))
    assert scene.occupied(grid.static, grid.arrays, block).all()
    dense = dense_materials(grid.static, grid.arrays).numpy()
    x, y, z = block.T
    assert (dense[x, y, z] == 40).all()
    assert (dense == 40).sum() == 256


def test_scene_generator_is_build_config4s(cell):
    """`emissive_block` against the port's own construction of config 4's
    world (`benchmarks/configs.py:build_config4`: the terrain without the
    model, the material set, the block inserted), at the small size."""
    from zig_vulkan_tpu_torch.core.materials import MAT_EMISSIVE as P_EM
    from zig_vulkan_tpu_torch.models import scenes as p_scenes

    full = spec.cell(spec.load(), CELL).config["scene"]
    conf = dict(cell.config["scene"], min_point=full["min_point"])
    grid, materials = scene.build(conf)
    want = p_scenes.default_scene(dims=tuple(conf["grid_dims"]),
                                  with_model=False)
    want.materials.set(40, P_EM, (1.0, 0.85, 0.4), 8.0)
    vx, vy, vz = want.grid.static.voxel_dims
    xs, ys, zs = np.meshgrid(np.arange(vx // 2 - 4, vx // 2 + 4),
                             np.arange(vy - 8, vy - 4),
                             np.arange(vz // 2 - 4, vz // 2 + 4),
                             indexing="ij")
    want.grid.insert_batch(xs.ravel(), ys.ravel(), zs.ravel(),
                           np.full(xs.size, 40, dtype=np.uint8))
    assert (dataclasses.astuple(grid.static)
            == dataclasses.astuple(want.grid.static))
    for f in dataclasses.fields(grid.arrays):
        np.testing.assert_array_equal(
            np.asarray(getattr(grid.arrays, f.name)),
            np.asarray(getattr(want.grid.arrays, f.name)), err_msg=f.name)
    for k in ("mtype", "albedo", "type_data"):
        np.testing.assert_array_equal(getattr(materials, k),
                                      getattr(want.materials, k))


# -- the traffic ---------------------------------------------------------------
def _pose_bytes(fr):
    return b"".join(np.ascontiguousarray(v).tobytes() for v in
                    (fr.origin, fr.yaw, fr.sun_position, fr.sun_color))


@pytest.mark.parametrize("seed", SEEDS)
def test_tables_hold_each_pose(cell, world, seed):
    """16 poses in a loop, each held 8 frames, one period of warm-up, the
    sun still, no actions; the checked frames are counts 2, 5 and 8 of one
    hold of the window's first period."""
    _, grid = world
    t = traffic.build(cell.traffic, cell.config["engine"], seed,
                      grid.static, grid.arrays)
    assert (t.poses, t.period, t.warmup) == (16, 16 * HOLD, 16 * HOLD)
    assert t.scene_period is None and t.fullest is None
    for g in range(2 * t.period):
        fr, nxt = t.frame(g), t.frame(g + 1)
        assert fr.actions == ()
        assert _pose_bytes(fr) == _pose_bytes(t.frame(g + t.period))
        np.testing.assert_array_equal(fr.sun_position, t.frame(0).sun_position)
        moved = not np.array_equal(fr.origin, nxt.origin)
        assert moved == ((g + 1) % HOLD == 0)
    hold = {(t.warmup + k) // HOLD for k in t.checked}
    assert len(hold) == 1
    assert [(t.warmup + k) % HOLD + 1 for k in t.checked] == [2, 5, 8]
    assert all(0 <= k < t.period for k in t.checked)


def test_every_seed_gets_the_same_frames(cell, world):
    _, grid = world
    seen = []
    for seed in SEEDS:
        t = traffic.build(cell.traffic, cell.config["engine"], seed,
                          grid.static, grid.arrays)
        seen.append(sorted(_pose_bytes(f) for f in t.frames))
    assert all(s == seen[0] for s in seen[1:])
    assert len(set(seen[0])) == 16


def test_every_pose_sees_the_block(cell, world):
    """The poses lie along x over +-1/8 of the world's width, and each
    camera sees the block (`path_loop.in_view` above zero); a pose behind
    the block is refused at set-up."""
    _, grid = world
    st = grid.static
    gen = spec.plugin("generators", "pose_holds")
    in_view = spec.plugin("generators", "path_loop").in_view
    where = gen.origins(cell.traffic, st)
    span = 0.125 * st.dim_x * st.scale
    assert where[-1, 0] - where[0, 0] == pytest.approx(2 * span)
    assert np.ptp(where[:, 1]) == 0 and np.ptp(where[:, 2]) == 0
    block = spec.plugin("scenes", "emissive_block").block_voxels(st)
    yaw = traffic.build(cell.traffic, cell.config["engine"], 1, st,
                        grid.arrays).frame(0).yaw
    for o in where:
        assert in_view(o, yaw, cell.config["engine"],
                       block.astype(np.float32), st) > 0
    behind = dict(cell.traffic, back=-0.375)
    with pytest.raises(ValueError):
        traffic.build(behind, cell.config["engine"], 1, st, grid.arrays)


# -- the program against the reference -----------------------------------------
def test_reference_follows_the_holds(reference):
    _, counts = reference
    assert counts == list(range(1, HOLD + 1)) * 2 + [1]


def test_program_follows_the_holds(traced_program):
    _, counts, _, _ = traced_program
    assert counts == list(range(1, HOLD + 1)) * 2 + [1]


@pytest.mark.parametrize("g", range(FRAMES))
def test_program_frame_matches_the_reference(traced_program, reference, g):
    """Every frame of two holds and the first of a third, the program's
    replayed step against the plain temporal reference, within the
    check's limits."""
    widest, share = check.frame_gaps(traced_program[0][g], reference[0][g])
    assert widest <= check.MAX_ABS_DIFF_LIMIT and share <= check.SHARE_OFF_LIMIT


def test_the_mean_refines_within_a_hold(reference):
    """The frames of a hold differ (each adds fresh samples), so a mean
    that stalls or restarts would show."""
    images, _ = reference
    for a, b in zip(images[:HOLD - 1], images[1:HOLD]):
        assert not torch.equal(a, b)


def _reset_every_frame(mp):
    """The running mean zeroed on every frame, held pose or not."""
    carry = VoxelRT._carry_or_reset

    def reset(self, step):
        self._pose_key = None
        carry(self, step)

    mp.setattr(VoxelRT, "_carry_or_reset", reset)


def _never_reset(mp):
    """The running mean carried across a move: zeroed only on the first
    temporal frame."""
    carry = VoxelRT._carry_or_reset

    def never(self, step):
        if self._accum is not step.accum:
            carry(self, step)

    mp.setattr(VoxelRT, "_carry_or_reset", never)


@pytest.mark.parametrize("fault", [_reset_every_frame, _never_reset],
                         ids=["reset_every_frame", "never_reset"])
def test_broken_running_mean_is_not_correct(monkeypatch, cell, world,
                                            tables, reference, fault):
    """Each fault, planted underneath the program, reads not correct by
    `check.verdict` over the frames up to the second hold's second."""
    fault(monkeypatch)
    n = HOLD + 2
    images, _ = _program_frames(cell, world[0], tables, n)
    gaps = [check.frame_gaps(a, b) for a, b in zip(images, reference[0][:n])]
    assert not check.verdict(gaps, 0)["correct"]


# -- the program's spans and counters ------------------------------------------
def test_counters_read_one_reset_a_hold(traced_program):
    _, _, snap, _ = traced_program
    assert snap["zones"]["draw"]["count"] == 2 * HOLD
    assert snap["counters"]["temporal_frames"] == 2 * HOLD
    assert snap["counters"]["temporal_resets"] == 2
    assert snap["zones"]["temporal"]["count"] == 2 * HOLD


def test_temporal_marks_bracket_the_mean(traced_program):
    """The step's body marks the running mean twice a frame (in a graph,
    two event nodes; a no-op off the card)."""
    _, _, _, marks = traced_program
    assert marks.get("temporal") == 2 * FRAMES


def test_reset_share_reads_one_hold_in_eight(monkeypatch, traced_program):
    _, _, snap, _ = traced_program
    monkeypatch.setattr(profiling, "snapshot", lambda: snap)
    assert spec.reader("temporal.reset_share").read(None) == 12.5
    # no device spans off the card
    assert spec.reader("temporal.device_ms").read(None) is None


def test_non_temporal_frames_count_nothing(cell, world, tables):
    """A key without temporal accumulation: no zone, counter or mark of
    the mean."""
    rt = _engine(cell, world[0])
    rt.set_temporal(False)
    program = harness.Program(rt)
    profiling.enable(False)
    profiling.enable(True)
    try:
        program.step(tables.frame(0))
    finally:
        profiling.enable(False)
    snap = profiling.snapshot()
    assert "temporal" not in snap["zones"]
    assert "temporal_frames" not in snap["counters"]


FILLED = {
    "zones": {"draw": {"count": 8, "total_ms": 28.0, "self_ms": 1.0}},
    "counters": {"temporal_frames": 8, "temporal_resets": 1},
    "device": {"temporal": {"count": 8, "total_ms": 0.8}},
}


@dataclasses.dataclass
class _Stretch:
    engine: dict


@pytest.mark.parametrize("name", READERS)
def test_readers_on_a_filled_store(monkeypatch, name):
    monkeypatch.setattr(profiling, "snapshot", lambda: FILLED)
    engine = spec.cell(spec.load(), CELL).config["engine"]
    got = spec.reader(name).read(_Stretch(engine))
    bound = 3 * 1920 * 1080 * 3 * 4 / 3.35e12 * 1e3
    want = {"temporal.device_ms": 0.1, "temporal_roofline": 100 * bound / 0.1,
            "temporal.reset_share": 12.5}[name]
    assert got == pytest.approx(want)
    assert bound == pytest.approx(0.02228, abs=1e-5)


@pytest.mark.parametrize("name", READERS)
def test_readers_of_a_program_without_the_spans(monkeypatch, name):
    """A program whose store has no temporal counters or marks (the
    parent's), or no store at all: nothing to read, nothing raises."""
    engine = spec.cell(spec.load(), CELL).config["engine"]
    bare = {"zones": {"draw": FILLED["zones"]["draw"]}, "counters": {},
            "device": {}}
    monkeypatch.setattr(profiling, "snapshot", lambda: bare)
    assert spec.reader(name).read(_Stretch(engine)) is None
    monkeypatch.delattr(profiling, "snapshot")
    assert spec.reader(name).read(_Stretch(engine)) is None


def test_readers_are_the_benchmarks():
    bench = spec.load()
    named = {m.name: m for m in spec.metrics(bench, "per_layer")}
    for name in READERS:
        assert named[name].workloads == [CELL]
    assert set(READERS) <= set(spec.readers(bench, CELL))


# -- the control and the whole harness -----------------------------------------
@pytest.mark.parametrize("variant", control.VARIANTS)
def test_control_fails(cell, variant):
    """The reference through bfloat16, and at half its samples a pixel,
    each fail the comparison."""
    out = control.readings(cell, 77, CPU, variant)
    assert not out["correct"]
    assert len(out["gaps"]) == 3


def _short(cell, poses=2):
    """The small cell with fewer poses in the loop (a shorter period and
    warm-up), every hold as long."""
    tr = copy.deepcopy(cell.traffic)
    tr["poses"] = poses
    return spec.Cell(cell.name, cell.config_name, cell.traffic_name,
                     cell.chips, cell.config, tr)


def _first_hold_seed(cell, world):
    """A seed whose checked frames lie in the window's first hold (its
    first 8 frames)."""
    _, grid = world
    for seed in range(2**32, 2**32 + 64):
        t = traffic.build(cell.traffic, cell.config["engine"], seed,
                          grid.static, grid.arrays)
        if max(t.checked) < HOLD:
            return seed
    raise AssertionError("no seed checks the first hold")


def test_harness_run_is_correct(cell, world):
    """A whole run of the harness on the CPU: the plug-ins found by name,
    the reference the configuration names, three frames checked (a 10-s
    window: its first 8 frames hold them)."""
    short = _short(cell)
    out = harness.run(short, _first_hold_seed(short, world), 10.0, False,
                      CPU)
    assert out["correct"], out["check"]
    assert out["check"]["frames_checked"]["value"] == 3


# -- on the card ---------------------------------------------------------------
@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("the cell's card tests need a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_small_cell_on_the_card(card, cell, world):
    short = _short(cell)
    out = harness.run(short, _first_hold_seed(short, world), 1.0, False,
                      card)
    assert out["correct"], out["check"]


@pytest.mark.cuda
def test_traced_small_cell_reads_the_temporal_metrics(card, cell):
    bench = spec.load()
    out = harness.run(cell, 91, 1.0, True, card, spec.readers(bench, CELL))
    assert out["correct"], out["check"]
    m = out["metrics"]
    assert m["temporal.device_ms"] > 0
    assert 0 < m["temporal_roofline"] <= 100
    assert m["temporal.reset_share"] == pytest.approx(100 * 129 / 1025)
