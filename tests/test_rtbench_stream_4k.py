"""The benchmark cell `stream_4k` (BASELINE config 5 on one card) at a size
the CPU runs (`rtbench.tests.small.small_cell`: a 32x16x32-brick world and
64x36 frames, with the slab and the batch cut so that the stream has four
slabs and several batches a slab): the scene generator `streamed_terrain`
against `benchmarks/configs.py:build_config5`'s streamed construction and
in stream order, the program against the plain reference `RefEngine` frame
by frame, the sun states the traffic hands over ignored on both sides, the
one-level frame's launch counters, the reader `traverse_roofline`, the
control, and the whole harness run. Imports nothing of JAX.

    python -m pytest tests/test_rtbench_stream_4k.py -q

The `cuda` tests run the cell's small size and its traced full size on the
card (`--noconftest`)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from rtbench import check, control, devtrace, program_store, scene, spec
from rtbench import traffic
from rtbench import run as harness
from rtbench.ref.core.grid import dense_materials, grid_at
from rtbench.tests.small import small_cell
from zig_vulkan_tpu_torch.engine.engine import VoxelRT
from zig_vulkan_tpu_torch.io.scene_io import load_scene
from zig_vulkan_tpu_torch.ops import trace as p_trace
from zig_vulkan_tpu_torch.utils import profiling

CELL = "stream_4k"
CPU = torch.device("cpu")
SEED = 2**33 + 23
REGION_X = 32      # four slabs of the 128-voxel-wide small world
MAX_BATCH = 16384  # several batches a slab


@pytest.fixture(scope="module")
def cell():
    c = small_cell(CELL)
    c.config["scene"].update(region_x=REGION_X, max_batch=MAX_BATCH)
    return c


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


@pytest.fixture(scope="module")
def program(cell, world, tables):
    """The program over one loop of the path with its tracing on: (images,
    the store's snapshot, `LaneQueue`s made, the engine)."""
    made = []
    lane_queue = p_trace.LaneQueue

    def counting(*args, **kwargs):
        made.append(1)
        return lane_queue(*args, **kwargs)

    mp = pytest.MonkeyPatch()
    mp.setattr(p_trace, "LaneQueue", counting)
    rt = _engine(cell, world[0])
    prog = harness.Program(rt)
    was = profiling.enabled()
    profiling.enable(False)
    profiling.enable(True)
    try:
        images = [prog.step(tables.frame(g)) for g in range(tables.poses)]
    finally:
        profiling.enable(was)
        mp.undo()
    return images, profiling.snapshot(), len(made), rt


@pytest.fixture(scope="module")
def reference(cell, world, tables):
    ref = harness.reference_engine(cell, world[0], CPU)
    images = [ref.image(tables.frame(g)) for g in
              harness.reference_frames(ref, tables, range(tables.poses))]
    return images, ref


# -- the scene -----------------------------------------------------------------
def _streamed_by_the_port(dims, min_point, region_x, max_batch):
    """The arrays `build_config5` streams (its grid, engine and
    `io/streaming.py` calls) at `dims` bricks, on the CPU."""
    from zig_vulkan_tpu_torch.config import (CameraConfig, DenoiserConfig,
                                             EngineConfig, GridConfig,
                                             SunConfig)
    from zig_vulkan_tpu_torch.core.grid import BrickGrid
    from zig_vulkan_tpu_torch.core.materials import terrain_materials
    from zig_vulkan_tpu_torch.io import streaming

    grid = BrickGrid(*dims, GridConfig(min_point=min_point, scale=0.5))
    rt = VoxelRT(grid, terrain_materials(), EngineConfig(
        internal_resolution_width=16, internal_resolution_height=8,
        camera=CameraConfig(samples_per_pixel=1, max_bounce=0),
        sun=SunConfig(enabled=False), denoiser=DenoiserConfig(enabled=False)),
        device=CPU)
    streaming.stream_into_engine(
        rt, streaming.terrain_regions(grid, region_x=region_x),
        max_batch=max_batch)
    return rt.grid_static, rt.arrays


def _config5_scale():
    """The arrays `build_config5` itself streams at scale 1/32 (8x4x8
    bricks: four slabs of `region_x` 8, one batch each)."""
    from zig_vulkan_tpu_torch.benchmarks.configs import build_config5

    c = build_config5(1 / 32, devices=[CPU])
    return c.rt.grid_static, c.rt.arrays


def _assert_same_arrays(static, arrays, want_static, want_arrays):
    assert dataclasses.astuple(static) == dataclasses.astuple(want_static)
    for f in dataclasses.fields(arrays):
        got = np.asarray(getattr(arrays, f.name))
        want = getattr(want_arrays, f.name).cpu().numpy()
        if got.dtype == np.uint32:
            want = want.view(np.uint32)
        np.testing.assert_array_equal(got, want, err_msg=f.name)
    assert torch.equal(dense_materials(static, arrays),
                       dense_materials(want_static, want_arrays))


@pytest.mark.parametrize("case", ["build_config5", "several_batches"])
def test_scene_generator_is_build_config5s(cell, case):
    """`streamed_terrain` against the port's streamed construction at the
    same size, voxel for voxel and array for array: the generator sorts
    each batch by cell, as the engine's insert numbers a batch's new
    bricks, so the brick layout is the one `build_config5` streams."""
    full = spec.cell(spec.load(), CELL).config["scene"]
    if case == "build_config5":
        conf = dict(full, grid_dims=[8, 4, 8], region_x=8)
        want = _config5_scale()
    else:
        conf = dict(cell.config["scene"], min_point=full["min_point"])
        want = _streamed_by_the_port(tuple(conf["grid_dims"]),
                                     tuple(conf["min_point"]), REGION_X,
                                     MAX_BATCH)
    grid, _ = scene.build(conf)
    _assert_same_arrays(grid.static, grid.arrays, *want)


def test_bricks_are_in_stream_order(world, cell):
    """A loaded cell's brick index grows with the slab and batch that first
    wrote it: each batch's new bricks follow every earlier batch's. The
    scene is `terrain.generate`'s voxel for voxel, in another layout."""
    _, grid = world
    st, arrays = grid.static, grid.arrays
    gen = spec.plugin("scenes", "streamed_terrain")
    vy = st.voxel_dims[1]
    first = np.full(st.cells, -1, dtype=np.int64)
    slabs, n = set(), 0
    for n, (xyz, _) in enumerate(gen.batches(st, cell.config["scene"])):
        x, y, z = xyz.T
        cells = np.unique(grid_at(st, x, (vy - 1) - y, z))
        fresh = cells[first[cells] < 0]
        first[fresh] = n
        slabs.add(int(x.min()) // REGION_X)
    batches = n + 1
    assert len(slabs) == 4 and batches > 2 * len(slabs)
    loaded = np.flatnonzero(first >= 0)
    bricks = np.asarray(arrays.indices, dtype=np.int64)[loaded]
    order = np.argsort(bricks)
    assert np.all(np.diff(first[loaded][order]) >= 0)
    assert sorted(bricks) == list(range(int(arrays.active_bricks)))

    plain = spec.plugin("scenes", "default_scene")
    conf = dict(cell.config["scene"], generator="default_scene")
    g2, _ = plain.build(conf)
    assert torch.equal(dense_materials(st, arrays),
                       dense_materials(g2.static, g2.arrays))
    assert not np.array_equal(np.asarray(arrays.indices),
                              np.asarray(g2.arrays.indices))


def test_regions_are_terrain_regions(world):
    """The generator's slabs are `io/streaming.py:terrain_regions`'
    voxel for voxel (the port's copy over its own noise)."""
    from zig_vulkan_tpu_torch.core.grid import BrickGrid
    from zig_vulkan_tpu_torch.io import streaming

    _, grid = world
    st = grid.static
    gen = spec.plugin("scenes", "streamed_terrain")
    port = streaming.terrain_regions(
        BrickGrid(st.dim_x, st.dim_y, st.dim_z), region_x=REGION_X)
    ours = gen.regions(st, 420, 4.0, 20, REGION_X)
    pairs = list(zip(ours, port, strict=True))
    assert len(pairs) == 4
    for (xyz, mat), (p_xyz, p_mat) in pairs:
        np.testing.assert_array_equal(xyz, p_xyz)
        np.testing.assert_array_equal(mat, p_mat)


# -- the program against the reference -----------------------------------------
def test_every_frame_is_the_references(program, reference, tables):
    """Each frame of one loop of the path, bit for bit; most poses see
    the terrain."""
    images, _, _, _ = program
    ref_images, _ = reference
    assert len(images) == len(ref_images) == tables.poses == 6
    for got, want in zip(images, ref_images):
        assert check.frame_gaps(got, want) == (0.0, 0.0)
    assert sum(float(img.std()) > 0.05 for img in images) >= 4


def test_scene_check_is_exact(program, reference):
    _, _, _, rt = program
    _, ref = reference
    got = dense_materials(rt.grid_static, rt.arrays)
    assert int((got != ref.dense()).sum()) == 0
    assert int((got >= 0).sum()) > 0


def test_sun_states_are_ignored(cell, world, tables, program, reference):
    """The sun is off (so `path_loop` hands over one sun state, the
    still sun's): the program and the reference draw a frame the same
    under another sun position and colour."""
    images, _, _, _ = program
    ref_images, ref = reference
    suns = {tables.frame(g).sun_position.tobytes() for g in range(6)}
    assert len(suns) == 1
    g = max(range(tables.poses), key=lambda k: float(images[k].std()))
    fr = tables.frame(g)
    moved = dataclasses.replace(
        fr, sun_position=np.asarray([40.0, 60.0, 30.0], np.float32),
        sun_color=fr.sun_color * np.float32(0.5))
    prog = harness.Program(_engine(cell, world[0]))
    assert torch.equal(prog.step(moved), images[g])
    assert torch.equal(ref.image(moved), ref_images[g])


def test_one_launch_a_frame_and_no_queue(program, tables):
    """One level, no sun: kernels A and D run once a frame and take no
    queue, and no queue buffer is made."""
    _, snap, made, _ = program
    counters = snap["counters"]
    assert snap["zones"]["draw"]["count"] == tables.poses
    assert counters["trace_launches"] == tables.poses
    assert counters["trace_queued"] == 0
    assert counters["shade_launches"] == tables.poses
    assert counters["shade_queued"] == 0
    assert made == 0


# -- traverse_roofline ---------------------------------------------------------
def _stretch(kernels, engine, frames=4):
    return devtrace.Stretch(frames=frames, window_us=1e4, busy_us=5e3,
                            kernels=kernels, gaps=[], action_ms={},
                            engine=engine)


A = "void (anonymous namespace)::traverse_kernel<false, false, true>(Args)"
D = "void (anonymous namespace)::shade_kernel<true>(ShadeArgs)"


def test_traverse_bound_at_4k():
    reader = spec.reader("traverse_roofline")
    engine = spec.cell(spec.load(), CELL).config["engine"]
    assert reader.lanes(engine) == 8_294_400
    assert reader.traverse_bytes(engine) == 481_075_200
    assert reader.traverse_bound_ms(engine) == pytest.approx(0.1436, abs=5e-5)
    assert reader.RAY_IN_BYTES + reader.HIT_OUT_BYTES == 58


@pytest.mark.parametrize("kernels,want", [
    ([(A, 0.0, 600.0), (A, 1.0, 600.0), (D, 2.0, 400.0)], 0.3),
    ([], None),
    ([(D, 0.0, 400.0)], None),
], ids=["filled", "bare", "no_kernel_a"])
def test_traverse_roofline_reader(kernels, want):
    """A's share over a stretch of 4 frames: A 1.2 ms in all, 0.3 ms a
    frame; nothing to read without a kernel A."""
    reader = spec.reader("traverse_roofline")
    engine = spec.cell(spec.load(), CELL).config["engine"]
    got = reader.read(_stretch(kernels, engine))
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(100 * reader.traverse_bound_ms(engine)
                                    / want)
        assert 0 < got <= 100
    assert reader.read(_stretch(kernels, {})) is None


def test_reader_is_the_benchmarks():
    bench = spec.load()
    named = {m.name: m for m in spec.metrics(bench, "per_layer")}
    m = named["traverse_roofline"]
    assert m.workloads == [CELL] and m.moves == "frame_ms"
    assert m.layer == named["traverse.ms"].layer
    assert set(spec.readers(bench, CELL)) == {"traverse_roofline"}


# -- the control and the whole harness -----------------------------------------
def test_control_is_not_correct(cell):
    out = control.readings(cell, 77, CPU, "bfloat16")
    assert not out["correct"]
    assert len(out["gaps"]) == 3


def test_harness_run_is_correct(cell):
    """A whole run of the harness on the CPU: the plug-ins found by name,
    three frames checked bit for bit, the scene exact."""
    out = harness.run(cell, SEED, 2.0, False, CPU)
    assert out["correct"], out["check"]
    numbers = out["check"]
    assert numbers["frames_checked"]["value"] == 3
    assert numbers["max_abs_diff"]["value"] == 0.0
    assert numbers["share_off_pct"]["value"] == 0.0
    assert numbers["scene_voxels_wrong"]["value"] == 0


# -- on the card ---------------------------------------------------------------
@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("the cell's card tests need a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_small_cell_on_the_card(card, cell):
    out = harness.run(cell, SEED, 1.0, False, card)
    assert out["correct"], out["check"]
    assert out["check"]["max_abs_diff"]["value"] == 0.0


@pytest.mark.cuda
def test_traced_full_cell(card):
    """The full cell traced: bit for bit, A's share of its roofline read,
    one launch of kernel A a frame and no queued one."""
    bench = spec.load()
    out = harness.run(spec.cell(bench, CELL), 91, 1.0, True, card,
                      spec.readers(bench, CELL))
    assert out["correct"], out["check"]
    assert out["check"]["max_abs_diff"]["value"] == 0.0
    assert 0 < out["metrics"]["traverse_roofline"] <= 100
    held = program_store.store()
    assert held.counter("trace_launches") == held.frames
    assert held.counter("trace_queued") == 0
