"""The voxel edits' kernels (csrc/edit.cu, through their wrappers ops/edit.py)
against their plain body: core/grid.py apply_edits / remove_edits and
ops/trace.py's records refresh, op by op.

This file imports no JAX, so it also runs on a machine with a GPU and no
JAX: `python -m pytest --noconftest tests/test_torch_edit_kernels.py`. The
tests marked `cuda` build csrc/*.cu and hold the kernels, called op by op
and replayed as CUDA graphs, against the plain body on the same card, bit
for bit on every array of the scene, on the field and on the records, after
sequences of batches at every padded size from 1,024 to 32,768 lanes; where
`torch.cuda.is_available()` is False they skip. On the CPU: the wrappers'
checks, the CPU route and its counter, the kernels' per-line field against
`ops.trace._distance_field`, the argument struct's layout and constants
against the source, and the reader of the `edit.kernel_share` metric.
"""

import contextlib
import ctypes
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from zig_vulkan_tpu_torch import _build
from zig_vulkan_tpu_torch.config import (CameraConfig, DenoiserConfig,
                                         EngineConfig, GridConfig, SunConfig)
from zig_vulkan_tpu_torch.core.grid import BrickGrid, GridArrays, GridStatic
from zig_vulkan_tpu_torch.core.materials import (MAT_DIELECTRIC,
                                                 terrain_materials)
from zig_vulkan_tpu_torch.engine.engine import VoxelRT
from zig_vulkan_tpu_torch.engine.step import GraphedCall
from zig_vulkan_tpu_torch.ops import edit as edit_ops
from zig_vulkan_tpu_torch.ops import trace
from zig_vulkan_tpu_torch.utils import profiling

torch.set_num_threads(2)

SOURCE = Path(_build.CSRC) / "edit.cu"
GLASS = 9  # a second dielectric (ir 1.5) beside the water (material 0)
SIZES = [1024 << k for k in range(6)]  # the engine's padded sizes
# the field's terms along a line (csrc/edit.cu field_kernel): exact to
# radius FIELD_EXACT, then a windowed minimum grown by each step, with its
# floor (radius 6, 12, 24 and 30: ops.trace._DF_LEVELS)
FIELD_EXACT = 3
FIELD_WINDOWS = ((3, 4), (6, 7), (12, 13), (6, 25))


def _materials():
    mats = terrain_materials()
    mats.set(GLASS, MAT_DIELECTRIC, (0.8, 0.9, 1.0), 1.5)
    return mats


def _grid(dims, brick_alloc=None, seed=0):
    """A grid of `dims` cells: a floor of full bricks, and voxels of water,
    glass and opaque materials scattered over its lower half."""
    grid = BrickGrid(*dims, GridConfig(brick_alloc=brick_alloc))
    grid.attach_materials(_materials())
    vx, vy, vz = grid.static.voxel_dims
    xs, zs = np.meshgrid(np.arange(vx), np.arange(vz), indexing="ij")
    grid.insert_batch(xs.ravel(), np.zeros(xs.size, np.int64), zs.ravel(),
                      np.ones(xs.size, np.uint8))
    rng = np.random.default_rng(seed)
    n = vx * vz // 16
    grid.insert_batch(rng.integers(0, vx, n), rng.integers(1, vy // 2, n),
                      rng.integers(0, vz, n),
                      rng.choice([0, 1, 3, 7, GLASS], n).astype(np.uint8))
    return grid


def _classified(device):
    mats = _materials()
    return (torch.from_numpy(np.asarray(mats.mtype) == MAT_DIELECTRIC)
            .to(device),
            torch.from_numpy(np.asarray(mats.type_data, np.float32))
            .to(device))


def _buffer(size, xyz, mats, rng):
    """An edit buffer of `size` lanes holding the batch; the padded lanes
    hold garbage (coordinates out of the grid, the glass material), which
    the count masks."""
    n = len(xyz)
    lanes = rng.integers(-40, 700, (size, 3)).astype(np.int32)
    lanes[:n] = xyz
    m = np.full(size, GLASS, np.int32)
    m[:n] = mats
    return torch.from_numpy(np.concatenate(
        [lanes.ravel(), m, np.asarray([n], np.int32)]))


def _batches(static, n, seed):
    """(op, xyz, mats) of `n` live lanes, inserts and removals in turn: new
    and loaded bricks, a quarter of each insert's voxels given twice with
    other materials (the later lane wins), water and glass in one brick
    (its ir poisons to NaN), removals of voxels held and never held; then a
    batch of each kind with no live lane."""
    rng = np.random.default_rng(seed)
    vx, vy, vz = static.voxel_dims
    for _ in range(3):
        xyz = np.stack([rng.integers(0, vx, n), rng.integers(0, vy, n),
                        rng.integers(0, vz, n)], -1).astype(np.int32)
        q = n // 4
        xyz[n - q:] = xyz[:q]
        mats = rng.choice([0, 1, 2, 5, 7, GLASS], n).astype(np.int32)
        yield "insert", xyz, mats
        gone = np.concatenate([xyz[rng.permutation(n)[:n // 2]],
                               xyz[:8] + np.asarray([1, 0, 0], np.int32)])
        gone[:, 0] %= vx
        yield "remove", gone[:n], None
    empty = np.zeros((0, 3), np.int32)
    yield "insert", empty, np.zeros(0, np.int32)
    yield "remove", empty, None


def _records(static, arrays):
    """The engine's records and field as its first frame builds them."""
    dist = trace.distance_field(static, arrays, exact=True)
    return trace.build_trace_tables(static, arrays, dist), dist


def _copy(arrays):
    return GridArrays(**{f.name: getattr(arrays, f.name).clone()
                         for f in dataclasses.fields(arrays)})


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(got, want, what):
    for f in dataclasses.fields(want[0]):
        assert torch.equal(_bits(getattr(got[0], f.name)),
                           _bits(getattr(want[0], f.name))), (what, f.name)
    if want[1] is not None:
        assert torch.equal(got[1][0], want[1][0]), (what, "tables")
        assert torch.equal(got[1][1], want[1][1]), (what, "dist")


@contextlib.contextmanager
def _no_plain_body():
    """The plain body raises in the scope: a kernel route may not take it."""
    saved = edit_ops.insert_plain, edit_ops.remove_plain

    def refuse(*args, **kw):
        raise AssertionError("the plain body ran on the card")

    edit_ops.insert_plain = edit_ops.remove_plain = refuse
    try:
        yield
    finally:
        edit_ops.insert_plain, edit_ops.remove_plain = saved


def _three_routes(static, arrays, with_records, batches, size, device):
    """Every batch through the kernels op by op, through replayed graphs and
    through the plain body, each on its own copy of the scene on the card:
    all three alike after every batch. Returns the last state."""
    is_diel, ir = _classified(device)
    rng = np.random.default_rng(size)
    states = []
    for _ in range(3):
        a = _copy(arrays)
        states.append((a, _records(static, a) if with_records else None))
    (op_a, op_r), (gr_a, gr_r), (pl_a, pl_r) = states
    static_buf = torch.zeros(4 * size + 1, dtype=torch.int32, device=device)
    graphs = {
        "insert": GraphedCall(lambda b: edit_ops.insert(
            static, gr_a, b, is_diel, ir, gr_r), static_buf),
        "remove": GraphedCall(lambda b: edit_ops.remove(
            static, gr_a, b, gr_r), static_buf)}
    for op, xyz, mats in batches:
        buf = _buffer(size, xyz, mats if mats is not None
                      else np.zeros(len(xyz), np.int32), rng).to(device)
        with _no_plain_body():
            before = edit_ops.insert.launches + edit_ops.remove.launches
            if op == "insert":
                took = edit_ops.insert(static, op_a, buf, is_diel, ir, op_r)
            else:
                took = edit_ops.remove(static, op_a, buf, op_r)
            assert took is True
            launched = edit_ops.insert.launches + edit_ops.remove.launches
            assert launched - before == (4 if op == "insert" and with_records
                                         else 1)
            static_buf.copy_(buf)
            graphs[op]()
        if op == "insert":
            edit_ops.insert_plain(static, pl_a, buf, is_diel, ir, pl_r)
        else:
            edit_ops.remove_plain(static, pl_a, buf, pl_r)
        torch.cuda.synchronize(device)
        _same(states[0], states[2], ("op by op", op, len(xyz)))
        _same(states[1], states[2], ("replayed", op, len(xyz)))
    return states[2]


# -- on the card --------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("size", SIZES)
def test_kernel_edits_equal_the_plain_body(card, size):
    """Inserts and removals of 700 (or size - 300) live lanes padded to
    `size`, with the records current: arrays, field and records alike on
    the three routes after each batch, brick_ir's NaN included."""
    grid = _grid((12, 10, 20))
    st = grid.static
    last = _three_routes(st, grid.arrays.to_device(card), True,
                         _batches(st, min(700, size - 300), size), size,
                         card)
    assert torch.isnan(last[0].brick_ir).any()


@pytest.mark.cuda
@pytest.mark.parametrize("size", [1024, 4096])
def test_kernel_edits_without_records(card, size):
    """Before the records' first build (and after a flush) an edit writes
    only the scene: the same batches, no field, no rows."""
    grid = _grid((12, 10, 20), seed=1)
    st = grid.static
    _three_routes(st, grid.arrays.to_device(card), False,
                  _batches(st, 900, size + 1), size, card)


@pytest.mark.cuda
@pytest.mark.parametrize("past", [(3, 3), (4, 5)])
def test_kernel_insert_past_brick_alloc(card, past):
    """Five new bricks where three fit: the two past brick_alloc are
    counted and their cells marked, and set no bit; their bytes go through
    the clamped index into the last brick's window, where the lane last in
    cell order wins. Then a removal in every one of those cells (the bricks
    past brick_alloc have no words to clear)."""
    active = int(_grid((16, 8, 16), seed=2).arrays.active_bricks)
    grid = _grid((16, 8, 16), brick_alloc=active + 3, seed=2)
    st = grid.static
    corners = [(4 * k, 28, 60) for k in range(5)]
    xyz = np.asarray(corners + [(1, 29, 61), (5, 30, 62)], np.int32)
    mats = np.asarray([7, 8, 3, *past, 6, 2], np.int32)
    batches = [("insert", xyz, mats), ("remove", xyz, None),
               ("insert", xyz[::-1].copy(), mats[::-1].copy())]
    last = _three_routes(st, grid.arrays.to_device(card), False, batches,
                         1024, card)
    assert int(last[0].active_bricks) == st.brick_alloc + 2


@pytest.mark.cuda
def test_kernel_edits_at_the_benchmark_shape(card):
    """The 128x64x128-cell world of the benchmark's edit cell: a solid
    aligned 8x8x8 block stamped and erased as its brush does, then a
    random spray, in 1,024 lanes."""
    grid = _grid((128, 64, 128), seed=3)
    st = grid.static
    bx, by, bz = np.meshgrid(np.arange(200, 208), np.arange(20, 28),
                             np.arange(300, 308), indexing="ij")
    block = np.stack([bx.ravel(), by.ravel(), bz.ravel()], -1).astype(
        np.int32)
    mats = np.random.default_rng(3).integers(1, 8, 512).astype(np.int32)
    batches = [("insert", block, mats), ("remove", block[::-1].copy(), None),
               ("insert", block, mats[::-1].copy())]
    batches += list(_batches(st, 1000, 4))
    _three_routes(st, grid.arrays.to_device(card), True, batches, 1024, card)


@pytest.mark.cuda
def test_engine_edits_run_the_kernels_and_keep_their_marks(card):
    """An engine on the card: every edit counts `edit_kernel` 1, and the
    edit graphs' marks (`edit_graph`, and `edit_field` around the insert's
    field) are read."""
    sc = _grid((16, 8, 16))
    rt = VoxelRT(sc, _materials(), _engine_config(), device=card)
    rt.render()
    rng = np.random.default_rng(5)
    profiling.enable(True)
    try:
        for _ in range(3):
            xyz = np.stack([rng.integers(0, 64, 300), rng.integers(0, 32, 300),
                            rng.integers(0, 64, 300)], -1)
            rt.insert_voxels(xyz, rng.integers(0, 9, 300).astype(np.uint8))
            rt.remove_voxels(xyz[::2])
            rt.render()
        torch.cuda.synchronize(card)
        snap = profiling.snapshot()
    finally:
        profiling.enable(False)
    assert snap["counters"]["edit_kernel"] == 6
    assert snap["device"]["edit_graph"]["count"] == 6
    assert snap["device"]["edit_field"]["count"] == 3
    assert snap["device"]["edit_field"]["total_ms"] > 0


# -- on the CPU ---------------------------------------------------------------

def _engine_config():
    return EngineConfig(
        internal_resolution_width=16, internal_resolution_height=16,
        camera=CameraConfig(origin=(4.0, 6.5, 15.0), samples_per_pixel=1,
                            max_bounce=0),
        sun=SunConfig(enabled=False), denoiser=DenoiserConfig(enabled=False))


def test_edit_args_layout_matches_the_c_struct():
    """struct EditArgs in csrc/edit.cu: fifteen pointers, two int64s, the
    dims and two ints, padded to 8 bytes; its fields in the source's order."""
    a = _build.EditArgs
    assert a.scratch.offset == 14 * 8 and a.size.offset == 120
    assert a.material_bytes.offset == 128 and a.dims.offset == 136
    assert a.cells.offset == 148 and a.brick_alloc.offset == 152
    assert ctypes.sizeof(a) == 160
    body = re.search(r"struct EditArgs \{(.*?)\};", SOURCE.read_text(),
                     re.S).group(1)
    names = re.findall(r"(\w+)(?:\[\d+\])?;", body)
    assert names == [name for name, _ in a._fields_]


def test_kernel_constants_match_the_twin():
    """The field kernel's radius, windows, floors and tile in csrc/edit.cu
    are those of ops.trace's field (`_DF_EXACT_RADIUS`, `_DF_LEVELS`: each
    window grows the radius by its step) and of the per-line twin below."""
    src = SOURCE.read_text()
    steps = re.search(r"steps\[4\] = \{([^}]*)\}", src).group(1)
    floors = re.search(r"floors\[4\] = \{([^}]*)\}", src).group(1)
    windows = tuple(zip(map(int, steps.split(",")),
                        map(int, floors.split(","))))
    assert f"k <= {trace._DF_EXACT_RADIUS}" in src
    radius = trace._DF_EXACT_RADIUS
    for (step, floor), (r, want) in zip(windows, trace._DF_LEVELS,
                                        strict=True):
        radius += step
        assert (radius, floor) == (r, want)
    assert (FIELD_EXACT, FIELD_WINDOWS) == (trace._DF_EXACT_RADIUS, windows)
    assert f"DIST_CAP = {trace.DIST_CAP};" in src
    threads = int(re.search(r"FIELD_THREADS = (\d+);", src).group(1))
    per = int(re.search(r"FIELD_PER_THREAD = (\d+);", src).group(1))
    assert threads * per == edit_ops.FIELD_TILE


def field_by_lines(static: GridStatic, loaded):
    """The conservative skip field of the bool[cells] `loaded`, as
    csrc/edit.cu computes it: per axis (x, then z, then y), each line's
    cells take the least of their own value, the exact terms to radius
    FIELD_EXACT and the windowed minima of FIELD_WINDOWS with their floors;
    cells past a line's ends count as DIST_CAP. Plain torch, the kernels'
    per-line formulation: it equals `ops.trace._distance_field`."""
    cap = trace.DIST_CAP

    def shift(v, k):  # v[..., i + k], DIST_CAP past the line's ends
        pad = abs(k)
        p = torch.nn.functional.pad(v, (pad, pad), value=cap)
        return p[..., pad + k:pad + k + v.shape[-1]]

    vol = loaded.reshape(static.dim_y, static.dim_z, static.dim_x)
    d = torch.where(vol, 0, cap).to(torch.int32)
    for axis in (2, 1, 0):
        line = d.movedim(axis, -1)
        out = w = line
        for k in range(1, FIELD_EXACT + 1):
            near = torch.minimum(shift(line, -k), shift(line, k))
            out = torch.minimum(out, near.clamp(min=k))
            w = torch.minimum(w, near)
        for step, floor in FIELD_WINDOWS:
            w = torch.minimum(w, torch.minimum(shift(w, -step),
                                               shift(w, step)))
            out = torch.minimum(out, w.clamp(min=floor))
        d = out.movedim(-1, axis)
    return d.reshape(-1)


@pytest.mark.parametrize("dims", [(128, 64, 128), (12, 10, 20), (5, 3, 7),
                                  (1, 1, 1), (40, 3, 2), (3, 37, 1)])
@pytest.mark.parametrize("density", [0.0, 0.0005, 0.02, 0.4])
def test_field_by_lines_equals_the_distance_field(dims, density):
    """The kernels' per-line field, in plain torch, against
    ops.trace._distance_field on random occupancies, at the benchmark's
    128x64x128 cells and at small and odd shapes."""
    st = GridStatic(*dims, brick_alloc=1, min_point=(0.0, 0.0, 0.0),
                    scale=1.0, base_t=0.0)
    gen = torch.Generator().manual_seed(int(density * 1e4) + sum(dims))
    loaded = torch.rand(st.cells, generator=gen) < density
    assert torch.equal(field_by_lines(st, loaded),
                       trace._distance_field(st, loaded))


def _cpu_inputs():
    grid = _grid((8, 6, 10))
    st = grid.static
    a = grid.arrays.to_device("cpu")
    tables, dist = _records(st, a)
    buf = _buffer(1024, np.zeros((5, 3), np.int32), np.ones(5, np.int32),
                  np.random.default_rng(0))
    is_diel, ir = _classified("cpu")
    return st, a, buf, is_diel, ir, tables, dist


def _strided(t):
    return torch.stack([t, t], -1)[..., 0]


# each: (what it breaks, a function of the inputs that breaks it)
FAULTS = [
    ("buf dtype", lambda k: k.update(buf=k["buf"].to(torch.int64))),
    ("buf length", lambda k: k.update(buf=k["buf"][:-1].clone())),
    ("buf on another device", lambda k: k.update(buf=k["buf"].to("meta"))),
    ("statuses dtype", lambda k: k.update(arrays=dataclasses.replace(
        k["arrays"], statuses=k["arrays"].statuses.to(torch.int64)))),
    ("indices length", lambda k: k.update(arrays=dataclasses.replace(
        k["arrays"], indices=k["arrays"].indices[:-1].clone()))),
    ("occupancy not contiguous", lambda k: k.update(
        arrays=dataclasses.replace(
            k["arrays"], occupancy=_strided(k["arrays"].occupancy)))),
    ("brick_ir on another device", lambda k: k.update(
        arrays=dataclasses.replace(
            k["arrays"], brick_ir=k["arrays"].brick_ir.to("meta")))),
    ("material_indices dtype", lambda k: k.update(
        arrays=dataclasses.replace(
            k["arrays"],
            material_indices=k["arrays"].material_indices.to(torch.int32)))),
    ("active_bricks length", lambda k: k.update(arrays=dataclasses.replace(
        k["arrays"], active_bricks=torch.zeros(2, dtype=torch.int32)))),
    ("mat_ir alone", lambda k: k.update(mat_is_diel=None)),
    ("mat_ir dtype", lambda k: k.update(mat_ir=k["mat_ir"].double())),
    ("mat_is_diel length", lambda k: k.update(
        mat_is_diel=k["mat_is_diel"][:128].clone())),
    ("tables shape", lambda k: k.update(
        records=(k["records"][0][:-1].clone(), k["records"][1]))),
    ("tables not contiguous", lambda k: k.update(
        records=(k["records"][0].t().contiguous().t(), k["records"][1]))),
    ("dist dtype", lambda k: k.update(
        records=(k["records"][0], k["records"][1].to(torch.int64)))),
]


# a removal reads no material classification
CHECKS = [("insert", *f) for f in FAULTS] + [
    ("remove", *f) for f in FAULTS if not f[0].startswith("mat_")]


@pytest.mark.parametrize("op,what,fault", CHECKS,
                         ids=[f"{c[0]}-{c[1]}" for c in CHECKS])
def test_wrappers_check_their_tensors(op, what, fault):
    """What the kernels would read is checked before a launch: a tensor on
    another device, of another dtype or length, or not contiguous, raises
    (the checks run on any device; the launch only on a card)."""
    st, a, buf, is_diel, ir, tables, dist = _cpu_inputs()
    if op == "remove":
        is_diel = ir = None
    kw = dict(arrays=a, buf=buf, mat_is_diel=is_diel, mat_ir=ir,
              records=(tables, dist))
    args = edit_ops._launch_args(op, st, a, buf, is_diel, ir, (tables, dist))
    assert args.size == 1024 and args.cells == st.cells
    assert ("scratch" in args.held) == (op == "insert")
    fault(kw)
    with pytest.raises(ValueError, match="ops.edit"):
        edit_ops._launch_args(op, st, kw["arrays"], kw["buf"],
                              kw["mat_is_diel"], kw["mat_ir"], kw["records"])


def test_wrappers_refuse_other_devices():
    st, a, buf, is_diel, ir, tables, dist = _cpu_inputs()
    meta = buf.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        edit_ops.insert(st, a, meta, is_diel, ir)
    with pytest.raises(ValueError, match="unsupported device"):
        edit_ops.remove(st, a, meta)


def test_cpu_route_takes_the_plain_body_and_counts_no_kernel():
    """On the CPU an engine's edits run the plain body (no launch), and
    each counts `edit_kernel` 0: the metric reads 0% there."""
    from rtbench import devtrace, spec

    rt = VoxelRT(_grid((16, 8, 16)), _materials(), _engine_config(),
                 device="cpu")
    rt.draw()
    before = edit_ops.insert.launches + edit_ops.remove.launches
    ran = []
    saved = edit_ops.insert_plain, edit_ops.remove_plain
    edit_ops.insert_plain = lambda *a, **k: (ran.append("insert"),
                                             saved[0](*a, **k))
    edit_ops.remove_plain = lambda *a, **k: (ran.append("remove"),
                                             saved[1](*a, **k))
    profiling.enable(False)
    profiling.enable(True)
    try:
        rt.insert_voxels([[3, 20, 3], [4, 20, 3]], [2, 5])
        rt.remove_voxels([[3, 20, 3]])
        rt.draw()
        got = devtrace.per_layer(None, {"edit.kernel_share": spec.reader(
            "edit.kernel_share")})
        snap = profiling.snapshot()
    finally:
        profiling.enable(False)
        edit_ops.insert_plain, edit_ops.remove_plain = saved
    assert ran == ["insert", "remove"]
    assert edit_ops.insert.launches + edit_ops.remove.launches == before
    assert snap["counters"]["edit_kernel"] == 0
    assert got == {"edit.kernel_share": 0.0}
    assert rt.arrays.occupancy.any()


def test_engine_route_follows_the_device():
    """The wrappers report the route they took, which the engine counts:
    False for the plain body on the CPU (True for the kernels on a card,
    `_three_routes`), and an engine's edit body returns it."""
    st, a, buf, is_diel, ir, tables, dist = _cpu_inputs()
    assert edit_ops.insert(st, a, buf, is_diel, ir, (tables, dist)) is False
    assert edit_ops.remove(st, a, buf, (tables, dist)) is False
    rt = VoxelRT(_grid((16, 8, 16)), _materials(), _engine_config(),
                 device="cpu")
    step_buf = torch.from_numpy(edit_ops.pack(1024, np.zeros((1, 3),
                                                             np.int32)))
    for op in ("insert", "remove"):
        assert rt._edit_body(op, False)(step_buf) is False


KERNEL_SHARE = [
    ({"edit_kernel": 4}, 100.0),
    ({"edit_kernel": 1, "host_waits": 3}, 25.0),
    ({"edit_kernel": 0}, 0.0),
    ({"host_waits": 3}, None),  # a program without the kernels
]


@pytest.mark.parametrize("counters,want", KERNEL_SHARE)
def test_kernel_share_reads_the_store(monkeypatch, counters, want):
    """edit.kernel_share: the counter over the edit zones' count (two
    inserts and two removals), in %; nothing without the counter, without
    an edit or without a store."""
    from rtbench import spec

    snap = {"zones": {"draw": {"count": 4, "total_ms": 8.0, "self_ms": 1.0},
                      "edit_insert": {"count": 2, "total_ms": 2.0,
                                      "self_ms": 0.1},
                      "edit_remove": {"count": 2, "total_ms": 1.0,
                                      "self_ms": 0.1}},
            "counters": counters, "device": {}}
    monkeypatch.setattr(profiling, "snapshot", lambda: snap)
    reader = spec.reader("edit.kernel_share")
    assert reader.read(None) == (None if want is None
                                 else pytest.approx(want))
    snap["zones"] = {"draw": snap["zones"]["draw"]}
    assert reader.read(None) is None
    monkeypatch.delattr(profiling, "snapshot")
    assert reader.read(None) is None


def test_kernel_share_is_in_the_benchmark():
    from rtbench import spec

    named = {m.name: m for m in spec.metrics(spec.load(), "per_layer")}
    metric = named["edit.kernel_share"]
    assert metric.source == "program_counter" and metric.moves == "frame_ms"
    assert metric.layer == named["edit.device_ms"].layer
