"""The compiled edit path of zig_vulkan_tpu_torch against the JAX package's.

The JAX engine runs each edit batch through jitted programs with no host
sync (`apply_edits`, `remove_edits`, the records' refreshes), padded to
1024 lanes times a power of two. The port's counterparts are captured as
CUDA graphs on a card (`engine.step.EditStep`), so they must make no
tensor whose shape depends on the data and read nothing back to the host.
On the CPU these tests hold that (a dispatch mode that fails on every
host-syncing op), the padded edits against the JAX package's bit for bit,
the engine's edit path against the JAX engine's, and the edit cache; the
replays themselves are tested on the card (`tests/test_torch_kernels.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import zig_vulkan_tpu.config as rconfig
import zig_vulkan_tpu_torch.config as tconfig
from zig_vulkan_tpu.core import grid as rgrid
from zig_vulkan_tpu.core.materials import MAT_DIELECTRIC, terrain_materials
from zig_vulkan_tpu.engine import engine as rengine
from zig_vulkan_tpu.models import scenes as rscenes
from zig_vulkan_tpu_torch.core import grid as tgrid
from zig_vulkan_tpu_torch.core.camera import Camera
from zig_vulkan_tpu_torch.engine import engine as tengine
from zig_vulkan_tpu_torch.engine import step as tstep
from zig_vulkan_tpu_torch.models import scenes as tscenes
from zig_vulkan_tpu_torch.ops import edit as tedit
from zig_vulkan_tpu_torch.ops import tile_tracer as ttile
from zig_vulkan_tpu_torch.ops import trace as ttrace
from zig_vulkan_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(2)

FIELDS = ("statuses", "indices", "occupancy", "start_indices",
          "material_indices", "active_bricks", "material_cursor",
          "diel_mask", "brick_ir")
GLASS = 9  # a second dielectric (ir 1.5) beside the water (material 0)

# ops that wait for the device or size their result from the data
_SYNCING = {"aten::_local_scalar_dense", "aten::nonzero",
            "aten::masked_select", "aten::_unique", "aten::_unique2",
            "aten::unique_dim", "aten::unique_consecutive",
            "aten::unique_dim_consecutive"}
_INDEXING = {"aten::index", "aten::index_put", "aten::index_put_",
             "aten::_index_put_impl_"}


class HostSyncs(TorchDispatchMode):
    """Records every op that would read the device back to the host: an
    item, a nonzero or masked select, a unique, a boolean-mask index, a
    repeat_interleave that sizes its output from the data. Inside
    `kernel()` nothing is recorded: a kernel launch takes the place of its
    plain version there."""

    def __init__(self):
        super().__init__()
        self.found = []
        self.ops = 0
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        if not self.paused:
            self.ops += 1
            if name in _SYNCING or (
                    name.startswith("aten::repeat_interleave")
                    and kwargs.get("output_size") is None):
                self.found.append(name)
            elif name in _INDEXING and any(
                    i is not None and i.dtype == torch.bool for i in args[1]):
                self.found.append(f"{name} (bool index)")
        return func(*args, **kwargs)

    def kernel(self, fn):
        def launch(*args, **kw):
            self.paused = True
            try:
                return fn(*args, **kw)
            finally:
                self.paused = False
        return launch


def _materials():
    mats = terrain_materials()
    mats.set(GLASS, MAT_DIELECTRIC, (0.8, 0.9, 1.0), 1.5)
    return mats


def _scene(grid_cls, brick_alloc=None):
    """A 16x8x16-cell grid: a floor of full bricks and a water layer whose
    bricks are partly filled (tests/test_torch_edits.py's scene)."""
    mats = _materials()
    cfg_mod = rconfig if grid_cls is rgrid.BrickGrid else tconfig
    grid = grid_cls(16, 8, 16, cfg_mod.GridConfig(brick_alloc=brick_alloc))
    grid.attach_materials(mats)
    xs, zs = np.meshgrid(np.arange(40), np.arange(40), indexing="ij")
    for y in range(4):
        grid.insert_batch(xs.ravel(), np.full(xs.size, y), zs.ravel(),
                          np.full(xs.size, 1, dtype=np.uint8))
    wx, wz = np.meshgrid(np.arange(9, 15), np.arange(9, 15), indexing="ij")
    grid.insert_batch(wx.ravel(), np.full(wx.size, 4), wz.ravel(),
                      np.zeros(wx.size, dtype=np.uint8))
    return grid, mats


def _padded(xyz, mats, lanes, seed):
    """A batch padded to `lanes`: garbage coordinates and glass in the
    padded lanes, which `valid` masks."""
    rng = np.random.default_rng(seed)
    n = len(xyz)
    pad_xyz = rng.integers(0, 32, (lanes, 3)).astype(np.int32)
    pad_xyz[:n] = xyz
    pad_m = np.full(lanes, GLASS, dtype=np.uint8)
    pad_m[:n] = mats
    return pad_xyz, pad_m, np.arange(lanes) < n


def _batch(n, seed):
    """`n` insert lanes on the 64x32x64-voxel grid: new bricks high above
    the floor, a glass voxel in a water brick (its ir poisons to NaN), a new
    brick of two water voxels (1.333), and voxels given twice (the second
    lane of the same dielectric class, so that both packages agree on the
    winner: the later lane)."""
    rng = np.random.default_rng(seed)
    fixed = [((9, 5, 9), GLASS), ((44, 20, 44), 0), ((45, 21, 44), 0),
             ((40, 24, 40), 2), ((40, 24, 40), 6), ((20, 10, 20), 3),
             ((20, 10, 20), 5)]
    xyz = [v for v, _ in fixed]
    mats = [m for _, m in fixed]
    seen = set(xyz)
    while len(xyz) < n:
        v = (int(rng.integers(0, 64)), int(rng.integers(4, 32)),
             int(rng.integers(0, 64)))
        # stay out of the dielectric bricks of the fixed lanes
        if v in seen or (v[0] // 4, v[1] // 4, v[2] // 4) in {
                (2, 1, 2), (11, 5, 11), (11, 5, 10)}:
            continue
        seen.add(v)
        xyz.append(v)
        mats.append(int(rng.choice([1, 2, 3, 5, 6, 8])))
    return np.asarray(xyz, np.int32), np.asarray(mats, np.uint8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _classified(mats, jax_side):
    is_diel = np.asarray(mats.mtype) == MAT_DIELECTRIC
    ir = np.asarray(mats.type_data, dtype=np.float32)
    if jax_side:
        return jnp.asarray(is_diel), jnp.asarray(ir)
    return _t(is_diel), _t(ir)


def _assert_equal(port, ref):
    for name in FIELDS:
        got, want = getattr(port, name), np.asarray(getattr(ref, name))
        if want.dtype == np.uint32:
            got = got.numpy().view(np.uint32)
        else:
            got = got.numpy()
        np.testing.assert_array_equal(got.view(np.uint8) if name == "brick_ir"
                                      else got,
                                      want.view(np.uint8) if name == "brick_ir"
                                      else want, err_msg=name)


_ref_apply = jax.jit(rgrid.apply_edits, static_argnums=0)
_ref_remove = jax.jit(rgrid.remove_edits, static_argnums=0)


# -- no host sync ------------------------------------------------------------------

def _edit_inputs():
    grid, mats = _scene(tgrid.BrickGrid)
    st = grid.static
    arrays = grid.arrays.to_device("cpu")
    tables = ttrace.build_trace_tables(st, arrays, ttrace.distance_field(
        st, arrays, exact=True))
    xyz, m, valid = _padded(*_batch(512, 0), 1024, 1)
    cells = _t(tgrid.grid_at(st, xyz[:, 0], st.voxel_dims[1] - 1 - xyz[:, 1],
                             xyz[:, 2]))
    return st, mats, arrays, tables, _t(xyz), _t(m), _t(valid), cells


def test_edits_and_refreshes_make_no_host_sync():
    st, mats, arrays, tables, xyz, m, valid, cells = _edit_inputs()
    with HostSyncs() as mode:
        tgrid.apply_edits(st, arrays, xyz, m, valid, *_classified(mats, False))
        _, dist = ttrace.refresh_tables_after_insert(st, arrays, tables,
                                                     cells, valid)
    assert mode.found == [] and mode.ops > 300
    with HostSyncs() as mode:
        tgrid.remove_edits(st, arrays, xyz, valid)
        ttrace.refresh_tables_after_remove(st, arrays, tables, dist, cells,
                                           valid)
    assert mode.found == [] and mode.ops > 80


def test_the_checker_finds_boolean_mask_indexing():
    """The mode catches what the parent's edits did (a boolean-mask index),
    an item and a repeat_interleave sized by its repeats."""
    x = torch.arange(8)
    with HostSyncs() as mode:
        x[x > 3] = 0
        x.sum().item()
        torch.repeat_interleave(x, torch.full_like(x, 2))
    assert mode.found == ["aten::index_put_ (bool index)",
                          "aten::_local_scalar_dense", "aten::repeat_interleave"]


@pytest.mark.parametrize("denoise", [False, True])
def test_shard_band_bodies_make_no_host_sync(monkeypatch, denoise):
    """A shard's trace and post-process bodies, the kernel launches aside
    (their plain versions loop until every ray is done)."""
    sc = tscenes.flat_test_scene(dim=8)
    st = sc.grid.static
    mesh = pmesh.make_mesh(["cpu"] * 2)
    step = pmesh.build_sharded_step(
        mesh, st, width=32, height=32, spp=1, max_bounce=2, sun_enabled=True,
        denoiser=tconfig.DenoiserConfig(enabled=denoise, samples=4))
    arrays = sc.grid.arrays.to_device("cpu")
    mats = ttrace.materials_to_device(sc.materials, "cpu")
    tables = ttrace.build_trace_tables(st, arrays)
    pc = step.pcs[torch.device("cpu")]
    pc[0:12] = _t(ttrace.camera_basis(Camera(
        75.0, 32, 32, tconfig.CameraConfig(origin=(4.0, 6.5, 15.0)))
        .d_camera))
    pc[12:19] = torch.tensor([10.0, -40.0, 10.0, 1.0, 0.9, 0.8, 2.0])
    with HostSyncs() as mode:
        monkeypatch.setattr(ttile, "grid_hit_tiles",
                            mode.kernel(ttile.grid_hit_tiles))
        bands = [step.plan.trace(i, pc, tables, arrays.material_indices,
                                 mats) for i in range(2)]
        pieces = [bands[j][r0 - 16 * j:r1 - 16 * j]
                  for j, r0, r1 in step.plan.sources(1)]
        out = step.plan.post(1, *pieces)
    assert mode.found == [] and mode.ops > 200
    assert out.shape == (16, 32, 3) and torch.isfinite(out).all()


# -- padded edits against the JAX package ------------------------------------------

@pytest.mark.parametrize("n, lanes", [(512, 1024), (1500, 2048)])
def test_padded_edits_match_the_jax_package(n, lanes):
    """A padded batch (duplicates, new bricks, a NaN-poisoned brick, garbage
    in the padded lanes) through both packages' `apply_edits`, then a padded
    removal of every third voxel and a few the scene never held: all nine
    arrays bit for bit after each."""
    grid, mats = _scene(rgrid.BrickGrid)
    st = grid.static
    xyz, m, valid = _padded(*_batch(n, 2), lanes, 3)
    ref = _ref_apply(st, grid.device_arrays(), jnp.asarray(xyz),
                     jnp.asarray(m), jnp.asarray(valid),
                     *_classified(mats, True))
    port = tgrid.apply_edits(st, tgrid.GridArrays.to_device(grid.arrays, "cpu"),
                             _t(xyz), _t(m), _t(valid),
                             *_classified(mats, False))
    _assert_equal(port, ref)
    ir = port.brick_ir.numpy()
    assert np.isnan(ir).any() and (ir == np.float32(1.5)).sum() == 0
    assert (ir == np.float32(1.333)).any()
    gone = np.concatenate([xyz[:n:3], [[60, 30, 60], [1, 9, 1]]])
    rxyz, _, rvalid = _padded(gone, np.zeros(len(gone), np.uint8), lanes, 4)
    ref = _ref_remove(st, ref, jnp.asarray(rxyz), jnp.asarray(rvalid))
    port = tgrid.remove_edits(st, port, _t(rxyz), _t(rvalid))
    _assert_equal(port, ref)


@pytest.mark.parametrize("past", [(3, 3), (4, 5)])
def test_lanes_past_brick_alloc_are_dropped_as_in_the_jax_package(past):
    """Five new bricks where three fit: the two past `brick_alloc` are
    counted and their cells marked, as in the JAX package, and set no bit.
    Their voxels sit at the corner of their cells, as the voxel (material
    3) of the last brick that fits does, so both packages write their bytes
    through the clamped index into that brick's window, over that voxel's:
    the lane last in cell order wins (material 3 where the materials agree,
    5 where they differ)."""
    grid, mats = _scene(rgrid.BrickGrid, brick_alloc=None)
    active = int(grid.arrays.active_bricks)
    small, _ = _scene(rgrid.BrickGrid, brick_alloc=active + 3)
    st = small.static
    corners = [(4 * k, 28, 60) for k in range(5)]  # five unloaded cells
    xyz = np.asarray(corners + [(1, 29, 61), (5, 30, 62)], np.int32)
    m = np.asarray([7, 8, 3, *past, 6, 2], np.uint8)
    xyz, m, valid = _padded(xyz, m, 1024, 5)
    ref = _ref_apply(st, small.device_arrays(), jnp.asarray(xyz),
                     jnp.asarray(m), jnp.asarray(valid),
                     *_classified(mats, True))
    port = tgrid.apply_edits(st, tgrid.GridArrays.to_device(small.arrays,
                                                            "cpu"),
                             _t(xyz), _t(m), _t(valid),
                             *_classified(mats, False))
    _assert_equal(port, ref)
    assert int(port.active_bricks) == st.brick_alloc + 2
    # the bricks within brick_alloc hold their corner voxels; the others
    # have cells that point past the arrays
    bricks = []
    for (x, y, z), mat in zip(corners, (7, 8, past[-1], None, None)):
        fy = st.voxel_dims[1] - 1 - y
        brick = int(port.indices[int(tgrid.grid_at(st, x, fy, z))])
        bricks.append(brick)
        if brick < st.brick_alloc:
            nth = int(tgrid.voxel_at(x, fy, z))
            start = int(port.start_indices[brick]) & 0x7FFFFFFF
            assert int(port.material_indices[start + nth]) == mat
            assert (int(port.occupancy[2 * brick + nth // 32])
                    >> (nth % 32)) & 1
    assert bricks == list(range(st.brick_alloc - 3, st.brick_alloc + 2))


def test_removals_in_cells_past_brick_alloc_are_dropped_as_in_the_jax_package():
    """After five new bricks where three fit, a removal of every voxel the
    insert gave: the two cells past `brick_alloc` are loaded but have no
    words, so their lanes clear nothing (the JAX package drops them), and
    the last brick that fits keeps the voxel left in it, whose bit the
    lanes past `brick_alloc` share."""
    grid, mats = _scene(rgrid.BrickGrid, brick_alloc=None)
    active = int(grid.arrays.active_bricks)
    small, _ = _scene(rgrid.BrickGrid, brick_alloc=active + 3)
    st = small.static
    # two voxels of each cell, one in each word of its brick
    xyz = np.asarray([(4 * k, y, 60) for k in range(5) for y in (28, 30)],
                     np.int32)
    m = np.full(len(xyz), 3, np.uint8)
    pxyz, pm, valid = _padded(xyz, m, 1024, 6)
    ref = _ref_apply(st, small.device_arrays(), jnp.asarray(pxyz),
                     jnp.asarray(pm), jnp.asarray(valid),
                     *_classified(mats, True))
    port = tgrid.apply_edits(st, tgrid.GridArrays.to_device(small.arrays,
                                                            "cpu"),
                             _t(pxyz), _t(pm), _t(valid),
                             *_classified(mats, False))
    _assert_equal(port, ref)
    # all but the word-1 voxel (y 28) of the last brick that fits
    gone = xyz[[0, 1, 3, 5, 6, 8, 9]]
    rxyz, _, rvalid = _padded(gone, np.zeros(len(gone), np.uint8), 1024, 7)
    ref = _ref_remove(st, ref, jnp.asarray(rxyz), jnp.asarray(rvalid))
    port = tgrid.remove_edits(st, port, _t(rxyz), _t(rvalid))
    _assert_equal(port, ref)
    last = 2 * (st.brick_alloc - 1)
    assert port.occupancy[last].item() == 0 and port.occupancy[last + 1] != 0


def test_past_alloc_bytes_follow_cell_order_over_an_older_last_brick():
    """The last brick that fits is an older one, in a cell after the two
    bricks past `brick_alloc`; a voxel of it and theirs share one address of
    its window, and the voxel last in cell order (the older brick's) keeps
    it in both packages."""
    grid, mats = _scene(rgrid.BrickGrid)
    active = int(grid.arrays.active_bricks)
    small, _ = _scene(rgrid.BrickGrid, brick_alloc=active + 1)
    st = small.static
    ref = small.device_arrays()
    port = tgrid.GridArrays.to_device(small.arrays, "cpu")
    batches = [([(40, 5, 40)], [2]),
               ([(0, 29, 60), (4, 29, 60), (40, 5, 40)], [4, 5, 6])]
    for seed, (xyz, m) in enumerate(batches):
        xyz, m, valid = _padded(np.asarray(xyz, np.int32),
                                np.asarray(m, np.uint8), 1024, seed)
        ref = _ref_apply(st, ref, jnp.asarray(xyz), jnp.asarray(m),
                         jnp.asarray(valid), *_classified(mats, True))
        port = tgrid.apply_edits(st, port, _t(xyz), _t(m), _t(valid),
                                 *_classified(mats, False))
        _assert_equal(port, ref)
    fy = st.voxel_dims[1] - 1 - 5
    start = int(port.start_indices[st.brick_alloc - 1]) & 0x7FFFFFFF
    nth = int(tgrid.voxel_at(40, fy, 40))
    assert int(port.active_bricks) == st.brick_alloc + 2
    assert int(port.material_indices[start + nth]) == 6


# -- the engine's edit path against the JAX engine's --------------------------------

def _engine_config(m):
    return m.EngineConfig(
        internal_resolution_width=32, internal_resolution_height=32,
        camera=m.CameraConfig(origin=(4.0, 6.5, 15.0), samples_per_pixel=1,
                              max_bounce=0),
        sun=m.SunConfig(enabled=False), denoiser=m.DenoiserConfig(enabled=False))


def test_engine_edit_sequence_matches_the_jax_engine():
    """Batches of 300, 1,500 and 40 voxels inserted, then removals, through
    both engines (padded to 1,024 and 2,048 lanes): arrays and cached
    records bit for bit after every batch, and one edit step a padded
    size."""
    rsc = rscenes.flat_test_scene(dim=8)
    tsc = tscenes.flat_test_scene(dim=8)
    ref = rengine.VoxelRT(rsc.grid, rsc.materials, _engine_config(rconfig))
    port = tengine.VoxelRT(tsc.grid, tsc.materials, _engine_config(tconfig),
                           device="cpu")
    # the JAX engine's records as its first frame builds them
    ref._dist = ref._dist_fn(ref.grid_static, ref.arrays, True)
    ref._tables = ref._tables_fn(ref.grid_static, ref.arrays, ref._dist)
    port.tables()
    np.testing.assert_array_equal(port._tables.numpy(),
                                  np.asarray(ref._tables))
    rng = np.random.default_rng(11)
    vx, vy, vz = port.grid_static.voxel_dims
    inserted = []
    for n in (300, 1500, 40):
        xyz = np.unique(np.stack([rng.integers(0, vx, n),
                                  rng.integers(0, vy, n),
                                  rng.integers(0, vz, n)], -1), axis=0)
        m = rng.integers(0, 9, len(xyz)).astype(np.uint8)
        for rt in (ref, port):
            rt.insert_voxels(xyz, m)
        inserted.append(xyz)
        _assert_equal(port.arrays, ref.arrays)
        np.testing.assert_array_equal(port._tables.numpy(),
                                      np.asarray(ref._tables))
    for xyz in inserted:
        for rt in (ref, port):
            rt.remove_voxels(xyz[::2])
        _assert_equal(port.arrays, ref.arrays)
        np.testing.assert_array_equal(port._tables.numpy(),
                                      np.asarray(ref._tables))
    assert sorted(port._edit_cache) == [1024, 2048]
    assert set(port._edit_cache[1024].graphs) == {
        ("insert", True), ("remove", True)}


def test_op_by_op_edits_equal_the_edit_step():
    """`insert_voxels_op_by_op` / `remove_voxels_op_by_op` run the same
    body: two engines, one through each, end bit for bit alike."""
    engines = [tengine.VoxelRT(*_scene(tgrid.BrickGrid),
                               _engine_config(tconfig), device="cpu")
               for _ in range(2)]
    xyz, m = _batch(700, 6)
    for rt in engines:
        rt.tables()
    engines[0].insert_voxels(xyz, m)
    engines[1].insert_voxels_op_by_op(xyz, m)
    engines[0].remove_voxels(xyz[::4])
    engines[1].remove_voxels_op_by_op(xyz[::4])
    a, b = (rt.arrays for rt in engines)
    for name in FIELDS:
        assert torch.equal(getattr(a, name).view(torch.uint8)
                           if name == "brick_ir" else getattr(a, name),
                           getattr(b, name).view(torch.uint8)
                           if name == "brick_ir" else getattr(b, name)), name
    assert torch.equal(engines[0]._tables, engines[1]._tables)


# -- the edit cache and the materials ------------------------------------------------

def _cache_engine():
    sc = tscenes.flat_test_scene(dim=8)
    return sc, tengine.VoxelRT(sc.grid, sc.materials,
                               _engine_config(tconfig), device="cpu")


def _voxels(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, 32, n), rng.integers(8, 16, n),
                     rng.integers(0, 32, n)], -1)


def test_edit_cache_keeps_every_size():
    """Every padded size keeps its EditStep, as the JAX engine's jit keeps
    each shape: a return to a size takes the same step and its graphs."""
    _, rt = _cache_engine()
    assert rt._padded(1) == rt._padded(1024) == 1024
    assert rt._padded(1025) == 2048 and rt._padded(5000) == 8192
    for n in (10, 1500, 3000, 5000, 9000, 17000):  # 1024 ... 32768 lanes
        rt.insert_voxels(_voxels(n), np.ones(n, np.uint8))
    sizes = [1024 << k for k in range(6)]
    assert list(rt._edit_cache) == sizes
    kept = dict(rt._edit_cache)
    rt.remove_voxels(_voxels(2500))  # 4096 lanes again
    rt.insert_voxels(_voxels(1), np.ones(1, np.uint8))
    assert list(rt._edit_cache) == sizes
    assert all(rt._edit_cache[s] is kept[s] for s in sizes)
    assert set(kept[4096].graphs) == {("insert", False),
                                      ("remove", False)}
    assert not hasattr(rt, "_EDIT_SIZES")


def test_edit_cache_kept_where_the_scene_tensors_are_rewritten():
    """The records' first build and a flush write into the tensors the
    edit graphs hold, and an empty_skip flip writes nothing: the edit
    steps and their graphs stay, and a graph key names whether the records
    are current (not before the first build and after a flush, until the
    next frame rebuilds them), not empty_skip."""
    sc, rt = _cache_engine()
    edit = (_voxels(5), np.full(5, 3, np.uint8))
    rt.insert_voxels(*edit)
    step = rt._edit_cache[1024]
    rt.tables()
    rt.insert_voxels(*edit)
    graphs = dict(step.graphs)
    assert set(graphs) == {("insert", False), ("insert", True)}
    rt.trace_config = tconfig.TraceConfig(empty_skip=False)
    rt.tables()  # empty_skip flipped: the records as they were
    rt.insert_voxels(*edit)  # the unflipped insert's graph
    assert step.graphs == graphs
    rt.flush_grid(tscenes.flat_test_scene(dim=8).grid)
    rt.insert_voxels(*edit)  # the records wait for the next frame's rebuild
    rt.tables()
    rt.insert_voxels(*edit)
    assert rt._edit_cache == {1024: step} and step.graphs == graphs
    assert step.buf.device == torch.device("cpu")


def test_push_materials_reaches_the_next_insert():
    """A material made dielectric after the first insert: the next insert,
    through the same edit step, sets its dielectric bit and brick ir."""
    sc, rt = _cache_engine()
    rt.tables()
    rt.insert_voxels([[3, 20, 3]], [5])
    step = rt._edit_cache[1024]
    table = terrain_materials()
    table.set(5, MAT_DIELECTRIC, (0.1, 0.2, 0.3), 1.25)
    rt.push_materials(table)
    rt.insert_voxels([[30, 20, 30]], [5])
    assert rt._edit_cache[1024] is step
    st, a = rt.grid_static, rt.arrays
    for x, y, z, diel in ((3, 20, 3, False), (30, 20, 30, True)):
        fy = st.voxel_dims[1] - 1 - y
        cell = int(tgrid.grid_at(st, x, fy, z))
        brick = int(a.indices[cell])
        nth = int(tgrid.voxel_at(x, fy, z))
        bit = (int(a.diel_mask[brick * 2 + nth // 32]) >> (nth % 32)) & 1
        assert bit == diel
        assert np.isnan(float(a.brick_ir[brick])) != diel
        if diel:
            assert float(a.brick_ir[brick]) == np.float32(1.25)
            assert torch.equal(rt._tables[cell], ttrace.build_trace_tables(
                st, a, rt._dist)[cell])


def test_edit_step_upload_lays_out_the_batch():
    step = tstep.EditStep(1024, "cpu")
    xyz = np.asarray([[1, 2, 3], [4, 5, 6]], np.int32)
    step.upload(xyz, np.asarray([7, 250], np.uint8))
    got, mats, live = tedit.lanes(step.buf)
    assert got.shape == (1024, 3) and mats.shape == live.shape == (1024,)
    np.testing.assert_array_equal(got[:2].numpy(), xyz)
    assert not got[2:].any() and mats[:3].tolist() == [7, 250, 0]
    assert live.sum() == 2 and live[:2].all()
    step.upload(xyz[:1])  # a removal: no materials
    assert tedit.lanes(step.buf)[2].sum() == 1 and not step.buf[3 * 1024:4 * 1024].any()
