"""Device-side voxel edits of zig_vulkan_tpu_torch against the JAX package's.

`core.grid.apply_edits`/`remove_edits` and the table refreshes of
`ops.trace` are integer computations (plus the NaN merge of the brick ir):
on the same padded batches the port reproduces the reference's arrays and
records bit for bit. The batches avoid in-batch duplicate voxels, whose
winner the reference leaves unspecified; the port's rule for them (the last
lane wins, as sequential inserts do) is held against the host's
`BrickGrid.insert_batch`.

Against a full rebuild the refreshed records are compared on the lanes
kernel A reads: every lane of a loaded cell's row, and the start and skip
lanes of an empty cell's row. The other lanes of an empty row hold brick
0's words, which the reference's refresh, like the port's, leaves as they
were when an edit changes brick 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zig_vulkan_tpu.config as rconfig
import zig_vulkan_tpu_torch.config as tconfig
from zig_vulkan_tpu.core import grid as rgrid
from zig_vulkan_tpu.core.materials import MAT_DIELECTRIC, terrain_materials
from zig_vulkan_tpu.engine import engine as rengine
from zig_vulkan_tpu.models import scenes as rscenes
from zig_vulkan_tpu.ops import trace as rtrace
from zig_vulkan_tpu.ops.tile_tracer import build_region_tables
from zig_vulkan_tpu.ops.tile_tracer import grid_hit_tiles as r_grid_hit_tiles
from zig_vulkan_tpu_torch.core import grid as tgrid
from zig_vulkan_tpu_torch.engine import engine as tengine
from zig_vulkan_tpu_torch.models import scenes as tscenes
from zig_vulkan_tpu_torch.ops import tile_tracer as ttile
from zig_vulkan_tpu_torch.ops import trace as ttrace

torch.set_num_threads(2)

_FIELDS = ("statuses", "indices", "occupancy", "start_indices",
           "material_indices", "active_bricks", "material_cursor",
           "diel_mask", "brick_ir")
GLASS = 9  # a second dielectric (ir 1.5) beside the water (material 0)


def _materials():
    mats = terrain_materials()
    mats.set(GLASS, MAT_DIELECTRIC, (0.8, 0.9, 1.0), 1.5)
    return mats


def _host_scene(grid_cls):
    """A 16x8x16-cell grid: a floor (full bricks), a water layer whose
    bricks are partly filled (some with bit 31 of a word set), and voxels
    at bit 31 and bit 63 of a loaded brick."""
    mats = _materials()
    grid = grid_cls(16, 8, 16)
    grid.attach_materials(mats)
    xs, zs = np.meshgrid(np.arange(40), np.arange(40), indexing="ij")
    for y in range(4):
        grid.insert_batch(xs.ravel(), np.full(xs.size, y), zs.ravel(),
                          np.full(xs.size, 1, dtype=np.uint8))
    wx, wz = np.meshgrid(np.arange(9, 15), np.arange(9, 15), indexing="ij")
    grid.insert_batch(wx.ravel(), np.full(wx.size, 4), wz.ravel(),
                      np.zeros(wx.size, dtype=np.uint8))
    # (3, 8, 3): voxel bit 63; (3, 10, 3): bit 31, same brick
    grid.insert_batch(np.array([3, 3]), np.array([8, 10]), np.array([3, 3]),
                      np.array([5, 6], dtype=np.uint8))
    return grid, mats


def _insert_batch():
    """Padded insert batch: int32[N, 3], uint8[N], bool[N]; no duplicates."""
    rng = np.random.default_rng(3)
    fixed = [
        ((8, 4, 8), 2),      # word 1 of a water brick that has bit 31 set
        ((11, 6, 11), 3),    # bit 31 of word 0 of that brick
        ((7, 6, 7), 4),      # bit 31 of word 0 in a floor-adjacent brick
        ((9, 5, 9), GLASS),  # glass in a water brick: ir conflict -> NaN
        ((10, 4, 10), 1),    # overwrites water: the dielectric bit clears
        ((40, 20, 40), GLASS),  # a new brick holding only glass -> 1.5
        ((44, 20, 44), 0),   # a new brick with two water voxels -> 1.333
        ((45, 21, 44), 0),
        ((3, 9, 3), 7),      # the loaded brick with bits 31 and 63
    ]
    seen = {xyz for xyz, _ in fixed}
    xyz = [xyz for xyz, _ in fixed]
    mats = [m for _, m in fixed]
    while len(xyz) < 72:
        v = (int(rng.integers(0, 64)), int(rng.integers(0, 32)),
             int(rng.integers(0, 64)))
        # random lanes stay out of the dielectric bricks of the fixed lanes
        if v in seen or (v[0] // 4, v[1] // 4, v[2] // 4) in {
                (10, 5, 10), (11, 5, 11), (2, 1, 2), (2, 2, 2)}:
            continue
        seen.add(v)
        xyz.append(v)
        mats.append(int(rng.choice([1, 2, 3, 5, 6, 8])))
    pad = 21
    xyz = np.asarray(xyz + [(0, 0, 0)] * pad, dtype=np.int32)
    xyz[-8:] = rng.integers(0, 32, (8, 3))  # garbage in padded lanes
    mats = np.asarray(mats + [GLASS] * pad, dtype=np.uint8)
    valid = np.arange(len(xyz)) < len(xyz) - pad
    return xyz, mats, valid


def _remove_batch(inserted):
    fixed = np.asarray([
        (11, 4, 11),   # bit 31 of word 1, a word with other bits
        (12, 4, 12),   # water: its dielectric bit clears
        (3, 8, 3),     # bit 63 of the loaded brick
        (0, 0, 0),     # floor
        (60, 30, 60),  # an unloaded cell: nothing happens
        (1, 9, 1),     # a loaded brick's clear bit: nothing happens
    ], dtype=np.int32)
    xyz = np.concatenate([fixed, inserted[:30:3], np.zeros((5, 3), np.int32)])
    valid = np.arange(len(xyz)) < len(xyz) - 5
    return xyz.astype(np.int32), valid


def _ref_arrays(grid):
    return grid.device_arrays()


def _port_arrays(grid):
    return tgrid.GridArrays.to_device(grid.arrays, "cpu")


def _assert_arrays_equal(port, ref):
    for name in _FIELDS:
        got = getattr(port, name)
        want = np.asarray(getattr(ref, name))
        if name == "brick_ir":
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        else:
            np.testing.assert_array_equal(
                got.numpy().view(want.dtype) if want.dtype == np.uint32
                else got.numpy(), want, err_msg=name)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ref_classification(mats):
    return jnp.asarray(mats.mtype == MAT_DIELECTRIC), jnp.asarray(mats.type_data)


def _port_classification(mats):
    return (_t(np.asarray(mats.mtype) == MAT_DIELECTRIC),
            _t(np.asarray(mats.type_data, dtype=np.float32)))


_ref_apply = jax.jit(rgrid.apply_edits, static_argnums=0)
_ref_remove = jax.jit(rgrid.remove_edits, static_argnums=0)


def _edit_both(classified=True):
    """The scene and insert batch through both packages."""
    grid, mats = _host_scene(rgrid.BrickGrid)
    st = grid.static
    xyz, m, valid = _insert_batch()
    rcls = _ref_classification(mats) if classified else ()
    tcls = _port_classification(mats) if classified else ()
    ref = _ref_apply(st, _ref_arrays(grid), jnp.asarray(xyz), jnp.asarray(m),
                     jnp.asarray(valid), *rcls)
    port = tgrid.apply_edits(st, _port_arrays(grid), _t(xyz), _t(m),
                             _t(valid), *tcls)
    return grid, st, ref, port


@pytest.mark.parametrize("classified", [True, False])
def test_apply_edits_bit_exact(classified):
    grid, st, ref, port = _edit_both(classified)
    assert int(port.active_bricks) > int(grid.arrays.active_bricks)
    assert port.active_bricks.shape == () and port.active_bricks.dtype == torch.int32
    _assert_arrays_equal(port, ref)
    if classified:
        ir = port.brick_ir.numpy()
        assert np.isnan(ir).sum() < ir.size and (ir == np.float32(1.5)).any()


def test_remove_edits_bit_exact():
    _, st, ref, port = _edit_both()
    xyz, valid = _remove_batch(_insert_batch()[0])
    ref2 = _ref_remove(st, ref, jnp.asarray(xyz), jnp.asarray(valid))
    port2 = tgrid.remove_edits(st, port, _t(xyz), _t(valid))
    _assert_arrays_equal(port2, ref2)


@pytest.mark.parametrize("package", ["reference", "port"])
def test_host_remove_then_rebuild_agrees_with_device_remove(package):
    """Host `BrickGrid.remove_batch` clears occupancy bits only, in both
    packages alike, so a removed water voxel keeps its `diel_mask` bit until
    `rebuild_dielectric_masks`; the device `remove_edits` clears both. After
    remove-then-rebuild the host agrees with the device on `occupancy` and
    `diel_mask`."""
    grid_cls = rgrid.BrickGrid if package == "reference" else tgrid.BrickGrid
    host, _ = _host_scene(grid_cls)
    st = host.static
    xyz, valid = _remove_batch(_insert_batch()[0])
    xyz = xyz[valid]  # with two water voxels: (11, 4, 11) and (12, 4, 12)
    if package == "reference":
        dev = _ref_remove(st, host.device_arrays(), jnp.asarray(xyz),
                          jnp.ones(len(xyz), bool))
    else:
        dev = tgrid.remove_edits(st, _port_arrays(host), _t(xyz),
                                 torch.ones(len(xyz), dtype=torch.bool))
    dev_occ = np.asarray(dev.occupancy).view(np.uint32)
    dev_diel = np.asarray(dev.diel_mask).view(np.uint32)

    before = host.arrays.diel_mask.copy()
    host.remove_batch(xyz[:, 0], xyz[:, 1], xyz[:, 2])
    np.testing.assert_array_equal(host.arrays.occupancy, dev_occ)
    # the gap: the host's mask is untouched, the device's lost two bits
    np.testing.assert_array_equal(host.arrays.diel_mask, before)
    stale = host.arrays.diel_mask & ~dev_diel
    assert sum(bin(int(w)).count("1") for w in stale) == 2
    host.rebuild_dielectric_masks()
    np.testing.assert_array_equal(host.arrays.diel_mask, dev_diel)
    np.testing.assert_array_equal(host.arrays.occupancy, dev_occ)
    assert dev_diel.any()  # water voxels that stayed keep their bits


def test_sign_bit_words_wrap_as_uint32():
    """Words with bit 31 set gain and lose bits exactly as uint32 words do."""
    grid, st, _, port = _edit_both()
    before = grid.arrays.occupancy
    after = port.occupancy.numpy().view(np.uint32).copy()
    sign = np.uint32(1 << 31)
    grew = np.flatnonzero((before & sign).astype(bool) & (after != before))
    assert grew.size > 0  # words holding bit 31 that gained bits
    assert ((after[grew] & before[grew]) == before[grew]).all()
    gained = np.flatnonzero(~(before & sign).astype(bool) & (after & sign).astype(bool))
    assert gained.size > 0  # words that gained bit 31
    xyz, valid = _remove_batch(_insert_batch()[0])
    cleared = tgrid.remove_edits(st, port, _t(xyz), _t(valid))
    final = cleared.occupancy.numpy().view(np.uint32)
    lost = np.flatnonzero((after & sign).astype(bool) & ~(final & sign).astype(bool))
    assert lost.size > 0  # words that lost bit 31
    assert ((final[lost] | after[lost]) == after[lost]).all()


def test_dense_materials_matches_reference():
    _, st, ref, port = _edit_both()
    want = rgrid.dense_materials(st, ref)
    got = tgrid.dense_materials(st, port)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum() > 1000


def test_in_batch_duplicates_take_the_last_lane():
    """A voxel given twice takes its last lane's material and dielectric
    bit, as `BrickGrid.insert_batch`'s sequential order does."""
    grid, mats = _host_scene(tgrid.BrickGrid)
    st = grid.static
    arrays = _port_arrays(grid)
    xyz = np.asarray([(20, 20, 20), (21, 20, 20), (20, 20, 20), (9, 4, 9),
                      (9, 4, 9), (30, 3, 30), (30, 3, 30)], dtype=np.int32)
    # the dielectric lane first: `BrickGrid.insert_batch` clears a
    # dielectric bit that any lane of the batch overwrites
    m = np.asarray([1, 2, 5, 0, 3, 0, 6], dtype=np.uint8)
    out = tgrid.apply_edits(st, arrays, _t(xyz), _t(m),
                            torch.ones(len(xyz), dtype=torch.bool),
                            *_port_classification(mats))
    grid.insert_batch(xyz[:, 0], xyz[:, 1], xyz[:, 2], m)
    np.testing.assert_array_equal(tgrid.dense_materials(st, out).numpy(),
                                  tgrid.dense_materials(st, grid.arrays).numpy())
    np.testing.assert_array_equal(out.diel_mask.numpy().view(np.uint32),
                                  grid.arrays.diel_mask)


def _tables_both():
    grid, mats = _host_scene(rgrid.BrickGrid)
    st = grid.static
    rarr = _ref_arrays(grid)
    rtab = rtrace.build_trace_tables(st, rarr, rtrace.distance_field(
        st, rarr, exact=True))
    return grid, mats, st, rtab


def _read_lanes(tables):
    """The records with the lanes kernel A never reads zeroed: an empty
    row's occupancy, dielectric and ir lanes, and lane 7."""
    t = torch.as_tensor(np.asarray(tables)).clone()
    empty = t[:, 0] == -1
    t[empty, 1:3] = 0
    t[empty, 4:7] = 0
    t[:, 7] = 0
    return t.numpy()


def _cells(st, xyz):
    fy = (st.voxel_dims[1] - 1) - xyz[:, 1]
    return (xyz[:, 0] // 4 + st.dim_x * ((xyz[:, 2] // 4)
                                         + st.dim_z * (fy // 4))).astype(np.int32)


@pytest.mark.parametrize("against", ["reference", "full_rebuild"])
def test_refresh_after_insert(against):
    grid, mats, st, rtab = _tables_both()
    xyz, m, valid = _insert_batch()
    cells = _cells(st, xyz)
    tarr = tgrid.apply_edits(st, _port_arrays(grid), _t(xyz), _t(m),
                             _t(valid), *_port_classification(mats))
    tables = torch.from_numpy(np.array(rtab))
    got, dist = ttrace.refresh_tables_after_insert(st, tarr, tables,
                                                   _t(cells), _t(valid))
    assert got is tables  # in place
    if against == "reference":
        rarr = _ref_apply(st, _ref_arrays(grid), jnp.asarray(xyz),
                          jnp.asarray(m), jnp.asarray(valid),
                          *_ref_classification(mats))
        want, want_dist = rtrace.refresh_tables_after_insert(
            st, rarr, rtab, jnp.asarray(cells), jnp.asarray(valid))
        np.testing.assert_array_equal(dist.numpy(), np.asarray(want_dist))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        want = ttrace.build_trace_tables(st, tarr,
                                         ttrace.distance_field(st, tarr))
        np.testing.assert_array_equal(_read_lanes(got), _read_lanes(want))


@pytest.mark.parametrize("against", ["reference", "full_rebuild"])
def test_refresh_after_remove(against):
    grid, mats, st, rtab = _tables_both()
    ixyz, m, ivalid = _insert_batch()
    rxyz, rvalid = _remove_batch(ixyz)
    tarr = tgrid.apply_edits(st, _port_arrays(grid), _t(ixyz), _t(m),
                             _t(ivalid), *_port_classification(mats))
    tables, dist = ttrace.refresh_tables_after_insert(
        st, tarr, torch.from_numpy(np.array(rtab)), _t(_cells(st, ixyz)),
        _t(ivalid))
    tarr = tgrid.remove_edits(st, tarr, _t(rxyz), _t(rvalid))
    got = ttrace.refresh_tables_after_remove(st, tarr, tables, dist,
                                             _t(_cells(st, rxyz)), _t(rvalid))
    if against == "reference":
        rarr = _ref_apply(st, _ref_arrays(grid), jnp.asarray(ixyz),
                          jnp.asarray(m), jnp.asarray(ivalid),
                          *_ref_classification(mats))
        rtab2, rdist = rtrace.refresh_tables_after_insert(
            st, rarr, rtab, jnp.asarray(_cells(st, ixyz)), jnp.asarray(ivalid))
        rarr = _ref_remove(st, rarr, jnp.asarray(rxyz), jnp.asarray(rvalid))
        want = rtrace.refresh_tables_after_remove(
            st, rarr, rtab2, rdist, jnp.asarray(_cells(st, rxyz)),
            jnp.asarray(rvalid))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        want = ttrace.build_trace_tables(st, tarr, dist)
        np.testing.assert_array_equal(_read_lanes(got), _read_lanes(want))


# -- the engine ------------------------------------------------------------------

def _parity_scene(scenes):
    """tests/test_trace_parity.py's water pool + metal pillar scene."""
    sc = scenes.flat_test_scene(dim=8)
    xs, zs = np.meshgrid(np.arange(6, 16), np.arange(6, 16), indexing="ij")
    sc.grid.insert_batch(xs.ravel(), np.full(xs.size, 4), zs.ravel(),
                         np.zeros(xs.size, dtype=np.uint8))
    ys = np.arange(4, 12)
    sc.grid.insert_batch(np.full(ys.size, 20), ys, np.full(ys.size, 20),
                         np.full(ys.size, 7, dtype=np.uint8))
    return sc


def _primary_config(m):
    return m.EngineConfig(
        internal_resolution_width=48, internal_resolution_height=48,
        camera=m.CameraConfig(origin=(4.0, 6.5, 15.0), samples_per_pixel=1,
                              max_bounce=0),
        sun=m.SunConfig(enabled=False), denoiser=m.DenoiserConfig(enabled=False))


def test_engine_edits_match_reference():
    """The same inserts and removals through both engines: scene arrays
    and cached records bit for bit, and the primary frame after each."""
    rsc, tsc = _parity_scene(rscenes), _parity_scene(tscenes)
    ref = rengine.VoxelRT(rsc.grid, rsc.materials, _primary_config(rconfig))
    port = tengine.VoxelRT(tsc.grid, tsc.materials, _primary_config(tconfig),
                           device="cpu")
    np.testing.assert_allclose(port.render().numpy(), np.asarray(ref.render()),
                               atol=1e-5, rtol=0)
    # a block in front of the camera and a scatter of single voxels, all in
    # the floor's region (the reference's step cache keys on roamability)
    xs, ys, zs = np.meshgrid(np.arange(8, 16), np.arange(5, 12),
                             np.arange(22, 24), indexing="ij")
    block = np.stack([xs.ravel(), ys.ravel(), zs.ravel()], -1)
    rng = np.random.default_rng(5)
    spray = np.stack([rng.integers(0, 32, 40), rng.integers(0, 16, 40),
                      rng.integers(0, 32, 40)], -1)
    xyz = np.unique(np.concatenate([block, spray]), axis=0).astype(np.int32)
    m = rng.integers(0, 8, len(xyz)).astype(np.uint8)
    for rt in (ref, port):
        rt.insert_voxels(xyz, m)
    _assert_arrays_equal(port.arrays, ref.arrays)
    np.testing.assert_array_equal(port._tables.numpy(), np.asarray(ref._tables))
    after_insert = port.render().numpy()
    np.testing.assert_allclose(after_insert, np.asarray(ref.render()),
                               atol=1e-5, rtol=0)
    for rt in (ref, port):
        rt.remove_voxels(xyz[::2])
    _assert_arrays_equal(port.arrays, ref.arrays)
    np.testing.assert_array_equal(port._tables.numpy(), np.asarray(ref._tables))
    after_remove = port.render().numpy()
    np.testing.assert_allclose(after_remove, np.asarray(ref.render()),
                               atol=1e-5, rtol=0)
    assert not np.array_equal(after_insert, after_remove)
    assert not port._scene_degraded() and not ref._scene_degraded()


def _small_engine(grid, mats):
    return tengine.VoxelRT(grid, mats, _primary_config(tconfig), device="cpu")


def test_engine_insert_exhaustion_raises():
    grid = tgrid.BrickGrid(8, 8, 8, tconfig.GridConfig(brick_alloc=2))
    mats = terrain_materials()
    grid.attach_materials(mats)
    grid.insert(0, 0, 0, 1)  # one brick used on the host
    rt = _small_engine(grid, mats)
    rt.insert_voxels(np.asarray([[8, 8, 8]]), np.asarray([1], np.uint8))
    assert int(rt.arrays.active_bricks) == 2
    before = tgrid.dense_materials(rt.grid_static, rt.arrays).clone()
    with pytest.raises(MemoryError):
        rt.insert_voxels(np.asarray([[16, 16, 16], [24, 24, 24]]),
                         np.asarray([1, 1], np.uint8))
    # the rejected batch changed nothing; a batch into loaded bricks fits
    assert torch.equal(tgrid.dense_materials(rt.grid_static, rt.arrays), before)
    rt.insert_voxels(np.asarray([[9, 9, 9]]), np.asarray([3], np.uint8))
    assert int(rt.arrays.active_bricks) == 2


def test_engine_rejects_voxels_outside_the_grid():
    sc = _parity_scene(tscenes)
    rt = _small_engine(sc.grid, sc.materials)
    with pytest.raises(IndexError):
        rt.insert_voxels(np.asarray([[0, 0, 32]]), np.asarray([1], np.uint8))
    with pytest.raises(IndexError):
        rt.remove_voxels(np.asarray([[-1, 0, 0]]))


@pytest.mark.parametrize("scene", ["parity", "default_32x16x32"])
def test_region_occupancy_matches_reference(scene):
    sc = (_parity_scene(tscenes) if scene == "parity"
          else tscenes.default_scene(dims=(32, 16, 32)))
    st = sc.grid.static
    statuses = sc.grid.arrays.statuses
    assert (tengine._region_occupancy(st, statuses)
            == rengine._region_occupancy(st, statuses))
    cells = np.arange(st.cells)
    np.testing.assert_array_equal(tengine._regions_of_cells(st, cells),
                                  rengine._regions_of_cells(st, cells))


def test_engine_degraded_fraction_after_a_spray():
    """The engine's mirror after inserts equals the reference's region
    count over the edited scene's status bits."""
    sc = tscenes.default_scene(dims=(32, 16, 32))
    rt = _small_engine(sc.grid, sc.materials)
    st = rt.grid_static
    n0 = rengine._region_occupancy(st, sc.grid.arrays.statuses)
    assert rt.nonempty_region_fraction() == len(n0[1]) / n0[0]
    assert not rt._scene_degraded()
    rng = np.random.default_rng(0)
    vx, vy, vz = st.voxel_dims
    xyz = np.stack([rng.integers(0, vx, 512), rng.integers(0, vy, 512),
                    rng.integers(0, vz, 512)], -1)
    rt.insert_voxels(xyz, rng.integers(1, 8, 512).astype(np.uint8))
    n, nonempty = rengine._region_occupancy(
        st, rt.arrays.statuses.numpy().view(np.uint32))
    assert rt.nonempty_region_fraction() == len(nonempty) / n
    assert rt._scene_degraded()


def test_twin_matches_sparse_roam_kernel():
    """The TPU kernel's sparse_roam build (interpret mode) on the sprayed
    scene against the port's traversal twin, at that kernel's own test
    tolerance (tests/test_tile_tracer.py:300-306)."""
    from test_tile_tracer import _rays, sprayed_scene

    grid, _ = sprayed_scene()
    st = grid.static
    arrays = grid.device_arrays()
    tables = rtrace.build_trace_tables(st, arrays)
    blocks = build_region_tables(st, arrays, tables)
    # half the tile: that test's camera rays; half: rays from the same
    # point aimed at sprayed voxels, so that many lanes hit
    ro, rd = _rays(st, (16.0, 16.0, 16.0))
    x, y, z = np.nonzero(rgrid.dense_materials(st, arrays) >= 0)
    pick = np.random.default_rng(1).choice(x.size, 512)
    fy = st.voxel_dims[1] - 1 - y[pick]
    target = ((np.stack([x[pick], fy, z[pick]], -1) + 0.5) * st.voxel_scale
              + np.asarray(st.min_point)).astype(np.float32)
    aim = target - ro[512:]
    rd[512:] = aim / np.linalg.norm(aim, axis=-1, keepdims=True)
    n = ro.shape[0]
    assert n == 1024
    want = r_grid_hit_tiles(
        st, arrays, blocks, *(jnp.asarray(ro[:, i]) for i in range(3)),
        *(jnp.asarray(rd[:, i]) for i in range(3)), jnp.ones(n, bool),
        max_phases=256, interpret=True, sparse_roam=True)
    assert not np.asarray(want["unfinished"]).any()
    tarr = tgrid.GridArrays.to_device(grid.arrays, "cpu")
    got = ttile.grid_hit_tiles(
        st, ttrace.build_trace_tables(st, tarr), tarr.material_indices,
        *(_t(ro[:, i]) for i in range(3)), *(_t(rd[:, i]) for i in range(3)),
        torch.ones(n, dtype=torch.bool))
    f_w, f_g = np.asarray(want["found"]), got["found"].numpy()
    assert (f_w == f_g).mean() > 0.99
    both = f_w & f_g
    assert both.sum() > 100
    np.testing.assert_allclose(got["t"].numpy()[both],
                               np.asarray(want["t"])[both], atol=5e-2)


def test_engine_flush_and_material_pushes():
    """flush_grid re-uploads a host grid (records rebuilt with the exact
    field on the next frame, bounds and region mirror reset);
    push_materials / push_albedo replace the device material table."""
    sc = _parity_scene(tscenes)
    rt = _small_engine(sc.grid, sc.materials)
    rt.render()
    rt.insert_voxels(np.asarray([[2, 30, 2]]), np.asarray([3], np.uint8))
    assert rt._scene_degraded()
    fresh = _parity_scene(tscenes)
    tables = rt._tables
    rt.flush_grid(fresh.grid)
    # the records wait for the next frame's rebuild, into their tensors
    assert not rt._records_current and rt._tables is tables
    assert not rt._scene_degraded()
    assert rt._bricks_upper == int(fresh.grid.arrays.active_bricks)
    np.testing.assert_array_equal(
        tgrid.dense_materials(rt.grid_static, rt.arrays).numpy(),
        tgrid.dense_materials(fresh.grid.static, fresh.grid.arrays).numpy())
    want = ttrace.build_trace_tables(
        rt.grid_static, rt.arrays,
        ttrace.distance_field(rt.grid_static, rt.arrays, exact=True))
    assert torch.equal(rt.tables(), want) and rt._tables is tables
    with pytest.raises(ValueError):
        rt.flush_grid(tgrid.BrickGrid(4, 4, 4))

    rt.push_albedo(5, (0.25, 0.5, 1.0))
    np.testing.assert_array_equal(rt.mats[:3, 5].numpy(),
                                  np.float32([0.25, 0.5, 1.0]))
    table = terrain_materials()
    table.set(5, MAT_DIELECTRIC, (0.1, 0.2, 0.3), 1.5)
    rt.push_materials(table)
    assert rt.materials_host is table
    np.testing.assert_array_equal(
        rt.mats.numpy(), ttrace.materials_to_device(table, "cpu").numpy())
