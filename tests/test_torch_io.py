"""Host I/O of zig_vulkan_tpu_torch against the JAX package's.

- `io.image`: the same PNG and PPM bytes for the same image.
- `io.scene_io`: one .npz format. A scene saved by the port (from the
  engine's device arrays, int32 bit views) loads in the JAX package, and
  the reverse, with every array equal; the keys and dtypes are the same.
- `models.scenes.cached_default_scene`: hit, miss and stale version, and a
  cache written by one package is a hit in the other.
- `io.streaming`: the same terrain streamed through the port's engine and
  through the JAX engine decodes to the same scene, which is the batch
  build's.
- `io.native_builder`: the port's ctypes bridge over native/gridbuilder.cpp
  builds the numpy builder's scene (skipped without g++).
- `utils.validation` and `utils.profiling`, and the engine's
  `debug_validation` hook.
"""

import dataclasses

import numpy as np
import pytest
import torch

from zig_vulkan_tpu.config import (
    CameraConfig as RCameraConfig,
    DenoiserConfig as RDenoiserConfig,
    EngineConfig as REngineConfig,
    GridConfig as RGridConfig,
    SunConfig as RSunConfig,
)
from zig_vulkan_tpu.core.grid import BrickGrid as RBrickGrid
from zig_vulkan_tpu.core.grid import dense_materials as rdense
from zig_vulkan_tpu.engine.engine import VoxelRT as RVoxelRT
from zig_vulkan_tpu.io import image as rimage
from zig_vulkan_tpu.io import scene_io as rscene_io
from zig_vulkan_tpu.io import streaming as rstreaming
from zig_vulkan_tpu.models import scenes as rscenes
from zig_vulkan_tpu_torch import config as tconfig
from zig_vulkan_tpu_torch.core.grid import BrickGrid, dense_materials
from zig_vulkan_tpu_torch.engine.engine import VoxelRT
from zig_vulkan_tpu_torch.io import image as timage
from zig_vulkan_tpu_torch.io import native_builder
from zig_vulkan_tpu_torch.io import scene_io as tscene_io
from zig_vulkan_tpu_torch.io import streaming as tstreaming
from zig_vulkan_tpu_torch.io import terrain as tterrain
from zig_vulkan_tpu_torch.models import scenes as tscenes
from zig_vulkan_tpu_torch.utils import profiling, validation

torch.set_num_threads(2)

_ARRAY_FIELDS = ("statuses", "indices", "occupancy", "start_indices",
                 "material_indices", "active_bricks", "material_cursor",
                 "diel_mask", "brick_ir")


def _small_engine(scene, **cfg):
    kw = dict(internal_resolution_width=16, internal_resolution_height=16,
              camera=tconfig.CameraConfig(origin=(4.0, 6.5, 15.0),
                                          samples_per_pixel=1, max_bounce=1),
              sun=tconfig.SunConfig(enabled=False),
              denoiser=tconfig.DenoiserConfig(enabled=False))
    kw.update(cfg)
    return VoxelRT(scene.grid, scene.materials, tconfig.EngineConfig(**kw),
                   device="cpu")


def _edited_engine():
    """A port engine whose scene was edited on the device (inserts of
    dielectric and other voxels, removals)."""
    sc = tscenes.flat_test_scene(dim=8)
    rt = _small_engine(sc)
    rng = np.random.default_rng(7)
    vx, vy, vz = rt.grid_static.voxel_dims
    xyz = np.stack([rng.integers(0, vx, 300), rng.integers(0, vy, 300),
                    rng.integers(0, vz, 300)], -1)
    rt.insert_voxels(xyz, rng.integers(0, 8, 300).astype(np.uint8))
    rt.remove_voxels(xyz[::5])
    return rt


def _u32(t):
    return t.numpy().view(np.uint32) if t.dtype == torch.int32 else t.numpy()


def _bytes(a):
    """The raw bytes of an array (0-d included), for bit-for-bit checks
    that also hold for NaN."""
    return np.atleast_1d(np.asarray(a)).view(np.uint8)


# -- io.image -------------------------------------------------------------------

def test_png_and_ppm_bytes_equal_reference(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.uniform(-0.1, 1.1, size=(9, 13, 3)).astype(np.float32)
    np.testing.assert_array_equal(timage.to_uint8(img), rimage.to_uint8(img))
    for ext, t_fn, r_fn in (("png", timage.write_png, rimage.write_png),
                            ("ppm", timage.write_ppm, rimage.write_ppm)):
        t_fn(str(tmp_path / f"t.{ext}"), img)
        r_fn(str(tmp_path / f"r.{ext}"), img)
        assert ((tmp_path / f"t.{ext}").read_bytes()
                == (tmp_path / f"r.{ext}").read_bytes())
    np.testing.assert_array_equal(timage.read_ppm(str(tmp_path / "r.ppm")),
                                  timage.to_uint8(img))


def test_read_ppm_rejects_other_formats(tmp_path):
    p = tmp_path / "x.ppm"
    p.write_bytes(b"P3\n1 1\n255\n0 0 0\n")
    with pytest.raises(ValueError, match="P6"):
        timage.read_ppm(str(p))


# -- io.scene_io ------------------------------------------------------------------

def test_port_save_loads_in_reference(tmp_path):
    rt = _edited_engine()
    path = str(tmp_path / "port.npz")
    rt.save_scene(path)
    grid, mats = rscene_io.load_scene(path)
    assert dataclasses.astuple(grid.static) == dataclasses.astuple(
        rt.grid_static)
    for f in _ARRAY_FIELDS:
        got = np.asarray(getattr(grid.arrays, f))
        want = _u32(getattr(rt.arrays, f))
        if f == "brick_ir":
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)
    for f in ("mtype", "albedo", "type_data"):
        np.testing.assert_array_equal(getattr(mats, f),
                                      getattr(rt.materials_host, f))


def test_reference_save_loads_in_port(tmp_path):
    sc = rscenes.flat_test_scene(dim=8)
    rng = np.random.default_rng(8)
    sc.grid.insert_batch(rng.integers(0, 32, 200), rng.integers(0, 32, 200),
                         rng.integers(0, 32, 200),
                         rng.integers(0, 8, 200).astype(np.uint8))
    path = str(tmp_path / "ref.npz")
    rscene_io.save_scene(path, sc.grid.static, sc.grid.arrays, sc.materials)
    grid, mats = tscene_io.load_scene(path)
    assert dataclasses.astuple(grid.static) == dataclasses.astuple(
        sc.grid.static)
    for f in _ARRAY_FIELDS:
        got, want = getattr(grid.arrays, f), getattr(sc.grid.arrays, f)
        assert np.asarray(got).dtype == np.asarray(want).dtype, f
        np.testing.assert_array_equal(_bytes(got), _bytes(want), err_msg=f)
    # the loaded grid keeps maintaining the dielectric masks on inserts
    np.testing.assert_array_equal(grid._mat_is_diel, mats.mtype == 2)
    # and renders in the port's engine
    rt = VoxelRT(grid, mats, tconfig.EngineConfig(
        internal_resolution_width=16, internal_resolution_height=16),
        device="cpu")
    assert bool(torch.isfinite(rt.render()).all())


def test_file_format_keys_and_dtypes_equal_reference(tmp_path):
    rt = _edited_engine()
    rt.save_scene(str(tmp_path / "port.npz"))
    host = dataclasses.replace(
        rt.arrays, **{f: _u32(getattr(rt.arrays, f)) for f in _ARRAY_FIELDS})
    rscene_io.save_scene(str(tmp_path / "ref.npz"), rt.grid_static, host,
                         rt.materials_host)
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "ref.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(_bytes(a[k]), _bytes(b[k]),
                                          err_msg=k)
        for k in ("statuses", "indices", "occupancy", "start_indices",
                  "diel_mask", "active_bricks", "material_cursor"):
            assert a[k].dtype == np.uint32, k
        assert a["brick_ir"].dtype == np.float32
        assert a["material_indices"].dtype == np.uint8
        for k in ("min_point", "scale", "base_t"):
            assert a[k].dtype == np.float64, k


def test_save_load_flush_round_trip_renders_the_same_frame(tmp_path):
    """The edited scene saved, loaded and flushed back: the same device
    arrays, and the same frame. The frames are traced with the exact DDA,
    which reads the scene arrays only (the skip field of an edited scene is
    the conservative one, which a reload replaces with the exact one)."""
    rt = _edited_engine()
    rt.trace_config = tconfig.TraceConfig(empty_skip=False)
    before = rt.render()
    arrays = rt.arrays
    path = str(tmp_path / "s.npz")
    rt.save_scene(path)
    grid, _ = tscene_io.load_scene(path)
    rt.flush_grid(grid)
    for f in _ARRAY_FIELDS:
        assert torch.equal(getattr(rt.arrays, f).reshape(-1).view(torch.uint8),
                           getattr(arrays, f).reshape(-1).view(torch.uint8)), f
    assert torch.equal(rt.render(), before)


# -- models.scenes.cached_default_scene ------------------------------------------

_DEFAULT_SCENE = tscenes.default_scene


def _small_default(**_):
    return _DEFAULT_SCENE(dims=(8, 4, 8))


def test_cached_default_scene_miss_hit_and_stale(tmp_path, monkeypatch,
                                                 capsys):
    path = str(tmp_path / "cache.npz")
    monkeypatch.setattr(tscenes, "default_scene", _small_default)
    built = tscenes.cached_default_scene(path)              # miss: build
    with np.load(path) as z:
        assert int(z["cache_version"]) == tscenes.SCENE_CACHE_VERSION

    def no_build(**_):
        raise AssertionError("a cache hit must not rebuild")

    monkeypatch.setattr(tscenes, "default_scene", no_build)
    hit = tscenes.cached_default_scene(path)                # hit: load
    for f in _ARRAY_FIELDS:
        np.testing.assert_array_equal(_bytes(getattr(hit.grid.arrays, f)),
                                      _bytes(getattr(built.grid.arrays, f)))
    assert hit.grid.static == built.grid.static

    monkeypatch.setattr(tscenes, "default_scene", _small_default)
    again = tscenes.cached_default_scene(path, version=2)  # stale: rebuild
    assert "stale" in capsys.readouterr().err
    with np.load(path) as z:
        assert int(z["cache_version"]) == 2
    assert again.grid.static == built.grid.static

    (tmp_path / "bad.npz").write_bytes(b"not a zip")
    tscenes.cached_default_scene(str(tmp_path / "bad.npz"))
    assert "unreadable" in capsys.readouterr().err


def test_cache_is_shared_with_reference(tmp_path, monkeypatch):
    path = str(tmp_path / "cache.npz")
    monkeypatch.setattr(tscenes, "default_scene", _small_default)
    port = tscenes.cached_default_scene(path)

    def no_build(**_):
        raise AssertionError("a cache hit must not rebuild")

    monkeypatch.setattr(rscenes, "default_scene", no_build)
    ref = rscenes.cached_default_scene(path)
    np.testing.assert_array_equal(rdense(ref.grid.static, ref.grid.arrays),
                                  dense_materials(port.grid.static,
                                                  port.grid.arrays).numpy())


# -- io.streaming -----------------------------------------------------------------

def test_streamed_terrain_equals_reference_engine_and_batch_build():
    dims = (8, 4, 8)
    ref_grid = BrickGrid(*dims)
    tterrain.generate(ref_grid, seed=5, scale=4.0, ocean_level=4)

    mats = tscenes.flat_test_scene(dim=8).materials
    rt = VoxelRT(BrickGrid(*dims), mats, tconfig.EngineConfig(
        internal_resolution_width=16, internal_resolution_height=16,
        camera=tconfig.CameraConfig(origin=(4.0, 6.5, 15.0),
                                    samples_per_pixel=1, max_bounce=0),
        sun=tconfig.SunConfig(enabled=False),
        denoiser=tconfig.DenoiserConfig(enabled=False)), device="cpu")
    seen = []
    total = tstreaming.stream_into_engine(
        rt, tstreaming.terrain_regions(BrickGrid(*dims), seed=5, scale=4.0,
                                       ocean_level=4, region_x=8),
        draw_between=True, max_batch=1024, progress=seen.append)
    assert total > 1024 and seen[-1] == total and len(seen) == 4

    rsc = rscenes.flat_test_scene(dim=8)
    rrt = RVoxelRT(RBrickGrid(*dims, RGridConfig()), rsc.materials,
                   REngineConfig(
                       internal_resolution_width=16,
                       internal_resolution_height=16,
                       camera=RCameraConfig(origin=(4.0, 6.5, 15.0),
                                            samples_per_pixel=1, max_bounce=0),
                       sun=RSunConfig(enabled=False),
                       denoiser=RDenoiserConfig(enabled=False)))
    rtotal = rstreaming.stream_into_engine(
        rrt, rstreaming.terrain_regions(RBrickGrid(*dims), seed=5, scale=4.0,
                                        ocean_level=4, region_x=8),
        max_batch=1024)
    assert rtotal == total

    got = dense_materials(rt.grid_static, rt.arrays).numpy()
    want = dense_materials(ref_grid.static, ref_grid.arrays).numpy()
    np.testing.assert_array_equal(got, want)
    from zig_vulkan_tpu.core.grid import GridArrays as RGridArrays

    ra = RGridArrays(**{f: np.asarray(getattr(rrt.arrays, f))
                        for f in _ARRAY_FIELDS})
    np.testing.assert_array_equal(got, rdense(rrt.grid_static, ra))
    # the streamed records were refreshed after every batch
    st = rt.grid_static
    from zig_vulkan_tpu_torch.ops import trace as ttrace

    full = ttrace.build_trace_tables(st, rt.arrays,
                                     ttrace.distance_field(st, rt.arrays))
    live = full[:, 0] != -1
    assert torch.equal(rt.tables()[live], full[live])
    validation.validate_scene(st, rt.arrays)


def test_terrain_regions_equal_reference():
    g, rg = BrickGrid(8, 4, 8), RBrickGrid(8, 4, 8)
    got = list(tstreaming.terrain_regions(g, seed=9, region_x=12))
    want = list(rstreaming.terrain_regions(rg, seed=9, region_x=12))
    assert len(got) == len(want) > 1
    for (gx, gm), (wx, wm) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gm, wm)


# -- io.native_builder -------------------------------------------------------------

@pytest.fixture(scope="module")
def native():
    if not native_builder.native_available():
        pytest.skip("no native toolchain (g++)")
    return native_builder


def test_native_insert_batch_matches_numpy(native):
    rng = np.random.default_rng(0)
    n = 2000
    xs = rng.integers(0, 32, n)
    ys = rng.integers(0, 16, n)
    zs = rng.integers(0, 32, n)
    # de-duplicate voxels: multithreaded last-writer order is unordered
    _, keep = np.unique(xs * 10000 + ys * 100 + zs, return_index=True)
    xs, ys, zs = xs[keep], ys[keep], zs[keep]
    ms = rng.integers(1, 255, xs.size).astype(np.uint8)
    ref = BrickGrid(8, 4, 8)
    ref.insert_batch(xs, ys, zs, ms)
    nat = native.NativeGridBuilder(8, 4, 8,
                                   tconfig.GridConfig(workers_count=4))
    assert nat.insert_batch(xs, ys, zs, ms) == xs.size
    got = nat.finish()
    assert isinstance(got, BrickGrid)
    assert int(got.arrays.active_bricks) == int(ref.arrays.active_bricks)
    np.testing.assert_array_equal(got.arrays.statuses, ref.arrays.statuses)
    assert torch.equal(dense_materials(got.static, got.arrays),
                       dense_materials(ref.static, ref.arrays))
    with pytest.raises(ValueError, match="length"):
        native.NativeGridBuilder(8, 4, 8).insert_batch(xs, ys[:-1], zs, ms)


def test_native_terrain_matches_numpy_and_dielectrics(native):
    sc = tscenes.flat_test_scene(dim=8)
    ref = BrickGrid(16, 8, 16)
    ref.attach_materials(sc.materials)
    tterrain.generate(ref, seed=11, scale=4.0, ocean_level=10)
    nat = native.NativeGridBuilder(16, 8, 16)
    nat._grid.attach_materials(sc.materials)
    nat.generate_terrain(seed=11, scale=4.0, ocean_level=10)
    got = nat.finish()
    assert torch.equal(dense_materials(got.static, got.arrays),
                       dense_materials(ref.static, ref.arrays))
    # the dielectric masks rebuilt from the exported arrays mark the same
    # (water) voxels as the numpy builder's incremental masks
    assert int(np.unpackbits(got.arrays.diel_mask.view(np.uint8)).sum()) == \
        int(np.unpackbits(ref.arrays.diel_mask.view(np.uint8)).sum()) > 0
    validation.validate_scene(got.static, got.arrays)


def test_native_library_lives_in_the_package(native):
    assert native._build_library().parent.name == "build"
    assert native._build_library().parent.parent.name == "zig_vulkan_tpu_torch"


# -- utils.validation ---------------------------------------------------------------

def test_validate_scene_accepts_good_scenes():
    sc = tscenes.flat_test_scene(dim=8)
    validation.validate_scene(sc.grid.static, sc.grid.arrays)
    validation.validate_scene(sc.grid.static, sc.grid.arrays.to_device("cpu"))
    rt = _edited_engine()
    validation.validate_scene(rt.grid_static, rt.arrays)


@pytest.mark.parametrize("corrupt", ["unaligned_window", "window_unset",
                                     "too_many_bricks", "cursor_unaligned",
                                     "dangling_index"])
def test_validate_scene_catches_corruption(corrupt):
    sc = tscenes.flat_test_scene(dim=8)
    a = sc.grid.arrays
    if corrupt == "unaligned_window":
        a.start_indices[0] = np.uint32(7)  # tests/test_validation_streaming.py
    elif corrupt == "window_unset":
        a.start_indices[0] = np.uint32(0xFFFFFFFF)
    elif corrupt == "too_many_bricks":
        a.active_bricks = np.uint32(sc.grid.static.brick_alloc + 1)
    elif corrupt == "cursor_unaligned":
        a.material_cursor = np.uint32(int(a.material_cursor) + 3)
    else:
        a.indices[0] = np.uint32(int(a.active_bricks) + 5)
        a.statuses[0] |= np.uint32(1)
    with pytest.raises(validation.SceneValidationError):
        validation.validate_scene(sc.grid.static, a)
    # the device (int32 bit view) arrays fail the same way
    with pytest.raises(validation.SceneValidationError):
        validation.validate_scene(sc.grid.static, a.to_device("cpu"))


def test_check_image_on_tensors():
    validation.check_image(torch.zeros(4, 4, 3))
    validation.check_image(np.ones((4, 4, 3), np.float32))
    for bad in (torch.full((4, 4, 3), float("nan")),
                torch.full((4, 4, 3), float("inf")),
                torch.full((4, 4, 3), 1.5)):
        with pytest.raises(validation.SceneValidationError):
            validation.check_image(bad)


def test_debug_validation_checks_every_frame(monkeypatch):
    sc = tscenes.flat_test_scene(dim=8)
    try:
        rt = _small_engine(sc, debug_validation=True)
        assert validation.debug_mode_enabled()
        assert bool(torch.isfinite(rt.draw()).all())
        monkeypatch.setattr(rt, "_render",
                            lambda tables: torch.full((16, 16, 3),
                                                      float("nan")))
        with pytest.raises(validation.SceneValidationError):
            rt.render()
    finally:
        validation.disable_debug_mode()
    assert not validation.debug_mode_enabled()
    rt.render()  # the check is off again


def test_debug_validation_rejects_a_corrupt_scene():
    sc = tscenes.flat_test_scene(dim=8)
    sc.grid.arrays.start_indices[0] = np.uint32(7)
    try:
        with pytest.raises(validation.SceneValidationError):
            _small_engine(sc, debug_validation=True)
    finally:
        validation.disable_debug_mode()


# -- utils.profiling -----------------------------------------------------------------

def test_zones_are_no_ops_unless_enabled():
    assert not profiling.enabled()
    with profiling.zone("draw"):
        pass
    profiling.count("edit_lanes", 3)
    rt = _small_engine(tscenes.flat_test_scene(dim=8))
    try:
        profiling.enable()
        assert profiling.snapshot()["zones"] == {}
        rt.draw()
    finally:
        profiling.enable(False)
    snap = profiling.snapshot()
    assert set(snap["zones"]) == {"build_tables", "step_lookup",
                                  "push_constants", "render_step",
                                  "device_sync", "draw"}
    # the records' first build, and the frame's kernel A and kernel D
    # launches: two levels without the sun, the second queued; the first
    # frame is a key switch (from none), to a step it built
    assert snap["counters"] == {"host_waits": 1, "trace_launches": 2,
                                "trace_queued": 1, "shade_launches": 2,
                                "shade_queued": 1, "key_switches": 1,
                                "key_returns": 0}


def test_trace_session_writes_the_zones(tmp_path):
    import json

    rt = _small_engine(tscenes.flat_test_scene(dim=8))
    with profiling.trace_session(str(tmp_path)):
        assert profiling.enabled()
        rt.draw()
    assert not profiling.enabled()
    trace = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"draw", "render_step", "device_sync", "build_tables"} <= names
