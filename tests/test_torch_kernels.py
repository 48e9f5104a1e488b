"""zig_vulkan_tpu_torch's CUDA kernels against their plain torch versions.

This file imports no JAX, so it also runs on a machine with a GPU and no
JAX: `python -m pytest --noconftest tests/test_torch_kernels.py` (the
suite's conftest.py imports JAX). The tests marked
`cuda` build csrc/*.cu with nvcc and compare kernel A (traversal; its
default, shadow and stats builds) and kernel B (material lookup) with their
plain versions on the card, and the voxel edits on the card with the same
edits on the CPU; where `torch.cuda.is_available()` is False they skip.
Kernel A's NO_SKIP builds (`use_skip=False`, the exact DDA) are held against
their twin and against the port's numpy oracle. The build helpers are
tested everywhere.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from zig_vulkan_tpu_torch import _build
from zig_vulkan_tpu_torch.config import EngineConfig, TraceConfig
from zig_vulkan_tpu_torch.core import grid as grid_mod
from zig_vulkan_tpu_torch.engine.engine import VoxelRT
from zig_vulkan_tpu_torch.models import scenes
from zig_vulkan_tpu_torch.ops import lookup, tile_tracer, trace

torch.set_num_threads(2)

_KEYS = ("found", "t", "px", "py", "pz", "nx", "ny", "nz", "index")


def test_trace_params_layout_matches_c_struct():
    """struct TraceParams in csrc/traverse.cu: 3+3+5 floats, 3+3 ints,
    then an int64 at its natural 8-byte alignment."""
    P = _build.TraceParams
    assert P.scale.offset == 24 and P.t_off.offset == 40
    assert P.dims.offset == 44 and P.max_steps.offset == 64
    assert P.use_skip.offset == 68
    assert P.n.offset == 72 and ctypes.sizeof(P) == 80


def test_library_named_by_sources_and_flags():
    path = _build.library_path()
    assert path == _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libzvt_kernels_") and path.suffix == ".so"
    assert {p.name for p in _build._sources()} >= {"traverse.cu", "lookup.cu"}
    assert "--fmad=false" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert not any("fast_math" in f for f in _build.NVCC_FLAGS)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene_on_card(card):
    sc = scenes.default_scene(dims=(64, 32, 64))
    rt = VoxelRT(sc.grid, sc.materials, EngineConfig(
        internal_resolution_width=256, internal_resolution_height=144),
        device=card)
    return rt


def _rays(rt, dev):
    cam = trace.camera_vectors(rt.camera.d_camera, dev)
    r = trace._camera_rays_soa(cam, 256, 144, 1.0)
    dx, dy, dz = trace._norm3(r[3], r[4], r[5])
    return tuple(a.contiguous() for a in (*r[:3], dx, dy, dz))


def _hit(rt, rays, active, key, plain):
    fn = trace._grid_hit_soa if plain else tile_tracer.grid_hit_tiles
    return fn(rt.grid_static, rt.tables(), rt.arrays.material_indices,
              *rays, active, ray_key=key)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", ["primary", "bounce", "bounce_keyed"])
def test_kernel_a_matches_plain(scene_on_card, card, batch):
    rt = scene_on_card
    rays = _rays(rt, card)
    n = rays[0].shape[0]
    active = torch.ones(n, dtype=torch.bool, device=card)
    key = None
    if batch != "primary":
        prim = _hit(rt, rays, active, None, plain=True)
        g = torch.Generator().manual_seed(0)
        d = torch.randn(n, 3, generator=g).to(card)
        d = d / d.norm(dim=-1, keepdim=True)
        rays = (prim["px"], prim["py"], prim["pz"],
                *(d[:, i].contiguous() for i in range(3)))
        active = prim["found"].contiguous()
        if batch == "bounce_keyed":
            key = torch.where(torch.rand(n, generator=g) < 0.5,
                              torch.tensor(1.333),
                              torch.tensor(float("nan"))).to(card)
    want = _hit(rt, rays, active, key, plain=True)
    before = tile_tracer.grid_hit_tiles.launches
    got = _hit(rt, rays, active, key, plain=False)
    torch.cuda.synchronize()
    assert tile_tracer.grid_hit_tiles.launches == before + 1
    assert int(want["found"].sum()) > 0
    for k in _KEYS:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
def test_kernel_b_matches_plain(card):
    g = torch.Generator().manual_seed(1)
    tables = torch.rand(5, 256, generator=g).to(card)
    idx = torch.randint(-8, 264, (1 << 20,), generator=g,
                        dtype=torch.int32).to(card)
    before = lookup.table_lookup.launches
    got = lookup.table_lookup(tables, idx)
    torch.cuda.synchronize()
    assert lookup.table_lookup.launches == before + 1
    want = lookup._table_lookup_plain(tables, idx)
    for t in range(5):
        assert torch.equal(got[t], want[t])


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(scene_on_card, card):
    rt = scene_on_card
    rays = _rays(rt, card)
    n = rays[0].shape[0]
    active = torch.ones(n, dtype=torch.bool, device=card)
    strided = torch.zeros(2 * n, device=card)[::2]
    with pytest.raises(ValueError, match="contiguous"):
        tile_tracer.grid_hit_tiles(rt.grid_static, rt.tables(),
                                   rt.arrays.material_indices,
                                   strided, *rays[1:], active)
    with pytest.raises(ValueError, match="float32"):
        tile_tracer.grid_hit_tiles(rt.grid_static, rt.tables(),
                                   rt.arrays.material_indices,
                                   rays[0].double(), *rays[1:], active)
    with pytest.raises(ValueError, match="int32"):
        lookup.table_lookup(rt.mats,
                            torch.zeros(4, dtype=torch.int64, device=card))


@pytest.mark.cuda
def test_frame_launches_each_kernel(scene_on_card):
    """One frame at max_bounce 2 (3 bounce levels), sun on: 6 launches of
    kernel A (scatter + shadow per level) and 3 of kernel B."""
    rt = scene_on_card
    a0 = tile_tracer.grid_hit_tiles.launches
    b0 = lookup.table_lookup.launches
    img = rt.draw()
    assert tile_tracer.grid_hit_tiles.launches - a0 == 6
    assert lookup.table_lookup.launches - b0 == 3
    assert img.shape == (144, 256, 3) and img.is_cuda
    assert bool(torch.isfinite(img).all())
    cpu = img.cpu().numpy()
    assert cpu.min() >= 0.0 and cpu.max() <= 1.0


def _primary(rt, card):
    rays = _rays(rt, card)
    return rays, torch.ones(rays[0].shape[0], dtype=torch.bool, device=card)


def _targets(rays):
    """Sun targets scattered far around the scene in every direction, so
    that some lanes' sun rays are blocked and some are not."""
    g = torch.Generator().manual_seed(2)
    t = torch.randn(3, rays[0].shape[0], generator=g) * 1000.0
    return tuple(t[i].contiguous().to(rays[0].device) for i in range(3))


@pytest.mark.cuda
@pytest.mark.parametrize("build", ["shadow", "stats", "shadow+stats", "exact",
                                   "exact+shadow", "exact+stats",
                                   "exact+shadow+stats"])
def test_kernel_a_builds_match_plain(scene_on_card, card, build):
    rt = scene_on_card
    rays, active = _primary(rt, card)
    kw = {}
    if "shadow" in build:
        kw["shadow_targets"] = _targets(rays)
    if "stats" in build:
        kw["stats"] = True
    if "exact" in build:
        kw["use_skip"] = False
    args = (rt.grid_static, rt.tables(), rt.arrays.material_indices, *rays,
            active)
    want = tile_tracer.grid_hit_plain(*args, **kw)
    before = dict(tile_tracer.grid_hit_tiles.build_launches)
    got = tile_tracer.grid_hit_tiles(*args, **kw)
    torch.cuda.synchronize()
    assert (tile_tracer.grid_hit_tiles.build_launches[build]
            == before[build] + 1)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    if "shadow" in build:
        share = got["occluded"][got["found"]].float().mean().item()
        assert 0.0 < share < 1.0


@pytest.mark.cuda
def test_edits_on_card_match_cpu(card):
    """apply_edits/remove_edits and the table refreshes on the card give
    the CPU's arrays and records bit for bit."""
    sc = scenes.default_scene(dims=(32, 16, 32))
    st = sc.grid.static
    rng = np.random.default_rng(0)
    vx, vy, vz = st.voxel_dims
    xyz = np.stack([rng.integers(0, vx, 512), rng.integers(0, vy, 512),
                    rng.integers(0, vz, 512)], -1).astype(np.int32)
    mats = rng.integers(0, 8, 512).astype(np.uint8)
    fy = vy - 1 - xyz[:, 1]
    cells = torch.from_numpy(xyz[:, 0] // 4 + st.dim_x * (
        xyz[:, 2] // 4 + st.dim_z * (fy // 4)))
    is_diel = torch.from_numpy(sc.materials.mtype == 2)
    ir = torch.from_numpy(sc.materials.type_data.astype(np.float32))
    out = {}
    for dev in ("cpu", card):
        a = sc.grid.arrays.to_device(dev)
        tables = trace.build_trace_tables(st, a, trace.distance_field(
            st, a, exact=True))
        valid = torch.ones(512, dtype=torch.bool, device=dev)
        a = grid_mod.apply_edits(st, a, torch.from_numpy(xyz).to(dev),
                                 torch.from_numpy(mats).to(dev), valid,
                                 is_diel.to(dev), ir.to(dev))
        tables, dist = trace.refresh_tables_after_insert(
            st, a, tables, cells.to(dev), valid)
        a = grid_mod.remove_edits(st, a, torch.from_numpy(xyz[::3]).to(dev),
                                  valid[::3])
        tables = trace.refresh_tables_after_remove(
            st, a, tables, dist, cells[::3].to(dev), valid[::3])
        out[str(dev)] = (a, tables)
    (ca, ct), (ga, gt) = out["cpu"], out[str(card)]
    for f in dataclasses.fields(ca):
        assert torch.equal(getattr(ca, f.name).cpu(),
                           getattr(ga, f.name).cpu()) or f.name == "brick_ir"
    assert torch.equal(ca.brick_ir.cpu().view(torch.int32),
                       ga.brick_ir.cpu().view(torch.int32))
    assert torch.equal(ct, gt.cpu())
    assert torch.equal(grid_mod.dense_materials(st, ga).cpu(),
                       grid_mod.dense_materials(st, ca))


@pytest.mark.cuda
def test_kernel_a_matches_plain_on_a_sprayed_scene(card):
    """The config-3 regime: random single voxels in most regions."""
    sc = scenes.default_scene(dims=(64, 32, 64))
    rt = VoxelRT(sc.grid, sc.materials, EngineConfig(
        internal_resolution_width=256, internal_resolution_height=144,
        trace=TraceConfig(max_steps=160)), device=card)
    rt.tables()
    rng = np.random.default_rng(0)
    vx, vy, vz = rt.grid_static.voxel_dims
    for _ in range(3):
        xyz = np.stack([rng.integers(0, vx, 512), rng.integers(0, vy, 512),
                        rng.integers(0, vz, 512)], -1)
        rt.insert_voxels(xyz, rng.integers(1, 8, 512).astype(np.uint8))
    assert rt._scene_degraded()
    rays, active = _primary(rt, card)
    args = (rt.grid_static, rt.tables(), rt.arrays.material_indices)
    want = tile_tracer.grid_hit_plain(*args, *rays, active, max_steps=160)
    got = tile_tracer.grid_hit_tiles(*args, *rays, active, max_steps=160)
    torch.cuda.synchronize()
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
def test_frame_with_sun_in_kernel(scene_on_card):
    """sun_in_kernel: 3 launches of the shadow build per frame at
    max_bounce 2 and none of the default build, and the same image."""
    rt = scene_on_card
    separate = rt.draw()
    before = dict(tile_tracer.grid_hit_tiles.build_launches)
    rt.trace_config = TraceConfig(sun_in_kernel=True)
    try:
        img = rt.draw()
    finally:
        rt.trace_config = TraceConfig()
    after = tile_tracer.grid_hit_tiles.build_launches
    assert after["shadow"] - before["shadow"] == 3
    assert after["default"] == before["default"]
    assert torch.equal(img, separate)


@pytest.mark.cuda
def test_exact_build_gives_the_oracles_hits(card):
    """The NO_SKIP build on a small default scene: the numpy oracle's found
    set and material indices, t within rtol 1e-5 / atol 1e-4
    (tests/test_parity_at_scale.py:67-82), and its twin's answer bit for
    bit."""
    from zig_vulkan_tpu_torch.core.materials import MAT_NONE
    from zig_vulkan_tpu_torch.oracle import cpu_tracer as oracle

    sc = scenes.default_scene(dims=(32, 16, 32))
    st = sc.grid.static
    arrays = sc.grid.arrays.to_device(card)
    tables = trace.build_trace_tables(st, arrays,
                                      trace.no_skip_field(st, arrays))
    rt = VoxelRT(sc.grid, sc.materials, EngineConfig(
        internal_resolution_width=96, internal_resolution_height=54),
        device=card)
    cam = trace.camera_vectors(rt.camera.d_camera, card)
    r = trace._camera_rays_soa(cam, 96, 54, 0)
    rays = tuple(a.contiguous() for a in (*r[:3], *trace._norm3(*r[3:])))
    n = rays[0].shape[0]
    on = torch.ones(n, dtype=torch.bool, device=card)
    args = (st, tables, arrays.material_indices, *rays, on)
    got = tile_tracer.grid_hit_tiles(*args, use_skip=False)
    want = tile_tracer.grid_hit_plain(*args, use_skip=False)
    torch.cuda.synchronize()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    ro = torch.stack(rays[:3], -1).cpu().numpy()
    rd = torch.stack(rays[3:], -1).cpu().numpy()
    o = oracle.grid_hit(oracle.OracleScene(st, sc.grid.arrays, sc.materials),
                        ro, rd, np.float32(1e-5), np.float32(np.inf),
                        np.full(n, MAT_NONE, np.int32),
                        np.ones(n, np.float32), np.ones(n, bool))
    found = got["found"].cpu().numpy()
    assert (found == o.found).all() and found.sum() > 100
    np.testing.assert_allclose(got["t"].cpu().numpy()[found], o.t[found],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got["index"].cpu().numpy()[found],
                                  o.index[found])


@pytest.mark.cuda
def test_exact_frame_launches_the_exact_build(card):
    sc = scenes.default_scene(dims=(32, 16, 32))
    rt = VoxelRT(sc.grid, sc.materials, EngineConfig(
        internal_resolution_width=96, internal_resolution_height=54,
        trace=TraceConfig(empty_skip=False)), device=card)
    before = dict(tile_tracer.grid_hit_tiles.build_launches)
    img = rt.draw()
    after = tile_tracer.grid_hit_tiles.build_launches
    assert after["exact"] - before["exact"] == 6
    assert after["default"] == before["default"]
    assert bool(torch.isfinite(img).all())
    assert not rt.tables()[:, 3].any()
