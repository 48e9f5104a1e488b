"""zig_vulkan_tpu_torch's CUDA kernels against their plain torch versions.

This file imports no JAX, so it also runs on a machine with a GPU and no
JAX: `python -m pytest --noconftest tests/test_torch_kernels.py` (the
suite's conftest.py imports JAX). The tests marked
`cuda` build csrc/*.cu with nvcc and compare kernel A (traversal; its
default, shadow and stats builds), kernel B (material lookup) and kernels
C, D and E (camera rays, shade, resolve: ops.shade) with their plain
versions on the card, kernel F (the post-process: ops.denoise) with its
plain version on every mode, band and knob, and the voxel edits on the
card with the same edits on the CPU; where `torch.cuda.is_available()` is False they skip.
Kernel A's NO_SKIP builds (`use_skip=False`, the exact DDA) are held against
their twin and against the port's numpy oracle, and on records with the
exact field, the conservative one and all 0 (they never read it). The
build helpers are tested everywhere. The compiled steps (the frame, the edits, the sharded
bands) are held here as replays against their bodies op by op.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from zig_vulkan_tpu_torch import _build
from zig_vulkan_tpu_torch.config import (DenoiserConfig, EngineConfig,
                                         TraceConfig)
from zig_vulkan_tpu_torch.core import grid as grid_mod
from zig_vulkan_tpu_torch.engine.engine import VoxelRT, both_routes
from zig_vulkan_tpu_torch.models import scenes
from zig_vulkan_tpu_torch.core.materials import (
    MAT_DIELECTRIC,
    MAT_EMISSIVE,
    MAT_LAMBERTIAN,
    MAT_METAL,
    MAT_NONE,
    MaterialTable,
)
from zig_vulkan_tpu_torch.ops import denoise, lookup, shade, tile_tracer, trace
from zig_vulkan_tpu_torch.utils import profiling

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


def test_shading_args_layouts_match_the_c_structs():
    """struct CameraArgs (csrc/camera.cu), ShadeArgs (shade.cu) and
    ResolveArgs (resolve.cu): the pointers, then an int64 at its natural
    8-byte alignment, then ints and floats, padded to 8 bytes."""
    c, d, e = _build.CameraArgs, _build.ShadeArgs, _build.ResolveArgs
    assert c.tz.offset == 15 * 8 and c.n.offset == 128
    assert c.width.offset == 136 and c.row0.offset == 148
    assert c.base.offset == 160 and c.sun_p.offset == 164
    assert c.radius.offset == 176 and ctypes.sizeof(c) == 184
    assert d.found.offset == 0 and d.radius_ptr.offset == 40 * 8
    assert d.shadow_count.offset == 44 * 8
    assert d.in_queue.offset == 45 * 8 and d.in_count.offset == 46 * 8
    assert d.n.offset == 376 and d.sun.offset == 384
    assert d.sun_c.offset == 400 and d.radius.offset == 412
    assert ctypes.sizeof(d) == 416
    assert e.out.offset == 80 and e.m.offset == 88 and e.gamma.offset == 104
    assert e.sun_c.offset == 108 and ctypes.sizeof(e) == 120


def test_library_named_by_sources_and_flags():
    path = _build.library_path()
    assert path == _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libzvt_kernels_") and path.suffix == ".so"
    assert {p.name for p in _build._sources()} >= {
        "traverse.cu", "lookup.cu", "camera.cu", "shade.cu", "resolve.cu",
        "denoise.cu"}
    assert [p.name for p in _build._headers()] == ["shading.cuh"]
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
    kernel A (scatter + shadow per level) and 3 of kernel B, counted
    through the wrappers on the step's body op by op (a replay of the
    same step runs them without calling a wrapper)."""
    rt = scene_on_card
    a0 = tile_tracer.grid_hit_tiles.launches
    b0 = lookup.table_lookup.launches
    rt.render_op_by_op()
    assert tile_tracer.grid_hit_tiles.launches - a0 == 6
    assert lookup.table_lookup.launches - b0 == 3
    img = rt.draw()
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
    max_bounce 2 and none of the default build (the body op by op), and
    the same image."""
    rt = scene_on_card
    separate = rt.draw()
    rt.trace_config = TraceConfig(sun_in_kernel=True)
    try:
        before = dict(tile_tracer.grid_hit_tiles.build_launches)
        rt.render_op_by_op()
        after = dict(tile_tracer.grid_hit_tiles.build_launches)
        img = rt.draw()
    finally:
        rt.trace_config = TraceConfig()
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
    rt.render_op_by_op()  # one frame, each launch through its wrapper
    after = dict(tile_tracer.grid_hit_tiles.build_launches)
    img = rt.draw()
    assert after["exact"] - before["exact"] == 6
    assert after["default"] == before["default"]
    assert bool(torch.isfinite(img).all())
    # the records keep the exact field whatever empty_skip is
    assert torch.equal(rt.tables()[:, 3], trace.distance_field(
        rt.grid_static, rt.arrays, exact=True))


@pytest.mark.cuda
@pytest.mark.parametrize("build", ["exact", "exact+shadow", "exact+stats",
                                   "exact+shadow+stats"])
def test_exact_builds_ignore_the_distance_lane(scene_on_card, card, build):
    """Each NO_SKIP build on the scene's records with the exact field, the
    conservative one and all 0: the same answer bit for bit, equal to its
    plain twin's, on primary and random rays with scattered live lanes and
    dielectric keys. The default build's steps differ between the fields,
    so the fields differ where the rays go."""
    rt = scene_on_card
    st, arrays = rt.grid_static, rt.arrays
    fields = {name: trace.build_trace_tables(st, arrays, dist)
              for name, dist in (
                  ("exact", trace.distance_field(st, arrays, exact=True)),
                  ("conservative", trace.distance_field(st, arrays)),
                  ("zero", trace.no_skip_field(st, arrays)))}
    prim, _ = _primary(rt, card)
    rand = _random_rays(rt, 100_000, 14, card)
    rays = tuple(torch.cat([p, q]).contiguous() for p, q in zip(prim, rand))
    n = rays[0].shape[0]
    active, key = _mixed(n, 14, card, share=0.8)
    kw = dict(ray_key=key, stats="stats" in build, use_skip=False)
    if "shadow" in build:
        kw["shadow_targets"] = _targets(rays)
    args = (st, fields["exact"], arrays.material_indices, *rays, active)
    want = tile_tracer.grid_hit_plain(*args, **kw)
    for name, tables in fields.items():
        got = tile_tracer.grid_hit_tiles(st, tables, arrays.material_indices,
                                         *rays, active, **kw)
        torch.cuda.synchronize()
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (name, k)
    assert int(want["found"].sum()) > 1000
    steps = [tile_tracer.grid_hit_tiles(
        st, fields[name], arrays.material_indices, *rays, active,
        stats=True)["n_step"] for name in ("exact", "conservative")]
    assert not torch.equal(*steps)


def _random_rays(rt, n, seed, card):
    """`n` rays from points in and around the scene's grid, in random
    directions (numpy, from `seed`)."""
    k = trace.trace_constants(rt.grid_static)
    g0, g1 = np.asarray(k["g0"], np.float32), np.asarray(k["g1"], np.float32)
    rng = np.random.default_rng(seed)
    ext = g1 - g0
    o = (g0 - 0.2 * ext + rng.random((n, 3)) * 1.4 * ext).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return tuple(torch.from_numpy(np.ascontiguousarray(a[:, i])).to(card)
                 for a in (o, d) for i in range(3))


def _mixed(n, seed, card, share=0.6):
    """Scattered `active` lanes and dielectric keys: NaN, the water's ir
    and another ir."""
    rng = np.random.default_rng(seed + 1)
    active = torch.from_numpy(rng.random(n) < share).to(card)
    key = rng.choice(np.array([np.nan, 1.333, 1.5], np.float32), n)
    return active, torch.from_numpy(key).to(card)


def _kernel_vs_plain(rt, rays, active, **kw):
    args = (rt.grid_static, rt.tables(), rt.arrays.material_indices, *rays,
            active)
    want = tile_tracer.grid_hit_plain(*args, **kw)
    got = tile_tracer.grid_hit_tiles(*args, **kw)
    torch.cuda.synchronize()
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 31, 33, 128 * 37 + 5])
def test_kernel_a_ragged_wavefronts(scene_on_card, card, n):
    """Lane counts that fill no warp, one warp and a bit, and no block."""
    rt = scene_on_card
    rays = _random_rays(rt, n, n, card)
    active, key = _mixed(n, n, card)
    before = tile_tracer.grid_hit_tiles.launches
    _kernel_vs_plain(rt, rays, active, ray_key=key, stats=True)
    assert tile_tracer.grid_hit_tiles.launches == before + (n > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("share", [0.03, 0.6, 1.0])
@pytest.mark.parametrize("build", ["default", "shadow+stats", "exact+shadow"])
def test_kernel_a_scattered_masked_lanes_mixed_keys(scene_on_card, card,
                                                    share, build):
    """Bounce rays from the primary hits on scattered lanes, keyed with
    NaN and two irs: a few live lanes among many masked off (the frame's
    last bounce), most live, and all."""
    rt = scene_on_card
    rays, on = _primary(rt, card)
    n = rays[0].shape[0]
    prim = _hit(rt, rays, on, None, plain=True)
    d = torch.stack(_random_rays(rt, n, 7, card)[3:], -1)
    nrm = torch.stack([prim["nx"], prim["ny"], prim["nz"]], -1)
    d = torch.where((d * nrm).sum(-1, keepdim=True) < 0, -d, d)
    bounce = (prim["px"], prim["py"], prim["pz"],
              *(d[:, i].contiguous() for i in range(3)))
    scatter, key = _mixed(n, 3, card, share)
    kw = dict(ray_key=key, use_skip="exact" not in build,
              stats="stats" in build)
    if "shadow" in build:
        kw["shadow_targets"] = _targets(bounce)
    got = _kernel_vs_plain(rt, bounce, prim["found"] & scatter, **kw)
    assert int(got["found"].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [600_000, 20_000])
def test_kernel_a_beyond_one_resident_wave(scene_on_card, card, n):
    """More lanes than one resident wave of blocks holds (600,000: 4,688
    blocks of 128 against the H100's 1,056 resident), and fewer (20,000),
    with the sun-ray build."""
    rt = scene_on_card
    rays = _random_rays(rt, n, 11, card)
    active, key = _mixed(n, 11, card, share=0.8)
    got = _kernel_vs_plain(rt, rays, active, ray_key=key,
                           shadow_targets=_targets(rays))
    assert int(got["found"].sum()) > 0


@pytest.mark.cuda
def test_kernel_a_on_two_streams(scene_on_card, card):
    """Two launches in flight on two streams, each on its own inputs."""
    rt = scene_on_card
    n = 200_000
    sets = [(_random_rays(rt, n, s, card), *_mixed(n, s, card))
            for s in (21, 22)]
    args = (rt.grid_static, rt.tables(), rt.arrays.material_indices)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = []
    for s, (rays, active, key) in zip(streams, sets):
        with torch.cuda.stream(s):
            got.append(tile_tracer.grid_hit_tiles(*args, *rays, active,
                                                  ray_key=key))
    torch.cuda.synchronize()
    for g, (rays, active, key) in zip(got, sets):
        want = tile_tracer.grid_hit_plain(*args, *rays, active, ray_key=key)
        for k in want:
            assert torch.equal(g[k], want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [1, 7, 4099, (1 << 20) + 3])
def test_kernel_b_misaligned_and_ragged(card, offset, n):
    """`idx` starting 0-3 elements past a 16-byte boundary, and lane
    counts that leave output rows misaligned."""
    g = torch.Generator().manual_seed(n + offset)
    tables = torch.rand(5, 256, generator=g).to(card)
    full = torch.randint(-8, 264, (n + offset,), generator=g,
                         dtype=torch.int32).to(card)
    idx = full[offset:]
    assert idx.data_ptr() % 16 == 4 * offset % 16
    got = lookup.table_lookup(tables, idx)
    torch.cuda.synchronize()
    want = lookup._table_lookup_plain(tables, idx)
    for t in range(5):
        assert torch.equal(got[t], want[t])


@pytest.mark.cuda
@pytest.mark.parametrize("n_tables", [1, 3, 4, 9])
def test_kernel_b_table_counts(card, n_tables):
    """Table counts with and without a float4 group, and a remainder."""
    g = torch.Generator().manual_seed(n_tables)
    tables = torch.rand(n_tables, 100, generator=g).to(card)
    idx = torch.randint(-3, 103, (10_001,), generator=g,
                        dtype=torch.int32).to(card)
    got = lookup.table_lookup(tables, idx)
    torch.cuda.synchronize()
    want = lookup._table_lookup_plain(tables, idx)
    assert len(got) == n_tables
    for t in range(n_tables):
        assert torch.equal(got[t], want[t])


@pytest.mark.parametrize("size", [2.0 ** k for k in range(-6, 7)])
def test_power_of_two_reciprocal_multiply_is_the_division(size):
    """Kernel A's POW2 builds compute a DDA cursor's x / size as
    x * (1 / size): for a power-of-two size both are the one rounding of
    the same real number, so they agree bit for bit, on subnormal, huge,
    infinite and NaN x too."""
    rng = np.random.default_rng(int(np.log2(size)) + 10)
    x = np.concatenate([
        rng.standard_normal(20_000).astype(np.float32) * 300.0,
        rng.integers(0, 2**32, 20_000, dtype=np.uint64).astype(
            np.uint32).view(np.float32),  # every exponent, NaNs included
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45,
                  1.17e-38, 3.4e38], np.float32)])
    xt = torch.from_numpy(x)
    s = torch.tensor(size, dtype=torch.float32)
    quot = xt / s
    prod = xt * (torch.tensor(1.0, dtype=torch.float32) / s)
    nan = torch.isnan(quot)
    assert torch.equal(nan, torch.isnan(prod))
    assert torch.equal(quot[~nan].view(torch.int32),
                       prod[~nan].view(torch.int32))


def test_reciprocal_multiply_is_not_the_division_at_other_sizes():
    """Why the builds that divide stay: at a cell size that is no power of
    two the product rounds differently on some x."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        100_000).astype(np.float32) * 300.0)
    s = torch.tensor(0.3, dtype=torch.float32)
    assert bool(((x / s) != (x * (1.0 / s))).any())


@pytest.mark.cuda
@pytest.mark.parametrize("build", ["default", "shadow+stats", "exact",
                                   "exact+shadow+stats"])
@pytest.mark.parametrize("scale", [0.3, 1.5])
def test_kernel_a_dividing_builds_match_plain(scene_on_card, card, build,
                                              scale):
    """A cell size that is no power of two runs the builds that divide
    (every scene of the repo runs the POW2 builds): scattered masked lanes
    and mixed keys, against the plain version."""
    rt = scene_on_card
    static = dataclasses.replace(rt.grid_static, scale=scale)
    n = 50_000
    k = trace.trace_constants(static)
    g0, g1 = np.asarray(k["g0"], np.float32), np.asarray(k["g1"], np.float32)
    rng = np.random.default_rng(int(scale * 10))
    o = (g0 - 0.2 * (g1 - g0) + rng.random((n, 3)) * 1.4 * (g1 - g0))
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = tuple(torch.from_numpy(np.ascontiguousarray(
        a[:, i].astype(np.float32))).to(card) for a in (o, d)
        for i in range(3))
    active, key = _mixed(n, 5, card)
    args = (static, rt.tables(), rt.arrays.material_indices, *rays, active)
    kw = dict(ray_key=key, use_skip="exact" not in build,
              stats="stats" in build)
    if "shadow" in build:
        kw["shadow_targets"] = _targets(rays)
    want = tile_tracer.grid_hit_plain(*args, **kw)
    got = tile_tracer.grid_hit_tiles(*args, **kw)
    torch.cuda.synchronize()
    assert int(want["found"].sum()) > 0
    for name in want:
        assert torch.equal(got[name], want[name]), name


# -- row sharding on the card (parallel.mesh) ------------------------------------

def _sharded_inputs(rt, card):
    d, sun = rt.camera.d_camera, rt.sun.device_data
    iw, ih = rt.internal_resolution
    kw = dict(width=iw, height=ih, spp=int(d.samples_per_pixel),
              max_bounce=int(d.max_bounce), sun_enabled=bool(sun.enabled),
              out_width=rt.output_resolution[0],
              out_height=rt.output_resolution[1], denoiser=rt.denoiser,
              trace_config=rt.trace_config)
    args = (trace.camera_vectors(d, card), sun.position, sun.color,
            sun.radius)
    return kw, args


@pytest.mark.cuda
def test_two_shards_on_two_streams_equal_one_stream(scene_on_card, card):
    """Two shards of one card, each on its own stream, give the one-stream
    result bit for bit: the unsharded frame on the default stream, and the
    one-shard mesh."""
    from zig_vulkan_tpu_torch.parallel import mesh as pmesh

    rt = scene_on_card
    kw, args = _sharded_inputs(rt, card)
    want = rt.render()
    tile_tracer.reset_launch_counts()
    lookup.table_lookup.launches = 0
    images = {}
    for n in (1, 2):
        m = pmesh.make_mesh([card] * n)
        assert len(m.distinct) == 1
        step = pmesh.build_sharded_step(m, rt.grid_static, **kw)
        arrays_r, mats_r = pmesh.replicate_scene(m, rt.arrays, rt.mats)
        assert arrays_r[0] is arrays_r[-1]
        assert arrays_r[0].indices.data_ptr() != rt.arrays.indices.data_ptr()
        tables = pmesh.map_replicas(
            m, lambda a: trace.build_trace_tables(
                rt.grid_static, a,
                trace.distance_field(rt.grid_static, a, exact=True)),
            arrays_r)
        images[n] = step(arrays_r, mats_r, *args, tables=tables)
    torch.cuda.synchronize()
    assert images[2].device == want.device
    assert torch.equal(images[1], want)
    assert torch.equal(images[2], want)
    # 3 levels a shard: scatter + shadow launches of A, one of B; each
    # shard's first call is its graph's capture (its warm-up and its
    # capture go through the wrappers)
    assert tile_tracer.grid_hit_tiles.launches == 2 * 6 * 3
    assert lookup.table_lookup.launches == 2 * 3 * 3


@pytest.mark.cuda
def test_kernel_a_under_a_non_default_stream_and_on_a_second_card(
        scene_on_card, card):
    """Kernel A launched under a stream that is not the default one and,
    where there is a second card, on `cuda:1` with the scene copied there."""
    rt = scene_on_card
    n = 100_000
    rays = _random_rays(rt, n, 31, card)
    active, key = _mixed(n, 31, card)
    args = (rt.grid_static, rt.tables(), rt.arrays.material_indices)
    want = tile_tracer.grid_hit_plain(*args, *rays, active, ray_key=key)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert torch.cuda.current_stream() == side
        got = tile_tracer.grid_hit_tiles(*args, *rays, active, ray_key=key)
    side.synchronize()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    if torch.cuda.device_count() < 2:
        return
    other = torch.device("cuda:1")
    moved = [args[0], args[1].to(other), args[2].to(other),
             *(r.to(other) for r in rays), active.to(other)]
    before = tile_tracer.grid_hit_tiles.launches
    got = tile_tracer.grid_hit_tiles(*moved, ray_key=key.to(other))
    torch.cuda.synchronize(other)
    assert tile_tracer.grid_hit_tiles.launches == before + 1
    for k in want:
        assert got[k].device == other
        assert torch.equal(got[k].to(card), want[k]), k


# -- the compiled frame step (engine.step): replays on the card ------------------

def _step_engine(card, temporal=False):
    sc = scenes.default_scene(dims=(64, 32, 64))
    rt = VoxelRT(sc.grid, sc.materials, EngineConfig(
        internal_resolution_width=256, internal_resolution_height=144,
        output_resolution_width=320, output_resolution_height=180),
        device=card)
    rt.set_temporal(temporal)
    return rt


@pytest.mark.cuda
@pytest.mark.parametrize("temporal", [False, True])
def test_replay_equals_the_op_by_op_body(card, temporal):
    """After the capture frame, every replay equals the step's body run op
    by op on the same push constants, bit for bit; one capture."""
    from zig_vulkan_tpu_torch.engine.step import GraphedCall

    rt = _step_engine(card, temporal)
    before = GraphedCall.captures
    first = rt.render()
    for i in range(3):
        if not temporal:
            rt.camera.turn_yaw(0.05)
            rt.update_sun(0.5)
        got, want = both_routes(rt)
        assert torch.equal(got, want), i
    assert GraphedCall.captures == before + 1
    assert not torch.equal(got, first)
    if temporal:
        assert rt._accum_count == 4


@pytest.mark.cuda
def test_one_capture_over_frames_with_edits(card):
    """Edits between frames write the scene in place: each replay shows
    them through the one frame graph, equal to the op-by-op body; the
    edits add one graph for the inserts and one for the removals."""
    from zig_vulkan_tpu_torch.engine.step import GraphedCall

    rt = _step_engine(card)
    before = GraphedCall.captures
    rt.render()
    rng = np.random.default_rng(7)
    vx, vy, vz = rt.grid_static.voxel_dims
    for i in range(4):
        xyz = np.stack([rng.integers(0, vx, 512), rng.integers(0, vy, 512),
                        rng.integers(0, vz, 512)], -1)
        if i % 2 == 0:
            rt.insert_voxels(xyz, rng.integers(1, 8, 512).astype(np.uint8))
        else:
            rt.remove_voxels(xyz)
        got, want = both_routes(rt)
        assert torch.equal(got, want), i
    assert GraphedCall.captures == before + 3


def _card_launches(fn, calls):
    """Kernel launches a call of `fn` as a torch.profiler trace of the card
    shows them (`utils.profiling.kernel_launches`)."""
    import json
    import tempfile

    fn()  # outside the trace: its first device records may be lost
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace_session(tmp):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        with open(f"{tmp}/{profiling.TRACE_FILE}") as f:
            events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "kernel"]
    return {k: v / calls for k, v in profiling.kernel_launches(names).items()}


@pytest.mark.cuda
def test_launch_counters_after_replays(card):
    """The counters move where a wrapper launches its kernel: in the
    capture frame's warm-up and capture (6 A and 3 B each, a default frame
    of 3 levels with the sun) and op by op, never on a replay. A trace of
    the card shows each replay running the same 6 A and 3 B launches."""
    rt = _step_engine(card)
    tile_tracer.reset_launch_counts()
    lookup.table_lookup.launches = 0
    rt.render()
    torch.cuda.synchronize()
    assert tile_tracer.grid_hit_tiles.launches == 12
    assert lookup.table_lookup.launches == 6
    for _ in range(5):
        rt.render()
    torch.cuda.synchronize()
    assert tile_tracer.grid_hit_tiles.launches == 12
    assert tile_tracer.grid_hit_tiles.build_launches["default"] == 12
    assert lookup.table_lookup.launches == 6
    replayed = _card_launches(rt.render, 3)
    assert (replayed["A"], replayed["default"], replayed["B"]) == (6, 6, 3)
    assert tile_tracer.grid_hit_tiles.launches == 12
    assert _card_launches(rt.render_op_by_op, 1) == replayed
    # two op-by-op frames: the trace's and the one before it
    assert tile_tracer.grid_hit_tiles.launches == 12 + 2 * 6
    assert lookup.table_lookup.launches == 6 + 2 * 3


def _pool_bytes(pool):
    """Bytes of the segments of the CUDA memory pool `pool` (a graph's
    `pool()` id)."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


@pytest.mark.cuda
def test_denoiser_sweep_keeps_every_graph_in_one_pool(card):
    """Each value of the denoiser's pixel_multiplier is a key and a capture
    (samples, bias and hue tolerance are push constants: see
    test_slider_moves_replay_one_graph); the engine keeps every key's step
    and their graphs share the engine's one pool, which holds at most 1.25
    times the largest key's own pool (a key alone in an engine) plus each
    key's static output. A second sweep captures nothing."""
    from zig_vulkan_tpu_torch.engine.step import GraphedCall

    values = [1.0 + 0.25 * i for i in range(6)]
    alone = []
    for m in values:
        one = _step_engine(card)
        one.set_denoiser(pixel_multiplier=m)
        one.render()
        torch.cuda.synchronize()
        alone.append(_pool_bytes(one.step().graphed.graph.pool()))
        del one
    rt = _step_engine(card)
    before = GraphedCall.captures
    for sweep in range(2):
        for m in values:
            rt.set_denoiser(pixel_multiplier=m)
            rt.render()
    torch.cuda.synchronize()
    assert GraphedCall.captures - before == len(values)
    assert len(rt._step_cache) == len(values)
    pools = {tuple(s.graphed.graph.pool()) for s in rt._step_cache.values()}
    assert pools == {tuple(rt._graphs.handle)}
    out_bytes = 4 * 3 * 320 * 180
    shared = _pool_bytes(rt._graphs.handle)
    assert 0 < shared <= 1.25 * max(alone) + len(values) * out_bytes, (
        shared, alone)


@pytest.mark.cuda
def test_alternating_keys_keep_their_images(card):
    """Two keys A, B, A, B, ... over 8 frames with the camera moving: each
    replay equals the same key's body op by op bit for bit, and an image
    returned earlier is unchanged after the later replays of both graphs
    (which share one pool)."""
    from zig_vulkan_tpu_torch.engine.step import GraphedCall

    rt = _step_engine(card)
    before = GraphedCall.captures
    kept = []
    for i in range(8):
        rt.set_denoiser(pixel_multiplier=(1.5, 2.0)[i % 2])
        rt.camera.turn_yaw(0.05)
        rt.update_sun(0.5)
        want = rt.render_op_by_op()
        got = rt.render()
        assert torch.equal(got, want), i
        kept.append((got, got.clone()))
    torch.cuda.synchronize()
    assert GraphedCall.captures - before == 2
    for i, (got, copy) in enumerate(kept):
        assert torch.equal(got, copy), i
    assert not torch.equal(kept[0][0], kept[2][0])


@pytest.mark.cuda
def test_edit_sizes_kept_over_two_rounds(card):
    """Inserts and removals at six padded sizes (1,024 to 32,768 lanes),
    then again, with frames between: the second round captures nothing,
    and the scene and records equal the same edits on the CPU."""
    from zig_vulkan_tpu_torch.engine.key_tour import EDIT_SIZES, edit_batch
    from zig_vulkan_tpu_torch.engine.step import GraphedCall

    rt = _step_engine(card)
    sc = scenes.default_scene(dims=(64, 32, 64))
    cpu = VoxelRT(sc.grid, sc.materials, rt.config, device="cpu")
    rt.render()
    cpu.tables()
    rng = np.random.default_rng(11)
    box = ((0, 0, 0), rt.grid_static.voxel_dims)
    made = []
    for _ in range(2):
        c0 = GraphedCall.captures
        for n in EDIT_SIZES:
            xyz, mats = edit_batch(rng, n, box)
            for engine in (rt, cpu):
                engine.insert_voxels(xyz, mats)
            rt.render()
            for engine in (rt, cpu):
                engine.remove_voxels(xyz)
            rt.render()
        made.append(GraphedCall.captures - c0)
    torch.cuda.synchronize()
    assert made == [2 * len(EDIT_SIZES), 0]
    assert sorted(rt._edit_cache) == [1024 << k for k in range(6)]
    _same_scene(cpu.arrays, grid_mod.GridArrays(**{
        f.name: getattr(rt.arrays, f.name).cpu()
        for f in dataclasses.fields(rt.arrays)}))
    assert torch.equal(rt._tables.cpu(), cpu._tables)


@pytest.mark.cuda
def test_step_captures_on_a_second_card(card):
    """An engine on `cuda:1` captures and replays its step there while
    `cuda:0` is the current device: each replay equals its body op by op."""
    from zig_vulkan_tpu_torch.engine.step import GraphedCall

    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second card")
    other = torch.device("cuda:1")
    assert torch.cuda.current_device() == 0
    rt = _step_engine(other)
    before = GraphedCall.captures
    first = rt.render()
    assert first.device == other
    for _ in range(2):
        rt.camera.turn_yaw(0.05)
        got, want = both_routes(rt)
        assert got.device == other and torch.equal(got, want)
    assert GraphedCall.captures == before + 1
    assert rt.step().graphed.graph is not None
    assert rt._graphs.device == other and rt._graphs.stream.device == other
    assert tuple(rt.step().graphed.graph.pool()) == tuple(rt._graphs.handle)


@pytest.mark.cuda
def test_pose_frame_replays_equal_its_body(card):
    """The bench's compiled pose frame: each replay equals the body on the
    same vectors; the body makes one kernel A launch, a replay none through
    the wrapper."""
    from zig_vulkan_tpu_torch.benchmarks import bench
    from zig_vulkan_tpu_torch.core.camera import Camera
    from zig_vulkan_tpu_torch.config import CameraConfig

    rt = _step_engine(card)
    frame = bench.PoseFrame(rt.grid_static, rt.tables(),
                            rt.arrays.material_indices, 320, 180)
    cam = Camera(75.0, 320, 180, CameraConfig(origin=(0.0, 0.0, 0.0)))
    frame(torch.from_numpy(trace.camera_basis(cam.d_camera)).to(card))
    for p in ((2.0, 5.0, 0.0), (10.0, -20.0, 15.0)):
        cam.set_origin(p)
        vec = torch.from_numpy(trace.camera_basis(cam.d_camera)).to(card)
        before = tile_tracer.grid_hit_tiles.launches
        got = {k: v.clone() for k, v in frame(vec).items()}
        assert tile_tracer.grid_hit_tiles.launches == before  # a replay
        want = frame.body(vec)
        assert tile_tracer.grid_hit_tiles.launches == before + 1
        torch.cuda.synchronize()
        for k in want:
            assert torch.equal(got[k], want[k]), k


# -- the compiled edits and the sharded bands: replays on the card ---------------

def _edit_batches(rt, sizes, seed=3):
    """Insert and removal batches of `sizes` voxels, alternating."""
    rng = np.random.default_rng(seed)
    vx, vy, vz = rt.grid_static.voxel_dims
    for i, n in enumerate(sizes):
        xyz = np.stack([rng.integers(0, vx, n), rng.integers(0, vy, n),
                        rng.integers(0, vz, n)], -1)
        yield xyz, (rng.integers(0, 9, n).astype(np.uint8) if i % 2 == 0
                    else None)


def _edit(rt, xyz, mats, op_by_op=False):
    if mats is None:
        (rt.remove_voxels_op_by_op if op_by_op else rt.remove_voxels)(xyz)
    else:
        (rt.insert_voxels_op_by_op if op_by_op
         else rt.insert_voxels)(xyz, mats)


def _same_scene(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert torch.equal(x.view(torch.uint8) if x.is_floating_point() else x,
                           y.view(torch.uint8) if y.is_floating_point() else y
                           ), f.name


@pytest.mark.cuda
def test_edit_replays_equal_the_op_by_op_body(card):
    """Two engines on one scene, one editing through the edit graphs, one
    through the same bodies op by op: arrays, records and frames bit for
    bit after every batch; one capture an (op, padded size)."""
    from zig_vulkan_tpu_torch.engine.step import GraphedCall

    replay, plain = _step_engine(card), _step_engine(card)
    for rt in (replay, plain):
        rt.render()
    before = GraphedCall.captures
    sizes = (512, 512, 700, 300, 1500, 1500, 512, 512)
    for xyz, mats in _edit_batches(replay, sizes):
        _edit(replay, xyz, mats)
        _edit(plain, xyz, mats, op_by_op=True)
        _same_scene(replay.arrays, plain.arrays)
        assert torch.equal(replay._tables, plain._tables)
        assert torch.equal(replay.render(), plain.render())
    # (insert, 1024), (remove, 1024), (insert, 2048), (remove, 2048)
    assert GraphedCall.captures - before == 4


@pytest.mark.cuda
def test_edits_make_no_host_sync_on_the_card(card):
    """After each (op, size)'s capture, edits replayed and edits op by op
    run under `set_sync_debug_mode("error")`: no copy or wait of the edit
    body blocks the host."""
    rt = _step_engine(card)
    rt.render()
    batches = list(_edit_batches(rt, (512,) * 6))
    for xyz, mats in batches[:2]:
        _edit(rt, xyz, mats)  # the captures (a capture synchronizes)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for xyz, mats in batches[2:4]:
            _edit(rt, xyz, mats)
        for xyz, mats in batches[4:]:
            _edit(rt, xyz, mats, op_by_op=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_one_edit_capture_over_batches_of_one_size(card):
    """Eight inserts of 200 to 1,000 voxels: one padded size, one capture,
    and the scene equals the same inserts on the CPU."""
    from zig_vulkan_tpu_torch.engine.step import GraphedCall

    rt = _step_engine(card)
    rt.tables()
    sc = scenes.default_scene(dims=(64, 32, 64))
    cpu = VoxelRT(sc.grid, sc.materials, rt.config, device="cpu")
    cpu.tables()
    before = GraphedCall.captures
    rng = np.random.default_rng(9)
    for xyz, _ in _edit_batches(rt, [int(n) for n in
                                     rng.integers(200, 1000, 8)]):
        mats = np.full(len(xyz), 3, np.uint8)
        rt.insert_voxels(xyz, mats)
        cpu.insert_voxels(xyz, mats)
    assert GraphedCall.captures - before == 1
    assert list(rt._edit_cache) == [1024]
    _same_scene(cpu.arrays, grid_mod.GridArrays(**{
        f.name: getattr(rt.arrays, f.name).cpu()
        for f in dataclasses.fields(rt.arrays)}))
    assert torch.equal(rt._tables.cpu(), cpu._tables)


@pytest.mark.cuda
def test_two_shard_replays_equal_op_by_op_and_unsharded(scene_on_card, card):
    """Two shards of one card through their graphs: each frame, with the
    camera and the sun moved between calls, equals the same step op by op
    and the unsharded replayed frame bit for bit; one trace and one
    post-process capture a shard."""
    from zig_vulkan_tpu_torch.engine.step import GraphedCall
    from zig_vulkan_tpu_torch.parallel import mesh as pmesh

    rt = scene_on_card
    m = pmesh.make_mesh([card] * 2)
    kw, _ = _sharded_inputs(rt, card)
    step = pmesh.build_sharded_step(m, rt.grid_static, **kw)
    arrays_r, mats_r = pmesh.replicate_scene(m, rt.arrays, rt.mats)
    tables = pmesh.map_replicas(m, lambda a: rt.tables().clone(), arrays_r)
    rt.render()  # the frame's step captured outside the count
    before = GraphedCall.captures
    for i in range(3):
        rt.camera.turn_yaw(0.05)
        rt.update_sun(0.5)
        _, args = _sharded_inputs(rt, card)
        got = step(arrays_r, mats_r, *args, tables=tables)
        want = step.op_by_op(arrays_r, mats_r, *args, tables=tables)
        assert torch.equal(got, want), i
        assert torch.equal(got, rt.render()), i
    assert GraphedCall.captures - before == 2 * 2


# -- kernels C, D and E (ops.shade) against their plain twins ----------------------

def _bits_equal(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _assert_same(got: dict, want: dict, what=""):
    assert set(got) == set(want), what
    for k in want:
        assert got[k].shape == want[k].shape, (what, k)
        assert _bits_equal(got[k], want[k]), (what, k)


def _shade_table(card):
    t = MaterialTable.empty()
    t.set(0, MAT_DIELECTRIC, (0.117, 0.45, 0.85), 1.333)
    t.set(1, MAT_LAMBERTIAN, (0.0, 0.6, 0.0))
    t.set(2, MAT_METAL, (0.8, 0.8, 0.8), 0.3)
    t.set(3, MAT_EMISSIVE, (1.0, 0.5, 0.25), 4.0)
    t.set(4, MAT_NONE, (0.5, 0.5, 0.5))
    t.set(5, MAT_DIELECTRIC, (0.9, 0.9, 0.9), 1.52)
    t.set(6, MAT_METAL, (0.6, 0.3, 0.2), 0.0)
    return trace.materials_to_device(t, card)


_SUN = (np.float32([10.0, 30.0, 5.0]), np.float32([1.0, 0.9, 0.8]),
        np.float32(2.0))


def _lane_state(n, seed, card, mode):
    """A ray state after some levels, made by numpy from `seed`: scattered
    bouncing lanes, refracted lanes (ignore type dielectric, ir 1.333 or
    1.52), colours, loop counts and a pending sun term."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-10.0, 10.0, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = {k: torch.from_numpy(np.ascontiguousarray(a[:, i])).to(card)
            for k, a, i in zip(shade.RAY_KEYS, (o, o, o, d, d, d),
                               (0, 1, 2, 0, 1, 2))}
    state = shade.new_state(rays, mode)
    refr = rng.random(n) < 0.3
    state["ignore_type"].copy_(torch.from_numpy(
        np.where(refr, MAT_DIELECTRIC, MAT_NONE).astype(np.int32)))
    state["internal_refl"].copy_(torch.from_numpy(np.where(
        refr, rng.choice(np.float32([1.333, 1.52]), n), 1.0)
        .astype(np.float32)))
    state["loop_count"].copy_(torch.from_numpy(
        rng.integers(0, 3, n).astype(np.int32)))
    state["bouncing"].copy_(torch.from_numpy(rng.random(n) < 0.8))
    for k in shade.COLOUR_KEYS + (shade.PENDING_KEYS
                                  if mode == shade.SUN_DEFERRED else ()):
        state[k].copy_(torch.from_numpy(
            rng.uniform(0.0, 2.0, n).astype(np.float32)))
    return state, rng


def _lane_hits(n, rng, card):
    """Kernel A's and B's results of a level: misses, axis normals, hit
    points in a box, every material type."""
    axis = rng.integers(0, 3, n)
    nrm = np.zeros((n, 3), np.float32)
    nrm[np.arange(n), axis] = rng.choice(np.float32([-1.0, 1.0]), n)
    p = rng.uniform(-8.0, 8.0, (n, 3)).astype(np.float32)
    hit = dict(found=rng.random(n) < 0.8, px=p[:, 0], py=p[:, 1],
               pz=p[:, 2], nx=nrm[:, 0], ny=nrm[:, 1], nz=nrm[:, 2],
               index=rng.integers(0, 7, n).astype(np.int32),
               occluded=rng.random(n) < 0.4)
    hit = {k: torch.from_numpy(np.ascontiguousarray(v)).to(card)
           for k, v in hit.items()}
    looked = lookup.table_lookup(_shade_table(card), hit["index"])
    return hit, looked


def _clone_state(state):
    return {k: v.clone() for k, v in state.items()}


_MODES = {"no_sun": shade.SUN_OFF, "sun_in_kernel": shade.SUN_PROBE,
          "sun": shade.SUN_DEFERRED}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 257, 100_003])
@pytest.mark.parametrize("mode", list(_MODES))
@pytest.mark.parametrize("first", [True, False], ids=["first", "later"])
def test_kernel_d_matches_plain(card, n, mode, first):
    """Kernel D against `shade_plain` on the card: every state array, the
    shadow mask and directions, the next key (NaN on unrefracted lanes)
    and the next sun targets, bit for bit, on ragged lane counts."""
    m = _MODES[mode]
    state, rng = _lane_state(n, n + 7 * m, card, m)
    hit, looked = _lane_hits(n, rng, card)
    prev = None
    if m == shade.SUN_DEFERRED and not first:
        prev = torch.from_numpy(rng.random(n) < 0.5).to(card)
    kw = dict(prev_occluded=prev, next_key=True,
              next_targets=m == shade.SUN_PROBE)
    want_state, got_state = _clone_state(state), _clone_state(state)
    want = shade.shade_plain(want_state, hit, looked, m, *_SUN, **kw)
    before = shade.shade.launches
    got = shade.shade(got_state, hit, looked, m, *_SUN, **kw)
    torch.cuda.synchronize()
    assert shade.shade.launches == before + 1
    _assert_same(got, want, "outputs")
    _assert_same(got_state, want_state, "state")
    refracted = ~torch.isnan(got["key"])
    assert 0 < int(refracted.sum()) < n or n < 300


@pytest.mark.cuda
@pytest.mark.parametrize("spp,band", [(1, None), (2, None), (3, (5, 17))])
@pytest.mark.parametrize("sun", [False, True])
@pytest.mark.parametrize("on_card", [False, True],
                         ids=["host_values", "device_values"])
def test_kernel_c_matches_plain(scene_on_card, card, spp, band, sun,
                                on_card):
    """Kernel C against `camera_rays_plain` on the card at a width that
    leaves a ragged last block, bit for bit; the sample base and the sun's
    values on the host or on the card (the engine's push constants)."""
    rt = scene_on_card
    w, h = 250, 37
    row0, rows = band if band else (0, h)
    cam = trace.camera_vectors(rt.camera.d_camera, card)
    base, sun_p, radius = np.float32(3.0), _SUN[0], _SUN[2]
    if on_card:
        base, sun_p, radius = (torch.from_numpy(np.atleast_1d(v)).to(card)
                               for v in (base, sun_p, radius))
        base, radius = base[0], radius[0]
    kw = dict(sun=(sun_p, radius) if sun else None)
    want = shade.camera_rays_plain(cam, w, h, spp, base, row0, rows, **kw)
    before = shade.camera_rays.launches
    got = shade.camera_rays(cam, w, h, spp, base, row0, rows, **kw)
    torch.cuda.synchronize()
    assert shade.camera_rays.launches == before + 1
    assert got["ox"].numel() == spp * rows * w
    _assert_same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("spp", [1, 2, 3])
@pytest.mark.parametrize("sun,pending", [(False, False), (True, False),
                                         (True, True)])
def test_kernel_e_matches_plain(card, spp, sun, pending):
    """Kernel E against `resolve_plain` on the card: the pending sun term,
    the sky of lanes that never hit, the tone map, the samples' sum,
    division and square root; and the per-lane tone map."""
    m = 4099
    mode = shade.SUN_DEFERRED if pending else shade.SUN_OFF
    state, rng = _lane_state(spp * m, spp, card, mode)
    occ = (torch.from_numpy(rng.random(spp * m) < 0.5).to(card)
           if pending else None)
    sun_c = _SUN[1] if sun else None
    want = shade.resolve_plain(state, spp, sun_c, occ)
    before = shade.resolve.launches
    got = shade.resolve(state, spp, sun_c, occ)
    torch.cuda.synchronize()
    assert shade.resolve.launches == before + 1
    assert got.shape == (m, 3)
    assert _bits_equal(got, want)
    if spp == 1:
        lanes = shade.resolve(state, 1, sun_c, occ, gamma=False)
        assert _bits_equal(lanes, shade.resolve_plain(state, 1, sun_c, occ,
                                                      gamma=False))


@pytest.mark.cuda
def test_shading_wrappers_reject_what_the_kernels_do_not_take(scene_on_card,
                                                              card):
    rt = scene_on_card
    n = 1000
    state, rng = _lane_state(n, 1, card, shade.SUN_DEFERRED)
    hit, looked = _lane_hits(n, rng, card)
    args = (hit, looked, shade.SUN_DEFERRED, *_SUN)
    bad = dict(state, cr=state["cr"].double())
    with pytest.raises(ValueError, match="float32"):
        shade.shade(bad, *args)
    bad = dict(state, dx=torch.zeros(2 * n, device=card)[::2])
    with pytest.raises(ValueError, match="contiguous"):
        shade.shade(bad, *args)
    with pytest.raises(ValueError, match="on cuda"):
        shade.shade(state, dict(hit, px=hit["px"].cpu()), *args[1:])
    with pytest.raises(ValueError, match="sun_color"):
        shade.shade(state, hit, looked, shade.SUN_DEFERRED, _SUN[0],
                    torch.from_numpy(_SUN[1]), _SUN[2])
    with pytest.raises(ValueError, match="prev_occluded"):
        shade.shade(state, hit, looked, shade.SUN_OFF,
                    prev_occluded=hit["found"])
    cam = trace.camera_vectors(rt.camera.d_camera, card)
    with pytest.raises(ValueError, match="sample_base"):
        shade.camera_rays(cam, 64, 32, 1, torch.tensor(1.0))
    with pytest.raises(ValueError, match="contiguous"):
        shade.camera_rays(dict(cam, origin=torch.zeros(6, device=card)[::2]),
                          64, 32)
    with pytest.raises(ValueError, match="int32"):
        shade.resolve(dict(state, loop_count=state["loop_count"].long()), 1)
    with pytest.raises(ValueError, match="whole samples"):
        shade.resolve(state, 3)


@pytest.mark.cuda
def test_kernels_c_d_e_on_two_streams(scene_on_card, card):
    """Two wavefronts, each on its own stream: C, D and E launch on the
    current stream and equal their twins."""
    rt = scene_on_card
    cam = trace.camera_vectors(rt.camera.d_camera, card)
    inputs = []
    for seed in (1, 2):
        state, rng = _lane_state(70_001, seed, card, shade.SUN_DEFERRED)
        hit, looked = _lane_hits(70_001, rng, card)
        inputs.append((state, hit, looked))
    want = [(shade.camera_rays_plain(cam, 160 + i, 90, 2, 1.0 + i),
             shade.shade_plain(_clone_state(st), h, lk, shade.SUN_DEFERRED,
                               *_SUN),
             shade.resolve_plain(st, 1, _SUN[1]))
            for i, (st, h, lk) in enumerate(inputs)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = []
    for i, (s, (st, h, lk)) in enumerate(zip(streams, inputs)):
        with torch.cuda.stream(s):
            got.append((shade.camera_rays(cam, 160 + i, 90, 2, 1.0 + i),
                        shade.resolve(st, 1, _SUN[1]),
                        shade.shade(_clone_state(st), h, lk,
                                    shade.SUN_DEFERRED, *_SUN)))
    torch.cuda.synchronize()
    for (rays, colour, out), (w_rays, w_out, w_colour) in zip(got, want):
        _assert_same(rays, w_rays)
        _assert_same(out, w_out)
        assert _bits_equal(colour, w_colour)


@pytest.mark.cuda
@pytest.mark.parametrize("sun_in_kernel", [False, True])
def test_replayed_step_runs_kernels_c_d_e(card, sun_in_kernel):
    """The engine's step with the shading kernels inside: each replay equals
    the body op by op bit for bit; op by op a frame (3 levels, sun) makes 1
    C, 3 D and 1 E launch through the wrappers, and a replay runs the same
    launches on the card without calling them."""
    rt = _step_engine(card)
    rt.trace_config = TraceConfig(sun_in_kernel=sun_in_kernel)
    rt.render()
    for _ in range(2):
        rt.camera.turn_yaw(0.05)
        got, want = both_routes(rt)
        assert torch.equal(got, want)
    shade.reset_launch_counts()
    rt.render_op_by_op()
    assert (shade.camera_rays.launches, shade.shade.launches,
            shade.resolve.launches) == (1, 3, 1)
    rt.render()
    assert shade.shade.launches == 3
    replayed = _card_launches(rt.render, 2)
    assert (replayed["C"], replayed["D"], replayed["E"]) == (1, 3, 1)
    assert replayed["A"] == (3 if sun_in_kernel else 6)


# -- kernel F: the post-process -----------------------------------------------------

def _f_same(got, want):
    """Bit for bit by int32 views, NaN positions equal (a NaN's payload is
    whatever the card's arithmetic made of it)."""
    if got.shape != want.shape:
        return False
    same = got.view(torch.int32) == want.view(torch.int32)
    return bool((same | (torch.isnan(got) & torch.isnan(want))).all())


def _f_image(card, h, w, seed, kind="uniform"):
    """An f32[h, w, 3] image made by numpy from `seed`: values in [0, 1),
    or with zeros, NaN, inf, negatives and large HDR values sprinkled in
    ("special"), or all zero ("zeros")."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, 1.0, (h, w, 3)).astype(np.float32)
    if kind == "zeros":
        img[:] = 0.0
    if kind == "special":
        pick = rng.random((h, w))
        img[pick < 0.05] = 0.0
        img[(pick >= 0.05) & (pick < 0.07), 1] = np.nan
        img[(pick >= 0.07) & (pick < 0.09), 0] = np.inf
        img[(pick >= 0.09) & (pick < 0.15)] *= -1.0
        img[(pick >= 0.15) & (pick < 0.25)] *= 1e4
    return torch.from_numpy(img).to(card)


def _f_out(mode, h, w):
    """(output rows, columns, denoiser on) of a kernel F mode."""
    if mode == "same":
        return h, w, True
    if mode == "down":
        return max(1, h * 2 // 3), max(1, w * 2 // 3), True
    return h + h // 4 + 1, w + w // 4 + 1, mode == "up"


def _f_both(img, cfg, out_h, out_w, band=None):
    """(kernel F's result, the plain version's, kernel F's launches)."""
    want = denoise.postprocess_plain(img, cfg, out_h, out_w, band)
    before = denoise.postprocess.launches
    got = denoise.postprocess(img, cfg, out_h, out_w, band)
    torch.cuda.synchronize()
    return got, want, denoise.postprocess.launches - before


_F_MODES = ("same", "up", "down", "resample_only")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (576, 1024), (1080, 1920)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", _F_MODES)
def test_kernel_f_matches_plain(card, shape, mode):
    """Kernel F against `postprocess_plain` on the card at the default
    denoiser: the shifted path at equal size, the resampling path up and
    down, and the resample alone; one launch each."""
    h, w = shape
    out_h, out_w, on = _f_out(mode, h, w)
    img = _f_image(card, h, w, h + w)
    got, want, launches = _f_both(img, DenoiserConfig(enabled=on), out_h,
                                  out_w)
    assert launches == 1
    assert got.shape == (out_h, out_w, 3)
    assert _f_same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("samples", [1, 8, 20, 32])
@pytest.mark.parametrize("masked", [False, True], ids=["static", "masked"])
@pytest.mark.parametrize("mode", ["same", "up"])
def test_kernel_f_samples(card, monkeypatch, samples, masked, mode):
    """Each spiral length, the static loop and the runtime `samples` over
    the masked MAX_RUNTIME_SAMPLES spiral, bit for bit against the plain
    version; the masked spiral's plain version, given the static table's
    influences (the runtime builds compute theirs on the card), equals the
    static loop bit for bit: on a finite image the masked taps add
    nothing."""
    h, w = 97, 161
    out_h, out_w, _ = _f_out(mode, h, w)
    img = _f_image(card, h, w, samples)
    kw = (dict(samples=float(samples), max_samples=32) if masked
          else dict(samples=samples))
    want = denoise.denoise_plain(img, out_shape=(out_h, out_w), **kw)
    got = denoise.denoise(img, out_shape=(out_h, out_w), **kw)
    torch.cuda.synchronize()
    assert _f_same(got, want)
    static = denoise.denoise(img, samples=samples, out_shape=(out_h, out_w))
    if masked:
        host = denoise.spiral_taps(samples)["influence"]
        table = torch.from_numpy(np.concatenate(
            [host, np.full(33 - host.size, np.nan, np.float32)])).to(card)
        monkeypatch.setattr(denoise, "runtime_influences",
                            lambda s, b, r2: table)
        got = denoise.denoise_plain(img, out_shape=(out_h, out_w), **kw)
    assert torch.equal(got.view(torch.int32), static.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("pixel_multiplier", [1.0, 1.5, 3.0])
@pytest.mark.parametrize("mode", ["same", "up", "down"])
def test_kernel_f_pixel_multiplier(card, pixel_multiplier, mode):
    h, w = 120, 200
    out_h, out_w, _ = _f_out(mode, h, w)
    img = _f_image(card, h, w, 3)
    cfg = DenoiserConfig(pixel_multiplier=pixel_multiplier)
    got, want, launches = _f_both(img, cfg, out_h, out_w)
    assert launches == 1 and _f_same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("exponent", [0.0, 1.0, 0.5, -0.5, -1.0, 2.0, 3.0,
                                      -2.0, 8.0, 20.0, 7.3])
@pytest.mark.parametrize("kind", ["uniform", "special"])
def test_kernel_f_hue_exponents(card, exponent, kind):
    """`inverse_hue_tolerance` at each exponent ATen's pow treats apart (a
    fill, a copy, sqrt, rsqrt, the reciprocal and the products) and at
    powf's, bit for bit against the plain version."""
    img = _f_image(card, 64, 96, 11, kind)
    cfg = DenoiserConfig(inverse_hue_tolerance=exponent)
    for out_h, out_w in ((64, 96), (80, 120)):
        got, want, _ = _f_both(img, cfg, out_h, out_w)
        assert _f_same(got, want), (out_h, out_w)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["special", "zeros"])
@pytest.mark.parametrize("mode", _F_MODES)
def test_kernel_f_special_values(card, kind, mode):
    """Zeros (a centre of length 0), NaN, inf, negatives and large HDR
    values: NaN in the same pixels, every other value bit for bit."""
    h, w = 75, 133
    out_h, out_w, on = _f_out(mode, h, w)
    img = _f_image(card, h, w, 5, kind)
    got, want, _ = _f_both(img, DenoiserConfig(enabled=on), out_h, out_w)
    assert _f_same(got, want)
    if kind == "special" and on:
        assert bool(torch.isnan(got).any()) and bool(
            torch.isfinite(got).any())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", _F_MODES)
def test_kernel_f_bands(card, n, mode):
    """Output rows in `n` bands, each from its slab of `band_input_rows`
    (the halo included): each band equals its plain version and the rows
    of the whole image's result, bit for bit."""
    h, w = 144, 256
    out_h, out_w, on = _f_out(mode, h, w)
    cfg = DenoiserConfig(enabled=on)
    img = _f_image(card, h, w, n)
    whole = denoise.postprocess(img, cfg, out_h, out_w)
    bands = []
    for i in range(n):
        r0, r1 = i * out_h // n, (i + 1) * out_h // n
        a, b = denoise.band_input_rows(r0, r1, out_h, h, cfg)
        band = denoise.Band(r0, r1, a, h)
        got, want, launches = _f_both(img[a:b].clone(), cfg, out_h, out_w,
                                      band)
        assert launches == 1 and _f_same(got, want), i
        bands.append(got)
    assert torch.equal(torch.cat(bands).view(torch.int32),
                       whole.view(torch.int32))


def _f_build(fn):
    """(fn()'s result, the one kernel F build it launched)."""
    before = dict(denoise.postprocess.build_launches)
    got = fn()
    torch.cuda.synchronize()
    ran = [k for k, v in denoise.postprocess.build_launches.items()
           if v != before[k]]
    assert len(ran) == 1 and denoise.postprocess.build_launches[ran[0]] \
        == before[ran[0]] + 1, ran
    return got, ran[0]


# sizes at the shifted tile's edges (32 x 8 pixels a block at the
# defaults, whose halo is 7 x 7): 1, 2, the halo, twice it and one, and
# the tile's sides and either side of them
_F_EDGES = (1, 2, 7, 8, 9, 15, 31, 33)


@pytest.mark.cuda
@pytest.mark.parametrize("w", _F_EDGES)
@pytest.mark.parametrize("h", _F_EDGES)
def test_kernel_f_tile_edges(card, h, w):
    """The tiled build at equal size and the resampling build up, at every
    pair of edge sizes, with no tap, the default spiral and the longest:
    bit for bit against the plain version."""
    img = _f_image(card, h, w, 7 * h + w)
    for samples in (0, 20, 32):
        cfg = DenoiserConfig(samples=samples)
        for (out_h, out_w), build in (((h, w), "shifted_tile"),
                                      ((h + h // 4 + 1, w + w // 4 + 1),
                                       "resample")):
            want = denoise.postprocess_plain(img, cfg, out_h, out_w)
            got, ran = _f_build(
                lambda: denoise.postprocess(img, cfg, out_h, out_w))
            assert ran == build and _f_same(got, want), (samples, out_h)


@pytest.mark.cuda
@pytest.mark.parametrize("pixel_multiplier, build, rows", [
    (1.5, "shifted_tile", 8), (29.0, "shifted_tile", 4),
    (29.6, "shifted_tile", 2), (29.76, "shifted_tile", 1),
    (50.0, "shifted_global", 8)])
@pytest.mark.parametrize("n", [1, 3])
def test_kernel_f_wide_halos(card, pixel_multiplier, build, rows, n):
    """A halo that outgrows the default tile takes fewer rows of threads,
    and one no tile holds the untiled build: each chosen on the host from
    the taps, each bit for bit against the plain version, on the whole
    image and on bands whose slabs start past row 0."""
    h, w = 300, 150
    cfg = DenoiserConfig(pixel_multiplier=pixel_multiplier)
    plan = denoise.launch_plan(denoise.spiral_taps(
        20, pixel_multiplier=pixel_multiplier), denoise.SHIFTED)
    assert (plan.build, plan.block_rows) == (build, rows)
    img = _f_image(card, h, w, int(pixel_multiplier))
    whole = denoise.postprocess(img, cfg, h, w)
    bands = []
    for i in range(n):
        r0, r1 = i * h // n, (i + 1) * h // n
        a, b = denoise.band_input_rows(r0, r1, h, h, cfg)
        band = denoise.Band(r0, r1, a, h)
        slab = img[a:b].clone()
        want = denoise.postprocess_plain(slab, cfg, h, w, band)
        got, ran = _f_build(
            lambda: denoise.postprocess(slab, cfg, h, w, band))
        assert ran == build and _f_same(got, want), i
        bands.append(got)
    assert torch.equal(torch.cat(bands).view(torch.int32),
                       whole.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("exponent", [0.0, 1.0, 0.5, -0.5, -1.0, 2.0, 3.0,
                                      -2.0, 20.0])
def test_kernel_f_hue_branches_in_every_build(card, exponent):
    """Each of the hue's pow branches in each denoiser build (the tiled and
    untiled shifted builds and the resampling build), on a band of an image
    with zeros, NaN, inf, negatives and HDR values."""
    h, w = 70, 101
    img = _f_image(card, h, w, 17, "special")
    for pixel_multiplier, (out_h, out_w), build in (
            (1.5, (h, w), "shifted_tile"),
            (50.0, (h, w), "shifted_global"),
            (1.5, (h + 9, w + 13), "resample")):
        cfg = DenoiserConfig(inverse_hue_tolerance=exponent,
                             pixel_multiplier=pixel_multiplier)
        r0, r1 = out_h // 3, 2 * out_h // 3
        a, b = denoise.band_input_rows(r0, r1, out_h, h, cfg)
        band = denoise.Band(r0, r1, a, h)
        slab = img[a:b].clone()
        want = denoise.postprocess_plain(slab, cfg, out_h, out_w, band)
        got, ran = _f_build(
            lambda: denoise.postprocess(slab, cfg, out_h, out_w, band))
        assert ran == build and _f_same(got, want), pixel_multiplier


@pytest.mark.cuda
@pytest.mark.parametrize("pixel_multiplier, mode", [
    (1.5, denoise.SHIFTED), (29.76, denoise.SHIFTED),
    (50.0, denoise.SHIFTED), (1.5, denoise.RESAMPLE),
    (1.5, denoise.RESAMPLE_ONLY)])
def test_kernel_f_occupancy_of_each_build(card, pixel_multiplier, mode):
    """The runtime holds at least one block an SM of each build at its
    plan's block shape and shared bytes, and no more warps than an SM
    has."""
    taps = denoise.spiral_taps(20, pixel_multiplier=pixel_multiplier)
    plan = denoise.launch_plan(None if mode == denoise.RESAMPLE_ONLY
                               else taps, mode)
    a = _build.DenoiseArgs()
    a.mode, a.tiled = mode, int(plan.build == "shifted_tile")
    a.block_rows, a.smem = plan.block_rows, plan.smem_bytes
    blocks = ctypes.c_int()
    _build.check(_build.library().zvt_denoise_occupancy(
        ctypes.byref(a), ctypes.byref(blocks)), "zvt_denoise_occupancy")
    assert 1 <= blocks.value and blocks.value * plan.block_rows <= 64


@pytest.mark.cuda
def test_kernel_f_refuses_what_it_does_not_take(card):
    img = _f_image(card, 40, 64, 1)
    cfg = DenoiserConfig()
    with pytest.raises(ValueError, match="float32"):
        denoise.postprocess(img.double(), cfg, 40, 64)
    with pytest.raises(ValueError, match="float32"):
        denoise.postprocess(torch.zeros(40, 64, 4, device=card), cfg, 40, 64)
    with pytest.raises(ValueError, match="contiguous"):
        denoise.postprocess(img.transpose(0, 1), cfg, 64, 40)
    with pytest.raises(ValueError, match="no pixel"):
        denoise.postprocess(torch.zeros(0, 64, 3, device=card), cfg, 40, 64)
    with pytest.raises(ValueError, match="at most 33 taps"):
        denoise.denoise(img, samples=40.0, max_samples=40)
    # the runtime builds run every tap of the spiral, masked or not: a
    # 41-tap spiral is refused whatever `samples` is
    with pytest.raises(ValueError, match="at most 33 taps"):
        denoise.denoise(img, samples=3.0, max_samples=40)
    # a runtime launch's knobs are 0-d float32 tensors on its device
    with pytest.raises(ValueError, match="0-d"):
        denoise.denoise(img, samples=torch.ones(2, device=card),
                        max_samples=32)
    # a band whose slab lacks the halo rows the spiral reads
    a, b = denoise.band_input_rows(20, 30, 40, 40, cfg)
    with pytest.raises(ValueError, match="read image rows"):
        denoise.postprocess(img[20:30].clone(), cfg, 40, 64,
                            band=denoise.Band(20, 30, 20, 40))
    with pytest.raises(ValueError, match="output rows"):
        denoise.postprocess(img[a:b].clone(), cfg, 40, 64,
                            band=denoise.Band(20, 50, a, 40))
    # a CPU tensor goes to the plain version, and launches nothing
    before = denoise.postprocess.launches
    cpu = denoise.postprocess(img.cpu(), cfg, 40, 64)
    assert denoise.postprocess.launches == before
    assert _f_same(cpu, denoise.postprocess_plain(img.cpu(), cfg, 40, 64))
    # at the input's size the resample alone is the rows themselves
    assert torch.equal(denoise.bilinear_resample(img, 40, 64), img)
    assert denoise.postprocess.launches == before


@pytest.mark.cuda
def test_kernel_f_on_two_streams(card):
    """Two images, each on its own stream: kernel F launches on the current
    stream and equals its plain version."""
    cfg = DenoiserConfig()
    imgs = [_f_image(card, 300, 500, seed) for seed in (1, 2)]
    want = [denoise.postprocess_plain(img, cfg, 300, 500) for img in imgs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = []
    for s, img in zip(streams, imgs):
        with torch.cuda.stream(s):
            got.append(denoise.postprocess(img, cfg, 300, 500))
    torch.cuda.synchronize()
    assert all(_f_same(g, w_) for g, w_ in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["resampling", "same size", "temporal"])
def test_replayed_step_launches_kernel_f_once(card, case):
    """The engine's denoised step (256x144 to 320x180, or at 256x144, or
    with the temporal mean): each replay equals the body op by op bit for
    bit; op by op a frame makes one kernel F launch through the wrapper,
    and a trace of the card shows one a frame on both routes."""
    rt = _step_engine(card, temporal=case == "temporal")
    if case == "same size":
        rt.set_resolutions(output=(256, 144))
    rt.render()
    for _ in range(2):
        if case != "temporal":  # the temporal mean runs over a still pose
            rt.camera.turn_yaw(0.05)
        got, want = both_routes(rt)
        assert torch.equal(got, want)
    denoise.reset_launch_counts()
    rt.render_op_by_op()
    assert denoise.postprocess.launches == 1
    rt.render()
    assert denoise.postprocess.launches == 1
    assert _card_launches(rt.render, 2)["F"] == 1
    assert _card_launches(rt.render_op_by_op, 1)["F"] == 1


# -- kernel F's runtime builds: the knobs in device memory ---------------------------

_HUE_EXPONENTS = [0.0, 1.0, 0.5, -0.5, -1.0, 2.0, 3.0, -2.0, 8.0, 20.0, 7.3]


def _knobs(card, samples, bias=0.6, hue=20.0):
    """A DenoiserConfig whose runtime knobs are 0-d float32 tensors on the
    card."""
    return DenoiserConfig(**{k: torch.tensor(np.float32(v), device=card)
                             for k, v in (("samples", samples),
                                          ("distribution_bias", bias),
                                          ("inverse_hue_tolerance", hue))})


def _f_runtime(img, cfg, out_h, out_w, band=None):
    """(the runtime build's result, the twin's, the build launched)."""
    want = denoise.postprocess_plain(img, cfg, out_h, out_w, band,
                                     max_samples=32)
    got, ran = _f_build(lambda: denoise.postprocess(
        img, cfg, out_h, out_w, band, max_samples=32))
    return got, want, ran


@pytest.mark.cuda
@pytest.mark.parametrize("exponent", _HUE_EXPONENTS)
def test_aten_pow_with_a_device_exponent_is_powf(card, exponent):
    """ATen's pow with a 0-d exponent on the card runs its generic powf
    kernel, the same as with a full tensor of the exponent; with the
    exponent as a Python number it takes the branches kernel F's static
    builds copy (`pow_branch`), which differ from powf at 0.5, -0.5, -1, 2,
    3 and -2 (as NVIDIA H100 80GB HBM3, torch 2.11 and CUDA 12.8 showed).
    The runtime twin's hue and influences rely on the first."""
    g = torch.Generator().manual_seed(0)
    x = torch.cat([torch.rand(1 << 16, generator=g), torch.tensor(
        [0.0, -0.0, 1.0, float("inf"), float("nan"), 1e-30, 3.0e38])])
    x = torch.clamp(x.to(card), min=0.0)
    e = torch.tensor(exponent, device=card)
    device_exp = torch.pow(x, e)
    assert _f_same(device_exp, torch.pow(x, torch.full_like(x, exponent)))
    assert _f_same(device_exp, torch.pow(x, e.expand_as(x)))
    scalar = torch.pow(x, exponent)
    if denoise.pow_branch(exponent) in (denoise.POW_POWF, 1, 2):
        assert _f_same(device_exp, scalar)
    else:
        assert not _f_same(device_exp, scalar)


@pytest.mark.cuda
@pytest.mark.parametrize("exponent", _HUE_EXPONENTS)
@pytest.mark.parametrize("samples", [1, 20, 32])
def test_kernel_f_runtime_hue_exponents(card, samples, exponent):
    """The runtime builds (tiled, untiled at pixel_multiplier 50, and
    resampling) at every hue exponent, bit for bit against the twin on an
    image with zeros, NaN, inf, negatives and HDR values."""
    h, w = 64, 96
    img = _f_image(card, h, w, 11, "special")
    for pixel_multiplier, (out_h, out_w), build in (
            (1.5, (h, w), "shifted_tile_runtime"),
            (50.0, (h, w), "shifted_global_runtime"),
            (1.5, (80, 120), "resample_runtime")):
        cfg = dataclasses.replace(_knobs(card, samples, hue=exponent),
                                  pixel_multiplier=pixel_multiplier)
        got, want, ran = _f_runtime(img, cfg, out_h, out_w)
        assert ran == build and _f_same(got, want), (pixel_multiplier, ran)


@pytest.mark.cuda
@pytest.mark.parametrize("samples", [0, 1, 8, 20, 31.5, 32])
@pytest.mark.parametrize("mode", ["same", "up", "down"])
def test_kernel_f_runtime_planted_nonfinite(card, samples, mode):
    """An Inf and a NaN planted in a finite image: the runtime build's
    masked taps spread them as the twin's (NaN in the same pixels, every
    other value bit for bit), and the tiled build's blocks that skip their
    masked taps (a finite tile) equal the twin too; fewer taps than 32
    make pixels non-finite that the static loop leaves finite."""
    h, w = 75, 133
    out_h, out_w, _ = _f_out(mode, h, w)
    img = _f_image(card, h, w, 5)
    img[30, 40, 0] = float("inf")
    img[50, 90, 2] = float("nan")
    got, want, _ = _f_runtime(img, _knobs(card, samples), out_h, out_w)
    assert _f_same(got, want)
    if 1 <= samples < 32 and mode == "same":
        static = denoise.denoise(img, samples=int(samples))
        assert int((~torch.isfinite(got)).sum()) > int(
            (~torch.isfinite(static)).sum())
        assert bool(torch.isfinite(got).any())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("mode", ["same", "up"])
def test_kernel_f_runtime_bands(card, n, mode):
    """Bands of the runtime path from their slabs (`band_input_rows` with
    the 33-tap spiral's halo): each equal to its twin and the rows of the
    whole image's result, bit for bit, a planted NaN included."""
    h, w = 144, 256
    out_h, out_w, _ = _f_out(mode, h, w)
    cfg = _knobs(card, 8, hue=3.0)
    img = _f_image(card, h, w, n)
    img[70, 100, 1] = float("nan")
    whole = denoise.postprocess(img, cfg, out_h, out_w, max_samples=32)
    bands = []
    for i in range(n):
        r0, r1 = i * out_h // n, (i + 1) * out_h // n
        a, b = denoise.band_input_rows(r0, r1, out_h, h, cfg, max_samples=32)
        got, want, _ = _f_runtime(img[a:b].clone(), cfg, out_h, out_w,
                                  denoise.Band(r0, r1, a, h))
        assert _f_same(got, want), i
        bands.append(got)
    assert _f_same(torch.cat(bands), whole)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["same", "up"])
def test_kernel_f_runtime_graph_reads_the_knobs_in_place(card, mode):
    """A CUDA graph captures the runtime build with the knobs as views of a
    push-constant tensor; values written into pc[19], pc[20] and pc[23] on
    the card after the capture change each replay's output to the twin's
    at the new values."""
    h, w = 96, 160
    out_h, out_w, _ = _f_out(mode, h, w)
    img = _f_image(card, h, w, 3, "special")
    pc = torch.zeros(24, device=card)
    pc[19], pc[20], pc[23] = 0.6, 20.0, 20.0
    cfg = DenoiserConfig(samples=pc[23], distribution_bias=pc[19],
                         inverse_hue_tolerance=pc[20])

    def run():
        return denoise.postprocess(img, cfg, out_h, out_w, max_samples=32)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    outputs = []
    for samples, bias, hue in ((8.0, 0.3, 2.0), (32.0, 1.0, 0.5),
                               (1.0, 0.45, 7.3), (20.0, 0.6, 20.0)):
        pc[23].fill_(samples)
        pc[19].fill_(bias)
        pc[20].fill_(hue)
        graph.replay()
        torch.cuda.synchronize()
        want = denoise.postprocess_plain(img, _knobs(card, samples, bias, hue),
                                         out_h, out_w, max_samples=32)
        assert _f_same(out, want), (samples, bias, hue)
        outputs.append(out.clone())
    assert not _f_same(outputs[0], outputs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [denoise.SHIFTED, denoise.RESAMPLE])
@pytest.mark.parametrize("pixel_multiplier", [1.5, 50.0])
def test_kernel_f_occupancy_of_the_runtime_builds(card, pixel_multiplier,
                                                  mode):
    """The runtime holds at least one block an SM of each runtime build at
    its plan's block shape and shared bytes (its influences' static bytes
    besides)."""
    taps = denoise.spiral_taps(20.0, pixel_multiplier=pixel_multiplier,
                               max_samples=32)
    plan = denoise.launch_plan(taps, mode)
    assert plan.build.endswith("_runtime")
    a = _build.DenoiseArgs()
    a.mode, a.runtime = mode, 1
    a.tiled = int(plan.build == "shifted_tile_runtime")
    a.block_rows, a.smem = plan.block_rows, plan.smem_bytes
    blocks = ctypes.c_int()
    _build.check(_build.library().zvt_denoise_occupancy(
        ctypes.byref(a), ctypes.byref(blocks)), "zvt_denoise_occupancy")
    assert 1 <= blocks.value and blocks.value * plan.block_rows <= 64


@pytest.mark.cuda
def test_slider_moves_replay_one_graph(card):
    """Moves of the denoiser's samples, distribution bias and hue tolerance
    between frames keep the step and its one capture: each replay equals
    the body op by op (the runtime build reading the new push constants),
    and a trace of a replay shows its one kernel F launch."""
    from zig_vulkan_tpu_torch.engine.step import GraphedCall

    rt = _step_engine(card)
    rt.set_resolutions(output=(256, 144))
    rt.render()
    step, before = rt.step(), GraphedCall.captures
    images = []
    for knobs in (dict(samples=8), dict(distribution_bias=0.3),
                  dict(inverse_hue_tolerance=2.0),
                  dict(samples=32, inverse_hue_tolerance=0.5),
                  dict(samples=1, distribution_bias=1.0,
                       inverse_hue_tolerance=-1.0)):
        rt.set_denoiser(**knobs)
        got, want = both_routes(rt)
        assert torch.equal(got, want), knobs
        images.append(got)
    assert rt.step() is step and GraphedCall.captures == before
    assert not torch.equal(images[0], images[1])
    assert _card_launches(rt.render, 2)["F"] == 1
