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
tested everywhere. The compiled steps (the frame, the edits, the sharded
bands) are held here as replays against their bodies op by op.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from zig_vulkan_tpu_torch import _build
from zig_vulkan_tpu_torch.config import EngineConfig, TraceConfig
from zig_vulkan_tpu_torch.core import grid as grid_mod
from zig_vulkan_tpu_torch.engine.engine import VoxelRT, both_routes
from zig_vulkan_tpu_torch.models import scenes
from zig_vulkan_tpu_torch.ops import lookup, tile_tracer, trace
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
    assert not rt.tables()[:, 3].any()


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


@pytest.mark.cuda
def test_denoiser_sweep_keeps_one_graph(card):
    """Each denoiser value is a key and a capture; the engine keeps the
    current key's step alone, so the memory the graphs hold stays flat
    over a sweep of values."""
    rt = _step_engine(card)
    held = []
    for i in range(6):
        rt.set_denoiser(distribution_bias=0.05 * (i + 1))
        rt.render()
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated(card))
        assert len(rt._step_cache) == 1
    assert max(held[2:]) <= held[1]


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
