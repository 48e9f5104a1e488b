"""BASELINE configs 1, 2, 4 and 5 (benchmarks/configs.py:81-252) in
zig_vulkan_tpu_torch against the JAX package, at the small `scale` of
tests/test_bench_configs.py. One function makes each configuration for both
packages from the same numpy inputs.

Tolerances, as in tests/test_torch_engine.py: primary-ray frames (config 1)
to 1e-5; path-traced frames against the jitted JAX engine statistically
(mean |d| < 5e-3 and fewer than 1% of pixels further than 1e-3 on traced
frames; the mean bound alone once the denoiser has spread each differing
pixel over its 21 taps). Config 4's emissive, temporally accumulated traced
frames are also held bit for bit against the reference run op by op with
both packages' square roots made exact (tests/test_torch_parallel.py says
why). Config 5's streamed scene is equal array for array, and its sharded
frame equals the unsharded one bit for bit.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zig_vulkan_tpu.config as rconfig
import zig_vulkan_tpu.core.grid as rgrid
import zig_vulkan_tpu.core.materials as rmaterials
import zig_vulkan_tpu.engine.engine as rengine
import zig_vulkan_tpu.io.streaming as rstreaming
import zig_vulkan_tpu.models.scenes as rscenes
import zig_vulkan_tpu.ops.trace as rtrace
import zig_vulkan_tpu_torch.config as tconfig
import zig_vulkan_tpu_torch.core.grid as tgrid
import zig_vulkan_tpu_torch.core.materials as tmaterials
import zig_vulkan_tpu_torch.engine.engine as tengine
import zig_vulkan_tpu_torch.io.streaming as tstreaming
import zig_vulkan_tpu_torch.models.scenes as tscenes
import zig_vulkan_tpu_torch.ops.trace as ttrace
from zig_vulkan_tpu_torch.ops import denoise as tdenoise
from zig_vulkan_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(2)

REF = types.SimpleNamespace(config=rconfig, grid=rgrid, materials=rmaterials,
                            scenes=rscenes, streaming=rstreaming,
                            engine=lambda g, m, c: rengine.VoxelRT(g, m, c))
PORT = types.SimpleNamespace(config=tconfig, grid=tgrid, materials=tmaterials,
                             scenes=tscenes, streaming=tstreaming,
                             engine=lambda g, m, c: tengine.VoxelRT(
                                 g, m, c, device="cpu"))

FIELDS = ("statuses", "indices", "occupancy", "start_indices",
          "material_indices", "active_bricks", "material_cursor",
          "diel_mask", "brick_ir")
EMISSIVE = 40


def build(p, number, scale):
    """Config `number` of benchmarks/configs.py at `scale` for the package
    bundle `p`: its engine, before any frame."""
    c = p.config
    if number == 1:
        dim = max(2, int(16 * scale))
        res = max(32, int(256 * scale))
        grid = p.grid.BrickGrid(dim, dim, dim, c.GridConfig(scale=1.0))
        vx, vy, vz = grid.static.voxel_dims
        xs, ys, zs = np.meshgrid(np.arange(vx), np.arange(vy // 2),
                                 np.arange(vz), indexing="ij")
        grid.insert_batch(xs.ravel(), ys.ravel(), zs.ravel(),
                          np.full(xs.size, 1, dtype=np.uint8))
        return p.engine(grid, p.materials.terrain_materials(), c.EngineConfig(
            internal_resolution_width=res, internal_resolution_height=res,
            camera=c.CameraConfig(origin=(dim / 2, dim * 0.9, dim * 2.5),
                                  samples_per_pixel=1, max_bounce=0),
            sun=c.SunConfig(enabled=False),
            denoiser=c.DenoiserConfig(enabled=False)))
    if number == 2:
        dims = (max(4, int(128 * scale)), max(2, int(64 * scale)),
                max(4, int(128 * scale)))
        w, h = max(64, int(1280 * scale)), max(36, int(720 * scale))
        scene = p.scenes.default_scene(dims=dims)
        return p.engine(scene.grid, scene.materials, c.EngineConfig(
            internal_resolution_width=w, internal_resolution_height=h,
            camera=c.CameraConfig(origin=(0.0, 0.0, 0.0),
                                  samples_per_pixel=1, max_bounce=0),
            sun=c.SunConfig(enabled=True, animate=False),
            denoiser=c.DenoiserConfig(enabled=False),
            trace=c.TraceConfig(max_steps=160)))
    if number == 4:
        dims = (max(4, int(64 * scale)), max(2, int(32 * scale)),
                max(4, int(64 * scale)))
        w, h = max(64, int(1920 * scale)), max(36, int(1080 * scale))
        scene = p.scenes.default_scene(dims=dims, with_model=False)
        scene.materials.set(EMISSIVE, p.materials.MAT_EMISSIVE,
                            (1.0, 0.85, 0.4), 8.0)
        vx, vy, vz = scene.grid.static.voxel_dims
        xs, ys, zs = np.meshgrid(
            np.arange(max(0, vx // 2 - 4), vx // 2 + 4),
            np.arange(max(0, vy - 8), max(1, vy - 4)),
            np.arange(max(0, vz // 2 - 4), vz // 2 + 4), indexing="ij")
        scene.grid.insert_batch(xs.ravel(), ys.ravel(), zs.ravel(),
                                np.full(xs.size, EMISSIVE, dtype=np.uint8))
        rt = p.engine(scene.grid, scene.materials, c.EngineConfig(
            internal_resolution_width=w, internal_resolution_height=h,
            camera=c.CameraConfig(origin=(0.0, 0.0, 0.0),
                                  samples_per_pixel=2, max_bounce=3),
            sun=c.SunConfig(enabled=True, animate=False),
            denoiser=c.DenoiserConfig(enabled=True),
            trace=c.TraceConfig(max_steps=160)))
        rt.set_temporal(True)
        return rt
    assert number == 5
    dims = (max(8, int(256 * scale)), max(4, int(64 * scale)),
            max(8, int(256 * scale)))
    w = max(128, int(3840 * scale))
    h = max(8 * 8, (int(2160 * scale) // 8) * 8)
    grid = p.grid.BrickGrid(*dims, c.GridConfig(min_point=(-64, -16, -64),
                                                scale=0.5))
    rt = p.engine(grid, p.materials.terrain_materials(), c.EngineConfig(
        internal_resolution_width=w, internal_resolution_height=h,
        camera=c.CameraConfig(origin=(0.0, 0.0, 0.0), samples_per_pixel=1,
                              max_bounce=0),
        sun=c.SunConfig(enabled=False),
        denoiser=c.DenoiserConfig(enabled=False)))
    rt.streamed = p.streaming.stream_into_engine(
        rt, p.streaming.terrain_regions(grid, region_x=dims[0]))
    return rt


def _diff(a, b):
    assert a.shape == b.shape
    return np.abs(a - b).max(axis=-1)


def _scene_equal(port_arrays, ref_arrays):
    want = tgrid.GridArrays.to_device(ref_arrays, "cpu")
    for name in FIELDS:
        got, exp = getattr(port_arrays, name), getattr(want, name)
        assert torch.equal(got.reshape(-1).view(torch.uint8),
                           exp.reshape(-1).view(torch.uint8)), name


def test_config1_dense_primary_matches_reference():
    ref, port = build(REF, 1, 0.15), build(PORT, 1, 0.15)
    assert port.grid_static.scale == 1.0 and port.grid_static.dims == (2, 2, 2)
    _scene_equal(port.arrays, ref.arrays)
    got, want = port.render().numpy(), np.asarray(ref.render())
    assert got.shape == (38, 38, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the solid lower half and the sky above it
    assert len(np.unique((got * 255).astype(np.uint8).reshape(-1, 3),
                         axis=0)) > 4


def test_config2_sparse_diffuse_shadows_matches_reference():
    ref, port = build(REF, 2, 0.05), build(PORT, 2, 0.05)
    assert port.trace_config.max_steps == 160
    assert bool(port.sun.device_data.enabled)
    _scene_equal(port.arrays, ref.arrays)
    got, want = port.render().numpy(), np.asarray(ref.render())
    assert got.shape == (36, 64, 3) and np.isfinite(got).all()
    diff = _diff(got, want)
    assert diff.mean() < 5e-3
    assert (diff > 1e-3).mean() < 0.01


@pytest.fixture(scope="module")
def config4():
    """Config 4's engines and their first three accumulated frames."""
    ref, port = build(REF, 4, 0.05), build(PORT, 4, 0.05)
    frames = [(np.asarray(ref.render()), port.render().numpy())
              for _ in range(3)]
    return ref, port, frames


def _traced(rt, sample_base):
    d, sun = rt.camera.d_camera, rt.sun.device_data
    w, h = rt.internal_resolution
    return ttrace.render_rows(
        rt.grid_static, rt.tables(), rt.arrays.material_indices, rt.mats,
        ttrace.camera_vectors(d, "cpu"), w, h, int(d.samples_per_pixel),
        int(d.max_bounce), sun.position, sun.color, sun.radius, True,
        max_steps=160, sample_base=sample_base)


def test_config4_scene_and_emissive_hits(config4):
    ref, port, _ = config4
    _scene_equal(port.arrays, ref.arrays)
    assert port.temporal_enabled and port.denoiser.enabled
    assert int(port.camera.d_camera.max_bounce) == 4  # config + 1
    assert port.materials_host.mtype[EMISSIVE] == tmaterials.MAT_EMISSIVE
    # lanes of the primary wavefront hit the emissive block
    d = port.camera.d_camera
    w, h = port.internal_resolution
    r = ttrace._camera_rays_soa(ttrace.camera_vectors(d, "cpu"), w, h, 0.0)
    from zig_vulkan_tpu_torch.ops import tile_tracer as ttile

    hit = ttile.grid_hit_tiles(
        port.grid_static, port.tables(), port.arrays.material_indices,
        *r[:3], *ttrace._norm3(*r[3:]),
        torch.ones(w * h, dtype=torch.bool), max_steps=160)
    emissive = hit["found"] & (hit["index"] == EMISSIVE)
    assert int(emissive.sum()) > 0


def test_config4_accumulated_frames_match_jitted_reference(config4):
    """Temporal accumulation, then the denoiser: held to the mean bound."""
    ref, port, frames = config4
    assert ref._accum_count == port._accum_count == 3
    for want, got in frames:
        assert got.shape == want.shape == (54, 96, 3)
        assert np.isfinite(got).all()
        assert _diff(got, want).mean() < 5e-3
    assert not np.array_equal(frames[0][1], frames[2][1])
    # the port's frame is its running mean put through the reference's
    # denoiser (the stages compose as the reference's step composes them)
    from zig_vulkan_tpu.ops import denoise as rdn

    want = np.asarray(rdn.denoise(port._accum.numpy(), samples=20,
                                  out_shape=(54, 96)))
    np.testing.assert_allclose(frames[2][1], want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("sample_base", [0.0, 2.0])
def test_config4_traced_frame_bit_equal_op_by_op(monkeypatch, config4,
                                                 sample_base):
    """The emissive, sun-lit, four-level traced frame of accumulation step
    0 and step 1 (jitter seeds from 2), against the reference's
    `render_rows` run op by op; both packages with exact square roots."""
    ref, port, _ = config4
    monkeypatch.setattr(jax.lax, "rsqrt", lambda x: 1.0 / jnp.sqrt(x))
    monkeypatch.setattr(torch, "sqrt",
                        lambda x: torch.from_numpy(np.sqrt(x.numpy())))
    d, sun = ref.camera.d_camera, ref.sun.device_data
    w, h = ref.internal_resolution
    with jax.disable_jit():
        want = np.asarray(rtrace.render_rows(
            ref.grid_static, ref.arrays, ref.mats, rtrace.camera_vectors(d),
            w, h, int(d.samples_per_pixel), int(d.max_bounce),
            sun.position, sun.color, sun.radius, True, max_steps=160,
            use_skip=True, sample_base=sample_base))
    got = _traced(port, sample_base).numpy()
    np.testing.assert_array_equal(got, want)


def test_config5_streamed_scene_equals_reference_array_for_array():
    ref, port = build(REF, 5, 0.05), build(PORT, 5, 0.05)
    assert port.streamed == ref.streamed > 0
    assert port.grid_static.dims == (12, 4, 12)
    assert port.grid_static.min_point == (-64.0, -16.0, -64.0)
    _scene_equal(port.arrays, ref.arrays)

    # the frame as config 5 renders it: the exact field, then the sharded
    # step with max_bounce=1 and no sun over 8 shards
    st = port.grid_static
    w, h = port.internal_resolution
    tables = ttrace.build_trace_tables(
        st, port.arrays, ttrace.distance_field(st, port.arrays, True))
    m = pmesh.make_mesh(["cpu"] * 8)
    step = pmesh.build_sharded_step(
        m, st, width=w, height=h, spp=1, max_bounce=1, sun_enabled=False,
        denoiser=tconfig.DenoiserConfig(enabled=False))
    arrays_r, mats_r = pmesh.replicate_scene(m, port.arrays, port.mats)
    cam = ttrace.camera_vectors(port.camera.d_camera, "cpu")
    zeros3, ones3 = np.zeros(3, np.float32), np.ones(3, np.float32)
    got = step(arrays_r, mats_r, cam, zeros3, ones3, np.float32(1.0),
               tables=(tables,) * 8)
    whole = ttrace.render_rows(
        st, tables, port.arrays.material_indices, port.mats, cam, w, h, 1, 1,
        zeros3, ones3, np.float32(1.0), False)
    assert got.shape == (h, w, 3) == (104, 192, 3)
    assert torch.equal(got, tdenoise.bilinear_resample(whole, h, w))

    rtab = rtrace.build_trace_tables(
        ref.grid_static, ref.arrays,
        rtrace.distance_field(ref.grid_static, ref.arrays, True))
    np.testing.assert_array_equal(tables.numpy(), np.asarray(rtab))
    want = np.asarray(rtrace.render_rows(
        ref.grid_static, ref.arrays, ref.mats,
        rtrace.camera_vectors(ref.camera.d_camera), w, h, 1, 1,
        jnp.zeros(3), jnp.ones(3), jnp.float32(1.0), False, tables=rtab,
        use_skip=True))
    diff = _diff(got.numpy(), want)
    assert diff.mean() < 5e-3
    assert (diff > 1e-3).mean() < 0.01
