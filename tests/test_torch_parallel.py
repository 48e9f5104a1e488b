"""Row-sharded rendering of zig_vulkan_tpu_torch (parallel/mesh.py) on
meshes of 2, 4 and 8 `cpu` shards, case by case as tests/test_parallel.py
holds the JAX package's on its 8 virtual CPU devices.

The port rounds once per operation and its RNG keys off hit positions and
the jitter seed, not lane position, so a frame rendered in bands, and a
frame through a mesh, equal the unsharded frame bit for bit (the JAX test's
atol=1e-6 is XLA fusion noise). The same holds for the denoiser on bands
with a halo. Against the JAX reference run op by op (`jax.disable_jit`) the
sharded frame is bit-equal once the two CPU backends' inexact square roots
are made exact for the run: XLA:CPU's `rsqrt` is an approximation also
when it runs alone (off by one ULP on 14.7% of the 2^20 uniform inputs of
`test_backend_square_roots_within_one_ulp`, with jax 0.9.0 and torch 2.13
on the CPU), and `zig_vulkan_tpu.ops.trace._norm3` normalizes every ray with it; torch's
vectorized CPU `sqrt` is off by one ULP on 0.65% of the same inputs (on
CUDA it is correctly rounded). The test gives `jax.lax.rsqrt` the correctly
rounded 1/sqrt(x) and `torch.sqrt` numpy's. With the backends' own
functions, op by op, the primary and the path-traced frame differ in the
last bit of 0.9% and 1.3% of their values and by 2^-24 at most (held to
2^-23, `test_sharded_frame_close_to_reference_with_backend_sqrt`; the
primary frame also to the 1e-6 of tests/test_parallel.py:34 against the
jitted reference). Against the jitted
reference, which also contracts multiply-adds, the frame is held to
tests/test_parallel.py:94-124's bound: fewer than 3% of pixels further than
1e-3.

Sizes keep every band a whole number of 32-float vectors (32 columns):
on the CPU, torch's vectorized `pow` computes a ragged tail of a tensor
with the scalar libm function, whose last bit can differ from the vector
one, so only whole vectors compare bit for bit between a band and the
whole image. A CUDA device computes every element alike.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zig_vulkan_tpu.config as rconfig
import zig_vulkan_tpu_torch.config as tconfig
from zig_vulkan_tpu.core.camera import Camera as RefCamera
from zig_vulkan_tpu.core.grid import BrickGrid as RefBrickGrid
from zig_vulkan_tpu.core.sun import Sun as RefSun
from zig_vulkan_tpu.models import scenes as rscenes
from zig_vulkan_tpu.ops import denoise as rdenoise
from zig_vulkan_tpu.ops import trace as rtrace
from zig_vulkan_tpu.parallel import mesh as rmesh
from zig_vulkan_tpu_torch.core.camera import Camera
from zig_vulkan_tpu_torch.core.grid import BrickGrid, GridArrays
from zig_vulkan_tpu_torch.core.sun import Sun
from zig_vulkan_tpu_torch.models import scenes as tscenes
from zig_vulkan_tpu_torch.ops import denoise as tdenoise
from zig_vulkan_tpu_torch.ops import trace as ttrace
from zig_vulkan_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(2)

ORIGIN = (4.0, 6.5, 15.0)
W = H = 32
FIELDS = ("statuses", "indices", "occupancy", "start_indices",
          "material_indices", "active_bricks", "material_cursor",
          "diel_mask", "brick_ir")


def _cpu_mesh(n):
    return pmesh.make_mesh(["cpu"] * n)


class Frame:
    """The 32x32 `flat_test_scene(dim=8)` frame of tests/test_parallel.py in
    the port: scene, camera and sun on the CPU."""

    def __init__(self, spp=1, max_bounce=0, sun=False):
        self.scene = tscenes.flat_test_scene(dim=8)
        self.static = self.scene.grid.static
        self.camera = Camera(75.0, W, H, tconfig.CameraConfig(
            origin=ORIGIN, samples_per_pixel=spp, max_bounce=max_bounce))
        self.sun = Sun(tconfig.SunConfig(enabled=sun)).device_data
        self.arrays = self.scene.grid.arrays.to_device("cpu")
        self.mats = ttrace.materials_to_device(self.scene.materials, "cpu")
        self.tables = ttrace.build_trace_tables(self.static, self.arrays)

    def rows(self, row0=0, rows=None, **kw):
        d = self.camera.d_camera
        return ttrace.render_rows(
            self.static, self.tables, self.arrays.material_indices,
            self.mats, ttrace.camera_vectors(d, "cpu"), W, H,
            int(d.samples_per_pixel), int(d.max_bounce), self.sun.position,
            self.sun.color, self.sun.radius, bool(self.sun.enabled),
            row0=row0, rows=rows, **kw)

    def image(self, trace_config=tconfig.TraceConfig()):
        return ttrace.render_image(
            self.static, self.arrays, self.mats, self.camera.d_camera,
            self.sun.position, self.sun.color, self.sun.radius,
            bool(self.sun.enabled), trace_config)

    def sharded(self, n, **kw):
        return pmesh.render_image_sharded(
            _cpu_mesh(n), self.static, self.arrays, self.mats,
            self.camera.d_camera, self.sun, **kw)


def _reference(spp=1, max_bounce=0, sun=False):
    """The same frame's inputs in the JAX package."""
    sc = rscenes.flat_test_scene(dim=8)
    cam = RefCamera(75.0, W, H, rconfig.CameraConfig(
        origin=ORIGIN, samples_per_pixel=spp, max_bounce=max_bounce))
    sd = RefSun(rconfig.SunConfig(enabled=sun)).device_data
    return (sc, cam, sd, sc.grid.device_arrays(),
            rtrace.materials_to_device(sc.materials))


def _reference_image(jit, **kw):
    sc, cam, sd, arrays, mats = _reference(**kw)

    def run():
        return np.asarray(rtrace.render_image(
            sc.grid.static, arrays, mats, cam.d_camera, sd.position,
            sd.color, sd.radius, bool(sd.enabled)))

    if jit:
        return run()
    with jax.disable_jit():
        return run()


PRIMARY = dict(spp=1, max_bounce=0, sun=False)
PATH = dict(spp=2, max_bounce=1, sun=True)


@pytest.mark.parametrize("bands", [2, 4, 8])
@pytest.mark.parametrize("frame", [PRIMARY, PATH], ids=["primary", "path"])
def test_banded_render_rows_equals_whole_frame(frame, bands):
    f = Frame(**frame)
    whole = f.rows()
    assert whole.shape == (H, W, 3)
    rows = H // bands
    got = torch.cat([f.rows(row0=i * rows, rows=rows, sample_base=0.0)
                     for i in range(bands)])
    assert torch.equal(got, whole)
    assert torch.equal(f.image(), whole)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("frame", [PRIMARY, PATH], ids=["primary", "path"])
def test_sharded_render_matches_single_device(frame, n):
    f = Frame(**frame)
    sharded = f.sharded(n)
    assert sharded.shape == (H, W, 3) and sharded.dtype == torch.float32
    assert torch.equal(sharded, f.image())


@pytest.mark.parametrize("frame", [PRIMARY, PATH], ids=["primary", "path"])
def test_sharded_render_bit_equal_to_reference_op_by_op(monkeypatch, frame):
    """Against `zig_vulkan_tpu.ops.trace.render_image` run op by op, both
    packages with correctly rounded square roots; the JAX package's own
    sharded render equals its `render_image` (tests/test_parallel.py:16)."""
    monkeypatch.setattr(jax.lax, "rsqrt", lambda x: 1.0 / jnp.sqrt(x))
    monkeypatch.setattr(torch, "sqrt",
                        lambda x: torch.from_numpy(np.sqrt(x.numpy())))
    want = _reference_image(jit=False, **frame)
    np.testing.assert_array_equal(Frame(**frame).sharded(8).numpy(), want)


def test_sharded_primary_frame_close_to_reference_with_backend_sqrt():
    want = _reference_image(jit=False, **PRIMARY)
    got = Frame(**PRIMARY).sharded(8).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, _reference_image(jit=True, **PRIMARY),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("frame", [PRIMARY, PATH], ids=["primary", "path"])
def test_sharded_frame_close_to_reference_with_backend_sqrt(frame):
    """The reference as shipped, op by op, with neither package's square
    root replaced: every value within 2^-23 (one ULP of a colour in
    [0.5, 1), two below) of the port's sharded frame."""
    want = _reference_image(jit=False, **frame)
    got = Frame(**frame).sharded(8).numpy()
    np.testing.assert_allclose(got, want, atol=2.0 ** -23, rtol=0)


def test_backend_square_roots_within_one_ulp():
    """The two functions the bit-equality tests replace are each within one
    ULP of the correctly rounded result (and not always equal to it, which
    is why those tests replace them)."""
    x = np.random.default_rng(0).random(1 << 20, dtype=np.float32) * 100 + 1e-3
    exact = (1.0 / np.sqrt(x.astype(np.float64))).astype(np.float32)
    got = np.asarray(jax.lax.rsqrt(jnp.asarray(x)))
    assert np.abs(got.view(np.int32) - exact.view(np.int32)).max() <= 1
    got = torch.sqrt(torch.from_numpy(x)).numpy()
    assert np.abs(got.view(np.int32) - np.sqrt(x).view(np.int32)).max() <= 1


def test_sharded_render_with_denoise_and_upscale():
    f = Frame(spp=1, max_bounce=1, sun=True)
    dn = tconfig.DenoiserConfig(enabled=True, samples=8)
    out = f.sharded(8, denoiser=dn)
    assert out.shape == (H, W, 3)
    assert torch.isfinite(out).all() and out.max() > 0.1
    assert torch.equal(out, tdenoise.postprocess(f.image(), dn, H, W))
    up = f.sharded(4, denoiser=dn, out_size=(48, 48))
    assert torch.equal(up, tdenoise.postprocess(f.image(), dn, 48, 48))


def test_mesh_requires_divisible_height():
    sc = tscenes.flat_test_scene(dim=8)
    with pytest.raises(ValueError):
        pmesh.build_sharded_step(
            _cpu_mesh(8), sc.grid.static, width=16, height=30, spp=1,
            max_bounce=1, sun_enabled=False)


def test_make_mesh_has_no_cpu_default():
    if torch.cuda.is_available():
        assert pmesh.make_mesh().size == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError):
            pmesh.make_mesh()
    m = _cpu_mesh(4)
    assert m.size == 4 and m.distinct == (torch.device("cpu"),)
    assert m.axis_names == (pmesh.TILE_AXIS,) == (rmesh.TILE_AXIS,)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("out", [(32, 32), (48, 48), (64, 32), (32, 64)],
                         ids=["equal", "up", "tall", "wide"])
@pytest.mark.parametrize("samples, multiplier", [(8, 1.5), (20, 1.5),
                                                 (20, 3.0)])
def test_sharded_denoiser_halo_exact(samples, multiplier, out, n):
    """The same image in: every band, denoised from its own rows and its
    neighbours' halo, equals those rows of the unsharded result exactly.
    Over 8 shards a band is 4 rows: as thick as the default 20-tap spiral's
    halo (3 rows above, 4 below) and thinner than the halo at twice the
    pixel multiplier, where a slab reaches past the next neighbour."""
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.random((H, W, 3), dtype=np.float32))
    dn = tconfig.DenoiserConfig(enabled=True, samples=samples,
                                pixel_multiplier=multiplier)
    out_h, out_w = out
    single = tdenoise.postprocess(img, dn, out_h, out_w)
    rows = out_h // n
    bands = []
    for i in range(n):
        a, b = tdenoise.band_input_rows(i * rows, (i + 1) * rows, out_h, H, dn)
        assert 0 <= a < b <= H
        bands.append(tdenoise.postprocess(
            img[a:b].clone(), dn, out_h, out_w,
            band=tdenoise.Band(i * rows, (i + 1) * rows, a, H)))
    if n == 8 and samples == 20 and out_h == H:
        want = (5, 16) if multiplier == 1.5 else (2, 19)
        assert tdenoise.band_input_rows(8, 12, out_h, H, dn) == want
    assert torch.equal(torch.cat(bands), single)
    # and the unsharded result is the reference's filter
    want = np.asarray(rdenoise.denoise(
        img.numpy(), samples=samples,
        distribution_bias=dn.distribution_bias,
        pixel_multiplier=multiplier,
        inverse_hue_tolerance=dn.inverse_hue_tolerance, out_shape=out))
    np.testing.assert_allclose(single.numpy(), want, atol=1e-5, rtol=0)


def test_resample_without_denoiser_on_bands():
    rng = np.random.default_rng(4)
    img = torch.from_numpy(rng.random((H, W, 3), dtype=np.float32))
    off = tconfig.DenoiserConfig(enabled=False)
    for out_h, out_w in ((32, 32), (48, 64)):
        single = tdenoise.postprocess(img, off, out_h, out_w)
        rows = out_h // 4
        bands = []
        for i in range(4):
            a, b = tdenoise.band_input_rows(i * rows, (i + 1) * rows, out_h,
                                            H, off)
            bands.append(tdenoise.postprocess(
                img[a:b], off, out_h, out_w,
                band=tdenoise.Band(i * rows, (i + 1) * rows, a, H)))
        assert torch.equal(torch.cat(bands), single)


def test_sharded_full_step_with_denoiser_close_to_jitted_reference():
    """End to end against the jitted JAX sharded step (trace + denoise +
    upscale on its 8-device mesh): the bound of tests/test_parallel.py:94-124,
    fewer than 3% of pixels further than 1e-3; and exactly the port's own
    unsharded frame."""
    kw = dict(spp=1, max_bounce=1, sun=True)
    sc, cam, sd, arrays, mats = _reference(**kw)
    rdn = rconfig.DenoiserConfig(enabled=True, samples=8)
    want = np.asarray(rmesh.render_image_sharded(
        rmesh.make_mesh(), sc.grid.static, arrays, mats, cam.d_camera, sd,
        denoiser=rdn, out_size=(48, 48)))
    f = Frame(**kw)
    dn = tconfig.DenoiserConfig(enabled=True, samples=8)
    got = f.sharded(8, denoiser=dn, out_size=(48, 48))
    assert torch.equal(got, tdenoise.postprocess(f.image(), dn, 48, 48))
    diff = np.abs(got.numpy() - want).max(axis=-1)
    assert (diff > 1e-3).mean() < 0.03, float((diff > 1e-3).mean())


@pytest.mark.parametrize("trace_config", [
    tconfig.TraceConfig(max_steps=2),
    tconfig.TraceConfig(empty_skip=False),
    tconfig.TraceConfig(sun_in_kernel=True),
], ids=["max_steps", "no_skip", "sun_in_kernel"])
def test_sharded_step_honours_the_trace_config(trace_config):
    f = Frame(**PATH)
    got = f.sharded(4, trace_config=trace_config)
    assert torch.equal(got, f.image(trace_config))
    if not trace_config.empty_skip:
        # the exact DDA's records carry no field, and it never reads one
        assert not ttrace.one_shot_tables(f.static, f.arrays, False)[:, 3].any()
        assert torch.equal(got, ttrace.render_image(
            f.static, f.arrays, f.mats, f.camera.d_camera, f.sun.position,
            f.sun.color, f.sun.radius, True, trace_config, tables=f.tables))
    if trace_config.max_steps == 2:
        assert not torch.equal(got, f.image())  # the bound did cut rays


def test_sharded_step_accepts_cached_tables_and_sample_base():
    """Per-frame steps take pre-built records (the table build must not run
    inside every sharded frame) and the temporal jitter seed."""
    f = Frame(spp=2, max_bounce=0, sun=False)
    m = _cpu_mesh(8)
    d = f.camera.d_camera
    step = pmesh.build_sharded_step(
        m, f.static, width=W, height=H, spp=2, max_bounce=int(d.max_bounce),
        sun_enabled=False, denoiser=tconfig.DenoiserConfig(enabled=False))
    arrays_r, mats_r = pmesh.replicate_scene(m, f.arrays, f.mats)
    tables = pmesh.map_replicas(
        m, lambda a: ttrace.build_trace_tables(f.static, a), arrays_r)
    assert all(t is tables[0] for t in tables)  # one per device, not shard
    cam = ttrace.camera_vectors(d, "cpu")
    args = (arrays_r, mats_r, cam, f.sun.position, f.sun.color, f.sun.radius)
    assert torch.equal(step(*args, tables=tables), f.image())
    assert torch.equal(step(*args), f.image())  # records built in the step
    moved = step(*args, tables=tables, sample_base=4.0)
    assert torch.equal(moved, f.rows(sample_base=4.0))
    assert not torch.equal(moved, f.image())


def test_dryrun_multichip(capsys):
    pmesh.dryrun_multichip(8, device="cpu")
    assert "dryrun_multichip(8): OK" in capsys.readouterr().out
    assert pmesh.main(["2", "--device", "cpu"]) == 0
    if not torch.cuda.is_available():
        assert pmesh.main(["2"]) == 2  # on the card unless asked otherwise


@pytest.mark.parametrize("source", ["host", "reference", "device"])
def test_replicate_scene_equal_per_replica(source):
    """Host arrays of either package, or device tensors, in; every replica
    equals the source, shards of one device share one replica, and a replica
    never aliases its source."""
    sc = tscenes.flat_test_scene(dim=8)
    mats = ttrace.materials_to_device(sc.materials, "cpu")
    want = sc.grid.arrays.to_device("cpu")
    arrays = {"host": sc.grid.arrays,
              "reference": rscenes.flat_test_scene(dim=8).grid.arrays,
              "device": want}[source]
    m = _cpu_mesh(4)
    arrays_r, mats_r = pmesh.replicate_scene(m, arrays, mats)
    assert len(arrays_r) == len(mats_r) == 4
    for a, t in zip(arrays_r, mats_r):
        assert isinstance(a, GridArrays)
        assert a is arrays_r[0] and t is mats_r[0]
        assert torch.equal(t, mats) and t.data_ptr() != mats.data_ptr()
        for name in FIELDS:
            got, src = getattr(a, name), getattr(want, name)
            assert got.dtype == src.dtype and got.shape == src.shape
            assert torch.equal(got.reshape(-1).view(torch.uint8),
                               src.reshape(-1).view(torch.uint8)), name
            assert got.data_ptr() != src.data_ptr() or got.numel() == 0


def test_remove_batch_matches_reference():
    """`BrickGrid.remove_batch` against the JAX package's on the same
    random inserts and removals (voxels of unloaded cells included)."""
    rng = np.random.default_rng(5)
    grids = []
    for cls, cfg in ((BrickGrid, tconfig.GridConfig()),
                     (RefBrickGrid, rconfig.GridConfig())):
        g = cls(4, 3, 5, cfg)
        grids.append(g)
    vx, vy, vz = grids[0].static.voxel_dims
    for _ in range(3):
        n = 300
        xyz = np.stack([rng.integers(0, vx, n), rng.integers(0, vy, n),
                        rng.integers(0, vz, n)], -1)
        mats = rng.integers(0, 8, n).astype(np.uint8)
        gone = np.concatenate([xyz[rng.random(n) < 0.5],
                               np.stack([rng.integers(0, vx, 200),
                                         rng.integers(0, vy, 200),
                                         rng.integers(0, vz, 200)], -1)])
        for g in grids:
            g.insert_batch(xyz[:, 0], xyz[:, 1], xyz[:, 2], mats)
            g.remove_batch(gone[:, 0], gone[:, 1], gone[:, 2])
        for name in FIELDS:
            np.testing.assert_array_equal(
                np.asarray(getattr(grids[0].arrays, name)),
                np.asarray(getattr(grids[1].arrays, name)), err_msg=name)
        x, y, z = gone[0]
        assert grids[0].voxel_material(x, y, z) is None
    before = grids[0].arrays.occupancy.copy()
    empty = BrickGrid(2, 2, 2)
    empty.remove_batch([1], [1], [1])  # nothing loaded: a no-op
    assert not empty.arrays.occupancy.any()
    np.testing.assert_array_equal(grids[0].arrays.occupancy, before)


def _moving_frames(f, n, denoiser, calls=3, devices=None):
    """`calls` frames of one sharded step (over `n` shards of the CPU, or
    over `devices`), the camera and the sun moved and the sample base
    changed between them, each with the unsharded frame of the same
    values."""
    m = _cpu_mesh(n) if devices is None else pmesh.make_mesh(devices)
    d = f.camera.d_camera
    step = pmesh.build_sharded_step(
        m, f.static, width=W, height=H, spp=int(d.samples_per_pixel),
        max_bounce=int(d.max_bounce) + 1, sun_enabled=True, out_width=48,
        out_height=48, denoiser=denoiser)
    arrays_r, mats_r = pmesh.replicate_scene(m, f.arrays, f.mats)
    tables = pmesh.map_replicas(
        m, lambda a: ttrace.build_trace_tables(f.static, a), arrays_r)
    for k in range(calls):
        f.camera.turn_yaw(0.1)
        f.camera.translate(0.2, [0.0, 0.0, -1.0])
        sun = np.asarray(f.sun.position, np.float32) + np.float32(3 * k)
        cam = ttrace.camera_vectors(d, "cpu")
        args = (arrays_r, mats_r, cam, sun, f.sun.color, f.sun.radius)
        want = tdenoise.postprocess(
            ttrace.render_rows(f.static, tables[0], arrays_r[0].material_indices,
                               mats_r[0], cam, W, H, int(d.samples_per_pixel),
                               int(d.max_bounce) + 1, sun, f.sun.color,
                               f.sun.radius, True, sample_base=float(k)),
            denoiser, 48, 48)
        yield step, args, tables, float(k), want


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_step_push_constants_follow_the_camera_and_sun(n):
    """The per-frame values reach the shards as push constants: with the
    camera, the sun and the sample base moved between calls of one step,
    each frame equals the unsharded frame of its values bit for bit, on
    both routes."""
    f = Frame(spp=1, max_bounce=1, sun=True)
    dn = tconfig.DenoiserConfig(enabled=True, samples=8)
    images = []
    for step, args, tables, base, want in _moving_frames(f, n, dn):
        got = step(*args, tables=tables, sample_base=base)
        assert torch.equal(got, want)
        assert torch.equal(step.op_by_op(*args, tables=tables,
                                         sample_base=base), want)
        assert torch.equal(step.pcs[torch.device("cpu")][12:15],
                           torch.from_numpy(args[3]))
        images.append(got)
    assert not torch.equal(images[0], images[1])


class _FakeGraph:
    """A CUDA graph's contract on the CPU: the first call runs the body and
    returns its result (the warm-up) while the static output holds garbage
    (the capture runs nothing); every later call writes the body's result
    into the static output and returns it (a replay)."""

    captures = 0

    def __init__(self, body, *args):
        self.body, self.args, self.out = body, args, None

    def __call__(self):
        if self.out is None:
            result = self.body(*self.args)
            self.out = torch.full_like(result, float("nan"))
            _FakeGraph.captures += 1
            return result
        self.out.copy_(self.body(*self.args))
        return self.out


@pytest.mark.parametrize("n, denoise", [(1, False), (2, True), (4, True),
                                        (4, False)])
def test_sharded_graphs_read_static_bands(monkeypatch, n, denoise):
    """The graphed route's bookkeeping, with a stand-in for the graphs: a
    trace and (with the denoiser) a post-process graph a shard, captured on
    the first call; the capture call's bands reach the static bands the
    post graphs read; later calls replay; new records capture again."""
    monkeypatch.setattr(pmesh, "GraphedCall", _FakeGraph)
    f = Frame(spp=1, max_bounce=1, sun=True)
    dn = tconfig.DenoiserConfig(enabled=denoise, samples=8)
    before = _FakeGraph.captures
    for step, args, tables, base, want in _moving_frames(f, n, dn):
        step.graphed = True
        assert torch.equal(step(*args, tables=tables, sample_base=base), want)
    assert _FakeGraph.captures - before == n * 2
    fresh = tuple(t.clone() for t in tables)
    assert torch.equal(step(*args, tables=fresh, sample_base=base), want)
    assert _FakeGraph.captures - before == n * 4
    assert step._inputs[0][1] is fresh[0]  # (pc, records, ...)


class _Op:
    """An operation a stand-in stream holds: its name, the frame that
    issued it and the operations it follows directly."""

    def __init__(self, name, frame, after):
        self.name, self.frame, self.after = name, frame, after

    def follows(self, other) -> bool:
        """Whether `other` is among the operations this one waits for,
        directly or through others."""
        seen, todo = set(), list(self.after)
        while todo:
            op = todo.pop()
            if op is other:
                return True
            if id(op) not in seen:
                seen.add(id(op))
                todo.extend(op.after)
        return False


class _FakeCards:
    """Streams, events and copies between cards on the CPU, as a CUDA
    build of torch has them, for a mesh of `cpu:<k>` stand-in cards: a
    stream holds operations in order, an event the last of them, a wait an
    operation that follows the event's. A graph replays on the current
    stream of the current card. A copy into a halo slab or into another
    card's push constants is a copy between cards: it runs on the source
    card's current stream after that stream waited for the destination
    card's current stream, which then waits for the copy (torch's two-way
    barrier). `log` is what each stream was given, in the order issued."""

    def __init__(self, monkeypatch, step):
        self.step, self.frame, self.log = step, 0, []
        self.device = step.mesh.devices[0]
        self.current = {}
        fake = self

        class Stream:
            def __init__(self, device, name="stream"):
                self.device, self.name, self.ops = device, name, []

            def issue(self, name, *after):
                last = self.ops[-1:]
                op = _Op(name, fake.frame,
                         last + [a for a in after if a is not None])
                self.ops.append(op)
                fake.log.append((self.name, name))
                return op

            def wait_event(self, event):
                if event.op is not None:
                    self.issue("wait", event.op)

            def wait_stream(self, other):
                self.wait_event(other.record_event())

            def record_event(self):
                event = Event()
                event.record(self)
                return event

        class Event:
            op = None

            def record(self, stream):
                self.op = stream.ops[-1] if stream.ops else None

        @contextlib.contextmanager
        def stream(s):
            was = fake.device, current_stream(s.device)
            fake.device, fake.current[s.device] = s.device, s
            try:
                yield
            finally:
                fake.device, fake.current[s.device] = was

        def current_stream(device):
            device = torch.device(device)
            if device not in self.current:
                self.current[device] = Stream(device, f"caller {device}")
            return self.current[device]

        class Graph(_FakeGraph):
            def __call__(self):
                shard = self.body.args[0]
                current_stream(fake.device).issue(
                    (self.body.func.__name__, shard))
                return super().__call__()

        copy = torch.Tensor.copy_

        def copy_(dst, src, non_blocking=False):
            out = copy(dst, src, non_blocking)
            devices, pcs = step.mesh.devices, step.pcs
            halo = [k for k, slab in step.slabs.items() if slab is dst]
            if halo:
                i, j = halo[0]
                fake.between(devices[j], devices[i], ("halo", i, j))
            elif any(dst is t for t in pcs.values()) and src is pcs[devices[0]]:
                dev = next(d for d, t in pcs.items() if t is dst)
                fake.between(devices[0], dev, ("push constants", str(dev)))
            return out

        self.current_stream = current_stream
        monkeypatch.setattr(torch.cuda, "Stream", Stream)
        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(torch.cuda, "stream", stream)
        monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
        monkeypatch.setattr(torch.Tensor, "copy_", copy_)
        monkeypatch.setattr(pmesh, "GraphedCall", Graph)
        step.streams = [Stream(dev, f"shard {i}")
                        for i, dev in enumerate(step.mesh.devices)]
        step.cuda = list(step.mesh.distinct)
        step.graphed = True

    def between(self, src, dst, name):
        """A copy from card `src` to card `dst` under torch's barrier."""
        s, d = self.current_stream(src), self.current_stream(dst)
        ready = d.record_event()
        s.wait_event(ready)
        op = s.issue(name)
        d.wait_event(s.record_event())
        return op

    def ops(self, frame):
        """The operations frame `frame` issued, by name."""
        return {op.name: op for s in self._streams() for op in s.ops
                if op.frame == frame and op.name != "wait"}

    def _streams(self):
        return (list(self.current.values()) + list(self.step.streams)
                + list(self.step.__dict__.get("halo_streams", {}).values()))


@pytest.mark.parametrize("n", [2, 4])
def test_halo_copies_issued_before_any_post_process(monkeypatch, n):
    """The order of a frame's work on four (two) cards, with stand-ins for
    the cards' streams and events as `_FakeGraph` stands in for the graphs:
    no shard's post-process waits, directly or through a copy, for another
    shard's post-process; each halo copy waits for its source band's trace
    and for no other trace or post-process of the frame, and for the
    frame before's post-process of its destination (the slab's last
    reader), and comes before its destination's post-process, which waits
    for the traces it reads and for no others. The images are the unsharded
    frames bit for bit."""
    f = Frame(spp=1, max_bounce=1, sun=True)
    dn = tconfig.DenoiserConfig(enabled=True, samples=8)
    devices = [f"cpu:{k}" for k in range(n)]
    cards = before = None
    for step, args, tables, base, want in _moving_frames(f, n, dn,
                                                         devices=devices):
        if cards is None:
            cards = _FakeCards(monkeypatch, step)
        cards.frame += 1
        assert torch.equal(step(*args, tables=tables, sample_base=base), want)
        ops = cards.ops(cards.frame)
        traces = {i: ops[("trace", i)] for i in range(n)}
        posts = {i: ops[("post", i)] for i in range(n)}
        for i, post in posts.items():
            assert [k for k, p in posts.items() if post.follows(p)] == [], (
                i, cards.log)
        for i, post in posts.items():
            sources = {j for j, _, _ in step.plan.sources(i)}
            assert {k for k, t in traces.items()
                    if post.follows(t)} == sources | {i}, (i, cards.log)
            for j in sources - {i}:
                copy = ops[("halo", i, j)]
                assert post.follows(copy), (i, j, cards.log)
                assert {k for k, t in traces.items()
                        if copy.follows(t)} == {j}, (i, j, cards.log)
                assert not any(copy.follows(p) for p in posts.values())
                # the slab's last reader: the frame before's post-process
                assert before is None or copy.follows(before[i])
        before = posts
    assert len(step.slabs) == 2 * (n - 1)
