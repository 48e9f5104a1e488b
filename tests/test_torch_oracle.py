"""The port's numpy oracle and its exact traversal (`empty_skip=False`).

- `zig_vulkan_tpu_torch.oracle.cpu_tracer` is a numpy copy of the JAX
  package's oracle over its own numpy copy of the RNG: the two must agree
  bit for bit, on `grid_hit` and on `render`.
- The traversal twin with `use_skip=False` (the plain version of kernel
  A's NO_SKIP builds) must equal `zig_vulkan_tpu.ops.trace.grid_hit(
  use_skip=False)` run op by op (`jax.disable_jit`) bit for bit, including
  the step bound, and must give the oracle's hits: the same found set and
  material indices, t within rtol 1e-5 / atol 1e-4 (the bound of
  tests/test_parity_at_scale.py:67-82).
- Frames traced with the exact DDA are held against the oracle's with the
  statistical bounds of tests/test_trace_parity.py:75-77 (bounce and sun
  rays draw from the sin hash, which turns last-bit differences of the
  shading's operation order into other random numbers); primary frames to
  1e-5.
- The engine runs `TraceConfig(empty_skip=False)`: its records carry the
  exact field of its first build and the conservative one of its inserts,
  as the JAX engine's records do whatever `empty_skip` is, and the frame
  is the exact DDA's, which never reads the field.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zig_vulkan_tpu.config import CameraConfig as RCameraConfig
from zig_vulkan_tpu.config import SunConfig as RSunConfig
from zig_vulkan_tpu.core.camera import Camera as RCamera
from zig_vulkan_tpu.core.materials import MAT_DIELECTRIC, MAT_NONE
from zig_vulkan_tpu.core.sun import Sun as RSun
from zig_vulkan_tpu.models import scenes as rscenes
from zig_vulkan_tpu.oracle import cpu_tracer as roracle
from zig_vulkan_tpu.ops import trace as rtrace
from zig_vulkan_tpu_torch import config as tconfig
from zig_vulkan_tpu_torch.core.camera import Camera
from zig_vulkan_tpu_torch.core.sun import Sun
from zig_vulkan_tpu_torch.engine.engine import VoxelRT
from zig_vulkan_tpu_torch.models import scenes as tscenes
from zig_vulkan_tpu_torch.oracle import cpu_tracer as toracle
from zig_vulkan_tpu_torch.oracle import rng as orng
from zig_vulkan_tpu_torch.ops import tile_tracer as ttile
from zig_vulkan_tpu_torch.ops import trace as ttrace

torch.set_num_threads(2)

ORIGIN = (4.0, 6.5, 15.0)
_KEYS = ("found", "t", "px", "py", "pz", "nx", "ny", "nz", "index")


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


def _camera_rays(n_side=48):
    cam = RCamera(75.0, n_side, n_side, RCameraConfig(origin=ORIGIN))
    d = cam.d_camera
    ys, xs = np.meshgrid(np.arange(n_side, dtype=np.float32),
                         np.arange(n_side, dtype=np.float32), indexing="ij")
    u = (xs / np.float32(n_side - 1)).ravel()
    v = (ys / np.float32(n_side - 1)).ravel()
    rd = (d.horizontal * u[:, None] + d.lower_left_corner
          + d.vertical * v[:, None] - d.origin).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ro = np.broadcast_to(d.origin, rd.shape).astype(np.float32).copy()
    return ro, rd


class _Setup:
    """The parity scene in both packages, and three ray batches: primary
    rays of a 48x48 view, random directions from their hit points, and the
    same with the water's ir as the dielectric key on half the lanes."""

    def __init__(self):
        sc = _parity_scene(rscenes)
        self.rscene = sc
        self.static = sc.grid.static
        self.rarrays = sc.grid.device_arrays()
        self.rmats = rtrace.materials_to_device(sc.materials)
        self.rtables = rtrace.build_trace_tables(
            self.static, self.rarrays,
            rtrace.distance_field(self.static, self.rarrays, exact=True))
        self.tscene = _parity_scene(tscenes)
        ta = self.tscene.grid.arrays.to_device("cpu")
        self.material_indices = ta.material_indices
        # the exact DDA's records: no distance field
        self.tables = ttrace.build_trace_tables(
            self.static, ta, ttrace.no_skip_field(self.static, ta))

        ro, rd = _camera_rays()
        n = len(ro)
        rng = np.random.default_rng(0)
        prim = self.reference(ro, rd, None, jit=True)
        so = np.where(prim["found"][:, None],
                      np.stack([prim["px"], prim["py"], prim["pz"]], -1),
                      ro).astype(np.float32)
        sd = rng.standard_normal((n, 3)).astype(np.float32)
        sd /= np.linalg.norm(sd, axis=-1, keepdims=True)
        key = np.where(rng.random(n) < 0.5, np.float32(1.333),
                       np.float32(np.nan)).astype(np.float32)
        self.batches = {
            "primary": (ro, rd, None),
            "scatter": (so, sd, None),
            "refracted": (so, sd, key),
        }

    @staticmethod
    def _key_pair(n, key):
        if key is None:
            return np.full(n, MAT_NONE, np.int32), np.ones(n, np.float32)
        it = np.where(np.isnan(key), MAT_NONE, MAT_DIELECTRIC).astype(np.int32)
        ir = np.where(np.isnan(key), 1.0, key).astype(np.float32)
        return it, ir

    def reference(self, ro, rd, key, jit: bool, max_steps: int = 768):
        """JAX grid_hit(use_skip=False)."""
        n = len(ro)
        it, ir = self._key_pair(n, key)

        def run():
            return rtrace.grid_hit(
                self.static, self.rarrays, self.rmats, jnp.asarray(ro),
                jnp.asarray(rd), jnp.float32(np.inf), jnp.asarray(it),
                jnp.asarray(ir), jnp.ones(n, bool), max_steps=max_steps,
                tables=self.rtables, use_skip=False, bounded_t=False,
                needs_ignore=key is not None)

        if jit:
            out = run()
        else:
            with jax.disable_jit():
                out = run()
        p, nrm = np.asarray(out["point"]), np.asarray(out["normal"])
        return dict(found=np.asarray(out["found"]), t=np.asarray(out["t"]),
                    px=p[:, 0], py=p[:, 1], pz=p[:, 2],
                    nx=nrm[:, 0], ny=nrm[:, 1], nz=nrm[:, 2],
                    index=np.asarray(out["index"]))

    def port(self, ro, rd, key, max_steps: int = 768):
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a))

        out = ttile.grid_hit_tiles(
            self.static, self.tables, self.material_indices,
            *(t(ro[:, i]) for i in range(3)), *(t(rd[:, i]) for i in range(3)),
            torch.ones(len(ro), dtype=torch.bool),
            ray_key=None if key is None else t(key), max_steps=max_steps,
            use_skip=False)
        return {k: v.numpy() for k, v in out.items()}

    def oracle(self, module, scene, ro, rd, key):
        n = len(ro)
        it, ir = self._key_pair(n, key)
        osc = module.OracleScene(scene.grid.static, scene.grid.arrays,
                                 scene.materials)
        return module.grid_hit(osc, ro, rd, np.float32(1e-5),
                               np.float32(np.inf), it, ir, np.ones(n, bool))


@pytest.fixture(scope="module")
def setup():
    return _Setup()


_BATCHES = ["primary", "scatter", "refracted"]


# -- the port's oracle against the JAX package's ------------------------------

def test_oracle_rng_equals_reference_rng():
    from zig_vulkan_tpu.ops import rng as rrng

    rng = np.random.default_rng(3)
    co2 = (rng.standard_normal((4096, 2)) * 50).astype(np.float32)
    co3 = (rng.standard_normal((4096, 3)) * 50).astype(np.float32)
    lo = (rng.random(4096) * -0.5).astype(np.float32)
    for name, args in (("hsin", (co2[:, 0],)), ("rand1", (co2[:, 0],)),
                       ("rand2", (co2,)), ("rand3", (co3,)),
                       ("rand2_range", (co2, lo, -lo)),
                       ("rand_vec3_range", (co2, -0.4, 0.4)),
                       ("rand_vec3_range", (co2, lo, -lo)),
                       ("hash12", (co2,))):
        got = getattr(orng, name)(*args)
        want = getattr(rrng, name)(*args)
        assert got.dtype == want.dtype == np.float32, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("batch", _BATCHES)
def test_oracle_grid_hit_equals_reference_oracle(setup, batch):
    ro, rd, key = setup.batches[batch]
    got = setup.oracle(toracle, setup.tscene, ro, rd, key)
    want = setup.oracle(roracle, setup.rscene, ro, rd, key)
    assert got.found.sum() > 100
    for f in ("found", "t", "point", "normal", "index"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


@pytest.mark.parametrize("spp,max_bounce,sun_on", [(1, 0, False),
                                                    (2, 2, True)])
def test_oracle_render_equals_reference_oracle(setup, spp, max_bounce,
                                               sun_on):
    cam = RCamera(75.0, 24, 24, RCameraConfig(
        origin=ORIGIN, samples_per_pixel=spp, max_bounce=max_bounce))
    sun = RSun(RSunConfig(enabled=sun_on)).device_data
    sc_r, sc_t = setup.rscene, setup.tscene
    want = roracle.render(roracle.OracleScene(
        sc_r.grid.static, sc_r.grid.arrays, sc_r.materials), cam.d_camera, sun)
    got = toracle.render(toracle.OracleScene(
        sc_t.grid.static, sc_t.grid.arrays, sc_t.materials), cam.d_camera, sun)
    assert got.shape == (24, 24, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# -- the exact traversal twin ----------------------------------------------------

@pytest.mark.parametrize("batch", _BATCHES)
def test_exact_twin_bit_exact_against_reference_op_by_op(setup, batch):
    ro, rd, key = setup.batches[batch]
    want = setup.reference(ro, rd, key, jit=False)
    got = setup.port(ro, rd, key)
    for k in _KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("max_steps", [1, 4, 9, 30])
def test_exact_twin_step_bound_counts_like_reference(setup, max_steps):
    """One iteration is one reference while-loop iteration; a lane that
    exhausts `max_steps` is a miss in both packages."""
    ro, rd, _ = setup.batches["scatter"]
    want = setup.reference(ro, rd, None, jit=False, max_steps=max_steps)
    got = setup.port(ro, rd, None, max_steps=max_steps)
    for k in _KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("batch", _BATCHES)
def test_exact_twin_gives_the_oracles_hits(setup, batch):
    ro, rd, key = setup.batches[batch]
    o = setup.oracle(toracle, setup.tscene, ro, rd, key)
    got = setup.port(ro, rd, key)
    np.testing.assert_array_equal(got["found"], o.found)
    both = o.found
    assert both.sum() > 100
    np.testing.assert_allclose(got["t"][both], o.t[both], rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(got["index"][both], o.index[both])


def test_exact_twin_ignores_the_distance_lane(setup):
    """The exact DDA never reads lane 3: records with the exact skip field
    give the same answer as records without one; the skip path does read
    it and takes other steps."""
    ro, rd, _ = setup.batches["scatter"]
    ta = setup.tscene.grid.arrays.to_device("cpu")
    skip_tables = ttrace.build_trace_tables(
        setup.static, ta, ttrace.distance_field(setup.static, ta, exact=True))
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (*ro.T, *rd.T)]
    on = torch.ones(len(ro), dtype=torch.bool)
    a = ttrace._grid_hit_soa(setup.static, skip_tables, ta.material_indices,
                             *args, on, use_skip=False, stats=True)
    b = ttrace._grid_hit_soa(setup.static, setup.tables, ta.material_indices,
                             *args, on, use_skip=False, stats=True)
    s = ttrace._grid_hit_soa(setup.static, skip_tables, ta.material_indices,
                             *args, on, use_skip=True, stats=True)
    for k in (*_KEYS, "n_step"):
        assert torch.equal(a[k], b[k]), k
    assert s["n_step"].sum() < a["n_step"].sum()


# -- frames -------------------------------------------------------------------

def _frames(setup, spp, max_bounce, sun_on, size=32):
    cam = Camera(75.0, size, size, tconfig.CameraConfig(
        origin=ORIGIN, samples_per_pixel=spp, max_bounce=max_bounce))
    sun = Sun(tconfig.SunConfig(enabled=sun_on)).device_data
    sc = setup.tscene
    img = ttrace.render_rows(
        setup.static, setup.tables, setup.material_indices,
        ttrace.materials_to_device(sc.materials, "cpu"),
        ttrace.camera_vectors(cam.d_camera, "cpu"), size, size, spp,
        cam.d_camera.max_bounce, sun.position, sun.color, sun.radius,
        sun_on, use_skip=False).numpy()
    want = toracle.render(toracle.OracleScene(
        sc.grid.static, sc.grid.arrays, sc.materials), cam.d_camera, sun)
    return img, want


def test_exact_primary_frame_matches_oracle(setup):
    img, want = _frames(setup, 1, 0, False)
    np.testing.assert_allclose(img, want, atol=1e-5, rtol=0)


def test_exact_path_traced_frame_matches_oracle_statistically(setup):
    img, want = _frames(setup, 2, 2, True)
    diff = np.abs(img - want).max(axis=-1)
    assert diff.mean() < 5e-3
    assert (diff > 1e-3).mean() < 0.01


# -- the engine with TraceConfig(empty_skip=False) ---------------------------------

def _engine(empty_skip):
    sc = _parity_scene(tscenes)
    cfg = tconfig.EngineConfig(
        internal_resolution_width=32, internal_resolution_height=32,
        camera=tconfig.CameraConfig(origin=ORIGIN, samples_per_pixel=2,
                                    max_bounce=2),
        sun=tconfig.SunConfig(enabled=True, animate=False),
        denoiser=tconfig.DenoiserConfig(enabled=False),
        trace=tconfig.TraceConfig(empty_skip=empty_skip))
    return VoxelRT(sc.grid, sc.materials, cfg, device="cpu")


def test_engine_renders_the_exact_path(setup):
    rt = _engine(empty_skip=False)
    img = rt.draw()
    assert img.shape == (32, 32, 3) and bool(torch.isfinite(img).all())
    tables = rt.tables()
    st = rt.grid_static
    assert torch.equal(tables[:, 3], ttrace.distance_field(st, rt.arrays,
                                                          exact=True))
    lanes = [0, 1, 2, 4, 5, 6, 7]
    assert torch.equal(tables[:, lanes], setup.tables[:, lanes])
    # the engine's frame is the exact DDA's (denoiser off: a 1:1 resample)
    cam = rt.camera.d_camera
    sun = rt.sun.device_data
    want = ttrace.render_rows(
        rt.grid_static, tables, rt.arrays.material_indices, rt.mats,
        ttrace.camera_vectors(cam, "cpu"), 32, 32, 2, 2, sun.position,
        sun.color, sun.radius, True, use_skip=False)
    np.testing.assert_allclose(img.numpy(), want.numpy(), atol=1e-6)


def test_engine_exact_path_edits_keep_records_without_field():
    """Edits on the exact path keep the records up to date as on the skip
    path: the touched rows gathered anew and the inserts' conservative
    field in the distance lane, which the exact DDA never reads; a switch
    to empty_skip=True then traces on those records as they are."""
    rt = _engine(empty_skip=False)
    rt.draw()
    rng = np.random.default_rng(4)
    vx, vy, vz = rt.grid_static.voxel_dims
    xyz = np.stack([rng.integers(0, vx, 64), rng.integers(0, vy, 64),
                    rng.integers(0, vz, 64)], -1)
    rt.insert_voxels(xyz, rng.integers(1, 8, 64).astype(np.uint8))
    rt.remove_voxels(xyz[::2])
    st = rt.grid_static
    field = ttrace.distance_field(st, rt.arrays)
    full = ttrace.build_trace_tables(st, rt.arrays, field)
    tables = rt.tables()
    assert torch.equal(tables[:, 3], field)  # the inserts' conservative one
    live = tables[:, 0] != -1
    assert torch.equal(tables[live], full[live])
    # switching the config keeps the records, as the JAX engine does
    before = tables.clone()
    rt.trace_config = tconfig.TraceConfig(empty_skip=True)
    assert rt.tables() is tables and torch.equal(tables, before)


def _terrain(grid_cls, cfg_mod, materials_fn, terrain_mod):
    """A small terrain around the origin, where the camera sits at (0, 0,
    0): there a camera ray's hit point is d * t, whose last bits follow the
    direction's."""
    g = grid_cls(24, 12, 24, cfg_mod.GridConfig(min_point=(-6.0, -4.0, -6.0),
                                                scale=0.5))
    m = materials_fn()
    g.attach_materials(m)
    terrain_mod.generate(g, seed=420, scale=4.0, ocean_level=14)
    return g, m


def test_exact_path_on_terrain_no_further_from_oracle_than_reference():
    """The oracle normalizes a camera ray as v / sqrt(v.v), the port and
    the JAX package as v * (1 / sqrt(v.v)) (the jitted JAX one with an
    approximate rsqrt): the directions differ in the last bit, so the hit
    points of rays from the origin do, so the sin hash draws other scatter
    directions. Primary frames stay exact; path-traced frames differ from
    the oracle in a few % of pixels on terrain, for the JAX package as for
    the port, without bias. The port must come no further from the oracle
    than the reference (the bound chip_smoke.py phase 12 applies on the
    card)."""
    from zig_vulkan_tpu.core.grid import BrickGrid as RBrickGrid
    from zig_vulkan_tpu.core.materials import terrain_materials as rtm
    from zig_vulkan_tpu.io import terrain as rterrain
    from zig_vulkan_tpu import config as rc
    from zig_vulkan_tpu_torch.core.grid import BrickGrid
    from zig_vulkan_tpu_torch.core.materials import terrain_materials
    from zig_vulkan_tpu_torch.io import terrain

    w, h = 48, 32
    rg, rm = _terrain(RBrickGrid, rc, rtm, rterrain)
    tg, tm = _terrain(BrickGrid, tconfig, terrain_materials, terrain)
    osc = roracle.OracleScene(rg.static, rg.arrays, rm)

    def diff(a, b):
        d = np.abs(a - b).max(axis=-1)
        return (d > 1e-3).mean(), d.mean(), d.max(), (a - b).mean()

    for primary in (True, False):
        cam_kw = (dict(samples_per_pixel=1, max_bounce=0) if primary
                  else {})
        rt = VoxelRT(tg, tm, tconfig.EngineConfig(
            internal_resolution_width=w, internal_resolution_height=h,
            camera=tconfig.CameraConfig(origin=(0.0, 0.0, 0.0), **cam_kw),
            sun=tconfig.SunConfig(enabled=not primary),
            denoiser=tconfig.DenoiserConfig(enabled=False),
            trace=tconfig.TraceConfig(empty_skip=False)), device="cpu")
        got = rt.render().numpy()
        cam, sun = rt.camera.d_camera, rt.sun.device_data
        want = roracle.render(osc, cam, sun)
        share, mean, mx, signed = diff(got, want)
        if primary:
            assert mx < 1e-5
            continue
        ref = np.asarray(rtrace.render_image(
            rg.static, rg.device_arrays(), rtrace.materials_to_device(rm),
            cam, sun.position, sun.color, sun.radius, True,
            rc.TraceConfig(empty_skip=False)))
        ref_share, ref_mean, _, ref_signed = diff(ref, want)
        assert 0.0 < share <= ref_share and mean <= ref_mean
        assert abs(signed) < 2e-3 and abs(ref_signed) < 2e-3
