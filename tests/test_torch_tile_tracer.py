"""First-hit traversal of zig_vulkan_tpu_torch against the JAX package's.

`ops.tile_tracer.grid_hit_tiles` runs the plain torch traversal
(`ops.trace._grid_hit_soa`) for CPU tensors and kernel A
(csrc/traverse.cu) for CUDA tensors. Both must compute what the
reference's `ops.trace.grid_hit(..., use_skip=True, bounded_t=False)`
computes, which the Pallas tile kernel matches.

The array-of-structs entry points (`grid_hit`, `ray_color`, `camera_rays`,
`transmission_direction`, `background_color`) are held against the
reference's of the same names op by op: bit for bit, with the square roots
of both packages replaced by correctly rounded ones where a function takes
one (neither backend's is exact everywhere), and `transmission_direction`
also with the backends' own, within 2^-22.

Against the reference run op by op (`jax.disable_jit`) the results are
bit-identical. Against the jitted reference, whose XLA:CPU build contracts
multiply-adds into FMAs, `t` may differ in the last bits: found agreement
>= 0.999, t within 1e-5, index and normal equal where both hit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zig_vulkan_tpu.config import CameraConfig
from zig_vulkan_tpu.core.camera import Camera
from zig_vulkan_tpu.core.materials import MAT_DIELECTRIC, MAT_NONE
from zig_vulkan_tpu.models import scenes as rscenes
from zig_vulkan_tpu.ops import trace as rtrace
from zig_vulkan_tpu_torch.core.grid import GridArrays
from zig_vulkan_tpu_torch.ops import tile_tracer as ttile
from zig_vulkan_tpu_torch.ops import trace as ttrace

torch.set_num_threads(2)

_KEYS = ("found", "t", "px", "py", "pz", "nx", "ny", "nz", "index")


def _parity_scene():
    """tests/test_trace_parity.py's water pool + metal pillar scene."""
    sc = rscenes.flat_test_scene(dim=8)
    xs, zs = np.meshgrid(np.arange(6, 16), np.arange(6, 16), indexing="ij")
    sc.grid.insert_batch(xs.ravel(), np.full(xs.size, 4), zs.ravel(),
                         np.zeros(xs.size, dtype=np.uint8))
    ys = np.arange(4, 12)
    sc.grid.insert_batch(np.full(ys.size, 20), ys, np.full(ys.size, 20),
                         np.full(ys.size, 7, dtype=np.uint8))
    return sc


class _Setup:
    def __init__(self):
        sc = _parity_scene()
        self.static = sc.grid.static
        self.rarrays = sc.grid.device_arrays()
        self.rmats = rtrace.materials_to_device(sc.materials)
        dist = rtrace.distance_field(self.static, self.rarrays, exact=True)
        self.rtables = rtrace.build_trace_tables(self.static, self.rarrays,
                                                 dist)
        ta = GridArrays.to_device(sc.grid.arrays, "cpu")
        self.tarrays = ta
        self.tmats = ttrace.materials_to_device(sc.materials, "cpu")
        self.tables = torch.from_numpy(np.array(self.rtables))
        self.material_indices = ta.material_indices

        # primary rays of a 48x48 view, then scattered and refracted rays
        # from their hit points
        cam = Camera(75.0, 48, 48, CameraConfig(origin=(4.0, 6.5, 15.0)))
        d = cam.d_camera
        ys, xs = np.meshgrid(np.arange(48, dtype=np.float32),
                             np.arange(48, dtype=np.float32), indexing="ij")
        u = (xs / np.float32(47)).ravel()
        v = (ys / np.float32(47)).ravel()
        rd = (d.horizontal * u[:, None] + d.lower_left_corner
              + d.vertical * v[:, None] - d.origin).astype(np.float32)
        rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
        ro = np.broadcast_to(d.origin, rd.shape).astype(np.float32).copy()
        n = len(rd)
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

    def reference(self, ro, rd, key, jit: bool, max_steps: int = 768):
        n = len(ro)
        if key is None:
            it, ir = np.full(n, MAT_NONE, np.int32), np.ones(n, np.float32)
        else:
            it = np.where(np.isnan(key), MAT_NONE,
                          MAT_DIELECTRIC).astype(np.int32)
            ir = np.where(np.isnan(key), 1.0, key).astype(np.float32)

        def run():
            return rtrace.grid_hit(
                self.static, self.rarrays, self.rmats, jnp.asarray(ro),
                jnp.asarray(rd), jnp.float32(np.inf), jnp.asarray(it),
                jnp.asarray(ir), jnp.ones(n, bool), max_steps=max_steps,
                tables=self.rtables, use_skip=True, bounded_t=False,
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

    def port(self, ro, rd, key, max_steps: int = 768, device="cpu",
             stats: bool = False):
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        out = ttile.grid_hit_tiles(
            self.static, self.tables.to(device),
            self.material_indices.to(device),
            *(t(ro[:, i]) for i in range(3)), *(t(rd[:, i]) for i in range(3)),
            torch.ones(len(ro), dtype=torch.bool, device=device),
            ray_key=None if key is None else t(key), max_steps=max_steps,
            stats=stats)
        return {k: v.cpu().numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def setup():
    return _Setup()


_BATCHES = ["primary", "scatter", "refracted"]


@pytest.mark.parametrize("batch", _BATCHES)
def test_twin_matches_jitted_reference(setup, batch):
    ro, rd, key = setup.batches[batch]
    want = setup.reference(ro, rd, key, jit=True)
    got = setup.port(ro, rd, key)
    assert got["found"].dtype == bool and got["index"].dtype == np.int32
    assert (got["found"] == want["found"]).mean() >= 0.999
    both = got["found"] & want["found"]
    assert both.sum() > 100
    np.testing.assert_allclose(got["t"][both], want["t"][both], atol=1e-5)
    np.testing.assert_array_equal(got["index"][both], want["index"][both])
    for k in ("nx", "ny", "nz"):
        np.testing.assert_array_equal(got[k][both], want[k][both])


@pytest.mark.parametrize("batch", _BATCHES)
def test_twin_bit_exact_against_reference_op_by_op(setup, batch):
    ro, rd, key = setup.batches[batch]
    want = setup.reference(ro, rd, key, jit=False)
    got = setup.port(ro, rd, key)
    for k in _KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_dielectric_key_skips_water(setup):
    """Rays starting inside the water pool (material 0, ir 1.333) along +x:
    keyed with the water's ir they pass through it and leave the grid;
    keyed NaN or with another ir they hit the water at once."""
    zs = np.arange(6, 16)
    ro = np.stack([np.full(10, 1.55), np.full(10, 6.875), (zs + 0.5) * 0.25],
                  -1).astype(np.float32)
    rd = np.tile(np.array([1.0, 0.01, 0.003], np.float32), (10, 1))
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    keys = {"nan": np.full(10, np.nan, np.float32),
            "water": np.full(10, 1.333, np.float32),
            "glass": np.full(10, 1.5, np.float32)}
    got = {name: setup.port(ro, rd, key) for name, key in keys.items()}
    for name in ("nan", "glass"):
        assert got[name]["found"].all() and (got[name]["index"] == 0).all()
    assert not got["water"]["found"].any()
    for name, key in keys.items():
        want = setup.reference(ro, rd, key, jit=False)
        for k in _KEYS:
            np.testing.assert_array_equal(got[name][k], want[k], err_msg=k)


@pytest.mark.parametrize("max_steps", [1, 2, 3, 5, 8, 13, 21])
def test_step_bound_counts_like_reference(setup, max_steps):
    """A lane retires after `max_steps` loop iterations with the verdict
    the reference's while loop gives an exhausted lane."""
    ro, rd, key = setup.batches["scatter"]
    want = setup.reference(ro, rd, None, jit=False, max_steps=max_steps)
    got = setup.port(ro, rd, None, max_steps=max_steps)
    for k in _KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("quantile", [0.0, 0.5, 0.9, 1.0])
def test_stats_twin_counts_steps_like_reference(setup, quantile):
    """The stats build's `n_step`: a lane that hits with n_step = k hits
    with max_steps = k and misses with k - 1 in the reference run op by
    op; the other outputs are those of the build without stats."""
    ro, rd, key = setup.batches["refracted"]
    got = setup.port(ro, rd, key, stats=True)
    plain = setup.port(ro, rd, key)
    for k in _KEYS:
        np.testing.assert_array_equal(got[k], plain[k], err_msg=k)
    n_step, found = got["n_step"], got["found"]
    assert n_step.dtype == np.int32 and (n_step >= 0).all()
    assert (n_step[~found] <= 768).all() and found.sum() > 100
    k = int(np.quantile(n_step[found], quantile, method="nearest"))
    lanes = found & (n_step == k)
    at_k = setup.reference(ro, rd, key, jit=False, max_steps=k)
    below = setup.reference(ro, rd, key, jit=False, max_steps=k - 1)
    assert lanes.any()
    assert at_k["found"][lanes].all()
    assert not below["found"][lanes].any()


def test_cpu_wrapper_runs_twin_without_counting(setup):
    ro, rd, _ = setup.batches["primary"]
    before = ttile.grid_hit_tiles.launches
    setup.port(ro[:64], rd[:64], None)
    assert ttile.grid_hit_tiles.launches == before


def test_wrapper_rejects_other_devices(setup):
    n = 8
    z = torch.zeros(n, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ttile.grid_hit_tiles(setup.static, setup.tables.to("meta"),
                             setup.material_indices.to("meta"),
                             z, z, z, z, z, z,
                             torch.ones(n, dtype=torch.bool, device="meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", _BATCHES)
def test_kernel_matches_twin_on_card(setup, batch):
    if not torch.cuda.is_available():
        pytest.skip("kernel A runs only on a CUDA device")
    ro, rd, key = setup.batches[batch]
    want = setup.port(ro, rd, key)
    before = ttile.grid_hit_tiles.launches
    got = setup.port(ro, rd, key, device="cuda")
    torch.cuda.synchronize()
    assert ttile.grid_hit_tiles.launches == before + 1
    for k in _KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- the array-of-structs entry points ---------------------------------------

def _aos_reference(setup, ro, rd, key, t_max=np.inf, **kw):
    n = len(ro)
    if key is None:
        it, ir = np.full(n, MAT_NONE, np.int32), np.ones(n, np.float32)
    else:
        it = np.where(np.isnan(key), MAT_NONE, MAT_DIELECTRIC).astype(np.int32)
        ir = np.where(np.isnan(key), 1.0, key).astype(np.float32)
    with jax.disable_jit():
        out = rtrace.grid_hit(
            setup.static, setup.rarrays, setup.rmats, jnp.asarray(ro),
            jnp.asarray(rd), jnp.float32(t_max), jnp.asarray(it),
            jnp.asarray(ir), jnp.ones(n, bool), **kw)
    return {k: np.asarray(v) for k, v in out.items()}, it, ir


def _aos_port(setup, ro, rd, it, ir, t_max=np.inf, **kw):
    out = ttrace.grid_hit(
        setup.static, setup.tarrays, torch.from_numpy(ro),
        torch.from_numpy(rd), t_max, torch.from_numpy(it),
        torch.from_numpy(ir), **kw)
    return {k: v.numpy() for k, v in out.items()}


_AOS_KEYS = ("found", "t", "point", "normal", "index")


@pytest.mark.parametrize("use_skip", [False, True], ids=["exact", "skip"])
@pytest.mark.parametrize("batch", _BATCHES)
def test_grid_hit_aos_bit_exact_op_by_op(setup, batch, use_skip):
    """`grid_hit` on f32[N, 3] rays, records built by each package for
    itself, `t_max = inf`: every field of every lane."""
    ro, rd, key = setup.batches[batch]
    want, it, ir = _aos_reference(setup, ro, rd, key, use_skip=use_skip)
    got = _aos_port(setup, ro, rd, it, ir, use_skip=use_skip)
    assert got["point"].shape == got["normal"].shape == (len(ro), 3)
    assert got["found"].sum() > 100
    for k in _AOS_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_grid_hit_aos_needs_ignore_false_drops_the_key(setup):
    """Rays inside the water pool, keyed with the water's ir, leave the
    grid; with `needs_ignore=False` they hit the water at once, as if no
    ray had a key, in both packages."""
    zs = np.arange(6, 16)
    ro = np.stack([np.full(10, 1.55), np.full(10, 6.875), (zs + 0.5) * 0.25],
                  -1).astype(np.float32)
    rd = np.tile(np.array([1.0, 0.01, 0.003], np.float32), (10, 1))
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    key = np.full(10, 1.333, np.float32)
    for needs, hits in ((True, False), (False, True)):
        want, it, ir = _aos_reference(setup, ro, rd, key, use_skip=True,
                                      needs_ignore=needs)
        got = _aos_port(setup, ro, rd, it, ir, use_skip=True,
                        needs_ignore=needs)
        assert got["found"].all() == hits and got["found"].any() == hits
        for k in _AOS_KEYS:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("bounded_t", [True, False])
@pytest.mark.parametrize("t_max", [7.1, 7.6, 10.1, 40.0])
def test_grid_hit_finite_t_max_is_a_filter_after_the_launch(setup, t_max,
                                                            bounded_t):
    """A finite `t_max` in the reference (with or without its `bounded_t`
    carry) gives the unbounded traversal's hits up to `t_max` and misses
    beyond: `found` on every lane, the other fields where found."""
    ro, rd, key = setup.batches["primary"]
    want, it, ir = _aos_reference(setup, ro, rd, key, t_max=t_max,
                                  use_skip=True, bounded_t=bounded_t)
    got = _aos_port(setup, ro, rd, it, ir, t_max=t_max, use_skip=True)
    unbounded = _aos_port(setup, ro, rd, it, ir, use_skip=True)
    np.testing.assert_array_equal(got["found"], want["found"])
    f = want["found"]
    if t_max < 40.0:
        assert 0 < f.sum() < unbounded["found"].sum()
    else:
        assert f.sum() == unbounded["found"].sum()
    for k in _AOS_KEYS:
        np.testing.assert_array_equal(got[k][f], want[k][f], err_msg=k)


def test_grid_hit_aos_bounds_like_reference_case():
    """tests/test_trace_parity.py's single ray toward the centre cube: found
    without a bound, missed with `max_steps=2`, and missed with a `t_max`
    short of the cube, in both packages."""
    sc = rscenes.flat_test_scene(dim=8)
    arrays = GridArrays.to_device(sc.grid.arrays, "cpu")
    ro = np.array([[4.0, 4.5, 20.0]], np.float32)
    rd = np.array([[0.0, 0.0, -1.0]], np.float32)

    def both(t_max=np.inf, **kw):
        with jax.disable_jit():
            r = rtrace.grid_hit(
                sc.grid.static, sc.grid.device_arrays(),
                rtrace.materials_to_device(sc.materials), jnp.asarray(ro),
                jnp.asarray(rd), jnp.float32(t_max),
                jnp.full(1, 3, jnp.int32), jnp.ones(1, jnp.float32),
                jnp.ones(1, bool), **kw)
        p = ttrace.grid_hit(sc.grid.static, arrays, torch.from_numpy(ro),
                            torch.from_numpy(rd), t_max,
                            torch.full((1,), 3, dtype=torch.int32),
                            torch.ones(1), **kw)
        assert bool(p["found"][0]) == bool(r["found"][0])
        return p

    full = both()
    assert bool(full["found"][0])
    assert float(full["t"][0]) == pytest.approx(15.0, abs=1.0)
    assert not bool(both(max_steps=2)["found"][0])
    assert not bool(both(t_max=10.0)["found"][0])
    assert bool(both(t_max=30.0)["found"][0])


@pytest.mark.parametrize("sample_index", [0, 3])
@pytest.mark.parametrize("band", [(0, None), (8, 16)])
def test_camera_rays_aos_bit_exact(sample_index, band):
    row0, rows = band
    cam = Camera(75.0, 40, 24, CameraConfig(origin=(1.0, 2.0, 3.0)))
    cam.turn_yaw(0.3)
    want = rtrace.camera_rays(rtrace.camera_vectors(cam.d_camera), 40, 24,
                              sample_index, row0, rows)
    got = ttrace.camera_rays(ttrace.camera_vectors(cam.d_camera, "cpu"),
                             40, 24, sample_index, row0, rows)
    for g, w in zip(got, want):
        assert tuple(g.shape) == ((24 if rows is None else rows) * 40, 3)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_background_color_bit_exact():
    d = np.random.default_rng(5).standard_normal((4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = np.asarray(rtrace.background_color(jnp.asarray(d)))
    got = ttrace.background_color(torch.from_numpy(d))
    np.testing.assert_array_equal(got.numpy(), want)


def _refraction_inputs():
    rng = np.random.default_rng(6)
    n = 8192
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    nrm = rng.standard_normal((n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm *= -np.sign((d * nrm).sum(-1, keepdims=True))  # facing the ray
    n1 = rng.choice(np.array([1.0, 1.333, 1.5], np.float32), n)
    n2 = rng.choice(np.array([1.0, 1.333, 1.5], np.float32), n)
    return n1, n2, d, nrm.astype(np.float32)


@pytest.mark.parametrize("exact_sqrt", [True, False])
def test_transmission_direction_against_reference(monkeypatch, exact_sqrt):
    """Bit for bit with a correctly rounded square root in both packages;
    with the backends' own, within 2^-22 (one ULP of the root, in [0, 1],
    times a unit normal's component)."""
    if exact_sqrt:
        monkeypatch.setattr(jnp, "sqrt",
                            lambda x: jnp.asarray(np.sqrt(np.asarray(x))))
        monkeypatch.setattr(torch, "sqrt",
                            lambda x: torch.from_numpy(np.sqrt(x.numpy())))
    n1, n2, d, nrm = _refraction_inputs()
    with jax.disable_jit():
        should_w, refr_w = rtrace.transmission_direction(
            jnp.asarray(n1), jnp.asarray(n2), jnp.asarray(d), jnp.asarray(nrm))
    should_g, refr_g = ttrace.transmission_direction(
        *(torch.from_numpy(a) for a in (n1, n2, d, nrm)))
    np.testing.assert_array_equal(should_g.numpy(), np.asarray(should_w))
    assert 0.5 < should_g.float().mean() < 1.0
    if exact_sqrt:
        np.testing.assert_array_equal(refr_g.numpy(), np.asarray(refr_w))
    else:
        np.testing.assert_allclose(refr_g.numpy(), np.asarray(refr_w),
                                   atol=2.0 ** -22, rtol=0)


@pytest.mark.parametrize("sun", [False, True], ids=["no_sun", "sun"])
def test_ray_color_aos_bit_exact_op_by_op(monkeypatch, setup, sun):
    """`ray_color` on f32[N, 3] rays, two bounce levels, against the
    reference's op by op, both packages with correctly rounded roots."""
    monkeypatch.setattr(jax.lax, "rsqrt", lambda x: 1.0 / jnp.sqrt(x))
    monkeypatch.setattr(jnp, "sqrt",
                        lambda x: jnp.asarray(np.sqrt(np.asarray(x))))
    monkeypatch.setattr(torch, "sqrt",
                        lambda x: torch.from_numpy(np.sqrt(x.numpy())))
    ro, rd, _ = setup.batches["primary"]
    ro, rd = ro[::3], rd[::3]
    sun_p = np.array([10.0, 30.0, 5.0], np.float32)
    sun_c = np.array([1.0, 0.9, 0.8], np.float32)
    radius = np.float32(2.0)
    with jax.disable_jit():
        want = np.asarray(rtrace.ray_color(
            setup.static, setup.rarrays, setup.rmats, jnp.asarray(ro),
            jnp.asarray(rd), 2, jnp.asarray(sun_p), sun, jnp.asarray(sun_c),
            jnp.float32(radius), max_steps=256, use_skip=True))
    got = ttrace.ray_color(
        setup.static, setup.tarrays, setup.tmats, torch.from_numpy(ro),
        torch.from_numpy(rd), 2, sun_p, sun, sun_c, radius, max_steps=256,
        use_skip=True)
    assert tuple(got.shape) == (len(ro), 3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(got.numpy().round(3), axis=0)) > 20
