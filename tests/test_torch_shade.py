"""The trace's shading glue (`zig_vulkan_tpu_torch.ops.shade`: kernels C, D
and E) against the JAX package, on the CPU, where each wrapper runs its
plain twin.

The JAX package computes the same work inline in `ops.trace._ray_color_soa`
and `render_rows`, with no function a level. So the twins are held against
those functions run op by op (`jax.disable_jit`) with their traversal
(`_grid_hit_soa`, the XLA wavefront) replaced by a stand-in that returns
hits made by numpy from a seed and records the rays each call is given:
the camera rays and the ray state after a level are the next call's
inputs, the shadow directions and mask the shadow call's inputs, the
colours the result. The hits mix all material types (lambertian, metal,
dielectric, emissive, none), misses and, after a refraction, dielectric
keys. Both packages' square roots are made correctly rounded, as in
tests/test_torch_tile_tracer.py. Tolerance 0: float arrays are compared as
int32 bit patterns.

The whole restructured `render_rows` (camera rays, the levels through the
traversal, the lookup and the shading, the resolve) is then held against
the JAX `render_rows` on tests/test_trace_parity.py's scene: op by op bit
for bit, and against the jitted reference within the statistical bounds of
tests/test_torch_engine.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zig_vulkan_tpu.config import CameraConfig as RCameraConfig
from zig_vulkan_tpu.core.camera import Camera as RCamera
from zig_vulkan_tpu.models import scenes as rscenes
from zig_vulkan_tpu.ops import trace as rtrace
from zig_vulkan_tpu_torch.core.grid import GridArrays
from zig_vulkan_tpu_torch.core.materials import (
    MAT_DIELECTRIC,
    MAT_EMISSIVE,
    MAT_LAMBERTIAN,
    MAT_METAL,
    MAT_NONE,
    MaterialTable,
)
from zig_vulkan_tpu_torch.ops import lookup as tlookup
from zig_vulkan_tpu_torch.ops import shade as tshade
from zig_vulkan_tpu_torch.ops import trace as ttrace

torch.set_num_threads(2)

SUN_P = np.array([10.0, 30.0, 5.0], np.float32)
SUN_C = np.array([1.0, 0.9, 0.8], np.float32)
RADIUS = np.float32(2.0)
N_MATERIALS = 8


@pytest.fixture
def exact_roots(monkeypatch):
    """Correctly rounded square roots in both packages."""
    monkeypatch.setattr(jax.lax, "rsqrt", lambda x: 1.0 / jnp.sqrt(x))
    monkeypatch.setattr(jnp, "sqrt",
                        lambda x: jnp.asarray(np.sqrt(np.asarray(x))))
    monkeypatch.setattr(torch, "sqrt",
                        lambda x: torch.from_numpy(np.sqrt(x.numpy())))


def _materials():
    t = MaterialTable.empty()
    t.set(0, MAT_DIELECTRIC, (0.117, 0.45, 0.85), 1.333)
    t.set(1, MAT_LAMBERTIAN, (0.0, 0.6, 0.0))
    t.set(2, MAT_METAL, (0.8, 0.8, 0.8), 0.3)
    t.set(3, MAT_EMISSIVE, (1.0, 0.5, 0.25), 4.0)
    t.set(4, MAT_NONE, (0.5, 0.5, 0.5))
    t.set(5, MAT_DIELECTRIC, (0.9, 0.9, 0.9), 1.52)
    t.set(6, MAT_METAL, (0.6, 0.3, 0.2), 0.0)
    t.set(7, MAT_LAMBERTIAN, (0.301, 0.149, 0.0))
    return t


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(got, want, what):
    g = got.numpy() if torch.is_tensor(got) else got
    np.testing.assert_array_equal(_bits(g), _bits(want), err_msg=what)


def _hits(rng, n, found_share=0.8):
    """A stand-in traversal's result: hit points in a box, axis normals,
    material indices over the whole table."""
    axis = rng.integers(0, 3, n)
    nrm = np.zeros((n, 3), np.float32)
    nrm[np.arange(n), axis] = rng.choice(np.float32([-1.0, 1.0]), n)
    p = rng.uniform(-8.0, 8.0, (n, 3)).astype(np.float32)
    return dict(found=rng.random(n) < found_share,
                t=rng.uniform(0.0, 10.0, n).astype(np.float32),
                px=p[:, 0], py=p[:, 1], pz=p[:, 2],
                nx=nrm[:, 0], ny=nrm[:, 1], nz=nrm[:, 2],
                index=rng.integers(0, N_MATERIALS, n).astype(np.int32))


def _shadow(rng, n):
    return dict(found=rng.random(n) < 0.4)


_CALL_KEYS = ("ox", "oy", "oz", "dx", "dy", "dz", "ignore_type", "internal",
              "mask")


class _Traversal:
    """The JAX package's `_grid_hit_soa`, replaced: returns the queued
    hits in order and records the rays of each call."""

    def __init__(self, hits):
        self.queue = list(hits)
        self.calls = []

    def __call__(self, static, arrays, mats, ox, oy, oz, dx, dy, dz, t_max,
                 ignore_type, internal, mask, *args, **kw):
        self.calls.append({k: np.asarray(v) for k, v in zip(
            _CALL_KEYS, (ox, oy, oz, dx, dy, dz, ignore_type, internal,
                         mask))})
        return {k: jnp.asarray(v) for k, v in self.queue.pop(0).items()}


def _torch(h):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in h.items()}


def _check_call(call, state, key, what):
    """The rays of a scatter call of the JAX traversal against the port's
    state after a level and the dielectric key it made."""
    for k in tshade.RAY_KEYS:
        _same(state[k], call[k], f"{what}: {k}")
    _same(state["bouncing"], call["mask"], f"{what}: bouncing")
    # the reference passes the key as (ignore type, internal reflection)
    isnan = torch.isnan(key)
    _same(torch.where(isnan, MAT_NONE, MAT_DIELECTRIC).to(torch.int32),
          call["ignore_type"], f"{what}: key's ignore type")
    _same(torch.where(isnan, 1.0, key), call["internal"],
          f"{what}: key's ir")


def _rays(rng, n):
    o = rng.uniform(-10.0, 10.0, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    return [np.ascontiguousarray(a[:, i]) for a in (o, d) for i in range(3)]


@pytest.mark.parametrize("sun", [False, True], ids=["no_sun", "sun"])
def test_shade_plain_levels_match_the_reference_level_body(exact_roots,
                                                           monkeypatch, sun):
    """Two bounce levels of `shade_plain` and the per-lane resolve against
    `_ray_color_soa`'s level body and tone map, on the same hits: the state
    after each level, the shadow rays, the next level's key, the colours."""
    rng = np.random.default_rng(11 + sun)
    n, levels = 1500, 2
    table = _materials()
    rays = _rays(rng, n)
    queue, scatter, shadow = [], [], []
    for _ in range(levels):
        scatter.append(_hits(rng, n))
        queue.append(scatter[-1])
        if sun:
            shadow.append(_shadow(rng, n))
            queue.append(shadow[-1])
    traversal = _Traversal(queue)
    monkeypatch.setattr(rtrace, "_grid_hit_soa", traversal)
    with jax.disable_jit():
        want = np.asarray(rtrace._ray_color_soa(
            None, None, rtrace.materials_to_device(table),
            *(jnp.asarray(a) for a in rays), levels, jnp.asarray(SUN_P), sun,
            jnp.asarray(SUN_C), jnp.float32(RADIUS), 64,
            tables=jnp.zeros(1, jnp.int32), use_skip=True))

    mats = ttrace.materials_to_device(table, "cpu")
    tr = [torch.from_numpy(a) for a in rays]
    dx, dy, dz = ttrace._norm3(*tr[3:])
    mode = tshade.sun_mode(sun, False)
    state = tshade.new_state(dict(zip(tshade.RAY_KEYS, (
        *(a.clone() for a in tr[:3]), dx, dy, dz))), mode)
    per = 2 if sun else 1
    _check_call(traversal.calls[0], state,
                torch.full((n,), float("nan")), "level 0")
    occluded = None
    for level in range(levels):
        hit = _torch(scatter[level])
        looked = tlookup.table_lookup(mats, hit["index"])
        out = tshade.shade_plain(state, hit, looked, mode, SUN_P, SUN_C,
                                 RADIUS, prev_occluded=occluded,
                                 next_key=level < levels - 1)
        if sun:
            call = traversal.calls[per * level + 1]
            for k, c in zip(("px", "py", "pz"), ("ox", "oy", "oz")):
                _same(hit[k], call[c], f"level {level} shadow origin")
            for k, c in zip(tshade.SHADOW_KEYS, ("dx", "dy", "dz")):
                _same(out[k], call[c], f"level {level} shadow {k}")
            _same(out["active"], call["mask"], f"level {level} shadow mask")
            occluded = torch.from_numpy(shadow[level]["found"])
        if level < levels - 1:
            _check_call(traversal.calls[per * (level + 1)], state,
                        out["key"], f"after level {level}")
            assert 0 < int((~torch.isnan(out["key"])).sum()) < n
    assert traversal.queue == []
    got = tshade.resolve_plain(state, 1, SUN_C if sun else None, occluded,
                               gamma=False)
    _same(got, want, "colour")
    assert got.shape == (n, 3)
    # every kind of lane was there: emitters, misses, lanes that bounced
    # twice, lanes that ended on an unknown material
    assert len(np.unique(got.numpy().round(3), axis=0)) > 100


def test_probe_mode_equals_the_deferred_sun_term(exact_roots):
    """With the sun traced in the scatter launch (SUN_PROBE), the level adds
    its lit term at once; with a shadow launch the next level (or the
    resolve) adds it: the same colours, the same state."""
    rng = np.random.default_rng(5)
    n = 1200
    mats = ttrace.materials_to_device(_materials(), "cpu")
    tr = [torch.from_numpy(a) for a in _rays(rng, n)]
    dx, dy, dz = ttrace._norm3(*tr[3:])
    hits = [_torch(_hits(rng, n)) for _ in range(3)]
    occ = [torch.from_numpy(_shadow(rng, n)["found"]) for _ in range(3)]
    colours, states = {}, {}
    for mode in (tshade.SUN_PROBE, tshade.SUN_DEFERRED):
        # the state's tensors are updated in place: each run its own
        state = tshade.new_state(dict(zip(tshade.RAY_KEYS, (
            a.clone() for a in (*tr[:3], dx, dy, dz)))), mode)
        prev = None
        for level in range(3):
            hit = dict(hits[level], occluded=occ[level])
            looked = tlookup.table_lookup(mats, hit["index"])
            out = tshade.shade_plain(
                state, hit, looked, mode, SUN_P, SUN_C, RADIUS,
                prev_occluded=prev, next_key=level < 2,
                next_targets=mode == tshade.SUN_PROBE and level < 2)
            if mode == tshade.SUN_PROBE and level < 2:
                want = ttrace.sun_targets(state["dx"], state["dy"],
                                          state["dz"], SUN_P, RADIUS)
                for k, w in zip(tshade.TARGET_KEYS, want):
                    _same(out[k], w.numpy(), f"level {level} target {k}")
            prev = occ[level] if mode == tshade.SUN_DEFERRED else None
        colours[mode] = tshade.resolve_plain(state, 1, SUN_C, prev,
                                             gamma=False)
        states[mode] = state
    _same(colours[tshade.SUN_PROBE], colours[tshade.SUN_DEFERRED].numpy(),
          "colour")
    for k in tshade.RAY_KEYS + ("loop_count", "bouncing", "internal_refl",
                                "ignore_type"):
        _same(states[tshade.SUN_PROBE][k],
              states[tshade.SUN_DEFERRED][k].numpy(), k)


def _reference_camera(width, height):
    cam = RCamera(75.0, width, height, RCameraConfig(origin=(4.0, 6.5, 15.0)))
    cam.turn_yaw(0.3)
    return cam


@pytest.mark.parametrize("spp,sample_base,band", [
    (1, 0.0, None), (2, 0.0, None), (3, 5.0, (2, 3)), (2, 7.0, (5, 4))])
@pytest.mark.parametrize("sun", [False, True], ids=["no_sun", "sun"])
def test_camera_rays_plain_matches_the_reference(exact_roots, spp,
                                                 sample_base, band, sun):
    """`camera_rays_plain` against the reference's `_camera_rays_soa` of
    each sample (seed sample_base + s in float32), concatenated and put
    through `_norm3`; the sun targets against the reference's jitter of
    the normalized directions (trace.py:1127-1139)."""
    w, h = 20, 12
    row0, rows = band if band else (0, h)
    cam = _reference_camera(w, h)
    rcam = rtrace.camera_vectors(cam.d_camera)
    with jax.disable_jit():
        samples = [rtrace._camera_rays_soa(
            rcam, w, h, jnp.asarray(sample_base, jnp.float32)
            + jnp.float32(s), row0=row0, rows=rows) for s in range(spp)]
        cat = [jnp.concatenate([sm[i] for sm in samples]) for i in range(6)]
        rdx, rdy, rdz = rtrace._norm3(*cat[3:])
        jx, jy, jz = rtrace._rand_vec3_range_soa(
            rdx + rdz, rdy + rdz, -jnp.float32(RADIUS), jnp.float32(RADIUS))
        want = dict(zip(tshade.RAY_KEYS, (*cat[:3], rdx, rdy, rdz)),
                    tx=SUN_P[0] + jx, ty=SUN_P[1] + jy, tz=SUN_P[2] + jz)
    base = torch.tensor(sample_base) if spp == 3 else sample_base
    got = tshade.camera_rays(ttrace.camera_vectors(cam.d_camera, "cpu"), w,
                             h, spp, base, row0, rows,
                             sun=(SUN_P, RADIUS) if sun else None)
    assert set(got) == set(tshade.RAY_KEYS) | (
        set(tshade.TARGET_KEYS) if sun else set())
    for k, v in got.items():
        assert v.shape == (spp * rows * w,) and v.is_contiguous()
        _same(v, np.asarray(want[k]), k)


@pytest.mark.parametrize("spp,sun", [(1, False), (2, True), (3, True)])
def test_resolve_plain_matches_the_reference_render_rows(exact_roots,
                                                         monkeypatch, spp,
                                                         sun):
    """Camera rays, one level and the resolve of `spp` samples against the
    reference's `render_rows` (one wavefront a sample, summed in order
    from zeros, divided by spp, square root) on the same hits."""
    rng = np.random.default_rng(3 * spp + sun)
    w, h, row0, rows = 16, 10, 1, 6
    m = rows * w
    table = _materials()
    cam = _reference_camera(w, h)
    scatter = [_hits(rng, m, 0.7) for _ in range(spp)]
    shadow = [_shadow(rng, m) for _ in range(spp)]
    queue = [x for s in range(spp)
             for x in ((scatter[s], shadow[s]) if sun else (scatter[s],))]
    traversal = _Traversal(queue)
    monkeypatch.setattr(rtrace, "_grid_hit_soa", traversal)
    with jax.disable_jit():
        want = np.asarray(rtrace.render_rows(
            None, None, rtrace.materials_to_device(table),
            rtrace.camera_vectors(cam.d_camera), w, h, spp, 1,
            jnp.asarray(SUN_P), jnp.asarray(SUN_C), jnp.float32(RADIUS), sun,
            row0=row0, rows=rows, max_steps=64,
            tables=jnp.zeros(1, jnp.int32), use_skip=True,
            sample_base=jnp.float32(1.0)))

    mode = tshade.sun_mode(sun, False)
    rays = tshade.camera_rays(ttrace.camera_vectors(cam.d_camera, "cpu"), w,
                              h, spp, 1.0, row0, rows)
    per = 2 if sun else 1
    for s in range(spp):
        for k in tshade.RAY_KEYS:
            _same(rays[k][s * m:(s + 1) * m], traversal.calls[per * s][k],
                  f"sample {s} camera {k}")
    state = tshade.new_state(rays, mode)
    hit = _torch({k: np.concatenate([x[k] for x in scatter])
                  for k in scatter[0]})
    looked = tlookup.table_lookup(ttrace.materials_to_device(table, "cpu"),
                                  hit["index"])
    tshade.shade_plain(state, hit, looked, mode, SUN_P, SUN_C, RADIUS)
    occluded = (torch.from_numpy(np.concatenate([x["found"] for x in shadow]))
                if sun else None)
    got = tshade.resolve_plain(state, spp, SUN_C if sun else None, occluded)
    assert got.shape == (m, 3)
    _same(got.reshape(rows, w, 3), want, "pixels")
    # the wrapper on CPU tensors is the twin, and counts no launch
    before = (tshade.camera_rays.launches, tshade.shade.launches,
              tshade.resolve.launches)
    _same(tshade.resolve(state, spp, SUN_C if sun else None, occluded), got,
          "wrapper")
    assert (tshade.camera_rays.launches, tshade.shade.launches,
            tshade.resolve.launches) == before


def test_resolve_refuses_per_lane_colours_of_several_samples():
    state = {k: torch.zeros(4) for k in tshade.COLOUR_KEYS + ("dy",)}
    state["loop_count"] = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="one sample"):
        tshade.resolve(state, 2, gamma=False)


# -- the slice end to end: render_rows on a real scene --------------------------

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


@pytest.fixture(scope="module")
def parity_scene():
    sc = _parity_scene()
    static = sc.grid.static
    rarrays = sc.grid.device_arrays()
    rtables = rtrace.build_trace_tables(
        static, rarrays, rtrace.distance_field(static, rarrays, exact=True))
    arrays = GridArrays.to_device(sc.grid.arrays, "cpu")
    return dict(static=static, rarrays=rarrays, rtables=rtables,
                rmats=rtrace.materials_to_device(sc.materials),
                tables=torch.from_numpy(np.array(rtables)),
                material_indices=arrays.material_indices,
                mats=ttrace.materials_to_device(sc.materials, "cpu"))


_RENDERS = [(2, True, 2), (1, False, 2)]


def _port_render(s, cam, spp, sun, levels, w, h):
    return ttrace.render_rows(
        s["static"], s["tables"], s["material_indices"], s["mats"],
        ttrace.camera_vectors(cam.d_camera, "cpu"), w, h, spp, levels,
        SUN_P, SUN_C, RADIUS, sun, max_steps=256, sample_base=2.0).numpy()


def _reference_render(s, cam, spp, sun, levels, w, h):
    return np.asarray(rtrace.render_rows(
        s["static"], s["rarrays"], s["rmats"],
        rtrace.camera_vectors(cam.d_camera), w, h, spp, levels,
        jnp.asarray(SUN_P), jnp.asarray(SUN_C), jnp.float32(RADIUS), sun,
        max_steps=256, tables=s["rtables"], use_skip=True,
        sample_base=jnp.float32(2.0)))


@pytest.mark.parametrize("spp,sun,levels", _RENDERS,
                         ids=["2spp_sun", "1spp_no_sun"])
def test_render_rows_equals_the_reference_op_by_op(exact_roots, parity_scene,
                                                   spp, sun, levels):
    """Camera rays, two levels of traversal, lookup and shading, the
    resolve: bit for bit against the reference's `render_rows` op by op."""
    w, h = 32, 24
    cam = _reference_camera(w, h)
    with jax.disable_jit():
        want = _reference_render(parity_scene, cam, spp, sun, levels, w, h)
    got = _port_render(parity_scene, cam, spp, sun, levels, w, h)
    assert got.shape == (h, w, 3)
    _same(got, want, "frame")
    assert len(np.unique(got.round(3).reshape(-1, 3), axis=0)) > 30


@pytest.mark.parametrize("spp,sun,levels", _RENDERS,
                         ids=["2spp_sun", "1spp_no_sun"])
def test_render_rows_matches_the_jitted_reference(parity_scene, spp, sun,
                                                  levels):
    """Against the jitted reference (XLA:CPU contracts multiply-adds and
    approximates rsqrt): tests/test_torch_engine.py's bounds on traced
    frames."""
    w, h = 48, 48
    cam = _reference_camera(w, h)
    want = _reference_render(parity_scene, cam, spp, sun, levels, w, h)
    got = _port_render(parity_scene, cam, spp, sun, levels, w, h)
    diff = np.abs(got - want).max(axis=-1)
    assert diff.mean() < 5e-3
    assert (diff > 1e-3).mean() < 0.01
