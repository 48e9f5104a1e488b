"""The port's engine against the JAX engine through one session of edits,
`empty_skip` flips and a flush, move by move.

The JAX engine builds its records once, with the exact skip field, whatever
`empty_skip` is; every insert rewrites the conservative field, every
removal regathers the touched rows with the cached field, and only
`flush_grid` drops them. `empty_skip` picks only the frame's traversal.
The port's engine must keep the same records: after every move its
`_tables` and `_dist` equal the JAX engine's bit for bit, it builds the
records on the same moves (the first frame and the first after a flush),
and its primary frame equals the JAX engine's within 1e-5.

The scene is the flat test scene 12 cells tall: its upper cells lie more
than `_DF_EXACT_RADIUS` cells from any geometry, so the exact and the
conservative fields differ there, and records that followed `empty_skip`
(rebuilt with the exact field on a flip back) would differ from the JAX
engine's.

The exact DDA (`use_skip=False`) never reads the records' distance lane:
the plain twin of kernel A's NO_SKIP builds gives the same answer bit for
bit on the exact field, the conservative one and all 0. The card's twin of
that test is in `tests/test_torch_kernels.py`.
"""

import dataclasses

import numpy as np
import pytest
import torch

import zig_vulkan_tpu.config as rconfig
import zig_vulkan_tpu_torch.config as tconfig
from zig_vulkan_tpu.engine import engine as rengine
from zig_vulkan_tpu.models import scenes as rscenes
from zig_vulkan_tpu_torch.engine import engine as tengine
from zig_vulkan_tpu_torch.models import scenes as tscenes
from zig_vulkan_tpu_torch.ops import tile_tracer
from zig_vulkan_tpu_torch.ops import trace as ttrace

torch.set_num_threads(2)

DIM = 12  # cells a side: the top cells lie 5-8 cells from the geometry
SIDE = 48  # frame pixels a side


def _config(m):
    return m.EngineConfig(
        internal_resolution_width=SIDE, internal_resolution_height=SIDE,
        camera=m.CameraConfig(origin=(6.0, 8.0, 20.0), samples_per_pixel=1,
                              max_bounce=0),
        sun=m.SunConfig(enabled=False),
        denoiser=m.DenoiserConfig(enabled=False))


def _block(x, y, z):
    """int32[N, 3] voxels of the box with corners (x0, y0, z0) and (x1, y1,
    z1), upper bounds excluded, given as (x0, x1), (y0, y1), (z0, z1)."""
    g = np.meshgrid(np.arange(*x), np.arange(*y), np.arange(*z),
                    indexing="ij")
    return np.stack([a.ravel() for a in g], -1).astype(np.int32)


def _batches():
    """The session's two insert batches: a block in front of the camera
    and a scatter of single voxels, all below y = 16 (the scene's lowest
    region, which the floor already marks, so neither engine's scene
    degrades), with materials from a seed."""
    rng = np.random.default_rng(14)
    out = []
    for block in (_block((10, 30), (4, 12), (40, 43)),
                  _block((4, 12), (4, 14), (30, 33))):
        spray = np.stack([rng.integers(0, 48, 60), rng.integers(0, 16, 60),
                          rng.integers(0, 48, 60)], -1).astype(np.int32)
        xyz = np.unique(np.concatenate([block, spray]), axis=0)
        out.append((xyz, rng.integers(1, 9, len(xyz)).astype(np.uint8)))
    return out


def _edited_grid(scenes):
    """The scene with a slab of material 3 at y = 14: a same-geometry grid
    to flush in."""
    sc = scenes.flat_test_scene(dim=DIM)
    xs, zs = np.meshgrid(np.arange(0, 20), np.arange(0, 20), indexing="ij")
    sc.grid.insert_batch(xs.ravel(), np.full(xs.size, 14), zs.ravel(),
                         np.full(xs.size, 3, dtype=np.uint8))
    return sc.grid


def _counted(store, name, fn):
    def call(*args, **kw):
        store[name] += 1
        return fn(*args, **kw)
    return call


def test_session_records_and_frames_match_the_jax_engine(monkeypatch):
    """first frame -> insert -> empty_skip flipped -> insert and remove
    while flipped -> flipped back -> remove -> flush_grid of an edited grid
    -> flipped and back: the records and the field bit for bit, the
    records' builds on the same moves, and the primary frame within 1e-5,
    after every move."""
    rsc, tsc = (s.flat_test_scene(dim=DIM) for s in (rscenes, tscenes))
    st = tsc.grid.static
    start = tsc.grid.arrays.to_device("cpu")
    exact = ttrace.distance_field(st, start, exact=True)
    assert int((exact != ttrace.distance_field(st, start)).sum()) > 100
    assert int(exact.max()) >= 5

    ref = rengine.VoxelRT(rsc.grid, rsc.materials, _config(rconfig))
    port = tengine.VoxelRT(tsc.grid, tsc.materials, _config(tconfig),
                           device="cpu")
    builds = {"ref": 0, "port": 0}
    ref._tables_fn = _counted(builds, "ref", ref._tables_fn)
    monkeypatch.setattr(tengine.trace_mod, "build_trace_tables", _counted(
        builds, "port", ttrace.build_trace_tables))

    (ins_a, mat_a), (ins_b, mat_b) = _batches()
    flushed = {ref: _edited_grid(rscenes), port: _edited_grid(tscenes)}

    def flip(value):
        def move(rt):
            rt.trace_config = dataclasses.replace(rt.trace_config,
                                                  empty_skip=value)
        return move

    moves = [
        ("first frame", lambda rt: None),
        ("insert", lambda rt: rt.insert_voxels(ins_a, mat_a)),
        ("empty_skip flipped", flip(False)),
        ("flipped, insert", lambda rt: rt.insert_voxels(ins_b, mat_b)),
        ("flipped, remove", lambda rt: rt.remove_voxels(
            np.concatenate([ins_a[::3], ins_b[::2]]))),
        ("empty_skip back", flip(True)),
        ("remove", lambda rt: rt.remove_voxels(ins_a[1::3])),
        ("flush_grid", lambda rt: rt.flush_grid(flushed[rt])),
        ("flipped after the flush", flip(False)),
        ("back after the flush", flip(True))]
    rebuilt = []
    for label, move in moves:
        before = dict(builds)
        move(ref)
        move(port)
        want = np.asarray(ref.render())
        got = port.render().numpy()
        np.testing.assert_array_equal(port._dist.numpy(),
                                      np.asarray(ref._dist), err_msg=label)
        np.testing.assert_array_equal(port._tables.numpy(),
                                      np.asarray(ref._tables), err_msg=label)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                   err_msg=label)
        assert (builds["port"] - before["port"]
                == builds["ref"] - before["ref"]), label
        if builds["port"] > before["port"]:
            rebuilt.append(label)
        if label == "empty_skip back":
            # the inserts' conservative field, as the JAX engine's
            conservative = ttrace.distance_field(st, port.arrays)
            assert torch.equal(port._dist, conservative)
            assert not torch.equal(port._dist, ttrace.distance_field(
                st, port.arrays, exact=True))
    assert rebuilt == ["first frame", "flush_grid"]
    assert set(port._edit_cache[1024].graphs) == {("insert", True),
                                                  ("remove", True)}
    assert not port._scene_degraded() and not ref._scene_degraded()


# -- the exact DDA never reads the records' distance lane ---------------------

def _rays(rt, n_random, seed):
    """The engine's primary rays and `n_random` rays from points in and
    around the grid in random directions (numpy, from `seed`)."""
    cam = ttrace.camera_vectors(rt.camera.d_camera, "cpu")
    r = ttrace._camera_rays_soa(cam, SIDE, SIDE, 0)
    prim = (*r[:3], *ttrace._norm3(*r[3:]))
    k = ttrace.trace_constants(rt.grid_static)
    g0, g1 = np.asarray(k["g0"], np.float32), np.asarray(k["g1"], np.float32)
    rng = np.random.default_rng(seed)
    o = (g0 - 0.2 * (g1 - g0)
         + rng.random((n_random, 3)) * 1.4 * (g1 - g0)).astype(np.float32)
    d = rng.standard_normal((n_random, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rand = [torch.from_numpy(np.ascontiguousarray(a[:, i]))
            for a in (o, d) for i in range(3)]
    return tuple(torch.cat([p.reshape(-1), q]).contiguous()
                 for p, q in zip(prim, rand))


def _three_fields(st, arrays):
    """The scene's records with the exact field, the conservative one and
    all 0."""
    fields = (("exact", ttrace.distance_field(st, arrays, exact=True)),
              ("conservative", ttrace.distance_field(st, arrays)),
              ("zero", ttrace.no_skip_field(st, arrays)))
    return {name: ttrace.build_trace_tables(st, arrays, dist)
            for name, dist in fields}


@pytest.mark.parametrize("build", ["exact", "exact+shadow", "exact+stats",
                                   "exact+shadow+stats"])
def test_exact_dda_ignores_the_distance_lane(build):
    """The plain twin of each NO_SKIP build on the edited scene's records
    with the exact field, the conservative one and all 0: the same answer
    bit for bit, on primary and random rays with scattered live lanes and
    dielectric keys. The default build's steps differ between the fields,
    so the fields differ where rays go."""
    sc = tscenes.flat_test_scene(dim=DIM)
    rt = tengine.VoxelRT(sc.grid, sc.materials, _config(tconfig),
                         device="cpu")
    rt.insert_voxels(*_batches()[0])
    st, arrays = rt.grid_static, rt.arrays
    fields = _three_fields(st, arrays)
    rays = _rays(rt, 2000, 3)
    n = rays[0].shape[0]
    rng = np.random.default_rng(4)
    active = torch.from_numpy(rng.random(n) < 0.8)
    key = torch.from_numpy(rng.choice(np.array([np.nan, 1.333, 1.5],
                                               np.float32), n))
    kw = dict(ray_key=key, stats="stats" in build)
    if "shadow" in build:
        t = torch.from_numpy(rng.standard_normal((3, n)).astype(np.float32)
                             * 1000.0)
        kw["shadow_targets"] = tuple(t[i].contiguous() for i in range(3))

    def hits(tables, use_skip=False):
        return tile_tracer.grid_hit_plain(
            st, tables, arrays.material_indices, *rays, active,
            use_skip=use_skip, **kw)

    want = hits(fields["exact"])
    assert int(want["found"].sum()) > 500
    for name in ("conservative", "zero"):
        got = hits(fields[name])
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (name, k)
    steps = {name: tile_tracer.grid_hit_plain(
        st, fields[name], arrays.material_indices, *rays, active,
        stats=True)["n_step"] for name in ("exact", "conservative")}
    assert not torch.equal(steps["exact"], steps["conservative"])
