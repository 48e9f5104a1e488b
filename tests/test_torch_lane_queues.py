"""The bounce levels' queues of live lanes (`ops.trace._trace_levels`).

After the first scatter launch, kernel D (`ops.shade.shade`) appends the
lanes it leaves bouncing and the lanes it marks for a shadow ray to two
queues (`ops.trace.LaneQueue`), and the later launches of kernel A
(`ops.tile_tracer.grid_hit_tiles`) and kernel B (`ops.lookup.table_lookup`)
take them instead of the whole wavefront. From the second level on, kernel D
takes one too: the previous level's shadow queue (with a shadow launch)
or its scatter queue, the lanes it could have left with work. The queue
changes which lanes are visited, never a lane's arithmetic: on the CPU the
queued levels (the plain twins, gathering and scattering the queued lanes)
give the image of the full-lane levels bit for bit in every sun mode, on
the exact DDA, with the dielectric key and the emissive term, and in any
queue order, and kernel D over its queue leaves the state and the outputs
that later launches read as the full-lane launch does, whatever the lanes
outside the queue hold. The engine counts kernel A's and kernel D's
launches and the queued ones a frame, which
`rtbench/metrics/traverse.queued_share.py` and
`rtbench/metrics/shade.queued_share.py` read.

This file imports no JAX: `python -m pytest --noconftest
tests/test_torch_lane_queues.py` also runs on a machine with a GPU and no
JAX, where the `cuda` tests hold the kernels' queued launches against
their full-lane launches and the queued frame against the plain twins run
op by op on the card (`rtbench/ref/`, as the benchmark's reference runs
them). Without a card those skip.
"""

import importlib.util
import inspect
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from zig_vulkan_tpu_torch.config import CameraConfig, EngineConfig
from zig_vulkan_tpu_torch.core.materials import MAT_EMISSIVE, MAT_METAL
from zig_vulkan_tpu_torch.engine.engine import VoxelRT
from zig_vulkan_tpu_torch.models import scenes
from zig_vulkan_tpu_torch.ops import lookup, shade, tile_tracer, trace
from zig_vulkan_tpu_torch.utils import profiling

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
SUN_P = (40.0, 60.0, 30.0)
SUN_C = (1.0, 1.1, 1.0)
RADIUS = 5.0
W, H = 32, 24


def _scene():
    """The water pool and iron pillar of `small_test_scene` (dielectric and
    metal voxels) plus an emissive block (material 40, as the emissive
    cell's) and a rough metal block (material 41, fuzz 1: many of its rays
    scatter below the surface and stop, lit)."""
    sc = scenes.small_test_scene()
    sc.materials.set(40, MAT_EMISSIVE, (1.0, 0.85, 0.4), 8.0)
    sc.materials.set(41, MAT_METAL, (0.8, 0.8, 0.8), 1.0)
    for mat, (x0, y0, z0), size in ((40, (22, 4, 8), 4),
                                    (41, (12, 12, 20), 8)):
        xs, ys, zs = np.meshgrid(*(np.arange(v, v + size)
                                   for v in (x0, y0, z0)), indexing="ij")
        sc.grid.insert_batch(xs.ravel(), ys.ravel(), zs.ravel(),
                             np.full(xs.size, mat, dtype=np.uint8))
    return sc


def _engine(width, height, device):
    """An engine on `_scene()` whose camera sees the pool, the pillar and
    the emissive block."""
    sc = _scene()
    rt = VoxelRT(sc.grid, sc.materials, EngineConfig(
        internal_resolution_width=width, internal_resolution_height=height,
        camera=CameraConfig(origin=(4.0, 6.5, 15.0))), device=device)
    rt.camera.turn_yaw(0.3)
    return rt


@pytest.fixture(scope="module")
def rt_cpu():
    return _engine(W, H, "cpu")


def full_lane_levels(static, tables, material_indices, mats, state,
                     max_bounce, mode, sun, targets=None, max_steps=768,
                     use_skip=True, report=None):
    """The bounce levels with every launch over the whole wavefront (the
    loop before the queues)."""
    key = occluded = None
    for level in range(max_bounce):
        last = level == max_bounce - 1
        h = tile_tracer.grid_hit_tiles(
            static, tables, material_indices,
            *(state[k] for k in shade.RAY_KEYS), state["bouncing"],
            ray_key=key, max_steps=max_steps, shadow_targets=targets,
            use_skip=use_skip)
        looked = lookup.table_lookup(mats, h["index"])
        out = shade.shade(state, h, looked, mode, *sun,
                          prev_occluded=occluded, next_key=not last,
                          next_targets=mode == shade.SUN_PROBE and not last)
        key = out.get("key")
        targets = (tuple(out[k] for k in shade.TARGET_KEYS)
                   if "tx" in out else None)
        if mode == shade.SUN_DEFERRED:
            occluded = tile_tracer.grid_hit_tiles(
                static, tables, material_indices, h["px"], h["py"], h["pz"],
                *(out[k] for k in shade.SHADOW_KEYS), out["active"],
                max_steps=max_steps, use_skip=use_skip)["found"]
    return occluded


def _render(rt, dev, levels, sun_on, probe, use_skip, report=None,
            spp=2, width=W, height=H, ref=trace):
    cam = ref.camera_vectors(rt.camera.d_camera, dev)
    kw = {} if report is None else dict(report=report)
    return ref.render_rows(
        rt.grid_static, rt.tables(), rt.arrays.material_indices, rt.mats,
        cam, width, height, spp, levels, SUN_P, SUN_C, RADIUS, sun_on,
        max_steps=256, sample_base=2.0, shadow_probe=probe,
        use_skip=use_skip, **kw)


def _bits(a):
    return a.contiguous().view(torch.int32)


# (levels, sun on, sun traced in kernel A, empty skip): the three sun modes
# (SUN_DEFERRED, SUN_PROBE, SUN_OFF), the exact DDA, one and four levels
_CASES = {
    "deferred": (3, True, False, True),
    "probe": (3, True, True, True),
    "off": (3, False, False, True),
    "deferred_no_skip": (3, True, False, False),
    "probe_no_skip": (2, True, True, False),
    "deferred_four_levels": (4, True, False, True),
    "one_level": (1, True, False, True),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_queued_levels_equal_the_full_lane_levels(rt_cpu, monkeypatch, case):
    levels, sun_on, probe, skip = _CASES[case]
    report = {}
    got = _render(rt_cpu, "cpu", levels, sun_on, probe, skip, report)
    monkeypatch.setattr(trace, "_trace_levels", full_lane_levels)
    want = _render(rt_cpu, "cpu", levels, sun_on, probe, skip)
    assert torch.equal(_bits(got), _bits(want))
    assert len(np.unique(got.numpy().round(3).reshape(-1, 3), axis=0)) > 20
    per = 2 if sun_on and not probe else 1
    assert report == dict(trace_launches=levels * per,
                          trace_queued=levels * per - 1,
                          shade_launches=levels, shade_queued=levels - 1)


@pytest.mark.parametrize("case", list(_CASES))
def test_queued_levels_read_no_unwritten_lane(rt_cpu, monkeypatch, case):
    """The kernels leave the lanes outside a launch's queue unwritten: with
    the plain twins' outputs there turned to NaN and random values (their
    0 replaced by what an unwritten tensor may hold), the queued levels
    still give the full-lane image bit for bit, so no later launch reads
    such a lane."""
    levels, sun_on, probe, skip = _CASES[case]
    want = _render(rt_cpu, "cpu", levels, sun_on, probe, skip)
    g = torch.Generator().manual_seed(21)
    real_hit, real_lookup = tile_tracer.grid_hit_tiles, trace.table_lookup
    real_shade = shade.shade_plain
    spoiled = []

    def spoil(out, queue):
        if queue is None:
            return out
        lanes = queue.host_lanes()
        spoiled.append(lanes.numel())
        return _garbage(out, lanes, g) if len(out) else out

    monkeypatch.setattr(tile_tracer, "grid_hit_tiles", lambda *a, **kw: spoil(
        real_hit(*a, **kw), kw.get("queue")))
    monkeypatch.setattr(trace, "table_lookup", lambda *a, **kw: spoil(
        real_lookup(*a, **kw), kw.get("queue")))
    monkeypatch.setattr(shade, "shade_plain", lambda *a, **kw: spoil(
        real_shade(*a, **kw), inspect.signature(real_shade).bind(
            *a, **kw).arguments.get("queue")))
    got = _render(rt_cpu, "cpu", levels, sun_on, probe, skip)
    assert torch.equal(_bits(got), _bits(want))
    per = 2 if sun_on and not probe else 1
    # A's and B's queued launches, and D's from the second level on
    assert len(spoiled) == levels * per - 1 + 2 * (levels - 1)


def test_the_scene_exercises_the_key_and_the_emissive_term(rt_cpu,
                                                           monkeypatch):
    """The queued levels of the deferred case take a dielectric key and
    add the emissive term on some lane."""
    keyed, emitted = [], []
    real_hit, real_shade = tile_tracer.grid_hit_tiles, shade.shade_plain

    def hit(*args, **kw):
        if kw.get("ray_key") is not None and kw.get("queue") is not None:
            keyed.append(int(torch.isfinite(kw["ray_key"]).sum()))
        return real_hit(*args, **kw)

    def shade_plain(state, h, looked, *args, **kw):
        live = state["bouncing"] & h["found"]
        emitted.append(int((live & (looked[3] == MAT_EMISSIVE)).sum()))
        return real_shade(state, h, looked, *args, **kw)

    monkeypatch.setattr(tile_tracer, "grid_hit_tiles", hit)
    monkeypatch.setattr(shade, "shade_plain", shade_plain)
    _render(rt_cpu, "cpu", 3, True, False, True)
    assert sum(keyed) > 0 and sum(emitted) > 0


def test_queue_order_does_not_change_the_image(rt_cpu, monkeypatch):
    """Kernel D's appends keep lane order only within a warp: the image is
    the same with every queue reversed against lane order."""
    want = _render(rt_cpu, "cpu", 3, True, False, True)
    real_append = shade._append
    reversed_lanes = []

    def append_reversed(queue, take):
        start = int(queue.count[0])
        real_append(queue, take)
        end = int(queue.count[0])
        queue.lanes[start:end] = queue.lanes[start:end].flip(0)
        reversed_lanes.append(end - start)

    monkeypatch.setattr(shade, "_append", append_reversed)
    got = _render(rt_cpu, "cpu", 3, True, False, True)
    assert torch.equal(_bits(got), _bits(want))
    # two scatter queues and three shadow queues, none of them trivial
    assert len(reversed_lanes) == 5 and min(reversed_lanes) > 1


def _queue(lanes, n):
    buf = torch.full((n,), -1, dtype=torch.int32)
    buf[:len(lanes)] = torch.as_tensor(lanes, dtype=torch.int32)
    return trace.LaneQueue(buf, torch.tensor([len(lanes)], dtype=torch.int32))


def _primary(rt, dev):
    cam = trace.camera_vectors(rt.camera.d_camera, dev)
    rays = shade.camera_rays(cam, W, H, 1)
    return tuple(rays[k] for k in shade.RAY_KEYS)


@pytest.mark.parametrize("order", ["empty", "full", "ragged", "shuffled"])
def test_grid_hit_plain_over_a_queue(rt_cpu, order):
    """The plain twin of kernel A over a queue: the full-lane results on the
    queued lanes, 0 on the others (the kernel leaves them unwritten)."""
    rays = _primary(rt_cpu, "cpu")
    n = rays[0].shape[0]
    active = torch.rand(n, generator=torch.Generator().manual_seed(3)) < 0.7
    lanes = {"empty": [], "full": list(range(n)),
             "ragged": list(range(0, n, 3))[:101],
             "shuffled": torch.randperm(
                 n, generator=torch.Generator().manual_seed(4))[:257].tolist()
             }[order]
    args = (rt_cpu.grid_static, rt_cpu.tables(),
            rt_cpu.arrays.material_indices, *rays, active)
    targets = tuple(torch.full((n,), v) for v in SUN_P)
    want = tile_tracer.grid_hit_plain(*args, shadow_targets=targets,
                                      stats=True, max_steps=256)
    got = tile_tracer.grid_hit_tiles(*args, shadow_targets=targets,
                                     stats=True, max_steps=256,
                                     queue=_queue(lanes, n))
    assert set(got) == set(want)
    idx = torch.as_tensor(lanes, dtype=torch.long)
    outside = torch.ones(n, dtype=torch.bool)
    outside[idx] = False
    for k in want:
        assert torch.equal(got[k][idx], want[k][idx]), k
        assert not got[k][outside].any(), k
    if order == "full":
        assert int(want["found"].sum()) > 0


def test_table_lookup_over_a_queue():
    g = torch.Generator().manual_seed(5)
    tables = torch.rand(5, 256, generator=g)
    idx = torch.randint(-4, 260, (999,), generator=g, dtype=torch.int32)
    lanes = torch.randperm(999, generator=g)[:311].tolist()
    got = torch.stack(lookup.table_lookup(tables, idx,
                                          queue=_queue(lanes, 999)))
    want = torch.stack(lookup.table_lookup(tables, idx))
    assert torch.equal(got[:, lanes], want[:, lanes])
    rest = torch.ones(999, dtype=torch.bool)
    rest[lanes] = False
    assert not got[:, rest].any()


def test_plain_appends_are_the_live_lanes_in_lane_order(rt_cpu):
    """shade_plain appends each lane it leaves bouncing to the next queue
    and each lane of the shadow mask to the shadow queue, once, in lane
    order, after what the counts held."""
    rays = shade.camera_rays(trace.camera_vectors(rt_cpu.camera.d_camera,
                                                  "cpu"), W, H, 1)
    state = shade.new_state(rays, shade.SUN_DEFERRED)
    n = state["ox"].shape[0]
    h = tile_tracer.grid_hit_plain(rt_cpu.grid_static, rt_cpu.tables(),
                                   rt_cpu.arrays.material_indices,
                                   *(state[k] for k in shade.RAY_KEYS),
                                   state["bouncing"], max_steps=256)
    looked = lookup.table_lookup(rt_cpu.mats, h["index"])
    counts = shade.zeroed_counts(4, "cpu")
    counts[2] = 7  # a count that already holds 7 lanes
    nxt = trace.LaneQueue(torch.full((n,), -1, dtype=torch.int32),
                          counts[0:1])
    shq = trace.LaneQueue(torch.full((n,), -1, dtype=torch.int32),
                          counts[2:3])
    out = shade.shade(state, h, looked, shade.SUN_DEFERRED, SUN_P, SUN_C,
                      RADIUS, next_key=True, next_queue=nxt,
                      shadow_queue=shq)
    bouncing = torch.nonzero(state["bouncing"]).reshape(-1)
    active = torch.nonzero(out["active"]).reshape(-1)
    assert 0 < bouncing.numel() < active.numel() <= n
    assert int(counts[0]) == bouncing.numel()
    assert torch.equal(nxt.lanes[:bouncing.numel()].long(), bouncing)
    assert int(counts[2]) == 7 + active.numel()
    assert torch.equal(shq.lanes[7:7 + active.numel()].long(), active)
    assert int(counts[1]) == 0 and int(counts[3]) == 0


def _same(a, b):
    """Bit for bit: floats by their int32 views (NaN payloads included)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.equal(_bits(a), _bits(b))
    return a.dtype == b.dtype and torch.equal(a, b)


def _lanes_of(q):
    return torch.sort(q.lanes[:int(q.count[0])].long()).values


def _garbage(d, lanes, g):
    """Copies of the tensors of `d` (a dict or tuple) with every lane
    outside `lanes` overwritten: NaN floats, random bools and ints."""
    first = next(iter(d.values())) if isinstance(d, dict) else d[0]
    keep = torch.zeros(first.shape[0], dtype=torch.bool)
    keep[lanes.cpu()] = True

    def spoil(t):
        k = keep.to(t.device)
        if t.dtype == torch.float32:
            junk = torch.full_like(t, float("nan"))
        elif t.dtype == torch.bool:
            junk = (torch.rand(t.shape, generator=g) < 0.5).to(t.device)
        else:
            junk = torch.randint(-9, 99, t.shape, generator=g,
                                 dtype=t.dtype).to(t.device)
        return torch.where(k, t, junk)

    if isinstance(d, dict):
        return {k: spoil(v) for k, v in d.items()}
    return tuple(spoil(t) for t in d)


def _fresh_queues(n, dev, mode, last):
    counts = shade.zeroed_counts(2, dev)
    lanes = [torch.full((n,), -1, dtype=torch.int32, device=dev)
             for _ in range(2)]
    q = {}
    if not last:
        q["next_queue"] = trace.LaneQueue(lanes[0], counts[0:1])
    if mode == shade.SUN_DEFERRED:
        q["shadow_queue"] = trace.LaneQueue(lanes[1], counts[1:2])
    return q


_SUN_MODES = {"deferred": shade.SUN_DEFERRED, "probe": shade.SUN_PROBE,
              "off": shade.SUN_OFF}


def _shade_over_queues(rt, dev, mode, levels, fill, spp=1, width=W,
                       height=H, seed=0):
    """`levels` bounce levels of the scene's frame through kernels A and B
    over every lane; at each level after the first, kernel D over its
    queue (`fill`: "partial", the previous level's shadow queue with
    SUN_DEFERRED, else its scatter queue; "full", every lane, shuffled;
    "empty", no lane, after a level that left none bouncing and no
    pending term) against kernel D over every lane from the same state,
    the queued launch reading NaN and random values on the lanes outside
    its queue. Asserts the two states bit for bit, the outputs on the
    lanes the next launches read and the queues' lanes; on a card also the
    launch over every lane (the build that fills queues) against the
    plain twin. Returns (the queue's length at each level after the
    first, the lanes)."""
    g = torch.Generator().manual_seed(seed)
    probe = mode == shade.SUN_PROBE
    rays = shade.camera_rays(trace.camera_vectors(rt.camera.d_camera, dev),
                             width, height, spp, 2.0,
                             sun=(SUN_P, RADIUS) if probe else None)
    state = shade.new_state(rays, mode)
    n = state["ox"].shape[0]
    targets = tuple(rays[k] for k in shade.TARGET_KEYS) if probe else None
    key = occluded = taken = None
    sizes, stopped_lanes = [], []
    for level in range(levels):
        last = level == levels - 1
        h = tile_tracer.grid_hit_tiles(
            rt.grid_static, rt.tables(), rt.arrays.material_indices,
            *(state[k] for k in shade.RAY_KEYS), state["bouncing"],
            ray_key=key, max_steps=256, shadow_targets=targets)
        looked = lookup.table_lookup(rt.mats, h["index"])
        kw = dict(prev_occluded=occluded, next_key=not last,
                  next_targets=probe and not last)
        if level and fill == "empty":
            state["bouncing"].zero_()
            for k in (shade.PENDING_KEYS if mode == shade.SUN_DEFERRED
                      else ()):
                state[k].zero_()
            taken = _queue([], n)
        elif level and fill == "full":
            taken = _queue(torch.randperm(n, generator=g).tolist(), n)
        if taken is not None and dev != "cpu":
            taken = trace.LaneQueue(taken.lanes.to(dev),
                                    taken.count.to(dev))
        want_state = {k: v.clone() for k, v in state.items()}
        want_q = _fresh_queues(n, dev, mode, last)
        want = shade.shade(want_state, h, looked, mode, SUN_P, SUN_C, RADIUS,
                           **kw, **want_q)
        if level:
            lanes = taken.lanes[:int(taken.count[0])].long()
            sizes.append(lanes.numel())
            outside = torch.ones(n, dtype=torch.bool, device=lanes.device)
            outside[lanes] = False
            # the lanes skipped have nothing to shade
            assert not bool(want_state["bouncing"][outside].any())
            if mode == shade.SUN_DEFERRED and fill == "partial":
                # lanes of the shadow queue that stopped bouncing and still
                # add their pending term: the scatter queue would miss them
                stopped = ~state["bouncing"][lanes] & (
                    state["pr"][lanes] > 0)
                stopped_lanes.append(int(stopped.sum()))
            if "active" in want:
                assert not bool(want["active"][outside].any())
            got_state = {k: v.clone() for k, v in state.items()}
            got_q = _fresh_queues(n, dev, mode, last)
            got = shade.shade(
                got_state, _garbage(h, lanes, g), _garbage(looked, lanes, g),
                mode, SUN_P, SUN_C, RADIUS,
                **dict(kw, prev_occluded=None if occluded is None
                       else _garbage(dict(found=occluded), lanes,
                                     g)["found"]),
                **got_q, queue=taken)
            _assert_shaded_alike(got_state, got, got_q, want_state, want,
                                 want_q, lanes, level)
        if dev != "cpu":
            # the kernel that fills queues against its plain twin, on the
            # same inputs
            plain_state = {k: v.clone() for k, v in state.items()}
            plain_q = _fresh_queues(n, dev, mode, last)
            plain = shade.shade_plain(plain_state, h, looked, mode, SUN_P,
                                      SUN_C, RADIUS, **kw, **plain_q)
            _assert_shaded_alike(want_state, want, want_q, plain_state,
                                 plain, plain_q, None, level)
        state = want_state
        key = want.get("key")
        targets = (tuple(want[k] for k in shade.TARGET_KEYS)
                   if "tx" in want else None)
        if mode == shade.SUN_DEFERRED:
            occluded = tile_tracer.grid_hit_tiles(
                rt.grid_static, rt.tables(), rt.arrays.material_indices,
                h["px"], h["py"], h["pz"],
                *(want[k] for k in shade.SHADOW_KEYS), want["active"],
                max_steps=256)["found"]
            taken = want_q["shadow_queue"]
        else:
            taken = want_q.get("next_queue")
    if stopped_lanes:
        assert stopped_lanes[0] > 0
    return sizes, n


def _assert_shaded_alike(got_state, got, got_q, want_state, want, want_q,
                         lanes, level):
    """Two launches of kernel D from one state: the states bit for bit, the
    queues' lanes, and the outputs on the lanes the next launches read
    (the shadow mask on `lanes`, the shaded ones, or every lane)."""
    for k in want_state:
        assert _same(got_state[k], want_state[k]), (level, k)
    assert set(got) == set(want)
    every = slice(None)
    read = {"active": every if lanes is None else lanes}
    if "shadow_queue" in want_q:
        read.update(dict.fromkeys(shade.SHADOW_KEYS,
                                  _lanes_of(want_q["shadow_queue"])))
    if "next_queue" in want_q:
        read.update(dict.fromkeys(("key",) + shade.TARGET_KEYS,
                                  _lanes_of(want_q["next_queue"])))
    for k in want:
        assert _same(got[k][read[k]], want[k][read[k]]), (level, k)
    for name in want_q:
        assert torch.equal(_lanes_of(got_q[name]),
                           _lanes_of(want_q[name])), (level, name)


@pytest.mark.parametrize("levels", [2, 3, 4])
@pytest.mark.parametrize("fill", ["partial", "full", "empty"])
@pytest.mark.parametrize("mode", list(_SUN_MODES))
def test_shade_over_its_queue_equals_the_full_lane_shade(rt_cpu, mode, fill,
                                                         levels):
    sizes, n = _shade_over_queues(rt_cpu, "cpu", _SUN_MODES[mode], levels,
                                  fill)
    assert len(sizes) == levels - 1
    if fill == "partial":
        assert 0 < sizes[0] < n
    else:
        assert set(sizes) == {0 if fill == "empty" else n}


@pytest.mark.parametrize("levels", [2, 3, 4])
@pytest.mark.parametrize("mode", list(_SUN_MODES))
def test_kernel_d_reads_the_queue_the_previous_level_filled(
        rt_cpu, monkeypatch, mode, levels):
    """Each level's kernel D after the first takes the previous level's
    shadow queue (with a shadow launch) or scatter queue, which it reads
    while it appends to queues in other buffers: a launch on the card
    reads its queue while other blocks append."""
    calls = []
    real_shade = shade.shade

    def spy(*a, **kw):
        calls.append({k: kw.get(k) for k in ("queue", "next_queue",
                                             "shadow_queue")})
        return real_shade(*a, **kw)

    monkeypatch.setattr(shade, "shade", spy)
    _render(rt_cpu, "cpu", levels, mode != "off", mode == "probe", True,
            spp=1)
    assert len(calls) == levels and calls[0]["queue"] is None
    filled = "shadow_queue" if mode == "deferred" else "next_queue"
    for before, call in zip(calls, calls[1:]):
        assert call["queue"] is before[filled]
        ptr = call["queue"].lanes.data_ptr()
        for name in ("next_queue", "shadow_queue"):
            if call[name] is not None:
                assert call[name].lanes.data_ptr() != ptr
                assert (call[name].count.data_ptr()
                        != call["queue"].count.data_ptr())


@pytest.mark.parametrize("levels", [1, 2, 3, 4])
@pytest.mark.parametrize("mode", list(_SUN_MODES))
def test_shade_counters_read_l_minus_one_of_l(rt_cpu, mode, levels):
    """Every level's kernel D launch but the first takes a queue."""
    report = {}
    sun_on, probe = mode != "off", mode == "probe"
    _render(rt_cpu, "cpu", levels, sun_on, probe, True, report, spp=1)
    assert report["shade_launches"] == levels
    assert report["shade_queued"] == levels - 1


def test_shade_plain_over_a_queue_leaves_the_other_lanes(rt_cpu):
    """The plain twin of kernel D over a shuffled queue of a random state:
    the queued lanes as the full-lane twin shades them, the others' state
    untouched and their outputs 0."""
    rays = _primary(rt_cpu, "cpu")
    n = rays[0].shape[0]
    g = torch.Generator().manual_seed(8)
    state = shade.new_state(dict(zip(shade.RAY_KEYS, rays)),
                            shade.SUN_DEFERRED)
    state["bouncing"].copy_(torch.rand(n, generator=g) < 0.6)
    for k in shade.PENDING_KEYS:
        state[k].copy_(torch.rand(n, generator=g))
    h = tile_tracer.grid_hit_plain(rt_cpu.grid_static, rt_cpu.tables(),
                                   rt_cpu.arrays.material_indices, *rays,
                                   state["bouncing"], max_steps=256)
    looked = lookup.table_lookup(rt_cpu.mats, h["index"])
    prev = torch.rand(n, generator=g) < 0.5
    lanes = torch.randperm(n, generator=g)[:301]
    kw = dict(prev_occluded=prev, next_key=True)
    want_state = {k: v.clone() for k, v in state.items()}
    want = shade.shade(want_state, h, looked, shade.SUN_DEFERRED, SUN_P,
                       SUN_C, RADIUS, **kw)
    got_state = {k: v.clone() for k, v in state.items()}
    got = shade.shade(got_state, h, looked, shade.SUN_DEFERRED, SUN_P, SUN_C,
                      RADIUS, **kw, queue=_queue(lanes.tolist(), n))
    rest = torch.ones(n, dtype=torch.bool)
    rest[lanes] = False
    for k in state:
        assert _same(got_state[k][lanes], want_state[k][lanes]), k
        assert _same(got_state[k][rest], state[k][rest]), k
    assert set(got) == set(want)
    for k in want:
        assert _same(got[k][lanes], want[k][lanes]), k
        assert not got[k][rest].any(), k
    # the random state's skipped lanes did have work: the queue decides
    assert not all(_same(want_state[k], got_state[k]) for k in state)


def test_a_shadow_queue_needs_a_shadow_launch(rt_cpu):
    n = 4
    state = shade.new_state({k: torch.zeros(n) for k in shade.RAY_KEYS},
                            shade.SUN_OFF)
    with pytest.raises(ValueError, match="shadow queue"):
        shade.shade(state, {}, (), shade.SUN_OFF,
                    shadow_queue=_queue([], n))


def test_engine_counts_kernel_a_launches_a_frame():
    """Each frame adds the launches and the queued launches its body
    reported: 3 levels with a shadow launch each, 5 of 6 queued."""
    rt = _engine(16, 12, "cpu")
    profiling.enable(True)
    try:
        rt.draw()
        rt.draw()
    finally:
        profiling.enable(False)
    counters = profiling.snapshot()["counters"]
    levels = rt.camera.d_camera.max_bounce
    assert rt.sun.device_data.enabled and not rt.trace_config.sun_in_kernel
    assert counters["trace_launches"] == 2 * 2 * levels
    assert counters["trace_queued"] == 2 * (2 * levels - 1)


def test_engine_counts_kernel_d_launches_a_frame():
    """Each frame adds kernel D's launches and the queued ones: 3 levels,
    2 of 3 queued."""
    rt = _engine(16, 12, "cpu")
    profiling.enable(True)
    try:
        rt.draw()
        rt.draw()
    finally:
        profiling.enable(False)
    counters = profiling.snapshot()["counters"]
    levels = rt.camera.d_camera.max_bounce
    assert counters["shade_launches"] == 2 * levels
    assert counters["shade_queued"] == 2 * (levels - 1)


def _reader(name="traverse.queued_share"):
    path = ROOT / "rtbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("counters,want", [
    ({"trace_launches": 60, "trace_queued": 50}, 100.0 * 5 / 6),
    ({"trace_launches": 40, "trace_queued": 30}, 75.0),
    ({"trace_launches": 80, "trace_queued": 70}, 87.5),
    ({"trace_launches": 10}, None),
    ({"trace_launches": 0, "trace_queued": 0}, None),
    ({}, None),
])
def test_queued_share_reader_on_a_stub_store(monkeypatch, counters, want):
    from rtbench import program_store

    reader = _reader()
    snap = {"zones": {"draw": {"count": 10, "total_ms": 1.0,
                               "self_ms": 1.0}},
            "counters": counters, "device": {}}
    monkeypatch.setattr(program_store, "store",
                        lambda: program_store.Store(snap))
    got = reader.read(None)
    assert got == pytest.approx(want) if want is not None else got is None
    monkeypatch.setattr(program_store, "store", lambda: None)
    assert reader.read(None) is None


def test_queued_share_entry_in_the_benchmark():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(m for m in bench["per_layer"]
                 if m["name"] == "traverse.queued_share")
    reader = _reader()
    assert entry == dict(
        name=reader.NAME, unit=reader.UNIT, better="higher",
        source=reader.SOURCE, layer=reader.LAYER, moves=reader.MOVES,
        workloads=reader.WORKLOADS)
    # every cell but `stream_4k`, `pathtraced_4k_4cards` and
    # `default_settings`, which came after the entry and which the entry
    # does not list yet
    cells = {w["name"] for w in bench["workloads"]}
    assert set(reader.WORKLOADS) == cells - {
        "stream_4k", "pathtraced_4k_4cards", "default_settings"}
    layers = {m["layer"] for m in bench["per_layer"]
              if m["name"] == "traverse.ms"}
    assert layers == {reader.LAYER}


@pytest.mark.parametrize("counters,want", [
    ({"shade_launches": 30, "shade_queued": 20}, 100.0 * 2 / 3),
    ({"shade_launches": 20, "shade_queued": 10}, 50.0),
    ({"shade_launches": 40, "shade_queued": 30}, 75.0),
    ({"shade_launches": 10, "shade_queued": 0}, 0.0),
    ({"shade_launches": 10}, None),
    ({"shade_launches": 0, "shade_queued": 0}, None),
    ({"trace_launches": 60, "trace_queued": 50}, None),
])
def test_shade_queued_share_reader_on_a_stub_store(monkeypatch, counters,
                                                   want):
    from rtbench import program_store

    reader = _reader("shade.queued_share")
    snap = {"zones": {"draw": {"count": 10, "total_ms": 1.0,
                               "self_ms": 1.0}},
            "counters": counters, "device": {}}
    monkeypatch.setattr(program_store, "store",
                        lambda: program_store.Store(snap))
    got = reader.read(None)
    assert got == pytest.approx(want) if want is not None else got is None
    monkeypatch.setattr(program_store, "store", lambda: None)
    assert reader.read(None) is None


def test_shade_queued_share_entry_in_the_benchmark():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(m for m in bench["per_layer"]
                 if m["name"] == "shade.queued_share")
    reader = _reader("shade.queued_share")
    assert entry == dict(
        name=reader.NAME, unit=reader.UNIT, better="higher",
        source=reader.SOURCE, layer=reader.LAYER, moves=reader.MOVES,
        workloads=reader.WORKLOADS)
    # the cells with more than one level: `stream_4k` has one, no queue;
    # `pathtraced_4k_4cards` and `default_settings` came after the entry,
    # which does not list them yet
    cells = {w["name"] for w in bench["workloads"]}
    assert set(reader.WORKLOADS) == cells - {
        "stream_4k", "pathtraced_4k_4cards", "default_settings"}
    layers = {m["layer"] for m in bench["per_layer"]
              if m["name"] == "shade.ms"}
    assert layers == {reader.LAYER}


# -- on the card ------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def rt_card(card):
    return _engine(96, 64, card)


def _card_queue(lanes, n, dev):
    q = _queue(lanes, n)
    return trace.LaneQueue(q.lanes.to(dev), q.count.to(dev))


_BUILDS = ["default", "shadow", "stats", "shadow+stats", "exact",
           "exact+shadow", "exact+stats", "exact+shadow+stats"]


@pytest.mark.cuda
@pytest.mark.parametrize("build", _BUILDS)
@pytest.mark.parametrize("order", ["empty", "full", "ragged", "shuffled"])
@pytest.mark.parametrize("scale", [0.5, 0.3], ids=["pow2", "dividing"])
def test_kernel_a_over_a_queue_writes_the_full_launch_bits(rt_card, card,
                                                           build, order,
                                                           scale):
    import dataclasses

    rt = rt_card
    cam = trace.camera_vectors(rt.camera.d_camera, card)
    rays = shade.camera_rays(cam, 96, 64, 2)
    rays = tuple(rays[k] for k in shade.RAY_KEYS)
    n = rays[0].shape[0]
    g = torch.Generator().manual_seed(11)
    active = (torch.rand(n, generator=g) < 0.8).to(card)
    lanes = {"empty": [], "full": list(range(n)),
             "ragged": list(range(5, n, 7))[:1001],
             "shuffled": torch.randperm(n, generator=g)[:4099].tolist()
             }[order]
    kw = dict(max_steps=256)
    if "shadow" in build:
        kw["shadow_targets"] = tuple(torch.full((n,), v, device=card)
                                     for v in SUN_P)
    if "stats" in build:
        kw["stats"] = True
    if "exact" in build:
        kw["use_skip"] = False
    static = dataclasses.replace(rt.grid_static, scale=scale)
    args = (static, rt.tables(), rt.arrays.material_indices, *rays, active)
    full = tile_tracer.grid_hit_tiles(*args, **kw)
    before = dict(tile_tracer.grid_hit_tiles.build_launches)
    got = tile_tracer.grid_hit_tiles(*args, **kw,
                                     queue=_card_queue(lanes, n, card))
    torch.cuda.synchronize()
    assert (tile_tracer.grid_hit_tiles.build_launches[build]
            == before[build] + 1)
    idx = torch.as_tensor(lanes, dtype=torch.long, device=card)
    assert set(got) == set(full)
    for k in full:
        a, b = got[k][idx], full[k][idx]
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), k


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["empty", "ragged", "shuffled", "full"])
def test_kernel_b_over_a_queue_is_index_select(card, order):
    g = torch.Generator().manual_seed(12)
    n = (1 << 18) + 3
    tables = torch.rand(5, 256, generator=g).to(card)
    idx = torch.randint(0, 256, (n,), generator=g,
                        dtype=torch.int32).to(card)
    lanes = {"empty": [], "full": list(range(n)),
             "ragged": list(range(1, n, 5)),
             "shuffled": torch.randperm(n, generator=g)[:70001].tolist()
             }[order]
    got = torch.stack(lookup.table_lookup(tables, idx,
                                          queue=_card_queue(lanes, n, card)))
    torch.cuda.synchronize()
    at = torch.as_tensor(lanes, dtype=torch.long, device=card)
    assert torch.equal(got[:, at], torch.index_select(tables, 1, idx[at]))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [shade.SUN_DEFERRED, shade.SUN_PROBE,
                                  shade.SUN_OFF])
def test_kernel_d_appends_each_live_lane_once(rt_card, card, mode):
    rt = rt_card
    rays = shade.camera_rays(trace.camera_vectors(rt.camera.d_camera, card),
                             96, 64, 2)
    state = shade.new_state(rays, mode)
    n = state["ox"].shape[0]
    targets = (tuple(torch.full((n,), v, device=card) for v in SUN_P)
               if mode == shade.SUN_PROBE else None)
    h = tile_tracer.grid_hit_tiles(rt.grid_static, rt.tables(),
                                   rt.arrays.material_indices,
                                   *(state[k] for k in shade.RAY_KEYS),
                                   state["bouncing"], max_steps=256,
                                   shadow_targets=targets)
    looked = lookup.table_lookup(rt.mats, h["index"])
    live = torch.nonzero(state["bouncing"] & h["found"]).reshape(-1)
    counts = shade.zeroed_counts(2, card)
    nxt = trace.LaneQueue(torch.full((n,), -1, dtype=torch.int32,
                                     device=card), counts[0:1])
    shq = (trace.LaneQueue(torch.full((n,), -1, dtype=torch.int32,
                                      device=card), counts[1:2])
           if mode == shade.SUN_DEFERRED else None)
    out = shade.shade(state, h, looked, mode, SUN_P, SUN_C, RADIUS,
                      next_key=True, next_targets=mode == shade.SUN_PROBE,
                      next_queue=nxt, shadow_queue=shq)
    torch.cuda.synchronize()
    want = torch.nonzero(state["bouncing"]).reshape(-1)
    k = int(counts[0])
    assert k == want.numel() > 0
    got = nxt.lanes[:k].long()
    assert torch.equal(torch.sort(got).values, want)
    # lane order within each block of 256 lanes
    block = got // 256
    same_block = block[1:] == block[:-1]
    assert bool((got[1:][same_block] > got[:-1][same_block]).all())
    if shq is not None:
        assert torch.equal(torch.nonzero(out["active"]).reshape(-1), live)
        assert int(counts[1]) == live.numel() >= want.numel()
        got = torch.sort(shq.lanes[:live.numel()].long()).values
        assert torch.equal(got, live)


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [2, 3, 4])
@pytest.mark.parametrize("fill", ["partial", "full", "empty"])
@pytest.mark.parametrize("mode", list(_SUN_MODES))
def test_kernel_d_over_its_queue_writes_the_full_launch_bits(rt_card, card,
                                                             mode, fill,
                                                             levels):
    sizes, n = _shade_over_queues(rt_card, card, _SUN_MODES[mode], levels,
                                  fill, spp=2, width=96, height=64)
    torch.cuda.synchronize()
    if fill == "partial":
        assert 0 < sizes[0] < n
    else:
        assert set(sizes) == {0 if fill == "empty" else n}


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [1, 2, 4])
@pytest.mark.parametrize("sun_in_kernel", [False, True])
def test_replayed_frame_with_queued_shading_equals_op_by_op(card, levels,
                                                            sun_in_kernel):
    """The engine's frame graph, its kernel D launches after the first
    level over their queues: each replay equals the body op by op bit for
    bit, and the frames count L - 1 of L kernel D launches queued."""
    from zig_vulkan_tpu_torch.config import TraceConfig
    from zig_vulkan_tpu_torch.engine.engine import both_routes

    rt = _engine(96, 64, card)
    rt.trace_config = TraceConfig(sun_in_kernel=sun_in_kernel)
    rt.camera.d_camera.max_bounce = levels
    rt.render()
    profiling.enable(True)
    try:
        for _ in range(3):
            rt.camera.turn_yaw(0.05)
            got, want = both_routes(rt)
            assert torch.equal(_bits(got), _bits(want))
    finally:
        profiling.enable(False)
    counters = profiling.snapshot()["counters"]
    # three replays and three frames op by op
    assert counters["shade_launches"] == 6 * levels
    assert counters["shade_queued"] == 6 * (levels - 1)


def _config(name):
    return json.loads((ROOT / "rtbench" / "configs" / f"{name}.json")
                      .read_text())["engine"]


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["default_workload", "edit_1080p",
                                    "emissive_temporal_1080p"])
@pytest.mark.parametrize("sun", ["deferred", "probe", "off"])
def test_queued_frame_equals_the_plain_twins_on_the_card(rt_card, card,
                                                         config, sun):
    """Each cell's trace settings at 96x64: the queued levels of the
    kernels give the image of the port's plain twins run op by op on the
    card (`rtbench/ref/`, the benchmark's reference), bit for bit."""
    from rtbench.ref.ops import trace as ref_trace

    e = _config(config)
    levels = int(e["camera"]["max_bounce"]) + 1
    spp = int(e["camera"]["samples_per_pixel"])
    sun_on, probe = sun != "off", sun == "probe"
    report = {}
    got = _render(rt_card, card, levels, sun_on, probe,
                  e["trace"]["empty_skip"], report, spp, 96, 64)
    want = _render(rt_card, card, levels, sun_on, probe,
                   e["trace"]["empty_skip"], None, spp, 96, 64,
                   ref=ref_trace)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))
    assert report["trace_queued"] == report["trace_launches"] - 1
