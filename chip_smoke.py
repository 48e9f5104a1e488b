#!/usr/bin/env python3
"""Drive zig_vulkan_tpu_torch's main path once on an NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA GPU
    python3 chip_smoke.py --default-frame-trace   # phase 20's trace alone

The quickest proof that the port builds and runs on the card. Every phase
prints one line of numbers and raises on failure, so the script exits
non-zero if any phase fails. Every engine frame of every phase
(`VoxelRT.render()`, `draw()`) runs through the compiled step: captured
once a step key as a CUDA graph and replayed. Checks that hook the kernel
wrappers run the same step's body op by op (`VoxelRT.render_op_by_op()`):
a replay calls no wrapper. So the wrappers' launch counters move only on a
capture frame (its run and its capture) and op by op, and the launches of
a replayed frame are counted in a `torch.profiler` trace of the card
(`card_launches`).

1. device: the card's name and power limit (nvidia-smi);
2. build: compile csrc/*.cu (kernels A and B) with nvcc;
3. kernel A (traversal) against its plain torch version on the card, on
   the default 512x256x512 scene: the frame's primary wavefront,
   bounce-like rays from its hit points, and the same rays with a
   dielectric key; the builds that divide (a cell size that is no power
   of two) on the primary and keyed rays, bit for bit;
4. kernel B (material lookup) against its plain torch version;
5. golden parity: the 48x48 flat-scene renders of
   tests/golden/flat_scene_renders.npz rendered on the card;
6. the main path: `VoxelRT(...).draw()` at the default EngineConfig
   (1024x576, 2 spp, max_bounce 2, sun, denoiser) on the default scene,
   with the kernels' launch counts through the wrappers and a replayed
   frame's on the card;
6b. the frame's 6 kernel A and 3 kernel B launches, captured from one
   frame of the step's body run op by op and replayed one by one
   (`frame_kernels`): each bit for bit
   against its plain version, its device time warm and after an L2
   flush, its bound, kernel A's steps, warp-use shares and its time with
   no lane live, with only its slowest 1% of rays live and through the
   builds that divide (at a 0.3 cell, also bit for bit), kernel B's
   `torch.index_select` time;
7. headline analogue: 1920x1080 primary rays through kernel A over the
   fly-through path's points (three passes), in Mray/s;
8. the edit fly-through (BASELINE config 3, benchmarks/configs.py:117-148,
   built by `zig_vulkan_tpu_torch.benchmarks.configs`, as phases 16 and 17
   are): 1920x1080, 1 spp, max_bounce 1, animated sun, no denoiser, max_steps
   160, 512 random voxels inserted (even frames) or removed (odd frames)
   on the device every frame, on a fresh copy of the default scene; frame,
   insert and remove times, the degraded fraction, peak memory and kernel
   A's steps per primary ray (stats build) before and after the edits;
   holds the decoded scene against a host replay of the edits, the
   refreshed records against a full rebuild, and kernel A against its
   plain version on the sprayed scene;
9. the sun-shadow probe: kernel A's shadow build against its plain
   version, and default frames with `sun_in_kernel` on and off;
10. temporal accumulation: five frames of a static pose, then
    `set_resolutions`;
11. the whole fly-through: `benchmarks.flythrough.fly` flies all 120
    frames of the 60 s path at the default workload and prints the
    reference's report; its min, max and average frame time and frame
    count, 6 A and 3 B launches a frame;
12. oracle parity on the card: 24x24 subsampled 1080p rays from three
    fly-through poses of the default scene through kernel A's NO_SKIP build
    (the exact DDA, `TraceConfig(empty_skip=False)`) against the port's
    numpy oracle (identical hits and indices) and its twin (bit for bit),
    the default build's flip rate against the oracle (< 0.5%) and against
    its twin; full-RGB frames of the exact path through the engine against
    `oracle.render` on two poses; NO_SKIP against the default build on the
    1080p primary rays;
13. the app: `python -m zig_vulkan_tpu_torch.app.run`'s `main` at its
    defaults with `--frames 8 --out`, `--script demo`, `--benchmark`,
    `--profile` (the zones in the trace) and `--live` (output captured);
14. host I/O: save_scene / load_scene / flush_grid of phase 8's edited
    scene (same arrays, same frame), the file read by plain numpy against
    the JAX package's format, `cached_default_scene` cold and warm,
    `stream_into_engine(terrain_regions(...))` into an empty engine against
    the host terrain build, and the native C++ builder where g++ exists.
15. the mesh (parallel/mesh.py): (a) the denoiser on 1, 2, 4 and 8 bands
    with their halos against the whole image, a seeded random 1024x576
    image to 1280x720 and at equal size, bit for bit; (b) the default
    frame's configuration through `build_sharded_step` over 1, 2 and 4
    shards of the card, each first call (each shard's graphs' capture)
    equal bit for bit to `render_image` + `postprocess`, its captures and
    launches, the 4-shard step's kernel launches op by op (a band's lanes
    each) bit for bit against their plain versions (phase 21 times the
    steps); (c) `dryrun_multichip(4)`; (d) where there
    is more than one card, (b) over the distinct cards;
16. BASELINE config 5 (benchmarks/configs.py:179-252): a 1024x256x1024-voxel
    terrain streamed into an empty engine, the exact distance field and the
    records built once, then 3840x2160 frames (1 spp, one level, no sun, no
    denoiser) through the sharded step's graphs over every card and over 4
    shards of the first card; each equal to the unsharded `render_image`
    bit for bit, with its device ms between events, wall ms and
    device-busy ms (a `torch.profiler` trace) and the idle share they give,
    its captures and a replayed step's launches on the card; the kernel A
    and kernel B launches of the unsharded frame (8,294,400 lanes) and of
    the 4-shard step op by op (2,073,600 lanes a shard), captured and held
    bit for bit against their plain versions; kernel A and kernel B on the
    whole frame with their times, plain times and bounds; the terrain's
    stream through the engine's edit graphs (voxels/s, captures);
17. BASELINE configs 1, 2 and 4 (benchmarks/configs.py:81-114, :151-176) at
    full width: ms a frame and Mray/s over the source's 8 / 6 / 6 frames
    (`benchmarks.configs._timed_frames`), launches per frame,
    each frame's shape, range and finiteness, and every kernel launch of
    one more frame of each (config 1's 1.0 cells, config 2's shadow
    launch, config 4's keyed bounces) captured and held bit for bit
    against its plain version; for config 4 the accumulated frame moves,
    and from a pose that looks at the emissive block its lanes hit it
    (those launches held against their plain versions too);
18. the headline bench: `benchmarks.bench.main` in this process prints its
    JSON line (primary Mray/s over 10 poses at 1920x1080, rays made and
    traced, one kernel A launch a pose; parity with the numpy oracle on
    48x48 subsampled rays, at least 0.995; the default frame's ms over 12
    chained frames);
19. the entry module: `entry.entry()`'s render step (64x48, two levels, the
    denoiser) on the card against the same step on the CPU, where the
    kernels' plain versions run (no pixel differs by 1e-5); its 4 A and 2 B
    launches, each against its plain version bit for bit;
20. the compiled step (`engine.step`): the default frame, config 4's
    temporal frames, config 5's 4K frame, the default frame after a change
    of the denoiser's `samples`, and the bench's pose frame (config 3's
    edit frames are phase 21's), each run as a replay and op by op (the
    body called directly): the replay's image equal to the op-by-op one
    bit for bit, the captures (one a key), kernel A and B launches a
    frame on each route, median ms of each route in turns by CUDA events
    and by the host clock, device-busy ms and idle share and host-to-device
    copies a frame from a `torch.profiler` trace of each route, and peak
    allocated and reserved bytes of each;
21. the compiled edit path and shards: (a) config 3's 16 edit frames on
    two engines built from one scene, one through the edit and frame
    graphs, one through the same bodies op by op (`insert_voxels_op_by_op`,
    `render_op_by_op`), in turns (op, replay, replay, op; twice): the nine
    arrays, the records and each frame's image bit for bit, one capture an
    edit kind (and the frame's), every edit after the captures under
    `torch.cuda.set_sync_debug_mode("error")`, insert + refresh, remove +
    refresh and edit-frame ms by CUDA events and the host clock, an edit's
    host-to-device copies from a trace (one pinned), the graphs' pool
    bytes and peak bytes; (b) a 1,500-voxel batch (2,048 lanes) on both
    routes, and a batch the capacity guard refuses before the scene is
    touched; (c) half of config 5's first terrain slab streamed into empty engines
    on both routes in turns: voxels/s, captures, the scenes bit for bit;
    (d) the default frame and config 5's frame (`Config5.sharded_step`)
    over 1, 2 and 4 shards of the card: the capture call, then frames with
    the camera and the sun moved between calls, each as a replay, op by op
    and the unsharded replayed frame, bit for bit; ms of the three in
    turns, busy ms (and the idle share, on one shard) and kernel A and B
    launches a step of the replays from a trace, equal to the op-by-op
    step's launches through the wrappers.

`--default-frame-trace` runs phases 1-2 and the trace of phase 20's default
frame through `VoxelRT.render()` alone: the same lines from an older tree
(copy this script over its checkout) give the numbers before the step.

The line before the last is a JSON object with one entry per kernel build
(its launches through the wrapper in this run, launches a replayed frame
on the card, time, plain time, bound, share of the bound and, for kernel
B, `index_select`'s time); the last line is
{"ok": true, "device": {...}}. Imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

FRAMES = 10
HEADLINE_POSES = 10
HEADLINE_PASSES = 3  # passes over the poses: one pass is too short to time
EDIT_FRAMES = 8      # timed frames of phase 8: 4 insert and 4 remove batches
PROBE_FRAMES = 3     # timed default frames per group in phase 9 (2 groups
                     # per variant)
TEMPORAL_FRAMES = 5
FLY_DT = 0.5         # phase 11: virtual seconds a frame, 120 frames of 60 s
BENCH_POSES = 10     # phase 18: the bench's timed poses (its default)
ORACLE_POSES = (0, 3, 7)   # PATH_POINTS indices (tests/test_parity_at_scale.py)
ORACLE_SIDE = 24           # rays per pose: a 24x24 subgrid of 1080p
RGB_POSES = (0, 3)
RGB_RES = (64, 36)         # the full-RGB oracle frames
# Path-traced frames of the default scene against the oracle: the sin hash
# turns last-bit differences of a scatter direction into other random
# numbers, and the terrain's voxel staircase turns those into other hits,
# so no implementation matches the oracle pixel for pixel there. The bound
# is the JAX package's own distance from its oracle on the same frames
# (render_image with empty_skip=False on XLA:CPU, 64x36, 2 spp, 3 levels,
# sun): (share of pixels with |d| > 1e-3, mean |d|) per RGB_POSES entry.
# The port must come no further; the parity scene keeps the 1% bound of
# tests/test_trace_parity.py:75-77.
RGB_REFERENCE = {0: (0.1094, 0.01528), 3: (0.1536, 0.01935)}
STREAM_BATCH = 262144      # io.streaming.stream_into_engine's max_batch
SLEEP_CYCLES = 20_000_000  # about 10 ms of the card's clock: the host
                           # enqueues the timed calls meanwhile
FLUSH_BYTES = 128 << 20    # written between timed calls: evicts the 50 MB L2
FRAME_REPS = 10            # timed replays of each captured frame launch
HALO_BANDS = (1, 2, 4, 8)  # phase 15a
MESH_SIZES = (1, 2, 4)     # shards of one card, phase 15b
EMISSIVE = 40              # config 4's emissive material index
STEP_EQUAL = 3             # phase 20: frames held bit for bit a case
STEP_FRAMES = 3            # phase 20: timed frames a route and turn (4 turns)
TRACE_FRAMES = 3           # phase 20: traced frames a route
EDIT_TURN_FRAMES = 4       # phase 21: config 3's edit frames a route and
                           # turn (4 turns a route: 16 frames)
ROUTE_TURNS = ("op_by_op", "replay", "replay", "op_by_op")
SHARD_FRAMES = 2           # phase 21: timed steps a route and turn
SHARD_TRACE = 2            # phase 21: traced steps a route
# the JAX package's scene file: key -> dtype (zig_vulkan_tpu/io/scene_io.py:
# 24-46, core/materials.py:MaterialTable)
SCENE_FILE_DTYPES = {
    "dim_x": np.int64, "dim_y": np.int64, "dim_z": np.int64,
    "brick_alloc": np.int64, "min_point": np.float64, "scale": np.float64,
    "base_t": np.float64, "statuses": np.uint32, "indices": np.uint32,
    "occupancy": np.uint32, "start_indices": np.uint32,
    "material_indices": np.uint8, "active_bricks": np.uint32,
    "material_cursor": np.uint32, "diel_mask": np.uint32,
    "brick_ir": np.float32, "mat_type": np.int32, "mat_albedo": np.float32,
    "mat_type_data": np.float32}
# the first points of the fly-through path (zig_vulkan_tpu/engine/
# benchmark.py:29, Benchmark.zig:146-158)
PATH_POINTS = ((0, 0, 0), (2, 5, 0), (3, 5, 5), (5, 2, 1), (10, 0, 10),
               (20, -20, 20), (10, -25, 15), (10, -22, 20), (10, -30, 25),
               (5, -10, 10))


def log(phase: str, **fields) -> None:
    parts = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{phase}] {parts}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` back-to-back calls, by CUDA
    events. A sleep kernel holds the card while the host enqueues the
    calls, so a kernel shorter than its host-side launch is timed by the
    card, not by the host."""
    import torch

    fn()  # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, flush=None) -> float:
    """Median device time of one call of `fn`, each of `reps` calls between
    its own CUDA events, with the host kept ahead of the card as in
    `cuda_ms`. With `flush` (a buffer larger than the L2), the buffer is
    written before each call, as the frame's glue evicts the L2 between
    kernel launches."""
    import torch

    fn()  # warm
    torch.cuda.synchronize()
    pairs = [frame_events()[:2] for _ in range(reps)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in pairs:
        if flush is not None:
            flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def compare_hits(name, got, want, mask):
    """Kernel A against the plain version on the lanes of `mask`."""
    g_found, w_found = got["found"][mask], want["found"][mask]
    agree = (g_found == w_found).float().mean().item()
    both = g_found & w_found
    dt = (got["t"][mask][both] - want["t"][mask][both]).abs()
    max_dt = dt.max().item() if dt.numel() else 0.0
    idx_bad = int((got["index"][mask][both] != want["index"][mask][both]).sum())
    mismatch = {k: int((got[k][mask] != want[k][mask]).sum())
                for k in ("found", "t", "px", "py", "pz", "nx", "ny", "nz",
                          "index")}
    log("kernel A", batch=name, lanes=int(mask.sum()),
        hits=int(w_found.sum()), found_agree=f"{agree:.6f}",
        max_dt=max_dt, index_mismatch=idx_bad,
        field_mismatches=json.dumps(mismatch, separators=(",", ":")))
    if agree < 0.999 or max_dt > 1e-4 or idx_bad:
        raise AssertionError(f"kernel A disagrees with its plain version "
                             f"on {name}")
    return max_dt


def frame_events():
    import torch

    return [torch.cuda.Event(enable_timing=True) for _ in range(3)]


def read_lanes(tables):
    """The records with the lanes kernel A never reads zeroed: an empty
    cell's occupancy, dielectric and ir lanes (they hold brick 0's words,
    which the incremental refresh leaves as they were, as the JAX
    package's does) and lane 7."""
    t = tables.clone()
    empty = t[:, 0] == -1
    t[empty, 1:3] = 0
    t[empty, 4:7] = 0
    t[:, 7] = 0
    return t


def host_remove(grid, xyz):
    """Clear voxels in a host BrickGrid's arrays: the numpy replay of
    core.grid.remove_edits."""
    from zig_vulkan_tpu_torch.core.grid import grid_at, voxel_at

    st, a = grid.static, grid.arrays
    x, y, z = (xyz[:, i].astype(np.int64) for i in range(3))
    fy = (st.voxel_dims[1] - 1) - y
    cell = grid_at(st, x, fy, z)
    nth = voxel_at(x, fy, z)
    loaded = ((a.statuses[cell // 32] >> (cell % 32).astype(np.uint32))
              & 1) == 1
    word = a.indices[cell[loaded]].astype(np.int64) * 2 + nth[loaded] // 32
    keep = ~(np.uint32(1) << (nth[loaded] % 32).astype(np.uint32))
    np.bitwise_and.at(a.occupancy, word, keep)
    np.bitwise_and.at(a.diel_mask, word, keep)


def warp_share(out):
    from zig_vulkan_tpu_torch.utils import roofline

    return roofline.warp_use_share(out["n_step"].cpu().numpy())


def step_stats(n_step):
    """Mean and p99 of per-ray loop iterations."""
    import torch

    s = n_step.float()
    return s.mean().item(), torch.quantile(s, 0.99).item()


def a_bound(n, out, n_step, **flags):
    """bound_ms and bound_by of a kernel A launch over `n` lanes with
    results `out` and the stats build's `n_step` on the same inputs."""
    from zig_vulkan_tpu_torch.utils import roofline

    ms, by = roofline.traverse_bound_ms(n, int(out["found"].sum()),
                                        int(n_step.sum()), **flags)
    return dict(bound_ms=ms, bound_by=by)


def mismatches(got, want, keys):
    """({field: lanes that differ}, the largest difference in a float
    field, whether every field is equal bit for bit) of two results."""
    import torch

    bad, err = {}, 0.0
    for k in keys:
        differs = got[k] != want[k]
        bad[k] = int(differs.sum())
        if bad[k] and got[k].is_floating_point():
            err = max(err, (got[k][differs] - want[k][differs])
                      .abs().max().item())
    same = not any(bad.values()) and all(torch.equal(got[k], want[k])
                                         for k in keys)
    return bad, err, same


def compare_exact(name, got, want, keys):
    """A kernel build against its plain version, bit for bit. Returns the
    largest difference found in a float field (0.0 when it passes)."""
    bad, err, same = mismatches(got, want, keys)
    log(name, lanes=int(want["found"].numel()),
        hits=int(want["found"].sum()), max_abs_err=err,
        mismatches=json.dumps(bad, separators=(",", ":")))
    if not same:
        raise AssertionError(f"{name}: the kernel disagrees with its plain "
                             f"version")
    return err


def edit_flythrough(dev, scene, scale, frames):
    """Phase 8: BASELINE config 3 (`benchmarks.configs.build_config3` and
    its `EditStream`) on a fresh device copy of `scene`."""
    import copy

    import torch

    from zig_vulkan_tpu_torch.benchmarks import configs
    from zig_vulkan_tpu_torch.core.grid import dense_materials
    from zig_vulkan_tpu_torch.ops import lookup, tile_tracer, trace

    host = copy.deepcopy(scene.grid)  # the host replay of every edit
    rt = configs.build_config3(scale, dev, scene=scene)
    w, h = rt.internal_resolution
    max_steps = rt.trace_config.max_steps
    st = rt.grid_static
    rt.tables()
    edits = configs.EditStream(rt)
    replay = []

    def move(insert):
        # the pose and the batch of an even (insert) or odd (remove) frame
        xyz, mats = edits.draw(0 if insert else 1)
        replay.append((xyz, mats))
        return lambda: edits.apply(xyz, mats)

    fractions = [rt.nonempty_region_fraction()]

    # the first pose's primary rays, traced before the edits and after
    cam = trace.camera_vectors(rt.camera.d_camera, dev)
    r = trace._camera_rays_soa(cam, w, h, 0)
    prim = tuple(a.contiguous() for a in (*r[:3], *trace._norm3(*r[3:])))
    on = torch.ones(w * h, dtype=torch.bool, device=dev)

    def hit(rays, active, plain=False, tables=None, **kw):
        fn = tile_tracer.grid_hit_plain if plain else tile_tracer.grid_hit_tiles
        return fn(st, rt.tables() if tables is None else tables,
                  rt.arrays.material_indices, *rays, active,
                  max_steps=max_steps, **kw)

    stats_launches = 0

    def stats_run(tables=None):
        nonlocal stats_launches
        tile_tracer.reset_launch_counts()
        out = hit(prim, on, tables=tables, stats=True)
        torch.cuda.synchronize()
        stats_launches += tile_tracer.grid_hit_tiles.build_launches["stats"]
        return out

    before = stats_run()
    steps_before = step_stats(before["n_step"])
    # the clean scene with the conservative field every edit switches to
    steps_conservative = step_stats(stats_run(trace.build_trace_tables(
        st, rt.arrays, trace.distance_field(st, rt.arrays)))["n_step"])
    clean_ms = cuda_ms(lambda: hit(prim, on), reps=5)

    # warm both edit paths outside the timing (benchmarks/configs.py:52-62);
    # the first frame is the step's capture, counted with the frames
    tile_tracer.reset_launch_counts()
    lookup.table_lookup.launches = 0
    c0 = captures()
    for insert in (True, False):
        move(insert)()
        rt.render()
        torch.cuda.synchronize()
        if insert:
            fractions.append(rt.nonempty_region_fraction())

    torch.cuda.reset_peak_memory_stats()
    frame_ms, wall_ms, edit_ms = [], [], {True: [], False: []}
    image = None
    for i in range(frames):
        insert = i % 2 == 0
        edit = move(insert)
        e0, e1, e2 = frame_events()
        t0 = time.perf_counter()
        e0.record()
        edit()
        e1.record()
        image = rt.render()
        e2.record()
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        frame_ms.append(e0.elapsed_time(e2))
        edit_ms[insert].append(e0.elapsed_time(e1))
        if insert:
            fractions.append(rt.nonempty_region_fraction())
    launches = {"A": tile_tracer.grid_hit_tiles.build_launches["default"],
                "A_all": tile_tracer.grid_hit_tiles.launches,
                "B": lookup.table_lookup.launches}
    made = captures() - c0
    peak = torch.cuda.max_memory_allocated()
    on_card = card_launches(rt.render)  # a replayed frame, traced
    img = image.cpu().numpy()
    log("edit", frames=frames, resolution=f"{w}x{h}", captures=made,
        replayed_frame_on_card_A=on_card["A_all"],
        replayed_frame_on_card_B=on_card["B"],
        median_frame_ms=f"{np.median(frame_ms):.3f}",
        min_frame_ms=f"{min(frame_ms):.3f}", max_frame_ms=f"{max(frame_ms):.3f}",
        median_wall_ms=f"{np.median(wall_ms):.3f}",
        median_insert_refresh_ms=f"{np.median(edit_ms[True]):.3f}",
        median_remove_refresh_ms=f"{np.median(edit_ms[False]):.3f}",
        peak_bytes=peak, launches_A=launches["A"], launches_B=launches["B"],
        shape=list(img.shape))
    log("edit", nonempty_region_fraction_by_insert_batches=json.dumps(
        [round(f, 4) for f in fractions]),
        after_1=f"{fractions[1]:.4f}", after_3=f"{fractions[3]:.4f}",
        degraded=rt._scene_degraded())
    if img.shape != (h, w, 3) or not np.isfinite(img).all():
        raise AssertionError("edit frame has the wrong shape or non-finite "
                             "values")
    # three captures over every edit frame: the frame's step (its run and
    # its capture went through the wrappers, the replays did not), the
    # insert's graph and the removal's (1,024 lanes, with the records)
    if made != 3 or launches != {"A": 2 * 4, "A_all": 2 * 4, "B": 2 * 2}:
        raise AssertionError(f"expected three captures and 4 A and 2 B "
                             f"launches twice over the edit frames, got "
                             f"{made} and {launches}")
    if (on_card["A"], on_card["A_all"], on_card["B"]) != (4, 4, 2):
        raise AssertionError(f"expected 4 A and 2 B launches a replayed edit "
                             f"frame on the card, got {on_card}")
    if not rt._scene_degraded():
        raise AssertionError("the sprayed scene did not degrade")

    # one more insert and one more removal, each held against a full rebuild
    move(True)()
    full = trace.build_trace_tables(st, rt.arrays,
                                    trace.distance_field(st, rt.arrays))
    ins_exact = torch.equal(rt.tables(), full)
    ins_ok = torch.equal(read_lanes(rt.tables()), read_lanes(full))
    move(False)()
    full = trace.build_trace_tables(st, rt.arrays, rt._dist)
    rem_exact = torch.equal(rt.tables(), full)
    rem_ok = torch.equal(read_lanes(rt.tables()), read_lanes(full))
    log("edit", tables_vs_rebuild_after_insert=ins_ok,
        all_lanes_after_insert=ins_exact,
        tables_vs_rebuild_after_remove=rem_ok, all_lanes_after_remove=rem_exact)
    if not (ins_ok and rem_ok):
        raise AssertionError("refreshed records differ from a full rebuild")

    # the decoded scene against the host replay of every edit
    t0 = time.perf_counter()
    for xyz, mats in replay:
        if mats is None:
            host_remove(host, xyz)
        else:
            host.insert_batch(xyz[:, 0], xyz[:, 1], xyz[:, 2], mats)
    got = dense_materials(st, rt.arrays)
    want = dense_materials(st, host.arrays.to_device(dev))
    same = torch.equal(got, want)
    log("edit", batches=len(replay), solid_voxels=int((want >= 0).sum()),
        scene_vs_host_replay=same,
        replay_seconds=f"{time.perf_counter() - t0:.2f}")
    if not same:
        raise AssertionError("the edited scene differs from the host replay")

    # kernel A on the sprayed scene: steps, agreement, time
    after = stats_run()
    steps_after = step_stats(after["n_step"])
    log("edit", steps_per_primary_ray_before=f"mean {steps_before[0]:.2f} "
        f"p99 {steps_before[1]:.0f}",
        clean_with_conservative_field=f"mean {steps_conservative[0]:.2f} "
        f"p99 {steps_conservative[1]:.0f}",
        steps_per_primary_ray_after=f"mean {steps_after[0]:.2f} "
        f"p99 {steps_after[1]:.0f}", stats_launches=stats_launches,
        max_steps=max_steps, warp_use_share_before=f"{warp_share(before):.4f}",
        warp_use_share_after=f"{warp_share(after):.4f}")
    stats_err = compare_exact("stats build", after,
                              hit(prim, on, plain=True, stats=True),
                              ("found", "t", "index", "n_step"))
    want_p = hit(prim, on, plain=True)
    sprayed_err = compare_exact("sprayed primary", hit(prim, on), want_p,
                                tuple(want_p))
    brng = np.random.default_rng(1)
    d = torch.from_numpy(brng.standard_normal((w * h, 3)).astype(
        np.float32)).to(dev)
    d = d / d.norm(dim=-1, keepdim=True)
    nrm = torch.stack([want_p["nx"], want_p["ny"], want_p["nz"]], -1)
    d = torch.where((d * nrm).sum(-1, keepdim=True) < 0, -d, d)
    bounce = (want_p["px"], want_p["py"], want_p["pz"],
              *(d[:, i].contiguous() for i in range(3)))
    live = want_p["found"].contiguous()
    want_b = hit(bounce, live, plain=True)
    sprayed_err = max(sprayed_err, compare_exact(
        "sprayed bounce", hit(bounce, live), want_b, tuple(want_b)))
    sprayed_ms = cuda_ms(lambda: hit(prim, on), reps=5)
    sprayed_plain_ms = cuda_ms(lambda: hit(prim, on, plain=True), reps=1)
    stats_ms = cuda_ms(lambda: hit(prim, on, stats=True), reps=5)
    stats_plain_ms = cuda_ms(lambda: hit(prim, on, plain=True, stats=True),
                             reps=1)
    log("edit", kernel_a_primary_ms_clean=f"{clean_ms:.3f}",
        kernel_a_primary_ms_sprayed=f"{sprayed_ms:.3f}",
        plain_ms_sprayed=f"{sprayed_plain_ms:.1f}",
        stats_build_ms=f"{stats_ms:.3f}", stats_plain_ms=f"{stats_plain_ms:.1f}")
    n = w * h
    return dict(
        sprayed=dict(launches=launches["A"],
                     launches_per_frame=on_card["A"],
                     max_abs_err=sprayed_err, ms=sprayed_ms,
                     plain_ms=sprayed_plain_ms,
                     **a_bound(n, after, after["n_step"])),
        stats=dict(launches=stats_launches,
                   # no frame runs it: a replayed frame's other builds
                   launches_per_frame=on_card["A_all"] - on_card["A"],
                   max_abs_err=stats_err, ms=stats_ms,
                   plain_ms=stats_plain_ms,
                   **a_bound(n, after, after["n_step"], stats=True)),
        engine=rt)


def step_times(fn, frames):
    """[(device ms, wall ms)] of `frames` calls of `fn`, each between CUDA
    events on the current stream and ending in a synchronize, after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(frames):
        e0, e1, _ = frame_events()
        t0 = time.perf_counter()
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        out.append((e0.elapsed_time(e1), (time.perf_counter() - t0) * 1e3))
    return out


def reset_counts():
    from zig_vulkan_tpu_torch.ops import lookup, tile_tracer

    tile_tracer.reset_launch_counts()
    lookup.table_lookup.launches = 0


def read_counts():
    from zig_vulkan_tpu_torch.ops import lookup, tile_tracer

    a = tile_tracer.grid_hit_tiles
    return {"A": a.build_launches["default"], "A_all": a.launches,
            "B": lookup.table_lookup.launches}


def card_counts(launches, calls=1):
    """`utils.profiling.kernel_launches`' counts of a trace, a call, in
    `read_counts`' keys plus one key a build of kernel A."""
    per = {k: v / calls for k, v in launches.items()}
    return dict(per, A=per["default"], A_all=per["A"], B=per["B"])


def card_launches(fn, calls=1):
    """Kernel A and B launches a call of `fn` as the card ran them, counted
    in a `torch.profiler` trace (`device_trace`; one more call runs before
    the trace): a CUDA graph's replay runs its kernels without calling a
    wrapper, so the wrappers' counters (`read_counts`) miss them."""
    return device_trace(fn, calls)["launches"]


def captures():
    """CUDA graph captures made by the port's compiled steps so far."""
    from zig_vulkan_tpu_torch.engine.step import GraphedCall

    return GraphedCall.captures


def halo_check(dev, width, height):
    """Phase 15a: the banded denoiser against the whole image."""
    import torch

    from zig_vulkan_tpu_torch.config import DenoiserConfig
    from zig_vulkan_tpu_torch.ops import denoise

    img = torch.from_numpy(np.random.default_rng(15).random(
        (height, width, 3), dtype=np.float32)).to(dev)
    dn = DenoiserConfig(enabled=True)
    for out_h, out_w in ((height, width), (height * 5 // 4, width * 5 // 4)):
        whole = denoise.postprocess(img, dn, out_h, out_w)
        equal, halos = {}, {}
        for n in HALO_BANDS:
            rows = out_h // n
            bands = []
            for i in range(n):
                r0, r1 = i * rows, (i + 1) * rows if i < n - 1 else out_h
                a, b = denoise.band_input_rows(r0, r1, out_h, height, dn)
                bands.append(denoise.postprocess(
                    img[a:b].clone(), dn, out_h, out_w,
                    band=denoise.Band(r0, r1, a, height)))
                if i == n // 2:
                    halos[n] = [a, b]
            equal[n] = bool(torch.equal(torch.cat(bands), whole))
        log("mesh halo", image=f"{width}x{height}", out=f"{out_w}x{out_h}",
            bands=list(HALO_BANDS),
            equal=json.dumps(equal, separators=(",", ":")),
            middle_band_input_rows=json.dumps(halos, separators=(",", ":")))
        if not all(equal.values()):
            raise AssertionError("the banded denoiser differs from the whole "
                                 "image")


def sharded_default_frame(rt, devices, label, sizes):
    """Phase 15b/d: the default frame's configuration (the engine `rt`'s)
    through `build_sharded_step` over meshes of `devices[:n]` for n in
    `sizes`. Each image (the first call: each shard's graphs' capture) is
    held to the unsharded `render_image` + `postprocess` bit for bit and
    its launches through the wrappers are counted; the largest mesh's
    launches, op by op, are held against their plain versions (phase 21
    times the routes). Returns the kernel launches counted, with the
    launches a shard of one step op by op ("per_shard")."""
    import torch

    from zig_vulkan_tpu_torch.ops import denoise, trace

    st = rt.grid_static
    d, sun = rt.camera.d_camera, rt.sun.device_data
    ow, oh = rt.output_resolution
    levels = int(d.max_bounce)
    img = trace.render_image(st, rt.arrays, rt.mats, d, sun.position,
                             sun.color, sun.radius, bool(sun.enabled),
                             rt.trace_config, tables=rt.tables())
    want = denoise.postprocess(img, rt.denoiser, oh, ow)
    per = levels * frame_launches_per_level(rt)
    total = {"A": 0, "A_all": 0, "B": 0}
    for n in sizes:
        step, args, tables = sharded_default_step(rt, devices[:n])
        reset_counts()
        c0 = captures()
        got = step(*args, tables=tables)
        torch.cuda.synchronize()
        counts = read_counts()
        made = captures() - c0
        total = {k: total[k] + counts[k] for k in total}
        same = bool(torch.equal(got, want))
        log("mesh", mesh=label, shards=n, replicas=len(step.mesh.distinct),
            equals_unsharded=same, captures=made, launches_A=counts["A"],
            launches_B=counts["B"], shape=list(got.shape),
            device=str(got.device))
        if not same or got.device != want.device:
            raise AssertionError(f"the {n}-shard frame differs from the "
                                 f"unsharded one")
        # the capture call: each shard's trace and post-process graphs,
        # their warm-ups and captures through the wrappers
        if made != 2 * n or counts != {"A": 2 * per * n, "A_all": 2 * per * n,
                                       "B": 2 * levels * n}:
            raise AssertionError(f"expected {2 * n} captures and {per} A and "
                                 f"{levels} B launches a shard twice, got "
                                 f"{made} and {counts}")
    # the bands' launches (a band's lanes, each shard's replica), op by
    # op, against their plain versions
    reset_counts()
    check_frame_launches(f"mesh {label} x{n}",
                         lambda: step.op_by_op(*args, tables=tables),
                         per * n, levels * n)
    # a shard's launches in one step, measured: the last mesh's capture
    # call ran each shard's bodies twice (its warm-up and its capture)
    return dict(total, per_shard={k: counts[k] / (2 * n) for k in ("A", "B")})


def sharded_default_step(rt, devices):
    """(the sharded step of `rt`'s frame over `devices`, its arguments
    (replicas, material tables, the camera on the host, the sun) at `rt`'s
    pose now, the records of each replica built with the exact field)."""
    from zig_vulkan_tpu_torch.ops import trace
    from zig_vulkan_tpu_torch.parallel import mesh as pmesh

    st = rt.grid_static
    d, sun = rt.camera.d_camera, rt.sun.device_data
    iw, ih = rt.internal_resolution
    ow, oh = rt.output_resolution
    m = pmesh.make_mesh(devices)
    arrays_r, mats_r = pmesh.replicate_scene(m, rt.arrays, rt.mats)
    tables = pmesh.map_replicas(
        m, lambda a: trace.build_trace_tables(
            st, a, trace.distance_field(st, a, exact=True)), arrays_r)
    step = pmesh.build_sharded_step(
        m, st, width=iw, height=ih, spp=int(d.samples_per_pixel),
        max_bounce=int(d.max_bounce), sun_enabled=bool(sun.enabled),
        out_width=ow, out_height=oh, denoiser=rt.denoiser,
        trace_config=rt.trace_config)
    return step, (arrays_r, mats_r, trace.camera_vectors(d, "cpu"),
                  sun.position, sun.color, sun.radius), tables


def mesh_phase(dev, rt):
    """Phase 15."""
    import torch

    from zig_vulkan_tpu_torch.parallel import mesh as pmesh

    iw, ih = rt.internal_resolution
    halo_check(dev, iw, ih)
    one = pmesh.make_mesh([dev]).devices[0]
    counts = sharded_default_frame(rt, [one] * max(MESH_SIZES), "one card",
                                   MESH_SIZES)
    reset_counts()
    pmesh.dryrun_multichip(4, device=None if dev.type == "cuda" else dev)
    dry = read_counts()
    log("mesh", dryrun_shards=4, launches_A=dry["A_all"],
        launches_B=dry["B"])
    cards = torch.cuda.device_count() if dev.type == "cuda" else 1
    log("mesh", cards=cards,
        note="the frame over distinct cards runs where there are several")
    if cards > 1:
        many = sharded_default_frame(
            rt, list(pmesh.make_mesh().devices), f"{cards} cards", (cards,))
        counts = dict({k: counts[k] + many[k] for k in ("A", "A_all", "B")},
                      per_shard=counts["per_shard"])
    return counts


def config5(dev, scale=1.0, frames=None):
    """Phase 16: BASELINE config 5 (`benchmarks.configs.build_config5`)."""
    import math

    import torch

    from zig_vulkan_tpu_torch.benchmarks import configs
    from zig_vulkan_tpu_torch.ops import lookup, tile_tracer, trace
    from zig_vulkan_tpu_torch.parallel import mesh as pmesh
    from zig_vulkan_tpu_torch.utils import roofline

    frames = configs.DEFAULT_FRAMES[5] if frames is None else frames
    first = pmesh.make_mesh([dev]).devices[0]
    cards = (pmesh.make_mesh() if dev.type == "cuda"
             else pmesh.make_mesh([dev]))
    meshes = [(f"{cards.size} card(s)", cards),
              ("4 shards of one card", pmesh.make_mesh([first] * 4))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # rows that divide over the cards and over 2 and 4 shards of one; the
    # terrain streams through the engine's edit graphs
    c0 = captures()
    c = configs.build_config5(scale, cards.devices,
                              row_multiple=math.lcm(4, cards.size))
    rt, tables, cam = c.rt, c.tables, c.cam
    w, h, streamed = c.width, c.height, c.streamed
    st = rt.grid_static
    log("config 5", voxels="x".join(map(str, st.voxel_dims)), cells=st.cells,
        streamed_voxels=streamed, stream_seconds=f"{c.stream_s:.2f}",
        voxels_per_s=f"{streamed / c.stream_s:.0f}",
        stream_captures=captures() - c0,
        stream_padded_sizes=json.dumps(list(rt._edit_cache)),
        active_bricks=int(rt.arrays.active_bricks),
        exact_field_and_tables_seconds=f"{c.tables_s:.2f}")
    if streamed <= 0 or int(rt.arrays.active_bricks) <= 0:
        raise AssertionError("config 5 streamed no voxel")
    unsharded = c.unsharded

    # the whole frame's launches (one lane a pixel) against their plain
    # versions, then counted and timed as the sharded steps are
    want, err, _, b_inputs = check_frame_launches(
        "config 5 unsharded", unsharded, 1, 1)
    torch.cuda.synchronize()
    reset_counts()
    whole_ms = step_times(unsharded, frames)
    whole = read_counts()
    busy = device_trace(unsharded, frames)
    busy_ms, busy_events = busy["busy_ms"], busy["events"]
    dev_ms, wall_ms = (float(np.median(v)) for v in zip(*whole_ms))
    log("config 5", step="unsharded render_image", frames=frames,
        median_device_ms=f"{dev_ms:.3f}", median_wall_ms=f"{wall_ms:.3f}",
        device_busy_ms=f"{busy_ms:.3f}", device_events=busy_events,
        idle_share=f"{1 - busy_ms / wall_ms:.4f}",
        launches_A=whole["A"], launches_B=whole["B"])
    if whole != {"A": frames + 1, "A_all": frames + 1, "B": frames + 1}:
        raise AssertionError(f"expected one A and one B launch a frame, got "
                             f"{whole}")
    host = want.cpu().numpy()
    colours = len(np.unique((host[::8, ::8] * 255).astype(np.uint8)
                            .reshape(-1, 3), axis=0))
    log("config 5", unsharded_frame=list(want.shape), min=float(host.min()),
        max=float(host.max()), finite=bool(np.isfinite(host).all()),
        distinct_colours_subsampled=colours)
    if (host.shape != (h, w, 3) or not np.isfinite(host).all()
            or host.min() < 0.0 or host.max() > 1.0 or colours <= 16):
        raise AssertionError("config 5's frame has the wrong shape or range")

    total = {"A": 0, "A_all": 0, "B": 0}
    per_shard = None
    for label, m in meshes:
        run = c.sharded_step(m.devices)
        reset_counts()
        c0 = captures()
        got = run()  # each shard's graph captured, synced
        torch.cuda.synchronize()
        made = captures() - c0
        captured = read_counts()
        same = bool(torch.equal(got, want))
        t0 = time.perf_counter()
        for _ in range(frames):
            got = run()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / frames
        # and each step between events of its own, ending in a synchronize
        dev_ms, wall_ms = (float(np.median(v))
                           for v in zip(*step_times(run, frames)))
        busy = device_trace(run, frames)
        busy_ms, busy_events = busy["busy_ms"], busy["events"]
        launches = busy["launches"]  # a replayed step, on the card
        shard = {k: launches[k] / m.size for k in ("A", "B")}
        total = {k: total[k] + captured[k] for k in total}
        log("config 5", mesh=label, shards=m.size, replicas=len(m.distinct),
            resolution=f"{w}x{h}", frames=frames, captures=made,
            ms_per_frame=f"{dt * 1e3:.3f}",
            mrays_per_s=f"{w * h / dt / 1e6:.1f}",
            median_device_ms=f"{dev_ms:.3f}", median_wall_ms=f"{wall_ms:.3f}",
            device_busy_ms=f"{busy_ms:.3f}", device_events=busy_events,
            **idle_share(busy_ms, wall_ms, m.size),
            capture_call_launches_A=captured["A"],
            capture_call_launches_B=captured["B"],
            replayed_step_on_card_A=launches["A_all"],
            replayed_step_on_card_B=launches["B"],
            per_shard_per_step=f"{shard['A']} A + {shard['B']} B",
            equals_unsharded=same,
            peak_bytes=torch.cuda.max_memory_allocated())
        if not same or not torch.equal(got, want):
            raise AssertionError(f"config 5 over {label} differs from the "
                                 f"unsharded frame")
        # a trace graph a shard (no denoiser at the same size: no
        # post-process), its warm-up and capture through the wrappers
        if made != m.size or captured != {"A": 2 * m.size,
                                          "A_all": 2 * m.size,
                                          "B": 2 * m.size}:
            raise AssertionError(f"expected {m.size} captures of one A and "
                                 f"one B launch a shard, got {made} and "
                                 f"{captured}")
        if shard != {"A": 1, "B": 1} or launches["A_all"] != m.size:
            raise AssertionError(f"expected one A and one B launch a shard "
                                 f"a replayed step, got {launches}")
        if per_shard not in (None, shard):
            raise AssertionError(f"launches a shard vary with the mesh: "
                                 f"{per_shard}, {shard}")
        per_shard = shard
    # the last mesh's launches (a band of rows a shard), op by op, against
    # their plain versions
    _, band_err, _, _ = check_frame_launches(f"config 5 {label}",
                                             run.op_by_op, m.size, m.size)
    err = max(err, band_err)
    del run

    # kernel A on the whole wavefront against its plain version
    r = trace._camera_rays_soa(cam, w, h, 0.0)
    rays = tuple(a.contiguous() for a in (*r[:3], *trace._norm3(*r[3:])))
    on = torch.ones(w * h, dtype=torch.bool, device=dev)
    args = (st, tables, rt.arrays.material_indices, *rays, on)
    got = tile_tracer.grid_hit_tiles(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = tile_tracer.grid_hit_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(err, compare_exact("config 5 wavefront", got, plain,
                                 tuple(plain)))
    counted = tile_tracer.grid_hit_tiles(*args, stats=True)
    ms = cuda_ms(lambda: tile_tracer.grid_hit_tiles(*args), reps=5)
    mean, p99 = step_stats(counted["n_step"])
    bound = a_bound(w * h, got, counted["n_step"])
    log("config 5", kernel_a_lanes=w * h, kernel_a_ms=f"{ms:.3f}",
        plain_ms=f"{plain_ms:.1f}", bound_ms=f"{bound['bound_ms']:.4f}",
        bound_by=bound["bound_by"],
        steps_per_ray=f"mean {mean:.2f} p99 {p99:.0f}",
        warp_use_share=f"{warp_share(counted):.4f}",
        mrays_per_s=f"{w * h / ms / 1e3:.1f}",
        peak_bytes=torch.cuda.max_memory_allocated())
    # kernel B on the whole frame's material indices
    mats, idx = b_inputs[0]
    nb = int(idx.numel())
    b_ms = cuda_ms(lambda: lookup.table_lookup(mats, idx), reps=10)
    b_plain_ms = cuda_ms(lambda: lookup._table_lookup_plain(mats, idx),
                         reps=5)
    b_lib_ms = cuda_ms(lambda: torch.index_select(mats, 1, idx), reps=10)
    b_bound, b_by = roofline.bound_ms(roofline.lookup_bytes(nb, *mats.shape))
    b_got = torch.stack(lookup.table_lookup(mats, idx))
    b_err = (b_got - lookup._table_lookup_plain(mats, idx)).abs().max().item()
    log("config 5", kernel_b_lanes=nb, tables=list(mats.shape),
        kernel_b_ms=f"{b_ms:.4f}", plain_ms=f"{b_plain_ms:.4f}",
        index_select_ms=f"{b_lib_ms:.4f}", bound_ms=f"{b_bound:.4f}",
        bound_by=b_by, max_abs_err=b_err)
    if b_err != 0.0:
        raise AssertionError("kernel B differs from its plain version on "
                             "config 5's frame")
    # launches: the whole-frame launches the main path made (the unsharded
    # frames: the shape that is timed here); the sharded steps' launches
    # stand beside them, in all and a shard a step, as counted

    def row(k, **measured):
        return dict(lanes=w * h, launches=whole[k],
                    launches_sharded_steps=total[k],
                    launches_per_shard_per_step=per_shard[k], **measured)

    return dict(
        A=row("A", max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound),
        B=row("B", max_abs_err=b_err, ms=b_ms, plain_ms=b_plain_ms,
              bound_ms=b_bound, bound_by=b_by, library_ms=b_lib_ms)), c


def baseline_configs(dev, scene, scale=1.0, frames=None):
    """Phase 17: BASELINE configs 1, 2 and 4 at full width, built by
    `benchmarks.configs` and timed by its `_timed_frames` (a synced warm-up,
    the frames chained, one sync) over the source's 8 / 6 / 6 frames (or
    `frames` each); then one more frame of each has its kernel launches held
    against their plain versions. Returns the kernel launches counted, with
    the launches a frame of each config ("per_frame") and the largest
    difference from a plain version ("max_abs_err")."""
    import torch

    from zig_vulkan_tpu_torch.benchmarks import configs

    total = {"A": 0, "A_all": 0, "B": 0}
    per_frame, err = {}, 0.0
    for number in (1, 2, 4):
        n_frames = configs.DEFAULT_FRAMES[number] if frames is None else frames
        t0 = time.perf_counter()
        build = getattr(configs, f"build_config{number}")
        # config 2 renders the default scene the caller has built
        rt = (build(scale, dev, scene=scene) if number == 2
              else build(scale, dev))
        rt.tables()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        reset_counts()
        c0 = captures()
        first = rt.render().clone()  # the capture frame, before the timed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        timed = configs._timed_frames(rt, n_frames)
        counts = read_counts()
        made = captures() - c0
        # a replayed frame on the card (two renders: the trace's and one
        # before it)
        on_card = card_launches(rt.render)
        image = rt.render()
        torch.cuda.synchronize()
        total = {k: total[k] + counts[k] for k in total}
        per_frame[number] = {k: on_card[k] for k in ("A", "B")}
        w, h = rt.internal_resolution
        d = rt.camera.d_camera
        spp, levels = int(d.samples_per_pixel), int(d.max_bounce)
        per = levels * frame_launches_per_level(rt)
        img = image.cpu().numpy()
        log(f"config {number}",
            voxels="x".join(map(str, rt.grid_static.voxel_dims)),
            cell_size=rt.grid_static.scale, resolution=f"{w}x{h}", spp=spp,
            bounce_levels=levels, sun=bool(rt.sun.device_data.enabled),
            denoiser=bool(rt.denoiser.enabled), temporal=rt.temporal_enabled,
            max_steps=rt.trace_config.max_steps, frames=n_frames,
            captures=made, launches_A=counts["A"], launches_B=counts["B"],
            ms_per_frame=f"{timed['ms_per_frame']:.3f}",
            fps=f"{timed['fps']:.2f}",
            mrays_per_s=f"{timed['mrays_per_s']:.1f}",
            launches_A_per_frame=per_frame[number]["A"],
            launches_B_per_frame=per_frame[number]["B"],
            shape=list(img.shape), min=float(img.min()),
            max=float(img.max()), finite=bool(np.isfinite(img).all()),
            setup_seconds=f"{setup_s:.2f}",
            peak_bytes=torch.cuda.max_memory_allocated())
        ow, oh = rt.output_resolution
        if (img.shape != (oh, ow, 3) or not np.isfinite(img).all()
                or img.min() < 0.0 or img.max() > 1.0):
            raise AssertionError(f"config {number}: wrong shape or range")
        # the capture frame's run and capture through the wrappers; the
        # timed frames are replays
        if made != 1 or counts != {"A": 2 * per, "A_all": 2 * per,
                                   "B": 2 * levels}:
            raise AssertionError(f"config {number}: expected one capture of "
                                 f"{per} A and {levels} B launches, got "
                                 f"{made} and {counts}")
        if (on_card["A"], on_card["A_all"], on_card["B"]) != (per, per,
                                                             levels):
            raise AssertionError(f"config {number}: expected {per} A and "
                                 f"{levels} B launches a replayed frame on "
                                 f"the card, got {on_card}")
        moved = (image - first).abs().mean().item()
        # one more frame, its launches against their plain versions
        _, e, rows, _ = check_frame_launches(f"config {number}",
                                             rt.render_op_by_op, per, levels)
        err = max(err, e)
        log(f"config {number}", frame_launches=json.dumps(
            rows, separators=(",", ":")))
        if number != 4:
            continue
        seen = [r["emissive"] for r in rows]
        log("config 4", accum_count=rt._accum_count,
            mean_abs_accumulated_minus_first=f"{moved:.3e}",
            emissive_lanes_per_launch=seen)
        # the capture frame, _timed_frames' warm-up and frames, the two of
        # the trace, one more, the op-by-op frame
        if rt._accum_count != n_frames + 6 or not moved > 0:
            raise AssertionError("config 4: the accumulated frame did not "
                                 "move")
        # The benchmark's camera may see no emissive voxel, so the same
        # engine also renders from the pose that looks at the block.
        configs.look_at_emissive_block(rt)
        _, e, rows, _ = check_frame_launches(
            "config 4, the block in view", rt.render_op_by_op, per, levels)
        err = max(err, e)
        seen = [r["emissive"] for r in rows]
        log("config 4", pose="the block in view", frame_launches=json.dumps(
            rows, separators=(",", ":")))
        view = rt.render()
        torch.cuda.synchronize()
        red = float(view[..., 0].max())
        log("config 4", pose="the block in view",
            origin=np.round(rt.camera.d_camera.origin, 3).tolist(),
            emissive_lanes_per_launch=seen, accum_count=rt._accum_count,
            max_red=f"{red:.4f}", finite=bool(torch.isfinite(view).all()))
        # albedo 1.0 x strength 8 tone-maps to 8/9, gamma 0.943; the sun
        # lights no albedo beyond 0.5, gamma 0.707
        if (seen[0] <= 0 or sum(seen[2::2]) <= 0 or not red > 0.9
                or rt._accum_count != 2 or not torch.isfinite(view).all()):
            raise AssertionError("config 4: the emissive block is not in "
                                 "the frame that looks at it")
    return dict(total, per_frame=per_frame, max_abs_err=err)


def shadow_probe(rt, rays, active, key):
    """Phase 9: kernel A's shadow build and the sun_in_kernel frame, at the
    default EngineConfig (`rt`), on the frame's primary wavefront `rays`
    and the keyed bounce batch `key` = (rays, active, ray_key)."""
    import dataclasses

    import torch

    from zig_vulkan_tpu_torch.ops import lookup, tile_tracer, trace

    st = rt.grid_static
    sun = rt.sun.device_data
    radius = np.float32(sun.radius)

    def hit(r, a, plain=False, **kw):
        fn = tile_tracer.grid_hit_plain if plain else tile_tracer.grid_hit_tiles
        return fn(st, rt.tables(), rt.arrays.material_indices, *r, a,
                  max_steps=rt.trace_config.max_steps, **kw)

    keys = ("found", "t", "index", "occluded", "px", "py", "pz", "nx", "ny",
            "nz")
    tg = trace.sun_targets(rays[3], rays[4], rays[5], sun.position, radius)
    want = hit(rays, active, plain=True, shadow_targets=tg)
    err = compare_exact("shadow build primary",
                        hit(rays, active, shadow_targets=tg), want, keys)
    occ_share = want["occluded"][want["found"]].float().mean().item()
    krays, kactive, kkey = key
    ktg = trace.sun_targets(krays[3], krays[4], krays[5], sun.position, radius)
    err = max(err, compare_exact(
        "shadow build keyed bounce",
        hit(krays, kactive, ray_key=kkey, shadow_targets=ktg),
        hit(krays, kactive, plain=True, ray_key=kkey, shadow_targets=ktg),
        keys))
    first = hit(rays, active, shadow_targets=tg, stats=True)
    bound = a_bound(int(active.numel()), first, first["n_step"], shadow=True)
    ms = cuda_ms(lambda: hit(rays, active, shadow_targets=tg), reps=5)
    plain_ms = cuda_ms(lambda: hit(rays, active, plain=True,
                                   shadow_targets=tg), reps=1)
    log("shadow", occluded_share_of_hits=f"{occ_share:.4f}",
        shadow_build_ms=f"{ms:.3f}", plain_ms=f"{plain_ms:.3f}")

    base = rt.trace_config
    images = {}
    ms_lists = {False: [], True: []}
    counts = {False: {}, True: {}}  # through the wrappers
    made = {False: 0, True: 0}
    on_card = {}  # a replayed frame of each, traced
    # in turns (separate, in kernel, in kernel, separate): the frames are
    # host-bound and drift between groups. sun_in_kernel is in the step's
    # key: a group whose key is not the cached step's captures it anew.
    for probe in (False, True, True, False):
        rt.trace_config = dataclasses.replace(base, sun_in_kernel=probe)
        tile_tracer.reset_launch_counts()
        lookup.table_lookup.launches = 0
        c0 = captures()
        rt.draw()  # warm-up
        for _ in range(PROBE_FRAMES):
            e0, e1, _ = frame_events()
            e0.record()
            images[probe] = rt.draw()
            e1.record()
            torch.cuda.synchronize()
            ms_lists[probe].append(e0.elapsed_time(e1))
        made[probe] += captures() - c0
        for name, n in dict(tile_tracer.grid_hit_tiles.build_launches,
                            B=lookup.table_lookup.launches).items():
            counts[probe][name] = counts[probe].get(name, 0) + n
        if probe not in on_card:
            on_card[probe] = card_launches(rt.render)
    rt.trace_config = base
    timing = {k: float(np.median(v)) for k, v in ms_lists.items()}
    diff = (images[True] - images[False]).abs().amax(-1)
    share = (diff > 1e-3).float().mean().item()
    log("shadow", frame_ms_separate=f"{timing[False]:.3f}",
        frame_ms_in_kernel=f"{timing[True]:.3f}",
        frames_each=2 * PROBE_FRAMES, captures=json.dumps(made),
        launches_separate=json.dumps(counts[False], separators=(",", ":")),
        launches_in_kernel=json.dumps(counts[True], separators=(",", ":")),
        replayed_frame_on_card_separate=json.dumps(
            on_card[False], separators=(",", ":")),
        replayed_frame_on_card_in_kernel=json.dumps(
            on_card[True], separators=(",", ":")),
        share_over_1e_3=share,
        bit_equal=bool(torch.equal(images[True], images[False])))
    if share >= 0.01:
        raise AssertionError("sun_in_kernel frame differs from the separate "
                             "shadow launches")
    # a replayed frame: 3 shadow A launches in kernel, 6 default A
    # separately, 3 B either way; through the wrappers, each capture's run
    # and capture of the same
    want = {True: {"shadow": 3, "default": 0, "B": 3},
            False: {"shadow": 0, "default": 6, "B": 3}}
    for probe, w in want.items():
        got = {k: on_card[probe][k] for k in w}
        wrapped = {k: counts[probe][k] for k in w}
        if (made[probe] < 1 or got != w
                or wrapped != {k: 2 * made[probe] * v for k, v in w.items()}):
            raise AssertionError(f"unexpected launch counts: captures {made}, "
                                 f"wrappers {counts}, on the card {on_card}")
    return dict(launches=counts[True]["shadow"],
                launches_per_frame=on_card[True]["shadow"],
                max_abs_err=err, ms=ms, **bound,
                plain_ms=plain_ms)


def temporal(rt):
    """Phase 10: accumulation over a static pose, then set_resolutions."""
    import torch

    rt.set_temporal(True)
    accums = []
    for _ in range(TEMPORAL_FRAMES):
        img = rt.draw()
        accums.append(rt._accum.clone())
    deltas = [(b - a).abs().mean().item() for a, b in zip(accums, accums[1:])]
    finite = bool(torch.isfinite(img).all())
    log("temporal", frames=TEMPORAL_FRAMES, accum_count=rt._accum_count,
        mean_abs_delta=json.dumps([f"{d:.3e}" for d in deltas]),
        finite=finite)
    if rt._accum_count != TEMPORAL_FRAMES or not finite:
        raise AssertionError("temporal accumulation count or values wrong")
    if not deltas[-1] < deltas[0]:
        raise AssertionError("accumulated frames do not settle")
    internal, output = rt.internal_resolution, rt.output_resolution
    iw, ih = internal
    new_out = (iw * 5 // 8, ih * 5 // 8)  # 640x360 from 1024x576
    rt.set_resolutions(internal=(iw // 2, ih // 2), output=new_out)
    shape = tuple(rt.draw().shape)
    log("temporal", set_resolutions_shape=list(shape),
        accum_count=rt._accum_count)
    if shape != (new_out[1], new_out[0], 3) or rt._accum_count != 1:
        raise AssertionError("set_resolutions did not change the output")
    rt.set_temporal(False)
    rt.set_resolutions(internal=internal, output=output)


def flythrough(dev, scene, width, height):
    """Phase 11: the whole 60 s fly-through through
    `benchmarks.flythrough.fly` (the default workload at `width` x `height`,
    animated sun), which prints the reference's report. Returns the kernel
    launches counted."""
    from zig_vulkan_tpu_torch.benchmarks import flythrough as fly_mod

    reset_counts()
    c0 = captures()
    t0 = time.perf_counter()
    rep = fly_mod.fly(FLY_DT, dev, scene=scene,
                      config=fly_mod.default_workload(width=width,
                                                      height=height))
    counts = read_counts()
    made = captures() - c0
    want = round(60.0 / FLY_DT)
    # mean ms over each of the path's 11 waypoint stretches, in path order
    stretches = [f"{np.mean(part) * 1e3:.1f}"
                 for part in np.array_split(np.asarray(rep.samples), 11)]
    log("benchmark", mean_ms_by_path_stretch=json.dumps(stretches))
    log("benchmark", frames=rep.delta_time_sum_samples,
        min_ms=f"{rep.min_delta_time * 1e3:.3f}",
        max_ms=f"{rep.max_delta_time * 1e3:.3f}",
        avg_ms=f"{rep.average() * 1e3:.3f}",
        captures=made, launches_A=counts["A"], launches_B=counts["B"],
        seconds=f"{time.perf_counter() - t0:.2f}")
    if rep.delta_time_sum_samples != want or not np.isfinite(rep.average()):
        raise AssertionError(f"the fly-through reported "
                             f"{rep.delta_time_sum_samples} frames, not "
                             f"{want}")
    # one capture (the warm-up frame) for every frame of the path: its run
    # and its capture went through the wrappers, the 121 replays did not
    # (phases 6 and 20 count a replayed frame's launches on the card)
    if made != 1 or counts != {"A": 2 * 6, "A_all": 2 * 6, "B": 2 * 3}:
        raise AssertionError(f"expected one capture of 6 A and 3 B launches "
                             f"over the fly-through, got {made} and "
                             f"{counts}")
    return counts


def headline_bench(dev, scale):
    """Phase 18: `benchmarks.bench.main` in this process; its JSON line goes
    out on a line of its own. Returns the kernel launches counted."""
    from zig_vulkan_tpu_torch.benchmarks import bench

    argv = [str(BENCH_POSES), "--device", str(dev)]
    if scale != 1.0:
        argv += ["--scale", str(scale)]
    reset_counts()
    c0 = captures()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(argv)
    counts = read_counts()
    made = captures() - c0
    lines = buf.getvalue().strip().splitlines()
    print(buf.getvalue().strip(), flush=True)
    rec = json.loads(lines[-1])
    log("bench", exit_code=rc, captures=made, launches_A=counts["A"],
        launches_B=counts["B"], seconds=f"{time.perf_counter() - t0:.2f}")
    if rc != 0 or len(lines) != 1:
        raise AssertionError(f"the bench exited with {rc}")
    if not rec["value"] > 0 or rec["parity_vs_oracle"] < 0.995:
        raise AssertionError("the bench line has no value or too low a "
                             "parity")
    if dev.type == "cuda" and rec["kernel_a_launches_per_pose"] != 1:
        raise AssertionError("the bench did not launch kernel A once a pose")
    # through the wrappers: the pose frame's capture (its run and its
    # capture), one pose op by op, the parity rays, and the default frame's
    # capture (6 A and 3 B, twice); the timed poses and 12 default frames
    # are replays (phase 20 traces both frames' replays on the card)
    a = 2 + 1 + 1 + 2 * 6
    if made != 2 or counts != {"A": a, "A_all": a, "B": 2 * 3}:
        raise AssertionError(f"unexpected bench launches {counts} over "
                             f"{made} captures")
    return counts


def entry_step(dev):
    """Phase 19: `entry.entry()`'s render step on the card: its image
    against the same step on the CPU (the kernels' plain versions; no pixel
    may differ by 1e-5, where an H100 measured 1.8e-7), then each of its
    kernel launches against its plain version, bit for bit. Returns the
    kernel launches counted in the step, with the launches' largest
    difference as `max_abs_err`."""
    import torch

    from zig_vulkan_tpu_torch import entry

    fn, args = entry.entry(dev)
    reset_counts()
    got = fn(*args)
    torch.cuda.synchronize()
    counts = read_counts()
    plain_fn, plain_args = entry.entry("cpu")
    want = plain_fn(*plain_args)
    diff = (got.cpu() - want).abs().amax(-1)
    log("entry", shape=list(got.shape), device=str(got.device),
        max_abs=float(diff.max()), mean_abs=float(diff.mean()),
        share_over_1e_3=float((diff > 1e-3).float().mean()),
        finite=bool(torch.isfinite(got).all()), launches_A=counts["A"],
        launches_B=counts["B"])
    if (tuple(got.shape) != (48, 64, 3) or got.device.type != dev.type
            or not torch.isfinite(got).all()):
        raise AssertionError("the entry step's image has the wrong shape, "
                             "device or values")
    if not diff.max() < 1e-5:
        raise AssertionError("the entry step on the card differs from the "
                             "step on plain versions")
    if counts != {"A": 4, "A_all": 4, "B": 2}:
        raise AssertionError(f"expected 4 A and 2 B launches in the entry "
                             f"step, got {counts}")
    _, err, _, _ = check_frame_launches("entry", lambda: fn(*args), 4, 2)
    return dict(counts, max_abs_err=err)


def _same(got, want):
    import torch

    if isinstance(want, dict):
        return all(torch.equal(got[k], want[k]) for k in want)
    return bool(torch.equal(got, want))


def graph_pool_bytes(graph):
    """Bytes of the segments of `graph`'s private memory pool (what a
    captured step holds between replays), or None where the allocator's
    snapshot does not name pools."""
    import torch

    pool = tuple(graph.pool())
    segments = torch.cuda.memory_snapshot()
    if not segments or "segment_pool_id" not in segments[0]:
        return None
    return sum(seg["total_size"] for seg in segments
               if tuple(seg["segment_pool_id"]) == pool)


def step_case(label, pair, routes, graph, between=lambda i: None,
              htod_replay=1):
    """Phase 20, one case. `routes` = {"replay": ..., "op_by_op": ...}, one
    frame each; `pair()` gives (replayed, op-by-op) results of one frame
    from the same state; `graph()` the case's CUDAGraph; `between(i)` the
    host's work before frame i, outside the timings (moves). The first
    frame is the capture frame. Kernel launches are counted two
    ways: through the wrappers over the whole case (the capture frame's run
    and capture, and the op-by-op frames), and on the card from the traces
    of each route (a replay calls no wrapper). Returns the case's
    numbers."""
    import torch

    c0 = captures()
    reset_counts()
    t_case = time.perf_counter()
    between(0)
    routes["replay"]()
    torch.cuda.synchronize()
    equal = []
    frame = 1
    for _ in range(STEP_EQUAL):
        between(frame)
        frame += 1
        equal.append(_same(*pair()))
    times = {name: [] for name in routes}
    for name in ("op_by_op", "replay", "replay", "op_by_op"):
        for _ in range(STEP_FRAMES):
            between(frame)
            frame += 1
            torch.cuda.synchronize()
            e0, e1, _ = frame_events()
            t0 = time.perf_counter()
            e0.record()
            routes[name]()
            e1.record()
            torch.cuda.synchronize()
            times[name].append((e0.elapsed_time(e1),
                                (time.perf_counter() - t0) * 1e3))
    peak = {}
    for name, fn in routes.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        fn()
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated()
    pool = graph_pool_bytes(graph())
    traced = {name: device_trace(fn, TRACE_FRAMES)
              for name, fn in routes.items()}
    wrapped = read_counts()
    made = captures() - c0
    launches = {name: t["launches"] for name, t in traced.items()}
    out = dict(bit_equal=all(equal), frames_compared=len(equal),
               captures=made, frames=frame,
               wrapper_launches_A=wrapped["A_all"],
               wrapper_launches_B=wrapped["B"])
    for name in routes:
        dev_ms, wall_ms = (float(np.median(v)) for v in zip(*times[name]))
        t = traced[name]
        out[name] = dict(
            launches_A=launches[name]["A_all"], launches_B=launches[name]["B"],
            median_device_ms=dev_ms, median_wall_ms=wall_ms,
            device_busy_ms=t["busy_ms"], idle_share=1 - t["busy_ms"] / wall_ms,
            device_events=t["events"], kernels=t["kernels"],
            htod_copies=t["htod"], htod_pageable=t["htod_pageable"],
            copies=json.dumps(t["copies"], separators=(",", ":")),
            peak_allocated_bytes=peak[name])
    out["replay"]["graph_pool_bytes"] = pool
    log("step", case=label, bit_equal=out["bit_equal"],
        frames_compared=len(equal), captures=made, frames=frame,
        wrapper_launches_A=wrapped["A_all"], wrapper_launches_B=wrapped["B"],
        seconds=f"{time.perf_counter() - t_case:.2f}")
    for name in routes:
        log("step", case=label, route=name, **{
            k: (f"{v:.4f}" if isinstance(v, float) else v)
            for k, v in out[name].items()})
    if not out["bit_equal"]:
        raise AssertionError(f"{label}: a replay differs from the op-by-op "
                             f"body")
    if made != 1:
        raise AssertionError(f"{label}: {made} captures, expected one")
    # on the card, a replay runs every launch of kernels A and B (each
    # build) that the body op by op runs
    if (launches["replay"] != launches["op_by_op"]
            or not launches["replay"]["A_all"] > 0 or not wrapped["A_all"] > 0):
        raise AssertionError(f"{label}: launches on the card differ between "
                             f"the routes or are missing: {launches}, "
                             f"{wrapped} through the wrappers")
    if out["replay"]["htod_copies"] != htod_replay:
        raise AssertionError(f"{label}: {out['replay']['htod_copies']} "
                             f"host-to-device copies a replayed frame, "
                             f"expected {htod_replay}")
    return out


def compiled_step(dev, scene, cfg, c5, scale=1.0):
    """Phase 20: the compiled step's five cases (see the module
    docstring); `c5` is phase 16's config 5. Returns {case: numbers}."""
    import torch

    from zig_vulkan_tpu_torch.benchmarks import bench, configs
    from zig_vulkan_tpu_torch.config import CameraConfig
    from zig_vulkan_tpu_torch.core.camera import Camera
    from zig_vulkan_tpu_torch.engine.engine import VoxelRT, both_routes
    from zig_vulkan_tpu_torch.ops import trace

    cases = {}

    def engine_case(label, rt, between=lambda i: None):
        cases[label] = step_case(
            label, lambda: both_routes(rt),
            {"replay": rt.render, "op_by_op": rt.render_op_by_op},
            lambda: rt.step().graphed.graph, between)

    def move(rt):
        def between(i):
            rt.camera.turn_yaw(0.02)
            rt.camera.translate(0.05, [0.0, 0.0, -1.0])
        return between

    rt = VoxelRT(scene.grid, scene.materials, cfg, device=dev)
    engine_case("default frame", rt, move(rt))
    rt.set_denoiser(samples=8)
    engine_case("default frame, denoiser samples 8", rt, move(rt))
    del rt

    rt = configs.build_config4(scale, dev)
    engine_case("config 4 temporal frames", rt)
    del rt

    engine_case("config 5 4K frame", c5.rt)

    tables = VoxelRT(scene.grid, scene.materials, cfg, device=dev).tables()
    st = scene.grid.static
    w, h = configs.scaled_size(scale, 1920, 1080)
    arrays = scene.grid.arrays.to_device(dev)
    frame = bench.PoseFrame(st, tables, arrays.material_indices, w, h)
    cam = Camera(75.0, w, h, CameraConfig(origin=(0.0, 0.0, 0.0)))
    vecs = []
    for p in PATH_POINTS:
        cam.set_origin(p)
        vecs.append(torch.from_numpy(trace.camera_basis(cam.d_camera))
                    .to(dev))
    pose = [vecs[0]]

    def pair():
        got = {k: v.clone() for k, v in frame(pose[0]).items()}
        frame.camera.copy_(pose[0])
        return got, frame.body(frame.camera)

    def op_by_op():
        frame.camera.copy_(pose[0])
        return frame.body(frame.camera)

    cases["bench pose frame"] = step_case(
        "bench pose frame", pair,
        {"replay": lambda: frame(pose[0]), "op_by_op": op_by_op},
        lambda: frame.compiled.graph,
        lambda i: pose.__setitem__(0, vecs[i % len(vecs)]), htod_replay=0)
    return cases


# -- phase 21: the compiled edit path and shards ----------------------------------

@contextlib.contextmanager
def sync_errors():
    """Any host synchronization by a CUDA call inside the block raises
    (`torch.cuda.set_sync_debug_mode("error")`)."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def edit_call(rt, xyz, mats, replay):
    """One edit batch of `rt` (an insert, or a removal where `mats` is
    None) through its graph (`replay`) or its body op by op."""
    if mats is None:
        (rt.remove_voxels if replay else rt.remove_voxels_op_by_op)(xyz)
    else:
        (rt.insert_voxels if replay
         else rt.insert_voxels_op_by_op)(xyz, mats)


def scene_differs(a, b):
    """The GridArrays fields that differ between two scenes, bit for bit."""
    import torch

    def raw(t):
        return t.reshape(-1).view(torch.uint8)

    return [f for f in _FIELDS if not torch.equal(raw(getattr(a, f)),
                                                  raw(getattr(b, f)))]


def edit_routes(dev, scene, scale):
    """Phase 21a: config 3's 16 edit frames (`build_config3` and its
    `EditStream`) on two engines from one scene, one through the edit and
    frame graphs, one through the same bodies op by op, in turns. Returns
    the engines and the numbers."""
    import torch

    from zig_vulkan_tpu_torch.benchmarks import configs

    rts = {name: configs.build_config3(scale, dev, scene=scene)
           for name in ("replay", "op_by_op")}
    streams = {name: configs.EditStream(rt) for name, rt in rts.items()}
    for rt in rts.values():
        rt.tables()
    done = {name: 0 for name in rts}
    images = {name: [] for name in rts}
    times = {name: {"insert": [], "remove": []} for name in rts}
    frames = {name: [] for name in rts}

    def frame(name):
        rt, i = rts[name], done[name]
        done[name] += 1
        replay = name == "replay"
        xyz, mats = streams[name].draw(i)
        op = "remove" if mats is None else "insert"
        torch.cuda.synchronize()
        e0, e1, e2 = frame_events()
        t0 = time.perf_counter()
        e0.record()
        # the replay route's first insert and removal capture their graphs
        # (a capture synchronizes); every other edit runs with host syncs
        # made errors
        with (contextlib.nullcontext() if replay and i < 2
              else sync_errors()):
            edit_call(rt, xyz, mats, replay)
        e1.record()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        images[name].append(rt.render() if replay else rt.render_op_by_op())
        e2.record()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if i >= 2:  # the capture frames stay out of the times
            times[name][op].append((e0.elapsed_time(e1), (t1 - t0) * 1e3))
            frames[name].append((e0.elapsed_time(e2), (t2 - t0) * 1e3))

    c0 = captures()
    for name in ROUTE_TURNS * 2:
        for _ in range(EDIT_TURN_FRAMES):
            frame(name)
    made = captures() - c0
    differ = scene_differs(rts["replay"].arrays, rts["op_by_op"].arrays)
    tables_equal = bool(torch.equal(rts["replay"]._tables,
                                    rts["op_by_op"]._tables))
    images_equal = [bool(torch.equal(a, b)) for a, b in
                    zip(images["replay"], images["op_by_op"])]
    graphs = rts["replay"]._edit_cache[1024].graphs
    keys = sorted(graphs)
    pools = [graph_pool_bytes(g.graph) for g in graphs.values()]
    pools.append(graph_pool_bytes(rts["replay"].step().graphed.graph))

    # host-to-device copies and busy time of an edit, from a trace
    def next_edit(name):
        i = done[name]
        done[name] += 1
        edit_call(rts[name], *streams[name].draw(i), name == "replay")

    traced = {name: device_trace(lambda name=name: next_edit(name),
                                 TRACE_FRAMES)
              for name in rts}
    peak = {}
    for name in rts:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            frame(name)
        peak[name] = torch.cuda.max_memory_allocated()
    out = dict(frames=len(images_equal), captures=made,
               graph_keys=[list(k) for k in keys], arrays_differ=differ,
               tables_equal=tables_equal, images_equal=sum(images_equal),
               graph_pool_bytes=pools)
    for name in rts:
        ins, rem, fr = (list(zip(*v)) for v in
                        (times[name]["insert"], times[name]["remove"],
                         frames[name]))
        t = traced[name]
        out[name] = dict(
            insert_refresh_ms=float(np.median(ins[0])),
            insert_refresh_wall_ms=float(np.median(ins[1])),
            remove_refresh_ms=float(np.median(rem[0])),
            remove_refresh_wall_ms=float(np.median(rem[1])),
            edit_frame_ms=float(np.median(fr[0])),
            edit_frame_wall_ms=float(np.median(fr[1])),
            edit_htod_copies=t["htod"], edit_htod_pageable=t["htod_pageable"],
            edit_busy_ms=t["busy_ms"], edit_kernels=t["kernels"],
            peak_allocated_bytes=peak[name])
    log("edits", case="config 3's edit frames, replay against op by op",
        **{k: (json.dumps(v, separators=(",", ":"))
               if isinstance(v, (list, dict)) else v)
           for k, v in out.items() if k not in rts})
    for name in rts:
        log("edits", route=name, **{k: (f"{v:.4f}" if isinstance(v, float)
                                        else v)
                                    for k, v in out[name].items()})
    if differ or not tables_equal or not all(images_equal):
        raise AssertionError(f"config 3's edit frames differ between the "
                             f"routes: arrays {differ}, records equal "
                             f"{tables_equal}, images {images_equal}")
    # the frame's step, one insert and one removal graph of 1,024 lanes
    if made != 3 or keys != [("insert", True, True), ("remove", True, True)]:
        raise AssertionError(f"expected the frame's and one capture an edit "
                             f"kind over config 3's frames, got {made}: "
                             f"{keys}")
    if any(out[n]["edit_htod_copies"] != 1 or out[n]["edit_htod_pageable"]
           for n in rts):
        raise AssertionError("expected one pinned host-to-device copy an "
                             "edit")
    return rts, out


def edge_batches(dev, rts):
    """Phase 21b: a batch of 1,500 voxels (2,048 lanes) on both routes of
    phase 21a's engines, and a batch that would exhaust `brick_alloc` on a
    small engine: the guard raises before the scene is touched."""
    import torch

    from zig_vulkan_tpu_torch.config import (CameraConfig, DenoiserConfig,
                                             EngineConfig, GridConfig,
                                             SunConfig)
    from zig_vulkan_tpu_torch.core.grid import BrickGrid
    from zig_vulkan_tpu_torch.core.materials import terrain_materials
    from zig_vulkan_tpu_torch.engine.engine import VoxelRT

    rng = np.random.default_rng(21)
    vx, vy, vz = rts["replay"].grid_static.voxel_dims
    xyz = np.stack([rng.integers(0, vx, 1500), rng.integers(0, vy, 1500),
                    rng.integers(0, vz, 1500)], -1)
    mats = rng.integers(1, 8, 1500).astype(np.uint8)
    c0 = captures()
    for name, rt in rts.items():
        with (contextlib.nullcontext() if name == "replay"
              else sync_errors()):
            edit_call(rt, xyz, mats, name == "replay")
    torch.cuda.synchronize()
    made = captures() - c0
    differ = scene_differs(rts["replay"].arrays, rts["op_by_op"].arrays)
    same_tables = bool(torch.equal(rts["replay"]._tables,
                                   rts["op_by_op"]._tables))

    grid = BrickGrid(16, 8, 16, GridConfig(brick_alloc=4))
    grid.insert(0, 0, 0, 1)
    small = VoxelRT(grid, terrain_materials(), EngineConfig(
        internal_resolution_width=64, internal_resolution_height=64,
        camera=CameraConfig(samples_per_pixel=1, max_bounce=0),
        sun=SunConfig(enabled=False), denoiser=DenoiserConfig(enabled=False)),
        device=dev)
    small.insert_voxels([[8, 8, 8]], [1])
    small.insert_voxels([[16, 16, 16], [24, 24, 24]], [2, 3])  # 4 of 4
    before = {f: getattr(small.arrays, f).clone() for f in _FIELDS}
    raised = False
    try:
        small.insert_voxels([[32, 8, 32], [40, 8, 40]], [4, 5])
    except MemoryError:
        raised = True
    torch.cuda.synchronize()
    untouched = all(torch.equal(before[f].view(torch.uint8)
                                if before[f].is_floating_point() else before[f],
                                getattr(small.arrays, f).view(torch.uint8)
                                if before[f].is_floating_point()
                                else getattr(small.arrays, f))
                    for f in _FIELDS)
    small.insert_voxels([[9, 9, 9]], [6])  # into a loaded brick: fits
    torch.cuda.synchronize()
    active = int(small.arrays.active_bricks)
    log("edits", case="edge batches", batch_1500_lanes=rts["replay"]._padded(
        1500), captures=made, arrays_differ=json.dumps(differ),
        tables_equal=same_tables, exhaustion_raised=raised,
        scene_untouched=untouched, active_bricks_after=active)
    if made != 1 or differ or not same_tables:
        raise AssertionError("the 1,500-voxel batch differs between the "
                             "routes or did not capture once")
    if not (raised and untouched and active == 4):
        raise AssertionError("the capacity guard did not hold the scene")
    return dict(captures=made, exhaustion_raised=raised)


def stream_routes(dev, c5):
    """Phase 21c: config 5's terrain, its first slab (half of the width
    `build_config5` streams at once), streamed
    (`stream_into_engine`) into empty engines of its geometry through the
    edit graphs and op by op, in turns: voxels/s and captures of each, and
    the two scenes bit for bit."""
    import itertools
    import types

    import torch

    from zig_vulkan_tpu_torch.config import GridConfig
    from zig_vulkan_tpu_torch.core.grid import BrickGrid
    from zig_vulkan_tpu_torch.core.materials import terrain_materials
    from zig_vulkan_tpu_torch.engine.engine import VoxelRT
    from zig_vulkan_tpu_torch.io import streaming

    st = c5.rt.grid_static
    gcfg = GridConfig(brick_alloc=st.brick_alloc, base_t=st.base_t,
                      min_point=st.min_point, scale=st.scale)
    rates, made, last = {"replay": [], "op_by_op": []}, {}, {}
    for name in ROUTE_TURNS:
        last.pop(name, None)
        grid = BrickGrid(st.dim_x, st.dim_y, st.dim_z, gcfg)
        rt = VoxelRT(grid, terrain_materials(), c5.rt.config, device=dev)
        engine = (rt if name == "replay" else
                  types.SimpleNamespace(insert_voxels=rt.insert_voxels_op_by_op))
        regions = itertools.islice(
            streaming.terrain_regions(grid, region_x=st.dim_x // 2), 1)
        torch.cuda.synchronize()
        c0 = captures()
        t0 = time.perf_counter()
        n = streaming.stream_into_engine(engine, regions)
        torch.cuda.synchronize()
        rates[name].append(n / (time.perf_counter() - t0))
        made[name] = captures() - c0
        last[name] = rt
    differ = scene_differs(last["replay"].arrays, last["op_by_op"].arrays)
    out = dict(voxels=n, voxels_per_s=rates, captures=made,
               padded_sizes=list(last["replay"]._edit_cache),
               arrays_differ=differ)
    log("edits", case="config 5's first slab streamed",
        **{k: json.dumps(v, separators=(",", ":")) if isinstance(
            v, (list, dict)) else v for k, v in out.items()})
    if differ or made["op_by_op"] != 0 or made["replay"] < 1:
        raise AssertionError("the streamed scenes differ between the routes "
                             "or the captures are wrong")
    return out


def idle_share(busy_ms, wall_ms, streams):
    """{"idle_share": 1 - busy / wall} for a step on one stream, else {}:
    the traced union of several streams' (or cards') intervals can exceed
    the untraced wall time, so a share there would mislead."""
    return {"idle_share": 1 - busy_ms / wall_ms} if streams == 1 else {}


def shard_case(label, n, routes, unsharded, move, want_captures):
    """Phase 21d, one mesh: the capture call, then frames moved between
    calls, each as a replay, op by op and the unsharded replayed frame, bit
    for bit; ms of each in turns; a trace of the replays (busy ms, the idle
    share on one shard, kernel A and B launches a step on the card) beside
    the op-by-op step's launches through the wrappers (each a launch on the
    card)."""
    import torch

    c0 = captures()
    first = routes["replay"]()
    torch.cuda.synchronize()
    made = captures() - c0
    equal = [bool(torch.equal(first, unsharded()))]
    for _ in range(2):
        move()
        got, want = routes["replay"](), routes["op_by_op"]()
        equal.append(bool(torch.equal(got, want))
                     and bool(torch.equal(got, unsharded())))
    runs = dict(routes, unsharded=unsharded)
    times = {name: [] for name in runs}
    for name in ("op_by_op", "replay", "unsharded", "unsharded", "replay",
                 "op_by_op"):
        times[name] += step_times(runs[name], SHARD_FRAMES)
    traced = {"replay": device_trace(routes["replay"], SHARD_TRACE)}
    reset_counts()
    routes["op_by_op"]()
    wrapped = read_counts()
    out = dict(shards=n, captures=made, bit_equal=all(equal),
               frames_compared=len(equal))
    for name in runs:
        dev_ms, wall_ms = (float(np.median(v)) for v in zip(*times[name]))
        out[name] = dict(median_device_ms=dev_ms, median_wall_ms=wall_ms)
        if name in traced:
            t = traced[name]
            out[name].update(
                device_busy_ms=t["busy_ms"],
                **idle_share(t["busy_ms"], wall_ms, n),
                device_events=t["events"],
                launches_A=t["launches"]["A_all"],
                launches_B=t["launches"]["B"], htod_copies=t["htod"])
    out["op_by_op"].update(launches_A=wrapped["A_all"],
                           launches_B=wrapped["B"])
    log("shards", case=label, shards=n, captures=made,
        bit_equal=out["bit_equal"], frames_compared=len(equal))
    for name in runs:
        log("shards", case=label, shards=n, route=name, **{
            k: (f"{v:.4f}" if isinstance(v, float) else v)
            for k, v in out[name].items()})
    launches = {name: (out[name]["launches_A"], out[name]["launches_B"])
                for name in routes}
    if not out["bit_equal"]:
        raise AssertionError(f"{label} over {n} shards: a replay differs "
                             f"from op by op or from the unsharded frame")
    if made != want_captures or launches["replay"] != launches["op_by_op"]:
        raise AssertionError(f"{label} over {n} shards: {made} captures "
                             f"(expected {want_captures}), launches "
                             f"{launches}")
    return out


def shard_routes(dev, rt, c5):
    """Phase 21d: the sharded step over 1, 2 and 4 shards of the card, the
    default frame (phase 15b's: the engine `rt`'s) and config 5's frame
    through `Config5.sharded_step`. Returns {(case, shards): numbers}."""
    from zig_vulkan_tpu_torch.ops import trace
    from zig_vulkan_tpu_torch.parallel import mesh as pmesh

    card = pmesh.make_mesh([dev]).devices[0]
    out = {}

    def move_default():
        rt.camera.turn_yaw(0.02)
        rt.camera.translate(0.05, [0.0, 0.0, -1.0])
        rt.update_sun(0.5)

    def move_config5():
        c5.rt.camera.turn_yaw(0.02)

    rt.render()
    for n in MESH_SIZES:
        step, args, tables = sharded_default_step(rt, [card] * n)

        def frame(route, step=step, args=args, tables=tables):
            d, sun = rt.camera.d_camera, rt.sun.device_data
            return route(*args[:2], trace.camera_vectors(d, "cpu"),
                         sun.position, sun.color, sun.radius, tables=tables)

        routes = {"replay": lambda frame=frame, step=step: frame(step),
                  "op_by_op": lambda frame=frame, step=step:
                  frame(step.op_by_op)}
        out[("default frame", n)] = shard_case(
            "default frame", n, routes, rt.render, move_default, 2 * n)
    c5.rt.render()
    for n in MESH_SIZES:
        run = c5.sharded_step([card] * n)
        out[("config 5", n)] = shard_case(
            "config 5", n, {"replay": run, "op_by_op": run.op_by_op},
            c5.rt.render, move_config5, n)
    return out


def default_frame_trace(dev, scene, cfg):
    """`--default-frame-trace`: the default frame through `VoxelRT.render()`
    with the camera moving, 5 timed frames (host clock to a synchronize)
    and a trace of TRACE_FRAMES more: device-busy ms, idle share, device
    events, kernels and host-to-device copies a frame."""
    import torch

    from zig_vulkan_tpu_torch.engine.engine import VoxelRT

    rt = VoxelRT(scene.grid, scene.materials, cfg, device=dev)

    def frame():
        rt.camera.turn_yaw(0.02)
        rt.camera.translate(0.05, [0.0, 0.0, -1.0])
        return rt.render()

    for _ in range(2):
        frame()
    torch.cuda.synchronize()
    wall = []
    for _ in range(5):
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    t = device_trace(frame, TRACE_FRAMES)
    wall_ms = float(np.median(wall))
    log("trace", frame="VoxelRT.render(), default EngineConfig",
        median_wall_ms=f"{wall_ms:.3f}", device_busy_ms=f"{t['busy_ms']:.3f}",
        idle_share=f"{1 - t['busy_ms'] / wall_ms:.4f}",
        device_events=t["events"], kernels=t["kernels"],
        htod_copies=t["htod"], htod_pageable=t["htod_pageable"],
        copies=json.dumps(t["copies"], separators=(",", ":")))


def png_size(path):
    """(width, height) from a PNG's IHDR chunk."""
    head = Path(path).read_bytes()[:24]
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise AssertionError(f"{path} is not a PNG")
    return struct.unpack(">II", head[16:24])


def sub_rays(origin, n_side=ORACLE_SIDE, width=1920, height=1080):
    """An n_side x n_side subgrid of the 1080p camera rays from a pose
    (tests/test_parity_at_scale.py:31-44), as numpy (origins, dirs)."""
    from zig_vulkan_tpu_torch.config import CameraConfig
    from zig_vulkan_tpu_torch.core.camera import Camera

    cam = Camera(75.0, width, height, CameraConfig(origin=tuple(origin)))
    d = cam.d_camera
    xs = np.linspace(0, width - 1, n_side, dtype=np.float32)
    ys = np.linspace(0, height - 1, n_side, dtype=np.float32)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    u = (gx / np.float32(width - 1)).ravel()
    v = (gy / np.float32(height - 1)).ravel()
    rd = (d.horizontal * u[:, None] + d.lower_left_corner
          + d.vertical * v[:, None] - d.origin).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ro = np.broadcast_to(d.origin, rd.shape).astype(np.float32).copy()
    return ro, rd


def frame_launches_per_level(rt):
    """Kernel A launches per bounce level of a frame: the scatter ray, and
    the sun ray unless it is off."""
    return 2 if rt.sun.device_data.enabled else 1


def _clone(v):
    import torch

    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, tuple):
        return tuple(_clone(a) for a in v)
    return v


@contextlib.contextmanager
def capturing(module, name, store, keep=()):
    """Replace `module.name` with a wrapper that appends (args, kwargs) of
    each call to `store`, tensors cloned except the positional arguments in
    `keep`, and calls the original. The wrapper shares the original's
    attributes (its launch counts)."""
    real = getattr(module, name)

    def wrapper(*args, **kw):
        store.append(([a if i in keep else _clone(a)
                       for i, a in enumerate(args)],
                      {k: _clone(v) for k, v in kw.items()}))
        return real(*args, **kw)

    wrapper.__dict__ = real.__dict__
    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, real)


HIT_KEYS = ("found", "t", "px", "py", "pz", "nx", "ny", "nz", "index")


def check_frame_launches(label, frame, want_a, want_b):
    """One call of `frame()` with its launches of kernels A and B captured
    (an engine frame through `render_op_by_op`: a graph's replay calls no
    wrapper); each launch is then replayed on its own inputs, on its own
    device, and
    held bit for bit against its plain version (kernel B also against
    `torch.index_select`). `want_a` and `want_b` are the launches the frame
    must make. The replays move the launch counts: call it outside a
    counted run. Returns (the frame, the largest difference found, one
    dict per kernel A launch, the captured kernel B inputs)."""
    import torch

    from zig_vulkan_tpu_torch.ops import lookup, tile_tracer, trace

    cap_a, cap_b = [], []
    with capturing(tile_tracer, "grid_hit_tiles", cap_a, keep=(0, 1, 2)), \
            capturing(trace, "table_lookup", cap_b, keep=(0,)):
        image = frame()
    if len(cap_a) != want_a or len(cap_b) != want_b:
        raise AssertionError(f"{label}: captured {len(cap_a)} A and "
                             f"{len(cap_b)} B launches, expected {want_a} "
                             f"and {want_b}")
    err, rows, differ = 0.0, [], []
    for i, (args, kw) in enumerate(cap_a):
        keys = HIT_KEYS + (("occluded",) if kw.get("shadow_targets") else ())
        got = tile_tracer.grid_hit_tiles(*args, **kw)
        bad, e, same = mismatches(
            got, tile_tracer.grid_hit_plain(*args, **kw), keys)
        err = max(err, e)
        if not same:
            differ.append({f"A launch {i}": bad})
        rows.append(dict(
            lanes=int(args[9].numel()), active=int(args[9].sum()),
            keyed=kw.get("ray_key") is not None, device=str(args[9].device),
            hits=int(got["found"].sum()),
            emissive=int((got["found"] & (got["index"] == EMISSIVE)).sum())))
    for i, (args, kw) in enumerate(cap_b):
        mats, idx = args
        got = torch.stack(lookup.table_lookup(mats, idx))
        plain = lookup._table_lookup_plain(mats, idx)
        err = max(err, (got - plain).abs().max().item())
        if not (torch.equal(got, plain)
                and torch.equal(got, torch.index_select(mats, 1, idx))):
            differ.append({f"B launch {i}": int((got != plain).sum())})
    log(f"{label}: launches against plain", A=len(cap_a), B=len(cap_b),
        lanes_A=json.dumps(sorted({r["lanes"] for r in rows})),
        lanes_B=json.dumps(sorted({int(a[1].numel()) for a, _ in cap_b})),
        max_abs_err=err, differ=json.dumps(differ, separators=(",", ":")))
    if differ:
        raise AssertionError(f"{label}: a kernel launch differs from its "
                             f"plain version")
    return image, err, rows, [args for args, _ in cap_b]


TRACE_MARK = "chip_smoke: traced calls"


def device_trace(fn, frames):
    """The card's intervals in a `torch.profiler` trace of `frames` calls of
    `fn`: {"busy_ms": the union of the kernel, copy and memset intervals a
    call, "events": those intervals a call, "htod": host-to-device copies a
    call, "htod_pageable": those from pageable memory, "kernels": kernels a
    call, "copies": {copy or memset kind: count a call}, "launches": kernel
    A and B launches a call (`card_counts`)}. One call runs
    first, synchronized, outside the counted range (a trace's first
    device records may be lost). The intervals are the card's own; the
    host runs slower under the profiler, so an idle share is taken against
    wall time that was measured without it."""
    import collections

    import torch

    from zig_vulkan_tpu_torch.utils import profiling

    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace_session(tmp):
            fn()
            torch.cuda.synchronize()
            with torch.profiler.record_function(TRACE_MARK):
                for _ in range(frames):
                    fn()
                torch.cuda.synchronize()
        events = json.loads(Path(tmp, profiling.TRACE_FILE)
                            .read_text())["traceEvents"]
    start = min(e["ts"] for e in events if e.get("name") == TRACE_MARK)
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
           and e["ts"] >= start]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev)
    if not spans:
        raise AssertionError("the trace shows no activity on the card")
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    htod = [e["name"] for e in dev
            if e["cat"] == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    copies = collections.Counter(e["name"] for e in dev
                                 if e["cat"] != "kernel")
    launches = profiling.kernel_launches(e["name"] for e in dev
                                         if e["cat"] == "kernel")
    return dict(busy_ms=busy / 1e3 / frames, events=len(spans) / frames,
                launches=card_counts(launches, frames),
                htod=len(htod) / frames,
                htod_pageable=sum("Pageable" in n for n in htod) / frames,
                kernels=sum(e["cat"] == "kernel" for e in dev) / frames,
                copies={k: v / frames for k, v in sorted(copies.items())})


def frame_kernels(rt, reps: int = FRAME_REPS):
    """Phase 6b: the kernel A and kernel B launches of one frame of `rt`'s
    step run op by op, captured and replayed one by one: each against its plain version, bit
    for bit; device time warm and after an L2 flush; for A, the stats
    build's steps over the active lanes, the warp-use shares (lanes in
    launch order, and the active lanes packed together), and the launch's
    time with no lane live, with only its slowest 1% of rays live and
    through the builds that divide (its own check and time); for B,
    `torch.index_select`'s time on the same inputs; each launch's bound.
    Returns {"A": [...], "B": [...]}, one dict per launch."""
    import torch

    from zig_vulkan_tpu_torch.ops import lookup, tile_tracer, trace
    from zig_vulkan_tpu_torch.utils import roofline

    cap_a, cap_b = [], []
    with capturing(tile_tracer, "grid_hit_tiles", cap_a, keep=(0, 1, 2)), \
            capturing(trace, "table_lookup", cap_b, keep=(0,)):
        rt.render_op_by_op()
    levels = int(rt.camera.d_camera.max_bounce)
    per = frame_launches_per_level(rt)
    if len(cap_a) != levels * per or len(cap_b) != levels:
        raise AssertionError(f"captured {len(cap_a)} A and {len(cap_b)} B "
                             f"launches of one frame")
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                        device=rt.device)
    keys = ("found", "t", "px", "py", "pz", "nx", "ny", "nz", "index")
    rows = {"A": [], "B": []}
    for i, (args, kw) in enumerate(cap_a):
        active = args[9]
        n = int(active.numel())
        keyed = kw.get("ray_key") is not None
        label = (f"level {i // per} "
                 f"{'scatter' if i % per == 0 else 'shadow'}"
                 f"{' keyed' if keyed else ''}")

        def run(plain=False, **extra):
            fn = (tile_tracer.grid_hit_plain if plain
                  else tile_tracer.grid_hit_tiles)
            return fn(*args, **dict(kw, **extra))

        got = run()
        compare_exact(f"frame launch A {label}", got, run(plain=True), keys)
        n_step = run(stats=True)["n_step"]
        act = n_step[active].float()
        hits = int(got["found"].sum())
        iters = int(n_step.sum())
        bound, by = roofline.traverse_bound_ms(n, hits, iters, has_key=keyed)
        p99 = torch.quantile(act, 0.99).item() if act.numel() else 0.0
        # the same launch with no ray live (the reads and writes of every
        # lane), and with only its slowest 1% of rays live (what the longest
        # chains of dependent steps add)
        tail = roofline.slowest_lanes(n_step, active)

        def run_live(live):
            return tile_tracer.grid_hit_tiles(*args[:9], live, *args[10:],
                                              **kw)

        # the same launch through the builds that divide: the records at a
        # cell size of 0.3, no power of two
        odd = [dataclasses.replace(args[0], scale=0.3), *args[1:]]

        def run_dividing(plain=False):
            fn = (tile_tracer.grid_hit_plain if plain
                  else tile_tracer.grid_hit_tiles)
            return fn(*odd, **kw)

        compare_exact(f"frame launch A {label}, dividing build",
                      run_dividing(), run_dividing(plain=True), keys)

        row = dict(
            launch=label, lanes=n, active=int(active.sum()), hits=hits,
            mean_steps=act.mean().item() if act.numel() else 0.0,
            p99_steps=p99, max_steps=int(n_step.max()),
            warp_use_share=roofline.warp_use_share(n_step.cpu().numpy()),
            warp_use_share_packed=roofline.warp_use_share(
                n_step[active].cpu().numpy()),
            ms=device_ms(run, reps), ms_l2_flushed=device_ms(run, reps, flush),
            ms_none_live=device_ms(
                lambda: run_live(torch.zeros_like(active)), reps),
            tail_lanes=int(tail.sum()),
            ms_tail_only=device_ms(lambda: run_live(tail), reps),
            ms_dividing=device_ms(run_dividing, reps),
            bound_ms=bound, bound_by=by)
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        rows["A"].append(row)
        log("frame A", **{k: (f"{v:.5f}" if isinstance(v, float) else v)
                          for k, v in row.items()})
    for i, (args, kw) in enumerate(cap_b):
        mats, idx = args
        got = torch.stack(lookup.table_lookup(mats, idx))
        lib = torch.index_select(mats, 1, idx)
        if not (torch.equal(got, lookup._table_lookup_plain(mats, idx))
                and torch.equal(got, lib)):
            raise AssertionError(f"kernel B on frame launch {i} differs from "
                                 f"its plain version or index_select")
        bound, by = roofline.bound_ms(roofline.lookup_bytes(
            int(idx.numel()), *mats.shape))
        row = dict(
            launch=f"level {i}", lanes=int(idx.numel()),
            ms=device_ms(lambda: lookup.table_lookup(mats, idx), reps),
            ms_l2_flushed=device_ms(lambda: lookup.table_lookup(mats, idx),
                                    reps, flush),
            library_ms=device_ms(lambda: torch.index_select(mats, 1, idx),
                                 reps),
            library_ms_l2_flushed=device_ms(
                lambda: torch.index_select(mats, 1, idx), reps, flush),
            bound_ms=bound, bound_by=by)
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        rows["B"].append(row)
        log("frame B", **{k: (f"{v:.5f}" if isinstance(v, float) else v)
                          for k, v in row.items()})
    return rows


def oracle_parity(dev, scene, rt, poses_1080):
    """Phase 12: kernel A's NO_SKIP and default builds against the numpy
    oracle on the default scene (`scene`, host arrays; `rt` its engine),
    exact-path frames against `oracle.render`, and NO_SKIP against the
    default build on the 1080p primary rays `poses_1080`."""
    import torch

    from zig_vulkan_tpu_torch.config import (CameraConfig, DenoiserConfig,
                                             EngineConfig, SunConfig,
                                             TraceConfig)
    from zig_vulkan_tpu_torch.core.camera import Camera
    from zig_vulkan_tpu_torch.core.materials import MAT_NONE
    from zig_vulkan_tpu_torch.core.sun import Sun
    from zig_vulkan_tpu_torch.engine.engine import VoxelRT
    from zig_vulkan_tpu_torch.models import scenes
    from zig_vulkan_tpu_torch.ops import lookup, tile_tracer, trace
    from zig_vulkan_tpu_torch.oracle import cpu_tracer as oracle

    st = rt.grid_static
    osc = oracle.OracleScene(st, scene.grid.arrays, scene.materials)
    skip_tables = rt.tables()
    exact_tables = trace.build_trace_tables(
        st, rt.arrays, trace.no_skip_field(st, rt.arrays))
    mat_idx = rt.arrays.material_indices
    keys = ("found", "t", "px", "py", "pz", "nx", "ny", "nz", "index")

    def hit(rays, active, exact, plain=False, **kw):
        fn = tile_tracer.grid_hit_plain if plain else tile_tracer.grid_hit_tiles
        return fn(st, exact_tables if exact else skip_tables, mat_idx, *rays,
                  active, use_skip=not exact, **kw)

    t0 = time.perf_counter()
    total = flips = 0
    for i in ORACLE_POSES:
        ro, rd = sub_rays(PATH_POINTS[i])
        n = ro.shape[0]
        o = oracle.grid_hit(osc, ro, rd, np.float32(1e-5), np.float32(np.inf),
                            np.full(n, MAT_NONE, np.int32),
                            np.ones(n, np.float32), np.ones(n, bool))
        rays = tuple(torch.from_numpy(np.ascontiguousarray(a[:, k])).to(dev)
                     for a in (ro, rd) for k in range(3))
        on = torch.ones(n, dtype=torch.bool, device=dev)
        ex = hit(rays, on, exact=True)
        compare_exact(f"NO_SKIP build oracle pose {i}", ex,
                      hit(rays, on, exact=True, plain=True), keys)
        sk = hit(rays, on, exact=False)
        compare_exact(f"default build oracle pose {i}", sk,
                      hit(rays, on, exact=False, plain=True), keys)
        ef, et, ei = (ex[k].cpu().numpy() for k in ("found", "t", "index"))
        both = ef & o.found
        dt = np.abs(et[both] - o.t[both])
        t_ok = bool(np.all(dt <= 1e-4 + 1e-5 * np.abs(o.t[both])))
        found_bad = int((ef != o.found).sum())
        index_bad = int((ei[both] != o.index[both]).sum())
        sf, stt = sk["found"].cpu().numpy(), sk["t"].cpu().numpy()
        sboth = sf & o.found
        pose_flips = int((sf != o.found).sum()
                         + (np.abs(stt[sboth] - o.t[sboth]) >= 1e-2).sum())
        total += n
        flips += pose_flips
        log("oracle", pose=list(PATH_POINTS[i]), rays=n,
            oracle_hits=int(o.found.sum()), exact_found_mismatch=found_bad,
            exact_index_mismatch=index_bad,
            exact_max_dt=float(dt.max()) if dt.size else 0.0,
            exact_t_within_tol=t_ok, skip_flips=pose_flips)
        if found_bad or index_bad or not t_ok:
            raise AssertionError(f"NO_SKIP build differs from the oracle at "
                                 f"pose {PATH_POINTS[i]}")
    flip_rate = flips / total
    log("oracle", rays=total, skip_flip_rate=f"{flip_rate:.6f}",
        bound=0.005, seconds=f"{time.perf_counter() - t0:.2f}")
    if flip_rate >= 0.005:
        raise AssertionError("the default build flips more than 0.5% of the "
                             "oracle's hits")

    def frame_diff(got, want):
        d = np.abs(got - want).max(axis=-1)
        return (float((d > 1e-3).mean()), float(d.mean()), float(d.max()),
                float((got - want).mean()))

    # RGB of the exact path on the parity scene, tests/test_trace_parity.py's
    # bound
    t0 = time.perf_counter()
    psc = scenes.small_test_scene()
    parr = psc.grid.arrays.to_device(dev)
    pst = psc.grid.static
    pcam = Camera(75.0, 48, 48, CameraConfig(origin=(4.0, 6.5, 15.0)))
    psun = Sun(SunConfig(enabled=True)).device_data
    ptab = trace.build_trace_tables(pst, parr, trace.no_skip_field(pst, parr))
    img = trace.render_rows(
        pst, ptab, parr.material_indices, trace.materials_to_device(psc.materials, dev),
        trace.camera_vectors(pcam.d_camera, dev), 48, 48,
        pcam.d_camera.samples_per_pixel, pcam.d_camera.max_bounce,
        psun.position, psun.color, psun.radius, True,
        use_skip=False).cpu().numpy()
    want = oracle.render(oracle.OracleScene(pst, psc.grid.arrays,
                                            psc.materials),
                         pcam.d_camera, psun)
    share, mean, mx, signed = frame_diff(img, want)
    log("oracle rgb", scene="parity", resolution="48x48", spp=2,
        bounce_levels=int(pcam.d_camera.max_bounce),
        share_over_1e_3=f"{share:.6f}", mean_abs=f"{mean:.3e}",
        max_abs=f"{mx:.4f}", bound="share < 0.01, mean < 5e-3")
    if share >= 0.01 or mean >= 5e-3:
        raise AssertionError("exact-path parity frame differs from the "
                             "oracle")

    # RGB of the exact path on the default scene, through the engine (the
    # NO_SKIP build's main path: launches counted from 0 over these frames;
    # each engine's one frame is its step's capture frame, whose run and
    # capture go through the wrappers)
    w, h = RGB_RES
    counts = {"exact": 0, "other_A": 0, "B": 0, "expected_A": 0,
              "expected_B": 0, "captures": 0}
    path_frame_launches = None
    for i in RGB_POSES:
        origin = tuple(float(v) for v in PATH_POINTS[i])
        for primary in (True, False):
            camera = (CameraConfig(origin=origin, samples_per_pixel=1,
                                   max_bounce=0) if primary
                      else CameraConfig(origin=origin))
            ert = VoxelRT(scene.grid, scene.materials, EngineConfig(
                internal_resolution_width=w, internal_resolution_height=h,
                camera=camera, sun=SunConfig(enabled=not primary),
                denoiser=DenoiserConfig(enabled=False),
                trace=TraceConfig(empty_skip=False)), device=dev)
            ert.tables()
            tile_tracer.reset_launch_counts()
            lookup.table_lookup.launches = 0
            c0 = captures()
            img = ert.render()
            torch.cuda.synchronize()
            a = tile_tracer.grid_hit_tiles
            counts["exact"] += a.build_launches["exact"]
            counts["other_A"] += a.launches - a.build_launches["exact"]
            counts["B"] += lookup.table_lookup.launches
            counts["captures"] += captures() - c0
            levels = int(ert.camera.d_camera.max_bounce)
            counts["expected_A"] += 2 * levels * frame_launches_per_level(ert)
            counts["expected_B"] += 2 * levels
            if not primary and path_frame_launches is None:
                # a replayed path-traced frame, traced on the card
                path_frame_launches = card_launches(ert.render)["exact"]
            got = img.cpu().numpy()
            want = oracle.render(osc, ert.camera.d_camera, ert.sun.device_data)
            share, mean, mx, signed = frame_diff(got, want)
            ref_share, ref_mean = RGB_REFERENCE[i]
            log("oracle rgb", scene="default", pose=list(PATH_POINTS[i]),
                frame="primary" if primary else "path-traced",
                resolution=f"{w}x{h}",
                spp=int(ert.camera.d_camera.samples_per_pixel),
                bounce_levels=levels, share_over_1e_3=f"{share:.6f}",
                mean_abs=f"{mean:.3e}", max_abs=f"{mx:.4f}",
                signed_mean=f"{signed:.2e}",
                bound=("max < 1e-5" if primary else
                       f"share < {ref_share}, mean < {ref_mean} (the JAX "
                       f"package vs its oracle), |signed mean| < 2e-3"))
            ok = np.isfinite(got).all() and got.shape == want.shape
            if primary:
                ok = ok and mx < 1e-5
            else:
                ok = (ok and share < ref_share and mean < ref_mean
                      and abs(signed) < 2e-3)
            if not ok:
                raise AssertionError(f"exact-path frame differs from the "
                                     f"oracle at pose {PATH_POINTS[i]}")
    log("oracle rgb", launches=json.dumps(counts, separators=(",", ":")),
        seconds=f"{time.perf_counter() - t0:.2f}")
    if (counts["exact"] != counts["expected_A"] or counts["other_A"]
            or counts["B"] != counts["expected_B"]
            or counts["captures"] != 2 * len(RGB_POSES)
            or path_frame_launches != 2 * 3):
        raise AssertionError(f"unexpected launch counts {counts}, "
                             f"{path_frame_launches} exact launches a "
                             f"replayed path-traced frame")

    # NO_SKIP against the default build on the 1080p primary rays, in turns
    hon = torch.ones(poses_1080[0][0].shape[0], dtype=torch.bool, device=dev)

    def pass_ms(exact):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for rays in poses_1080:
            hit(rays, hon, exact)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / len(poses_1080)

    hit(poses_1080[0], hon, True)  # warm
    times = {True: [], False: []}
    for exact in (False, True, True, False):
        times[exact].append(pass_ms(exact))
    exact_ms, skip_ms = (float(np.mean(times[k])) for k in (True, False))
    counted = {k: hit(poses_1080[0], hon, k, stats=True)
               for k in (True, False)}
    steps = {k: step_stats(v["n_step"]) for k, v in counted.items()}
    got = hit(poses_1080[0], hon, True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = hit(poses_1080[0], hon, True, plain=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = compare_exact("NO_SKIP build 1080p pose 0", got, want, keys)
    log("oracle", rays=int(hon.numel()), poses=len(poses_1080),
        no_skip_ms_per_pose=f"{exact_ms:.3f}",
        default_ms_per_pose=f"{skip_ms:.3f}",
        no_skip_mrays_per_s=f"{hon.numel() / exact_ms / 1e3:.1f}",
        steps_per_ray_no_skip=f"mean {steps[True][0]:.2f} "
        f"p99 {steps[True][1]:.0f}",
        steps_per_ray_default=f"mean {steps[False][0]:.2f} "
        f"p99 {steps[False][1]:.0f}",
        no_skip_plain_ms=f"{plain_ms:.1f}")
    return dict(launches=counts["exact"],
                launches_per_frame=path_frame_launches,  # a path-traced one
                max_abs_err=err, ms=exact_ms,
                **a_bound(int(hon.numel()), counted[True],
                          counted[True]["n_step"]),
                plain_ms=plain_ms)


def app_phase(app_args):
    """Phase 13: the app's `main` in each mode, in this process."""
    import torch

    from zig_vulkan_tpu_torch.app import run as app_run
    from zig_vulkan_tpu_torch.ops import lookup, tile_tracer
    from zig_vulkan_tpu_torch.utils import profiling

    engines = []
    build = app_run.build_engine

    def keep(args):
        engines.append(build(args))
        return engines[-1]

    def run(*extra, capture=False):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with (contextlib.redirect_stdout(buf) if capture
              else contextlib.nullcontext()):
            rc = app_run.main([*app_args, *extra])
        torch.cuda.synchronize()
        if rc != 0:
            raise AssertionError(f"app {' '.join(extra)} exited with {rc}")
        return buf.getvalue(), time.perf_counter() - t0, engines[-1]

    app_run.build_engine = keep
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tile_tracer.reset_launch_counts()
            lookup.table_lookup.launches = 0
            c0 = captures()
            _, secs, rt = run("--frames", "8", "--out", f"{tmp}/frames")
            made = captures() - c0
            a = tile_tracer.grid_hit_tiles
            launches = {"A": a.build_launches["default"], "A_all": a.launches,
                        "B": lookup.table_lookup.launches}
            pngs = sorted(Path(tmp, "frames").glob("frame_*.png"))
            sizes = sorted({png_size(p) for p in pngs})
            levels = int(rt.camera.d_camera.max_bounce)
            per = levels * frame_launches_per_level(rt)
            log("app", mode="frames", frames=len(pngs), png_sizes=sizes,
                captures=made,
                launches=json.dumps(launches, separators=(",", ":")),
                seconds=f"{secs:.2f}")
            if len(pngs) != 8 or sizes != [rt.output_resolution]:
                raise AssertionError("the app did not write 8 frames of the "
                                     "output size")
            # 8 frames of one step: its capture frame's run and capture
            # through the wrappers, then 7 replays
            if made != 1 or launches != {"A": 2 * per, "A_all": 2 * per,
                                         "B": 2 * levels}:
                raise AssertionError(f"unexpected app launches {launches} "
                                     f"over {made} captures")

            _, secs, rt = run("--script", "demo", "--frames", "8")
            ft = np.asarray(rt.metrics.frame_times) * 1e3
            log("app", mode="script demo", frames=len(ft),
                median_frame_ms=f"{np.median(ft[1:]):.3f}",
                frame0_ms=f"{ft[0]:.3f}", seconds=f"{secs:.2f}",
                origin=np.round(rt.camera.d_camera.origin, 3).tolist())
            if len(ft) != 8 or not np.isfinite(ft).all():
                raise AssertionError("the scripted run recorded no frames")

            report, secs, rt = run("--benchmark", "--benchmark-duration",
                                   "60", "--frames", "12", capture=True)
            print(report, end="", flush=True)
            log("app", mode="benchmark", seconds=f"{secs:.2f}")
            if "BENCHMARK REPORT" not in report:
                raise AssertionError("the benchmark printed no report")

            _, secs, rt = run("--profile", f"{tmp}/prof", "--frames", "3")
            trace = json.loads(Path(tmp, "prof", profiling.TRACE_FILE)
                               .read_text())
            events = trace["traceEvents"]
            names = {e.get("name") for e in events}
            zones = [z for z in ("draw", "render_step", "device_sync",
                                 "build_tables") if z in names]
            kernels = sum(1 for e in events if e.get("cat") == "kernel")
            log("app", mode="profile", zones=zones, trace_events=len(events),
                cuda_kernel_events=kernels, seconds=f"{secs:.2f}")
            if not {"draw", "render_step"} <= set(zones):
                raise AssertionError("the trace lacks the draw/render_step "
                                     "zones")

            out, secs, rt = run("--live", "--frames", "3", capture=True)
            log("app", mode="live", paints=out.count("\x1b[H"),
                bytes=len(out), seconds=f"{secs:.2f}")
            if out.count("\x1b[H") != 3:
                raise AssertionError("the live viewer did not paint 3 frames")
    finally:
        app_run.build_engine = build


_FIELDS = ("statuses", "indices", "occupancy", "start_indices",
           "material_indices", "active_bricks", "material_cursor",
           "diel_mask", "brick_ir")


def host_io(dev, scene, rt8, cfg):
    """Phase 14: save/load of phase 8's edited scene (`rt8`), the file
    format, the scene cache, terrain streaming and the native builder."""
    import dataclasses

    import torch

    from zig_vulkan_tpu_torch.config import GridConfig
    from zig_vulkan_tpu_torch.core.grid import BrickGrid, dense_materials
    from zig_vulkan_tpu_torch.core.materials import terrain_materials
    from zig_vulkan_tpu_torch.engine.engine import VoxelRT
    from zig_vulkan_tpu_torch.io import (native_builder, scene_io, streaming,
                                         terrain)
    from zig_vulkan_tpu_torch.models import scenes

    def raw(t):
        return t.reshape(-1).view(torch.uint8)

    with tempfile.TemporaryDirectory() as tmp:
        # the round trip; the frames run the exact DDA, which reads the
        # scene arrays only (an edited scene's skip field is the
        # conservative one; a reload rebuilds the exact one)
        rt8.trace_config = dataclasses.replace(rt8.trace_config,
                                               empty_skip=False)
        before = rt8.render()
        torch.cuda.synchronize()
        arrays = rt8.arrays
        path = f"{tmp}/edited.npz"
        t0 = time.perf_counter()
        rt8.save_scene(path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        grid, _ = scene_io.load_scene(path)
        rt8.flush_grid(grid)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        same = [f for f in _FIELDS
                if torch.equal(raw(getattr(rt8.arrays, f)),
                               raw(getattr(arrays, f)))]
        after = rt8.render()
        torch.cuda.synchronize()
        identical = bool(torch.equal(before, after))
        log("io", round_trip_file_bytes=Path(path).stat().st_size,
            save_seconds=f"{save_s:.2f}", load_flush_seconds=f"{load_s:.2f}",
            arrays_equal=f"{len(same)}/{len(_FIELDS)}",
            next_frame_bit_identical=identical,
            frame=list(after.shape))
        if len(same) != len(_FIELDS) or not identical:
            raise AssertionError("save/load/flush changed the scene or frame")

        # the same file through plain numpy: the JAX package's format
        with np.load(path) as z:
            keys = set(z.files)
            bad = {k: str(z[k].dtype) for k, dt in SCENE_FILE_DTYPES.items()
                   if k in keys and z[k].dtype != dt}
            statuses = bool(np.array_equal(
                z["statuses"], arrays.statuses.cpu().numpy().view(np.uint32)))
            active = int(z["active_bricks"])
        log("io", numpy_keys_match=keys == set(SCENE_FILE_DTYPES),
            dtype_mismatches=json.dumps(bad), statuses_equal=statuses,
            active_bricks=active)
        if keys != set(SCENE_FILE_DTYPES) or bad or not statuses:
            raise AssertionError("the scene file is not the JAX format")

        # the scene cache: cold build and save, then a load
        cache = f"{tmp}/scene_cache.npz"
        t0 = time.perf_counter()
        cold = scenes.cached_default_scene(cache)
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        warm = scenes.cached_default_scene(cache)
        warm_s = time.perf_counter() - t0
        cache_same = all(np.array_equal(
            np.atleast_1d(np.asarray(getattr(warm.grid.arrays, f))).view(
                np.uint8),
            np.atleast_1d(np.asarray(getattr(cold.grid.arrays, f))).view(
                np.uint8)) for f in _FIELDS)
        log("io", cache_cold_build_seconds=f"{cold_s:.2f}",
            cache_load_seconds=f"{warm_s:.2f}",
            cache_bytes=Path(cache).stat().st_size, cache_equal=cache_same)
        if not cache_same:
            raise AssertionError("the cached scene differs from the build")

    # terrain streamed into an empty engine of the scene's geometry
    st = scene.grid.static
    gcfg = GridConfig(brick_alloc=st.brick_alloc, base_t=st.base_t,
                      min_point=st.min_point, scale=st.scale)
    empty = BrickGrid(st.dim_x, st.dim_y, st.dim_z, gcfg)
    mats = terrain_materials()
    srt = VoxelRT(empty, mats, cfg, device=dev)
    batch_s = []
    insert = srt.insert_voxels

    def timed_insert(xyz, material_index):
        t = time.perf_counter()
        insert(xyz, material_index)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t)

    srt.insert_voxels = timed_insert
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    total = streaming.stream_into_engine(
        srt, streaming.terrain_regions(empty, seed=420, scale=4.0,
                                       ocean_level=20),
        max_batch=STREAM_BATCH)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    host = BrickGrid(st.dim_x, st.dim_y, st.dim_z, gcfg)
    host.attach_materials(mats)
    terrain.generate(host, seed=420, scale=4.0, ocean_level=20)
    host_s = time.perf_counter() - t0
    want = dense_materials(st, host.arrays.to_device(dev))
    streamed_same = bool(torch.equal(dense_materials(st, srt.arrays), want))
    log("stream", voxels=total, batches=len(batch_s),
        seconds=f"{stream_s:.2f}", voxels_per_s=f"{total / stream_s:.0f}",
        median_batch_ms=f"{np.median(batch_s) * 1e3:.1f}",
        max_batch_ms=f"{max(batch_s) * 1e3:.1f}", peak_bytes=peak,
        host_build_seconds=f"{host_s:.2f}", equals_host_build=streamed_same)
    if not streamed_same or total != int((want >= 0).sum()):
        raise AssertionError("the streamed terrain differs from the host "
                             "build")

    # the native C++ builder, where the machine has g++
    t0 = time.perf_counter()
    if not native_builder.native_available():
        log("native", available=False,
            note="no g++ on this machine; the native builder was not run")
        return
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nb = native_builder.NativeGridBuilder(st.dim_x, st.dim_y, st.dim_z, gcfg)
    nb.generate_terrain(seed=420, scale=4.0, ocean_level=20)
    ngrid = nb.finish()
    native_s = time.perf_counter() - t0
    native_same = bool(torch.equal(
        dense_materials(st, ngrid.arrays.to_device(dev)), want))
    log("native", available=True, compile_seconds=f"{build_s:.2f}",
        terrain_seconds=f"{native_s:.2f}", threads=nb.threads,
        equals_numpy_build=native_same)
    if not native_same:
        raise AssertionError("the native builder's terrain differs")


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--default-frame-trace"]):
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from zig_vulkan_tpu_torch.config import EngineConfig
    from zig_vulkan_tpu_torch.models import scenes

    dev = torch.device("cuda")
    if argv:
        card = device_and_build()
        default_frame_trace(dev, scenes.default_scene(), EngineConfig())
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    return smoke(dev, scenes.default_scene, EngineConfig())


def device_and_build():
    """Phases 1 and 2; returns the card's nvidia-smi line."""
    import torch

    from zig_vulkan_tpu_torch import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0].strip()
    print(card, flush=True)
    log("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)
    t0 = time.perf_counter()
    _build.library(force_build=True)
    log("build", seconds=f"{time.perf_counter() - t0:.2f}",
        nvcc_seconds=f"{_build.build_seconds:.2f}")
    for name, row in ptxas_summary(_build.build_log).items():
        log("build", kernel=name, **row)
    return card


def ptxas_summary(text):
    """{kernel build: registers, spill store bytes and, for kernel A, the
    warps an SM holds at 128 threads a block} from nvcc's -Xptxas -v
    output."""
    import re

    from zig_vulkan_tpu_torch.ops.tile_tracer import _build_name

    rows, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            t = re.search(r"traverse_kernelILb([01])ELb([01])ELb([01])E"
                          r"Lb([01])E", m[1])
            name = (f"A {_build_name(t[1] == '1', t[2] == '1', t[3] == '1')}"
                    f"{' pow2' if t[4] == '1' else ''}"
                    if t else "B aligned" if "lookup_kernelILb1E" in m[1]
                    else "B" if "lookup_kernel" in m[1] else m[1])
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and name:
            rows.setdefault(name, {})["spill_stores"] = int(m[1])
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            regs = int(m[1])
            rows.setdefault(name, {})["registers"] = regs
            if name.startswith("A "):
                # registers allocated 256 to a warp, at most 64 warps
                per_warp = -(-regs * 32 // 256) * 256
                rows[name]["warps_per_sm"] = min(64, 65536 // per_warp // 4 * 4)
    return rows


def headline_poses(dev, headline, poses_n):
    """The 1920x1080 primary rays of the fly-through path's first points."""
    from zig_vulkan_tpu_torch.config import CameraConfig
    from zig_vulkan_tpu_torch.core.camera import Camera
    from zig_vulkan_tpu_torch.ops import trace

    w, h = headline
    hcam = Camera(75.0, w, h, CameraConfig(origin=(0.0, 0.0, 0.0)))
    poses = []
    for p in PATH_POINTS[:poses_n]:
        hcam.d_camera.origin = np.asarray(p, dtype=np.float32)
        hcam.propagate_pitch_change()
        r = trace._camera_rays_soa(trace.camera_vectors(hcam.d_camera, dev),
                                   w, h, 0)
        ndx, ndy, ndz = trace._norm3(r[3], r[4], r[5])
        poses.append(tuple(a.contiguous() for a in (*r[:3], ndx, ndy, ndz)))
    return poses


def smoke(dev, make_scene, cfg, headline=(1920, 1080), frames: int = FRAMES,
          poses_n: int = HEADLINE_POSES, edit_frames: int = EDIT_FRAMES,
          app_args=(), scale: float = 1.0) -> int:
    """The phases on the scene `make_scene()` builds, at `cfg` (main()
    passes the default scene and EngineConfig); `app_args` go before the
    app's flags in phase 13 (none: the app's defaults); `scale` sizes the
    BASELINE configs of phases 16 and 17 as benchmarks/configs.py's does
    (1.0: their full widths)."""
    import torch

    t_start = time.perf_counter()
    from zig_vulkan_tpu_torch.config import CameraConfig, SunConfig
    from zig_vulkan_tpu_torch.core.camera import Camera
    from zig_vulkan_tpu_torch.core.sun import Sun
    from zig_vulkan_tpu_torch.engine.engine import VoxelRT
    from zig_vulkan_tpu_torch.models import scenes
    from zig_vulkan_tpu_torch.ops import lookup, tile_tracer, trace
    from zig_vulkan_tpu_torch.utils import roofline

    results = {}

    # -- 1. device, 2. build -----------------------------------------------------
    card = device_and_build()

    # -- 3. kernel A against its plain version -------------------------------------
    t0 = time.perf_counter()
    scene = make_scene()
    log("scene", voxels="x".join(map(str, scene.grid.static.voxel_dims)),
        host_build_seconds=f"{time.perf_counter() - t0:.2f}")
    rt = VoxelRT(scene.grid, scene.materials, cfg, device=dev)
    t0 = time.perf_counter()
    tables = rt.tables()
    torch.cuda.synchronize()
    log("tables", cells=tables.shape[0],
        seconds=f"{time.perf_counter() - t0:.2f}")
    static = rt.grid_static
    mat_idx = rt.arrays.material_indices

    def hit(rays, active, key, plain=False):
        fn = trace._grid_hit_soa if plain else tile_tracer.grid_hit_tiles
        return fn(static, tables, mat_idx, *rays, active, ray_key=key,
                  max_steps=cfg.trace.max_steps)

    # the frame's primary wavefront: 2 jittered samples at 1024x576
    iw, ih = cfg.internal_resolution_width, cfg.internal_resolution_height
    cam = trace.camera_vectors(rt.camera.d_camera, dev)
    samples = [trace._camera_rays_soa(cam, iw, ih, float(s))
               for s in range(cfg.camera.samples_per_pixel)]
    ox, oy, oz, dx, dy, dz = (torch.cat([s[i] for s in samples])
                              for i in range(6))
    dx, dy, dz = trace._norm3(dx, dy, dz)
    primary = tuple(a.contiguous() for a in (ox, oy, oz, dx, dy, dz))
    n = primary[0].shape[0]
    all_on = torch.ones(n, dtype=torch.bool, device=dev)
    want_p = hit(primary, all_on, None, plain=True)
    got_p = hit(primary, all_on, None)
    torch.cuda.synchronize()
    max_dt = compare_hits("primary", got_p, want_p, all_on)

    # bounce-like rays: random outward directions from the primary hits
    rng = np.random.default_rng(0)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = torch.from_numpy(d).to(dev)
    nrm = torch.stack([want_p["nx"], want_p["ny"], want_p["nz"]], -1)
    d = torch.where((d * nrm).sum(-1, keepdim=True) < 0, -d, d)
    bounce = (want_p["px"], want_p["py"], want_p["pz"],
              d[:, 0].contiguous(), d[:, 1].contiguous(), d[:, 2].contiguous())
    live = want_p["found"].contiguous()
    want_b = hit(bounce, live, None, plain=True)
    got_b = hit(bounce, live, None)
    torch.cuda.synchronize()
    max_dt = max(max_dt, compare_hits("bounce", got_b, want_b, live))

    # the same rays keyed with the water's ir on half the lanes
    key_np = np.where(rng.random(n) < 0.5, np.float32(1.333),
                      np.float32(np.nan)).astype(np.float32)
    key = torch.from_numpy(key_np).to(dev)
    want_k = hit(bounce, live, key, plain=True)
    got_k = hit(bounce, live, key)
    torch.cuda.synchronize()
    max_dt = max(max_dt, compare_hits("bounce_keyed", got_k, want_k, live))
    skipped = int((live & want_b["found"] & (want_b["index"] == 0)
                   & ~torch.isnan(key)).sum())
    log("kernel A", keyed_lanes_that_hit_water_unkeyed=skipped)
    # the builds that divide (a cell size that is no power of two): the
    # primary and keyed bounce rays on the same records at 0.3 a cell
    odd = dataclasses.replace(static, scale=0.3)
    for name, rays, act, k in (("primary", primary, all_on, None),
                               ("bounce_keyed", bounce, live, key)):
        got_o, want_o = (fn(odd, tables, mat_idx, *rays, act, ray_key=k,
                            max_steps=cfg.trace.max_steps)
                         for fn in (tile_tracer.grid_hit_tiles,
                                    trace._grid_hit_soa))
        compare_exact(f"kernel A dividing build, {name}", got_o, want_o,
                      ("found", "t", "px", "py", "pz", "nx", "ny", "nz",
                       "index"))

    a_ms = cuda_ms(lambda: hit(primary, all_on, None), reps=5)
    a_plain_ms = cuda_ms(lambda: hit(primary, all_on, None, plain=True),
                         reps=1)
    log("kernel A", shape=f"{n} rays (primary wavefront)",
        ms=f"{a_ms:.3f}", plain_ms=f"{a_plain_ms:.3f}")
    counted = tile_tracer.grid_hit_tiles(static, tables, mat_idx, *primary,
                                         all_on, stats=True,
                                         max_steps=cfg.trace.max_steps)
    results["A"] = dict(max_abs_err=max_dt, ms=a_ms, plain_ms=a_plain_ms,
                        **a_bound(n, got_p, counted["n_step"]))

    # -- 4. kernel B against its plain version -------------------------------------
    lut = rt.mats
    idx = torch.from_numpy(
        rng.integers(0, lut.shape[1], n).astype(np.int32)).to(dev)
    got = torch.stack(lookup.table_lookup(lut, idx))
    want = lut[:, idx.long()]
    torch.cuda.synchronize()
    b_err = (got - want).abs().max().item()
    b_ms = cuda_ms(lambda: lookup.table_lookup(lut, idx), reps=20)
    b_plain_ms = cuda_ms(lambda: lookup._table_lookup_plain(lut, idx), reps=20)
    # one PyTorch call for the same function (the indices are in range);
    # timed as a yardstick only
    b_lib_ms = cuda_ms(lambda: torch.index_select(lut, 1, idx), reps=20)
    log("kernel B", lanes=n, tables=lut.shape[0], max_abs_err=b_err,
        exact=bool(torch.equal(got, want)), ms=f"{b_ms:.4f}",
        index_select_ms=f"{b_lib_ms:.4f}",
        plain_ms=f"{b_plain_ms:.4f}")
    if not torch.equal(got, want):
        raise AssertionError("kernel B disagrees with its plain version")
    b_bound, b_by = roofline.bound_ms(roofline.lookup_bytes(n, *lut.shape))
    results["B"] = dict(max_abs_err=b_err, ms=b_ms, plain_ms=b_plain_ms,
                        bound_ms=b_bound, bound_by=b_by, library_ms=b_lib_ms)

    # -- 5. golden parity on the card ----------------------------------------------
    golden = np.load(REPO / "tests" / "golden" / "flat_scene_renders.npz")
    gsc = scenes.small_test_scene()
    garr = gsc.grid.arrays.to_device(dev)
    gtab = trace.build_trace_tables(gsc.grid.static, garr)
    gmats = trace.materials_to_device(gsc.materials, dev)
    for name, spp, mb, sun_on in (("primary", 1, 0, False),
                                  ("path_sun", 2, 2, True)):
        gcam = Camera(75.0, 48, 48, CameraConfig(
            origin=(4.0, 6.5, 15.0), samples_per_pixel=spp, max_bounce=mb))
        sun = Sun(SunConfig(enabled=sun_on)).device_data
        img = trace.render_rows(
            gsc.grid.static, gtab, garr.material_indices, gmats,
            trace.camera_vectors(gcam.d_camera, dev), 48, 48, spp,
            gcam.d_camera.max_bounce, sun.position, sun.color, sun.radius,
            sun_on).cpu().numpy()
        diff = np.abs(img - golden[name]).max(axis=-1)
        log("golden", image=name, max_abs=float(diff.max()),
            mean_abs=float(diff.mean()),
            share_over_1e_3=float((diff > 1e-3).mean()))
        if name == "primary":
            ok = diff.max() <= 1e-5
        else:
            ok = diff.mean() < 5e-3 and (diff > 1e-3).mean() < 0.01
        if not ok:
            raise AssertionError(f"golden {name} out of tolerance")

    # -- 6. the main path ----------------------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tile_tracer.reset_launch_counts()
    lookup.table_lookup.launches = 0
    c0 = captures()
    rt.draw()  # warm-up frame: the step's capture

    def move_and_draw():
        rt.camera.turn_yaw(0.02)
        rt.camera.translate(0.05, [0.0, 0.0, -1.0])
        return rt.draw()

    frame_ms = []
    image = None
    for _ in range(frames):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        image = move_and_draw()
        end.record()
        torch.cuda.synchronize()
        frame_ms.append(start.elapsed_time(end))
    # the wrappers launched the capture frame's kernels twice (its run and
    # its capture); the replays call no wrapper
    launches = {"A": tile_tracer.grid_hit_tiles.build_launches["default"],
                "B": lookup.table_lookup.launches}
    made = captures() - c0
    if tile_tracer.grid_hit_tiles.launches != launches["A"]:
        raise AssertionError("the default frame launched another build of A")
    peak = torch.cuda.max_memory_allocated()
    frames += 1  # with the warm-up
    # what a replayed frame runs on the card, from a trace of two
    on_card = card_launches(move_and_draw, 2)
    img = image.cpu().numpy()
    colours = len(np.unique((img * 255).astype(np.uint8).reshape(-1, 3),
                            axis=0))
    log("frame", frames=frames, median_ms=f"{np.median(frame_ms):.3f}",
        min_ms=f"{min(frame_ms):.3f}", max_ms=f"{max(frame_ms):.3f}",
        peak_bytes=peak, captures=made, launches_A=launches["A"],
        launches_B=launches["B"], replayed_frame_on_card_A=on_card["A_all"],
        replayed_frame_on_card_B=on_card["B"],
        shape=list(img.shape), distinct_colours=colours,
        min=float(img.min()), max=float(img.max()))
    if img.shape != (ih, iw, 3) or not np.isfinite(img).all():
        raise AssertionError("frame has the wrong shape or non-finite values")
    if img.min() < 0.0 or img.max() > 1.0 or colours <= 64:
        raise AssertionError("frame out of [0, 1] or nearly uniform")
    if made != 1 or launches != {"A": 2 * 6, "B": 2 * 3}:
        raise AssertionError(f"expected one capture of 6 A and 3 B launches "
                             f"(its run and its capture), got {made} and "
                             f"{launches}")
    if (on_card["A"], on_card["A_all"], on_card["B"]) != (6, 6, 3):
        raise AssertionError(f"expected 6 A and 3 B launches a replayed "
                             f"frame on the card, got {on_card}")

    # -- 6b. the frame's kernel launches, one by one --------------------------------
    t0 = time.perf_counter()
    frame_rows = frame_kernels(rt)
    log("frame kernels", phase_seconds=f"{time.perf_counter() - t0:.2f}")

    # -- 7. headline analogue: primary rays at 1920x1080 ---------------------------
    w, h = headline
    poses = headline_poses(dev, headline, poses_n)
    hon = torch.ones(w * h, dtype=torch.bool, device=dev)
    hit(poses[-1], hon, None)  # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(HEADLINE_PASSES):
        for rays in poses:
            hit(rays, hon, None)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (HEADLINE_PASSES * len(poses))
    got_h = hit(poses[0], hon, None)
    t0 = time.perf_counter()
    want_h = hit(poses[0], hon, None, plain=True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    compare_hits("headline_pose0", got_h, want_h, hon)
    log("headline", rays=w * h, poses=len(poses), passes=HEADLINE_PASSES,
        kernel_ms_per_pose=f"{ms:.3f}",
        mrays_per_s=f"{w * h / ms / 1e3:.1f}",
        plain_ms_per_pose=f"{plain_s * 1e3:.1f}")

    # -- 8. the edit fly-through (BASELINE config 3) ------------------------------
    t0 = time.perf_counter()
    edit = edit_flythrough(dev, scene, scale, edit_frames)
    log("edit", phase_seconds=f"{time.perf_counter() - t0:.2f}")

    # -- 9. the sun-shadow probe at the default EngineConfig -----------------------
    shadow = shadow_probe(rt, primary, all_on, (bounce, live, key))

    # -- 10. temporal accumulation and set_resolutions ----------------------------
    temporal(rt)

    # -- 11. the whole fly-through ------------------------------------------------
    fly_counts = flythrough(dev, scene, iw, ih)

    # -- 12. oracle parity on the card, kernel A's NO_SKIP build --------------------
    t0 = time.perf_counter()
    exact = oracle_parity(dev, scene, rt, poses)
    log("oracle", phase_seconds=f"{time.perf_counter() - t0:.2f}")

    # -- 13. the app ---------------------------------------------------------------
    t0 = time.perf_counter()
    app_phase(app_args)
    log("app", phase_seconds=f"{time.perf_counter() - t0:.2f}")

    # -- 14. host I/O ---------------------------------------------------------------
    t0 = time.perf_counter()
    host_io(dev, scene, edit["engine"], cfg)
    log("io", phase_seconds=f"{time.perf_counter() - t0:.2f}")

    # -- 15. the mesh ---------------------------------------------------------------
    t0 = time.perf_counter()
    mesh_counts = mesh_phase(dev, rt)
    log("mesh", phase_seconds=f"{time.perf_counter() - t0:.2f}")

    # -- 16. BASELINE config 5 ------------------------------------------------------
    t0 = time.perf_counter()
    big, c5 = config5(dev, scale)
    log("config 5", phase_seconds=f"{time.perf_counter() - t0:.2f}")

    # -- 17. BASELINE configs 1, 2 and 4 --------------------------------------------
    t0 = time.perf_counter()
    config_counts = baseline_configs(dev, scene, scale)
    log("configs", phase_seconds=f"{time.perf_counter() - t0:.2f}")

    # -- 18. the headline bench, 19. the entry step ---------------------------------
    bench_counts = headline_bench(dev, scale)
    entry_counts = entry_step(dev)

    # -- 20. the compiled step ---------------------------------------------------------
    t0 = time.perf_counter()
    steps = compiled_step(dev, scene, cfg, c5, scale)
    log("step", phase_seconds=f"{time.perf_counter() - t0:.2f}")
    default_step = steps["default frame"]

    # -- 21. the compiled edit path and shards ------------------------------------------
    t0 = time.perf_counter()
    edit_rts, edits21 = edit_routes(dev, scene, scale)
    edge_batches(dev, edit_rts)
    del edit_rts
    stream21 = stream_routes(dev, c5)
    shards21 = shard_routes(dev, rt, c5)
    log("edits and shards", phase_seconds=f"{time.perf_counter() - t0:.2f}")
    widest = shards21[("default frame", max(MESH_SIZES))]
    shard_launches = {
        route: {k: widest[route][f"launches_{k}"] / max(MESH_SIZES)
                for k in ("A", "B")} for route in ("replay", "op_by_op")}
    # the default build's and kernel B's launches of phases 11, 15, 17, 18
    # and 19 (config 5's stand in rows of their own)
    later = {k: sum(c[k] for c in (fly_counts, mesh_counts, config_counts,
                                   bench_counts, entry_counts))
             for k in ("A", "B")}
    for name in ("A", "B"):
        # phases 17 and 19 held launches of their shapes against the plain
        # versions
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                           config_counts["max_abs_err"],
                                           entry_counts["max_abs_err"])
    per_frame = {k: [config_counts["per_frame"][c][k] for c in (1, 2, 4)]
                 for k in ("A", "B")}

    src_a = "zig_vulkan_tpu_torch/csrc/traverse.cu"
    kernels = [
        # launches: through the wrapper, in the main path's run (its step's
        # run and capture) and the later phases', as counted; a replay calls
        # no wrapper. launches_per_frame: a replayed frame that runs the
        # build, on the card in a profiler trace (the default frame; config
        # 3's edit frame for the sprayed scene; a sun_in_kernel frame; none
        # for the diagnostic stats build; a path-traced empty_skip=False
        # frame); launches_per_replayed_frame and _per_op_by_op_frame: phase
        # 20's traces of the default frame
        dict(name="traverse (kernel A, default build)", route="cuda",
             source=src_a, replaces="zig_vulkan_tpu/ops/tile_tracer.py:367",
             launches=launches["A"] + later["A"],
             launches_per_frame=on_card["A"],
             launches_per_replayed_frame=default_step["replay"]["launches_A"],
             launches_per_op_by_op_frame=default_step["op_by_op"][
                 "launches_A"],
             launches_per_shard_of_a_sharded_frame=mesh_counts["per_shard"][
                 "A"],
             launches_per_shard_of_a_sharded_replay=shard_launches[
                 "replay"]["A"],
             launches_per_shard_of_a_sharded_op_by_op_frame=shard_launches[
                 "op_by_op"]["A"],
             launches_per_frame_configs_1_2_4=per_frame["A"],
             frame_launch_ms=[r["ms"] for r in frame_rows["A"]],
             **results["A"]),
        dict(name="traverse (kernel A, default build on config 5's 4K "
             "wavefront)", route="cuda", source=src_a,
             replaces="zig_vulkan_tpu/ops/tile_tracer.py:367",
             **big["A"]),
        dict(name="traverse (kernel A, default build on the sprayed scene, "
             "for the sparse_roam build)", route="cuda", source=src_a,
             replaces="zig_vulkan_tpu/ops/tile_tracer.py:595",
             **edit["sprayed"]),
        dict(name="traverse (kernel A, shadow build)", route="cuda",
             source=src_a, replaces="zig_vulkan_tpu/ops/tile_tracer.py:381",
             **shadow),
        dict(name="traverse (kernel A, stats build)", route="cuda",
             source=src_a, replaces="zig_vulkan_tpu/ops/tile_tracer.py:377",
             **edit["stats"]),
        dict(name="traverse (kernel A, NO_SKIP build: the exact DDA of "
             "TraceConfig(empty_skip=False))", route="cuda", source=src_a,
             replaces="zig_vulkan_tpu/ops/trace.py:388",
             **exact),
        dict(name="table_lookup (kernel B)", route="cuda",
             source="zig_vulkan_tpu_torch/csrc/lookup.cu",
             replaces="zig_vulkan_tpu/ops/lookup.py:29",
             launches=launches["B"] + later["B"],
             launches_per_frame=on_card["B"],
             launches_per_replayed_frame=default_step["replay"]["launches_B"],
             launches_per_op_by_op_frame=default_step["op_by_op"][
                 "launches_B"],
             launches_per_shard_of_a_sharded_frame=mesh_counts["per_shard"][
                 "B"],
             launches_per_shard_of_a_sharded_replay=shard_launches[
                 "replay"]["B"],
             launches_per_shard_of_a_sharded_op_by_op_frame=shard_launches[
                 "op_by_op"]["B"],
             launches_per_frame_configs_1_2_4=per_frame["B"],
             frame_launch_ms=[r["ms"] for r in frame_rows["B"]],
             **results["B"]),
        dict(name="table_lookup (kernel B on config 5's 4K frame)",
             route="cuda", source="zig_vulkan_tpu_torch/csrc/lookup.cu",
             replaces="zig_vulkan_tpu/ops/lookup.py:29", **big["B"]),
    ]
    for k in kernels:
        k.setdefault("library_ms", None)  # no PyTorch call traces a DDA
        k["share_of_bound"] = k["bound_ms"] / k["ms"]
    log("done", script_seconds=f"{time.perf_counter() - t_start:.2f}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
