#!/usr/bin/env python3
"""Drive zig_vulkan_tpu_torch's main path once on an NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA GPU

The quickest proof that the port builds and runs on the card. Every phase
prints one line of numbers and raises on failure, so the script exits
non-zero if any phase fails:

1. device: the card's name and power limit (nvidia-smi);
2. build: compile csrc/*.cu (kernels A and B) with nvcc;
3. kernel A (traversal) against its plain torch version on the card, on
   the default 512x256x512 scene: the frame's primary wavefront,
   bounce-like rays from its hit points, and the same rays with a
   dielectric key;
4. kernel B (material lookup) against its plain torch version;
5. golden parity: the 48x48 flat-scene renders of
   tests/golden/flat_scene_renders.npz rendered on the card;
6. the main path: `VoxelRT(...).draw()` at the default EngineConfig
   (1024x576, 2 spp, max_bounce 2, sun, denoiser) on the default scene,
   with the kernels' launch counts;
7. headline analogue: 1920x1080 primary rays through kernel A over the
   fly-through path's points (three passes), in Mray/s;
8. the edit fly-through (BASELINE config 3, benchmarks/configs.py:117-148):
   1920x1080, 1 spp, max_bounce 1, animated sun, no denoiser, max_steps
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
11. the fly-through harness: `run_benchmark(fixed_dt=0.5)` prints the
    reference's report;
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

The line before the last is a JSON object with one entry per kernel build;
the last line is {"ok": true, "device": {...}}. Imports no JAX.
"""

from __future__ import annotations

import contextlib
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
EDIT_VOXELS = 512    # voxels per batch (benchmarks/configs.py:132)
PROBE_FRAMES = 3     # timed default frames per group in phase 9 (2 groups
                     # per variant)
TEMPORAL_FRAMES = 5
BENCH_FRAMES = 12
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
    """Mean device time of `fn` over `reps` calls, by CUDA events."""
    import torch

    fn()  # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def step_stats(n_step):
    """Mean and p99 of per-ray loop iterations."""
    import torch

    s = n_step.float()
    return s.mean().item(), torch.quantile(s, 0.99).item()


def compare_exact(name, got, want, keys):
    """A kernel build against its plain version, bit for bit."""
    import torch

    bad = {k: int((got[k] != want[k]).sum()) for k in keys}
    log(name, lanes=int(want["found"].numel()),
        hits=int(want["found"].sum()),
        mismatches=json.dumps(bad, separators=(",", ":")))
    if any(bad.values()) or not all(torch.equal(got[k], want[k])
                                    for k in keys):
        raise AssertionError(f"{name}: the kernel disagrees with its plain "
                             f"version")


def edit_flythrough(dev, scene, res, frames):
    """Phase 8: BASELINE config 3 on a fresh device copy of `scene`."""
    import copy

    import torch

    from zig_vulkan_tpu_torch.config import (CameraConfig, DenoiserConfig,
                                             EngineConfig, SunConfig,
                                             TraceConfig)
    from zig_vulkan_tpu_torch.core.grid import dense_materials
    from zig_vulkan_tpu_torch.engine.engine import VoxelRT
    from zig_vulkan_tpu_torch.ops import lookup, tile_tracer, trace

    w, h = res
    max_steps = 160
    cfg = EngineConfig(
        internal_resolution_width=w, internal_resolution_height=h,
        camera=CameraConfig(origin=(0.0, 0.0, 0.0), samples_per_pixel=1,
                            max_bounce=1),
        sun=SunConfig(enabled=True, animate=True),
        denoiser=DenoiserConfig(enabled=False),
        trace=TraceConfig(max_steps=max_steps))
    host = copy.deepcopy(scene.grid)  # the host replay of every edit
    rt = VoxelRT(scene.grid, scene.materials, cfg, device=dev)
    st = rt.grid_static
    rt.tables()
    bench = rt.create_benchmark(duration=60.0)
    rng = np.random.default_rng(0)
    vx, vy, vz = st.voxel_dims
    replay = []

    def move(insert):
        # benchmarks/configs.py:132-141, the same random stream
        bench.update(0.016)
        rt.update_sun(0.016)
        n = EDIT_VOXELS
        xyz = np.stack([rng.integers(0, vx, n), rng.integers(0, vy, n),
                        rng.integers(0, vz, n)], axis=-1)
        if insert:
            mats = rng.integers(1, 8, n).astype(np.uint8)
            replay.append((xyz, mats))
            return lambda: rt.insert_voxels(xyz, mats)
        replay.append((xyz, None))
        return lambda: rt.remove_voxels(xyz)

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

    # warm both edit paths outside the timing (benchmarks/configs.py:52-62)
    for insert in (True, False):
        move(insert)()
        rt.render()
        torch.cuda.synchronize()
        if insert:
            fractions.append(rt.nonempty_region_fraction())

    torch.cuda.reset_peak_memory_stats()
    tile_tracer.reset_launch_counts()
    lookup.table_lookup.launches = 0
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
    peak = torch.cuda.max_memory_allocated()
    img = image.cpu().numpy()
    log("edit", frames=frames, resolution=f"{w}x{h}",
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
    if launches != {"A": 4 * frames, "A_all": 4 * frames, "B": 2 * frames}:
        raise AssertionError(f"expected 4 A and 2 B launches per edit frame, "
                             f"got {launches} over {frames} frames")
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
        max_steps=max_steps)
    compare_exact("stats build", after, hit(prim, on, plain=True, stats=True),
                  ("found", "t", "index", "n_step"))
    want_p = hit(prim, on, plain=True)
    compare_exact("sprayed primary", hit(prim, on), want_p,
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
    compare_exact("sprayed bounce", hit(bounce, live), want_b, tuple(want_b))
    sprayed_ms = cuda_ms(lambda: hit(prim, on), reps=5)
    sprayed_plain_ms = cuda_ms(lambda: hit(prim, on, plain=True), reps=1)
    stats_ms = cuda_ms(lambda: hit(prim, on, stats=True), reps=5)
    stats_plain_ms = cuda_ms(lambda: hit(prim, on, plain=True, stats=True),
                             reps=1)
    log("edit", kernel_a_primary_ms_clean=f"{clean_ms:.3f}",
        kernel_a_primary_ms_sprayed=f"{sprayed_ms:.3f}",
        plain_ms_sprayed=f"{sprayed_plain_ms:.1f}",
        stats_build_ms=f"{stats_ms:.3f}", stats_plain_ms=f"{stats_plain_ms:.1f}")
    return dict(
        sprayed=dict(launches=launches["A"], max_abs_err=0.0, ms=sprayed_ms,
                     plain_ms=sprayed_plain_ms),
        stats=dict(launches=stats_launches, max_abs_err=0.0, ms=stats_ms,
                   plain_ms=stats_plain_ms),
        engine=rt)


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
    compare_exact("shadow build primary", hit(rays, active, shadow_targets=tg),
                  want, keys)
    occ_share = want["occluded"][want["found"]].float().mean().item()
    krays, kactive, kkey = key
    ktg = trace.sun_targets(krays[3], krays[4], krays[5], sun.position, radius)
    compare_exact("shadow build keyed bounce",
                  hit(krays, kactive, ray_key=kkey, shadow_targets=ktg),
                  hit(krays, kactive, plain=True, ray_key=kkey,
                      shadow_targets=ktg), keys)
    ms = cuda_ms(lambda: hit(rays, active, shadow_targets=tg), reps=5)
    plain_ms = cuda_ms(lambda: hit(rays, active, plain=True,
                                   shadow_targets=tg), reps=1)
    log("shadow", occluded_share_of_hits=f"{occ_share:.4f}",
        shadow_build_ms=f"{ms:.3f}", plain_ms=f"{plain_ms:.3f}")

    base = rt.trace_config
    images = {}
    ms_lists = {False: [], True: []}
    counts = {False: {}, True: {}}
    # in turns (separate, in kernel, in kernel, separate): the frames are
    # host-bound and drift between groups
    for probe in (False, True, True, False):
        rt.trace_config = dataclasses.replace(base, sun_in_kernel=probe)
        rt.draw()  # warm-up
        tile_tracer.reset_launch_counts()
        lookup.table_lookup.launches = 0
        for _ in range(PROBE_FRAMES):
            e0, e1, _ = frame_events()
            e0.record()
            images[probe] = rt.draw()
            e1.record()
            torch.cuda.synchronize()
            ms_lists[probe].append(e0.elapsed_time(e1))
        for name, n in dict(tile_tracer.grid_hit_tiles.build_launches,
                            B=lookup.table_lookup.launches).items():
            counts[probe][name] = counts[probe].get(name, 0) + n
    rt.trace_config = base
    timing = {k: float(np.median(v)) for k, v in ms_lists.items()}
    diff = (images[True] - images[False]).abs().amax(-1)
    share = (diff > 1e-3).float().mean().item()
    log("shadow", frame_ms_separate=f"{timing[False]:.3f}",
        frame_ms_in_kernel=f"{timing[True]:.3f}",
        frames_each=2 * PROBE_FRAMES,
        launches_separate=json.dumps(counts[False], separators=(",", ":")),
        launches_in_kernel=json.dumps(counts[True], separators=(",", ":")),
        share_over_1e_3=share,
        bit_equal=bool(torch.equal(images[True], images[False])))
    if share >= 0.01:
        raise AssertionError("sun_in_kernel frame differs from the separate "
                             "shadow launches")
    f = 2 * PROBE_FRAMES
    if (counts[True]["shadow"] != 3 * f or counts[True]["default"] != 0
            or counts[False]["default"] != 6 * f or counts[False]["shadow"]
            or counts[True]["B"] != 3 * f):
        raise AssertionError(f"unexpected launch counts {counts}")
    return dict(launches=counts[True]["shadow"], max_abs_err=0.0, ms=ms,
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


def flythrough(rt):
    """Phase 11: the fly-through harness prints the reference's report."""
    t0 = time.perf_counter()
    bench = rt.run_benchmark(fixed_dt=0.5, max_frames=BENCH_FRAMES)
    rep = bench.report
    log("benchmark", frames=BENCH_FRAMES, samples=rep.delta_time_sum_samples,
        avg_ms=f"{rep.average() * 1e3:.3f}",
        seconds=f"{time.perf_counter() - t0:.2f}")
    if rep.delta_time_sum_samples != BENCH_FRAMES - 1 or not np.isfinite(
            rep.average()):
        raise AssertionError("benchmark report incomplete")


def parity_scene():
    """tests/test_trace_parity.py's water pool + metal pillar scene, on
    which the golden renders were made."""
    from zig_vulkan_tpu_torch.models import scenes

    sc = scenes.flat_test_scene(dim=8)
    xs, zs = np.meshgrid(np.arange(6, 16), np.arange(6, 16), indexing="ij")
    sc.grid.insert_batch(xs.ravel(), np.full(xs.size, 4), zs.ravel(),
                         np.zeros(xs.size, dtype=np.uint8))
    ys = np.arange(4, 12)
    sc.grid.insert_batch(np.full(ys.size, 20), ys, np.full(ys.size, 20),
                         np.full(ys.size, 7, dtype=np.uint8))
    return sc


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
    psc = parity_scene()
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
    # NO_SKIP build's main path: launches counted from 0 over these frames)
    w, h = RGB_RES
    counts = {"exact": 0, "other_A": 0, "B": 0, "expected_A": 0,
              "expected_B": 0}
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
            img = ert.render()
            torch.cuda.synchronize()
            a = tile_tracer.grid_hit_tiles
            counts["exact"] += a.build_launches["exact"]
            counts["other_A"] += a.launches - a.build_launches["exact"]
            counts["B"] += lookup.table_lookup.launches
            levels = int(ert.camera.d_camera.max_bounce)
            counts["expected_A"] += levels * frame_launches_per_level(ert)
            counts["expected_B"] += levels
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
            or counts["B"] != counts["expected_B"]):
        raise AssertionError(f"unexpected launch counts {counts}")

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
    steps = {k: step_stats(hit(poses_1080[0], hon, k, stats=True)["n_step"])
             for k in (True, False)}
    got = hit(poses_1080[0], hon, True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = hit(poses_1080[0], hon, True, plain=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    compare_exact("NO_SKIP build 1080p pose 0", got, want, keys)
    log("oracle", rays=int(hon.numel()), poses=len(poses_1080),
        no_skip_ms_per_pose=f"{exact_ms:.3f}",
        default_ms_per_pose=f"{skip_ms:.3f}",
        no_skip_mrays_per_s=f"{hon.numel() / exact_ms / 1e3:.1f}",
        steps_per_ray_no_skip=f"mean {steps[True][0]:.2f} "
        f"p99 {steps[True][1]:.0f}",
        steps_per_ray_default=f"mean {steps[False][0]:.2f} "
        f"p99 {steps[False][1]:.0f}",
        no_skip_plain_ms=f"{plain_ms:.1f}")
    return dict(launches=counts["exact"], max_abs_err=0.0, ms=exact_ms,
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
            _, secs, rt = run("--frames", "8", "--out", f"{tmp}/frames")
            a = tile_tracer.grid_hit_tiles
            launches = {"A": a.build_launches["default"], "A_all": a.launches,
                        "B": lookup.table_lookup.launches}
            pngs = sorted(Path(tmp, "frames").glob("frame_*.png"))
            sizes = sorted({png_size(p) for p in pngs})
            levels = int(rt.camera.d_camera.max_bounce)
            per = levels * frame_launches_per_level(rt)
            log("app", mode="frames", frames=len(pngs), png_sizes=sizes,
                launches=json.dumps(launches, separators=(",", ":")),
                seconds=f"{secs:.2f}")
            if len(pngs) != 8 or sizes != [rt.output_resolution]:
                raise AssertionError("the app did not write 8 frames of the "
                                     "output size")
            if launches != {"A": 8 * per, "A_all": 8 * per, "B": 8 * levels}:
                raise AssertionError(f"unexpected app launches {launches}")

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from zig_vulkan_tpu_torch.config import EngineConfig
    from zig_vulkan_tpu_torch.models import scenes

    return smoke(torch.device("cuda"), scenes.default_scene, EngineConfig())


def smoke(dev, make_scene, cfg, headline=(1920, 1080), frames: int = FRAMES,
          poses_n: int = HEADLINE_POSES, edit_frames: int = EDIT_FRAMES,
          app_args=()) -> int:
    """The phases on the scene `make_scene()` builds, at `cfg` (main()
    passes the default scene and EngineConfig); `app_args` go before the
    app's flags in phase 13 (none: the app's defaults)."""
    import torch

    t_start = time.perf_counter()
    from zig_vulkan_tpu_torch import _build
    from zig_vulkan_tpu_torch.config import CameraConfig, SunConfig
    from zig_vulkan_tpu_torch.core.camera import Camera
    from zig_vulkan_tpu_torch.core.sun import Sun
    from zig_vulkan_tpu_torch.engine.engine import VoxelRT
    from zig_vulkan_tpu_torch.ops import lookup, tile_tracer, trace

    results = {}

    # -- 1. device ----------------------------------------------------------------
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

    # -- 2. build -----------------------------------------------------------------
    t0 = time.perf_counter()
    _build.library(force_build=True)
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    log("build", seconds=f"{time.perf_counter() - t0:.2f}",
        nvcc_seconds=f"{_build.build_seconds:.2f}")
    for ln in ptxas:
        print(f"[build] {ln}", flush=True)

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

    a_ms = cuda_ms(lambda: hit(primary, all_on, None), reps=5)
    a_plain_ms = cuda_ms(lambda: hit(primary, all_on, None, plain=True),
                         reps=1)
    log("kernel A", shape=f"{n} rays (primary wavefront)",
        ms=f"{a_ms:.3f}", plain_ms=f"{a_plain_ms:.3f}")
    results["A"] = dict(max_abs_err=max_dt, ms=a_ms, plain_ms=a_plain_ms)

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
    log("kernel B", lanes=n, tables=lut.shape[0], max_abs_err=b_err,
        exact=bool(torch.equal(got, want)), ms=f"{b_ms:.4f}",
        plain_ms=f"{b_plain_ms:.4f}")
    if not torch.equal(got, want):
        raise AssertionError("kernel B disagrees with its plain version")
    results["B"] = dict(max_abs_err=b_err, ms=b_ms, plain_ms=b_plain_ms)

    # -- 5. golden parity on the card ----------------------------------------------
    golden = np.load(REPO / "tests" / "golden" / "flat_scene_renders.npz")
    gsc = parity_scene()
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
    rt.draw()  # warm-up frame
    frame_ms = []
    image = None
    for _ in range(frames):
        rt.camera.turn_yaw(0.02)
        rt.camera.translate(0.05, [0.0, 0.0, -1.0])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        image = rt.draw()
        end.record()
        torch.cuda.synchronize()
        frame_ms.append(start.elapsed_time(end))
    launches = {"A": tile_tracer.grid_hit_tiles.build_launches["default"],
                "B": lookup.table_lookup.launches}
    if tile_tracer.grid_hit_tiles.launches != launches["A"]:
        raise AssertionError("the default frame launched another build of A")
    peak = torch.cuda.max_memory_allocated()
    frames += 1  # with the warm-up
    img = image.cpu().numpy()
    colours = len(np.unique((img * 255).astype(np.uint8).reshape(-1, 3),
                            axis=0))
    log("frame", frames=frames, median_ms=f"{np.median(frame_ms):.3f}",
        min_ms=f"{min(frame_ms):.3f}", max_ms=f"{max(frame_ms):.3f}",
        peak_bytes=peak, launches_A=launches["A"], launches_B=launches["B"],
        shape=list(img.shape), distinct_colours=colours,
        min=float(img.min()), max=float(img.max()))
    if img.shape != (ih, iw, 3) or not np.isfinite(img).all():
        raise AssertionError("frame has the wrong shape or non-finite values")
    if img.min() < 0.0 or img.max() > 1.0 or colours <= 64:
        raise AssertionError("frame out of [0, 1] or nearly uniform")
    if launches != {"A": 6 * frames, "B": 3 * frames}:
        raise AssertionError(f"expected 6 A and 3 B launches per frame, "
                             f"got {launches} over {frames} frames")

    # -- 7. headline analogue: primary rays at 1920x1080 ---------------------------
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
    edit = edit_flythrough(dev, scene, headline, edit_frames)
    log("edit", phase_seconds=f"{time.perf_counter() - t0:.2f}")

    # -- 9. the sun-shadow probe at the default EngineConfig -----------------------
    shadow = shadow_probe(rt, primary, all_on, (bounce, live, key))

    # -- 10. temporal accumulation and set_resolutions ----------------------------
    temporal(rt)

    # -- 11. the fly-through harness ----------------------------------------------
    flythrough(rt)

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

    src_a = "zig_vulkan_tpu_torch/csrc/traverse.cu"
    kernels = [
        dict(name="traverse (kernel A, default build)", route="cuda",
             source=src_a, replaces="zig_vulkan_tpu/ops/tile_tracer.py:367",
             launches=launches["A"], **results["A"]),
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
             replaces="zig_vulkan_tpu/ops/trace.py:388", **exact),
        dict(name="table_lookup (kernel B)", route="cuda",
             source="zig_vulkan_tpu_torch/csrc/lookup.cu",
             replaces="zig_vulkan_tpu/ops/lookup.py:29",
             launches=launches["B"], **results["B"]),
    ]
    log("done", script_seconds=f"{time.perf_counter() - t_start:.2f}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
