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
   fly-through path's points, in Mray/s.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

FRAMES = 10
HEADLINE_POSES = 10
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
          poses_n: int = HEADLINE_POSES) -> int:
    """The phases on the scene `make_scene()` builds, at `cfg` (main()
    passes the default scene and EngineConfig)."""
    import torch

    from zig_vulkan_tpu_torch import _build
    from zig_vulkan_tpu_torch.config import CameraConfig, SunConfig
    from zig_vulkan_tpu_torch.core.camera import Camera
    from zig_vulkan_tpu_torch.core.sun import Sun
    from zig_vulkan_tpu_torch.engine.engine import VoxelRT
    from zig_vulkan_tpu_torch.models import scenes
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
    gsc = scenes.flat_test_scene(dim=8)
    xs, zs = np.meshgrid(np.arange(6, 16), np.arange(6, 16), indexing="ij")
    gsc.grid.insert_batch(xs.ravel(), np.full(xs.size, 4), zs.ravel(),
                          np.zeros(xs.size, dtype=np.uint8))
    ys = np.arange(4, 12)
    gsc.grid.insert_batch(np.full(ys.size, 20), ys, np.full(ys.size, 20),
                          np.full(ys.size, 7, dtype=np.uint8))
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
    tile_tracer.grid_hit_tiles.launches = 0
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
    launches = {"A": tile_tracer.grid_hit_tiles.launches,
                "B": lookup.table_lookup.launches}
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
    for rays in poses:
        hit(rays, hon, None)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / len(poses)
    got_h = hit(poses[0], hon, None)
    t0 = time.perf_counter()
    want_h = hit(poses[0], hon, None, plain=True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    compare_hits("headline_pose0", got_h, want_h, hon)
    log("headline", rays=w * h, poses=len(poses),
        kernel_ms_per_pose=f"{ms:.3f}",
        mrays_per_s=f"{w * h / ms / 1e3:.1f}",
        plain_ms_per_pose=f"{plain_s * 1e3:.1f}")

    kernels = [
        dict(name="traverse (kernel A)", route="cuda",
             source="zig_vulkan_tpu_torch/csrc/traverse.cu",
             replaces="zig_vulkan_tpu/ops/tile_tracer.py:367",
             launches=launches["A"], **results["A"]),
        dict(name="table_lookup (kernel B)", route="cuda",
             source="zig_vulkan_tpu_torch/csrc/lookup.cu",
             replaces="zig_vulkan_tpu/ops/lookup.py:29",
             launches=launches["B"], **results["B"]),
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
