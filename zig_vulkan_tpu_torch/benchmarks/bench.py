"""The 1080p headline bench: one JSON line.

The torch counterpart of `bench.py`. Measures primary-ray throughput at
1920x1080 on the default 512x256x512 brickmap scene through kernel A and
prints ONE JSON line:

    {"metric": "primary_ray_throughput_1080p_512^3", "value": N,
     "unit": "Mray/s", "parity_vs_oracle": p, "default_frame_ms": t,
     "default_frame_workload": "...", "kernel_a_launches_per_pose": k,
     "device": "..."}

- `value`: as the reference's timed frame, each of `frames` poses along
  the fly-through path makes its camera rays from camera vectors that were
  uploaded before the timed loop, normalizes them and traces them through
  `grid_hit_tiles` (one kernel A launch a pose); the poses are chained and
  synchronized once; the host's clock. The pose frame is compiled as the
  reference's `make_frame` is (`PoseFrame`): captured once as a CUDA graph
  that reads the pose's camera vectors from a static device buffer, then
  a device-to-device copy of each pose's vectors and a replay.
- `parity_vs_oracle`: the share of 48x48 subsampled rays of pose 0 on
  which the compiled kernel and the numpy oracle agree (same `found`, and
  `t` within 1e-2 where both hit). The skip path may flip grazing voxels
  in under 0.5% of lanes.
- `default_frame_ms`: the default workload through the engine, 12 chained
  frames with a static sun.
- `kernel_a_launches_per_pose`: kernel A launches of one pose frame run
  op by op after the timed poses, counted by the wrapper (1 on a card; 0
  on the CPU, where the plain version runs); each replay runs the same
  launches without calling the wrapper.

A phase that fails is not swallowed: the line then carries `value` 0 and a
note, and the exit code is 1. `--timeout` bounds the whole run the same
way. `--scale` shrinks the scene and the resolutions for smoke runs; the
metric is defined at 1.0.

    python -m zig_vulkan_tpu_torch.benchmarks.bench [frames] [--device cpu]
"""

from __future__ import annotations

import json
import signal
import sys
import time
import traceback

import numpy as np
import torch

from ..config import CameraConfig
from ..core.camera import Camera
from ..core.materials import MAT_NONE
from ..engine.benchmark import PATH_POINTS
from ..engine.engine import VoxelRT, device_name
from ..engine.step import GraphedCall
from ..models import scenes
from ..ops import tile_tracer
from ..ops import trace as trace_mod
from ..oracle import cpu_tracer as oracle
from ..utils.device import cli_main, resolve_device, sync
from . import configs, flythrough

METRIC = "primary_ray_throughput_1080p_512^3"
DEFAULT_FRAME_WORKLOAD = "1024x576 2spp 2+1bounce sun denoiser"
PARITY_SIDE = 48  # the parity check's rays: a 48x48 subgrid of the frame
DEFAULT_WORKLOAD_FRAMES = 12  # chained frames behind `default_frame_ms`


def _note(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def _emit(value: float, device, **fields) -> dict:
    """Print the JSON line and return it as a dict; fields that are None
    are left out."""
    rec = {"metric": METRIC, "value": round(float(value), 2),
           "unit": "Mray/s"}
    rec.update({k: v for k, v in fields.items() if v is not None})
    rec["device"] = device_name(device)
    print(json.dumps(rec), flush=True)
    return rec


def _parity_check(sc, tables, material_indices, width: int,
                  height: int) -> float:
    """Agreement of the traversal on the records' device (kernel A on a
    card) with the numpy DDA oracle on a PARITY_SIDE^2 subgrid of the
    frame's rays from the path's first pose (`bench.py:110-163`): `found`
    equal, and `t` within 1e-2 where both hit."""
    static = sc.grid.static
    dev = tables.device
    d = Camera(75.0, width, height,
               CameraConfig(origin=tuple(PATH_POINTS[0]))).d_camera
    xs = np.linspace(0, width - 1, PARITY_SIDE, dtype=np.float32)
    ys = np.linspace(0, height - 1, PARITY_SIDE, dtype=np.float32)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    u = (gx / np.float32(width - 1)).ravel()
    v = (gy / np.float32(height - 1)).ravel()
    rd = (d.horizontal * u[:, None] + d.lower_left_corner
          + d.vertical * v[:, None] - d.origin).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ro = np.broadcast_to(d.origin, rd.shape).astype(np.float32).copy()
    n = ro.shape[0]

    rays = (torch.from_numpy(np.ascontiguousarray(a[:, k])).to(dev)
            for a in (ro, rd) for k in range(3))
    got = tile_tracer.grid_hit_tiles(
        static, tables, material_indices, *rays,
        torch.ones(n, dtype=torch.bool, device=dev))
    g_found = got["found"].cpu().numpy()
    g_t = got["t"].cpu().numpy()

    osc = oracle.OracleScene(static, sc.grid.arrays, sc.materials)
    o = oracle.grid_hit(osc, ro, rd, np.float32(1e-5), np.float32(np.inf),
                        np.full(n, MAT_NONE, np.int32),
                        np.ones(n, np.float32), np.ones(n, bool))
    agree = g_found == o.found
    both = g_found & o.found
    agree[both] &= np.abs(g_t[both] - o.t[both]) < 1e-2
    rate = float(agree.mean())
    _note(f"parity vs the numpy DDA oracle ({n} rays of pose 0): {rate:.4f}")
    return rate


class PoseFrame:
    """The bench's compiled pose frame (the counterpart of `bench.py:
    make_frame`, 190-200): a pose's camera rays, read from the static
    f32[12] buffer `camera`, their normalization and one kernel A launch,
    captured once as a CUDA graph (`engine.step.GraphedCall`; the body op
    by op on the CPU). Calling it with a pose's vectors (an f32[12] device
    tensor of `ops.trace.camera_basis`) copies them into the buffer and
    runs the frame; the hits it returns are the graph's static outputs,
    which the next pose overwrites."""

    def __init__(self, static, tables, material_indices, width: int,
                 height: int):
        self.static, self.tables = static, tables
        self.material_indices = material_indices
        self.width, self.height = width, height
        dev = tables.device
        self.camera = torch.zeros(12, dtype=torch.float32, device=dev)
        self.on = torch.ones(width * height, dtype=torch.bool, device=dev)
        self.compiled = GraphedCall(self.body, self.camera)

    def body(self, camera):
        r = trace_mod._camera_rays_soa(trace_mod.basis_views(camera),
                                       self.width, self.height, 0)
        rays = (a.contiguous() for a in (*r[:3], *trace_mod._norm3(*r[3:])))
        return tile_tracer.grid_hit_tiles(self.static, self.tables,
                                          self.material_indices, *rays,
                                          self.on)

    def __call__(self, vectors):
        self.camera.copy_(vectors)
        return self.compiled()


def _headline(sc, device, frames: int, width: int, height: int):
    """(Mray/s of the poses, kernel A launches a pose, parity) of the
    primary-ray pass."""
    static = sc.grid.static
    arrays = sc.grid.arrays.to_device(device)
    tables = trace_mod.build_trace_tables(
        static, arrays, trace_mod.distance_field(static, arrays, True))
    mat_idx = arrays.material_indices
    frame = PoseFrame(static, tables, mat_idx, width, height)

    # the camera bases along the path, uploaded outside the timed loop
    cam = Camera(75.0, width, height, CameraConfig(origin=(0.0, 0.0, 0.0)))
    path = np.asarray(PATH_POINTS, dtype=np.float32)
    cam_vecs = []
    for i in range(frames):
        cam.d_camera.origin = path[i % len(path)]
        cam.propagate_pitch_change()
        cam_vecs.append(torch.from_numpy(
            trace_mod.camera_basis(cam.d_camera)).to(device))

    t0 = time.time()
    frame(cam_vecs[0])  # warm-up: the kernels' build, one pose, the capture
    sync(device)
    _note(f"warm-up (build + 1 pose + capture): {time.time() - t0:.1f}s")

    t0 = time.time()
    for cv in cam_vecs:
        hits = frame(cv)
    sync(device)
    elapsed = time.time() - t0
    # the kernel A launches of one pose, through the body op by op: a
    # replay runs the same launches without calling the wrapper
    before = tile_tracer.grid_hit_tiles.launches
    frame.body(frame.camera)
    launches = tile_tracer.grid_hit_tiles.launches - before
    per_frame = elapsed / frames
    mrays = width * height / per_frame / 1e6
    found = int(hits["found"].sum())
    _note(f"{frames} poses in {elapsed:.4f}s -> {per_frame * 1e3:.3f} "
          f"ms/pose, {launches} kernel A launches a pose, {found} hits in "
          f"the last")
    if found <= 0:
        raise AssertionError("the last pose hit nothing")
    return mrays, launches, _parity_check(sc, tables, mat_idx, width, height)


def _default_frame_ms(sc, device, config) -> float:
    """Frame time of `config` (the default workload, static sun) through
    the engine: a synced warm-up, DEFAULT_WORKLOAD_FRAMES chained frames, one sync."""
    rt = VoxelRT(sc.grid, sc.materials, config, device=device)
    t0 = time.time()
    rt.render()  # records + warm-up
    sync(device)
    _note(f"default-frame warm-up (records + 1 frame): "
          f"{time.time() - t0:.1f}s")
    t0 = time.time()
    for _ in range(DEFAULT_WORKLOAD_FRAMES):
        rt.render()
    sync(device)
    ms = (time.time() - t0) / DEFAULT_WORKLOAD_FRAMES * 1e3
    _note(f"default workload: {ms:.3f} ms/frame")
    return ms


def run(frames: int = 10, device="cuda", scale: float = 1.0) -> dict:
    """Measure every phase and return the line's fields (without printing).
    Raises where a phase fails."""
    device = resolve_device(device)
    t0 = time.time()
    if scale == 1.0:
        sc = flythrough.cached_scene()
    else:
        sc = scenes.default_scene(dims=configs.scaled_dims(scale))
    _note(f"scene: {sc.grid.static.voxel_dims} voxels, "
          f"{int(sc.grid.arrays.active_bricks)} bricks, ready in "
          f"{time.time() - t0:.1f}s")
    w, h = configs.scaled_size(scale, 1920, 1080)
    mrays, launches, parity = _headline(sc, device, frames, w, h)
    fw, fh = configs.scaled_size(scale, 1024, 576)
    ms = _default_frame_ms(
        sc, device, flythrough.default_workload(False, fw, fh))
    return dict(value=mrays, parity_vs_oracle=round(parity, 4),
                default_frame_ms=round(ms, 3),
                default_frame_workload=DEFAULT_FRAME_WORKLOAD,
                kernel_a_launches_per_pose=launches,
                scale=None if scale == 1.0 else scale)


def _on_alarm(signum, frame):
    raise TimeoutError("the bench ran into its --timeout")


@cli_main
def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="The 1080p headline bench.")
    ap.add_argument("frames", nargs="?", type=int, default=10,
                    help="timed poses (default 10)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N or cpu)")
    ap.add_argument("--timeout", type=int, default=1500,
                    help="seconds for the whole run (0: none)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="shrink the scene and resolutions (smoke runs)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    previous = signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(max(0, args.timeout))
    try:
        fields = run(args.frames, device, args.scale)
    except Exception as e:  # noqa: BLE001 - reported in the line and the code
        traceback.print_exc(file=sys.stderr)
        _emit(0.0, device, note=f"failed: {type(e).__name__}: {e}")
        return 1
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)
    _emit(fields.pop("value"), device, **fields)
    return 0


if __name__ == "__main__":
    sys.exit(main())
