"""The five BASELINE.json benchmark configurations on the port.

The torch counterpart of `benchmarks/configs.py`. Each configuration is a
function that returns its engine (`build_config1` ... `build_config5`) and a
timed run over it (`config1_dense_primary` ... `config5_multichip_4k`) that
returns the reference harness's dict of numbers. Sizes take the same `scale`
knob, so the suite runs small on the CPU in the tests and at full width on
the card:

 1. primary-ray 3D-DDA render: 64^3 dense voxel grid, 256x256, flat shading
 2. sparse brickmap traversal, 512^3 scene at 720p, diffuse + sun shadows
 3. interactive camera fly-through with per-frame voxel edits at 1080p
 4. path-traced bounces + emissive voxels with temporal accumulation, 1080p
 5. framebuffer-row sharding: 4K render of a streamed 1024^3 scene

    python -m zig_vulkan_tpu_torch.benchmarks.configs [scale] [--device cpu]

Timing is the reference's: a synced warm-up, the frames chained, one
synchronize, the host's clock.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np

from ..config import (
    CameraConfig,
    DenoiserConfig,
    EngineConfig,
    GridConfig,
    SunConfig,
    TraceConfig,
)
from ..core.grid import BrickGrid
from ..core.materials import MAT_EMISSIVE, terrain_materials
from ..engine.engine import VoxelRT, device_name
from ..io import streaming
from ..models import scenes
from ..ops import trace as trace_mod
from ..parallel import mesh as pmesh
from ..utils.device import cli_main, resolve_device, sync

# timed frames of each configuration (benchmarks/configs.py:81-179)
DEFAULT_FRAMES = {1: 8, 2: 6, 3: 6, 4: 6, 5: 3}
EDIT_VOXELS = 512  # voxels inserted or removed a frame by config 3
EMISSIVE = 40      # config 4's emissive material index


def _timed_frames(rt: VoxelRT, frames: int,
                  move: Callable[[int], None] | None = None) -> Dict:
    """Frame timing as `benchmarks/configs.py:46-78`: the warm-up render is
    synced, both edit paths are warmed (`move(i)` alternates insert and
    remove), then the frames are chained and synchronized once."""
    rt.render()
    sync(rt.device)
    if move is not None:
        move(0)
        rt.render()
        move(1)
        rt.render()
        sync(rt.device)
    t0 = time.time()
    for i in range(frames):
        if move is not None:
            move(i)
        rt.render()
    sync(rt.device)
    dt = (time.time() - t0) / frames
    w, h = rt.internal_resolution
    spp = int(rt.camera.d_camera.samples_per_pixel)
    return {
        "ms_per_frame": dt * 1e3,
        "fps": 1.0 / dt,
        "mrays_per_s": w * h * spp / dt / 1e6,
    }


def scaled_dims(scale: float, full=(128, 64, 128)):
    return (max(4, int(full[0] * scale)), max(2, int(full[1] * scale)),
            max(4, int(full[2] * scale)))


def scaled_size(scale: float, width: int, height: int):
    return max(64, int(width * scale)), max(36, int(height * scale))


def build_config1(scale: float = 1.0, device="cuda") -> VoxelRT:
    """64^3 dense grid (the lower half solid), 256x256, primary rays."""
    device = resolve_device(device)
    dim = max(2, int(16 * scale))  # 16 bricks = 64^3 voxels at scale 1
    res = max(32, int(256 * scale))
    grid = BrickGrid(dim, dim, dim, GridConfig(scale=1.0))
    vx, vy, vz = grid.static.voxel_dims
    xs, ys, zs = np.meshgrid(np.arange(vx), np.arange(vy // 2), np.arange(vz),
                             indexing="ij")
    grid.insert_batch(xs.ravel(), ys.ravel(), zs.ravel(),
                      np.full(xs.size, 1, dtype=np.uint8))
    return VoxelRT(grid, terrain_materials(), EngineConfig(
        internal_resolution_width=res, internal_resolution_height=res,
        camera=CameraConfig(origin=(dim / 2, dim * 0.9, dim * 2.5),
                            samples_per_pixel=1, max_bounce=0),
        sun=SunConfig(enabled=False), denoiser=DenoiserConfig(enabled=False)),
        device=device)


def build_config2(scale: float = 1.0, device="cuda", scene=None) -> VoxelRT:
    """512^3 sparse scene at 720p, diffuse + sun shadow rays. `scene` is
    the default scene at this scale, for a caller that has built it."""
    device = resolve_device(device)
    w, h = scaled_size(scale, 1280, 720)
    if scene is None:
        scene = scenes.default_scene(dims=scaled_dims(scale))
    return VoxelRT(scene.grid, scene.materials, EngineConfig(
        internal_resolution_width=w, internal_resolution_height=h,
        camera=CameraConfig(origin=(0.0, 0.0, 0.0), samples_per_pixel=1,
                            max_bounce=0),
        sun=SunConfig(enabled=True, animate=False),
        denoiser=DenoiserConfig(enabled=False),
        trace=TraceConfig(max_steps=160)), device=device)


def build_config3(scale: float = 1.0, device="cuda", scene=None) -> VoxelRT:
    """The 1080p fly-through with voxel edits every frame (`EditStream`
    makes them). `scene` as in `build_config2`."""
    device = resolve_device(device)
    w, h = scaled_size(scale, 1920, 1080)
    if scene is None:
        scene = scenes.default_scene(dims=scaled_dims(scale))
    return VoxelRT(scene.grid, scene.materials, EngineConfig(
        internal_resolution_width=w, internal_resolution_height=h,
        camera=CameraConfig(origin=(0.0, 0.0, 0.0), samples_per_pixel=1,
                            max_bounce=1),
        sun=SunConfig(enabled=True, animate=True),
        denoiser=DenoiserConfig(enabled=False),
        trace=TraceConfig(max_steps=160)), device=device)


class EditStream:
    """Config 3's per-frame motion and edits (`benchmarks/configs.py:130-143`):
    the 60 s camera path and the sun advance by 16 ms, then 512 random voxels
    are inserted (even frames) or removed (odd frames). The draws come from
    `np.random.default_rng(0)` in the reference's order (x, y, z, then the
    materials of an insert), so the edited scene equals the reference's
    array for array."""

    def __init__(self, rt: VoxelRT):
        self.rt = rt
        self.bench = rt.create_benchmark(duration=60.0)
        self.rng = np.random.default_rng(0)

    def draw(self, i: int):
        """Advance the pose and draw frame i's batch: (xyz int[n, 3],
        materials uint8[n] for an insert, None for a removal)."""
        self.bench.update(0.016)
        self.rt.update_sun(0.016)
        n, rng = EDIT_VOXELS, self.rng
        vx, vy, vz = self.rt.grid_static.voxel_dims
        xyz = np.stack([rng.integers(0, vx, n), rng.integers(0, vy, n),
                        rng.integers(0, vz, n)], axis=-1)
        mats = rng.integers(1, 8, n).astype(np.uint8) if i % 2 == 0 else None
        return xyz, mats

    def apply(self, xyz, mats) -> None:
        if mats is None:
            self.rt.remove_voxels(xyz)
        else:
            self.rt.insert_voxels(xyz, mats)

    def __call__(self, i: int) -> None:
        self.apply(*self.draw(i))


def build_config4(scale: float = 1.0, device="cuda") -> VoxelRT:
    """Path-traced bounces, an emissive block (material 40) and temporal
    accumulation at 1080p, on the terrain without the model."""
    device = resolve_device(device)
    w, h = scaled_size(scale, 1920, 1080)
    scene = scenes.default_scene(dims=scaled_dims(scale, (64, 32, 64)),
                                 with_model=False)
    scene.materials.set(EMISSIVE, MAT_EMISSIVE, (1.0, 0.85, 0.4), 8.0)
    vx, vy, vz = scene.grid.static.voxel_dims
    xs, ys, zs = np.meshgrid(
        np.arange(max(0, vx // 2 - 4), vx // 2 + 4),
        np.arange(max(0, vy - 8), max(1, vy - 4)),
        np.arange(max(0, vz // 2 - 4), vz // 2 + 4), indexing="ij")
    scene.grid.insert_batch(xs.ravel(), ys.ravel(), zs.ravel(),
                            np.full(xs.size, EMISSIVE, dtype=np.uint8))
    rt = VoxelRT(scene.grid, scene.materials, EngineConfig(
        internal_resolution_width=w, internal_resolution_height=h,
        camera=CameraConfig(origin=(0.0, 0.0, 0.0), samples_per_pixel=2,
                            max_bounce=3),
        sun=SunConfig(enabled=True, animate=False),
        denoiser=DenoiserConfig(enabled=True),
        trace=TraceConfig(max_steps=160)), device=device)
    rt.set_temporal(True)
    return rt


def look_at_emissive_block(rt: VoxelRT) -> None:
    """Move config 4's camera to a pose that looks at the emissive block:
    in front of it (+z) and below it (world y grows downwards). The
    configuration's own camera sits at the grid's corner, inside the
    terrain, and sees no emissive voxel."""
    st = rt.grid_static
    vs = st.voxel_scale
    vx, _, vz = st.voxel_dims
    centre = (st.min_point[0] + vx // 2 * vs, st.min_point[1] + 6 * vs,
              st.min_point[2] + vz // 2 * vs)
    rt.camera.set_origin((centre[0], centre[1] + 0.2 * st.dim_y * st.scale,
                          centre[2] + 0.375 * st.dim_z * st.scale))


@dataclasses.dataclass
class Config5:
    """Config 5 after its set-up: the engine with the streamed scene, the
    records with the exact field (built once), and the frame's constants."""

    rt: VoxelRT
    devices: tuple          # the mesh's devices, one a shard
    width: int
    height: int
    streamed: int           # voxels streamed into the engine
    stream_s: float
    tables: object          # int32[cells, 8] on the engine's device
    tables_s: float
    cam: dict

    _SUN = (np.zeros(3, np.float32), np.ones(3, np.float32), np.float32(1.0))

    def unsharded(self):
        """The frame through `render_image` on the engine's device."""
        rt = self.rt
        return trace_mod.render_image(
            rt.grid_static, rt.arrays, rt.mats, rt.camera.d_camera,
            *self._SUN, False, TraceConfig(), tables=self.tables)

    def sharded_step(self, devices=None):
        """A zero-argument function that renders the frame of the engine's
        camera through `build_sharded_step` over `devices` (default: the
        configuration's), the scene and the records replicated once: the
        step's graphs, captured on the first call. Its attribute `op_by_op`
        renders the same frame through the same bodies op by op."""
        rt = self.rt
        m = pmesh.make_mesh(self.devices if devices is None else devices)
        step = pmesh.build_sharded_step(
            m, rt.grid_static, width=self.width, height=self.height, spp=1,
            max_bounce=1, sun_enabled=False,
            denoiser=DenoiserConfig(enabled=False))
        arrays_r, mats_r = pmesh.replicate_scene(m, rt.arrays, rt.mats)
        tables_r = pmesh.map_replicas(
            m, lambda a: self.tables.to(a.statuses.device), arrays_r)

        def frame(route):
            # the camera packs into the step's one pinned upload
            cam = trace_mod.camera_vectors(rt.camera.d_camera, "cpu")
            return route(arrays_r, mats_r, cam, *self._SUN, tables=tables_r)

        def run():
            return frame(step)

        run.op_by_op = lambda: frame(step.op_by_op)
        return run


def build_config5(scale: float = 1.0, devices=None,
                  row_multiple: Optional[int] = None) -> Config5:
    """Stream the 1024x256x1024-voxel terrain into an empty engine on the
    first of `devices` (default: every CUDA device, one shard each) and
    build the exact field and the records once. The frame's height is
    rounded down to a multiple of `row_multiple` (default: the number of
    shards)."""
    m = pmesh.make_mesh(devices)
    n_dev = m.size
    mult = n_dev if row_multiple is None else int(row_multiple)
    dims = (max(8, int(256 * scale)), max(4, int(64 * scale)),
            max(8, int(256 * scale)))  # 1024^3 voxels at scale 1 (x/z)
    w = max(128, int(3840 * scale))
    h = max(mult * 8, (int(2160 * scale) // mult) * mult)
    first = m.devices[0]

    grid = BrickGrid(*dims, GridConfig(min_point=(-64, -16, -64), scale=0.5))
    rt = VoxelRT(grid, terrain_materials(), EngineConfig(
        internal_resolution_width=w, internal_resolution_height=h,
        camera=CameraConfig(origin=(0.0, 0.0, 0.0), samples_per_pixel=1,
                            max_bounce=0),
        sun=SunConfig(enabled=False), denoiser=DenoiserConfig(enabled=False)),
        device=first)
    sync(first)
    t0 = time.time()
    streamed = streaming.stream_into_engine(
        rt, streaming.terrain_regions(grid, region_x=dims[0]))
    sync(first)
    stream_s = time.time() - t0
    t0 = time.time()
    st = rt.grid_static
    tables = trace_mod.build_trace_tables(
        st, rt.arrays, trace_mod.distance_field(st, rt.arrays, True))
    sync(first)
    return Config5(rt=rt, devices=m.devices, width=w, height=h,
                   streamed=streamed, stream_s=stream_s, tables=tables,
                   tables_s=time.time() - t0,
                   cam=trace_mod.camera_vectors(rt.camera.d_camera, first))


def config1_dense_primary(scale: float = 1.0,
                          frames: int = DEFAULT_FRAMES[1],
                          device="cuda") -> Dict:
    return {"config": "1: dense 64^3 primary 256x256",
            **_timed_frames(build_config1(scale, device), frames)}


def config2_sparse_diffuse_shadows(scale: float = 1.0,
                                   frames: int = DEFAULT_FRAMES[2],
                                   device="cuda") -> Dict:
    return {"config": "2: sparse 512^3 diffuse+shadows 720p",
            **_timed_frames(build_config2(scale, device), frames)}


def config3_interactive_edits(scale: float = 1.0,
                              frames: int = DEFAULT_FRAMES[3],
                              device="cuda") -> Dict:
    rt = build_config3(scale, device)
    out = {"config": "3: interactive edits 1080p",
           **_timed_frames(rt, frames, EditStream(rt))}
    rt.camera.reset()
    return out


def config4_path_traced_emissive(scale: float = 1.0,
                                 frames: int = DEFAULT_FRAMES[4],
                                 device="cuda") -> Dict:
    return {"config": "4: path traced + emissive + temporal 1080p",
            **_timed_frames(build_config4(scale, device), frames)}


def config4_emissive_block_in_view(scale: float = 1.0,
                                   frames: int = DEFAULT_FRAMES[4],
                                   device="cuda") -> Dict:
    """Config 4 from the pose that looks at the emissive block: an extra
    cell, not one of BASELINE's five."""
    rt = build_config4(scale, device)
    look_at_emissive_block(rt)
    return {"config": "4b: config 4, the emissive block in view",
            **_timed_frames(rt, frames)}


def config5_multichip_4k(scale: float = 1.0,
                         frames: int = DEFAULT_FRAMES[5],
                         devices=None) -> Dict:
    """Row sharding: the 4K render of the streamed scene through the
    sharded step, one shard a device of `devices` (default: every CUDA
    device; a device may repeat)."""
    c = build_config5(scale, devices)
    run = c.sharded_step()
    run()  # warm-up, synced
    sync(*c.devices)
    t0 = time.time()
    for _ in range(frames):
        run()
    sync(*c.devices)
    dt = (time.time() - t0) / frames
    return {
        "config": "5: multi-chip 4K streamed scene",
        "devices": len(c.devices),
        "streamed_voxels": c.streamed,
        "stream_s": c.stream_s,
        "ms_per_frame": dt * 1e3,
        "mrays_per_s": c.width * c.height / dt / 1e6,
    }


ALL_CONFIGS = [
    config1_dense_primary,
    config2_sparse_diffuse_shadows,
    config3_interactive_edits,
    config4_path_traced_emissive,
    config5_multichip_4k,
]


def run_all(scale: float = 1.0, device="cuda") -> list:
    """Run the five configurations on `device` (config 5: over every CUDA
    device for `cuda`, else over `device` alone) and print each result."""
    device = resolve_device(device)
    results = []
    for fn in ALL_CONFIGS:
        print(f"# running {fn.__name__}", file=sys.stderr, flush=True)
        if fn is config5_multichip_4k:
            whole = device.type == "cuda" and device.index is None
            r = fn(scale=scale, devices=None if whole else [device])
        else:
            r = fn(scale=scale, device=device)
        r["device"] = device_name(device)
        results.append(r)
        print(r, flush=True)
    return results


@cli_main
def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Run the five BASELINE configurations.")
    ap.add_argument("scale", nargs="?", type=float, default=1.0,
                    help="size knob (1.0: the configurations' full widths)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)
    run_all(scale=args.scale, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
