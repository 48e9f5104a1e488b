"""Application entry point — the reference's `main()` re-imagined headless.

Reproduces the startup sequence of src/main.zig:38-152 (grid build, .vox
model load + material derivation, terrain generation, engine init with the
default workload: 1024x576 internal resolution, 2 spp, 2 bounces) and the
frame loop of main.zig:156-195 (input -> camera, sun update, draw), with
frames optionally written to PNG instead of a swapchain. The flags and
defaults are `zig_vulkan_tpu.app.run`'s, plus `--device` (default `cuda`):
without a CUDA device the app stops unless `--device cpu` is given.

Usage:
    python -m zig_vulkan_tpu_torch.app.run --frames 60 --out frames_dir
    python -m zig_vulkan_tpu_torch.app.run --benchmark       # fly-through
    python -m zig_vulkan_tpu_torch.app.run --script demo     # scripted input
    python -m zig_vulkan_tpu_torch.app.run --device cpu --grid 8 4 8 \\
        --width 64 --height 48 --frames 2 --out frames_dir   # CPU, tiny
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

from ..config import CameraConfig, DenoiserConfig, EngineConfig, SunConfig
from ..engine.engine import VoxelRT, device_name
from ..io.image import write_png
from ..models import scenes
from ..utils import profiling
from ..utils.device import cli_main, resolve_device
from .input import Action, Input, Key


def build_engine(args) -> VoxelRT:
    scene = scenes.default_scene(
        vox_path=args.vox,
        dims=tuple(args.grid),
        with_terrain=not args.no_terrain,
    )
    cfg = EngineConfig(
        internal_resolution_width=args.width,
        internal_resolution_height=args.height,
        output_resolution_width=args.out_width,
        output_resolution_height=args.out_height,
        camera=CameraConfig(samples_per_pixel=args.spp, max_bounce=args.bounces),
        sun=SunConfig(enabled=not args.no_sun),
        denoiser=DenoiserConfig(enabled=not args.no_denoise),
    )
    return VoxelRT(scene.grid, scene.materials, cfg, device=args.device)


def demo_script(frame: int, inp: Input) -> None:
    """A small scripted input sequence exercising the game bindings."""
    if frame == 0:
        inp.key_event(Key.W, Action.PRESS)
    if frame == 20:
        inp.key_event(Key.W, Action.RELEASE)
        inp.key_event(Key.LEFT_SHIFT, Action.PRESS)
        inp.key_event(Key.D, Action.PRESS)
    if frame == 40:
        inp.key_event(Key.D, Action.RELEASE)
    if 10 <= frame < 50:
        inp.cursor_event(frame * 4.0, frame * 1.5)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--width", type=int, default=1024)    # main.zig:23
    p.add_argument("--height", type=int, default=576)
    p.add_argument("--out-width", type=int, default=None)
    p.add_argument("--out-height", type=int, default=None)
    p.add_argument("--spp", type=int, default=2)         # main.zig:126
    p.add_argument("--bounces", type=int, default=2)     # main.zig:127
    p.add_argument("--grid", type=int, nargs=3, default=[128, 64, 128])
    p.add_argument("--vox", type=str, default=None, help=".vox model path")
    p.add_argument("--no-terrain", action="store_true")
    p.add_argument("--no-sun", action="store_true")
    p.add_argument("--no-denoise", action="store_true")
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--out", type=str, default=None, help="PNG output dir")
    p.add_argument("--benchmark", action="store_true",
                   help="run the 60s fly-through and print the report")
    p.add_argument("--benchmark-duration", type=float, default=60.0)
    p.add_argument("--script", choices=["none", "demo"], default="none")
    p.add_argument("--live", action="store_true",
                   help="interactive terminal viewer (ANSI half-blocks; "
                        "WASD+arrows, q quits)")
    p.add_argument("--live-cols", type=int, default=120)
    p.add_argument("--live-rows", type=int, default=40)
    p.add_argument("--profile", type=str, default=None,
                   help="capture a torch.profiler trace to this dir "
                        "(trace.json, Chrome trace format)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to render on (cuda, cuda:N or cpu)")
    return p.parse_args(argv)


@cli_main
def main(argv=None) -> int:
    args = parse_args(argv)
    resolve_device(args.device)

    t0 = time.time()
    rt = build_engine(args)
    print(f"scene + engine ready in {time.time() - t0:.1f}s "
          f"({rt.arrays.active_bricks.item()} bricks) on "
          f"{device_name(rt.device)}", file=sys.stderr)

    ctx = (profiling.trace_session(args.profile) if args.profile
           else contextlib.nullcontext())
    with ctx:
        if args.live:
            from .live import LiveViewer

            viewer = LiveViewer(rt, max_cols=args.live_cols,
                                max_rows=args.live_rows)
            n = viewer.run(max_frames=args.frames or None)
            print(f"live session ended after {n} frames; "
                  f"metrics: {rt.metrics.summary()}", file=sys.stderr)
            return 0
        if args.benchmark:
            rt.run_benchmark(duration=args.benchmark_duration,
                             max_frames=args.frames or None)
            return 0

        inp = Input()
        prev = time.perf_counter()
        for frame in range(args.frames):
            now = time.perf_counter()
            dt = now - prev
            prev = now
            if args.script == "demo":
                demo_script(frame, inp)
            inp.apply_to_camera(rt.camera, dt if frame else 1e-3)
            rt.update_sun(dt if frame else 1e-3)
            with profiling.zone("draw"):
                image = rt.draw(dt if frame else None)
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                write_png(os.path.join(args.out, f"frame_{frame:04d}.png"),
                          rt.device_image_to_host(image))
            profiling.frame_mark()
        print(f"rendered {args.frames} frames; metrics: {rt.metrics.summary()}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
