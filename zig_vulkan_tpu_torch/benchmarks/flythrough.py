"""Full-length fly-through benchmark report (reference format).

The torch counterpart of `benchmarks/flythrough.py`: the engine's 60-second
scripted fly-through (the reference harness, src/modules/voxel_rt/
Benchmark.zig:141-173) over the default workload (1024x576 internal, 2 spp,
2 user bounces, animated sun, denoiser) on the default scene, printed as
the reference-format report with the frame count that backs the average.

The path advances by a fixed virtual dt (default 0.5 s: 120 frames cover
the whole 60 s path), so every segment of the path is sampled whatever the
frame time; the report's min, max and average are the measured frame times.

    python -m zig_vulkan_tpu_torch.benchmarks.flythrough [fixed_dt] \\
        [--device cpu]
"""

from __future__ import annotations

import sys
from typing import Optional

from .. import _build
from ..config import CameraConfig, DenoiserConfig, EngineConfig, SunConfig
from ..engine.benchmark import BenchmarkReport
from ..engine.engine import VoxelRT
from ..models import scenes
from ..utils.device import cli_main, resolve_device

# the default scene's host-side cache (io.scene_io's format), beside the
# kernels' build products
SCENE_CACHE = _build.BUILD_DIR / "bench_scene_cache.npz"


def default_workload(animate_sun: bool = True, width: int = 1024,
                     height: int = 576) -> EngineConfig:
    """The reference app's default workload (src/main.zig:122-135)."""
    return EngineConfig(
        internal_resolution_width=width, internal_resolution_height=height,
        camera=CameraConfig(origin=(0.0, 0.0, 0.0), samples_per_pixel=2,
                            max_bounce=2),
        sun=SunConfig(enabled=True, animate=animate_sun),
        denoiser=DenoiserConfig(enabled=True))


def cached_scene():
    """The default 512x256x512 scene through its cache file."""
    SCENE_CACHE.parent.mkdir(parents=True, exist_ok=True)
    return scenes.cached_default_scene(str(SCENE_CACHE))


def fly(fixed_dt: float = 0.5, device="cuda", scene=None,
        config: Optional[EngineConfig] = None) -> BenchmarkReport:
    """Fly the whole path on `scene` (default: the cached default scene) at
    `config` (default: the default workload) and return the report, which
    holds 60 / fixed_dt frame times."""
    device = resolve_device(device)
    sc = cached_scene() if scene is None else scene
    rt = VoxelRT(sc.grid, sc.materials, config or default_workload(),
                 device=device)
    return rt.run_benchmark(fixed_dt=fixed_dt).report


def main(argv=None) -> BenchmarkReport:
    import argparse

    ap = argparse.ArgumentParser(
        description="The 60 s fly-through over the default workload.")
    ap.add_argument("fixed_dt", nargs="?", type=float, default=0.5,
                    help="virtual seconds of path a frame (default 0.5)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)
    return fly(args.fixed_dt, args.device)


@cli_main
def _cli(argv=None) -> int:
    report = main(argv)
    return 0 if report.delta_time_sum_samples > 0 else 1


if __name__ == "__main__":
    sys.exit(_cli())
