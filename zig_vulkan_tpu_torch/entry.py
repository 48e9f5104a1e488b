"""Entry points of the port for a harness that drives it.

The torch counterpart of `__graft_entry__.py`:

- `entry(device)`: a single-device render step on the small test scene
  (64x48, 1 spp, two bounce levels, sun; `render_rows` then the denoiser
  with 8 samples) with example arguments on `device`;
- `parallel.mesh.dryrun_multichip(n)`: the whole sharded frame on an
  n-shard mesh at a small size.

    python -m zig_vulkan_tpu_torch.entry [--device cpu] [n]

runs the step once, then the dry run over n shards (default 8), and prints
one OK line for each.
"""

from __future__ import annotations

import sys

import torch

from .config import CameraConfig, SunConfig
from .core.camera import Camera
from .core.sun import Sun
from .models.scenes import small_test_scene
from .ops import denoise as denoise_mod
from .ops import trace as trace_mod
from .utils.device import cli_main, resolve_device, sync


def entry(device="cuda"):
    """Returns (render_step, example_args): the forward render step and
    arguments for it on `device`. The step builds the scene's records (the
    fast conservative field), traces and denoises: f32[48, 64, 3]."""
    device = resolve_device(device)
    sc = small_test_scene()
    static = sc.grid.static
    width, height, spp, max_bounce = 64, 48, 1, 2

    cam = Camera(75.0, width, height,
                 CameraConfig(origin=(4.0, 6.5, 15.0), samples_per_pixel=spp,
                              max_bounce=max_bounce - 1))
    sun = Sun(SunConfig(enabled=True)).device_data

    def render_step(arrays, mats, cam_vecs, sun_position, sun_color,
                    sun_radius):
        tables = trace_mod.one_shot_tables(static, arrays)
        img = trace_mod.render_rows(
            static, tables, arrays.material_indices, mats, cam_vecs, width,
            height, spp, max_bounce, sun_position, sun_color, sun_radius,
            True, max_steps=256)
        return denoise_mod.denoise(img, samples=8)

    example_args = (
        sc.grid.arrays.to_device(device),
        trace_mod.materials_to_device(sc.materials, device),
        trace_mod.camera_vectors(cam.d_camera, device),
        sun.position, sun.color, sun.radius,
    )
    return render_step, example_args


@cli_main
def main(argv=None) -> int:
    import argparse

    from .parallel.mesh import dryrun_multichip

    ap = argparse.ArgumentParser(
        description="Run the entry render step once, then the sharded dry "
                    "run.")
    ap.add_argument("n", nargs="?", type=int, default=8,
                    help="shards of the dry run (default 8)")
    ap.add_argument("--device", default=None,
                    help="run both on this device (e.g. cpu); by default "
                         "the step runs on the first CUDA device and the "
                         "shards go round them all")
    args = ap.parse_args(argv)
    fn, example_args = entry(args.device or "cuda")
    out = fn(*example_args)
    sync(out.device)
    if tuple(out.shape) != (48, 64, 3) or not bool(torch.isfinite(out).all()):
        print(f"entry FAILED: shape {tuple(out.shape)} or non-finite values",
              flush=True)
        return 1
    print("entry OK:", tuple(out.shape), flush=True)
    dryrun_multichip(args.n, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
