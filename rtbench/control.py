"""The control of the comparison: the reference in the program's place, at
the next precision below the configurations' float32.

For each seed it makes the run's traffic tables, replays the edits, and for
each frame the seed picks compares the reference's image with the same
frame presented through bfloat16 (`ref.engine.RefEngine.present(...,
"bfloat16")`: the traced and the presented image rounded), by the numbers
`rtbench.check` compares. The readings set the upper end of the limits in
`check.py`; the control must fail one. It runs no program and no window.
`--variant half_samples` reads a fault the same way: each frame traced at
half its samples a pixel (at least one), the mean taken over those.

    python3 -m rtbench.control --workload <name> --seeds <n> [<n> ...] \\
        [--device cuda] [--variant bfloat16|half_samples]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from rtbench import check, scene, spec, traffic
from rtbench.run import reference_engine, reference_frames


VARIANTS = ("bfloat16", "half_samples")


def readings(cell: spec.Cell, seed: int, device="cuda",
             variant: str = "bfloat16") -> dict:
    """`check.frame_gaps` between the reference's image and `variant`'s
    for each frame `seed` picks, and the verdict `check` gives it. `bfloat16`
    is the control; `half_samples` plants a fault in the reference put in
    the program's place: each frame traced at half its samples a pixel
    (at least one), the mean taken over those."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}")
    path = scene.cached(cell.config["scene"])
    grid, _ = scene.load_reference(path)
    tables = traffic.build(cell.traffic, cell.config["engine"], seed,
                           grid.static, grid.arrays)
    del grid
    ref = reference_engine(cell, path, device)
    frames = [tables.warmup + k for k in tables.checked]
    gaps = []
    for g in reference_frames(ref, tables, frames):
        fr = tables.frame(g)
        img = ref.traced(fr.origin, fr.yaw, fr.sun_position, fr.sun_color)
        if variant == "bfloat16":
            got = ref.present(img, "bfloat16")
        else:
            spp = max(1, cell.config["engine"]["camera"]["samples_per_pixel"]
                      // 2)
            got = ref.present(ref.traced(fr.origin, fr.yaw, fr.sun_position,
                                         fr.sun_color, spp))
        gaps.append(check.frame_gaps(got, ref.present(img)))
    v = check.verdict(gaps, 0)
    return {"seed": seed, "variant": variant, "gaps": gaps,
            "correct": v["correct"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--variant", choices=VARIANTS, default="bfloat16")
    args = ap.parse_args(argv)
    cell = spec.cell(spec.load(), args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = readings(cell, seed, args.device, args.variant)
        out.update(workload=args.workload,
                   seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
