"""Faults planted in the program underneath a whole run of the harness, each
of which the comparison must find: a run with one comes out not correct.

A fault is `fn(patch)`, where `patch(obj, name, value)` replaces an
attribute (pytest's `monkeypatch.setattr`, or `setattr` in a process of
its own). The tests run every fault on the small cells on the CPU
(`rtbench/tests/test_rtbench_check.py`); on the card, at a cell's own size:

    python3 -m rtbench.faults --fault <name> --workload <cell> \\
        --seeds <n> [<n> ...] [--seconds <s>]

prints one JSON line a seed, with `correct` and the numbers compared.
"""

from __future__ import annotations

import argparse
import json
import sys


def stale_frames(patch):
    """A step that returns its state unchanged: every frame shows the first
    frame the engine drew."""
    from zig_vulkan_tpu_torch.engine.engine import VoxelRT

    draw = VoxelRT.draw
    first = {}

    def stale(self, dt=None):
        img = draw(self, dt)
        return first.setdefault(id(self), img).clone()

    patch(VoxelRT, "draw", stale)


def half_samples(patch):
    """Half of the batch left out: the frames traced at half the
    configuration's samples a pixel, the mean taken over the rest."""
    from zig_vulkan_tpu_torch.engine.engine import VoxelRT

    render = VoxelRT.render

    def half(self):
        self.camera.d_camera.samples_per_pixel = max(
            1, self.config.camera.samples_per_pixel // 2)
        return render(self)

    patch(VoxelRT, "render", half)


def half_rows(patch):
    """Half of the batch left out where a pixel has one sample: the lower
    half of every frame's rows not traced (left black)."""
    from zig_vulkan_tpu_torch.engine.engine import VoxelRT

    draw = VoxelRT.draw

    def half(self, dt=None):
        img = draw(self, dt)
        img[img.shape[0] // 2:] = 0.0
        return img

    patch(VoxelRT, "draw", half)


def half_edits(patch):
    """Half of each edit batch left out."""
    from zig_vulkan_tpu_torch.engine.engine import VoxelRT

    insert, remove = VoxelRT.insert_voxels, VoxelRT.remove_voxels
    patch(VoxelRT, "insert_voxels", lambda self, xyz, m: insert(
        self, xyz[:len(xyz) // 2], m[:len(m) // 2]))
    patch(VoxelRT, "remove_voxels", lambda self, xyz: remove(
        self, xyz[:len(xyz) // 2]))


def edits_dropped(patch):
    """An insert that returns the scene unchanged."""
    from zig_vulkan_tpu_torch.engine.engine import VoxelRT

    patch(VoxelRT, "insert_voxels", lambda self, xyz, m: None)


def stale_records(patch):
    """An insert that writes the scene's arrays but leaves the records and
    the skip field as they were (`ops.trace.refresh_tables_after_insert`
    skipped): the scene decodes right, the traversal does not see the new
    voxels."""
    from zig_vulkan_tpu_torch.ops import trace

    patch(trace, "refresh_tables_after_insert",
          lambda static, arrays, tables, cells, valid, dist=None:
          (tables, dist))


def answer_altered(patch):
    """One pixel of every frame altered where it is produced."""
    from zig_vulkan_tpu_torch.engine.engine import VoxelRT

    draw = VoxelRT.draw

    def altered(self, dt=None):
        img = draw(self, dt)
        img[img.shape[0] // 2, img.shape[1] // 3, 1] += 0.125
        return img

    patch(VoxelRT, "draw", altered)


FAULTS = {f.__name__: f for f in (stale_frames, half_samples, half_rows,
                                  half_edits, edits_dropped, stale_records,
                                  answer_altered)}


def main(argv=None) -> int:
    from rtbench import run, spec

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    run._caches()
    FAULTS[args.fault](setattr)
    cell = spec.cell(spec.load(), args.workload)
    for seed in args.seeds:
        out = run.run(cell, seed, args.seconds, False)
        print(json.dumps({"fault": args.fault, "workload": args.workload,
                          "seed": seed, "correct": out["correct"],
                          "check": out["check"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
