"""Edit pattern `brick_stamps`: whole bricks stamped onto the terrain and
erased again, one batch a frame.

BASELINE.json's config 3 is a 1080p fly-through with "per-frame voxel
edits (brick insert/remove)", 512 voxels a frame with materials 1-7
(zig_vulkan_tpu_torch/benchmarks/configs.py: EditStream). Here a batch is
one solid `block`-voxel cube, `block`^3 voxels (8^3 = 512: 2x2x2 whole
4^3 bricks), aligned to the block, standing on the terrain: its floor is
the lowest multiple of `block` above every filled voxel of its footprint,
so every voxel it covers is empty in the set-up scene. The cycle stamps
`stamps` blocks at places fixed for every seed (`PLACEMENT_SEED`), one a
frame, then erases them in reverse order, one a frame: `2 * stamps`
frames that leave the occupancy as they found it. Once the first cycle
has loaded the bricks it touches, no batch allocates one. The seed draws
each voxel's material from `materials` (inclusive).

Config 3's own draws, uniform over the whole volume, exhaust the brick
pool after about 2,300 inserts, since removals leave their bricks loaded;
each frame is slower than the last, so a faster program would do more
work. The stamps keep its batch size, materials and insert/remove mix and
make the work stationary.
"""

from __future__ import annotations

import numpy as np

from rtbench import scene, traffic

# the blocks' places are the same for every seed: which stamps lie in view,
# and so the frames' work, does not move with the seed
PLACEMENT_SEED = 16


def places(edits: dict, static, arrays):
    """The corners (x0, y0, z0) of the cycle's blocks, on the terrain."""
    vx, vy, vz = static.voxel_dims
    b, n = int(edits["block"]), int(edits["stamps"])
    cols = (vx // b) * (vz // b)
    place = traffic.rng(PLACEMENT_SEED, 1)
    heights = np.arange(vy)
    out = []
    for c in place.permutation(cols):
        if len(out) == n:
            break
        x0, z0 = int(c // (vz // b)) * b, int(c % (vz // b)) * b
        xs, ys, zs = np.meshgrid(np.arange(x0, x0 + b), heights,
                                 np.arange(z0, z0 + b), indexing="ij")
        col = np.stack([xs.ravel(), ys.ravel(), zs.ravel()], axis=-1)
        filled = col[scene.occupied(static, arrays, col), 1]
        top = int(filled.max()) + 1 if filled.size else 0
        y0 = -(-top // b) * b
        if y0 + b <= vy:
            out.append((x0, y0, z0))
    if len(out) != n:
        raise ValueError(f"could not stamp {n} blocks of {b} voxels on a "
                         f"{vx}x{vy}x{vz} grid")
    return out


def cycle(edits: dict, static, arrays, seed: int):
    """(the cycle's batches, the phase after which the scene holds every
    block, the blocks' centres f32[stamps, 3] in voxels (x, y, z))."""
    b = int(edits["block"])
    lo, hi = edits["materials"]
    draw = traffic.rng(seed, 1)
    cube = np.stack(np.meshgrid(np.arange(b), np.arange(b), np.arange(b),
                                indexing="ij"), axis=-1).reshape(-1, 3)
    inserts, centres = [], []
    for corner in places(edits, static, arrays):
        xyz = (cube + np.asarray(corner)).astype(np.int32)
        mats = draw.integers(lo, hi + 1, xyz.shape[0]).astype(np.uint8)
        inserts.append(traffic.Edit(traffic.INSERT, xyz, mats))
        centres.append(np.asarray(corner, np.float32) + b / 2)
    removes = [traffic.Edit(traffic.REMOVE, e.xyz, None)
               for e in reversed(inserts)]
    return inserts + removes, len(inserts) - 1, np.stack(centres)
