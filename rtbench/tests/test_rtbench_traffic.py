"""The traffic generator: its tables repeat, every seed gets the same work,
a checked frame sees the edits, and `brush_edits` is stationary: a cycle
leaves the occupancy as it found it, and after the first cycle no batch
allocates a brick."""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from rtbench import scene, spec, traffic
from rtbench.ref.core.grid import dense_materials
from rtbench.ref.engine import RefEngine
from rtbench.run import Program, engine_config
from rtbench.tests.small import small_cell
from zig_vulkan_tpu_torch.engine.engine import VoxelRT
from zig_vulkan_tpu_torch.io import scene_io as p_scene_io

CPU = torch.device("cpu")
SEEDS = (0, 7, 2**31 + 5, 3_000_000_019)


def _key(fr: traffic.Frame):
    """Everything a frame hands the program, as bytes."""
    parts = [fr.origin, fr.yaw, fr.sun_position, fr.sun_color]
    for a in fr.actions:
        parts += [np.frombuffer(a.kind.encode(), np.uint8), a.xyz]
        if a.mats is not None:
            parts.append(a.mats)
    return b"".join(np.ascontiguousarray(p).tobytes() for p in parts)


@pytest.fixture(scope="module")
def small_world():
    cell = small_cell("edit_brush_1080p")
    grid, materials = scene.build(cell.config["scene"])
    return cell, grid, materials


@pytest.mark.parametrize("name", ["flythrough", "brush_edits"])
def test_tables_repeat_over_two_periods(small_world, name):
    """Frame g and frame g + period hand the program the same work, over
    two whole periods, and a seed's tables are the same in every build."""
    cell, grid, _ = small_world
    tr = small_cell("edit_brush_1080p" if name == "brush_edits"
                    else "fly_1080p").traffic
    a = traffic.build(tr, cell.config["engine"], 5, grid.static, grid.arrays)
    b = traffic.build(tr, cell.config["engine"], 5, grid.static, grid.arrays)
    assert a.period % a.poses == 0
    if a.scene_period:
        assert a.period % a.scene_period == 0
        assert a.warmup % a.scene_period == 0
    assert a.warmup >= a.poses
    for g in range(2 * a.period):
        assert _key(a.frame(g)) == _key(a.frame(g + a.period))
        assert _key(a.frame(g)) == _key(b.frame(g))
    assert a.checked == b.checked
    assert all(0 <= k < a.period for k in a.checked)


def test_every_seed_gets_the_same_work(small_world):
    """Seeds reorder the period and redraw each voxel's material: the
    blocks, the period's (pose, sun, cycle phase) triples, and the batch
    kinds and voxels are the same for every seed."""
    cell, grid, _ = small_world
    seen = []
    for seed in SEEDS:
        t = traffic.build(cell.traffic, cell.config["engine"], seed,
                          grid.static, grid.arrays)
        work = sorted((np.concatenate([f.origin, f.yaw, f.sun_position,
                                       f.sun_color]).tobytes(),
                       g % t.scene_period, a.kind, a.xyz.tobytes())
                      for g, f in enumerate(t.frames) for a in f.actions)
        seen.append((work, t.period, t.warmup))
    assert all(s == seen[0] for s in seen[1:])


def test_a_checked_frame_shows_the_fullest_scene(small_world):
    """With edits one checked frame is one right after the cycle's fullest
    phase, and its camera sees the blocks: the reference's image of it
    with the cycle's inserts differs from the image without."""
    cell, grid, materials = small_world
    t = traffic.build(cell.traffic, cell.config["engine"], 31, grid.static,
                      grid.arrays)
    full = [k for k in t.checked
            if (t.warmup + k) % t.scene_period == t.fullest]
    assert full
    fr = t.frame(t.warmup + full[0])
    bare = RefEngine(copy.deepcopy(grid), materials, cell.config["engine"],
                     CPU)
    ref = RefEngine(copy.deepcopy(grid), materials, cell.config["engine"],
                    CPU)
    for g in range(t.fullest + 1):
        ref.advance(t.frame(g))
    changed = (ref.image(fr) - bare.image(fr)).abs().amax(-1) > 0
    assert int(changed.sum()) > 0


def _occupancy(static, arrays):
    return dense_materials(static, arrays) >= 0


def _check_cycles(apply, occupancy, bricks, tables, cycles=3):
    """Run `cycles` edit cycles through `apply(frame)`; the occupancy after
    each equals the set-up's, and after the first no batch moves the
    brick count."""
    start = occupancy()
    counts = []
    for c in range(cycles):
        for g in range(c * tables.scene_period,
                       (c + 1) * tables.scene_period):
            apply(tables.frame(g))
            counts.append(bricks())
        assert torch.equal(occupancy(), start), f"cycle {c}"
    after_first = counts[tables.scene_period - 1:]
    assert after_first and all(n == after_first[0] for n in after_first)


def test_brush_edits_are_stationary_in_the_reference(small_world):
    cell, grid, materials = small_world
    tables = traffic.build(cell.traffic, cell.config["engine"], 3,
                           grid.static, grid.arrays)
    ref = RefEngine(copy.deepcopy(grid), materials, cell.config["engine"],
                    CPU)
    _check_cycles(ref.advance,
                  lambda: _occupancy(ref.static, ref.grid.arrays),
                  lambda: int(ref.grid.arrays.active_bricks), tables)


def test_brush_edits_are_stationary_in_the_port(small_world, tmp_path):
    """The same through the port's engine, the harness's own calls."""
    from rtbench.ref.io import scene_io

    cell, grid, materials = small_world
    path = tmp_path / "scene.npz"
    scene_io.save_scene(str(path), grid.static, grid.arrays, materials)
    tables = traffic.build(cell.traffic, cell.config["engine"], 4,
                           grid.static, grid.arrays)
    rt = VoxelRT(*p_scene_io.load_scene(str(path)),
                 engine_config(cell.config["engine"]), device=CPU)
    program = Program(rt)
    program.pose(tables.frame(0))
    rt.draw()
    _check_cycles(program.act,
                  lambda: _occupancy(grid.static, rt.arrays),
                  lambda: int(rt.arrays.active_bricks), tables, cycles=2)


def test_full_size_stamps_are_whole_bricks_on_empty_voxels():
    """The real `brush_edits` on the real default scene: 32 blocks of
    8x8x8 voxels, each 2x2x2 whole bricks aligned to the block, empty in
    the set-up scene, on footprints that do not overlap, each standing on
    its footprint's highest voxel; two cycles through the reference leave
    the occupancy as it was and allocate no brick after the first."""
    bench = spec.load()
    cell = spec.cell(bench, "edit_brush_1080p")
    grid, materials = scene.build(cell.config["scene"])
    tables = traffic.build(cell.traffic, cell.config["engine"], 2**40 + 3,
                           grid.static, grid.arrays)
    edits = cell.traffic["edits"]
    n, b = edits["stamps"], edits["block"]
    assert tables.scene_period == 2 * n and tables.fullest == n - 1
    inserts = [a for g in range(n) for a in tables.frame(g).actions]
    assert [a.kind for a in inserts] == [traffic.INSERT] * n
    feet = set()
    for a in inserts:
        lo, hi = a.xyz.min(axis=0), a.xyz.max(axis=0)
        assert (hi - lo == b - 1).all() and (lo % b == 0).all()
        assert len({tuple(v) for v in a.xyz}) == b ** 3 == a.xyz.shape[0]
        assert not scene.occupied(grid.static, grid.arrays, a.xyz).any()
        below = a.xyz[a.xyz[:, 1] == lo[1]] - [0, 1, 0]
        lo_m, hi_m = edits["materials"]
        assert a.mats.min() >= lo_m and a.mats.max() <= hi_m
        feet.add((int(lo[0]), int(lo[2])))
        if lo[1] > 0:  # a block floats no more than a block over the top
            drop = np.concatenate([below - [0, k, 0] for k in range(b)])
            assert scene.occupied(grid.static, grid.arrays, drop).any()
    assert len(feet) == n
    ref = RefEngine(grid, materials, cell.config["engine"], CPU)
    _check_cycles(ref.advance,
                  lambda: _occupancy(ref.static, ref.grid.arrays),
                  lambda: int(ref.grid.arrays.active_bricks), tables,
                  cycles=2)
