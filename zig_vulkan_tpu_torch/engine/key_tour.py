"""The key tour: the moves between frames that change the compiled step's
key or add an edit size, each made and then undone.

A user toggles the sun, the samples per pixel, the bounces, the denoiser's
pixel multiplier and on/off, the in-kernel sun probe, temporal
accumulation and `empty_skip`, reloads the scene (`flush_grid`) and edits
voxels in batches of several sizes. The JAX engine compiles a step once a
key and an edit program once a padded size, and keeps them all; so does
this package's engine, which captures a graph where JAX compiles.
`tests/test_torch_step_cache.py` drives both engines through the same
tour, and `chip_smoke.py` drives the card's engine through it twice
(phase 22: the second round captures nothing).

A move is `fn(rt, ui)` of an engine and its `ControlPanel`; it calls only
what the two packages share, so the same moves drive either engine.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import numpy as np

# voxels in the tour's edit batches: one batch a padded size, 1024 lanes
# times 1, 2, 4, 8, 16 and 32
EDIT_SIZES = (1000, 2000, 4000, 8000, 16000, 17000)
FLIPPED_EDITS = (600, 300)  # an insert and a removal, empty_skip flipped

Move = Tuple[str, Callable]


def _trace(**knobs):
    def move(rt, ui):
        rt.trace_config = dataclasses.replace(rt.trace_config, **knobs)
    return move


def _insert(xyz, mats):
    return lambda rt, ui: rt.insert_voxels(xyz, mats)


def _remove(xyz):
    return lambda rt, ui: rt.remove_voxels(xyz)


def edit_batch(rng, n, box):
    """`n` voxel coordinates int32[n, 3] drawn in `box` = ((x0, y0, z0),
    (x1, y1, z1)) (upper bounds excluded), and their materials uint8[n]
    (1-8)."""
    lo, hi = (np.asarray(b) for b in box)
    xyz = rng.integers(lo, hi, (n, 3)).astype(np.int32)
    return xyz, rng.integers(1, 9, n).astype(np.uint8)


def key_tour(rt, flush: Callable, box, seed: int = 0) -> List[Move]:
    """The tour's moves from `rt`'s settings: the values it starts from are
    put back at the end of each group, so a second round repeats the first
    one's keys. `flush(rt)` reloads `rt`'s scene from a host grid of the
    same geometry. The edits draw their voxels in `box` (see
    `edit_batch`) from `seed`."""
    d = rt.camera.d_camera
    spp, bounce = int(d.samples_per_pixel), int(d.max_bounce)
    multiplier = float(rt.denoiser.pixel_multiplier)
    probe = bool(rt.trace_config.sun_in_kernel)
    skip = bool(rt.trace_config.empty_skip)
    rng = np.random.default_rng(seed)
    moves: List[Move] = [
        ("sun off", lambda rt, ui: ui.set_sun_enabled(False)),
        ("sun on", lambda rt, ui: ui.set_sun_enabled(True))]
    for n in (1, 3, 1, spp):
        moves.append((f"spp {n}",
                      lambda rt, ui, n=n: ui.set_samples_per_pixel(n)))
    for n in (2, 3, 2, bounce):
        moves.append((f"bounce {n}", lambda rt, ui, n=n: ui.set_max_bounce(n)))
    for m in (1.5, 2.0, 1.5, multiplier):
        moves.append((f"pixel_multiplier {m}", lambda rt, ui, m=m:
                      ui.set_denoiser(pixel_multiplier=m)))
    moves += [
        ("denoiser off", lambda rt, ui: ui.set_denoiser(enabled=False)),
        ("denoiser on", lambda rt, ui: ui.set_denoiser(enabled=True)),
        ("sun_in_kernel on", _trace(sun_in_kernel=not probe)),
        ("sun_in_kernel back", _trace(sun_in_kernel=probe)),
        # the running mean goes on over a new temporal key and back, and
        # starts again where the pose moves
        ("temporal on", lambda rt, ui: rt.set_temporal(True)),
        ("temporal, spp 3", lambda rt, ui: ui.set_samples_per_pixel(3)),
        (f"temporal, spp {spp}",
         lambda rt, ui: ui.set_samples_per_pixel(spp)),
        ("temporal, camera moved",
         lambda rt, ui: rt.camera.translate(0.2, [1.0, 0.0, 0.0])),
        ("temporal, camera moved back",
         lambda rt, ui: rt.camera.translate(0.2, [-1.0, 0.0, 0.0])),
        ("temporal off", lambda rt, ui: rt.set_temporal(False)),
        ("empty_skip flipped", _trace(empty_skip=not skip))]
    ins, mats = edit_batch(rng, FLIPPED_EDITS[0], box)
    moves += [
        (f"flipped, insert {FLIPPED_EDITS[0]}", _insert(ins, mats)),
        (f"flipped, remove {FLIPPED_EDITS[1]}",
         _remove(ins[:FLIPPED_EDITS[1]])),
        ("empty_skip back", _trace(empty_skip=skip)),
        ("flush_grid", lambda rt, ui: flush(rt))]
    batches = [edit_batch(rng, n, box) for n in EDIT_SIZES]
    moves += [(f"insert {len(xyz)}", _insert(xyz, mats))
              for xyz, mats in batches]
    moves += [(f"remove {len(xyz)}", _remove(xyz)) for xyz, _ in batches]
    return moves
