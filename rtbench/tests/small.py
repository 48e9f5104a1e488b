"""The cells of `BENCHMARK.json` cut to a size the CPU tests can run: a
32x16x32-cell default scene placed under the path (so that the stamps
are in view), 64x36 frames, a 6-pose path and, with edits, two stamps.
Nothing else changes."""

from __future__ import annotations

import copy

from rtbench import spec


def small_cell(name: str, stamps: int = 2) -> spec.Cell:
    c = spec.cell(spec.load(), name)
    conf, tr = copy.deepcopy(c.config), copy.deepcopy(c.traffic)
    conf["scene"]["grid_dims"] = [32, 16, 32]
    conf["scene"]["min_point"] = [0.0, -4.0, 0.0]
    conf["engine"].update(
        internal_resolution_width=64, internal_resolution_height=36,
        output_resolution_width=64, output_resolution_height=36)
    tr["path_dt_s"] = tr["sun_dt_s"] = 10.0
    if tr.get("edits"):
        tr["edits"].update(stamps=stamps)
    return spec.Cell(c.name, c.config_name, c.traffic_name, c.chips, conf,
                     tr)
