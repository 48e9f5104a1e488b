"""Reference engine `plain_banded`: `rtbench.ref.engine.RefEngine` with the
traced image rendered in blocks of rows, for a frame too large to trace as
one wavefront of the plain twins (3840x2160 at 2 spp: 16.6M lanes a level).

`traced` renders `BLOCK_ROWS` rows at a time (the last block the rest)
through the frozen `rtbench.ref.ops.trace.render_rows(row0=, rows=)`, whose
rows rendered as a band equal those rows of the whole frame bit for bit, and
joins the blocks on the reference's device; `present` post-processes the
whole traced image, as `plain` does. The blocks are rows of one image on
one device: nothing of the program's mesh, shards, halos or assembly is
copied here.
"""

from __future__ import annotations

import numpy as np
import torch

from rtbench.ref.engine import RefEngine
from rtbench.ref.ops import trace

BLOCK_ROWS = 540  # rows traced at a time: 4,147,200 lanes at 3840 x 2 spp


class Engine(RefEngine):
    """`RefEngine` whose traced image is made block by block."""

    def traced(self, origin, yaw, sun_position, sun_color, spp=None):
        """The traced image f32[ih, iw, 3] of one frame (before the
        post-process), at the configuration's samples a pixel or `spp`,
        `BLOCK_ROWS` rows at a time."""
        e = self.engine
        sun, tc, cam = e["sun"], e["trace"], e["camera"]
        width = e["internal_resolution_width"]
        height = e["internal_resolution_height"]
        arrays, _, records = self.scene()
        basis = self.basis(origin, yaw)
        blocks = []
        for row0 in range(0, height, BLOCK_ROWS):
            blocks.append(trace.render_rows(
                self.static, records, arrays.material_indices, self.mats,
                basis, width, height, spp or cam["samples_per_pixel"],
                cam["max_bounce"] + 1,
                np.asarray(sun_position, dtype=np.float32),
                np.asarray(sun_color, dtype=np.float32),
                np.float32(sun["radius"]), bool(sun["enabled"]),
                max_steps=tc["max_steps"], sample_base=0.0,
                shadow_probe=bool(tc["sun_in_kernel"]),
                use_skip=bool(tc["empty_skip"]), row0=row0,
                rows=min(BLOCK_ROWS, height - row0)))
        return torch.cat(blocks)
