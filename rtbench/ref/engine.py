"""The plain reference of a cell's frames: the scene, its edits and a frame.

It follows the engine's documented semantics (zig_vulkan_tpu_torch/engine/
engine.py: VoxelRT) with the plain torch twins of this package and no graph,
no padding, no push constants and no incremental update:

- the scene lives in a host `BrickGrid` (the scene builder's own arrays);
  an insert is `BrickGrid.insert_batch` (a brick and its material window
  allocated for each cell seen for the first time), a removal
  `remove_batch` (occupancy bits only: bricks are never freed);
- before a frame is traced, the scene goes to the device whole and its
  records are built from scratch (`ops.trace.build_trace_tables`) with the
  skip field the program's records carry at that point: the exact field
  of the scene while no insert has followed the first frame, and after
  one, the conservative field of the scene's loaded cells (the program
  rebuilds that field whole on every insert; removals load and free
  nothing, so it stays valid);
- a frame is the camera of the pose (vertical fov 75 degrees, the yaw given,
  pitch identity), `ops.trace.render_rows` (camera rays, the bounce levels'
  traversal, material lookup and shading with sun shadows, the resolve),
  then the sirBird post-process at its integer `samples`
  (`ops.denoise.postprocess`, the static path).

The program's edit path (its device scatters, its row refreshes and its
field updates) is not copied here: the reference works the records out
again from the scene alone.

`precision="bfloat16"` rounds the traced image and the presented image to
bfloat16: the control that the comparison must reject.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import CameraConfig, DenoiserConfig
from .core.camera import Camera
from .core.grid import dense_materials
from .ops import denoise, trace
from .utils import quat as q

VFOV_DEGREES = 75.0  # VoxelRT.init's camera (VoxelRT.zig)
PRECISIONS = ("float32", "bfloat16")


class RefEngine:
    """A scene (a host `BrickGrid` and its material table) and the frames
    of configuration `engine` (a configuration file's "engine" entry) over
    it, traced on `device`."""

    def __init__(self, grid, materials, engine: dict, device):
        if engine.get("temporal"):
            raise NotImplementedError(
                "the plain reference has no temporal mean")
        self.device = torch.device(device)
        self.engine = engine
        self.grid = grid
        self.grid.attach_materials(materials)
        self.static = grid.static
        self.mats = trace.materials_to_device(materials, self.device)
        self.inserted = False  # an insert after the first frame
        self._scene = None     # (arrays, field, records) on the device

    # -- the scene ----------------------------------------------------------
    def insert(self, xyz: np.ndarray, mats: np.ndarray) -> None:
        xyz = np.asarray(xyz, dtype=np.int64)
        self.grid.insert_batch(xyz[:, 0], xyz[:, 1], xyz[:, 2],
                               np.asarray(mats, dtype=np.uint8))
        self.inserted = True
        self._scene = None

    def remove(self, xyz: np.ndarray) -> None:
        xyz = np.asarray(xyz, dtype=np.int64)
        self.grid.remove_batch(xyz[:, 0], xyz[:, 1], xyz[:, 2])
        self._scene = None

    def advance(self, frame) -> None:
        """Make frame `frame`'s actions (`rtbench.traffic.Frame`)."""
        for action in frame.actions:
            action.reference(self)

    def scene(self):
        """(arrays, skip field, records) of the scene as it stands, on the
        device, built from scratch."""
        if self._scene is None:
            arrays = self.grid.arrays.to_device(self.device)
            field = trace.distance_field(self.static, arrays,
                                         exact=not self.inserted)
            self._scene = (arrays, field,
                           trace.build_trace_tables(self.static, arrays,
                                                    field))
        return self._scene

    def dense(self):
        """The scene as `dense_materials` decodes it, on the device."""
        return dense_materials(self.static, self.scene()[0])

    # -- a frame ------------------------------------------------------------
    def basis(self, origin, yaw) -> dict:
        """The camera vectors of a pose on the device."""
        e = self.engine
        cam = Camera(VFOV_DEGREES, e["internal_resolution_width"],
                     e["internal_resolution_height"], CameraConfig(
                         samples_per_pixel=e["camera"]["samples_per_pixel"],
                         max_bounce=e["camera"]["max_bounce"]))
        cam.d_camera.origin = np.asarray(origin, dtype=np.float32)
        cam.yaw = np.asarray(yaw, dtype=np.float32)
        cam.pitch = q.quat_identity()
        cam.propagate_pitch_change()
        return trace.camera_vectors(cam.d_camera, self.device)

    def traced(self, origin, yaw, sun_position, sun_color, spp=None):
        """The traced image f32[ih, iw, 3] of one frame (before the
        post-process), at the configuration's samples a pixel or `spp`."""
        e = self.engine
        sun, tc, cam = e["sun"], e["trace"], e["camera"]
        arrays, _, records = self.scene()
        return trace.render_rows(
            self.static, records, arrays.material_indices, self.mats,
            self.basis(origin, yaw), e["internal_resolution_width"],
            e["internal_resolution_height"],
            spp or cam["samples_per_pixel"], cam["max_bounce"] + 1,
            np.asarray(sun_position, dtype=np.float32),
            np.asarray(sun_color, dtype=np.float32),
            np.float32(sun["radius"]), bool(sun["enabled"]),
            max_steps=tc["max_steps"], sample_base=0.0,
            shadow_probe=bool(tc["sun_in_kernel"]),
            use_skip=bool(tc["empty_skip"]))

    def present(self, img, precision: str = "float32"):
        """The presented image f32[out_h, out_w, 3] of a traced image."""
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        e = self.engine
        dn = e["denoiser"]
        low = precision == "bfloat16"
        if low:
            img = img.to(torch.bfloat16).to(torch.float32)
        out = denoise.postprocess(img, DenoiserConfig(
            samples=int(dn["samples"]),
            distribution_bias=dn["distribution_bias"],
            pixel_multiplier=dn["pixel_multiplier"],
            inverse_hue_tolerance=dn["inverse_hue_tolerance"],
            enabled=bool(dn["enabled"])), e["output_resolution_height"],
            e["output_resolution_width"])
        if low:
            out = out.to(torch.bfloat16).to(torch.float32)
        return out

    def image(self, frame, precision: str = "float32"):
        """The presented image f32[out_h, out_w, 3] of frame `frame`
        (`rtbench.traffic.Frame`), its actions already made."""
        return self.present(self.traced(frame.origin, frame.yaw,
                                        frame.sun_position,
                                        frame.sun_color), precision)
