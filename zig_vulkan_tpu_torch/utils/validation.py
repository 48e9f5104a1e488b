"""Validation / debug checks.

The torch counterpart of `zig_vulkan_tpu.utils.validation` (the reference's
Vulkan validation layers, SURVEY.md §5.2, validation_layer.zig:10-49):

- `enable_debug_mode()` is the "validation layers on" build. JAX flips a
  global NaN/Inf trap (`jax_debug_nans`); torch has none for eager
  kernels, so here it sets a module flag, and `VoxelRT.render` then checks
  every frame it returns with `check_image`;
- `validate_scene()` checks the brickmap invariants the reference guards
  with `std.debug.assert` (insert bounds Grid.zig:130-132, material window
  alignment Grid.zig:170-171, allocator capacity MaterialAllocator.zig:40);
- `check_image()` is the per-frame NaN oracle for render outputs.

The scene arrays are not checked for NaN: `brick_ir` holds NaN on purpose
(a brick without one dielectric ir).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import BRICK_BITS
from ..core.grid import UNSET_START_INDEX, GridArrays, GridStatic

_DEBUG = False


def enable_debug_mode() -> None:
    """The 'Debug build with validation layers' analog."""
    global _DEBUG
    _DEBUG = True


def disable_debug_mode() -> None:
    global _DEBUG
    _DEBUG = False


def debug_mode_enabled() -> bool:
    return _DEBUG


class SceneValidationError(AssertionError):
    pass


def _u32(a) -> np.ndarray:
    """A scene field on the host as uint32: host arrays as they are, the
    int32 bit views of `GridArrays.to_device` viewed back."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.int32 else a.astype(np.uint32)


def validate_scene(static: GridStatic, arrays: GridArrays) -> None:
    """Structural invariants of the brickmap, on host (numpy) or device
    (torch) arrays."""
    statuses = _u32(arrays.statuses)
    indices = _u32(arrays.indices)
    starts = _u32(arrays.start_indices)
    active = int(_u32(arrays.active_bricks))
    cursor = int(_u32(arrays.material_cursor))

    if active > static.brick_alloc:
        raise SceneValidationError(
            f"active_bricks {active} exceeds brick_alloc {static.brick_alloc}")
    if cursor > BRICK_BITS * static.brick_alloc:
        raise SceneValidationError("material cursor exceeds window capacity")
    if cursor % BRICK_BITS != 0:
        raise SceneValidationError("material cursor not window-aligned")

    cells = np.arange(static.cells)
    loaded = ((statuses[cells // 32] >> (cells % 32).astype(np.uint32)) & 1) == 1
    used_bricks = indices[loaded]
    if used_bricks.size:
        if used_bricks.max() >= active:
            raise SceneValidationError("cell references unallocated brick slot")
        used_starts = starts[used_bricks]
        if (used_starts == UNSET_START_INDEX).any():
            raise SceneValidationError("loaded brick without material window")
        vals = used_starts & np.uint32(0x7FFFFFFF)
        if (vals % BRICK_BITS).any():
            raise SceneValidationError(
                "material window start not 64-aligned (Grid.zig:170-171)")
        if (vals.astype(np.int64) + BRICK_BITS
                > BRICK_BITS * static.brick_alloc).any():
            raise SceneValidationError("material window exceeds capacity")


def check_image(image, what: str = "frame") -> None:
    """NaN/Inf/range oracle for rendered frames (a tensor on any device,
    or an array)."""
    t = torch.as_tensor(image)
    if not bool(torch.isfinite(t).all()):
        raise SceneValidationError(f"{what}: non-finite pixels")
    lo, hi = t.min().item(), t.max().item()
    if lo < -1e-5 or hi > 1.0 + 1e-5:
        raise SceneValidationError(
            f"{what}: pixels outside [0,1] ({lo}..{hi})")
