"""zig_vulkan_tpu_torch — the voxel ray tracer on PyTorch and CUDA.

A port of `zig_vulkan_tpu` (the JAX/Pallas package beside it, which stays
the reference) to PyTorch for an NVIDIA H100. Module paths and function
names follow the reference's, so each counterpart is found at once:
`ops/trace.py:render_rows`, `ops/lookup.py:table_lookup`,
`engine/engine.py:VoxelRT`, and so on. The app starts as
`python -m zig_vulkan_tpu_torch.app.run`.

The reference's two Pallas kernels are hand-written CUDA here
(`csrc/traverse.cu`, `csrc/lookup.cu`, built by `_build.py`), and so is
the trace's shading, which XLA fuses in the reference (`csrc/camera.cu`,
`shade.cu`, `resolve.cu`; `ops/shade.py`); the denoiser and the rest are
torch ops. Each kernel's wrapper runs a plain torch version for CPU
tensors and launches the kernel for CUDA tensors.

This package never imports JAX or `zig_vulkan_tpu`.
"""

from .config import (
    CameraConfig,
    DenoiserConfig,
    EngineConfig,
    GridConfig,
    SunConfig,
    TraceConfig,
)
from .core.camera import Camera, CameraDevice
from .core.grid import BrickGrid, GridArrays, GridStatic
from .core.materials import MaterialTable, terrain_materials
from .core.sun import Sun, SunDevice
from .engine.engine import VoxelRT

__all__ = [
    "BrickGrid",
    "Camera",
    "CameraConfig",
    "CameraDevice",
    "DenoiserConfig",
    "EngineConfig",
    "GridArrays",
    "GridConfig",
    "GridStatic",
    "MaterialTable",
    "Sun",
    "SunConfig",
    "SunDevice",
    "TraceConfig",
    "VoxelRT",
    "terrain_materials",
]
