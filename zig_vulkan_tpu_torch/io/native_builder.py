"""ctypes bridge to the native C++ grid builder (native/gridbuilder.cpp).

The reference's host runtime builds scenes with worker threads and atomics
(terrain.zig:113-127, Grid.zig:141-148); the repository's native library
re-implements that path, and this wrapper drives it and imports the result
into the port's `core.grid.BrickGrid`. A copy of
`zig_vulkan_tpu.io.native_builder` over the same C++ source, used as it
is. The library is compiled on first use with g++ into this package's
`build/` directory (ignored by git), apart from the JAX package's, so the
two packages never load each other's library; `native_available()` is False
where no toolchain is installed, and the vectorized numpy builder
(`BrickGrid.insert_batch`, `io.terrain.generate`) builds the same scenes.

Because the native builder allocates brick slots in thread arrival order,
slot *numbering* differs run to run under multithreading (exactly like the
reference); scene semantics (which voxel has which material) are identical,
which is what the tests assert.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from ..config import GridConfig
from ..core.grid import BrickGrid

_LIB: Optional[ctypes.CDLL] = None
_LIB_FAILED = False

_SRC = Path(__file__).resolve().parents[2] / "native" / "gridbuilder.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "build"


def _build_library() -> Optional[Path]:
    so_path = _BUILD_DIR / "libzvtgrid.so"
    if not _SRC.exists():
        return None
    if so_path.exists() and so_path.stat().st_mtime >= _SRC.stat().st_mtime:
        return so_path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
           "-o", str(tmp), str(_SRC), "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, so_path)
    return so_path


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    path = _build_library()
    if path is None:
        _LIB_FAILED = True
        return None
    lib = ctypes.CDLL(str(path))
    lib.zvt_grid_create.restype = ctypes.c_void_p
    lib.zvt_grid_create.argtypes = [ctypes.c_uint32] * 3 + [ctypes.c_uint64]
    lib.zvt_grid_destroy.restype = None
    lib.zvt_grid_destroy.argtypes = [ctypes.c_void_p]
    lib.zvt_insert_batch.restype = ctypes.c_uint64
    lib.zvt_insert_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int]
    lib.zvt_generate_terrain.restype = None
    lib.zvt_generate_terrain.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_uint32, ctypes.c_double,
        ctypes.c_int64, ctypes.c_int]
    lib.zvt_export.restype = None
    lib.zvt_export.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint32)]
    _LIB = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeGridBuilder:
    """Builds a scene natively, then exports into a BrickGrid."""

    def __init__(self, dim_x: int, dim_y: int, dim_z: int,
                 config: GridConfig = GridConfig()):
        lib = _load()
        if lib is None:
            raise RuntimeError("native grid builder unavailable (no g++)")
        self._lib = lib
        self._grid = BrickGrid(dim_x, dim_y, dim_z, config)  # layout template
        alloc = self._grid.static.brick_alloc
        self._handle = lib.zvt_grid_create(dim_x, dim_y, dim_z, alloc)
        self.threads = max(1, int(config.workers_count))

    def insert_batch(self, x, y, z, material_index) -> int:
        """Insert voxels; returns how many were inserted (the library skips
        voxels outside the grid)."""
        xs = np.ascontiguousarray(x, dtype=np.int64)
        ys = np.ascontiguousarray(y, dtype=np.int64)
        zs = np.ascontiguousarray(z, dtype=np.int64)
        ms = np.ascontiguousarray(material_index, dtype=np.uint8)
        n = xs.size
        if not (ys.size == zs.size == ms.size == n):
            raise ValueError("x, y, z and material_index differ in length")
        ok = self._lib.zvt_insert_batch(
            self._handle, n, _ptr(xs, ctypes.c_int64),
            _ptr(ys, ctypes.c_int64), _ptr(zs, ctypes.c_int64),
            _ptr(ms, ctypes.c_uint8), self.threads)
        return int(ok)

    def generate_terrain(self, seed: int = 420, scale: float = 4.0,
                         ocean_level: int = 20) -> None:
        """Native perlin terrain with the same tables/hashes as io.terrain."""
        from .terrain import PerlinNoise

        p = PerlinNoise(seed)
        rf = np.ascontiguousarray(p.rand_float, dtype=np.float64)
        px = np.ascontiguousarray(p.perm_x, dtype=np.int32)
        py = np.ascontiguousarray(p.perm_y, dtype=np.int32)
        pz = np.ascontiguousarray(p.perm_z, dtype=np.int32)
        self._lib.zvt_generate_terrain(
            self._handle, _ptr(rf, ctypes.c_double),
            _ptr(px, ctypes.c_int32), _ptr(py, ctypes.c_int32),
            _ptr(pz, ctypes.c_int32), seed & 0xFFFFFFFF, float(scale),
            int(ocean_level), self.threads)

    def finish(self) -> BrickGrid:
        """Export native arrays into the BrickGrid and free the handle."""
        g = self._grid
        a = g.arrays
        counters = np.zeros(2, dtype=np.uint32)
        self._lib.zvt_export(
            self._handle,
            _ptr(a.statuses, ctypes.c_uint32), _ptr(a.indices, ctypes.c_uint32),
            _ptr(a.occupancy, ctypes.c_uint32),
            _ptr(a.start_indices, ctypes.c_uint32),
            _ptr(a.material_indices, ctypes.c_uint8),
            _ptr(counters, ctypes.c_uint32))
        a.active_bricks = np.uint32(counters[0])
        a.material_cursor = np.uint32(counters[1])
        self._lib.zvt_grid_destroy(self._handle)
        self._handle = None
        g.rebuild_dielectric_masks()
        return g
