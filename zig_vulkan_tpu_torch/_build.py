"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

The sources (and the headers they include, csrc/*.cuh) compile with `nvcc` into one shared library with a plain C
interface, loaded with ctypes: no PyTorch headers, so a build takes seconds.
Each source compiles in its own nvcc process, all started together, and one
more links them. The library goes to `build/` inside this package (ignored
by git), named by a hash of the sources and flags, and is built on first
use.

`--fmad=false` keeps every `a*b + c` of the kernels two roundings, as the
torch versions and the JAX reference compute them; the build never uses
`--use_fast_math` (IEEE division and square root stay exact).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int


class TraceParams(ctypes.Structure):
    """Mirror of `struct TraceParams` in csrc/traverse.cu."""

    _fields_ = [
        ("g0", ctypes.c_float * 3),
        ("g1", ctypes.c_float * 3),
        ("scale", ctypes.c_float),
        ("voxel_scale", ctypes.c_float),
        ("park", ctypes.c_float),
        ("enter_eps", ctypes.c_float),
        ("t_off", ctypes.c_float),
        ("dims", ctypes.c_int * 3),
        ("cells", ctypes.c_int),
        ("mat_cap", ctypes.c_int),
        ("max_steps", ctypes.c_int),
        ("use_skip", ctypes.c_int),
        ("n", ctypes.c_int64),
    ]


def _pointers(*names):
    return [(name, _P) for name in names]


class CameraArgs(ctypes.Structure):
    """Mirror of `struct CameraArgs` in csrc/camera.cu (kernel C)."""

    _fields_ = _pointers(
        "origin", "horizontal", "vertical", "lower_left", "base_ptr",
        "sun_p_ptr", "radius_ptr", "ox", "oy", "oz", "dx", "dy", "dz",
        "tx", "ty", "tz") + [
        ("n", ctypes.c_int64),
        ("width", ctypes.c_int),
        ("rows", ctypes.c_int),
        ("spp", ctypes.c_int),
        ("row0", ctypes.c_float),
        ("w1", ctypes.c_float),
        ("h1", ctypes.c_float),
        ("base", ctypes.c_float),
        ("sun_p", ctypes.c_float * 3),
        ("radius", ctypes.c_float),
    ]


class ShadeArgs(ctypes.Structure):
    """Mirror of `struct ShadeArgs` in csrc/shade.cu (kernel D)."""

    _fields_ = _pointers(
        "found", "px", "py", "pz", "nx", "ny", "nz", "occluded",
        "albedo_r", "albedo_g", "albedo_b", "mtype", "type_data",
        "ox", "oy", "oz", "dx", "dy", "dz", "internal_refl", "ignore_type",
        "loop_count", "bouncing", "cr", "cg", "cb",
        "pr", "pg", "pb", "prev_occluded",
        "active", "shx", "shy", "shz", "key", "tx", "ty", "tz",
        "sun_p_ptr", "sun_c_ptr", "radius_ptr") + [
        ("n", ctypes.c_int64),
        ("sun", ctypes.c_int),
        ("sun_p", ctypes.c_float * 3),
        ("sun_c", ctypes.c_float * 3),
        ("radius", ctypes.c_float),
    ]


class ResolveArgs(ctypes.Structure):
    """Mirror of `struct ResolveArgs` in csrc/resolve.cu (kernel E)."""

    _fields_ = _pointers(
        "cr", "cg", "cb", "loop_count", "dy", "pr", "pg", "pb", "occluded",
        "sun_c_ptr", "out") + [
        ("m", ctypes.c_int64),
        ("spp", ctypes.c_int),
        ("sun", ctypes.c_int),
        ("gamma", ctypes.c_int),
        ("sun_c", ctypes.c_float * 3),
    ]


DENOISE_MAX_TAPS = 33  # csrc/denoise.cu: ops.denoise.MAX_RUNTIME_SAMPLES + 1


class DenoiseArgs(ctypes.Structure):
    """Mirror of `struct DenoiseArgs` in csrc/denoise.cu (kernel F)."""

    _fields_ = _pointers("img", "out") + [
        (name, ctypes.c_int) for name in (
            "w_in", "height", "a", "row_lo", "row_hi", "w_out", "h_out",
            "r0", "r1", "mode", "hue_pow", "n_taps", "tiled", "hx0", "hx1",
            "hy0", "hy1", "block_rows", "smem")] + [
        ("hue_exp", ctypes.c_float),
        ("sat_exp", ctypes.c_float),
        ("x0", ctypes.c_int * DENOISE_MAX_TAPS),
        ("y0", ctypes.c_int * DENOISE_MAX_TAPS)] + [
        (name, ctypes.c_float * DENOISE_MAX_TAPS) for name in (
            "fx", "fy", "gx", "gy", "ou", "ov", "influence", "r2")] + [
        ("runtime", ctypes.c_int)] + _pointers("samples", "bias", "hue")


class EditArgs(ctypes.Structure):
    """Mirror of `struct EditArgs` in csrc/edit.cu (the voxel edits)."""

    _fields_ = _pointers(
        "statuses", "indices", "occupancy", "start_indices",
        "material_indices", "active_bricks", "material_cursor", "diel_mask",
        "brick_ir", "mat_is_diel", "mat_ir", "buf", "tables", "dist",
        "scratch") + [
        ("size", ctypes.c_int64),
        ("material_bytes", ctypes.c_int64),
        ("dims", ctypes.c_int * 3),
        ("cells", ctypes.c_int),
        ("brick_alloc", ctypes.c_int),
    ]


# C entry points: name -> argtypes; every one returns a CUDA error code
_SIGNATURES = {
    # params, tables, material_indices, ox, oy, oz, dx, dy, dz, ray_key
    # (NULL = no key), active, sun targets tx, ty, tz (NULL = no shadow
    # ray), found, t, px, py, pz, nx, ny, nz, index, occluded (with the
    # targets), n_step (NULL = no stats), stream
    "zvt_traverse": [ctypes.POINTER(TraceParams)] + [_P] * 25,
    # tables, n_tables, size, idx, n, out, stream
    "zvt_table_lookup": [_P, _I32, _I32, _P, _I64, _P, _P],
    # args, stream
    "zvt_camera_rays": [ctypes.POINTER(CameraArgs), _P],
    "zvt_shade": [ctypes.POINTER(ShadeArgs), _P],
    "zvt_resolve": [ctypes.POINTER(ResolveArgs), _P],
    "zvt_denoise": [ctypes.POINTER(DenoiseArgs), _P],
    # args, blocks an SM (out)
    "zvt_denoise_occupancy": [ctypes.POINTER(DenoiseArgs),
                              ctypes.POINTER(ctypes.c_int)],
    # args, stream
    "zvt_edit_insert": [ctypes.POINTER(EditArgs), _P],
    "zvt_edit_field": [ctypes.POINTER(EditArgs), _P],
    "zvt_edit_remove": [ctypes.POINTER(EditArgs), _P],
}

_LIB = None
build_seconds = None  # wall time of the last compile in this process
build_log = ""        # nvcc's output of that compile (ptxas -v included)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return str(path)


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _headers():
    return sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libzvt_kernels_{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> Path:
    """Compile csrc/*.cu unless the library for these sources exists."""
    global build_seconds, build_log
    out = library_path()
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    srcs = _sources()
    objs, procs = [], []
    for src in srcs:
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [proc.communicate()[0] for proc in procs]
    build_log = "".join(logs)
    failed = [src.name for src, proc in zip(srcs, procs)
              if proc.returncode != 0]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True)
        build_log += link.stdout + link.stderr
        if link.returncode != 0:
            failed = ["link"]
    build_seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{build_log}")
    os.replace(tmp, out)
    return out


def library(force_build: bool = False):
    """The loaded kernel library (built first if needed)."""
    global _LIB
    if _LIB is not None and not force_build:
        return _LIB
    lib = ctypes.CDLL(str(build(force=force_build)))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.zvt_error_string.argtypes = [ctypes.c_int]
    lib.zvt_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def check(status: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        msg = _LIB.zvt_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} ({msg}) at launch")
