"""The camera's pose as one native host routine (csrc/pose_host.cpp).

`Camera.propagate_pitch_change` takes the pose through its `Pose` where the
routine can: one ctypes call in place of some 60 small numpy calls, with the
same float32 result bit for bit (the source says how). The library compiles
with g++ on first use into this package's `build/` directory (ignored by
git), named by a hash of the source and flags, so a checkout compiles it
once and later processes only load it. Where no toolchain is found,
`routine()` is None and the camera keeps its numpy twin, as
`io.native_builder.native_available()` does for the grid builder.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "csrc" / "pose_host.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
# -ffp-contract=off: no a*b + c fused into one rounding; no fast-math
FLAGS = ("-O3", "-shared", "-fPIC", "-ffp-contract=off")

_F32 = np.dtype(np.float32)
_ROUTINE = None
_FAILED = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libzvt_pose_{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    """The library, compiled unless it exists; None where g++ fails or is
    missing."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SRC)],
                       check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, OSError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)
    return out


def routine():
    """The loaded `zvt_pose` entry point (built first if needed), or None
    where the library cannot be built or loaded."""
    global _ROUTINE, _FAILED
    if _ROUTINE is not None or _FAILED:
        return _ROUTINE
    path = _build()
    try:
        fn = ctypes.CDLL(str(path)).zvt_pose if path is not None else None
    except OSError:
        fn = None
    if fn is None:
        _FAILED = True
        return None
    # yaw, pitch, origin, viewport width, viewport height, out
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_float] * 2 + [
        ctypes.c_void_p]
    fn.restype = None
    _ROUTINE = fn
    return fn


def _takes(a, n: int) -> bool:
    """Whether `a` is a float32[n] array: what the routine reads as the
    numpy twin would."""
    return getattr(a, "dtype", None) is _F32 and a.shape == (n,)


class Pose:
    """One camera's way to the routine: its staging buffers (the inputs
    copied in, the basis written out) at addresses fixed once, so a call
    converts no array to a pointer. A copy (`copy.deepcopy` of a camera)
    gets buffers and addresses of its own."""

    def __init__(self):
        self.inputs = np.zeros(11, _F32)
        self.yaw, self.pitch, self.origin = (
            self.inputs[0:4], self.inputs[4:8], self.inputs[8:11])
        self.out = np.zeros(9, _F32)
        base = self.inputs.ctypes.data
        self.args = (base, base + 16, base + 32)
        self.out_ptr = self.out.ctypes.data

    def __reduce__(self):
        return Pose, ()

    def __call__(self, yaw, pitch, origin, viewport_width,
                 viewport_height) -> Optional[np.ndarray]:
        """A fresh float32[9] (horizontal, vertical, lower-left corner) of
        the pose, or None where the routine cannot take it: no library, or
        inputs other than float32 (a float64 origin gives the numpy twin's
        float64 corner)."""
        fn = routine()
        if fn is None or not (_takes(yaw, 4) and _takes(pitch, 4)
                              and _takes(origin, 3)):
            return None
        self.yaw[...] = yaw
        self.pitch[...] = pitch
        self.origin[...] = origin
        fn(*self.args, viewport_width, viewport_height, self.out_ptr)
        return self.out.copy()
