"""Image output.

The reference presents frames through a Vulkan swapchain; the port is
headless and writes frames to PNG/PPM (the stb_image analog, SURVEY.md §2b)
for golden-image tests and offline inspection. A numpy copy of
`zig_vulkan_tpu.io.image`: it takes host arrays, so callers bring device
images over first (`VoxelRT.device_image_to_host`).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_uint8(image) -> np.ndarray:
    """f32[H,W,3] in [0,1] -> uint8[H,W,3]."""
    arr = np.asarray(image)
    return np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)


def write_ppm(path: str, image) -> None:
    """Binary PPM (no dependencies)."""
    arr = to_uint8(image)
    h, w, _ = arr.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(arr.tobytes())


def write_png(path: str, image) -> None:
    """Minimal dependency-free PNG writer (8-bit RGB)."""
    arr = to_uint8(image)
    h, w, _ = arr.shape
    raw = b"".join(b"\x00" + arr[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", header)
           + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def read_ppm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        if f.readline().strip() != b"P6":
            raise ValueError(f"{path}: not a binary PPM (P6)")
        line = f.readline()
        while line.startswith(b"#"):
            line = f.readline()
        w, h = (int(v) for v in line.split())
        if int(f.readline()) != 255:
            raise ValueError(f"{path}: only 8-bit PPM is supported")
        data = np.frombuffer(f.read(w * h * 3), dtype=np.uint8)
    return data.reshape(h, w, 3)
