"""MagicaVoxel .vox scene import.

Re-implements the reference's VOX v150 parser (reference:
src/modules/voxel_rt/vox/loader.zig, spec cited at loader.zig:8) with the
same behaviors:

- optional `strict` validation of the "VOX " magic, version byte 150, and
  "MAIN" chunk id (loader.zig:216-229), raising the same error conditions;
- MAIN -> optional PACK -> per-model SIZE + XYZI chunk walk
  (loader.zig:41-150);
- RGBA palette handling quirk preserved: palette[0] is forced to
  (0, 0, 0, 1) and exactly 254 entries are read into slots 1..254
  (loader.zig:167-183); slot 255 stays zero;
- unknown trailing chunks are skipped 4 bytes at a time while scanning for
  an RGBA chunk (loader.zig:185-189);
- the default 256-color palette when no RGBA chunk exists
  (loader.zig:246-263), decoded little-endian as {r,g,b,a} bytes.

Also provides `write` (fixture/export superset feature) so tests can build
valid .vox buffers without binary assets.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Sequence, Tuple

import numpy as np


class VoxParseError(ValueError):
    """Parse failures (reference loader.zig ParseError, loader.zig:32-40)."""


class InvalidId(VoxParseError):
    pass


class UnexpectedVersion(VoxParseError):
    pass


class InvalidFileContent(VoxParseError):
    pass


class ExpectedSizeHeader(VoxParseError):
    pass


class ExpectedXyziHeader(VoxParseError):
    pass


class ExpectedRgbaHeader(VoxParseError):
    pass


@dataclasses.dataclass
class Vox:
    """A parsed .vox file (reference vox/types.zig:6-41)."""

    version_number: int
    num_models: int
    sizes: List[Tuple[int, int, int]]     # per-model (x, y, z); z is gravity
    models: List[np.ndarray]              # per-model uint8[N, 4] = x,y,z,color_index
    palette: np.ndarray                   # uint8[256, 4] = r,g,b,a


def validate_header(buffer: bytes) -> None:
    """Header validation (reference loader.zig:216-229)."""
    if buffer[0:4] != b"VOX ":
        raise InvalidId("vox format should start with 'VOX '")
    if buffer[4] != 150:
        raise UnexpectedVersion("expected vox version 150")
    if buffer[8:12] != b"MAIN":
        raise InvalidFileContent("missing MAIN chunk")


def _i32(buffer: bytes, pos: int) -> int:
    return struct.unpack_from("<i", buffer, pos)[0]


_CHUNK_STRIDE = 12  # id (4) + chunk size (4) + child size (4)


def parse_buffer(buffer: bytes, strict: bool = False) -> Vox:
    """Parse a .vox byte buffer (reference loader.zig:41-198)."""
    if strict:
        validate_header(buffer)

    pos = 8 + _CHUNK_STRIDE  # skip file header + MAIN chunk header

    # optional PACK chunk
    if buffer[pos : pos + 1] == b"P":
        pos += _CHUNK_STRIDE
        num_models = _i32(buffer, pos)
        pos += 4
    else:
        num_models = 1

    sizes: List[Tuple[int, int, int]] = []
    models: List[np.ndarray] = []
    for _ in range(num_models):
        if strict and buffer[pos : pos + 4] != b"SIZE":
            raise ExpectedSizeHeader("expected SIZE chunk")
        pos += _CHUNK_STRIDE
        sizes.append((_i32(buffer, pos), _i32(buffer, pos + 4), _i32(buffer, pos + 8)))
        pos += 12

        if strict and buffer[pos : pos + 4] != b"XYZI":
            raise ExpectedXyziHeader("expected XYZI chunk")
        pos += _CHUNK_STRIDE
        voxel_count = _i32(buffer, pos)
        pos += 4
        raw = np.frombuffer(buffer, dtype=np.uint8, count=voxel_count * 4, offset=pos)
        models.append(raw.reshape(voxel_count, 4).copy())
        pos += voxel_count * 4

    palette = np.zeros((256, 4), dtype=np.uint8)
    rgba_set = False
    n = len(buffer)
    while pos < n:
        if buffer[pos : pos + 1] == b"R":
            if strict and buffer[pos : pos + 4] != b"RGBA":
                raise ExpectedRgbaHeader("expected RGBA chunk")
            pos += _CHUNK_STRIDE
            # reference quirk (loader.zig:167-183): slot 0 = (0,0,0,1),
            # exactly 254 entries read into 1..254, slot 255 untouched
            palette[0] = (0, 0, 0, 1)
            raw = np.frombuffer(buffer, dtype=np.uint8, count=254 * 4, offset=pos)
            palette[1:255] = raw.reshape(254, 4)
            pos += 254 * 4
            rgba_set = True
        else:
            pos += 4  # skip scan (loader.zig:185-189)

    if not rgba_set:
        palette = default_palette()

    return Vox(
        version_number=150,
        num_models=num_models,
        sizes=sizes,
        models=models,
        palette=palette,
    )


def load(path: str, strict: bool = False) -> Vox:
    """Load a .vox file from disk (reference loader.zig:9-30)."""
    with open(path, "rb") as f:
        return parse_buffer(f.read(), strict=strict)


def write(path_or_buf, sizes: Sequence[Tuple[int, int, int]],
          models: Sequence[np.ndarray], palette: np.ndarray | None = None) -> bytes:
    """Serialize models to a VOX v150 buffer (superset feature / fixtures)."""
    body = b""
    if len(models) != 1:
        body += b"PACK" + struct.pack("<ii", 4, 0) + struct.pack("<i", len(models))
    for (sx, sy, sz), voxels in zip(sizes, models):
        body += b"SIZE" + struct.pack("<ii", 12, 0) + struct.pack("<iii", sx, sy, sz)
        voxels = np.asarray(voxels, dtype=np.uint8)
        body += (b"XYZI" + struct.pack("<ii", 4 + voxels.size, 0)
                 + struct.pack("<i", voxels.shape[0]) + voxels.tobytes())
    if palette is not None:
        pal = np.asarray(palette, dtype=np.uint8)
        # the on-disk chunk stores entries that land at parsed slots 1..254
        body += b"RGBA" + struct.pack("<ii", 1024, 0) + pal[1:255].tobytes() + b"\x00" * 8
    buf = b"VOX " + struct.pack("<i", 150)
    buf += b"MAIN" + struct.pack("<ii", 0, len(body)) + body
    if isinstance(path_or_buf, (str, bytes)) and isinstance(path_or_buf, str):
        with open(path_or_buf, "wb") as f:
            f.write(buf)
    return buf


# Default 256-color palette (reference loader.zig:246-263), stored as the
# same u32 constants and decoded little-endian into {r,g,b,a} bytes.
_DEFAULT_PALETTE_U32 = [
    0x00000000, 0xffffffff, 0xffccffff, 0xff99ffff, 0xff66ffff, 0xff33ffff, 0xff00ffff, 0xffffccff, 0xffccccff, 0xff99ccff, 0xff66ccff, 0xff33ccff, 0xff00ccff, 0xffff99ff, 0xffcc99ff, 0xff9999ff,
    0xff6699ff, 0xff3399ff, 0xff0099ff, 0xffff66ff, 0xffcc66ff, 0xff9966ff, 0xff6666ff, 0xff3366ff, 0xff0066ff, 0xffff33ff, 0xffcc33ff, 0xff9933ff, 0xff6633ff, 0xff3333ff, 0xff0033ff, 0xffff00ff,
    0xffcc00ff, 0xff9900ff, 0xff6600ff, 0xff3300ff, 0xff0000ff, 0xffffffcc, 0xffccffcc, 0xff99ffcc, 0xff66ffcc, 0xff33ffcc, 0xff00ffcc, 0xffffcccc, 0xffcccccc, 0xff99cccc, 0xff66cccc, 0xff33cccc,
    0xff00cccc, 0xffff99cc, 0xffcc99cc, 0xff9999cc, 0xff6699cc, 0xff3399cc, 0xff0099cc, 0xffff66cc, 0xffcc66cc, 0xff9966cc, 0xff6666cc, 0xff3366cc, 0xff0066cc, 0xffff33cc, 0xffcc33cc, 0xff9933cc,
    0xff6633cc, 0xff3333cc, 0xff0033cc, 0xffff00cc, 0xffcc00cc, 0xff9900cc, 0xff6600cc, 0xff3300cc, 0xff0000cc, 0xffffff99, 0xffccff99, 0xff99ff99, 0xff66ff99, 0xff33ff99, 0xff00ff99, 0xffffcc99,
    0xffcccc99, 0xff99cc99, 0xff66cc99, 0xff33cc99, 0xff00cc99, 0xffff9999, 0xffcc9999, 0xff999999, 0xff669999, 0xff339999, 0xff009999, 0xffff6699, 0xffcc6699, 0xff996699, 0xff666699, 0xff336699,
    0xff006699, 0xffff3399, 0xffcc3399, 0xff993399, 0xff663399, 0xff333399, 0xff003399, 0xffff0099, 0xffcc0099, 0xff990099, 0xff660099, 0xff330099, 0xff000099, 0xffffff66, 0xffccff66, 0xff99ff66,
    0xff66ff66, 0xff33ff66, 0xff00ff66, 0xffffcc66, 0xffcccc66, 0xff99cc66, 0xff66cc66, 0xff33cc66, 0xff00cc66, 0xffff9966, 0xffcc9966, 0xff999966, 0xff669966, 0xff339966, 0xff009966, 0xffff6666,
    0xffcc6666, 0xff996666, 0xff666666, 0xff336666, 0xff006666, 0xffff3366, 0xffcc3366, 0xff993366, 0xff663366, 0xff333366, 0xff003366, 0xffff0066, 0xffcc0066, 0xff990066, 0xff660066, 0xff330066,
    0xff000066, 0xffffff33, 0xffccff33, 0xff99ff33, 0xff66ff33, 0xff33ff33, 0xff00ff33, 0xffffcc33, 0xffcccc33, 0xff99cc33, 0xff66cc33, 0xff33cc33, 0xff00cc33, 0xffff9933, 0xffcc9933, 0xff999933,
    0xff669933, 0xff339933, 0xff009933, 0xffff6633, 0xffcc6633, 0xff996633, 0xff666633, 0xff336633, 0xff006633, 0xffff3333, 0xffcc3333, 0xff993333, 0xff663333, 0xff333333, 0xff003333, 0xffff0033,
    0xffcc0033, 0xff990033, 0xff660033, 0xff330033, 0xff000033, 0xffffff00, 0xffccff00, 0xff99ff00, 0xff66ff00, 0xff33ff00, 0xff00ff00, 0xffffcc00, 0xffcccc00, 0xff99cc00, 0xff66cc00, 0xff33cc00,
    0xff00cc00, 0xffff9900, 0xffcc9900, 0xff999900, 0xff669900, 0xff339900, 0xff009900, 0xffff6600, 0xffcc6600, 0xff996600, 0xff666600, 0xff336600, 0xff006600, 0xffff3300, 0xffcc3300, 0xff993300,
    0xff663300, 0xff333300, 0xff003300, 0xffff0000, 0xffcc0000, 0xff990000, 0xff660000, 0xff330000, 0xff0000ee, 0xff0000dd, 0xff0000bb, 0xff0000aa, 0xff000088, 0xff000077, 0xff000055, 0xff000044,
    0xff000022, 0xff000011, 0xff00ee00, 0xff00dd00, 0xff00bb00, 0xff00aa00, 0xff008800, 0xff007700, 0xff005500, 0xff004400, 0xff002200, 0xff001100, 0xffee0000, 0xffdd0000, 0xffbb0000, 0xffaa0000,
    0xff880000, 0xff770000, 0xff550000, 0xff440000, 0xff220000, 0xff110000, 0xffeeeeee, 0xffdddddd, 0xffbbbbbb, 0xffaaaaaa, 0xff888888, 0xff777777, 0xff555555, 0xff444444, 0xff222222, 0xff111111,
]


def default_palette() -> np.ndarray:
    """The built-in palette decoded to uint8[256, 4] {r,g,b,a}."""
    u32 = np.asarray(_DEFAULT_PALETTE_U32, dtype=np.uint32)
    return u32.view(np.uint8).reshape(256, 4).copy()
