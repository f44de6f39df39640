"""Gray-8 image file I/O: BMP (8-bit palette), PGM/PNM (P5 binary).

The port's own copy of ``nblic_tpu/utils/imageio.py``; both write the same
bytes.  Matches the reference's pixel I/O contract (reference: src/FileIO.c:81-287):
- BMP: requires 'BM', 1 color plane, 8 bpp, BI_RGB; rows stored bottom-up with
  4-byte alignment. The writer emits a canonical 14+40+1024-byte header with a
  256-entry gray palette, so round-trips are pixel-exact (not byte-exact with
  arbitrary input headers — same as the reference).
- PGM: binary 'P5' with maxval in 1..255.

All functions operate on numpy uint8 arrays of shape (H, W).
"""

from __future__ import annotations

import re
import struct

import numpy as np

_BMP_ROW_ALIGN = 4


def _aligned_width(width: int) -> int:
    return (width + _BMP_ROW_ALIGN - 1) // _BMP_ROW_ALIGN * _BMP_ROW_ALIGN


def load_bmp_gray(data: bytes) -> np.ndarray:
    """Parse an 8-bit grayscale (palette) BMP byte string into an (H, W) uint8 array.

    Mirrors the validation rules of the reference loader (FileIO.c:170-226).
    """
    if len(data) < 34 or data[:2] != b"BM":
        raise ValueError("not a BMP file")
    (offset,) = struct.unpack_from("<I", data, 10)
    width, height = struct.unpack_from("<ii", data, 18)
    color_planes, bpp = struct.unpack_from("<HH", data, 26)
    (compression,) = struct.unpack_from("<I", data, 30)
    if color_planes != 1 or bpp != 8 or compression != 0 or width < 1 or height < 1:
        raise ValueError("unsupported BMP: need 8-bit uncompressed grayscale")
    stride = _aligned_width(width)
    pixels = np.frombuffer(data, dtype=np.uint8, count=stride * height, offset=offset)
    rows = pixels.reshape(height, stride)[:, :width]
    return rows[::-1].copy()  # BMP rows are bottom-up


def save_bmp_gray(img: np.ndarray) -> bytes:
    """Serialize an (H, W) uint8 array as a canonical gray-palette BMP.

    Byte-identical header layout to the reference writer (FileIO.c:233-287).
    """
    img = np.ascontiguousarray(img, dtype=np.uint8)
    height, width = img.shape
    stride = _aligned_width(width)
    file_size = 14 + 40 + 1024 + height * stride
    header = struct.pack("<2sIII", b"BM", file_size, 0, 0x436)
    dib = struct.pack(
        "<IiiHHIIiiII", 40, width, height, 1, 8, 0, 0, 0xEC4, 0xEC4, 0x100, 0
    )
    palette = bytes(bytearray(v for i in range(256) for v in (i, i, i, 0xFF)))
    rows = np.zeros((height, stride), dtype=np.uint8)
    rows[:, :width] = img[::-1]
    return header + dib + palette + rows.tobytes()


def load_pgm(data: bytes) -> np.ndarray:
    """Parse a binary PGM/PNM (P5, maxval 1..255) into an (H, W) uint8 array.

    Mirrors FileIO.c:81-134 (whitespace-delimited header, one separator byte
    before the raster). Comments (# lines) are also tolerated, which is a strict
    superset of the reference parser.
    """
    if data[:2] != b"P5":
        raise ValueError("not a binary PGM (P5) file")
    # Tokenize the header: width, height, maxval; '#' starts a comment to EOL.
    pos = 2
    fields = []
    while len(fields) < 3:
        m = re.compile(rb"\s*(#[^\n]*\n|\S+)").match(data, pos)
        if m is None:
            raise ValueError("truncated PGM header")
        pos = m.end()
        tok = m.group(1)
        if not tok.startswith(b"#"):
            fields.append(int(tok))
    width, height, maxval = fields
    if not (1 <= maxval <= 255) or width < 1 or height < 1:
        raise ValueError("unsupported PGM: need 8-bit, positive dimensions")
    pos += 1  # single whitespace byte separating header from raster
    n = width * height
    pixels = np.frombuffer(data, dtype=np.uint8, count=n, offset=pos)
    return pixels.reshape(height, width).copy()


def save_pgm(img: np.ndarray) -> bytes:
    """Serialize an (H, W) uint8 array as binary PGM (FileIO.c:141-159)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    height, width = img.shape
    return b"P5\n%d %d\n255\n" % (width, height) + img.tobytes()


def load_image(path: str) -> np.ndarray:
    """Load a gray-8 image from a .bmp/.pgm/.pnm path (format sniffed by magic)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"BM":
        return load_bmp_gray(data)
    if data[:2] == b"P5":
        return load_pgm(data)
    raise ValueError(f"{path}: not a gray-8 BMP or binary PGM/PNM file")


def save_image(path: str, img: np.ndarray) -> None:
    """Save an (H, W) uint8 array; format chosen by file suffix (.bmp vs .pgm/.pnm)."""
    lower = path.lower()
    data = save_bmp_gray(img) if lower.endswith(".bmp") else save_pgm(img)
    with open(path, "wb") as f:
        f.write(data)
