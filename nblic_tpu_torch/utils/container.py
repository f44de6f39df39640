"""Container headers (NBLIC0.3, Q0.2, NBTC), size validation and sniffing.

The port's own copy of ``nblic_tpu/utils/container.py``; both write and
read the same bytes.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

# image limits of the format family
MAX_HEIGHT = 65535
MAX_WIDTH = 65535
MAX_IMG_SIZE = 100_000_000

NBLIC_MAGIC = b"NBLIC0.3"
QNBLIC_MAGIC = b"Q0.2"
NBTC_MAGIC = b"NBTC0001"


def check_size(height: int, width: int) -> None:
    """Size validation shared by all engines."""
    if height <= 0 or width <= 0:
        raise ValueError(f"invalid image size {height}x{width}")
    if height > MAX_HEIGHT or width > MAX_WIDTH or height * width > MAX_IMG_SIZE:
        raise ValueError(f"image too large: {height}x{width}")


def inflate(data: bytes, what: str) -> bytes:
    """zlib-decompress a container block; a corrupt one is a ValueError."""
    try:
        return zlib.decompress(data)
    except zlib.error as exc:
        raise ValueError(f"corrupt {what}: {exc}") from None


@dataclass(frozen=True)
class NblicHeader:
    """NBLIC0.3: magic, n_channel u8, height and width big-endian u16, near
    u8, k_step u8, effort u8; then the range coder's payload."""

    n_channel: int
    height: int
    width: int
    near: int
    k_step: int
    effort: int

    SIZE = 16

    def to_bytes(self) -> bytes:
        return NBLIC_MAGIC + struct.pack(
            ">BHHBBB", self.n_channel, self.height, self.width, self.near,
            self.k_step, self.effort,
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "NblicHeader":
        if data[: len(NBLIC_MAGIC)] != NBLIC_MAGIC:
            raise ValueError("not an NBLIC0.3 stream")
        if len(data) < cls.SIZE:
            raise ValueError("truncated NBLIC0.3 header")
        return cls(*struct.unpack_from(">BHHBBB", data, len(NBLIC_MAGIC)))


@dataclass(frozen=True)
class QnblicHeader:
    """Q0.2: the little-endian u16 words "Q0", ".2", height, width; then 12
    RLE-coded histograms and the word-reversed rANS payload."""

    height: int
    width: int

    SIZE = 8

    def to_bytes(self) -> bytes:
        return QNBLIC_MAGIC + struct.pack("<HH", self.height, self.width)

    @classmethod
    def from_bytes(cls, data: bytes) -> "QnblicHeader":
        if data[: len(QNBLIC_MAGIC)] != QNBLIC_MAGIC:
            raise ValueError("not a Q0.2 stream")
        if len(data) < cls.SIZE:
            raise ValueError("truncated Q0.2 header")
        return cls(*struct.unpack_from("<HH", data, len(QNBLIC_MAGIC)))


@dataclass(frozen=True)
class NbtcHeader:
    """Header of the tiled container.

    Layout (little-endian):
      magic (8B) | flags u16 (bit 0: image stored transposed) | profile u8 |
      near u8 | height u32 | width u32 | tile_h u16 | tile_w u16 |
      n_tiles u32 | bias_len u32 | hist_len u32,
    then the zlib'd int16[3072] bias table (bias_len bytes), the profile-2
    weight block, the RLE-coded 12 x 256 histograms (hist_len bytes), the
    group table and the interleaved rANS payload.
    """

    profile: int
    near: int
    height: int
    width: int
    tile_h: int
    tile_w: int
    n_tiles: int
    bias_len: int
    hist_len: int
    flags: int = 0  # bit 0: pixel data is the TRANSPOSE of the source image

    SIZE = len(NBTC_MAGIC) + 2 + 1 + 1 + 4 + 4 + 2 + 2 + 4 + 4 + 4

    @property
    def transposed(self) -> bool:
        return bool(self.flags & 1)

    def to_bytes(self) -> bytes:
        return NBTC_MAGIC + struct.pack(
            "<HBBIIHHIII", self.flags, self.profile, self.near, self.height,
            self.width, self.tile_h, self.tile_w, self.n_tiles, self.bias_len,
            self.hist_len,
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "NbtcHeader":
        if data[: len(NBTC_MAGIC)] != NBTC_MAGIC:
            raise ValueError("not an NBTC stream")
        if len(data) < cls.SIZE:
            raise ValueError("truncated NBTC header")
        (flags, profile, near, height, width, tile_h, tile_w, n_tiles,
         bias_len, hist_len) = struct.unpack_from("<HBBIIHHIII", data, len(NBTC_MAGIC))
        return cls(profile, near, height, width, tile_h, tile_w, n_tiles,
                   bias_len, hist_len, flags)


def sniff_format(data: bytes) -> str:
    """Container auto-detection: the NBTC magic, then Q0.2, then NBLIC0.3."""
    if data[: len(NBTC_MAGIC)] == NBTC_MAGIC:
        return "nbtc"
    if data[: len(QNBLIC_MAGIC)] == QNBLIC_MAGIC:
        return "qnblic"
    if data[: len(NBLIC_MAGIC)] == NBLIC_MAGIC:
        return "nblic"
    raise ValueError("unknown container format")
