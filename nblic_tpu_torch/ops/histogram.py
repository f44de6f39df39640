"""Histogram normalization, prefix sums, the decode table and the 16-bit
RLE table code (host-side numpy).

Counterpart of ``nblic_tpu/ops/histogram.py``, kept here because that
module's package pulls in JAX.  The normalized histograms are a few KB of
container metadata per image and never touch the device here.  The Q0.2
engine's ``normalize`` scales in float64 with the reference's 0.49 rounding
and cyclic fix-up loops; the NBTC path's float32 ``tiled._norm_hist_dev``
is another function and rounds otherwise.
"""

from __future__ import annotations

import numpy as np

NORM_BITS = 15
NORM_SUM = 1 << NORM_BITS
N_SYM = 256


def normalize(hist: np.ndarray) -> np.ndarray:
    """Normalize one 256-bin histogram to sum exactly NORM_SUM."""
    hist = hist.astype(np.uint32).copy()
    nz = np.flatnonzero(hist)
    if nz.size <= 1:
        # empty or one symbol: that symbol (0 when empty) takes all but one
        # slot and its successor the last one
        j = int(nz[0]) if nz.size else 0
        hist[j] = NORM_SUM - 1
        hist[(j + 1) % N_SYM] = 1
        return hist
    scale = (1.0 * NORM_SUM) / int(hist.sum())
    hist = np.where(hist > 0, np.maximum((0.49 + scale * hist).astype(np.uint32), 1),
                    0).astype(np.uint32)
    s = int(hist.sum())
    i = 0
    while s > NORM_SUM:
        if hist[i] > 1:
            hist[i] -= 1
            s -= 1
        i = (i + 1) % N_SYM
    i = 0
    while s < NORM_SUM:
        if hist[i] > 0:
            hist[i] += 1
            s += 1
        i = (i + 1) % N_SYM
    return hist


def accumulate(hist: np.ndarray) -> np.ndarray:
    """Exclusive prefix sum (hist_acc)."""
    acc = np.zeros(N_SYM, dtype=np.uint32)
    np.cumsum(hist[:-1], out=acc[1:])
    return acc


def decode_lut(acc: np.ndarray) -> np.ndarray:
    """2^15-entry state-slot -> symbol table."""
    lut = np.full(NORM_SUM, N_SYM - 1, dtype=np.uint8)
    bounds = np.append(acc, NORM_SUM).astype(np.int64)
    for v in range(N_SYM):
        lut[bounds[v] : bounds[v + 1]] = v
    return lut


def serialize(hist: np.ndarray) -> list[int]:
    """Histogram -> list of 16-bit RLE code words."""
    out: list[int] = []
    i, s = 0, 0
    while i < N_SYM and s < NORM_SUM:
        h0 = int(hist[i])
        j = i + 1
        he = 0xFFFF
        while j < N_SYM:
            he = int(hist[j])
            if he != h0:
                break
            j += 1
        length = j - i
        if h0 <= 1 and length >= 4:
            if j < N_SYM and he <= 15:
                j += 1  # absorb the run terminator into the KKKK field
            else:
                he = h0
            code = (7 << 13) | (h0 << 12) | (he << 8) | (length - 4)
        else:
            h1 = int(hist[i + 1]) if i + 1 < N_SYM else 0xFFFF
            h2 = int(hist[i + 2]) if i + 2 < N_SYM else 0xFFFF
            h3 = int(hist[i + 3]) if i + 3 < N_SYM else 0xFFFF
            if h0 <= 7 and h1 <= 7 and h2 <= 7 and h3 <= 7:
                code = (13 << 12) | (h0 << 9) | (h1 << 6) | (h2 << 3) | h3
                j = i + 4
            elif h0 <= 15 and h1 <= 15 and h2 <= 15:
                code = (12 << 12) | (h0 << 8) | (h1 << 4) | h2
                j = i + 3
            elif h0 <= 127 and h1 <= 127:
                code = (2 << 14) | (h0 << 7) | h1
                j = i + 2
            else:
                code = h0
                j = i + 1
        out.append(code)
        while i < j:
            s += int(hist[i])
            i += 1
    return out


def deserialize(words, pos: int):
    """Parse one histogram from a u16 word sequence; returns (hist, new_pos)."""
    hist = np.zeros(N_SYM, dtype=np.uint32)
    i, s = 0, 0
    while i < N_SYM and s < NORM_SUM:
        if pos >= len(words):
            raise ValueError("truncated histogram stream")
        code = int(words[pos])
        pos += 1
        if (code >> 15) == 0:
            vals = (code,)
        elif (code >> 14) == 2:
            vals = ((code >> 7) & 0x7F, code & 0x7F)
        elif (code >> 12) == 12:
            vals = ((code >> 8) & 0xF, (code >> 4) & 0xF, code & 0xF)
        elif (code >> 12) == 13:
            vals = (
                (code >> 9) & 0x7, (code >> 6) & 0x7, (code >> 3) & 0x7,
                code & 0x7,
            )
        else:
            length = (code & 0xFF) + 4
            he = (code >> 8) & 0xF
            h0 = (code >> 12) & 0x1
            vals = (h0,) * length + ((he,) if he != h0 else ())
        if i + len(vals) > N_SYM:
            raise ValueError("malformed histogram stream")
        for v in vals:
            hist[i] = v
            s += v
            i += 1
    if s != NORM_SUM:
        raise ValueError("malformed histogram stream")
    return hist, pos
