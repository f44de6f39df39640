"""Causal neighborhood sampling as whole-plane tensor ops.

The effort-0 template per pixel::

        s  h  f  g  r
        q  c  b  d
        e  a  .

``sample_slide`` is the closed form of the incremental window (fresh-sampled
at each row start, then slid one column at a time), including its border
artifacts, which the bitstream depends on.  Counterpart of
``nblic_tpu/ops/neighbors.py``; planes are int32 and the last two axes are
(rows, columns), so a leading tile or image axis batches for free.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..constants import MID_VAL


class Neighbors(NamedTuple):
    """The 11 causal neighbor planes, each shaped like the input plane."""

    a: torch.Tensor  # (i,   j-1)
    b: torch.Tensor  # (i-1, j  )
    c: torch.Tensor  # (i-1, j-1)
    d: torch.Tensor  # (i-1, j+1)
    e: torch.Tensor  # (i,   j-2)
    f: torch.Tensor  # (i-2, j  )
    g: torch.Tensor  # (i-2, j+1)
    h: torch.Tensor  # (i-2, j-1)
    q: torch.Tensor  # (i-1, j-2)
    r: torch.Tensor  # (i-2, j+2)
    s: torch.Tensor  # (i-2, j-2)


def _shift(x: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """Plane holding x[i+di, j+dj]; out-of-range cells are zero."""
    h, w = x.shape[-2], x.shape[-1]
    xp = F.pad(x, (max(0, -dj), max(0, dj), max(0, -di), max(0, di)))
    lo_i, lo_j = max(0, di), max(0, dj)
    return xp[..., lo_i : lo_i + h, lo_j : lo_j + w]


def _shift_left_clamp(x: torch.Tensor, k: int) -> torch.Tensor:
    """x[i, min(j+k, W-1)]: shift left with right-edge replication."""
    k = min(k, x.shape[-1] - 1)
    if k == 0:
        return x
    return torch.cat([x[..., :, k:]] + [x[..., :, -1:]] * k, dim=-1)


def sample_slide(x: torch.Tensor) -> Neighbors:
    """Closed form of the effort-0 incremental window.

    Rows i >= 2 mostly equal fresh sampling, except that the j==0/j==1 fills
    come from column 0 of the row above.  Row 1's (i-2) taps and all of row
    0's taps are right-shifted copies of row 0 with pipeline-delay thresholds.
    """
    x = x.to(torch.int32)
    h, w = x.shape[-2], x.shape[-1]
    ii = torch.arange(h, dtype=torch.int32, device=x.device)[:, None]
    jj = torch.arange(w, dtype=torch.int32, device=x.device)[None, :]
    mid = torch.tensor(MID_VAL, dtype=torch.int32, device=x.device)

    u1 = _shift(x, -1, 0)
    u2 = _shift(x, -2, 0)
    c0m1 = u1[..., :, 0:1]
    c0m2 = u2[..., :, 0:1]

    def sr(v, k):
        return _shift(v, 0, -k)

    # general rows (exact for i >= 2; a..e, q also exact for i == 1)
    a = torch.where(jj >= 1, sr(x, 1), c0m1)
    b = u1
    c = torch.where(jj >= 1, sr(u1, 1), c0m1)
    d = _shift_left_clamp(u1, 1)
    e = torch.where(jj >= 2, sr(x, 2), c0m1)
    f = u2
    g = _shift_left_clamp(u2, 1)
    hh = torch.where(jj >= 1, sr(u2, 1), c0m2)
    q = torch.where(jj >= 2, sr(u1, 2), c0m1)
    r = _shift_left_clamp(u2, 2)
    s = torch.where(jj >= 2, sr(u2, 2), c0m2)

    # row 1: the (i-2) taps alias onto delayed copies of row 0
    row0 = x[..., 0:1, :].expand(x.shape)
    x00 = row0[..., :, 0:1]
    on1 = ii == 1
    f = torch.where(on1, torch.where(jj >= 3, sr(row0, 1), x00), f)
    g = torch.where(on1, torch.where(jj >= 2, row0, x00), g)
    hh = torch.where(on1, torch.where(jj >= 4, sr(row0, 2), x00), hh)
    r = torch.where(on1, torch.where(jj >= 1, _shift_left_clamp(row0, 1), x00), r)
    s = torch.where(on1, torch.where(jj >= 5, sr(row0, 3), x00), s)

    # row 0: every tap is a right-shifted copy of row 0 itself
    def row0_tap(k):
        return torch.where(jj >= k, sr(row0, k), mid)

    on0 = ii == 0
    a = torch.where(on0, row0_tap(1), a)
    b = torch.where(on0, row0_tap(2), b)
    c = torch.where(on0, row0_tap(3), c)
    d = torch.where(on0, row0_tap(1), d)
    e = torch.where(on0, row0_tap(2), e)
    f = torch.where(on0, row0_tap(3), f)
    g = torch.where(on0, row0_tap(2), g)
    hh = torch.where(on0, row0_tap(4), hh)
    q = torch.where(on0, row0_tap(4), q)
    r = torch.where(on0, row0_tap(1), r)
    s = torch.where(on0, row0_tap(5), s)

    return Neighbors(a, b, c, d, e, f, g, hh, q, r, s)


# effort-0 modeling uses the incremental-window semantics
sample = sample_slide
