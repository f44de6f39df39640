"""Causal windows for the per-pixel walks.

Counterpart of ``nblic_tpu/ops/window.py``.  The effort-0 window is
fresh-sampled at each row start and slid one column per pixel; the NBLIC0.3
template is fresh-sampled at every pixel from three rows.  Every lane shares
(i, j), so ``i`` and ``j`` are Python ints and ``prev1``/``prev2`` are the
previous two rows with the column on the last axis.
"""

from __future__ import annotations

import functools

import torch

from ..constants import MID_VAL

from .lsq import N_FEAT, predict_lanes
from .neighbors import Neighbors
from .predict import activity, context_address, quantize_activity, simple_predict


def row_start_window(i: int, prev1, prev2, w: int):
    """Fresh window registers at (i, 0); prev1/prev2: rows i-1, i-2 (..., w)."""
    if i > 0:
        a = prev1[..., 0]
    else:
        a = torch.full(prev1.shape[:-1], MID_VAL, dtype=prev1.dtype,
                       device=prev1.device)
    b = e = c = a
    d = prev1[..., 1] if (i > 0 and w > 1) else b
    f = prev2[..., 0] if i > 1 else b
    g = prev2[..., 1] if (i > 1 and w > 1) else f
    h = f
    q = c
    r = prev2[..., 2] if (i > 1 and w > 2) else g
    s = h
    return (a, b, c, d, e, f, g, h, q, r, s)


def slide_window(regs, x, i: int, j: int, prev1, prev2, w: int):
    """One-column slide after coding pixel (i, j) with value x."""
    a, b, c, d, e, f, g, h, q, r, s = regs
    e2, a2, q2, c2, b2 = a, x, c, b, d
    s2, h2, f2, g2 = h, f, g, r
    if i <= 0:
        d2 = a2
    else:
        d2 = d if j + 2 >= w else prev1[..., j + 2]
    if i <= 1:
        r2 = d2
    else:
        r2 = r if j + 3 >= w else prev2[..., j + 3]
    return (a2, b2, c2, d2, e2, f2, g2, h2, q2, r2, s2)


def pixel_model(regs, err, wcols=None):
    """Per-pixel modeling on window registers -> (px0, qd, adr).

    ``wcols`` (..., 16, G) selects profile 2: rows 0-11 are each lane's
    least-squares weights (intercept on row 11) and row 12 its flag, 0 for
    the blend predictor, 1 for the learned one, 2 for their rounded mean.
    ``None`` is profile 1 (the blend predictor alone).
    """
    nb = Neighbors(*regs)
    px0 = simple_predict(nb)
    if wcols is not None:
        px_l = predict_lanes(regs, wcols)
        flag = wcols[..., N_FEAT, :]
        px_a = (px0 + px_l + 1) >> 1
        px0 = torch.where(flag == 1, px_l, torch.where(flag == 2, px_a, px0))
    qd = quantize_activity(activity(nb, err))
    adr = context_address(nb, px0, qd)
    return px0, qd, adr


@functools.lru_cache(maxsize=None)
def _mid(dtype, device):
    # one per device: a fresh constant a pixel would be a host-to-device copy
    return torch.full((1,), MID_VAL, dtype=dtype, device=device)


def fresh_window_rows(i: int, j: int, cur, prev1, prev2, w: int) -> Neighbors:
    """The template at (i, j) sampled from three rows (w,): ``cur`` (row i,
    written up to column j - 1), ``prev1`` (row i - 1), ``prev2`` (row i - 2).

    An out-of-image tap takes another tap's value, in the cascade of the
    reference codec.  Each tap is a (1,) view of a row, no copy.
    """
    def at(row, k):
        return row[k : k + 1]

    mid = _mid(cur.dtype, cur.device)
    a = at(cur, j - 1) if j >= 1 else mid
    b = at(prev1, j) if i >= 1 else mid
    if i == 0:
        b = a
    elif j == 0:
        a = b
    e = at(cur, j - 2) if j >= 2 else a
    c = at(prev1, j - 1) if (i >= 1 and j >= 1) else b
    d = at(prev1, j + 1) if (i >= 1 and j + 1 < w) else b
    f = at(prev2, j) if i >= 2 else b
    g = at(prev2, j + 1) if (i >= 2 and j + 1 < w) else f
    h = at(prev2, j - 1) if (i >= 2 and j >= 1) else f
    q = at(prev1, j - 2) if (i >= 1 and j >= 2) else c
    r = at(prev2, j + 2) if (i >= 2 and j + 2 < w) else g
    s = at(prev2, j - 2) if (i >= 2 and j >= 2) else h
    return Neighbors(a, b, c, d, e, f, g, h, q, r, s)


def fresh_t_tap(i: int, j: int, prev1, w: int, d):
    """The 13th tap t = (i - 1, j + 2) as a (1,) view, ``d`` where it lies
    outside (AVP only)."""
    return prev1[j + 2 : j + 3] if (i >= 1 and j + 2 < w) else d
