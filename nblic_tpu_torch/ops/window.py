"""Sliding-window registers for the lockstep per-pixel decode loop.

Counterpart of ``nblic_tpu/ops/window.py``.  The window is fresh-sampled at
each row start and slid one column per pixel; every lane shares (i, j), so
``i`` and ``j`` are Python ints and ``prev1``/``prev2`` are the previous two
rows with the column on the last axis.
"""

from __future__ import annotations

import torch

from nblic_tpu.constants import MID_VAL

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


def pixel_model(regs, err):
    """Per-pixel effort-0 modeling on window registers -> (px0, qd, adr)."""
    nb = Neighbors(*regs)
    px0 = simple_predict(nb)
    qd = quantize_activity(activity(nb, err))
    adr = context_address(nb, px0, qd)
    return px0, qd, adr
