"""Whole-plane prediction, activity and context address (effort-0 family).

Counterpart of ``nblic_tpu/ops/predict.py``: the blend predictor, the 12-bin
activity quantizer and the 3072-entry context address, as branch-free int32
tensor math over whole planes.
"""

from __future__ import annotations

import torch

from nblic_tpu.constants import MAX_VAL, Q_PT_THRESH, Q_QD_THRESH

from .neighbors import Neighbors, sample


def simple_predict(n: Neighbors) -> torch.Tensor:
    """Blend predictor over neighbor planes; returns px0 in [0, 255]."""
    a, b, c, d, e, f, g, h, q, r, s = n
    px_lnr = torch.clamp(9 * a + 9 * b + 2 * d - 2 * c - e - f, 0, 16 * MAX_VAL)

    def aab(u, v):
        return torch.abs(u - v)

    costs = [
        2 * (aab(a, e) + aab(c, q) + aab(b, c) + aab(d, b)),
        2 * (aab(a, c) + aab(c, h) + aab(b, f) + aab(d, g)),
        2 * (aab(a, q) + aab(c, s) + aab(b, h) + aab(d, f)),
        2 * (aab(a, b) + aab(c, f) + aab(b, g) + aab(d, r)),
        aab(2 * a - e, q) + aab(2 * c - q, s) + aab(2 * b - c, h) + aab(2 * d - b, f),
        aab(2 * a - q, c) + aab(2 * c - s, h) + aab(2 * b - h, f) + aab(2 * d - f, g),
        aab(2 * a - c, b) + aab(2 * c - h, f) + aab(2 * b - f, g) + aab(2 * d - g, r),
    ]
    preds = [2 * a, 2 * b, 2 * c, 2 * d, a + c, c + b, b + d]

    # strict ">" keeps the first minimum, as the reference's if-chain does
    cmin = costs[0]
    px_ang = preds[0]
    csum = costs[0]
    for cost, pred in zip(costs[1:], preds[1:]):
        csum = csum + cost
        take = cmin > cost
        cmin = torch.where(take, cost, cmin)
        px_ang = torch.where(take, pred, px_ang)

    csum = torch.clamp((csum - 7 * cmin) >> 3, max=608 - 1)
    wt = torch.zeros_like(csum)
    for cut in Q_PT_THRESH[:-1]:
        wt = wt + (csum >= cut).to(torch.int32)
    return (8 * wt * px_ang + (8 - wt) * px_lnr + 64) >> 7


def activity(n: Neighbors, prev_err: torch.Tensor) -> torch.Tensor:
    """Raw texture activity: local gradients plus the carried error."""
    a, b, c, d, e, f, g = n.a, n.b, n.c, n.d, n.e, n.f, n.g
    return (
        torch.abs(a - e)
        + torch.abs(b - c)
        + torch.abs(b - d)
        + torch.abs(a - c)
        + torch.abs(b - f)
        + torch.abs(d - g)
        + 2 * torch.abs(prev_err)
    )


def quantize_activity(delta: torch.Tensor) -> torch.Tensor:
    """12-bin activity quantizer, as a threshold count."""
    v = torch.clamp(delta, max=152 - 1)
    qd = torch.zeros_like(v)
    for cut in Q_QD_THRESH[:-1]:
        qd = qd + (v >= cut).to(torch.int32)
    return qd


def context_address(n: Neighbors, px: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
    """qd*256 | 8 one-bit texture comparisons."""
    bits = [
        px > n.a,
        px > n.b,
        px > n.c,
        px > n.d,
        px > n.e,
        px > n.f,
        px > 2 * n.a - n.e,
        px > 2 * n.b - n.f,
    ]
    adr = qd
    for bit in bits:
        adr = (adr << 1) | bit.to(torch.int32)
    return adr


def shift_err(err: torch.Tensor) -> torch.Tensor:
    """In-row carried error: err[i, j-1], reset to 0 at column 0."""
    z = torch.zeros_like(err[..., :, :1])
    return torch.cat([z, err[..., :, :-1]], dim=-1)


def model_stage1(img: torch.Tensor):
    """Parallel modeling pass: (px0, err, qd, adr) int32 planes from pixels."""
    x = img.to(torch.int32)
    n = sample(x)
    px0 = simple_predict(n)
    err = x - px0
    qd = quantize_activity(activity(n, shift_err(err)))
    adr = context_address(n, px0, qd)
    return px0, err, qd, adr
