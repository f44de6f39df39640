"""Whole-plane prediction, activity and context address (effort-0 family).

Counterpart of ``nblic_tpu/ops/predict.py``: the blend predictor, the 12-bin
activity quantizer and the 3072-entry context address, as branch-free int32
tensor math over whole planes; the dual-bin activity quantizer of profile 3
and NBLIC0.3; and NBLIC0.3's blend predictor and 2048-entry context address.

The NBLIC0.3 functions stack the 11 taps on a last axis and take every
linear combination they compare as one product with a coefficient table:
a few tensor operations whatever the shape, so the interop walk, which
calls them on single pixels, issues a few launches a pixel.
"""

from __future__ import annotations

import functools
import re

import torch

from ..constants import C_THRESHOLDS, MAX_VAL, Q_MID, Q_PT_THRESH, Q_QD_THRESH

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


N_QW = 32  # interpolation weight range of the dual-bin quantizer


@functools.lru_cache(maxsize=None)
def _mids(dtype, device):
    # made once per device: a copy per call would wait for the card's queue
    # inside the per-pixel decode walk
    return torch.tensor(Q_MID, dtype=dtype, device=device)


def n_quantize_activity(delta: torch.Tensor):
    """Dual-bin activity quantizer with 5-bit interpolation: (qu, qv, qw)."""
    mids = _mids(delta.dtype, delta.device)
    # first qd in [0, 15) with delta <= mid[qd], else 15
    qd = (delta[..., None] > mids[:15]).sum(-1).to(delta.dtype)
    mid_lo = mids[torch.clamp(qd - 1, min=0)]
    mid_hi = mids[qd]
    interp = (delta < mid_hi) & (qd > 0)
    qw_raw = torch.where(
        interp,
        torch.div(N_QW * (delta - mid_lo), torch.clamp(mid_hi - mid_lo, min=1),
                  rounding_mode="floor"),
        0,
    )
    low_half = qw_raw < N_QW // 2
    qu = torch.where(interp & low_half, qd - 1, qd)
    qv = torch.where(interp & ~low_half, qd - 1, qd)
    qw = torch.where(interp, torch.where(low_half, qw_raw, N_QW - qw_raw), 0)
    return qu, qv, qw.to(delta.dtype)


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


def context_planes(n: Neighbors, x: torch.Tensor, px0: torch.Tensor):
    """(err, qd, adr) int32 planes of the prediction px0 of pixels x."""
    err = x - px0
    qd = quantize_activity(activity(n, shift_err(err)))
    adr = context_address(n, px0, qd)
    return err, qd, adr


def model_stage1(img: torch.Tensor):
    """Parallel modeling pass: (px0, err, qd, adr) int32 planes from pixels."""
    x = img.to(torch.int32)
    n = sample(x)
    px0 = simple_predict(n)
    return (px0, *context_planes(n, x, px0))


# NBLIC0.3 blend predictor, over the taps a b c d e f g h q r s: the 28
# differences whose magnitudes make the 7 directional costs (4 each), the 7
# candidate predictions, then the linear predictor
_N_DIFFS = (
    "a-e", "c-q", "b-c", "d-b",
    "a-c", "c-h", "b-f", "d-g",
    "a-q", "c-s", "b-h", "d-f",
    "a-b", "c-f", "b-g", "d-r",
    "2a-e-q", "2c-q-s", "2b-c-h", "2d-b-f",
    "2a-q-c", "2c-s-h", "2b-h-f", "2d-f-g",
    "2a-c-b", "2c-h-f", "2b-f-g", "2d-g-r",
)
_N_PREDS = ("2a", "2b", "2c", "2d", "a+c", "c+b", "b+d")
_N_LINEAR = "9a+9b+2d-2c-e-f"
_N_COST_WEIGHT = (2, 2, 2, 2, 1, 1, 1)
# NBLIC0.3 context texture bits: px > each of these
_N_TEXTURE = ("a", "b", "c", "d", "e", "f", "2a-e", "2b-f")
_TAPS = "abcdefghqrs"


def _coefficients(expr: str) -> list[int]:
    """Tap coefficients of a linear expression such as ``9a+9b-2c``."""
    out = [0] * len(_TAPS)
    for sign, num, tap in re.findall(r"([+-]?)(\d*)([a-z])", expr):
        out[_TAPS.index(tap)] += (-1 if sign == "-" else 1) * int(num or 1)
    return out


@functools.lru_cache(maxsize=None)
def _n_tables(dtype, device):
    """(combination table (36, 11), cost weights (7,), thresholds (8,),
    texture table (8, 11), texture bit values (8,)) on a device."""
    def t(v):
        return torch.tensor(v, dtype=dtype, device=device)

    combos = [_coefficients(e) for e in _N_DIFFS + _N_PREDS + (_N_LINEAR,)]
    return (t(combos), t(_N_COST_WEIGHT), t(C_THRESHOLDS),
            t([_coefficients(e) for e in _N_TEXTURE]), t([1 << k for k in range(8)]))


def _taps(n: Neighbors) -> torch.Tensor:
    return torch.stack(tuple(n), -1)


def n_simple_predict(n: Neighbors) -> torch.Tensor:
    """NBLIC0.3 blend predictor: the angular candidate of least cost (the
    first on ties), blended with the linear predictor by a weight counted
    from the thresholds at or below the cost sum."""
    combos, weight, thresh, _, _ = _n_tables(n.a.dtype, n.a.device)
    v = (_taps(n)[..., None, :] * combos).sum(-1)
    costs = v[..., :28].abs().unflatten(-1, (7, 4)).sum(-1) * weight
    best = costs.argmin(-1, keepdim=True)
    px_ang = v[..., 28:35].gather(-1, best)[..., 0]
    px_lnr = torch.clamp(v[..., 35], 0, 16 * MAX_VAL)
    csum = costs.sum(-1) - 7 * costs.gather(-1, best)[..., 0]
    wt = (thresh <= csum[..., None]).sum(-1).to(v.dtype)
    return (8 * wt * px_ang + (8 - wt) * px_lnr + 64) >> 7


def n_context_address(n: Neighbors, px: torch.Tensor, qu: torch.Tensor) -> torch.Tensor:
    """(qu >> 1) * 256 | 8 texture bits, bit k set where px exceeds the
    k-th of a, b, c, d, e, f, 2a-e, 2b-f."""
    _, _, _, texture, bits = _n_tables(n.a.dtype, n.a.device)
    v = (_taps(n)[..., None, :] * texture).sum(-1)
    return ((qu >> 1) << 8) | ((px[..., None] > v) * bits).sum(-1).to(qu.dtype)
