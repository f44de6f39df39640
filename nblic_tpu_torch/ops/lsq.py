"""Per-tile least-squares predictors (NBTC profile 2).

Counterpart of ``nblic_tpu/ops/lsq.py``.  One ridge regression per tile
over its causal neighbour taps; the weights are quantized to int16 and
transmitted, so the decoder predicts with the same integers.

The fit matches the JAX package bit for bit: the features are small
integers, so the normal equations ``A = F^T F`` and ``b = F^T t`` are sums
of integers, exact in float64 in any order (|sum| < 2^27 at 64 x 64 tiles).
They are rounded once to float32, as JAX's float32 product at HIGHEST
precision gives them, and the solve is the same unrolled float32
Gauss-Jordan, whose row update rounds once, as the fused multiply-add that
XLA emits for it on the CPU does (:func:`_fused_sub_mul`).

Prediction: px = clip(128 + (w_11 + sum_k w_k (tap_k - 128) + 2^11) >> 12).
"""

from __future__ import annotations

import torch

from ..constants import MAX_VAL, MID_VAL
from .neighbors import Neighbors, sample

N_FEAT = 12  # 11 causal taps + intercept
W_FRAC_BITS = 12  # weight fixed point
W_CLIP = (1 << 15) - 1  # int16 transmitted
RIDGE = 64.0


def features(n: Neighbors) -> torch.Tensor:
    """(..., H, W, 12) int32 feature planes: taps - 128, intercept last."""
    taps = torch.stack([n.a, n.b, n.c, n.d, n.e, n.f, n.g, n.h, n.q, n.r, n.s],
                       dim=-1).to(torch.int32) - MID_VAL
    return torch.cat([taps, torch.ones_like(taps[..., :1])], dim=-1)


def _fused_sub_mul(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a - b * c for float32 tensors, rounded once, as a fused multiply-add
    rounds it.

    The product of two float32 values is exact in float64; the difference
    is taken with its exact error (Knuth's two-sum), rounded to odd in
    float64 and then to float32, which rounds correctly (round-to-odd with
    29 spare bits).  Every step is a separate IEEE operation, so the CPU and
    the card give the same bits.
    """
    a64 = a.to(torch.float64)
    p = b.to(torch.float64) * c.to(torch.float64)
    s = a64 - p
    bv = s - a64
    err = (a64 - (s - bv)) + (-p - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _solve_spd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 12x12 solve by unrolled Gauss-Jordan (no pivoting), float32.

    The ridge makes A symmetric positive definite.  The row update rounds
    as one fused multiply-subtract: that is how XLA compiles the JAX
    package's jitted ``_solve_spd`` on the CPU, the encoder's reference.
    """
    aug = torch.cat([a, b[..., None]], dim=-1)  # (T, n, n+1)
    n = a.shape[-1]
    for k in range(n):
        piv = aug[:, k : k + 1, :] / aug[:, k : k + 1, k : k + 1]
        aug = _fused_sub_mul(aug, aug[:, :, k : k + 1], piv)
        aug[:, k, :] = piv[:, 0, :]
    return aug[:, :, n]


def fit_tile_weights(tiles: torch.Tensor, target: torch.Tensor | None = None):
    """Fit quantized predictor weights per tile.

    tiles: (T, th, tw) pixels, the plane the causal feature windows are
    sampled from; ``target`` (same shape, default ``tiles``) is the plane
    being predicted.  The near-lossless refit passes the reconstruction as
    ``tiles`` and the original as ``target``, so the fit sees the windows
    the decoder will.  Returns (w_q int32 (T, 12), valid bool (T,)); the
    weights of a tile whose solve is not finite are 0.
    """
    x = tiles.to(torch.int32)
    t = x.shape[0]
    fm = features(sample(x)).reshape(t, -1, N_FEAT).to(torch.float64)
    tgt_x = x if target is None else target.to(torch.int32)
    tgt = (tgt_x - MID_VAL).reshape(t, -1, 1).to(torch.float64)
    ft = fm.transpose(1, 2)
    a = torch.bmm(ft, fm).to(torch.float32)  # exact integer sums, then f32
    b = torch.bmm(ft, tgt)[..., 0].to(torch.float32)
    a = a + RIDGE * torch.eye(N_FEAT, dtype=torch.float32, device=x.device)
    w = _solve_spd(a, b)
    w_q = torch.clamp(torch.round(w * (1 << W_FRAC_BITS)), -W_CLIP, W_CLIP)
    valid = torch.isfinite(w).all(dim=-1)
    w_q = torch.where(valid[:, None], w_q, torch.zeros_like(w_q))
    return w_q.to(torch.int32), valid


def _predict(taps, w_row) -> torch.Tensor:
    """clip(128 + (intercept + sum_k w_k (tap_k - 128) + 2^11) >> 12), int32.

    ``w_row(k)`` is weight k broadcast against the taps; every partial sum
    stays below 2^31 (11 x 32767 x 128 + 32767).
    """
    acc = w_row(N_FEAT - 1)
    for k, tap in enumerate(taps):
        acc = acc + w_row(k) * (tap.to(torch.int32) - MID_VAL)
    px = MID_VAL + ((acc + (1 << (W_FRAC_BITS - 1))) >> W_FRAC_BITS)
    return torch.clamp(px, 0, MAX_VAL)


def predict_plane(n: Neighbors, w_q: torch.Tensor) -> torch.Tensor:
    """Integer prediction plane from quantized weights.

    n: neighbor planes of (..., T, th, tw); w_q: (..., T, 12) int32.
    """
    w = w_q.to(torch.int32)
    return _predict(tuple(n), lambda k: w[..., k, None, None])


def predict_lanes(regs, w_cols: torch.Tensor) -> torch.Tensor:
    """Per-lane integer prediction inside the lockstep decode loop.

    regs: 11 window registers, each (..., G); w_cols: (..., >=12, G) int32,
    weight k on row k (intercept on row 11).
    """
    w = w_cols.to(torch.int32)
    return _predict(regs, lambda k: w[..., k, :])
