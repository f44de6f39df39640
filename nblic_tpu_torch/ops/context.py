"""Static context bias and the residual fold, as tensor ops.

Counterpart of ``nblic_tpu/ops/context.py`` (the NBTC half).  The encoder
transmits the per-context mean prediction error, quantized to 1/16 px; its
half-bit doubles as the preferred residual sign.  Segment sums are int64
``scatter_add_``, exact at any image size; table reads are plain indexing.
"""

from __future__ import annotations

import torch

from nblic_tpu.constants import MAX_VAL, MID_VAL

# fixed-point scale of the transmitted static bias table (1/16 px units)
BIAS_FRAC_BITS = 4


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def bias_moments(adr: torch.Tensor, err: torch.Tensor, n_ctx: int):
    """Per-context (sum, count) of prediction errors, int64 (n_ctx,)."""
    idx = adr.reshape(-1).to(torch.int64)
    sums = torch.zeros(n_ctx, dtype=torch.int64, device=adr.device)
    sums.scatter_add_(0, idx, err.reshape(-1).to(torch.int64))
    cnts = torch.bincount(idx, minlength=n_ctx)
    return sums, cnts


def quantize_bias(sums: torch.Tensor, cnts: torch.Tensor) -> torch.Tensor:
    """Fixed-point rounded mean error per context, int32 in [-2^11, 2^11).

    Rounds half away from zero on magnitudes (a floor division of a signed
    numerator would round negative means one step too far).
    """
    denom = torch.clamp(cnts, min=1)
    mag = _floordiv((torch.abs(sums) << BIAS_FRAC_BITS) * 2 + denom, 2 * denom)
    bias = torch.where(cnts > 0, torch.sign(sums) * mag, torch.zeros_like(mag))
    return torch.clamp(bias, -(1 << 11), (1 << 11) - 1).to(torch.int32)


def build_static_bias(adr: torch.Tensor, err: torch.Tensor, n_ctx: int) -> torch.Tensor:
    """Per-context quantized mean error: int32 (n_ctx,), 0 for unused ones."""
    return quantize_bias(*bias_moments(adr, err, n_ctx))


def apply_static_bias(bias_tab: torch.Tensor, adr: torch.Tensor, px0: torch.Tensor):
    """Correct predictions by the static bias table; returns (px, sign)."""
    b = bias_tab[adr.to(torch.int64)]
    sign = (b >> (BIAS_FRAC_BITS - 1)) & 1
    px = torch.clamp(px0 + (b >> BIAS_FRAC_BITS) + sign, 0, MAX_VAL)
    return px, sign


def _fold_bound(px, near: int):
    return _floordiv(torch.minimum(torch.clamp(px, min=0), MAX_VAL - px) + near,
                     2 * near + 1)


def residual_fold(x, px, sign, near: int = 0):
    """|x-px| quantized by near, sign-interleaved (mapXtoY)."""
    ty = _fold_bound(px, near)
    sy = (x >= px).to(torch.int32)
    y = _floordiv(torch.abs(x - px) + near, 2 * near + 1)
    folded = torch.where(y <= ty, 2 * y - (sy ^ sign), y + ty)
    return torch.where(y <= 0, torch.zeros_like(folded), folded)


def residual_unfold(z, px, sign, near: int = 0):
    """Inverse fold plus the reconstruction clip (mapYtoX)."""
    ty = _fold_bound(px, near)
    in_fold = z <= 2 * ty
    y = torch.where(in_fold, (z + 1) >> 1, z - ty)
    sy = torch.where(in_fold, (z & 1) ^ sign, (px < MID_VAL).to(z.dtype))
    y = torch.where(z <= 0, torch.zeros_like(y), y)
    sy = torch.where(z <= 0, torch.zeros_like(sy), sy)
    y = y * (2 * near + 1)
    return torch.clamp(px + torch.where(sy.bool(), y, -y), 0, MAX_VAL)
