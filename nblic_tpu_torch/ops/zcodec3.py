"""Layered Zcodec walk for the NBTC profile-3 strip engine.

Counterpart of ``nblic_tpu/ops/zcodec3.py``.  A symbol z is coded as an
escalating unary walk over a 256-wide counter row plus k binary refinement
bits.  The unary bin position and the escalated context row at walk step L
are functions of (qu, L) alone, never of z, so the walk flattens into
``n_unary`` dense layers; a symbol still walking after the budget escapes
to 8 raw bits.  Refinement bits take a (row, bit position, seen-a-one)
context.

Here every layer is computed at once: the layer is the leading axis of each
returned tensor, so one call is a handful of elementwise tensor ops.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

N_ROW = 16       # activity context rows
N_REFINE = 5     # max binary refinement bits
ESCAPE_BITS = 8  # raw bits of an escaped symbol (the fold is onto 0..255)


class LayerConsts(NamedTuple):
    """Static per-layer walk constants for one k_step."""

    k_max: int
    i_vals: tuple      # unary bin position per layer
    cls_vals: tuple    # counter class index per layer (i >> k_max)
    esc_counts: tuple  # escalations experienced before each layer
    n_class: int       # distinct counter classes = 256 >> k_max


def layer_consts(k_step: int, n_unary: int) -> LayerConsts:
    k_max = (N_ROW - 1) // k_step
    step = 1 << k_max
    i_vals, esc_counts = [], []
    i, esc = 0, 0
    for _ in range(n_unary):
        i_vals.append(i)
        esc_counts.append(esc)
        i2 = i + step
        if i2 >= 256:
            i2 >>= 1
            esc += 1
        i = i2
    return LayerConsts(k_max, tuple(i_vals), tuple(v >> k_max for v in i_vals),
                       tuple(esc_counts), 256 >> k_max)


def escalated_row(qu, esc_count, k_step: int):
    """Context row after ``esc_count`` escalations (a tensor broadcasts)."""
    esc = torch.as_tensor(esc_count, dtype=qu.dtype, device=qu.device)
    up = torch.clamp((torch.div(qu, k_step, rounding_mode="floor") + esc) * k_step,
                     max=N_ROW - 1)
    return torch.where(esc == 0, qu, up)


def adjust_qv(qu, qv, k_step: int):
    """qv collapses to qu when their k differ."""
    return torch.where(torch.div(qv, k_step, rounding_mode="floor")
                       != torch.div(qu, k_step, rounding_mode="floor"), qu, qv)


@functools.lru_cache(maxsize=None)
def layer_axis(vals: tuple, dtype, device, ndim: int):
    """Per-layer constants as a (layers, 1, ..., 1) tensor on ``device``, made
    once: a host-to-device copy in a loop would wait for the card's queue."""
    return torch.tensor(vals, dtype=dtype, device=device).view((-1,) + (1,) * ndim)


def unary_layers(z, qu, qv, k_step: int, n_unary: int):
    """The unary walk of planes z/qu/qv, all layers at once.

    Returns (row_u, row_v, bin, active), each (n_unary, *z.shape) (bin and
    active bool), then (row_end, k_end, escaped): the row where the walk
    stopped, its refinement bit count (0 for an escape) and the escape mask.
    """
    lc = layer_consts(k_step, n_unary)
    qv = adjust_qv(qu, qv, k_step)
    esc = layer_axis(lc.esc_counts, z.dtype, z.device, z.dim())
    row_u = escalated_row(qu[None], esc, k_step)
    row_v = escalated_row(qv[None], esc, k_step)
    k = torch.div(row_u, k_step, rounding_mode="floor")
    go = layer_axis(lc.cls_vals, z.dtype, z.device, z.dim()) < (z[None] >> k)
    # a layer is active while every earlier layer continued the walk
    halts = (~go).to(torch.int32)
    active = (torch.cumsum(halts, 0) - halts) == 0
    b = go & active
    stop = active & ~go
    row_end = torch.where(stop, row_u, 0).sum(0).to(z.dtype)
    escaped = active[-1] & go[-1]
    k_end = torch.where(escaped, 0, torch.div(row_end, k_step, rounding_mode="floor"))
    return (row_u, row_v, b, active), row_end, k_end, escaped


def refine_layers(z, k_end, escaped):
    """Refinement bit layers, MSB first: (bit, active, msb_seen), each
    (N_REFINE, *z.shape).  ``msb_seen`` is whether a more significant
    refinement bit of the pixel was 1, the context before this bit."""
    kk = k_end[None] - 1 - layer_axis(tuple(range(N_REFINE)), z.dtype, z.device, z.dim())
    act = (kk >= 0) & ~escaped[None]
    bit = ((z[None] >> torch.clamp(kk, min=0)) & 1) * act
    seen = torch.cummax(bit, 0).values
    msb = torch.cat([torch.zeros_like(seen[:1]), seen[:-1]])
    return bit, act, msb
