"""Adaptive tables of the profile-3 coder: bit counters and the AutoMapper.

Counterpart of ``nblic_tpu/ops/coder3.py``.  The counters and the mapper
history stay frozen within a column segment of a row and update between
segments from order-free aggregates of the segment's events, so the
encoder's per-segment work is whole-plane tensor math.

State (int64 here; the values stay far below 2^31):
- unary counters (L, N_ROW, n_class, 2), private per strip lane L, one pair
  per escalation class; halved when c0 + c1 passes the halving threshold;
- refine counters (L, N_ROW, N_REFINE, 2, 2): (row, bit position,
  seen-a-one) context of the refinement bits;
- mapper history (B, 512, N_MAP), one per image, shared by its strips;
  ranks are rebuilt by a stable sort of the decayed counts.

The JAX package forms every update as float32 one-hot contractions (exact
while counts stay under 2^24); here they are integer ``index_add_`` and
gathers over flattened tables.
"""

from __future__ import annotations

import torch

from .rans_bin import PROB_MAX
from .zcodec3 import N_REFINE, N_ROW, layer_axis, layer_consts

N_MAP = 20
MAP_KEYS = 512
QW_MAX = 32


def init_unary(lanes: int, n_class: int, init: int, device=None):
    return torch.full((lanes, N_ROW, n_class, 2), init, dtype=torch.int64, device=device)


def init_refine(lanes: int, init: int, device=None):
    return torch.full((lanes, N_ROW, N_REFINE, 2, 2), init, dtype=torch.int64,
                      device=device)


def init_mapper(n_imgs: int, device=None):
    base = 2 * (N_MAP - 1 - torch.arange(N_MAP, dtype=torch.int64, device=device))
    return base.expand(n_imgs, MAP_KEYS, N_MAP).clone()


def prob_table(tab):
    """Counter pairs (..., 2) -> 12-bit P(bin=1), clipped to [1, 4095]."""
    c0, c1 = tab[..., 0], tab[..., 1]
    return torch.clamp(torch.div(PROB_MAX * c1, c0 + c1, rounding_mode="floor"),
                       1, PROB_MAX - 1)


def mix_prob(pu, pv, qw):
    """Dual-counter interpolation of two probabilities by qw / 32."""
    p = torch.div(pu * (QW_MAX - qw) + pv * qw + QW_MAX // 2, QW_MAX,
                  rounding_mode="floor")
    return torch.clamp(p, 1, PROB_MAX - 1)


def mapper_ranks(mhist):
    """(B, 512, N_MAP) counts -> ranks y -> z: the position of y in the
    stable descending order of its key's counts."""
    order = torch.argsort(-mhist, dim=-1, stable=True)
    ranks = torch.empty_like(order)
    ranks.scatter_(-1, order, torch.arange(N_MAP, device=order.device).expand_as(order))
    return ranks


def mapper_order(mhist):
    """(B, 512, N_MAP) counts -> order z -> y: the inverse of
    :func:`mapper_ranks`, what the decoder reads."""
    return torch.argsort(-mhist, dim=-1, stable=True)


def halve_pairs(tab, thresh: int):
    over = (tab[..., 0] + tab[..., 1]) > thresh
    return torch.where(over[..., None], (tab + 1) >> 1, tab)


def unary_cells(lane, unary, k_step: int, n_unary: int, n_class: int):
    """Flat counter-pair cells of each layer's u and v reads, (lane * N_ROW +
    row) * n_class + cls, each (n_unary, L, W): the index into a prob table
    (L, N_ROW, n_class), and with 2 * cell + bin into the counts."""
    row_u, row_v = unary[0], unary[1]
    cls = layer_axis(layer_consts(k_step, n_unary).cls_vals, row_u.dtype, row_u.device,
                     row_u.dim() - 1)
    return (lane * N_ROW + row_u) * n_class + cls, (lane * N_ROW + row_v) * n_class + cls


def refine_cells(lane, row_end, k_end, msb):
    """Flat counter-pair cells of each refinement layer, ((lane * N_ROW +
    row_end) * N_REFINE + kk) * 2 + msb, kk the bit position clipped to
    [0, N_REFINE), each (N_REFINE, L, W)."""
    kk = torch.clamp(k_end[None] - 1 - torch.arange(N_REFINE, device=k_end.device).view(
        -1, 1, 1), 0, N_REFINE - 1)
    return (((lane * N_ROW + row_end)[None] * N_REFINE + kk) * 2 + msb)


def row_updates(utab, rtab, qw, unary, refine, ucells, rcells, halve: int):
    """Fold one segment's coded events into the counter tables.

    ``unary`` = (row_u, row_v, bin, active) and ``refine`` = (bit, active,
    msb) from ``ops/zcodec3.py``, (layers, L, W); ``ucells`` / ``rcells``
    their flat cells.  Escape bits are never counted.  Returns (utab, rtab).
    """
    _, _, b, act = unary
    wu = (QW_MAX - qw)[None] * act
    wv = qw[None] * act
    b = b.to(torch.int64)
    du = torch.zeros(utab.numel(), dtype=utab.dtype, device=utab.device)
    du.index_add_(0, torch.cat([(2 * ucells[0] + b).reshape(-1),
                                (2 * ucells[1] + b).reshape(-1)]),
                  torch.cat([wu.reshape(-1), wv.reshape(-1)]).to(utab.dtype))
    utab = halve_pairs(utab + du.view(utab.shape), halve)
    bit, ract, _ = refine
    dr = torch.zeros(rtab.numel(), dtype=rtab.dtype, device=rtab.device)
    dr.index_add_(0, (2 * rcells + bit).reshape(-1), ract.reshape(-1).to(rtab.dtype))
    rtab = halve_pairs(rtab + dr.view(rtab.shape), halve)
    return utab, rtab


def mapper_updates(mhist, img_of_lane, key, y, bump: int, halve: int):
    """Decayed per-(key, y) frequency update from one segment (order-free)."""
    small = (y < N_MAP).to(mhist.dtype)
    cell = (img_of_lane[:, None].to(torch.int64) * MAP_KEYS + key) * N_MAP \
        + torch.clamp(y, max=N_MAP - 1)
    counts = torch.zeros(mhist.numel(), dtype=mhist.dtype, device=mhist.device)
    counts.index_add_(0, cell.reshape(-1), small.reshape(-1))
    mhist = mhist + bump * counts.view(mhist.shape)
    over = mhist.amax(-1, keepdim=True) > halve
    return torch.where(over, mhist >> 1, mhist)


def mapper_lookup(table, img_of_lane, key, val):
    """table (B, 512, N_MAP); key/val (L, W): table[image, key, min(val, 19)]."""
    cell = (img_of_lane[:, None].to(torch.int64) * MAP_KEYS + key) * N_MAP \
        + torch.clamp(val, max=N_MAP - 1)
    return table.reshape(-1)[cell]
