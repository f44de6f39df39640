"""Adaptive small-residual re-ranking permutations ("AutoMapper").

Counterpart of ``nblic_tpu/ops/automapper.py``: 512 independent rank
permutations over the 20 smallest residuals, keyed by (corrected
prediction, sign); a hit bubbles the symbol one rank toward 0 once its
frequency passes its neighbor's.  The state is three (512, 20) int64
tensors; ``key``, ``y`` and ``z`` are (1,) tensors on their device (an
index of shape (1,) gathers; a 0-d one would make PyTorch read it on the
host), and :func:`observe` updates the state in place.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

N_MAPPER = 20
N_KEYS = 512  # 256 px values x 2 signs


class MapperState(NamedTuple):
    to_rank: torch.Tensor  # (512, 20) y -> z
    from_rank: torch.Tensor  # (512, 20) z -> y
    freq: torch.Tensor  # (512, 20) rank-slot frequencies


def init_mappers(device="cpu") -> MapperState:
    ranks = torch.arange(N_MAPPER, dtype=torch.int64, device=device).repeat(N_KEYS, 1)
    freq0 = ((N_MAPPER - 1 - ranks) * 2).contiguous()
    return MapperState(ranks, ranks.clone(), freq0)


def fold(m: MapperState, key, y):
    """y -> its rank z (y itself from N_MAPPER up)."""
    yc = torch.clamp(y, max=N_MAPPER - 1)
    return torch.where(y < N_MAPPER, m.to_rank.view(-1)[key * N_MAPPER + yc], y)


def unfold(m: MapperState, key, z):
    """Rank z -> its y (z itself from N_MAPPER up)."""
    zc = torch.clamp(z, max=N_MAPPER - 1)
    return torch.where(z < N_MAPPER, m.from_rank.view(-1)[key * N_MAPPER + zc], z)


def observe(m: MapperState, key, y) -> MapperState:
    """Count y under ``key`` and swap it one rank up where its count now
    exceeds the count of the rank above.  Updates ``m`` in place."""
    to_rank, from_rank, freq = (t.view(-1) for t in m)
    key, y = key.reshape(1), y.reshape(1)
    do = y < N_MAPPER
    base = key * N_MAPPER
    yc = torch.clamp(y, max=N_MAPPER - 1)
    z = to_rank[base + yc]
    zu = torch.clamp(z - 1, min=0)
    yu = from_rank[base + zu]
    at_z, at_zu = base + z, base + zu
    freq.index_put_((at_z,), do.to(freq.dtype), accumulate=True)
    f, fu = freq[at_z], freq[at_zu]
    swap = do & (z > 0) & (fu < f)
    # without a swap every write below puts back the value it read; with one,
    # z != zu and yc != yu, so no two writes of one tensor share a cell
    pair = torch.stack((at_z, at_zu))
    freq[pair] = torch.where(swap, torch.stack((fu, f)), torch.stack((f, fu)))
    from_rank[pair] = torch.where(swap, torch.stack((yu, yc)), from_rank[pair])
    ys = base + torch.stack((yc, yu))
    to_rank[ys] = torch.where(swap, torch.stack((zu, z)), to_rank[ys])
    return m
