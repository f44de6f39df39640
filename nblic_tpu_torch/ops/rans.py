"""rANS coding with static tables, 16-bit renormalization, 15-bit histograms.

Counterpart of ``nblic_tpu/ops/rans.py``: the plain lockstep encode fold,
the interleaved multi-lane stream layout and the decoder's shared-cursor
renormalization.  The coder state is an unsigned 32-bit value; here it is
carried as int64 masked to 32 bits, because CPU tensors of ``torch.uint32``
lack shifts, division and comparison.  Every function accepts leading batch
axes (one per interleave group).
"""

from __future__ import annotations

import numpy as np
import torch

ANS_BITS = 16
ANS_MASK = (1 << ANS_BITS) - 1
ANS_LOW_BOUND = 1 << ANS_BITS
NORM_BITS = 15
NORM_MASK = (1 << NORM_BITS) - 1
ANS_HIGH_BOUND_NORM = (1 << (2 * ANS_BITS - NORM_BITS)) - 1
U32_MASK = (1 << 32) - 1


def encode_scan(freq: torch.Tensor, acc: torch.Tensor):
    """Plain lockstep rANS encode of S parallel streams.

    freq/acc: (S, L) per-symbol frequency / cumulative frequency in raster
    order; the fold walks them in reverse.  Returns (words, emits, state):
    words (S, L) int32, the candidate u16 word at each fold step; emits
    (S, L) bool, whether that step renormalized; state (S,) int64, the final
    u32 coder state.  Step order along L is fold order (reverse raster).
    """
    s, l = freq.shape
    freq_t = freq.to(torch.int64).t().contiguous()
    acc_t = acc.to(torch.int64).t().contiguous()
    state = torch.full((s,), ANS_LOW_BOUND, dtype=torch.int64, device=freq.device)
    words = torch.empty((l, s), dtype=torch.int32, device=freq.device)
    emits = torch.empty((l, s), dtype=torch.bool, device=freq.device)
    for k in range(l):
        h = freq_t[l - 1 - k]
        renorm = (state // h) > ANS_HIGH_BOUND_NORM
        words[k] = state & ANS_MASK
        emits[k] = renorm
        state = torch.where(renorm, state >> ANS_BITS, state)
        state = ((state % h) + ((state // h) << NORM_BITS) + acc_t[l - 1 - k]) & U32_MASK
    return words.t(), emits.t(), state


def interleave_pack(words, emits, state):
    """Pack a lockstep fold into ONE interleaved stream (decode-read order).

    words/emits: (..., S, L) in fold order; state: (..., S).  Head: S hi-words
    (lane ascending) then S lo-words; body: for decode step t ascending, the
    words consumed at step t in lane-ascending order (fold step L-1-t).
    Returns (flat (..., S*(L+2)) int32, of which only the first ``total``
    entries are meaningful, and total (...,) int64).
    """
    s, l = words.shape[-2:]
    cap = s * (l + 2)
    e = emits.to(torch.int64)
    cnt = e.sum(-2)  # (..., L) words per fold step
    # decode step t consumes fold step L-1-t: the words of fold step f start
    # after those of every fold step f' > f
    suffix = cnt.flip(-1).cumsum(-1).flip(-1) - cnt
    rank = e.cumsum(-2) - e  # lane-exclusive prefix
    pos = (2 * s + suffix)[..., None, :] + rank
    idx = torch.where(emits, pos, cap)  # slot `cap` collects the non-emits
    lead = words.shape[:-2]
    flat = torch.zeros(lead + (cap + 1,), dtype=torch.int32, device=words.device)
    flat.scatter_(-1, idx.reshape(lead + (-1,)),
                  words.to(torch.int32).reshape(lead + (-1,)))
    flat = flat[..., :cap]
    st = state.to(torch.int64)
    flat[..., :s] = ((st >> ANS_BITS) & ANS_MASK).to(torch.int32)
    flat[..., s : 2 * s] = (st & ANS_MASK).to(torch.int32)
    return flat, 2 * s + cnt.sum(-1)


def interleaved_dec_init(stream, n_lanes: int):
    """Lockstep decoder init from interleaved streams (..., W).

    Returns (state (..., n_lanes) int64, cursor (...,) int64).
    """
    hi = stream[..., :n_lanes].to(torch.int64) & ANS_MASK
    lo = stream[..., n_lanes : 2 * n_lanes].to(torch.int64) & ANS_MASK
    sp = torch.full(stream.shape[:-1], 2 * n_lanes, dtype=torch.int64,
                    device=stream.device)
    return (hi << ANS_BITS) | lo, sp


def interleaved_dec_renorm(state, sp, stream, active):
    """Post-symbol renorm of all lanes against the shared cursor.

    state (..., G) int64; sp (...,) cursor; stream (..., W); active (..., G)
    bool lane mask.  Each lane below the low bound reads the word at the
    cursor plus its exclusive rank among the needing lanes, clamped to the
    stream's end.  Returns (state, sp).
    """
    need = (state < ANS_LOW_BOUND) & active
    n = need.to(torch.int64)
    rank = n.cumsum(-1) - n
    idx = torch.clamp(sp[..., None] + rank, max=stream.shape[-1] - 1)
    word = stream.gather(-1, idx).to(torch.int64) & ANS_MASK
    state = torch.where(need, (state << ANS_BITS) | word, state)
    return state, sp + n.sum(-1)


def pad_streams(flat: np.ndarray, lengths: np.ndarray, wmax: int) -> np.ndarray:
    """Host-side layout of packed streams into a (S, wmax) lockstep matrix."""
    lengths = np.asarray(lengths, dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    idx = offsets[:, None] + np.arange(wmax)[None, :]
    mask = np.arange(wmax)[None, :] < lengths[:, None]
    idx = np.minimum(idx, len(flat) - 1)
    return np.where(mask, np.asarray(flat)[idx], 0).astype(np.int32)
