"""Binary rANS with 12-bit probabilities: the NBTC profile-3 entropy stage.

Counterpart of ``nblic_tpu/ops/rans_bin.py``.  Every
(strip, phase) pair owns an independent rANS state; slots go to phases
statically (phase = slot index mod N_PHASE), so each state's slot sequence
is a reshape of the dense slot grid.  Masked slots pass the state through
and emit nothing; the decoder walks the same layer structure and skips the
same slots.

32-bit state in [2^16, 2^32), one u16 word per renormalization.  The state
is carried as int64 masked to 32 bits, as in ``ops/rans.py``: CPU tensors
of ``torch.uint32`` lack shifts, division and comparison.  Streams are
packed in decode order by ``rans.pack_streams``.  On the card the fold is
kernel K3 (``csrc/bin_fold.cu``, :func:`fold_card`), the counterpart of
nblic_tpu's ``lax.scan``; :func:`fold_plain` is its plain version.
"""

from __future__ import annotations

import torch

from .. import kernels

PROB_BITS = 12
PROB_MAX = 1 << PROB_BITS          # 4096
ANS_BITS = 16
ANS_MASK = (1 << ANS_BITS) - 1
ANS_LOW = 1 << ANS_BITS

N_PHASE = 16                        # interleaved states per strip lane
BYPASS_P1 = PROB_MAX // 2           # raw-bit probability


def fold(p1, bins, mask):
    """Lockstep reverse fold of S independent bin sequences; see
    :func:`fold_plain` for the contract.

    A CPU tensor runs the plain version, :func:`fold_plain`; a CUDA tensor
    launches kernel K3 (``csrc/bin_fold.cu``, :func:`fold_card`) or raises;
    any other device raises.
    """
    if p1.dim() != 2 or p1.shape != bins.shape or p1.shape != mask.shape:
        raise ValueError(f"p1/bins/mask must be equal (S, n): {tuple(p1.shape)}, "
                         f"{tuple(bins.shape)}, {tuple(mask.shape)}")
    if not p1.device == bins.device == mask.device:
        raise ValueError("p1, bins and mask lie on different devices")
    if p1.device.type == "cpu":
        return fold_plain(p1, bins, mask)
    if p1.device.type == "cuda":
        return fold_card(p1, bins, mask)
    raise ValueError(f"the fold runs on cpu or cuda, not {p1.device}")


def _bytes(t, live: bool):
    """A byte plane of bins (1 a one) or masks (nonzero live) as K3 reads
    them: 1-byte dtypes as they are, wider ones compared first."""
    if t.dtype in (torch.bool, torch.int8, torch.uint8):
        return t.view(torch.uint8).contiguous()
    return ((t != 0) if live else (t == 1)).to(torch.uint8).contiguous()


def fold_card(p1, bins, mask):
    """:func:`fold_plain` on the card: kernel K3, one chain a state over
    its live slots.  p1/bins/mask: (S, n) integer (mask also bool) CUDA
    tensors of one device, as :func:`fold` checks them; p1 as int16 (wider
    values clipped to int16 first, which K3's clip to [1, 4095] then gives
    as :func:`fold_plain`'s), bins and mask a byte each.  Returns what
    :func:`fold_plain` returns, every word included."""
    for name, t in (("p1", p1), ("bins", bins), ("mask", mask)):
        if t.dtype.is_floating_point or t.dtype.is_complex or (t.dtype == torch.bool
                                                               and name == "p1"):
            raise ValueError(f"{name} must be an integer tensor, got {t.dtype}")
    if p1.device.type != "cuda":
        raise ValueError(f"p1 lies on {p1.device}: K3 runs on one CUDA device")
    s, n = p1.shape
    p16 = (p1 if p1.dtype == torch.int16 else
           torch.clamp(p1, -(1 << 15), (1 << 15) - 1).to(torch.int16)).contiguous()
    b8, m8 = _bytes(bins, False), _bytes(mask, True)
    words = torch.empty((n, s), dtype=torch.int32, device=p1.device)
    emits = torch.empty((n, s), dtype=torch.bool, device=p1.device)
    state = torch.full((s,), ANS_LOW, dtype=torch.int32, device=p1.device)
    if s > 0 and n > 0:
        dev, stream = kernels.stream_of(p1)
        rc = kernels.library().nbt_bin_fold(p16.data_ptr(), b8.data_ptr(), m8.data_ptr(),
                                            words.data_ptr(), emits.data_ptr(),
                                            state.data_ptr(), s, n, dev, stream)
        kernels.check(rc, "bin_fold")
        fold_card.launches += 1
    # rows of `words` and `emits` are fold steps
    return words.t(), emits.t(), state.to(torch.int64) & U32


fold_card.launches = 0


def fold_plain(p1, bins, mask):
    """Lockstep reverse fold of S independent bin sequences: the plain
    version of kernel K3.

    p1/bins/mask: (S, L) in decode order (the fold walks them backwards).
    Masked slots leave the state untouched and emit nothing: they fold as a
    symbol of frequency 4096 at offset 0, which maps every state below 2^32
    onto itself without renormalizing.  Returns (words (S, L) int32, emits
    (S, L) bool, state (S,) int64), words and emits in fold order, ready for
    ``rans.pack_streams``.  The step loop never syncs with the host.
    """
    s, l = p1.shape
    p1 = torch.clamp(p1.to(torch.int64), 1, PROB_MAX - 1)
    one = bins == 1
    live = mask.to(torch.bool)
    freq = torch.where(live, torch.where(one, p1, PROB_MAX - p1), PROB_MAX)
    acc = torch.where(live & one, PROB_MAX - p1, 0)
    freq, acc = (a.flip(-1).t().contiguous() for a in (freq, acc))
    bound = freq << (2 * ANS_BITS - PROB_BITS)  # renormalize at or past f << 20
    state = torch.full((s,), ANS_LOW, dtype=torch.int64, device=p1.device)
    before = torch.empty((l, s), dtype=torch.int64, device=p1.device)
    emits = torch.empty((l, s), dtype=torch.bool, device=p1.device)
    for k in range(l):
        f = freq[k]
        renorm = state >= bound[k]
        before[k] = state
        emits[k] = renorm
        state = torch.where(renorm, state >> ANS_BITS, state)
        state = ((torch.div(state, f, rounding_mode="floor") << PROB_BITS)
                 + torch.remainder(state, f) + acc[k])
    return (before & ANS_MASK).to(torch.int32).t(), emits.t(), state


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


U32 = (1 << 32) - 1


def dec_init(words):
    """words: (..., W) stream rows [hi, lo, ...].  Returns (state int64,
    ptr int64), the pointer at the first renormalization word."""
    w = words.to(torch.int64) & U32
    state = ((w[..., 0] << ANS_BITS) | w[..., 1]) & U32
    return state, torch.full_like(state, 2)


def dec_masked(state, ptr, p1, active, words):
    """One decode step on the lanes where ``active``: the binary symbol
    from each lane's state, then the renorm against the lane's own stream
    row (a state below 2^16 takes the word at ``ptr``; reads past the row's
    end clamp to its last word).  The other lanes keep their state and
    pointer and decode 0.  nblic_tpu's ``dec_bit`` then ``dec_renorm``,
    which clips ``p1`` to [1, 4095]: here it must already lie there.
    state/ptr/p1/active: (...,); words: (..., W) of u16 values, int64.
    Returns (bin bool, state, ptr)."""
    p0 = PROB_MAX - p1
    lb = state & (PROB_MAX - 1)
    one = lb >= p0
    st = (state >> PROB_BITS) * torch.where(one, p1, p0) + lb - torch.where(one, p0, 0)
    need = (st < ANS_LOW) & active
    nxt = words.gather(-1, torch.clamp(ptr, max=words.shape[-1] - 1)[..., None])[..., 0]
    state = torch.where(need, (st << ANS_BITS) | nxt, torch.where(active, st, state))
    return one & active, state, ptr + need
