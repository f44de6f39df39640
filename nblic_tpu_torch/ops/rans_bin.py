"""Binary rANS with 12-bit probabilities: the NBTC profile-3 entropy stage.

Counterpart of ``nblic_tpu/ops/rans_bin.py`` (the encoder's half).  Every
(strip, phase) pair owns an independent rANS state; slots go to phases
statically (phase = slot index mod N_PHASE), so each state's slot sequence
is a reshape of the dense slot grid.  Masked slots pass the state through
and emit nothing; the decoder walks the same layer structure and skips the
same slots.

32-bit state in [2^16, 2^32), one u16 word per renormalization.  The state
is carried as int64 masked to 32 bits, as in ``ops/rans.py``: CPU tensors
of ``torch.uint32`` lack shifts, division and comparison.  Streams are
packed in decode order by ``rans.pack_streams``.
"""

from __future__ import annotations

import torch

PROB_BITS = 12
PROB_MAX = 1 << PROB_BITS          # 4096
ANS_BITS = 16
ANS_MASK = (1 << ANS_BITS) - 1
ANS_LOW = 1 << ANS_BITS

N_PHASE = 16                        # interleaved states per strip lane
BYPASS_P1 = PROB_MAX // 2           # raw-bit probability


def fold(p1, bins, mask):
    """Lockstep reverse fold of S independent bin sequences.

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
