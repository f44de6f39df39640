"""Binary range coder, adaptive counters and the escalating symbol coder.

Counterpart of ``nblic_tpu/ops/range_coder.py``, for the NBLIC0.3 walk:

- a carry-less 32-bit range coder with a 12-bit probability split and byte
  renormalization,
- (c0, c1) counter pairs bumped by interpolated weights and halved past
  32 * 256,
- the Zcodec walk: unary bins that escalate to coarser bins, then k binary
  refinement bits, over a (16, 256, 2) counter tree.

The coder's registers are unsigned 32-bit; here they are int64 tensors of
shape (1,) masked to 32 bits (CPU tensors have no uint32 arithmetic), and
every state stays on its device.  The renormalization loop (at most four
bytes a bin) runs in closed form: the count of equal leading bytes of lo
and hi says how many bytes move at once.  The unary walk's length depends
on the data: the host reads its stop flag after every bin, and stops a
corrupt stream's walk after 4098 bins as the reference's guard does.  The counter tree and the byte
buffer are updated in place.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

N_QD = 16
N_QW = 32
MAX_COUNTER = 256
PROB_MAX = 1 << 12
U32_MASK = (1 << 32) - 1
GUARD = 4096  # a unary walk stops after GUARD + 2 bins, whatever it reads


class CoderState(NamedTuple):
    lo: torch.Tensor  # (1,) int64, u32 value
    hi: torch.Tensor  # (1,) int64, u32 value
    window: torch.Tensor  # (1,) int64, the decoder's u32 stream window
    ptr: torch.Tensor  # (1,) int64, next byte to write or read
    buf: torch.Tensor  # uint8 byte stream, 4 spare bytes past its end


@functools.lru_cache(maxsize=None)
def _consts(device):
    """(powers that bound 0-3 equal leading bytes, byte shifts 24..0,
    byte offsets 0..3, one-hot rows of a bin) on a device."""
    def t(v):
        return torch.tensor(v, dtype=torch.int64, device=device)

    return t([1 << 24, 1 << 16, 1 << 8, 1]), t([24, 16, 8, 0]), t([0, 1, 2, 3]), \
        t([[1, 0], [0, 1]])


def _scalar(v, device):
    return torch.full((1,), v, dtype=torch.int64, device=device)


def coder_init_encode(buf: torch.Tensor) -> CoderState:
    """Encoder registers over ``buf``, a uint8 buffer whose last 4 bytes
    take writes past the capacity (the caller checks ``ptr`` at the end)."""
    dev = buf.device
    return CoderState(_scalar(0, dev), _scalar(U32_MASK, dev), _scalar(0, dev),
                      _scalar(0, dev), buf)


def coder_init_decode(payload: torch.Tensor) -> CoderState:
    """Decoder registers over a uint8 payload.  The window takes its first 4
    bytes, the last one repeated where it is shorter (the JAX engine's
    clamped gather); an empty payload raises.  Later reads past its end give
    0: the state's buffer is the payload and 4 zero bytes."""
    n = payload.shape[0]
    if n == 0:
        raise ValueError("empty NBLIC0.3 payload")
    dev = payload.device
    _, shifts, _, _ = _consts(dev)
    head = payload[[min(k, n - 1) for k in range(4)]].to(torch.int64)
    buf = torch.cat((payload, torch.zeros(4, dtype=torch.uint8, device=dev)))
    return CoderState(_scalar(0, dev), _scalar(U32_MASK, dev),
                      (head << shifts).sum().reshape(1), _scalar(4, dev), buf)


def _renorm(st: CoderState, decode: bool) -> CoderState:
    """Shift out the n leading bytes that lo and hi share (n <= 4)."""
    lo, hi, window, ptr, buf = st
    bounds, shifts, offsets, _ = _consts(buf.device)
    n = ((lo ^ hi) < bounds).sum().reshape(1)
    sh = n * 8
    at = torch.clamp(ptr + offsets, max=buf.shape[0] - 1)
    if decode:
        nxt = (buf[at].to(torch.int64) << shifts).sum()
        window = ((window << sh) | (nxt >> (32 - sh))) & U32_MASK
    else:
        # all 4 of hi's bytes go out; those past the n shared ones are
        # overwritten by the next write, which starts at ptr + n
        buf[at] = ((hi >> shifts) & 0xFF).to(torch.uint8)
    lo = (lo << sh) & U32_MASK
    hi = (((hi + 1) << sh) - 1) & U32_MASK
    return CoderState(lo, hi, window, ptr + n, buf)


def code_bit(st: CoderState, bin_in, prob, decode: bool):
    """One binary decision at P(1) = prob / 4096.  Returns (state, bin)."""
    lo, hi, window, ptr, buf = st
    span = (hi - lo) & U32_MASK
    # (span >> 12) * prob + (((span & 0xFFF) * prob) >> 12) == (span * prob) >> 12
    mid = (lo + ((span * prob) >> 12)) & U32_MASK
    b = (window <= mid).to(torch.int64) if decode else bin_in
    one = b == 1
    st = CoderState(torch.where(one, lo, (mid + 1) & U32_MASK), torch.where(one, mid, hi),
                    window, ptr, buf)
    return _renorm(st, decode), b


def coder_flush(st: CoderState) -> CoderState:
    """Encoder flush: lo's 4 bytes, most significant first."""
    lo, hi, window, ptr, buf = st
    _, shifts, offsets, _ = _consts(buf.device)
    buf[torch.clamp(ptr + offsets, max=buf.shape[0] - 1)] = \
        ((lo >> shifts) & 0xFF).to(torch.uint8)
    return CoderState(lo, hi, window, ptr + 4, buf)


def counter_bump(tree, row, idx, b, amount):
    """Add ``amount`` to counter ``b`` of pair (row, idx); halve the pair
    (rounding up) once its sum passes 32 * 256.  In place; returns tree."""
    pairs = tree.view(-1, 2)
    at = row * tree.shape[1] + idx
    c = pairs[at] + amount[..., None] * _consts(tree.device)[3][b]
    c = torch.where(c.sum(-1, keepdim=True) > N_QW * MAX_COUNTER, (c + 1) >> 1, c)
    pairs[at] = c
    return tree


def _prob1(c):
    return (PROB_MAX * c[..., 1]) // (c[..., 0] + c[..., 1])


def mixed_code_bit(st: CoderState, tree, qu, qv, i, qw, bin_in, decode: bool):
    """Code one bin at the qw-weighted mix of counters (qu, i) and (qv, i),
    then bump each by its weight, v's bump seeing u's where qu == qv.
    Returns (state, tree, bin)."""
    pairs = tree.view(-1, 2)
    weights = torch.cat((N_QW - qw, qw))
    p1 = _prob1(pairs[torch.cat((qu, qv)) * tree.shape[1] + i])
    prob = ((p1 * weights).sum(0, keepdim=True) + N_QW // 2) // N_QW
    st, b = code_bit(st, bin_in, torch.clamp(prob, 1, PROB_MAX - 1), decode)
    counter_bump(tree, qu, i, b, weights[:1])
    counter_bump(tree, qv, i, b, weights[1:])
    return st, tree, b


def code_symbol(st: CoderState, tree, k_step: int, qu, qv, qw, z_in, decode: bool):
    """Code z: unary bins over rows qu/qv of the tree, each level of 2^k_max
    bins escalating to a coarser row and a halved bin index, then k = qu //
    k_step refinement bits, most significant first.  Returns (state, tree,
    z); on encode z is ``z_in``, on decode ``z_in`` is ignored."""
    k_max = (N_QD - 1) // k_step
    qv = torch.where(qv // k_step != qu // k_step, qu, qv)
    i = torch.zeros_like(qu)
    for _ in range(GUARD + 2):
        k = qu // k_step
        bin_in = i if decode else ((i >> k_max) < (z_in >> k)).to(torch.int64)
        st, tree, b = mixed_code_bit(st, tree, qu, qv, i, qw, bin_in, decode)
        go = b == 1
        i2 = i + (1 << k_max)
        esc = (i2 >= 256) & go
        i = torch.where(go, torch.where(esc, i2 >> 1, i2), i)
        qn = torch.clamp((k + 1) * k_step, max=N_QD - 1)
        qu = torch.where(esc, qn, qu)
        qv = torch.where(esc, qn, qv)
        # one read of the flag and the row: the walk's only host sync
        stopped, q = torch.cat(((~go).to(qu.dtype), qu)).tolist()
        if stopped:
            break
    k = q // k_step
    z = (i >> k_max) << k if decode else z_in
    i = i + 1
    for kk in range(k - 1, -1, -1):
        bin_in = i if decode else (z_in >> kk) & 1
        st, tree, b = mixed_code_bit(st, tree, qu, qv, i, qw, bin_in, decode)
        if decode:
            z = z + (b << kk)
        i = i + torch.where(b == 1, 1 << kk, 1)
    return st, tree, z
