"""The Q0.2 interop container (effort 0), encode and decode on a device.

Counterpart of ``nblic_tpu/models/qnblic.py``; writes and reads the same
bytes as the reference codec and the JAX engine.

Encode: the modeling pass runs over the whole plane (``ops/predict.py``).
Its one serial piece, each context's EWMA bias chain, couples only the
pixels of one context address and reads only their prediction errors, which
the whole-plane pass already gives.  So it runs over the 3072 contexts,
each walking its own pixels in raster order: on a CUDA tensor kernel K6
(``ops/interop_walk.py::context_before``), one thread a context; on a CPU
tensor the plain version, lanes over the contexts, where one step of two
tensor operations advances every context whose pixels are not done, and the
steps number the most pixels any context holds (h * w for a flat image,
where every pixel shares one context).  The histograms are normalized on
the host (numpy, as in the JAX package) and the rANS fold runs as ONE
stream of h * w symbols through ``ops/fold.encode_fold``: kernel K1 on a
CUDA tensor, its plain version on the CPU.

Decode is one sequential walk over the raster, a pixel a step, with the
sliding window of ``ops/window.py``: kernel K6 on a CUDA tensor
(``interop_walk.q_decode_walk``), the plain walk on a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import Q_N_CONTEXT, Q_N_QD
from ..convert import resolve_device
from ..ops import context as ctx_ops
from ..ops import histogram as hist_ops
from ..ops import interop_walk, rans
from ..ops.fold import encode_fold
from ..ops.predict import model_stage1
from ..ops.window import pixel_model, row_start_window, slide_window
from ..utils.container import QnblicHeader, check_size

NORM_SUM = hist_ops.NORM_SUM
N_SYM = hist_ops.N_SYM


def _context_chain(x, px0, err, adr):
    """Residual plane y of the per-context EWMA chain, in raster order
    within each context.  Planes (h, w) int32 on one device: kernel K6's
    chain on a CUDA tensor, :func:`_context_chain_plain` on a CPU tensor."""
    if x.device.type == "cuda":
        return _context_chain_card(x, px0, err, adr)
    return _context_chain_plain(x, px0, err, adr)


def _context_chain_card(x, px0, err, adr):
    """The chain by kernel K6: each pixel's state before its step, then the
    bias correction and the fold over the plane."""
    before = interop_walk.context_before(err, adr)
    px, sign = ctx_ops.q_correct_px(before, px0)
    return ctx_ops.residual_fold(x, px, sign, 0)


def _context_chain_plain(x, px0, err, adr):
    """The plain chain, lanes over the contexts, a step of two tensor
    operations for each pixel of the fullest context; any device."""
    dev = x.device
    adr_f = adr.reshape(-1).to(torch.int64)
    n = adr_f.numel()
    counts = torch.bincount(adr_f, minlength=Q_N_CONTEXT)
    # lane l is the context with the l-th most pixels, so the lanes still
    # walking at step k are a prefix, 0 .. n_k - 1
    order = torch.argsort(counts, descending=True, stable=True)
    lane = torch.empty_like(order)
    lane[order] = torch.arange(Q_N_CONTEXT, device=dev)
    by_lane = counts[order].cpu().numpy()
    steps = int(by_lane[0])
    n_k = len(by_lane) - np.searchsorted(by_lane[::-1], np.arange(steps), side="right")
    off = np.concatenate(([0], np.cumsum(n_k)))
    # each pixel's step: its rank among its context's pixels in raster order
    perm = torch.argsort(adr_f, stable=True)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(adr_f)
    rank[perm] = torch.arange(n, device=dev) - start[adr_f[perm]]
    off_t = torch.from_numpy(off).to(dev)
    lane_px = lane[adr_f]
    pos = off_t[rank] + lane_px  # step-major: step k holds lanes 0 .. n_k - 1
    e2 = torch.empty(n, dtype=torch.int32, device=dev)
    e2[pos] = (err.reshape(-1) << 11) + 63
    # c after each step: (127 c + (err << 11) + 63) >> 7, c = 0 before step 0
    c = torch.empty_like(e2)
    torch.bitwise_right_shift(e2[: off[1]], 7, out=c[: off[1]])
    for k in range(1, steps):
        cur = slice(int(off[k]), int(off[k + 1]))
        torch.add(e2[cur], c[int(off[k - 1]) : int(off[k - 1] + n_k[k])], alpha=127,
                  out=c[cur])
        c[cur] >>= 7
    prev = c[off_t[torch.clamp(rank - 1, min=0)] + lane_px]
    before = torch.where(rank == 0, 0, prev).reshape(x.shape)
    px, sign = ctx_ops.q_correct_px(before, px0)
    return ctx_ops.residual_fold(x, px, sign, 0)


def encode(img: np.ndarray, device="cuda") -> bytes:
    """Lossless effort-0 encode into a Q0.2 container."""
    dev = resolve_device(device)
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape
    check_size(h, w)
    x = torch.from_numpy(img).to(dev).to(torch.int32)
    px0, err, qd, adr = model_stage1(x)
    y = _context_chain(x, px0, err, adr)
    sym = (qd * N_SYM + y).reshape(-1).to(torch.int64)
    hist = torch.bincount(sym, minlength=Q_N_QD * N_SYM).view(Q_N_QD, N_SYM).cpu().numpy()
    hist_n = np.stack([hist_ops.normalize(hh) for hh in hist])
    acc = np.stack([hist_ops.accumulate(hh) for hh in hist_n])
    freq = torch.from_numpy(hist_n.astype(np.int32)).to(dev).view(-1)[sym]
    facc = torch.from_numpy(acc.astype(np.int32)).to(dev).view(-1)[sym]
    (payload,) = rans.finalize_streams(*encode_fold(freq[None], facc[None]))
    hist_words: list[int] = []
    for hh in hist_n:
        hist_words.extend(hist_ops.serialize(hh))
    return (QnblicHeader(h, w).to_bytes() + np.asarray(hist_words, np.uint16).tobytes()
            + payload.tobytes())


def _decode_walk(words, hist_n, acc, lut, h: int, w: int):
    """The sequential decode on the tables' device: kernel K6 on a CUDA
    tensor, :func:`_decode_walk_plain` on a CPU tensor.  Returns the (h, w)
    integer plane."""
    if words.device.type == "cuda":
        return interop_walk.q_decode_walk(words, hist_n, acc, lut, h, w)
    return _decode_walk_plain(words, hist_n, acc, lut, h, w)


def _decode_walk_plain(words, hist_n, acc, lut, h: int, w: int):
    """The plain sequential decode, a pixel a step on any device: window,
    model, bias, the rANS symbol, unfold, bias update.  Returns the (h, w)
    int32 plane."""
    dev = words.device
    state, ptr = rans.dec_start(words)
    ctx = torch.zeros(Q_N_CONTEXT, dtype=torch.int32, device=dev)
    hist_f, acc_f = hist_n.view(-1), acc.view(-1)
    # a leading lane axis of one: every per-pixel value is a (1,) tensor,
    # whose indexing gathers on the device (a 0-d index is read on the host)
    rows = torch.zeros((h, 1, w), dtype=torch.int32, device=dev)
    zero_row = torch.zeros((1, w), dtype=torch.int32, device=dev)
    for i in range(h):
        prev1 = rows[i - 1] if i >= 1 else zero_row
        prev2 = rows[i - 2] if i >= 2 else zero_row
        cur = rows[i]
        regs = row_start_window(i, prev1, prev2, w)
        err = torch.zeros(1, dtype=torch.int32, device=dev)
        for j in range(w):
            px0, qd, adr = pixel_model(regs, err)
            c = ctx[adr]
            px, sign = ctx_ops.q_correct_px(c, px0)
            lb = state & rans.NORM_MASK
            y = lut[qd * NORM_SUM + lb]
            at = qd * N_SYM + y
            state, ptr = rans.dec_step(state, ptr, words, hist_f[at], acc_f[at], lb)
            x = ctx_ops.residual_unfold(y.to(torch.int32), px, sign, 0)
            err = x - px0
            ctx[adr] = ctx_ops.q_update_ctx(c, err)
            cur[:, j] = x
            regs = slide_window(regs, x, i, j, prev1, prev2, w)
    return rows[:, 0]


def decode(stream: bytes, device="cuda") -> np.ndarray:
    """Decode a Q0.2 container."""
    dev = resolve_device(device)
    hdr = QnblicHeader.from_bytes(stream)
    check_size(hdr.height, hdr.width)
    words = np.frombuffer(stream, dtype=np.uint16)
    pos = QnblicHeader.SIZE // 2
    hists = []
    for _ in range(Q_N_QD):
        hh, pos = hist_ops.deserialize(words, pos)
        hists.append(hh)
    hist_n = np.stack(hists)
    acc = np.stack([hist_ops.accumulate(hh) for hh in hist_n])
    lut = np.stack([hist_ops.decode_lut(a) for a in acc])

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a).astype(np.int64)).to(dev)

    img = _decode_walk(t(words[pos:]), t(hist_n), t(acc), t(lut).view(-1),
                       hdr.height, hdr.width)
    return img.to(torch.uint8).cpu().numpy()
