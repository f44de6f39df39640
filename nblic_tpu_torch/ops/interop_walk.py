"""The interop engines' serial walks on the card: kernel K6
(``csrc/interop_walk.cu``, its per-pixel functions in
``csrc/interop_chain.cuh``).

Three entries, each one launch:

- :func:`nblic_walk`: the NBLIC0.3 codec walk of one image (efforts 1-3,
  encode and decode), the counterpart of ``nblic_tpu/models/nblic.py``'s
  ``_codec_scan`` (a ``lax.scan``, no ``pallas_call``); its plain version
  is ``models/nblic.py::_walk_plain``;
- :func:`q_decode_walk`: the Q0.2 decode walk of one image
  (``nblic_tpu/models/qnblic.py``'s ``_decode_scan``; plain
  ``models/qnblic.py::_decode_walk_plain``);
- :func:`context_before`: the Q0.2 encode's per-context EWMA chain, one
  thread a context over its pixels in raster order
  (``nblic_tpu/models/qnblic.py``'s ``_context_chain``; plain, the step
  loop of ``models/qnblic.py::_context_chain_plain``).

The dispatchers in ``models/nblic.py`` and ``models/qnblic.py`` take these
for a CUDA tensor and the plain versions for a CPU tensor.  Each wrapper
checks its tensors, launches on the current stream, counts the launch and
reads nothing back: a walk's coder registers stay on the card.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..constants import Q_N_CONTEXT, Q_N_QD
from . import avp
from .histogram import N_SYM, NORM_SUM
from .range_coder import CoderState


def nblic_walk(st: CoderState, h: int, w: int, near: int, k_step: int, effort: int,
               img=None):
    """The NBLIC0.3 walk of one (h, w) image on the card (kernel K6):
    ``img`` (h, w) integer pixels encodes, None decodes from ``st``.

    ``st`` is the coder's state as ``range_coder.coder_init_encode`` /
    ``coder_init_decode`` make it, on one CUDA device.  Returns (the
    reconstruction (h, w) uint8, the coder's state after the walk: new
    register tensors over the same buffer, written on encode).  effort
    must be 1..3, k_step at least 2 (below, the walk's counter index passes
    the tree), near at least 0.  The count of binary decisions the walk
    codes lands in ``nblic_walk.bins``, a (1,) int64 tensor on the card
    (read by measurements, never by the walk).
    """
    if effort not in (1, 2, 3):
        raise ValueError(f"K6 walks efforts 1..3, got {effort}")
    if k_step < 2 or near < 0 or h < 1 or w < 1:
        raise ValueError(f"K6 takes k_step >= 2, near >= 0 and a non-empty image, got "
                         f"k_step {k_step}, near {near}, {h}x{w}")
    dev = st.buf.device
    regs = [t.to(torch.int64).clone() for t in st[:4]]
    want = {name: (t, (1,), torch.int64) for name, t in zip(("lo", "hi", "window", "ptr"), regs)}
    want["buf"] = (st.buf, (st.buf.numel(),), torch.uint8)
    if img is not None:
        img = img.to(torch.uint8).contiguous()
        want["img"] = (img, (h, w), torch.uint8)
    kernels.check_tensors(want, dev, "K6")
    n_feat = avp.N_LIST[effort]
    rec = torch.empty((h, w), dtype=torch.uint8, device=dev)
    b = f = None
    if n_feat > 0:
        b = torch.zeros((w, avp.get_m(n_feat)), dtype=torch.int64, device=dev)
        f = torch.empty_like(b)
    bins = torch.zeros(1, dtype=torch.int64, device=dev)
    rc = kernels.library().nbt_interop_nblic_walk(
        img.data_ptr() if img is not None else None, rec.data_ptr(),
        *(t.data_ptr() for t in regs), st.buf.data_ptr(), st.buf.numel(),
        b.data_ptr() if b is not None else None, f.data_ptr() if f is not None else None,
        bins.data_ptr(), h, w, near, k_step, effort, int(img is None), *kernels.stream_of(rec))
    kernels.check(rc, "nbt_interop_nblic_walk")
    nblic_walk.launches += 1
    nblic_walk.bins = bins
    return rec, CoderState(*regs, st.buf)


nblic_walk.launches = 0
nblic_walk.bins = None


def q_decode_walk(words, hist_n, acc, lut, h: int, w: int):
    """The Q0.2 decode of one (h, w) image on the card (kernel K6): words
    (n,) the stream's u16 words, n >= 1; hist_n and acc (12, 256) the
    normalized histograms and their exclusive prefix sums; lut (12 *
    2^15,) the symbol of each state slot; integer tensors on one CUDA
    device.  Returns the (h, w) uint8 image."""
    if words.dim() != 1 or words.numel() == 0:
        raise ValueError("empty rANS stream")
    if h < 1 or w < 1:
        raise ValueError(f"K6 decodes a non-empty image, got {h}x{w}")
    dev = words.device
    words32 = words.to(torch.int32).contiguous()
    freq = hist_n.to(torch.int32).reshape(-1).contiguous()
    cum = acc.to(torch.int32).reshape(-1).contiguous()
    lut8 = lut.to(torch.uint8).reshape(-1).contiguous()
    kernels.check_tensors({"words": (words32, (words32.numel(),), torch.int32),
                           "hist_n": (freq, (Q_N_QD * N_SYM,), torch.int32),
                           "acc": (cum, (Q_N_QD * N_SYM,), torch.int32),
                           "lut": (lut8, (Q_N_QD * NORM_SUM,), torch.uint8)}, dev, "K6")
    rec = torch.empty((h, w), dtype=torch.uint8, device=dev)
    rc = kernels.library().nbt_interop_q_decode(
        words32.data_ptr(), words32.numel(), freq.data_ptr(), cum.data_ptr(), lut8.data_ptr(),
        rec.data_ptr(), h, w, *kernels.stream_of(rec))
    kernels.check(rc, "nbt_interop_q_decode")
    q_decode_walk.launches += 1
    return rec


q_decode_walk.launches = 0


def context_before(err, adr):
    """Each pixel's context state before its EWMA step (kernel K6): err and
    adr integer planes of one shape on one CUDA device, adr in
    0..3071.  The pixels of a context step in raster order, an order a
    stable sort by address gives.  Returns the int32 plane of states."""
    if err.shape != adr.shape:
        raise ValueError(f"err and adr differ in shape: {tuple(err.shape)}, "
                         f"{tuple(adr.shape)}")
    dev = err.device
    adr_f = adr.reshape(-1).to(torch.int64)
    order = torch.argsort(adr_f, stable=True)
    start = torch.zeros(Q_N_CONTEXT + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.bincount(adr_f, minlength=Q_N_CONTEXT), 0, out=start[1:])
    err32 = err.reshape(-1).to(torch.int32).contiguous()
    n = err32.numel()
    kernels.check_tensors({"err": (err32, (n,), torch.int32),
                           "order": (order, (n,), torch.int64),
                           "start": (start, (Q_N_CONTEXT + 1,), torch.int64)}, dev, "K6")
    before = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        rc = kernels.library().nbt_interop_q_chain(
            err32.data_ptr(), order.data_ptr(), start.data_ptr(), Q_N_CONTEXT,
            before.data_ptr(), *kernels.stream_of(before))
        kernels.check(rc, "nbt_interop_q_chain")
        context_before.launches += 1
    return before.view(err.shape)


context_before.launches = 0
