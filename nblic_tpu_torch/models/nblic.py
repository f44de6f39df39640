"""The NBLIC0.3 interop container (efforts 1-3), encode and decode on a device.

Counterpart of ``nblic_tpu/models/nblic.py``; writes and reads the same
bytes as the reference codec and the JAX engine at every effort 1-3 and
``near`` 0-9.  One walk serves both directions, a pixel a step in raster
order: it samples the causal template afresh from three rows
(``ops/window.py``), predicts (the blend predictor; at efforts 2-3 the
int64 online least-squares AVP of ``ops/avp.py``, solved at two ridge
strengths, falling back to the blend where a system is singular),
quantizes the activity into two weighted bins, corrects by the context's
adaptive bias (``ops/context.py``), re-ranks small residuals
(``ops/automapper.py``) and codes the symbol with the adaptive binary range
coder (``ops/range_coder.py``).  Encode folds each pixel against its own
reconstruction, so near-lossless coding predicts from what the decoder
sees.  On a CUDA tensor the walk is kernel K6 (``ops/interop_walk.py``),
one launch an image, every state on the card and no host read inside;
on a CPU tensor it is the plain walk :func:`_walk_plain`, whose states
live on its device and whose host reads the range coder's unary stop
flag once a bin.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import MAX_NEAR, MAX_PX_INC, MIN_K_STEP, N_CONTEXT
from ..convert import resolve_device
from ..ops import automapper, avp, interop_walk
from ..ops import context as ctx_ops
from ..ops import range_coder as rc
from ..ops.predict import activity, n_context_address, n_quantize_activity, n_simple_predict
from ..ops.window import fresh_t_tap, fresh_window_rows
from ..utils.container import NblicHeader, check_size


def capacity(h: int, w: int) -> int:
    """Byte capacity of an encode's output; a stream past it raises."""
    return 4 * h * w + 4096


def _walk(st, h: int, w: int, near: int, k_step: int, effort: int, img=None):
    """The codec walk on the coder's device: kernel K6 on a CUDA tensor,
    :func:`_walk_plain` on a CPU tensor.  ``img`` (h, w) integer pixels on
    that device encodes, None decodes.  Returns (reconstruction (h, w),
    coder state)."""
    if st.buf.device.type == "cuda":
        return interop_walk.nblic_walk(st, h, w, near, k_step, effort, img)
    return _walk_plain(st, h, w, near, k_step, effort, img)


def _walk_plain(st, h: int, w: int, near: int, k_step: int, effort: int, img=None):
    """The plain codec walk, a pixel a step on any device; ``img`` (h, w)
    int64 encodes, None decodes.  Returns (reconstruction (h, w) int64,
    coder state)."""
    decode = img is None
    dev = st.buf.device
    n_feat = avp.N_LIST[effort]
    use_avp = n_feat > 0
    m_stat = avp.get_m(n_feat) if use_avp else 1

    def scalar(v):
        return torch.full((1,), v, dtype=torch.int64, device=dev)

    tree = torch.full((rc.N_QD, 256, 2), rc.N_QW, dtype=torch.int64, device=dev)
    maps = automapper.init_mappers(dev)
    ctx = torch.zeros(N_CONTEXT, dtype=torch.int64, device=dev)
    rows = torch.zeros((h, w), dtype=torch.int64, device=dev)
    b_cols = torch.zeros((w, m_stat), dtype=torch.int64, device=dev)
    biasv = scalar(avp.BIAS_INIT)
    zero = scalar(0)
    for i in range(h):
        cur = rows[i]
        prev1 = rows[i - 1] if i >= 1 else cur
        prev2 = rows[i - 2] if i >= 2 else cur
        if use_avp:
            f_cols = avp.precalculate_f(b_cols, m_stat)
            e_acc = torch.zeros(m_stat, dtype=torch.int64, device=dev)
        err = zero
        for j in range(w):
            nb = fresh_window_rows(i, j, cur, prev1, prev2, w)
            px0 = n_simple_predict(nb)
            if use_avp:
                feat = avp.features(nb, fresh_t_tap(i, j, prev1, w, nb.d), n_feat)
                biases = torch.cat(avp.dual_biases(biasv))
                f_col = f_cols[j]
                pxf, ok = avp.predict(e_acc, f_col, feat, biases, n_feat)
                px1f = torch.where(ok[:1], pxf[:1], px0 << avp.FB1)
                px0 = torch.where(ok[:1], (pxf[:1] + (1 << (avp.FB1 - 1))) >> avp.FB1, px0)
            qu, qv, qw = n_quantize_activity(activity(nb, err))
            adr = n_context_address(nb, px0, qu)
            c = ctx[adr]
            px, sign = ctx_ops.n_correct_px(c, px0)
            key = px * 2 + sign
            if decode:
                st, tree, z = rc.code_symbol(st, tree, k_step, qu, qv, qw, zero, True)
                y = automapper.unfold(maps, key, z)
            else:
                y = ctx_ops.residual_fold(img[i, j : j + 1], px, sign, near)
                st, tree, _ = rc.code_symbol(st, tree, k_step, qu, qv, qw,
                                             automapper.fold(maps, key, y), False)
            automapper.observe(maps, key, y)
            x = ctx_ops.residual_unfold(y, px, sign, near)
            err = torch.clamp(x - px0, -MAX_PX_INC, MAX_PX_INC)
            ctx[adr] = ctx_ops.n_update_ctx(c, err)
            cur[j : j + 1] = x
            if use_avp:
                # misses of the two strengths' predictions, the first's
                # replaced by the blend where its system was singular
                miss = torch.abs(torch.cat((px1f, pxf[1:])) - (x << avp.FB1))
                s_sum = e_acc[:1] + f_col[:1] + torch.div(miss[:1] * avp.BETA, avp.BETA - 1,
                                                          rounding_mode="trunc")
                e_acc, b_cols[j] = avp.update(e_acc, b_cols[j], feat, x, miss[:1], s_sum,
                                              n_feat)
                # the strength whose prediction missed by less, where both solved
                both = ok.all().reshape(1)
                biasv = torch.where(both, torch.where(miss[:1] > miss[1:], biases[1:],
                                                      biases[:1]), biasv)
    return rows, st


def encode(img: np.ndarray, near: int = 0, effort: int = 1, device="cuda") -> bytes:
    """Encode into an NBLIC0.3 container at effort 1-3 and ``near`` (clipped
    to 0..9); raises ValueError if the stream outgrows :func:`capacity`."""
    if effort not in (1, 2, 3):
        raise NotImplementedError("effort must be 1..3")
    dev = resolve_device(device)
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape
    check_size(h, w)
    near = int(np.clip(near, 0, MAX_NEAR))
    k_step = int(np.clip(MIN_K_STEP + 2 * near, MIN_K_STEP, 16))
    cap = capacity(h, w)
    # 4 spare bytes take the renormalization's writes past ptr
    st = rc.coder_init_encode(torch.zeros(cap + 4, dtype=torch.uint8, device=dev))
    x = torch.from_numpy(img).to(dev).to(torch.int64)
    _, st = _walk(st, h, w, near, k_step, effort, x)
    st = rc.coder_flush(st)
    n_bytes = int(st.ptr)
    if n_bytes > cap:
        raise ValueError("compressed stream exceeded output capacity")
    return NblicHeader(1, h, w, near, k_step, effort).to_bytes() + \
        st.buf[:n_bytes].cpu().numpy().tobytes()


def decode(stream: bytes, device="cuda") -> np.ndarray:
    """Decode an NBLIC0.3 container (efforts 1-3)."""
    dev = resolve_device(device)
    hdr = NblicHeader.from_bytes(stream)
    if hdr.effort not in (1, 2, 3):
        raise ValueError(f"bad effort {hdr.effort}")
    if hdr.k_step < 2:  # the walk divides by it, and at 1 indexes past the counter tree
        raise ValueError(f"bad k_step {hdr.k_step}")
    check_size(hdr.height, hdr.width)
    payload = np.frombuffer(stream, dtype=np.uint8, offset=NblicHeader.SIZE)
    st = rc.coder_init_decode(torch.from_numpy(payload.copy()).to(dev))
    rows, _ = _walk(st, hdr.height, hdr.width, hdr.near, hdr.k_step, hdr.effort)
    return rows.to(torch.uint8).cpu().numpy()
