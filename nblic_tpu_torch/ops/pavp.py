"""Parallel AVP: the NBTC profile-3 predictor (the encoder's half).

Counterpart of ``nblic_tpu/ops/pavp.py``.  The reference AVP is an online
int64 ridge regression whose statistics decay per column (B), per row
position (E) and as a right-to-left prefix (F).  In lossless coding every
input of those recurrences is an original pixel, so the predictor becomes
three short chains over whole planes plus one independent n x n integer
solve per pixel:

- ``col_chain``: B, a per-column decay over rows;
- ``e_chain``: E, the in-row left accumulation of B;
- ``f_chain``: F, the right-to-left decayed prefix of the previous row's B;
- ``avp.solve_batch``: per-pixel Gaussian elimination with partial
  pivoting, the pixel axis last.

These loops are the plain versions; on the card :func:`predict_plane`
runs kernels K10 (the chains) and K11 (the solve) through
``ops/model_pass.py``.

All arithmetic is int64 with C-truncating division (``avp.tdiv``), wrapping
as the reference's does, so every backend computes the same bits.  Chains
take (T, C, ...) tensors, T the scanned axis and C the channels.
"""

from __future__ import annotations

import torch

from ..constants import MAX_VAL
from .avp import ALPHA, BETA, FB1, FB2, FB3, FIT_BASE, predict_from_solve, solve_batch, tdiv
from .neighbors import sample
from .predict import simple_predict

RIDGE_BIAS = 8  # the ridge strength, fixed at the reference's initial bias
N_FEAT = 6
# pixels per solve chunk: each chunk's elimination holds ~4 m int64 values a
# pixel at once (m = 111 at n = 10), ~0.9 GB at this size
SOLVE_CHUNK = 1 << 18
# predictor mixing: pre-square downshift of the |err| energies
MIX_SH = 12
# w_pred: quantization step 2^-FBW of a pixel; |weight| below 2^19
FBW = 12
WCLIP = (1 << 19) - 1


def get_m(n: int) -> int:
    return 1 + n + n * n


def _ab(x, first_beta: bool, ab):
    """Per-channel decay denominators shaped to broadcast over x[0]: BETA for
    the energy channel, ALPHA for the regression moments, unless ``ab``
    gives one per channel."""
    c = x.shape[1]
    if ab is None:
        ab = [BETA if first_beta else ALPHA] + [ALPHA] * (c - 1)
    return torch.as_tensor(ab, dtype=torch.int64, device=x.device).view(
        (c,) + (1,) * (x.dim() - 2))


def mix_ab():
    """Decay denominators of the two mix channels (both energy-class)."""
    return (BETA, BETA)


def ab_vec(ab, device=None):
    """Per-channel decay denominators as an int64 (C, 1) tensor, made once
    for a loop that decays (C, L) columns: ``ab`` is m, for the energy
    channel's BETA then m - 1 moment channels' ALPHA, or a tuple of
    denominators."""
    if isinstance(ab, int):
        ab = (BETA,) + (ALPHA,) * (ab - 1)
    return torch.tensor(ab, dtype=torch.int64, device=device).view(-1, 1)


def decay(v, ab):
    # tdiv by a positive divisor: the numerators here never near 2^63
    return torch.div(v * (ab - 1) + (ab >> 1), ab, rounding_mode="trunc")


def col_chain(contrib, first_beta: bool = True, ab=None):
    """B state after the update at each row.  contrib: (H, C, ...) int64."""
    ab = _ab(contrib, first_beta, ab)
    out = torch.empty_like(contrib)
    b = torch.zeros_like(contrib[0])
    for i in range(contrib.shape[0]):
        b = decay(b, ab) + contrib[i]
        out[i] = b
    return out


def e_chain(b_new, first_beta: bool = True, ab=None):
    """E before each column (E after column j - 1, zero at j = 0): the in-row
    accumulation of post-update B columns.  b_new: (W, C, ...)."""
    ab = _ab(b_new, first_beta, ab)
    out = torch.empty_like(b_new)
    e = torch.zeros_like(b_new[0])
    for j in range(b_new.shape[0]):
        out[j] = e
        e = decay(e, ab) + b_new[j]
    return out


def f_chain(b_prev, first_beta: bool = True, ab=None):
    """F at each column from the previous row's B, accumulated right to left.
    b_prev: (W, C, ...)."""
    ab = _ab(b_prev, first_beta, ab)
    out = torch.empty_like(b_prev)
    f = torch.zeros_like(b_prev[0])
    for j in range(b_prev.shape[0] - 1, -1, -1):
        f = decay(f, ab) + b_prev[j]
        out[j] = f
    return out


def e_freeze_extend(e, seg_w: int, first_beta: bool = True, ab=None):
    """Segment-frozen E: E'(j0 + k) = decay^k(E(j0)) for the segment starts
    j0 (multiples of ``seg_w``), what a decoder batching a segment's solves
    can compute before decoding it.  e: (W, C, ...)."""
    w = e.shape[0]
    if seg_w <= 1 or w % seg_w:
        return e
    ab = _ab(e, first_beta, ab)
    full = e.reshape((w // seg_w, seg_w) + e.shape[1:]).clone()
    st = full[:, 0]
    for k in range(1, seg_w):
        st = decay(st, ab)
        full[:, k] = st
    return full.reshape(e.shape)


def hold_starts(e, seg_w: int):
    """Hold chain values at segment starts: e'(j0 + k) = e(j0).  e: (W, C, ...)."""
    w = e.shape[0]
    if seg_w <= 1 or w % seg_w:
        return e
    blocks = e.reshape((w // seg_w, seg_w) + e.shape[1:])
    return blocks[:, :1].expand(blocks.shape).reshape(e.shape)


def quantize_weights(diag, num):
    """(diag, num) solve output -> int32 fixed-point weights (w_pred): the
    pixel-unit coefficient num * 2^(FB2 - FB1) / diag at step 2^-FBW, on
    magnitudes (quotient and remainder apart: the shifted numerator would
    overflow int64), truncated toward zero and clipped."""
    efb = FBW - FB1 + FB2  # = 2
    safe = torch.where(diag == 0, 1, diag)
    ad, an = torch.abs(safe), torch.abs(num)
    big = ad >= (1 << 48)
    ad = torch.clamp(torch.where(big, ad >> 16, ad), min=1)
    an = torch.where(big, an >> 16, an)
    q0 = torch.div(an, ad, rounding_mode="floor")
    r = an - q0 * ad
    mag = (torch.clamp(q0, max=1 << 28) << efb) + torch.div(r << efb, ad,
                                                            rounding_mode="floor")
    sgn = torch.sign(num) * torch.sign(safe)
    return torch.clamp(sgn * mag, -WCLIP, WCLIP).to(torch.int32)


def predict_wq(wq, feats32):
    """int32 prediction from quantized weights (n, ...) and int32 features
    tap - FIT_BASE: |acc| < 2^30, so the dot stays in int32."""
    acc = torch.sum(wq * feats32, dim=0, dtype=torch.int32)
    px = torch.clamp((FIT_BASE << FBW) + acc, 0, MAX_VAL << FBW)
    return (px + (1 << (FBW - 1))) >> FBW


def mix_blend(px_a, px_s, e_a, e_s, ok):
    """px0 = (px_a (e_s' + 1) + px_s (e_a' + 1)) / (e_a' + e_s' + 2) with
    e' = (e >> MIX_SH)^2; px_s where the solve failed."""
    ea2 = (e_a >> MIX_SH) * (e_a >> MIX_SH)
    es2 = (e_s >> MIX_SH) * (e_s >> MIX_SH)
    den = ea2 + es2 + 2
    num = px_a.to(torch.int64) * (es2 + 1) + px_s.to(torch.int64) * (ea2 + 1) + (den >> 1)
    return torch.where(ok, torch.div(num, den, rounding_mode="floor").to(torch.int32),
                       px_s)


def solve_stats(stats, n: int):
    """The ridge system of (m, P) E + F statistics, solved: (diag, x_num,
    ok) of :func:`solve_batch`."""
    bvec = stats[1 : 1 + n] + (RIDGE_BIAS << FB3)
    eye = torch.eye(n, dtype=torch.int64, device=stats.device)[:, :, None]
    amat = stats[1 + n :].reshape(n, n, -1) + eye * (RIDGE_BIAS * n)
    return solve_batch(amat, bvec, n)


def predict_from_stats(stats, feats, n: int):
    """Ridge solve + fixed-point prediction.  stats: (m, P) = E + F;
    feats: (n, P).  Returns (px in FB1 fixed point, ok)."""
    diag, num, ok = solve_stats(stats, n)
    return predict_from_solve(diag, num, feats), ok


def predict_from_stats_wq(stats, feats, n: int):
    """Ridge solve + w_pred quantized-weight prediction: (px0 in pixel
    units int32, ok)."""
    diag, num, ok = solve_stats(stats, n)
    return predict_wq(quantize_weights(diag, num), feats.to(torch.int32)), ok


def predict_chunked(stats, feats, n: int, w_quant: bool = False):
    """The per-pixel solves in chunks of SOLVE_CHUNK pixels, bounding the
    elimination's temporaries."""
    fn = predict_from_stats_wq if w_quant else predict_from_stats
    parts = [fn(stats[:, i : i + SOLVE_CHUNK], feats[:, i : i + SOLVE_CHUNK], n)
             for i in range(0, stats.shape[1], SOLVE_CHUNK)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _moments(left, right, shift, s_sum_c):
    """Weighted moment contributions ((left * right) << shift) / s_sum,
    rounded half up, truncated toward zero."""
    return tdiv(((left * right) << shift) + (s_sum_c >> 1), s_sum_c)


def _clip_s_sum(s_sum):
    return torch.clamp(s_sum + (1 << FB1), 1 << FB1, 16 << FB1)


def contributions(x, feats, s_curr, s_sum, n: int):
    """Per-pixel moment contributions (the reference's AVPupdate).

    x: (P,) int64 pixels; feats: (n, P); s_curr/s_sum: (P,).  Returns (m, P)
    int64: [energy, b-vector, A-matrix flattened]."""
    s_sum_c = _clip_s_sum(s_sum)
    vb = _moments(x - FIT_BASE, feats, 4 + FB1 + FB1, s_sum_c)
    va = _moments(feats[:, None], feats[None], 4 + FB2 + FB1, s_sum_c)
    return torch.cat([s_curr[None], vb, va.reshape(n * n, -1)])


def _run_chains(contrib, ab, seg_w: int, w_quant: bool):
    """contrib (C, S, H, W) -> the (E + F) statistics, same shape; ``ab``
    the decay denominator of every channel."""
    abv = (ab,) * contrib.shape[0]
    b_new = col_chain(contrib.permute(2, 0, 1, 3).contiguous(), ab=abv)  # (H, C, S, W)
    b_prev = torch.cat([torch.zeros_like(b_new[:1]), b_new[:-1]])
    # E over the current row's B; with seg_w frozen at segment starts,
    # decay-extended or (w_pred) held
    e = e_chain(b_new.permute(3, 1, 2, 0).contiguous(), ab=abv)  # (W, C, S, H)
    f = f_chain(b_prev.permute(3, 1, 2, 0).contiguous(), ab=abv)
    del b_new, b_prev
    if seg_w and w_quant:
        e, f = hold_starts(e, seg_w), hold_starts(f, seg_w)
    elif seg_w:
        e = e_freeze_extend(e, seg_w, ab=abv)
    return (e + f).permute(1, 2, 3, 0)


def predict_plane(strips, n: int = N_FEAT, seg_w: int = 0, mix: bool = False,
                  w_quant: bool = False):
    """AVP prediction for every pixel of (S, H, W) strips: int32 px0 plane.

    The per-sample inverse-error-energy weight uses the simple predictor's
    error.  ``seg_w``: E frozen at segment starts (the seg_stats contract; with
    ``w_quant`` the whole E + F held, one solve a segment).  ``mix``: blend
    the hard-fallback prediction with the simple one by squared causal
    decayed |err| energies; incompatible with ``seg_w``.
    ``w_quant``: predict with int32 quantized weights (w_pred).
    On a CUDA tensor the pass runs on kernels K10 and K11
    (``ops/model_pass.py``); the loops below serve CPU tensors.
    """
    if strips.device.type == "cuda":
        from .model_pass import predict_plane as on_card

        return on_card(strips, n, seg_w=seg_w, mix=mix, w_quant=w_quant)
    return predict_plane_loops(strips, n, seg_w, mix, w_quant)


def predict_plane_loops(strips, n: int = N_FEAT, seg_w: int = 0, mix: bool = False,
                        w_quant: bool = False):
    """:func:`predict_plane` by the torch loops on any device: the plain
    version of the whole pass."""
    if mix and seg_w:
        raise ValueError("mix_e is incompatible with seg_stats")
    s, h, w = strips.shape
    x32 = strips.to(torch.int32)
    nb = sample(x32)
    px_s = simple_predict(nb)
    x = strips.to(torch.int64)

    # t tap: img[i-1, j+2], falling back to d out of range
    up2r = torch.roll(x, shifts=(1, -2), dims=(1, 2))
    ii = torch.arange(h, device=x.device)[:, None]
    jj = torch.arange(w, device=x.device)[None, :]
    t_tap = torch.where((ii >= 1) & (jj + 2 < w), up2r, nb.d.to(torch.int64))
    taps = (nb.a, nb.b, nb.c, nb.d, nb.e, nb.f, t_tap, nb.h, nb.q, nb.g, nb.r, nb.s)
    feats = torch.stack([v.to(torch.int64) - FIT_BASE for v in taps[:n]])

    def chains(contrib, ab):
        return _run_chains(contrib, ab, seg_w, w_quant)

    # the energy channel first: its E + F weighs every moment channel
    s_curr = torch.abs(x - px_s.to(torch.int64)) << FB1
    stats = torch.empty((get_m(n), s, h, w), dtype=torch.int64, device=x.device)
    stats[0] = chains(s_curr[None], BETA)[0]
    s_sum_c = _clip_s_sum(stats[0] + tdiv(s_curr * BETA, s_curr.new_tensor(BETA - 1)))
    # the moment channels in blocks of n (one block holds ~5 n int64
    # planes): block 0 the b-vector xf * feat_k, block 1 + i row i of A
    feats_ext = torch.cat([(x - FIT_BASE)[None], feats])
    for blk in range(1 + n):
        if blk == 0:
            left, right, shift = feats_ext[:1], feats_ext[1:], 4 + FB1 + FB1
        else:
            left, right, shift = feats_ext[blk : blk + 1], feats_ext[1:], 4 + FB2 + FB1
        stats[1 + blk * n : 1 + (blk + 1) * n] = chains(
            _moments(left, right, shift, s_sum_c), ALPHA)

    px_v, ok = predict_chunked(stats.reshape(get_m(n), -1), feats.reshape(n, -1), n,
                               w_quant)
    del stats
    if w_quant:  # already pixel units
        px0 = px_v.to(torch.int32).reshape(s, h, w)
    else:
        px0 = ((px_v + (1 << (FB1 - 1))) >> FB1).to(torch.int32).reshape(s, h, w)
    okp = ok.reshape(s, h, w)
    px_hard = torch.where(okp, px0, px_s)
    if not mix:
        return px_hard
    # mix chains: causal decayed |err| energies of both predictors
    c_mix = torch.stack([torch.abs(x - px_hard.to(torch.int64)) << FB1,
                         torch.abs(x - px_s.to(torch.int64)) << FB1])
    ef_mix = chains(c_mix, BETA)
    return mix_blend(px_hard, px_s, ef_mix[0], ef_mix[1], okp)
