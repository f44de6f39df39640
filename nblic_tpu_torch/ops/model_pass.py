"""The profile-3 modeling pass on the card: kernels K10
(``csrc/p3_model_chains.cu``) and K11 (``csrc/p3_model_solve.cu``).

Counterpart of ``nblic_tpu/ops/pavp.py::predict_plane``'s chains
(``run_chains`` over the energy channel, the moment blocks ``block_stats``
and the mix channels) and its solve (``predict_chunked``), which the JAX
package runs as XLA scans and a ``lax.map`` (no ``pallas_call``).  The
pass, :func:`predict_plane`:

1. :func:`features`: the feature planes, pixel-major (P, n + 1) int32
   ``[x - FIT_BASE, tap_0 - FIT_BASE, ...]``, and the simple prediction;
2. :func:`chains` (K10) over the energy channel, whose E + F gives each
   pixel's sample weight, then the n + n^2 moment channels (one wavefront
   launch, or two-pass launches within the scratch budget: ``chain_design``):
   the (rows, m) int64 statistics, a row a pixel, or a segment under w_pred;
3. :func:`solve` (K11): each row's ridge solve and its pixels' prediction,
   the simple prediction where a pivot was 0;
4. under mix_e, :func:`chains` over the two mix channels, then
   ``pavp.mix_blend``, elementwise torch.

Each wrapper takes its plain version (:func:`chains_plain`,
:func:`solve_plain`, built from ``ops/pavp.py``'s functions, same
arguments, same output layout) for CPU tensors; on CUDA tensors it
launches its kernel or raises.  ``ops/pavp.py::predict_plane`` keeps its
own path for CPU tensors and comes here for CUDA tensors.
"""

from __future__ import annotations

import torch

from .. import kernels
from . import pavp
from .avp import BETA, FB1, FIT_BASE, tdiv
from .neighbors import sample
from .predict import simple_predict

# K10's designs (csrc/p3_model_chains.cu): two passes, B through
# an (S H W, k) int64 scratch; the skewed wavefront at 32 channel lanes a
# warp, 2 rows a thread (moments only)
TWO_PASS, WAVE = 0, 32
SCRATCH_BYTES = 1 << 31  # the most B scratch a two-pass launch takes
PLAIN, FREEZE, HOLD = 0, 1, 2  # K10's forms: E + F; E decay-extended; both held
ENERGY, MOMENTS, MIX = 0, 1, 2  # K10's kinds of channel


def form_of(w: int, seg_w: int, w_quant: bool) -> tuple[int, int]:
    """(form, seg) of the chains at width ``w``: E frozen at segment
    starts and decay-extended (seg_stats), E and F held there (w_pred, one
    statistics row a segment), or plain where the segments do not divide
    the row (``pavp.e_freeze_extend`` and ``hold_starts`` then return E
    unchanged)."""
    if seg_w > 1 and w % seg_w == 0:
        return (HOLD if w_quant else FREEZE), seg_w
    return PLAIN, 1


def features(strips, n: int):
    """(fe, px_s) of (S, H, W) strips: fe (S H W, n + 1) int32, a pixel's
    x - FIT_BASE then its n features (the taps a, b, c, d, e, f, t, h, q,
    g, r, s minus FIT_BASE, the t tap (i - 1, j + 2) falling back to d out
    of range, as ``pavp.predict_plane`` forms them); px_s (S, H, W) int32,
    the simple prediction."""
    _, h, w = strips.shape
    x = strips.to(torch.int32)
    nb = sample(x)
    px_s = simple_predict(nb)
    up2r = torch.roll(x, shifts=(1, -2), dims=(1, 2))
    ii = torch.arange(h, device=x.device)[:, None]
    jj = torch.arange(w, device=x.device)[None, :]
    t_tap = torch.where((ii >= 1) & (jj + 2 < w), up2r, nb.d)
    taps = (x, nb.a, nb.b, nb.c, nb.d, nb.e, nb.f, t_tap, nb.h, nb.q, nb.g, nb.r, nb.s)
    fe = torch.stack([v - FIT_BASE for v in taps[:1 + n]], dim=-1)
    return fe.reshape(-1, n + 1).to(torch.int32).contiguous(), px_s


def chain_design(s: int, h: int, k: int, sms: int) -> int:
    """K10's design for a launch of ``k`` channels over ``s`` strips of
    ``h`` rows on a card of ``sms`` SMs: the wavefront for the moments
    where its (strip, 32-channel block) CTAs fill twice the SMs (the th-64
    corpus); else the two passes (th 768, where the wavefront would leave
    4 CTAs in all)."""
    if k > 2 and s * -(-k // 32) >= 2 * sms:
        return WAVE
    return TWO_PASS


def _moment_blocks(n: int, p: int) -> list[tuple[int, int]]:
    """(first, count) of each two-pass moment launch: the n + n^2 channels
    in as few equal launches as keep the scratch within SCRATCH_BYTES."""
    total = n + n * n
    k_max = max(1, SCRATCH_BYTES // (8 * max(p, 1)))
    k = -(-total // -(-total // k_max))
    return [(q, min(k, total - q)) for q in range(0, total, k)]


def chains_plain(fe, preds, shape, n: int, seg_w: int = 0, w_quant: bool = False):
    """:func:`chains` by ``ops/pavp.py``'s torch loops (``_run_chains``,
    ``_moments``, ``_clip_s_sum``), in its output layout."""
    s, h, w = shape
    x = fe[:, 0].to(torch.int64).reshape(s, h, w) + FIT_BASE
    errs = torch.stack([torch.abs(x - p.to(torch.int64).reshape(s, h, w)) << FB1
                        for p in preds])
    if len(preds) == 2:  # the mix chains
        return pavp._run_chains(errs, BETA, 0, False).reshape(2, -1).t().contiguous()
    s_curr = errs[0]
    stats = torch.empty((pavp.get_m(n), s, h, w), dtype=torch.int64, device=fe.device)
    stats[0] = pavp._run_chains(s_curr[None], BETA, seg_w, w_quant)[0]
    s_sum_c = pavp._clip_s_sum(stats[0] + tdiv(s_curr * BETA, s_curr.new_tensor(BETA - 1)))
    ext = fe.to(torch.int64).t().reshape(n + 1, s, h, w)
    for blk in range(1 + n):
        shift = 4 + FB1 + FB1 if blk == 0 else 4 + pavp.FB2 + FB1
        stats[1 + blk * n : 1 + (blk + 1) * n] = pavp._run_chains(
            pavp._moments(ext[blk : blk + 1], ext[1:], shift, s_sum_c), pavp.ALPHA, seg_w,
            w_quant)
    form, seg = form_of(w, seg_w, w_quant)
    stats = stats.permute(1, 2, 3, 0)
    if form == HOLD:
        stats = stats[:, :, ::seg]
    return stats.reshape(-1, pavp.get_m(n)).contiguous()


def _launch_chains(kind, fe, pred, ssum, srecip, out, shape, n, q0, k, c0, form, seg,
                   design=TWO_PASS):
    s, h, w = shape
    lib = kernels.library()
    size = lib.nbt_p3_model_chains_scratch(s, h, w, k, design)
    scratch = torch.empty(size, dtype=torch.int64, device=fe.device) if size > 0 else None
    rc = lib.nbt_p3_model_chains(
        kind, fe.data_ptr(), pred.data_ptr(), ssum.data_ptr(), srecip.data_ptr(),
        None if scratch is None else scratch.data_ptr(), out.data_ptr(), s, h, w, n, q0, k,
        out.shape[1], c0, seg, form, design, *kernels.stream_of(fe))
    kernels.check(rc, "p3_model_chains")
    chains.launches += 1


def chains(fe, preds, shape, n: int, seg_w: int = 0, w_quant: bool = False):
    """K10: the E + F statistics of (S, H, W) = ``shape`` strips.

    ``fe`` (S H W, n + 1) int32 from :func:`features`; ``preds`` (K, S H W)
    int32.  K = 1, ``preds[0]`` the simple prediction: the model's
    statistics, (rows, 1 + n + n^2) int64, channel 0 the energy's, then the
    b-vector's and the matrix's moments, a row a pixel (S, H, W order) or,
    where w_pred holds them (:func:`form_of`), a row a segment.  K = 2, the
    hard and the simple prediction: the two mix chains, (S H W, 2).  CPU
    tensors take :func:`chains_plain`; CUDA tensors launch K10 (the energy
    channel, then the moments in the design of :func:`chain_design`: one
    wavefront launch, or two-pass launches in :func:`_moment_blocks`; one
    count a launch) or raise."""
    if fe.device.type == "cpu":
        return chains_plain(fe, preds, shape, n, seg_w, w_quant)
    s, h, w = shape
    p = s * h * w
    mix = len(preds) == 2
    if len(preds) not in (1, 2) or not 1 <= n <= 12:
        raise ValueError(f"K10 takes 1 or 2 prediction planes and 1..12 features, got "
                         f"{len(preds)} and {n}")
    if w >= 1 << 16:
        raise ValueError(f"K10 takes strips narrower than 65536 columns, got {w}")
    dev = fe.device
    if p == 0:
        return torch.empty((0, 2 if mix else pavp.get_m(n)), dtype=torch.int64, device=dev)
    kernels.check_tensors({"fe": (fe, (p, n + 1), torch.int32),
                           "preds": (preds, (len(preds), p), torch.int32)}, dev, "K10")
    ssum = torch.empty(p, dtype=torch.int32, device=dev)
    srecip = torch.empty(p, dtype=torch.int64, device=dev)  # uint64 bits
    if mix:  # plain chains: mix_e rules out the segment forms
        out = torch.empty((p, 2), dtype=torch.int64, device=dev)
        _launch_chains(MIX, fe, preds, ssum, srecip, out, shape, n, 0, 2, 0, PLAIN, 1)
        return out
    form, seg = form_of(w, seg_w, w_quant)
    k = n + n * n
    rows = p // seg if form == HOLD else p  # w_pred: a row a segment
    out = torch.empty((rows, pavp.get_m(n)), dtype=torch.int64, device=dev)
    _launch_chains(ENERGY, fe, preds, ssum, srecip, out, shape, n, 0, 1, 0, form, seg)
    design = chain_design(s, h, k, torch.cuda.get_device_properties(dev).multi_processor_count)
    blocks = [(0, k)] if design == WAVE else _moment_blocks(n, p)
    for q0, kk in blocks:
        _launch_chains(MOMENTS, fe, preds, ssum, srecip, out, shape, n, q0, kk, 1 + q0, form,
                       seg, design)
    return out


chains.launches = 0


def solve_plain(stats, fe, px_s, n: int, seg: int = 1, w_quant: bool = False):
    """:func:`solve` by ``pavp.predict_chunked`` on every pixel's system
    (a segment's row repeated for each of its pixels)."""
    if seg > 1:
        stats = stats.repeat_interleave(seg, dim=0)
    px_v, ok = pavp.predict_chunked(stats.t(), fe[:, 1:].t().to(torch.int64), n, w_quant)
    if w_quant:  # already pixel units
        px0 = px_v.to(torch.int32)
    else:
        px0 = ((px_v + (1 << (FB1 - 1))) >> FB1).to(torch.int32)
    return torch.where(ok, px0, px_s), ok


def solve(stats, fe, px_s, n: int, seg: int = 1, w_quant: bool = False):
    """K11: the ridge solve of each statistics row of :func:`chains` and
    the prediction of its pixels.  ``stats`` (rows, 1 + n + n^2) int64, a
    row ``seg`` pixels (seg > 1 only with ``w_quant``); ``fe`` (rows seg,
    n + 1) int32; ``px_s`` (rows seg,) int32.  Returns (px, ok): the hard
    prediction int32 (``px_s`` where a pivot was 0) and the solve's
    success, each (rows seg,).  CPU tensors take :func:`solve_plain`; CUDA
    tensors launch K11 or raise."""
    if stats.device.type == "cpu":
        return solve_plain(stats, fe, px_s, n, seg, w_quant)
    rows = stats.shape[0]
    if not 1 <= n <= 12 or seg < 1 or (seg > 1 and not w_quant):
        raise ValueError(f"K11 takes 1..12 features and segments only with w_quant, got n {n}, "
                         f"seg {seg}, w_quant {w_quant}")
    dev = stats.device
    p = rows * seg
    kernels.check_tensors({"stats": (stats, (rows, pavp.get_m(n)), torch.int64),
                           "fe": (fe, (p, n + 1), torch.int32),
                           "px_s": (px_s, (p,), torch.int32)}, dev, "K11")
    px = torch.empty(p, dtype=torch.int32, device=dev)
    ok = torch.empty(p, dtype=torch.bool, device=dev)
    rc = kernels.library().nbt_p3_model_solve(
        stats.data_ptr(), fe.data_ptr(), px_s.data_ptr(), px.data_ptr(), ok.data_ptr(), rows,
        seg, n, int(w_quant), *kernels.stream_of(stats))
    kernels.check(rc, "p3_model_solve")
    solve.launches += 1
    return px, ok


solve.launches = 0


def predict_plane(strips, n: int = pavp.N_FEAT, seg_w: int = 0, mix: bool = False,
                  w_quant: bool = False):
    """``pavp.predict_plane`` through :func:`chains` and :func:`solve`:
    the int32 px0 plane of (S, H, W) strips of 8-bit pixels.  On CUDA
    tensors K10 and K11; on CPU tensors their plain versions."""
    if mix and seg_w:
        raise ValueError("mix_e is incompatible with seg_stats")
    if strips.numel():
        lo, hi = (int(v) for v in torch.aminmax(strips))
        if lo < 0 or hi > 255:
            raise ValueError(f"the modeling pass takes 8-bit pixels, got [{lo}, {hi}]")
    shape = tuple(strips.shape)
    fe, px_s = features(strips, n)
    px_flat = px_s.reshape(-1)
    form, seg = form_of(shape[2], seg_w, w_quant)
    stats = chains(fe, px_flat[None], shape, n, seg_w, w_quant)
    px_hard, ok = solve(stats, fe, px_flat, n, seg if form == HOLD else 1, w_quant)
    del stats
    if not mix:
        return px_hard.reshape(shape)
    ef = chains(fe, torch.stack([px_hard, px_flat]), shape, n)
    return pavp.mix_blend(px_hard, px_flat, ef[:, 0], ef[:, 1], ok).reshape(shape)
