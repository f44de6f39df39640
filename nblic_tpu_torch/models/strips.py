"""NBTC profile 3, lossless encode: the adaptive-coding strip engine.

Counterpart of the encoder's half of ``nblic_tpu/models/strips.py``; writes
the same containers byte for byte.  Images are normalized to portrait (the
long axis scans as rows; the header flags a transpose) and cut into
full-width strips of ``th`` rows.  Every strip of every same-shape image of
a call is one lane, and all lanes run in lockstep:

- Modeling (:func:`_model_planes`): the parallel AVP prediction
  (``ops/pavp.py``), then the activity quantizers and the context address,
  all whole-plane tensor math.
- Row scan (:func:`_row_scan`): for each row and each of its column
  segments, the row-adaptive context bias corrects the prediction, the
  AutoMapper ranks the folded residual, and the layered Zcodec walk
  (``ops/zcodec3.py``) turns it into binary decisions whose probabilities
  come from the counter tables (``ops/coder3.py``); the tables, the mapper
  history and the bias moments then take the segment's events.  Counters
  are per lane; the mapper and the bias are per image.
- Fold (``ops/rans_bin.py``): binary rANS over 16 phase states a strip,
  slots assigned to phases statically, then ``rans.pack_streams``.

Container (``NBTC0001``, profile 3): header | 32-byte Tune block | u32
word count per state | the states' u16 streams.  ``tile_h`` is the strip
height; ``tile_w`` bit 0 the transpose, bit 1 the legacy tune-version bit,
bits 2 and 3 the extended Tune block, bits 4+ the AVP feature count;
``n_tiles`` the strip count; ``bias_len`` 0 (the bias is replayed, not
sent).  Decode and near-lossless are not ported yet (ROADMAP Queue 1 items
10 and 11).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import MAX_VAL, Q_N_CONTEXT
from ..convert import resolve_device
from ..ops import coder3, pavp, rans, rans_bin, zcodec3
from ..ops.context import quantize_bias, residual_fold
from ..ops.neighbors import sample
from ..ops.predict import (
    activity, context_address, n_quantize_activity, quantize_activity, shift_err,
)
from ..utils.container import NbtcHeader, check_size

# default strip height: a whole 768-row Kodak-shaped image is one strip
TH_DEFAULT = 768
AVP_N = 10          # AVP feature count; containers record it
K_STEP = 3          # lossless k_step
N_PHASE = rans_bin.N_PHASE
L_R = zcodec3.ESCAPE_BITS  # the refine grid carries the escape bits too
PROFILE = 3
MAX_PX_INC = 127    # the error clip feeding the activity


class Tune(NamedTuple):
    """Replay-contract constants, serialized in every container (16
    little-endian u16 in this field order) so decode never consults
    process state."""

    bias_cap: int     # halve the bias moment pairs past this count
    map_bump: int     # mapper count increment per event
    map_halve: int    # halve mapper counts past this max
    n_unary: int      # unary layer budget before the raw escape
    bias_shrink: int  # pseudo-counts pulling sparse-context bias to 0
    n_seg: int = 1    # column segments per row for counter adaptation
    seg_bias: int = 0   # context-bias moments also update per segment
    seg_map: int = 0    # AutoMapper ranks/history also update per segment
    seg_stats: int = 0  # AVP E chains frozen at segment starts
    sym_cnt: int = 0    # per-symbol counter adaptation inside segments
    cnt_init: int = 32     # unary/refine counter pair init
    cnt_halve: int = 8192  # counter halving threshold
    mix_e: int = 0      # blend AVP and simple predictions by |err| energies
    sym_bias: int = 0   # per-symbol context-bias reads inside segments
    w_pred: int = 0     # int32 quantized-weight prediction (needs seg_stats)
    spare: int = 0      # reserved, must be 0

    SIZE = 20   # legacy serialized block: the first 10 fields
    SIZE2 = 32  # extended serialized block: all 16 fields

    def to_bytes(self) -> bytes:
        return np.asarray(self, dtype="<u2").tobytes()

    @classmethod
    def from_bytes(cls, data: bytes, extended: bool = False) -> "Tune":
        size = cls.SIZE2 if extended else cls.SIZE
        if len(data) < size:
            raise ValueError("truncated profile-3 tune block")
        return cls(*(int(v) for v in np.frombuffer(data[:size], dtype="<u2")))

    def validate(self) -> "Tune":
        """Range-check the replay constants; a hostile block fails with a
        ValueError before any work."""
        ok = (
            1 <= self.bias_cap <= 32768
            and 1 <= self.map_bump <= 4096
            and 1 <= self.map_halve
            and 1 <= self.n_unary <= 20
            and self.bias_shrink <= 4096
            and 1 <= self.n_seg <= 4096
            and self.seg_bias in (0, 1)
            and self.seg_map in (0, 1)
            and self.seg_stats in (0, 1)
            and self.sym_cnt in (0, 1)
            and 1 <= self.cnt_init <= 16384
            and 64 <= self.cnt_halve
            and self.mix_e in (0, 1)
            and self.sym_bias in (0, 1)
            and self.w_pred in (0, 1)
            and self.spare == 0
            and not (self.mix_e and self.seg_stats)
            and not (self.w_pred and not self.seg_stats)
        )
        if not ok:
            raise ValueError(f"invalid profile-3 tune block: {tuple(self)}")
        return self


TUNE_V1 = Tune(2048, 4, 4096, 9, 0, 1, 0, 0, 0, 0)
TUNE_V2 = Tune(256, 2, 512, 13, 16, 1, 0, 0, 0, 0)
# sub-row adaptation of counters, bias and mapper at 32 column segments
TUNE_V3 = Tune(256, 2, 256, 13, 48, 32, 1, 1, 0, 0)
# V3 + squared-energy predictor mixing: the default
TUNE_V4 = TUNE_V3._replace(mix_e=1)
# max ratio: + per-symbol counters
TUNE_MAX = TUNE_V4._replace(sym_cnt=1)
# serving: 64 segments with segment-frozen AVP stats
TUNE_V3S = TUNE_V3._replace(n_seg=64, seg_stats=1)
# serving: + quantized-weight prediction, 10 unary layers, row-frozen
# bias and mapper
TUNE_V4S = TUNE_V3S._replace(w_pred=1, n_unary=10, seg_bias=0, seg_map=0)
# what new containers are encoded with
TUNE = TUNE_V4


def _eff_seg(n_seg: int, w: int) -> int:
    """Effective column-segment count: the largest divisor of ``w`` not
    above the requested ``n_seg``."""
    n = max(1, min(int(n_seg), w))
    while w % n:
        n -= 1
    return n


# ---------------------------------------------------------------------------
# modeling
# ---------------------------------------------------------------------------


def _model_planes(strips, n_feat: int = AVP_N, seg_w: int = 0, mix: bool = False,
                  w_quant: bool = False):
    """Whole-plane modeling of (L, th, W) strips: AVP prediction, activity
    quantizers and the context address.  Returns int32 planes (x, px0, adr,
    qu, qv, qw).  The bias correction and the residual fold happen in the
    row scan: the bias is row-adaptive."""
    x = strips.to(torch.int32)
    px0 = pavp.predict_plane(x, n_feat, seg_w=seg_w, mix=mix, w_quant=w_quant)
    nb = sample(x)
    err_c = torch.clamp(x - px0, -MAX_PX_INC, MAX_PX_INC)
    delta = activity(nb, shift_err(err_c))
    qu, qv, qw = n_quantize_activity(delta)
    adr = context_address(nb, px0, quantize_activity(delta))
    return x, px0, adr, qu, qv, qw


# ---------------------------------------------------------------------------
# the coding model of one column segment
# ---------------------------------------------------------------------------


def _code_events(z, qu, qv, k_step: int, n_unary: int):
    """Layer decomposition of a symbol plane: the coded events whose
    probabilities and counter updates the contract defines."""
    unary, row_end, k_end, escaped = zcodec3.unary_layers(z, qu, qv, k_step, n_unary)
    refine = zcodec3.refine_layers(z, k_end, escaped)
    return unary, refine, row_end, k_end, escaped


def _prefix_counts(tab, events, reads):
    """Per-symbol counts: for each read, the lane's segment-start counts of
    its cell plus the events of earlier slots, slots ordered column-major
    (column, then layer).

    tab: (L, ..., 2) counts; events: (cell, bin, weight) triples and reads:
    cells, all (E, L, ws), cells flat pair indexes into ``tab``.  Returns the
    counts before each read, (E, L, ws, 2).
    """
    n_l = tab.shape[0]
    k = tab[0].numel() // 2
    e, _, ws = reads[0].shape
    t = ws * e
    lane = torch.arange(n_l, device=tab.device)[:, None]
    slot = torch.arange(t, device=tab.device)[None]

    def by_slot(a):  # (E, L, ws) -> (L, ws * E), slot = column * E + layer
        return a.permute(1, 2, 0).reshape(n_l, t)

    def local(cell):  # the pair within its lane's table
        return by_slot(cell) - lane * k

    inc = torch.zeros(n_l * t * k * 2, dtype=tab.dtype, device=tab.device)
    for cell, b, wgt in events:
        idx = ((lane * t + slot) * k + local(cell)) * 2 + by_slot(b.to(cell.dtype))
        inc.index_add_(0, idx.reshape(-1), by_slot(wgt.to(tab.dtype)).reshape(-1))
    inc = inc.view(n_l, t, k * 2)
    before = (torch.cumsum(inc, 1) - inc + tab.reshape(n_l, 1, k * 2)).view(n_l, t, k, 2)
    return [before[lane, slot, local(cell)].view(n_l, ws, e, 2).permute(2, 0, 1, 3)
            for cell in reads]


def _pair_prob(c):
    return torch.clamp(torch.div(rans_bin.PROB_MAX * c[..., 1], c[..., 0] + c[..., 1],
                                 rounding_mode="floor"), 1, rans_bin.PROB_MAX - 1)


def _sym_unary_probs(utab, unary, qw, ucells):
    """Per-symbol unary probabilities inside a segment: each slot's counts
    are the segment-start table plus the earlier in-segment events of its
    cell, exactly the counts a per-bin update would reach."""
    _, _, b, act = unary
    wu = (coder3.QW_MAX - qw)[None] * act
    wv = qw[None] * act
    cu, cv = _prefix_counts(utab, [(ucells[0], b, wu), (ucells[1], b, wv)], ucells)
    return coder3.mix_prob(_pair_prob(cu), _pair_prob(cv), qw[None])


def _sym_refine_probs(rtab, refine, rcells):
    """Per-symbol refine-bit probabilities: the prefix-count twin of
    :func:`_sym_unary_probs` over the (row, bit position, msb) cells."""
    bit, act, _ = refine
    (c,) = _prefix_counts(rtab, [(rcells, bit, act)], [rcells])
    return _pair_prob(c)


def _seg_slots_update(utab, rtab, z, qu, qv, qw, lane, tune: Tune):
    """Per-slot (prob, bin, mask) of one column segment from the current
    counter tables, then the tables after the segment's events.

    z/qu/qv/qw: (L, ws) planes; ``lane``: (L, 1) lane indexes.  With
    ``tune.sym_cnt`` the probabilities are per symbol; the tables still
    update (and halve) at the segment's end.  Returns ((probs, bins,
    masks), each (n_unary + L_R, L, ws), (utab, rtab)).
    """
    n_class = utab.shape[2]
    unary, refine, row_end, k_end, escaped = _code_events(z, qu, qv, K_STEP, tune.n_unary)
    ucells = coder3.unary_cells(lane, unary, K_STEP, tune.n_unary, n_class)
    rcells = coder3.refine_cells(lane, row_end, k_end, refine[2])
    if tune.sym_cnt:
        u_probs = _sym_unary_probs(utab, unary, qw, ucells)
        r_probs = _sym_refine_probs(rtab, refine, rcells)
    else:
        uprob = coder3.prob_table(utab).reshape(-1)
        u_probs = coder3.mix_prob(uprob[ucells[0]], uprob[ucells[1]], qw[None])
        r_probs = coder3.prob_table(rtab).reshape(-1)[rcells]
    bit, ract, _ = refine
    n_pad = L_R - zcodec3.N_REFINE
    pad = z.new_zeros((n_pad,) + z.shape)
    esc_bits = (z[None] >> (zcodec3.ESCAPE_BITS - 1 - torch.arange(
        L_R, device=z.device).view(-1, 1, 1))) & 1
    r_p = torch.cat([r_probs, torch.full_like(pad, rans_bin.BYPASS_P1)])
    probs = torch.cat([u_probs, torch.where(escaped, rans_bin.BYPASS_P1, r_p)])
    bins = torch.cat([unary[2].to(z.dtype),
                      torch.where(escaped, esc_bits, torch.cat([bit.to(z.dtype), pad]))])
    masks = torch.cat([unary[3], torch.cat([ract, pad.bool()]) | escaped])
    utab, rtab = coder3.row_updates(utab, rtab, qw, unary, refine, ucells, rcells,
                                    tune.cnt_halve)
    return (probs, bins, masks), (utab, rtab)


# ---------------------------------------------------------------------------
# the row scan, the fold and the container
# ---------------------------------------------------------------------------


def _bias_update(bsums, bcnts, idx, err, cap: int):
    """Fold coded pixels into the bias moments, halving both moments of a
    context past ``cap`` events.  bsums/bcnts: (B * C,) per image's
    contexts; idx: flat (image * C + adr) indexes; err: raw errors."""
    bsums = bsums.index_add(0, idx.reshape(-1), err.reshape(-1))
    bcnts = bcnts.index_add(0, idx.reshape(-1), torch.ones_like(idx).reshape(-1))
    over = bcnts > cap
    return torch.where(over, bsums >> 1, bsums), torch.where(over, bcnts >> 1, bcnts)


def _row_scan(x, px0, adr, qu, qv, qw, n_imgs: int, tune: Tune):
    """The coding scan over rows and column segments of (L, th, W) planes,
    L = n_imgs strips of each image, image-major.

    Returns (probs, bins, masks), each (th, n_unary + L_R, L, W): every
    slot's 12-bit probability, bin and live mask.  Nothing in the loop
    waits for the host.
    """
    x, px0, adr, qu, qv, qw = (v.to(torch.int64) for v in (x, px0, adr, qu, qv, qw))
    n_l, th, w = x.shape
    dev = x.device
    l_tot = tune.n_unary + L_R
    img_of_lane = torch.arange(n_imgs, device=dev).repeat_interleave(n_l // n_imgs)
    lane = torch.arange(n_l, device=dev)[:, None]
    bidx = img_of_lane[:, None, None] * Q_N_CONTEXT + adr
    n_seg = _eff_seg(tune.n_seg, w)
    ws = w // n_seg
    seg_bias = bool(tune.seg_bias) and n_seg > 1
    seg_map = bool(tune.seg_map) and n_seg > 1
    n_class = zcodec3.layer_consts(K_STEP, tune.n_unary).n_class
    utab = coder3.init_unary(n_l, n_class, tune.cnt_init, dev)
    rtab = coder3.init_refine(n_l, tune.cnt_init, dev)
    mhist = coder3.init_mapper(n_imgs, dev)
    bsums = torch.zeros(n_imgs * Q_N_CONTEXT, dtype=torch.int64, device=dev)
    bcnts = torch.zeros_like(bsums)
    probs = torch.empty((th, l_tot, n_l, w), dtype=torch.int16, device=dev)
    bins = torch.empty((th, l_tot, n_l, w), dtype=torch.int8, device=dev)
    masks = torch.empty((th, l_tot, n_l, w), dtype=torch.bool, device=dev)
    y_r = torch.empty((n_l, w), dtype=torch.int64, device=dev)
    key_r = torch.empty_like(y_r)
    for r in range(th):
        if not seg_bias:
            btab = quantize_bias(bsums, bcnts, tune.bias_shrink)
        if not seg_map:
            ranks = coder3.mapper_ranks(mhist)
        for sg in range(n_seg):
            cols = slice(sg * ws, (sg + 1) * ws)
            x_s, px0_s, bidx_s = x[:, r, cols], px0[:, r, cols], bidx[:, r, cols]
            if seg_bias:
                btab = quantize_bias(bsums, bcnts, tune.bias_shrink)
            bval = btab[bidx_s]
            sign = (bval >> 3) & 1  # the half bit of the 1/16 px bias
            pxc = torch.clamp(px0_s + (bval >> 4) + sign, 0, MAX_VAL)
            y = residual_fold(x_s, pxc, sign, 0)
            key = pxc * 2 + sign
            if seg_map:
                ranks = coder3.mapper_ranks(mhist)
            z = torch.where(y < coder3.N_MAP,
                            coder3.mapper_lookup(ranks, img_of_lane, key, y), y)
            (p, b, m), (utab, rtab) = _seg_slots_update(
                utab, rtab, z, qu[:, r, cols], qv[:, r, cols], qw[:, r, cols], lane, tune)
            probs[r, :, :, cols] = p
            bins[r, :, :, cols] = b
            masks[r, :, :, cols] = m
            if seg_map:
                mhist = coder3.mapper_updates(mhist, img_of_lane, key, y, tune.map_bump,
                                              tune.map_halve)
            else:
                y_r[:, cols], key_r[:, cols] = y, key
            if seg_bias:
                bsums, bcnts = _bias_update(bsums, bcnts, bidx_s, x_s - px0_s,
                                            tune.bias_cap)
        if not seg_map:
            mhist = coder3.mapper_updates(mhist, img_of_lane, key_r, y_r, tune.map_bump,
                                          tune.map_halve)
        if not seg_bias:
            bsums, bcnts = _bias_update(bsums, bcnts, bidx[:, r], x[:, r] - px0[:, r],
                                        tune.bias_cap)
    return probs, bins, masks


def _fold_layout(a):
    """(th, slots, L, W) -> (L * N_PHASE, n): each lane's slots in decode
    order (row, column, slot), dealt to its 16 phase states round robin."""
    n_l = a.shape[2]
    a = a.permute(2, 0, 3, 1).reshape(n_l, -1)
    return a.reshape(n_l, -1, N_PHASE).transpose(1, 2).reshape(n_l * N_PHASE, -1)


def _code_impl(x, px0, adr, qu, qv, qw, n_imgs: int, tune: Tune = TUNE):
    """Row scan + fold + pack of modeled planes.  Returns (lengths
    (n_imgs, S * N_PHASE) int64, flat u16 words of every state back to back
    as int32), both on the planes' device."""
    probs, bins, masks = _row_scan(x, px0, adr, qu, qv, qw, n_imgs, tune)
    words, emits, state = rans_bin.fold(_fold_layout(probs), _fold_layout(bins),
                                        _fold_layout(masks))
    flat, lengths = rans.pack_streams(words, emits, state)
    return lengths.view(n_imgs, -1), flat


def _to_strips(img: np.ndarray, th: int) -> np.ndarray:
    h, w = img.shape
    s = -(-h // th)
    padded = np.pad(img, ((0, s * th - h), (0, 0)), mode="edge")
    return padded.reshape(s, th, w)


def _container(lengths, words, h0, w0, s, th, transposed, tune: Tune) -> bytes:
    tune.validate()
    n_states = s * N_PHASE
    hdr = NbtcHeader(
        profile=PROFILE, near=0, height=h0, width=w0, tile_h=th,
        # bit 0: transposed; bit 1: legacy tune-version bit; bits 2 and 3:
        # an extended Tune block follows; bits 4+: AVP feature count
        tile_w=int(transposed) | (2 * (tune != TUNE_V1)) | 4 | 8 | (AVP_N << 4),
        n_tiles=s, bias_len=0, hist_len=4 * n_states,
    )
    return (hdr.to_bytes() + tune.to_bytes()
            + np.asarray(lengths).astype("<u4").tobytes()
            + np.asarray(words).astype("<u2").tobytes())


def _check_near(near: int) -> None:
    if not 0 <= near <= 255:
        raise ValueError(f"near must be in [0, 255], got {near}")
    if near:
        raise NotImplementedError(
            "profile-3 near-lossless (effort >= 3, near > 0) is not ported yet: "
            "ROADMAP Queue 1 item 11")


def _prepare(imgs, th: int):
    """Portrait-normalized strips of same-shape images: (strips (B, S, th, W)
    uint8, original dims, transposed flags, th after the clamp)."""
    imgs = [np.ascontiguousarray(im, dtype=np.uint8) for im in imgs]
    dims = [im.shape for im in imgs]
    tflags = [h < w for h, w in dims]
    imgs = [np.ascontiguousarray(im.T) if t else im for im, t in zip(imgs, tflags)]
    h, w = imgs[0].shape
    if any(im.shape != (h, w) for im in imgs):
        raise ValueError("encode_batch requires same-shape images (after "
                         "orientation normalization)")
    check_size(h, w)
    th = min(th, -(-h // N_PHASE) * N_PHASE)
    return np.stack([_to_strips(im, th) for im in imgs]), dims, tflags, th


def _finalize(lengths, flat, dims, tflags, s: int, th: int, tune: Tune) -> list[bytes]:
    """Fetch each image's streams and emit its container."""
    lens = lengths.cpu().numpy()
    ends = np.cumsum(lens.sum(axis=1))
    words = flat[: int(ends[-1])].cpu().numpy()
    return [_container(lens[b], words[ends[b] - lens[b].sum() : ends[b]], dims[b][0],
                       dims[b][1], s, th, tflags[b], tune)
            for b in range(len(dims))]


def encode(img: np.ndarray, th: int = TH_DEFAULT, near: int = 0, device="cuda") -> bytes:
    """Profile-3 lossless encode of one gray-8 image."""
    return encode_batch([img], th=th, near=near, device=device)[0]


def encode_batch(imgs, th: int = TH_DEFAULT, near: int = 0, device="cuda") -> list[bytes]:
    """Encode images whose shapes agree after portrait normalization: all
    their strips run as lanes of one modeling pass, one row scan and one
    fold.  Each image gets the container it would get alone."""
    _check_near(near)
    dev = resolve_device(device)
    if not imgs:
        return []
    tune = TUNE.validate()
    strips, dims, tflags, th = _prepare(imgs, th)
    b, s, _, w = strips.shape
    seg_w = w // _eff_seg(tune.n_seg, w) if tune.seg_stats else 0
    planes = _model_planes(torch.from_numpy(strips).to(dev).reshape(b * s, th, w), AVP_N,
                           seg_w, bool(tune.mix_e), bool(tune.w_pred))
    lengths, flat = _code_impl(*planes, b, tune)
    return _finalize(lengths, flat, dims, tflags, s, th, tune)


def encode_batches(image_groups, th: int = TH_DEFAULT, near: int = 0,
                   device="cuda") -> list[list[bytes]]:
    """Encode several batches, one :func:`encode_batch` each."""
    return [encode_batch(g, th=th, near=near, device=device) for g in image_groups]
