"""NBTC profile 3: the adaptive-coding strip engine.

Counterpart of ``nblic_tpu/models/strips.py``: the encoder writes the same
containers byte for byte, lossless or near-lossless, and the decoder reads
every profile-3 container that package writes or reads to the same pixels.
Images are normalized to portrait (the long axis scans as rows; the header
flags a transpose) and cut into full-width strips of ``th`` rows.  Every
strip of every same-shape image of a call is one lane, and all lanes run in
lockstep:

- Modeling (:func:`_model_planes`): the parallel AVP prediction
  (``ops/pavp.py``), then the activity quantizers and the context address,
  all whole-plane tensor math.
- Row scan (:func:`_row_scan`): for each row and each of its column
  segments, the row-adaptive context bias corrects the prediction, the
  AutoMapper ranks the folded residual, and the layered Zcodec walk
  (``ops/zcodec3.py``) turns it into binary decisions whose probabilities
  come from the counter tables (``ops/coder3.py``); the tables, the mapper
  history and the bias moments then take the segment's events.  Counters
  are per lane; the mapper and the bias are per image.  On the card kernel
  K8 (``csrc/p3_row_scan.cu``), one launch; on the CPU its plain version.
- Fold (``ops/rans_bin.py``): binary rANS over 16 phase states a strip,
  slots assigned to phases statically (on the card kernel K3,
  ``csrc/bin_fold.cu``), then ``rans.pack_streams``.

Near-lossless encode (``near`` > 0) cannot model whole planes: each pixel
is predicted from the reconstruction of the pixels before it.
:func:`_near_walk` steps through the pixels of every lane in lockstep,
folding each residual with step 2 near + 1 and feeding the reconstruction
back (on the card kernel K5, ``csrc/p3_near_walk.cu``, a launch a row; on
the CPU its plain version); :func:`_near_code` then runs the coding model
a row at a time (:func:`_row_code`: bias and mapper row-frozen, counters
a segment, with k_step = min(3 + 2 near, 16); on the card K8's near mode),
and the fold is the lossless one.

Decode (:func:`_decode_walk`) is one lockstep step a pixel over every strip
lane of every image of a call: the AVP prediction from the reconstructed
window, the bias correction, up to n_unary + 8 binary decisions read from
the 16 phase states, the AutoMapper and the unfold, then the same segment
and row updates of the adaptive state as the encoder's (on the card kernel
K4, ``csrc/p3_decode_walk.cu``, a launch a row or a column segment; on the
CPU its plain version).

Container (``NBTC0001``, profile 3): header | 32-byte Tune block | u32
word count per state | the states' u16 streams.  ``tile_h`` is the strip
height; ``tile_w`` bit 0 the transpose, bit 1 the legacy tune-version bit,
bits 2 and 3 the extended Tune block, bits 4+ the AVP feature count;
``n_tiles`` the strip count; ``bias_len`` 0 (the bias is replayed, not
sent; a legacy container carries a zlib'd static table there and still
decodes); ``near`` the max error.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import MAX_VAL, Q_N_CONTEXT
from ..convert import resolve_device
from ..ops import (
    coder3, decode_walk, near_walk, pavp, rans, rans_bin, row_scan, table_replay, zcodec3,
)
from ..ops.avp import BETA, FB1, FIT_BASE
from ..ops.context import BIAS_FRAC_BITS, quantize_bias, residual_fold, residual_unfold
from ..ops.neighbors import Neighbors, sample
from ..ops.predict import (
    activity, context_address, n_quantize_activity, quantize_activity, shift_err,
    simple_predict,
)
from ..ops.table_replay import bias_update as _bias_update
from ..ops.window import row_start_window, slide_window
from ..utils.container import NbtcHeader, check_size, inflate

# default strip height: a whole 768-row Kodak-shaped image is one strip;
# read when an encode is called, as TUNE is
TH_DEFAULT = 768
AVP_N = 10          # AVP feature count; containers record it
K_STEP = 3          # lossless k_step
N_TAPS = 12         # AVP taps a container may name (bits 4+ of tile_w)
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


def _k_step(near: int) -> int:
    """k_step from near, the reference's rule: min(3 + 2 near, 16)."""
    return min(K_STEP + 2 * near, zcodec3.N_ROW)


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


def _seg_slots_update(utab, rtab, z, qu, qv, qw, lane, k_step: int, tune: Tune):
    """Per-slot (prob, bin, mask) of one column segment from the current
    counter tables, then the tables after the segment's events.

    z/qu/qv/qw: (L, ws) planes; ``lane``: (L, 1) lane indexes; ``k_step``
    the escalation step (:func:`_k_step`).  With ``tune.sym_cnt`` the
    probabilities are per symbol; the tables still update (and halve) at
    the segment's end.  Returns ((probs, bins, masks), each (n_unary + L_R,
    L, ws), (utab, rtab)).
    """
    n_class = utab.shape[2]
    unary, refine, row_end, k_end, escaped = _code_events(z, qu, qv, k_step, tune.n_unary)
    ucells = coder3.unary_cells(lane, unary, k_step, tune.n_unary, n_class)
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


def _row_code(utab, rtab, mhist, img_of_lane, lane, y, qu, qv, qw, key, k_step: int,
              tune: Tune):
    """One row of the coding model with a row-frozen mapper, as the near
    encoder codes it: the mapper ranks at the row start, then each column
    segment's slots through :func:`_seg_slots_update` with the counters
    updated a segment, then the mapper history once.

    y/qu/qv/qw/key: (L, W) int64 planes of the row.  Returns ((probs, bins,
    masks), each (n_unary + L_R, L, W), (utab, rtab, mhist)).
    """
    ranks = coder3.mapper_ranks(mhist)
    z = torch.where(y < coder3.N_MAP, coder3.mapper_lookup(ranks, img_of_lane, key, y), y)
    w = y.shape[1]
    ws = w // _eff_seg(tune.n_seg, w)
    segs = []
    for c0 in range(0, w, ws):
        cols = slice(c0, c0 + ws)
        slots, (utab, rtab) = _seg_slots_update(utab, rtab, z[:, cols], qu[:, cols],
                                                qv[:, cols], qw[:, cols], lane, k_step, tune)
        segs.append(slots)
    mhist = coder3.mapper_updates(mhist, img_of_lane, key, y, tune.map_bump, tune.map_halve)
    return tuple(torch.cat(v, -1) for v in zip(*segs)), (utab, rtab, mhist)


# ---------------------------------------------------------------------------
# the row scan, the fold and the container
# ---------------------------------------------------------------------------


def _row_scan(x, px0, adr, qu, qv, qw, n_imgs: int, tune: Tune):
    """The coding scan over rows and column segments of (L, th, W) planes,
    L = n_imgs strips of each image, image-major.

    Returns (probs, bins, masks), each (th, n_unary + L_R, L, W): every
    slot's 12-bit probability, bin and live mask.  A CPU tensor runs the
    plain scan (:func:`_row_scan_plain`); a CUDA tensor launches kernel K8
    (``ops/row_scan.py::scan``) or raises; any other device raises.
    """
    if x.device.type == "cpu":
        return _row_scan_plain(x, px0, adr, qu, qv, qw, n_imgs, tune)
    if x.device.type == "cuda":
        return row_scan.scan((qu, qv, qw, x, px0, adr), n_imgs, tune, K_STEP,
                             _eff_seg(tune.n_seg, x.shape[-1]), near=False)
    raise ValueError(f"the row scan runs on cpu or cuda, not {x.device}")


def _row_scan_plain(x, px0, adr, qu, qv, qw, n_imgs: int, tune: Tune):
    """The row scan in plain PyTorch, a row and a column segment at a time:
    the plain version of K8.  Nothing in the loop waits for the host.
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
                utab, rtab, z, qu[:, r, cols], qv[:, r, cols], qw[:, r, cols], lane, K_STEP,
                tune)
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


def _fold_pack(probs, bins, masks, n_imgs: int):
    """Fold + pack of the slot planes (th, slots, L, W).  Returns (lengths
    (n_imgs, S * N_PHASE) int64, flat u16 words of every state back to back
    as int32), both on the planes' device."""
    words, emits, state = rans_bin.fold(_fold_layout(probs), _fold_layout(bins),
                                        _fold_layout(masks))
    flat, lengths = rans.pack_streams(words, emits, state)
    return lengths.view(n_imgs, -1), flat


def _to_strips(img: np.ndarray, th: int) -> np.ndarray:
    h, w = img.shape
    s = -(-h // th)
    padded = np.pad(img, ((0, s * th - h), (0, 0)), mode="edge")
    return padded.reshape(s, th, w)


def _container(lengths, words, h0, w0, s, th, transposed, near: int, tune: Tune) -> bytes:
    tune.validate()
    n_states = s * N_PHASE
    hdr = NbtcHeader(
        profile=PROFILE, near=near, height=h0, width=w0, tile_h=th,
        # bit 0: transposed; bit 1: legacy tune-version bit; bits 2 and 3:
        # an extended Tune block follows; bits 4+: AVP feature count
        tile_w=int(transposed) | (2 * (tune != TUNE_V1)) | 4 | 8 | (AVP_N << 4),
        n_tiles=s, bias_len=0, hist_len=4 * n_states,
    )
    return (hdr.to_bytes() + tune.to_bytes()
            + np.asarray(lengths).astype("<u4").tobytes()
            + np.asarray(words).astype("<u2").tobytes())


def _check_near(near: int) -> None:
    if not 0 <= near <= 255:  # the header keeps near in one byte
        raise ValueError(f"near must be in [0, 255], got {near}")


def _near_tune(tune: Tune) -> Tune:
    """The contract a near-lossless container records: ``tune`` with the
    bias and mapper row-frozen and the AVP statistics live (the feedback
    walk reads the tables a whole row and solves every pixel)."""
    return tune._replace(seg_bias=0, seg_map=0, seg_stats=0, sym_bias=0, w_pred=0)


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


def _finalize(lengths, flat, dims, tflags, s: int, th: int, near: int,
              tune: Tune) -> list[bytes]:
    """Fetch each image's streams and emit its container."""
    lens = lengths.cpu().numpy()
    ends = np.cumsum(lens.sum(axis=1))
    words = flat[: int(ends[-1])].cpu().numpy()
    return [_container(lens[b], words[ends[b] - lens[b].sum() : ends[b]], dims[b][0],
                       dims[b][1], s, th, tflags[b], near, tune)
            for b in range(len(dims))]


def encode(img: np.ndarray, th: int | None = None, near: int = 0, device="cuda") -> bytes:
    """Profile-3 encode of one gray-8 image: lossless, or near-lossless
    with max error ``near`` through the feedback walk."""
    return encode_batch([img], th=th, near=near, device=device)[0]


def encode_batch(imgs, th: int | None = None, near: int = 0, device="cuda") -> list[bytes]:
    """Encode images whose shapes agree after portrait normalization: all
    their strips run as lanes of one modeling pass (at ``near`` > 0, one
    feedback walk), one coding pass and one fold.  Each image gets the
    container it would get alone.  ``th`` is the strip height,
    :data:`TH_DEFAULT` if None."""
    _check_near(near)
    dev = resolve_device(device)
    if not imgs:
        return []
    tune = (_near_tune(TUNE) if near else TUNE).validate()
    strips, dims, tflags, th = _prepare(imgs, TH_DEFAULT if th is None else th)
    b, s, _, w = strips.shape
    x = torch.from_numpy(strips).to(dev).reshape(b * s, th, w)
    if near:
        planes = _near_walk(x, b, near, AVP_N, tune)
        slots = _near_code(*planes, b, _k_step(near), tune)
    else:
        seg_w = w // _eff_seg(tune.n_seg, w) if tune.seg_stats else 0
        planes = _model_planes(x, AVP_N, seg_w, bool(tune.mix_e), bool(tune.w_pred))
        slots = _row_scan(*planes, b, tune)
    lengths, flat = _fold_pack(*slots, b)
    return _finalize(lengths, flat, dims, tflags, s, th, near, tune)


def encode_batches(image_groups, th: int | None = None, near: int = 0,
                   device="cuda") -> list[list[bytes]]:
    """Encode several batches, one :func:`encode_batch` each."""
    return [encode_batch(g, th=th, near=near, device=device) for g in image_groups]


# ---------------------------------------------------------------------------
# the per-pixel model (the decoder's, and the near encoder's)
# ---------------------------------------------------------------------------


def _pixel_taps(regs, prev1, i: int, j: int, w: int, n: int):
    """Neighbor taps, the simple prediction and the n AVP features (taps
    minus FIT_BASE, int64 (n, L)) of pixel (i, j) from the causal window.
    The t tap (feature 7) is (i - 1, j + 2) of the reconstructed row
    above, d out of range."""
    nb = Neighbors(*regs)
    px_s = simple_predict(nb)
    t_tap = prev1[:, j + 2] if i >= 1 and j + 2 < w else nb.d
    taps = (nb.a, nb.b, nb.c, nb.d, nb.e, nb.f, t_tap, nb.h, nb.q, nb.g, nb.r, nb.s)
    return nb, px_s, torch.stack([v.to(torch.int64) for v in taps[:n]]) - FIT_BASE


def _round_px(px_f, ok, px_s):
    """An FB1 fixed-point prediction rounded to a pixel; px_s where the
    solve failed."""
    return torch.where(ok, (px_f + (1 << (FB1 - 1))) >> FB1, px_s)


def _pixel_px0_from_solve(diag, num, ok, feats, px_s):
    """Prediction of a pixel from its solved ridge system."""
    return _round_px(pavp.predict_from_solve(diag, num, feats), ok, px_s)


def _pixel_ctx(nb, err, px0):
    """Activity quantizers and the context address of one pixel column."""
    delta = activity(nb, err)
    qu, qv, qw = n_quantize_activity(delta)
    return qu, qv, qw, context_address(nb, px0, quantize_activity(delta))


def _pixel_features(regs, prev1, err, f_row_j, e_acc, i: int, j: int, w: int, n: int):
    """Prediction and contexts of pixel (i, j): AVP over the running
    moment chains (stats = E + F) with the simple-prediction fallback."""
    nb, px_s, feats = _pixel_taps(regs, prev1, i, j, w, n)
    stats = e_acc + f_row_j
    px0 = _round_px(*pavp.predict_from_stats(stats, feats, n), px_s)
    qu, qv, qw, adr = _pixel_ctx(nb, err, px0)
    return nb, px_s, feats, stats, px0, qu, qv, qw, adr


def _pixel_predict(regs, prev1, err, f_row_j, f_mix_j, e_acc, e_mix, i: int, j: int, w: int,
                   n: int):
    """Prediction and contexts of pixel (i, j) over live moment chains:
    plain AVP (:func:`_pixel_features`) without mix chains (``f_mix_j``
    None), else the hard-fallback AVP blended with the simple prediction by
    their squared decayed |error| energies.  Returns (px_s, feats, stats,
    px0, px_hard, qu, qv, qw, adr); px_hard None without mixing."""
    if f_mix_j is None:
        _, px_s, feats, stats, px0, qu, qv, qw, adr = _pixel_features(
            regs, prev1, err, f_row_j, e_acc, i, j, w, n)
        return px_s, feats, stats, px0, None, qu, qv, qw, adr
    nb, px_s, feats = _pixel_taps(regs, prev1, i, j, w, n)
    stats = e_acc + f_row_j
    px_f, ok = pavp.predict_from_stats(stats, feats, n)
    px_hard = _round_px(px_f, ok, px_s)
    em = e_mix + f_mix_j
    px0 = pavp.mix_blend(px_hard, px_s, em[0], em[1], ok)
    qu, qv, qw, adr = _pixel_ctx(nb, err, px0)
    return px_s, feats, stats, px0, px_hard, qu, qv, qw, adr


def _pixel_correct(px0, bias):
    """Bias-corrected prediction, the bias's half bit as the preferred
    sign, and the mapper key: (sign, pxc, key)."""
    sign = (bias >> (BIAS_FRAC_BITS - 1)) & 1
    pxc = torch.clamp(px0 + (bias >> BIAS_FRAC_BITS) + sign, 0, MAX_VAL)
    return sign, pxc, pxc * 2 + sign


def _pixel_update(x, px_s, feats, stats, e_acc, b_row, j: int, ab, n: int):
    """Fold the reconstructed pixel x into the moment chains: column j of
    B (``b_row`` (W, m, L), written in place) and E.  The sample weight
    comes from the simple predictor's error.  Returns E after column j."""
    s_curr = torch.abs(x - px_s).to(torch.int64) << FB1
    s_sum = stats[0] + torch.div(s_curr * BETA, BETA - 1, rounding_mode="trunc")
    b_col = pavp.decay(b_row[j], ab) + pavp.contributions(
        x.to(torch.int64), feats, s_curr, s_sum, n)
    b_row[j] = b_col
    return pavp.decay(e_acc, ab) + b_col


def _mix_update(x, px_hard, px_s, e_mix, b_mix, j: int, ab_m):
    """Fold both predictors' |error| at x into the two mix chains: column j
    of ``b_mix`` (W, 2, L), written in place, and E.  Returns E."""
    x = x.to(torch.int64)
    col = pavp.decay(b_mix[j], ab_m) + torch.stack(
        [torch.abs(x - px_hard) << FB1, torch.abs(x - px_s) << FB1])
    b_mix[j] = col
    return pavp.decay(e_mix, ab_m) + col


# ---------------------------------------------------------------------------
# near-lossless encode: the feedback walk, then the row coder
# ---------------------------------------------------------------------------


def _near_walk(x, n_imgs: int, near: int, n_feat: int, tune: Tune):
    """Reconstruction-feedback walk of (L, th, W) strips, L = n_imgs strips
    of each image, image-major; ``near`` in 1..255.  Returns the int64 (L,
    th, W) planes (y, qu, qv, qw, key) on x's device.

    A CPU tensor runs the plain walk (:func:`_near_walk_plain`); a CUDA
    tensor runs kernel K5 a row at a time (:func:`_near_walk_card`), which
    raises where it cannot run; any other device raises.
    """
    if not 1 <= near <= MAX_VAL:  # the header keeps near in one byte
        raise ValueError(f"the feedback walk serves near in 1..{MAX_VAL}, got {near}")
    if x.device.type == "cpu":
        return _near_walk_plain(x, n_imgs, near, n_feat, tune)
    if x.device.type == "cuda":
        return _near_walk_card(x, n_imgs, near, n_feat, tune)
    raise ValueError(f"the feedback walk runs on cpu or cuda, not {x.device}")


def _near_walk_plain(x, n_imgs: int, near: int, n_feat: int, tune: Tune):
    """The feedback walk in plain PyTorch, one lockstep step a pixel over
    every lane: the plain version of K5.

    Each pixel is predicted from the reconstructed window and chains as the
    decoder will (:func:`_pixel_predict`), corrected by the row-frozen bias,
    folded with step 2 near + 1 and unfolded to its reconstruction xr; the
    chains, the window, the next pixel's error and each row's bias moments
    take xr, never x.  The coding model reads none of the walk's state, so
    it runs after it (:func:`_near_code`).  Returns the int64 (L, th, W)
    planes (y, qu, qv, qw, key) on x's device.  The pixel loop never waits
    for the host: (i, j) are Python ints, every constant is made once.
    """
    dev = x.device
    lanes, th, w = x.shape
    n = n_feat
    m = pavp.get_m(n)
    mix_e = bool(tune.mix_e)
    i64 = dict(dtype=torch.int64, device=dev)
    bias_off = torch.arange(n_imgs, **i64).repeat_interleave(lanes // n_imgs) * Q_N_CONTEXT
    ab = pavp.ab_vec(m, dev)
    ab_m = pavp.ab_vec(pavp.mix_ab(), dev)
    zero = torch.zeros((lanes,), **i64)
    x_px = x.to(torch.int64).permute(1, 2, 0).contiguous()  # (th, W, L)

    prev1 = torch.zeros((lanes, w), **i64)
    prev2 = prev1
    b_row = torch.zeros((w, m, lanes), **i64)
    b_mix = torch.zeros((w, 2, lanes), **i64) if mix_e else None
    bsums = torch.zeros(n_imgs * Q_N_CONTEXT, **i64)
    bcnts = torch.zeros_like(bsums)
    planes = torch.empty((5, lanes, th, w), **i64)
    for i in range(th):
        btab = quantize_bias(bsums, bcnts, tune.bias_shrink)
        f_row = pavp.f_chain(b_row, ab=ab)
        f_mix = pavp.f_chain(b_mix, ab=ab_m) if mix_e else None
        regs = row_start_window(i, prev1, prev2, w)
        err = zero
        e_acc = torch.zeros((m, lanes), **i64)
        e_mix = torch.zeros((2, lanes), **i64) if mix_e else None
        cols = []
        for j in range(w):
            px_s, feats, stats, px0, px_hard, qu, qv, qw, adr = _pixel_predict(
                regs, prev1, err, f_row[j], f_mix[j] if mix_e else None, e_acc, e_mix,
                i, j, w, n)
            sign, pxc, key = _pixel_correct(px0, btab[bias_off + adr])
            y = residual_fold(x_px[i, j], pxc, sign, near)
            xr = residual_unfold(y, pxc, sign, near)
            err = torch.clamp(xr - px0, -MAX_PX_INC, MAX_PX_INC)
            e_acc = _pixel_update(xr, px_s, feats, stats, e_acc, b_row, j, ab, n)
            if mix_e:
                e_mix = _mix_update(xr, px_hard, px_s, e_mix, b_mix, j, ab_m)
            regs = slide_window(regs, xr, i, j, prev1, prev2, w)
            cols.append((xr, px0, adr, y, qu, qv, qw, key))
        xr_r, px0_r, adr_r, *coded = (torch.stack(v, 1).to(torch.int64) for v in zip(*cols))
        planes[:, :, i] = torch.stack(coded)
        bsums, bcnts = _bias_update(bsums, bcnts, bias_off[:, None] + adr_r, xr_r - px0_r,
                                    tune.bias_cap)
        prev1, prev2 = xr_r, prev1
    return planes.unbind(0)


def _near_walk_card(x, n_imgs: int, near: int, n_feat: int, tune: Tune):
    """The feedback walk on the card: per row, kernel K5 over every lane
    (``ops/near_walk.py``), then kernel K9 (``ops/table_replay.py``) folds
    the row into the images' bias moments and rewrites their int16 table,
    which K5 reads for the next row.  The state stays on the card in the
    kernels' layout (B and F (L, W, m), a lane's channels contiguous; the
    rows lanes fastest; the tables a ``table_replay.Tables``); the planes
    are laid out for :func:`_near_code` once, at the end.  Returns what
    :func:`_near_walk_plain` returns."""
    dev = x.device
    lanes, th, w = x.shape
    m = pavp.get_m(n_feat)
    i64 = dict(dtype=torch.int64, device=dev)
    xs = x.permute(1, 2, 0).to(torch.uint8).contiguous()  # (th, W, L)
    prev1 = torch.zeros((w, lanes), dtype=torch.uint8, device=dev)
    prev2 = torch.zeros_like(prev1)
    b_row = torch.zeros((lanes, w, m), **i64)
    f_row = torch.empty_like(b_row)
    b_mix = f_mix = None
    if tune.mix_e:
        b_mix = torch.zeros((lanes, w, 2), **i64)
        f_mix = torch.empty_like(b_mix)
    planes = torch.empty((near_walk.N_PLANES, th, w, lanes), dtype=torch.int32, device=dev)
    idx = torch.empty((w, lanes), **i64)
    dx = torch.empty_like(idx)
    con = table_replay.contract(tune, lanes // n_imgs, w)
    tb = table_replay.new_tables(n_imgs, con, dev)
    replay = table_replay.prepare(tb, (idx, dx, None, None), con) if x.numel() else None
    for i in range(th):
        near_walk.launch_row(xs[i], tb.btab, prev1, prev2, b_row, f_row, b_mix, f_mix, planes,
                             idx, dx, i, near, n_feat)
        if replay is not None:
            table_replay.launch(replay, bias_cols=(0, w))
        prev1, prev2 = prev2, prev1  # row i was written into prev2
    return planes.permute(0, 3, 1, 2).to(torch.int64,
                                         memory_format=torch.contiguous_format).unbind(0)


def _near_code(y, qu, qv, qw, key, n_imgs: int, k_step: int, tune: Tune):
    """The coding model over the walk's (L, th, W) planes.  Returns (probs,
    bins, masks), each (th, n_unary + L_R, L, W), for :func:`_fold_pack`.

    A CPU tensor runs the plain row coder (:func:`_near_code_plain`); a CUDA
    tensor launches kernel K8 in its near mode (``ops/row_scan.py::scan``)
    or raises; any other device raises.
    """
    if y.device.type == "cpu":
        return _near_code_plain(y, qu, qv, qw, key, n_imgs, k_step, tune)
    if y.device.type == "cuda":
        return row_scan.scan((qu, qv, qw, y, key), n_imgs, tune, k_step,
                             _eff_seg(tune.n_seg, y.shape[-1]), near=True)
    raise ValueError(f"the row coder runs on cpu or cuda, not {y.device}")


def _near_code_plain(y, qu, qv, qw, key, n_imgs: int, k_step: int, tune: Tune):
    """The row coder in plain PyTorch, one :func:`_row_code` a row: the
    plain version of K8's near mode."""
    n_l, th, w = y.shape
    dev = y.device
    l_tot = tune.n_unary + L_R
    img_of_lane = torch.arange(n_imgs, device=dev).repeat_interleave(n_l // n_imgs)
    lane = torch.arange(n_l, device=dev)[:, None]
    n_class = zcodec3.layer_consts(k_step, tune.n_unary).n_class
    utab = coder3.init_unary(n_l, n_class, tune.cnt_init, dev)
    rtab = coder3.init_refine(n_l, tune.cnt_init, dev)
    mhist = coder3.init_mapper(n_imgs, dev)
    probs = torch.empty((th, l_tot, n_l, w), dtype=torch.int16, device=dev)
    bins = torch.empty((th, l_tot, n_l, w), dtype=torch.int8, device=dev)
    masks = torch.empty((th, l_tot, n_l, w), dtype=torch.bool, device=dev)
    for r in range(th):
        (probs[r], bins[r], masks[r]), (utab, rtab, mhist) = _row_code(
            utab, rtab, mhist, img_of_lane, lane, y[:, r], qu[:, r], qv[:, r], qw[:, r],
            key[:, r], k_step, tune)
    return probs, bins, masks


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _decode_walk(words, bias_tab, th: int, w: int, s: int, n_imgs: int, n_feat: int,
                 near: int, tune: Tune):
    """Lockstep decode of every strip lane.

    words: (N_PHASE, L, wmax) int32 streams of u16 words of the L = n_imgs
    * s lanes, image-major; ``bias_tab``: None for the row-adaptive bias,
    else the legacy static tables (n_imgs * C,); ``near`` in 0..255,
    ``n_feat`` in 1..12; ``tune`` is the container's replay contract.
    Returns the (L, th, w) uint8 reconstruction on words' device.

    A CPU tensor runs the plain walk (:func:`_decode_walk_plain`); a CUDA
    tensor runs kernel K4 a row or a column segment at a time
    (:func:`_decode_walk_card`), which raises where it cannot run; any
    other device raises.
    """
    if not 0 <= near <= MAX_VAL:  # the header keeps near in one byte
        raise ValueError(f"the decode walk serves near in 0..{MAX_VAL}, got {near}")
    if not 1 <= n_feat <= N_TAPS:
        raise ValueError(f"the decode walk serves 1 to {N_TAPS} AVP features, got {n_feat}")
    if words.device.type == "cpu":
        return _decode_walk_plain(words.to(torch.int64), bias_tab, th, w, s, n_imgs, n_feat,
                                  near, tune)
    if words.device.type == "cuda":
        return _decode_walk_card(words, bias_tab, th, w, s, n_imgs, n_feat, near, tune)
    raise ValueError(f"the decode walk runs on cpu or cuda, not {words.device}")


def _decode_walk_plain(words, bias_tab, th: int, w: int, s: int, n_imgs: int, n_feat: int,
                       near: int, tune: Tune):
    """The decode walk in plain PyTorch, one lockstep step a pixel over
    every lane: the plain version of K4.

    words: (N_PHASE, L, wmax) int64 streams; the rest and the result as
    :func:`_decode_walk`'s.  The pixel loop never waits for the host: every
    index that varies is a tensor, (i, j) and the phase of each bin are
    Python ints.
    """
    dev = words.device
    lanes = n_imgs * s
    n = n_feat
    m = pavp.get_m(n)
    k_step = _k_step(near)
    l_u = tune.n_unary
    l_tot = l_u + L_R
    lc = zcodec3.layer_consts(k_step, l_u)
    n_class = lc.n_class
    adaptive = bias_tab is None
    n_seg = _eff_seg(tune.n_seg, w)
    ws = w // n_seg
    seg_bias = bool(tune.seg_bias) and n_seg > 1 and adaptive
    seg_map = bool(tune.seg_map) and n_seg > 1
    seg_stats = bool(tune.seg_stats)
    sym_cnt = bool(tune.sym_cnt)
    mix_e = bool(tune.mix_e) and not seg_stats
    w_pred = bool(tune.w_pred) and seg_stats
    i64 = dict(dtype=torch.int64, device=dev)

    # constants, made once: none is copied from the host in the loop
    img = torch.arange(n_imgs, **i64).repeat_interleave(s)
    li = torch.arange(lanes, **i64)
    lane = li[:, None]
    bias_off = img * Q_N_CONTEXT
    map_off = img * coder3.MAP_KEYS
    ab = pavp.ab_vec(m, dev)
    ab_m = pavp.ab_vec(pavp.mix_ab(), dev)
    esc = zcodec3.layer_axis(lc.esc_counts, torch.int64, dev, 1)  # (l_u, 1)
    cls = zcodec3.layer_axis(lc.cls_vals, torch.int64, dev, 1)
    i_vals = zcodec3.layer_axis(lc.i_vals, torch.int64, dev, 0)
    lane_rows = li[None] * zcodec3.N_ROW  # each lane's first counter row
    r_layers = torch.arange(L_R, **i64)[:, None]
    esc_weight = 1 << (zcodec3.ESCAPE_BITS - 1 - r_layers)
    msb_pair = torch.arange(2, **i64)
    bypass = torch.full((lanes,), rans_bin.BYPASS_P1, **i64)
    zero = torch.zeros((lanes,), **i64)
    no = torch.zeros((lanes,), dtype=torch.bool, device=dev)
    yes = ~no

    # the carry
    prev1 = torch.zeros((lanes, w), **i64)
    prev2 = prev1
    b_row = torch.zeros((w, m, lanes), **i64)
    b_mix = torch.zeros((w, 2, lanes), **i64) if mix_e else None
    utab = coder3.init_unary(lanes, n_class, tune.cnt_init, dev)
    rtab = coder3.init_refine(lanes, tune.cnt_init, dev)
    mhist = coder3.init_mapper(n_imgs, dev)
    bsums = torch.zeros(n_imgs * Q_N_CONTEXT, **i64)
    bcnts = torch.zeros_like(bsums)
    state0, ptr0 = rans_bin.dec_init(words)
    phase_words = list(words.unbind(0))
    states, ptrs = list(state0.unbind(0)), list(ptr0.unbind(0))
    out = torch.empty((lanes, th, w), dtype=torch.uint8, device=dev)

    def code_bin(c: int, p1, active):
        """Decode one bin of phase c on the lanes where ``active``."""
        b, states[c], ptrs[c] = rans_bin.dec_masked(states[c], ptrs[c], p1, active,
                                                    phase_words[c])
        return b

    for i in range(th):
        if not seg_bias:
            btab = quantize_bias(bsums, bcnts, tune.bias_shrink) if adaptive else bias_tab
        if not seg_map:
            order = coder3.mapper_order(mhist).reshape(-1)
        f_row = pavp.f_chain(b_row, ab=ab)  # (W, m, L), from the row above's B
        f_mix = pavp.f_chain(b_mix, ab=ab_m) if mix_e else None
        regs = row_start_window(i, prev1, prev2, w)
        err = zero
        e_acc = torch.zeros((m, lanes), **i64)
        e_mix = torch.zeros((2, lanes), **i64) if mix_e else None
        row_parts = []
        for j0 in range(0, w, ws):
            if not sym_cnt:
                uprob = coder3.prob_table(utab).reshape(-1)
                rprob = coder3.prob_table(rtab).reshape(-1)
            if seg_bias:
                btab = quantize_bias(bsums, bcnts, tune.bias_shrink)
            if seg_map:
                order = coder3.mapper_order(mhist).reshape(-1)
            if w_pred:
                # the statistics held at the segment's first column: one
                # solve and one weight quantization a segment
                stats0 = e_acc + f_row[j0]
                diag, num, ok_seg = pavp.solve_stats(stats0, n)
                wq_seg = pavp.quantize_weights(diag, num)
            elif seg_stats:
                # E frozen at the segment start and decay-extended (the
                # encoder's e_freeze_extend): the segment's solves batch here
                e_lag = [e_acc]
                for _ in range(ws - 1):
                    e_lag.append(pavp.decay(e_lag[-1], ab))
                stats_seg = torch.stack(e_lag) + f_row[j0 : j0 + ws]  # (ws, m, L)
                diag, num, ok_x = pavp.solve_stats(stats_seg.transpose(0, 1).reshape(m, -1), n)
                diag, num, ok_x = diag.view(n, ws, lanes), num.view(n, ws, lanes), \
                    ok_x.view(ws, lanes)
            cols = []
            for j in range(j0, j0 + ws):
                if seg_stats:
                    nb, px_s, feats = _pixel_taps(regs, prev1, i, j, w, n)
                    if w_pred:
                        px0 = torch.where(ok_seg, pavp.predict_wq(wq_seg, feats.to(torch.int32)),
                                          px_s)
                    else:
                        k = j - j0
                        px0 = _pixel_px0_from_solve(diag[:, k], num[:, k], ok_x[k], feats, px_s)
                    qu, qv, qw, adr = _pixel_ctx(nb, err, px0)
                else:
                    px_s, feats, stats, px0, px_hard, qu, qv, qw, adr = _pixel_predict(
                        regs, prev1, err, f_row[j], f_mix[j] if mix_e else None, e_acc, e_mix,
                        i, j, w, n)
                sign, pxc, key = _pixel_correct(px0, btab[bias_off + adr])
                base = (i * w + j) * l_tot  # the pixel's first slot

                # the unary walk: layer l reads rows escalated l's way; a
                # lane walks on while it decodes ones, so the layer it
                # stopped at is its count of ones
                ru = zcodec3.escalated_row(qu[None], esc, k_step)  # (l_u, L)
                rv = zcodec3.escalated_row(zcodec3.adjust_qv(qu, qv, k_step)[None], esc,
                                           k_step)
                ucell_u = (lane_rows + ru) * n_class + cls
                ucell_v = (lane_rows + rv) * n_class + cls
                if sym_cnt:
                    w_u, w_v = coder3.QW_MAX - qw, qw
                else:
                    p1_u = coder3.mix_prob(uprob[ucell_u], uprob[ucell_v], qw)
                active = yes
                n_ones = zero
                for l in range(l_u):
                    if sym_cnt:  # live counters: every bin's update feeds the next
                        ucnt = utab.view(-1, 2)
                        p1 = coder3.mix_prob(_pair_prob(ucnt[ucell_u[l]]),
                                             _pair_prob(ucnt[ucell_v[l]]), qw)
                    else:
                        p1 = p1_u[l]
                    b = code_bin((base + l) % N_PHASE, p1, active)
                    if sym_cnt:
                        flat = utab.view(-1)
                        flat.index_add_(0, 2 * ucell_u[l] + b, w_u * active)
                        flat.index_add_(0, 2 * ucell_v[l] + b, w_v * active)
                    n_ones = n_ones + b
                    active = b
                escaped = active
                stopped = ~escaped
                stop_layer = torch.clamp(n_ones, max=l_u - 1)
                stop_row = ru.gather(0, stop_layer[None])[0]
                k_end = torch.where(stopped, torch.div(stop_row, k_step, rounding_mode="floor"),
                                    0)
                z = torch.where(stopped, (i_vals[stop_layer] >> lc.k_max) << k_end, 0)

                # refinement bits, MSB first (bit position kk, context: the
                # row, kk and whether a higher bit was 1), or an escaped
                # symbol's 8 raw bits
                kk = k_end - 1 - r_layers  # (L_R, L)
                act_r = (kk >= 0) & stopped  # none past layer N_REFINE - 1
                kk = torch.clamp(kk, 0, zcodec3.N_REFINE - 1)
                # counter pair of each layer at msb 0
                rpair = ((lane_rows + stop_row) * zcodec3.N_REFINE + kk) * 2
                if not sym_cnt:
                    p_refine = rprob[rpair[: zcodec3.N_REFINE, :, None] + msb_pair]
                # a decoded 1 adds 1 << kk, or an escaped symbol's 1 << (7 - l)
                weight = torch.where(escaped, esc_weight, 1 << kk)
                msb = no
                for l in range(L_R):
                    if l < zcodec3.N_REFINE:
                        if sym_cnt:
                            pair = rpair[l] + msb
                            p_ad = _pair_prob(rtab.view(-1, 2)[pair])
                        else:
                            p_ad = torch.where(msb, p_refine[l, :, 1], p_refine[l, :, 0])
                        p1 = torch.where(escaped, rans_bin.BYPASS_P1, p_ad)
                    else:
                        p1 = bypass
                    b = code_bin((base + l_u + l) % N_PHASE, p1, act_r[l] | escaped)
                    if sym_cnt and l < zcodec3.N_REFINE:
                        rtab.view(-1).index_add_(0, 2 * pair + b, act_r[l].to(torch.int64))
                    msb = msb | b
                    z = z + b * weight[l]

                # the AutoMapper's order, the unfold and the chains
                y_map = order[(map_off + key) * coder3.N_MAP
                              + torch.clamp(z, 0, coder3.N_MAP - 1)]
                y = torch.where(z < coder3.N_MAP, y_map, z)
                x = residual_unfold(y, pxc, sign, near)
                err = torch.clamp(x - px0, -MAX_PX_INC, MAX_PX_INC)
                if not seg_stats:
                    e_acc = _pixel_update(x, px_s, feats, stats, e_acc, b_row, j, ab, n)
                if mix_e:
                    e_mix = _mix_update(x, px_hard, px_s, e_mix, b_mix, j, ab_m)
                regs = slide_window(regs, x, i, j, prev1, prev2, w)
                cols.append((x, y, z, qu, qv, qw, key, adr, px0, px_s, feats))

            x_c, y_c, z_c, qu_c, qv_c, qw_c, key_c, adr_c, px0_c = (
                torch.stack(v, 1) for v in list(zip(*cols))[:9])  # (L, ws)
            if seg_stats:
                # the segment's moments, folded column by column at once
                x64, px_s_c = x_c.t(), torch.stack([c[9] for c in cols])  # (ws, L)
                feats_c = torch.stack([c[10] for c in cols], 1)  # (n, ws, L)
                s_curr = torch.abs(x64 - px_s_c) << FB1
                e0 = stats0[0][None] if w_pred else stats_seg[:, 0]
                s_sum = e0 + torch.div(s_curr * BETA, BETA - 1, rounding_mode="trunc")
                contrib = pavp.contributions(x64.reshape(-1), feats_c.reshape(n, -1),
                                             s_curr.reshape(-1), s_sum.reshape(-1), n)
                b_new = pavp.decay(b_row[j0 : j0 + ws], ab) \
                    + contrib.view(m, ws, lanes).transpose(0, 1)
                b_row[j0 : j0 + ws] = b_new
                for b_col in b_new:
                    e_acc = pavp.decay(e_acc, ab) + b_col
            # the segment's adaptive-state replay, as the encoder's
            if sym_cnt:  # the walk counted every bin; only the halving is left
                utab = coder3.halve_pairs(utab, tune.cnt_halve)
                rtab = coder3.halve_pairs(rtab, tune.cnt_halve)
            else:
                unary, refine, row_end, k_end, _ = _code_events(z_c, qu_c, qv_c, k_step, l_u)
                utab, rtab = coder3.row_updates(
                    utab, rtab, qw_c, unary, refine,
                    coder3.unary_cells(lane, unary, k_step, l_u, n_class),
                    coder3.refine_cells(lane, row_end, k_end, refine[2]), tune.cnt_halve)
            if seg_map:
                mhist = coder3.mapper_updates(mhist, img, key_c, y_c, tune.map_bump,
                                              tune.map_halve)
            if seg_bias:
                bsums, bcnts = _bias_update(bsums, bcnts, bias_off[:, None] + adr_c,
                                            x_c - px0_c, tune.bias_cap)
            row_parts.append((x_c, y_c, key_c, adr_c, px0_c))

        x_r, y_r, key_r, adr_r, px0_r = (torch.cat(v, 1) for v in zip(*row_parts))
        if not seg_map:
            mhist = coder3.mapper_updates(mhist, img, key_r, y_r, tune.map_bump,
                                          tune.map_halve)
        if adaptive and not seg_bias:
            bsums, bcnts = _bias_update(bsums, bcnts, bias_off[:, None] + adr_r,
                                        x_r - px0_r, tune.bias_cap)
        out[:, i] = x_r
        prev1, prev2 = x_r, prev1
    return out


def _decode_walk_card(words, bias_tab, th: int, w: int, s: int, n_imgs: int, n_feat: int,
                      near: int, tune: Tune):
    """The decode walk on the card: kernel K4 (``ops/decode_walk.py``) a
    column segment at a time where the contract replays the bias or the
    mapper a segment (seg_bias, seg_map), else a row at a time, each launch
    followed by kernel K9 (``ops/table_replay.py``), which folds the
    pixels K4 wrote into what an image's lanes share (the bias moments and
    their int16 table, the mapper history and its order), as
    :func:`_decode_walk_plain` updates them: the mapper's a segment under
    seg_map, else at the row's end over its W columns; the bias's likewise
    under seg_bias, and never with a static table.  Nothing runs between
    the launches but the forming of their arguments, and nothing is read
    back; K4's arguments are checked once a walk.  The lanes' own state
    stays on the card in K4's layout (``decode_walk.State``).
    Returns what :func:`_decode_walk_plain` returns."""
    dev = words.device
    lanes = n_imgs * s
    adaptive = bias_tab is None
    n_seg = _eff_seg(tune.n_seg, w)
    ws = w // n_seg
    seg_bias = bool(tune.seg_bias) and n_seg > 1 and adaptive
    seg_map = bool(tune.seg_map) and n_seg > 1
    span = ws if seg_bias or seg_map else w  # columns a launch
    con = decode_walk.contract(near, n_feat, tune, ws, s)
    st = decode_walk.new_state(words, th, w, con, tune.cnt_init)
    tcon = table_replay.contract(tune, s, w)
    tb = table_replay.new_tables(n_imgs, tcon, dev, bias_tab)
    prev1 = torch.zeros((w, lanes), dtype=torch.uint8, device=dev)
    prev2 = torch.zeros_like(prev1)
    if not (th and w):
        return st.out.permute(2, 0, 1).contiguous()
    decode_walk._check(st, tb.btab, tb.order, prev1, prev2, 0, 0, span, con)
    replay = table_replay.prepare(tb, tuple(st.replay.unbind(0)), tcon)  # (W, L) each
    for i in range(th):
        for c0 in range(0, w, span):
            c1 = c0 + span
            decode_walk.launch_segment(st, tb.btab, tb.order, prev1, prev2, i, c0, c1, con,
                                       checked=True)
            row_end = c1 == w
            map_cols = (c0, c1) if seg_map else ((0, w) if row_end else None)
            bias_cols = None
            if adaptive:
                bias_cols = (c0, c1) if seg_bias else ((0, w) if row_end else None)
            table_replay.launch(replay, map_cols, bias_cols)
        prev1, prev2 = prev2, prev1  # row i was written into prev2
    return st.out.permute(2, 0, 1).contiguous()


def _parse(stream: bytes):
    """Header, replay contract and streams of a profile-3 container, every
    field checked before anything is sized from it.  Returns (geometry
    (height, width, strips, th, transposed, n_feat, near, tune), the
    static bias table or None, the per-state word counts, the u16
    payload)."""
    hdr = NbtcHeader.from_bytes(stream)
    if hdr.profile != PROFILE:
        raise ValueError(f"not a profile-3 container: profile {hdr.profile}")
    check_size(hdr.height, hdr.width)
    pos = NbtcHeader.SIZE
    if hdr.tile_w & 4:  # a serialized replay contract
        ext = bool(hdr.tile_w & 8)  # the 32-byte extended block
        size = Tune.SIZE2 if ext else Tune.SIZE
        tune = Tune.from_bytes(stream[pos : pos + size], ext).validate()
        pos += size
    else:  # legacy: the version bit names a fixed contract
        tune = TUNE_V2 if hdr.tile_w & 2 else TUNE_V1
    # the strips must cover the portrait height once; a strip taller than
    # that height (no encoder cuts one past it rounded up to 16 rows, but
    # nblic_tpu reads it) is one strip, walked only as far as the height
    hh = hdr.width if hdr.tile_w & 1 else hdr.height
    if hdr.tile_h < 1 or hdr.n_tiles != -(-hh // hdr.tile_h):
        raise ValueError("inconsistent profile-3 strip geometry")
    n_feat = (hdr.tile_w >> 4) or 6  # containers before the count held 6
    if n_feat > N_TAPS:
        raise ValueError(f"invalid profile-3 AVP feature count {n_feat}")
    bias = None
    if hdr.bias_len:  # legacy transmitted static-bias table
        raw = inflate(stream[pos : pos + hdr.bias_len], "profile-3 bias table")
        bias = np.frombuffer(raw, dtype="<i2").astype(np.int64)
        if bias.shape != (Q_N_CONTEXT,):
            raise ValueError("malformed profile-3 bias table")
    pos += hdr.bias_len
    n_states = hdr.n_tiles * N_PHASE
    lengths = np.frombuffer(stream[pos : pos + 4 * n_states], dtype="<u4").astype(np.int64)
    if lengths.size != n_states:
        raise ValueError("truncated profile-3 length table")
    pos += 4 * n_states
    payload = np.frombuffer(stream, dtype="<u2", offset=pos, count=(len(stream) - pos) // 2)
    # every stream opens with two state words, and the table must fit the
    # payload (a corrupt length would size the stream matrix)
    if (lengths < 2).any() or int(lengths.sum()) > payload.size:
        raise ValueError("invalid profile-3 stream lengths")
    geom = (hdr.height, hdr.width, hdr.n_tiles, hdr.tile_h, bool(hdr.tile_w & 1), n_feat,
            hdr.near, tune)
    return geom, bias, lengths, payload


def _plane_geom(geom):
    """What lanes of one walk share: the encoded (portrait) plane and the
    model; each image's orientation only changes its crop."""
    h0, w0, s, th, transposed, n_feat, near, tune = geom
    return (s, th, h0 if transposed else w0, n_feat, near, tune)


def _walk_args(parsed, dev):
    """The :func:`_decode_walk` arguments of parsed containers (``_parse``)
    of one plane geometry, model and bias mode, lanes image-major, and each
    image's plane height."""
    s, th, ww, n_feat, near, tune = _plane_geom(parsed[0][0])
    n_imgs = len(parsed)
    wmax = max(2, max(int(p[2].max()) for p in parsed))
    wmax = -(-wmax // 64) * 64
    smat = np.concatenate([rans.pad_streams(p[3], p[2], wmax) for p in parsed])
    words = torch.from_numpy(smat).to(dev).view(n_imgs * s, N_PHASE, wmax)
    words = words.transpose(0, 1).contiguous()  # int32: each walk reads u16 words
    bias = None if parsed[0][1] is None else torch.from_numpy(
        np.concatenate([p[1] for p in parsed])).to(dev)
    # the rows past the plane's height come last in the walk and are cut:
    # a strip taller than the plane (s = 1) walks only the plane's rows
    heights = [g[1] if g[4] else g[0] for g, *_ in parsed]
    rows = min(th, max(heights))
    return (words, bias, rows, ww, s, n_imgs, n_feat, near, tune), heights


def decode(stream: bytes, device="cuda") -> np.ndarray:
    """Decode one profile-3 container."""
    return decode_batch([stream], device=device)[0]


def decode_batch(streams: list[bytes], device="cuda") -> list[np.ndarray]:
    """Decode profile-3 containers.  Those of one encoded plane geometry,
    model and bias mode run as the image-major lanes of one walk; any other
    mix decodes one by one."""
    dev = resolve_device(device)
    if not streams:
        return []
    parsed = [_parse(x) for x in streams]
    adaptive = parsed[0][1] is None
    if any(_plane_geom(p[0]) != _plane_geom(parsed[0][0]) or (p[1] is None) != adaptive
           for p in parsed[1:]):
        return [decode(x, device=dev) for x in streams]
    args, heights = _walk_args(parsed, dev)
    s, rows, ww = args[4], args[2], args[3]
    px = _decode_walk(*args).cpu().numpy()
    out = []
    for b, (geom, *_) in enumerate(parsed):
        transposed = geom[4]
        plane = px[b * s : (b + 1) * s].reshape(s * rows, ww)[: heights[b]]
        out.append(np.ascontiguousarray(plane.T if transposed else plane))
    return out
