"""NBTC profiles 1 and 2, lossless and near-lossless: the tile-parallel
codec on PyTorch.

Counterpart of ``nblic_tpu/models/tiled.py``; writes and reads the same
``NBTC0001`` containers, byte for byte at profile 1 and, at profile 2, given
the same per-tile (weights, flags).  Profile 2's fit is exact, but its race
sums float32 code lengths, whose order differs between the card, the CPU
and XLA: on large tiles a near-tie may pick another flag for a tile.  Such
a container still decodes exactly (within ``near``) in both packages.

- Encode is one whole-plane modeling pass (blend predictor, 12-bin
  activity, a 3072-context static bias table, residual fold, a 12 x 256
  histogram per image), then a coding tail: normalize the histograms, look
  up each pixel's (freq, cum), fold one rANS stream per tile (kernel K1 on
  CUDA) and interleave the streams of each group of 128 tiles into one.
- Effort 2 writes profile 2: each tile also fits a least-squares predictor
  over its causal taps (``ops/lsq.py``) and keeps the best of the blend,
  the learned predictor and their mean; the weights ride the container.
- Near-lossless (``near`` > 0) replaces the modeling pass by a
  reconstruction-feedback scan (:func:`_tile_encode_scan`, kernel K7 on
  CUDA): every tile of every same-shape image steps through its pixels in
  lockstep, predicting from reconstructed pixels as the decoder will.  The lossless pass gives
  the first bias table, one statistics scan refines it (and, at profile 2,
  refits the learned predictors), and a final scan yields the symbols for
  the same coding tail.  Each image still gets the container the JAX
  package writes for it alone.
- Decode runs the 128 tile lanes of each group in lockstep against one
  shared stream cursor (kernel K2 on CUDA), near-lossless containers
  included.

Effort 3 writes profile 3 through ``models/strips.py``, lossless or
near-lossless, as the JAX package routes it, and the decoders send
profile-3 containers there.  Every entry point takes ``device`` ("cuda" by
default); a CUDA device on a machine without CUDA raises.  Profile-0 decode
is not ported and raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from ..constants import Q_N_CONTEXT
from ..convert import group_args, resolve_device
from ..ops import histogram as hist_ops
from ..ops import lsq, near_scan, rans
from ..ops.context import (
    apply_static_bias, bias_moments, quantize_bias, residual_fold,
)
from ..ops.decode import N_WROWS, decode_groups
from ..ops.fold import encode_fold
from ..ops.neighbors import sample
from ..ops.predict import context_planes, model_stage1, simple_predict
from ..utils.container import NbtcHeader, check_size, inflate
from . import strips

DEFAULT_TILE = (64, 64)
N_QD = 12
N_SYM = 256
NORM_SUM = hist_ops.NORM_SUM
# interleave-group width: one shared-cursor stream per G tiles
G_LANES = 128
MAX_GROUP = 1024  # the widest group a container may declare (K2's limit)
# profile-2 predictor race: the learned choices pay for their transmitted
# weights and the context-model shift they cause (nblic_tpu's constants)
RACE_PENALTY = 700.0
RACE_INVALID = 3e38
# near > 0: bias-refinement passes of the feedback scan (nblic_tpu's constant)
NEAR_BIAS_ITERS = 1


def _check_encode_mode(near: int) -> None:
    if not 0 <= near <= 255:  # the header keeps near in one byte
        raise ValueError(f"near must lie in 0..255, got {near}")


# ---------------------------------------------------------------------------
# tiling
# ---------------------------------------------------------------------------


def _tile_grid(h, w, th, tw):
    return -(-h // th), -(-w // tw)


def to_tiles(img: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Pad (edge-replicate) and cut (..., H, W) into (..., T, th, tw)."""
    h, w = img.shape[-2:]
    gh, gw = _tile_grid(h, w, th, tw)
    if gh * th != h:
        img = img[..., torch.arange(gh * th, device=img.device).clamp(max=h - 1), :]
    if gw * tw != w:
        img = img[..., torch.arange(gw * tw, device=img.device).clamp(max=w - 1)]
    lead = img.shape[:-2]
    t = img.reshape(*lead, gh, th, gw, tw).transpose(-3, -2)
    return t.reshape(*lead, gh * gw, th, tw).contiguous()


def from_tiles(tiles: torch.Tensor, h: int, w: int, th: int, tw: int) -> torch.Tensor:
    """Inverse of :func:`to_tiles`: (..., T, th, tw) -> (..., h, w)."""
    gh, gw = _tile_grid(h, w, th, tw)
    lead = tiles.shape[:-3]
    img = tiles.reshape(*lead, gh, gw, th, tw).transpose(-3, -2)
    return img.reshape(*lead, gh * th, gw * tw)[..., :h, :w]


# ---------------------------------------------------------------------------
# encode: modeling pass and coding tail
# ---------------------------------------------------------------------------


def _model_lossless_impl(tiles: torch.Tensor):
    """tiles (B, T, th, tw) uint8 -> (y, qd, bias, hist), one parallel pass.

    y/qd: (B, T, th, tw) int32; bias: (B, 3072) int32; hist: (B, 12, 256)
    int64 symbol counts per activity bin.  Each image has its own tables.
    """
    x = tiles.to(torch.int32)
    return _bias_fold_hist(x, *model_stage1(x))


def _race_bits(x: torch.Tensor, px: torch.Tensor, near: int = 0) -> torch.Tensor:
    """Per-tile code-length proxy sum 2 log2(1 + |x - px| / (2 near + 1)),
    float32 (B, T); near-lossless codes residuals at that magnitude."""
    e = torch.abs(x - px).to(torch.float32) / (2.0 * near + 1.0)
    return torch.sum(2.0 * torch.log2(1.0 + e), dim=(-2, -1))


def _model_lossless2_impl(tiles: torch.Tensor, weights=None, near: int = 0):
    """Profile-2 modeling: per-tile least-squares predictors (ops/lsq.py)
    raced against the blend predictor, the winner kept per tile.

    tiles (B, T, th, tw) uint8 -> (y, qd, bias, hist, w_q, flags): the
    outputs of :func:`_model_lossless_impl`, then w_q (B, T, 12) int32 (0
    where the flag is 0) and flags (B, T) int32, 0 blend, 1 learned, 2 their
    rounded mean.  The race scores a Laplacian code-length proxy in float32,
    as the JAX package does, so a near-tie may pick another flag there;
    ``near`` only rescales that proxy.

    ``weights`` (private; tests and the smoke run carry state with it):
    (w_q, flags) tensors that replace the fit and the race.
    """
    x = tiles.to(torch.int32)
    b, t = x.shape[:2]
    n = sample(x)
    px_s = simple_predict(n)
    if weights is None:
        w_q, valid = lsq.fit_tile_weights(x.reshape(b * t, *x.shape[2:]))
        w_q, valid = w_q.view(b, t, lsq.N_FEAT), valid.view(b, t)
    else:
        w_q, flags = (v.to(torch.int32) for v in weights)
    px_l = lsq.predict_plane(n, w_q)
    px_a = (px_s + px_l + 1) >> 1
    if weights is None:
        cost_s = _race_bits(x, px_s, near)  # float32, and so are the sums below
        cost_l = torch.where(valid, _race_bits(x, px_l, near) + RACE_PENALTY, RACE_INVALID)
        cost_a = torch.where(valid, _race_bits(x, px_a, near) + RACE_PENALTY, RACE_INVALID)
        # argmin keeps the first minimum, as jnp.argmin does
        flags = torch.argmin(torch.stack([cost_s, cost_l, cost_a]), dim=0).to(torch.int32)
    pick = flags[..., None, None]
    px0 = torch.where(pick == 1, px_l, torch.where(pick == 2, px_a, px_s))
    w_q = torch.where(flags[..., None] > 0, w_q, torch.zeros_like(w_q))
    return (*_bias_fold_hist(x, px0, *context_planes(n, x, px0)), w_q, flags)


def _image_offsets(b: int, device) -> torch.Tensor:
    """(B, 1, 1, 1) int32 offset of each image's tables in the batch's: bias
    contexts and histogram bins both number 3072 an image."""
    return (torch.arange(b, dtype=torch.int32, device=device)
            * Q_N_CONTEXT).view(b, 1, 1, 1)


def _batch_moments(adr, err):
    """Per-image bias moments of (B, ...) address and error planes: (sums,
    counts), int64 (B x 3072,), image b's contexts at b x 3072."""
    b = adr.shape[0]
    return bias_moments(adr + _image_offsets(b, adr.device), err, b * Q_N_CONTEXT)


def _batch_bias(adr, err) -> torch.Tensor:
    """Per-image static bias tables (B, 3072) of (B, ...) address and error
    planes."""
    return quantize_bias(*_batch_moments(adr, err)).view(adr.shape[0], Q_N_CONTEXT)


def _symbol_hist(y, qd) -> torch.Tensor:
    """Per-image (B, 12, 256) symbol counts by activity bin of (B, ...) planes."""
    b = y.shape[0]
    idx = qd * N_SYM + y + _image_offsets(b, y.device)
    return torch.bincount(idx.reshape(-1), minlength=b * N_QD * N_SYM).view(b, N_QD, N_SYM)


def _bias_fold_hist(x, px0, err, qd, adr, valid=None, reduce=lambda t: t):
    """The static bias, residual fold and histogram of a modeling pass over
    (B, T, th, tw) planes.  ``valid``, a (T,) bool mask, keeps the tiles it
    clears out of the bias moments and the histogram; ``reduce`` sums a
    table over the shards of a tile axis (the mesh's all-reduce)."""
    b = x.shape[0]
    keep = (lambda p: p) if valid is None else (lambda p: p[:, valid])
    sums, cnts = _batch_moments(keep(adr), keep(err))
    bias = quantize_bias(reduce(sums), reduce(cnts)).view(b, Q_N_CONTEXT)
    px, sign = apply_static_bias(bias.view(-1), adr + _image_offsets(b, x.device), px0)
    y = residual_fold(x, px, sign, 0)
    return y, qd, bias, reduce(_symbol_hist(keep(y), keep(qd)))


# ---------------------------------------------------------------------------
# near-lossless: the reconstruction-feedback scan
# ---------------------------------------------------------------------------


def _lane_wcols(w_q: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """(B, T, 12) weights and (B, T) flags -> (B, 16, T) lane columns: rows
    0-11 the weights, row 12 the flag, the window's ``pixel_model`` layout."""
    b, t = flags.shape
    wcols = torch.zeros((b, N_WROWS, t), dtype=torch.int32, device=flags.device)
    wcols[:, : lsq.N_FEAT] = w_q.transpose(1, 2)
    wcols[:, lsq.N_FEAT] = flags
    return wcols


def _tile_encode_scan(x, bias, wcols, th: int, tw: int, near: int, profile: int,
                      stats: bool = False):
    """Near-lossless modeling scan with reconstruction feedback, in lockstep
    over every tile of every image: kernel K7 on the card, its plain version
    on the CPU (``ops/near_scan.py``; see
    :func:`~nblic_tpu_torch.ops.near_scan.encode_scan_plain` for the
    contract).  Returns (y, qd) planes, and with ``stats`` also (adr,
    x - px0, x_rec)."""
    return near_scan.encode_scan(x, bias, wcols, th, tw, near, profile, stats)


def _refine_near_bias(x, bias, w_q, flags, th: int, tw: int, near: int, profile: int,
                      w_refit=None):
    """Re-estimate each image's bias table from the feedback scan's own
    errors: the lossless pass's tables saw unquantized windows, the decoder
    sees quantized ones.  Each of the ``NEAR_BIAS_ITERS`` passes runs a
    statistics scan with the current tables and rebuilds them from the
    (address, x - px0) pairs it saw; at profile 2 it also refits the learned
    predictors on the scan's reconstruction (targets the originals), kept
    where the fit is valid and the tile's flag is learned.  ``w_refit``
    (private): (B, T, 12) weights that replace the refit's result.

    x: (B, T, th, tw) int32; w_q (B, T, 12) and flags (B, T) at profile 2,
    else None.  Returns (bias, w_q).
    """
    b, t = x.shape[:2]
    for _ in range(NEAR_BIAS_ITERS):
        wcols = _lane_wcols(w_q, flags) if profile == 2 else None
        _, _, adr, err, rec = _tile_encode_scan(x, bias, wcols, th, tw, near, profile,
                                                stats=True)
        bias = _batch_bias(adr, err)
        if profile == 2:
            if w_refit is None:
                w_new, valid = lsq.fit_tile_weights(rec.view(b * t, th, tw),
                                                    target=x.view(b * t, th, tw))
                w_new, valid = w_new.view(b, t, lsq.N_FEAT), valid.view(b, t)
            else:
                w_new, valid = w_refit.to(torch.int32), torch.ones_like(flags, dtype=torch.bool)
            w_q = torch.where((valid & (flags > 0))[..., None], w_new, w_q)
    return bias, w_q


def _model_near(x, bias, wcols, th: int, tw: int, near: int, profile: int):
    """The final feedback scan: (y, qd) planes and each image's (12, 256)
    symbol counts."""
    y, qd = _tile_encode_scan(x, bias, wcols, th, tw, near, profile)
    return y, qd, _symbol_hist(y, qd)


def _encode_near_impl(tiles, th: int, tw: int, near: int, profile: int, weights=None):
    """Near-lossless modeling at profile 1 or 2 (the JAX package's
    near-lossless branch of ``encode`` and its ``_encode_near2_impl``).

    The lossless pass gives the first bias tables (at profile 2 the race,
    its proxy rescaled to ``near``), :func:`_refine_near_bias` refines them
    (and refits the learned predictors), then the final scan.  Returns (y,
    qd, bias, hist, w_q, flags); w_q and flags are None at profile 1.

    ``weights`` (private, profile 2; tests and the smoke run carry state
    with it): (w_q, flags) replace the race, as in
    :func:`_model_lossless2_impl`, and the refit keeps w_q; a third tensor,
    (B, T, 12), is the refit's result instead.
    """
    x = tiles.to(torch.int32)
    w_q = flags = w_refit = wcols = None
    if profile == 2:
        _, _, bias, _, w_q, flags = _model_lossless2_impl(
            tiles, None if weights is None else weights[:2], near)
        if weights is not None:
            w_refit = weights[2] if len(weights) > 2 else w_q
    else:
        _, _, bias, _ = _model_lossless_impl(tiles)
    bias, w_q = _refine_near_bias(x, bias, w_q, flags, th, tw, near, profile, w_refit)
    if profile == 2:
        wcols = _lane_wcols(w_q, flags)
    y, qd, hist = _model_near(x, bias, wcols, th, tw, near, profile)
    return y, qd, bias, hist, w_q, flags


def _norm_hist_dev(h: torch.Tensor) -> torch.Tensor:
    """Normalize histograms (..., 256) to sum 2^15, int32.

    Scale with a reserve so every nonzero bin keeps >= 1 and the floor sum
    never overshoots, then put the remainder on the first largest bin
    (capped at 2^15-1, spilling into the next slot modulo 256).  The scale
    is a float32 quotient and the product a float32 floor, so the tables
    match the JAX package's bit for bit.
    """
    total = h.sum(-1, keepdim=True)
    nz = (h > 0).to(torch.int32)
    scale = (torch.tensor(NORM_SUM - 260.0, dtype=torch.float32, device=h.device)
             / torch.clamp(total, min=1).to(torch.float32))
    s = torch.floor(h.to(torch.float32) * scale).to(torch.int32) + nz
    rem = (NORM_SUM - s.sum(-1, keepdim=True)).to(torch.int32)
    top = torch.argmax(s, dim=-1, keepdim=True)  # the first maximum
    s = s.scatter_add(-1, top, rem)
    over = torch.clamp(s.gather(-1, top) - (NORM_SUM - 1), min=0)
    s = s.scatter_add(-1, top, -over).scatter_add(-1, (top + 1) % N_SYM, over)
    empty = torch.zeros_like(s)
    empty[..., 0] = NORM_SUM - 1
    empty[..., 1] = 1
    return torch.where(total == 0, empty, s)


def _norm_tables(hist: torch.Tensor):
    """hist (B, 12, 256) counts -> (hist_n, acc), int32 (B, 12, 256)."""
    hist_n = _norm_hist_dev(hist)
    acc = torch.cumsum(hist_n, dim=-1, dtype=torch.int32) - hist_n
    return hist_n, acc


def _encode_tables(y, qd, hist_n, acc, g_lanes: int = G_LANES, valid=None):
    """Per-pixel (freq, cum) of every tile's symbols, in fold-ready layout.

    y/qd: (B, T, th, tw); hist_n/acc: (B, 12, 256).  Returns freq/facc as
    (S, L) views of (L, S) int32 tensors, S = B x T padded to a multiple of
    ``g_lanes`` per image (pad lanes are identity symbols, freq 2^15 and
    cum 0, that encode nothing) and L = th x tw.  ``valid``, a (T,) bool
    mask, makes the tiles it clears identity lanes too (the mesh's pad
    tiles).
    """
    b, t = y.shape[:2]
    l = y[0, 0].numel()
    t_pad = -(-t // g_lanes) * g_lanes
    off = (torch.arange(b, device=y.device) * (N_QD * N_SYM)).view(b, 1, 1)
    idx = (qd * N_SYM + y).reshape(b, t, l) + off
    idx = idx.permute(2, 0, 1)  # (L, B, T): the kernel reads lanes fastest
    freq = torch.full((l, b, t_pad), NORM_SUM, dtype=torch.int32, device=y.device)
    facc = torch.zeros((l, b, t_pad), dtype=torch.int32, device=y.device)
    freq[:, :, :t] = hist_n.reshape(-1)[idx]
    facc[:, :, :t] = acc.reshape(-1)[idx]
    if valid is not None:
        freq[:, :, :t][:, :, ~valid] = NORM_SUM
        facc[:, :, :t][:, :, ~valid] = 0
    return freq.view(l, b * t_pad).t(), facc.view(l, b * t_pad).t()


def _pack_groups(words, emits, state, g_lanes: int = G_LANES):
    """Interleave-pack a fold's outputs per group of ``g_lanes`` lanes.

    Returns (totals (G,) int64 word counts, flats (G, g_lanes*(L+2)) int32).
    """
    s, l = words.shape
    n = s // g_lanes
    flats, totals = rans.interleave_pack(
        words.reshape(n, g_lanes, l),
        emits.reshape(n, g_lanes, l),
        state.reshape(n, g_lanes),
    )
    return totals, flats


def _live_payload(flats, totals):
    """The live prefix of every group's buffer, back to back (int32 words)."""
    cap = flats.shape[1]
    live = torch.arange(cap, device=flats.device)[None, :] < totals[:, None]
    return flats[live]


def _finish_encode_parts(y, qd, hist, g_lanes: int = G_LANES, valid=None):
    """The coding tail of a modeling pass: normalize the (B, 12, 256)
    histograms, fold every lane (K1 on a CUDA tensor) and pack each group of
    ``g_lanes`` lanes.  ``valid`` as in :func:`_encode_tables`.

    Returns (totals (B x groups,) int64 word counts, hist_n (B, 12, 256)
    int32, the groups' live words back to back, int32), on y's device.
    """
    hist_n, acc = _norm_tables(hist)
    freq, facc = _encode_tables(y, qd, hist_n, acc, g_lanes, valid)
    totals, flats = _pack_groups(*encode_fold(freq, facc), g_lanes)
    return totals, hist_n, _live_payload(flats, totals)


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------


def _serialize_hists(hist_n: np.ndarray) -> bytes:
    words: list[int] = []
    for h in hist_n:
        words.extend(hist_ops.serialize(h))
    return np.asarray(words, dtype=np.uint16).tobytes()


def _deserialize_hists(data: bytes):
    words = np.frombuffer(data, dtype=np.uint16)
    hists, pos = [], 0
    for _ in range(N_QD):
        h, pos = hist_ops.deserialize(words, pos)
        hists.append(h)
    return np.stack(hists)


def _serialize_weights(w_q: np.ndarray, flags: np.ndarray) -> bytes:
    """Profile-2 weight block: flags + weights of learned tiles, zlib'd."""
    raw = zlib.compress(flags.tobytes() + w_q[flags > 0].tobytes(), 6)
    return np.asarray([len(raw)], np.uint32).tobytes() + raw + b"\x00" * (len(raw) & 1)


def _containers(profile, near, h, w, tile_h, tile_w, n_tiles, g_lanes, totals, bias,
                hist_n, words, weights=None, transposed=None) -> list[bytes]:
    """One container per image of a batch, from its host arrays: totals (B,
    groups) word counts, bias (B, 3072), hist_n (B, 12, 256), words the u16
    payload of every group of every image back to back; ``weights`` the
    profile-2 (w_q (B, T, 12), flags (B, T)); ``transposed`` per-image
    header flags.  The group count is the totals' width: the mesh writes one
    group a tile shard, and may pad past ceil(n_tiles / g_lanes) groups."""
    totals = np.asarray(totals).reshape(len(bias), -1)
    ends = np.cumsum(totals.sum(axis=1))
    return [
        _emit_container(
            profile, near, h, w, tile_h, tile_w, n_tiles, g_lanes, totals[i],
            np.asarray(bias[i], np.int16), np.asarray(hist_n[i], np.uint32),
            np.asarray(words[ends[i] - totals[i].sum() : ends[i]], np.uint16).tobytes(),
            _serialize_weights(weights[0][i], weights[1][i]) if weights is not None else b"",
            bool(transposed[i]) if transposed is not None else False)
        for i in range(len(bias))
    ]


def _emit_container(profile, near, h, w, tile_h, tile_w, n_tiles, g_lanes, totals,
                    bias_i16, hist_n, payload, weights_bytes,
                    transposed_flag) -> bytes:
    """Serialize one NBTC container (profile 1 or 2)."""
    bias_bytes = zlib.compress(bias_i16.tobytes(), 6)
    bias_bytes += b"\x00" * (len(bias_bytes) & 1)  # keep u16 aligned
    hist_bytes = _serialize_hists(hist_n)
    meta = np.asarray(
        [g_lanes, len(totals)] + [2 * int(t) for t in totals], dtype=np.uint32
    ).tobytes()
    header = NbtcHeader(
        profile=profile, near=near, height=h, width=w, tile_h=tile_h, tile_w=tile_w,
        n_tiles=n_tiles, bias_len=len(bias_bytes), hist_len=len(hist_bytes),
        flags=int(transposed_flag),
    )
    return (header.to_bytes() + bias_bytes + weights_bytes + hist_bytes + meta
            + payload)


# ---------------------------------------------------------------------------
# public encode
# ---------------------------------------------------------------------------


def encode(img: np.ndarray, near: int = 0, tile_h: int = DEFAULT_TILE[0],
           tile_w: int = DEFAULT_TILE[1], effort: int = 1,
           device="cuda") -> bytes:
    """Encode a gray-8 image into an NBTC container: profile 1 at effort
    0-1, profile 2 (per-tile least-squares predictors) at effort 2,
    profile 3 (the strip engine; no tiles) at effort 3 and above;
    near-lossless (max error ``near``) when ``near`` > 0."""
    return encode_batch([img], near=near, tile_h=tile_h, tile_w=tile_w,
                        effort=effort, device=device)[0]


def encode_batch(imgs, near: int = 0, tile_h: int = DEFAULT_TILE[0],
                 tile_w: int = DEFAULT_TILE[1], effort: int = 1,
                 transposed=None, device="cuda") -> list[bytes]:
    """Encode same-shape images together: every image's tiles ride one
    modeling pass (at ``near`` > 0, one lockstep feedback scan) and one
    fold.  ``transposed`` marks images stored transposed (header flag bit
    0); at ``near`` > 0 it is ignored, as the JAX package ignores it there.
    At effort 3 the images go to :func:`strips.encode_batch`, which
    normalizes their orientation itself."""
    _check_encode_mode(near)
    if effort >= 3:
        return strips.encode_batch(imgs, near=near, device=device)
    return _encode_batch(imgs, tile_h, tile_w, 2 if effort >= 2 else 1,
                         transposed if near == 0 else None, resolve_device(device),
                         near=near)


def _encode_batch(imgs, tile_h: int, tile_w: int, profile: int, transposed,
                  dev: torch.device, weights=None, near: int = 0) -> list[bytes]:
    """:func:`encode_batch` after its mode checks.  Private, for tests and
    the smoke run: ``weights`` is the profile-2 state of
    :func:`_model_lossless2_impl` (lossless) or :func:`_encode_near_impl`
    (near-lossless)."""
    imgs = [np.ascontiguousarray(im, dtype=np.uint8) for im in imgs]
    if not imgs:
        return []
    if any(im.ndim != 2 or im.shape != imgs[0].shape for im in imgs):
        raise ValueError("encode_batch requires same-shape 2-D gray-8 images")
    h, w = imgs[0].shape
    check_size(h, w)
    if not (0 < tile_h < 1 << 16 and 0 < tile_w < 1 << 16):
        raise ValueError(f"tile size {tile_h}x{tile_w} outside 1..65535")
    gh, gw = _tile_grid(h, w, tile_h, tile_w)

    tiles = to_tiles(torch.from_numpy(np.stack(imgs)).to(dev), tile_h, tile_w)
    if near:
        y, qd, bias, hist, w_q, flags = _encode_near_impl(tiles, tile_h, tile_w, near,
                                                          profile, weights)
    elif profile == 2:
        y, qd, bias, hist, w_q, flags = _model_lossless2_impl(tiles, weights)
    else:
        y, qd, bias, hist = _model_lossless_impl(tiles)
    sent = None  # the profile-2 weights the containers carry
    if profile == 2:
        sent = (w_q.cpu().numpy().astype(np.int16), flags.cpu().numpy().astype(np.uint8))
    totals, hist_n, payload = _finish_encode_parts(y, qd, hist)
    return _containers(profile, near, h, w, tile_h, tile_w, gh * gw, G_LANES,
                       totals.cpu().numpy(), bias.cpu().numpy(), hist_n.cpu().numpy(),
                       payload.cpu().numpy(), sent, transposed)


def _encode_flag_cycle(imgs, t: int, device="cuda", near: int = 0) -> list[bytes]:
    """Profile-2 containers of same-shape ``imgs`` at t x t tiles whose tiles
    cycle through flags 0, 1, 2 (blend, learned, mean) with their fitted
    weights: every branch of the profile-2 predictor, which small tiles
    seldom win by merit.  Tests and the smoke run hold the decoders against
    each other on them."""
    dev = resolve_device(device)
    tiles = to_tiles(torch.from_numpy(np.stack(imgs)).to(dev), t, t)
    b, n = tiles.shape[:2]
    w_q, _ = lsq.fit_tile_weights(tiles.reshape(b * n, t, t))
    flags = torch.arange(b * n, dtype=torch.int32, device=dev) % 3
    return _encode_batch(imgs, t, t, 2, None, dev,
                         (w_q.reshape(b, n, lsq.N_FEAT), flags.reshape(b, n)), near=near)


def encode_batches(image_groups, near: int = 0,
                   tile_h: int = DEFAULT_TILE[0], tile_w: int = DEFAULT_TILE[1],
                   effort: int = 1, transposed_groups=None,
                   device="cuda") -> list[list[bytes]]:
    """Encode several same-shape batches, one :func:`encode_batch` each."""
    return [
        encode_batch(g, near=near, tile_h=tile_h, tile_w=tile_w, effort=effort,
                     transposed=transposed_groups[i] if transposed_groups else None,
                     device=device)
        for i, g in enumerate(image_groups)
    ]


def encode_corpus(imgs, near: int = 0, tile_h: int = DEFAULT_TILE[0],
                  tile_w: int = DEFAULT_TILE[1], effort: int = 1,
                  device="cuda") -> list[bytes]:
    """Encode images of any shapes with orientation normalization.

    Portrait images are transposed to landscape (header flag bit 0) so both
    orientations of a corpus share one batch shape.  Containers come back
    in input order; the decoders undo the transpose.  At ``near`` > 0 no
    image is transposed (the JAX package encodes those one by one and
    never merges orientations); the images of each shape share one batch.
    At effort 3 the strip engine normalizes images to portrait instead, and
    the images of each portrait shape share one batch.
    """
    _check_encode_mode(near)
    if effort >= 3:
        return _encode_corpus_p3(imgs, near, device)
    idx_groups, batches, flag_groups = _orientation_batches(imgs, transpose=near == 0)
    streams_by_group = encode_batches(
        batches, near=near, tile_h=tile_h, tile_w=tile_w, effort=effort,
        transposed_groups=flag_groups, device=device,
    )
    out: list[bytes] = [b""] * len(imgs)
    for g, streams in zip(idx_groups, streams_by_group):
        for i, s in zip(g, streams):
            out[i] = s
    return out


def _encode_corpus_p3(imgs, near: int, device) -> list[bytes]:
    """Profile-3 containers of ``imgs`` in input order, one
    :func:`strips.encode_batch` per portrait-normalized shape."""
    groups: dict[tuple, list[int]] = {}
    for i, im in enumerate(imgs):
        groups.setdefault(tuple(sorted(np.shape(im), reverse=True)), []).append(i)
    out: list[bytes] = [b""] * len(imgs)
    for idx in groups.values():
        for i, c in zip(idx, strips.encode_batch([imgs[i] for i in idx], near=near,
                                                      device=device)):
            out[i] = c
    return out


def _orientation_batches(imgs, transpose: bool = True):
    """Same-shape batches of ``imgs``, landscape-normalized unless
    ``transpose`` is false.

    Returns (index groups into ``imgs``, image batches, transposed flags
    per batch).
    """
    norm, flags = [], []
    for im in imgs:
        im = np.ascontiguousarray(im, dtype=np.uint8)
        t = transpose and im.shape[0] > im.shape[1]
        norm.append(np.ascontiguousarray(im.T) if t else im)
        flags.append(t)
    order: dict[tuple, list[int]] = {}
    for i, im in enumerate(norm):
        order.setdefault(im.shape, []).append(i)
    idx_groups = list(order.values())
    return (idx_groups, [[norm[i] for i in g] for g in idx_groups],
            [[flags[i] for i in g] for g in idx_groups])


# ---------------------------------------------------------------------------
# public decode
# ---------------------------------------------------------------------------


class _Parsed:
    """Host-side view of one NBTC profile-1 or profile-2 container."""

    def __init__(self, stream: bytes):
        self.hdr = hdr = NbtcHeader.from_bytes(stream)
        if hdr.profile not in (0, 1, 2, 3):
            raise ValueError(f"unknown NBTC profile {hdr.profile}")
        if hdr.profile == 0:
            raise NotImplementedError(
                "profile-0 containers are not ported (ROADMAP Queue 1 item 14)")
        if hdr.profile == 3:
            raise ValueError("a profile-3 container decodes through models/strips.py")
        check_size(hdr.height, hdr.width)
        # the tile grid before any decode: a hostile header is refused here
        if hdr.tile_h < 1 or hdr.tile_w < 1 or hdr.n_tiles != np.prod(
                _tile_grid(hdr.height, hdr.width, hdr.tile_h, hdr.tile_w)):
            raise ValueError(f"tile grid {hdr.tile_h}x{hdr.tile_w} of a {hdr.height}x"
                             f"{hdr.width} image does not hold {hdr.n_tiles} tiles")
        pos = NbtcHeader.SIZE
        self.bias = np.frombuffer(
            inflate(stream[pos : pos + hdr.bias_len], "bias table"), dtype=np.int16
        ).astype(np.int32)
        if self.bias.shape != (Q_N_CONTEXT,):
            raise ValueError("malformed bias table")
        pos += hdr.bias_len
        self.weights = self.flags = None
        if hdr.profile == 2:
            (wlen,) = np.frombuffer(stream[pos : pos + 4], dtype=np.uint32)
            pos += 4
            raw = inflate(stream[pos : pos + int(wlen)], "weight block")
            pos += int(wlen) + (int(wlen) & 1)
            t = hdr.n_tiles
            self.flags = np.frombuffer(raw[:t], dtype=np.uint8)
            dense = np.frombuffer(raw[t:], dtype=np.int16)
            if len(self.flags) != t or dense.size != lsq.N_FEAT * int((self.flags > 0).sum()):
                raise ValueError("malformed weight block")
            self.weights = np.zeros((t, lsq.N_FEAT), dtype=np.int16)
            self.weights[self.flags > 0] = dense.reshape(-1, lsq.N_FEAT)
        self.hist_n = _deserialize_hists(
            stream[pos : pos + hdr.hist_len]
        ).astype(np.int32)
        pos += hdr.hist_len
        self.acc = np.stack(
            [hist_ops.accumulate(h.astype(np.uint32)) for h in self.hist_n]
        ).astype(np.int32)
        g, n_groups = (int(v) for v in np.frombuffer(stream[pos : pos + 8],
                                                     dtype=np.uint32))
        pos += 8
        # ceil(n_tiles / g) groups, or (the mesh: one group a tile shard, the
        # tile axis padded to a multiple of the shards) fewer pad lanes than
        # groups; no more groups than the tiles fill unless shards outnumber
        # the tiles, and then at most MAX_GROUP
        n_pad = n_groups * g - hdr.n_tiles
        if (not 1 <= g <= MAX_GROUP or not 0 <= n_pad < max(g, n_groups)
                or n_groups > max(-(-hdr.n_tiles // g), MAX_GROUP)):
            raise ValueError(f"{n_groups} groups of {g} lanes do not hold "
                             f"{hdr.n_tiles} tiles")
        self.group_size = g
        lengths = np.frombuffer(stream[pos : pos + 4 * n_groups], dtype=np.uint32)
        pos += 4 * n_groups
        self.counts = (lengths // 2).astype(np.int64)
        self.payload = np.frombuffer(stream, dtype=np.uint16, offset=pos)
        if len(self.counts) != n_groups or self.counts.sum() > self.payload.size:
            raise ValueError("truncated group table or payload")

    def n_active(self) -> np.ndarray:
        """Per-group active-lane counts (0 for a whole pad group)."""
        t, g = self.hdr.n_tiles, self.group_size
        n_groups = len(self.counts)
        return np.clip(t - g * np.arange(n_groups, dtype=np.int64), 0, g).astype(np.int32)

    def weight_cols(self) -> np.ndarray:
        """Per-group (16, g) weight and flag columns for the group decoders:
        rows 0-11 the weights, row 12 the flag, 0 for pad lanes."""
        g = self.group_size
        n_groups = len(self.counts)
        wf = np.zeros((n_groups * g, 16), dtype=np.int32)
        if self.weights is not None:
            t = self.hdr.n_tiles
            wf[:t, : lsq.N_FEAT] = self.weights
            wf[:t, lsq.N_FEAT] = self.flags
        return np.ascontiguousarray(wf.reshape(n_groups, g, 16).transpose(0, 2, 1))


def decode(stream: bytes, device="cuda") -> np.ndarray:
    """Decode one NBTC container of any profile the port writes."""
    return decode_batch([stream], device=device)[0]


def decode_batch(streams: list[bytes], device="cuda") -> list[np.ndarray]:
    """Decode same-geometry containers in one lockstep group decode; profile
    3 goes to :func:`strips.decode_batch`, and a batch may not mix it with
    profiles 1-2."""
    dev = resolve_device(device)
    if not streams:
        return []
    p3 = [NbtcHeader.from_bytes(s).profile == 3 for s in streams]
    if any(p3):
        if not all(p3):
            raise ValueError("a decode batch mixes profile 3 with profiles 1-2")
        return strips.decode_batch(streams, device=dev)
    parsed = [_Parsed(s) for s in streams]
    h0 = parsed[0].hdr

    def geometry(p):
        return (p.hdr.height, p.hdr.width, p.hdr.tile_h, p.hdr.tile_w,
                p.hdr.near, p.group_size, len(p.counts), p.hdr.profile)

    if any(geometry(p) != geometry(parsed[0]) for p in parsed):
        return [decode(s, device=dev) for s in streams]
    tiles = decode_groups(*group_args(parsed, dev))
    tiles = tiles.reshape(len(parsed), -1, h0.tile_h, h0.tile_w)[:, : h0.n_tiles]
    imgs = from_tiles(tiles, h0.height, h0.width, h0.tile_h, h0.tile_w).cpu().numpy()
    return [np.ascontiguousarray(im.T if p.hdr.transposed else im)
            for im, p in zip(imgs, parsed)]


def decode_batches(stream_groups, device="cuda") -> list[list[np.ndarray]]:
    """Decode several batches, one :func:`decode_batch` each."""
    return [decode_batch(g, device=device) for g in stream_groups]
