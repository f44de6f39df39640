"""NBTC profile 1, lossless: the tile-parallel codec on PyTorch.

Counterpart of ``nblic_tpu/models/tiled.py``; writes and reads the same
``NBTC0001`` containers, byte for byte.

- Encode is one whole-plane modeling pass (blend predictor, 12-bin
  activity, a 3072-context static bias table, residual fold, a 12 x 256
  histogram per image), then a coding tail: normalize the histograms, look
  up each pixel's (freq, cum), fold one rANS stream per tile (kernel K1 on
  CUDA) and interleave the streams of each group of 128 tiles into one.
- Decode runs the 128 tile lanes of each group in lockstep against one
  shared stream cursor (kernel K2 on CUDA).

Every entry point takes ``device`` ("cuda" by default); a CUDA device on a
machine without CUDA raises.  Near-lossless encode and profiles 0, 2 and 3
are not ported yet and raise ``NotImplementedError`` naming their ROADMAP
item.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from nblic_tpu.constants import Q_N_CONTEXT
from nblic_tpu.utils.container import NbtcHeader, check_size

from ..convert import resolve_device, streams_from_parsed, tables_from_numpy
from ..ops import histogram as hist_ops
from ..ops import rans
from ..ops.context import apply_static_bias, build_static_bias, residual_fold
from ..ops.decode import decode_groups
from ..ops.fold import encode_fold
from ..ops.predict import model_stage1

DEFAULT_TILE = (64, 64)
N_QD = 12
N_SYM = 256
NORM_SUM = hist_ops.NORM_SUM
# interleave-group width: one shared-cursor stream per G tiles
G_LANES = 128


def _check_encode_mode(near: int, effort: int) -> None:
    if effort >= 3:
        raise NotImplementedError(
            "profile 3 (effort >= 3) is not ported yet: ROADMAP Queue 1 items 9-11"
        )
    if effort == 2:
        raise NotImplementedError(
            "profile 2 (effort 2) is not ported yet: ROADMAP Queue 1 item 8"
        )
    if near != 0:
        raise NotImplementedError(
            "near-lossless encode is not ported yet: ROADMAP Queue 1 item 7"
        )


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
    px0, err, qd, adr = model_stage1(x)
    b = x.shape[0]
    # per-image table offset: bias contexts and histogram bins both number 3072
    off = (torch.arange(b, dtype=torch.int32, device=x.device)
           * Q_N_CONTEXT).view(b, 1, 1, 1)
    bias = build_static_bias(adr + off, err, b * Q_N_CONTEXT)
    px, sign = apply_static_bias(bias, adr + off, px0)
    y = residual_fold(x, px, sign, 0)
    hist = torch.bincount((qd * N_SYM + y + off).reshape(-1),
                          minlength=b * N_QD * N_SYM)
    return y, qd, bias.view(b, Q_N_CONTEXT), hist.view(b, N_QD, N_SYM)


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


def _encode_tables(y, qd, hist_n, acc, g_lanes: int = G_LANES):
    """Per-pixel (freq, cum) of every tile's symbols, in fold-ready layout.

    y/qd: (B, T, th, tw); hist_n/acc: (B, 12, 256).  Returns freq/facc as
    (S, L) views of (L, S) int32 tensors, S = B x T padded to a multiple of
    ``g_lanes`` per image (pad lanes are identity symbols, freq 2^15 and
    cum 0, that encode nothing) and L = th x tw.
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


def _emit_container(h, w, tile_h, tile_w, n_tiles, g_lanes, totals,
                    bias_i16, hist_n, payload, transposed_flag) -> bytes:
    """Serialize one profile-1 lossless NBTC container."""
    bias_bytes = zlib.compress(bias_i16.tobytes(), 6)
    bias_bytes += b"\x00" * (len(bias_bytes) & 1)  # keep u16 aligned
    hist_bytes = _serialize_hists(hist_n)
    meta = np.asarray(
        [g_lanes, len(totals)] + [2 * int(t) for t in totals], dtype=np.uint32
    ).tobytes()
    header = NbtcHeader(
        profile=1, near=0, height=h, width=w, tile_h=tile_h, tile_w=tile_w,
        n_tiles=n_tiles, bias_len=len(bias_bytes), hist_len=len(hist_bytes),
        flags=int(transposed_flag),
    )
    return header.to_bytes() + bias_bytes + hist_bytes + meta + payload


# ---------------------------------------------------------------------------
# public encode
# ---------------------------------------------------------------------------


def encode(img: np.ndarray, near: int = 0, tile_h: int = DEFAULT_TILE[0],
           tile_w: int = DEFAULT_TILE[1], effort: int = 1,
           device="cuda") -> bytes:
    """Encode a gray-8 image into an NBTC profile-1 container."""
    return encode_batch([img], near=near, tile_h=tile_h, tile_w=tile_w,
                        effort=effort, device=device)[0]


def encode_batch(imgs, near: int = 0, tile_h: int = DEFAULT_TILE[0],
                 tile_w: int = DEFAULT_TILE[1], effort: int = 1,
                 transposed=None, device="cuda") -> list[bytes]:
    """Encode same-shape images together: every image's tiles ride one
    modeling pass and one fold.  ``transposed`` marks images stored
    transposed (header flag bit 0)."""
    _check_encode_mode(near, effort)
    dev = resolve_device(device)
    imgs = [np.ascontiguousarray(im, dtype=np.uint8) for im in imgs]
    if not imgs:
        return []
    if any(im.ndim != 2 or im.shape != imgs[0].shape for im in imgs):
        raise ValueError("encode_batch requires same-shape 2-D gray-8 images")
    h, w = imgs[0].shape
    check_size(h, w)
    if not (0 < tile_h < 1 << 16 and 0 < tile_w < 1 << 16):
        raise ValueError(f"tile size {tile_h}x{tile_w} outside 1..65535")
    b = len(imgs)
    gh, gw = _tile_grid(h, w, tile_h, tile_w)

    tiles = to_tiles(torch.from_numpy(np.stack(imgs)).to(dev), tile_h, tile_w)
    y, qd, bias, hist = _model_lossless_impl(tiles)
    hist_n, acc = _norm_tables(hist)
    freq, facc = _encode_tables(y, qd, hist_n, acc)
    totals, flats = _pack_groups(*encode_fold(freq, facc))
    payload = _live_payload(flats, totals)

    totals = totals.cpu().numpy().reshape(b, -1)
    words = payload.cpu().numpy().astype(np.uint16)
    bias = bias.cpu().numpy().astype(np.int16)
    hist_n = hist_n.cpu().numpy().astype(np.uint32)
    ends = np.cumsum(totals.sum(axis=1))
    out = []
    for i in range(b):
        out.append(_emit_container(
            h, w, tile_h, tile_w, gh * gw, G_LANES, totals[i], bias[i],
            hist_n[i], words[ends[i] - totals[i].sum() : ends[i]].tobytes(),
            bool(transposed[i]) if transposed is not None else False,
        ))
    return out


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
    in input order; the decoders undo the transpose.
    """
    _check_encode_mode(near, effort)
    norm, flags = [], []
    for im in imgs:
        im = np.ascontiguousarray(im, dtype=np.uint8)
        t = im.shape[0] > im.shape[1]
        norm.append(np.ascontiguousarray(im.T) if t else im)
        flags.append(t)
    order: dict[tuple, list[int]] = {}
    for i, im in enumerate(norm):
        order.setdefault(im.shape, []).append(i)
    idx_groups = list(order.values())
    streams_by_group = encode_batches(
        [[norm[i] for i in g] for g in idx_groups],
        tile_h=tile_h, tile_w=tile_w, effort=effort,
        transposed_groups=[[flags[i] for i in g] for g in idx_groups],
        device=device,
    )
    out: list[bytes] = [b""] * len(imgs)
    for g, streams in zip(idx_groups, streams_by_group):
        for i, s in zip(g, streams):
            out[i] = s
    return out


# ---------------------------------------------------------------------------
# public decode
# ---------------------------------------------------------------------------


class _Parsed:
    """Host-side view of one NBTC profile-1 container."""

    def __init__(self, stream: bytes):
        self.hdr = hdr = NbtcHeader.from_bytes(stream)
        if hdr.profile != 1:
            raise NotImplementedError({
                0: "profile-0 containers are not ported (ROADMAP Queue 1 item 14)",
                2: "profile-2 decode is not ported yet: ROADMAP Queue 1 item 8",
                3: "profile-3 decode is not ported yet: ROADMAP Queue 1 item 10",
            }.get(hdr.profile, f"unknown NBTC profile {hdr.profile}"))
        check_size(hdr.height, hdr.width)
        pos = NbtcHeader.SIZE
        self.bias = np.frombuffer(
            zlib.decompress(stream[pos : pos + hdr.bias_len]), dtype=np.int16
        ).astype(np.int32)
        if self.bias.shape != (Q_N_CONTEXT,):
            raise ValueError("malformed bias table")
        pos += hdr.bias_len
        self.hist_n = _deserialize_hists(
            stream[pos : pos + hdr.hist_len]
        ).astype(np.int32)
        pos += hdr.hist_len
        self.acc = np.stack(
            [hist_ops.accumulate(h.astype(np.uint32)) for h in self.hist_n]
        ).astype(np.int32)
        g, n_groups = np.frombuffer(stream[pos : pos + 8], dtype=np.uint32)
        pos += 8
        self.group_size = int(g)
        lengths = np.frombuffer(stream[pos : pos + 4 * int(n_groups)], dtype=np.uint32)
        pos += 4 * int(n_groups)
        self.counts = (lengths // 2).astype(np.int64)
        self.payload = np.frombuffer(stream, dtype=np.uint16, offset=pos)

    def n_active(self) -> np.ndarray:
        """Per-group active-lane counts."""
        t, g = self.hdr.n_tiles, self.group_size
        n_groups = len(self.counts)
        return np.minimum(t - g * np.arange(n_groups, dtype=np.int64), g).astype(
            np.int32
        )


def decode(stream: bytes, device="cuda") -> np.ndarray:
    """Decode one NBTC profile-1 container."""
    return decode_batch([stream], device=device)[0]


def decode_batch(streams: list[bytes], device="cuda") -> list[np.ndarray]:
    """Decode same-geometry containers in one lockstep group decode."""
    dev = resolve_device(device)
    if not streams:
        return []
    parsed = [_Parsed(s) for s in streams]
    h0 = parsed[0].hdr

    def geometry(p):
        return (p.hdr.height, p.hdr.width, p.hdr.tile_h, p.hdr.tile_w,
                p.hdr.near, p.group_size)

    if any(geometry(p) != geometry(parsed[0]) for p in parsed):
        return [decode(s, device=dev) for s in streams]
    b = len(parsed)
    bias, hist_n, acc = tables_from_numpy(
        np.stack([p.bias for p in parsed]), np.stack([p.hist_n for p in parsed]),
        np.stack([p.acc for p in parsed]), dev,
    )
    words, n_active = streams_from_parsed(parsed, dev)
    tiles = decode_groups(words, n_active, bias, hist_n, acc, h0.tile_h,
                          h0.tile_w, h0.near, parsed[0].group_size)
    tiles = tiles.reshape(b, -1, h0.tile_h, h0.tile_w)[:, : h0.n_tiles]
    imgs = from_tiles(tiles, h0.height, h0.width, h0.tile_h, h0.tile_w).cpu().numpy()
    return [np.ascontiguousarray(im.T if p.hdr.transposed else im)
            for im, p in zip(imgs, parsed)]


def decode_batches(stream_groups, device="cuda") -> list[list[np.ndarray]]:
    """Decode several batches, one :func:`decode_batch` each."""
    return [decode_batch(g, device=device) for g in stream_groups]
