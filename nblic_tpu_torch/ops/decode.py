"""Lockstep group decode: kernels K2 and K2' (``csrc/group_decode.cu``) and
their plain version.

Counterpart of ``nblic_tpu/ops/pallas_decode.py::decode_groups_pallas``
(K2, profiles 1 and 2), of
``docs/experiments/pallas_decode8.py::decode_groups_pallas8`` (K2', one
table set per group) and of ``nblic_tpu/models/tiled.py::_group_decode_scan``.
Both launch the same kernel, one group a CTA.  A CPU tensor runs
:func:`group_decode_plain`; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from .. import kernels
from . import rans
from .context import apply_static_bias, residual_unfold
from .window import pixel_model, row_start_window, slide_window

N_QD = 12
N_SYM = 256
N_CTX = N_QD * N_SYM
N_WROWS = 16  # rows of a group's weight table: 12 weights, the flag, 3 spare
GROUP_MULTIPLE8 = 8  # K2': the group count is a multiple of this
SLOT_BITS = 12  # k of K2's slot table, kSlotBits in csrc/group_decode.cu
SLOT_PAD = 16  # slot-table entries past 2^k


def slot_table(acc: torch.Tensor, k: int = SLOT_BITS) -> torch.Tensor:
    """K2's symbol lookup over the top k bits of the slot ``state & 0x7FFF``:
    the plain version of the table each K2 CTA builds in its prologue.

    acc: (..., 256) cumulative frequencies, nondecreasing from acc[0] = 0
    (as every table the codec builds).  Returns (..., 2^k + 16) uint8:
    entry b < 2^k is the last symbol v with acc[v] <= b 2^(15-k) (the last
    of a run of zero-frequency bins), and the entries from 2^k on are 255:
    entry 2^k closes the last span, the rest pad a row to 16 bytes.  The
    symbol of slot lb lies in [T[b], T[b + 1]] for b = lb >> (15 - k).
    """
    if not 4 <= k <= rans.NORM_BITS:
        raise ValueError(f"slot bits must lie in 4..15, got {k}")
    # the count of acc[1..255] at most an edge is the last such v when acc[0] = 0
    rows = acc.reshape(-1, N_SYM)[:, 1:].contiguous()
    edges = torch.full(((1 << k) + SLOT_PAD,), torch.iinfo(rows.dtype).max,
                       dtype=rows.dtype, device=rows.device)
    edges[: 1 << k] = torch.arange(1 << k, device=rows.device) << (rans.NORM_BITS - k)
    t = torch.searchsorted(rows, edges.expand(rows.shape[0], -1).contiguous(), right=True)
    return t.to(torch.uint8).reshape(acc.shape[:-1] + (edges.shape[0],))


def slot_search(acc_rows: torch.Tensor, slots: torch.Tensor, row: torch.Tensor,
                lb: torch.Tensor, k: int = SLOT_BITS) -> torch.Tensor:
    """K2's symbol search: the slot lookup, then a bounded binary search in
    [T[b], T[b+1]], step for step as the kernel takes it.

    acc_rows: (R, 256); slots: (R, 2^k + 16), :func:`slot_table` of those
    rows; row, lb: equal-shape int64 row indices and slots.  Returns the
    symbols, int64.
    """
    b = lb >> (rans.NORM_BITS - k)
    y = slots[row, b].to(torch.int64)
    n = slots[row, b + 1].to(torch.int64) - y
    acc_rows = acc_rows.to(torch.int64)
    while bool((n > 0).any()):
        live = n > 0
        half = (n + 1) >> 1
        ok = live & (acc_rows[row, (y + half).clamp(max=N_SYM - 1)] <= lb)
        y = torch.where(ok, y + half, y)
        n = torch.where(ok, n - half, torch.where(live, half - 1, n))
    return y


def _check(streams, n_active, bias, hist_n, acc, wcols, th, tw, g, profile):
    n_groups, w = streams.shape
    b = bias.shape[0]
    if bias.shape != (b, N_CTX) or hist_n.shape != (b, N_QD, N_SYM) \
            or acc.shape != (b, N_QD, N_SYM):
        raise ValueError("bias must be (B, 3072) and hist_n/acc (B, 12, 256)")
    if b == 0 or n_groups % b:
        raise ValueError(f"{n_groups} groups do not split over {b} images")
    if n_active.shape != (n_groups,):
        raise ValueError("n_active must hold one count per group")
    if th < 1 or tw < 1 or g < 1 or w < 2 * g:
        raise ValueError(f"bad geometry: th={th} tw={tw} g={g} stream width {w}")
    if profile not in (1, 2):
        raise ValueError(f"profile {profile}: the group decoders run profiles 1 and 2")
    tensors = [streams, n_active, bias, hist_n, acc]
    if profile == 2:
        if wcols is None or wcols.shape != (n_groups, N_WROWS, g):
            raise ValueError(f"profile 2 needs wcols of shape {(n_groups, N_WROWS, g)}")
        tensors.append(wcols)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")


def _aligned(t: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    """``t`` as a contiguous tensor of ``dtype`` starting 16-byte aligned."""
    t = t.to(dtype).contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _launch(name, streams, n_active, bias, hist_n, acc, wcols, th, tw, near, g,
            profile) -> torch.Tensor:
    """Launch ``group_decode_kernel`` on CUDA tensors: one CTA a group, CTA
    gi reading table set gi // (G / B).  Returns (G, g, th, tw) uint8."""
    if streams.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {streams.device}")
    if not 1 <= g <= 1024:
        raise ValueError(f"the kernel needs g in 1..1024, got {g}")
    lib = kernels.library()
    smem = lib.nbt_group_decode_smem(tw, g)
    if smem > kernels.SMEM_LIMIT:
        raise ValueError(f"this tile width and g = {g} need {smem} B of shared memory")
    n_active, bias, hist_n, acc = (_aligned(t) for t in (n_active, bias, hist_n, acc))
    wcols = _aligned(wcols) if profile == 2 else None
    # rows of a multiple of 4 words: the kernel stages them by 16-byte copies
    n_groups, w = streams.shape
    words = _aligned(torch.nn.functional.pad(streams, (0, -w % 4)) if w % 4 else streams)
    out = torch.empty((n_groups, th, tw, g), dtype=torch.uint8, device=streams.device)
    rc = lib.nbt_group_decode(
        words.data_ptr(), w, words.shape[1], n_active.data_ptr(), bias.data_ptr(),
        hist_n.data_ptr(), acc.data_ptr(), wcols.data_ptr() if wcols is not None else None,
        n_groups, n_groups // bias.shape[0], g, th, tw, near, profile, out.data_ptr(),
        *kernels.stream_of(streams))
    kernels.check(rc, "nbt_group_decode")
    return out.permute(0, 3, 1, 2)


def decode_groups(streams, n_active, bias, hist_n, acc, wcols, th: int, tw: int,
                  near: int, g: int, profile: int = 1) -> torch.Tensor:
    """Decode interleaved groups of g tile lanes (kernel K2).

    streams: (G, W) int32 u16 stream words, one row per group; n_active:
    (G,) live lanes per group; bias: (B, 3072) int32; hist_n/acc:
    (B, 12, 256) int32, one table set per image, where G = B x groups per
    image; wcols: (G, 16, g) int32 per-lane weights and flag (profile 2;
    unused, and may be None, at profile 1).  Returns (G, g, th, tw) uint8.
    Any g in 1..1024: a g that is not a multiple of 32 (the mesh writes
    such groups) leaves the last warp's threads past g idle.
    """
    _check(streams, n_active, bias, hist_n, acc, wcols, th, tw, g, profile)
    if streams.device.type == "cpu":
        return group_decode_plain(streams, n_active, bias, hist_n, acc, wcols,
                                  th, tw, near, g, profile)
    out = _launch("decode_groups", streams, n_active, bias, hist_n, acc, wcols, th, tw,
                  near, g, profile)
    decode_groups.launches += 1
    return out


decode_groups.launches = 0


def decode_groups8(streams, n_active, bias, hist_n, acc, wcols, th: int, tw: int,
                   near: int, g: int, profile: int = 1) -> torch.Tensor:
    """Decode interleaved groups with one table set per group (kernel K2').

    The contract of ``decode_groups_pallas8``: the tables are per group,
    bias (G, 3072) and hist_n/acc (G, 12, 256), G must be a multiple of 8
    (callers pad with n_active = 0 rows) and 8 g <= 1024.  On the card it
    launches K2's kernel with one table set a CTA; the output is
    bit-identical to :func:`decode_groups`.  Its plain version is
    :func:`group_decode_plain` with one table set per group.
    """
    _check(streams, n_active, bias, hist_n, acc, wcols, th, tw, g, profile)
    n_groups = streams.shape[0]
    if bias.shape[0] != n_groups:
        raise ValueError("decode_groups8 takes one table set per group")
    if n_groups % GROUP_MULTIPLE8:
        raise ValueError(f"{n_groups} groups: decode_groups8 needs a multiple of 8")
    if GROUP_MULTIPLE8 * g > 1024:
        raise ValueError(f"8 groups of {g} lanes exceed 1024 threads")
    if streams.device.type == "cpu":
        return group_decode_plain(streams, n_active, bias, hist_n, acc, wcols,
                                  th, tw, near, g, profile)
    out = _launch("decode_groups8", streams, n_active, bias, hist_n, acc, wcols, th, tw,
                  near, g, profile)
    decode_groups8.launches += 1
    return out


decode_groups8.launches = 0


def group_decode_plain(streams, n_active, bias, hist_n, acc, wcols, th: int,
                       tw: int, near: int, g: int, profile: int = 1,
                       slot_bits: int | None = None) -> torch.Tensor:
    """Plain version of the group decode: a Python loop over the th x tw
    pixel steps, each step vectorized over (groups x lanes).

    The symbol is the count #{v : acc[qd][v] <= lb} - 1; with ``slot_bits``
    it is K2's :func:`slot_search` over :func:`slot_table` instead.
    """
    dev = streams.device
    n_groups = streams.shape[0]
    npg = n_groups // bias.shape[0]
    img = torch.arange(n_groups, device=dev) // npg
    ctx_off = (img * N_CTX)[:, None]  # (G, 1) offset of each group's tables
    bias_f = bias.reshape(-1).to(torch.int32)
    hist_f = hist_n.reshape(-1).to(torch.int64)
    acc_f = acc.reshape(-1).to(torch.int64)
    acc_rows = acc_f.reshape(-1, N_SYM)
    if slot_bits is not None:
        slots = slot_table(acc_rows, slot_bits)
    wcols = wcols.to(torch.int32) if profile == 2 else None

    state, sp = rans.interleaved_dec_init(streams, g)
    active = torch.arange(g, device=dev)[None, :] < n_active[:, None]
    prev1 = torch.zeros((n_groups, g, tw), dtype=torch.int32, device=dev)
    prev2 = torch.zeros_like(prev1)
    rows = []
    for i in range(th):
        regs = row_start_window(i, prev1, prev2, tw)
        err = torch.zeros((n_groups, g), dtype=torch.int32, device=dev)
        row = torch.zeros_like(prev1)
        for j in range(tw):
            px0, qd, adr = pixel_model(regs, err, wcols)
            px, sign = apply_static_bias(bias_f, adr + ctx_off, px0)
            lb = state & rans.NORM_MASK
            slot = ctx_off + qd * N_SYM  # (G, g) start of each lane's acc row
            if slot_bits is None:
                y = (acc_rows[slot // N_SYM] <= lb[..., None]).sum(-1) - 1
            else:
                y = slot_search(acc_rows, slots, slot // N_SYM, lb, slot_bits)
            at = slot + y
            state = (state >> rans.NORM_BITS) * hist_f[at] + lb - acc_f[at]
            state, sp = rans.interleaved_dec_renorm(state, sp, streams, active)
            x = residual_unfold(y.to(torch.int32), px, sign, near)
            err = x - px0
            row[..., j] = x
            regs = slide_window(regs, x, i, j, prev1, prev2, tw)
        rows.append(row)
        prev1, prev2 = row, prev1
    return torch.stack(rows, dim=2).to(torch.uint8)
