"""Lockstep group decode: kernel K2 (``csrc/group_decode.cu``) and its
plain version.

Counterpart of ``nblic_tpu/ops/pallas_decode.py`` (profile-1 branch) and of
``nblic_tpu/models/tiled.py::_group_decode_scan``.  A CPU tensor runs
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
SMEM_LIMIT = 232448  # bytes of shared memory one Hopper CTA may use


def _check(streams, n_active, bias, hist_n, acc, th, tw, g):
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
    devices = {t.device for t in (streams, n_active, bias, hist_n, acc)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")


def decode_groups(streams, n_active, bias, hist_n, acc, th: int, tw: int,
                  near: int, g: int) -> torch.Tensor:
    """Decode interleaved groups of g tile lanes.

    streams: (G, W) int32 u16 stream words, one row per group; n_active:
    (G,) live lanes per group; bias: (B, 3072) int32; hist_n/acc:
    (B, 12, 256) int32, one table set per image, where G = B x groups per
    image.  Returns (G, g, th, tw) uint8 tiles.
    """
    _check(streams, n_active, bias, hist_n, acc, th, tw, g)
    if streams.device.type == "cpu":
        return group_decode_plain(streams, n_active, bias, hist_n, acc,
                                  th, tw, near, g)
    if streams.device.type != "cuda":
        raise ValueError(f"decode_groups runs on cpu or cuda, not {streams.device}")
    if g % 32 or g > 1024:
        raise ValueError(f"the kernel needs g a multiple of 32 up to 1024, got {g}")
    lib = kernels.library()
    smem = lib.nbt_group_decode_smem(tw, g)
    if smem > SMEM_LIMIT:
        raise ValueError(f"tile width {tw} x {g} lanes needs {smem} B of shared memory")
    n_groups, w = streams.shape
    streams = streams.to(torch.int32).contiguous()
    n_active = n_active.to(torch.int32).contiguous()
    bias = bias.to(torch.int32).contiguous()
    hist_n = hist_n.to(torch.int32).contiguous()
    acc = acc.to(torch.int32).contiguous()
    out = torch.empty((n_groups, th, tw, g), dtype=torch.uint8, device=streams.device)
    dev, stream = kernels.stream_of(streams)
    rc = lib.nbt_group_decode(
        streams.data_ptr(), w, n_active.data_ptr(), bias.data_ptr(),
        hist_n.data_ptr(), acc.data_ptr(), n_groups, n_groups // bias.shape[0],
        g, th, tw, near, out.data_ptr(), dev, stream,
    )
    kernels.check(rc, "group_decode")
    decode_groups.launches += 1
    return out.permute(0, 3, 1, 2)


decode_groups.launches = 0


def group_decode_plain(streams, n_active, bias, hist_n, acc, th: int, tw: int,
                       near: int, g: int) -> torch.Tensor:
    """Plain version of the group decode: a Python loop over the th x tw
    pixel steps, each step vectorized over (groups x lanes)."""
    dev = streams.device
    n_groups = streams.shape[0]
    npg = n_groups // bias.shape[0]
    img = torch.arange(n_groups, device=dev) // npg
    ctx_off = (img * N_CTX)[:, None]  # (G, 1) offset of each group's tables
    bias_f = bias.reshape(-1).to(torch.int32)
    hist_f = hist_n.reshape(-1).to(torch.int64)
    acc_f = acc.reshape(-1).to(torch.int64)
    acc_rows = acc_f.reshape(-1, N_SYM)

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
            px0, qd, adr = pixel_model(regs, err)
            px, sign = apply_static_bias(bias_f, adr + ctx_off, px0)
            lb = state & rans.NORM_MASK
            slot = ctx_off + qd * N_SYM  # (G, g) start of each lane's acc row
            y = (acc_rows[slot // N_SYM] <= lb[..., None]).sum(-1) - 1
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
