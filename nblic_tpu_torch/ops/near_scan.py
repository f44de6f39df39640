"""The tiled near-lossless feedback scan: kernel K7 (``csrc/near_scan.cu``)
and its plain version.

Counterpart of ``nblic_tpu/models/tiled.py::_tile_encode_scan``, which the
JAX package runs as a ``jax.vmap`` of a nested ``lax.scan`` (no
``pallas_call``).  ``encode_scan`` has the contract of
:func:`encode_scan_plain`.  A CPU tensor runs the plain version; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from .. import kernels
from ..constants import MAX_VAL, Q_N_CONTEXT
from .context import apply_static_bias, residual_fold, residual_unfold
from .decode import N_WROWS, _aligned
from .window import pixel_model, row_start_window, slide_window



def encode_scan_plain(x, bias, wcols, th: int, tw: int, near: int, profile: int,
                      stats: bool = False):
    """Near-lossless modeling scan with reconstruction feedback, in lockstep
    over every tile of every image: the plain version of K7.

    x: (B, T, th, tw) int32 pixels; bias: (B, 3072) int32, one table per
    image; wcols: (B, 16, T) int32 per-tile weights and flag (profile 2;
    ignored at profile 1).  Every lane walks its tile in raster order and
    slides its window over *reconstructed* pixels, so the decoder replays
    the same chain: the loop of ``ops/decode.py::group_decode_plain``, with
    a fold where the decoder reads a symbol.  ``i`` and ``j`` are Python
    ints and nothing in the loop reads a value back from the device.

    Returns (y, qd), (B, T, th, tw) int32 planes; ``stats=True`` adds (adr,
    x - px0, x_rec): each pixel's context address (within its image's
    table), the error of the *original* pixel against the unbiased
    prediction, which the bias refit averages, and the reconstruction.
    The chain's own error, x_rec - px0, feeds the next pixel's activity.
    """
    b, t = x.shape[:2]
    dev = x.device
    xs = x.permute(2, 3, 0, 1).contiguous()  # (th, tw, B, T): a step reads one slab
    off = (torch.arange(b, dtype=torch.int32, device=dev) * Q_N_CONTEXT).view(b, 1)
    bias_f = bias.reshape(-1)
    wcols = wcols if profile == 2 else None
    prev1 = torch.zeros((b, t, tw), dtype=torch.int32, device=dev)
    prev2 = torch.zeros_like(prev1)
    outs = []
    for i in range(th):
        regs = row_start_window(i, prev1, prev2, tw)
        err = torch.zeros((b, t), dtype=torch.int32, device=dev)
        row = []
        for j in range(tw):
            px0, qd, adr = pixel_model(regs, err, wcols)
            px, sign = apply_static_bias(bias_f, adr + off, px0)
            x_orig = xs[i, j]
            y = residual_fold(x_orig, px, sign, near)
            x_rec = residual_unfold(y, px, sign, near)
            err = x_rec - px0
            row.append(x_rec)
            outs.append((y, qd, adr, x_orig - px0, x_rec) if stats else (y, qd))
            regs = slide_window(regs, x_rec, i, j, prev1, prev2, tw)
        prev1, prev2 = torch.stack(row, dim=-1), prev1
    return tuple(torch.stack(plane, dim=-1).view(b, t, th, tw) for plane in zip(*outs))


def _check(x, bias, wcols, th, tw, near, profile):
    if x.dim() != 4 or x.shape[2:] != (th, tw):
        raise ValueError(f"x must be (B, T, {th}, {tw}), got {tuple(x.shape)}")
    b, t = x.shape[:2]
    if bias.shape != (b, Q_N_CONTEXT) or bias.dtype != torch.int32:
        raise ValueError(f"bias must be ({b}, {Q_N_CONTEXT}) int32, got "
                         f"{tuple(bias.shape)} {bias.dtype}")
    if not 1 <= near <= MAX_VAL:  # the header keeps near in one byte
        raise ValueError(f"the feedback scan serves near in 1..{MAX_VAL}, got {near}")
    if profile not in (1, 2):
        raise ValueError(f"profile {profile}: the feedback scan runs profiles 1 and 2")
    tensors = [x, bias]
    if profile == 2:
        if wcols is None or wcols.shape != (b, N_WROWS, t):
            raise ValueError(f"profile 2 needs wcols of shape {(b, N_WROWS, t)}")
        tensors.append(wcols)
    devices = {v.device for v in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"encode_scan runs on cpu or cuda, not {x.device}")
    if x.device.type == "cpu":
        # the container's int16 tables; on the card the check would read the
        # table back, and K7 holds it as int32, exact for any values
        kernels.check_int16(bias)


def encode_scan(x, bias, wcols, th: int, tw: int, near: int, profile: int,
                stats: bool = False):
    """The feedback scan (kernel K7); see :func:`encode_scan_plain`.

    ``near`` in 1..255 (the scan serves near-lossless modes only); bias is
    int32 with values in int16, as the container stores them (every table
    the encoder builds lies in [-2048, 2047]); anything else raises, but
    values outside int16, which the card takes as they are (checking them
    there would read the table back).  On the card the kernel reads x in
    its own (B, T, th, tw) layout, each lane its tile's contiguous pixels,
    and writes its planes in that layout: an int32 contiguous x is not
    copied, and nothing is read back.
    """
    _check(x, bias, wcols, th, tw, near, profile)
    if x.device.type == "cpu":
        return encode_scan_plain(x, bias, wcols, th, tw, near, profile, stats)
    x = x.to(torch.int32).contiguous()
    outs = [torch.empty_like(x) for _ in range(5 if stats else 2)]
    if x.numel():
        launch(x, bias, wcols, near, profile, outs)
        encode_scan.launches += 1
    return tuple(outs)


encode_scan.launches = 0


@functools.cache
def _smem(tw: int) -> int:
    """Shared memory of a K7 CTA at tile width ``tw``, either chunking."""
    lib = kernels.library()
    return max(lib.nbt_near_scan_smem(tw, 8), lib.nbt_near_scan_smem(tw, 1))


def launch(x, bias, wcols, near: int, profile: int, outs) -> None:
    """K7 alone, without the wrapper's checks: the scan of the (B, T, th,
    tw) int32 contiguous CUDA tiles ``x`` into ``outs``, two (y, qd) or five
    (with the statistics) planes of its shape.  :func:`encode_scan` calls
    it; it counts no launch."""
    b, t, th, tw = x.shape
    lib = kernels.library()
    smem = _smem(tw)
    if smem > kernels.SMEM_LIMIT:
        raise ValueError(f"tile width {tw} needs {smem} B of shared memory a CTA")
    bias_a = _aligned(bias)
    wcols_a = _aligned(wcols) if profile == 2 else None
    ptrs = [o.data_ptr() for o in outs] + [None] * (5 - len(outs))
    rc = lib.nbt_near_scan(
        x.data_ptr(), bias_a.data_ptr(), wcols_a.data_ptr() if wcols_a is not None else None,
        b, t, th, tw, near, profile, *ptrs, *kernels.stream_of(x))
    kernels.check(rc, "nbt_near_scan")
