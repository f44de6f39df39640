"""The encode fold: kernel K1 (``csrc/rans_fold.cu``) and its dispatch.

Counterpart of ``nblic_tpu/ops/pallas_fold.py``.  ``encode_fold`` has the
contract of :func:`rans.encode_scan`.  A CPU tensor runs the plain version,
``rans.encode_scan``; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from .. import kernels
from . import rans


def encode_fold(freq: torch.Tensor, facc: torch.Tensor):
    """Lockstep rANS encode of S streams; see :func:`rans.encode_scan`.

    freq/facc: (S, L), freq in [1, 2^15].  The kernel reads an (L, S) layout:
    a caller that builds the tables as ``t.t()`` of an (L, S) tensor saves
    the transpose.  Returns (words (S, L) int32, emits (S, L) bool, state
    (S,) int64), fold order along L.
    """
    if freq.shape != facc.shape or freq.dim() != 2:
        raise ValueError(f"freq/facc must be equal (S, L): {freq.shape}, {facc.shape}")
    if freq.device != facc.device:
        raise ValueError("freq and facc lie on different devices")
    if freq.device.type == "cpu":
        return rans.encode_scan(freq, facc)
    if freq.device.type != "cuda":
        raise ValueError(f"encode_fold runs on cpu or cuda, not {freq.device}")
    s, l = freq.shape
    freq_ls = freq.t().to(torch.int32).contiguous()
    facc_ls = facc.t().to(torch.int32).contiguous()
    out = torch.empty((l, s), dtype=torch.int32, device=freq.device)
    state = torch.full((s,), rans.ANS_LOW_BOUND, dtype=torch.int32,
                       device=freq.device)
    if s > 0:
        dev, stream = kernels.stream_of(freq)
        rc = kernels.library().nbt_rans_fold(
            freq_ls.data_ptr(), facc_ls.data_ptr(), out.data_ptr(),
            state.data_ptr(), s, l, dev, stream,
        )
        kernels.check(rc, "rans_fold")
        encode_fold.launches += 1
    fold = out.t()  # rows of `out` are fold steps
    return fold & rans.ANS_MASK, (fold >> 16) != 0, state.to(torch.int64) & rans.U32_MASK


encode_fold.launches = 0
