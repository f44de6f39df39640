"""The profile-3 near-lossless feedback walk on the card: kernel K5
(``csrc/p3_near_walk.cu``), one launch a row.

Counterpart of a row of ``nblic_tpu/models/strips.py::_near_rows``, which
the JAX package runs as a jitted ``lax.scan`` (no ``pallas_call``).  The
plain version is ``models/strips.py::_near_walk_plain``; the dispatcher
``strips._near_walk`` takes it for a CPU tensor and runs the row loop
around :func:`launch_row` for a CUDA tensor (``strips._near_walk_card``).
K5 runs one warp a lane, so a lane's channels are contiguous: B and its F
scratch (L, W, m), the mix B (L, W, 2); the rows and the planes stay lanes
fastest, (W, L).  :func:`solve_systems` runs the kernel's warp chain alone
(the solve and the prediction), for its tests.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..constants import MAX_VAL, Q_N_CONTEXT

N_FEAT = 10      # the feature count K5 is built for (strips.AVP_N)
N_PLANES = 5     # y, qu, qv, qw, key
CTA_WARPS = 2    # lanes (warps) a CTA, 1 to 4


def _check(x_row, bias, prev1, prev2, b, f, b_mix, f_mix, out, idx, dx, i, near, n_feat):
    if n_feat != N_FEAT:
        raise ValueError(f"K5 is built for {N_FEAT} AVP features, got {n_feat}")
    if not 1 <= near <= MAX_VAL:  # the header keeps near in one byte
        raise ValueError(f"the feedback walk serves near in 1..{MAX_VAL}, got {near}")
    if x_row.dim() != 2:
        raise ValueError(f"x_row must be (W, L), got {tuple(x_row.shape)}")
    w, lanes = x_row.shape
    m = 1 + n_feat + n_feat * n_feat
    want = {"x_row": (x_row, (w, lanes), torch.uint8),
            "prev1": (prev1, (w, lanes), torch.uint8),
            "prev2": (prev2, (w, lanes), torch.uint8),
            "b": (b, (lanes, w, m), torch.int64), "f": (f, (lanes, w, m), torch.int64),
            "idx": (idx, (w, lanes), torch.int64), "dx": (dx, (w, lanes), torch.int64)}
    if (b_mix is None) != (f_mix is None):
        raise ValueError("b_mix and f_mix come together (mix_e) or not at all")
    if b_mix is not None:
        want["b_mix"] = (b_mix, (lanes, w, 2), torch.int64)
        want["f_mix"] = (f_mix, (lanes, w, 2), torch.int64)
    if out.dim() != 4 or out.shape[0] != N_PLANES or out.shape[2:] != (w, lanes) \
            or not 0 <= i < out.shape[1]:
        raise ValueError(f"out must be ({N_PLANES}, th, {w}, {lanes}) with row {i} in it, "
                         f"got {tuple(out.shape)}")
    want["out"] = (out, tuple(out.shape), torch.int32)
    n_imgs, rem = divmod(bias.numel(), Q_N_CONTEXT)
    if bias.dim() != 1 or bias.dtype not in (torch.int16, torch.int32) or rem or not n_imgs \
            or lanes % n_imgs:
        raise ValueError(f"bias must be (n_images * {Q_N_CONTEXT},) int16 or int32 with the "
                         f"lanes {lanes} a multiple of n_images, got {tuple(bias.shape)} "
                         f"{bias.dtype}")
    want["bias"] = (bias, tuple(bias.shape), bias.dtype)
    kernels.check_tensors(want, x_row.device, "K5")
    kernels.check_int16(bias)  # the kernel reads the table as int16
    return lanes // n_imgs


def launch_row(x_row, bias, prev1, prev2, b, f, b_mix, f_mix, out, idx, dx, i: int,
               near: int, n_feat: int = N_FEAT) -> None:
    """Row ``i`` of the feedback walk for every lane (kernel K5).

    x_row: (W, L) uint8 originals of row i; bias: (n_images * 3072,)
    row-frozen tables, int16, or int32 with values in int16 (checked, at
    the cost of a readback, and cast), L a multiple of n_images,
    image-major;
    prev1 / prev2: (W, L) uint8 reconstructed rows i-1 and i-2, row i
    written into ``prev2``; b: (L, W, m) int64 column moments, updated in
    place, f its (L, W, m) scratch; b_mix / f_mix the same at (L, W, 2)
    under mix_e, else None; out: (5, th, W, L) int32 planes (y, qu, qv, qw,
    key), row i written; idx / dx: (W, L) int64, each pixel's image x 3072
    + context address and xr - px0, for the bias moments.  Everything lies
    on one CUDA device, contiguous; anything else raises.  Launches on the
    current stream and counts the launch.
    """
    lanes_per_image = _check(x_row, bias, prev1, prev2, b, f, b_mix, f_mix, out, idx, dx, i,
                             near, n_feat)
    w, lanes = x_row.shape
    if not x_row.numel():
        return
    th = out.shape[1]
    lib = kernels.library()
    mix = b_mix is not None
    bias16 = bias.to(torch.int16)
    rc = lib.nbt_p3_near_row(
        x_row.data_ptr(), bias16.data_ptr(), prev1.data_ptr(), prev2.data_ptr(),
        b.data_ptr(), f.data_ptr(), b_mix.data_ptr() if mix else None,
        f_mix.data_ptr() if mix else None, lanes, lanes_per_image, w, i, near, n_feat,
        th * w * lanes, out[0, i].data_ptr(), idx.data_ptr(), dx.data_ptr(), CTA_WARPS,
        *kernels.stream_of(x_row))
    kernels.check(rc, "nbt_p3_near_row")
    launch_row.launches += 1


launch_row.launches = 0


def solve_systems(a, b, feats):
    """K5's warp chain alone on the card: one warp a system solves the
    (n, n, P) int64 matrices ``a`` with the (n, P) right-hand sides ``b``
    and predicts from the (n, P) features, as ``avp.solve_batch`` and
    ``avp.predict_from_solve`` lay them out, n in 1..12.  Returns (diag,
    num, ok, px): the solve's diagonal and numerators (n, P), ok (P,) bool
    and the FB1 fixed-point prediction (P,).  A test entry: no walk calls
    it."""
    n, _, p = a.shape
    if not 1 <= n <= 12 or a.shape != (n, n, p) or b.shape != (n, p) \
            or feats.shape != (n, p):
        raise ValueError(f"a must be (n, n, P), b and feats (n, P) with n in 1..12, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, {tuple(feats.shape)}")
    dev = a.device
    full = torch.cat([a, b[:, None]], 1).permute(2, 0, 1).to(torch.int64).contiguous()
    f32 = feats.t().to(torch.int32).contiguous()
    diag = torch.empty((p, n), dtype=torch.int64, device=dev)
    num = torch.empty_like(diag)
    ok = torch.empty(p, dtype=torch.int32, device=dev)
    px = torch.empty(p, dtype=torch.int64, device=dev)
    kernels.check_tensors({"a": (full, (p, n, n + 1), torch.int64),
                           "feats": (f32, (p, n), torch.int32)}, dev, "K5's chain")
    rc = kernels.library().nbt_avp_solve(full.data_ptr(), f32.data_ptr(), n, p,
                                         diag.data_ptr(), num.data_ptr(), ok.data_ptr(),
                                         px.data_ptr(), *kernels.stream_of(full))
    kernels.check(rc, "nbt_avp_solve")
    return diag.t(), num.t(), ok.bool(), px
