"""The profile-3 coding scan on the card: kernel K8 (``csrc/p3_row_scan.cu``),
one launch a scan.

Counterpart of ``nblic_tpu/models/strips.py::_code_impl``'s row and segment
scans and of ``_row_code`` inside ``_near_rows``, which the JAX package runs
as jitted ``lax.scan``s (no ``pallas_call``).  The plain versions are
``models/strips.py::_row_scan_plain`` (the lossless encoder) and
``_near_code_plain`` (the near-lossless encoder's row coder); the
dispatchers ``strips._row_scan`` and ``strips._near_code`` take them for a
CPU tensor and :func:`scan` for a CUDA tensor.  K8 keeps every table on the
card for the whole scan: an image's bias moments and mapper history in its
CTA's shared memory, each lane's counter tables and their sweep marks there
too where they fit, else in the scratch tensors made here.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..constants import MAX_VAL, Q_N_CONTEXT
from . import coder3, zcodec3
from .decode_walk import MAX_UNARY, REFINE_CELLS

L_R = zcodec3.ESCAPE_BITS  # refinement and escape layers after the unary ones


def contract(tune, k_step: int, near: bool, lanes_per_image: int, th: int, w: int,
             n_seg: int) -> list[int]:
    """The 57 ints of K8's contract: ``tune`` the replay contract
    (``strips.Tune``), ``n_seg`` the effective segments a row
    (``strips._eff_seg``); the near coder keeps the mapper row-frozen and
    has no bias."""
    lc = zcodec3.layer_consts(k_step, tune.n_unary)
    pad = (0,) * (MAX_UNARY - tune.n_unary)
    seg_bias = int(bool(tune.seg_bias) and n_seg > 1 and not near)
    seg_map = int(bool(tune.seg_map) and n_seg > 1 and not near)
    return [int(near), lanes_per_image, th, w, w // n_seg, tune.n_unary, k_step, lc.n_class,
            seg_bias, seg_map, int(bool(tune.sym_cnt)), tune.cnt_init, tune.cnt_halve,
            tune.bias_cap, tune.bias_shrink, tune.map_bump, tune.map_halve,
            *lc.esc_counts, *pad, *lc.cls_vals, *pad]


def _ranges(near: bool) -> list[tuple[int, int]]:
    """Each plane's values, as K8 indexes its tables with them."""
    head = [(0, zcodec3.N_ROW - 1), (0, zcodec3.N_ROW - 1), (0, coder3.QW_MAX)]
    if near:
        return head + [(0, MAX_VAL), (0, coder3.MAP_KEYS - 1)]
    return head + [(0, MAX_VAL), (0, MAX_VAL), (0, Q_N_CONTEXT - 1)]


def _check(planes, n_imgs: int, n_seg: int, near: bool):
    n_planes = 5 if near else 6
    if len(planes) != n_planes:
        raise ValueError(f"the {'near coder' if near else 'row scan'} takes {n_planes} planes, "
                         f"got {len(planes)}")
    shape = tuple(planes[0].shape)
    for p in planes:
        if p.dim() != 3 or tuple(p.shape) != shape:
            raise ValueError(f"the planes must be equal (L, th, W), got {tuple(p.shape)} "
                             f"beside {shape}")
        if p.dtype.is_floating_point or p.dtype.is_complex or p.dtype == torch.bool:
            raise ValueError(f"the planes must be integer tensors, got {p.dtype}")
    lanes = shape[0]
    if n_imgs < 1 or lanes % n_imgs:
        raise ValueError(f"{lanes} lanes do not split into {n_imgs} images")
    if n_seg < 1 or shape[2] % n_seg:
        raise ValueError(f"{n_seg} segments do not split a row of {shape[2]}")
    dev = planes[0].device
    if dev.type != "cuda" or any(p.device != dev for p in planes):
        raise ValueError(f"K8 runs on one CUDA device, got {[str(p.device) for p in planes]}")
    return shape


def scan(planes, n_imgs: int, tune, k_step: int, n_seg: int, near: bool):
    """The coding scan of (L, th, W) planes, L = n_imgs strips of each image,
    image-major: ``planes`` (qu, qv, qw, x, px0, adr) for the lossless row
    scan, (qu, qv, qw, y, key) for the near coder (``near``).  ``n_seg`` is
    the effective segment count, ``k_step`` the escalation step.  Returns
    (probs int16, bins int8, masks bool), each (th, n_unary + L_R, L, W), as
    ``strips._row_scan_plain`` / ``_near_code_plain`` return them.  Raises
    ValueError on planes K8 cannot take, before any launch."""
    n_l, th, w = _check(planes, n_imgs, n_seg, near)
    dev = planes[0].device
    bad = torch.stack([((p < lo) | (p > hi)).any()
                       for p, (lo, hi) in zip(planes, _ranges(near))])
    if bool(bad.any()):
        raise ValueError("a plane holds values outside the range the coding model gives it")
    stack = torch.stack([p.to(torch.int32) for p in planes])
    con = contract(tune, k_step, near, n_l // n_imgs, th, w, n_seg)
    l_tot = tune.n_unary + L_R
    probs = torch.empty((th, l_tot, n_l, w), dtype=torch.int16, device=dev)
    bins = torch.empty((th, l_tot, n_l, w), dtype=torch.int8, device=dev)
    masks = torch.empty((th, l_tot, n_l, w), dtype=torch.bool, device=dev)
    utab = torch.empty((n_l, zcodec3.N_ROW * con[7] * 2), dtype=torch.int32, device=dev)
    rtab = torch.empty((n_l, REFINE_CELLS), dtype=torch.int32, device=dev)
    umark = torch.empty((n_l, -(-(zcodec3.N_ROW * con[7] + REFINE_CELLS // 2) // 32)),
                        dtype=torch.int32, device=dev)
    keep = torch.empty((n_l, w), dtype=torch.int32, device=dev)
    if probs.numel() == 0:
        return probs, bins, masks
    ints = torch.tensor(con, dtype=torch.int32)
    d, stream = kernels.stream_of(stack)
    rc = kernels.library().nbt_p3_row_scan(
        stack.data_ptr(), probs.data_ptr(), bins.data_ptr(), masks.data_ptr(), utab.data_ptr(),
        rtab.data_ptr(), umark.data_ptr(), keep.data_ptr(), n_l, n_imgs, ints.data_ptr(), d,
        stream)
    kernels.check(rc, "p3_row_scan")
    scan.launches += 1
    return probs, bins, masks


scan.launches = 0
