"""State carried between the JAX package and this one, and the device rule.

The codec's decode state is, per image, the static bias table and the
normalized histograms with their cumulative tables, plus, per interleave
group, the u16 stream words and (profile 2) each tile lane's quantized
least-squares weights and predictor flag.  Both packages parse containers
into the same numpy arrays; the functions here turn them into this
package's tensors, so a test can feed identical state to both.  Profile 2's
encoder state, the per-tile (weights, flags) that the JAX package fitted,
crosses with :func:`weights_from_numpy`.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.decode import GROUP_MULTIPLE8
from .ops.rans import pad_streams


def resolve_device(device) -> torch.device:
    """The torch device for ``device``; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is false"
        )
    return dev


def tables_from_numpy(bias, hist_n, acc, device="cuda"):
    """Per-image tables -> int32 tensors: bias (B, 3072), hist_n/acc (B, 12, 256).

    Inputs are array-likes of those shapes, or of one image's (3072,) and
    (12, 256), which get a leading image axis.
    """
    dev = resolve_device(device)
    return (
        torch.tensor(np.reshape(bias, (-1, 3072)), dtype=torch.int32, device=dev),
        torch.tensor(np.reshape(hist_n, (-1, 12, 256)), dtype=torch.int32, device=dev),
        torch.tensor(np.reshape(acc, (-1, 12, 256)), dtype=torch.int32, device=dev),
    )


def _bucket(wmax: int) -> int:
    """Stream-matrix width: the longest stream rounded up to 512 words."""
    return -(-max(wmax, 2) // 512) * 512


def streams_from_parsed(parsed, device="cuda"):
    """Parsed containers -> (streams (G, W) int32, n_active (G,) int32).

    ``parsed``: containers parsed by either package (``_Parsed``: ``payload``,
    ``counts``, ``group_size``, ``n_active()``), all with one group size.
    Every group's stream is padded with zeros to one width W >= 2 g, in
    container order.
    """
    dev = resolve_device(device)
    g = parsed[0].group_size
    if any(p.group_size != g for p in parsed):
        raise ValueError("containers with different group sizes")
    wmax = _bucket(max(max(int(p.counts.max()) for p in parsed), 2 * g))
    mat = np.concatenate([pad_streams(p.payload, p.counts, wmax) for p in parsed])
    n_active = np.concatenate([p.n_active() for p in parsed]).astype(np.int32)
    return torch.from_numpy(mat).to(dev), torch.from_numpy(n_active).to(dev)


def wcols_from_parsed(parsed, device="cuda") -> torch.Tensor:
    """Parsed profile-2 containers -> per-group weight columns (G, 16, g) int32.

    Rows 0-11 hold each tile lane's weights, row 12 its flag; pad lanes and
    the spare rows are 0.  Container order, as :func:`streams_from_parsed`.
    """
    dev = resolve_device(device)
    return torch.from_numpy(np.concatenate([p.weight_cols() for p in parsed])).to(dev)


def group_args(parsed, device="cuda", per_group_tables=False) -> tuple:
    """Parsed same-geometry containers -> the arguments of the group
    decoders, ``(streams, n_active, bias, hist_n, acc, wcols, th, tw, near,
    g, profile)``; ``wcols`` is None at profile 1.

    With ``per_group_tables`` (the contract of ``decode_groups8``) every
    group gets its image's tables, and the groups are padded to a multiple
    of 8 with n_active = 0 rows (zero streams, the first image's tables).
    """
    dev = resolve_device(device)
    hdr = parsed[0].hdr
    bias, hist_n, acc = tables_from_numpy(
        np.stack([p.bias for p in parsed]), np.stack([p.hist_n for p in parsed]),
        np.stack([p.acc for p in parsed]), dev,
    )
    words, n_active = streams_from_parsed(parsed, dev)
    wcols = wcols_from_parsed(parsed, dev) if hdr.profile == 2 else None
    if per_group_tables:
        n_groups = words.shape[0]
        pad = -n_groups % GROUP_MULTIPLE8
        sets = torch.cat([torch.arange(n_groups, device=dev) // len(parsed[0].counts),
                          torch.zeros(pad, dtype=torch.int64, device=dev)])
        bias, hist_n, acc = bias[sets], hist_n[sets], acc[sets]
        words = torch.cat([words, words.new_zeros((pad, words.shape[1]))])
        n_active = torch.cat([n_active, n_active.new_zeros(pad)])
        if wcols is not None:
            wcols = torch.cat([wcols, wcols.new_zeros((pad,) + wcols.shape[1:])])
    return (words, n_active, bias, hist_n, acc, wcols, hdr.tile_h, hdr.tile_w,
            hdr.near, parsed[0].group_size, hdr.profile)


def weights_from_numpy(w_q, flags, device="cuda"):
    """Per-tile profile-2 state, w_q (B, T, 12) and flags (B, T) arrays ->
    int32 tensors of those shapes."""
    dev = resolve_device(device)
    return (torch.tensor(np.asarray(w_q), dtype=torch.int32, device=dev),
            torch.tensor(np.asarray(flags), dtype=torch.int32, device=dev))
