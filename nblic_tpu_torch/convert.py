"""State carried between the JAX package and this one, and the device rule.

The codec has no weights.  Its decode state is, per image, the static bias
table and the normalized histograms with their cumulative tables, plus, per
interleave group, the u16 stream words.  Both packages parse containers into
the same numpy arrays; the functions here turn them into this package's
tensors, so a test can feed identical state to both.
"""

from __future__ import annotations

import numpy as np
import torch

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
    """Parsed profile-1 containers -> (streams (G, W) int32, n_active (G,) int32).

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
