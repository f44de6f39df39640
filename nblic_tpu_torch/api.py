"""Public API of nblic_tpu_torch, the PyTorch / CUDA port of nblic_tpu.

``compress_tiled`` / ``decompress_tiled`` write and read the tile-parallel
``NBTC`` container (profile 1, lossless), byte-identical to ``nblic_tpu``.
``decompress`` sniffs the container magic.  Every entry takes ``device``,
"cuda" by default; asking for CUDA where there is none raises.
"""

from __future__ import annotations

import numpy as np

from nblic_tpu.utils.container import sniff_format

from .models import tiled


def compress_tiled(img: np.ndarray, near: int = 0, device="cuda", **kwargs) -> bytes:
    """Encode with the tile-parallel engine (NBTC container)."""
    return tiled.encode(img, near=near, device=device, **kwargs)


def decompress_tiled(stream: bytes, device="cuda") -> np.ndarray:
    """Decode an NBTC container."""
    return tiled.decode(stream, device=device)


def decompress(stream: bytes, device="cuda") -> np.ndarray:
    """Decode any container this port reads (NBTC so far)."""
    if sniff_format(stream) == "nbtc":
        return decompress_tiled(stream, device=device)
    raise NotImplementedError(
        "the interop containers (Q0.2, NBLIC0.3) are not ported yet: "
        "ROADMAP Queue 1 item 13"
    )
