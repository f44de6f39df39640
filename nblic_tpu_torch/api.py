"""Public API of nblic_tpu_torch, the PyTorch / CUDA port of nblic_tpu.

``compress_tiled`` / ``decompress_tiled`` write and read the ``NBTC``
container, the same format as ``nblic_tpu`` (see ``models/tiled.py`` for
where the bytes may differ at effort 2): profile 1 at effort 0-1 and
profile 2 at effort 2 and profile 3 (the strip engine) at effort 3, each
lossless or, with ``near`` > 0, near-lossless.  The decoders read every
profile-3 container the JAX package writes or reads.
``decompress`` sniffs the container magic.  Every entry takes ``device``,
"cuda" by default; asking for CUDA where there is none raises.
"""

from __future__ import annotations

import numpy as np

from .models import tiled
from .utils.container import sniff_format


def compress_tiled(img: np.ndarray, near: int = 0, device="cuda", **kwargs) -> bytes:
    """Encode into an NBTC container; ``effort=2`` selects profile 2
    (per-tile least-squares predictors), ``effort=3`` profile 3 (the
    adaptive strip engine), ``near`` > 0 near-lossless coding with max error
    ``near``."""
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
