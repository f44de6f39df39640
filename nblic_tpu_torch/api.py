"""Public API of nblic_tpu_torch, the PyTorch / CUDA port of nblic_tpu.

Two families of entry points, the same as ``nblic_tpu``'s:

- ``compress`` / ``decompress``: the interop containers of the reference
  codec, ``Q0.2`` at effort 0 and ``NBLIC0.3`` at efforts 1-3, byte for
  byte the reference's.  ``backend="torch"`` (the default) runs the device
  engines (``models/qnblic.py``, ``models/nblic.py``) on ``device``: on a
  card their serial walks are kernel K6, one launch an image (PERF.md
  gives their times); ``backend="native"`` runs the port's copy of the
  C++ host runtime (``runtime/``), the fast path.  ``nblic_tpu`` defaults
  to its native runtime; the port defaults to the card, as every one of
  its entry points does.
- ``compress_tiled`` / ``decompress_tiled``: the ``NBTC`` container, the
  same format as ``nblic_tpu`` (see ``models/tiled.py`` for where the bytes
  may differ at effort 2): profile 1 at effort 0-1, profile 2 at effort 2
  and profile 3 (the strip engine) at effort 3, each lossless or, with
  ``near`` > 0, near-lossless.  The decoders read every profile-3
  container the JAX package writes or reads.

``decompress`` sniffs the container magic.  Every entry takes ``device``,
"cuda" by default; asking for CUDA where there is none raises, and nothing
falls back to another device or backend.
"""

from __future__ import annotations

import numpy as np

from .constants import EFFORTS, MAX_NEAR
from .models import tiled
from .utils.container import check_size, sniff_format

BACKENDS = ("torch", "native")


def _validate(img: np.ndarray, near: int, effort: int):
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 2:
        raise ValueError("expected a 2-D gray-8 image")
    check_size(*img.shape)
    if not 0 <= near <= MAX_NEAR:
        raise ValueError(f"near must be in 0..{MAX_NEAR}")
    if effort not in EFFORTS:
        raise ValueError(f"effort must be one of {EFFORTS}")
    if near > 0 and effort == 0:
        effort = 1  # near > 0 needs the effort >= 1 engine, as in the reference
    return img, near, effort


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")


def compress(img: np.ndarray, near: int = 0, effort: int = 1, backend: str = "torch",
             device="cuda", n_threads: int = 0) -> bytes:
    """Encode a gray-8 image into an interop container: Q0.2 where near and
    effort are 0, else NBLIC0.3.  ``n_threads`` is the native effort-0
    encoder's (0: automatic)."""
    img, near, effort = _validate(img, near, effort)
    _check_backend(backend)
    if backend == "native":
        from . import runtime

        if near == 0 and effort == 0:
            return runtime.q_encode(img, n_threads=n_threads)
        return runtime.n_encode(img, near=near, effort=effort)
    if near == 0 and effort == 0:
        from .models import qnblic

        return qnblic.encode(img, device=device)
    from .models import nblic

    return nblic.encode(img, near=near, effort=effort, device=device)


def decompress(stream: bytes, backend: str = "torch", device="cuda") -> np.ndarray:
    """Decode any container of the format family: NBTC (on ``device``,
    whatever the backend), Q0.2 or NBLIC0.3."""
    fmt = sniff_format(stream)
    if fmt == "nbtc":
        return decompress_tiled(stream, device=device)
    _check_backend(backend)
    if backend == "native":
        from . import runtime

        return runtime.q_decode(stream) if fmt == "qnblic" else runtime.n_decode(stream)[0]
    if fmt == "qnblic":
        from .models import qnblic

        return qnblic.decode(stream, device=device)
    from .models import nblic

    return nblic.decode(stream, device=device)


def compress_tiled(img: np.ndarray, near: int = 0, device="cuda", **kwargs) -> bytes:
    """Encode into an NBTC container; ``effort=2`` selects profile 2
    (per-tile least-squares predictors), ``effort=3`` profile 3 (the
    adaptive strip engine), ``near`` > 0 near-lossless coding with max error
    ``near``."""
    return tiled.encode(img, near=near, device=device, **kwargs)


def decompress_tiled(stream: bytes, device="cuda") -> np.ndarray:
    """Decode an NBTC container."""
    return tiled.decode(stream, device=device)
