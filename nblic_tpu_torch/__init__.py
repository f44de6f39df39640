"""nblic_tpu_torch: the PyTorch / CUDA port of nblic_tpu.

It writes and reads the same NBTC profile-1 (lossless) containers as
``nblic_tpu``, which stays the reference.  Plain tensor code is PyTorch; the
two kernels of the main path are hand-written CUDA for Hopper (``csrc/``):
the rANS encode fold (``ops/fold.py``) and the lockstep group decode
(``ops/decode.py``).  It never imports JAX: of ``nblic_tpu`` it uses only
``constants``, ``utils.container`` and ``utils.imageio``.

Public API: :mod:`nblic_tpu_torch.api`.
"""

from .api import compress_tiled, decompress, decompress_tiled  # noqa: F401
