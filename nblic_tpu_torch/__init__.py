"""nblic_tpu_torch: the PyTorch / CUDA port of nblic_tpu.

It writes and reads the same NBTC profile-1 and profile-2 containers as
``nblic_tpu``, which stays the reference, and writes its lossless
profile-3 containers (``models/strips.py``).  Plain tensor code
is PyTorch; the kernels are hand-written CUDA for Hopper (``csrc/``): the
rANS encode fold (``ops/fold.py``) and the lockstep group decoders
(``ops/decode.py``).  It imports neither JAX nor anything of ``nblic_tpu``:
it keeps its own ``constants``, ``utils.container`` and ``utils.imageio``.

Public API: :mod:`nblic_tpu_torch.api`.
"""

from .api import compress_tiled, decompress, decompress_tiled  # noqa: F401
