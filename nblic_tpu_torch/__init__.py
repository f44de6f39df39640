"""nblic_tpu_torch: the PyTorch / CUDA port of nblic_tpu.

It writes and reads the same containers as ``nblic_tpu``, which stays the
reference: NBTC profiles 1-3 (``models/tiled.py``, ``models/strips.py``)
and the reference codec's Q0.2 and NBLIC0.3 (``models/qnblic.py``,
``models/nblic.py``, and ``runtime/``, its own copy of the C++ host
runtime).  Plain tensor code is PyTorch; the kernels are hand-written CUDA
for Hopper (``csrc/``): the rANS encode fold (``ops/fold.py``) and the
lockstep group decoders (``ops/decode.py``).  It imports neither JAX nor
anything of ``nblic_tpu``: it keeps its own ``constants``,
``utils.container``, ``utils.imageio`` and ``runtime``.

Public API: :mod:`nblic_tpu_torch.api`.
"""

from .api import compress, compress_tiled, decompress, decompress_tiled  # noqa: F401
