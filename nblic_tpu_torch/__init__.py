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

Public API: :mod:`nblic_tpu_torch.api`; the subpackages load at first use.
"""

from .api import (  # noqa: F401
    EFFORTS,
    MAX_NEAR,
    compress,
    compress_tiled,
    decompress,
    decompress_tiled,
)

__version__ = "0.1.0"

_SUBPACKAGES = ("models", "ops", "parallel", "runtime", "utils")


def __getattr__(name):
    """The subpackages, imported at first use (``nblic_tpu_torch.parallel``)."""
    if name in _SUBPACKAGES:
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
