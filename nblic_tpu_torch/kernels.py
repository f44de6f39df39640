"""Build and bind the hand-written CUDA kernels in ``csrc/``.

The sources compile with ``nvcc`` for ``sm_90a`` (Hopper) into ONE shared
library with a plain C interface, loaded with ``ctypes``.  The build runs at
first use, into ``build/nblic_tpu_torch/`` beside the package; the library's
name carries a hash of the sources and flags, so an edited source rebuilds.
Every C entry launches on the caller's stream and returns
``cudaGetLastError()``; :func:`check` raises on a nonzero code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "nblic_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libnblic_kernels_{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless a library for these sources exists.

    ``verbose`` adds ``-Xptxas -v`` and prints the compiler's report
    (registers, shared memory and spills per kernel).
    """
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", str(tmp), *map(str, _sources())]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (rc={res.returncode}):\n{res.stdout}{res.stderr}"
        )
    if verbose:
        print(res.stdout + res.stderr, end="")
    os.replace(tmp, path)
    return path


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.nbt_rans_fold.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.nbt_rans_fold.restype = i32
    lib.nbt_rans_fold_smem.argtypes = []
    lib.nbt_rans_fold_smem.restype = i64
    lib.nbt_group_decode.argtypes = [
        ptr, i32, i32, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32,
        ptr, i32, ptr,
    ]
    lib.nbt_group_decode.restype = i32
    lib.nbt_group_decode_smem.argtypes = [i32, i32]
    lib.nbt_group_decode_smem.restype = i64
    lib.nbt_group_decode_ring_words.argtypes = [i32]
    lib.nbt_group_decode_ring_words.restype = i32
    lib.nbt_error_string.argtypes = [i32]
    lib.nbt_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if rc != 0:
        msg = library().nbt_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_of(t: torch.Tensor) -> tuple[int, int]:
    """(device index, current stream handle) for a CUDA tensor."""
    dev = t.device.index if t.device.index is not None else torch.cuda.current_device()
    return dev, torch.cuda.current_stream(dev).cuda_stream
