"""Build and bind the hand-written CUDA kernels in ``csrc/``.

The sources (``*.cu``, which include the shared ``*.cuh`` headers) compile
with ``nvcc`` for ``sm_90a`` (Hopper) into ONE shared library with a plain C
interface, loaded with ``ctypes``.  The build runs at first use, into
``build/nblic_tpu_torch/`` beside the package; the library's name carries a
hash of the sources, the headers and the flags, so an edited file rebuilds.
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
    "-Xcompiler", "-fPIC",
)
SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use


def _sources() -> list[Path]:
    """The translation units nvcc compiles, one process each."""
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources, headers and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*_sources(), *CSRC.glob("*.cuh")]):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libnblic_kernels_{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def _run(cmds: list[list[str]]) -> str:
    """Run the commands at once; raise with the output of any that failed,
    else return their joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed (rc={p.returncode}):\n{out}")
    return "".join(outs)


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless a library for these sources exists: one
    nvcc a source, all started together, then one link.

    ``verbose`` adds ``-Xptxas -v`` and prints the compiler's report
    (registers, shared memory and spills per kernel).
    """
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{path.name}.{os.getpid()}"
    tmp = path.with_name(f"{tag}.tmp")
    objs = [path.with_name(f"{tag}.{src.stem}.o") for src in _sources()]
    nvcc, ptxas = _nvcc(), ("-Xptxas", "-v") if verbose else ()
    try:
        report = _run([[nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", str(obj), str(src)]
                       for src, obj in zip(_sources(), objs)])
        _run([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    if verbose:
        print(report, end="")
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
    lib.nbt_near_scan.argtypes = [
        ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, i32, ptr,
    ]
    lib.nbt_near_scan.restype = i32
    lib.nbt_near_scan_smem.argtypes = [i32, i32]
    lib.nbt_near_scan_smem.restype = i64
    lib.nbt_p3_near_row.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i64, ptr, ptr,
        ptr, i32, i32, ptr,
    ]
    lib.nbt_p3_near_row.restype = i32
    lib.nbt_avp_solve.argtypes = [ptr, ptr, i32, i32, ptr, ptr, ptr, ptr, i32, ptr]
    lib.nbt_avp_solve.restype = i32
    lib.nbt_p3_decode_segment.argtypes = [
        ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        i32, i32, i32, i32, i32, ptr, i32, i32, ptr,
    ]
    lib.nbt_p3_decode_segment.restype = i32
    lib.nbt_p3_row_scan.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, ptr, i32,
                                    ptr]
    lib.nbt_p3_row_scan.restype = i32
    lib.nbt_p3_row_scan_smem.argtypes = []
    lib.nbt_p3_row_scan_smem.restype = i64
    lib.nbt_bin_fold.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.nbt_bin_fold.restype = i32
    lib.nbt_bin_fold_steps.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, ptr]
    lib.nbt_bin_fold_steps.restype = i32
    lib.nbt_p3_table_replay.argtypes = [ptr] * 11 + [i32] * 13 + [ptr]
    lib.nbt_p3_table_replay.restype = i32
    lib.nbt_p3_model_chains.argtypes = [i32] + [ptr] * 6 + [i32] * 12 + [ptr]
    lib.nbt_p3_model_chains.restype = i32
    lib.nbt_p3_model_chains_scratch.argtypes = [i32] * 5
    lib.nbt_p3_model_chains_scratch.restype = i64
    lib.nbt_p3_model_chains_plan.argtypes = [i32, i32, ptr]
    lib.nbt_p3_model_chains_plan.restype = i32
    lib.nbt_p3_model_solve.argtypes = [ptr] * 5 + [i64, i32, i32, i32, i32, ptr]
    lib.nbt_p3_model_solve.restype = i32
    lib.nbt_p3_model_solve_per_sm.argtypes = [i32, i32]
    lib.nbt_p3_model_solve_per_sm.restype = i32
    lib.nbt_interop_nblic_walk.argtypes = [ptr] * 7 + [i64, ptr, ptr, ptr] + [i32] * 7 + [ptr]
    lib.nbt_interop_nblic_walk.restype = i32
    lib.nbt_interop_walk_smem.argtypes = [i32]
    lib.nbt_interop_walk_smem.restype = i64
    lib.nbt_interop_q_decode.argtypes = [ptr, i64, ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.nbt_interop_q_decode.restype = i32
    lib.nbt_interop_q_chain.argtypes = [ptr, ptr, ptr, i32, ptr, i32, ptr]
    lib.nbt_interop_q_chain.restype = i32
    lib.nbt_error_string.argtypes = [i32]
    lib.nbt_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if rc != 0:
        msg = library().nbt_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def check_tensors(want: dict, device: torch.device, kernel: str) -> None:
    """Raise ValueError unless every tensor of ``want`` ({name: (tensor,
    shape, dtype)}) has its shape and dtype, lies on ``device``, a CUDA
    device, and is contiguous; shapes and dtypes are checked first."""
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{name} must be {tuple(shape)} {dtype}, got {tuple(t.shape)} "
                             f"{t.dtype}")
    for name, (t, _, _) in want.items():
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name} lies on {t.device}: {kernel} runs on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_int16(table: torch.Tensor) -> None:
    """Raise ValueError unless an int32 ``table``'s values lie in int16, as
    a kernel reading it as int16 needs (a readback); int16 passes as it is."""
    if table.dtype == torch.int32 and table.numel():
        lo, hi = (int(v) for v in torch.aminmax(table))
        if lo < -(1 << 15) or hi >= 1 << 15:
            raise ValueError(f"bias values must lie in int16, got [{lo}, {hi}]")


def stream_of(t: torch.Tensor) -> tuple[int, int]:
    """(device index, current stream handle) for a CUDA tensor."""
    dev = t.device.index if t.device.index is not None else torch.cuda.current_device()
    return dev, torch.cuda.current_stream(dev).cuda_stream
