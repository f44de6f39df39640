"""Kernel K7's division-free near fold (``near_recip``, ``near_quot`` and
``near_fold`` of ``nblic_tpu_torch/csrc/pixel_chain.cuh``), on the CPU.

Those three are ``__host__ __device__``: only the multiply-high differs on
the host.  g++ compiles them here into a small ctypes library under
``build/`` (as ``tests/test_torch_udiv64.py`` builds its header), and the
quotient by the reciprocal is held to C's ``/`` for every ``near`` in
1..255 and every numerator 0..510 the fold divides, and the fused fold and
reconstruction to the port's ``ops/context.py::residual_fold`` and
``residual_unfold`` over every (x, px, sign).  Tolerance 0.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from nblic_tpu_torch.ops.context import residual_fold, residual_unfold

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
HEADER = ROOT / "nblic_tpu_torch" / "csrc" / "pixel_chain.cuh"

SHIM = r"""
#include "pixel_chain.cuh"
extern "C" {
// n / (2 near + 1) by the reciprocal and by C's division, for every n of
// the array
void quot_many(const int* n, int near, int* by_recip, int* by_div, long long count) {
  const uint32_t m = near_recip(near);
  for (long long k = 0; k < count; ++k) {
    by_recip[k] = near_quot(n[k], m);
    by_div[k] = n[k] / (2 * near + 1);
  }
}
void fold_many(const int* x, const int* px, const int* sign, int near, int* y, int* rec,
               long long count) {
  const uint32_t m = near_recip(near);
  for (long long k = 0; k < count; ++k) {
    const NearFold f = near_fold(x[k], px[k], sign[k], near, m);
    y[k] = f.y;
    rec[k] = f.x_rec;
  }
}
}
"""


@pytest.fixture(scope="module")
def lib():
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.fail("g++ is needed to compile pixel_chain.cuh's host path")
    digest = hashlib.sha256(HEADER.read_bytes() + SHIM.encode()).hexdigest()[:16]
    out_dir = ROOT / "build" / "test_near_fold"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"libnearfold_{digest}.so"
    if not so.exists():
        src = out_dir / f"shim_{digest}_{os.getpid()}.cpp"
        tmp = out_dir / f"libnearfold_{digest}_{os.getpid()}.so"
        src.write_text(SHIM)
        subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I", str(HEADER.parent),
                        "-o", str(tmp), str(src)], check=True, capture_output=True, text=True)
        src.unlink()
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    ptr, i32, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.quot_many.argtypes = [ptr, i32, ptr, ptr, n]
    lib.fold_many.argtypes = [ptr, ptr, ptr, i32, ptr, ptr, n]
    return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


@pytest.mark.parametrize("first", range(1, 256, 51))
def test_reciprocal_quotient_is_c_division(lib, first):
    """Every near in [first, first + 51) and every numerator 0..510."""
    n = np.arange(511, dtype=np.int32)
    for near in range(first, first + 51):
        by_recip, by_div = np.empty_like(n), np.empty_like(n)
        lib.quot_many(_ptr(n), near, _ptr(by_recip), _ptr(by_div), n.size)
        np.testing.assert_array_equal(by_recip, by_div, err_msg=f"near {near}")
        np.testing.assert_array_equal(by_div, n // (2 * near + 1))


@pytest.mark.parametrize("near", [1, 2, 9, 127, 255])
def test_near_fold_is_fold_then_unfold(lib, near):
    """Every (x, px, sign) in [0, 255]^2 x {0, 1}: the fused fold's symbol
    is residual_fold's, its reconstruction residual_unfold's of it."""
    x, px, sign = (a.astype(np.int32).ravel().copy()
                   for a in np.meshgrid(np.arange(256), np.arange(256), np.arange(2),
                                        indexing="ij"))
    y, rec = np.empty_like(x), np.empty_like(x)
    lib.fold_many(_ptr(x), _ptr(px), _ptr(sign), near, _ptr(y), _ptr(rec), x.size)
    tx, tpx, tsign = (torch.from_numpy(a) for a in (x, px, sign))
    want_y = residual_fold(tx, tpx, tsign, near)
    want_rec = residual_unfold(want_y, tpx, tsign, near)
    np.testing.assert_array_equal(y, want_y.numpy())
    np.testing.assert_array_equal(rec, want_rec.numpy())
    assert np.abs(rec - x).max() <= near  # the reconstruction stays within near
