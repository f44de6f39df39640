"""The shared-divisor division of the profile-3 AVP chain
(``nblic_tpu_torch/csrc/udiv64.cuh``), on the CPU.

The header is ``__host__ __device__``: only its multiply-high differs on
the host (``unsigned __int128``).  g++ compiles it here into a small ctypes
library under ``build/``, and the reciprocal division is held to Python's
``//``, ``tdiv_by`` to the port's plain ``ops/avp.py::tdiv_by``, and
``tdiv_trunc`` to C's truncating division (and to ``avp.tdiv`` wherever
the numerator is not INT64_MIN).  Tolerance 0.
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
from hypothesis import given, settings, strategies as st

from nblic_tpu_torch.ops import avp

ROOT = Path(__file__).resolve().parent.parent
HEADER = ROOT / "nblic_tpu_torch" / "csrc" / "udiv64.cuh"
U64 = (1 << 64) - 1
I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1

SHIM = r"""
#include "udiv64.cuh"
extern "C" {
void udiv_many(const uint64_t* n, const uint64_t* d, uint64_t* q, long long count) {
  for (long long k = 0; k < count; ++k) q[k] = udiv64(n[k], udiv64_gen(d[k]));
}
void tdiv_by_many(const int64_t* a, const int64_t* b_abs, const uint8_t* b_neg, int64_t* q,
                  long long count) {
  for (long long k = 0; k < count; ++k) q[k] = tdiv_by(a[k], tdiv_gen(b_abs[k], b_neg[k]));
}
void tdiv_trunc_many(const int64_t* a, const uint64_t* s, int64_t* q, long long count) {
  for (long long k = 0; k < count; ++k) q[k] = tdiv_trunc(a[k], udiv64_gen(s[k]));
}
void magic_of(uint64_t d, uint64_t* magic, int* shift, int* add) {
  const UDiv64 r = udiv64_gen(d);
  *magic = r.magic;
  *shift = r.shift;
  *add = r.add;
}
}
"""


@pytest.fixture(scope="module")
def lib():
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.fail("g++ is needed to compile udiv64.cuh's host path")
    digest = hashlib.sha256(HEADER.read_bytes() + SHIM.encode()).hexdigest()[:16]
    out_dir = ROOT / "build" / "test_udiv64"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"libudiv64_{digest}.so"
    if not so.exists():
        src = out_dir / f"shim_{digest}_{os.getpid()}.cpp"
        tmp = out_dir / f"libudiv64_{digest}_{os.getpid()}.so"
        src.write_text(SHIM)
        subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I", str(HEADER.parent),
                        "-o", str(tmp), str(src)], check=True, capture_output=True, text=True)
        src.unlink()
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    ptr, n = ctypes.c_void_p, ctypes.c_longlong
    lib.udiv_many.argtypes = [ptr, ptr, ptr, n]
    lib.tdiv_by_many.argtypes = [ptr, ptr, ptr, ptr, n]
    lib.tdiv_trunc_many.argtypes = [ptr, ptr, ptr, n]
    lib.magic_of.argtypes = [ctypes.c_uint64, ptr, ptr, ptr]
    return lib


def _udiv(lib, nums, divs):
    n = np.array(nums, dtype=np.uint64)
    d = np.broadcast_to(np.array(divs, dtype=np.uint64), n.shape).copy()
    q = np.empty_like(n)
    lib.udiv_many(n.ctypes.data, d.ctypes.data, q.ctypes.data, n.size)
    return [int(v) for v in q]


def _tdiv_by(lib, a, b_abs, b_neg):
    a = np.array(a, dtype=np.int64)
    b = np.broadcast_to(np.array(b_abs, dtype=np.int64), a.shape).copy()
    s = np.broadcast_to(np.array(b_neg, dtype=np.uint8), a.shape).copy()
    q = np.empty_like(a)
    lib.tdiv_by_many(a.ctypes.data, b.ctypes.data, s.ctypes.data, q.ctypes.data, a.size)
    return q


def _plain_tdiv_by(a, b_abs, b_neg):
    a = torch.tensor(np.array(a, dtype=np.int64))
    b = torch.tensor(np.broadcast_to(np.array(b_abs, dtype=np.int64), a.shape).copy())
    s = torch.tensor(np.broadcast_to(np.array(b_neg, dtype=bool), a.shape).copy())
    return avp.tdiv_by(a, b, s).numpy()


def _wrap(v: int) -> int:
    """v modulo 2^64 as an int64."""
    v &= U64
    return v - (1 << 64) if v >> 63 else v


def _numerators(d: int, rng) -> list:
    """Numerators around the edges of d and of the word, and random ones of
    every bit length."""
    base = {0, 1, 2, 3, I64_MAX, 1 << 63, U64, U64 - 1, (1 << 32) - 1, 1 << 32, (1 << 32) + 1}
    for k in range(1, 5):
        for v in (k * d - 1, k * d, k * d + 1, U64 - k * d, U64 // d * d, U64 // d * d - 1):
            base.add(v & U64)
    bits = rng.integers(1, 65, size=400)
    base.update(int(rng.integers(0, 1 << 62)) * 4 + int(rng.integers(0, 4)) >> (64 - int(b))
                for b in bits)
    # wrapped products passing 2^63, as the elimination makes them
    for _ in range(100):
        x, y = (int(v) for v in rng.integers(1 << 40, 1 << 62, size=2))
        base.add((x * y) & U64)
    return sorted(base)


DIVISORS = [1, 2, 3, 5, 6, 7, 10, 12, 4096, 4097, 65535, 65536, 1 << 31, (1 << 32) - 1,
            1 << 32, (1 << 32) + 1, 0x5555_5555_5555_5555, (1 << 62) + 1, (1 << 63) - 1,
            1 << 63, (1 << 63) + 1, U64 - 1, U64, 1000003, 0x1234_5678_9ABC_DEF1]


@pytest.mark.parametrize("d", DIVISORS, ids=hex)
def test_reciprocal_division_matches_floor_division(lib, d):
    nums = _numerators(d, np.random.default_rng(d % (1 << 32)))
    assert _udiv(lib, nums, d) == [n // d for n in nums]


@pytest.mark.parametrize("k", range(64))
def test_powers_of_two_and_their_neighbours(lib, k):
    rng = np.random.default_rng(k)
    for d in {1 << k, (1 << k) + 1, max((1 << k) - 1, 1)}:
        d &= U64
        if d == 0:
            continue
        nums = _numerators(d, rng)
        assert _udiv(lib, nums, d) == [n // d for n in nums], d


def test_magic_of_a_power_of_two_is_a_shift(lib):
    magic, shift, add = ctypes.c_uint64(), ctypes.c_int(), ctypes.c_int()
    for k in range(64):
        lib.magic_of(1 << k, ctypes.byref(magic), ctypes.byref(shift), ctypes.byref(add))
        assert (magic.value, shift.value, add.value) == (0, k, 0)


# tdiv_by against the plain version: (numerators, divisor magnitude, sign)
TDIV_CASES = {
    "int64-min-numerator": ([I64_MIN, I64_MIN + 1, -1, 0, 1, I64_MAX], [1, 2, 3, 7, 1 << 62]),
    "int64-min-divisor": ([I64_MIN, I64_MIN + 1, -5, 0, 5, I64_MAX, 1 << 62], [I64_MIN]),
    "small": (list(range(-40, 41)), [1, 2, 3, 4, 5, 9, 16, 17]),
    "word-edges": ([I64_MAX, I64_MAX - 1, -I64_MAX, 1 << 32, -(1 << 32), (1 << 32) - 1],
                   [1, (1 << 32) - 1, 1 << 32, (1 << 32) + 1, I64_MAX, I64_MAX - 1]),
}


@pytest.mark.parametrize("neg", [False, True])
@pytest.mark.parametrize("case", list(TDIV_CASES))
def test_tdiv_by_matches_plain(lib, case, neg):
    nums, divs = TDIV_CASES[case]
    for b in divs:
        if b == I64_MIN and not neg:
            continue  # |x| = INT64_MIN only for x = INT64_MIN, a negative divisor
        got = _tdiv_by(lib, nums, b, neg)
        np.testing.assert_array_equal(got, _plain_tdiv_by(nums, b, neg), err_msg=str(b))


@pytest.mark.parametrize("seed", range(4))
def test_tdiv_by_on_wrapped_products(lib, seed):
    # the elimination's numerators: int64 products that wrap past 2^63,
    # over pivots of every size and sign
    rng = np.random.default_rng(seed)
    x = rng.integers(I64_MIN, I64_MAX, size=2000, dtype=np.int64)
    y = rng.integers(-(1 << 40), 1 << 40, size=2000, dtype=np.int64)
    a = np.array([_wrap(int(u) * int(v)) for u, v in zip(x, y)], dtype=np.int64)
    for piv in (1, -1, 3, -12345, 1 << 40, -(1 << 52) - 7, I64_MAX, -I64_MAX, I64_MIN):
        b_abs, neg = (I64_MIN, True) if piv == I64_MIN else (abs(piv), piv < 0)
        np.testing.assert_array_equal(_tdiv_by(lib, a, b_abs, neg),
                                      _plain_tdiv_by(a, b_abs, neg), err_msg=str(piv))


def _tdiv_trunc(lib, a, s):
    a = np.array(a, dtype=np.int64)
    d = np.broadcast_to(np.array(s, dtype=np.uint64), a.shape).copy()
    q = np.empty_like(a)
    lib.tdiv_trunc_many(a.ctypes.data, d.ctypes.data, q.ctypes.data, a.size)
    return q


@pytest.mark.parametrize("s", [1 << 12, (1 << 12) + 1, 6000, 12345, 32769, (1 << 16) - 1,
                               1 << 16])
def test_moment_division_truncates(lib, s):
    # the moments' numerators: (left right) << shift + s / 2, |left right|
    # <= 2^14 and shift <= 28, and the word's edges besides
    rng = np.random.default_rng(s)
    a = [int(v) for v in rng.integers(-(1 << 42), 1 << 42, size=3000)]
    a += [0, 1, -1, s, -s, s - 1, 1 - s, I64_MAX, I64_MIN + 1, I64_MIN]
    want = [(abs(v) // s) * (1 if v >= 0 else -1) for v in a]
    got = _tdiv_trunc(lib, a, s)
    assert [int(v) for v in got] == want
    plain = avp.tdiv(torch.tensor(a[:-1]), torch.tensor(s)).numpy()  # INT64_MIN aside
    np.testing.assert_array_equal(got[:-1], plain)


@settings(max_examples=400, deadline=None)
@given(st.integers(0, U64), st.integers(1, U64))
def test_reciprocal_division_on_drawn_pairs(lib, n, d):
    assert _udiv(lib, [n, n >> 1, n >> 33], d) == [n // d, (n >> 1) // d, (n >> 33) // d]


@settings(max_examples=400, deadline=None)
@given(st.integers(I64_MIN, I64_MAX), st.integers(I64_MIN, I64_MAX).filter(lambda b: b != 0))
def test_tdiv_by_on_drawn_pairs(lib, a, b):
    b_abs, neg = (I64_MIN, True) if b == I64_MIN else (abs(b), b < 0)
    assert _tdiv_by(lib, [a], b_abs, neg)[0] == _plain_tdiv_by([a], b_abs, neg)[0]
