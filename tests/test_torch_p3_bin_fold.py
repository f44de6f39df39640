"""Kernel K3's binary rANS fold step (``nblic_tpu_torch/csrc/coder3.cuh``)
on the CPU, against the port's plain fold.

K3's chain steps a live slot without a division: its frequency f and
offset from the slot (``fold_operands``), then f's exact reciprocal
(``fold_recip``) in the multiply-high step ``fold_by_recip``.  These are
``__host__ __device__``: g++ compiles them here into a small ctypes
library under ``build/`` (as ``tests/test_torch_udiv64.py`` builds its
own), and each state's chain is walked from its last slot, a masked slot
keeping the state.  It is held to ``rans_bin.fold_plain`` on every output
(the words, emitted or not, the emit flags and the final states), and the
step alone to the plain step's arithmetic for all 4,095 values of f at the
edge states, which ``tests/test_torch_cuda.py`` holds on the card too.
The dispatcher ``rans_bin.fold`` and the card wrapper's refusals are
tested here too.  Tolerance 0.
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

from nblic_tpu_torch import kernels
from nblic_tpu_torch.ops import rans_bin

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "nblic_tpu_torch" / "csrc"

SHIM = r"""
#include "coder3.cuh"

namespace {
// one step of a state's chain, as K3 takes a slot: word | emitted << 16
uint32_t step(uint32_t& state, int p1, int bin, int live) {
  const uint32_t word = state & 0xFFFFu;
  if (!live) return word;
  const FoldSlot fs = fold_operands(p1, bin == 1);
  uint32_t emit;
  state = fold_by_recip(state, fs.f, fs.acc, fold_recip(fs.f), emit);
  return word | emit << 16;
}
}  // namespace

extern "C" {
// p1 (S, n) int16, bins / mask (S, n) bytes; out: (n, S) in fold order, as
// K3 writes it, word | emitted << 16; state: (S,)
void fold_host(const int16_t* p1, const int8_t* bins, const uint8_t* mask, int32_t* out,
               uint32_t* state, int S, int n) {
  for (int s = 0; s < S; ++s) {
    uint32_t st = kAnsLow;
    for (int j = n - 1; j >= 0; --j) {
      const long long at = static_cast<long long>(s) * n + j;
      out[static_cast<long long>(n - 1 - j) * S + s] =
          static_cast<int32_t>(step(st, p1[at], bins[at], mask[at]));
    }
    state[s] = st;
  }
}
// floor(x / f) by f's reciprocal, a (x, f) pair each
void recip_div_many(const uint32_t* x, const uint32_t* f, uint32_t* out, long long n) {
  for (long long k = 0; k < n; ++k) out[k] = recip_div(x[k], fold_recip(f[k]));
}
// one step a (state, slot) pair: the word, the emit flag, the state after
void steps_many(const uint32_t* states, const int16_t* p1, const int8_t* bins,
                const uint8_t* mask, uint32_t* out, long long n) {
  for (long long k = 0; k < n; ++k) {
    uint32_t st = states[k];
    const uint32_t w = step(st, p1[k], bins[k], mask[k]);
    out[3 * k] = w & 0xFFFFu;
    out[3 * k + 1] = w >> 16;
    out[3 * k + 2] = st;
  }
}
}
"""


@pytest.fixture(scope="module")
def lib():
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.fail("g++ is needed to compile coder3.cuh's host path")
    digest = hashlib.sha256((CSRC / "coder3.cuh").read_bytes() + SHIM.encode()).hexdigest()[:16]
    out_dir = ROOT / "build" / "test_p3_bin_fold"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"libbinfold_{digest}.so"
    if not so.exists():
        src = out_dir / f"shim_{digest}_{os.getpid()}.cpp"
        tmp = out_dir / f"libbinfold_{digest}_{os.getpid()}.so"
        src.write_text(SHIM)
        subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I", str(CSRC),
                        "-o", str(tmp), str(src)], check=True, capture_output=True, text=True)
        src.unlink()
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fold_host.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32]
    lib.recip_div_many.argtypes = [ptr, ptr, ptr, ctypes.c_longlong]
    lib.steps_many.argtypes = [ptr, ptr, ptr, ptr, ptr, ctypes.c_longlong]
    return lib


def _planes(p1, bins, mask):
    """p1, bins and mask as K3 reads them (``rans_bin.fold_card``'s
    conversions, on the host): int16, and a byte each."""
    p16 = torch.clamp(p1.to(torch.int64), -(1 << 15), (1 << 15) - 1).to(torch.int16)
    return (np.ascontiguousarray(p16.numpy()),
            np.ascontiguousarray((bins == 1).numpy().astype(np.int8)),
            np.ascontiguousarray((mask != 0).numpy().astype(np.uint8)))


def shim_fold(lib, p1, bins, mask):
    """K3's chains on the host: (words, emits, state) as fold_plain returns
    them."""
    p16, b8, m8 = _planes(p1, bins, mask)
    s, n = p16.shape
    out = np.zeros((n, s), dtype=np.int32)
    state = np.zeros(s, dtype=np.uint32)
    lib.fold_host(p16.ctypes.data, b8.ctypes.data, m8.ctypes.data, out.ctypes.data,
                  state.ctypes.data, s, n)
    fold = torch.from_numpy(out).t()
    return fold & 0xFFFF, fold > 0xFFFF, torch.from_numpy(state.astype(np.int64))


def _inputs(seed, s, n, p1_dtype=torch.int16, live=0.4):
    rng = np.random.default_rng(seed)
    p1 = rng.integers(1, 4096, (s, n))
    p1[:, ::7] = rng.choice([1, 2, 4094, 4095], size=p1[:, ::7].shape)  # the clip's edges
    bins = (rng.random((s, n)) < p1 / 4096.0).astype(np.int8)
    mask = rng.random((s, n)) < live
    return (torch.from_numpy(p1).to(p1_dtype), torch.from_numpy(bins),
            torch.from_numpy(mask))


def _assert_same(got, want):
    for g, w_, name in zip(got, want, ("words", "emits", "state")):
        assert g.dtype == w_.dtype and g.shape == w_.shape, name
        assert torch.equal(g, w_), name


@pytest.mark.parametrize("s,n", [(16, 21 * 16), (32, 1000), (48, 4099), (3, 1)])
def test_fold_chains_match_plain(lib, s, n):
    p1, bins, mask = _inputs(s * n, s, n)
    _assert_same(shim_fold(lib, p1, bins, mask), rans_bin.fold_plain(p1, bins, mask))


def test_all_masked_state_and_live_runs(lib):
    p1, bins, mask = _inputs(1, 16, 640, live=0.9)
    mask[3] = False  # a state with no live slot keeps 2^16 and emits nothing
    mask[5, 100:400] = False
    got = shim_fold(lib, p1, bins, mask)
    _assert_same(got, rans_bin.fold_plain(p1, bins, mask))
    assert int(got[2][3]) == rans_bin.ANS_LOW and not got[1][3].any()
    assert got[1].any()


def test_out_of_range_probabilities_clip_as_plain(lib):
    # int32 and int64 probabilities past [1, 4095] and past int16: the
    # packing clips to int16, K3 to [1, 4095], as fold_plain clips
    rng = np.random.default_rng(4)
    p1 = rng.choice([-(1 << 40), -70000, -32769, -5, 0, 1, 4095, 4096, 32767, 32768, 65537,
                     1 << 33], size=(8, 300))
    bins = rng.integers(0, 3, (8, 300))  # 2 is not a one
    mask = rng.random((8, 300)) < 0.7
    for dtype in (torch.int32, torch.int64):
        t = torch.from_numpy(p1).to(dtype) if dtype == torch.int64 else \
            torch.from_numpy(np.clip(p1, -(1 << 31), (1 << 31) - 1)).to(dtype)
        b, m = torch.from_numpy(bins), torch.from_numpy(mask)
        _assert_same(shim_fold(lib, t, b, m), rans_bin.fold_plain(t, b, m))


def edge_steps():
    """(states, p1 int16, bins int8, masks uint8, expected (n, 3) word, emit
    flag and state after) of one fold step: every p1 in [1, 4095] at both
    bins (so every f twice), against 2^16, 2^32 - 1, f << 20 and f << 20 -
    1 (the renormalization's edge), and multiples of f near f << 20 and
    those - 1, plus masked slots.  The expected values are the plain
    step's (fold_plain's arithmetic, with its division)."""
    p1 = np.repeat(np.arange(1, 4096, dtype=np.int64), 2)
    one = np.tile(np.array([0, 1], dtype=np.int64), 4095)
    f = np.where(one == 1, p1, 4096 - p1)
    edges = [np.full_like(f, 1 << 16), np.full_like(f, (1 << 32) - 1), f << 20, (f << 20) - 1]
    for k in (1, 2, 3, 4096):
        m = ((1 << 20) - k) * f  # multiples of f just below f << 20
        edges += [m, m - 1]
    edges += [(((1 << 32) - 1) // f) * f, (((1 << 32) - 1) // f) * f - 1]
    states = np.concatenate(edges)
    p1s, ones, fs = (np.tile(v, len(edges)) for v in (p1, one, f))
    live = np.ones_like(states, dtype=bool)
    live[::97] = False
    keep = (states >= 1 << 16) & (states < 1 << 32)
    states, p1s, ones, fs, live = (v[keep] for v in (states, p1s, ones, fs, live))
    renorm = states >= fs << 20
    x = np.where(renorm, states >> 16, states)
    nxt = ((x // fs) << 12) + x % fs + np.where(ones == 1, 4096 - p1s, 0)
    want = np.stack([states & 0xFFFF, renorm & live, np.where(live, nxt, states)], 1)
    return (states.astype(np.uint32), p1s.astype(np.int16), ones.astype(np.int8),
            live.astype(np.uint8), want.astype(np.uint32))


def test_reciprocal_division_is_exact_for_every_f(lib):
    f = np.arange(1, 4096, dtype=np.uint64)
    cols = [np.zeros_like(f), np.ones_like(f), f - 1, f, f + 1, (f << 20) - 1, f << 20,
            np.full_like(f, (1 << 32) - 1), np.full_like(f, (1 << 32) - 2)]
    top = ((1 << 32) - 1) // f
    for k in (1, 2, 1 << 10, 1 << 19, (1 << 20) - 1):
        q = np.minimum(np.uint64(k), top)
        cols += [q * f, q * f - 1]
    cols += [top * f, top * f - 1]
    x = np.concatenate(cols)
    x = np.concatenate([x, np.random.default_rng(6).integers(0, 1 << 32, 200000,
                                                            dtype=np.uint64)])
    fs = np.concatenate([np.tile(f, len(cols)), np.random.default_rng(7).integers(
        1, 4096, 200000, dtype=np.uint64)])
    x, fs = x.astype(np.uint32), fs.astype(np.uint32)
    out = np.zeros_like(x)
    lib.recip_div_many(x.ctypes.data, fs.ctypes.data, out.ctypes.data, x.size)
    np.testing.assert_array_equal(out, x.astype(np.uint64) // fs.astype(np.uint64))


def test_reciprocal_step_matches_the_plain_step(lib):
    states, p1, bins, live, want = edge_steps()
    out = np.zeros((states.size, 3), dtype=np.uint32)
    lib.steps_many(states.ctypes.data, p1.ctypes.data, bins.ctypes.data, live.ctypes.data,
                   out.ctypes.data, states.size)
    np.testing.assert_array_equal(out, want)


# ---- the dispatcher and the wrapper's refusals


def test_cpu_tensors_run_the_plain_fold(monkeypatch):
    calls = []
    monkeypatch.setattr(rans_bin, "fold_plain", lambda *a: calls.append(1) or "plain")
    monkeypatch.setattr(rans_bin, "fold_card", lambda *a: pytest.fail("K3 on a CPU tensor"))
    p1, bins, mask = _inputs(0, 4, 8)
    assert rans_bin.fold(p1, bins, mask) == "plain" and calls == [1]


def test_other_devices_raise():
    t = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        rans_bin.fold(t, t, t)


@pytest.mark.parametrize("case", ["shape", "rank", "dtype", "device"])
def test_fold_refuses_before_any_launch(monkeypatch, case):
    monkeypatch.setattr(kernels, "library", lambda: pytest.fail("launched"))
    p1, bins, mask = _inputs(0, 4, 8)
    with pytest.raises(ValueError):
        if case == "shape":
            rans_bin.fold(p1, bins[:, :4], mask)
        elif case == "rank":
            rans_bin.fold(p1[0], bins[0], mask[0])
        elif case == "dtype":
            rans_bin.fold_card(p1.float(), bins, mask)
        else:
            rans_bin.fold_card(p1, bins, mask)  # CPU tensors
