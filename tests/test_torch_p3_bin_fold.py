"""Kernel K3's binary rANS fold step (``nblic_tpu_torch/csrc/coder3.cuh``'s
``fold_slot``) on the CPU, against the port's plain fold.

``fold_slot`` is ``__host__ __device__``: g++ compiles it here into a small
ctypes library under ``build/`` (as ``tests/test_torch_udiv64.py`` builds
its own), and each state's chain is walked from its last slot, on the slots
``rans_bin.pack_slots`` packs for the kernel.  It is held to
``rans_bin.fold_plain`` on every output: the words (emitted or not), the
emit flags and the final states.  The dispatcher ``rans_bin.fold`` and the
card wrapper's refusals are tested here too.  Tolerance 0.
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

extern "C" {
// out: (n, S) in fold order, as K3 writes it; state: (S,)
void fold_host(const uint32_t* slots, int32_t* out, uint32_t* state, int S, int n) {
  for (int s = 0; s < S; ++s) {
    uint32_t st = kAnsLow;
    for (int j = n - 1; j >= 0; --j)
      out[static_cast<long long>(n - 1 - j) * S + s] =
          static_cast<int32_t>(fold_slot(st, slots[static_cast<long long>(s) * n + j]));
    state[s] = st;
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
    lib.fold_host.argtypes = [ptr, ptr, ptr, i32, i32]
    return lib


def shim_fold(lib, p1, bins, mask):
    """K3's chains on the host: (words, emits, state) as fold_plain returns
    them."""
    slots = rans_bin.pack_slots(p1, bins, mask).numpy().view(np.uint32)
    s, n = slots.shape
    out = np.zeros((n, s), dtype=np.int32)
    state = np.zeros(s, dtype=np.uint32)
    lib.fold_host(slots.ctypes.data, out.ctypes.data, state.ctypes.data, s, n)
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
