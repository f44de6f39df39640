"""Kernel K6's walks (``nblic_tpu_torch/csrc/interop_chain.cuh``) on the
CPU, through the wrappers of ``ops/interop_walk.py``.

The walks' per-pixel functions and the walk loops are ``__host__
__device__``: g++ compiles them here into a small ctypes library under
``build/``, and a stand-in for the kernel library hands each wrapper's
launch to the host walk with the same pointers (the NBLIC0.3 walk with a
team of virtual threads, one after another between the kernel's phases,
at the card's 32 and at 1 and 7, in both orders).  The dispatchers of
``models/nblic.py`` and ``models/qnblic.py`` are pointed at the wrappers,
so every container and decode below goes through the entry points as a
card's would.  They are held byte-identical to the port's native runtime
copy (``nblic_tpu_torch.runtime``, which ``tests/test_torch_interop.py``
holds to ``nblic_tpu`` and to the plain walks): efforts 1-3 at near 0,
effort 1 at near 2 and 9, effort 2 at near 2, both ways; the Q0.2 decode;
the Q0.2 encode's context chain against ``qnblic._context_chain_plain``;
and the hostile streams of ``tests/test_torch_interop_api.py`` against the
plain walks.  Tolerance 0.
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
from conftest import make_test_images

from nblic_tpu_torch import kernels, runtime
from nblic_tpu_torch.models import nblic, qnblic
from nblic_tpu_torch.ops import histogram, interop_walk, predict
from nblic_tpu_torch.utils.container import QnblicHeader

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "nblic_tpu_torch" / "csrc"
HEADERS = ("udiv64.cuh", "model_solve.cuh", "interop_chain.cuh")
IMAGES = make_test_images(np.random.default_rng(1234))
# 1x1, 1x7, 5x1, 8x8, 23x17 (random), 16x16 flat 0 and 255
SMALL = [IMAGES[k] for k in (0, 1, 2, 3, 4, 6, 7)]

SHIM = r"""
#include "interop_chain.cuh"
#include <vector>

namespace {
// A CTA of n virtual threads, run one after another (in reverse where
// asked) between the walk's phases.
struct HostTeam {
  int n;
  bool reverse;
  template <class F>
  void threads(F f) const {
    for (int k = 0; k < n; ++k) f(reverse ? n - 1 - k : k, n);
  }
  template <class F>
  void one(F f) const { f(); }
  void sync() const {}
};

template <int kN, bool kDecode>
void walk(const NWalk& a, int n_threads, int reverse) {
  NAvp<kN ? kN : 1> av;
  std::vector<uint16_t> tree(2 * kTreePairs);
  std::vector<int32_t> ctx(kNCtxN), freq(kMapKeys * kMapN);
  std::vector<uint8_t> to_rank(kMapKeys * kMapN), from_rank(kMapKeys * kMapN);
  const NTables tb{tree.data(), ctx.data(), Mappers{to_rank.data(), from_rank.data(), freq.data()}};
  nblic_walk<kN, kDecode>(a, tb, av, HostTeam{n_threads, reverse != 0});
}
}  // namespace

extern "C" {
// nbt_interop_nblic_walk's arguments, a team's size and order for the device
int nblic_walk_host(const uint8_t* img, uint8_t* rec, int64_t* lo, int64_t* hi, int64_t* window,
                    int64_t* ptr, uint8_t* buf, long long len, int64_t* b, int64_t* f,
                    int64_t* bins, int h, int w, int near, int k_step, int effort, int decode,
                    int n_threads, int reverse) {
  const NWalk a{img, rec, {lo, hi, window, ptr}, buf, len, b, f, h, w, near, k_step, bins};
  if (effort == 1) decode ? walk<0, true>(a, n_threads, reverse) : walk<0, false>(a, n_threads, reverse);
  if (effort == 2) decode ? walk<6, true>(a, n_threads, reverse) : walk<6, false>(a, n_threads, reverse);
  if (effort == 3) decode ? walk<10, true>(a, n_threads, reverse) : walk<10, false>(a, n_threads, reverse);
  return 0;
}
int q_decode_host(const int32_t* words, long long n_words, const int32_t* freq,
                  const int32_t* cum, const uint8_t* lut, uint8_t* rec, int h, int w) {
  std::vector<int32_t> ctx(kQCtx);
  q_decode_walk(words, n_words, freq, cum, lut, ctx.data(), rec, h, w);
  return 0;
}
int q_chain_host(const int32_t* err, const int64_t* order, const int64_t* start, int n_ctx,
                 int32_t* before) {
  for (int c = 0; c < n_ctx; ++c) q_chain_context(err, order, start[c], start[c + 1], before);
  return 0;
}
}
"""


@pytest.fixture(scope="module")
def lib():
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.fail("g++ is needed to compile interop_chain.cuh's host path")
    digest = hashlib.sha256(b"".join((CSRC / h).read_bytes() for h in HEADERS)
                            + SHIM.encode()).hexdigest()[:16]
    out_dir = ROOT / "build" / "test_interop_walk"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"libinteropwalk_{digest}.so"
    if not so.exists():
        src = out_dir / f"shim_{digest}_{os.getpid()}.cpp"
        tmp = out_dir / f"libinteropwalk_{digest}_{os.getpid()}.so"
        src.write_text(SHIM)
        subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I", str(CSRC),
                        "-o", str(tmp), str(src)], check=True, capture_output=True, text=True)
        src.unlink()
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.nblic_walk_host.argtypes = [ptr] * 7 + [i64, ptr, ptr, ptr] + [i32] * 8
    lib.q_decode_host.argtypes = [ptr, i64, ptr, ptr, ptr, ptr, i32, i32]
    lib.q_chain_host.argtypes = [ptr, ptr, ptr, i32, ptr]
    for fn in (lib.nblic_walk_host, lib.q_decode_host, lib.q_chain_host):
        fn.restype = i32
    return lib


class HostLibrary:
    """The kernel library's K6 entries, run by the host walks on CPU
    pointers: each takes the C entry's arguments, drops the device and the
    stream, and returns 0 as a launch that raised no error."""

    def __init__(self, lib, n_threads=32, reverse=False):
        self.lib, self.n_threads, self.reverse = lib, n_threads, reverse

    def nbt_interop_nblic_walk(self, *args):
        return self.lib.nblic_walk_host(*args[:-2], self.n_threads, int(self.reverse))

    def nbt_interop_q_decode(self, *args):
        return self.lib.q_decode_host(*args[:-2])

    def nbt_interop_q_chain(self, *args):
        return self.lib.q_chain_host(*args[:-2])


def cpu_check_tensors(want, device, kernel):
    """kernels.check_tensors without the device: shapes and dtypes, then
    contiguity, on CPU tensors."""
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{name} must be {tuple(shape)} {dtype}, got {tuple(t.shape)} "
                             f"{t.dtype}")
    for name, (t, _, _) in want.items():
        assert t.device == device and t.is_contiguous(), name


@pytest.fixture
def on_host(lib, monkeypatch):
    """Route the entry points' walks through the wrappers onto the host
    walks; returns a function that sets the NBLIC0.3 team."""
    monkeypatch.setattr(kernels, "library", lambda: host)
    monkeypatch.setattr(kernels, "check_tensors", cpu_check_tensors)
    monkeypatch.setattr(kernels, "stream_of", lambda t: (0, 0))
    monkeypatch.setattr(nblic, "_walk", interop_walk.nblic_walk)
    monkeypatch.setattr(qnblic, "_decode_walk", interop_walk.q_decode_walk)
    monkeypatch.setattr(qnblic, "_context_chain", qnblic._context_chain_card)
    host = HostLibrary(lib)

    def team(n_threads, reverse=False):
        host.n_threads, host.reverse = n_threads, reverse

    return team


def _err(a, b) -> int:
    return int(np.abs(a.astype(int) - b.astype(int)).max())


@pytest.mark.parametrize("effort,near", [(1, 0), (2, 0), (3, 0), (1, 2), (1, 9), (2, 2)])
def test_nblic_walk_equals_runtime_both_ways(on_host, effort, near):
    for img in SMALL:
        launches = interop_walk.nblic_walk.launches
        stream = nblic.encode(img, near=near, effort=effort, device="cpu")
        assert interop_walk.nblic_walk.launches == launches + 1  # one launch an image
        assert stream == runtime.n_encode(img, near=near, effort=effort), img.shape
        dec = nblic.decode(stream, device="cpu")
        ref, got_near, got_effort = runtime.n_decode(stream)
        np.testing.assert_array_equal(dec, ref)
        assert (got_near, got_effort) == (near, effort)
        assert _err(dec, img) <= near


@pytest.mark.parametrize("effort", [2, 3])
@pytest.mark.parametrize("n_threads,reverse", [(32, True), (1, False), (7, True)])
def test_nblic_walk_any_team(on_host, effort, n_threads, reverse):
    # the phases' channel split over other teams, threads in either order
    on_host(n_threads, reverse)
    for img in (IMAGES[4], IMAGES[8]):  # 23x17 random, 32x24 gradient
        stream = nblic.encode(img, effort=effort, device="cpu")
        assert stream == runtime.n_encode(img, effort=effort), img.shape
        np.testing.assert_array_equal(nblic.decode(stream, device="cpu"), img)


def test_q_decode_walk_equals_runtime(on_host):
    for img in IMAGES:
        stream = runtime.q_encode(img, n_threads=1)
        launches = interop_walk.q_decode_walk.launches
        dec = qnblic.decode(stream, device="cpu")
        assert interop_walk.q_decode_walk.launches == launches + 1
        np.testing.assert_array_equal(dec, img)
        np.testing.assert_array_equal(dec, runtime.q_decode(stream))


@pytest.mark.parametrize("kind", ["random", "flat", "gradient"])
def test_context_chain_equals_plain(on_host, kind):
    rng = np.random.default_rng(7)
    img = {"random": rng.integers(0, 256, (37, 29), dtype=np.uint8),
           "flat": np.full((24, 40), 77, dtype=np.uint8),
           "gradient": IMAGES[8]}[kind]
    x = torch.from_numpy(img).to(torch.int32)
    planes = predict.model_stage1(x)
    px0, err, _, adr = planes
    launches = interop_walk.context_before.launches
    got = qnblic._context_chain_card(x, px0, err, adr)
    assert interop_walk.context_before.launches == launches + 1
    assert torch.equal(got, qnblic._context_chain_plain(x, px0, err, adr))
    stream = qnblic.encode(img, device="cpu")  # the whole encode on K6's chain
    assert stream == runtime.q_encode(img, n_threads=1)


def _nblic_hostile():
    img = np.random.default_rng(0).integers(0, 256, (4, 5), dtype=np.uint8)
    stream = runtime.n_encode(img, near=0, effort=1)
    rng = np.random.default_rng(1)
    bad = [stream[:-1], stream[:-3]]
    bad += [stream[:16] + rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (1, 3, 40)]
    bad.append(runtime.n_encode(np.array([[9, 200]], np.uint8), near=0, effort=1)[:17])
    # the garbage again under efforts 2 and 3 and near 5 (header bytes 13, 15)
    for effort, near in ((2, 0), (3, 0), (1, 5)):
        b = bytearray(bad[4])
        b[13], b[15] = near, effort
        bad.append(bytes(b))
    return bad


@pytest.mark.parametrize("case", range(9))
def test_nblic_hostile_streams_match_plain(on_host, case):
    # reads past the end give 0; the unary walks stop at the guard
    b = _nblic_hostile()[case]
    got = nblic.decode(b, device="cpu")
    with pytest.MonkeyPatch.context() as m:
        m.setattr(nblic, "_walk", nblic._walk_plain)
        want = nblic.decode(b, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_q_hostile_streams_match_plain(on_host):
    img = np.random.default_rng(2).integers(0, 256, (6, 7), dtype=np.uint8)
    stream = runtime.q_encode(img, n_threads=1)
    rng = np.random.default_rng(3)
    body = len(stream) // 2 * 2
    words = np.frombuffer(stream[:body], dtype=np.uint16)
    pos = QnblicHeader.SIZE // 2
    for _ in range(12):
        _, pos = histogram.deserialize(words, pos)
    # a cut, garbage of the stream's length, a one-word stream (read twice)
    bad = [stream[:body - 20], stream[:-2] + rng.integers(0, 256, 2, dtype=np.uint8).tobytes(),
           stream[:2 * pos + 2]]
    for b in bad:  # reads past the end take the last word
        got = qnblic.decode(b, device="cpu")
        with pytest.MonkeyPatch.context() as m:
            m.setattr(qnblic, "_decode_walk", qnblic._decode_walk_plain)
            np.testing.assert_array_equal(got, qnblic.decode(b, device="cpu"))
    for walk in (interop_walk.q_decode_walk, qnblic._decode_walk_plain):  # no payload
        with pytest.MonkeyPatch.context() as m:
            m.setattr(qnblic, "_decode_walk", walk)
            with pytest.raises(ValueError, match="empty"):
                qnblic.decode(stream[:2 * pos], device="cpu")


def test_encode_past_capacity_raises(on_host, monkeypatch):
    img = np.random.default_rng(4).integers(0, 256, (6, 6), dtype=np.uint8)
    monkeypatch.setattr(nblic, "capacity", lambda h, w: 8)
    with pytest.raises(ValueError, match="capacity"):
        nblic.encode(img, device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        nblic.encode(img, effort=3, device="cpu")


def test_wrappers_refuse(on_host):
    st = nblic.rc.coder_init_encode(torch.zeros(64, dtype=torch.uint8))
    for effort, k_step, near in ((0, 3, 0), (4, 3, 0), (1, 1, 0), (1, 3, -1)):
        with pytest.raises(ValueError):
            interop_walk.nblic_walk(st, 2, 2, near, k_step, effort)
    with pytest.raises(ValueError, match="empty"):
        interop_walk.q_decode_walk(torch.zeros(0, dtype=torch.int64), None, None, None, 2, 2)
    stream = bytearray(runtime.n_encode(IMAGES[3], near=0, effort=1))
    stream[14] = 1  # k_step 1: the walk would index past the counter tree
    with pytest.raises(ValueError, match="k_step"):
        nblic.decode(bytes(stream), device="cpu")
