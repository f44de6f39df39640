"""Kernel K8's coding scan (``nblic_tpu_torch/csrc/row_scan.cuh``) on the
CPU, against the port's plain versions.

The scan's per-lane and per-image steps are ``__host__ __device__``: g++
compiles them here into a small ctypes library under ``build/`` (as
``tests/test_torch_udiv64.py`` builds its own), and ``scan_image`` runs on
one host thread, its lanes one by one in the kernel's phase order (walk,
adds, sweeps a segment).  It is held to ``strips._row_scan_plain`` and
``strips._near_code_plain`` on the same seeded planes, the bias quantizer
to ``context.quantize_bias``, the mapper's rank to ``coder3.mapper_ranks``,
the sweeps to the plain halvings.  The dispatchers ``strips._row_scan`` /
``_near_code`` and the wrapper's refusals are tested here too.  Tolerance 0.
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
from nblic_tpu_torch.models import strips
from nblic_tpu_torch.ops import coder3, context, row_scan
from nblic_tpu_torch.utils.synth import synth_image

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "nblic_tpu_torch" / "csrc"
HEADERS = ("coder3.cuh", "row_scan.cuh")

SHIM = r"""
#include "row_scan.cuh"
#include <vector>

namespace {
struct NoSync {
  void operator()() const {}
};
struct HostAdd64 {
  void operator()(int64_t* p, int64_t v) const {
    *p = static_cast<int64_t>(static_cast<uint64_t>(*p) + static_cast<uint64_t>(v));
  }
};
}  // namespace

extern "C" {
int scan_host(const int32_t* planes, int16_t* probs, int8_t* bins, uint8_t* masks,
              int32_t* utab, int32_t* rtab, int32_t* keep, int lanes, int n_imgs,
              const int* contract) {
  const ScanContract c = scan_contract(contract);
  if (!scan_contract_ok(c, lanes, n_imgs)) return 1;
  const ScanData d{planes, probs, bins, masks, utab, rtab, keep, lanes};
  std::vector<int64_t> tables(2 * kScanCtx + kMapKeys * kNMap);
  for (int img = 0; img < n_imgs; ++img) {
    const ImageTables tb{tables.data(), tables.data() + kScanCtx, tables.data() + 2 * kScanCtx};
    scan_image(c, d, tb, img, 0, 1, NoSync{}, HostAdd64{});
  }
  return 0;
}
void quantize_many(const int64_t* sums, const int64_t* cnts, int shrink, int32_t* out,
                   long long n) {
  for (long long k = 0; k < n; ++k) out[k] = quantize_bias(sums[k], cnts[k], shrink);
}
void rank_many(const int64_t* h, const int32_t* y, int32_t* out, long long n) {
  for (long long k = 0; k < n; ++k) out[k] = mapper_rank(h + k * kNMap, y[k]);
}
// phase (c) alone over one image's tables, as one thread
void sweep_host(const int* contract, int32_t* utab, int32_t* rtab, int64_t* bsum,
                int64_t* bcnt, int64_t* mhist) {
  const ScanContract c = scan_contract(contract);
  const ScanData d{nullptr, nullptr, nullptr, nullptr, utab, rtab, nullptr,
                   c.lanes_per_image};
  sweep(c, d, ImageTables{bsum, bcnt, mhist}, 0, true, true, 0, 1);
}
}
"""


@pytest.fixture(scope="module")
def lib():
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.fail("g++ is needed to compile row_scan.cuh's host path")
    digest = hashlib.sha256(b"".join((CSRC / h).read_bytes() for h in HEADERS)
                            + SHIM.encode()).hexdigest()[:16]
    out_dir = ROOT / "build" / "test_p3_row_scan"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"librowscan_{digest}.so"
    if not so.exists():
        src = out_dir / f"shim_{digest}_{os.getpid()}.cpp"
        tmp = out_dir / f"librowscan_{digest}_{os.getpid()}.so"
        src.write_text(SHIM)
        subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I", str(CSRC),
                        "-o", str(tmp), str(src)], check=True, capture_output=True, text=True)
        src.unlink()
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    ptr, i32, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.scan_host.argtypes = [ptr] * 7 + [i32, i32, ptr]
    lib.scan_host.restype = i32
    lib.quantize_many.argtypes = [ptr, ptr, i32, ptr, n]
    lib.rank_many.argtypes = [ptr, ptr, ptr, n]
    lib.sweep_host.argtypes = [ptr] * 6
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data


def shim_scan(lib, planes, n_imgs, tune, k_step, near):
    """K8's scan_image on the host over (L, th, W) planes; returns (probs,
    bins, masks) as torch tensors in the plain versions' layout."""
    stack = np.ascontiguousarray(np.stack([p.numpy() for p in planes]).astype(np.int32))
    _, n_l, th, w = stack.shape
    con = row_scan.contract(tune, k_step, near, n_l // n_imgs, th, w,
                            strips._eff_seg(tune.n_seg, w))
    l_tot = tune.n_unary + strips.L_R
    probs = np.zeros((th, l_tot, n_l, w), dtype=np.int16)
    bins = np.zeros_like(probs, dtype=np.int8)
    masks = np.zeros_like(probs, dtype=np.uint8)
    utab = np.zeros((n_l, 16 * con[7] * 2), dtype=np.int32)
    rtab = np.zeros((n_l, row_scan.REFINE_CELLS), dtype=np.int32)
    keep = np.zeros((n_l, w), dtype=np.int32)
    ints = np.asarray(con, dtype=np.int32)
    rc = lib.scan_host(_ptr(stack), _ptr(probs), _ptr(bins), _ptr(masks), _ptr(utab),
                       _ptr(rtab), _ptr(keep), n_l, n_imgs, _ptr(ints))
    assert rc == 0
    return torch.from_numpy(probs), torch.from_numpy(bins), torch.from_numpy(masks.view(bool))


def _assert_same(got, want):
    for g, w_, name in zip(got, want, ("probs", "bins", "masks")):
        assert g.dtype == w_.dtype, name
        assert torch.equal(g, w_), name


def _pair():
    rng = np.random.default_rng(5)
    return [synth_image(rng, 48, 64), synth_image(rng, 64, 48)]


def _lossless_planes(imgs, th, tune):
    st, *_ = strips._prepare(imgs, th)
    b, s, th, w = st.shape
    x = torch.from_numpy(st).reshape(b * s, th, w)
    seg_w = w // strips._eff_seg(tune.n_seg, w) if tune.seg_stats else 0
    return strips._model_planes(x, strips.AVP_N, seg_w, bool(tune.mix_e),
                                bool(tune.w_pred)), b


@pytest.mark.parametrize("th", [4, 8])
@pytest.mark.parametrize("tune", ["TUNE_V4", "TUNE_MAX", "TUNE_V4S"])
def test_lossless_scan_matches_plain(lib, tune, th):
    t = getattr(strips, tune)
    planes, b = _lossless_planes(_pair(), th, t)
    want = strips._row_scan_plain(*planes, b, t)
    x, px0, adr, qu, qv, qw = planes
    _assert_same(shim_scan(lib, (qu, qv, qw, x, px0, adr), b, t, strips.K_STEP, False), want)


@pytest.mark.parametrize("near", [1, 3])
def test_near_coder_matches_plain(lib, near):
    tune = strips._near_tune(strips.TUNE_V4)
    st, *_ = strips._prepare(_pair(), 4)
    b, s, th, w = st.shape
    x = torch.from_numpy(st).reshape(b * s, th, w)
    y, qu, qv, qw, key = strips._near_walk_plain(x, b, near, strips.AVP_N, tune)
    k_step = strips._k_step(near)
    want = strips._near_code_plain(y, qu, qv, qw, key, b, k_step, tune)
    _assert_same(shim_scan(lib, (qu, qv, qw, y, key), b, tune, k_step, True), want)


def _random_planes(seed, n_l, th, w, near):
    """Seeded planes over the whole of each plane's range: residuals far and
    near the prediction, so symbols escape and walks stop on every layer."""
    rng = np.random.default_rng(seed)
    qu = rng.integers(0, 16, (n_l, th, w))
    qv = np.clip(qu + rng.integers(-1, 2, qu.shape), 0, 15)
    qw = rng.integers(0, 33, qu.shape)
    if near:
        y = np.where(rng.random(qu.shape) < 0.8, rng.integers(0, 24, qu.shape),
                     rng.integers(0, 256, qu.shape))
        key = rng.integers(0, 512, qu.shape)
        planes = (qu, qv, qw, y, key)
    else:
        px0 = rng.integers(0, 256, qu.shape)
        x = np.clip(px0 + np.where(rng.random(qu.shape) < 0.8, rng.integers(-6, 7, qu.shape),
                                   rng.integers(-255, 256, qu.shape)), 0, 255)
        adr = rng.integers(0, 40, qu.shape) * 75  # few contexts: moments build up
        planes = (qu, qv, qw, x, px0, adr)
    return [torch.from_numpy(p.astype(np.int32)) for p in planes]


# contracts every field of which Tune.validate accepts, away from the named ones
ODD_TUNES = {
    "short-walk-seg": strips.Tune(8, 7, 50, 3, 3, 3, 1, 1, 0, 0, cnt_init=5, cnt_halve=64),
    "sym-rowfrozen": strips.Tune(4, 4096, 1, 6, 0, 5, 0, 0, 0, 1, cnt_init=1, cnt_halve=100),
    "one-segment": strips.Tune(32768, 1, 65535, 20, 4096, 1, 1, 1, 0, 1, cnt_init=16384,
                               cnt_halve=65535),
}


@pytest.mark.parametrize("name", list(ODD_TUNES))
def test_lossless_scan_under_odd_contracts(lib, name):
    tune = ODD_TUNES[name].validate()
    planes = _random_planes(7, 6, 5, 30, False)
    qu, qv, qw, x, px0, adr = planes
    want = strips._row_scan_plain(x, px0, adr, qu, qv, qw, 2, tune)
    _assert_same(shim_scan(lib, planes, 2, tune, strips.K_STEP, False), want)


@pytest.mark.parametrize("near", [1, 2, 7])
@pytest.mark.parametrize("name", ["short-walk-seg", "sym-rowfrozen"])
def test_near_coder_under_odd_contracts(lib, name, near):
    tune = strips._near_tune(ODD_TUNES[name])
    planes = _random_planes(near, 4, 3, 20, True)
    qu, qv, qw, y, key = planes
    k_step = strips._k_step(near)
    want = strips._near_code_plain(y, qu, qv, qw, key, 2, k_step, tune)
    _assert_same(shim_scan(lib, planes, 2, tune, k_step, True), want)


def test_over_cap_in_one_update(lib):
    """One bias context, one mapper key and one counter pair pass twice
    their caps in a single update, so a halving leaves each past its cap and
    the next update halves it again, touched or not."""
    tune = strips.Tune(4, 4096, 10, 4, 0, 2, 1, 1, 0, 0, cnt_init=32, cnt_halve=64).validate()
    n_l, th, w = 16, 3, 32
    ones = torch.ones((n_l, th, w), dtype=torch.int32)
    px0 = 100 * ones
    x = px0 + 1      # error 1: y small, one mapper key
    x[:, 1:] = px0[:, 1:]  # later rows touch nothing new
    planes = (0 * ones, 0 * ones, 0 * ones, x, px0, 5 * ones)  # one context, one pair
    # the scenario: one segment's events leave each table past its cap after
    # the plain version's halving
    idx = torch.full((n_l * w // 2,), 5)
    bsums, bcnts = strips._bias_update(torch.zeros(3072, dtype=torch.int64),
                                       torch.zeros(3072, dtype=torch.int64), idx,
                                       torch.ones_like(idx), tune.bias_cap)
    assert bcnts[5] > tune.bias_cap
    mh = coder3.mapper_updates(coder3.init_mapper(1), torch.zeros(n_l, dtype=torch.int64),
                               torch.zeros((n_l, w // 2), dtype=torch.int64),
                               torch.zeros((n_l, w // 2), dtype=torch.int64), tune.map_bump,
                               tune.map_halve)
    assert mh.amax() > tune.map_halve
    pair = coder3.halve_pairs(torch.tensor([[32 + 32 * w // 2, 32]]), tune.cnt_halve)
    assert pair.sum() > tune.cnt_halve
    qu, qv, qw = planes[:3]
    want = strips._row_scan_plain(x, px0, planes[5], qu, qv, qw, 1, tune)
    _assert_same(shim_scan(lib, planes, 1, tune, strips.K_STEP, False), want)


def test_sweeps_halve_past_twice_the_caps(lib):
    tune = strips.Tune(6, 1, 9, 13, 0, 1, cnt_halve=64).validate()
    con = np.asarray(row_scan.contract(tune, strips.K_STEP, False, 2, 1, 1, 1), dtype=np.int32)
    rng = np.random.default_rng(3)
    utab = rng.integers(1, 200, (2, 16 * con[7] * 2)).astype(np.int32)
    rtab = rng.integers(1, 200, (2, row_scan.REFINE_CELLS)).astype(np.int32)
    bsum = rng.integers(-5000, 5000, 3072).astype(np.int64)
    bcnt = rng.integers(0, 20, 3072).astype(np.int64)
    mhist = rng.integers(0, 30, (512, 20)).astype(np.int64)
    want_u = coder3.halve_pairs(torch.from_numpy(utab).view(2, -1, 2).long(), tune.cnt_halve)
    want_r = coder3.halve_pairs(torch.from_numpy(rtab).view(2, -1, 2).long(), tune.cnt_halve)
    over = bcnt > tune.bias_cap
    want_s, want_c = np.where(over, bsum >> 1, bsum), np.where(over, bcnt >> 1, bcnt)
    mh = torch.from_numpy(mhist)
    want_m = torch.where(mh.amax(-1, keepdim=True) > tune.map_halve, mh >> 1, mh)
    lib.sweep_host(_ptr(con), _ptr(utab), _ptr(rtab), _ptr(bsum), _ptr(bcnt), _ptr(mhist))
    assert torch.equal(torch.from_numpy(utab).view(2, -1, 2).long(), want_u)
    assert torch.equal(torch.from_numpy(rtab).view(2, -1, 2).long(), want_r)
    np.testing.assert_array_equal(bsum, want_s)
    np.testing.assert_array_equal(bcnt, want_c)
    assert torch.equal(torch.from_numpy(mhist), want_m)


def test_quantize_bias_matches_plain(lib):
    edge = [0, 1, 7, (1 << 26) - 1, 1 << 26, (1 << 26) + 1, (1 << 26) + 12345, 1 << 27,
            (1 << 31) - 1, 1 << 31, 3 << 30, 1 << 40, (1 << 62) + 3]
    sums = np.array(edge + [-v for v in edge], dtype=np.int64)
    rng = np.random.default_rng(9)
    sums = np.concatenate([sums, rng.integers(-(1 << 34), 1 << 34, 400),
                           np.array([np.iinfo(np.int64).min, np.iinfo(np.int64).max])])
    for shrink in (0, 48, 4096):
        for cnts in (np.zeros_like(sums), np.ones_like(sums), np.full_like(sums, 7),
                     rng.integers(0, 40000, sums.shape)):
            out = np.empty(sums.shape, dtype=np.int32)
            lib.quantize_many(_ptr(sums), _ptr(cnts), shrink, _ptr(out), sums.size)
            want = context.quantize_bias(torch.from_numpy(sums), torch.from_numpy(cnts), shrink)
            np.testing.assert_array_equal(out, want.numpy())


def test_mapper_rank_matches_stable_sort(lib):
    rng = np.random.default_rng(11)
    h = rng.integers(0, 6, (3000, 20)).astype(np.int64)  # ties everywhere
    h[:500] = 3
    y = rng.integers(0, 20, 3000).astype(np.int32)
    out = np.empty_like(y)
    lib.rank_many(_ptr(h), _ptr(y), _ptr(out), y.size)
    ranks = coder3.mapper_ranks(torch.from_numpy(h)[None])[0]
    np.testing.assert_array_equal(out, ranks[torch.arange(3000), torch.from_numpy(y).long()])


# ---- the dispatchers and the wrapper's refusals


def test_cpu_tensors_run_the_plain_versions(monkeypatch):
    calls = []
    monkeypatch.setattr(strips, "_row_scan_plain", lambda *a: calls.append("scan") or "scan")
    monkeypatch.setattr(strips, "_near_code_plain", lambda *a: calls.append("near") or "near")
    monkeypatch.setattr(row_scan, "scan", lambda *a, **k: pytest.fail("K8 on a CPU tensor"))
    t = torch.zeros((2, 4, 16), dtype=torch.int32)
    assert strips._row_scan(t, t, t, t, t, t, 1, strips.TUNE_V4) == "scan"
    assert strips._near_code(t, t, t, t, t, 1, 5, strips.TUNE_V4) == "near"
    assert calls == ["scan", "near"]


def test_other_devices_raise():
    t = torch.zeros((2, 4, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        strips._row_scan(t, t, t, t, t, t, 1, strips.TUNE_V4)
    with pytest.raises(ValueError, match="cpu or cuda"):
        strips._near_code(t, t, t, t, t, 1, 5, strips.TUNE_V4)


@pytest.mark.parametrize("case", ["count", "shape", "dtype", "images", "device", "segments"])
def test_scan_refuses_before_any_launch(monkeypatch, case):
    monkeypatch.setattr(kernels, "library", lambda: pytest.fail("launched"))
    t = torch.zeros((4, 2, 16), dtype=torch.int32)
    planes, n_imgs, n_seg = [t] * 6, 2, 4
    if case == "count":
        planes = [t] * 5
    elif case == "shape":
        planes = [t] * 5 + [torch.zeros((4, 2, 8), dtype=torch.int32)]
    elif case == "dtype":
        planes = [t] * 5 + [t.float()]
    elif case == "images":
        n_imgs = 3
    elif case == "segments":
        n_seg = 5
    with pytest.raises(ValueError):
        row_scan.scan(planes, n_imgs, strips.TUNE_V4, strips.K_STEP, n_seg, near=False)
