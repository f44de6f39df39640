"""Kernel K8's coding scan (``nblic_tpu_torch/csrc/row_scan.cuh``) on the
CPU, against the port's plain versions.

The scan's per-pixel, per-warp and per-phase steps are ``__host__
__device__``: g++ compiles them here into a small ctypes library under
``build/`` (as ``tests/test_torch_udiv64.py`` builds its own), and
``scan_image`` runs with a team of virtual threads, one after another
between the kernel's barriers (walk, adds, sweeps a segment), each warp's
ballots their loops over its threads.  It is held to
``strips._row_scan_plain`` and ``strips._near_code_plain`` on the same
seeded planes at the kernel's 512 threads and at 64, the bias quantizer to
``context.quantize_bias``, the mapper's rank by votes to
``coder3.mapper_ranks``, a pixel's slots (its stop layer from the votes) to
``strips._seg_slots_update``, the marked sweeps to the plain halvings of
every entry.  The dispatchers ``strips._row_scan`` / ``_near_code`` and
the wrapper's refusals are tested here too.  Tolerance 0.
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
HEADERS = ("coder3.cuh", "image_tables.cuh", "row_scan.cuh")

SHIM = r"""
#include "row_scan.cuh"
#include <vector>

namespace {
// A CTA of n_threads virtual threads, run one after another between the
// scan's barriers.
struct HostTeam {
  int n_threads;
  int by_warp;  // the walk a pixel a warp: 1 always, 0 never, -1 as the card picks
  HostAtomics at;
  std::vector<SlotEvents>* events_kept;  // the walk's events, a thread's each
  bool warp_pixels(const ScanContract& c) const {
    return by_warp < 0 ? ::warp_pixels(c, n_threads / kWarp)
                       : by_warp && !c.sym_cnt && c.lanes_per_image * c.ws <= n_threads / kWarp;
  }
  template <class F>
  void threads(F f) const {
    for (int t = 0; t < n_threads; ++t) f(t, n_threads);
  }
  void sync() const {}
  SlotEvents walk(const ScanContract& c, const ScanData& d, const ImageTables& tb,
                  const LaneTables& lt, int lane0, int r, int j0) const {
    std::vector<SlotEvents>& ev = *events_kept;
    ev.assign(n_threads, SlotEvents{-1, -1, -1, 0, 0, -1});
    for (int task = 0; task < c.lanes_per_image * c.ws; ++task)
      walk_pixel_host(c, d, tb, lt, lane0, r, j0, task, ev.data() + task * kWarp);
    return ev[0];
  }
  void events(const ScanContract& c, const LaneTables& lt, const SlotEvents&) const {
    for (int t = 0; t < n_threads; ++t) add_events(c, lt, (*events_kept)[t], at);
  }
};
}  // namespace

extern "C" {
int scan_host(const int32_t* planes, int16_t* probs, int8_t* bins, uint8_t* masks,
              int32_t* utab, int32_t* rtab, uint32_t* umark, int32_t* keep, int lanes,
              int n_imgs, const int* contract, int n_threads, int by_warp) {
  const ScanContract c = scan_contract(contract);
  if (!scan_contract_ok(c, lanes, n_imgs)) return 1;
  const ScanData d{planes, probs, bins, masks, utab, rtab, umark, keep, lanes};
  std::vector<int64_t> tables(2 * kScanCtx + kMapKeys * kNMap);
  std::vector<uint32_t> marks(kMapKeys / 32 + kScanCtx / 32);
  std::vector<int> consts(kLayerConsts);
  std::vector<SlotEvents> events_kept;
  const int ucells = unary_cells(c), words = counter_words(c);
  for (int img = 0; img < n_imgs; ++img) {
    const ImageTables tb{tables.data(), tables.data() + kScanCtx, tables.data() + 2 * kScanCtx,
                         marks.data() + kMapKeys / 32, marks.data(), consts.data()};
    const size_t lane0 = static_cast<size_t>(img) * c.lanes_per_image;
    const LaneTables lt{utab + lane0 * ucells, rtab + lane0 * 2 * kRefinePairs,
                        umark + lane0 * words, ucells, words};
    scan_image(c, d, tb, lt, img, HostTeam{n_threads, by_warp, HostAtomics{}, &events_kept});
  }
  return 0;
}
void quantize_many(const int64_t* sums, const int64_t* cnts, int shrink, int32_t* out,
                   long long n) {
  for (long long k = 0; k < n; ++k) out[k] = quantize_bias(sums[k], cnts[k], shrink);
}
// the rank as the warp takes it: the count of its threads' votes
void rank_many(const int64_t* h, const int32_t* y, int32_t* out, long long n) {
  for (long long k = 0; k < n; ++k) {
    int votes = 0;
    for (int t = 0; t < kWarp; ++t) votes += rank_vote(h + k * kNMap, y[k], t);
    out[k] = votes;
  }
}
// the slots of n pixels (z, qu, qv, qw each (n,)) of lane `lane[k]`'s
// tables, as a warp codes them: out (n_unary + 8, n) words
void slots_many(const int* contract, const int32_t* z, const int32_t* qu, const int32_t* qv,
                const int32_t* qw, const int32_t* lane, const int32_t* utab,
                const int32_t* rtab, uint32_t* out, long long n) {
  const ScanContract c = scan_contract(contract);
  std::vector<int> consts(kLayerConsts);
  const ImageTables tb{nullptr, nullptr, nullptr, nullptr, nullptr, consts.data()};
  scan_init_consts(c, tb, 0, 1);
  const Layers ly = scan_layers(c, tb);
  for (long long k = 0; k < n; ++k) {
    const PixelIn p{qu[k], scan_adjust_qv(tb, qu[k], qv[k]), qw[k], 0, 0};
    LayerStep s[kWarp];
    code_pixel_host(ly, tb, p, z[k], utab + static_cast<size_t>(lane[k]) * unary_cells(c),
                    rtab + static_cast<size_t>(lane[k]) * 2 * kRefinePairs, s, out + k, n);
  }
}
// phase (c) alone over one image's tables and marks, with n_threads
// virtual threads
void sweep_host(const int* contract, int32_t* utab, int32_t* rtab, uint32_t* umark,
                int64_t* bsum, int64_t* bcnt, int64_t* mhist, uint32_t* bmark, uint32_t* mmark,
                int n_threads) {
  const ScanContract c = scan_contract(contract);
  const ImageTables tb{bsum, bcnt, mhist, bmark, mmark, nullptr};
  const LaneTables lt{utab, rtab, umark, unary_cells(c), counter_words(c)};
  for (int t = 0; t < n_threads; ++t) segment_sweeps(c, tb, lt, true, true, t, n_threads);
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
    lib.scan_host.argtypes = [ptr] * 8 + [i32, i32, ptr, i32, i32]
    lib.scan_host.restype = i32
    lib.quantize_many.argtypes = [ptr, ptr, i32, ptr, n]
    lib.rank_many.argtypes = [ptr, ptr, ptr, n]
    lib.slots_many.argtypes = [ptr] * 9 + [n]
    lib.sweep_host.argtypes = [ptr] * 9 + [i32]
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data


def _words(con) -> int:
    """A lane's mark words: a bit a counter pair."""
    return -(-(16 * con[7] + row_scan.REFINE_CELLS // 2) // 32)


def shim_scan(lib, planes, n_imgs, tune, k_step, near, n_threads=512, by_warp=-1):
    """K8's scan_image on the host over (L, th, W) planes, a team of
    ``n_threads`` virtual threads walking a pixel a warp (``by_warp`` 1),
    a pixel a thread (0) or as the card picks (-1); returns (probs, bins,
    masks) as torch tensors in the plain versions' layout."""
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
    umark = np.zeros((n_l, _words(con)), dtype=np.uint32)
    keep = np.zeros((n_l, w), dtype=np.int32)
    ints = np.asarray(con, dtype=np.int32)
    rc = lib.scan_host(_ptr(stack), _ptr(probs), _ptr(bins), _ptr(masks), _ptr(utab),
                       _ptr(rtab), _ptr(umark), _ptr(keep), n_l, n_imgs, _ptr(ints), n_threads,
                       by_warp)
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


# a team of 2 warps on one lane an image: the walk a pixel a warp where a
# segment holds at most 2 pixels (ws 1 under TUNE_V4 and TUNE_V4S), a pixel
# a thread under TUNE_V1 (ws = W), a lane a thread under TUNE_MAX; a thread
# takes several entries in the sweeps
@pytest.mark.parametrize("tune", ["TUNE_V4", "TUNE_MAX", "TUNE_V4S", "TUNE_V1"])
def test_lossless_scan_on_a_small_team(lib, tune):
    t = getattr(strips, tune)
    planes = _random_planes(21, 2, 3, 32, False)
    qu, qv, qw, x, px0, adr = planes
    want = strips._row_scan_plain(x, px0, adr, qu, qv, qw, 2, t)
    _assert_same(shim_scan(lib, planes, 2, t, strips.K_STEP, False, n_threads=64, by_warp=1),
                 want)


@pytest.mark.parametrize("near", [2, 7])
def test_near_coder_on_a_small_team(lib, near):
    tune = strips._near_tune(strips.TUNE_V4)
    planes = _random_planes(near + 10, 2, 4, 32, True)
    qu, qv, qw, y, key = planes
    k_step = strips._k_step(near)
    want = strips._near_code_plain(y, qu, qv, qw, key, 2, k_step, tune)
    _assert_same(shim_scan(lib, planes, 2, tune, k_step, True, n_threads=64, by_warp=1), want)


# the walk a pixel a warp at the kernel's 512 threads, and a pixel a thread
@pytest.mark.parametrize("by_warp", [1, 0])
@pytest.mark.parametrize("tune", ["TUNE_V4", "TUNE_V4S"])
def test_lossless_scan_either_walk(lib, tune, by_warp):
    t = getattr(strips, tune)
    planes, b = _lossless_planes(_pair(), 8, t)
    want = strips._row_scan_plain(*planes, b, t)
    x, px0, adr, qu, qv, qw = planes
    _assert_same(shim_scan(lib, (qu, qv, qw, x, px0, adr), b, t, strips.K_STEP, False,
                           by_warp=by_warp), want)


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


def _sweep(lib, con, tabs, n_threads):
    utab, rtab, umark, bsum, bcnt, mhist, bmark, mmark = tabs
    lib.sweep_host(_ptr(con), _ptr(utab), _ptr(rtab), _ptr(umark), _ptr(bsum), _ptr(bcnt),
                   _ptr(mhist), _ptr(bmark), _ptr(mmark), n_threads)


@pytest.mark.parametrize("n_threads", [512, 1])
def test_sweeps_halve_past_twice_the_caps(lib, n_threads):
    """The entries past their thresholds marked, as a segment's adds leave
    them, the sweep is the plain halving of every entry; marks stay on what
    is still past its threshold, and a second sweep with nothing added
    halves exactly those again, as the plain version's next update halves
    every entry."""
    tune = strips.Tune(6, 1, 9, 13, 0, 1, cnt_halve=64).validate()
    con = np.asarray(row_scan.contract(tune, strips.K_STEP, False, 2, 1, 1, 1), dtype=np.int32)
    rng = np.random.default_rng(3)
    utab = rng.integers(1, 200, (2, 16 * con[7] * 2)).astype(np.int32)
    rtab = rng.integers(1, 200, (2, row_scan.REFINE_CELLS)).astype(np.int32)
    bsum = rng.integers(-5000, 5000, 3072).astype(np.int64)
    bcnt = rng.integers(0, 40, 3072).astype(np.int64)
    mhist = rng.integers(0, 60, (512, 20)).astype(np.int64)
    pairs = 16 * con[7] + row_scan.REFINE_CELLS // 2

    def marks(over, words):
        bits = np.zeros((over.shape[0], 32 * words), dtype=np.uint8)
        bits[:, :over.shape[1]] = over
        return np.packbits(bits, axis=1, bitorder="little").view(np.uint32).copy()

    u_sum = np.concatenate([utab.reshape(2, -1, 2), rtab.reshape(2, -1, 2)], 1).sum(-1)
    umark = marks(u_sum > tune.cnt_halve, _words(con))
    bmark = marks((bcnt > tune.bias_cap)[None], 96)[0]
    mmark = marks((mhist.max(-1) > tune.map_halve)[None], 16)[0]
    tabs = (utab, rtab, umark, bsum, bcnt, mhist, bmark, mmark)
    want_u = torch.from_numpy(utab).view(2, -1, 2).long()
    want_r = torch.from_numpy(rtab).view(2, -1, 2).long()
    want_s, want_c, want_m = bsum.copy(), bcnt.copy(), torch.from_numpy(mhist.copy())
    for sweep in range(2):
        want_u = coder3.halve_pairs(want_u, tune.cnt_halve)
        want_r = coder3.halve_pairs(want_r, tune.cnt_halve)
        over = want_c > tune.bias_cap
        want_s, want_c = np.where(over, want_s >> 1, want_s), np.where(over, want_c >> 1, want_c)
        want_m = torch.where(want_m.amax(-1, keepdim=True) > tune.map_halve, want_m >> 1, want_m)
        _sweep(lib, con, tabs, n_threads)
        assert torch.equal(torch.from_numpy(utab).view(2, -1, 2).long(), want_u)
        assert torch.equal(torch.from_numpy(rtab).view(2, -1, 2).long(), want_r)
        np.testing.assert_array_equal(bsum, want_s)
        np.testing.assert_array_equal(bcnt, want_c)
        assert torch.equal(torch.from_numpy(mhist), want_m)
        # the marks left: exactly the entries still past their thresholds
        u_over = torch.cat([want_u, want_r], 1).sum(-1) > tune.cnt_halve
        bits = np.unpackbits(umark.view(np.uint8), bitorder="little").reshape(2, -1)[:, :pairs]
        np.testing.assert_array_equal(bits, u_over.numpy())
        b_bits = np.unpackbits(bmark.view(np.uint8), bitorder="little")
        np.testing.assert_array_equal(b_bits, want_c > tune.bias_cap)
        m_bits = np.unpackbits(mmark.view(np.uint8), bitorder="little")
        np.testing.assert_array_equal(m_bits, (want_m.amax(-1) > tune.map_halve).numpy())
        assert u_over.any() and b_bits.any() and m_bits.any()  # some left past after one


def test_pixel_slots_match_seg_slots_update(lib):
    """A pixel's slots as a warp codes them (the unary slots one a thread,
    the stop layer from their votes, the refinement and escape slots from
    the stop row and z) against strips._seg_slots_update on the same
    segment-start tables, at z over 0-255 and every layer's stop."""
    for k_step, n_unary in ((3, 13), (7, 20), (16, 9), (3, 1)):
        tune = strips.TUNE_V4._replace(n_unary=n_unary)
        n_class = strips.zcodec3.layer_consts(k_step, n_unary).n_class
        rng = np.random.default_rng(k_step * 100 + n_unary)
        n_l, ws = 3, 400
        utab = torch.from_numpy(rng.integers(1, 3000, (n_l, 16, n_class, 2)))
        rtab = torch.from_numpy(rng.integers(1, 3000, (n_l, 16, 5, 2, 2)))
        z = torch.from_numpy(np.where(rng.random((n_l, ws)) < 0.7, rng.integers(0, 24, (n_l, ws)),
                                      rng.integers(0, 256, (n_l, ws))))
        qu = torch.from_numpy(rng.integers(0, 16, (n_l, ws)))
        qv = torch.clamp(qu + torch.from_numpy(rng.integers(-2, 3, (n_l, ws))), 0, 15)
        qw = torch.from_numpy(rng.integers(0, 33, (n_l, ws)))
        lane = torch.arange(n_l)[:, None]
        (probs, bins, masks), _ = strips._seg_slots_update(utab, rtab, z, qu, qv, qw, lane,
                                                           k_step, tune)
        con = np.asarray(row_scan.contract(tune, k_step, False, n_l, 1, ws, 1), dtype=np.int32)
        flat = [np.ascontiguousarray(v.numpy().astype(np.int32).ravel())
                for v in (z, qu, qv, qw, lane.expand(n_l, ws))]
        ut = np.ascontiguousarray(utab.numpy().astype(np.int32))
        rt = np.ascontiguousarray(rtab.numpy().astype(np.int32))
        out = np.zeros((n_unary + 8, n_l * ws), dtype=np.uint32)
        lib.slots_many(_ptr(con), *(_ptr(a) for a in flat), _ptr(ut), _ptr(rt), _ptr(out),
                       n_l * ws)
        got_p = (out & 0xFFFF).astype(np.int16).reshape(n_unary + 8, n_l, ws)
        np.testing.assert_array_equal(got_p, probs.numpy())
        np.testing.assert_array_equal((out >> 16) & 1, bins.reshape(n_unary + 8, -1).numpy())
        np.testing.assert_array_equal((out >> 17) & 1, masks.reshape(n_unary + 8, -1).numpy())
        stops = masks[:n_unary].sum(0) - 1  # the stop layer, n_unary where escaped
        assert set(stops.unique().tolist()) >= set(range(min(n_unary, 4)))


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
