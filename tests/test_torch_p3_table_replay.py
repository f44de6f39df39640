"""Kernel K9's image-table replay (``nblic_tpu_torch/csrc/image_tables.cuh``)
on the CPU, against its plain version, and the plain version against
nblic_tpu.

The replay's phases (the adds, the marked sweeps, the rewrite of the
int16 bias table and the mapper's order) are ``__host__ __device__``: g++
compiles them here into a small ctypes library under ``build/`` (as
``tests/test_torch_p3_row_scan.py`` builds K8's scan), and
``replay_image`` runs with a team of virtual threads, one after another
between the kernel's barriers.  It is held to
``table_replay.replay_plain`` over successive launches of every schedule
the walks use, with caps low enough that entries one halving leaves past
their thresholds halve again untouched, errors of both signs and past
2^26 in sum, tied mapper counts and two images; ``replay_plain`` is held
to nblic_tpu's ``_bias_update``, ``quantize_bias``, ``mapper_updates`` and
``mapper_ranks`` (inverted) on the same numpy inputs.  The wrapper's
refusals are tested too.  Tolerance 0.

:func:`emulated_launch` and :func:`cpu_check_tensors` let the walks'
card loops run here (``tests/test_torch_p3_decode_walk.py``,
``tests/test_torch_p3_near_walk.py``): K9 by its plain version, the
wrappers' checks of shapes and dtypes without their device check.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nblic_tpu.models import strips as j_strips
from nblic_tpu.ops import coder3 as j_coder3
from nblic_tpu.ops import context as j_context
from nblic_tpu_torch import kernels
from nblic_tpu_torch.constants import Q_N_CONTEXT
from nblic_tpu_torch.ops import coder3, table_replay

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "nblic_tpu_torch" / "csrc"
HEADERS = ("coder3.cuh", "image_tables.cuh")

SHIM = r"""
#include "image_tables.cuh"

namespace {
// A CTA of n_threads virtual threads, run one after another between the
// replay's barriers.
struct HostTeam {
  int n_threads;
  HostAtomics at;
  template <class F>
  void threads(F f) const {
    for (int t = 0; t < n_threads; ++t) f(t, n_threads);
  }
  void sync() const {}
};
}  // namespace

extern "C" {
// K9's launch on the host: the kernel's CTAs, image by image, over the
// walk's tables as p3_table_replay.cu lays them out
void replay_host(const int64_t* idx, const int64_t* dx, const int64_t* key, const int64_t* y,
                 int64_t* bsum, int64_t* bcnt, uint32_t* bmark, int16_t* btab, int64_t* mhist,
                 uint32_t* mmark, int64_t* order, int lanes, int n_imgs, int w, int bias_cap,
                 int bias_shrink, int map_bump, int map_halve, int map, int m0, int bias, int b0,
                 int j1, int n_threads) {
  const ReplayContract c{lanes / n_imgs, w, bias_cap, bias_shrink, map_bump, map_halve};
  const ReplayPlanes p{idx, dx, key, y, lanes};
  const ReplaySpan s{map, m0, bias, b0, j1};
  for (int img = 0; img < n_imgs; ++img) {
    ReplayShared sh;
    const size_t ctx = static_cast<size_t>(img) * kContexts;
    const size_t hist = static_cast<size_t>(img) * kMapKeys * kNMap;
    const ReplayTables tb{bsum + ctx, bcnt + ctx, bmark + img * kBiasWords, btab + ctx,
                          mhist + hist, mmark + img * kMapWords, order + hist};
    replay_launch(c, p, tb, sh, img, s, HostTeam{n_threads, HostAtomics{}});
  }
}
}
"""


@pytest.fixture(scope="module")
def lib():
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.fail("g++ is needed to compile image_tables.cuh's host path")
    digest = hashlib.sha256(b"".join((CSRC / h).read_bytes() for h in HEADERS)
                            + SHIM.encode()).hexdigest()[:16]
    out_dir = ROOT / "build" / "test_p3_table_replay"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"libreplay_{digest}.so"
    if not so.exists():
        src = out_dir / f"shim_{digest}_{os.getpid()}.cpp"
        tmp = out_dir / f"libreplay_{digest}_{os.getpid()}.so"
        src.write_text(SHIM)
        subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I", str(CSRC),
                        "-o", str(tmp), str(src)], check=True, capture_output=True, text=True)
        src.unlink()
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.replay_host.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 13
    return lib


def emulated_launch(walk, map_cols=None, bias_cols=None):
    """What one K9 launch computes, by its plain version, on CPU tensors."""
    table_replay.replay_plain(walk.tables, walk.planes, walk.con, map_cols, bias_cols)
    emulated_launch.launches += 1


emulated_launch.launches = 0


def cpu_check_tensors(want, device, kernel):
    """kernels.check_tensors without the device: shapes and dtypes, then
    contiguity, on CPU tensors."""
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{name} must be {tuple(shape)} {dtype}, got {tuple(t.shape)} "
                             f"{t.dtype}")
    for name, (t, _, _) in want.items():
        assert t.device == device and t.is_contiguous(), name


def host_launch(lib, walk, map_cols=None, bias_cols=None, n_threads=512):
    """K9's replay_image on the host over a walk's CPU tables, in place."""
    idx, dx, key, y = walk.planes
    tb, con = walk.tables, walk.con
    m0, m1 = map_cols if map_cols is not None else (0, 0)
    b0, b1 = bias_cols if bias_cols is not None else (0, 0)
    lanes = idx.shape[1]
    lib.replay_host(idx.data_ptr(), dx.data_ptr(), None if key is None else key.data_ptr(),
                    None if y is None else y.data_ptr(), *(t.data_ptr() for t in tb), lanes,
                    lanes // con.lanes_per_image, con.w, con.bias_cap, con.bias_shrink,
                    con.map_bump, con.map_halve, int(map_cols is not None), m0,
                    int(bias_cols is not None), b0, max(m1, b1), n_threads)


def _planes(rng, w, lanes, lpi, big=False):
    """Seeded (W, L) int64 planes: contexts and keys drawn from 3 of 12
    each, a call's own 3, so that moments and counts build up fast in one
    call and stay untouched in the next; errors of both signs (where
    ``big``, 2^22 to 2^24 each, a context's all of one sign, so that its
    sum passes 2^26); y below 20 mostly, drawn from few values so that
    counts tie."""
    img = torch.arange(lanes) // lpi
    pick = torch.from_numpy(rng.choice(rng.permutation(12)[:3], (w, lanes)))
    idx = img * Q_N_CONTEXT + pick * 487 % Q_N_CONTEXT
    if big:
        dx = torch.from_numpy(rng.integers(1 << 22, 1 << 24, (w, lanes))) * (1 - 2 * (pick & 1))
    else:
        dx = torch.from_numpy(rng.integers(-255, 256, (w, lanes)))
    key = torch.from_numpy(rng.choice(rng.permutation(12)[:3], (w, lanes)) * 97
                           % coder3.MAP_KEYS)
    y = torch.from_numpy(np.where(rng.random((w, lanes)) < 0.85, rng.integers(0, 6, (w, lanes)),
                                  rng.integers(0, 40, (w, lanes))))
    return idx, dx, key, y


def _schedule(kind, w, ws):
    """The walks' launches over one row, (map_cols, bias_cols) each:
    ``seg`` seg_map and seg_bias, ``seg_map`` seg_map with the bias at the
    row's end, ``seg_bias`` the other way, ``row`` one launch a row,
    ``static`` the mapper alone a row (a static bias table), ``near`` the
    bias alone a row (the near walk)."""
    out = []
    for c0 in range(0, w, ws):
        c1, end = c0 + ws, c0 + ws == w
        if kind == "seg":
            out.append(((c0, c1), (c0, c1)))
        elif kind == "seg_map":
            out.append(((c0, c1), (0, w) if end else None))
        elif kind == "seg_bias":
            out.append(((0, w) if end else None, (c0, c1)))
    return {"row": [((0, w), (0, w))], "static": [((0, w), None)],
            "near": [(None, (0, w))]}.get(kind, out)


def _clone(tb):
    return table_replay.Tables(*(t.clone() for t in tb))


def _assert_tables(got, want, what):
    for name, g, v in zip(table_replay.Tables._fields, got, want):
        assert torch.equal(g, v), f"{name} after {what}"


# (schedule, images, lanes an image, W, ws, bias_cap, bias_shrink, map_bump,
# map_halve, errors past 2^24): the caps low against the events a launch
# brings, so that a halving leaves entries past and the next update halves
# them again
CASES = {
    "seg-two-images": ("seg", 2, 3, 16, 4, 3, 2, 5, 12, False),
    "seg_map": ("seg_map", 1, 4, 12, 3, 5, 0, 4, 9, False),
    "seg_bias": ("seg_bias", 2, 2, 8, 2, 2, 7, 3, 14, False),
    "row": ("row", 2, 5, 10, 10, 4, 0, 4, 30, False),
    "static": ("static", 1, 6, 8, 8, 1, 0, 9, 8, False),
    "near-wide-errors": ("near", 2, 4, 9, 9, 6, 0, 4, 20, True),
    "seg-wide-errors": ("seg", 1, 2, 8, 4, 9, 48, 2, 15, True),
}


@pytest.mark.parametrize("n_threads", [512, 64, 32])
@pytest.mark.parametrize("case", list(CASES))
def test_host_replay_matches_plain(lib, case, n_threads):
    kind, n_imgs, lpi, w, ws, cap, shrink, bump, halve, big = CASES[case]
    rng = np.random.default_rng(len(case) * 7 + n_threads)
    con = table_replay.Contract(lpi, w, cap, shrink, bump, halve)
    lanes = n_imgs * lpi
    bias_tab = None
    if kind == "static":
        bias_tab = torch.from_numpy(rng.integers(-2048, 2048, n_imgs * Q_N_CONTEXT))
    plain = table_replay.new_tables(n_imgs, con, "cpu", bias_tab)
    host = _clone(plain)
    halved_untouched = False
    for row in range(5):
        planes = _planes(rng, w, lanes, lpi, big=big)
        want_w = table_replay.Walk(plain, planes, con)
        got_w = table_replay.Walk(host, planes, con)
        for map_cols, bias_cols in _schedule(kind, w, ws):
            before = _clone(plain)
            table_replay.replay_plain(plain, *want_w[1:], map_cols, bias_cols)
            host_launch(lib, got_w, map_cols, bias_cols, n_threads)
            _assert_tables(host, plain, f"row {row}, map {map_cols}, bias {bias_cols}")
            if bias_cols is not None:  # a context this launch did not touch halved
                touched = torch.zeros(n_imgs * Q_N_CONTEXT, dtype=torch.bool)
                touched[planes[0][slice(*bias_cols)].reshape(-1)] = True
                halved_untouched |= bool(((plain.bcnt != before.bcnt) & ~touched).any())
            if map_cols is not None:
                keys = torch.zeros(n_imgs * coder3.MAP_KEYS, dtype=torch.bool)
                img = torch.arange(lanes) // lpi
                cols = slice(*map_cols)
                keys[(img * coder3.MAP_KEYS + planes[2])[cols].reshape(-1)] = True
                changed = (plain.mhist != before.mhist).any(-1).reshape(-1)
                halved_untouched |= bool((changed & ~keys).any())
    assert halved_untouched, "no entry halved again untouched: raise the events or lower the caps"
    if kind == "static":
        assert torch.equal(host.btab, bias_tab.to(torch.int16))
    if big:
        assert int(plain.bsum.abs().max()) >= 1 << 26  # quantize_bias's numerator wraps


def _edge_launches(kind):
    """(contract, [planes of each launch]) of one image whose launches each
    take one path of the sweep: ``halved-untouched``, a launch whose only
    halvings are of entries an earlier one left marked and it does not
    touch; ``passes``, launches that take a context and a key past their
    thresholds (one halved back below, one left past); ``equal``, every
    pixel of a launch on one context and one (key, y), errors of one sign
    past 2^23 (a warp's equal addresses, whose sum passes 2^32); ``big``,
    bumps of 2^25 that take a key's counts past 2^26 unhalved (its order
    ranked by int64 compares, not 32-bit keys)."""
    lpi, w = (64, 4) if kind == "equal" else (4, 8)
    n = lpi * w
    pix = np.arange(n).reshape(w, lpi)
    bump, halve = (1 << 25, (1 << 31) - 1) if kind == "big" else (4, 60)
    con = table_replay.Contract(lpi, w, {"halved-untouched": 2, "passes": 5, "equal": 24,
                                         "big": 24}[kind], 1, bump, halve)
    if kind == "halved-untouched":
        rows = [(np.full((w, lpi), 5), np.full((w, lpi), 7), np.zeros((w, lpi))),
                (100 + pix // 2, 200 + pix // 2, pix % 2)]
    elif kind == "passes":
        rows = [(np.where(pix < 4, 3, 50 + pix), np.where(pix < 4, 9, 300 + pix),
                 np.where(pix < 4, 2, 1)),
                (np.where(pix < 4, 3, np.where(pix < 24, 4, 60 + pix)),
                 np.where(pix < 4, 9, 300 + pix), np.where(pix < 4, 2, 1))]
    elif kind == "big":
        rows = [(pix % 7, np.full((w, lpi), 7), pix % 5)] * 3
    else:
        rows = [(np.full((w, lpi), 11), np.full((w, lpi), 13), np.full((w, lpi), 5))] * 3
    rng = np.random.default_rng(len(kind))
    launches = []
    for ctx, key, y in rows:
        if kind == "equal":
            dx = rng.integers(1 << 23, 1 << 25, (w, lpi))
        else:
            dx = rng.integers(-255, 256, (w, lpi))
        launches.append(tuple(torch.from_numpy(np.asarray(v, dtype=np.int64))
                              for v in (ctx, dx, key, y)))
    return con, launches


@pytest.mark.parametrize("n_threads", [32, 128, 512])
@pytest.mark.parametrize("kind", ["halved-untouched", "passes", "equal", "big"])
def test_host_replay_edge_launches(lib, kind, n_threads):
    con, launches = _edge_launches(kind)
    plain = table_replay.new_tables(1, con, "cpu")
    host = _clone(plain)
    for k, planes in enumerate(launches):
        before = _clone(plain)
        cols = (0, con.w)
        table_replay.replay_plain(plain, planes, con, cols, cols)
        host_launch(lib, table_replay.Walk(host, planes, con), cols, cols, n_threads)
        _assert_tables(host, plain, f"{kind} launch {k}")
        if kind == "halved-untouched" and k == 1:  # halved, untouched, rewritten
            assert plain.bcnt[5] == before.bcnt[5] >> 1 and plain.bmark[0, 0] >> 5 & 1
            assert torch.equal(plain.mhist[0, 7], before.mhist[0, 7] >> 1)
            assert before.mmark[0, 0] >> 7 & 1 and not plain.mmark[0, 0] >> 7 & 1
        if kind == "passes" and k == 1:  # context 3 and key 9 passed and were halved back
            assert plain.bcnt[3] == 4 and not plain.bmark[0, 0] >> 3 & 1
            assert plain.bmark[0, 0] >> 4 & 1 and int(plain.mhist[0, 9].amax()) <= con.map_halve
    if kind == "equal":  # a launch's sum on one context passes 2^32
        assert all(int(planes[1].sum()) > 1 << 32 for planes in launches)
    if kind == "big":
        assert int(plain.mhist[0, 7].amax()) > 1 << 26


def test_host_replay_ties_in_the_order(lib):
    """Counts that tie after a bump or a halving: the lower y first."""
    con = table_replay.Contract(1, 4, 100, 0, 2, 7)
    plain = table_replay.new_tables(1, con, "cpu")
    host = _clone(plain)
    # key 3: y 1 and 0 bumped to tie with the counts above them, then
    # halvings make neighbours equal
    for ys in ([1, 1, 0, 5], [19, 18, 2, 2], [7, 7, 7, 8], [0, 0, 0, 0]):
        y = torch.tensor(ys, dtype=torch.int64)[:, None]
        key = torch.full_like(y, 3)
        planes = (torch.zeros_like(y), torch.zeros_like(y), key, y)
        table_replay.replay_plain(plain, planes, con, (0, 4), None)
        host_launch(lib, table_replay.Walk(host, planes, con), (0, 4), None)
        _assert_tables(host, plain, f"y {ys}")
    h = plain.mhist[0, 3]
    assert len(set(h.tolist())) < coder3.N_MAP  # ties are there


def test_replay_plain_matches_jax():
    """replay_plain's successive updates against nblic_tpu's functions on
    the same numpy inputs: the moments by _bias_update, the table by
    quantize_bias, the history by mapper_updates, the order as mapper_ranks
    inverted.  nblic_tpu's moments are int32 and its segment sum exact for
    errors within 2^8, as a pixel's are; its quantizer's numerator wraps in
    int32 past |sum| 2^26, which the second run reaches from moments that
    start there (as a long walk's may)."""
    rng = np.random.default_rng(21)
    n_imgs, lpi, w = 2, 3, 8
    lanes = n_imgs * lpi
    for cap, shrink, bump, halve, big in ((3, 5, 4, 11, False), (40, 0, 3, 60, True)):
        con = table_replay.Contract(lpi, w, cap, shrink, bump, halve)
        tb = table_replay.new_tables(n_imgs, con, "cpu")
        if big:
            tb.bsum.copy_(torch.from_numpy(rng.integers(1 << 26, 1 << 30, tb.bsum.shape)
                                           * rng.choice([-1, 1], tb.bsum.shape)))
            tb.bcnt.copy_(torch.from_numpy(rng.integers(1, cap + 1, tb.bcnt.shape)))
        j_sums = jnp.asarray(tb.bsum.numpy(), jnp.int32)
        j_cnts = jnp.asarray(tb.bcnt.numpy(), jnp.int32)
        j_hist = j_coder3.init_mapper(n_imgs)
        img = np.repeat(np.arange(n_imgs), lpi)
        for row in range(4):
            idx, dx, key, y = (p.numpy() for p in _planes(rng, w, lanes, lpi))
            table_replay.replay_plain(tb, tuple(map(torch.from_numpy, (idx, dx, key, y))), con,
                                      (0, w), (0, w))
            j_sums, j_cnts = j_strips._bias_update(j_sums, j_cnts, jnp.asarray(idx.T),
                                                   jnp.asarray(dx.T, jnp.int32), cap)
            j_hist = j_coder3.mapper_updates(j_hist, jnp.asarray(img), jnp.asarray(key.T),
                                             jnp.asarray(y.T), bump, halve)
            np.testing.assert_array_equal(tb.bsum.numpy(), np.asarray(j_sums))
            np.testing.assert_array_equal(tb.bcnt.numpy(), np.asarray(j_cnts))
            np.testing.assert_array_equal(
                tb.btab.numpy(), np.asarray(j_context.quantize_bias(j_sums, j_cnts, shrink)))
            np.testing.assert_array_equal(tb.mhist.numpy(), np.asarray(j_hist))
            ranks, _ = j_coder3.mapper_ranks(j_hist)
            np.testing.assert_array_equal(tb.order.numpy(), np.argsort(np.asarray(ranks), -1))
        if big:
            assert int(tb.bsum.abs().max()) >= 1 << 26


# ---- the wrapper's refusals


def _walk_inputs(n_imgs=2, lpi=3, w=8):
    con = table_replay.Contract(lpi, w, 4, 0, 4, 9)
    tb = table_replay.new_tables(n_imgs, con, "cpu")
    planes = _planes(np.random.default_rng(1), w, n_imgs * lpi, lpi)
    return tb, planes, con


@pytest.mark.parametrize("case", ["cpu", "lanes", "width", "dtype", "key-alone", "table",
                                  "bias_cap"])
def test_prepare_refuses_what_k9_cannot_run(monkeypatch, case):
    monkeypatch.setattr(kernels, "library", lambda: pytest.fail("launched"))
    tb, planes, con = _walk_inputs()
    idx, dx, key, y = planes
    match = {"cpu": "CUDA", "lanes": "images", "width": "images", "dtype": "dx",
             "key-alone": "key and y", "table": "order", "bias_cap": "bias_cap"}[case]
    if case == "lanes":
        con = con._replace(lanes_per_image=4)
    elif case == "width":
        con = con._replace(w=9)
    elif case == "dtype":
        dx = dx.to(torch.int32)
    elif case == "key-alone":
        y = None
    elif case == "table":
        tb = tb._replace(order=tb.order[..., :4])
    elif case == "bias_cap":
        con = con._replace(bias_cap=0)
    with pytest.raises(ValueError, match=match):
        table_replay.prepare(tb, (idx, dx, key, y), con)


def test_launch_refuses_before_the_library(monkeypatch):
    monkeypatch.setattr(kernels, "library", lambda: pytest.fail("launched"))
    tb, (idx, dx, key, y), con = _walk_inputs()
    bias_only = table_replay.Walk(tb, (idx, dx, None, None), con)
    with pytest.raises(ValueError, match="key and y"):
        table_replay.launch(bias_only, (0, 8), None)
    walk = table_replay.Walk(tb, (idx, dx, key, y), con)
    with pytest.raises(ValueError, match="one column"):
        table_replay.launch(walk, (0, 4), (0, 8))


def test_prepare_passes_a_walks_tensors(monkeypatch):
    # the same tensors pass where only the device differs
    monkeypatch.setattr(kernels, "check_tensors", cpu_check_tensors)
    tb, planes, con = _walk_inputs()
    walk = table_replay.prepare(tb, planes, con)
    assert walk.tables is tb and walk.con == con
    table_replay.prepare(tb, (*planes[:2], None, None), con)
