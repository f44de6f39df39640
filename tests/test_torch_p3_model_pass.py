"""The profile-3 modeling pass's plain versions (``ops/model_pass.py``)
and K10's arithmetic (``csrc/model_chain.cuh``), on the CPU, tolerance 0.

- ``chains_plain`` against a composition of nblic_tpu's ``col_chain``,
  ``e_chain``, ``f_chain``, ``e_freeze_extend``, ``hold_starts`` and
  ``contributions`` (under ``jax.enable_x64``), on stressed planes, for the
  plain, mix, seg_stats and w_pred forms;
- ``solve_plain`` against nblic_tpu's ``predict_chunked`` on ridge systems
  with singular ones and pivots at INT64_MIN;
- the pass as the card runs it (``model_pass.predict_plane`` on CPU
  tensors, the plain versions in the kernels' places) against
  ``pavp.predict_plane``'s loops under every form;
- ``model_chain.cuh``'s host branch, built with g++ into
  ``build/test_p3_model_pass/``, against ``pavp.decay``, ``pavp._moments``,
  ``pavp._clip_s_sum`` and the energy channel's sample weight over edge
  numerators, signs and every divisor the sample weight takes.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nblic_tpu.ops import avp as j_avp
from nblic_tpu.ops import pavp as j_pavp
from nblic_tpu_torch.ops import avp, model_pass, pavp
from test_torch_p3_pavp import _stressed_strips

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
HEADER = ROOT / "nblic_tpu_torch" / "csrc" / "model_chain.cuh"
I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1
N = 10
# (seg_w, w_quant, mix) of each form: plain, mix_e, seg_stats (E frozen
# and decay-extended), w_pred (E and F held)
FORMS = {"plain": (0, False, False), "mix": (0, False, True), "seg_stats": (4, False, False),
         "w_pred": (4, True, False)}
SOLVES = [(False, 1), (True, 1), (True, 4)]  # (w_quant, pixels a statistics row)


def _np(t):
    return np.asarray(t)


def _planes(n=N):
    """(x (2, 16, 24) int64, fe, px_s): the checkerboard and noise planes
    of the stressed strips with their features and simple prediction."""
    x = torch.from_numpy(_stressed_strips()[2:])
    fe, px_s = model_pass.features(x, n)
    return x, fe, px_s


def _j_run_chains(contrib, ab, seg_w, w_quant):
    """nblic_tpu's run_chains on (C, S, H, W) numpy contributions, each
    channel decaying by its ``ab`` (first_beta when ab[0] is BETA)."""
    c, s, h, w = contrib.shape
    abv = jnp.asarray(ab, jnp.int64)[:, None]
    first_beta = ab[0] == j_avp.BETA
    b_new = j_pavp.col_chain(jnp.asarray(contrib.transpose(2, 0, 1, 3).reshape(h, c, s * w)),
                             ab=abv).reshape(h, c, s, w).transpose(1, 2, 0, 3)
    b_prev = jnp.concatenate([jnp.zeros_like(b_new[:, :, :1]), b_new[:, :, :-1]], axis=2)
    e = j_pavp.e_chain(b_new.transpose(3, 0, 1, 2).reshape(w, c, s * h), ab=abv)
    f = j_pavp.f_chain(b_prev.transpose(3, 0, 1, 2).reshape(w, c, s * h), ab=abv)
    if seg_w and w_quant:
        e, f = j_pavp.hold_starts(e, seg_w), j_pavp.hold_starts(f, seg_w)
    elif seg_w:
        e = j_pavp.e_freeze_extend(e, seg_w, first_beta)
    return _np((e + f).reshape(w, c, s, h).transpose(1, 2, 3, 0))


def _j_stats(x, feats, px_s, seg_w, w_quant, n=N):
    """The model's (m, S, H, W) statistics by nblic_tpu's chains and
    contributions."""
    s_curr = np.abs(x - px_s) << 12
    e0 = _j_run_chains(s_curr[None], [j_avp.BETA], seg_w, w_quant)[0]
    s_sum = e0 + _np(j_avp.tdiv(jnp.asarray(s_curr * 3), jnp.int64(2)))
    contrib = _np(j_pavp.contributions(jnp.asarray(x.reshape(-1)), jnp.asarray(
        feats.reshape(n, -1)), jnp.asarray(s_curr.reshape(-1)), jnp.asarray(s_sum.reshape(-1)),
        n)).reshape((-1,) + x.shape)
    moments = _j_run_chains(contrib[1:], [j_avp.ALPHA] * (n + n * n), seg_w, w_quant)
    return np.concatenate([e0[None], moments])


def _hard(xn, psn):
    """A hard prediction for the mix chains: the simple one moved by a
    pattern of the pixel to the left."""
    return np.clip(psn + np.roll(xn, 1, axis=2) % 7 - 3, 0, 255)


@pytest.fixture(scope="module")
def jax_refs():
    """nblic_tpu's results for every case of this file, computed once:
    {form: statistics (or mix chains)}, {(w_quant, seg): (px_v, ok)}.  The
    solves run with jit disabled, so that their cases share the compiled
    operations of the elimination (~20 s; each jitted program ~16 s)."""
    x, fe, px_s = _planes()
    xn = x.numpy().astype(np.int64)
    feats = fe[:, 1:].t().reshape((N,) + tuple(x.shape)).numpy().astype(np.int64)
    psn = px_s.numpy().astype(np.int64)
    st = _systems()
    solve_fe = _solve_inputs(st.shape[1] * 4)[0]
    chains, solves = {}, {}
    with jax.enable_x64():
        for form, (seg_w, w_quant, mix) in FORMS.items():
            if mix:
                hard = _hard(xn, psn)
                chains[form] = _j_run_chains(
                    np.stack([np.abs(xn - hard) << 12, np.abs(xn - psn) << 12]),
                    list(_np(j_pavp.mix_ab())[:, 0]), 0, False)
            else:
                chains[form] = _j_stats(xn, feats, psn, seg_w, w_quant)
    with jax.enable_x64(), jax.disable_jit():
        for w_quant, seg in SOLVES:
            fe_s = solve_fe[: st.shape[1] * seg]
            px_v, ok = j_pavp.predict_chunked(jnp.asarray(np.repeat(st, seg, axis=1)),
                                              jnp.asarray(fe_s[:, 1:].T.astype(np.int64)), N,
                                              w_quant)
            solves[w_quant, seg] = (_np(px_v), _np(ok))
    return chains, solves


@pytest.mark.parametrize("form", list(FORMS))
def test_chains_plain_against_jax(form, jax_refs):
    seg_w, w_quant, mix = FORMS[form]
    x, fe, px_s = _planes()
    shape = tuple(x.shape)
    want = jax_refs[0][form]
    if mix:
        hard = _hard(x.numpy().astype(np.int64), px_s.numpy().astype(np.int64))
        got = model_pass.chains_plain(fe, torch.stack([torch.from_numpy(hard).to(torch.int32),
                                                       px_s]).reshape(2, -1), shape, N)
        np.testing.assert_array_equal(got.numpy(), want.reshape(2, -1).T)
        return
    want = want.transpose(1, 2, 3, 0)
    form_id, seg = model_pass.form_of(shape[2], seg_w, w_quant)
    if form_id == model_pass.HOLD:
        want = want[:, :, ::seg]
    got = model_pass.chains_plain(fe, px_s.reshape(1, -1), shape, N, seg_w, w_quant)
    np.testing.assert_array_equal(got.numpy(), want.reshape(-1, pavp.get_m(N)))
    assert form_id == {"plain": 0, "seg_stats": 1, "w_pred": 2}[form]


def _systems(p=96, n=N, seed=21):
    """(m, P) statistics whose ridge systems are random at the chains'
    magnitudes, zero (singular: ok false), rank-deficient, wrapping, or
    hold INT64_MIN pivots (a whole first column of it)."""
    rng = np.random.default_rng(seed)
    m = pavp.get_m(n)
    st = rng.integers(-(1 << 40), 1 << 40, size=(m, p))
    a = st[1 + n :].reshape(n, n, p)  # a view: the matrix's channels
    a += (np.eye(n, dtype=np.int64) << 44)[:, :, None]
    a[:, :, 8:16] = -(np.eye(n, dtype=np.int64) * (8 * n))[:, :, None]  # A + ridge = 0
    a[3, :, 16:24] = a[2, :, 16:24]  # two equal rows before the ridge
    st[:, 24:32] = rng.integers(-(1 << 62), 1 << 62, size=(m, 8))  # products wrap
    a[:, 0, 32:40] = I64_MIN  # column 0 all INT64_MIN: the least |.|, so row 0
    a[0, 0, 32:40] = I64_MAX - 79  # wraps to INT64_MIN with the ridge: the pivot
    pick = rng.random((m, 8))
    blk = st[:, 40:48]
    blk[pick < 0.2] = I64_MIN
    blk[pick > 0.9] = I64_MAX
    return st


def _solve_inputs(p):
    """(fe (P, n + 1), px_s (P,)) int32 of the solve's pixels."""
    rng = np.random.default_rng(22)
    return (rng.integers(-128, 128, size=(p, N + 1)).astype(np.int32),
            rng.integers(0, 256, size=p).astype(np.int32))


@pytest.mark.parametrize("w_quant,seg", SOLVES)
def test_solve_plain_against_jax(w_quant, seg, jax_refs):
    st = _systems()
    p = st.shape[1] * seg
    fe, px_s = (a[:p] for a in _solve_inputs(st.shape[1] * 4))
    px_v, ok = jax_refs[1][w_quant, seg]
    px0 = px_v.astype(np.int32) if w_quant else ((px_v + 2048) >> 12).astype(np.int32)
    got, got_ok = model_pass.solve_plain(torch.from_numpy(st.T.copy()), torch.from_numpy(fe),
                                         torch.from_numpy(px_s), N, seg, w_quant)
    np.testing.assert_array_equal(got.numpy(), np.where(ok, px0, px_s))
    np.testing.assert_array_equal(got_ok.numpy(), ok)
    assert not ok[8 * seg : 16 * seg].any() and ok[:8 * seg].all()


@pytest.mark.parametrize("kw", [dict(), dict(mix=True), dict(seg_w=4), dict(seg_w=4, w_quant=True),
                                dict(seg_w=5, w_quant=True), dict(seg_w=1), dict(n=6)],
                         ids=["plain", "mix", "seg_stats", "w_pred", "w_pred_ragged", "seg1",
                              "n6"])
def test_pass_as_the_card_runs_it(kw):
    """model_pass.predict_plane on CPU tensors (chains_plain and
    solve_plain where the card runs K10 and K11) equals pavp.predict_plane's
    loops, which test_torch_p3_pavp.py holds to nblic_tpu's."""
    x = torch.from_numpy(_stressed_strips()[1:3])
    kw = dict(kw)
    n = kw.pop("n", N)
    got = model_pass.predict_plane(x, n, **kw)
    assert torch.equal(got, pavp.predict_plane(x, n, **kw))


def test_moment_blocks_and_refusals(monkeypatch):
    """The moments run in one K10 wavefront launch where the strips are short
    and many (the th-64 corpus), else in two-pass launches within
    the scratch budget; the pass refuses what it cannot model."""
    k, design = N + N * N, model_pass.chain_design
    assert design(288, 64, k, 132) == model_pass.WAVE  # the th-64 corpus
    assert design(288, 64, 1, 132) == model_pass.TWO_PASS  # its energy channel
    assert design(288, 64, 2, 132) == model_pass.TWO_PASS  # its mix channels
    assert design(1, 768, k, 132) == model_pass.TWO_PASS  # th 768: 4 CTAs a wavefront
    assert design(24, 64, k, 132) == model_pass.TWO_PASS  # 96 CTAs
    assert design(72, 256, k, 132) == model_pass.WAVE  # the corpus at th 256: 288 CTAs
    assert design(48, 384, k, 132) == model_pass.TWO_PASS  # at th 384: 192
    assert len(model_pass._moment_blocks(N, 768 * 512)) == 1  # th 768: one moment launch
    assert len(model_pass._moment_blocks(N, 24 * 768 * 512)) == 4  # 24 images: four
    for p, budget in ((393216, 1 << 31), (9437184, 1 << 31), (10, 80), (5, 1)):
        monkeypatch.setattr(model_pass, "SCRATCH_BYTES", budget)
        blocks = model_pass._moment_blocks(N, p)
        assert [q for q, _ in blocks] == list(np.cumsum([0] + [k for _, k in blocks[:-1]]))
        assert sum(k for _, k in blocks) == N + N * N
        assert max(k for _, k in blocks) * 8 * p <= max(budget, 8 * p)
    with pytest.raises(ValueError, match="8-bit"):
        model_pass.predict_plane(torch.full((1, 4, 4), 256, dtype=torch.int32))
    with pytest.raises(ValueError, match="incompatible"):
        model_pass.predict_plane(torch.zeros((1, 4, 8), dtype=torch.int32), seg_w=4, mix=True)


# ---- model_chain.cuh's host branch

SHIM = r"""
#include <algorithm>
#include <array>
#include <vector>

#include "model_chain.cuh"
#include "model_solve.cuh"
extern "C" {
void decay_many(const int64_t* v, int ab, int64_t* out, long long count) {
  for (long long k = 0; k < count; ++k) out[k] = ab == 3 ? mc_decay<3>(v[k]) : mc_decay<5>(v[k]);
}
void moment_many(const int64_t* l, const int64_t* r, const int* shift, const int64_t* s,
                 int64_t* out, long long count) {
  for (long long k = 0; k < count; ++k)
    out[k] = moment(l[k], r[k], shift[k], s[k], moment_recip(s[k]));
}
// moment_fast, falling back to moment() where it flags its input
void moment_fast_many(const int64_t* l, const int64_t* r, const int* shift, const int64_t* s,
                      int64_t* out, long long count) {
  for (long long k = 0; k < count; ++k) {
    bool slow = false;
    out[k] = moment_fast(l[k], r[k], shift[k], s[k], moment_recip(s[k]), slow);
    if (slow) out[k] = moment(l[k], r[k], shift[k], s[k], moment_recip(s[k]));
  }
}
void quot_many(const int64_t* a, const int64_t* s, int64_t* out, long long count) {
  for (long long k = 0; k < count; ++k)
    out[k] = static_cast<int64_t>(umulhi64(static_cast<uint64_t>(a[k]), moment_recip(s[k])));
}
void clip_many(const int64_t* v, int64_t* out, long long count) {
  for (long long k = 0; k < count; ++k) out[k] = clip_s_sum(v[k]);
}
void weight_many(const int64_t* stats0, const int* x, const int* p, int64_t* out,
                 long long count) {
  for (long long k = 0; k < count; ++k) out[k] = sample_weight(stats0[k], err_energy(x[k], p[k]));
}
}

// K10's schedule on virtual threads: each chunk of kChainChunk steps runs
// warp after warp (in `order` 0 ascending, 1 descending), each step lane
// after lane; the end of a chunk is the CTA's barrier.  A consumer warp run
// before its producer (descending) reads what the producer left in an
// earlier chunk only; a producer run first (ascending) overwrites only
// slots already read.
// One step of a thread: its rows' inputs, contributions and chains.
template <int kKind, int kForm, int kRows, bool kFwd>
void emu_step(const ChainArgs& a, const ChainThread& th, int t0, int64_t up,
              int64_t (&hand)[kRows], int64_t (&acc)[kRows], int64_t (&ef)[kRows]) {
  ChainIn in[kRows];
  chain_rows_load<kKind, kForm, kRows, kFwd>(a, th, t0, in);
  int64_t cv[kRows];
  chain_rows_contrib<kKind, kRows>(in, th.mo, cv);
  chain_rows_apply<kKind, kForm, kRows, kFwd>(a, th, t0, up, in, cv, hand, acc, ef);
}

template <int kKind, int kForm, int kRows, bool kFwd>
void emu_pass(const ChainArgs& a, const ChainPlan& pl, int64_t* ring, int strip, int cblock,
              int band, int nrows, int order) {
  const int threads = pl.warps * kChainWarp;
  std::vector<ChainThread> th;
  for (int x = 0; x < threads; ++x)
    th.push_back(chain_thread(a, pl, kKind, kFwd, ring, strip, cblock, band, nrows,
                              x / kChainWarp, x % kChainWarp));
  std::vector<std::array<int64_t, kRows>> hand(threads), acc(threads), ef(threads);
  for (int x = 0; x < threads; ++x) hand[x].fill(0), acc[x].fill(0), ef[x].fill(0);
  const int steps = chain_steps(pl, a.w, nrows);
  for (int s0 = 0; s0 < steps; s0 += kChainChunk) {
    for (int wi = 0; wi < pl.warps; ++wi) {
      const int warp = order ? pl.warps - 1 - wi : wi;
      for (int u = 0; u < kChainChunk; ++u) {
        for (int l = 0; l < kChainWarp; ++l) {
          const int x = warp * kChainWarp + l;
          const int t0 = s0 + u - th[x].lag0;
          const int64_t up = chain_receive(a, th[x], kFwd, t0);
          int64_t(&h)[kRows] = *reinterpret_cast<int64_t(*)[kRows]>(hand[x].data());
          int64_t(&c)[kRows] = *reinterpret_cast<int64_t(*)[kRows]>(acc[x].data());
          int64_t(&e)[kRows] = *reinterpret_cast<int64_t(*)[kRows]>(ef[x].data());
          emu_step<kKind, kForm, kRows, kFwd>(a, th[x], t0, up, h, c, e);
        }
      }
    }
  }
}

template <int kKind, int kForm, int kRows>
void emu_launch(const ChainArgs& a, const ChainPlan& pl, int order) {
  std::vector<int64_t> ring(static_cast<size_t>(pl.warps) * kChainRing * kChainWarp, 0);
  const int cblocks = (a.k + kChainWarp - 1) / kChainWarp;
  for (int strip = 0; strip < a.s; ++strip)
    for (int cb = 0; cb < cblocks; ++cb)
      for (int band = 0; band < pl.bands; ++band) {
        const int nrows = std::min(pl.band, a.h - band * pl.band);
        emu_pass<kKind, kForm, kRows, true>(a, pl, ring.data(), strip, cb, band, nrows, order);
        emu_pass<kKind, kForm, kRows, false>(a, pl, ring.data(), strip, cb, band, nrows, order);
      }
  if (kKind == kEnergy)
    for (long long px = 0; px < a.p; ++px) chain_weight(a, px);
}

template <int kKind, int kForm>
int emu_rows(const ChainArgs& a, const ChainPlan& pl, int order) {
  switch (pl.rows) {
    case 1: emu_launch<kKind, kForm, 1>(a, pl, order); return 0;
    case 2: emu_launch<kKind, kForm, 2>(a, pl, order); return 0;
    case 3: emu_launch<kKind, kForm, 3>(a, pl, order); return 0;
    case 4: emu_launch<kKind, kForm, 4>(a, pl, order); return 0;
  }
  return -1;
}

template <int kKind>
int emu_rows(const ChainArgs& a, const ChainPlan& pl, int order) {
  if (a.form == kFreeze) return emu_rows<kKind, kFreeze>(a, pl, order);
  if (a.form == kHold) return emu_rows<kKind, kHold>(a, pl, order);
  return emu_rows<kKind, kPlain>(a, pl, order);
}

extern "C" int emulate_chains(int kind, const int32_t* fe, const int32_t* pred, int32_t* ssum,
                              uint64_t* srecip, int64_t* out, int s, int h, int w, int n, int q0,
                              int k, int stride, int c0, int seg, int form, int rows,
                              int max_warps, int order) {
  const ChainPlan pl = chain_plan(h, rows, max_warps);
  std::vector<int64_t> carry(pl.bands > 1 ? 2ull * s * k * w : 0);
  const int sg = form == kPlain ? 1 : seg;
  const ChainArgs a{fe, pred, ssum, srecip, carry.empty() ? nullptr : carry.data(), out,
                    static_cast<long long>(s) * h * w, s, h, w, n, q0, k, stride, c0, sg,
                    form, seg_inverse(sg)};
  if (kind == kEnergy) return emu_rows<kEnergy>(a, pl, order);
  if (kind == kMix) return emu_rows<kMix>(a, pl, order);
  return emu_rows<kMoments>(a, pl, order);
}

extern "C" int chain_bands(int h, int rows, int max_warps) {
  return chain_plan(h, rows, max_warps).bands;
}

// K11's thread on each statistics row, as the kernel's instance for n
// (10, else 12) runs it: the system staged with the ridge, solved, then
// the prediction of the row's pixels (seg of them under w_pred).
template <int kN>
void solve_rows_n(const int64_t* stats, const int32_t* fe, const int32_t* px_s, int32_t* px,
                  uint8_t* ok_out, long long rows, int seg, int n, int wq) {
  const int m = 1 + n + n * n;
  for (long long r = 0; r < rows; ++r) {
    int64_t a[kN * (kN + 1)] = {};
    uint64_t magic[kN];
    uint32_t meta[kN];
    for (int ch = 0; ch < m; ++ch) {
      int64_t add;
      const int at = solve_entry<kN>(ch, n, add);
      if (at >= 0) a[at] = sv_add(stats[r * m + ch], add);
    }
    const SolveRef<kN, 1> s{a, magic, meta};
    const bool ok = thread_solve<kN, 1>(s, n);
    if (wq) {
      int w[kN];
      for (int t = 0; t < kN; ++t) w[t] = t < n ? solve_quantize(s.at(t, t), s.at(t, n)) : 0;
      for (int q = 0; q < seg; ++q) {
        const long long p = r * seg + q;
        px[p] = ok ? solve_predict_wq<kN>(w, n, fe + p * (n + 1) + 1) : px_s[p];
        ok_out[p] = ok;
      }
    } else {
      px[r] = ok ? solve_round_px(thread_predict<kN, 1>(s, n, fe + r * (n + 1) + 1)) : px_s[r];
      ok_out[r] = ok;
    }
  }
}

// Each row's solved system: its diagonal and numerators (n each) and ok.
template <int kN>
void solve_systems_n(const int64_t* stats, long long rows, int n, int64_t* diag, int64_t* num,
                     uint8_t* ok) {
  const int m = 1 + n + n * n;
  for (long long r = 0; r < rows; ++r) {
    int64_t a[kN * (kN + 1)] = {};
    uint64_t magic[kN];
    uint32_t meta[kN];
    for (int ch = 0; ch < m; ++ch) {
      int64_t add;
      const int at = solve_entry<kN>(ch, n, add);
      if (at >= 0) a[at] = sv_add(stats[r * m + ch], add);
    }
    const SolveRef<kN, 1> s{a, magic, meta};
    ok[r] = thread_solve<kN, 1>(s, n);
    for (int t = 0; t < n; ++t) {
      diag[r * n + t] = s.at(t, t);
      num[r * n + t] = s.at(t, n);
    }
  }
}

extern "C" void solve_systems(const int64_t* stats, long long rows, int n, int64_t* diag,
                              int64_t* num, uint8_t* ok) {
  if (n == 10) solve_systems_n<10>(stats, rows, n, diag, num, ok);
  else solve_systems_n<kSolveMaxN>(stats, rows, n, diag, num, ok);
}

extern "C" void solve_rows(const int64_t* stats, const int32_t* fe, const int32_t* px_s,
                           int32_t* px, uint8_t* ok, long long rows, int seg, int n, int wq) {
  if (n == 10) solve_rows_n<10>(stats, fe, px_s, px, ok, rows, seg, n, wq);
  else solve_rows_n<kSolveMaxN>(stats, fe, px_s, px, ok, rows, seg, n, wq);
}
"""


@pytest.fixture(scope="module")
def lib():
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.fail("g++ is needed to compile model_chain.cuh's host path")
    text = b"".join((HEADER.parent / h).read_bytes()
                    for h in ("model_chain.cuh", "model_solve.cuh", "udiv64.cuh")) + SHIM.encode()
    digest = hashlib.sha256(text).hexdigest()[:16]
    out_dir = ROOT / "build" / "test_p3_model_pass"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"libmodel_chain_{digest}.so"
    if not so.exists():
        src = out_dir / f"shim_{digest}_{os.getpid()}.cpp"
        tmp = out_dir / f"libmodel_chain_{digest}_{os.getpid()}.so"
        src.write_text(SHIM)
        subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I", str(HEADER.parent),
                        "-o", str(tmp), str(src)], check=True, capture_output=True, text=True)
        src.unlink()
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    ptr, cnt = ctypes.c_void_p, ctypes.c_longlong
    lib.decay_many.argtypes = [ptr, ctypes.c_int, ptr, cnt]
    lib.moment_many.argtypes = [ptr, ptr, ptr, ptr, ptr, cnt]
    lib.moment_fast_many.argtypes = [ptr, ptr, ptr, ptr, ptr, cnt]
    lib.quot_many.argtypes = [ptr, ptr, ptr, cnt]
    lib.clip_many.argtypes = [ptr, ptr, cnt]
    lib.weight_many.argtypes = [ptr, ptr, ptr, ptr, cnt]
    lib.emulate_chains.argtypes = [ctypes.c_int] + [ptr] * 5 + [ctypes.c_int] * 13
    lib.emulate_chains.restype = ctypes.c_int
    lib.chain_bands.argtypes = [ctypes.c_int] * 3
    lib.chain_bands.restype = ctypes.c_int
    lib.solve_rows.argtypes = [ptr] * 5 + [cnt] + [ctypes.c_int] * 3
    lib.solve_systems.argtypes = [ptr, cnt, ctypes.c_int, ptr, ptr, ptr]
    return lib


def _edges(rng, size):
    """int64 edge values: the extremes, small values of both signs and
    random ones across the range."""
    fixed = np.array([I64_MIN, I64_MIN + 1, I64_MAX, I64_MAX - 1, 0, 1, -1, 2, -2, 3, -3, 4,
                      -4, 5, -5, 7, -7, (1 << 62) - 1, -(1 << 62), 1 << 47, -(1 << 47)],
                     dtype=np.int64)
    return np.concatenate([fixed, rng.integers(I64_MIN, I64_MAX, size=size, dtype=np.int64),
                           rng.integers(-(1 << 40), 1 << 40, size=size, dtype=np.int64)])


@pytest.mark.parametrize("ab", [avp.BETA, avp.ALPHA])
def test_host_decay(lib, ab):
    v = _edges(np.random.default_rng(ab), 20000)
    out = np.empty_like(v)
    lib.decay_many(v.ctypes.data, ab, out.ctypes.data, v.size)
    np.testing.assert_array_equal(out, pavp.decay(torch.from_numpy(v), ab).numpy())


def test_host_clip_and_sample_weight(lib):
    rng = np.random.default_rng(31)
    v = np.concatenate([_edges(rng, 20000), np.arange(-(1 << 13), 17 << 12, 7)])
    out = np.empty_like(v)
    lib.clip_many(v.ctypes.data, out.ctypes.data, v.size)
    np.testing.assert_array_equal(out, pavp._clip_s_sum(torch.from_numpy(v)).numpy())
    x = rng.integers(0, 256, size=v.size).astype(np.int32)
    px = rng.integers(0, 256, size=v.size).astype(np.int32)
    x[:256], px[:256] = np.arange(256), 255 - np.arange(256)
    lib.weight_many(v.ctypes.data, x.ctypes.data, px.ctypes.data, out.ctypes.data, v.size)
    s_curr = torch.abs(torch.from_numpy(x).long() - torch.from_numpy(px).long()) << 12
    want = pavp._clip_s_sum(torch.from_numpy(v) + avp.tdiv(s_curr * 3, s_curr.new_tensor(2)))
    np.testing.assert_array_equal(out, want.numpy())


def _moments_ref(l, r, shift, s):
    return pavp._moments(torch.from_numpy(l), torch.from_numpy(r),
                         torch.from_numpy(shift.astype(np.int64)), torch.from_numpy(s)).numpy()


def test_host_moments_every_divisor(lib):
    """Every sample weight s in [2^12, 2^16] against the pixels' edge
    factors at both shifts; then factors past the pixels' range, whose
    numerators leave the reciprocal's domain (2^47) or wrap: moment(), and
    K10's moment_fast with its fallback."""
    s_all = np.arange(1 << 12, (16 << 12) + 1, dtype=np.int64)
    vals = np.array([-128, -127, -1, 0, 1, 127])
    pairs = [(a, b, sh) for a in vals for b in vals if a <= b for sh in (18, 28)]
    l = np.repeat(np.array([p[0] for p in pairs], dtype=np.int64), s_all.size)
    r = np.repeat(np.array([p[1] for p in pairs], dtype=np.int64), s_all.size)
    shift = np.repeat(np.array([p[2] for p in pairs], dtype=np.int32), s_all.size)
    s = np.tile(s_all, len(pairs))
    rng = np.random.default_rng(41)
    k = 40000
    wide = rng.integers(-(1 << 40), 1 << 40, size=(2, k), dtype=np.int64)
    wide[:, :64] = [[I64_MIN, 1 << 62, -(1 << 31), 1 << 19] * 16, [1, 3, -(1 << 31), 1 << 9] * 16]
    l = np.concatenate([l, wide[0]])
    r = np.concatenate([r, wide[1]])
    shift = np.concatenate([shift, rng.choice([18, 28], size=k).astype(np.int32)])
    s = np.concatenate([s, rng.integers(1 << 12, (16 << 12) + 1, size=k)])
    want = _moments_ref(l, r, shift, s)
    for fn in (lib.moment_many, lib.moment_fast_many):  # K10 takes the second
        out = np.empty_like(l)
        fn(l.ctypes.data, r.ctypes.data, shift.ctypes.data, s.ctypes.data, out.ctypes.data,
           l.size)
        np.testing.assert_array_equal(out, want)


def test_host_reciprocal_quotient_at_its_edges(lib):
    """The reciprocal's quotient floor(a / s) for every s in [2^12, 2^16] at
    multiples of s and one below and above, up to its domain's end 2^47."""
    s_all = np.arange(1 << 12, (16 << 12) + 1, dtype=np.int64)
    q_max = ((1 << 47) - 1) // s_all
    a = np.concatenate([s_all - 1, s_all, s_all + 1, q_max * s_all - 1, q_max * s_all,
                        np.minimum(q_max * s_all + s_all - 1, (1 << 47) - 1), np.zeros_like(s_all)])
    s = np.tile(s_all, 7)
    out = np.empty_like(a)
    lib.quot_many(a.ctypes.data, s.ctypes.data, out.ctypes.data, a.size)
    np.testing.assert_array_equal(out, a // s)


# ---- K10's skewed wavefront, run lane by lane and warp by warp

# (rows a thread, most warps a CTA): K10's wavefront, then smaller CTAs
# whose warp boundaries and bands the small strips below cross (one warp
# of 4 rows; bands of 6 rows in two warps, of 3 in three)
WAVE_LAYOUTS = [(2, 16), (4, 1), (3, 2), (1, 3)]
# (S, H, W): h < w, h > w, 44 columns (segments of 4 and 11), 33 (of 11;
# of 4 the plain chains) and 37 (no segment divides it), one row, one column
WAVE_SHAPES = {"h<w": (2, 5, 44), "h>w": (1, 40, 33), "row": (3, 1, 37), "col": (2, 9, 1),
               "w37": (1, 7, 37)}
# (shape, seg_w, w_quant, n)
WAVE_CASES = [("h<w", 0, False, N), ("h<w", 4, False, N), ("h<w", 11, False, N),
              ("h<w", 4, True, N), ("h<w", 11, True, N), ("h>w", 0, False, N),
              ("h>w", 11, False, N), ("h>w", 11, True, N), ("h>w", 4, True, N),
              ("row", 0, False, N), ("col", 0, False, N), ("w37", 4, True, N),
              ("h<w", 0, False, 6), ("h>w", 4, False, 12)]


def _wave_inputs(shape, n, seed):
    """(fe, px_s (1, P)) of seeded strips: noise over a ramp, one strip's
    first row flat and a checkerboard below it."""
    s, h, w = shape
    rng = np.random.default_rng(seed)
    x = (np.add.outer(np.arange(h), 3 * np.arange(w))[None] + rng.integers(0, 64, (s, h, w)))
    x[0, 0] = 200
    x[0, 1:] = np.where(np.add.outer(np.arange(h - 1), np.arange(w)) % 2, 255, x[0, 1:])
    fe, px_s = model_pass.features(torch.from_numpy(np.clip(x, 0, 255).astype(np.int32)), n)
    return fe, px_s.reshape(1, -1)


def _emulated(lib, fe, preds, shape, n, seg_w, w_quant, layout, order):
    """The statistics of ``chains`` (the energy's launch, whose sample
    weights the moments read, and the moments') on the wavefront's
    schedule emulated in ``layout``."""
    s, h, w = shape
    p = s * h * w
    fe_np = np.ascontiguousarray(fe.numpy())
    pr = np.ascontiguousarray(preds.numpy().astype(np.int32))
    ssum, srecip = np.zeros(p, np.int32), np.zeros(p, np.uint64)

    def run(kind, out, q0, k, c0, form, seg, lay):
        rc = lib.emulate_chains(kind, fe_np.ctypes.data, pr.ctypes.data, ssum.ctypes.data,
                                srecip.ctypes.data, out.ctypes.data, s, h, w, n, q0, k,
                                out.shape[1], c0, seg, form, *lay, order)
        assert rc == 0

    form, seg = model_pass.form_of(w, seg_w, w_quant)
    rows = p // seg if form == model_pass.HOLD else p
    out = np.full((rows, pavp.get_m(n)), 0x5A5A5A5A5A5A5A5A, np.int64)
    run(model_pass.ENERGY, out, 0, 1, 0, form, seg, layout)
    run(model_pass.MOMENTS, out, 0, n + n * n, 1, form, seg, layout)
    return out


@pytest.mark.parametrize("case", WAVE_CASES,
                         ids=[f"{c[0]}-seg{c[1]}-{'hold' if c[2] else 'e'}-n{c[3]}"
                              for c in WAVE_CASES])
def test_wavefront_emulated_against_chains_plain(lib, case):
    """model_chain.cuh's schedule and steps, run lane by lane, warp by warp
    in both orders between barriers, equal chains_plain: every statistic
    written, the warp boundaries, bands and the channel blocks' idle lanes
    included."""
    name, seg_w, w_quant, n = case
    shape = WAVE_SHAPES[name]
    fe, preds = _wave_inputs(shape, n, len(name) + seg_w + n)
    want = model_pass.chains_plain(fe, preds, shape, n, seg_w, w_quant).numpy()
    crossed = set()
    for layout in WAVE_LAYOUTS:
        if lib.chain_bands(shape[1], *layout) > 1:
            crossed.add("bands")
        for order in (0, 1):
            got = _emulated(lib, fe, preds, shape, n, seg_w, w_quant, layout, order)
            np.testing.assert_array_equal(got, want, err_msg=f"{layout} order {order}")
    assert shape[1] < 9 or "bands" in crossed


# ---- K11's system a thread (model_solve.cuh's host path)


@pytest.mark.parametrize("n", [6, 10, 12])
@pytest.mark.parametrize("w_quant,seg", SOLVES)
def test_host_thread_solve_against_solve_plain(lib, n, w_quant, seg):
    """K11's per-thread elimination, prediction and w_pred dot on random
    ridge systems, singular ones, wrapping ones and INT64_MIN pivots, at
    tolerance 0 against solve_plain (pavp.predict_chunked)."""
    st = _systems(n=n, seed=20 + n)
    rows = st.shape[1]
    a = st[1 + n :].reshape(n, n, rows)  # a view: the matrix's channels
    a[:, :, 48:56] = ((1 - 8 * n) * np.eye(n, dtype=np.int64))[:, :, None]
    a[n - 1, n - 1, 48:56] = -8 * n  # with the ridge diag(1, ..., 1, 0): the last pivot 0
    rng = np.random.default_rng(n + seg)
    fe = rng.integers(-128, 128, size=(rows * seg, n + 1)).astype(np.int32)
    px_s = rng.integers(0, 256, size=rows * seg).astype(np.int32)
    stats = np.ascontiguousarray(st.T)
    px = np.empty(rows * seg, np.int32)
    ok = np.empty(rows * seg, np.uint8)
    lib.solve_rows(stats.ctypes.data, fe.ctypes.data, px_s.ctypes.data, px.ctypes.data,
                   ok.ctypes.data, rows, seg, n, int(w_quant))
    want, want_ok = model_pass.solve_plain(torch.from_numpy(stats), torch.from_numpy(fe),
                                           torch.from_numpy(px_s), n, seg, w_quant)
    np.testing.assert_array_equal(px, want.numpy())
    np.testing.assert_array_equal(ok.astype(bool), want_ok.numpy())
    assert not want_ok[8 * seg : 16 * seg].any() and not want_ok[48 * seg : 56 * seg].any()
    assert want_ok.any()
    # the solve itself, before the rounding hides a small error
    diag, num = np.empty((rows, n), np.int64), np.empty((rows, n), np.int64)
    lib.solve_systems(stats.ctypes.data, rows, n, diag.ctypes.data, num.ctypes.data,
                      ok.ctypes.data)
    want_diag, want_num, want_ok = pavp.solve_stats(torch.from_numpy(st), n)
    np.testing.assert_array_equal(diag, want_diag.t().numpy())
    np.testing.assert_array_equal(num, want_num.t().numpy())
    np.testing.assert_array_equal(ok[:rows].astype(bool), want_ok.numpy())
