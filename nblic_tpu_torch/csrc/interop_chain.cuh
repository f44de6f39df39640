// The interop engines' serial walks, as functions that compile for the card
// (kernel K6, interop_walk.cu) and, with g++, for the CPU test
// tests/test_torch_interop_walk.py, which runs the same walks on the host.
//
// What it computes, bit for bit:
// - nblic_walk: nblic_tpu_torch/models/nblic.py::_walk_plain, the NBLIC0.3
//   codec walk (efforts 1-3, encode and decode, near 0-9): per pixel the
//   template sampled afresh from three rows (ops/window.py
//   fresh_window_rows, fresh_t_tap), the blend predictor
//   (ops/predict.py n_simple_predict), at efforts 2-3 the int64 AVP
//   solved at two ridge strengths (ops/avp.py predict over solve_batch and
//   predict_from_solve: model_solve.cuh's thread_solve and thread_predict,
//   one system a thread) with the blend where a system is singular, the
//   dual-bin quantizer and the context address (n_quantize_activity,
//   n_context_address), the context bias (ops/context.py n_correct_px,
//   n_update_ctx), the AutoMapper (ops/automapper.py), the escalating
//   symbol coder over the adaptive binary range coder
//   (ops/range_coder.py code_symbol), the near-aware fold and unfold, and
//   at efforts 2-3 the decayed rank-1 moment update (avp.update) and the
//   choice of the ridge strength; the F chain (avp.precalculate_f) at each
//   row's start.
// - q_decode_walk: models/qnblic.py::_decode_walk_plain, the Q0.2 decode
//   (the sliding window of ops/window.py, the effort-0 blend predictor,
//   12-bin activity and 3072-entry address of ops/predict.py, the EWMA bias
//   q_correct_px / q_update_ctx, the table lookup and ops/rans.py dec_step).
// - q_chain_context: one context's EWMA chain of qnblic._context_chain_plain.
//
// The NBLIC0.3 walk runs with a team: `team.threads(f)` runs f(t, n) on
// each of its n threads, `team.one(f)` runs f on thread 0, `team.sync()`
// ends a phase.  On the card the team is one warp (one CTA) an image at
// efforts 2-3, one thread at effort 1; on the host its threads run one
// after another between the phases, in either order.  A pixel's phases:
// (a) the two ridge systems built from E + F, channels over the threads,
// and the template on thread 0; (b) the two solves and predictions, one a
// thread; (c) the serial chain on thread 0: prediction, contexts, mapper,
// coder, reconstruction, the sample weight of the update and the next
// pixel's strengths; (d) the moment update, channels over the threads.
// A thread touches only its own channels of E, F and B (channel c is
// thread c % n's), so only the systems, the features and (c)'s scalars
// cross threads, each after a sync.  At effort 1 only (c) runs.
//
// Exactness.  The plain versions compute in int64 with torch's semantics:
// products, sums and left shifts of the AVP wrap modulo 2^64 (through
// uint64 here), every quotient truncates toward zero (torch "trunc" is
// C's /; the solve's signed quotients are tdiv_by, |INT64_MIN| included),
// right shifts are arithmetic.  The coder's registers are uint32 (the
// plain version masks int64 to 32 bits).  The hostile-stream rules are
// the plain walk's: the decoder's window takes the payload's first 4 bytes
// (the caller's coder_init_decode), reads past the payload give 0, a unary
// walk stops after kGuard + 2 bins and then takes k from its last row, an
// encode's writes past the buffer are dropped (the caller raises when the
// final pointer passes the capacity); a Q0.2 read past the stream takes
// its last word.

#pragma once

#include <cstdint>

#include "model_solve.cuh"

namespace {

// ---- constants (nblic_tpu_torch/constants.py, ops/*.py)

constexpr int kIcMaxVal = 255;
constexpr int kIcMid = 128;
constexpr int kNQdN = 16;                  // NBLIC0.3 activity bins (rc.N_QD)
constexpr int kNCtxN = (kNQdN >> 1) * 256;  // 2048 context cells
constexpr int kNQwN = 32;                  // interpolation weight range
constexpr int kCountCap = kNQwN * 256;     // a counter pair halves past this sum
constexpr int kTreeRow = 256;              // counter pairs a row of the tree
constexpr int kTreePairs = kNQdN * kTreeRow;
constexpr int kGuardBins = 4096 + 2;       // a unary walk stops after these bins
constexpr int kMapN = 20;                  // automapper.N_MAPPER
constexpr int kMapKeys = 512;              // 256 px values x 2 signs
constexpr int kPxInc = 127;                // MAX_PX_INC
constexpr int kIcFitBase = 128;            // avp.FIT_BASE
constexpr int kIcFb1 = 12;
constexpr int kIcFb2 = 2;
constexpr int kIcFb3 = kIcFb1 - kIcFb2;
constexpr int kIcAlpha = 5;
constexpr int kIcBeta = 3;
constexpr int64_t kBiasInit = 2 << kIcFb2;
constexpr int64_t kBiasMax = 1024 << kIcFb2;
constexpr int64_t kBiasCoef = 21;
constexpr int kQQd = 12;                   // Q0.2 activity bins
constexpr int kQCtx = kQQd * 256;          // 3072 context cells
constexpr int kQSym = 256;
constexpr int kQNormBits = 15;
constexpr int kQNormSum = 1 << kQNormBits;
constexpr uint32_t kQLowBound = 1u << 16;

NBT_HD int ic_abs(int v) { return v < 0 ? -v : v; }
NBT_HD int ic_clamp(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }
NBT_HD int64_t ic_abs64(int64_t v) { return v < 0 ? wneg(v) : v; }

// pavp / avp decay of a moment: (v (ab - 1) + ab / 2) / ab truncated
// toward zero, the product wrapping
template <int kAb>
NBT_HD int64_t ic_decay(int64_t v) {
  return sv_add(sv_mul(v, kAb - 1), kAb >> 1) / kAb;
}

// ---- the template

// The 11 taps a, b, c, d, e, f, g, h, q, r, s (ops/neighbors.py).
struct Taps {
  int a, b, c, d, e, f, g, h, q, r, s;
};

// window.fresh_window_rows at (i, j): cur is row i (written up to j - 1),
// p1 row i - 1, p2 row i - 2 (each read only where it exists).  An
// out-of-image tap takes another tap's value, as the reference cascades.
NBT_HD Taps fresh_taps(const uint8_t* cur, const uint8_t* p1, const uint8_t* p2, int i, int j,
                       int w) {
  Taps t;
  t.a = j >= 1 ? cur[j - 1] : kIcMid;
  t.b = i >= 1 ? p1[j] : kIcMid;
  if (i == 0)
    t.b = t.a;
  else if (j == 0)
    t.a = t.b;
  t.e = j >= 2 ? cur[j - 2] : t.a;
  t.c = (i >= 1 && j >= 1) ? p1[j - 1] : t.b;
  t.d = (i >= 1 && j + 1 < w) ? p1[j + 1] : t.b;
  t.f = i >= 2 ? p2[j] : t.b;
  t.g = (i >= 2 && j + 1 < w) ? p2[j + 1] : t.f;
  t.h = (i >= 2 && j >= 1) ? p2[j - 1] : t.f;
  t.q = (i >= 1 && j >= 2) ? p1[j - 2] : t.c;
  t.r = (i >= 2 && j + 2 < w) ? p2[j + 2] : t.g;
  t.s = (i >= 2 && j >= 2) ? p2[j - 2] : t.h;
  return t;
}

// window.fresh_t_tap: (i - 1, j + 2), d where it lies outside.
NBT_HD int fresh_t(const uint8_t* p1, int i, int j, int w, int d) {
  return (i >= 1 && j + 2 < w) ? p1[j + 2] : d;
}

// predict.activity: the local gradients plus twice the carried error.
NBT_HD int activity(const Taps& t, int err) {
  return ic_abs(t.a - t.e) + ic_abs(t.b - t.c) + ic_abs(t.b - t.d) + ic_abs(t.a - t.c) +
         ic_abs(t.b - t.f) + ic_abs(t.d - t.g) + 2 * ic_abs(err);
}

// The seven directional costs (unweighted) and candidates that both blend
// predictors rank; `lnr` the linear predictor before its clip.
struct Blend {
  int cost[7], pred[7], lnr;
};

NBT_HD Blend blend_terms(const Taps& t) {
  const int a = t.a, b = t.b, c = t.c, d = t.d, e = t.e, f = t.f, g = t.g, h = t.h, q = t.q,
            r = t.r, s = t.s;
  Blend o;
  o.cost[0] = ic_abs(a - e) + ic_abs(c - q) + ic_abs(b - c) + ic_abs(d - b);
  o.cost[1] = ic_abs(a - c) + ic_abs(c - h) + ic_abs(b - f) + ic_abs(d - g);
  o.cost[2] = ic_abs(a - q) + ic_abs(c - s) + ic_abs(b - h) + ic_abs(d - f);
  o.cost[3] = ic_abs(a - b) + ic_abs(c - f) + ic_abs(b - g) + ic_abs(d - r);
  o.cost[4] = ic_abs(2 * a - e - q) + ic_abs(2 * c - q - s) + ic_abs(2 * b - c - h) +
              ic_abs(2 * d - b - f);
  o.cost[5] = ic_abs(2 * a - q - c) + ic_abs(2 * c - s - h) + ic_abs(2 * b - h - f) +
              ic_abs(2 * d - f - g);
  o.cost[6] = ic_abs(2 * a - c - b) + ic_abs(2 * c - h - f) + ic_abs(2 * b - f - g) +
              ic_abs(2 * d - g - r);
  o.pred[0] = 2 * a;
  o.pred[1] = 2 * b;
  o.pred[2] = 2 * c;
  o.pred[3] = 2 * d;
  o.pred[4] = a + c;
  o.pred[5] = c + b;
  o.pred[6] = b + d;
  o.lnr = 9 * a + 9 * b + 2 * d - 2 * c - e - f;
  return o;
}

// predict.n_simple_predict: the first candidate of least weighted cost,
// blended with the linear predictor by the count of C_THRESHOLDS at or
// below the cost sum less 7 times the least.
NBT_HD int n_predict(const Taps& t) {
  const int cuts[8] = {31, 93, 279, 620, 1550, 3410, 9300, 24800};
  const Blend o = blend_terms(t);
  int cmin = 0, best = 0, csum = 0;
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    const int cost = k < 4 ? 2 * o.cost[k] : o.cost[k];
    csum += cost;
    if (k == 0 || cmin > cost) {
      cmin = cost;
      best = o.pred[k];
    }
  }
  csum -= 7 * cmin;
  int wt = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) wt += cuts[k] <= csum;
  const int lnr = ic_clamp(o.lnr, 0, 16 * kIcMaxVal);
  return (8 * wt * best + (8 - wt) * lnr + 64) >> 7;
}

// predict.simple_predict (the effort-0 blend): the cost sum less 7 times
// the least, shifted by 3 and capped at 607, counted against Q_PT_THRESH.
NBT_HD int q_predict(const Taps& t) {
  const int cuts[7] = {5, 12, 34, 78, 194, 431, 601};
  const Blend o = blend_terms(t);
  int cmin = 0, best = 0, csum = 0;
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    const int cost = k < 4 ? 2 * o.cost[k] : o.cost[k];
    csum += cost;
    if (k == 0 || cmin > cost) {
      cmin = cost;
      best = o.pred[k];
    }
  }
  csum = (csum - 7 * cmin) >> 3;
  csum = csum > 607 ? 607 : csum;
  int wt = 0;
#pragma unroll
  for (int k = 0; k < 7; ++k) wt += csum >= cuts[k];
  const int lnr = ic_clamp(o.lnr, 0, 16 * kIcMaxVal);
  return (8 * wt * best + (8 - wt) * lnr + 64) >> 7;
}

// predict.n_quantize_activity: the dual-bin quantizer with 5-bit
// interpolation.  Where it interpolates delta > mid_lo, so C's / is the
// floor.
NBT_HD void n_quantize(int delta, int& qu, int& qv, int& qw) {
  const int mids[16] = {0, 2, 4, 7, 10, 14, 20, 26, 34, 42, 52, 64, 78, 95, 135, 200};
  int qd = 0;
#pragma unroll
  for (int k = 0; k < 15; ++k) qd += delta > mids[k];
  const int mid_hi = mids[qd], mid_lo = mids[qd > 0 ? qd - 1 : 0];
  const bool interp = delta < mid_hi && qd > 0;
  const int span = mid_hi - mid_lo;
  const int raw = interp ? kNQwN * (delta - mid_lo) / (span > 1 ? span : 1) : 0;
  const bool low = raw < kNQwN / 2;
  qu = (interp && low) ? qd - 1 : qd;
  qv = (interp && !low) ? qd - 1 : qd;
  qw = interp ? (low ? raw : kNQwN - raw) : 0;
}

// predict.n_context_address: (qu >> 1) * 256 | bit k where px exceeds the
// k-th of a, b, c, d, e, f, 2a - e, 2b - f.
NBT_HD int n_address(const Taps& t, int px, int qu) {
  int adr = (qu >> 1) << 8;
  adr |= (px > t.a) << 0;
  adr |= (px > t.b) << 1;
  adr |= (px > t.c) << 2;
  adr |= (px > t.d) << 3;
  adr |= (px > t.e) << 4;
  adr |= (px > t.f) << 5;
  adr |= (px > 2 * t.a - t.e) << 6;
  adr |= (px > 2 * t.b - t.f) << 7;
  return adr;
}

// predict.quantize_activity (12 bins) and context_address (qd * 256 | the
// same comparisons, a's the most significant bit).
NBT_HD int q_quantize(int delta) {
  const int cuts[11] = {1, 2, 4, 6, 9, 15, 25, 39, 63, 101, 151};
  const int v = delta > 151 ? 151 : delta;
  int qd = 0;
#pragma unroll
  for (int k = 0; k < 11; ++k) qd += v >= cuts[k];
  return qd;
}

NBT_HD int q_address(const Taps& t, int px, int qd) {
  int adr = qd;
  adr = (adr << 1) | (px > t.a);
  adr = (adr << 1) | (px > t.b);
  adr = (adr << 1) | (px > t.c);
  adr = (adr << 1) | (px > t.d);
  adr = (adr << 1) | (px > t.e);
  adr = (adr << 1) | (px > t.f);
  adr = (adr << 1) | (px > 2 * t.a - t.e);
  adr = (adr << 1) | (px > 2 * t.b - t.f);
  return adr;
}

// ---- the context bias and the residual fold (ops/context.py)

// n_correct_px / q_correct_px: (px, sign) from a context's EWMA state at
// `scale` fractional bits; >> is arithmetic.
NBT_HD int correct_px(int ctx, int px0, int scale, int& sign) {
  sign = (ctx >> (scale - 1)) & 1;
  return ic_clamp(px0 + (ctx >> scale) + sign, 0, kIcMaxVal);
}

// n_update_ctx (rounding 64) and q_update_ctx (rounding 63); err << scale
// as a product, the same value for a negative err.
NBT_HD int n_update_ctx(int ctx, int err) { return (ctx * 127 + err * 256 + 64) >> 7; }
NBT_HD int q_update_ctx(int ctx, int err) { return (ctx * 127 + err * 2048 + 63) >> 7; }

NBT_HD int fold_bound(int px, int near) {
  const int lo = px < 0 ? 0 : px;
  const int m = lo < kIcMaxVal - px ? lo : kIcMaxVal - px;
  return (m + near) / (2 * near + 1);  // px in [0, 255]: non-negative
}

// context.residual_fold: |x - px| quantized by near, sign-interleaved.
NBT_HD int residual_fold(int x, int px, int sign, int near) {
  const int ty = fold_bound(px, near);
  const int sy = x >= px;
  const int y = (ic_abs(x - px) + near) / (2 * near + 1);
  if (y <= 0) return 0;
  return y <= ty ? 2 * y - (sy ^ sign) : y + ty;
}

// context.residual_unfold: the inverse fold and the reconstruction clip.
NBT_HD int residual_unfold(int z, int px, int sign, int near) {
  const int ty = fold_bound(px, near);
  int y, sy;
  if (z <= 0) {
    y = 0;
    sy = 0;
  } else if (z <= 2 * ty) {
    y = (z + 1) >> 1;
    sy = (z & 1) ^ sign;
  } else {
    y = z - ty;
    sy = px < kIcMid;
  }
  y *= 2 * near + 1;
  return ic_clamp(px + (sy ? y : -y), 0, kIcMaxVal);
}

// ---- the AutoMapper (ops/automapper.py): 512 keys of 20 ranks

struct Mappers {
  uint8_t* to_rank;    // (512, 20) y -> z
  uint8_t* from_rank;  // (512, 20) z -> y
  int32_t* freq;       // (512, 20) rank-slot counts, at most h w + 38
};

NBT_HD void map_init(const Mappers& m, int t, int n) {
  for (int k = t; k < kMapKeys * kMapN; k += n) {
    const int r = k % kMapN;
    m.to_rank[k] = static_cast<uint8_t>(r);
    m.from_rank[k] = static_cast<uint8_t>(r);
    m.freq[k] = (kMapN - 1 - r) * 2;
  }
}

NBT_HD int map_fold(const Mappers& m, int key, int y) {
  return y < kMapN ? m.to_rank[key * kMapN + y] : y;
}
NBT_HD int map_unfold(const Mappers& m, int key, int z) {
  return z < kMapN ? m.from_rank[key * kMapN + z] : z;
}

// automapper.observe: count y and bubble it one rank up where its count
// now exceeds the count of the rank above.
NBT_HD void map_observe(const Mappers& m, int key, int y) {
  if (y >= kMapN) return;
  uint8_t* to = m.to_rank + key * kMapN;
  uint8_t* from = m.from_rank + key * kMapN;
  int32_t* fr = m.freq + key * kMapN;
  const int z = to[y];
  const int f = ++fr[z];
  if (z == 0) return;
  const int zu = z - 1, yu = from[zu];
  const int fu = fr[zu];
  if (fu < f) {
    fr[z] = fu;
    fr[zu] = f;
    from[z] = static_cast<uint8_t>(yu);
    from[zu] = static_cast<uint8_t>(y);
    to[y] = static_cast<uint8_t>(zu);
    to[yu] = static_cast<uint8_t>(z);
  }
}

// ---- the adaptive binary range coder (ops/range_coder.py)

struct Coder {
  uint32_t lo, hi, window;
  int64_t ptr;   // the next byte to write or read
  uint8_t* buf;  // the stream; on decode the payload and 4 zero bytes
  int64_t len;   // buf's bytes: reads at or past it give 0, writes drop
};

// code_bit: one decision at P(1) = prob / 4096, then the renormalization
// of the leading bytes lo and hi share.  Returns the bin.
template <bool kDecode>
NBT_HD int code_bit(Coder& s, int bin, uint32_t prob) {
  const uint32_t span = s.hi - s.lo;
  const uint32_t mid =
      s.lo + static_cast<uint32_t>((static_cast<uint64_t>(span) * prob) >> 12);
  if (kDecode) bin = s.window <= mid;
  if (bin)
    s.hi = mid;
  else
    s.lo = mid + 1;
  while (((s.lo ^ s.hi) & 0xFF000000u) == 0) {
    if (kDecode)
      s.window = (s.window << 8) | (s.ptr < s.len ? s.buf[s.ptr] : 0u);
    else if (s.ptr < s.len)
      s.buf[s.ptr] = static_cast<uint8_t>(s.hi >> 24);
    ++s.ptr;
    s.lo <<= 8;
    s.hi = (s.hi << 8) | 0xFFu;
  }
  return bin;
}

// A counter pair: (c0, c1), each at least 1 and at most kCountCap + 32.
NBT_HD uint32_t prob1(const uint16_t* p) {
  return (4096u * p[1]) / (static_cast<uint32_t>(p[0]) + p[1]);
}

// counter_bump: add `amount` to counter `bin`, halve the pair (rounding
// up) once its sum passes 32 * 256.
NBT_HD void bump(uint16_t* p, int bin, int amount) {
  uint32_t c0 = p[0] + (bin ? 0 : amount), c1 = p[1] + (bin ? amount : 0);
  if (c0 + c1 > static_cast<uint32_t>(kCountCap)) {
    c0 = (c0 + 1) >> 1;
    c1 = (c1 + 1) >> 1;
  }
  p[0] = static_cast<uint16_t>(c0);
  p[1] = static_cast<uint16_t>(c1);
}

// mixed_code_bit: one bin at the qw-weighted mix of pairs (qu, i) and (qv,
// i), then each bumped by its weight, v's bump seeing u's where qu == qv.
template <bool kDecode>
NBT_HD int mixed_code_bit(Coder& s, uint16_t* tree, int qu, int qv, int i, int qw, int bin) {
  uint16_t* u = tree + 2 * (qu * kTreeRow + i);
  uint16_t* v = tree + 2 * (qv * kTreeRow + i);
  int prob = static_cast<int>((prob1(u) * (kNQwN - qw) + prob1(v) * qw + kNQwN / 2) / kNQwN);
  prob = ic_clamp(prob, 1, 4095);
  bin = code_bit<kDecode>(s, bin, static_cast<uint32_t>(prob));
  bump(u, bin, kNQwN - qw);
  bump(v, bin, qw);
  return bin;
}

// code_symbol: z as unary bins over rows qu / qv, each level of 2^k_max
// bins escalating to a coarser row and a halved index, at most kGuardBins
// of them, then k = qu / k_step refinement bits of the last row, most
// significant first.  Returns z (on encode z_in); adds the bins coded to
// n_bins.  k_step >= 2 keeps every index in the tree.
template <bool kDecode>
NBT_HD int code_symbol(Coder& s, uint16_t* tree, int k_step, int qu, int qv, int qw, int z_in,
                       int64_t& n_bins) {
  const int k_max = (kNQdN - 1) / k_step;
  if (qv / k_step != qu / k_step) qv = qu;
  int i = 0, it = 0;
  for (; it < kGuardBins; ++it) {
    const int k = qu / k_step;
    const int bin_in = kDecode ? 0 : ((i >> k_max) < (z_in >> k));
    if (!mixed_code_bit<kDecode>(s, tree, qu, qv, i, qw, bin_in)) {
      ++it;
      break;
    }
    i += 1 << k_max;
    if (i >= kTreeRow) {
      i >>= 1;
      const int qn = (k + 1) * k_step;
      qu = qv = qn < kNQdN - 1 ? qn : kNQdN - 1;
    }
  }
  const int k = qu / k_step;
  n_bins += it + k;
  int z = kDecode ? (i >> k_max) << k : z_in;
  ++i;
  for (int kk = k - 1; kk >= 0; --kk) {
    const int bin_in = kDecode ? 0 : (z_in >> kk) & 1;
    const int b = mixed_code_bit<kDecode>(s, tree, qu, qv, i, qw, bin_in);
    if (kDecode) z += b << kk;
    i += b ? 1 << kk : 1;
  }
  return z;
}

// ---- the AVP's strengths (ops/avp.py dual_biases)

NBT_HD void dual_biases(int64_t bias, int64_t& b1, int64_t& b2) {
  int64_t lo = bias * kBiasCoef / (kBiasCoef + 1);
  lo = lo < -1 ? -1 : lo;
  lo = lo > bias - 1 ? bias - 1 : lo;
  int64_t hi = bias * (kBiasCoef + 1) / kBiasCoef;
  hi = hi < bias + 1 ? bias + 1 : hi;
  hi = hi > kBiasMax + 1 ? kBiasMax + 1 : hi;
  b1 = lo < 0 ? 0 : (lo > kBiasMax ? kBiasMax : lo);
  b2 = hi < 0 ? 0 : (hi > kBiasMax ? kBiasMax : hi);
}

// ---- the NBLIC0.3 walk

// What a walk works on: the image (encode) or null (decode), the
// reconstruction (h, w) uint8 it writes, the coder's registers (lo, hi,
// window, ptr: int64 each, read at the start and written at the end), the
// stream, at efforts 2-3 the columns' moments B and the row's prefix F
// ((w, m) int64 each, B zeroed by the caller), and where not null `bins`,
// which takes the count of binary decisions the walk coded.
struct NWalk {
  const uint8_t* img;
  uint8_t* rec;
  int64_t* regs[4];
  uint8_t* buf;
  int64_t len;
  int64_t* b;
  int64_t* f;
  int h, w, near, k_step;
  int64_t* bins;
};

// The walk's tables: the counter tree (16 x 256 pairs), the 2048 context
// cells, the mappers.
struct NTables {
  uint16_t* tree;
  int32_t* ctx;
  Mappers map;
};

// The state that crosses threads at efforts 2-3 (kN features, m = 1 + kN
// + kN^2 channels): the two systems with their divisors, E, the features,
// the solves' predictions and ok flags, the strengths, and (c)'s values
// for the update.
template <int kN>
struct NAvp {
  static constexpr int kM = 1 + kN + kN * kN;
  int64_t sys[2][kN][kN + 1];
  uint64_t magic[2][kN];
  uint32_t meta[2][kN];
  int64_t e[kM];
  int64_t pxf[2];
  int64_t bias[2];
  int64_t s_curr;
  int64_t half;
  UDiv64 rs;
  int32_t feat[kN];
  int32_t ok[2];
  int32_t x;
};

// Phase (a) for thread t of n: its channels of E + F at column j into both
// systems, each strength's ridge added (avp.predict's b and a).
template <int kN>
NBT_HD void build_systems(NAvp<kN>& av, const int64_t* fcol, int t, int n) {
  for (int c = t; c < NAvp<kN>::kM; c += n) {
    if (c == 0) continue;  // the energy: no entry of a system
    const int64_t v = sv_add(av.e[c], fcol[c]);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (c <= kN) {
        av.sys[s][c - 1][kN] = sv_add(v, av.bias[s] << kIcFb3);
      } else {
        const int r = (c - 1 - kN) / kN, cc = (c - 1 - kN) % kN;
        av.sys[s][r][cc] = r == cc ? sv_add(v, av.bias[s] * kN) : v;
      }
    }
  }
}

// Phase (b): system s solved (avp.solve_batch) and its FB1 prediction
// (avp.predict_from_solve) with its ok flag.
template <int kN>
NBT_HD void solve_system(NAvp<kN>& av, int s) {
  const SolveRef<kN, 1> ref{&av.sys[s][0][0], av.magic[s], av.meta[s]};
  av.ok[s] = thread_solve<kN, 1>(ref, kN);
  av.pxf[s] = thread_predict<kN, 1>(ref, kN, av.feat);
}

// Phase (d) for thread t of n: avp.update of its channels of column j's B
// and of E by pixel x at the sample weight (c) left in av.
template <int kN>
NBT_HD void update_moments(NAvp<kN>& av, int64_t* bcol, int t, int n) {
  const int xf = av.x - kIcFitBase;
  for (int c = t; c < NAvp<kN>::kM; c += n) {
    int64_t contrib;
    if (c == 0) {
      contrib = av.s_curr;
    } else if (c <= kN) {
      contrib = tdiv_trunc(
          sv_add(sv_shl(static_cast<int64_t>(xf * av.feat[c - 1]), 4 + kIcFb1 + kIcFb1),
                 av.half),
          av.rs);
    } else {
      const int r = (c - 1 - kN) / kN, cc = (c - 1 - kN) % kN;
      contrib = tdiv_trunc(
          sv_add(sv_shl(static_cast<int64_t>(av.feat[r] * av.feat[cc]), 4 + kIcFb2 + kIcFb1),
                 av.half),
          av.rs);
    }
    const int64_t col =
        sv_add(c == 0 ? ic_decay<kIcBeta>(bcol[c]) : ic_decay<kIcAlpha>(bcol[c]), contrib);
    bcol[c] = col;
    av.e[c] = sv_add(c == 0 ? ic_decay<kIcBeta>(av.e[c]) : ic_decay<kIcAlpha>(av.e[c]), col);
  }
}

// avp.precalculate_f for thread t of n: its channels of F, the previous
// row's B decayed right to left; E reset for the row.
template <int kN>
NBT_HD void f_chain(NAvp<kN>& av, const int64_t* b, int64_t* f, int w, int t, int n) {
  constexpr int kM = NAvp<kN>::kM;
  for (int c = t; c < kM; c += n) {
    int64_t acc = 0;
    for (int j = w - 1; j >= 0; --j) {
      const size_t at = static_cast<size_t>(j) * kM + c;
      acc = sv_add(c == 0 ? ic_decay<kIcBeta>(acc) : ic_decay<kIcAlpha>(acc), b[at]);
      f[at] = acc;
    }
    av.e[c] = 0;
  }
}

// The walk of one image with `team` (see the header comment); kN = 0 is
// effort 1 (no AVP, `av` unused).
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <int kN, bool kDecode, class Team>
NBT_HD void nblic_walk(const NWalk& a, const NTables& tb, NAvp<kN ? kN : 1>& av,
                       const Team& team) {
  constexpr bool kAvp = kN > 0;
  constexpr int kNa = kN ? kN : 1;  // the AVP state's size (unused at effort 1)
  constexpr int kM = 1 + kN + kN * kN;
  team.threads([&](int t, int n) {
    for (int k = t; k < 2 * kTreePairs; k += n) tb.tree[k] = kNQwN;
    for (int k = t; k < kNCtxN; k += n) tb.ctx[k] = 0;
    map_init(tb.map, t, n);
  });
  // thread 0's state: the coder, the carried error, the ridge strength
  Coder rc{0, 0, 0, 0, a.buf, a.len};
  int64_t biasv = kBiasInit, n_bins = 0;
  team.one([&] {
    rc.lo = static_cast<uint32_t>(*a.regs[0]);
    rc.hi = static_cast<uint32_t>(*a.regs[1]);
    rc.window = static_cast<uint32_t>(*a.regs[2]);
    rc.ptr = *a.regs[3];
    if (kAvp) dual_biases(biasv, av.bias[0], av.bias[1]);
  });
  team.sync();
  for (int i = 0; i < a.h; ++i) {
    uint8_t* cur = a.rec + static_cast<size_t>(i) * a.w;
    const uint8_t* p1 = i >= 1 ? cur - a.w : cur;
    const uint8_t* p2 = i >= 2 ? cur - 2 * a.w : cur;
    if (kAvp) {
      team.threads([&](int t, int n) { f_chain<kNa>(av, a.b, a.f, a.w, t, n); });
      team.sync();
    }
    int err = 0;
    Taps tp{};
    for (int j = 0; j < a.w; ++j) {
      const size_t col = static_cast<size_t>(j) * kM;
      if (kAvp) {
        team.threads([&](int t, int n) {
          if (t == 0) {
            tp = fresh_taps(cur, p1, p2, i, j, a.w);
            const int taps[10] = {tp.a, tp.b, tp.c, tp.d, tp.e, tp.f,
                                  fresh_t(p1, i, j, a.w, tp.d), tp.h, tp.q, tp.g};
#pragma unroll
            for (int k = 0; k < kNa; ++k) av.feat[k] = taps[k] - kIcFitBase;
          }
          build_systems<kNa>(av, a.f + col, t, n);
        });
        team.sync();
        team.threads([&](int t, int n) {
          for (int s = t; s < 2; s += n) solve_system<kNa>(av, s);
        });
        team.sync();
      }
      team.one([&] {
        if (!kAvp) tp = fresh_taps(cur, p1, p2, i, j, a.w);
        int px0 = n_predict(tp);
        int64_t px1f = 0;
        if (kAvp) {
          px1f = av.pxf[0];
          if (av.ok[0])
            px0 = static_cast<int>((px1f + (1 << (kIcFb1 - 1))) >> kIcFb1);
          else
            px1f = static_cast<int64_t>(px0) << kIcFb1;
        }
        int qu, qv, qw;
        n_quantize(activity(tp, err), qu, qv, qw);
        const int adr = n_address(tp, px0, qu);
        const int c = tb.ctx[adr];
        int sign;
        const int px = correct_px(c, px0, 8, sign);
        const int key = px * 2 + sign;
        int y;
        if (kDecode) {
          const int z = code_symbol<true>(rc, tb.tree, a.k_step, qu, qv, qw, 0, n_bins);
          y = map_unfold(tb.map, key, z);
        } else {
          y = residual_fold(a.img[static_cast<size_t>(i) * a.w + j], px, sign, a.near);
          code_symbol<false>(rc, tb.tree, a.k_step, qu, qv, qw, map_fold(tb.map, key, y),
                             n_bins);
        }
        map_observe(tb.map, key, y);
        const int x = residual_unfold(y, px, sign, a.near);
        err = ic_clamp(x - px0, -kPxInc, kPxInc);
        tb.ctx[adr] = n_update_ctx(c, err);
        cur[j] = static_cast<uint8_t>(x);
        if (kAvp) {
          const int64_t xf = static_cast<int64_t>(x) << kIcFb1;
          const int64_t miss1 = ic_abs64(sv_sub(px1f, xf));
          const int64_t miss2 = ic_abs64(sv_sub(av.pxf[1], xf));
          // s_sum as avp.update clips it; miss * BETA / (BETA - 1) of a
          // non-negative miss truncates as C's /
          int64_t s = sv_add(sv_add(sv_add(av.e[0], a.f[col]), miss1 * kIcBeta / (kIcBeta - 1)),
                             1 << kIcFb1);
          s = s < (1 << kIcFb1) ? (1 << kIcFb1) : (s > (16 << kIcFb1) ? (16 << kIcFb1) : s);
          av.s_curr = miss1;
          av.half = s >> 1;
          av.rs = udiv64_gen(static_cast<uint64_t>(s));
          av.x = x;
          if (av.ok[0] && av.ok[1]) biasv = miss1 > miss2 ? av.bias[1] : av.bias[0];
          dual_biases(biasv, av.bias[0], av.bias[1]);
        }
      });
      if (kAvp) {
        team.sync();
        team.threads([&](int t, int n) { update_moments<kNa>(av, a.b + col, t, n); });
        team.sync();
      }
    }
  }
  team.one([&] {
    *a.regs[0] = rc.lo;
    *a.regs[1] = rc.hi;
    *a.regs[2] = rc.window;
    *a.regs[3] = rc.ptr;
    if (a.bins != nullptr) *a.bins = n_bins;
  });
}

// ---- the Q0.2 decode walk

// window.row_start_window: the sliding registers at (i, 0).
NBT_HD Taps q_row_start(const uint8_t* p1, const uint8_t* p2, int i, int w) {
  Taps t;
  t.a = i > 0 ? p1[0] : kIcMid;
  t.b = t.e = t.c = t.a;
  t.d = (i > 0 && w > 1) ? p1[1] : t.b;
  t.f = i > 1 ? p2[0] : t.b;
  t.g = (i > 1 && w > 1) ? p2[1] : t.f;
  t.h = t.f;
  t.q = t.c;
  t.r = (i > 1 && w > 2) ? p2[2] : t.g;
  t.s = t.h;
  return t;
}

// window.slide_window after pixel (i, j) took the value x.
NBT_HD Taps q_slide(const Taps& o, int x, const uint8_t* p1, const uint8_t* p2, int i, int j,
                    int w) {
  Taps t;
  t.e = o.a;
  t.a = x;
  t.q = o.c;
  t.c = o.b;
  t.b = o.d;
  t.s = o.h;
  t.h = o.f;
  t.f = o.g;
  t.g = o.r;
  t.d = i <= 0 ? t.a : (j + 2 >= w ? o.d : p1[j + 2]);
  t.r = i <= 1 ? t.d : (j + 3 >= w ? o.r : p2[j + 3]);
  return t;
}

// qnblic._decode_walk_plain over one stream of n_words u16 words (int32
// each; n_words >= 1): freq / cum (12, 256) and the lut (12, 2^15) of the
// container's tables, the 3072 context cells (zeroed here), the (h, w)
// reconstruction written.
NBT_HD void q_decode_walk(const int32_t* words, int64_t n_words, const int32_t* freq,
                          const int32_t* cum, const uint8_t* lut, int32_t* ctx, uint8_t* rec,
                          int h, int w) {
  for (int k = 0; k < kQCtx; ++k) ctx[k] = 0;
  const int64_t last = n_words - 1;
  uint32_t state = (static_cast<uint32_t>(words[0] & 0xFFFF) << 16) |
                   static_cast<uint32_t>(words[last < 1 ? last : 1] & 0xFFFF);
  int64_t ptr = 2;
  for (int i = 0; i < h; ++i) {
    uint8_t* cur = rec + static_cast<size_t>(i) * w;
    const uint8_t* p1 = i >= 1 ? cur - w : cur;
    const uint8_t* p2 = i >= 2 ? cur - 2 * w : cur;
    Taps t = q_row_start(p1, p2, i, w);
    int err = 0;
    for (int j = 0; j < w; ++j) {
      const int px0 = q_predict(t);
      const int qd = q_quantize(activity(t, err));
      const int adr = q_address(t, px0, qd);
      const int c = ctx[adr];
      int sign;
      const int px = correct_px(c, px0, 11, sign);
      const uint32_t lb = state & (kQNormSum - 1);
      const int y = lut[qd * kQNormSum + lb];
      const int at = qd * kQSym + y;
      state = (state >> kQNormBits) * static_cast<uint32_t>(freq[at]) + lb -
              static_cast<uint32_t>(cum[at]);
      if (state < kQLowBound) {
        state = (state << 16) | static_cast<uint32_t>(words[ptr < last ? ptr : last] & 0xFFFF);
        ++ptr;
      }
      const int x = residual_unfold(y, px, sign, 0);
      err = x - px0;
      ctx[adr] = q_update_ctx(c, err);
      cur[j] = static_cast<uint8_t>(x);
      t = q_slide(t, x, p1, p2, i, j, w);
    }
  }
}

// ---- the Q0.2 encode's context chain

// One context's EWMA chain: its pixels are order[p0 .. p1) (raster order,
// from a stable sort by address); `before` takes each pixel's state before
// its step, 0 for the first.  Eight pixels' loads go ahead of their steps.
NBT_HD void q_chain_context(const int32_t* err, const int64_t* order, int64_t p0, int64_t p1,
                            int32_t* before) {
  int c = 0;
  int64_t p = p0;
  for (; p + 8 <= p1; p += 8) {
    int64_t idx[8];
    int e[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) idx[k] = order[p + k];
#pragma unroll
    for (int k = 0; k < 8; ++k) e[k] = err[idx[k]];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      before[idx[k]] = c;
      c = q_update_ctx(c, e[k]);
    }
  }
  for (; p < p1; ++p) {
    const int64_t idx = order[p];
    before[idx] = c;
    c = q_update_ctx(c, err[idx]);
  }
}

}  // namespace
