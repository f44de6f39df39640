// The profile-3 per-pixel AVP chain: the device counterpart of the
// per-pixel model that every profile-3 walk shares
// (nblic_tpu_torch/models/strips.py: _pixel_taps, _round_px, _pixel_ctx,
// _pixel_correct, _pixel_update, _mix_update; ops/pavp.py: solve_stats,
// mix_blend, contributions, decay, f_chain; ops/avp.py: solve_batch,
// predict_from_solve, tdiv_by; ops/predict.py: n_quantize_activity).
// Kernel K5 (p3_near_walk.cu) runs it with a fold where a decoder reads
// its symbols; kernel K4 (p3_decode_walk.cu) runs it with the decoder,
// and adds the segment-frozen contracts below (pavp.quantize_weights,
// predict_wq, the decay-extended E).  The window, the blend prediction, the
// activity and the context address are pixel_chain.cuh's, which compute
// the same thing.
//
// The feature count.  Each function takes the compile-time kN, which
// sizes its arrays, and a runtime n <= kN, the count it computes with
// (default kN, which the compiler folds): an instance with kN = 12 serves
// any count.  A pixel's statistics are m = 1 + n + n^2 channels, laid out
// with n, and the augmented column of a system is column n.
//
// Exactness.  The plain versions compute in int64 with torch's semantics,
// and each function here reproduces them bit for bit:
// - products, sums and left shifts wrap modulo 2^64 (torch and XLA wrap;
//   signed overflow is undefined in C++, so they go through uint64);
// - |INT64_MIN| is INT64_MIN (torch.abs), and torch's floor division of
//   such an operand is not C's /: tdiv_by reproduces it;
// - right shifts of negative values are arithmetic, as torch's >>.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "pixel_chain.cuh"

namespace {

constexpr int kNTaps = 12;     // AVP taps a container may name (strips.N_TAPS)
constexpr int kFitBase = 128;  // avp.FIT_BASE
constexpr int kFb1 = 12;       // avp.FB1, the prediction's fixed point
constexpr int kFb2 = 2;        // avp.FB2
constexpr int kFb3 = kFb1 - kFb2;
constexpr int kAlpha = 5;      // decay denominator of the regression moments
constexpr int kBeta = 3;       // decay denominator of the error energies
constexpr int kRidgeBias = 8;  // pavp.RIDGE_BIAS
constexpr int kMixSh = 12;     // pavp.MIX_SH
constexpr int kMaxPxInc = 127; // strips.MAX_PX_INC, the carried error's clip
constexpr int kBiasFracBits = 4;
constexpr int kNQw = 32;       // predict.N_QW
constexpr int kFbw = 12;       // pavp.FBW, the quantized weights' fixed point
constexpr int kWClip = (1 << 19) - 1;  // pavp.WCLIP

// Statistics a pixel: the energy, n moments, the n x n matrix.
template <int kN>
__host__ __device__ constexpr int avp_m() { return 1 + kN + kN * kN; }
__host__ __device__ constexpr int avp_m(int n) { return 1 + n + n * n; }

// ---- int64 arithmetic as torch computes it

__device__ __forceinline__ int64_t wadd(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) + static_cast<uint64_t>(b));
}
__device__ __forceinline__ int64_t wsub(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) - static_cast<uint64_t>(b));
}
__device__ __forceinline__ int64_t wmul(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) * static_cast<uint64_t>(b));
}
__device__ __forceinline__ int64_t wneg(int64_t a) {
  return static_cast<int64_t>(0ull - static_cast<uint64_t>(a));
}
__device__ __forceinline__ int64_t wshl(int64_t a, int s) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) << s);
}
// torch.abs: INT64_MIN stays INT64_MIN
__device__ __forceinline__ int64_t wabs(int64_t a) { return a < 0 ? wneg(a) : a; }

// torch's floor division of int64 (c10::div_floor_integer) for b != 0; the
// callers never divide INT64_MIN by -1
__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
  const int64_t q = a / b;
  return ((a < 0) != (b < 0) && a % b != 0) ? q - 1 : q;
}

// avp.tdiv_by: floor(|a| / b_abs), negated where a's and the divisor's
// signs differ.  Where both magnitudes are non-negative the floor is C's
// unsigned /.  Trap: |INT64_MIN| wraps to itself, a negative magnitude,
// and floor division of it (or by it) rounds otherwise than C's /; the
// plain version does so, and so does this.
__device__ __forceinline__ int64_t tdiv_by(int64_t a, int64_t b_abs, bool b_neg) {
  const int64_t a_abs = wabs(a);
  const int64_t q =
      (a_abs >= 0 && b_abs > 0)
          ? static_cast<int64_t>(static_cast<uint64_t>(a_abs) / static_cast<uint64_t>(b_abs))
          : floor_div(a_abs, b_abs);
  return ((a < 0) != b_neg) ? wneg(q) : q;
}

// pavp.decay: (v (ab - 1) + ab / 2) / ab, truncating toward zero on
// negative moments (torch.div "trunc" is C's /).  The divisor is a
// constant, so nvcc divides by a multiply-high; the product wraps.
template <int kAb>
__device__ __forceinline__ int64_t decay(int64_t v) {
  return wadd(wmul(v, kAb - 1), kAb >> 1) / kAb;
}

// ---- prediction

// The n AVP features of pixel (i, j): the taps a, b, c, d, e, f, t, h, q,
// g, r, s minus FIT_BASE, where t is (i - 1, j + 2) of the reconstructed
// row above, the caller's d out of range (strips._pixel_taps).
template <int kN>
__device__ __forceinline__ void avp_features(const Window& v, int t, int (&feat)[kN],
                                             int n = kN) {
  static_assert(kN >= 1 && kN <= kNTaps, "AVP takes 1 to 12 taps");
  const int taps[kNTaps] = {v.a, v.b, v.c, v.d, v.e, v.f, t, v.h, v.q, v.gg, v.r, v.s};
#pragma unroll
  for (int k = 0; k < kN; ++k)
    if (k < n) feat[k] = taps[k] - kFitBase;
}

// pavp.solve_stats's system: the augmented n x (n + 1) ridge system of
// the statistics E + F, with E in `e` and F at f[c * stride] for channel c.
template <int kN>
__device__ __forceinline__ void ridge_system(const int64_t* e, const int64_t* f,
                                             size_t stride, int64_t (&a)[kN][kN + 1],
                                             int n = kN) {
  for (int k = 0; k < n; ++k) {
    const int c = 1 + n + k * n;
    for (int l = 0; l < n; ++l)
      a[k][l] = wadd(wadd(e[c + l], f[(c + l) * stride]), k == l ? kRidgeBias * n : 0);
    a[k][n] = wadd(wadd(e[1 + k], f[(1 + k) * stride]), kRidgeBias << kFb3);
  }
}

// avp.solve_batch on one system: int64 Gaussian elimination with partial
// pivoting, in place.  Afterwards solution k is a[k][n] / a[k][k]; returns
// false where a pivot was 0 (the plain version then goes on with a divisor
// of 1, and so does this).  Column k below the diagonal is left as it
// was: nothing reads it.
template <int kN>
__device__ __forceinline__ bool ridge_solve(int64_t (&a)[kN][kN + 1], int n = kN) {
  bool ok = true;
  for (int k = 0; k < n - 1; ++k) {
    // the first maximum of |a[r][k]| (strict >), as torch.argmax takes it;
    // |INT64_MIN| is INT64_MIN, the least
    int piv = k;
    int64_t best = wabs(a[k][k]);
    for (int r = k + 1; r < n; ++r) {
      const int64_t v = wabs(a[r][k]);
      if (v > best) {
        best = v;
        piv = r;
      }
    }
    if (piv != k) {
      for (int c = k; c <= n; ++c) {  // columns left of k are not read again
        const int64_t t = a[k][c];
        a[k][c] = a[piv][c];
        a[piv][c] = t;
      }
    }
    const int64_t d = a[k][k];
    ok = ok && d != 0;
    const int64_t safe = d == 0 ? 1 : d;
    const int64_t d_abs = wabs(safe);
    const bool d_neg = safe < 0;
    for (int r = k + 1; r < n; ++r) {
      const int64_t ark = a[r][k];
      for (int c = k + 1; c <= n; ++c)  // the product passes 2^63 and wraps
        a[r][c] = wsub(a[r][c], tdiv_by(wmul(a[k][c], ark), d_abs, d_neg));
    }
  }
  for (int k = n - 1; k > 0; --k) {
    const int64_t d = a[k][k];
    ok = ok && d != 0;
    const int64_t safe = d == 0 ? 1 : d;
    const int64_t d_abs = wabs(safe);
    const bool d_neg = safe < 0;
    for (int r = 0; r < k; ++r)
      a[r][n] = wsub(a[r][n], tdiv_by(wmul(a[k][n], a[r][k]), d_abs, d_neg));
  }
  return ok;
}

// avp.predict_from_solve: the FB1 fixed-point prediction of a solved
// system, clipped to [0, 255 << FB1].
template <int kN>
__device__ __forceinline__ int64_t predict_from_solve(const int64_t (&a)[kN][kN + 1],
                                                      const int (&feat)[kN], int n = kN) {
  int64_t acc = 0;
  for (int k = 0; k < n; ++k) {
    const int64_t safe = a[k][k] == 0 ? 1 : a[k][k];
    // safe >> 1: an arithmetic shift of a possibly negative divisor
    const int64_t t = wadd(wshl(wmul(a[k][n], feat[k]), kFb2), safe >> 1);
    acc = wadd(acc, tdiv_by(t, wabs(safe), safe < 0));
  }
  const int64_t px = wadd(static_cast<int64_t>(kFitBase) << kFb1, acc);
  return px < 0 ? 0 : (px > (255ll << kFb1) ? (255ll << kFb1) : px);
}

// strips._round_px of a solved prediction (the caller takes px_s where the
// solve failed).
__device__ __forceinline__ int round_px(int64_t px_f) {
  return static_cast<int>((px_f + (1 << (kFb1 - 1))) >> kFb1);
}

// pavp.mix_blend where the solve succeeded: the hard AVP prediction and
// the simple one weighted by the other's squared decayed |error| energy.
// The energies are sums of non-negative terms far below 2^63, so every
// operand is non-negative and C's / is the plain floor division.
__device__ __forceinline__ int mix_blend(int px_a, int px_s, int64_t e_a, int64_t e_s) {
  const int64_t ea = e_a >> kMixSh, es = e_s >> kMixSh;
  const int64_t ea2 = ea * ea, es2 = es * es;
  const int64_t den = ea2 + es2 + 2;
  const int64_t num = px_a * (es2 + 1) + px_s * (ea2 + 1) + (den >> 1);
  return static_cast<int>(num / den);
}

// ---- contexts and the bias

// predict.n_quantize_activity: the dual-bin quantizer with 5-bit
// interpolation.  delta > mid_lo where it interpolates, so the quotient's
// operands are non-negative and C's / is the floor.
__device__ __forceinline__ void n_quantize_activity(int delta, int& qu, int& qv, int& qw) {
  // constants.Q_MID, the bins' midpoints
  const int mids[16] = {0, 2, 4, 7, 10, 14, 20, 26, 34, 42, 52, 64, 78, 95, 135, 200};
  int qd = 0;
#pragma unroll
  for (int k = 0; k < 15; ++k) qd += delta > mids[k];
  int mid_lo = 0, mid_hi = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (k == qd) mid_hi = mids[k];
    if (k == (qd > 0 ? qd - 1 : 0)) mid_lo = mids[k];
  }
  const bool interp = delta < mid_hi && qd > 0;
  const int qw_raw = interp ? kNQw * (delta - mid_lo) / max(mid_hi - mid_lo, 1) : 0;
  const bool low_half = qw_raw < kNQw / 2;
  qu = (interp && low_half) ? qd - 1 : qd;
  qv = (interp && !low_half) ? qd - 1 : qd;
  qw = interp ? (low_half ? qw_raw : kNQw - qw_raw) : 0;
}

// strips._pixel_correct: the bias-corrected prediction, the bias's half
// bit as the preferred sign and the mapper key.  >> is arithmetic.
__device__ __forceinline__ void pixel_correct(int px0, int bias, int& sign, int& pxc,
                                              int& key) {
  sign = (bias >> (kBiasFracBits - 1)) & 1;
  pxc = clampi(px0 + (bias >> kBiasFracBits) + sign, 0, 255);
  key = pxc * 2 + sign;
}

// ---- the moment chains

// pavp.f_chain for one lane: F at each column, the previous row's B
// accumulated right to left.  b and f: (W, n_c, lanes) with the lane's
// column at the pointers, n_c <= kC channels (default kC); `acc` holds n_c
// values of scratch.  Channel 0 decays by kAb0, the others by kAb.
template <int kC, int kAb0, int kAb>
__device__ __forceinline__ void f_chain(const int64_t* b, int64_t* f, int w, size_t lanes,
                                        int64_t* acc, int n_c = kC) {
  for (int c = 0; c < n_c; ++c) acc[c] = 0;
  for (int j = w - 1; j >= 0; --j) {
    const size_t col = static_cast<size_t>(j) * n_c * lanes;
    for (int c = 0; c < n_c; ++c) {
      const int64_t d = c == 0 ? decay<kAb0>(acc[c]) : decay<kAb>(acc[c]);
      acc[c] = wadd(d, b[col + c * lanes]);
      f[col + c * lanes] = acc[c];
    }
  }
}

// pavp._moments: ((left right) << shift + s / 2) / s, truncating toward
// zero; s is in [2^12, 2^16] and |left right| <= 2^14, so the numerator
// never nears 2^63 and C's / is avp.tdiv.
__device__ __forceinline__ int64_t moment(int left, int right, int shift, int64_t s) {
  return wadd(wshl(static_cast<int64_t>(left * right), shift), s >> 1) / s;
}

// strips._pixel_update: fold the reconstructed pixel x into column j of B
// (at `b`, channel c at b[c * stride], updated in place) and into E (`e`),
// the sample weighted by the simple predictor's error; `s0` is channel 0
// of the pixel's E + F.  pavp.contributions gives each channel's term.
template <int kN>
__device__ __forceinline__ void avp_update(int x, int px_s, const int (&feat)[kN], int64_t s0,
                                           int64_t* e, int64_t* b, size_t stride,
                                           int n = kN) {
  const int64_t s_curr = static_cast<int64_t>(iabs(x - px_s)) << kFb1;
  // s_curr * BETA / (BETA - 1) of a non-negative value: C's / is "trunc"
  const int64_t s_sum = wadd(s0, s_curr * kBeta / (kBeta - 1));
  const int64_t s_raw = wadd(s_sum, 1 << kFb1);  // pavp._clip_s_sum
  const int64_t s = s_raw < (1 << kFb1) ? (1 << kFb1)
                                        : (s_raw > (16 << kFb1) ? (16 << kFb1) : s_raw);
  auto fold_in = [&](int c, int64_t contrib, bool energy) {
    const int64_t old = b[c * stride];
    const int64_t col = wadd(energy ? decay<kBeta>(old) : decay<kAlpha>(old), contrib);
    b[c * stride] = col;
    e[c] = wadd(energy ? decay<kBeta>(e[c]) : decay<kAlpha>(e[c]), col);
  };
  fold_in(0, s_curr, true);
  const int xf = x - kFitBase;
  for (int k = 0; k < n; ++k) fold_in(1 + k, moment(xf, feat[k], 4 + kFb1 + kFb1, s), false);
  for (int k = 0; k < n; ++k)
    for (int l = 0; l < n; ++l)
      fold_in(1 + n + k * n + l, moment(feat[k], feat[l], 4 + kFb2 + kFb1, s), false);
}

// ---- the segment-frozen contracts (seg_stats, w_pred)

// pavp.decay of every channel of E in place, the energy by BETA and the
// moments by ALPHA: one step of pavp.e_freeze_extend.
__device__ __forceinline__ void decay_stats(int64_t* e, int m) {
  e[0] = decay<kBeta>(e[0]);
  for (int c = 1; c < m; ++c) e[c] = decay<kAlpha>(e[c]);
}

// pavp.quantize_weights of one weight: num * 2^(FB2 - FB1) / diag at step
// 2^-FBW, quotient and remainder apart on magnitudes, truncated toward
// zero and clipped to [-WCLIP, WCLIP].  Trap: |INT64_MIN| is INT64_MIN, a
// negative magnitude; torch's floor divisions of it round toward minus
// infinity (floor_div), the products and shifts wrap.
__device__ __forceinline__ int quantize_weight(int64_t diag, int64_t num) {
  constexpr int kEfb = kFbw - kFb1 + kFb2;  // 2
  const int64_t safe = diag == 0 ? 1 : diag;
  int64_t ad = wabs(safe), an = wabs(num);
  if (ad >= (1ll << 48)) {  // INT64_MIN's magnitude is negative: not big
    ad >>= 16;
    an >>= 16;  // arithmetic, as torch's >>
  }
  ad = ad < 1 ? 1 : ad;
  const int64_t q0 = floor_div(an, ad);
  const int64_t r = wsub(an, wmul(q0, ad));
  const int64_t mag = wadd(wshl(q0 > (1ll << 28) ? (1ll << 28) : q0, kEfb),
                           floor_div(wshl(r, kEfb), ad));
  const int64_t sgn = static_cast<int64_t>((num > 0) - (num < 0)) * ((safe > 0) - (safe < 0));
  const int64_t v = wmul(sgn, mag);
  return static_cast<int>(v < -kWClip ? -kWClip : (v > kWClip ? kWClip : v));
}

// pavp.predict_wq: the int32 prediction from quantized weights and the
// features, |acc| < 2^30 (|weight| <= WCLIP, |feature| <= 128, n <= 12).
template <int kN>
__device__ __forceinline__ int predict_wq(const int (&wq)[kN], const int (&feat)[kN],
                                          int n = kN) {
  int acc = 0;
  for (int k = 0; k < n; ++k) acc += wq[k] * feat[k];
  const int px = clampi((kFitBase << kFbw) + acc, 0, 255 << kFbw);
  return (px + (1 << (kFbw - 1))) >> kFbw;
}

// strips._mix_update: both predictors' |error| at x into the two mix
// chains: column j of the mix B (at `b`, updated in place) and E (`e`).
__device__ __forceinline__ void mix_update(int x, int px_hard, int px_s, int64_t (&e)[2],
                                           int64_t* b, size_t stride) {
  const int64_t err[2] = {static_cast<int64_t>(iabs(x - px_hard)) << kFb1,
                          static_cast<int64_t>(iabs(x - px_s)) << kFb1};
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int64_t col = wadd(decay<kBeta>(b[c * stride]), err[c]);
    b[c * stride] = col;
    e[c] = wadd(decay<kBeta>(e[c]), col);
  }
}

}  // namespace
