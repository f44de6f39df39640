// The profile-3 per-pixel AVP chain, one warp a strip lane: the device
// counterpart of the per-pixel model that every profile-3 walk shares
// (nblic_tpu_torch/models/strips.py: _pixel_taps, _round_px, _pixel_ctx,
// _pixel_correct, _pixel_update, _mix_update; ops/pavp.py: solve_stats,
// mix_blend, contributions, decay, f_chain, quantize_weights, predict_wq;
// ops/avp.py: solve_batch, predict_from_solve, tdiv_by; ops/predict.py:
// n_quantize_activity).  Kernel K5 (p3_near_walk.cu) runs it with a fold
// where a decoder reads its symbols; kernel K4 (p3_decode_walk.cu) runs it
// with the decoder and the segment-frozen contracts.  The window, the
// blend prediction, the activity and the context address are
// pixel_chain.cuh's, which compute the same thing.
//
// One warp a lane.  A pixel's statistics are m = 1 + n + n^2 channels;
// channel c lives in thread c % 32, slot c / 32 (avp_slots), so the
// channels of one column are contiguous in device memory and a warp's loads
// coalesce.  What is per channel runs over the threads: E's and B's
// update, the F chain, the moments, the ridge system's entries.  The solve
// runs level by level over the warp: each elimination level's pivot search
// is a butterfly of shuffles, its (n - k - 1)(n - k) updates spread over
// the threads, and all of them divide by one pivot, whose reciprocal
// (udiv64.cuh) is computed once; the back substitution is n - 1 levels of
// one shuffle and one quotient a row; the prediction's n terms are summed
// by shuffles.  The system, its divisors and the features sit in the
// warp's shared memory (AvpShared).  What is one value a pixel (the
// window, the blend, the quantizers, the bias, the fold) every thread
// computes alike: a warp issues it once, and no shuffle has to spread it.
//
// The feature count.  Each function takes the compile-time kN, which
// sizes its arrays, and a runtime n <= kN, the count it computes with
// (default kN, which the compiler folds): an instance with kN = 12 serves
// any count.  The statistics are laid out with n, and the augmented
// column of a system is column n.
//
// Exactness.  The plain versions compute in int64 with torch's semantics,
// and each function here reproduces them bit for bit:
// - products, sums and left shifts wrap modulo 2^64 (torch and XLA wrap;
//   signed overflow is undefined in C++, so they go through uint64);
// - |INT64_MIN| is INT64_MIN (torch.abs), and torch's floor division of
//   such an operand is not C's /: tdiv_by reproduces it;
// - right shifts of negative values are arithmetic, as torch's >>;
// - a wrapping sum is the same in any order, so the warp's reductions
//   equal the plain version's sums.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "pixel_chain.cuh"
#include "udiv64.cuh"

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
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

// Statistics a pixel: the energy, n moments, the n x n matrix.
template <int kN>
__host__ __device__ constexpr int avp_m() { return 1 + kN + kN * kN; }
__host__ __device__ constexpr int avp_m(int n) { return 1 + n + n * n; }
// Channel slots a thread holds: channel c is thread c % 32's slot c / 32.
template <int kN>
__host__ __device__ constexpr int avp_slots() { return (avp_m<kN>() + kWarp - 1) / kWarp; }

// ---- int64 arithmetic as torch computes it (wneg, wabs and floor_div
// are udiv64.cuh's)

__device__ __forceinline__ int64_t wadd(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) + static_cast<uint64_t>(b));
}
__device__ __forceinline__ int64_t wsub(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) - static_cast<uint64_t>(b));
}
__device__ __forceinline__ int64_t wmul(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) * static_cast<uint64_t>(b));
}
__device__ __forceinline__ int64_t wshl(int64_t a, int s) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) << s);
}

// pavp.decay: (v (ab - 1) + ab / 2) / ab, truncating toward zero on
// negative moments (torch.div "trunc" is C's /).  The divisor is a
// constant, so nvcc divides by a multiply-high; the product wraps.
template <int kAb>
__device__ __forceinline__ int64_t decay(int64_t v) {
  return wadd(wmul(v, kAb - 1), kAb >> 1) / kAb;
}

// ---- the warp's layout

// A warp's shared scratch for one lane's solve: the augmented system, the
// diagonal's divisors with their reciprocals, the features.
template <int kN>
struct AvpShared {
  int64_t a[kN][kN + 1];
  TDiv dv[kN];
  int feat[kN];
};

// Where thread t's channels go: for slot s (channel c = 32 s + t), kk = -2
// for the energy (c = 0), -1 for a moment of x (c in 1..n: system entry
// (ll, n)), the matrix row for c > n (entry (kk, ll)), -3 past m.
template <int kN>
struct Slots {
  int kk[avp_slots<kN>()], ll[avp_slots<kN>()];
};

template <int kN>
__device__ __forceinline__ Slots<kN> slots_of(int t, int n = kN) {
  Slots<kN> sl;
#pragma unroll
  for (int s = 0; s < avp_slots<kN>(); ++s) {
    const int c = s * kWarp + t;
    if (c == 0) {
      sl.kk[s] = -2;
      sl.ll[s] = 0;
    } else if (c <= n) {
      sl.kk[s] = -1;
      sl.ll[s] = c - 1;
    } else if (c < avp_m(n)) {
      sl.kk[s] = (c - 1 - n) / n;
      sl.ll[s] = (c - 1 - n) % n;
    } else {
      sl.kk[s] = -3;
      sl.ll[s] = 0;
    }
  }
  return sl;
}

// Load thread t's channels of one column (`col`, m contiguous channels);
// channels past m read as 0.
template <int kS>
__device__ __forceinline__ void load_col(const int64_t* col, int m, int t, int64_t (&v)[kS]) {
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const int c = s * kWarp + t;
    v[s] = c < m ? col[c] : 0;
  }
}

// ---- prediction

// Thread t's AVP feature of pixel (i, j): tap t of a, b, c, d, e, f, t, h,
// q, g, r, s minus FIT_BASE, where the t tap is (i - 1, j + 2) of the
// reconstructed row above, the caller's d out of range
// (strips._pixel_taps); 0 for t >= kN.
template <int kN>
__device__ __forceinline__ int avp_feature(const Window& v, int t_tap, int t) {
  static_assert(kN >= 1 && kN <= kNTaps, "AVP takes 1 to 12 taps");
  const int taps[kNTaps] = {v.a, v.b, v.c, v.d, v.e, v.f, t_tap, v.h, v.q, v.gg, v.r, v.s};
  int f = 0;
#pragma unroll
  for (int k = 0; k < kN; ++k)
    if (k == t) f = taps[k] - kFitBase;
  return f;
}

// pavp.solve_stats's system: the augmented n x (n + 1) ridge system of
// the statistics E + F (thread t's channels in `e` and `f`) into sh.a.
// Returns channel 0 of E + F, on every thread.  The caller syncs the warp
// before the system is read.
template <int kN, int kS>
__device__ __forceinline__ int64_t warp_system(const int64_t (&e)[kS], const int64_t (&f)[kS],
                                               const Slots<kN>& sl, AvpShared<kN>& sh,
                                               int n = kN) {
  int64_t s0 = 0;
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const int64_t v = wadd(e[s], f[s]);
    const int kk = sl.kk[s], ll = sl.ll[s];
    if (kk >= 0)
      sh.a[kk][ll] = wadd(v, kk == ll ? kRidgeBias * n : 0);
    else if (kk == -1)
      sh.a[ll][n] = wadd(v, kRidgeBias << kFb3);
    else if (kk == -2)
      s0 = v;
  }
  return __shfl_sync(kFull, s0, 0);
}

// avp.solve_batch on the warp's system sh.a: int64 Gaussian elimination
// with partial pivoting, in place, level by level.  Afterwards solution k
// is x / a[k][k], x thread k's `x`; sh.dv[k] holds a[k][k]'s divisor (1
// where it is 0).  Returns false where a pivot was 0 (the plain version
// then goes on with a divisor of 1, and so does this), on every thread.
// Column k below the diagonal is left as it was: nothing reads it.
template <int kN>
__device__ __forceinline__ bool warp_solve(AvpShared<kN>& sh, int t, int64_t& x, int n = kN) {
  constexpr int kRounds = ((kN - 1) * kN + kWarp - 1) / kWarp;  // a level's rounds at most
  bool ok = true;
  for (int k = 0; k < n - 1; ++k) {
    // the pivot: the first maximum of |a[r][k]|, r >= k, as torch.argmax
    // takes it (|INT64_MIN| is INT64_MIN, the least): a butterfly over
    // each half-warp, both halves holding the same rows
    const int r = k + (t & 15);
    int64_t best = r < n ? wabs(sh.a[r][k]) : INT64_MIN;
    int piv = r < n ? r : kWarp;
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const int64_t ob = __shfl_xor_sync(kFull, best, off);
      const int op = __shfl_xor_sync(kFull, piv, off);
      if (ob > best || (ob == best && op < piv)) {
        best = ob;
        piv = op;
      }
    }
    if (piv != k) {  // every thread holds the same pivot
      if (t <= n - k) {  // columns left of k are not read again
        const int64_t tmp = sh.a[k][k + t];
        sh.a[k][k + t] = sh.a[piv][k + t];
        sh.a[piv][k + t] = tmp;
      }
      __syncwarp();
    }
    const int64_t d = sh.a[k][k];
    ok = ok && d != 0;
    const int64_t safe = d == 0 ? 1 : d;
    const TDiv dv = tdiv_gen(wabs(safe), safe < 0);
    if (t == 0) sh.dv[k] = dv;
    // the level's (n - k - 1)(n - k) entries over the threads: entry e is
    // row k + 1 + e / cols, column k + 1 + e % cols, e / cols as a
    // multiply-high (exact for e < 2^12).  No entry reads another's, so
    // every round's loads go before its stores, and the rounds overlap
    const int cols = n - k, cnt = (n - k - 1) * cols;
    const int inv = 0x10000 / cols + 1;
    int64_t upd[kRounds];
    int at[kRounds];
#pragma unroll
    for (int rnd = 0; rnd < kRounds; ++rnd) {
      const int e = t + rnd * kWarp;
      at[rnd] = -1;
      if (e < cnt) {
        const int q = (e * inv) >> 16;
        const int rr = k + 1 + q, c = k + 1 + e - q * cols;
        at[rnd] = rr * (kN + 1) + c;
        // the product passes 2^63 and wraps
        upd[rnd] = wsub(sh.a[rr][c], tdiv_by(wmul(sh.a[k][c], sh.a[rr][k]), dv));
      }
    }
#pragma unroll
    for (int rnd = 0; rnd < kRounds; ++rnd)
      if (at[rnd] >= 0) (&sh.a[0][0])[at[rnd]] = upd[rnd];
    __syncwarp();
  }
  // the last diagonal's divisor; the back substitution tests it
  const int64_t d = sh.a[n - 1][n - 1];
  const int64_t safe = d == 0 ? 1 : d;
  const TDiv last = tdiv_gen(wabs(safe), safe < 0);
  if (n > 1) ok = ok && d != 0;
  if (t == 0) sh.dv[n - 1] = last;
  // the back substitution: thread r holds row r's augmented entry, and
  // level k hands row k's to the rows above
  x = t < n ? sh.a[t][n] : 0;
  for (int k = n - 1; k > 0; --k) {
    const int64_t xk = __shfl_sync(kFull, x, k);
    const TDiv dv = k == n - 1 ? last : sh.dv[k];
    if (t < k) x = wsub(x, tdiv_by(wmul(xk, sh.a[t][k]), dv));
  }
  __syncwarp();
  return ok;
}

// avp.predict_from_solve: the FB1 fixed-point prediction of a solved
// system (thread t's solution numerator `x` and feature `feat`), clipped
// to [0, 255 << FB1], on every thread.
template <int kN>
__device__ __forceinline__ int64_t warp_predict(const AvpShared<kN>& sh, int64_t x, int feat,
                                                int t, int n = kN) {
  int64_t term = 0;
  if (t < n) {
    const TDiv dv = sh.dv[t];
    // the divisor >> 1: an arithmetic shift of a possibly negative divisor
    term = tdiv_by(wadd(wshl(wmul(x, feat), kFb2), tdiv_value(dv) >> 1), dv);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) term = wadd(term, __shfl_xor_sync(kFull, term, off));
  const int64_t px = wadd(static_cast<int64_t>(kFitBase) << kFb1, term);
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

// pavp.f_chain for one lane over the warp: F at each column, the previous
// row's B accumulated right to left.  b and f: the lane's (W, m) blocks,
// channel c of column j at j * m + c.  Channel 0 decays by kAb0, the
// others by kAb.  Each thread writes and later reads only its own
// channels.
template <int kS, int kAb0, int kAb>
__device__ __forceinline__ void warp_f_chain(const int64_t* b, int64_t* f, int w, int m,
                                             int t) {
  int64_t acc[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) acc[s] = 0;
#pragma unroll 4
  for (int j = w - 1; j >= 0; --j) {
    const size_t col = static_cast<size_t>(j) * m;
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const int c = s * kWarp + t;
      if (c < m) {
        const int64_t d = c == 0 ? decay<kAb0>(acc[s]) : decay<kAb>(acc[s]);
        acc[s] = wadd(d, b[col + c]);
        f[col + c] = acc[s];
      }
    }
  }
}

// strips._pixel_update over the warp: fold the reconstructed pixel x into
// column j of B (thread t's channels of it in `bcol`, the column written
// to `bout`) and into E (`e`), the sample weighted by the simple
// predictor's error; `s0` is channel 0 of the pixel's statistics, `feat`
// the features in shared memory.  pavp.contributions gives each channel's
// term: the moments ((left right) << shift + s / 2) / s truncated toward
// zero, all by the one s, whose reciprocal is computed once (s in [2^12,
// 2^16], |left right| <= 2^14: the numerators never near 2^63).
template <int kN, int kS>
__device__ __forceinline__ void warp_update(int x, int px_s, int64_t s0, const int* feat,
                                            const Slots<kN>& sl, int64_t (&e)[kS],
                                            const int64_t (&bcol)[kS], int64_t* bout, int t) {
  const int64_t s_curr = static_cast<int64_t>(iabs(x - px_s)) << kFb1;
  // s_curr * BETA / (BETA - 1) of a non-negative value: C's / is "trunc"
  const int64_t s_sum = wadd(s0, s_curr * kBeta / (kBeta - 1));
  const int64_t s_raw = wadd(s_sum, 1 << kFb1);  // pavp._clip_s_sum
  const int64_t s = s_raw < (1 << kFb1) ? (1 << kFb1)
                                        : (s_raw > (16 << kFb1) ? (16 << kFb1) : s_raw);
  const UDiv64 rs = udiv64_gen(static_cast<uint64_t>(s));
  const int xf = x - kFitBase;
#pragma unroll
  for (int k = 0; k < kS; ++k) {
    const int kk = sl.kk[k];
    if (kk == -3) continue;
    const bool energy = kk == -2;
    int64_t contrib = s_curr;
    if (!energy) {
      const int left = kk == -1 ? xf : feat[kk];
      const int shift = kk == -1 ? 4 + kFb1 + kFb1 : 4 + kFb2 + kFb1;
      contrib = tdiv_trunc(wadd(wshl(static_cast<int64_t>(left * feat[sl.ll[k]]), shift), s >> 1),
                           rs);
    }
    const int64_t col = wadd(energy ? decay<kBeta>(bcol[k]) : decay<kAlpha>(bcol[k]), contrib);
    bout[k * kWarp + t] = col;
    e[k] = wadd(energy ? decay<kBeta>(e[k]) : decay<kAlpha>(e[k]), col);
  }
}

// ---- the segment-frozen contracts (seg_stats, w_pred)

// pavp.decay of thread t's channels of E in place, the energy by BETA and
// the moments by ALPHA: one step of pavp.e_freeze_extend.
template <int kS>
__device__ __forceinline__ void decay_stats(int64_t (&e)[kS], int t) {
#pragma unroll
  for (int s = 0; s < kS; ++s)
    e[s] = (s == 0 && t == 0) ? decay<kBeta>(e[s]) : decay<kAlpha>(e[s]);
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

// pavp.predict_wq over the warp: the int32 prediction from thread t's
// quantized weight and feature (0 past the count), |sum| < 2^30 (|weight|
// <= WCLIP, |feature| <= 128, n <= 12), on every thread.
__device__ __forceinline__ int warp_predict_wq(int wq, int feat) {
  const int acc = __reduce_add_sync(kFull, wq * feat);
  const int px = clampi((kFitBase << kFbw) + acc, 0, 255 << kFbw);
  return (px + (1 << (kFbw - 1))) >> kFbw;
}

// strips._mix_update: both predictors' |error| at x into the two mix
// chains: column j of the mix B (`bcol` in, the new column returned in
// it) and E (`e`).  Every thread computes it alike.
__device__ __forceinline__ void mix_update(int x, int px_hard, int px_s, int64_t (&e)[2],
                                           int64_t (&bcol)[2]) {
  const int64_t err[2] = {static_cast<int64_t>(iabs(x - px_hard)) << kFb1,
                          static_cast<int64_t>(iabs(x - px_s)) << kFb1};
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    bcol[c] = wadd(decay<kBeta>(bcol[c]), err[c]);
    e[c] = wadd(decay<kBeta>(e[c]), bcol[c]);
  }
}

}  // namespace
