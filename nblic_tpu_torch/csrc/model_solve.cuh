// The profile-3 modeling pass's ridge solve, one system a thread: the
// device counterpart of nblic_tpu_torch/ops/pavp.py's solve_stats,
// predict_from_stats and predict_from_stats_wq (ops/avp.py's solve_batch
// and predict_from_solve, pavp.py's quantize_weights and predict_wq) for
// one statistics row, which kernel K11 (p3_model_solve.cu) runs on every
// row a thread.
//
// A thread's system is the augmented n x (n + 1) int64 matrix, entry (r,
// c) at a[(r (kN + 1) + c) kStride]: K11 keeps a warp's 32 systems in
// shared memory with the system fastest (kStride 33: a warp's accesses
// of one entry are 32 consecutive words, its staging stores of a row's
// consecutive channels fall in distinct banks), the host test one system
// (kStride 1).  The elimination runs level by level with partial
// pivoting, every quotient of a level by its pivot's reciprocal
// (udiv64.cuh), kept for the back substitution and the prediction.
//
// Exactness.  The plain versions compute in int64 with torch's semantics,
// and each function here reproduces them bit for bit: products, sums and
// left shifts wrap modulo 2^64 (through uint64); |INT64_MIN| is INT64_MIN,
// the least magnitude for the pivot search (torch.argmax's first maximum)
// and a negative one for the divisions (tdiv_by); right shifts are
// arithmetic.  A level's updates are independent, so their order is free.
//
// The host branch: g++ compiles this header for the CPU test
// tests/test_torch_p3_model_pass.py.

#pragma once

#include <cstdint>

#include "udiv64.cuh"

namespace {

constexpr int kSolveFitBase = 128;  // avp.FIT_BASE
constexpr int kSolveFb1 = 12;       // avp.FB1, the prediction's fixed point
constexpr int kSolveFb2 = 2;        // avp.FB2
constexpr int kSolveFb3 = kSolveFb1 - kSolveFb2;
constexpr int kSolveRidge = 8;      // pavp.RIDGE_BIAS
constexpr int kSolveFbw = 12;       // pavp.FBW, the quantized weights' fixed point
constexpr int kSolveWClip = (1 << 19) - 1;  // pavp.WCLIP
constexpr int kSolveMaxN = 12;      // AVP taps a container may name

NBT_HD int64_t sv_add(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) + static_cast<uint64_t>(b));
}
NBT_HD int64_t sv_sub(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) - static_cast<uint64_t>(b));
}
NBT_HD int64_t sv_mul(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) * static_cast<uint64_t>(b));
}
NBT_HD int64_t sv_shl(int64_t a, int s) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) << s);
}

// udiv64 without branches: a thread's divisor is its own, so a warp's
// lanes would take different paths; every path is computed and one kept.
NBT_HD uint64_t sv_udiv(uint64_t n, const UDiv64& r) {
  const uint64_t t = umulhi64(r.magic, n);
  const uint64_t q_add = (((n - t) >> 1) + t) >> r.shift;
  const uint64_t q = r.add ? q_add : t >> r.shift;
  return r.magic == 0 ? n >> r.shift : q;
}

// tdiv_by where both magnitudes are non-negative (the reciprocal's
// quotient); else flags `slow` for the caller to take tdiv_by itself.  The
// one negative magnitude is |INT64_MIN|, so the test compares bits: a
// compiler may take an absolute value for non-negative and drop a sign
// test of it.
NBT_HD int64_t sv_tdiv(int64_t a, const TDiv& d, bool& slow) {
  constexpr uint64_t kMin = 1ull << 63;
  slow = slow || static_cast<uint64_t>(a) == kMin || static_cast<uint64_t>(d.b_abs) == kMin;
  const uint64_t a_mag = a < 0 ? 0ull - static_cast<uint64_t>(a) : static_cast<uint64_t>(a);
  const int64_t q = static_cast<int64_t>(sv_udiv(a_mag, d.r));
  return ((a < 0) != d.b_neg) ? wneg(q) : q;
}

// Where statistics channel ch (of 1 + n + n^2) goes in the system:
// its entry's index r (kN + 1) + c, and what the ridge adds to it; -1 for
// channel 0, the energy, which the system does not hold.
template <int kN>
NBT_HD int solve_entry(int ch, int n, int64_t& add) {
  add = 0;
  if (ch == 0) return -1;
  if (ch <= n) {  // the b-vector: column n
    add = static_cast<int64_t>(kSolveRidge) << kSolveFb3;
    return (ch - 1) * (kN + 1) + n;
  }
  const int r = (ch - 1 - n) / n, c = (ch - 1 - n) % n;
  if (r == c) add = kSolveRidge * n;
  return r * (kN + 1) + c;
}

// No stamps: the probe build passes a clock instead (kernel_probe.py
// p3-model-phases), called at each phase's end.
struct NoStamp {
  NBT_HD void operator()(int) const {}
};

// Phases of a solve, for a stamping clock.
enum SolvePhase { kPivot = 1, kRecip = 2, kEliminate = 3, kBack = 4 };

// A thread's system and its levels' divisors (the magnitude's reciprocal
// at magic[k kStride], its shift | add << 8 at meta[k kStride]; the
// divisor itself is the diagonal, 1 where it is 0).
template <int kN, int kStride>
struct SolveRef {
  int64_t* a;
  uint64_t* magic;
  uint32_t* meta;
  NBT_HD int64_t& at(int r, int c) const { return a[(r * (kN + 1) + c) * kStride]; }
  NBT_HD TDiv divisor(int k) const {
    const int64_t d = at(k, k);
    const int64_t safe = d == 0 ? 1 : d;
    const uint32_t m = meta[k * kStride];
    const UDiv64 r = {magic[k * kStride], static_cast<int>(m & 0xff), (m >> 8) != 0};
    return {wabs(safe), safe < 0, r};
  }
  NBT_HD TDiv set_divisor(int k) const {
    const int64_t d = at(k, k);
    const int64_t safe = d == 0 ? 1 : d;
    const TDiv dv = tdiv_gen(wabs(safe), safe < 0);
    magic[k * kStride] = dv.r.magic;
    meta[k * kStride] = static_cast<uint32_t>(dv.r.shift) | (dv.r.add ? 0x100u : 0u);
    return dv;
  }
};

// avp.solve_batch on one system, in place: afterwards solution k is
// at(k, n) / at(k, k), each level's divisor kept.  Returns false where a
// pivot was 0 (the plain version then goes on with a divisor of 1, and so
// does this).  Columns left of a level are not updated: nothing reads them.
// Each row of a level is read whole into registers, its n - k updates run
// side by side (compile-time columns, those of the level live), then it is
// stored: the updates are independent, and shared memory, not registers,
// bounds how many threads an SM holds.
template <int kN, int kStride, class Stamp = NoStamp>
NBT_HD bool thread_solve(const SolveRef<kN, kStride>& s, int n, Stamp stamp = Stamp()) {
  bool ok = true;
  for (int k = 0; k < n - 1; ++k) {
    // the first maximum of |a[r][k]|, r >= k
    int piv = k;
    int64_t best = wabs(s.at(k, k));
    for (int r = k + 1; r < n; ++r) {
      const int64_t v = wabs(s.at(r, k));
      if (v > best) {
        best = v;
        piv = r;
      }
    }
    if (piv != k) {
      for (int c = k; c <= n; ++c) {
        const int64_t tmp = s.at(k, c);
        s.at(k, c) = s.at(piv, c);
        s.at(piv, c) = tmp;
      }
    }
    stamp(kPivot);
    ok = ok && s.at(k, k) != 0;
    const TDiv dv = s.set_divisor(k);
    stamp(kRecip);
    int64_t prow[kN + 1];  // the pivot row's columns of the level
#pragma unroll
    for (int c = 1; c <= kN; ++c)
      if (c > k && c <= n) prow[c] = s.at(k, c);
    for (int r = k + 1; r < n; ++r) {
      const int64_t mult = s.at(r, k);
      int64_t v[kN + 1];
      bool slow = false;
#pragma unroll
      for (int c = 1; c <= kN; ++c)
        if (c > k && c <= n) v[c] = s.at(r, c);
#pragma unroll
      for (int c = 1; c <= kN; ++c)  // the product passes 2^63 and wraps
        if (c > k && c <= n) v[c] = sv_sub(v[c], sv_tdiv(sv_mul(prow[c], mult), dv, slow));
      if (slow) {  // rare: the row again by tdiv_by
#pragma unroll
        for (int c = 1; c <= kN; ++c)
          if (c > k && c <= n) v[c] = sv_sub(s.at(r, c), tdiv_by(sv_mul(prow[c], mult), dv));
      }
#pragma unroll
      for (int c = 1; c <= kN; ++c)
        if (c > k && c <= n) s.at(r, c) = v[c];
    }
    stamp(kEliminate);
  }
  // the last diagonal: its divisor, tested where it is not the only one
  if (n > 1) ok = ok && s.at(n - 1, n - 1) != 0;
  s.set_divisor(n - 1);
  stamp(kRecip);
  // the back substitution on the augmented column, held in registers
  int64_t x[kN];
#pragma unroll
  for (int r = 0; r < kN; ++r)
    if (r < n) x[r] = s.at(r, n);
  for (int k = n - 1; k > 0; --k) {
    const TDiv dv = s.divisor(k);
    int64_t xk = 0;
#pragma unroll
    for (int r = 0; r < kN; ++r)
      if (r == k) xk = x[r];
    int64_t y[kN];
    bool slow = false;
#pragma unroll
    for (int r = 0; r < kN; ++r)
      if (r < k) y[r] = sv_sub(x[r], sv_tdiv(sv_mul(xk, s.at(r, k)), dv, slow));
    if (slow) {  // rare: the level again by tdiv_by
#pragma unroll
      for (int r = 0; r < kN; ++r)
        if (r < k) y[r] = sv_sub(x[r], tdiv_by(sv_mul(xk, s.at(r, k)), dv));
    }
#pragma unroll
    for (int r = 0; r < kN; ++r)
      if (r < k) x[r] = y[r];
  }
#pragma unroll
  for (int r = 0; r < kN; ++r)
    if (r < n) s.at(r, n) = x[r];
  stamp(kBack);
  return ok;
}

// avp.predict_from_solve of a solved system and its pixel's n features
// (`feat`, tap - FIT_BASE): the FB1 fixed-point prediction, clipped to [0,
// 255 << FB1].
template <int kN, int kStride>
NBT_HD int64_t thread_predict(const SolveRef<kN, kStride>& s, int n, const int32_t* feat) {
  int64_t sum = 0;
#pragma unroll
  for (int t = 0; t < kN; ++t) {
    if (t >= n) continue;
    const TDiv dv = s.divisor(t);
    // the divisor >> 1: an arithmetic shift of a possibly negative divisor
    sum = sv_add(sum, tdiv_by(sv_add(sv_shl(sv_mul(s.at(t, n), feat[t]), kSolveFb2),
                                     tdiv_value(dv) >> 1),
                              dv));
  }
  const int64_t px = sv_add(static_cast<int64_t>(kSolveFitBase) << kSolveFb1, sum);
  return px < 0 ? 0 : (px > (255ll << kSolveFb1) ? (255ll << kSolveFb1) : px);
}

// strips._round_px of a solved prediction.
NBT_HD int solve_round_px(int64_t px_f) {
  return static_cast<int>((px_f + (1 << (kSolveFb1 - 1))) >> kSolveFb1);
}

// pavp.quantize_weights of one weight: num 2^(FB2 - FB1) / diag at step
// 2^-FBW, quotient and remainder apart on magnitudes, truncated toward
// zero and clipped to [-WCLIP, WCLIP].  |INT64_MIN| is INT64_MIN, a
// negative magnitude, which torch's floor divisions round toward minus
// infinity (floor_div); the products and shifts wrap.
NBT_HD int solve_quantize(int64_t diag, int64_t num) {
  constexpr int kEfb = kSolveFbw - kSolveFb1 + kSolveFb2;  // 2
  const int64_t safe = diag == 0 ? 1 : diag;
  int64_t ad = wabs(safe), an = wabs(num);
  if (ad >= (1ll << 48)) {  // INT64_MIN's magnitude is negative: not big
    ad >>= 16;
    an >>= 16;  // arithmetic, as torch's >>
  }
  ad = ad < 1 ? 1 : ad;
  const int64_t q0 = floor_div(an, ad);
  const int64_t r = sv_sub(an, sv_mul(q0, ad));
  const int64_t mag = sv_add(sv_shl(q0 > (1ll << 28) ? (1ll << 28) : q0, kEfb),
                             floor_div(sv_shl(r, kEfb), ad));
  const int64_t sgn = static_cast<int64_t>((num > 0) - (num < 0)) * ((safe > 0) - (safe < 0));
  const int64_t v = sv_mul(sgn, mag);
  return static_cast<int>(v < -kSolveWClip ? -kSolveWClip : (v > kSolveWClip ? kSolveWClip : v));
}

// pavp.predict_wq of a pixel from the quantized weights `wq` and its
// features: |sum| < 2^30 (|weight| <= WCLIP, |feature| <= 128, n <= 12).
template <int kN>
NBT_HD int solve_predict_wq(const int (&wq)[kN], int n, const int32_t* feat) {
  int acc = 0;
#pragma unroll
  for (int t = 0; t < kN; ++t)
    if (t < n) acc += wq[t] * feat[t];
  int px = (kSolveFitBase << kSolveFbw) + acc;
  px = px < 0 ? 0 : (px > (255 << kSolveFbw) ? (255 << kSolveFbw) : px);
  return (px + (1 << (kSolveFbw - 1))) >> kSolveFbw;
}

}  // namespace
