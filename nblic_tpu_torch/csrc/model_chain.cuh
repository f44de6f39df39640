// The profile-3 modeling chains' arithmetic, one value at a time: the
// device counterpart of nblic_tpu_torch/ops/pavp.py's decay, _moments,
// _clip_s_sum and the energy channel's sample weight (predict_plane), which
// kernel K10 (p3_model_chains.cu) runs on every pixel of every channel.
//
// Exactness.  The plain versions compute in int64 with torch's semantics,
// and each function here reproduces them bit for bit on every input:
// products, sums and left shifts wrap modulo 2^64 (through uint64: signed
// overflow is undefined in C++), a decay truncates toward zero
// (torch.div "trunc" is C's /), and avp.tdiv divides magnitudes with
// |INT64_MIN| wrapping to itself (udiv64.cuh's wabs and floor_div).
//
// The moments' division.  Every moment of a pixel divides by the same
// clipped sample weight s in [2^12, 2^16], which K10's energy pass writes
// once a pixel with its reciprocal M = floor((2^64 - 1) / s) + 1.  For a
// numerator's magnitude a < 2^47, floor(a / s) is the high word of a M:
// with a = q s + r, a M / 2^64 = a / s + a e / 2^64 for some 0 <= e < 1,
// and a / 2^64 < 1 / s, so the error never reaches the next integer.
// Pixels give |left right| <= 2^14 and shifts <= 28, so a < 2^43 there;
// any other numerator takes udiv64.cuh's floor_div, exact as well.
//
// The host branch: g++ compiles this header for the CPU test
// tests/test_torch_p3_model_pass.py (udiv64.cuh's multiply-high is
// unsigned __int128 there).

#pragma once

#include <cstdint>

#include "udiv64.cuh"

namespace {

constexpr int kMcFb1 = 12;        // avp.FB1
constexpr int kMcFb2 = 2;         // avp.FB2
constexpr int kMcAlpha = 5;       // decay denominator of the regression moments
constexpr int kMcBeta = 3;        // decay denominator of the error energies
constexpr int kMcShiftB = 4 + kMcFb1 + kMcFb1;  // the b-vector moments' shift
constexpr int kMcShiftA = 4 + kMcFb2 + kMcFb1;  // the matrix moments' shift
constexpr int64_t kMcFastMag = 1ll << 47;       // moment(): the reciprocal's domain

NBT_HD int64_t mc_add(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) + static_cast<uint64_t>(b));
}
NBT_HD int64_t mc_mul(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) * static_cast<uint64_t>(b));
}
NBT_HD int64_t mc_shl(int64_t a, int s) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) << s);
}

// pavp.decay: (v (ab - 1) + ab / 2) / ab truncated toward zero, the
// product wrapping.  ab is a constant, so the division is a multiply-high.
template <int kAb>
NBT_HD int64_t mc_decay(int64_t v) {
  return mc_add(mc_mul(v, kAb - 1), kAb >> 1) / kAb;
}

// pavp._clip_s_sum: s_sum + 2^FB1 clipped to [2^FB1, 16 2^FB1].
NBT_HD int64_t clip_s_sum(int64_t s_sum) {
  const int64_t v = mc_add(s_sum, 1ll << kMcFb1);
  return v < (1ll << kMcFb1) ? (1ll << kMcFb1) : (v > (16ll << kMcFb1) ? (16ll << kMcFb1) : v);
}

// The energy channel's contribution (and the mix chains'): |x - p| << FB1
// of a pixel and a prediction.
NBT_HD int64_t err_energy(int x, int p) {
  const int64_t d = static_cast<int64_t>(x) - p;
  return mc_shl(d < 0 ? -d : d, kMcFb1);
}

// The sample weight of pavp.predict_plane: _clip_s_sum(stats0 +
// tdiv(s_curr BETA, BETA - 1)), stats0 channel 0 of the pixel's E + F,
// s_curr its energy contribution.
NBT_HD int64_t sample_weight(int64_t stats0, int64_t s_curr) {
  const int64_t num = mc_mul(s_curr, kMcBeta);
  const int64_t q = floor_div(wabs(num), kMcBeta - 1);
  return clip_s_sum(mc_add(stats0, num < 0 ? wneg(q) : q));
}

// The reciprocal moment() divides by: floor((2^64 - 1) / s) + 1, s >= 2.
NBT_HD uint64_t moment_recip(int64_t s) {
  return ~0ull / static_cast<uint64_t>(s) + 1;
}

// pavp._moments of one channel: tdiv(((left right) << shift) + s / 2, s)
// for s = the clipped sample weight in [2^12, 2^16] and its reciprocal
// from moment_recip.
NBT_HD int64_t moment(int64_t left, int64_t right, int shift, int64_t s, uint64_t recip) {
  const int64_t num = mc_add(mc_shl(mc_mul(left, right), shift), s >> 1);
  const int64_t mag = wabs(num);
  const int64_t q = (mag >= 0 && mag < kMcFastMag)
                        ? static_cast<int64_t>(umulhi64(static_cast<uint64_t>(mag), recip))
                        : floor_div(mag, s);
  return num < 0 ? wneg(q) : q;
}

// Moment channel q of the n + n^2 (statistics channel 1 + q): the
// indexes of its two factors among [x - FIT_BASE, the n features] and its
// shift; q < n is the b-vector's (x times feature q), else the matrix's
// row (q - n) / n, column (q - n) % n.
struct MomentOf {
  int left, right, shift;
};

NBT_HD MomentOf moment_of(int q, int n) {
  if (q < n) return {0, 1 + q, kMcShiftB};
  const int r = q - n;
  return {1 + r / n, 1 + r % n, kMcShiftA};
}

}  // namespace
