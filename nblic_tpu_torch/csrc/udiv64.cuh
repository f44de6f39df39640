// Division of 64-bit integers by a divisor that many quotients share.
//
// The profile-3 AVP chain (avp_chain.cuh) divides by runtime divisors
// ~500 times a pixel: every quotient of one elimination level by that
// level's pivot, every term of the back substitution and the prediction
// by a diagonal entry, every moment by the sample weight s.  nvcc's 64-bit
// division is an out-of-line routine of 70-84 instructions, each on the
// chain's dependency path.  Here the divisor's reciprocal is computed once
// (an exact magic number and shift, as libdivide's unsigned 64-bit
// divider, from "Division by Invariant Integers using Multiplication",
// Granlund and Montgomery, 1994), and each quotient is one multiply-high
// and a correction.
//
// The reciprocal floor(2^(64 + l) / d) is a 128-by-64-bit quotient.  It is
// estimated from d's double-precision reciprocal and corrected twice: once
// by the remainder's own quotient (by the same reciprocal, off by one at
// most), then exactly by the 128-bit remainder.  So no 128-bit division
// runs, and the code is the same on the host and the card but for the
// multiply-high and the reciprocal (the same IEEE value on both): the
// host's branch (unsigned __int128) lets g++ compile this header for the
// CPU test tests/test_torch_udiv64.py.
//
// The signed wrappers reproduce the port's plain divisions bit for bit:
// tdiv_by is ops/avp.py::tdiv_by (torch's floor division of magnitudes,
// where |INT64_MIN| wraps to itself), tdiv_trunc C's truncating / of a
// signed numerator by a positive divisor.

#pragma once

#include <cmath>
#include <cstdint>

#if defined(__CUDACC__)
#define NBT_HD __host__ __device__ __forceinline__
#else
#define NBT_HD inline
#endif

namespace {

// ---- int64 arithmetic as torch computes it: wrapping, through uint64

NBT_HD int64_t wneg(int64_t a) {
  return static_cast<int64_t>(0ull - static_cast<uint64_t>(a));
}
// torch.abs: INT64_MIN stays INT64_MIN
NBT_HD int64_t wabs(int64_t a) { return a < 0 ? wneg(a) : a; }

// torch's floor division of int64 (c10::div_floor_integer) for b != 0; the
// callers never divide INT64_MIN by -1
NBT_HD int64_t floor_div(int64_t a, int64_t b) {
  const int64_t q = a / b;
  return ((a < 0) != (b < 0) && a % b != 0) ? q - 1 : q;
}

NBT_HD uint64_t umulhi64(uint64_t a, uint64_t b) {
#if defined(__CUDA_ARCH__)
  return __umul64hi(a, b);
#else
  return static_cast<uint64_t>((static_cast<unsigned __int128>(a) * b) >> 64);
#endif
}

// 1 / d rounded to nearest once: IEEE division's result, which the card's
// reciprocal gives without the division's residual steps
NBT_HD double recip_rn(double d) {
#if defined(__CUDA_ARCH__)
  return __drcp_rn(d);
#else
  return 1.0 / d;
#endif
}

NBT_HD int clz64(uint64_t x) {  // x != 0
#if defined(__CUDA_ARCH__)
  return __clzll(static_cast<long long>(x));
#else
  return __builtin_clzll(x);
#endif
}

// The reciprocal of an unsigned divisor d >= 1: q = n >> shift where d is
// a power of two (magic 0), else t = mulhi(magic, n) and q = t >> shift,
// or (((n - t) >> 1) + t) >> shift with `add` (the 65-bit magic).
struct UDiv64 {
  uint64_t magic;
  int shift;
  bool add;
};

// floor(2^127 / dn) and 2^127 mod dn for dn in (2^63, 2^64).
NBT_HD uint64_t recip127(uint64_t dn, uint64_t& rem) {
  const double dd = static_cast<double>(dn);
  const double rc = recip_rn(dd);
  // within 2^13 of the quotient: dd, its reciprocal and the product each
  // round once
  const double x = 0x1p127 * rc;
  uint64_t v = x >= 0x1p64 ? ~0ull : static_cast<uint64_t>(x);
  // r = 2^127 - v dn as a signed 128-bit (rh, rl); |r| < 2^77
  uint64_t pl = v * dn;
  uint64_t rh = (1ull << 63) - umulhi64(v, dn) - (pl != 0);
  uint64_t rl = 0ull - pl;
  // v moves by r's quotient, which a double gets within one
  const double rd = static_cast<double>(static_cast<int64_t>(rh)) * 0x1p64 +
                    static_cast<double>(rl);
  v += static_cast<uint64_t>(static_cast<int64_t>(floor(rd * rc)));
  pl = v * dn;
  rh = (1ull << 63) - umulhi64(v, dn) - (pl != 0);
  rl = 0ull - pl;
  // then exactly: r into [0, dn)
  while (static_cast<int64_t>(rh) < 0) {  // r < 0: v was too large
    --v;
    rl += dn;
    rh += rl < dn;
  }
  while (rh != 0 || rl >= dn) {  // r >= dn: v was too small
    ++v;
    rh -= rl < dn;
    rl -= dn;
  }
  rem = rl;
  return v;
}

NBT_HD UDiv64 udiv64_gen(uint64_t d) {  // d >= 1
  const int l = 63 - clz64(d);            // 2^l <= d < 2^(l + 1)
  if ((d & (d - 1)) == 0) return {0, l, false};
  const int s = 63 - l;
  uint64_t rem;
  uint64_t m = recip127(d << s, rem);  // floor(2^(64 + l) / d)
  rem >>= s;
  if (d - rem < (1ull << l)) return {m + 1, l, false};
  // 2^(65 + l) / d: both the quotient and the remainder doubled
  const uint64_t twice = rem + rem;
  m = m + m + ((twice >= d || twice < rem) ? 1 : 0);
  return {m + 1, l, true};
}

NBT_HD uint64_t udiv64(uint64_t n, const UDiv64& r) {
  if (r.magic == 0) return n >> r.shift;
  const uint64_t t = umulhi64(r.magic, n);
  return r.add ? (((n - t) >> 1) + t) >> r.shift : t >> r.shift;
}

// A divisor as avp.tdiv_by takes it: its magnitude (|INT64_MIN| is
// INT64_MIN, a negative magnitude) and its sign, and the magnitude's
// reciprocal where the magnitude is positive.
struct TDiv {
  int64_t b_abs;
  bool b_neg;
  UDiv64 r;
};

NBT_HD TDiv tdiv_gen(int64_t b_abs, bool b_neg) {  // b_abs != 0
  const UDiv64 none = {0, 0, false};
  return {b_abs, b_neg, b_abs > 0 ? udiv64_gen(static_cast<uint64_t>(b_abs)) : none};
}

// The divisor itself: (b_neg ? -|b| : |b|), INT64_MIN for INT64_MIN.
NBT_HD int64_t tdiv_value(const TDiv& d) { return d.b_neg ? wneg(d.b_abs) : d.b_abs; }

// avp.tdiv_by: floor(|a| / b_abs), negated where a's and the divisor's
// signs differ.  Where both magnitudes are non-negative the floor is the
// reciprocal's quotient.  Trap: |INT64_MIN| wraps to itself, a negative
// magnitude, and floor division of it (or by it) rounds otherwise than an
// unsigned quotient; the plain version does so, and so does this.
NBT_HD int64_t tdiv_by(int64_t a, const TDiv& d) {
  const int64_t a_abs = wabs(a);
  const int64_t q = (a_abs >= 0 && d.b_abs > 0)
                        ? static_cast<int64_t>(udiv64(static_cast<uint64_t>(a_abs), d.r))
                        : floor_div(a_abs, d.b_abs);
  return ((a < 0) != d.b_neg) ? wneg(q) : q;
}

// C's / of a signed numerator by a positive divisor (its reciprocal `r`):
// the quotient truncated toward zero, INT64_MIN's magnitude taken as
// 2^63.
NBT_HD int64_t tdiv_trunc(int64_t a, const UDiv64& r) {
  const uint64_t mag = a < 0 ? 0ull - static_cast<uint64_t>(a) : static_cast<uint64_t>(a);
  const uint64_t q = udiv64(mag, r);
  return static_cast<int64_t>(a < 0 ? 0ull - q : q);
}

}  // namespace
