// The per-pixel chain that kernels K2 (group_decode.cu) and K7
// (near_scan.cu) share, and K5 (p3_near_walk.cu, through avp_chain.cuh)
// reuses: the 11-register causal window, the blend and
// least-squares predictions, the 12-bin activity, the context address, the
// near-aware fold (encode) and unfold (decode), and the cp.async helpers.
// Each function is the device counterpart of one function of the plain
// versions (nblic_tpu_torch/ops/window.py, predict.py, context.py), held
// exact against them on the card by chip_smoke.py and
// tests/test_torch_cuda.py.  K7's division-free fold (near_fold, at the
// end) is __host__ __device__: g++ compiles it for the CPU tests
// (tests/test_torch_near_fold.py), the rest is the card's alone.

#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#endif

#ifndef NBT_HD
#if defined(__CUDACC__)
#define NBT_HD __host__ __device__ __forceinline__
#else
#define NBT_HD inline
#endif
#endif

#if defined(__CUDACC__)
namespace {

constexpr int kQd = 12;          // activity bins
constexpr int kCtx = kQd * 256;  // x 256 texture patterns
constexpr int kWeights = 12;     // 11 taps + intercept
constexpr int kWRows = 16;       // weight rows per lane in wcols

__device__ __forceinline__ int iabs(int v) { return v < 0 ? -v : v; }
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The causal window of a pixel: a, b, c, d, e, f, gg, h, q, r, s as in the
// model (a left, b above, c above-left, d above-right, ...).
struct Window {
  int a, b, c, d, e, f, gg, h, q, r, s;
};

// The fresh window at (i, 0): p1 and p2 hold rows i-1 and i-2, lane-strided.
__device__ __forceinline__ Window row_start(const uint8_t* p1, const uint8_t* p2,
                                            int i, int tw, int g, int lane) {
  Window v;
  v.a = i > 0 ? p1[lane] : 128;
  v.b = v.e = v.c = v.a;
  v.d = (i > 0 && tw > 1) ? p1[g + lane] : v.b;
  v.f = i > 1 ? p2[lane] : v.b;
  v.gg = (i > 1 && tw > 1) ? p2[g + lane] : v.f;
  v.h = v.f;
  v.q = v.c;
  v.r = (i > 1 && tw > 2) ? p2[2 * g + lane] : v.gg;
  v.s = v.h;
  return v;
}

// Slide the window one column past x; up1/up2 are the row-above taps of
// column j + 2 of row i-1 and column j + 3 of row i-2.
__device__ __forceinline__ void slide(Window& v, int x, int i, int j, int tw,
                                      int up1, int up2) {
  const int nd = i <= 0 ? x : (j + 2 >= tw ? v.d : up1);
  const int nr = i <= 1 ? nd : (j + 3 >= tw ? v.r : up2);
  v.e = v.a;
  v.a = x;
  v.q = v.c;
  v.c = v.b;
  v.b = v.d;
  v.s = v.h;
  v.h = v.f;
  v.f = v.gg;
  v.gg = v.r;
  v.d = nd;
  v.r = nr;
}

// Blend of clipped-linear and best-of-7 angular predictions (effort 0).
__device__ __forceinline__ int simple_predict(const Window& v) {
  const int a = v.a, b = v.b, c = v.c, d = v.d, e = v.e, f = v.f, g = v.gg,
            h = v.h, q = v.q, r = v.r, s = v.s;
  const int px_lnr = clampi(9 * a + 9 * b + 2 * d - 2 * c - e - f, 0, 16 * 255);
  const int costs[7] = {
      2 * (iabs(a - e) + iabs(c - q) + iabs(b - c) + iabs(d - b)),
      2 * (iabs(a - c) + iabs(c - h) + iabs(b - f) + iabs(d - g)),
      2 * (iabs(a - q) + iabs(c - s) + iabs(b - h) + iabs(d - f)),
      2 * (iabs(a - b) + iabs(c - f) + iabs(b - g) + iabs(d - r)),
      iabs(2 * a - e - q) + iabs(2 * c - q - s) + iabs(2 * b - c - h) +
          iabs(2 * d - b - f),
      iabs(2 * a - q - c) + iabs(2 * c - s - h) + iabs(2 * b - h - f) +
          iabs(2 * d - f - g),
      iabs(2 * a - c - b) + iabs(2 * c - h - f) + iabs(2 * b - f - g) +
          iabs(2 * d - g - r),
  };
  const int preds[7] = {2 * a, 2 * b, 2 * c, 2 * d, a + c, c + b, b + d};
  // the first minimum, by a tournament three rounds deep: the left side
  // holds the lower indices and keeps ties
  auto pick = [](int& c_l, int& p_l, int c_r, int p_r) {
    if (c_r < c_l) {
      c_l = c_r;
      p_l = p_r;
    }
  };
  int c01 = costs[0], p01 = preds[0], c23 = costs[2], p23 = preds[2];
  int c45 = costs[4], p45 = preds[4];
  pick(c01, p01, costs[1], preds[1]);
  pick(c23, p23, costs[3], preds[3]);
  pick(c45, p45, costs[5], preds[5]);
  pick(c01, p01, c23, p23);
  pick(c45, p45, costs[6], preds[6]);
  pick(c01, p01, c45, p45);
  const int cmin = c01, px_ang = p01;
  int csum = (costs[0] + costs[1]) + (costs[2] + costs[3]) +
             (costs[4] + costs[5]) + costs[6];
  csum = min((csum - 7 * cmin) >> 3, 607);
  const int wt = (csum >= 5) + (csum >= 12) + (csum >= 34) + (csum >= 78) +
                 (csum >= 194) + (csum >= 431) + (csum >= 601);
  return (8 * wt * px_ang + (8 - wt) * px_lnr + 64) >> 7;
}

// Profile-2 least-squares prediction: |acc| <= 11 * 32767 * 128 + 32767
// stays below 2^31, and >> is arithmetic, as in nblic_tpu/ops/lsq.py.
__device__ __forceinline__ int lsq_predict(const int (&w)[kWeights],
                                           const Window& v) {
  const int acc = w[11] + w[0] * (v.a - 128) + w[1] * (v.b - 128) +
                  w[2] * (v.c - 128) + w[3] * (v.d - 128) + w[4] * (v.e - 128) +
                  w[5] * (v.f - 128) + w[6] * (v.gg - 128) + w[7] * (v.h - 128) +
                  w[8] * (v.q - 128) + w[9] * (v.r - 128) + w[10] * (v.s - 128);
  return clampi(128 + ((acc + 2048) >> 12), 0, 255);
}

template <int kProfile>
__device__ __forceinline__ int predict(const Window& v, const int (&w)[kWeights],
                                       int flag) {
  int px0 = simple_predict(v);
  if constexpr (kProfile == 2) {
    const int px_l = lsq_predict(w, v);
    px0 = flag == 1 ? px_l : (flag == 2 ? (px0 + px_l + 1) >> 1 : px0);
  }
  return px0;
}

// The raw texture activity of the window and the carried error.
__device__ __forceinline__ int activity(const Window& v, int err) {
  return iabs(v.a - v.e) + iabs(v.b - v.c) + iabs(v.b - v.d) + iabs(v.a - v.c) +
         iabs(v.b - v.f) + iabs(v.d - v.gg) + 2 * iabs(err);
}

// The 12-bin quantizer of an activity.
__device__ __forceinline__ int quantize_activity(int delta) {
  const int t = min(delta, 151);
  return (t >= 1) + (t >= 2) + (t >= 4) + (t >= 6) + (t >= 9) + (t >= 15) +
         (t >= 25) + (t >= 39) + (t >= 63) + (t >= 101) + (t >= 151);
}

// The 12-bin activity of the window and the carried error.
__device__ __forceinline__ int activity_bin(const Window& v, int err) {
  return quantize_activity(activity(v, err));
}

// The context address: activity bin and the 8-bit texture pattern.
__device__ __forceinline__ int context_adr(const Window& v, int px0, int qd) {
  return (qd << 8) | ((px0 > v.a) << 7) | ((px0 > v.b) << 6) |
         ((px0 > v.c) << 5) | ((px0 > v.d) << 4) | ((px0 > v.e) << 3) |
         ((px0 > v.f) << 2) | ((px0 > 2 * v.a - v.e) << 1) | (px0 > 2 * v.b - v.f);
}

// Near-aware unfold (mapYtoX) of symbol y around the biased prediction px.
template <bool kLossless>
__device__ __forceinline__ int unfold(int y, int px, int sign, int near) {
  const int qstep = 2 * near + 1;
  const int ty = kLossless ? min(px, 255 - px) : (min(px, 255 - px) + near) / qstep;
  int mag, sy;
  if (y <= 0) {
    mag = 0;
    sy = 0;
  } else if (y <= 2 * ty) {
    mag = (y + 1) >> 1;
    sy = (y & 1) ^ sign;
  } else {
    mag = y - ty;
    sy = px < 128;
  }
  if (!kLossless) mag *= qstep;
  return clampi(px + (sy ? mag : -mag), 0, 255);
}

// Near-aware fold (mapXtoY) of pixel x around the biased prediction px in
// [0, 255], near >= 1: ops/context.py::residual_fold.  Both divisions take
// non-negative operands, |x - px| + near and min(px, 255 - px) + near, so
// C's truncating / is the floor division of the plain version.
__device__ __forceinline__ int fold(int x, int px, int sign, int near) {
  const int qstep = 2 * near + 1;
  const int ty = (min(px, 255 - px) + near) / qstep;
  const int y = (iabs(x - px) + near) / qstep;
  const int sy = x >= px;
  return y <= 0 ? 0 : (y <= ty ? 2 * y - (sy ^ sign) : y + ty);
}

}  // namespace
#endif  // __CUDACC__

namespace {

// K7's fold and unfold in one, without a division.  The near quantizer's
// step qstep = 2 near + 1 (3..511) divides only n in [0, 510] (|x - px| +
// near and min(px, 255 - px) + near, x and px pixels): near_recip's m =
// ceil(2^32 / qstep) once a launch, then n / qstep = (n m) >> 32, exact
// since n (m qstep - 2^32) <= 510 x 510 < 2^32 (the CPU tests check every
// near and n).
NBT_HD uint32_t near_recip(int near) {
  const uint64_t q = 2 * static_cast<uint64_t>(near) + 1;
  return static_cast<uint32_t>(((uint64_t{1} << 32) + q - 1) / q);
}

NBT_HD int near_quot(int n, uint32_t m) {
#if defined(__CUDA_ARCH__)
  return static_cast<int>(__umulhi(static_cast<uint32_t>(n), m));
#else
  return static_cast<int>((static_cast<uint64_t>(static_cast<uint32_t>(n)) * m) >> 32);
#endif
}

// The symbol y and the reconstruction x_rec of pixel x around the biased
// prediction px in [0, 255], near >= 1, m = near_recip(near): what fold
// and then unfold<false> give (ops/context.py::residual_fold,
// residual_unfold), with ty and the quotient q computed once.  A folded
// q <= ty keeps x's side of px; past ty, y = q + ty unfolds to the side
// with room, px < 128.
struct NearFold {
  int y, x_rec;
};

NBT_HD NearFold near_fold(int x, int px, int sign, int near, uint32_t m) {
  const int qstep = 2 * near + 1;
  const int d = x - px;
  const int ty = near_quot((px < 255 - px ? px : 255 - px) + near, m);
  const int q = near_quot((d < 0 ? -d : d) + near, m);
  const int sy = x >= px;
  if (q <= 0) return {0, px};
  const bool up = q <= ty ? sy != 0 : px < 128;
  const int rec = px + (up ? q * qstep : -q * qstep);
  return {q <= ty ? 2 * q - (sy ^ sign) : q + ty, rec < 0 ? 0 : (rec > 255 ? 255 : rec)};
}

}  // namespace
