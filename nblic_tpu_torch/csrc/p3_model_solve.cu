// The profile-3 modeling pass's ridge solve and prediction: kernel K11.
//
// K11 replaces no pallas_call: the JAX package runs this solve,
// nblic_tpu/ops/pavp.py::predict_chunked (solve_batch, predict_from_stats
// or predict_from_stats_wq, a lax.map over chunks of pixels), as an XLA
// program.  Its plain version is
// nblic_tpu_torch/ops/model_pass.py::solve_plain, built on ops/pavp.py's
// predict_chunked: the int64 elimination of every pixel's system as whole
// (n, n + 1, P) tensors, chunks of 2^18 pixels, each level ~10 torch
// operations; then the rounding and the fallback to the simple prediction
// where a pivot was 0.
//
// One warp a system, on avp_chain.cuh's warp chain, which kernels K5 and
// K4 run a pixel at a time: warp_system forms the ridge system from a
// pixel's m statistics (channel c on thread c % 32, so the warp's loads of
// a row of the (rows, m) statistics are one coalesced sweep), warp_solve
// eliminates it level by level (each level's quotients by one reciprocal,
// udiv64.cuh), warp_predict sums the n terms by shuffles.  Under w_pred a
// row holds a segment's statistics (K10 writes one a segment), so the
// warp solves once, quantizes the n weights (quantize_weight) and predicts
// each of the segment's pixels with warp_predict_wq: the same result as
// the plain version's solve of every pixel, whose systems are equal.
//
// What bounds K11 on Hopper: the operations, ~13,000 a system (the tally
// in chip_smoke.py), against 888 B of statistics read; and, one warp a
// system, the threads a level leaves idle.
// The systems are independent, so the card is filled by warps: one wave
// of CTAs of kWarps warps, each warp walking rows grid-stride.

#include <cstdint>
#include <cuda_runtime.h>

#include "avp_chain.cuh"

namespace {

constexpr int kWarps = 4;  // warps (systems in flight) a CTA

// stats: (rows, m) int64; fe: (P, n + 1) int32 (x - FIT_BASE, then the
// features); px_s: (P,) the simple prediction; px, ok: (P,) the hard
// prediction (px_s where the solve failed) and the solve's success.  Row r
// predicts pixels r seg .. r seg + seg - 1 (seg > 1 only with kWq).
template <int kN, bool kWq>
__global__ void __launch_bounds__(kWarps * kWarp)
    p3_model_solve_kernel(const int64_t* __restrict__ stats, const int32_t* __restrict__ fe,
                          const int32_t* __restrict__ px_s, int32_t* __restrict__ px,
                          uint8_t* __restrict__ ok_out, long long rows, int seg, int n) {
  constexpr int kS = avp_slots<kN>();
  __shared__ AvpShared<kN> shm[kWarps];
  const int t = threadIdx.x % kWarp, wid = threadIdx.x / kWarp;
  AvpShared<kN>& sh = shm[wid];
  const int m = avp_m(n), n1 = n + 1;
  const Slots<kN> sl = slots_of<kN>(t, n);
  int64_t none[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) none[s] = 0;
  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  for (long long r = static_cast<long long>(blockIdx.x) * kWarps + wid; r < rows; r += step) {
    int64_t st[kS];
    load_col(stats + r * m, m, t, st);
    warp_system<kN>(st, none, sl, sh, n);
    __syncwarp();
    int64_t num;
    const bool ok = warp_solve<kN>(sh, t, num, n);
    const long long p0 = r * seg;
    if constexpr (kWq) {
      const int wq = t < n ? quantize_weight(sh.a[t][t], num) : 0;
      for (int q = 0; q < seg; ++q) {
        const long long p = p0 + q;
        const int v = warp_predict_wq(wq, t < n ? fe[p * n1 + 1 + t] : 0);
        if (t == 0) {
          px[p] = ok ? v : px_s[p];
          ok_out[p] = ok;
        }
      }
    } else {
      const int feat = t < n ? fe[p0 * n1 + 1 + t] : 0;
      const int64_t px_f = warp_predict<kN>(sh, num, feat, t, n);
      if (t == 0) {
        px[p0] = ok ? round_px(px_f) : px_s[p0];
        ok_out[p0] = ok;
      }
    }
    __syncwarp();  // this row's reads of sh before the next row's system
  }
}

// One wave of CTAs, as many as the card holds at once (the registers
// bound them), each warp walking rows grid-stride.
template <int kN, bool kWq>
int launch(const int64_t* stats, const int32_t* fe, const int32_t* px_s, int32_t* px,
           uint8_t* ok, long long rows, int seg, int n, int device, cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, p3_model_solve_kernel<kN, kWq>, kWarps * kWarp, 0);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long ctas = (rows + kWarps - 1) / kWarps;
  const long long wave = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const unsigned grid = static_cast<unsigned>(ctas < wave ? ctas : wave);
  p3_model_solve_kernel<kN, kWq><<<grid, kWarps * kWarp, 0, stream>>>(stats, fe, px_s, px, ok,
                                                                     rows, seg, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K11: the ridge solve of each of `rows` statistics rows (rows, 1 + n +
// n^2) int64 and the prediction of its pixels: row r holds pixel r, or
// under w_quant with seg > 1 the segment of pixels r seg .. r seg + seg -
// 1.  fe: (rows seg, n + 1) int32; px_s: (rows seg,) int32; px (int32), ok
// (uint8): (rows seg,).  n in 1..12 (instances at 10 and, for any other
// count, 12).  Each on `device`, contiguous.  Launches on `stream`;
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments out of range).
extern "C" int nbt_p3_model_solve(const int64_t* stats, const int32_t* fe, const int32_t* px_s,
                                  int32_t* px, uint8_t* ok, long long rows, int seg, int n,
                                  int w_quant, int device, void* stream) {
  if (n < 1 || n > kNTaps || rows < 0 || seg < 1 || (seg > 1 && !w_quant))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (n == 10)
    return w_quant ? launch<10, true>(stats, fe, px_s, px, ok, rows, seg, n, device, s)
                   : launch<10, false>(stats, fe, px_s, px, ok, rows, seg, n, device, s);
  return w_quant ? launch<kNTaps, true>(stats, fe, px_s, px, ok, rows, seg, n, device, s)
                 : launch<kNTaps, false>(stats, fe, px_s, px, ok, rows, seg, n, device, s);
}
