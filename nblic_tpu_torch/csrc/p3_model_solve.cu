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
// What bounds K11 on Hopper: the operations, ~13,000 a system (the tally
// in chip_smoke.py), against 888 B of statistics read.  The systems are
// independent, so K11 solves one a thread (model_solve.cuh): every lane
// busy at every level, no shuffle, no idle threads in the later levels.
// A CTA is one warp; it stages its batch of 32 consecutive statistics
// rows (contiguous in device memory) by cp.async, coalesced, all copies in
// flight at once, into its 32 systems in shared memory, the system index
// fastest; each thread then adds the ridge to its own, eliminates,
// back-substitutes and predicts.  Under w_pred a row holds a segment's
// statistics (K10 writes one a segment), so the thread solves once,
// quantizes the n weights and predicts each of the segment's pixels by an
// int32 dot: the same result as the plain version's solve of every pixel,
// whose systems are equal.  One wave of CTAs, as many as the card holds
// at once (shared memory bounds them: ~29 KB of systems a batch at n =
// 10), each walking batches grid-stride.

#include <cstdint>
#include <cuda_runtime.h>

#include "model_solve.cuh"

namespace {

constexpr int kSys = 32;        // systems a warp, one a thread; a CTA is a warp
constexpr int kSysStride = 33;  // words between a system's entries in shared memory
// Batches of systems in shared memory: 1, each batch staged after the
// last is solved; 2, the next batch's copies in flight while this one is
// solved, 45.1 ms at the th-64 corpus against 1's 26.2 (62 KB a CTA: 3
// warps an SM, not 6; kernel_probe.py p3-model-phases times both).
constexpr int kStages = 1;

// Shared memory of a CTA's systems at instance kN: its kStages batches.
template <int kN>
constexpr size_t systems_bytes() {
  return static_cast<size_t>(kStages) * kN * (kN + 1) * kSysStride * sizeof(int64_t);
}

// The probe build (kernel_probe.py p3-model-phases, -DNBT_PROBE_STAMPS)
// sums each thread's clock64() cycles by phase, for the systems it solved.
#ifdef NBT_PROBE_STAMPS
__device__ unsigned long long nbt_probe_phase[8];
struct ClockStamp {
  unsigned long long* acc;
  long long* last;
  __device__ void operator()(int phase) const {
    const long long now = clock64();
    acc[phase] += now - *last;
    *last = now;
  }
};
#endif

enum { kLoad = 0, kPredict = 5, kSystems = 7 };

// stats: (rows, m) int64; fe: (P, n + 1) int32 (x - FIT_BASE, then the
// features); px_s: (P,) the simple prediction; px, ok: (P,) the hard
// prediction (px_s where the solve failed) and the solve's success.  Row r
// predicts pixels r seg .. r seg + seg - 1 (seg > 1 only with kWq).
template <int kN, bool kWq>
__global__ void __launch_bounds__(kSys)
    p3_model_solve_kernel(const int64_t* __restrict__ stats, const int32_t* __restrict__ fe,
                          const int32_t* __restrict__ px_s, int32_t* __restrict__ px,
                          uint8_t* __restrict__ ok_out, long long rows, int seg, int n_arg) {
  constexpr int kM = 1 + kN + kN * kN;
  constexpr int kWords = kN * (kN + 1) * kSysStride;  // a batch's systems
  extern __shared__ int64_t sys[];                    // (kStages, kWords)
  __shared__ uint64_t magic[kN * kSysStride];
  __shared__ uint32_t meta[kN * kSysStride];
  __shared__ int16_t entry_of[kM];
  const int n = kN == 10 ? 10 : n_arg;  // the count an instance at 10 folds
  const int m = 1 + n + n * n, n1 = n + 1;
  const int lane = threadIdx.x;
#ifdef NBT_PROBE_STAMPS
  unsigned long long acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  long long last = clock64();
  const ClockStamp stamp{acc, &last};
#else
  const NoStamp stamp{};
#endif
  for (int ch = lane; ch < m; ch += kSys) {
    int64_t add;  // the ridge: each thread adds it after the copies
    entry_of[ch] = static_cast<int16_t>(solve_entry<kN>(ch, n, add));
  }
  __syncwarp();
  // The statistics of the batch at `base`, contiguous, into `buf`'s
  // systems by cp.async, all copies in flight at once (element e of the
  // batch: row e / m, channel e % m, stepped along); one commit group a
  // batch, empty past the last row.
  auto stage = [&](long long base, int64_t* buf) {
    if (base < rows) {
      const int cnt = static_cast<int>(rows - base < kSys ? rows - base : kSys);
      const int64_t* src = stats + base * m;
      int row = lane / m, ch = lane % m;
      for (int e = lane; e < cnt * m; e += kSys) {
        const int at = entry_of[ch];
        if (at >= 0) {
          const unsigned dst =
              static_cast<unsigned>(__cvta_generic_to_shared(buf + at * kSysStride + row));
          asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(src + e)
                       : "memory");
        }
        ch += kSys;
        while (ch >= m) {
          ch -= m;
          ++row;
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  const long long step = static_cast<long long>(gridDim.x) * kSys;
  long long base = static_cast<long long>(blockIdx.x) * kSys;
  stage(base, sys);
  for (int b = 0; base < rows; base += step, ++b) {
    int64_t* cur = sys + (b % kStages) * kWords;
    if (kStages > 1) stage(base + step, sys + ((b + 1) % kStages) * kWords);
    // this batch's group landed (the next one's, where staged, may not have)
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
    __syncwarp();
    const int cnt = static_cast<int>(rows - base < kSys ? rows - base : kSys);
    const SolveRef<kN, kSysStride> s{cur + lane, magic + lane, meta + lane};
    if (lane < cnt) {
      for (int t = 0; t < n; ++t) {
        s.at(t, t) = sv_add(s.at(t, t), kSolveRidge * n);
        s.at(t, n) = sv_add(s.at(t, n), static_cast<int64_t>(kSolveRidge) << kSolveFb3);
      }
    }
    stamp(kLoad);
    if (lane < cnt) {
      const bool ok = thread_solve<kN, kSysStride>(s, n, stamp);
      const long long p0 = (base + lane) * seg;
      if constexpr (kWq) {
        int wq[kN];
#pragma unroll
        for (int t = 0; t < kN; ++t) wq[t] = t < n ? solve_quantize(s.at(t, t), s.at(t, n)) : 0;
        for (int q = 0; q < seg; ++q) {
          const long long p = p0 + q;
          const int v = solve_predict_wq<kN>(wq, n, fe + p * n1 + 1);
          px[p] = ok ? v : px_s[p];
          ok_out[p] = ok;
        }
      } else {
        const int64_t px_f = thread_predict<kN, kSysStride>(s, n, fe + p0 * n1 + 1);
        px[p0] = ok ? solve_round_px(px_f) : px_s[p0];
        ok_out[p0] = ok;
      }
      stamp(kPredict);
#ifdef NBT_PROBE_STAMPS
      acc[kSystems] += 1;
#endif
    }
    __syncwarp();  // this batch's reads of its systems before their buffer is staged again
    if (kStages == 1) stage(base + step, sys);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // the last, empty group
#ifdef NBT_PROBE_STAMPS
  for (int ph = 0; ph < 8; ++ph) atomicAdd(&nbt_probe_phase[ph], acc[ph]);
#endif
}

// CTAs of the instance an SM holds at once (its systems' shared memory
// allowed first).
template <int kN, bool kWq>
cudaError_t solve_per_sm(int& per_sm) {
  const cudaError_t err = cudaFuncSetAttribute(p3_model_solve_kernel<kN, kWq>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(systems_bytes<kN>()));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, p3_model_solve_kernel<kN, kWq>,
                                                       kSys, systems_bytes<kN>());
}

// One wave of CTAs, as many as the card holds at once (shared memory
// bounds them), each walking batches grid-stride.
template <int kN, bool kWq>
int launch(const int64_t* stats, const int32_t* fe, const int32_t* px_s, int32_t* px,
           uint8_t* ok, long long rows, int seg, int n, int device, cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  cudaError_t err = solve_per_sm<kN, kWq>(per_sm);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long ctas = (rows + kSys - 1) / kSys;
  const long long wave = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const unsigned grid = static_cast<unsigned>(ctas < wave ? ctas : wave);
  p3_model_solve_kernel<kN, kWq><<<grid, kSys, systems_bytes<kN>(), stream>>>(
      stats, fe, px_s, px, ok, rows, seg, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#ifdef NBT_PROBE_STAMPS
// The probe's phase sums (load, pivot, reciprocal, elimination, back
// substitution, prediction; then the systems) since the last reset.
extern "C" int nbt_probe_phases(unsigned long long* dst, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(dst, nbt_probe_phase, sizeof(nbt_probe_phase));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    err = cudaMemcpyToSymbol(nbt_probe_phase, zero, sizeof(zero));
  }
  return static_cast<int>(err);
}
#endif

// CTAs (a warp each) an SM holds at once of the instance for n and
// w_quant, by occupancy (shared memory bounds them).
extern "C" int nbt_p3_model_solve_per_sm(int n, int w_quant) {
  int per_sm = 0;
  cudaError_t err;
  if (n == 10)
    err = w_quant ? solve_per_sm<10, true>(per_sm) : solve_per_sm<10, false>(per_sm);
  else
    err = w_quant ? solve_per_sm<kSolveMaxN, true>(per_sm)
                  : solve_per_sm<kSolveMaxN, false>(per_sm);
  return err == cudaSuccess ? per_sm : -static_cast<int>(err);
}

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
  if (n < 1 || n > kSolveMaxN || rows < 0 || seg < 1 || (seg > 1 && !w_quant))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (n == 10)
    return w_quant ? launch<10, true>(stats, fe, px_s, px, ok, rows, seg, n, device, s)
                   : launch<10, false>(stats, fe, px_s, px, ok, rows, seg, n, device, s);
  return w_quant ? launch<kSolveMaxN, true>(stats, fe, px_s, px, ok, rows, seg, n, device, s)
                 : launch<kSolveMaxN, false>(stats, fe, px_s, px, ok, rows, seg, n, device, s);
}
