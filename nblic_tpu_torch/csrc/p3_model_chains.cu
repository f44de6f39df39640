// The profile-3 modeling chains: kernel K10.
//
// K10 replaces no pallas_call: the JAX package runs these chains,
// nblic_tpu/ops/pavp.py::predict_plane's run_chains (col_chain, e_chain,
// f_chain, e_freeze_extend, hold_starts: lax.scans) over the energy
// channel, the moment blocks (block_stats, a lax.map) and the two mix
// channels, as XLA programs.  Its plain version is
// nblic_tpu_torch/ops/model_pass.py::chains_plain, built on ops/pavp.py's
// _run_chains: Python loops of a few torch operations a step, H + 2 W
// steps a channel block, ~10^5 launches a pass at strip height 768.
//
// What it computes, channel by channel (c), strip by strip (s): the
// contribution of each pixel; B, its column chain over the rows; E, the
// in-row left accumulation of B before each column; F, the right-to-left
// accumulation of the row above's B; then E + F, E frozen at the segment
// starts and decay-extended (seg_stats), or E and F held at the starts
// (w_pred).  A channel's contribution is computed here from what it
// multiplies (model_chain.cuh): |x - p| << FB1 for the energy and mix
// channels, the moment of two of [x - FIT_BASE, the features] over the
// pixel's sample weight s for the others.  The energy launch ends with a
// pass a thread a pixel that writes each pixel's s and its reciprocal
// from its E + F, for the moments.
//
// What bounds K10 on Hopper.  Its output: 888 B of statistics a pixel at
// n = 10 (8.4 GB at the th-64 corpus), ~69 integer operations a channel
// and pixel.  The chains are serial: B down a column, E and F along a
// row; the decay truncates, so no scan reorders them.  Two designs, the
// wrapper (ops/model_pass.py::chain_design) picks by shape:
// - the skewed wavefront (model_chain.cuh's schedule), for the moments of
//   short strips whose CTAs fill the card (the th-64 corpus): a CTA a
//   (strip, 32-channel block), 32 channel lanes a warp and 2 rows a
//   thread, a forward pass that hands B from row to row on the chip and
//   stores E, a reverse pass that forms B again, carries F and adds it;
//   each pass w + h steps, ~24 B of traffic a channel and pixel, no
//   scratch for B; a warp's loads of a pixel's inputs are one or two
//   lines and its stores of a pixel's 32 channels one coalesced 256 B;
// - two passes (below), for tall strips (th 768: the wavefront
//   would leave 4 CTAs in all, and a row a thread, which would fill the
//   card, makes each warp instruction load or store 32 lines: 11.1-11.4 ms
//   against 2.4-2.6) and for the energy and mix channels.

#include <cstdint>
#include <cuda_runtime.h>

#include "model_chain.cuh"

namespace {

constexpr int kWeightThreads = 256;

// The probe build (kernel_probe.py p3-model-phases, -DNBT_PROBE_STAMPS)
// sums each thread's clock64() cycles by phase of its steps: the
// hand-off (ring or carry) with the next loads' issue, the
// contributions (waiting on their loads), the chains and stores, the
// barrier; then the steps.
#ifdef NBT_PROBE_STAMPS
__device__ unsigned long long nbt_probe_phase[8];
struct ChainClock {
  unsigned long long acc[5];
  long long last;
  __device__ ChainClock() {
    for (int ph = 0; ph < 5; ++ph) acc[ph] = 0;
    last = clock64();
  }
  __device__ void operator()(int phase) {
    const long long now = clock64();
    acc[phase] += now - last;
    last = now;
  }
  __device__ void flush() {
    for (int ph = 0; ph < 5; ++ph) atomicAdd(&nbt_probe_phase[ph], acc[ph]);
  }
};
#else
struct ChainClock {
  __device__ void operator()(int) {}
  __device__ void flush() {}
};
#endif
enum { kHandOff = 0, kContrib = 1, kChain = 2, kBarrier = 3, kSteps = 4 };

// The wavefront's layout: 32 channel lanes a warp, 2 rows a thread, 16
// warps a CTA (a band of 32 rows), the inputs of the next step loaded a
// step ahead.  2 rows a thread 23.3 ms at the th-64 corpus beside 4 rows'
// 26.0 and 8 rows' 26.7 (kernel_probe.py p3-model-forms).
constexpr int kWaveLanes = 32;
constexpr int kWaveRows = 2;
constexpr int kWaveWarps = 16;

// One pass over band `band` (`nrows` rows) of the CTA's strip and channel
// block: forward (E stored) or reverse (F added), each thread its rows of
// one channel, the steps in chunks of kChainChunk between barriers.  B of
// the row above a thread's first row: chain_receive (the ring of the warp
// above, or the carry above the band).  Each step issues the loads of the
// next, so a step waits on its chain, not on memory.
template <int kForm, bool kFwd>
__device__ __forceinline__ void chain_pass(const ChainArgs& a, const ChainPlan& pl,
                                           int64_t* ring, int strip, int cblock, int band,
                                           int nrows, ChainClock& clock) {
  constexpr int kRows = kWaveRows;
  const ChainThread th = chain_thread(a, pl, kMoments, kFwd, ring, strip, cblock, band, nrows,
                                      threadIdx.x / kChainWarp, threadIdx.x % kChainWarp);
  const int steps = chain_steps(pl, a.w, nrows);
  int64_t hand[kRows], acc[kRows], ef[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) hand[k] = acc[k] = ef[k] = 0;
  ChainIn next[kRows];
  chain_rows_load<kMoments, kForm, kRows, kFwd>(a, th, -th.lag0, next);
  for (int s0 = 0; s0 < steps; s0 += kChainChunk) {
#pragma unroll 1
    for (int u = 0; u < kChainChunk; ++u) {
      const int t0 = s0 + u - th.lag0;
      int64_t cv[kRows];
      ChainIn cur[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) cur[k] = next[k];
      chain_rows_contrib<kMoments, kRows>(cur, th.mo, cv);
      clock(kContrib);
      chain_rows_load<kMoments, kForm, kRows, kFwd>(a, th, t0 + 1, next);
      const int64_t up = chain_receive(a, th, kFwd, t0);
      clock(kHandOff);
      chain_rows_apply<kMoments, kForm, kRows, kFwd>(a, th, t0, up, cur, cv, hand, acc, ef);
      clock(kChain);
    }
    __syncthreads();
    clock(kBarrier);
  }
#ifdef NBT_PROBE_STAMPS
  clock.acc[kSteps] += steps;
#endif
}

template <int kForm>
__global__ void __launch_bounds__(kWaveWarps * kChainWarp) chains_kernel(ChainArgs a,
                                                                         ChainPlan pl) {
  extern __shared__ int64_t ring[];  // (warps, kChainRing, kWaveLanes)
  const int cblocks = (a.k + kWaveLanes - 1) / kWaveLanes;
  const int strip = blockIdx.x / cblocks, cblock = blockIdx.x % cblocks;  // channels fastest
  ChainClock clock;
  for (int band = 0; band < pl.bands; ++band) {
    const int nrows = min(pl.band, a.h - band * pl.band);
    chain_pass<kForm, true>(a, pl, ring, strip, cblock, band, nrows, clock);
    chain_pass<kForm, false>(a, pl, ring, strip, cblock, band, nrows, clock);
  }
  clock.flush();
}

// The two-pass design, for tall or few strips (th 768), where a CTA of
// the 32-lane wavefront would hold a whole channel block and a row-a-thread
// wavefront loads and stores 32 lines a warp instruction: two passes a
// launch, each one thread a chain, channels fastest.  The B pass, a thread
// a (strip, column, channel), runs B down the column into the (P, k)
// scratch (in `carry`); the E/F pass, a thread a (strip, row, channel),
// runs F right to left into the output, then E left to right added to it
// (E before column j, frozen at a segment's start and decayed across it,
// or held with F).  Each pass loads kTwoPassAhead steps' inputs before
// stepping through them: 2 the fastest (4, 8 and 16 took the B pass to 86,
// 128 and 226 registers; a 16-row cp.async ring in shared memory, which
// costs none, paid two barriers a row and was 4-10% slower at th 768).
constexpr int kTwoPassThreads = 256;
constexpr int kTwoPassAhead = 2;

template <int kKind>
__global__ void __launch_bounds__(kTwoPassThreads) b_pass_kernel(ChainArgs a) {
  const long long t = static_cast<long long>(blockIdx.x) * kTwoPassThreads + threadIdx.x;
  if (t >= static_cast<long long>(a.s) * a.w * a.k) return;
  const int c = static_cast<int>(t % a.k);
  const long long col = t / a.k;                             // s w + j
  const long long px_top = col / a.w * a.h * a.w + col % a.w;  // row 0 of the column
  const MomentOf mo = kKind == kMoments ? moment_of(a.q0 + c, a.n) : MomentOf{0, 0, 0};
  int64_t bv = 0;
  for (int i0 = 0; i0 < a.h; i0 += kTwoPassAhead) {
    int64_t cv[kTwoPassAhead];
#pragma unroll
    for (int u = 0; u < kTwoPassAhead; ++u)
      cv[u] = i0 + u < a.h
                  ? chain_contribution<kKind>(
                        chain_load<kKind>(a, mo, px_top + static_cast<long long>(i0 + u) * a.w, c),
                        mo)
                  : 0;
#pragma unroll
    for (int u = 0; u < kTwoPassAhead; ++u) {
      if (i0 + u < a.h) {
        bv = mc_add(chain_decay<kKind>(bv), cv[u]);
        a.carry[(px_top + static_cast<long long>(i0 + u) * a.w) * a.k + c] = bv;
      }
    }
  }
}

template <int kKind>
__global__ void __launch_bounds__(kTwoPassThreads) ef_pass_kernel(ChainArgs a) {
  const long long t = static_cast<long long>(blockIdx.x) * kTwoPassThreads + threadIdx.x;
  if (t >= static_cast<long long>(a.s) * a.h * a.k) return;
  const int c = static_cast<int>(t % a.k);
  const long long row = t / a.k;  // s h + i
  const int i = static_cast<int>(row % a.h);
  const long long px0 = row * a.w;
  const bool hold = a.form == kHold, freeze = a.form == kFreeze;
  const int w_out = hold ? a.w / a.seg : a.w;
  const long long k = a.k, stride = a.stride;
  int64_t* out = a.out + row * w_out * stride + a.c0 + c;
  const int64_t* b_cur = a.carry + px0 * k + c;
  const int64_t* b_up = i > 0 ? b_cur - a.w * k : b_cur;  // read where i > 0
  const int seg = a.seg;  // 1 where plain: every column a start
  // F, right to left; a column's place in its segment counts down from
  // seg - 1 (w is a multiple of seg), held values stored at the starts
  int64_t f = 0;
  int at = seg - 1;
  int64_t* o = out + (w_out - 1) * stride;
  for (int j0 = a.w - 1; j0 >= 0; j0 -= kTwoPassAhead) {
    int64_t bu[kTwoPassAhead];
#pragma unroll
    for (int u = 0; u < kTwoPassAhead; ++u)
      bu[u] = (i > 0 && j0 - u >= 0) ? b_up[(j0 - u) * k] : 0;
#pragma unroll
    for (int u = 0; u < kTwoPassAhead; ++u) {
      const int j = j0 - u;
      if (j >= 0) {
        f = mc_add(chain_decay<kKind>(f), bu[u]);
        if (!hold) {
          out[j * stride] = f;
        } else if (at == 0) {
          *o = f;
          o -= stride;
        }
        at = at == 0 ? seg - 1 : at - 1;
      }
    }
  }
  // E, left to right, added to the stored F
  int64_t e = 0, ef = 0;
  at = 0;
  o = out;
  for (int j0 = 0; j0 < a.w; j0 += kTwoPassAhead) {
    int64_t bc[kTwoPassAhead], fv[kTwoPassAhead];
    int at_u = at;
    const int64_t* o_u = o;
#pragma unroll
    for (int u = 0; u < kTwoPassAhead; ++u) {
      const int j = j0 + u;
      const bool in = j < a.w;
      bc[u] = in ? b_cur[j * k] : 0;
      if (!hold) {
        fv[u] = in ? out[j * stride] : 0;
      } else {
        fv[u] = (in && at_u == 0) ? *o_u : 0;
        if (in && at_u == 0) o_u += stride;
        at_u = at_u == seg - 1 ? 0 : at_u + 1;
      }
    }
#pragma unroll
    for (int u = 0; u < kTwoPassAhead; ++u) {
      const int j = j0 + u;
      if (j < a.w) {
        if (freeze) ef = at == 0 ? e : chain_decay<kKind>(ef);
        if (!hold) {
          out[j * stride] = mc_add(freeze ? ef : e, fv[u]);
        } else if (at == 0) {
          *o = mc_add(e, fv[u]);
          o += stride;
        }
        e = mc_add(chain_decay<kKind>(e), bc[u]);
        at = at == seg - 1 ? 0 : at + 1;
      }
    }
  }
}

__global__ void __launch_bounds__(kWeightThreads) weight_kernel(ChainArgs a) {
  const long long px = static_cast<long long>(blockIdx.x) * kWeightThreads + threadIdx.x;
  if (px < a.p) chain_weight(a, px);
}

template <int kKind>
int launch_two_pass(const ChainArgs& a, cudaStream_t stream) {
  const long long b_threads = static_cast<long long>(a.s) * a.w * a.k;
  const long long ef_threads = static_cast<long long>(a.s) * a.h * a.k;
  b_pass_kernel<kKind><<<static_cast<unsigned>((b_threads + kTwoPassThreads - 1) /
                                               kTwoPassThreads),
                         kTwoPassThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ef_pass_kernel<kKind><<<static_cast<unsigned>((ef_threads + kTwoPassThreads - 1) /
                                                kTwoPassThreads),
                          kTwoPassThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (kKind != kEnergy || err != cudaSuccess) return static_cast<int>(err);
  weight_kernel<<<static_cast<unsigned>((a.p + kWeightThreads - 1) / kWeightThreads),
                  kWeightThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

ChainPlan plan_for(int h) { return chain_plan(h, kWaveRows, kWaveWarps); }

template <int kForm>
int launch_wave(const ChainArgs& a, cudaStream_t stream) {
  const ChainPlan pl = plan_for(a.h);
  const size_t smem = static_cast<size_t>(pl.warps) * kChainRing * kWaveLanes * sizeof(int64_t);
  cudaError_t err = cudaFuncSetAttribute(chains_kernel<kForm>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long ctas = static_cast<long long>(a.s) * ((a.k + kWaveLanes - 1) / kWaveLanes);
  chains_kernel<kForm><<<static_cast<unsigned>(ctas), pl.warps * kChainWarp, smem, stream>>>(
      a, pl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#ifdef NBT_PROBE_STAMPS
// The probe's phase sums (hand-off, contributions, chains and stores,
// barrier; then the steps, a thread's passes) since the last reset.
extern "C" int nbt_probe_phases(unsigned long long* dst, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(dst, nbt_probe_phase, sizeof(nbt_probe_phase));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    err = cudaMemcpyToSymbol(nbt_probe_phase, zero, sizeof(zero));
  }
  return static_cast<int>(err);
}
#endif

// The wavefront's layout over strips of h rows x w, for its floor:
// out[0..4] = warps a CTA, rows a band, bands, steps a pass over a whole
// band, CTAs an SM at once (by occupancy).
extern "C" int nbt_p3_model_chains_plan(int h, int w, int* out) {
  if (h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const ChainPlan pl = plan_for(h);
  const size_t smem = static_cast<size_t>(pl.warps) * kChainRing * kWaveLanes * sizeof(int64_t);
  int per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(chains_kernel<kPlain>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chains_kernel<kPlain>,
                                                        pl.warps * kChainWarp, smem);
  out[0] = pl.warps;
  out[1] = pl.band;
  out[2] = pl.bands;
  out[3] = chain_steps(pl, w, pl.band);
  out[4] = per_sm;
  return static_cast<int>(err);
}

// The int64 scratch a launch of k channels over s strips of h x w needs in
// design `design` (nbt_p3_model_chains): two passes' B, s h w k; the
// wavefront's carry between bands, 2 s k w where a strip is more than one
// band, else 0.  -1 for a design out of range.
extern "C" long long nbt_p3_model_chains_scratch(int s, int h, int w, int k, int design) {
  if (s < 1 || h < 1 || w < 1 || k < 1) return -1;
  if (design == 0) return static_cast<long long>(s) * h * w * k;
  if (design != kWaveLanes) return -1;
  return plan_for(h).bands > 1 ? 2ll * s * k * w : 0;
}

// K10, one launch: kind 0 the energy channel (k = 1, its E + F at output
// channel c0, then in a second pass each pixel's sample weight into ssum
// and srecip), 1 the moment channels q0 .. q0 + k - 1 of the n + n^2
// (output channels c0 + c), 2 the two mix channels (k = 2).  design: 0
// two passes (B through the scratch), 32 the wavefront at 32
// channel lanes a warp (kind 1 only).  fe: (s h w, n + 1) int32; pred: (k,
// s h w) int32 for kinds 0 and 2 (else unread); ssum (int32), srecip
// (uint64): (s h w,); scratch: int64 of nbt_p3_model_chains_scratch's size
// (may be null where that is 0); out: int64 rows of `stride`, one a pixel,
// or under form 2 (hold) one a segment of `seg` columns (w a multiple of
// seg); form 1 (freeze) decay-extends E across segments of seg.  w < 2^16.
// Each on `device`, contiguous.  Launches on `stream`; returns
// cudaGetLastError() after each launch (cudaErrorInvalidValue for
// arguments out of range).
extern "C" int nbt_p3_model_chains(int kind, const int32_t* fe, const int32_t* pred,
                                   int32_t* ssum, uint64_t* srecip, int64_t* scratch,
                                   int64_t* out, int s, int h, int w, int n, int q0, int k,
                                   int stride, int c0, int seg, int form, int design, int device,
                                   void* stream) {
  const bool shape_ok = s >= 1 && h >= 1 && w >= 1 && w < (1 << 16) && n >= 1 && n <= 12 &&
                        k >= 1 && c0 >= 0 && c0 + k <= stride;
  const bool kind_ok = (kind == kEnergy && k == 1) || (kind == kMix && k == 2) ||
                       (kind == kMoments && q0 >= 0 && q0 + k <= n + n * n);
  const bool form_ok = form == kPlain || ((form == kFreeze || form == kHold) && seg >= 2 &&
                                          seg < (1 << 16) && w % seg == 0);
  const bool design_ok = design == 0 || (design == kWaveLanes && kind == kMoments);
  if (!shape_ok || !kind_ok || !form_ok || !design_ok)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nbt_p3_model_chains_scratch(s, h, w, k, design) > 0 && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int sg = form == kPlain ? 1 : seg;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ChainArgs a{fe, pred, ssum, srecip, scratch, out, static_cast<long long>(s) * h * w,
                    s, h, w, n, q0, k, stride, c0, sg, form, seg_inverse(sg)};
  auto st = static_cast<cudaStream_t>(stream);
  if (design == kWaveLanes) {
    if (form == kFreeze) return launch_wave<kFreeze>(a, st);
    if (form == kHold) return launch_wave<kHold>(a, st);
    return launch_wave<kPlain>(a, st);
  }
  if (kind == kEnergy) return launch_two_pass<kEnergy>(a, st);
  if (kind == kMix) return launch_two_pass<kMix>(a, st);
  return launch_two_pass<kMoments>(a, st);
}
