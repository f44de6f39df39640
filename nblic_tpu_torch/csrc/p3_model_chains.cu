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
// from its E + F, for the moment launches.
//
// What bounds K10 on Hopper.  Its output: 888 B of statistics a pixel at
// n = 10 (8.4 GB at the th-64 corpus); the arithmetic, ~40 int64
// operations a channel and pixel, is below the memory's share.  The chains
// are serial: H steps down a column, then 2 W along a row, so the launch
// needs many chains at once to fill the card: at strip height 768 one
// image is one strip, and a row-sweeping CTA an image would serialize
// 768 x 1,024 steps.  So K10 is two passes a launch, each one thread a
// chain: the B pass, a thread a (strip, column, channel), writes B after
// every row into a scratch (P, k) (k channels of the launch, channels
// fastest); the E/F pass, a thread a (strip, row, channel), runs F right
// to left into the output, then E left to right adding it.  Channels run
// fastest in both passes and in the statistics (pixel-major (rows, m)),
// so a warp's loads and stores of one pixel's channels are contiguous and
// K11's warp reads a pixel's m statistics in one coalesced sweep.  The
// wrapper cuts the moment channels into launches whose scratch stays
// within a budget, so the peak memory is the statistics plus that budget.

#include <cstdint>
#include <cuda_runtime.h>

#include "model_chain.cuh"

namespace {

constexpr int kThreads = 256;
// chain steps whose loads a chain issues together: 2 beside 1, 4, 8 and
// 16 was the fastest at the th-64 corpus (more loads in flight cost
// registers, so fewer warps) and within 4% of the fastest at th 768
// (kernel_probe.py p3-model-forms)
constexpr int kAhead = 2;
enum Kind { kEnergy = 0, kMoments = 1, kMix = 2 };
enum Form { kPlain = 0, kFreeze = 1, kHold = 2 };

struct ChainArgs {
  const int32_t* fe;    // (P, n + 1): x - FIT_BASE, then the n features
  const int32_t* pred;  // (K, P): the predictions of the energy and mix channels
  int32_t* ssum;        // (P,): the clipped sample weight (energy writes, moments read)
  uint64_t* srecip;     // (P,): its reciprocal for model_chain.cuh's moment()
  int64_t* b;           // (P, k) scratch: B after each row
  int64_t* out;         // (rows, stride): E + F at channel c0 + c
  long long p;          // pixels: s h w
  int s, h, w, n, q0, k, stride, c0, seg, form;
};

// Channel c's contribution at pixel px; `mo` its factors (moments only).
template <int kKind>
__device__ __forceinline__ int64_t contribution(const ChainArgs& a, const MomentOf& mo,
                                                long long px, int c) {
  const int32_t* f = a.fe + px * (a.n + 1);
  if (kKind == kMoments)
    return moment(f[mo.left], f[mo.right], mo.shift, a.ssum[px], a.srecip[px]);
  return err_energy(f[0] + 128, a.pred[c * a.p + px]);
}

template <int kKind>
__device__ __forceinline__ int64_t decay(int64_t v) {
  return kKind == kMoments ? mc_decay<kMcAlpha>(v) : mc_decay<kMcBeta>(v);
}

// The B pass: thread (strip, column j, channel c), c fastest, runs B down
// the strip's column and stores it after every row.  Each chunk of kAhead
// rows loads (and computes) its contributions before its steps, so a
// chain waits on device memory once a chunk and not once a step.
template <int kKind>
__global__ void __launch_bounds__(kThreads) b_pass_kernel(ChainArgs a) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(a.s) * a.w * a.k) return;
  const int c = static_cast<int>(t % a.k);
  const long long col = t / a.k;  // s w + j
  const int j = static_cast<int>(col % a.w);
  const long long px_top = col / a.w * a.h * a.w + j;  // row 0 of the column
  const MomentOf mo = kKind == kMoments ? moment_of(a.q0 + c, a.n) : MomentOf{0, 0, 0};
  int64_t bv = 0;
  for (int i0 = 0; i0 < a.h; i0 += kAhead) {
    int64_t cv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      cv[u] = i0 + u < a.h
                  ? contribution<kKind>(a, mo, px_top + static_cast<long long>(i0 + u) * a.w, c)
                  : 0;
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (i0 + u < a.h) {
        bv = mc_add(decay<kKind>(bv), cv[u]);
        a.b[(px_top + static_cast<long long>(i0 + u) * a.w) * a.k + c] = bv;
      }
    }
  }
}

// The E/F pass: thread (strip, row i, channel c), c fastest.  F of the row
// from the row above's B, right to left, into the output rows; then E left
// to right, each output row's F read back and E added (E before column j:
// frozen at a segment's start and decayed across it, or held with F).
// Both sweeps load a chunk of kAhead columns before stepping through it.
template <int kKind>
__global__ void __launch_bounds__(kThreads) ef_pass_kernel(ChainArgs a) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(a.s) * a.h * a.k) return;
  const int c = static_cast<int>(t % a.k);
  const long long row = t / a.k;  // s h + i
  const int i = static_cast<int>(row % a.h);
  const long long px0 = row * a.w;
  const bool hold = a.form == kHold, freeze = a.form == kFreeze;
  const int w_out = hold ? a.w / a.seg : a.w;
  const long long k = a.k, stride = a.stride;
  int64_t* out = a.out + row * w_out * stride + a.c0 + c;
  const int64_t* b_cur = a.b + px0 * k + c;
  const int64_t* b_up = i > 0 ? b_cur - a.w * k : b_cur;  // read where i > 0
  const int seg = a.seg;  // 1 where plain: every column a start

  // F, right to left; a column's place in its segment counts down from
  // seg - 1 (w is a multiple of seg), held values stored at the starts
  int64_t f = 0;
  int at = seg - 1;
  int64_t* o = out + (w_out - 1) * stride;
  for (int j0 = a.w - 1; j0 >= 0; j0 -= kAhead) {
    int64_t bu[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) bu[u] = (i > 0 && j0 - u >= 0) ? b_up[(j0 - u) * k] : 0;
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int j = j0 - u;
      if (j >= 0) {
        f = mc_add(decay<kKind>(f), bu[u]);
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
  for (int j0 = 0; j0 < a.w; j0 += kAhead) {
    int64_t bc[kAhead], fv[kAhead];
    int at_u = at;
    const int64_t* o_u = o;
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
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
    for (int u = 0; u < kAhead; ++u) {
      const int j = j0 + u;
      if (j < a.w) {
        if (freeze) ef = at == 0 ? e : decay<kKind>(ef);
        if (!hold) {
          out[j * stride] = mc_add(freeze ? ef : e, fv[u]);
        } else if (at == 0) {
          *o = mc_add(e, fv[u]);
          o += stride;
        }
        e = mc_add(decay<kKind>(e), bc[u]);
        at = at == seg - 1 ? 0 : at + 1;
      }
    }
  }
}

// The energy launch's last pass: thread a pixel, its sample weight from
// its statistics row's channel 0 (the segment's under hold) and its
// energy contribution, with the weight's reciprocal, for the moments.
__global__ void __launch_bounds__(kThreads) weight_kernel(ChainArgs a) {
  const long long px = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (px >= a.p) return;
  const long long row = px / a.w;
  const int j = static_cast<int>(px - row * a.w);
  const long long r = a.form == kHold ? row * (a.w / a.seg) + j / a.seg : px;
  const int64_t sw = sample_weight(a.out[r * a.stride + a.c0],
                                   err_energy(a.fe[px * (a.n + 1)] + 128, a.pred[px]));
  a.ssum[px] = static_cast<int32_t>(sw);
  a.srecip[px] = moment_recip(sw);
}

template <int kKind>
int launch(const ChainArgs& a, cudaStream_t stream) {
  const long long b_threads = static_cast<long long>(a.s) * a.w * a.k;
  const long long ef_threads = static_cast<long long>(a.s) * a.h * a.k;
  b_pass_kernel<kKind><<<static_cast<unsigned>((b_threads + kThreads - 1) / kThreads),
                         kThreads, 0, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ef_pass_kernel<kKind><<<static_cast<unsigned>((ef_threads + kThreads - 1) / kThreads),
                          kThreads, 0, stream>>>(a);
  if (kKind != kEnergy) return static_cast<int>(cudaGetLastError());
  const cudaError_t ef_err = cudaGetLastError();
  if (ef_err != cudaSuccess) return static_cast<int>(ef_err);
  weight_kernel<<<static_cast<unsigned>((a.p + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K10, one launch: kind 0 the energy channel (k = 1, its E + F at output
// channel c0, then in a third pass each pixel's sample weight into ssum
// and srecip), 1 the
// moment channels q0 .. q0 + k - 1 of the n + n^2 (output channels c0 + c),
// 2 the two mix channels (k = 2).  fe: (s h w, n + 1) int32; pred: (k, s h
// w) int32 for kinds 0 and 2 (else unread); ssum (int32), srecip (uint64):
// (s h w,); b: (s h w, k) int64 scratch; out: int64 rows of `stride`, one
// a pixel, or under form 2 (hold) one a segment of `seg` columns (w a
// multiple of seg); form 1 (freeze) decay-extends E across segments of
// seg.  Each on `device`, contiguous.  Launches the B pass, then the E/F
// pass (and the weights) on `stream`; returns cudaGetLastError() after each
// (cudaErrorInvalidValue for arguments out of range).
extern "C" int nbt_p3_model_chains(int kind, const int32_t* fe, const int32_t* pred,
                                   int32_t* ssum, uint64_t* srecip, int64_t* b, int64_t* out,
                                   int s, int h, int w, int n, int q0, int k, int stride, int c0,
                                   int seg, int form, int device, void* stream) {
  const bool shape_ok = s >= 1 && h >= 1 && w >= 1 && n >= 1 && n <= 12 && k >= 1 &&
                        c0 >= 0 && c0 + k <= stride;
  const bool kind_ok = (kind == kEnergy && k == 1) || (kind == kMix && k == 2) ||
                       (kind == kMoments && q0 >= 0 && q0 + k <= n + n * n);
  const bool form_ok = form == kPlain || ((form == kFreeze || form == kHold) && seg >= 2 &&
                                          w % seg == 0);
  if (!shape_ok || !kind_ok || !form_ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ChainArgs a{fe, pred, ssum, srecip, b, out, static_cast<long long>(s) * h * w,
                    s, h, w, n, q0, k, stride, c0, form == kPlain ? 1 : seg, form};
  auto st = static_cast<cudaStream_t>(stream);
  if (kind == kEnergy) return launch<kEnergy>(a, st);
  if (kind == kMix) return launch<kMix>(a, st);
  return launch<kMoments>(a, st);
}
