// Kernel K6: the interop engines' serial walks on the card, three entries.
//
// - nblic_walk_kernel<kN, kDecode>: the NBLIC0.3 codec walk (efforts 1-3:
//   kN = 0, 6, 10 AVP features; encode and decode; near 0-9), one image a
//   launch.  Replaces, on a CUDA tensor, models/nblic.py::_walk_plain; the
//   JAX package runs it as the lax.scan of nblic_tpu/models/nblic.py:40
//   (_codec_scan), no pallas_call.
// - q_decode_kernel: the Q0.2 decode walk, one image a launch, replacing
//   models/qnblic.py::_decode_walk_plain (nblic_tpu/models/qnblic.py:103,
//   _decode_scan).
// - q_chain_kernel: the Q0.2 encode's per-context EWMA chain, one thread a
//   context over its pixels in raster order, replacing the step loop of
//   models/qnblic.py::_context_chain_plain (nblic_tpu/models/qnblic.py:46).
//
// What bounds them.  Each walk is one dependent chain a pixel long: the
// coder's registers, the context cells, the mappers and (efforts 2-3) the
// moments all carry from one pixel to the next, and the range coder's
// unary bins carry within a pixel.  So the work is latency, not bytes or
// operations: one image's chain on one SM.  The design keeps every step of
// the chain on chip: the counter tree (uint16 pairs), the context cells
// and the mappers in shared memory, the coder's registers in thread 0's
// registers, and no host read anywhere (the stop flag of a unary walk is
// a branch of thread 0).  At efforts 2-3 the warp shares the pixel: the
// two ridge systems are built over the 32 threads, solved side by side by
// threads 0 and 1 (model_solve.cuh's one-system-a-thread solve, divisions
// by each level's reciprocal), and the m = 1 + n + n^2 moments update over
// the threads; the rest of the pixel runs on thread 0.  The columns'
// moments B and the row's prefix F ((w, m) int64, ~0.7 MB each at w = 768,
// n = 10) stay in device memory (L2), read and written coalesced.  The
// context chain is as serial as its fullest context (a flat image: one
// thread, 393,216 steps): each thread loads eight pixels' indices and
// errors ahead of their steps.  The per-pixel functions are
// interop_chain.cuh's, which g++ also compiles for the CPU test.

#include <cstdint>
#include <cuda_runtime.h>

#include "interop_chain.cuh"

namespace {

constexpr int kAvpThreads = 32;  // the team of an effort 2-3 walk: one warp
constexpr int kChainThreads = 128;

// One CTA as nblic_walk's team.
struct CtaTeam {
  template <class F>
  __device__ __forceinline__ void threads(F f) const {
    f(static_cast<int>(threadIdx.x), static_cast<int>(blockDim.x));
  }
  template <class F>
  __device__ __forceinline__ void one(F f) const {
    if (threadIdx.x == 0) f();
  }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

// The walk's dynamic shared memory: the AVP's cross-thread state, then
// the mappers' counts, the context cells, the counter tree and the
// mappers' ranks.
template <int kN>
__host__ __device__ constexpr size_t avp_bytes() {
  return (sizeof(NAvp<kN ? kN : 1>) + 15) / 16 * 16;
}
template <int kN>
__host__ __device__ constexpr size_t walk_smem() {
  return avp_bytes<kN>() + 4 * kMapKeys * kMapN + 4 * kNCtxN + 2 * 2 * kTreePairs +
         2 * kMapKeys * kMapN;
}

template <int kN, bool kDecode>
__global__ void __launch_bounds__(kAvpThreads) nblic_walk_kernel(NWalk a) {
  extern __shared__ __align__(16) int64_t smem[];
  char* base = reinterpret_cast<char*>(smem);
  auto& av = *reinterpret_cast<NAvp<kN ? kN : 1>*>(base);
  size_t off = avp_bytes<kN>();
  int32_t* freq = reinterpret_cast<int32_t*>(base + off);
  off += 4 * kMapKeys * kMapN;
  int32_t* ctx = reinterpret_cast<int32_t*>(base + off);
  off += 4 * kNCtxN;
  uint16_t* tree = reinterpret_cast<uint16_t*>(base + off);
  off += 2 * 2 * kTreePairs;
  uint8_t* to_rank = reinterpret_cast<uint8_t*>(base + off);
  uint8_t* from_rank = to_rank + kMapKeys * kMapN;
  const NTables tb{tree, ctx, Mappers{to_rank, from_rank, freq}};
  nblic_walk<kN, kDecode>(a, tb, av, CtaTeam{});
}

template <int kN, bool kDecode>
int launch_walk(const NWalk& a, cudaStream_t stream) {
  constexpr size_t bytes = walk_smem<kN>();
  const cudaError_t e = cudaFuncSetAttribute(
      nblic_walk_kernel<kN, kDecode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  nblic_walk_kernel<kN, kDecode><<<1, kN ? kAvpThreads : 1, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDecode>
int launch_effort(const NWalk& a, int effort, cudaStream_t stream) {
  switch (effort) {
    case 1:
      return launch_walk<0, kDecode>(a, stream);
    case 2:
      return launch_walk<6, kDecode>(a, stream);
    default:
      return launch_walk<10, kDecode>(a, stream);
  }
}

// The Q0.2 decode: the tables staged in shared memory by the CTA, the
// walk on thread 0, the lut (12 x 2^15 bytes) read through the read-only
// cache.
__global__ void __launch_bounds__(kAvpThreads)
    q_decode_kernel(const int32_t* __restrict__ words, long long n_words,
                    const int32_t* __restrict__ freq, const int32_t* __restrict__ cum,
                    const uint8_t* __restrict__ lut, uint8_t* __restrict__ rec, int h, int w) {
  __shared__ int32_t s_freq[kQCtx], s_cum[kQCtx], s_ctx[kQCtx];
  for (int k = threadIdx.x; k < kQCtx; k += blockDim.x) {
    s_freq[k] = freq[k];
    s_cum[k] = cum[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) q_decode_walk(words, n_words, s_freq, s_cum, lut, s_ctx, rec, h, w);
}

__global__ void __launch_bounds__(kChainThreads)
    q_chain_kernel(const int32_t* __restrict__ err, const int64_t* __restrict__ order,
                   const int64_t* __restrict__ start, int n_ctx, int32_t* __restrict__ before) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < n_ctx) q_chain_context(err, order, start[c], start[c + 1], before);
}

}  // namespace

// Dynamic shared memory of one NBLIC0.3 walk at `effort` (1..3), else -1.
extern "C" long long nbt_interop_walk_smem(int effort) {
  switch (effort) {
    case 1:
      return static_cast<long long>(walk_smem<0>());
    case 2:
      return static_cast<long long>(walk_smem<6>());
    case 3:
      return static_cast<long long>(walk_smem<10>());
    default:
      return -1;
  }
}

// K6's NBLIC0.3 walk of one (h, w) image.  img: (h, w) uint8 on encode,
// null on decode; rec: (h, w) uint8, written; lo, hi, window, ptr: the
// coder's registers, one int64 each, read and written back; buf: the
// stream of len bytes (encode: written, writes past len dropped; decode:
// the payload and 4 zero bytes); b, f: (w, 1 + n + n^2) int64 at efforts
// 2-3 (n = 6, 10), b zeroed, else unused; bins: one int64 that takes the
// count of binary decisions coded, or null.  effort in 1..3, k_step >= 2,
// near >= 0, h and w >= 1.  Launches one CTA on `stream` (32 threads at
// efforts 2-3, one at effort 1); returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for arguments out of range).
extern "C" int nbt_interop_nblic_walk(const uint8_t* img, uint8_t* rec, int64_t* lo, int64_t* hi,
                                      int64_t* window, int64_t* ptr, uint8_t* buf,
                                      long long len, int64_t* b, int64_t* f, int64_t* bins,
                                      int h, int w, int near, int k_step, int effort, int decode,
                                      int device, void* stream) {
  if (effort < 1 || effort > 3 || k_step < 2 || near < 0 || h < 1 || w < 1 || len < 1 ||
      (!decode && img == nullptr) || (effort > 1 && (b == nullptr || f == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const NWalk a{img, rec, {lo, hi, window, ptr}, buf, len, b, f, h, w, near, k_step, bins};
  auto s = static_cast<cudaStream_t>(stream);
  return decode ? launch_effort<true>(a, effort, s) : launch_effort<false>(a, effort, s);
}

// K6's Q0.2 decode of one (h, w) image: words (n_words >= 1 u16 values as
// int32), freq and cum (12, 256) int32, lut (12, 2^15) uint8, rec (h, w)
// uint8 written.  One CTA of 32 threads on `stream`.
extern "C" int nbt_interop_q_decode(const int32_t* words, long long n_words, const int32_t* freq,
                                    const int32_t* cum, const uint8_t* lut, uint8_t* rec, int h,
                                    int w, int device, void* stream) {
  if (n_words < 1 || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  q_decode_kernel<<<1, kAvpThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      words, n_words, freq, cum, lut, rec, h, w);
  return static_cast<int>(cudaGetLastError());
}

// K6's context chain: err (P,) int32 errors, order (P,) int64 the pixels
// stably sorted by context, start (n_ctx + 1,) int64 each context's first
// position in order (the last entry P); before (P,) int32 written.  One
// thread a context on `stream`.
extern "C" int nbt_interop_q_chain(const int32_t* err, const int64_t* order, const int64_t* start,
                                   int n_ctx, int32_t* before, int device, void* stream) {
  if (n_ctx < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned blocks = static_cast<unsigned>((n_ctx + kChainThreads - 1) / kChainThreads);
  q_chain_kernel<<<blocks, kChainThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      err, order, start, n_ctx, before);
  return static_cast<int>(cudaGetLastError());
}
