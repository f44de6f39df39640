// The profile-3 coding scan: kernel K8.
//
// K8 replaces no pallas_call: the JAX package runs this scan,
// nblic_tpu/models/strips.py::_code_impl's row and segment scans (and
// _row_code inside _near_rows for the near-lossless encoder), as jitted
// lax.scans that XLA compiles.  Its plain versions are
// nblic_tpu_torch/models/strips.py::_row_scan_plain and _near_code_plain,
// Python loops over rows and column segments with ~200 small launches a
// segment.  One launch runs the whole scan, th rows x n_seg segments, for
// every image of the call: what it computes, and the order of its phases,
// is row_scan.cuh's (scan_image), which the CPU tests run on one host
// thread; the coder's arithmetic is coder3.cuh's, which kernel K4 decodes
// with.
//
// Mapping: one CTA an image, kThreads threads.  An image's strip lanes
// share its bias moments and its mapper history, which live in the CTA's
// shared memory (3072 x 2 + 10240 int64, 128 KB); thread t walks lanes t,
// t + kThreads, ... and every thread sweeps the shared tables and the
// lanes' counter tables (global memory, a lane's own) between segments.
// The barriers between a segment's walk, its adds and its sweeps keep each
// read at the state the contract gives it: the segment's start (the row's
// for a row-frozen bias or mapper).  The shared adds are 64-bit atomics:
// wrapping int64 sums, the same in any order.
//
// What bounds K8 on Hopper.  A lane's walk is one thread's serial chain:
// per pixel a bias quantization (a 64-bit division), the mapper's rank (20
// shared loads), and n_unary + 8 slots, each one or two counter pairs
// loaded and a 32-bit division; at th 768 an image is one lane, so the
// chain is the whole image's 393,216 pixels, and the three barriers and
// the sweeps (13,312 shared entries and the lane's 416 counter pairs over
// 256 threads) come every 16 pixels at 32 segments a row.

#include <cstdint>
#include <cuda_runtime.h>

#include "row_scan.cuh"

namespace {

constexpr int kThreads = 256;  // threads a CTA (an image)
constexpr int kSmemBytes = (2 * kScanCtx + kMapKeys * kNMap) * 8;

struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

struct SharedAdd64 {
  __device__ __forceinline__ void operator()(int64_t* p, int64_t v) const {
    atomicAdd(reinterpret_cast<unsigned long long*>(p), static_cast<unsigned long long>(v));
  }
};

__global__ void __launch_bounds__(kThreads) p3_row_scan_kernel(ScanContract c, ScanData d) {
  extern __shared__ __align__(16) int64_t tables[];
  const ImageTables tb{tables, tables + kScanCtx, tables + 2 * kScanCtx};
  scan_image(c, d, tb, blockIdx.x, threadIdx.x, blockDim.x, BlockSync{}, SharedAdd64{});
}

}  // namespace

// Dynamic shared memory of one K8 CTA.
extern "C" long long nbt_p3_row_scan_smem() { return kSmemBytes; }

// K8 over `n_imgs` images of lanes / n_imgs strip lanes each.  planes,
// probs, bins, masks, utab, rtab, keep as row_scan.cuh's ScanData, each on
// `device`, contiguous; contract: the host's 57 ints (near_mode,
// lanes_per_image, th, w, ws, n_unary, k_step, n_class, seg_bias, seg_map,
// sym_cnt, cnt_init, cnt_halve, bias_cap, bias_shrink, map_bump, map_halve,
// then the n_unary-long esc and cls, each padded to 20).  Launches one CTA
// an image on `stream`; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a contract out of range).
extern "C" int nbt_p3_row_scan(const int32_t* planes, int16_t* probs, int8_t* bins,
                               uint8_t* masks, int32_t* utab, int32_t* rtab, int32_t* keep,
                               int lanes, int n_imgs, const int* contract, int device,
                               void* stream) {
  const ScanContract c = scan_contract(contract);
  if (!scan_contract_ok(c, lanes, n_imgs)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(p3_row_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ScanData d{planes, probs, bins, masks, utab, rtab, keep, lanes};
  p3_row_scan_kernel<<<n_imgs, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(c, d);
  return static_cast<int>(cudaGetLastError());
}
