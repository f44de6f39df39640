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
// is row_scan.cuh's (scan_image), which the CPU tests run with virtual
// threads; the coder's arithmetic is coder3.cuh's, which kernel K4 decodes
// with.
//
// Mapping: one CTA an image, kThreads threads (16 warps).  An image's
// strip lanes share its bias moments and its mapper history, which live
// in the CTA's shared memory (3072 x 2 + 10240 int64, 128 KB; the near
// coder has no bias), beside the layer tables and, where they fit in what
// is left, the lanes' counter tables (2,304 B a lane for the lossless scan
// at k_step 3; 9.5 KB at k_step 7, 34 KB at 16) with their marks;
// otherwise the counters stay in the scratch tensors in device memory,
// their marks (152 B a lane at k_step 7) in shared memory where those fit.
// The barriers between a segment's walk, its adds and its sweeps keep each
// read at the state the contract gives it: the segment's start (the row's
// for a row-frozen bias or mapper).
//
// What bounds K8 on Hopper.  A segment is a dependent step of the image:
// its walk, adds and sweeps, three barriers; at th 768 an image is one
// lane and a row 32 segments of 16 pixels, 24,576 segments in all, so a
// segment's latency is the time.  There a warp takes a pixel and a thread
// a slot (the rank and the stop layer one ballot each), and keeps its
// slot's events for the adds; with more pixels than warps a thread takes
// a pixel (the warps' issue binds; kernel_probe.py p3-scan-phases times
// both).  A counter pair's two counts are one 64-bit atomic add, which
// returns their sum, so an add that takes an entry past its threshold
// marks it and the sweeps visit only those: none of the 10,240 mapper
// counts, 3,072 contexts and every lane's pairs that a full sweep visits
// each segment.  The layer rows and quotients by k_step come from shared
// tables, the pair probabilities from 32-bit divisions where the counts
// allow.

#include <cstdint>
#include <cuda_runtime.h>

#include "row_scan.cuh"

namespace {

constexpr int kThreads = 512;  // threads a CTA (an image)

struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

// The CTA as scan_image's team.
struct BlockTeam {
  BlockSync barrier;
  DeviceAtomics at;
  template <class F>
  __device__ __forceinline__ void threads(F f) const {
    f(static_cast<int>(threadIdx.x), static_cast<int>(blockDim.x));
  }
  __device__ __forceinline__ void sync() const { barrier(); }
  __device__ __forceinline__ bool warp_pixels(const ScanContract& c) const {
    return ::warp_pixels(c, kThreads / kWarp);
  }
  __device__ __forceinline__ SlotEvents walk(const ScanContract& c, const ScanData& d,
                                             const ImageTables& tb, const LaneTables& lt,
                                             int lane0, int r, int j0) const {
    const int task = threadIdx.x / kWarp;
    if (task >= c.lanes_per_image * c.ws) return {-1, -1, -1, 0, 0, -1};
    return walk_pixel_device(c, d, tb, lt, lane0, r, j0, task, threadIdx.x % kWarp);
  }
  __device__ __forceinline__ void events(const ScanContract& c, const LaneTables& lt,
                                         const SlotEvents& ev) const {
    add_events(c, lt, ev, at);
  }
};

__global__ void __launch_bounds__(kThreads)
    p3_row_scan_kernel(ScanContract c, ScanData d, int placement) {
  extern __shared__ __align__(16) int64_t smem[];
  char* base = reinterpret_cast<char*>(smem);
  const ScanLayout lay = scan_layout(c, placement);
  const ImageTables tb{
      c.near_mode ? nullptr : reinterpret_cast<int64_t*>(base + lay.bsum),
      c.near_mode ? nullptr : reinterpret_cast<int64_t*>(base + lay.bcnt),
      reinterpret_cast<int64_t*>(base + lay.mhist), reinterpret_cast<uint32_t*>(base + lay.bmark),
      reinterpret_cast<uint32_t*>(base + lay.mmark), reinterpret_cast<int*>(base + lay.consts)};
  const size_t lane0 = static_cast<size_t>(blockIdx.x) * c.lanes_per_image;
  const int ucells = unary_cells(c), words = counter_words(c);
  const bool tables = placement == kSharedCounters;
  const LaneTables lt{
      tables ? reinterpret_cast<int32_t*>(base + lay.u) : d.utab + lane0 * ucells,
      tables ? reinterpret_cast<int32_t*>(base + lay.r) : d.rtab + lane0 * 2 * kRefinePairs,
      placement != kDeviceCounters ? reinterpret_cast<uint32_t*>(base + lay.umark)
                                   : d.umark + lane0 * words,
      ucells, words};
  scan_image(c, d, tb, lt, blockIdx.x, BlockTeam{});
}

}  // namespace

// Dynamic shared memory of one K8 CTA of the lossless scan, without the
// lanes' counter tables and marks (which join it where they fit).
extern "C" long long nbt_p3_row_scan_smem() {
  ScanContract c{};
  return static_cast<long long>(scan_layout(c, kDeviceCounters).bytes);
}

// K8 over `n_imgs` images of lanes / n_imgs strip lanes each.  planes,
// probs, bins, masks, utab, rtab, umark, keep as row_scan.cuh's ScanData,
// each on `device`, contiguous; contract: the host's 57 ints (near_mode,
// lanes_per_image, th, w, ws, n_unary, k_step, n_class, seg_bias, seg_map,
// sym_cnt, cnt_init, cnt_halve, bias_cap, bias_shrink, map_bump, map_halve,
// then the n_unary-long esc and cls, each padded to 20).  Launches one CTA
// an image on `stream`; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a contract out of range).
extern "C" int nbt_p3_row_scan(const int32_t* planes, int16_t* probs, int8_t* bins,
                               uint8_t* masks, int32_t* utab, int32_t* rtab, uint32_t* umark,
                               int32_t* keep, int lanes, int n_imgs, const int* contract,
                               int device, void* stream) {
  const ScanContract c = scan_contract(contract);
  if (!scan_contract_ok(c, lanes, n_imgs)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr size_t kSmemLimit = 232448;  // bytes of shared memory a Hopper block may use
  int placement = kSharedCounters;
  while (placement > kDeviceCounters && scan_layout(c, placement).bytes > kSmemLimit) --placement;
  const size_t bytes = scan_layout(c, placement).bytes;
  err = cudaFuncSetAttribute(p3_row_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const ScanData d{planes, probs, bins, masks, utab, rtab, umark, keep, lanes};
  p3_row_scan_kernel<<<n_imgs, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      c, d, placement);
  return static_cast<int>(cudaGetLastError());
}
