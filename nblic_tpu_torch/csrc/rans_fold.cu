// Lockstep reverse rANS encode fold of S independent streams (kernel K1).
//
// Replaces nblic_tpu/ops/pallas_fold.py::encode_fold, the TPU kernel, and
// computes what nblic_tpu/ops/rans.py::encode_scan computes: the state starts
// at 2^16; for each symbol, last to first, if state >> 17 >= freq the step
// emits state & 0xFFFF and shifts the state down 16 bits, then
// state = ((state / freq) << 15) + state % freq + cum.  A pad lane
// (freq == 2^15, cum == 0) keeps its state at 2^16 and never emits.
//
// What bounds it on Hopper: each stream is one serial chain of L dependent
// steps (a 32-bit division each); every step reads 8 bytes (freq, cum) and
// writes 4, 151 MB for a batch of 24 Kodak-shaped images, which the card
// moves in ~45 us.  A table load that the chain waits for costs a device
// memory latency per step, so the tables reach the chain through shared
// memory.  Design: one thread per stream with native u32 division.  The
// tables arrive in an (L, S) layout; a block of kBlock streams walks its
// columns from l = L - 1 down in chunks of kChunk rows.  Each chunk of
// freq and of facc is a (kChunk x kBlock) tile, copied by 16-byte
// cp.async (4-byte copies where S or a pointer is not 16-byte aligned)
// into a ring of kStages stages: a chunk is requested kStages - 1 chunks
// (~48 steps of chain, a few microseconds) before the chain reads it, and
// the chain reads shared memory only.  One block barrier per chunk frees
// the stage that the next request overwrites.  The output is (L, S), with
// fold step k = L-1-l on row k, so the caller's (S, L) fold-order view is
// a transpose, not a copy, and each warp's stores coalesce.  Blocks of
// 32, 64 and 128 threads (96, 48 or 24 blocks for 3072 streams on the
// 132 SMs) take the same time, so the chain, not the SMs, bounds it
// (kernel_probe.py fold: PERF.md); kBlock = 128.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kLowBound = 1u << 16;
constexpr int kChunk = 16;  // table rows per stage
constexpr int kStages = 4;  // ring stages; kStages - 1 chunks in flight
constexpr int kBlock = 128; // streams per block
constexpr int kSmem = 2 * kStages * kChunk * kBlock * sizeof(int32_t);

__device__ __forceinline__ void cp_async(void* dst, const void* src, bool whole) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (whole)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
                 : "memory");
}

__global__ void rans_fold_kernel(const int32_t* __restrict__ freq,
                                 const int32_t* __restrict__ facc,
                                 int32_t* __restrict__ out,
                                 uint32_t* __restrict__ state_out, int S, int L) {
  extern __shared__ __align__(16) uint32_t ring[];  // [stage][freq|facc][row][lane]
  constexpr int tile = kChunk * kBlock;  // words of one table's chunk
  const int tid = threadIdx.x;
  const int s0 = blockIdx.x * kBlock;
  const int s = s0 + tid;
  const int n_chunks = (L + kChunk - 1) / kChunk;
  const bool vec = (S % 4 == 0) &&
                   ((reinterpret_cast<uintptr_t>(freq) |
                     reinterpret_cast<uintptr_t>(facc)) % 16 == 0);

  // Request chunk c (rows l = L-1-c*kChunk down) into its stage.
  auto request = [&](int c) {
    uint32_t* st = ring + (c % kStages) * 2 * tile;
    constexpr int quads = kBlock / 4;
    for (int q = tid; q < kChunk * quads; q += kBlock) {
      const int r = q / quads;
      const int col = 4 * (q % quads);
      const int l = L - 1 - c * kChunk - r;
      if (l < 0) continue;
      const size_t at = static_cast<size_t>(l) * S + s0 + col;
      if (vec && s0 + col + 3 < S) {
        cp_async(st + r * kBlock + col, freq + at, true);
        cp_async(st + tile + r * kBlock + col, facc + at, true);
      } else {
        for (int e = 0; e < 4 && s0 + col + e < S; ++e) {
          cp_async(st + r * kBlock + col + e, freq + at + e, false);
          cp_async(st + tile + r * kBlock + col + e, facc + at + e, false);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks) request(c);
    else asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  uint32_t state = kLowBound;
  for (int c = 0; c < n_chunks; ++c) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncthreads();  // chunk c has landed; every thread is done with c - 1
    if (c + kStages - 1 < n_chunks) request(c + kStages - 1);
    else asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (s >= S) continue;
    const uint32_t* fr = ring + (c % kStages) * 2 * tile + tid;
    const uint32_t* fa = fr + tile;
    int32_t* o = out + static_cast<size_t>(c) * kChunk * S + s;
    auto step = [&](int r) {
      const uint32_t h = fr[r * kBlock];
      const uint32_t ha = fa[r * kBlock];
      // state / h > 2^17 - 1  <=>  state >> 17 >= h
      const uint32_t renorm = (state >> 17) >= h ? 1u : 0u;
      const uint32_t word = state & 0xFFFFu;
      if (renorm) state >>= 16;
      const uint32_t q = state / h;
      o[static_cast<size_t>(r) * S] = static_cast<int32_t>(word | (renorm << 16));
      state = (state - q * h) + (q << 15) + ha;
    };
    const int rows = min(kChunk, L - c * kChunk);
    if (rows == kChunk) {
      // one basic block of kChunk steps: the table reads and the divisor's
      // half of each division do not depend on the state and issue early
#pragma unroll
      for (int r = 0; r < kChunk; ++r) step(r);
    } else {
      for (int r = 0; r < rows; ++r) step(r);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  if (s < S) state_out[s] = state;
}

}  // namespace

// Dynamic shared memory of one K1 block.
extern "C" long long nbt_rans_fold_smem() { return kSmem; }

// freq/facc: (L, S) int32, freq in [1, 2^15].  out: (L, S) int32 in fold
// order, word | renorm << 16.  state: (S,) u32 final states.  Launches on
// `stream`; returns cudaGetLastError() after the launch.
extern "C" int nbt_rans_fold(const int32_t* freq, const int32_t* facc,
                             int32_t* out, uint32_t* state, int S, int L,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(rans_fold_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (S + kBlock - 1) / kBlock;
  rans_fold_kernel<<<blocks, kBlock, kSmem, static_cast<cudaStream_t>(stream)>>>(
      freq, facc, out, state, S, L);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
