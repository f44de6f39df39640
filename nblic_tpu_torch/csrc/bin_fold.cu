// The binary rANS fold of the profile-3 encoder: kernel K3.
//
// K3 replaces no pallas_call: the JAX package runs this fold,
// nblic_tpu/ops/rans_bin.py::fold, as a jitted lax.scan over the slots.
// Its plain version is nblic_tpu_torch/ops/rans_bin.py::fold_plain, one
// torch step a slot over every state.  What it computes is coder3.cuh's
// fold_slot, slot by slot from the last: S independent 32-bit states, each
// over its n slots (12-bit probabilities; a masked slot keeps the state and
// emits nothing).
//
// What bounds it on Hopper: each state is one serial chain of n dependent
// steps, a 32-bit division each where the slot is live.  A slot load that
// the chain waits for costs a device memory latency per step, so, as in
// kernel K1 (rans_fold.cu), the slots reach the chain through shared
// memory: one thread a state, kBlock states a CTA; each state's slots are
// packed in 4 bytes ((S, n) int32, rans_bin.pack_slots) and copied by
// 16-byte cp.async (4-byte copies where n or the pointer is not 16-byte
// aligned), a chunk of kChunk slots of every state of the CTA a stage,
// into a ring of kStages stages: a chunk is requested kStages - 1 chunks
// before the chain reads it.  A state's row in a stage is padded to kRow
// words, so the chain's 16-byte reads of 4 slots are free of bank
// conflicts.  The output is (n, S), fold step k on row k, word | emitted
// << 16, so each warp's stores coalesce and the caller's (S, n) view is a
// transpose.

#include <cstdint>
#include <cuda_runtime.h>

#include "coder3.cuh"

namespace {

constexpr int kBlock = 32;        // states a CTA: one warp
constexpr int kChunk = 32;        // slots of a state a stage
constexpr int kStages = 4;        // ring stages; kStages - 1 chunks in flight
constexpr int kRow = kChunk + 4;  // words of a state's row in a stage

__device__ __forceinline__ void copy_async(void* dst, const void* src, bool whole) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (whole)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to), "l"(src) : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__global__ void __launch_bounds__(kBlock)
    bin_fold_kernel(const uint32_t* __restrict__ slots, int32_t* __restrict__ out,
                    uint32_t* __restrict__ state_out, int S, int n) {
  __shared__ __align__(16) uint32_t ring[kStages * kBlock * kRow];
  const int tid = threadIdx.x;
  const int s0 = blockIdx.x * kBlock;
  const int s = s0 + tid;
  const int n_chunks = (n + kChunk - 1) / kChunk;
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(slots) % 16 == 0;

  // Request the c-th chunk from the end, slots [k0, k0 + rows), into its
  // stage; rows is a multiple of 4 wherever the copies are 16 bytes.
  auto request = [&](int c) {
    uint32_t* st = ring + (c % kStages) * kBlock * kRow;
    const int k0 = (n_chunks - 1 - c) * kChunk;
    const int rows = min(kChunk, n - k0);
    constexpr int quads = kChunk / 4;
    for (int q = tid; q < kBlock * quads; q += kBlock) {
      const int r = q / quads, col = 4 * (q % quads);
      if (s0 + r >= S || col >= rows) continue;
      const uint32_t* src = slots + static_cast<size_t>(s0 + r) * n + k0 + col;
      uint32_t* dst = st + r * kRow + col;
      if (vec) {
        copy_async(dst, src, true);
      } else {
        for (int e = 0; e < 4 && col + e < rows; ++e) copy_async(dst + e, src + e, false);
      }
    }
    commit();
  };

  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks) request(c);
    else commit();
  }
  uint32_t state = kAnsLow;
  for (int c = 0; c < n_chunks; ++c) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncthreads();  // chunk c has landed; every thread is done with c - 1
    if (c + kStages - 1 < n_chunks) request(c + kStages - 1);
    else commit();
    if (s >= S) continue;
    const int k0 = (n_chunks - 1 - c) * kChunk;
    const int rows = min(kChunk, n - k0);
    const uint32_t* row = ring + (c % kStages) * kBlock * kRow + tid * kRow;
    // slot k0 + j is fold step n - 1 - k0 - j
    int32_t* o = out + static_cast<size_t>(n - k0 - rows) * S + s;
    if (rows == kChunk) {
#pragma unroll
      for (int q = kChunk / 4 - 1; q >= 0; --q) {
        const uint4 v = *reinterpret_cast<const uint4*>(row + 4 * q);
        const uint32_t quad[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 3; e >= 0; --e) {
          const int j = 4 * q + e;
          const uint32_t word = fold_slot(state, quad[e]);
          o[static_cast<size_t>(rows - 1 - j) * S] = static_cast<int32_t>(word);
        }
      }
    } else {
      for (int j = rows - 1; j >= 0; --j)
        o[static_cast<size_t>(rows - 1 - j) * S] = static_cast<int32_t>(fold_slot(state, row[j]));
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  if (s < S) state_out[s] = state;
}

}  // namespace

// slots: (S, n) packed slots (coder3.cuh's fold_slot) in decode order.
// out: (n, S) int32 in fold order, word | emitted << 16.  state: (S,) u32
// final states.  Launches on `stream`; returns cudaGetLastError() after the
// launch.
extern "C" int nbt_bin_fold(const uint32_t* slots, int32_t* out, uint32_t* state, int S, int n,
                            int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (S + kBlock - 1) / kBlock;
  bin_fold_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(slots, out, state, S,
                                                                           n);
  return static_cast<int>(cudaGetLastError());
}
