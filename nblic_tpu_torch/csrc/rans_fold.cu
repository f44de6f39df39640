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
// steps (a 32-bit division each), and every step reads 8 bytes (freq, cum)
// and writes 4.  Design: one thread per stream with native u32 division; the
// tables arrive in an (L, S) layout, so at every step neighbouring threads
// read neighbouring addresses and each warp's loads coalesce into 128-byte
// lines.  The loads do not depend on the state, so unrolling lets them issue
// ahead of the chain.  The output is (L, S) too, with fold step k = L-1-l
// on row k, so the caller's (S, L) fold-order view is a transpose, not a
// copy.  S streams make S / 128 blocks; a batch of 24 images at 64x64 tiles
// has 3072 streams, so 24 blocks on 132 SMs (occupancy is left for later).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kLowBound = 1u << 16;

__global__ void rans_fold_kernel(const int32_t* __restrict__ freq,
                                 const int32_t* __restrict__ facc,
                                 int32_t* __restrict__ out,
                                 uint32_t* __restrict__ state_out,
                                 int S, int L) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  uint32_t st = kLowBound;
#pragma unroll 8
  for (int l = L - 1; l >= 0; --l) {
    const size_t at = static_cast<size_t>(l) * S + s;
    const uint32_t h = static_cast<uint32_t>(freq[at]);
    const uint32_t ha = static_cast<uint32_t>(facc[at]);
    // state / h > 2^17 - 1  <=>  state >> 17 >= h
    const uint32_t renorm = (st >> 17) >= h ? 1u : 0u;
    const uint32_t word = st & 0xFFFFu;
    if (renorm) st >>= 16;
    const uint32_t q = st / h;
    const uint32_t r = st - q * h;
    out[static_cast<size_t>(L - 1 - l) * S + s] =
        static_cast<int32_t>(word | (renorm << 16));
    st = r + (q << 15) + ha;
  }
  state_out[s] = st;
}

}  // namespace

// freq/facc: (L, S) int32, freq in [1, 2^15].  out: (L, S) int32 in fold
// order, word | renorm << 16.  state: (S,) u32 final states.  Launches on
// `stream`; returns cudaGetLastError() after the launch.
extern "C" int nbt_rans_fold(const int32_t* freq, const int32_t* facc,
                             int32_t* out, uint32_t* state, int S, int L,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 128;
  const int blocks = (S + threads - 1) / threads;
  rans_fold_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      freq, facc, out, state, S, L);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
