// The binary rANS fold of the profile-3 encoder: kernel K3.
//
// K3 replaces no pallas_call: the JAX package runs this fold,
// nblic_tpu/ops/rans_bin.py::fold, as a jitted lax.scan over the slots.
// Its plain version is nblic_tpu_torch/ops/rans_bin.py::fold_plain, one
// torch step a slot over every state.  What it computes is coder3.cuh's
// fold step, slot by slot from the last: S independent 32-bit states, each
// over its n slots (12-bit probabilities; a masked slot keeps the state and
// emits nothing).
//
// What bounds it on Hopper: each state is one serial chain of dependent
// steps, one a live slot; a masked slot does not move the state, and its
// word is the state's low 16 bits after the last live step before it.
// Only the renormalization test, the shift, the quotient and the new state
// depend on the state.  So a CTA holds kStates chains, one a thread of its
// consumer warp, and kProducers producer warps that, a round of kChunk
// slots a state at a time, read the slots ((S, n) p1 int16, bin and live
// mask a byte each, as the encoder's slot planes hold them) through a ring
// of kStages stages filled by 16-byte cp.async (plain loads where n is not
// a multiple of 16 or a pointer not 16-byte aligned), requested kStages -
// 1 rounds ahead; turn each state's live slots into the chain's operands,
// compacted in fold order (f, acc, the slot's position, and f's
// reciprocal from a table of the 4,095 magics the CTA builds first,
// coder3.cuh's fold_recip); and, two rounds later, write every word of
// the chunk, live ones from the chain's record, masked ones from the state
// it left.  The consumer steps only live slots, with no division:
// fold_by_recip's compare, shift, multiply-high, multiply-subtract and
// add.  Round r builds chunk r, steps chunk r - 1 and stores chunk r - 2,
// one block barrier a round.  The outputs are (n, S), fold step k on row
// k: the words (int32) and the emit flags (a byte each), so the stores
// coalesce across states and the caller's (S, n) views are transposes.

#include <cstdint>
#include <cuda_runtime.h>

#include "coder3.cuh"

namespace {

constexpr int kWarpSize = 32;
constexpr int kStates = 32;     // chains a CTA: the consumer warp
constexpr int kProducers = 7;   // producer warps
constexpr int kThreads = kWarpSize * (1 + kProducers);
constexpr int kChunk = 32;      // slots of a state a round
constexpr int kStages = 4;      // ring stages
constexpr int kRecBufs = 3;     // records built, stepped, stored
constexpr int kWordRow = 2 * kChunk + 1;  // a state's words: live, after; a pad word

// A state's chunk in a ring stage: p1, bins, live masks.
struct SlotRow {
  int16_t p1[kChunk];
  uint8_t bin[kChunk];
  uint8_t live[kChunk];
};

struct FoldShared {
  SlotRow ring[kStages][kStates];
  uint2 rec[kRecBufs][kStates][kChunk];  // magic, f | acc << 12 | position << 24
  uint32_t live[kRecBufs][kStates];      // a chunk's live positions, bit p: fold position p
  uint32_t words[2][kStates][kWordRow];  // [p]: a live step's word; [kChunk + p]: state after
  uint32_t entry[2][kStates];            // the state before the chunk's first step
  uint32_t magic[kProbMax];              // fold_recip(f).magic by f
};

__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to), "l"(src) : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// The producers' own barrier (named barrier 1; 0 is __syncthreads').
__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kWarpSize * kProducers) : "memory");
}

__device__ __forceinline__ void build_magic(uint32_t* magic, int t, int n) {
  for (int f = t; f < kProbMax; f += n) magic[f] = f ? fold_recip(f).magic : 0;
}

// A live slot's record at fold position p: its f and acc, and f's magic
// from the table.
__device__ __forceinline__ uint2 live_record(int p1, bool one, int p, const uint32_t* magic) {
  const FoldSlot fs = fold_operands(p1, one);
  return make_uint2(magic[fs.f], fs.f | fs.acc << 12 | static_cast<uint32_t>(p) << 24);
}

// One live step of the chain: its word (the state's low 16 bits before it,
// bit 16 where it renormalized) at word[0], the state's low 16 bits after
// it at word[kChunk].
__device__ __forceinline__ uint32_t fold_live(uint32_t state, uint2 rec, uint32_t* word) {
  const uint32_t f = rec.y & 0xFFFu, acc = (rec.y >> 12) & 0xFFFu;
  uint32_t emit;
  const uint32_t next = fold_by_recip(state, f, acc, FoldRecip{rec.x, ceil_log2(f)}, emit);
  word[0] = (state & 0xFFFFu) | emit << 16;
  word[kChunk] = next & 0xFFFFu;
  return next;
}

__global__ void __launch_bounds__(kThreads)
    bin_fold_kernel(const int16_t* __restrict__ p1, const uint8_t* __restrict__ bins,
                    const uint8_t* __restrict__ mask, int32_t* __restrict__ words,
                    uint8_t* __restrict__ emits, uint32_t* __restrict__ state_out, int S, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FoldShared& sh = *reinterpret_cast<FoldShared*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / kWarpSize, lane = tid % kWarpSize;
  const int s0 = blockIdx.x * kStates;
  const int n_states = min(kStates, S - s0);
  const int n_chunks = (n + kChunk - 1) / kChunk;
  const bool vec = n % 16 == 0 && reinterpret_cast<uintptr_t>(p1) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(bins) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  const int pt = tid - kWarpSize;  // a producer's index
  constexpr int kProducerThreads = kWarpSize * kProducers;

  // Chunk c (the c-th from the end) covers slots [k0, k0 + rows); its fold
  // positions p = 0.. are slots k0 + rows - 1 - p, fold steps n - k0 -
  // rows + p.
  auto chunk_k0 = [&](int c) { return (n_chunks - 1 - c) * kChunk; };
  auto chunk_rows = [&](int c) { return min(kChunk, n - chunk_k0(c)); };

  // A producer requests chunk c into its stage: a state's row is four
  // 16-byte pieces of p1 and two each of bins and masks (rows is a
  // multiple of 16 wherever the copies are 16 bytes); element by element
  // with plain loads otherwise.
  auto request = [&](int c) {
    SlotRow* st = sh.ring[c % kStages];
    const int k0 = chunk_k0(c), rows = chunk_rows(c);
    if (vec) {
      for (int q = pt; q < kStates * 8; q += kProducerThreads) {
        const int r = q / 8, piece = q % 8;
        const int col = piece < 4 ? 8 * piece : 16 * ((piece - 4) % 2);
        if (r >= n_states || col >= rows) continue;
        const size_t at = static_cast<size_t>(s0 + r) * n + k0 + col;
        if (piece < 4) copy_async(st[r].p1 + col, p1 + at);
        else if (piece < 6) copy_async(st[r].bin + col, bins + at);
        else copy_async(st[r].live + col, mask + at);
      }
    } else {
      for (int q = pt; q < kStates * kChunk; q += kProducerThreads) {
        const int r = q / kChunk, col = q % kChunk;
        if (r >= n_states || col >= rows) continue;
        const size_t at = static_cast<size_t>(s0 + r) * n + k0 + col;
        st[r].p1[col] = p1[at];
        st[r].bin[col] = bins[at];
        st[r].live[col] = mask[at];
      }
    }
    commit();
  };

  // Producer warp w compacts the live slots of its states of chunk c.
  auto build = [&](int c) {
    const int rows = chunk_rows(c), b = c % kRecBufs;
    for (int s = warp - 1; s < n_states; s += kProducers) {
      const SlotRow& row = sh.ring[c % kStages][s];
      const int at = rows - 1 - lane;
      const bool live = lane < rows && row.live[at] != 0;
      const uint32_t mask = __ballot_sync(0xffffffffu, live);
      if (live)
        sh.rec[b][s][__popc(mask & ((1u << lane) - 1))] =
            live_record(row.p1[at], row.bin[at] == 1, lane, sh.magic);
      if (lane == 0) sh.live[b][s] = mask;
    }
  };

  // The producers store every word and emit flag of chunk c, state fastest.
  auto store = [&](int c) {
    const int k0 = chunk_k0(c), rows = chunk_rows(c), b = c % kRecBufs, h = c & 1;
    const size_t o = static_cast<size_t>(n - k0 - rows) * S + s0;
    for (int e = pt; e < rows * n_states; e += kProducerThreads) {
      const int p = e / n_states, s = e - p * n_states;
      const uint32_t lm = sh.live[b][s];
      const uint32_t below = lm & ((1u << p) - 1);
      const uint32_t v = (lm >> p) & 1u ? sh.words[h][s][p]
                         : below        ? sh.words[h][s][kChunk + 31 - __clz(below)]
                                        : sh.entry[h][s] & 0xFFFFu;
      words[o + static_cast<size_t>(p) * S + s] = static_cast<int32_t>(v & 0xFFFFu);
      emits[o + static_cast<size_t>(p) * S + s] = v >> 16;
    }
  };

  build_magic(sh.magic, tid, kThreads);
  if (warp > 0) {
    for (int c = 0; c < kStages - 1; ++c) {
      if (c < n_chunks) request(c);
      else commit();
    }
  }
  __syncthreads();  // the magic table
  uint32_t state = kAnsLow;  // the consumer thread's chain
  for (int round = 0; round < n_chunks + 2; ++round) {
    if (warp == 0) {
      const int c = round - 1;
      if (c >= 0 && c < n_chunks && lane < n_states) {
        uint32_t* w = sh.words[c & 1][lane];
        const uint2* rec = sh.rec[c % kRecBufs][lane];
        const int n_live = __popc(sh.live[c % kRecBufs][lane]);
        sh.entry[c & 1][lane] = state;
        uint2 q = rec[0];
        for (int i = 0; i < n_live; ++i) {
          const uint2 next = rec[i + 1 < n_live ? i + 1 : i];
          state = fold_live(state, q, w + (q.y >> 24));
          q = next;
        }
      }
    } else {
      if (round >= 2) store(round - 2);
      if (round < n_chunks) {
        asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
        producers_sync();  // chunk `round` has landed; every producer is done with round - 1
        if (round + kStages - 1 < n_chunks) request(round + kStages - 1);
        else commit();
        build(round);
      }
    }
    __syncthreads();
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  if (warp == 0 && lane < n_states) state_out[s0 + lane] = state;
}

// One step of K3's chain a (state, slot) pair, for the card tests of the
// reciprocal: the slot's record as the producers build it, then the live
// step (or, for a masked slot, the state kept).  out: the word, the emit
// flag and the state after at 3 i, 3 i + 1, 3 i + 2.
__global__ void __launch_bounds__(256)
    bin_fold_steps_kernel(const uint32_t* states, const int16_t* p1, const uint8_t* bins,
                          const uint8_t* mask, uint32_t* out, int n) {
  __shared__ uint32_t magic[kProbMax];
  build_magic(magic, threadIdx.x, blockDim.x);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t state = states[i];
  uint32_t word[kChunk + 1] = {state & 0xFFFFu};
  uint32_t next = state;
  if (mask[i]) next = fold_live(state, live_record(p1[i], bins[i] == 1, 0, magic), word);
  out[3 * i] = word[0] & 0xFFFFu;
  out[3 * i + 1] = word[0] >> 16;
  out[3 * i + 2] = next;
}

}  // namespace

// p1 (S, n) int16, bins and mask (S, n) a byte each (a one where bins is
// 1, live where mask is not 0), in decode order.  words (n, S) int32 and
// emits (n, S) bytes in fold order; state: (S,) u32 final states.
// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int nbt_bin_fold(const int16_t* p1, const uint8_t* bins, const uint8_t* mask,
                            int32_t* words, uint8_t* emits, uint32_t* state, int S, int n,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kBytes = sizeof(FoldShared);
  err = cudaFuncSetAttribute(bin_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (S + kStates - 1) / kStates;
  bin_fold_kernel<<<blocks, kThreads, kBytes, static_cast<cudaStream_t>(stream)>>>(
      p1, bins, mask, words, emits, state, S, n);
  return static_cast<int>(cudaGetLastError());
}

// One chain step for each of n (state, slot) pairs (bin_fold_steps_kernel).
extern "C" int nbt_bin_fold_steps(const uint32_t* states, const int16_t* p1, const uint8_t* bins,
                                  const uint8_t* mask, uint32_t* out, int n, int device,
                                  void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  bin_fold_steps_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      states, p1, bins, mask, out, n);
  return static_cast<int>(cudaGetLastError());
}
