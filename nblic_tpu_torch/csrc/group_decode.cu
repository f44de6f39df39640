// Lockstep decode of NBTC profile-1 and profile-2 interleave groups:
// kernel K2, one group per CTA, which also serves as kernel K2'.
//
// K2 replaces nblic_tpu/ops/pallas_decode.py::decode_groups_pallas, the TPU
// kernel, profile-1 and profile-2 branches; K2' replaces
// docs/experiments/pallas_decode8.py::decode_groups_pallas8.  Both compute
// what nblic_tpu_torch/ops/decode.py::group_decode_plain computes.  The g
// tile lanes of a group walk their th x tw tiles in raster order in
// lockstep.  Per pixel: the 11-register causal window (fresh at each row
// start, slid per column), the blend prediction (profile 2: or the lane's
// least-squares prediction, or their mean, by the lane's flag), the 12-bin
// activity and the context address, the static bias (1/16 px plus the sign
// bit), the symbol y = #{v : acc[qd][v] <= state & 0x7FFF} - 1, the state
// update, the renormalization against ONE shared stream cursor per group
// (each lane that needs a word takes the word at cursor + its exclusive
// rank among the group's needing lanes, clamped to the last word), and the
// near-aware unfold.
//
// What bounds K2 on Hopper.  Not the bytes, and not the card's operations:
// a group's lanes share one cursor, so a group is one CTA of g threads (of
// ceil(g / 32) warps at a width that is not a multiple of 32, as the mesh
// writes: t_total / n_tiles lanes), and
// a Kodak-shaped image at 64 x 64 tiles is one group (24 images: 24 of 132
// SMs).  On its SM a CTA of g = 128 lanes is 4 warps on the 4 schedulers;
// a lane runs ~364 integer operations per pixel (~396 at profile 2;
// chip_smoke.py counts them), so the SM cannot step faster than ~364
// cycles a pixel.  Above that floor
// sits the per-pixel chain: a lane's next state needs its renormalization
// word, whose position needs every warp's count of needing lanes (a block
// barrier); the symbol needs the state and the activity bin; the next
// pixel's prediction needs the symbol.  Each piece of the design cuts a
// link of that chain:
// - The stream is staged in shared memory, ahead of the cursor: a ring of
//   ring_words(g) int32 words (a power of two >= (kAhead + 2) g + 8).
//   A pixel consumes, and so frees, at most g words.  Each pixel every
//   thread requests at most one 16-byte cp.async copy of 4 words into the
//   slots freed (those of the words below the cursor that every thread
//   has read), one commit group per pixel, and before the pixel's barrier
//   waits for the group of kAhead pixels ago: every word is in the ring
//   before its read.  Rows of the stream matrix are a multiple of 4 words
//   (the wrapper pads them where they are not).  Reads past the end clamp
//   to word W - 1, whose slot no later word overwrites.
// - The symbol search is a slot lookup: row qd of the uint8 table T holds,
//   for each b < 2^k, the last symbol whose cumulative frequency is at
//   most b 2^(15-k), and T[2^k] = 255.  The symbol lies in [T[b], T[b+1]]
//   for b = lb >> (15 - k); a bounded binary search over that span takes
//   no load for most lanes and one for most of the rest, where the search
//   it replaces took 8 dependent loads.  k = kSlotBits = 12, the fastest
//   of 8-12 at every shape measured (kernel_probe.py slot-bits: PERF.md)
//   and still small enough for three CTAs an SM.  Each CTA builds
//   its table in the prologue, each symbol writing its own span of slots
//   (ops/decode.py::slot_table is its plain version): a table built by
//   the wrapper cost three more launches and, with a table set per group,
//   a global read of 48 KB per CTA.
// - One block barrier per pixel: the warp counts are double-buffered by
//   pixel parity.  Pixel p + 1 writes the other buffer; pixel p + 2 writes
//   this one after a barrier that every reader of it has passed.  A warp's
//   count is one byte, so one load brings four warps' counts, and one
//   multiply sums them.
// - The loop is rotated so that pixel p - 1's renormalization (the counts,
//   the ring word) and pixel p's prediction share one basic block: the
//   prediction issues while those loads are in flight.
// - Lossless groups (near = 0) run a template instance without the
//   division by the quantizer step.
// Kept: one thread per lane (folding a group's lanes into one warp would
// put all of a step's warp instructions on one scheduler); the state,
// window, carried error and (profile 2) the lane's 12 weights and flag in
// registers; the bias (int16), frequency and cumulative (uint16) tables
// and the two previous rows (uint8, lane fastest: row i is written into
// row i - 2 behind the read frontier, since pixel j reads column j + 3 of
// row i - 2) in shared memory; each lane reads and writes only its own
// column of the rows, so they need no barrier.  The output is (groups,
// th, tw, g), so each pixel's store coalesces across the lanes.
//
// K2' is this kernel with one table set per group (npg = 1): CTA gi
// reads set gi and builds its slot table from it.  The TPU kernel packed
// eight groups onto its 1024-lane axis to spread the core's fixed cost per
// step over 1024 pixels.  Hopper has no such cost to share, and the groups
// share no data, so the port packed them into one CTA only to lose three
// things: SMs (the frame's 24 groups ran on 3 of 132), shared memory (eight
// table sets left no room for the ring, slot table or rows) and barriers
// (two a pixel, and the 8-step search).  That design took 0.717-0.804 ms at
// 288 groups of 16 x 16 and 10.746-10.792 ms at 24 groups of 64 x 64, 2.6x
// and 5.2x K2's time (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W).
// A cluster of eight CTAs would only force them into one GPC: nothing
// crosses between the groups for distributed shared memory to carry.  One
// group a CTA took 0.268 ms (p1) and 0.331 ms (p2) at 288 groups, 77% and
// 68% of the bound, 2.058 ms on the 24 groups and 2.040 ms at g = 48, each
// within 1.1% of K2 in the same call (the same card and script): the
// per-group tables' prologue costs nothing that shows.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "pixel_chain.cuh"

namespace {

constexpr int kTableBytes = 3 * kCtx * 2;  // bias, freq, acc as 16-bit
constexpr int kCountBytes = 32;            // K2: one byte per warp, 32 warps
constexpr int kAhead = 4;                  // pixels from a ring request to its read
constexpr int kSlotBits = 12;              // k: the slot table's bits of lb
constexpr int kSlotPad = 16;               // slot-table entries past 2^k (255)
constexpr int kSlotRow = (1 << kSlotBits) + kSlotPad;  // a row: 16n bytes

// Words of K2's stream ring for groups of g lanes.
__host__ __device__ int ring_words(int g) {
  int rw = 256;
  while (rw < (kAhead + 2) * g + 8) rw <<= 1;
  return rw;
}

// K2's dynamic shared memory: tables | warp counts x 2 | ring | slot table |
// two rows.  Offsets in bytes, each 16-byte aligned.
struct Layout {
  int counts, ring, slots, rows, total;
  __host__ __device__ Layout(int tw, int g) {
    counts = kTableBytes;
    ring = counts + 2 * kCountBytes;
    slots = ring + 4 * ring_words(g);
    rows = slots + kQd * kSlotRow;
    total = rows + 2 * tw * g;
  }
};

// K2: one group per CTA, lane = threadIdx.x.  kFull: g is a multiple of
// 32 and the CTA has g threads.  Otherwise it has ceil(g / 32) warps, and
// the threads at or past g idle: they keep the barriers and ballots, take
// no ballot bit and no word, read no stream word and write nothing; their
// (unused) window reads take lane g - 1's column.  kFull keeps the idle-lane
// guards out of the full-width instance: at g = 128 (two groups of 64 x 64)
// the general instance took 2.02 ms against 1.89 ms for kFull in one run
// (kernel_probe.py k2-width, NVIDIA H100 80GB HBM3, 700.00 W).
template <int kProfile, bool kLossless, bool kFull>
__global__ void group_decode_kernel(
    const int32_t* __restrict__ streams, int W, int pitch,
    const int32_t* __restrict__ n_active, const int32_t* __restrict__ bias,
    const int32_t* __restrict__ hist_n, const int32_t* __restrict__ acc,
    const int32_t* __restrict__ wcols, int npg, int g, int th, int tw, int near,
    uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(tw, g);
  int16_t* bias_s = reinterpret_cast<int16_t*>(smem);
  uint16_t* freq_s = reinterpret_cast<uint16_t*>(smem + 2 * kCtx);
  uint16_t* acc_s = reinterpret_cast<uint16_t*>(smem + 4 * kCtx);
  uint8_t* counts = smem + lay.counts;  // [2][32]: needing lanes per warp
  int32_t* ring = reinterpret_cast<int32_t*>(smem + lay.ring);
  uint8_t* slot_s = smem + lay.slots;
  uint8_t* p1 = smem + lay.rows;  // row i-1
  uint8_t* p2 = p1 + tw * g;      // row i-2, then row i behind the frontier

  const int gi = blockIdx.x;
  const int lane = threadIdx.x;
  const bool live = kFull || lane < g;
  const int col = kFull ? lane : min(lane, g - 1);
  const int nthr = kFull ? g : static_cast<int>(blockDim.x);
  const int set = gi / npg;
  constexpr int shift = 15 - kSlotBits;
  const int rw = ring_words(g);
  const int wend = (W + 3) & ~3;  // words a row of `streams` holds (<= pitch)
  // the tables in 16-byte vectors (the wrapper aligns them)
  const int4* bias4 = reinterpret_cast<const int4*>(bias + set * kCtx);
  const int4* freq4 = reinterpret_cast<const int4*>(hist_n + set * kCtx);
  const int4* acc4 = reinterpret_cast<const int4*>(acc + set * kCtx);
  for (int k = lane; k < kCtx / 4; k += nthr) {
    const int4 bv = bias4[k], fv = freq4[k], av = acc4[k];
    bias_s[4 * k] = static_cast<int16_t>(bv.x);
    bias_s[4 * k + 1] = static_cast<int16_t>(bv.y);
    bias_s[4 * k + 2] = static_cast<int16_t>(bv.z);
    bias_s[4 * k + 3] = static_cast<int16_t>(bv.w);
    freq_s[4 * k] = static_cast<uint16_t>(fv.x);
    freq_s[4 * k + 1] = static_cast<uint16_t>(fv.y);
    freq_s[4 * k + 2] = static_cast<uint16_t>(fv.z);
    freq_s[4 * k + 3] = static_cast<uint16_t>(fv.w);
    acc_s[4 * k] = static_cast<uint16_t>(av.x);
    acc_s[4 * k + 1] = static_cast<uint16_t>(av.y);
    acc_s[4 * k + 2] = static_cast<uint16_t>(av.z);
    acc_s[4 * k + 3] = static_cast<uint16_t>(av.w);
  }
  // The slot table, from the int32 cumulative rows (nondecreasing): symbol
  // v owns the slots b with acc[v] <= b 2^shift < acc[v + 1], v = 0 also
  // those below, v = 255 also those above; so T[b] = #{v >= 1 : acc[v] <=
  // b 2^shift}, as ops/decode.py::slot_table computes it.  Entries 2^k on
  // are 255.
  constexpr int n_slots = 1 << kSlotBits;
  const int32_t* acc_g = acc + set * kCtx;
  for (int k = lane; k < kCtx; k += nthr) {
    const int v = k & 255;
    uint8_t* srow = slot_s + (k >> 8) * kSlotRow;
    auto first = [&](int u) {  // the first slot whose edge reaches acc[u]
      return min((acc_g[k - v + u] + (1 << shift) - 1) >> shift, n_slots);
    };
    int b = v == 0 ? 0 : first(v);
    const int end = v == 255 ? n_slots + kSlotPad : first(v + 1);
    const uint32_t v4 = static_cast<uint32_t>(v) * 0x01010101u;
    for (; b < end && (b & 15); ++b) srow[b] = static_cast<uint8_t>(v);
    for (; b + 16 <= end; b += 16)
      *reinterpret_cast<uint4*>(srow + b) = make_uint4(v4, v4, v4, v4);
    for (; b < end; ++b) srow[b] = static_cast<uint8_t>(v);
  }
  for (int k = lane; k < 2 * kCountBytes; k += nthr) counts[k] = 0;

  int w[kWeights];
  int flag = 0;
  if constexpr (kProfile == 2) {
    const int32_t* wl = wcols + static_cast<size_t>(gi) * kWRows * g + col;
#pragma unroll
    for (int k = 0; k < kWeights; ++k) w[k] = wl[k * g];
    flag = wl[kWeights * g];
  }

  // Head: the lanes' initial states.  The ring takes the words from the
  // 4-word chunk that holds word 2 g - 1 on (2 g - 4 for an even g), so that
  // it holds word W - 1 even where W = 2 g.
  const int32_t* stream = streams + static_cast<size_t>(gi) * pitch;
  uint32_t state = live ? (static_cast<uint32_t>(stream[lane] & 0xFFFF) << 16) |
                              static_cast<uint32_t>(stream[g + lane] & 0xFFFF)
                        : 0u;
  int sp = 2 * g;  // cursor before the pending renormalization
  // words [first chunk, filled) are requested
  int filled = kFull ? 2 * g - 4 : (2 * g - 1) & ~3;
  auto upto = [&](int free_below) {
    // the end of the words whose slots may be taken: those of the words
    // below free_below are free
    return min((free_below + rw - 4) & ~3, wend);
  };
  if (live)
    for (int at = filled + 4 * lane; at < upto(sp); at += 4 * g)
      cp_async16(ring + (at & (rw - 1)), stream + at);
  cp_async_commit();
  filled = upto(sp);
  cp_async_wait<0>();
  __syncthreads();

  const bool active = lane < n_active[gi];  // n_active <= g: idle lanes are inactive
  const int warp = lane >> 5;
  const int n_warps = kFull ? g >> 5 : (g + 31) >> 5;
  const unsigned lanemask_lt = (1u << (lane & 31)) - 1u;
  uint8_t* out_g = out + static_cast<size_t>(gi) * th * tw * g;
  bool need = false;  // the pending renormalization: this lane takes a word
  int rank = 0;       // at cursor + rank + the needing lanes of lower warps
  int par = 0;        // pixel parity: this pixel writes counts[par]

  for (int i = 0; i < th; ++i) {
    Window v = row_start(p1, p2, i, tw, g, col);
    int err = 0;
    for (int j = 0; j < tw; ++j) {
      // pixel p - 1's renormalization, after its barrier: four warps' counts
      // a word, summed bytewise by one multiply (each sum stays below 256)
      const uint32_t* prev =
          reinterpret_cast<const uint32_t*>(counts + kCountBytes * (par ^ 1));
      int base = 0, total = 0;
      for (int k = 0; 4 * k < n_warps; ++k) {
        const uint32_t four = prev[k];
        const int below = min(max(warp - 4 * k, 0), 4);  // of this word's warps
        total += (four * 0x01010101u) >> 24;
        base += below ? ((four << (32 - 8 * below)) * 0x01010101u) >> 24 : 0;
      }
      const int at = min(sp + base + rank, W - 1);
      const uint32_t word = ring[at & (rw - 1)] & 0xFFFF;
      if (need) state = (state << 16) | word;
      const int free_below = sp;  // every thread is past its reads below sp
      sp += total;

      // pixel p
      const int up1 = (i > 0 && j + 2 < tw) ? p1[(j + 2) * g + col] : 0;
      const int up2 = (i > 1 && j + 3 < tw) ? p2[(j + 3) * g + col] : 0;
      const int qd = activity_bin(v, err);
      const int px0 = predict<kProfile>(v, w, flag);
      const int bval = bias_s[context_adr(v, px0, qd)];
      const int sign = (bval >> 3) & 1;  // arithmetic shift, as in the model
      const int px = clampi(px0 + (bval >> 4) + sign, 0, 255);

      // symbol: the last y with acc[qd][y] <= lb, in [T[b], T[b + 1]]
      const uint32_t lb = state & 0x7FFFu;
      const uint8_t* srow = slot_s + qd * kSlotRow;
      const uint16_t* arow = acc_s + qd * 256;
      const int b = static_cast<int>(lb >> shift);
      int y = srow[b];
      int n = srow[b + 1] - y;
      while (n > 0) {
        const int half = (n + 1) >> 1;
        if (arow[y + half] <= lb) {
          y += half;
          n -= half;
        } else {
          n = half - 1;
        }
      }
      state = (state >> 15) * freq_s[qd * 256 + y] + lb - arow[y];
      need = active && state < (1u << 16);
      const unsigned ballot = __ballot_sync(0xFFFFFFFFu, need);
      rank = __popc(ballot & lanemask_lt);
      if ((lane & 31) == 0) counts[kCountBytes * par + warp] = __popc(ballot);

      const int x = unfold<kLossless>(y, px, sign, near);
      err = x - px0;
      if (live) {
        p2[j * g + lane] = static_cast<uint8_t>(x);
        out_g[(static_cast<size_t>(i) * tw + j) * g + lane] = static_cast<uint8_t>(x);
      }
      slide(v, x, i, j, tw, up1, up2);

      // a pixel frees at most g words: one 4-word copy per lane refills
      const int end = upto(free_below);
      const int at_copy = filled + 4 * lane;
      if (live && at_copy < end) cp_async16(ring + (at_copy & (rw - 1)), stream + at_copy);
      cp_async_commit();
      filled = end;
      cp_async_wait<kAhead - 1>();
      __syncthreads();
      par ^= 1;
    }
    uint8_t* t = p1;
    p1 = p2;
    p2 = t;
  }
  cp_async_wait<0>();
}

}  // namespace

// Dynamic shared memory of one K2 CTA: tile width tw, g lanes.
extern "C" long long nbt_group_decode_smem(int tw, int g) {
  return Layout(tw, g).total;
}

// Words of K2's stream ring for groups of g lanes.
extern "C" int nbt_group_decode_ring_words(int g) { return ring_words(g); }

// K2.  streams: (G, pitch) int32 u16 words, W of them live per row, pitch a
// multiple of 4 >= W, 16-byte aligned; n_active: (G,); bias: (B, 3072)
// int32; hist_n/acc: (B, 12, 256) int32, acc nondecreasing along its last
// axis (each CTA builds its slot table from it); the tables 16-byte
// aligned; G = B * npg, CTA gi reading set gi / npg (K2': npg = 1); wcols:
// (G, 16, g) int32 (profile 2; not read at profile 1).  out: (G, th, tw, g)
// uint8.  g: 1..1024; the CTA has ceil(g / 32) x 32 threads, and a g that
// is a multiple of 32 runs the kFull instance.  Launches on `stream`;
// returns cudaGetLastError() after the launch.
extern "C" int nbt_group_decode(const int32_t* streams, int W, int pitch,
                                const int32_t* n_active, const int32_t* bias,
                                const int32_t* hist_n, const int32_t* acc,
                                const int32_t* wcols, int n_groups, int npg,
                                int g, int th, int tw, int near, int profile,
                                uint8_t* out, int device, void* stream) {
  const long long smem = Layout(tw, g).total;
  const bool lossless = near == 0;
  auto pick = [&](auto full) {
    constexpr bool kFull = decltype(full)::value;
    return profile == 2 ? (lossless ? group_decode_kernel<2, true, kFull>
                                    : group_decode_kernel<2, false, kFull>)
                        : (lossless ? group_decode_kernel<1, true, kFull>
                                    : group_decode_kernel<1, false, kFull>);
  };
  auto kernel = g % 32 == 0 ? pick(std::true_type{}) : pick(std::false_type{});
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<n_groups, (g + 31) & ~31, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(streams, W, pitch, n_active, bias,
                                                hist_n, acc, wcols, npg, g, th, tw,
                                                near, out);
  return static_cast<int>(cudaGetLastError());
}
