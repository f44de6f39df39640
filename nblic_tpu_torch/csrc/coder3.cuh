// The profile-3 binary coder, shared by the kernels that code its symbols:
// K4 (p3_decode_walk.cu) decodes them, K8 (p3_row_scan.cu) models and
// codes them for the encoder, K3 (bin_fold.cu) folds K8's slots into rANS
// words.  Each function is the device counterpart of one function of the
// plain versions: ops/rans_bin.py (fold, dec_masked), ops/coder3.py
// (prob_table, mix_prob, row_updates, halve_pairs), ops/zcodec3.py
// (escalated_row, adjust_qv, unary_layers, refine_layers).
//
// A symbol z is an escalating unary walk over a lane's counter rows: layer
// l reads the pair (row escalated l's way, class cls[l]) of the u and the v
// activity row and codes whether the walk goes on past it; a walk still
// going after n_unary layers escapes to z's 8 raw bits.  A walk that stops
// at row r codes k_end = r / k_step refinement bits of z, MSB first, each
// from the pair (r, bit position, whether a higher bit was 1).
//
// Everything but the warp-cooperative events of K4 is __host__ __device__,
// so g++ compiles this header for the CPU tests (tests/test_torch_p3_row_scan.py,
// tests/test_torch_p3_bin_fold.py) as it does udiv64.cuh: K3's
// division-free step is held to the plain fold there.

#pragma once

#include <cstddef>
#include <cstdint>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#endif

#ifndef NBT_HD
#if defined(__CUDACC__)
#define NBT_HD __host__ __device__ __forceinline__
#else
#define NBT_HD inline
#endif
#endif

namespace {

constexpr int kPhases = 16;       // rans_bin.N_PHASE
constexpr int kProbBits = 12;     // rans_bin.PROB_BITS
constexpr int kProbMax = 1 << kProbBits;
constexpr uint32_t kAnsLow = 1u << 16;
constexpr int kBypassP1 = kProbMax / 2;
constexpr int kNRow = 16;         // zcodec3.N_ROW
constexpr int kNRefine = 5;       // zcodec3.N_REFINE
constexpr int kEscapeBits = 8;    // zcodec3.ESCAPE_BITS, strips.L_R
constexpr int kMaxUnary = 20;     // Tune.n_unary's bound
constexpr int kNMap = 20;         // coder3.N_MAP
constexpr int kMapKeys = 512;     // coder3.MAP_KEYS
constexpr int kRefinePairs = kNRow * kNRefine * 2;  // (row, bit position, msb)
constexpr int kQwMax = 32;        // coder3.QW_MAX

NBT_HD int c3_clamp(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// ---- binary rANS

// rans_bin.dec_masked on an active lane: the bin from the state, then the
// renormalization against the lane's stream row, reads clamped to the
// padded matrix's last word.  uint32 arithmetic: (state >> 12) * p < 2^32.
NBT_HD int dec_bin(uint32_t& st, long long& ptr, int p1, const int32_t* row, int wmax) {
  const uint32_t p0 = kProbMax - p1;
  const uint32_t lb = st & (kProbMax - 1);
  const bool one = lb >= p0;
  uint32_t s = (st >> kProbBits) * (one ? p1 : p0) + lb - (one ? p0 : 0);
  if (s < kAnsLow) {
    const long long at = ptr < wmax - 1 ? ptr : wmax - 1;
    s = (s << 16) | static_cast<uint32_t>(row[at]);
    ++ptr;
  }
  st = s;
  return one;
}

// One step of rans_bin.fold, last slot first: a live slot's frequency f
// and offset acc from its 12-bit probability p1 (clipped to [1, 4095]) and
// bin, f = p1 at offset 4096 - p1 (a one) or 4096 - p1 at offset 0; the
// state renormalizes first where it is at or past f << 20 (its low 16 bits
// out, then shifted down 16) and becomes (x / f) << 12 + x % f + acc.  A
// masked slot keeps the state.  A step's word is the state's low 16 bits
// before it, emitted where it renormalized.
struct FoldSlot {
  uint32_t f, acc;
};

NBT_HD FoldSlot fold_operands(int p1, bool one) {
  const uint32_t p = c3_clamp(p1, 1, kProbMax - 1);
  return {one ? p : kProbMax - p, one ? kProbMax - p : 0u};
}

// The live step without its division, for K3's chain: a live slot's
// frequency f in [1, 4095] carries an exact reciprocal (Granlund and
// Montgomery's round-up method): with shift = ceil(log2 f) and magic =
// ceil(2^(32 + shift) / f) - 2^32 (below 2^32), floor(x / f) =
// (umulhi(x, magic) + x) >> shift for every x < 2^32, the sum taken in 64
// bits (it may pass 2^32).  f = 1 and the powers of 2 get magic 0.
struct FoldRecip {
  uint32_t magic;
  int shift;
};

NBT_HD int ceil_log2(uint32_t f) {
#if defined(__CUDA_ARCH__)
  return f <= 1 ? 0 : 32 - __clz(f - 1);
#else
  return f <= 1 ? 0 : 32 - __builtin_clz(f - 1);
#endif
}

NBT_HD FoldRecip fold_recip(uint32_t f) {
  const int shift = ceil_log2(f);
  const uint64_t m = ((uint64_t{1} << (32 + shift)) + f - 1) / f;
  return {static_cast<uint32_t>(m - (uint64_t{1} << 32)), shift};
}

NBT_HD uint32_t umulhi32(uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  return __umulhi(a, b);
#else
  return static_cast<uint32_t>((static_cast<uint64_t>(a) * b) >> 32);
#endif
}

// floor(x / f) by f's reciprocal r.
NBT_HD uint32_t recip_div(uint32_t x, FoldRecip r) {
  const uint64_t t = umulhi32(x, r.magic);
  return static_cast<uint32_t>((t + x) >> r.shift);
}

// One live step of the fold from f, acc and f's reciprocal r: compare,
// shift, multiply-high, multiply-subtract, add.  Sets `emit` where the
// state renormalized.
NBT_HD uint32_t fold_by_recip(uint32_t state, uint32_t f, uint32_t acc, FoldRecip r,
                              uint32_t& emit) {
  emit = state >= (f << (32 - kProbBits));
  const uint32_t x = emit ? state >> 16 : state;
  const uint32_t q = recip_div(x, r);
  return (q << kProbBits) + (x - q * f) + acc;
}

// ---- the counters and the layer walk

// coder3.prob_table / strips._pair_prob of one counter pair (counts >= 1):
// floor(4096 c1 / (c0 + c1)) clipped to [1, 4095].  A 32-bit division
// where c1 < 2^20 and c0 < 2^31 (numerator and sum then fit); a 64-bit one
// past it (cnt_halve up to 65535, a segment as wide as a row).
NBT_HD int pair_prob(const int32_t* pair) {
  const uint32_t c0 = static_cast<uint32_t>(pair[0]), c1 = static_cast<uint32_t>(pair[1]);
  if (c1 < (1u << (32 - kProbBits)) && c0 < (1u << 31))
    return c3_clamp(static_cast<int>((c1 << kProbBits) / (c0 + c1)), 1, kProbMax - 1);
  const uint64_t num = static_cast<uint64_t>(c1) << kProbBits;
  return c3_clamp(static_cast<int>(num / (static_cast<uint64_t>(c0) + c1)), 1, kProbMax - 1);
}

// coder3.mix_prob: the two probabilities interpolated by qw / 32.
NBT_HD int mix_prob(int pu, int pv, int qw) {
  return c3_clamp((pu * (kQwMax - qw) + pv * qw + kQwMax / 2) >> 5, 1, kProbMax - 1);
}

// zcodec3.escalated_row: the context row after `esc` escalations.
NBT_HD int escalated_row(int q, int esc, int k_step) {
  const int up = (q / k_step + esc) * k_step;
  return esc == 0 ? q : (up < kNRow - 1 ? up : kNRow - 1);
}

// zcodec3.adjust_qv: qv collapses to qu where their k differ.
NBT_HD int adjust_qv(int qu, int qv, int k_step) {
  return qv / k_step != qu / k_step ? qu : qv;
}

// The walk's layer constants (zcodec3.layer_consts): per unary layer the
// escalations before it and its counter class.
struct Layers {
  int k_step, n_class, n_unary;
  const int* esc;
  const int* cls;
};

// Unary layer l of the walk of z: its u and v rows and whether the walk
// goes on past it (a one).
struct LayerStep {
  int ru, rv;
  bool go;
};

NBT_HD LayerStep layer_step(const Layers& ly, int l, int qu, int qv2, int z) {
  const int ru = escalated_row(qu, ly.esc[l], ly.k_step);
  return {ru, escalated_row(qv2, ly.esc[l], ly.k_step), ly.cls[l] < (z >> (ru / ly.k_step))};
}

// The counts a layer the walk reached adds (coder3.row_updates): 32 - qw
// to its u pair's count at its bin, qw to its v pair's.  `add(p, v)` adds
// v to *p.
template <class Add>
NBT_HD void add_layer(const Layers& ly, int l, const LayerStep& s, int qw, int32_t* ud, Add add) {
  add(&ud[2 * (s.ru * ly.n_class + ly.cls[l]) + s.go], kQwMax - qw);
  add(&ud[2 * (s.rv * ly.n_class + ly.cls[l]) + s.go], qw);
}

// The count refinement bit kk of z adds, of a walk stopped at row_end with
// k_end bits: its pair (row_end, kk, whether a higher bit below k_end was
// 1), at the bit.
NBT_HD int refine_count(int row_end, int kk, int k_end, int z) {
  const int seen = ((z >> (kk + 1)) & ((1 << (k_end - 1 - kk)) - 1)) != 0;
  return 2 * ((row_end * kNRefine + kk) * 2 + seen) + ((z >> kk) & 1);
}

// coder3.halve_pairs over pairs [t, pairs) in steps of `stride`, after
// adding the events of `delta` where `add` (zeroing them): both counts of
// a pair whose sum passes the threshold become (c + 1) >> 1.  Every pair
// is swept at every update, touched or not: a halving can leave a pair
// past the threshold, and the next update halves it again.
NBT_HD void segment_end(int32_t* tab, int32_t* delta, int pairs, int thresh, bool add, int t,
                        int stride) {
  for (int p = t; p < pairs; p += stride) {
    int c0 = tab[2 * p], c1 = tab[2 * p + 1];
    if (add) {
      c0 += delta[2 * p];
      c1 += delta[2 * p + 1];
      delta[2 * p] = delta[2 * p + 1] = 0;
    }
    if (c0 + c1 > thresh) {
      c0 = (c0 + 1) >> 1;
      c1 = (c1 + 1) >> 1;
    }
    tab[2 * p] = c0;
    tab[2 * p + 1] = c1;
  }
}

#if defined(__CUDACC__)
// The segment's events of one symbol z into the counts (ud: unary pairs
// (row, class) x 2 bins; rd: refine pairs (row, bit position, msb) x 2
// bins), as coder3.row_updates folds zcodec3.unary_layers / refine_layers
// of z, over a warp (K4): thread l takes unary layer l, which the walk
// reaches where no layer before it stopped (two layers, or a layer's u and
// v rows, may share a pair: the adds are atomic), and thread kk
// refinement bit kk; escape bits are never counted.
struct AtomicAdd32 {
  __device__ __forceinline__ void operator()(int32_t* p, int v) const { atomicAdd(p, v); }
};

__device__ __forceinline__ void warp_symbol_events(const Layers& ly, int z, int qu, int qv2,
                                                   int qw, int32_t* ud, int32_t* rd, int t) {
  const bool layer = t < ly.n_unary;
  LayerStep s{0, 0, false};
  if (layer) s = layer_step(ly, t, qu, qv2, z);
  const unsigned stops = __ballot_sync(0xffffffffu, layer && !s.go);
  const int stop = stops ? __ffs(stops) - 1 : ly.n_unary;  // n_unary: escaped
  if (layer && t <= stop) add_layer(ly, t, s, qw, ud, AtomicAdd32{});
  if (stop == ly.n_unary) return;
  const int row_end = escalated_row(qu, ly.esc[stop], ly.k_step);
  const int k_end = row_end / ly.k_step;
  if (t < k_end) rd[refine_count(row_end, t, k_end, z)] += 1;
}
#endif

}  // namespace
