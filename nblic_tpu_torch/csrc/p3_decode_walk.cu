// The profile-3 decode walk: kernel K4.
//
// K4 replaces no pallas_call: the JAX package runs this walk,
// nblic_tpu/models/strips.py::_decode_seg, as a jitted lax.scan over rows,
// column segments and columns that XLA compiles.  Its plain version is
// nblic_tpu_torch/models/strips.py::_decode_walk_plain, a Python loop over
// the th x W pixel steps with hundreds of small launches each.  One launch
// computes one row of the walk, or one column segment of it where the
// contract replays an image's shared state a segment (seg_bias, seg_map),
// for every strip lane; the loop, the bias table's quantization, the
// mapper's order and both of their updates stay in torch
// (strips._decode_walk_card), since an image's lanes meet only there.
//
// A lane at row i, columns [c0, c1): at the row's first launch (c0 = 0)
// the F chain, the previous row's B accumulated right to left (and the mix
// chain's under mix_e), into the scratch f; then its pixels in order, a
// column segment of ws at a time.  Per pixel: the causal window over the
// decoded pixels and the t tap; the prediction (the AVP ridge solve of E +
// F, under mix_e its blend with the simple prediction; under seg_stats the
// solve of E frozen at the segment start and decay-extended, under w_pred
// one solve a segment into quantized weights); the dual-bin activity
// quantizers and the context address; the image's bias; the symbol: up to
// n_unary unary bins and then up to 8 refinement or escape bits, each read
// from phase (base + l) % 16 of the lane's 16 binary rANS states
// (ops/rans_bin.py::dec_masked) with the probability of its counter pair
// (ops/coder3.py: prob_table, mix_prob; under sym_cnt the live counts);
// the AutoMapper's order, the near-aware unfold, the error clip; then B's
// column, E, the mix chains and the window take the pixel.  At a segment's
// end the counter tables take its events and halve (coder3.row_updates,
// halve_pairs).  The AVP chain is avp_chain.cuh's, the window and contexts
// pixel_chain.cuh's.
//
// State.  What a lane owns stays on the card in K4's layout across
// launches, lanes fastest in every array: the 16 states and pointers, the
// counter tables (int32; their values stay below 2^28) and, without
// sym_cnt, a delta table of each that gathers the segment's events, B, F,
// the mix chains, the two decoded rows, and the carry of a row cut into
// several launches (the window, the error, E).  What an image's lanes
// share is read from torch's tensors: the int16 bias table and the
// mapper's order; K4 writes each pixel's bias index and error and its
// mapper key and symbol for the replays that update them.
//
// What bounds K4 on Hopper.  As K5: a pixel's ~500 runtime 64-bit
// divisions of the solve and the moments, on a lane's serial chain; the
// coder adds ~2 x (n_unary + 8) counter reads, probabilities and rANS
// steps a pixel at most, and a sweep of the counter tables a segment.  The
// design is the simple one: one thread a lane, one warp a CTA, no shared
// memory and no barrier.

#include <cstdint>
#include <cuda_runtime.h>

#include "avp_chain.cuh"

namespace {

constexpr int kDecLanes = 32;     // lanes a CTA: one warp
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
constexpr int kCarry = 12;        // the window's 11 registers and the error

// The walk's constants: the replay contract, the escalation step and the
// layer constants of zcodec3.layer_consts (per unary layer: escalations
// before it, its counter class, its bin position).
struct Contract {
  int near, k_step, k_max, n_class, n_unary, ws, cnt_halve, lanes_per_image;
  int sym_cnt, seg_stats, w_pred, mix_e, n_feat;
  int esc[kMaxUnary], cls[kMaxUnary], ival[kMaxUnary];
};

// ---- the coder

// rans_bin.dec_masked on an active lane: the bin from the state, then the
// renormalization against the lane's stream row, reads clamped to the
// padded matrix's last word.  uint32 arithmetic: (state >> 12) * p < 2^32.
__device__ __forceinline__ int dec_bin(uint32_t& st, long long& ptr, int p1,
                                       const int32_t* row, int wmax) {
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

// coder3.prob_table / strips._pair_prob of one counter pair (counts >= 1):
// floor(4096 c1 / (c0 + c1)) clipped to [1, 4095].
__device__ __forceinline__ int pair_prob(const int32_t* pair, size_t lanes) {
  const uint64_t c0 = static_cast<uint32_t>(pair[0]), c1 = static_cast<uint32_t>(pair[lanes]);
  return clampi(static_cast<int>((c1 << kProbBits) / (c0 + c1)), 1, kProbMax - 1);
}

// coder3.mix_prob: the two probabilities interpolated by qw / 32.
__device__ __forceinline__ int mix_prob(int pu, int pv, int qw) {
  return clampi((pu * (kNQw - qw) + pv * qw + kNQw / 2) >> 5, 1, kProbMax - 1);
}

// zcodec3.escalated_row: the context row after `esc` escalations.
__device__ __forceinline__ int escalated_row(int q, int esc, int k_step) {
  return esc == 0 ? q : min((q / k_step + esc) * k_step, kNRow - 1);
}

// The segment's events of one decoded symbol z into the delta tables, as
// coder3.row_updates folds zcodec3.unary_layers / refine_layers of z:
// re-derived from z, not from the bins read (a garbage stream's bins need
// not be z's).  ud: unary pairs (row, class) x 2 bins; rd: refine pairs
// (row, bit position, msb) x 2 bins; both lanes-strided.
__device__ __forceinline__ void symbol_events(const Contract& c, int z, int qu, int qv2, int qw,
                                              int32_t* ud, int32_t* rd, size_t lanes) {
  int row_end = 0;
  bool escaped = true;
  for (int l = 0; l < c.n_unary; ++l) {
    const int ru = escalated_row(qu, c.esc[l], c.k_step);
    const int rv = escalated_row(qv2, c.esc[l], c.k_step);
    const int go = c.cls[l] < (z >> (ru / c.k_step));
    ud[(2 * (ru * c.n_class + c.cls[l]) + go) * lanes] += kNQw - qw;
    ud[(2 * (rv * c.n_class + c.cls[l]) + go) * lanes] += qw;
    if (!go) {
      row_end = ru;
      escaped = false;
      break;
    }
  }
  const int k_end = escaped ? 0 : row_end / c.k_step;  // <= 5 = N_REFINE
  int seen = 0;
  for (int l = 0; l < k_end; ++l) {
    const int kk = k_end - 1 - l;
    const int bit = (z >> kk) & 1;
    rd[(2 * ((row_end * kNRefine + kk) * 2 + seen) + bit) * lanes] += 1;
    seen |= bit;
  }
}

// A segment's end: the events into the table (`add`, without sym_cnt),
// then coder3.halve_pairs: both counts of a pair whose sum passes the
// threshold become (c + 1) >> 1.
__device__ __forceinline__ void segment_end(int32_t* tab, int32_t* delta, int pairs,
                                            size_t lanes, int thresh, bool add) {
  for (int p = 0; p < pairs; ++p) {
    int32_t* t = tab + 2 * p * lanes;
    int c0 = t[0], c1 = t[lanes];
    if (add) {
      int32_t* d = delta + 2 * p * lanes;
      c0 += d[0];
      c1 += d[lanes];
      d[0] = d[lanes] = 0;
    }
    if (c0 + c1 > thresh) {
      c0 = (c0 + 1) >> 1;
      c1 = (c1 + 1) >> 1;
    }
    t[0] = c0;
    t[lanes] = c1;
  }
}

// K4, row i, columns [c0, c1) (whole segments of c.ws): thread `lane`
// walks its strip.  words: (16, lanes, wmax) int32 u16 words; rans: (2,
// 16, lanes) int64 states then pointers; ut / ud: (16 n_class 2, lanes)
// int32 unary counts and their segment deltas; rt / rd: (320, lanes) the
// refine ones; b, f: (W, m, lanes) int64; bm, fm: (W, 2, lanes) under
// mix_e; carry: (12, lanes) int32 window and error, e: (m, lanes) and em:
// (2, lanes) int64 E, kept between the launches of a row; p1 / p2: (W,
// lanes) uint8 rows i-1 and i-2, row i written into p2 behind the read
// frontier; bias: (images, 3072) int16; order: (images, 512, 20) int64;
// out: (W, lanes) uint8, row i; rep: (4, W, lanes) int64 each pixel's
// image x 3072 + context address, x - px0, mapper key and symbol y.
template <int kN>
__global__ void __launch_bounds__(kDecLanes)
    p3_decode_kernel(const int32_t* __restrict__ words, int wmax, int64_t* __restrict__ rans,
                     int32_t* __restrict__ ut, int32_t* __restrict__ ud,
                     int32_t* __restrict__ rt, int32_t* __restrict__ rd,
                     int64_t* __restrict__ b, int64_t* __restrict__ f,
                     int64_t* __restrict__ bm, int64_t* __restrict__ fm,
                     int32_t* __restrict__ carry, int64_t* __restrict__ ecar,
                     int64_t* __restrict__ emcar, uint8_t* p1, uint8_t* p2,
                     const int16_t* __restrict__ bias, const int64_t* __restrict__ order,
                     uint8_t* __restrict__ out, int64_t* __restrict__ rep, int lanes, int w,
                     int i, int c0, int c1, Contract c) {
  constexpr int kM = avp_m<kN>();
  const int lane = blockIdx.x * kDecLanes + threadIdx.x;
  if (lane >= lanes) return;  // no barrier follows: an idle thread writes nothing
  const size_t n_l = static_cast<size_t>(lanes);
  const int n = kN == kNTaps ? c.n_feat : kN;  // the general instance's count
  const int m = avp_m(n);
  const long long img = lane / c.lanes_per_image;
  const int16_t* btab = bias + img * kCtx;
  const int64_t* otab = order + img * kMapKeys * kNMap;
  const size_t plane = static_cast<size_t>(w) * n_l;
  const int l_tot = c.n_unary + kEscapeBits;
  const int n_upairs = kNRow * c.n_class;
  const bool mix = c.mix_e != 0, sym = c.sym_cnt != 0;

  int64_t e[kM], ef[kM];
  int64_t em[2];
  Window v;
  int err;
  if (c0 == 0) {  // the row's first launch: F from the previous row's B
    f_chain<kM, kBeta, kAlpha>(b + lane, f + lane, w, n_l, e, m);
    if (mix) f_chain<2, kBeta, kBeta>(bm + lane, fm + lane, w, n_l, em);
    for (int k = 0; k < m; ++k) e[k] = 0;
    em[0] = em[1] = 0;
    v = row_start(p1, p2, i, w, lanes, lane);
    err = 0;
  } else {
    for (int k = 0; k < m; ++k) e[k] = ecar[k * n_l + lane];
    em[0] = emcar[lane];
    em[1] = emcar[n_l + lane];
    int r[kCarry];
    for (int k = 0; k < kCarry; ++k) r[k] = carry[k * n_l + lane];
    v = Window{r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7], r[8], r[9], r[10]};
    err = r[11];
  }
  uint32_t st[kPhases];
  long long pt[kPhases];
  for (int k = 0; k < kPhases; ++k) {
    st[k] = static_cast<uint32_t>(rans[k * n_l + lane]);
    pt[k] = rans[(kPhases + k) * n_l + lane];
  }
  int32_t* utl = ut + lane;
  int32_t* udl = ud + lane;
  int32_t* rtl = rt + lane;
  int32_t* rdl = rd + lane;

  for (int j0 = c0; j0 < c1; j0 += c.ws) {
    // the segment-frozen statistics: E at the segment's start
    int wq[kN];
    bool ok_seg = false;
    int64_t s0_seg = 0;
    if (c.seg_stats) {
      for (int k = 0; k < m; ++k) ef[k] = e[k];
      if (c.w_pred) {  // one solve and one weight quantization a segment
        const size_t col = static_cast<size_t>(j0) * m * n_l + lane;
        int64_t a[kN][kN + 1];
        ridge_system<kN>(ef, f + col, n_l, a, n);
        s0_seg = wadd(ef[0], f[col]);
        ok_seg = ridge_solve<kN>(a, n);
        for (int k = 0; k < n; ++k) wq[k] = quantize_weight(a[k][k], a[k][n]);
      }
    }
    for (int j = j0; j < j0 + c.ws; ++j) {
      const size_t at = static_cast<size_t>(j) * n_l + lane;
      const int up1 = (i > 0 && j + 2 < w) ? p1[at + 2 * n_l] : 0;
      const int up2 = (i > 1 && j + 3 < w) ? p2[at + 3 * n_l] : 0;
      const int px_s = simple_predict(v);
      int feat[kN];
      avp_features<kN>(v, (i >= 1 && j + 2 < w) ? up1 : v.d, feat, n);

      // ---- the prediction
      const size_t col = static_cast<size_t>(j) * m * n_l + lane;  // channel k at + k * n_l
      int px0, px_hard = px_s;
      int64_t s0;
      if (c.w_pred) {
        px0 = ok_seg ? predict_wq<kN>(wq, feat, n) : px_s;
        s0 = s0_seg;
      } else {
        const int64_t* stats = c.seg_stats ? ef : e;
        int64_t a[kN][kN + 1];
        ridge_system<kN>(stats, f + col, n_l, a, n);
        s0 = wadd(stats[0], f[col]);  // channel 0 of the pixel's statistics
        const bool ok = ridge_solve<kN>(a, n);
        px_hard = ok ? round_px(predict_from_solve<kN>(a, feat, n)) : px_s;
        px0 = px_hard;
        if (mix && ok) {
          const size_t mcol = static_cast<size_t>(j) * 2 * n_l + lane;
          px0 = mix_blend(px_hard, px_s, wadd(em[0], fm[mcol]), wadd(em[1], fm[mcol + n_l]));
        }
        if (c.seg_stats) decay_stats(ef, m);  // E' of the next column
      }

      const int delta = activity(v, err);
      int qu, qv, qw;
      n_quantize_activity(delta, qu, qv, qw);
      const int adr = context_adr(v, px0, quantize_activity(delta));
      int sign, pxc, key;
      pixel_correct(px0, btab[adr], sign, pxc, key);

      // ---- the symbol.  The unary walk: layer l reads rows escalated l's
      // way; a lane walks on while it decodes ones
      const int ph0 = static_cast<int>(((static_cast<long long>(i) * w + j) * l_tot) & 15);
      const int qv2 = (qv / c.k_step != qu / c.k_step) ? qu : qv;  // zcodec3.adjust_qv
      int n_ones = 0;
      bool walking = true;
      for (int l = 0; l < c.n_unary && walking; ++l) {
        const int cu = escalated_row(qu, c.esc[l], c.k_step) * c.n_class + c.cls[l];
        const int cv = escalated_row(qv2, c.esc[l], c.k_step) * c.n_class + c.cls[l];
        const int p1b = mix_prob(pair_prob(utl + 2 * cu * n_l, n_l),
                                 pair_prob(utl + 2 * cv * n_l, n_l), qw);
        const int ph = (ph0 + l) & (kPhases - 1);
        const int bin = dec_bin(st[ph], pt[ph], p1b, words + (ph * n_l + lane) * wmax, wmax);
        if (sym) {  // live counters: the u add, then the v add, in order
          utl[(2 * cu + bin) * n_l] += kNQw - qw;
          utl[(2 * cv + bin) * n_l] += qw;
        }
        n_ones += bin;
        walking = bin;
      }
      const bool escaped = walking;  // every unary bin was a one
      const int stop_layer = min(n_ones, c.n_unary - 1);
      const int stop_row = escalated_row(qu, c.esc[stop_layer], c.k_step);
      const int k_end = escaped ? 0 : stop_row / c.k_step;
      int z = escaped ? 0 : (c.ival[stop_layer] >> c.k_max) << k_end;
      // refinement bits MSB first (context: the row, the bit position and
      // whether a higher bit was 1), or an escaped symbol's 8 raw bits
      int msb = 0;
      const int n_bits = escaped ? kEscapeBits : k_end;
      for (int l = 0; l < n_bits; ++l) {
        const int kk = k_end - 1 - l;
        const int pair = (stop_row * kNRefine + kk) * 2 + msb;
        const int p1b = escaped ? kBypassP1 : pair_prob(rtl + 2 * pair * n_l, n_l);
        const int ph = (ph0 + c.n_unary + l) & (kPhases - 1);
        const int bin = dec_bin(st[ph], pt[ph], p1b, words + (ph * n_l + lane) * wmax, wmax);
        if (sym && !escaped) rtl[(2 * pair + bin) * n_l] += 1;
        msb |= bin;
        if (bin) z += escaped ? 1 << (kEscapeBits - 1 - l) : 1 << kk;
      }

      // ---- the AutoMapper's order, the unfold and the chains
      const int y = z < kNMap ? static_cast<int>(otab[key * kNMap + z]) : z;
      const int x = unfold<false>(y, pxc, sign, c.near);
      err = clampi(x - px0, -kMaxPxInc, kMaxPxInc);
      avp_update<kN>(x, px_s, feat, s0, e, b + col, n_l, n);
      if (mix)
        mix_update(x, px_hard, px_s, em, bm + static_cast<size_t>(j) * 2 * n_l + lane, n_l);
      if (!sym) symbol_events(c, z, qu, qv2, qw, udl, rdl, n_l);

      out[at] = static_cast<uint8_t>(x);
      p2[at] = static_cast<uint8_t>(x);
      rep[at] = img * kCtx + adr;
      rep[plane + at] = x - px0;
      rep[2 * plane + at] = key;
      rep[3 * plane + at] = y;
      slide(v, x, i, j, w, up1, up2);
    }
    // the segment's end: the counters take its events (live under
    // sym_cnt) and halve
    segment_end(utl, udl, n_upairs, n_l, c.cnt_halve, !sym);
    segment_end(rtl, rdl, kRefinePairs, n_l, c.cnt_halve, !sym);
  }

  for (int k = 0; k < kPhases; ++k) {
    rans[k * n_l + lane] = st[k];
    rans[(kPhases + k) * n_l + lane] = pt[k];
  }
  if (c1 < w) {  // the row goes on in another launch
    for (int k = 0; k < m; ++k) ecar[k * n_l + lane] = e[k];
    emcar[lane] = em[0];
    emcar[n_l + lane] = em[1];
    const int r[kCarry] = {v.a, v.b, v.c, v.d, v.e, v.f, v.gg, v.h, v.q, v.r, v.s, err};
    for (int k = 0; k < kCarry; ++k) carry[k * n_l + lane] = r[k];
  }
}

}  // namespace

// K4, row i, columns [c0, c1).  Arrays as p3_decode_kernel's, each on
// `device`, contiguous; bm / fm null without mix_e; contract: the host's
// 73 ints (near, k_step, k_max, n_class, n_unary, ws,
// cnt_halve, lanes_per_image, sym_cnt, seg_stats, w_pred, mix_e, n_feat,
// then the n_unary-long esc, cls and ival, each padded to 20).  n_feat 10
// and 6 have instances of their own, any other count in 1..12 the general
// one.  Launches ceil(lanes / 32) CTAs of 32 threads on `stream`; returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// contract out of range).
extern "C" int nbt_p3_decode_segment(const int32_t* words, int wmax, int64_t* rans, int32_t* ut,
                                     int32_t* ud, int32_t* rt, int32_t* rd, int64_t* b,
                                     int64_t* f, int64_t* bm, int64_t* fm, int32_t* carry,
                                     int64_t* e, int64_t* em, uint8_t* p1, uint8_t* p2,
                                     const int16_t* bias, const int64_t* order, uint8_t* out,
                                     int64_t* rep, int lanes, int w, int i, int c0, int c1,
                                     const int* contract, int device, void* stream) {
  Contract c;
  int* dst[] = {&c.near, &c.k_step, &c.k_max, &c.n_class, &c.n_unary, &c.ws, &c.cnt_halve,
                &c.lanes_per_image, &c.sym_cnt, &c.seg_stats, &c.w_pred, &c.mix_e, &c.n_feat};
  for (int k = 0; k < 13; ++k) *dst[k] = contract[k];
  for (int k = 0; k < kMaxUnary; ++k) {
    c.esc[k] = contract[13 + k];
    c.cls[k] = contract[13 + kMaxUnary + k];
    c.ival[k] = contract[13 + 2 * kMaxUnary + k];
  }
  if (c.n_feat < 1 || c.n_feat > kNTaps || c.n_unary < 1 || c.n_unary > kMaxUnary ||
      c.k_step < 1 || c.ws < 1 || c.lanes_per_image < 1 || (c.mix_e && bm == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  const unsigned ctas = static_cast<unsigned>((lanes + kDecLanes - 1) / kDecLanes);
#define NBT_K4_LAUNCH(KN)                                                                      \
  p3_decode_kernel<KN><<<ctas, kDecLanes, 0, s>>>(words, wmax, rans, ut, ud, rt, rd, b, f, bm, \
                                                  fm, carry, e, em, p1, p2, bias, order, out,  \
                                                  rep, lanes, w, i, c0, c1, c)
  if (c.n_feat == 10)
    NBT_K4_LAUNCH(10);
  else if (c.n_feat == 6)
    NBT_K4_LAUNCH(6);
  else
    NBT_K4_LAUNCH(kNTaps);
#undef NBT_K4_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
