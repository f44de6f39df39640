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
// pixel_chain.cuh's, the coder's arithmetic (the rANS step, the pair
// probabilities, the layer walk's rows, a symbol's events and the tables'
// halving) coder3.cuh's, which kernel K8 (p3_row_scan.cu) codes with.
//
// State.  What a lane owns stays on the card across launches: the 16
// states and pointers (2, 16, L), the counter tables (L, cells) int32
// (their values stay below 2^28), B and F (L, W, m), the mix chains (L, W,
// 2), the two decoded rows (W, L), and the carry of a row cut into several
// launches (the window and the error (12, L), E (L, m), the mix E (L, 2)).
// What an image's lanes share is read from torch's tensors: the int16 bias
// table and the mapper's order; K4 writes each pixel's bias index and
// error and its mapper key and symbol for the replays that update them.
//
// What bounds K4 on Hopper.  As K5: a pixel's ~500 64-bit divisions of the
// solve and the moments, on a lane's serial chain; the coder adds ~2 x
// (n_unary + 8) counter reads, probabilities and rANS steps a pixel at
// most, and a sweep of the counter tables a segment.  The design is K5's,
// one warp a lane on avp_chain.cuh's warp chain.  The coder is serial by
// nature and runs on the warp's first thread, its symbol shuffled to the
// others: the lane's counter tables are staged in the warp's shared memory
// for the launch (read once, written back once), with the segment's event
// tables beside them (zero at every launch's start and end, since a launch
// holds whole segments); the rANS states too.  A symbol's events and the
// segment end's sweep of the tables run over the warp's threads.  A CTA
// holds up to `warps` warps, fewer where the tables (which grow with near:
// 16 x 256 >> k_max unary pairs) would pass the CTA's shared memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "avp_chain.cuh"
#include "coder3.cuh"

namespace {

constexpr int kMaxWarps = 4;      // warps (lanes) a CTA at most
constexpr int kSmemMax = 232448;  // bytes of shared memory a Hopper CTA may use
constexpr int kCarry = 12;        // the window's 11 registers and the error

// The walk's constants: the replay contract, the escalation step and the
// layer constants of zcodec3.layer_consts (per unary layer: escalations
// before it, its counter class, its bin position).
struct Contract {
  int near, k_step, k_max, n_class, n_unary, ws, cnt_halve, lanes_per_image;
  int sym_cnt, seg_stats, w_pred, mix_e, n_feat;
  int esc[kMaxUnary], cls[kMaxUnary], ival[kMaxUnary];
};

// A warp's shared memory: the chain's scratch, the rANS states and the
// layer constants; the counter tables follow it (table_offset).
template <int kN>
struct DecShared {
  AvpShared<kN> avp;
  long long pt[kPhases];
  uint32_t st[kPhases];
  int esc[kMaxUnary], cls[kMaxUnary], ival[kMaxUnary];
};

template <int kN>
__host__ __device__ constexpr int table_offset() {
  return (static_cast<int>(sizeof(DecShared<kN>)) + 15) & ~15;
}

// Bytes of one warp's shared memory: its DecShared, then the unary and
// refine tables and, without sym_cnt, their segment events.
template <int kN>
int warp_bytes(int n_class, bool sym) {
  const int cells = kNRow * n_class * 2 + 2 * kRefinePairs;
  return table_offset<kN>() + ((4 * cells * (sym ? 1 : 2) + 15) & ~15);
}

// ---- the coder (the warp's first thread; its arithmetic is coder3.cuh's)

// One symbol: the unary walk (layer l reads rows escalated l's way; the
// walk goes on while it decodes ones), then the refinement bits MSB first
// (context: the row, the bit position and whether a higher bit was 1), or
// an escaped symbol's 8 raw bits.  ut / rt: the lane's tables, counted
// live under sym_cnt.  Returns the symbol z.
template <int kN>
__device__ __forceinline__ int decode_symbol(const Contract& c, DecShared<kN>& sh, int32_t* ut,
                                             int32_t* rt, const int32_t* words, size_t row0,
                                             size_t row_step, int wmax, int ph0, int qu, int qv2,
                                             int qw) {
  const bool sym = c.sym_cnt != 0;
  int n_ones = 0;
  bool walking = true;
  for (int l = 0; l < c.n_unary && walking; ++l) {
    const int cu = escalated_row(qu, sh.esc[l], c.k_step) * c.n_class + sh.cls[l];
    const int cv = escalated_row(qv2, sh.esc[l], c.k_step) * c.n_class + sh.cls[l];
    const int p1b = mix_prob(pair_prob(ut + 2 * cu), pair_prob(ut + 2 * cv), qw);
    const int ph = (ph0 + l) & (kPhases - 1);
    const int bin = dec_bin(sh.st[ph], sh.pt[ph], p1b, words + row0 + ph * row_step, wmax);
    if (sym) {  // live counters: the u add, then the v add, in order
      ut[2 * cu + bin] += kNQw - qw;
      ut[2 * cv + bin] += qw;
    }
    n_ones += bin;
    walking = bin;
  }
  const bool escaped = walking;  // every unary bin was a one
  const int stop_layer = min(n_ones, c.n_unary - 1);
  const int stop_row = escalated_row(qu, sh.esc[stop_layer], c.k_step);
  const int k_end = escaped ? 0 : stop_row / c.k_step;
  int z = escaped ? 0 : (sh.ival[stop_layer] >> c.k_max) << k_end;
  int msb = 0;
  const int n_bits = escaped ? kEscapeBits : k_end;
  for (int l = 0; l < n_bits; ++l) {
    const int kk = k_end - 1 - l;
    const int pair = (stop_row * kNRefine + kk) * 2 + msb;
    const int p1b = escaped ? kBypassP1 : pair_prob(rt + 2 * pair);
    const int ph = (ph0 + c.n_unary + l) & (kPhases - 1);
    const int bin = dec_bin(sh.st[ph], sh.pt[ph], p1b, words + row0 + ph * row_step, wmax);
    if (sym && !escaped) rt[2 * pair + bin] += 1;
    msb |= bin;
    if (bin) z += escaped ? 1 << (kEscapeBits - 1 - l) : 1 << kk;
  }
  return z;
}

// K4, row i, columns [c0, c1) (whole segments of c.ws): warp `lane` walks
// its strip.  words: (16, lanes, wmax) int32 u16 words; rans: (2, 16,
// lanes) int64 states then pointers; utab: (lanes, 16 n_class 2) int32
// unary counts; rtab: (lanes, 320) the refine ones; b, f: (lanes, W, m)
// int64; bm, fm: (lanes, W, 2) under mix_e; carry: (12, lanes) int32 window
// and error, ecar: (lanes, m) and emcar: (lanes, 2) int64 E, kept between
// the launches of a row; p1 / p2: (W, lanes) uint8 rows i-1 and i-2, row i
// written into p2 behind the read frontier; bias: (images, 3072) int16;
// order: (images, 512, 20) int64; out: (W, lanes) uint8, row i; rep: (4,
// W, lanes) int64 each pixel's image x 3072 + context address, x - px0,
// mapper key and symbol y.  Each warp's shared memory is `wbytes` long.
template <int kN>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
    p3_decode_kernel(const int32_t* __restrict__ words, int wmax, int64_t* __restrict__ rans,
                     int32_t* __restrict__ utab, int32_t* __restrict__ rtab,
                     int64_t* __restrict__ b, int64_t* __restrict__ f,
                     int64_t* __restrict__ bm, int64_t* __restrict__ fm,
                     int32_t* __restrict__ carry, int64_t* __restrict__ ecar,
                     int64_t* __restrict__ emcar, uint8_t* p1, uint8_t* p2,
                     const int16_t* __restrict__ bias, const int64_t* __restrict__ order,
                     uint8_t* __restrict__ out, int64_t* __restrict__ rep, int lanes, int w,
                     int i, int c0, int c1, int wbytes, Contract c) {
  constexpr int kS = avp_slots<kN>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x % kWarp, wid = threadIdx.x / kWarp;
  const int lane = blockIdx.x * (blockDim.x / kWarp) + wid;
  if (lane >= lanes) return;  // the whole warp: its barriers are its own
  unsigned char* mine = smem + static_cast<size_t>(wid) * wbytes;
  DecShared<kN>& sh = *reinterpret_cast<DecShared<kN>*>(mine);
  const size_t n_l = static_cast<size_t>(lanes);
  const int n = kN == kNTaps ? c.n_feat : kN;  // the general instance's count
  const int m = avp_m(n);
  const long long img = lane / c.lanes_per_image;
  const int16_t* btab = bias + img * kCtx;
  const int64_t* otab = order + img * kMapKeys * kNMap;
  const size_t plane = static_cast<size_t>(w) * n_l;
  const int l_tot = c.n_unary + kEscapeBits;
  const int n_ucells = kNRow * c.n_class * 2;
  const bool mix = c.mix_e != 0, sym = c.sym_cnt != 0;
  // Built here, not at its one call: ptxas then gives <12> 168 registers
  // (a spill of 60 B) instead of 196, and it runs faster at many lanes
  // (kernel_probe.py p3-decode-feat).
  const Layers layers{c.k_step, c.n_class, c.n_unary, sh.esc, sh.cls};

  // the lane's tables into shared memory, the event tables zeroed
  int32_t* ut = reinterpret_cast<int32_t*>(mine + table_offset<kN>());
  int32_t* rt = ut + n_ucells;
  int32_t* ud = rt + 2 * kRefinePairs;
  int32_t* rd = ud + n_ucells;
  int32_t* ut_g = utab + lane * static_cast<size_t>(n_ucells);
  int32_t* rt_g = rtab + lane * static_cast<size_t>(2 * kRefinePairs);
  for (int k = t; k < n_ucells; k += kWarp) ut[k] = ut_g[k];
  for (int k = t; k < 2 * kRefinePairs; k += kWarp) rt[k] = rt_g[k];
  if (!sym) {
    for (int k = t; k < n_ucells + 2 * kRefinePairs; k += kWarp) ud[k] = 0;
  }
  if (t < kPhases) {
    sh.st[t] = static_cast<uint32_t>(rans[t * n_l + lane]);
    sh.pt[t] = rans[(kPhases + t) * n_l + lane];
  }
  if (t == 0) {
#pragma unroll
    for (int k = 0; k < kMaxUnary; ++k) {
      sh.esc[k] = c.esc[k];
      sh.cls[k] = c.cls[k];
      sh.ival[k] = c.ival[k];
    }
  }

  int64_t* bl = b + static_cast<size_t>(lane) * w * m;
  int64_t* fl = f + static_cast<size_t>(lane) * w * m;
  int64_t* bml = mix ? bm + static_cast<size_t>(lane) * w * 2 : nullptr;
  int64_t* fml = mix ? fm + static_cast<size_t>(lane) * w * 2 : nullptr;
  const Slots<kN> sl = slots_of<kN>(t, n);
  int64_t e[kS], ef[kS];
  int64_t em[2];
  Window v;
  int err;
  if (c0 == 0) {  // the row's first launch: F from the previous row's B
    warp_f_chain<kS, kBeta, kAlpha>(bl, fl, w, m, t);
    if (mix && t < 2) warp_f_chain<1, kBeta, kBeta>(bml, fml, w, 2, t);
#pragma unroll
    for (int s = 0; s < kS; ++s) e[s] = 0;
    em[0] = em[1] = 0;
    v = row_start(p1, p2, i, w, lanes, lane);
    err = 0;
  } else {
    load_col(ecar + static_cast<size_t>(lane) * m, m, t, e);
    em[0] = emcar[2 * static_cast<size_t>(lane)];
    em[1] = emcar[2 * static_cast<size_t>(lane) + 1];
    int r[kCarry];
#pragma unroll
    for (int k = 0; k < kCarry; ++k) r[k] = carry[k * n_l + lane];
    v = Window{r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7], r[8], r[9], r[10]};
    err = r[11];
  }
  __syncwarp();  // the staged tables and the mix F, read by every thread
  int64_t bc[kS], fc[kS];
  load_col(bl + static_cast<size_t>(c0) * m, m, t, bc);
  load_col(fl + static_cast<size_t>(c0) * m, m, t, fc);

  for (int j0 = c0; j0 < c1; j0 += c.ws) {
    // the segment-frozen statistics: E at the segment's start
    int wq = 0;
    bool ok_seg = false;
    int64_t s0_seg = 0;
    if (c.seg_stats) {
#pragma unroll
      for (int s = 0; s < kS; ++s) ef[s] = e[s];
      if (c.w_pred) {  // one solve and one weight quantization a segment
        s0_seg = warp_system<kN>(ef, fc, sl, sh.avp, n);
        __syncwarp();
        int64_t num;
        ok_seg = warp_solve<kN>(sh.avp, t, num, n);
        if (t < n) wq = quantize_weight(sh.avp.a[t][t], num);
      }
    }
    for (int j = j0; j < j0 + c.ws; ++j) {
      // column j + 1's B and F, in flight while pixel j runs
      int64_t bn[kS], fn[kS];
      load_col(bl + static_cast<size_t>(j + 1) * m, j + 1 < c1 ? m : 0, t, bn);
      load_col(fl + static_cast<size_t>(j + 1) * m, j + 1 < c1 ? m : 0, t, fn);
      const size_t at = static_cast<size_t>(j) * n_l + lane;
      const int up1 = (i > 0 && j + 2 < w) ? p1[at + 2 * n_l] : 0;
      const int up2 = (i > 1 && j + 3 < w) ? p2[at + 3 * n_l] : 0;
      const int px_s = simple_predict(v);
      const int feat = t < n ? avp_feature<kN>(v, (i >= 1 && j + 2 < w) ? up1 : v.d, t) : 0;
      if (t < kN) sh.avp.feat[t] = feat;

      // ---- the prediction
      int px0, px_hard = px_s;
      int64_t s0;
      int64_t bmc[2] = {0, 0};
      if (c.w_pred) {
        const int p = warp_predict_wq(wq, feat);
        px0 = ok_seg ? p : px_s;
        s0 = s0_seg;
        __syncwarp();  // the features, read by every thread
      } else {
        int64_t stats[kS];
#pragma unroll
        for (int s = 0; s < kS; ++s) stats[s] = c.seg_stats ? ef[s] : e[s];
        s0 = warp_system<kN>(stats, fc, sl, sh.avp, n);  // channel 0 of the statistics
        __syncwarp();
        int64_t num;
        const bool ok = warp_solve<kN>(sh.avp, t, num, n);
        const int64_t px_f = warp_predict<kN>(sh.avp, num, feat, t, n);
        px_hard = ok ? round_px(px_f) : px_s;
        px0 = px_hard;
        if (mix) {
          bmc[0] = bml[2 * j];
          bmc[1] = bml[2 * j + 1];
          if (ok)
            px0 = mix_blend(px_hard, px_s, wadd(em[0], fml[2 * j]), wadd(em[1], fml[2 * j + 1]));
        }
        if (c.seg_stats) decay_stats(ef, t);  // E' of the next column
      }

      const int delta = activity(v, err);
      int qu, qv, qw;
      n_quantize_activity(delta, qu, qv, qw);
      const int adr = context_adr(v, px0, quantize_activity(delta));
      int sign, pxc, key;
      pixel_correct(px0, btab[adr], sign, pxc, key);

      // ---- the symbol, on the warp's first thread
      const int qv2 = (qv / c.k_step != qu / c.k_step) ? qu : qv;  // zcodec3.adjust_qv
      int z = 0;
      if (t == 0) {
        const int ph0 = static_cast<int>(((static_cast<long long>(i) * w + j) * l_tot) & 15);
        z = decode_symbol<kN>(c, sh, ut, rt, words, lane * static_cast<size_t>(wmax),
                              n_l * wmax, wmax, ph0, qu, qv2, qw);
      }
      z = __shfl_sync(kFull, z, 0);

      // ---- the AutoMapper's order, the unfold and the chains
      const int y = z < kNMap ? static_cast<int>(otab[key * kNMap + z]) : z;
      const int x = unfold<false>(y, pxc, sign, c.near);
      err = clampi(x - px0, -kMaxPxInc, kMaxPxInc);
      warp_update<kN>(x, px_s, s0, sh.avp.feat, sl, e, bc, bl + static_cast<size_t>(j) * m, t);
      if (mix) mix_update(x, px_hard, px_s, em, bmc);
      if (!sym) warp_symbol_events(layers, z, qu, qv2, qw, ud, rd, t);
      if (t == 0) {
        if (mix) {
          bml[2 * j] = bmc[0];
          bml[2 * j + 1] = bmc[1];
        }
        out[at] = static_cast<uint8_t>(x);
        p2[at] = static_cast<uint8_t>(x);
        rep[at] = img * kCtx + adr;
        rep[plane + at] = x - px0;
        rep[2 * plane + at] = key;
        rep[3 * plane + at] = y;
      }
      slide(v, x, i, j, w, up1, up2);
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        bc[s] = bn[s];
        fc[s] = fn[s];
      }
      __syncwarp();  // the pixel's reads of shared memory before the next writes
    }
    // the segment's end: the counters take its events (live under
    // sym_cnt) and halve
    segment_end(ut, ud, n_ucells / 2, c.cnt_halve, !sym, t, kWarp);
    segment_end(rt, rd, kRefinePairs, c.cnt_halve, !sym, t, kWarp);
    __syncwarp();
  }

  for (int k = t; k < n_ucells; k += kWarp) ut_g[k] = ut[k];
  for (int k = t; k < 2 * kRefinePairs; k += kWarp) rt_g[k] = rt[k];
  if (t < kPhases) {
    rans[t * n_l + lane] = sh.st[t];
    rans[(kPhases + t) * n_l + lane] = sh.pt[t];
  }
  if (c1 < w) {  // the row goes on in another launch
    int64_t* el = ecar + static_cast<size_t>(lane) * m;
#pragma unroll
    for (int s = 0; s < kS; ++s)
      if (s * kWarp + t < m) el[s * kWarp + t] = e[s];
    if (t == 0) {
      emcar[2 * static_cast<size_t>(lane)] = em[0];
      emcar[2 * static_cast<size_t>(lane) + 1] = em[1];
      const int r[kCarry] = {v.a, v.b, v.c, v.d, v.e, v.f, v.gg, v.h, v.q, v.r, v.s, err};
#pragma unroll
      for (int k = 0; k < kCarry; ++k) carry[k * n_l + lane] = r[k];
    }
  }
}

template <int kN>
int launch(const int32_t* words, int wmax, int64_t* rans, int32_t* ut, int32_t* rt, int64_t* b,
           int64_t* f, int64_t* bm, int64_t* fm, int32_t* carry, int64_t* e, int64_t* em,
           uint8_t* p1, uint8_t* p2, const int16_t* bias, const int64_t* order, uint8_t* out,
           int64_t* rep, int lanes, int w, int i, int c0, int c1, const Contract& c, int warps,
           cudaStream_t s) {
  const int wbytes = warp_bytes<kN>(c.n_class, c.sym_cnt != 0);
  const int fit = kSmemMax / wbytes;  // >= 1: a warp's tables take 68 KB at most
  warps = warps < fit ? warps : fit;
  const int bytes = warps * wbytes;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        p3_decode_kernel<kN>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned ctas = static_cast<unsigned>((lanes + warps - 1) / warps);
  p3_decode_kernel<kN><<<ctas, warps * kWarp, bytes, s>>>(
      words, wmax, rans, ut, rt, b, f, bm, fm, carry, e, em, p1, p2, bias, order, out, rep,
      lanes, w, i, c0, c1, wbytes, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4, row i, columns [c0, c1).  Arrays as p3_decode_kernel's, each on
// `device`, contiguous; bm / fm null without mix_e; contract: the host's
// 73 ints (near, k_step, k_max, n_class, n_unary, ws,
// cnt_halve, lanes_per_image, sym_cnt, seg_stats, w_pred, mix_e, n_feat,
// then the n_unary-long esc, cls and ival, each padded to 20).  n_feat 10
// and 6 have instances of their own, any other count in 1..12 the general
// one.  Launches CTAs of up to `warps` (1..4) warps, one a lane, on
// `stream`; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a contract or a warp count out of range).
extern "C" int nbt_p3_decode_segment(const int32_t* words, int wmax, int64_t* rans, int32_t* ut,
                                     int32_t* rt, int64_t* b, int64_t* f, int64_t* bm,
                                     int64_t* fm, int32_t* carry, int64_t* e, int64_t* em,
                                     uint8_t* p1, uint8_t* p2, const int16_t* bias,
                                     const int64_t* order, uint8_t* out, int64_t* rep,
                                     int lanes, int w, int i, int c0, int c1,
                                     const int* contract, int warps, int device, void* stream) {
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
      c.k_step < 1 || c.ws < 1 || c.lanes_per_image < 1 || (c.mix_e && bm == nullptr) ||
      c.n_class < 1 || c.n_class > 256 || warps < 1 || warps > kMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  if (c.n_feat == 10)
    return launch<10>(words, wmax, rans, ut, rt, b, f, bm, fm, carry, e, em, p1, p2, bias, order,
                      out, rep, lanes, w, i, c0, c1, c, warps, s);
  if (c.n_feat == 6)
    return launch<6>(words, wmax, rans, ut, rt, b, f, bm, fm, carry, e, em, p1, p2, bias, order,
                     out, rep, lanes, w, i, c0, c1, c, warps, s);
  return launch<kNTaps>(words, wmax, rans, ut, rt, b, f, bm, fm, carry, e, em, p1, p2, bias,
                        order, out, rep, lanes, w, i, c0, c1, c, warps, s);
}
