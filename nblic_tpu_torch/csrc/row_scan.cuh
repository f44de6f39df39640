// The profile-3 coding scan of kernel K8 (p3_row_scan.cu), as functions
// that compile for the card and, with g++, for the CPU tests
// (tests/test_torch_p3_row_scan.py runs scan_image on one host thread).
//
// What it computes: nblic_tpu_torch/models/strips.py::_row_scan_plain (the
// lossless encoder's coding scan over rows and column segments) and
// _near_code_plain (the near-lossless encoder's row coder over the feedback
// walk's planes): every slot's 12-bit probability, bin and live mask, each
// (th, n_unary + 8, L, W).  Per pixel: the bias of its context quantized
// from the image's moments (lossless; context.quantize_bias), the
// corrected prediction, the folded residual y and the mapper key (near:
// y and key from the walk), the AutoMapper's rank z of y, and the layer
// walk of z (coder3.cuh) with each slot's probability from the lane's
// counter pairs: the segment-start counts, or under sym_cnt the live ones.
//
// State.  The counter tables are a lane's own; the bias moments (3072 int64
// sums and counts) and the mapper history (512 keys x 20 int64 counts) are
// an image's, shared by its strip lanes.  scan_image runs one image: a
// thread `t` of `stride` takes lanes t, t + stride, ..., and every table is
// swept by all of them.
//
// Phase order, per column segment: (a) each lane walks the segment's
// columns, reading the tables as they stood at the segment's start (the
// bias and the mapper as they stood at the row's start where they update
// a row: seg_bias / seg_map off, and always in the near coder) and keeping
// each pixel's z, y and key; `sync`; (b) each lane adds its events: the
// counters' (re-derived from z; under sym_cnt they were added live), and
// where the mapper or the bias update, their events from the kept y and key
// and the raw error x - px0; `sync`; (c) the sweeps: every counter pair,
// and every mapper key and bias context that updated, halves where past its
// threshold; `sync`.  The adds of (b) are order-free int64 (or int32)
// sums, so atomics give the plain version's values.

#pragma once

#include "coder3.cuh"

namespace {

constexpr int kScanCtx = 3072;    // constants.Q_N_CONTEXT
constexpr int kScanFrac = 4;      // context.BIAS_FRAC_BITS
constexpr int kBiasMax = 1 << 11;  // quantize_bias's clip: [-2048, 2047]

// The scan's constants (ops/row_scan.py::contract).  seg_bias and seg_map
// are the effective ones: on only with more than one segment a row; the
// near coder has neither.
struct ScanContract {
  int near_mode;  // 0: the lossless row scan; 1: the near row coder
  int lanes_per_image, th, w, ws;
  int n_unary, k_step, n_class;
  int seg_bias, seg_map, sym_cnt;
  int cnt_init, cnt_halve, bias_cap, bias_shrink, map_bump, map_halve;
  int esc[kMaxUnary], cls[kMaxUnary];
};

NBT_HD ScanContract scan_contract(const int* v) {
  ScanContract c;
  int* dst[] = {&c.near_mode, &c.lanes_per_image, &c.th, &c.w, &c.ws, &c.n_unary, &c.k_step,
                &c.n_class, &c.seg_bias, &c.seg_map, &c.sym_cnt, &c.cnt_init, &c.cnt_halve,
                &c.bias_cap, &c.bias_shrink, &c.map_bump, &c.map_halve};
  for (int k = 0; k < 17; ++k) *dst[k] = v[k];
  for (int k = 0; k < kMaxUnary; ++k) {
    c.esc[k] = v[17 + k];
    c.cls[k] = v[17 + kMaxUnary + k];
  }
  return c;
}

NBT_HD bool scan_contract_ok(const ScanContract& c, int lanes, int n_imgs) {
  return c.near_mode >= 0 && c.near_mode <= 1 && n_imgs >= 1 && c.lanes_per_image >= 1 &&
         static_cast<long long>(c.lanes_per_image) * n_imgs == lanes && c.th >= 1 &&
         c.ws >= 1 && c.w % c.ws == 0 && c.n_unary >= 1 && c.n_unary <= kMaxUnary &&
         c.k_step >= 1 && c.n_class >= 1 && c.n_class <= 256 && c.cnt_init >= 1 &&
         c.bias_cap >= 1 && c.map_halve >= 1;
}

// The card's memory a scan reads and writes: the planes (P, L, th, W)
// int32 (qu, qv, qw, then x, px0, adr for the lossless scan or y, key for
// the near coder), the slot planes (th, n_unary + 8, L, W), the lanes'
// counter tables (L, 16 n_class 2) and (L, 320) int32, and the lanes' row
// of kept pixels (L, W) int32: z | y << 8 | key << 16.
struct ScanData {
  const int32_t* planes;
  int16_t* probs;
  int8_t* bins;
  uint8_t* masks;
  int32_t* utab;
  int32_t* rtab;
  int32_t* keep;
  int lanes;
};

// An image's shared tables: bias sums and counts (3072 each), the mapper
// history (512 x 20).
struct ImageTables {
  int64_t* bsum;
  int64_t* bcnt;
  int64_t* mhist;
};

struct PlainAdd32 {
  NBT_HD void operator()(int32_t* p, int v) const { *p += v; }
};

// context.quantize_bias of one context: the rounded mean error in 1/16 px,
// half away from zero on magnitudes, the numerator wrapped to int32 as
// nblic_tpu's int32 arithmetic wraps it (|sum| past 2^26), clipped to
// [-2048, 2047].
NBT_HD int quantize_bias(int64_t sum, int64_t cnt, int shrink) {
  const int64_t dn = cnt + shrink;
  const int64_t denom = dn < 1 ? 1 : dn;
  const uint64_t mag_sum =
      sum < 0 ? 0ull - static_cast<uint64_t>(sum) : static_cast<uint64_t>(sum);
  const uint64_t num = (mag_sum << (kScanFrac + 1)) + static_cast<uint64_t>(denom);
  const int64_t wrapped = static_cast<int32_t>(static_cast<uint32_t>(num));
  const int64_t d2 = 2 * denom;
  const int64_t mag = wrapped >= 0 ? wrapped / d2 : -((d2 - 1 - wrapped) / d2);  // floor
  if (cnt <= 0 || sum == 0) return 0;
  const int64_t bias = sum > 0 ? mag : -mag;
  return bias < -kBiasMax ? -kBiasMax
                          : (bias > kBiasMax - 1 ? kBiasMax - 1 : static_cast<int>(bias));
}

// coder3.mapper_ranks at one symbol: the position of y < 20 in the stable
// descending order of its key's 20 counts h.
NBT_HD int mapper_rank(const int64_t* h, int y) {
  const int64_t hy = h[y];
  int z = 0;
  for (int j = 0; j < kNMap; ++j) z += h[j] > hy || (j < y && h[j] == hy);
  return z;
}

// context.residual_fold at near 0: |x - px| sign-interleaved around px in
// [0, 255], the bias's half bit as the preferred sign.
NBT_HD int fold_lossless(int x, int px, int sign) {
  const int ty = px < 255 - px ? px : 255 - px;
  const int y = x >= px ? x - px : px - x;
  const int sy = x >= px;
  return y <= 0 ? 0 : (y <= ty ? 2 * y - (sy ^ sign) : y + ty);
}

// The slots of one symbol z (strips._seg_slots_update): the n_unary unary
// layers, then 5 refinement and 3 pad layers, which carry an escaped
// symbol's 8 raw bits.  Slot l is written at pr / bn / mk + l * step.  ut /
// rt: the lane's counter tables, counted live under `sym` (the read of a
// slot comes before both of its adds).
NBT_HD void code_symbol(const Layers& ly, int z, int qu, int qv2, int qw, int32_t* ut,
                        int32_t* rt, bool sym, int16_t* pr, int8_t* bn, uint8_t* mk,
                        size_t step) {
  bool active = true;
  int row_end = 0;
  for (int l = 0; l < ly.n_unary; ++l) {
    const LayerStep s = layer_step(ly, l, qu, qv2, z);
    const int cu = s.ru * ly.n_class + ly.cls[l], cv = s.rv * ly.n_class + ly.cls[l];
    pr[l * step] =
        static_cast<int16_t>(mix_prob(pair_prob(ut + 2 * cu), pair_prob(ut + 2 * cv), qw));
    bn[l * step] = s.go && active;
    mk[l * step] = active;
    if (active) {
      if (sym) add_layer(ly, l, s, qw, ut, PlainAdd32{});
      if (!s.go) {
        row_end = s.ru;
        active = false;
      }
    }
  }
  const bool escaped = active;  // the walk went on past every layer
  const int k_end = escaped ? 0 : row_end / ly.k_step;
  int msb = 0;
  for (int l = 0; l < kEscapeBits; ++l) {
    const size_t at = (ly.n_unary + l) * step;
    const int esc_bit = (z >> (kEscapeBits - 1 - l)) & 1;
    if (l >= kNRefine || escaped) {
      pr[at] = kBypassP1;
      bn[at] = escaped ? esc_bit : 0;
      mk[at] = escaped;
      continue;
    }
    const int kk = k_end - 1 - l;
    const bool act = kk >= 0;
    const int pair = (row_end * kNRefine + (act ? kk : 0)) * 2 + msb;
    const int bit = act ? (z >> kk) & 1 : 0;
    pr[at] = static_cast<int16_t>(pair_prob(rt + 2 * pair));
    bn[at] = bit;
    mk[at] = act;
    if (sym && act) rt[2 * pair + bit] += 1;
    msb |= bit;
  }
}

NBT_HD Layers scan_layers(const ScanContract& c) {
  return Layers{c.k_step, c.n_class, c.n_unary, c.esc, c.cls};
}

NBT_HD int unary_cells(const ScanContract& c) { return kNRow * c.n_class * 2; }

// Phase (a) of one lane: columns [j0, j1) of row r.
NBT_HD void lane_segment(const ScanContract& c, const ScanData& d, const ImageTables& tb,
                         int lane, int r, int j0, int j1) {
  const Layers ly = scan_layers(c);
  const size_t plane = static_cast<size_t>(d.lanes) * c.th * c.w;
  const int32_t* at = d.planes + (static_cast<size_t>(lane) * c.th + r) * c.w;
  int32_t* ut = d.utab + static_cast<size_t>(lane) * unary_cells(c);
  int32_t* rt = d.rtab + static_cast<size_t>(lane) * 2 * kRefinePairs;
  const size_t step = static_cast<size_t>(d.lanes) * c.w;  // slot l to slot l + 1
  const size_t o = (static_cast<size_t>(r) * (c.n_unary + kEscapeBits) * d.lanes + lane) * c.w;
  for (int j = j0; j < j1; ++j) {
    const int qu = at[j], qv = at[plane + j], qw = at[2 * plane + j];
    int y, key;
    if (c.near_mode) {
      y = at[3 * plane + j];
      key = at[4 * plane + j];
    } else {
      const int x = at[3 * plane + j], px0 = at[4 * plane + j], adr = at[5 * plane + j];
      const int bias = quantize_bias(tb.bsum[adr], tb.bcnt[adr], c.bias_shrink);
      const int sign = (bias >> (kScanFrac - 1)) & 1;  // the half bit
      const int pxc = c3_clamp(px0 + (bias >> kScanFrac) + sign, 0, 255);
      y = fold_lossless(x, pxc, sign);
      key = 2 * pxc + sign;
    }
    const int z = y < kNMap ? mapper_rank(tb.mhist + key * kNMap, y) : y;
    d.keep[static_cast<size_t>(lane) * c.w + j] = z | y << 8 | key << 16;
    code_symbol(ly, z, qu, adjust_qv(qu, qv, c.k_step), qw, ut, rt, c.sym_cnt != 0,
                d.probs + o + j, d.bins + o + j, d.masks + o + j, step);
  }
}

// Phase (b) of one lane: the counters' events of columns [j0, j1) (without
// sym_cnt), the mapper's of [m0, j1) where `map` and the bias moments' of
// [b0, j1) of row r where `bias`.
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <class Add64>
NBT_HD void lane_adds(const ScanContract& c, const ScanData& d, const ImageTables& tb, int lane,
                      int r, int j0, int j1, bool map, int m0, bool bias, int b0, Add64 add64) {
  const size_t plane = static_cast<size_t>(d.lanes) * c.th * c.w;
  const int32_t* at = d.planes + (static_cast<size_t>(lane) * c.th + r) * c.w;
  const int32_t* kept = d.keep + static_cast<size_t>(lane) * c.w;
  if (!c.sym_cnt) {
    const Layers ly = scan_layers(c);
    int32_t* ut = d.utab + static_cast<size_t>(lane) * unary_cells(c);
    int32_t* rt = d.rtab + static_cast<size_t>(lane) * 2 * kRefinePairs;
    for (int j = j0; j < j1; ++j) {
      const int qu = at[j];
      symbol_events(ly, kept[j] & 0xFF, qu, adjust_qv(qu, at[plane + j], c.k_step),
                    at[2 * plane + j], ut, rt, PlainAdd32{});
    }
  }
  if (map) {
    for (int j = m0; j < j1; ++j) {
      const int y = (kept[j] >> 8) & 0xFF;
      if (y < kNMap) add64(&tb.mhist[(kept[j] >> 16) * kNMap + y], c.map_bump);
    }
  }
  if (bias) {
    for (int j = b0; j < j1; ++j) {
      const int adr = at[5 * plane + j];
      add64(&tb.bsum[adr], at[3 * plane + j] - at[4 * plane + j]);
      add64(&tb.bcnt[adr], 1);
    }
  }
}

// Phase (c): the counter tables of the image's lanes, halved where past
// cnt_halve (coder3.halve_pairs); the mapper (coder3.mapper_updates'
// halving: every count of a key whose max passes map_halve, >> 1) and the
// bias moments (strips._bias_update's: both of a context whose count passes
// bias_cap, >> 1) where `map` / `bias`.
NBT_HD void sweep(const ScanContract& c, const ScanData& d, const ImageTables& tb, int lane0,
                  bool map, bool bias, int t, int stride) {
  const int n = c.lanes_per_image;
  segment_end(d.utab + static_cast<size_t>(lane0) * unary_cells(c), nullptr,
              n * unary_cells(c) / 2, c.cnt_halve, false, t, stride);
  segment_end(d.rtab + static_cast<size_t>(lane0) * 2 * kRefinePairs, nullptr,
              n * kRefinePairs, c.cnt_halve, false, t, stride);
  if (map) {
    for (int k = t; k < kMapKeys; k += stride) {
      int64_t* h = tb.mhist + k * kNMap;
      int64_t mx = h[0];
      for (int j = 1; j < kNMap; ++j) mx = h[j] > mx ? h[j] : mx;
      if (mx > c.map_halve)
        for (int j = 0; j < kNMap; ++j) h[j] >>= 1;
    }
  }
  if (bias) {
    for (int k = t; k < kScanCtx; k += stride) {
      if (tb.bcnt[k] > c.bias_cap) {
        tb.bsum[k] >>= 1;
        tb.bcnt[k] >>= 1;
      }
    }
  }
}

// One image's scan: its lanes are img * lanes_per_image onwards.  `sync()`
// is a barrier of the threads that run it (none on one host thread);
// `add64(p, v)` adds v to a shared table's entry (atomic on the card).
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <class Sync, class Add64>
NBT_HD void scan_image(const ScanContract& c, const ScanData& d, const ImageTables& tb, int img,
                       int t, int stride, Sync sync, Add64 add64) {
  const int lane0 = img * c.lanes_per_image, lane1 = lane0 + c.lanes_per_image;
  const int ucells = unary_cells(c);
  for (size_t k = t; k < static_cast<size_t>(c.lanes_per_image) * ucells; k += stride)
    d.utab[static_cast<size_t>(lane0) * ucells + k] = c.cnt_init;
  for (size_t k = t; k < static_cast<size_t>(c.lanes_per_image) * 2 * kRefinePairs; k += stride)
    d.rtab[static_cast<size_t>(lane0) * 2 * kRefinePairs + k] = c.cnt_init;
  for (int k = t; k < kMapKeys * kNMap; k += stride)
    tb.mhist[k] = 2 * (kNMap - 1 - k % kNMap);  // coder3.init_mapper
  for (int k = t; k < kScanCtx; k += stride) tb.bsum[k] = tb.bcnt[k] = 0;
  sync();
  const int n_seg = c.w / c.ws;
  for (int r = 0; r < c.th; ++r) {
    for (int sg = 0; sg < n_seg; ++sg) {
      const int j0 = sg * c.ws, j1 = j0 + c.ws;
      for (int lane = lane0 + t; lane < lane1; lane += stride)
        lane_segment(c, d, tb, lane, r, j0, j1);
      sync();
      const bool row_end = sg == n_seg - 1;
      const bool map = c.seg_map || row_end;
      const bool bias = !c.near_mode && (c.seg_bias || row_end);
      for (int lane = lane0 + t; lane < lane1; lane += stride)
        lane_adds(c, d, tb, lane, r, j0, j1, map, c.seg_map ? j0 : 0, bias,
                  c.seg_bias ? j0 : 0, add64);
      sync();
      sweep(c, d, tb, lane0, map, bias, t, stride);
      sync();
    }
  }
}

}  // namespace
