// The profile-3 coding scan of kernel K8 (p3_row_scan.cu), as functions
// that compile for the card and, with g++, for the CPU tests
// (tests/test_torch_p3_row_scan.py runs scan_image with a team of virtual
// threads, one after another between barriers, each ballot a loop).
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
// an image's, shared by its strip lanes.  Each table carries a bit an
// entry (its marks), set on an entry past its threshold: by the add that
// takes it past (a counter pair's two counts are added as one 64-bit
// word, so the add sees the pair's sum), or by the last sweep that left it
// past.  Counts only grow between sweeps, so that is every entry a sweep
// halves.
//
// Phase order, per column segment, each phase ended by a barrier of the
// image's team: (a) the walk, reading the tables as they stood at the
// segment's start (the bias and the mapper as they stood at the row's
// start where they update a row: seg_bias / seg_map off, and always in the
// near coder).  Without sym_cnt every read of a segment sees that state,
// so the segment's lanes_per_image x ws pixels are independent tasks.
// Where they are at most one a warp (one lane: 16 pixels, 16 warps), a
// warp takes a pixel: its fixed work (bias, y, key) on every thread, the
// rank by a ballot over the 20 counts, the slots one a thread (layer l's
// bit depends on z alone, the stop layer is the first stop of one ballot,
// the refinement and escape slots follow from the stop row and z), and
// each thread keeps its layer's events for (b).  With more, a thread takes
// a pixel and its slots one after another.  Under sym_cnt a slot reads the
// live counts, so a lane's pixels stay in order on one thread.  (b) the
// adds: the counters' events (from the warp's kept events, or re-derived a
// thread a pixel from the kept z; under sym_cnt added live in (a) and only
// checked here), and where the mapper or the bias update, their events
// from the kept y and key and the raw error x - px0, a thread a pixel.
// Order-free int32 and wrapping int64 sums, so atomics give the plain
// version's values.  (c) the sweeps: every marked counter pair, and every
// marked mapper key and bias context where they updated, halves, and
// keeps its mark only if still past its threshold: the plain version's
// sweep of every entry.  The image tables' atomics, adds and sweeps and
// the bias quantizer are image_tables.cuh's, with which kernel K9 replays
// the decoder's tables.

#pragma once

#include "image_tables.cuh"

namespace {

constexpr int kScanCtx = kContexts;
constexpr int kScanFrac = kBiasFrac;
constexpr int kWarp = 32;  // a pixel's n_unary + 8 <= 28 slots fit a warp

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
// counter tables (L, 16 n_class 2) and (L, 320) int32 and their marks (L,
// counter_words), used where the counters do not fit the CTA's shared
// memory, and the lanes' row of kept pixels (L, W) int32: z | y << 8 |
// key << 16.
struct ScanData {
  const int32_t* planes;
  int16_t* probs;
  int8_t* bins;
  uint8_t* masks;
  int32_t* utab;
  int32_t* rtab;
  uint32_t* umark;
  int32_t* keep;
  int lanes;
};

// An image's shared tables: bias sums and counts (3072 each), the mapper
// history (512 x 20), their marks (a bit a context, a bit a key), and the
// walk's layer constants (kLayerConsts ints from `consts` on: esc and cls
// copied from the contract, as each thread of a warp reads its own layer's,
// which the kernel's parameter space would serve one address at a time;
// kq[q] = q / k_step and rows[l][q] = escalated_row(q, esc[l], k_step) for
// the 16 activity levels q, so that a layer's rows, its quotient and
// adjust_qv cost a load, not a division).
constexpr int kLayerConsts = 2 * kMaxUnary + kNRow + kMaxUnary * kNRow;

struct ImageTables {
  int64_t* bsum;
  int64_t* bcnt;
  int64_t* mhist;
  uint32_t* bmark;
  uint32_t* mmark;
  int* consts;
  NBT_HD int* esc() const { return consts; }
  NBT_HD int* cls() const { return consts + kMaxUnary; }
  NBT_HD int* kq() const { return consts + 2 * kMaxUnary; }
  NBT_HD int* rows() const { return consts + 2 * kMaxUnary + kNRow; }
};

NBT_HD int unary_cells(const ScanContract& c) { return kNRow * c.n_class * 2; }
NBT_HD int counter_pairs(const ScanContract& c) { return kNRow * c.n_class + kRefinePairs; }
NBT_HD int counter_words(const ScanContract& c) { return (counter_pairs(c) + 31) / 32; }

// The counter tables of an image's lanes, lane li at u + li * ucells, r +
// li * 2 kRefinePairs, mark + li * words: the CTA's shared memory, or the
// scratch tensors from the image's first lane on.  A lane's pair e is a
// unary pair below 16 n_class, a refinement pair from there.
struct LaneTables {
  int32_t* u;
  int32_t* r;
  uint32_t* mark;
  int ucells, words;
  NBT_HD int32_t* ut(int li) const { return u + static_cast<size_t>(li) * ucells; }
  NBT_HD int32_t* rt(int li) const { return r + static_cast<size_t>(li) * 2 * kRefinePairs; }
  NBT_HD uint32_t* marks(int li) const { return mark + static_cast<size_t>(li) * words; }
};

// Where a CTA keeps the lanes' counters: their tables and marks in its
// shared memory, the marks alone there, or neither.
enum Placement { kDeviceCounters = 0, kSharedMarks = 1, kSharedCounters = 2 };

// Shared memory of one CTA, in bytes from its start: the mapper history,
// the bias moments (lossless only), the image tables' marks, the layer
// constants, then the lanes' counter tables and their marks as `placement`
// has them.  Every offset is a multiple of 8.
struct ScanLayout {
  size_t mhist, bsum, bcnt, mmark, bmark, consts, u, r, umark, bytes;
};

NBT_HD ScanLayout scan_layout(const ScanContract& c, int placement) {
  ScanLayout s;
  s.mhist = 0;
  s.bsum = s.mhist + sizeof(int64_t) * kMapKeys * kNMap;
  const size_t bias = c.near_mode ? 0 : sizeof(int64_t) * kScanCtx;
  s.bcnt = s.bsum + bias;
  s.mmark = s.bcnt + bias;
  s.bmark = s.mmark + sizeof(uint32_t) * kMapKeys / 32;
  s.consts = s.bmark + sizeof(uint32_t) * kScanCtx / 32;
  s.u = s.consts + sizeof(int) * kLayerConsts;
  const size_t lanes = c.lanes_per_image;
  const size_t tables = placement == kSharedCounters ? lanes : 0;
  s.r = s.u + sizeof(int32_t) * tables * unary_cells(c);
  s.umark = s.r + sizeof(int32_t) * tables * 2 * kRefinePairs;
  s.bytes = s.umark + (placement != kDeviceCounters ? sizeof(uint32_t) * lanes * counter_words(c)
                                                    : 0);
  return s;
}

struct PlainAdd32 {
  NBT_HD void operator()(int32_t* p, int v) const { *p += v; }
};

// context.residual_fold at near 0: |x - px| sign-interleaved around px in
// [0, 255], the bias's half bit as the preferred sign.
NBT_HD int fold_lossless(int x, int px, int sign) {
  const int ty = px < 255 - px ? px : 255 - px;
  const int y = x >= px ? x - px : px - x;
  const int sy = x >= px;
  return y <= 0 ? 0 : (y <= ty ? 2 * y - (sy ^ sign) : y + ty);
}

NBT_HD Layers scan_layers(const ScanContract& c, const ImageTables& tb) {
  return Layers{c.k_step, c.n_class, c.n_unary, tb.esc(), tb.cls()};
}

// layer_step and adjust_qv by the layer tables.
NBT_HD LayerStep scan_step(const ImageTables& tb, int l, int qu, int qv2, int z) {
  const int ru = tb.rows()[l * kNRow + qu];
  return {ru, tb.rows()[l * kNRow + qv2], tb.cls()[l] < (z >> tb.kq()[ru])};
}

NBT_HD int scan_adjust_qv(const ImageTables& tb, int qu, int qv) {
  return tb.kq()[qv] != tb.kq()[qu] ? qu : qv;
}

// The segment's events of one symbol z into the counts (ud: unary pairs
// (row, class) x 2 bins; rd: refine pairs (row, bit position, msb) x 2
// bins), as coder3.row_updates folds zcodec3.unary_layers / refine_layers
// of z: every layer the walk reaches, every refinement bit; escape bits
// are never counted.  One thread, the rows by the layer tables.
template <class Add>
NBT_HD void scan_events(const Layers& ly, const ImageTables& tb, int z, int qu, int qv2, int qw,
                        int32_t* ud, int32_t* rd, Add add) {
  for (int l = 0; l < ly.n_unary; ++l) {
    const LayerStep s = scan_step(tb, l, qu, qv2, z);
    add_layer(ly, l, s, qw, ud, add);
    if (!s.go) {
      const int k_end = tb.kq()[s.ru];
      for (int kk = 0; kk < k_end; ++kk) add(&rd[refine_count(s.ru, kk, k_end, z)], 1);
      return;
    }
  }
}

// A pixel's fixed work: its symbol's contexts, y and key.
struct PixelIn {
  int qu, qv2, qw, y, key;
};

NBT_HD PixelIn pixel_in(const ScanContract& c, const ScanData& d, const ImageTables& tb, int lane,
                        int r, int j) {
  const size_t plane = static_cast<size_t>(d.lanes) * c.th * c.w;
  const int32_t* at = d.planes + (static_cast<size_t>(lane) * c.th + r) * c.w + j;
  PixelIn p;
  p.qu = at[0];
  p.qv2 = scan_adjust_qv(tb, p.qu, at[plane]);
  p.qw = at[2 * plane];
  if (c.near_mode) {
    p.y = at[3 * plane];
    p.key = at[4 * plane];
  } else {
    const int x = at[3 * plane], px0 = at[4 * plane], adr = at[5 * plane];
    const int bias = quantize_bias(tb.bsum[adr], tb.bcnt[adr], c.bias_shrink);
    const int sign = (bias >> (kScanFrac - 1)) & 1;  // the half bit
    const int pxc = c3_clamp(px0 + (bias >> kScanFrac) + sign, 0, 255);
    p.y = fold_lossless(x, pxc, sign);
    p.key = 2 * pxc + sign;
  }
  return p;
}

NBT_HD uint32_t slot_word(int prob, int bin, bool mask) {
  return static_cast<uint32_t>(prob & 0xFFFF) | static_cast<uint32_t>(bin) << 16 |
         static_cast<uint32_t>(mask) << 17;
}

// Slot l's value at (r, l, lane, j) of the slot planes.
NBT_HD void store_slot(const ScanContract& c, const ScanData& d, int r, int l, int lane, int j,
                       uint32_t v) {
  const size_t o = ((static_cast<size_t>(r) * (c.n_unary + kEscapeBits) + l) * d.lanes + lane) *
                       c.w + j;
  d.probs[o] = static_cast<int16_t>(v & 0xFFFF);
  d.bins[o] = (v >> 16) & 1;
  d.masks[o] = (v >> 17) & 1;
}

// Unary layer l of symbol z (its step s: rows and whether the walk goes
// on past it): its probability from the counts in ut.
struct Unary {
  int prob;
  bool go;
};

NBT_HD Unary unary_slot(const Layers& ly, int l, const LayerStep& s, const PixelIn& p,
                        const int32_t* ut) {
  const int cu = s.ru * ly.n_class + ly.cls[l], cv = s.rv * ly.n_class + ly.cls[l];
  return {mix_prob(pair_prob(ut + 2 * cu), pair_prob(ut + 2 * cv), p.qw), s.go};
}

// The layer the walk stops at: the lowest set bit of `stops` (layer l's
// bit set where its walk stops), n_unary where none is (escaped).
NBT_HD int stop_layer(uint32_t stops, int n_unary) {
#if defined(__CUDA_ARCH__)
  return stops ? __ffs(stops) - 1 : n_unary;
#else
  return stops ? __builtin_ctz(stops) : n_unary;
#endif
}

// Slot l of a symbol z whose walk stops at layer `stop` (strips.
// _seg_slots_update): a unary layer l < n_unary (`u` its own) is live where
// no layer before it stopped; then the 5 refinement and 3 pad layers: a
// stopped walk's k_end = row_end / k_step refinement bits of z, MSB first,
// each read from the pair (row_end, bit, whether a bit above it was 1), or
// an escaped symbol's 8 raw bits at the bypass probability.
NBT_HD uint32_t symbol_slot(const Layers& ly, const ImageTables& tb, int l, int stop,
                            const Unary& u, const PixelIn& p, int z, const int32_t* rt) {
  if (l < ly.n_unary) {
    const bool act = l <= stop;
    return slot_word(u.prob, u.go && act, act);
  }
  const int e = l - ly.n_unary;
  const bool escaped = stop == ly.n_unary;
  if (e >= kNRefine || escaped)
    return slot_word(kBypassP1, escaped ? (z >> (kEscapeBits - 1 - e)) & 1 : 0, escaped);
  const int row_end = tb.rows()[stop * kNRow + p.qu];
  const int k_end = tb.kq()[row_end];
  const int kk = k_end - 1 - e;
  const bool act = kk >= 0;
  const int above = act ? e : k_end;  // the bits coded before this slot
  const int msb = ((z >> (k_end - above)) & ((1 << above) - 1)) != 0;
  const int pair = (row_end * kNRefine + (act ? kk : 0)) * 2 + msb;
  return slot_word(pair_prob(rt + 2 * pair), act ? (z >> kk) & 1 : 0, act);
}

// The slots of symbol z (strips._seg_slots_update, without sym_cnt) on one
// host thread as a warp codes them: the warp's threads one after another,
// the ballot of the stop layer their loop.  Slot t at out[t * step],
// thread t's layer step at s[t]; returns the stop layer.
NBT_HD int code_pixel_host(const Layers& ly, const ImageTables& tb, const PixelIn& p, int z,
                           const int32_t* ut, const int32_t* rt, LayerStep* s, uint32_t* out,
                           size_t step) {
  Unary u[kMaxUnary];
  uint32_t stops = 0;
  for (int t = 0; t < ly.n_unary; ++t) {
    s[t] = scan_step(tb, t, p.qu, p.qv2, z);
    u[t] = unary_slot(ly, t, s[t], p, ut);
    stops |= static_cast<uint32_t>(!s[t].go) << t;
  }
  const int stop = stop_layer(stops, ly.n_unary);
  for (int t = 0; t < ly.n_unary + kEscapeBits; ++t)
    out[t * step] = symbol_slot(ly, tb, t, stop, u[t < ly.n_unary ? t : 0], p, z, rt);
  return stop;
}

// The slots of one symbol z (strips._seg_slots_update) on one thread, each
// read from the lane's live counts and, under `sym`, added to them before
// the next read: the order sym_cnt needs.  Slot l is written at pr / bn /
// mk + l * step.
NBT_HD void code_symbol(const Layers& ly, const ImageTables& tb, int z, const PixelIn& p,
                        int32_t* ut, int32_t* rt, bool sym, int16_t* pr, int8_t* bn, uint8_t* mk,
                        size_t step) {
  bool active = true;
  int row_end = 0;
  for (int l = 0; l < ly.n_unary; ++l) {
    const LayerStep s = scan_step(tb, l, p.qu, p.qv2, z);
    pr[l * step] = static_cast<int16_t>(unary_slot(ly, l, s, p, ut).prob);
    bn[l * step] = s.go && active;
    mk[l * step] = active;
    if (active) {
      if (sym) add_layer(ly, l, s, p.qw, ut, PlainAdd32{});
      if (!s.go) {
        row_end = s.ru;
        active = false;
      }
    }
  }
  const bool escaped = active;  // the walk went on past every layer
  const int k_end = escaped ? 0 : tb.kq()[row_end];
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

// Phase (a) under sym_cnt: one lane's columns [j0, j1) of row r in order,
// on one thread.
NBT_HD void lane_segment(const ScanContract& c, const ScanData& d, const ImageTables& tb,
                         const LaneTables& lt, int lane0, int lane, int r, int j0, int j1) {
  const Layers ly = scan_layers(c, tb);
  const size_t step = static_cast<size_t>(d.lanes) * c.w;  // slot l to slot l + 1
  const size_t o = (static_cast<size_t>(r) * (c.n_unary + kEscapeBits) * d.lanes + lane) * c.w;
  for (int j = j0; j < j1; ++j) {
    const PixelIn p = pixel_in(c, d, tb, lane, r, j);
    const int z = p.y < kNMap ? mapper_rank(tb.mhist + p.key * kNMap, p.y) : p.y;
    d.keep[static_cast<size_t>(lane) * c.w + j] = z | p.y << 8 | p.key << 16;
    code_symbol(ly, tb, z, p, lt.ut(lane - lane0), lt.rt(lane - lane0), true, d.probs + o + j,
                d.bins + o + j, d.masks + o + j, step);
  }
}

// A segment without sym_cnt goes a pixel a warp where its pixel tasks are
// at most one a warp (a pixel's latency is then what a warp waits for),
// else a pixel a thread (the warps' issue binds: kernel_probe.py
// p3-scan-phases times both at one lane, the th-64 corpus and the near-2
// coder).
NBT_HD bool warp_pixels(const ScanContract& c, int n_warps) {
  return !c.sym_cnt && static_cast<long long>(c.lanes_per_image) * c.ws <= n_warps;
}

// Phase (a) a pixel a thread, thread t of `n`: task = lane of the image x
// ws + column in the segment.
NBT_HD void pixel_tasks(const ScanContract& c, const ScanData& d, const ImageTables& tb,
                        const LaneTables& lt, int lane0, int r, int j0, int t, int n) {
  const Layers ly = scan_layers(c, tb);
  const size_t step = static_cast<size_t>(d.lanes) * c.w;  // slot l to slot l + 1
  for (int task = t; task < c.lanes_per_image * c.ws; task += n) {
    const int li = task / c.ws, lane = lane0 + li, j = j0 + task % c.ws;
    const size_t o =
        (static_cast<size_t>(r) * (c.n_unary + kEscapeBits) * d.lanes + lane) * c.w + j;
    const PixelIn p = pixel_in(c, d, tb, lane, r, j);
    const int z = p.y < kNMap ? mapper_rank(tb.mhist + p.key * kNMap, p.y) : p.y;
    d.keep[static_cast<size_t>(lane) * c.w + j] = z | p.y << 8 | p.key << 16;
    code_symbol(ly, tb, z, p, lt.ut(li), lt.rt(li), false, d.probs + o, d.bins + o, d.masks + o,
                step);
  }
}

// Thread t's share of a pixel's events, kept from the walk a pixel a warp
// for (b): unary layer t's two cells and bin where the walk reached it
// (cu < 0: not reached), refinement bit t's count cell (refine_count; -1:
// none).  li < 0: the thread's warp had no pixel.
struct SlotEvents {
  int li, cu, cv, bin, qw, rcell;
};

NBT_HD SlotEvents slot_events(const Layers& ly, const ImageTables& tb, int t, int stop,
                              const LayerStep& s, const PixelIn& p, int z, int li) {
  SlotEvents ev{li, -1, -1, s.go, p.qw, -1};
  if (t < ly.n_unary && t <= stop) {
    ev.cu = s.ru * ly.n_class + ly.cls[t];
    ev.cv = s.rv * ly.n_class + ly.cls[t];
  }
  if (stop < ly.n_unary) {
    const int row_end = tb.rows()[stop * kNRow + p.qu];
    const int k_end = tb.kq()[row_end];
    if (t < k_end) ev.rcell = refine_count(row_end, t, k_end, z);
  }
  return ev;
}

// Phase (a) a pixel a warp on the host: the warp's threads one after
// another, each ballot their loop; `ev` gets the warp's threads' events.
NBT_HD void walk_pixel_host(const ScanContract& c, const ScanData& d, const ImageTables& tb,
                            const LaneTables& lt, int lane0, int r, int j0, int task,
                            SlotEvents* ev) {
  const Layers ly = scan_layers(c, tb);
  const int li = task / c.ws, lane = lane0 + li, j = j0 + task % c.ws;
  const PixelIn p = pixel_in(c, d, tb, lane, r, j);
  const int z = p.y < kNMap ? mapper_rank(tb.mhist + p.key * kNMap, p.y) : p.y;
  LayerStep s[kWarp] = {};
  uint32_t v[kWarp];
  const int stop = code_pixel_host(ly, tb, p, z, lt.ut(li), lt.rt(li), s, v, 1);
  for (int t = 0; t < c.n_unary + kEscapeBits; ++t) store_slot(c, d, r, t, lane, j, v[t]);
  d.keep[static_cast<size_t>(lane) * c.w + j] = z | p.y << 8 | p.key << 16;
  for (int t = 0; t < kWarp; ++t) ev[t] = slot_events(ly, tb, t, stop, s[t], p, z, li);
}

#if defined(__CUDACC__)
// Phase (a) a pixel a warp on the card: thread t of the warp taking pixel
// task `task`; returns its events.
__device__ __forceinline__ SlotEvents walk_pixel_device(const ScanContract& c,
                                                        const ScanData& d,
                                                        const ImageTables& tb,
                                                        const LaneTables& lt, int lane0, int r,
                                                        int j0, int task, int t) {
  const Layers ly = scan_layers(c, tb);
  const int li = task / c.ws, lane = lane0 + li, j = j0 + task % c.ws;
  const PixelIn p = pixel_in(c, d, tb, lane, r, j);
  const int z = p.y < kNMap
                    ? __popc(__ballot_sync(0xffffffffu,
                                           rank_vote(tb.mhist + p.key * kNMap, p.y, t)))
                    : p.y;
  LayerStep s{0, 0, false};
  Unary u{0, false};
  if (t < c.n_unary) {
    s = scan_step(tb, t, p.qu, p.qv2, z);
    u = unary_slot(ly, t, s, p, lt.ut(li));
  }
  const int stop = stop_layer(__ballot_sync(0xffffffffu, t < c.n_unary && !s.go), c.n_unary);
  if (t < c.n_unary + kEscapeBits)
    store_slot(c, d, r, t, lane, j, symbol_slot(ly, tb, t, stop, u, p, z, lt.rt(li)));
  if (t == 0) d.keep[static_cast<size_t>(lane) * c.w + j] = z | p.y << 8 | p.key << 16;
  return slot_events(ly, tb, t, stop, s, p, z, li);
}
#endif

// scan_events' adder: the event's count added (unless `only_mark`:
// already added, under sym_cnt) and its pair marked where its sum is past
// the threshold.
template <class At>
struct CounterAdd {
  int32_t* ud;
  int32_t* rd;
  uint32_t* mark;
  int unary_pairs, thresh;
  bool only_mark;
  At at;
  NBT_HD void operator()(int32_t* p, int v) const {
    const ptrdiff_t du = p - ud;
    const bool unary = du >= 0 && du < 2 * unary_pairs;
    const int e = unary ? static_cast<int>(du / 2) : unary_pairs + static_cast<int>((p - rd) / 2);
    int32_t* pair = unary ? ud + 2 * e : rd + 2 * (e - unary_pairs);
    const long long sum = only_mark ? static_cast<long long>(pair[0]) + pair[1]
                                    : at.add_pair(pair, static_cast<int>(p - pair), v);
    if (sum > thresh) at.set(mark + e / 32, 1u << (e % 32));
  }
};

template <class At>
NBT_HD CounterAdd<At> counter_add(const ScanContract& c, const LaneTables& lt, int li, At at) {
  return {lt.ut(li), lt.rt(li), lt.marks(li), kNRow * c.n_class, c.cnt_halve, c.sym_cnt != 0,
          at};
}

// Phase (b)'s counters from a thread's kept events (the walk a pixel a
// warp).
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <class At>
NBT_HD void add_events(const ScanContract& c, const LaneTables& lt, const SlotEvents& ev, At at) {
  if (ev.li < 0) return;
  const CounterAdd<At> add = counter_add(c, lt, ev.li, at);
  if (ev.cu >= 0) {
    add(lt.ut(ev.li) + 2 * ev.cu + ev.bin, kQwMax - ev.qw);
    add(lt.ut(ev.li) + 2 * ev.cv + ev.bin, ev.qw);
  }
  if (ev.rcell >= 0) add(lt.rt(ev.li) + ev.rcell, 1);
}

// Phase (b)'s counters a thread a pixel, thread t of `n`: the events of
// columns [j0, j1) of row r re-derived from the kept z (added, or under
// sym_cnt checked only).
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <class At>
NBT_HD void counter_events(const ScanContract& c, const ScanData& d, const ImageTables& tb,
                           const LaneTables& lt, int lane0, int r, int j0, int j1, int t, int n,
                           At at) {
  const size_t plane = static_cast<size_t>(d.lanes) * c.th * c.w;
  const Layers ly = scan_layers(c, tb);
  for (int task = t, ws = j1 - j0; task < c.lanes_per_image * ws; task += n) {
    const int li = task / ws, j = j0 + task % ws;
    const size_t px = (static_cast<size_t>(lane0 + li) * c.th + r) * c.w + j;
    const int qu = d.planes[px];
    scan_events(ly, tb, d.keep[static_cast<size_t>(lane0 + li) * c.w + j] & 0xFF, qu,
                scan_adjust_qv(tb, qu, d.planes[plane + px]), d.planes[2 * plane + px],
                lt.ut(li), lt.rt(li), counter_add(c, lt, li, at));
  }
}

// Phase (b)'s shared tables, thread t of `n`: the mapper's events of
// columns [m0, j1) of row r where `map`, the bias moments' of [b0, j1)
// where `bias`, a thread a pixel, each key or context marked where its add
// takes it past its threshold.
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <class At>
NBT_HD void table_adds(const ScanContract& c, const ScanData& d, const ImageTables& tb, int lane0,
                       int r, int j1, bool map, int m0, bool bias, int b0, int t, int n, At at) {
  const size_t plane = static_cast<size_t>(d.lanes) * c.th * c.w;
  const int lpi = c.lanes_per_image;
  if (map) {
    for (int task = t, wm = j1 - m0; task < lpi * wm; task += n) {
      const int li = task / wm, j = m0 + task % wm;
      const int kept = d.keep[static_cast<size_t>(lane0 + li) * c.w + j];
      mapper_add(at, tb.mhist, tb.mmark, kept >> 16, (kept >> 8) & 0xFF, c.map_bump,
                 c.map_halve);
    }
  }
  if (bias) {
    for (int task = t, wb = j1 - b0; task < lpi * wb; task += n) {
      const int li = task / wb, j = b0 + task % wb;
      const size_t px = (static_cast<size_t>(lane0 + li) * c.th + r) * c.w + j;
      bias_add(at, tb.bsum, tb.bcnt, tb.bmark, d.planes[5 * plane + px],
               d.planes[3 * plane + px] - d.planes[4 * plane + px], c.bias_cap);
    }
  }
}

// Phase (c), thread t of `n`: every marked counter pair of the image's
// lanes halved (coder3.halve_pairs), and where `map` / `bias` every marked
// mapper key (coder3.mapper_updates' halving: every count of a key whose
// max passes map_halve, >> 1) and bias context (strips._bias_update's:
// both of a context whose count passes bias_cap, >> 1); a mark stays
// where the entry is still past its threshold.  A thread takes a mark word
// and its set bits.
NBT_HD void segment_sweeps(const ScanContract& c, const ImageTables& tb, const LaneTables& lt,
                           bool map, bool bias, int t, int n) {
  const int up = kNRow * c.n_class;
  for (int g = t; g < c.lanes_per_image * lt.words; g += n) {
    uint32_t bits = lt.mark[g];
    if (!bits) continue;
    const int li = g / lt.words, e0 = 32 * (g - li * lt.words);
    uint32_t keep = 0;
    for (; bits; bits &= bits - 1) {
      const int b = stop_layer(bits, 32), e = e0 + b;
      int32_t* pr = e < up ? lt.ut(li) + 2 * e : lt.rt(li) + 2 * (e - up);
      const int c0 = (pr[0] + 1) >> 1, c1 = (pr[1] + 1) >> 1;
      pr[0] = c0;
      pr[1] = c1;
      if (c0 + c1 > c.cnt_halve) keep |= 1u << b;
    }
    lt.mark[g] = keep;
  }
  if (map) sweep_mapper(tb.mhist, tb.mmark, c.map_halve, nullptr, t, n);
  if (bias) sweep_bias(tb.bsum, tb.bcnt, tb.bmark, c.bias_cap, nullptr, t, n);
}

// The layer constants and tables from the contract, thread t of `n`.
NBT_HD void scan_init_consts(const ScanContract& c, const ImageTables& tb, int t, int n) {
  for (int k = t; k < kMaxUnary; k += n) {
    tb.esc()[k] = c.esc[k];
    tb.cls()[k] = c.cls[k];
  }
  for (int k = t; k < kNRow; k += n) tb.kq()[k] = k / c.k_step;
  for (int k = t; k < kMaxUnary * kNRow; k += n)
    tb.rows()[k] = escalated_row(k % kNRow, c.esc[k / kNRow], c.k_step);
}

// The tables' start, thread t of `n`: the layer constants and tables, the
// counters at cnt_init, the mapper at coder3.init_mapper, the moments at
// 0, and the marks of what starts past its threshold (every pair where 2
// cnt_init passes cnt_halve, every key where 38 passes map_halve).
NBT_HD void scan_init(const ScanContract& c, const ImageTables& tb, const LaneTables& lt, int t,
                      int n) {
  const int lpi = c.lanes_per_image;
  scan_init_consts(c, tb, t, n);
  for (size_t k = t; k < static_cast<size_t>(lpi) * lt.ucells; k += n) lt.u[k] = c.cnt_init;
  for (size_t k = t; k < static_cast<size_t>(lpi) * 2 * kRefinePairs; k += n)
    lt.r[k] = c.cnt_init;
  const bool over = 2ll * c.cnt_init > c.cnt_halve;
  for (size_t k = t; k < static_cast<size_t>(lpi) * lt.words; k += n) {
    const int left = counter_pairs(c) - 32 * static_cast<int>(k % lt.words);
    lt.mark[k] = !over ? 0u : (left >= 32 ? ~0u : (1u << left) - 1);
  }
  for (int k = t; k < kMapKeys * kNMap; k += n) tb.mhist[k] = 2 * (kNMap - 1 - k % kNMap);
  for (int k = t; k < kMapKeys / 32; k += n)
    tb.mmark[k] = 2 * (kNMap - 1) > c.map_halve ? ~0u : 0u;
  if (!c.near_mode) {
    for (int k = t; k < kScanCtx; k += n) tb.bsum[k] = tb.bcnt[k] = 0;
    for (int k = t; k < kScanCtx / 32; k += n) tb.bmark[k] = 0;
  }
}

// One image's scan: its lanes are img * lanes_per_image onwards.  `team`
// runs a phase on each of its threads (`threads(f)`: f(t, n)), the walk a
// pixel a warp where `warp_pixels(c)` (`walk(...)`, which returns the
// thread's events for `events(...)`), ends a phase with `sync()`, and
// updates the tables with `at`: a CTA on the card, virtual threads one
// after another on the host.
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <class Team>
NBT_HD void scan_image(const ScanContract& c, const ScanData& d, const ImageTables& tb,
                       const LaneTables& lt, int img, const Team& team) {
  const int lane0 = img * c.lanes_per_image, lane1 = lane0 + c.lanes_per_image;
  team.threads([&](int t, int n) { scan_init(c, tb, lt, t, n); });
  team.sync();
  const int n_seg = c.w / c.ws;
  const bool by_warp = team.warp_pixels(c);
  for (int r = 0; r < c.th; ++r) {
    for (int sg = 0; sg < n_seg; ++sg) {
      const int j0 = sg * c.ws, j1 = j0 + c.ws;
      SlotEvents ev{-1, -1, -1, 0, 0, -1};
      if (c.sym_cnt) {
        team.threads([&](int t, int n) {
          for (int lane = lane0 + t; lane < lane1; lane += n)
            lane_segment(c, d, tb, lt, lane0, lane, r, j0, j1);
        });
      } else if (by_warp) {
        ev = team.walk(c, d, tb, lt, lane0, r, j0);
      } else {
        team.threads([&](int t, int n) { pixel_tasks(c, d, tb, lt, lane0, r, j0, t, n); });
      }
      team.sync();
      const bool row_end = sg == n_seg - 1;
      const bool map = c.seg_map || row_end;
      const bool bias = !c.near_mode && (c.seg_bias || row_end);
      if (by_warp) {
        team.events(c, lt, ev);
      } else {
        team.threads([&](int t, int n) {
          counter_events(c, d, tb, lt, lane0, r, j0, j1, t, n, team.at);
        });
      }
      team.threads([&](int t, int n) {
        table_adds(c, d, tb, lane0, r, j1, map, c.seg_map ? j0 : 0, bias, c.seg_bias ? j0 : 0,
                   t, n, team.at);
      });
      team.sync();
      team.threads([&](int t, int n) { segment_sweeps(c, tb, lt, map, bias, t, n); });
      team.sync();
    }
  }
}

}  // namespace
