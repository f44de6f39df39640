// The profile-3 modeling chains' arithmetic and their skewed schedule: the
// device counterpart of nblic_tpu_torch/ops/pavp.py's decay, _moments,
// _clip_s_sum, the energy channel's sample weight (predict_plane) and
// _run_chains' B, E and F, which kernel K10 (p3_model_chains.cu) runs on
// every pixel of every channel.
//
// Exactness.  The plain versions compute in int64 with torch's semantics,
// and each function here reproduces them bit for bit on every input:
// products, sums and left shifts wrap modulo 2^64 (through uint64: signed
// overflow is undefined in C++), a decay truncates toward zero
// (torch.div "trunc" is C's /), and avp.tdiv divides magnitudes with
// |INT64_MIN| wrapping to itself (udiv64.cuh's wabs and floor_div).
//
// The moments' division.  Every moment of a pixel divides by the same
// clipped sample weight s in [2^12, 2^16], which K10's energy pass writes
// once a pixel with its reciprocal M = floor((2^64 - 1) / s) + 1.  For a
// numerator's magnitude a < 2^47, floor(a / s) is the high word of a M:
// with a = q s + r, a M / 2^64 = a / s + a e / 2^64 for some 0 <= e < 1,
// and a / 2^64 < 1 / s, so the error never reaches the next integer.
// Pixels give |left right| <= 2^14 and shifts <= 28, so a < 2^43 there;
// any other numerator takes udiv64.cuh's floor_div, exact as well.
//
// The schedule (the second half of this file), K10's wavefront.  A thread
// runs `rows` consecutive rows of one channel, a warp's 32 lanes are 32
// channels (K10: 2 rows a thread), a CTA's warps stack their rows down
// a band of the strip.  Row i works on column i steps after row 0 (plus
// kChainChunk steps a warp boundary), so at each step it takes B of the
// row above at the same column, which that row formed one step before:
// from the thread's own registers, or across a warp boundary from a ring
// in shared memory, which the CTA's barrier every kChainChunk steps makes
// safe.  A pass is then w + h steps and no more, and B never leaves the
// chip.  The forward pass carries E along the row and stores it (the
// frozen E under seg_stats, the segment starts' under w_pred); the reverse
// pass forms B again, carries F from the right and adds it to the stored
// E.  A strip taller than a band runs band after band, the last row's B
// of a band handed to the next through a small carry in device memory.
//
// The host branch: g++ compiles this header for the CPU test
// tests/test_torch_p3_model_pass.py (udiv64.cuh's multiply-high is
// unsigned __int128 there), which runs the schedule's steps on virtual
// lanes and warps.

#pragma once

#include <cstdint>

#include "udiv64.cuh"

namespace {

constexpr int kMcFb1 = 12;        // avp.FB1
constexpr int kMcFb2 = 2;         // avp.FB2
constexpr int kMcAlpha = 5;       // decay denominator of the regression moments
constexpr int kMcBeta = 3;        // decay denominator of the error energies
constexpr int kMcShiftB = 4 + kMcFb1 + kMcFb1;  // the b-vector moments' shift
constexpr int kMcShiftA = 4 + kMcFb2 + kMcFb1;  // the matrix moments' shift
constexpr int64_t kMcFastMag = 1ll << 47;       // moment(): the reciprocal's domain

NBT_HD int64_t mc_add(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) + static_cast<uint64_t>(b));
}
NBT_HD int64_t mc_mul(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) * static_cast<uint64_t>(b));
}
NBT_HD int64_t mc_shl(int64_t a, int s) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) << s);
}

// pavp.decay: (v (ab - 1) + ab / 2) / ab truncated toward zero, the
// product wrapping.  ab is a constant, so the division is a multiply-high.
template <int kAb>
NBT_HD int64_t mc_decay(int64_t v) {
  return mc_add(mc_mul(v, kAb - 1), kAb >> 1) / kAb;
}

// pavp._clip_s_sum: s_sum + 2^FB1 clipped to [2^FB1, 16 2^FB1].
NBT_HD int64_t clip_s_sum(int64_t s_sum) {
  const int64_t v = mc_add(s_sum, 1ll << kMcFb1);
  return v < (1ll << kMcFb1) ? (1ll << kMcFb1) : (v > (16ll << kMcFb1) ? (16ll << kMcFb1) : v);
}

// The energy channel's contribution (and the mix chains'): |x - p| << FB1
// of a pixel and a prediction.
NBT_HD int64_t err_energy(int x, int p) {
  const int64_t d = static_cast<int64_t>(x) - p;
  return mc_shl(d < 0 ? -d : d, kMcFb1);
}

// The sample weight of pavp.predict_plane: _clip_s_sum(stats0 +
// tdiv(s_curr BETA, BETA - 1)), stats0 channel 0 of the pixel's E + F,
// s_curr its energy contribution.
NBT_HD int64_t sample_weight(int64_t stats0, int64_t s_curr) {
  const int64_t num = mc_mul(s_curr, kMcBeta);
  const int64_t q = floor_div(wabs(num), kMcBeta - 1);
  return clip_s_sum(mc_add(stats0, num < 0 ? wneg(q) : q));
}

// The reciprocal moment() divides by: floor((2^64 - 1) / s) + 1, s >= 2.
NBT_HD uint64_t moment_recip(int64_t s) {
  return ~0ull / static_cast<uint64_t>(s) + 1;
}

// pavp._moments of one channel: tdiv(((left right) << shift) + s / 2, s)
// for s = the clipped sample weight in [2^12, 2^16] and its reciprocal
// from moment_recip.
NBT_HD int64_t moment(int64_t left, int64_t right, int shift, int64_t s, uint64_t recip) {
  const int64_t num = mc_add(mc_shl(mc_mul(left, right), shift), s >> 1);
  const int64_t mag = wabs(num);
  const int64_t q = (mag >= 0 && mag < kMcFastMag)
                        ? static_cast<int64_t>(umulhi64(static_cast<uint64_t>(mag), recip))
                        : floor_div(mag, s);
  return num < 0 ? wneg(q) : q;
}

// Moment channel q of the n + n^2 (statistics channel 1 + q): the
// indexes of its two factors among [x - FIT_BASE, the n features] and its
// shift; q < n is the b-vector's (x times feature q), else the matrix's
// row (q - n) / n, column (q - n) % n.
struct MomentOf {
  int left, right, shift;
};

NBT_HD MomentOf moment_of(int q, int n) {
  if (q < n) return {0, 1 + q, kMcShiftB};
  const int r = q - n;
  return {1 + r / n, 1 + r % n, kMcShiftA};
}


// ---- K10's skewed wavefront

enum ChainKind { kEnergy = 0, kMoments = 1, kMix = 2 };
enum ChainForm { kPlain = 0, kFreeze = 1, kHold = 2 };

constexpr int kChainWarp = 32;
// steps between the CTA's barriers; the extra lag a warp boundary adds
constexpr int kChainChunk = 4;
// ring slots a warp boundary and lane: a column is written kChainChunk + 1
// steps before it is read and a slot is written again kChainRing steps
// later, so the barriers order both once kChainRing >= 2 kChainChunk + 1
constexpr int kChainRing = 16;

// One launch's tensors and shape.  fe: (P, n + 1) x - FIT_BASE, then the
// features; pred: (K, P) the predictions of the energy and mix channels;
// ssum, srecip: each pixel's sample weight and its reciprocal (the energy
// launch writes them, the moments read them); carry: (2, s, k, w) B of a
// band's last row for the next band (null where one band holds the
// strip); out: (rows, stride) E + F at channel c0 + c.
struct ChainArgs {
  const int32_t* fe;
  const int32_t* pred;
  int32_t* ssum;
  uint64_t* srecip;
  int64_t* carry;
  int64_t* out;
  long long p;
  int s, h, w, n, q0, k, stride, c0, seg, form;
  uint32_t seg_inv;  // seg_inverse(seg)
};

// j / seg for j, seg < 2^16 by a multiply-high: inv = floor((2^32 - 1) /
// seg) + 1 exceeds 2^32 / seg by less than 1, and j inv / 2^32 then
// exceeds j / seg by less than j / 2^32 < 1 / seg (1 where seg is 1).
NBT_HD uint32_t seg_inverse(int seg) {
  return seg > 1 ? 0xffffffffu / static_cast<uint32_t>(seg) + 1 : 0;
}
NBT_HD int seg_quot(int j, int seg, uint32_t inv) {
  if (seg <= 1) return j;
#if defined(__CUDA_ARCH__)
  return static_cast<int>(__umulhi(static_cast<uint32_t>(j), inv));
#else
  return static_cast<int>((static_cast<uint64_t>(j) * inv) >> 32);
#endif
}

// The layout of a launch: a warp's 32 lanes are 32 channels; rows a
// thread, warps a CTA, rows a band (the CTA's), bands a strip.
struct ChainPlan {
  int rows, warps, band, bands;
};

NBT_HD ChainPlan chain_plan(int h, int rows, int max_warps) {
  int warps = (h + rows - 1) / rows;
  if (warps > max_warps) warps = max_warps;
  const int band = warps * rows;
  return {rows, warps, band, (h + band - 1) / band};
}

// The step at which row i of a band starts (its column 0).
NBT_HD int chain_lag(const ChainPlan& pl, int i) {
  return i + i / pl.rows * kChainChunk;
}

// Steps of a pass over a band of `nrows` rows, whole chunks.
NBT_HD int chain_steps(const ChainPlan& pl, int w, int nrows) {
  const int st = w + chain_lag(pl, nrows - 1);
  return (st + kChainChunk - 1) / kChainChunk * kChainChunk;
}

template <int kKind>
NBT_HD int64_t chain_decay(int64_t v) {
  return kKind == kMoments ? mc_decay<kMcAlpha>(v) : mc_decay<kMcBeta>(v);
}

// A pixel's inputs to one channel's contribution, loaded ahead of its
// step: the two factors, the sample weight and its reciprocal (moments),
// or x - FIT_BASE and the prediction (energy, mix: l and r).
struct ChainIn {
  int32_t l, r, s;
  uint64_t recip;
  int64_t e;  // the reverse pass: the E the forward pass stored there
};

// A read of the launch's inputs, which no thread writes during it (the
// read-only path on the card, free to run ahead of the stores).
template <class T>
NBT_HD T chain_ld(const T* p) {
#if defined(__CUDA_ARCH__)
  return __ldg(p);
#else
  return *p;
#endif
}

// Channel c's inputs at pixel px; `mo` its factors (moments only).
template <int kKind>
NBT_HD ChainIn chain_load(const ChainArgs& a, const MomentOf& mo, long long px, int c) {
  const int32_t* f = a.fe + px * (a.n + 1);
  if (kKind == kMoments)
    return {chain_ld(f + mo.left), chain_ld(f + mo.right), chain_ld(a.ssum + px),
            chain_ld(a.srecip + px), 0};
  return {chain_ld(f), chain_ld(a.pred + c * a.p + px), 0, 0, 0};
}

// The contribution from its inputs.
template <int kKind>
NBT_HD int64_t chain_contribution(const ChainIn& in, const MomentOf& mo) {
  if (kKind == kMoments) return moment(in.l, in.r, mo.shift, in.s, in.recip);
  return err_energy(in.l + 128, in.r);
}

// moment() where the numerator's magnitude lies in the reciprocal's domain,
// without a branch; else flags `slow` for the caller to take moment().  The
// magnitude is unsigned, so |INT64_MIN| (2^63) falls outside the domain.
NBT_HD int64_t moment_fast(int64_t left, int64_t right, int shift, int64_t s, uint64_t recip,
                           bool& slow) {
  const int64_t num = mc_add(mc_shl(mc_mul(left, right), shift), s >> 1);
  const uint64_t mag = num < 0 ? 0ull - static_cast<uint64_t>(num) : static_cast<uint64_t>(num);
  slow = slow || mag >= static_cast<uint64_t>(kMcFastMag);
  const int64_t q = static_cast<int64_t>(umulhi64(mag, recip));
  return num < 0 ? wneg(q) : q;
}

// The contributions of a thread's rows, straight-line; a row outside the
// reciprocal's domain (no pixel's) takes them all again by moment().
template <int kKind, int kRows>
NBT_HD void chain_rows_contrib(const ChainIn (&in)[kRows], const MomentOf& mo,
                               int64_t (&cv)[kRows]) {
  bool slow = false;
#pragma unroll
  for (int k = 0; k < kRows; ++k)
    cv[k] = kKind == kMoments
                ? moment_fast(in[k].l, in[k].r, mo.shift, in[k].s, in[k].recip, slow)
                : err_energy(in[k].l + 128, in[k].r);
  if (slow) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) cv[k] = chain_contribution<kKind>(in[k], mo);
  }
}

// Where pixel (row, j) of channel c keeps its statistics (row = strip h +
// its row) under form kForm; `start`: j opens a segment (every column of
// the plain form).  Under hold only the segment starts have a place.
template <int kForm>
NBT_HD long long chain_slot(const ChainArgs& a, long long row, int j, int c, bool& start) {
  if (kForm == kPlain) {
    start = true;
    return (row * a.w + j) * a.stride + a.c0 + c;
  }
  const int q = seg_quot(j, a.seg, a.seg_inv);
  start = j == q * a.seg;
  if (kForm == kHold) return (row * (a.w / a.seg) + q) * a.stride + a.c0 + c;
  return (row * a.w + j) * a.stride + a.c0 + c;
}

// The forward pass at pixel (row, j) of channel c, given B of the row
// above at j (`up`, 0 above the strip) and the pixel's contribution: B,
// returned; E before j stored (plain), frozen at the segment starts and
// decayed across them (freeze, `ef`), or at the starts only (hold); E
// carried past j.  Straight-line: where `valid` is false (no pixel, or a
// channel past k) nothing is stored or carried, so the rows of a thread's
// step can be interleaved.
template <int kKind, int kForm>
NBT_HD int64_t chain_forward(const ChainArgs& a, bool valid, long long row, int j, int c,
                             int64_t up, int64_t contrib, int64_t& e, int64_t& ef) {
  const int64_t b = mc_add(chain_decay<kKind>(up), contrib);
  bool start;
  const long long at = chain_slot<kForm>(a, row, j, c, start);
  int64_t v = e;
  if (kForm == kFreeze) {
    v = start ? e : chain_decay<kKind>(ef);
    ef = valid ? v : ef;
  }
  if (valid && (kForm != kHold || start)) a.out[at] = v;
  e = valid ? mc_add(chain_decay<kKind>(e), b) : e;
  return b;
}

// The reverse pass at pixel (row, j), columns right to left: B again; F
// through j (the row above's B at j included), added to the stored E
// (`e`, read ahead) wherever the forward pass stored it.
template <int kKind, int kForm>
NBT_HD int64_t chain_reverse(const ChainArgs& a, bool valid, long long row, int j, int c,
                             int64_t up, int64_t contrib, int64_t e, int64_t& f) {
  const int64_t fv = mc_add(chain_decay<kKind>(f), up);
  bool start;
  const long long at = chain_slot<kForm>(a, row, j, c, start);
  if (valid && (kForm != kHold || start)) a.out[at] = mc_add(e, fv);
  f = valid ? fv : f;
  return mc_add(chain_decay<kKind>(up), contrib);
}

// Where the carry keeps B of column j of channel c of strip `strip` for
// band parity `par`.
NBT_HD long long carry_at(const ChainArgs& a, int par, int strip, int c, int j) {
  return ((static_cast<long long>(par) * a.s + strip) * a.k + c) * a.w + j;
}

// A thread's place in the schedule: its rows (the warp's, `rows` of
// them) in the band, its channel (c, live where c < k; cc a channel whose
// inputs exist), where it takes B from above its first row (the carry
// above the band, or the ring of the warp above) and where it hands its
// last row's B on (the ring below, and the carry below the band's last
// row in the forward pass).
struct ChainThread {
  int rb, c, cc, nrows, lag0;
  bool live, publish, carries;
  MomentOf mo;
  long long srow;  // the band's first row, strip h + row
  const int64_t* cin;
  int64_t* cout;
  const int64_t* rin;
  int64_t* rout;
};

// Thread (warp, lane) of the CTA of (strip, channel block cblock) in band
// `band` of `nrows` rows; ring: the CTA's (warps, kChainRing, 32).
NBT_HD ChainThread chain_thread(const ChainArgs& a, const ChainPlan& pl, int kind, bool fwd,
                                int64_t* ring, int strip, int cblock, int band, int nrows,
                                int warp, int lane) {
  ChainThread th;
  th.rb = warp;
  th.c = cblock * kChainWarp + lane;
  th.live = th.c < a.k;
  th.cc = th.live ? th.c : a.k - 1;
  th.mo = kind == kMoments ? moment_of(a.q0 + th.cc, a.n) : MomentOf{0, 0, 0};
  th.nrows = nrows;
  th.lag0 = chain_lag(pl, th.rb * pl.rows);
  th.srow = static_cast<long long>(strip) * a.h + static_cast<long long>(band) * pl.band;
  th.cin = band > 0 ? a.carry + carry_at(a, (band - 1) & 1, strip, th.cc, 0) : nullptr;
  th.cout = fwd && band + 1 < pl.bands ? a.carry + carry_at(a, band & 1, strip, th.cc, 0)
                                       : nullptr;
  th.carries = th.cout != nullptr && th.live && th.rb * pl.rows + pl.rows - 1 == pl.band - 1;
  th.publish = th.live && warp + 1 < pl.warps;
  th.rin = warp > 0 ? ring + (warp - 1) * kChainRing * kChainWarp + lane : nullptr;
  th.rout = ring + warp * kChainRing * kChainWarp + lane;
  return th;
}

// B of the row above a thread's first row: above the band the carry (0
// above the strip), else the warp above's ring; t0 the place in pass order
// of the first row's column.
NBT_HD int64_t chain_receive(const ChainArgs& a, const ChainThread& th, bool fwd, int t0) {
  if (th.rb == 0)
    return (th.cin != nullptr && t0 >= 0 && t0 < a.w) ? th.cin[fwd ? t0 : a.w - 1 - t0] : 0;
  return th.rin[(t0 & (kChainRing - 1)) * kChainWarp];
}

// One step of a thread, in two halves.  The inputs of its rows at place
// t0 (row k at t0 - k), each at a clamped pixel, so the loads need no
// guard; the kernel issues them a step or two ahead of their use.
template <int kKind, int kForm, int kRows, bool kFwd>
NBT_HD void chain_rows_load(const ChainArgs& a, const ChainThread& th, int t0,
                            ChainIn (&in)[kRows]) {
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int i = th.rb * kRows + k, t = t0 - k;
    const int j = kFwd ? t : a.w - 1 - t;
    const int jc = j < 0 ? 0 : (j >= a.w ? a.w - 1 : j);
    const long long row = th.srow + (i < th.nrows ? i : th.nrows - 1);
    in[k] = chain_load<kKind>(a, th.mo, row * a.w + jc, th.cc);
    if (!kFwd) {  // the thread's own store of the forward pass: a plain read
      bool start;
      const long long at = chain_slot<kForm>(a, row, jc, th.c, start);
      in[k].e = th.live && i < th.nrows && (kForm != kHold || start) ? a.out[at] : 0;
    }
  }
}

// Then the chains: row k takes B of row k - 1 from the last step (`up` for
// row 0), the rows in descending order so that each reads its
// neighbour's value before it is replaced; then the last row's B handed on.
template <int kKind, int kForm, int kRows, bool kFwd>
NBT_HD void chain_rows_apply(const ChainArgs& a, const ChainThread& th, int t0, int64_t up,
                             const ChainIn (&in)[kRows], const int64_t (&cv)[kRows],
                             int64_t (&hand)[kRows], int64_t (&acc)[kRows],
                             int64_t (&ef)[kRows]) {
#pragma unroll
  for (int k = kRows - 1; k >= 0; --k) {
    const int i = th.rb * kRows + k, t = t0 - k;
    const bool valid = th.live && i < th.nrows && t >= 0 && t < a.w;
    const int j = kFwd ? t : a.w - 1 - t;
    const int jc = j < 0 ? 0 : (j >= a.w ? a.w - 1 : j);
    const long long row = th.srow + (i < th.nrows ? i : th.nrows - 1);
    const int64_t b_in = k == 0 ? up : hand[k > 0 ? k - 1 : 0];
    const int64_t b =
        kFwd ? chain_forward<kKind, kForm>(a, valid, row, jc, th.c, b_in, cv[k], acc[k], ef[k])
             : chain_reverse<kKind, kForm>(a, valid, row, jc, th.c, b_in, cv[k], in[k].e, acc[k]);
    hand[k] = valid ? b : hand[k];
  }
  const int t_last = t0 - (kRows - 1);
  if (t_last >= 0 && t_last < a.w) {
    if (th.publish) th.rout[(t_last & (kChainRing - 1)) * kChainWarp] = hand[kRows - 1];
    if (th.carries) th.cout[t_last] = hand[kRows - 1];
  }
}

// The energy launch's weights: pixel px's sample weight from its
// statistics row's channel 0 (the segment's under hold) and its energy
// contribution, with the weight's reciprocal, for the moments.
NBT_HD void chain_weight(const ChainArgs& a, long long px) {
  const long long row = px / a.w;
  const int j = static_cast<int>(px - row * a.w);
  const long long r = a.form == kHold ? row * (a.w / a.seg) + seg_quot(j, a.seg, a.seg_inv) : px;
  const int64_t sw = sample_weight(a.out[r * a.stride + a.c0],
                                   err_energy(chain_ld(a.fe + px * (a.n + 1)) + 128,
                                              chain_ld(a.pred + px)));
  a.ssum[px] = static_cast<int32_t>(sw);
  a.srecip[px] = moment_recip(sw);
}

}  // namespace
