// Effort-1..3 engine: "NBLIC0.3" container (adaptive binary range coder,
// lossless and near-lossless).
//
// Behavioral spec: reference src/NBLIC.c (constants cited per component).
// Re-designed implementation: a template<bool kDecode> codec core shares the
// modeling path between encoder and decoder at compile time, with the model
// split into small value-type components (range coder, bit-counter mixer,
// escalating symbol coder, rank mapper, online least-squares predictor).

#include <cstdio>
#include <cstring>
#include <vector>

#include "nbrt_common.hpp"

namespace nbrt {
namespace n {

constexpr int kNQd = 16;                     // NBLIC.c:60
constexpr int kNContext = (kNQd >> 1) * 256; // 2048
constexpr int kCtxCoef = 7;                  // NBLIC.c:63
constexpr int kCtxScale = 8;                 // NBLIC.c:64
constexpr int kNQw = 32;                     // NBLIC.c:66
constexpr int kNMapper = 20;                 // NBLIC.c:68
constexpr int kMaxCounter = 256;             // NBLIC.c:70
constexpr int kProbMax = 1 << 12;            // NBLIC.c:72
constexpr int kFb1 = 12, kFb2 = 2, kFb3 = kFb1 - kFb2;  // NBLIC.c:74-76
constexpr int kFitBase = kMidVal;            // NBLIC.c:78
constexpr int kAlpha = 5, kBeta = 3;         // NBLIC.c:79-80
constexpr i64 kBiasInit = 2 << kFb2;         // NBLIC.c:82
constexpr i64 kBiasMax = 1024 << kFb2;       // NBLIC.c:83
constexpr i64 kBiasCoef = 21;                // NBLIC.c:84
constexpr int kMaxNear = kMaxVal / 26;       // 9 (NBLIC.c:56)
constexpr int kMinKStep = 3;                 // NBLIC.c:58
constexpr int kMaxN = 10;
constexpr int kMaxPxInc = kMaxVal - kMidVal; // 127
// AVP neighbor-count per effort (NBLIC.c:88)
constexpr int kNList[4] = {-1, 0, 6, 10};

inline constexpr int stat_len(int n) { return 1 + n + n * n; }  // NBLIC.c:86

// ---------------------------------------------------------------- predictor

// Blend predictor, effort-1..3 flavor: identical candidate costs to the
// effort-0 engine but an unshifted threshold search (NBLIC.c:307-370).
static int blend_predict(const Window& v) {
  static const int cuts[8] = {31, 93, 279, 620, 1550, 3410, 9300, 24800};
  const int lnr =
      clip(9 * v.w + 9 * v.n + 2 * v.ne - 2 * v.nw - v.ww - v.nn, 0, 16 * kMaxVal);
  int best = 0, csum = 0, cmin = 0xFFFFFF, cost;

  cost = 2 * (iabs(v.w - v.ww) + iabs(v.nw - v.nww) + iabs(v.n - v.nw) +
              iabs(v.ne - v.n));
  csum += cost;
  if (cmin > cost) { cmin = cost; best = 2 * v.w; }
  cost = 2 * (iabs(v.w - v.nw) + iabs(v.nw - v.nnw) + iabs(v.n - v.nn) +
              iabs(v.ne - v.nne));
  csum += cost;
  if (cmin > cost) { cmin = cost; best = 2 * v.n; }
  cost = 2 * (iabs(v.w - v.nww) + iabs(v.nw - v.nnww) + iabs(v.n - v.nnw) +
              iabs(v.ne - v.nn));
  csum += cost;
  if (cmin > cost) { cmin = cost; best = 2 * v.nw; }
  cost = 2 * (iabs(v.w - v.n) + iabs(v.nw - v.nn) + iabs(v.n - v.nne) +
              iabs(v.ne - v.nnee));
  csum += cost;
  if (cmin > cost) { cmin = cost; best = 2 * v.ne; }
  cost = iabs(2 * v.w - v.ww - v.nww) + iabs(2 * v.nw - v.nww - v.nnww) +
         iabs(2 * v.n - v.nw - v.nnw) + iabs(2 * v.ne - v.n - v.nn);
  csum += cost;
  if (cmin > cost) { cmin = cost; best = v.w + v.nw; }
  cost = iabs(2 * v.w - v.nww - v.nw) + iabs(2 * v.nw - v.nnww - v.nnw) +
         iabs(2 * v.n - v.nnw - v.nn) + iabs(2 * v.ne - v.nn - v.nne);
  csum += cost;
  if (cmin > cost) { cmin = cost; best = v.nw + v.n; }
  cost = iabs(2 * v.w - v.nw - v.n) + iabs(2 * v.nw - v.nnw - v.nn) +
         iabs(2 * v.n - v.nn - v.nne) + iabs(2 * v.ne - v.nne - v.nnee);
  csum += cost;
  if (cmin > cost) { cmin = cost; best = v.n + v.ne; }

  csum -= 7 * cmin;
  int wt = 0;
  while (wt < 8 && cuts[wt] <= csum) ++wt;
  return (8 * wt * best + (8 - wt) * lnr + 64) >> 7;
}

// Dual-bin activity quantizer with 5-bit interpolation weight
// (NBLIC.c:373-395) — the qw mixing is a key compression-ratio feature.
struct Quantized {
  int qu, qv, qw;
};

static Quantized quantize_activity(const Window& v, int prev_err) {
  static const int mid[kNQd] = {0, 2, 4, 7, 10, 14, 20, 26,
                                34, 42, 52, 64, 78, 95, 135, 200};
  const int delta = iabs(v.w - v.ww) + iabs(v.n - v.nw) + iabs(v.n - v.ne) +
                    iabs(v.w - v.nw) + iabs(v.n - v.nn) + iabs(v.ne - v.nne) +
                    2 * iabs(prev_err);
  int qd = 0;
  while (qd < kNQd - 1 && delta > mid[qd]) ++qd;
  Quantized out{qd, qd, 0};
  if (delta < mid[qd]) {
    out.qw = kNQw * (delta - mid[qd - 1]) / (mid[qd] - mid[qd - 1]);
    if (out.qw < kNQw / 2) {
      out.qu = qd - 1;
    } else {
      out.qv = qd - 1;
      out.qw = kNQw - out.qw;
    }
  }
  return out;
}

// Context address: (qu>>1)*256 | 8 texture bits (NBLIC.c:398-410).
static int context_address(const Window& v, int qu, int px) {
  int adr = (qu >> 1) << 8;
  adr |= (px > v.w) ? 0x01 : 0;
  adr |= (px > v.n) ? 0x02 : 0;
  adr |= (px > v.nw) ? 0x04 : 0;
  adr |= (px > v.ne) ? 0x08 : 0;
  adr |= (px > v.ww) ? 0x10 : 0;
  adr |= (px > v.nn) ? 0x20 : 0;
  adr |= (px > (2 * v.w - v.ww)) ? 0x40 : 0;
  adr |= (px > (2 * v.n - v.nn)) ? 0x80 : 0;
  return adr;
}

// Per-context EWMA bias (NBLIC.c:413-428). Rounding constant is 64 here
// (vs 63 in the effort-0 engine) — both must be matched exactly.
static inline int correct_px(int ctx, int px0, int* sign) {
  *sign = (ctx >> (kCtxScale - 1)) & 1;
  return clip(px0 + (ctx >> kCtxScale) + *sign, 0, kMaxVal);
}

static inline int update_ctx(int ctx, int err) {
  return (ctx * ((1 << kCtxCoef) - 1) + (err << kCtxScale) +
          (1 << (kCtxCoef - 1))) >> kCtxCoef;
}

// Near-lossless residual fold/unfold, JPEG-LS style (NBLIC.c:431-466).
static int residual_fold(int x, int px, int sign, int near) {
  const int ty = (clip(px, 0, kMaxVal - px) + near) / (2 * near + 1);
  const int sy = x >= px ? 1 : 0;
  int y = (iabs(x - px) + near) / (2 * near + 1);
  if (y <= 0) return 0;
  if (y <= ty) return 2 * y - (sy ^ sign);
  return y + ty;
}

static int residual_unfold(int z, int px, int sign, int near) {
  const int ty = (clip(px, 0, kMaxVal - px) + near) / (2 * near + 1);
  int y, sy;
  if (z <= 0) {
    y = 0;
    sy = 0;
  } else if (z <= 2 * ty) {
    y = (z + 1) / 2;
    sy = (z & 1) ^ sign;
  } else {
    y = z - ty;
    sy = px < kMidVal ? 1 : 0;
  }
  y *= 2 * near + 1;
  return clip(px + (sy ? y : -y), 0, kMaxVal);
}

// ---------------------------------------------------------------- rank mapper

// Adaptive small-symbol re-ranking permutation over the 20 most frequent
// residuals; 512 instances keyed by (corrected px, sign) (NBLIC.c:470-523).
struct RankMapper {
  u8 to_rank[kNMapper];
  u8 from_rank[kNMapper];
  int freq[kNMapper];

  void reset() {
    for (int i = 0; i < kNMapper; ++i) {
      to_rank[i] = (u8)i;
      from_rank[i] = (u8)i;
      freq[i] = (kNMapper - 1 - i) * 2;
    }
  }

  int fold(int y) const { return y < kNMapper ? to_rank[y] : y; }
  int unfold(int z) const { return z < kNMapper ? from_rank[z] : z; }

  void observe(int y) {
    if (y >= kNMapper) return;
    const u8 z = to_rank[y];
    ++freq[z];
    if (z == 0) return;
    const u8 z_up = z - 1;
    const u8 y_up = from_rank[z_up];
    const int f = freq[z], f_up = freq[z_up];
    if (f_up < f) {  // bubble toward rank 0
      freq[z] = f_up;
      freq[z_up] = f;
      from_rank[z] = y_up;
      from_rank[z_up] = (u8)y;
      to_rank[y] = z_up;
      to_rank[y_up] = z;
    }
  }
};

// ---------------------------------------------------------------- range coder

// Carry-less binary range coder, 32-bit bounds, 12-bit probability split,
// byte renormalization (NBLIC.c:527-586).
template <bool kDecode>
struct RangeCoder {
  u32 lo = 0;
  u32 hi = 0xFFFFFFFFu;
  u32 window = 0;  // decoder's last 4 stream bytes
  ByteSink* sink = nullptr;
  ByteSource* source = nullptr;

  void init() {
    if (kDecode) {
      window = 0;
      for (int k = 0; k < 4; ++k) window = (window << 8) | source->get();
    }
  }

  // Codes one binary decision with P(bin=1) = prob/4096; returns the bin.
  int code_bit(int bin, u32 prob) {
    const u32 span = hi - lo;
    const u32 mid = lo + (span >> 12) * prob + (((span & 0xFFFu) * prob) >> 12);
    if (kDecode) bin = (window <= mid) ? 1 : 0;
    if (bin)
      hi = mid;
    else
      lo = mid + 1;
    while (((lo ^ hi) & 0xFF000000u) == 0) {
      if (kDecode) {
        window = (window << 8) | source->get();
      } else {
        sink->put((u8)(hi >> 24));
      }
      lo <<= 8;
      hi = (hi << 8) | 0xFF;
    }
    return bin;
  }

  void flush() {
    if (!kDecode) {
      for (int k = 0; k < 4; ++k) {
        sink->put((u8)(lo >> 24));
        lo <<= 8;
      }
    }
  }
};

// Adaptive bit-counter pair (NBLIC.c:589-618).
struct BitCounter {
  int c0, c1;
  void bump(int bin, int amount) {
    (bin ? c1 : c0) += amount;
    if (c0 + c1 > kNQw * kMaxCounter) {
      c0 = (c0 + 1) >> 1;
      c1 = (c1 + 1) >> 1;
    }
  }
  int prob1() const { return kProbMax * c1 / (c0 + c1); }
};

// Two-counter linear mixer feeding the range coder (NBLIC.c:621-637).
// u and v may alias the same counter (when qu == qv) — updates are sequential,
// exactly as in the reference.
template <bool kDecode>
static int mixed_code_bit(RangeCoder<kDecode>& rc, BitCounter* u, BitCounter* v,
                          int qw, int bin) {
  int prob = (u->prob1() * (kNQw - qw) + v->prob1() * qw + kNQw / 2) / kNQw;
  prob = clip(prob, 1, kProbMax - 1);
  bin = rc.code_bit(bin, (u32)prob);
  u->bump(bin, kNQw - qw);
  v->bump(bin, qw);
  return bin;
}

// Escalating adaptive-k symbol coder over a 16x256 counter tree
// (NBLIC.c:640-679). Codes z >= 0; k grows for large symbols.
template <bool kDecode>
static int code_symbol(RangeCoder<kDecode>& rc, int k_step,
                       BitCounter tree[kNQd][256], int qu, int qv, int qw,
                       int z) {
  const int k_max = (kNQd - 1) / k_step;
  if (qv / k_step != qu / k_step) qv = qu;

  int i = 0, k = 0, bin;
  int guard = 0;
  for (;;) {
    k = qu / k_step;
    bin = kDecode ? 0 : ((i >> k_max) < (z >> k) ? 1 : 0);
    bin = mixed_code_bit(rc, &tree[qu][i], &tree[qv][i], qw, bin);
    if (!bin) break;
    i += 1 << k_max;
    if (i >= 256) {
      i >>= 1;
      // valid streams never escalate past the top band (z <= 255 bounds the
      // walk); clamp + guard so CORRUPT streams can't index out of the tree
      // or spin forever (the reference has UB here, SURVEY.md §5)
      qu = qv = (k + 1) * k_step;
      if (qu > kNQd - 1) qu = qv = kNQd - 1;
    }
    if (++guard > 4096) break;
  }
  if (kDecode) z = (i >> k_max) << k;

  for (++i, --k; k >= 0; --k) {
    bin = kDecode ? 0 : ((z >> k) & 1);
    bin = mixed_code_bit(rc, &tree[qu][i], &tree[qv][i], qw, bin);
    if (kDecode) z += bin ? (1 << k) : 0;
    i += bin ? (1 << k) : 1;
  }
  return z;
}

// ---------------------------------------------------------------- AVP

// Online least-squares predictor with spatially decayed moments and dual-bias
// adaptation (efforts 2-3; NBLIC.c:112-283). All arithmetic is int64 with
// C-truncating division — the TPU port emulates this in paired int32 lanes.
class LeastSquares {
 public:
  LeastSquares(int n, int width) : n_(n), m_(stat_len(n)), width_(width) {
    col_moments_.assign((size_t)width * m_, 0);
    row_decayed_.assign((size_t)width * m_, 0);
  }

  int n() const { return n_; }

  // Row preamble: reset the in-row accumulator and rebuild the right-to-left
  // decayed prefix of the column moments (NBLIC.c:186-204, 817-819).
  void start_row() {
    for (int k = 0; k < m_; ++k) east_acc_[k] = 0;
    for (int j = width_ - 1; j >= 0; --j) {
      i64* f = &row_decayed_[(size_t)j * m_];
      const i64* f_right = &row_decayed_[(size_t)(j + 1) * m_];
      const i64* b = &col_moments_[(size_t)j * m_];
      int ab = kBeta;
      for (int k = 0; k < m_; ++k) {
        f[k] = (j == width_ - 1) ? 0 : tdiv(f_right[k] * (ab - 1) + ab / 2, ab);
        f[k] += b[k];
        ab = kAlpha;
      }
    }
  }

  // Gather the causal feature vector, order {w,n,nw,ne,ww,nn,nee,nnw,nww,nne}
  // (NBLIC.c:164-183 — note nee at index 6 and nne at index 9).
  void load_features(const Window& v) {
    const int src[kMaxN] = {v.w, v.n, v.nw, v.ne, v.ww,
                            v.nn, v.nee, v.nnw, v.nww, v.nne};
    for (int k = 0; k < n_; ++k) feat_[k] = src[k] - kFitBase;
  }

  // Ridge-regularized solve; returns false on singular systems
  // (NBLIC.c:210-239). px_out is the prediction in 12-bit fixed point.
  bool predict(int col, i64 bias, i64* px_out) const {
    i64 stats[stat_len(kMaxN)];
    const i64* e = east_acc_;
    const i64* f = &row_decayed_[(size_t)col * m_];
    for (int k = 1; k < m_; ++k) stats[k] = e[k] + f[k];
    i64* b = stats + 1;
    i64* a = stats + 1 + n_;
    for (int k = 0; k < n_; ++k) {
      b[k] += bias << kFb3;
      a[k * n_ + k] += bias * n_;
    }
    if (!solve_inplace(a, b)) return false;
    i64 px = (i64)kFitBase << kFb1;
    for (int k = 0; k < n_; ++k) {
      const i64 akk = a[k * n_ + k];
      px += tdiv(((b[k] * feat_[k]) << kFb2) + (akk >> 1), akk);
    }
    *px_out = clip(px, (i64)0, (i64)kMaxVal << kFb1);
    return true;
  }

  // Rank-1 moment update weighted by inverse local error energy
  // (NBLIC.c:242-283).
  void update(int col, int x, i64 s_curr, i64 s_sum) {
    i64 stats[stat_len(kMaxN)];
    stats[0] = s_curr;
    i64* b = stats + 1;
    i64* a = stats + 1 + n_;
    const i64 xf = x - kFitBase;
    s_sum = clip(s_sum + ((i64)1 << kFb1), (i64)1 << kFb1, (i64)16 << kFb1);
    const i64 half = s_sum >> 1;
    for (int k = 0; k < n_; ++k)
      b[k] = tdiv(((xf * feat_[k]) << (4 + kFb1 + kFb1)) + half, s_sum);
    for (int jj = 0; jj < n_; ++jj)
      for (int k = 0; k < n_; ++k)
        a[jj * n_ + k] = tdiv(((feat_[jj] * feat_[k]) << (4 + kFb2 + kFb1)) + half, s_sum);

    i64* col_b = &col_moments_[(size_t)col * m_];
    int ab = kBeta;
    for (int k = 0; k < m_; ++k) {
      col_b[k] = tdiv(col_b[k] * (ab - 1) + (ab >> 1), ab) + stats[k];
      east_acc_[k] = tdiv(east_acc_[k] * (ab - 1) + (ab >> 1), ab) + col_b[k];
      ab = kAlpha;
    }
  }

  // Recent error energy estimate at this column (NBLIC.c:883-884).
  i64 energy(int col) const {
    return east_acc_[0] + row_decayed_[(size_t)col * m_];
  }

 private:
  // int64 Gaussian elimination with partial pivoting; quotients use
  // C-truncating division of the product (NBLIC.c:112-161).
  bool solve_inplace(i64* a, i64* b) const {
    const int n = n_;
    for (int k = 0; k < n - 1; ++k) {
      int piv = k;
      for (int i = k + 1; i < n; ++i)
        if (iabs(a[i * n + k]) > iabs(a[piv * n + k])) piv = i;
      if (piv != k) {
        std::swap(b[k], b[piv]);
        for (int j = k; j < n; ++j) std::swap(a[k * n + j], a[piv * n + j]);
      }
      const i64 akk = a[k * n + k];
      if (akk == 0) return false;
      for (int i = k + 1; i < n; ++i) {
        const i64 aik = a[i * n + k];
        a[i * n + k] = 0;
        if (aik != 0) {
          for (int j = k + 1; j < n; ++j)
            a[i * n + j] -= tdiv(a[k * n + j] * aik, akk);
          b[i] -= tdiv(b[k] * aik, akk);
        }
      }
    }
    for (int k = n - 1; k > 0; --k) {
      const i64 akk = a[k * n + k];
      if (akk == 0) return false;
      for (int i = 0; i < k; ++i) {
        const i64 aik = a[i * n + k];
        a[i * n + k] = 0;
        if (aik != 0) b[i] -= tdiv(b[k] * aik, akk);
      }
    }
    return true;
  }

  int n_, m_, width_;
  std::vector<i64> col_moments_;  // per-column decayed moments ("B" rows)
  std::vector<i64> row_decayed_;  // right-to-left decayed prefix ("F" rows)
  i64 east_acc_[stat_len(kMaxN)]; // in-row accumulation ("E")
  i64 feat_[kMaxN];
};

// ---------------------------------------------------------------- codec core

struct Params {
  int height, width, near, k_step, effort;
};

static bool params_ok(const Params& p) {
  return size_ok(p.height, p.width) && p.near >= 0 && p.near <= kMaxNear &&
         p.k_step >= kMinKStep && p.k_step <= kNQd && p.effort >= 1 &&
         p.effort <= 3;
}

// Shared encode/decode loop. On encode, img_in holds the source pixels and
// img_rec receives the reconstruction (they may alias for in-place semantics —
// the reference encodes in place, NBLIC.c:915-916). On decode, img_in is null.
// -V progress reporting (analog of NBLIC.c:810-815): enabled per-process by
// nbrt_set_verbose; prints an in-place row counter every 8 rows to stderr.
static int g_verbose = 0;
extern "C" void nbrt_set_verbose(int v) { g_verbose = v; }

template <bool kDecode>
static bool run_codec(const Params& p, const u8* img_in, u8* img_rec,
                      ByteSink* sink, ByteSource* source) {
  const int height = p.height, width = p.width, near = p.near;

  RangeCoder<kDecode> rc;
  rc.sink = sink;
  rc.source = source;
  rc.init();

  std::vector<int> ctx(kNContext, 0);
  std::vector<BitCounter> tree_storage((size_t)kNQd * 256, BitCounter{kNQw, kNQw});
  auto* tree = reinterpret_cast<BitCounter(*)[256]>(tree_storage.data());
  std::vector<RankMapper> mappers(512);
  for (auto& m : mappers) m.reset();

  const int n_feat = kNList[p.effort];
  LeastSquares lsq(n_feat > 0 ? n_feat : 1, width);
  const bool use_lsq = n_feat > 0;
  i64 bias = kBiasInit;

  const ImageView rec_view(img_rec, height, width);

  for (int i = 0; i < height; ++i) {
    if (g_verbose >= 2 && (i & 0x7) == 0) {
      std::fprintf(stderr, "\r    effort=%d, %s row %d (%.2f%%)", p.effort,
                   kDecode ? "decoding" : "encoding", i,
                   (100.0 * i) / height);
      std::fflush(stderr);
    }
    int prev_err = 0;
    if (use_lsq) lsq.start_row();

    for (int j = 0; j < width; ++j) {
      const Window v = rec_view.fresh(i, j);

      bool p1_ok = false, p2_ok = false;
      i64 px1f = 0, px2f = 0, bias1 = 0, bias2 = 0;
      if (use_lsq) {
        lsq.load_features(v);
        bias1 = tdiv(bias * kBiasCoef, kBiasCoef + 1);
        bias2 = tdiv(bias * (kBiasCoef + 1), kBiasCoef);
        bias1 = clip(bias1, (i64)-1, bias - 1);
        bias2 = clip(bias2, bias + 1, kBiasMax + 1);
        bias1 = clip(bias1, (i64)0, kBiasMax);
        bias2 = clip(bias2, (i64)0, kBiasMax);
        p1_ok = lsq.predict(j, bias1, &px1f);
        p2_ok = lsq.predict(j, bias2, &px2f);
      }

      int px0;
      if (p1_ok) {
        px0 = (int)((px1f + (1 << (kFb1 - 1))) >> kFb1);
      } else {
        px0 = blend_predict(v);
        px1f = (i64)px0 << kFb1;
      }

      const Quantized qz = quantize_activity(v, prev_err);
      const int adr = context_address(v, qz.qu, px0);
      int sign;
      const int px = correct_px(ctx[adr], px0, &sign);
      RankMapper& mapper = mappers[(size_t)px * 2 + sign];

      int y = 0, z = 0;
      if (!kDecode) {
        const int x_orig = img_in[(i64)i * width + j];
        y = residual_fold(x_orig, px, sign, near);
        z = mapper.fold(y);
      }
      z = code_symbol(rc, p.k_step, tree, qz.qu, qz.qv, qz.qw, z);
      if (kDecode) y = mapper.unfold(z);
      mapper.observe(y);

      const int x = residual_unfold(y, px, sign, near);
      img_rec[(i64)i * width + j] = (u8)x;
      prev_err = clip(x - px0, -kMaxPxInc, kMaxPxInc);
      ctx[adr] = update_ctx(ctx[adr], prev_err);

      if (use_lsq) {
        const i64 s_curr = iabs(px1f - ((i64)x << kFb1));
        const i64 s_sum = lsq.energy(j) + tdiv(s_curr * kBeta, kBeta - 1);
        lsq.update(j, x, s_curr, s_sum);
        if (p1_ok && p2_ok) {
          const i64 e1 = iabs(px1f - ((i64)x << kFb1));
          const i64 e2 = iabs(px2f - ((i64)x << kFb1));
          bias = (e1 > e2) ? bias2 : bias1;
        }
      }
    }
  }

  if (g_verbose >= 2)
    std::fprintf(stderr, "\r%64s\r", "");
  rc.flush();
  return !(sink && sink->overflowed());
}

// ---------------------------------------------------------------- entry points

static i64 encode_impl(const u8* img, int height, int width, int near, int effort,
                       u8* out, i64 out_cap, u8* img_rec_out) {
  Params p;
  p.height = height;
  p.width = width;
  p.near = clip(near, 0, kMaxNear);                                  // NBLIC.c:768
  p.k_step = clip(kMinKStep + 2 * p.near, kMinKStep, kNQd);          // NBLIC.c:769
  p.effort = clip(effort, 1, 3);                                     // NBLIC.c:770
  if (!params_ok(p)) return -1;

  ByteSink sink(out, out_cap);
  // 15-byte header (NBLIC.c:682-694): magic, n_channel, H/W big-endian, near,
  // k_step, effort.
  for (const char* c = "NBLIC0.3"; *c; ++c) sink.put((u8)*c);
  sink.put(1);
  sink.put((u8)(height >> 8));
  sink.put((u8)height);
  sink.put((u8)(width >> 8));
  sink.put((u8)width);
  sink.put((u8)p.near);
  sink.put((u8)p.k_step);
  sink.put((u8)p.effort);

  // The reference encodes in place (reconstruction overwrites the input,
  // NBLIC.c:915-916); we keep the caller's buffer const and reconstruct into
  // a scratch (or the caller-provided img_rec_out).
  std::vector<u8> rec_scratch;
  u8* rec = img_rec_out;
  if (rec == nullptr) {
    rec_scratch.assign((size_t)height * width, 0);
    rec = rec_scratch.data();
  }
  std::memcpy(rec, img, (size_t)height * width);

  if (!run_codec<false>(p, img, rec, &sink, nullptr)) return -2;
  return sink.size();
}

static i64 decode_impl(const u8* stream, i64 stream_len, u8* img_out, i64 img_cap,
                       int32_t* height, int32_t* width, int32_t* near,
                       int32_t* effort) {
  if (stream_len < 15 + 4) return -1;
  ByteSource source(stream, stream_len);
  if (!source.take("NBLIC0.3", 8)) return -1;
  Params p;
  const int n_channel = source.get();
  p.height = (source.get() << 8);
  p.height += source.get();
  p.width = (source.get() << 8);
  p.width += source.get();
  p.near = source.get();
  p.k_step = source.get();
  p.effort = source.get();
  if (n_channel != 1 || !params_ok(p)) return -1;
  if ((i64)p.height * p.width > img_cap) return -2;

  if (!run_codec<true>(p, nullptr, img_out, nullptr, &source)) return -3;
  *height = p.height;
  *width = p.width;
  *near = p.near;
  *effort = p.effort;
  return (i64)p.height * p.width;
}

}  // namespace n
}  // namespace nbrt

using namespace nbrt;

extern "C" int64_t nbrt_n_encode(const uint8_t* img, int32_t height, int32_t width,
                                 int32_t near, int32_t effort, uint8_t* out,
                                 int64_t out_cap, uint8_t* img_rec) {
  return n::encode_impl(img, height, width, near, effort, out, out_cap, img_rec);
}

extern "C" int64_t nbrt_n_decode(const uint8_t* stream, int64_t stream_len,
                                 uint8_t* img_out, int64_t img_cap,
                                 int32_t* height, int32_t* width, int32_t* near,
                                 int32_t* effort) {
  return n::decode_impl(stream, stream_len, img_out, img_cap, height, width, near,
                        effort);
}

extern "C" int64_t nbrt_n_stage1(const uint8_t* img, int32_t height, int32_t width,
                                 uint8_t* px0_out, int16_t* qu_out, int16_t* qv_out,
                                 int16_t* qw_out, int16_t* adr_out) {
  // Effort-1 lossless parallel-stage oracle: per-pixel blend prediction,
  // dual-bin activity quantization, and context address computed from the
  // original image (reconstruction == original at near=0, so the stage is
  // embarrassingly parallel; ground truth for ops/predict.py's NBLIC path).
  if (!size_ok(height, width)) return -1;
  const ImageView view(img, height, width);
  i64 t = 0;
  for (int i = 0; i < height; ++i) {
    int prev_err = 0;
    for (int j = 0; j < width; ++j, ++t) {
      const Window v = view.fresh(i, j);
      const int px0 = n::blend_predict(v);
      const n::Quantized qz = n::quantize_activity(v, prev_err);
      const int adr = n::context_address(v, qz.qu, px0);
      const int x = img[(i64)i * width + j];
      prev_err = clip(x - px0, -n::kMaxPxInc, n::kMaxPxInc);
      px0_out[t] = (u8)px0;
      qu_out[t] = (int16_t)qz.qu;
      qv_out[t] = (int16_t)qz.qv;
      qw_out[t] = (int16_t)qz.qw;
      adr_out[t] = (int16_t)adr;
    }
  }
  return t;
}

extern "C" const char* nbrt_version(void) { return "nbrt-0.2.0"; }
