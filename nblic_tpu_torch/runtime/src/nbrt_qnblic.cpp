// Effort-0 engine: "Q0.2" container (static-rANS coded, lossless only).
//
// Behavioral spec: reference src/QNBLIC.c (constants cited per function).
// Re-designed implementation: the encoder runs a band-parallel modeling stage
// (std::thread) followed by a serial context/histogram stage — equivalent to
// the reference's Windows-only 4-thread pipeline (QNBLIC.c:660-868) but
// portable, and bit-identical to the single-threaded path by construction.

#include <atomic>
#include <cmath>
#include <thread>
#include <vector>

#include "nbrt_common.hpp"

namespace nbrt {
namespace q {

constexpr int kNQd = 12;                 // QNBLIC.c:24
constexpr int kNContext = kNQd * 256;    // 3072 contexts
constexpr int kCtxCoef = 7;              // QNBLIC.c:27
constexpr int kCtxScale = 11;            // QNBLIC.c:28

constexpr int kNormBits = 15;            // QNBLIC.c:221
constexpr u32 kNormSum = 1u << kNormBits;
constexpr int kAnsBits = 16;
constexpr u32 kAnsMask = (1u << kAnsBits) - 1;
constexpr u32 kAnsLowBound = 1u << kAnsBits;
constexpr u32 kAnsHighBoundNorm = (1u << (2 * kAnsBits - kNormBits)) - 1;

// ---------------------------------------------------------------- LUTs

struct Luts {
  u8 blend_wt[608];   // weight LUT over csum>>3 (QNBLIC.c:82-91)
  u8 activity[152];   // activity-to-bin LUT (QNBLIC.c:152-161)

  Luts() {
    static const int wt_cuts[8] = {5, 12, 34, 78, 194, 431, 601, 608};
    static const int qd_cuts[kNQd] = {1, 2, 4, 6, 9, 15, 25, 39, 63, 101, 151, 152};
    int lo = 0;
    for (int k = 0; k < 8; ++k) {
      for (int s = lo; s < wt_cuts[k]; ++s) blend_wt[s] = (u8)k;
      lo = wt_cuts[k];
    }
    lo = 0;
    for (int k = 0; k < kNQd; ++k) {
      for (int s = lo; s < qd_cuts[k]; ++s) activity[s] = (u8)k;
      lo = qd_cuts[k];
    }
  }
};

static const Luts kLuts;

// ---------------------------------------------------------------- predictor

// Clipped-linear / best-angular blend predictor (spec: QNBLIC.c:94-149).
static inline int predict(const Window& v) {
  const int lnr =
      clip(9 * v.w + 9 * v.n + 2 * v.ne - 2 * v.nw - v.ww - v.nn, 0, 16 * kMaxVal);

  int best, csum, cmin, cost;
  // candidate 2*w
  cmin = csum = 2 * (iabs(v.w - v.ww) + iabs(v.nw - v.nww) + iabs(v.n - v.nw) +
                     iabs(v.ne - v.n));
  best = 2 * v.w;
  // candidate 2*n
  cost = 2 * (iabs(v.w - v.nw) + iabs(v.nw - v.nnw) + iabs(v.n - v.nn) +
              iabs(v.ne - v.nne));
  csum += cost;
  if (cmin > cost) { cmin = cost; best = 2 * v.n; }
  // candidate 2*nw
  cost = 2 * (iabs(v.w - v.nww) + iabs(v.nw - v.nnww) + iabs(v.n - v.nnw) +
              iabs(v.ne - v.nn));
  csum += cost;
  if (cmin > cost) { cmin = cost; best = 2 * v.nw; }
  // candidate 2*ne
  cost = 2 * (iabs(v.w - v.n) + iabs(v.nw - v.nn) + iabs(v.n - v.nne) +
              iabs(v.ne - v.nnee));
  csum += cost;
  if (cmin > cost) { cmin = cost; best = 2 * v.ne; }
  // candidate w+nw
  cost = iabs(2 * v.w - v.ww - v.nww) + iabs(2 * v.nw - v.nww - v.nnww) +
         iabs(2 * v.n - v.nw - v.nnw) + iabs(2 * v.ne - v.n - v.nn);
  csum += cost;
  if (cmin > cost) { cmin = cost; best = v.w + v.nw; }
  // candidate nw+n
  cost = iabs(2 * v.w - v.nww - v.nw) + iabs(2 * v.nw - v.nnww - v.nnw) +
         iabs(2 * v.n - v.nnw - v.nn) + iabs(2 * v.ne - v.nn - v.nne);
  csum += cost;
  if (cmin > cost) { cmin = cost; best = v.nw + v.n; }
  // candidate n+ne
  cost = iabs(2 * v.w - v.nw - v.n) + iabs(2 * v.nw - v.nnw - v.nn) +
         iabs(2 * v.n - v.nn - v.nne) + iabs(2 * v.ne - v.nne - v.nnee);
  csum += cost;
  if (cmin > cost) { cmin = cost; best = v.n + v.ne; }

  csum -= 7 * cmin;
  csum = csum >> 3;
  if (csum > 607) csum = 607;
  const int wt = kLuts.blend_wt[csum];
  return (8 * wt * best + (8 - wt) * lnr + 64) >> 7;
}

// Activity measure feeding the context quantizer (QNBLIC.c:531,599).
static inline int activity_bin(const Window& v, int prev_err) {
  int d = iabs(v.w - v.ww) + iabs(v.n - v.nw) + iabs(v.n - v.ne) +
          iabs(v.w - v.nw) + iabs(v.n - v.nn) + iabs(v.ne - v.nne) +
          2 * iabs(prev_err);
  if (d > 151) d = 151;
  return kLuts.activity[d];
}

// Context address: activity bin + 8 texture bits (QNBLIC.c:164-173).
static inline int context_address(const Window& v, int px, int qd) {
  int adr = qd;
  adr = (adr << 1) | (px > v.w);
  adr = (adr << 1) | (px > v.n);
  adr = (adr << 1) | (px > v.nw);
  adr = (adr << 1) | (px > v.ne);
  adr = (adr << 1) | (px > v.ww);
  adr = (adr << 1) | (px > v.nn);
  adr = (adr << 1) | (px > (2 * v.w - v.ww));
  adr = (adr << 1) | (px > (2 * v.n - v.nn));
  return adr;
}

// Per-context EWMA bias correction (QNBLIC.c:176-188). Note the rounding
// constant here is (1<<(coef-1))-1 = 63, unlike the effort-1..3 engine's 64.
static inline int correct_px(int ctx, int px0, int* sign) {
  *sign = (ctx >> (kCtxScale - 1)) & 1;
  return clip(px0 + (ctx >> kCtxScale) + *sign, 0, kMaxVal);
}

static inline int update_ctx(int ctx, int err) {
  return (ctx * ((1 << kCtxCoef) - 1) + (err << kCtxScale) +
          ((1 << (kCtxCoef - 1)) - 1)) >> kCtxCoef;
}

// Sign-folded residual map, lossless-only variant (QNBLIC.c:191-217).
static inline int residual_fold(int x, int px, int sign) {
  const int ty = px < kMaxVal - px ? px : kMaxVal - px;
  const int mag = iabs(x - px);
  if (mag <= 0) return 0;
  if (mag <= ty) return 2 * mag - ((x >= px) ^ sign);
  return mag + ty;
}

static inline int residual_unfold(int z, int px, int sign) {
  const int ty = px < kMaxVal - px ? px : kMaxVal - px;
  if (z <= 0) return px;
  if (z <= 2 * ty) {
    const int mag = (z + 1) >> 1;
    return px + (((z & 1) ^ sign) ? mag : -mag);
  }
  return px + ((px < kMidVal) ? (z - ty) : (ty - z));
}

// ---------------------------------------------------------------- histograms

// Normalize a 256-bin histogram to sum 2^15 (encoder-side float is fine for
// cross-platform decode; spec incl. the 0.49 rounding constant: QNBLIC.c:308-358).
static void normalize_hist(u32 hist[256]) {
  u32 total = 0, nonzero = 0, last = 0;
  for (u32 i = 0; i < 256; ++i) {
    if (hist[i] > 0) {
      total += hist[i];
      ++nonzero;
      last = i;
    }
  }
  if (nonzero == 0) {
    hist[0] = kNormSum - 1;
    hist[1] = 1;
    return;
  }
  if (nonzero == 1) {
    hist[last] = kNormSum - 1;
    hist[(last + 1) & 255] = 1;
    return;
  }
  const double scale = (1.0 * kNormSum) / total;
  u32 sum = 0;
  for (u32 i = 0; i < 256; ++i) {
    if (hist[i] > 0) {
      hist[i] = (u32)(0.49 + scale * hist[i]);
      if (hist[i] < 1) hist[i] = 1;
      sum += hist[i];
    }
  }
  for (u32 i = 0; sum > kNormSum; i = (i + 1) & 255) {
    if (hist[i] > 1) { --hist[i]; --sum; }
  }
  for (u32 i = 0; sum < kNormSum; i = (i + 1) & 255) {
    if (hist[i] > 0) { ++hist[i]; ++sum; }
  }
}

static void build_acc(const u32 hist[256], u32 acc[256]) {
  acc[0] = 0;
  for (int i = 1; i < 256; ++i) acc[i] = acc[i - 1] + hist[i - 1];
}

static void build_decode_lut(const u32 acc[256], u8 lut[kNormSum]) {
  for (u32 v = 0; v < 255; ++v)
    for (u32 i = acc[v]; i < acc[v + 1]; ++i) lut[i] = (u8)v;
  for (u32 i = acc[255]; i < kNormSum; ++i) lut[i] = 255;
}

// 5-case 16-bit RLE serialization of a normalized histogram
// (format table: QNBLIC.c:362-371).
static void write_hist(std::vector<u16>& out, const u32 hist[256]) {
  u32 i = 0, sum = 0;
  while (i < 256 && sum < kNormSum) {
    const u16 h0 = (u16)hist[i];
    u32 j = i + 1;
    u16 he = 0xFFFF;
    for (; j < 256; ++j) {
      he = (u16)hist[j];
      if (he != h0) break;
    }
    const u16 len = (u16)(j - i);
    u16 code;
    if (h0 <= 1 && len >= 4) {
      if (j < 256 && he <= 15)
        ++j;  // absorb the run-terminating value into the KKKK field
      else
        he = h0;
      code = (u16)((7 << 13) | (h0 << 12) | (he << 8) | (len - 4));
    } else {
      const u16 h1 = (i + 1 < 256) ? (u16)hist[i + 1] : 0xFFFF;
      const u16 h2 = (i + 2 < 256) ? (u16)hist[i + 2] : 0xFFFF;
      const u16 h3 = (i + 3 < 256) ? (u16)hist[i + 3] : 0xFFFF;
      if (h0 <= 7 && h1 <= 7 && h2 <= 7 && h3 <= 7) {
        code = (u16)((13 << 12) | (h0 << 9) | (h1 << 6) | (h2 << 3) | h3);
        j = i + 4;
      } else if (h0 <= 15 && h1 <= 15 && h2 <= 15) {
        code = (u16)((12 << 12) | (h0 << 8) | (h1 << 4) | h2);
        j = i + 3;
      } else if (h0 <= 127 && h1 <= 127) {
        code = (u16)((2 << 14) | (h0 << 7) | h1);
        j = i + 2;
      } else {
        code = h0;
        j = i + 1;
      }
    }
    out.push_back(code);
    for (; i < j; ++i) sum += hist[i];
  }
}

// Reads one histogram; returns false on malformed input (QNBLIC.c:372-409).
static bool read_hist(const u16*& p, const u16* end, u32 hist[256]) {
  for (int i = 0; i < 256; ++i) hist[i] = 0;
  u32 i = 0, sum = 0;
  while (i < 256 && sum < kNormSum) {
    if (p >= end) return false;
    const u16 code = *p++;
    if ((code >> 15) == 0) {
      sum += (hist[i++] = code);
    } else if ((code >> 14) == 2) {
      if (i + 2 > 256) return false;
      sum += (hist[i++] = (code >> 7) & 0x7F);
      sum += (hist[i++] = code & 0x7F);
    } else if ((code >> 12) == 12) {
      if (i + 3 > 256) return false;
      sum += (hist[i++] = (code >> 8) & 0xF);
      sum += (hist[i++] = (code >> 4) & 0xF);
      sum += (hist[i++] = code & 0xF);
    } else if ((code >> 12) == 13) {
      if (i + 4 > 256) return false;
      sum += (hist[i++] = (code >> 9) & 0x7);
      sum += (hist[i++] = (code >> 6) & 0x7);
      sum += (hist[i++] = (code >> 3) & 0x7);
      sum += (hist[i++] = code & 0x7);
    } else {
      u32 len = (code & 0xFF) + 4;
      const u32 he = (code >> 8) & 0xF;
      const u32 h0 = (code >> 12) & 0x1;
      if (i + len > 256) return false;
      for (; len > 0; --len) sum += (hist[i++] = h0);
      if (he != h0) {
        if (i >= 256) return false;
        sum += (hist[i++] = he);
      }
    }
  }
  return sum == kNormSum;
}

// ---------------------------------------------------------------- modeling

struct PixelMeta {
  u8 x;
  u8 px0;
  u16 adr;
};

// Stage 1: prediction + activity + context address for a row range. Reads only
// the original image (rows are independent: the window and the in-row error
// chain both reset at column 0), so this parallelizes over row bands — the
// same property the reference's MT pipeline exploits (QNBLIC.c:683-739).
static void model_rows(const ImageView& img, int row_begin, int row_end,
                       PixelMeta* meta /* indexed from row_begin*width */) {
  const int width = img.width();
  for (int i = row_begin; i < row_end; ++i) {
    Window v = img.fresh(i, 0);
    int prev_err = 0;
    for (int j = 0; j < width; ++j) {
      const int x = img.at(i, j, 0);
      const int px0 = predict(v);
      const int qd = activity_bin(v, prev_err);
      prev_err = x - px0;
      PixelMeta& m = *meta++;
      m.x = (u8)x;
      m.px0 = (u8)px0;
      m.adr = (u16)context_address(v, px0, qd);
      img.slide(v, i, j, x);
    }
  }
}

// Stage 2: raster-order adaptive-context correction + residual fold + histogram
// accumulation (serial chain; QNBLIC.c:802-831 equivalent).
static void context_stage(const PixelMeta* meta, i64 n_px, u8* qd_out, u8* y_out,
                          u32 hist[kNQd][256]) {
  std::vector<int> ctx(kNContext, 0);
  for (i64 t = 0; t < n_px; ++t) {
    const PixelMeta& m = meta[t];
    const int adr = m.adr;
    const int qd = adr >> 8;
    int sign;
    const int px = correct_px(ctx[adr], m.px0, &sign);
    ctx[adr] = update_ctx(ctx[adr], (int)m.x - (int)m.px0);
    const int y = residual_fold(m.x, px, sign);
    qd_out[t] = (u8)qd;
    y_out[t] = (u8)y;
    ++hist[qd][y];
  }
}

// ---------------------------------------------------------------- rANS fold

// Reverse-order static rANS encode of the (qd, y) plane; emits little-endian
// u16 words, then reverses them so decode streams forward (QNBLIC.c:238-287).
static void rans_encode(const u8* qd, const u8* y, i64 n_px,
                        const u32 hist[kNQd][256], const u32 acc[kNQd][256],
                        std::vector<u16>& out) {
  const size_t mark = out.size();
  u32 state = kAnsLowBound;
  for (i64 t = n_px - 1; t >= 0; --t) {
    const u32 h = hist[qd[t]][y[t]];
    u32 quot = state / h;
    if (quot > kAnsHighBoundNorm) {
      out.push_back((u16)(state & kAnsMask));
      state >>= kAnsBits;
      quot = state / h;
    }
    state %= h;
    state += (quot << kNormBits) + acc[qd[t]][y[t]];
  }
  out.push_back((u16)(state & kAnsMask));
  out.push_back((u16)((state >> kAnsBits) & kAnsMask));
  // word-reverse the payload so the decoder reads forward
  for (size_t a = mark, b = out.size() - 1; a < b; ++a, --b) {
    const u16 tmp = out[a];
    out[a] = out[b];
    out[b] = tmp;
  }
}

// ---------------------------------------------------------------- encode

static i64 encode_impl(const u8* img_data, int height, int width, u8* out,
                       i64 out_cap, int n_threads) {
  if (!size_ok(height, width)) return -1;
  const i64 n_px = (i64)height * width;
  const ImageView img(img_data, height, width);

  std::vector<PixelMeta> meta(n_px);
  if (n_threads > 1 && height >= 2) {
    const int bands = n_threads < height ? n_threads : height;
    std::vector<std::thread> pool;
    pool.reserve(bands);
    for (int b = 0; b < bands; ++b) {
      const int r0 = (int)((i64)height * b / bands);
      const int r1 = (int)((i64)height * (b + 1) / bands);
      pool.emplace_back(model_rows, std::cref(img), r0, r1,
                        meta.data() + (i64)r0 * width);
    }
    for (auto& t : pool) t.join();
  } else {
    model_rows(img, 0, height, meta.data());
  }

  std::vector<u8> qd_plane(n_px), y_plane(n_px);
  u32 hist[kNQd][256] = {{0}};
  context_stage(meta.data(), n_px, qd_plane.data(), y_plane.data(), hist);
  meta.clear();
  meta.shrink_to_fit();

  u32 acc[kNQd][256];
  std::vector<u16> words;
  words.reserve((size_t)(n_px / 2 + 4096));
  // header: "Q0.2" as two LE words, then height, width (QNBLIC.c:463-473)
  words.push_back((u16)('0' << 8 | 'Q'));
  words.push_back((u16)('2' << 8 | '.'));
  words.push_back((u16)height);
  words.push_back((u16)width);
  for (int k = 0; k < kNQd; ++k) {
    normalize_hist(hist[k]);
    build_acc(hist[k], acc[k]);
    write_hist(words, hist[k]);
  }
  rans_encode(qd_plane.data(), y_plane.data(), n_px, hist, acc, words);

  const i64 n_bytes = (i64)words.size() * 2;
  if (n_bytes > out_cap) return -2;
  std::memcpy(out, words.data(), (size_t)n_bytes);  // LE platform == LE stream
  return n_bytes;
}

// ---------------------------------------------------------------- decode

static i64 decode_impl(const u8* stream, i64 stream_len, u8* img_out, i64 img_cap,
                       int32_t* height, int32_t* width) {
  if (stream_len < 8 || (stream_len & 1)) return -1;
  std::vector<u16> words((size_t)(stream_len / 2));
  std::memcpy(words.data(), stream, (size_t)stream_len);
  const u16* p = words.data();
  const u16* end = p + words.size();

  if (p[0] != (u16)('0' << 8 | 'Q') || p[1] != (u16)('2' << 8 | '.')) return -1;
  const int h = p[2], w = p[3];
  p += 4;
  if (!size_ok(h, w)) return -1;
  const i64 n_px = (i64)h * w;
  if (n_px > img_cap) return -2;

  u32 hist[kNQd][256], acc[kNQd][256];
  std::vector<u8> lut((size_t)kNQd * kNormSum);
  for (int k = 0; k < kNQd; ++k) {
    if (!read_hist(p, end, hist[k])) return -1;
    build_acc(hist[k], acc[k]);
    build_decode_lut(acc[k], lut.data() + (size_t)k * kNormSum);
  }

  if (end - p < 2) return -1;
  u32 state = ((u32)*p++) << kAnsBits;
  state |= *p++;

  std::vector<int> ctx(kNContext, 0);
  const ImageView img(img_out, h, w);
  for (int i = 0; i < h; ++i) {
    Window v = img.fresh(i, 0);
    int prev_err = 0;
    for (int j = 0; j < w; ++j) {
      const int px0 = predict(v);
      const int qd = activity_bin(v, prev_err);
      const int adr = context_address(v, px0, qd);
      int sign;
      const int px = correct_px(ctx[adr], px0, &sign);

      // rANS symbol decode (QNBLIC.c:263-274)
      const u32 lb = state & (kNormSum - 1);
      const int y = lut[(size_t)qd * kNormSum + lb];
      state >>= kNormBits;
      state *= hist[qd][y];
      state += lb;
      state -= acc[qd][y];
      if (state < kAnsLowBound) {
        state <<= kAnsBits;
        state |= (p < end) ? *p++ : 0;
      }

      const int x = residual_unfold(y, px, sign);
      img_out[(i64)i * w + j] = (u8)x;
      prev_err = x - px0;
      ctx[adr] = update_ctx(ctx[adr], prev_err);
      img.slide(v, i, j, x);
    }
  }
  *height = h;
  *width = w;
  return n_px;
}

}  // namespace q
}  // namespace nbrt

using namespace nbrt;

extern "C" int64_t nbrt_q_encode(const uint8_t* img, int32_t height, int32_t width,
                                 uint8_t* out, int64_t out_cap, int32_t n_threads) {
  return q::encode_impl(img, height, width, out, out_cap, n_threads);
}

extern "C" int64_t nbrt_q_decode(const uint8_t* stream, int64_t stream_len,
                                 uint8_t* img_out, int64_t img_cap,
                                 int32_t* height, int32_t* width) {
  return q::decode_impl(stream, stream_len, img_out, img_cap, height, width);
}

extern "C" int64_t nbrt_q_stage1(const uint8_t* img, int32_t height, int32_t width,
                                 uint8_t* px0_out, uint16_t* adr_out) {
  // Parallel-stage oracle: per-pixel uncorrected prediction and context
  // address (the quantities the device modeling kernels must reproduce).
  if (!size_ok(height, width)) return -1;
  const i64 n_px = (i64)height * width;
  const ImageView view(img, height, width);
  std::vector<q::PixelMeta> meta(n_px);
  q::model_rows(view, 0, height, meta.data());
  for (i64 t = 0; t < n_px; ++t) {
    px0_out[t] = meta[t].px0;
    adr_out[t] = meta[t].adr;
  }
  return n_px;
}

extern "C" int64_t nbrt_q_model(const uint8_t* img, int32_t height, int32_t width,
                                uint8_t* qd_out, uint8_t* y_out, uint32_t* hist_out) {
  if (!size_ok(height, width)) return -1;
  const i64 n_px = (i64)height * width;
  const ImageView view(img, height, width);
  std::vector<q::PixelMeta> meta(n_px);
  q::model_rows(view, 0, height, meta.data());
  u32 hist[q::kNQd][256] = {{0}};
  q::context_stage(meta.data(), n_px, qd_out, y_out, hist);
  std::memcpy(hist_out, hist, sizeof(hist));
  return n_px;
}
