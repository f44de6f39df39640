// Shared primitives of the nbrt host runtime.
//
// Numeric conventions: every operation that must round-trip against the
// reference bitstreams reproduces C's semantics exactly — truncating signed
// division (reference relies on it at e.g. NBLIC.c:139,199,230,258) and
// arithmetic right shift of negative values (gcc behavior).
#pragma once

#include <cstdint>
#include <cstring>
#include <vector>

namespace nbrt {

using i64 = int64_t;
using u32 = uint32_t;
using u16 = uint16_t;
using u8 = uint8_t;

constexpr int kMaxVal = 255;
constexpr int kMidVal = 128;
constexpr int kMaxHeight = 65535;   // NBLIC.h:29-31 / QNBLIC.h:9-11
constexpr int kMaxWidth = 65535;
constexpr i64 kMaxImageSize = 100000000;

template <typename T>
inline T clip(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <typename T>
inline T iabs(T x) {
  return x < 0 ? -x : x;
}

// C-style truncating division (round toward zero).
inline i64 tdiv(i64 num, i64 den) { return num / den; }  // C++11 already truncates

inline bool size_ok(int height, int width) {
  return height > 0 && width > 0 && height <= kMaxHeight && width <= kMaxWidth &&
         (i64)height * width <= kMaxImageSize;
}

// ---------------------------------------------------------------------------
// Causal neighborhood window.
//
// Compass naming of the 12-pixel causal template (reference uses a..t,
// NBLIC.c:287-304): w=(i,j-1) n=(i-1,j) nw ne ww=(i,j-2) nn=(i-2,j)
// nne nnw nww=(i-1,j-2) nnee nnww nee=(i-1,j+2).
// ---------------------------------------------------------------------------
struct Window {
  int w, n, nw, ne, ww, nn, nne, nnw, nww, nnee, nnww, nee;
};

class ImageView {
 public:
  ImageView(const u8* data, int height, int width)
      : data_(data), h_(height), w_(width) {}

  int at(int i, int j, int fallback) const {
    return (i >= 0 && j >= 0 && j < w_) ? data_[(i64)i * w_ + j] : fallback;
  }

  // Fresh per-pixel sampling with chained border defaults
  // (spec: NBLIC.c:287-304; also matches QNBLIC.c:48-64 at column 0).
  Window fresh(int i, int j) const {
    Window v;
    v.w = at(i, j - 1, kMidVal);
    v.n = at(i - 1, j, kMidVal);
    if (i == 0)
      v.n = v.w;
    else if (j == 0)
      v.w = v.n;
    v.ww = at(i, j - 2, v.w);
    v.nw = at(i - 1, j - 1, v.n);
    v.ne = at(i - 1, j + 1, v.n);
    v.nn = at(i - 2, j, v.n);
    v.nne = at(i - 2, j + 1, v.nn);
    v.nnw = at(i - 2, j - 1, v.nn);
    v.nww = at(i - 1, j - 2, v.nw);
    v.nnee = at(i - 2, j + 2, v.nne);
    v.nnww = at(i - 2, j - 2, v.nnw);
    v.nee = at(i - 1, j + 2, v.ne);
    return v;
  }

  // Incremental slide used by the effort-0 engine: after coding pixel (i,j)
  // with value x, shift the window to (i,j+1) (spec: QNBLIC.c:67-79).
  // The effective border values differ from fresh() — both ends of the codec
  // use the same recurrence, so this IS the effort-0 semantics.
  void slide(Window& v, int i, int j, int x) const {
    v.ww = v.w;
    v.w = x;
    v.nww = v.nw;
    v.nw = v.n;
    v.n = v.ne;
    v.nnww = v.nnw;
    v.nnw = v.nn;
    v.nn = v.nne;
    v.nne = v.nnee;
    v.ne = (i <= 0) ? v.w : (j + 2 >= w_) ? v.ne : data_[(i64)(i - 1) * w_ + (j + 2)];
    v.nnee = (i <= 1) ? v.ne : (j + 3 >= w_) ? v.nnee : data_[(i64)(i - 2) * w_ + (j + 3)];
  }

  int height() const { return h_; }
  int width() const { return w_; }

 private:
  const u8* data_;
  int h_, w_;
};

// ---------------------------------------------------------------------------
// Bounded output writer (byte or u16-word granularity). The reference writes
// into oversized static buffers with no checks (NBLIC_main.c:140-141); we
// bound-check and report capacity errors instead.
// ---------------------------------------------------------------------------
class ByteSink {
 public:
  ByteSink(u8* buf, i64 cap) : buf_(buf), cap_(cap) {}
  bool put(u8 b) {
    if (pos_ >= cap_) {
      overflow_ = true;
      return false;
    }
    buf_[pos_++] = b;
    return true;
  }
  i64 size() const { return pos_; }
  bool overflowed() const { return overflow_; }

 private:
  u8* buf_;
  i64 cap_;
  i64 pos_ = 0;
  bool overflow_ = false;
};

class ByteSource {
 public:
  ByteSource(const u8* buf, i64 len) : buf_(buf), len_(len) {}
  u8 get() { return pos_ < len_ ? buf_[pos_++] : 0; }
  bool take(const void* expect, i64 n) {
    if (pos_ + n > len_) return false;
    bool ok = std::memcmp(buf_ + pos_, expect, (size_t)n) == 0;
    pos_ += n;
    return ok;
  }
  i64 remaining() const { return len_ - pos_; }
  i64 pos() const { return pos_; }

 private:
  const u8* buf_;
  i64 len_;
  i64 pos_ = 0;
};

}  // namespace nbrt
