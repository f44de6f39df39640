// The tables of the profile-3 coder that an image's strip lanes share, and
// their replay: kernel K8 (row_scan.cuh, the encoder's coding scan) and
// kernel K9 (p3_table_replay.cu, the decode walk's and the near walk's
// replay between their launches) both update them with these functions,
// which compile for the card and, with g++, for the CPU tests
// (tests/test_torch_p3_row_scan.py, tests/test_torch_p3_table_replay.py
// run them with a team of virtual threads, one after another between
// barriers).
//
// The tables of one image: the bias moments, 3072 int64 sums and counts
// (strips._bias_update), and the AutoMapper's history, 512 keys x 20 int64
// counts (coder3.mapper_updates).  Each carries a bit an entry (its
// marks), set on an entry past its threshold (a context's count past
// bias_cap, a key's largest count past map_halve) by the last sweep that
// left it past, and in K8 by the add that takes it past.  Counts only grow
// between sweeps, so every entry a sweep halves is marked (K8) or marked
// or touched by the adds since (K9, whose adds are reductions that return
// nothing): the plain versions' halving of every entry visits only those.
//
// K9 also keeps what the decoder reads of them: the int16 table of the
// quantized bias (context.quantize_bias) and the mapper's order z -> y
// (coder3.mapper_order, the stable descending order of a key's counts).
// A replay rewrites both for every context and key that its adds touched
// or its sweeps halved: nothing else of them changed.

#pragma once

#include "coder3.cuh"

namespace {

constexpr int kContexts = 3072;    // constants.Q_N_CONTEXT
constexpr int kBiasFrac = 4;       // context.BIAS_FRAC_BITS
constexpr int kBiasMax = 1 << 11;  // quantize_bias's clip: [-2048, 2047]
constexpr int kBiasWords = kContexts / 32;  // mark words of an image's contexts
constexpr int kMapWords = kMapKeys / 32;    // and of its keys

// Table updates of one executor: the plain ones of a host thread (the
// wrapping int64 sums by uint64) and the atomics of the card's.  add64
// returns the value before the add, add_pair a counter pair's sum after
// adding v to its count `which`.
struct HostAtomics {
  NBT_HD int64_t add64(int64_t* p, int64_t v) const {
    const int64_t old = *p;
    *p = static_cast<int64_t>(static_cast<uint64_t>(old) + static_cast<uint64_t>(v));
    return old;
  }
  NBT_HD long long add_pair(int32_t* pair, int which, int v) const {
    pair[which] += v;
    return static_cast<long long>(pair[0]) + pair[1];
  }
  NBT_HD void set(uint32_t* w, uint32_t bits) const { *w |= bits; }
  // K9's: a reduction whose result no one reads, a shared bit set, a mark
  // bit written, a count taken from, and a load of what the reductions
  // left
  NBT_HD void red64(int64_t* p, int64_t v) const {
    *p = static_cast<int64_t>(static_cast<uint64_t>(*p) + static_cast<uint64_t>(v));
  }
  NBT_HD void or_bits(uint32_t* w, uint32_t bits) const { *w |= bits; }
  NBT_HD void put_bit(uint32_t* w, uint32_t bit, bool on) const { *w = on ? *w | bit : *w & ~bit; }
  NBT_HD int take(int* count, int k) const {
    const int old = *count;
    *count += k;
    return old;
  }
  NBT_HD int64_t load(const int64_t* p) const { return *p; }
};

#if defined(__CUDACC__)
struct DeviceAtomics {
  __device__ __forceinline__ int64_t add64(int64_t* p, int64_t v) const {
    return static_cast<int64_t>(atomicAdd(reinterpret_cast<unsigned long long*>(p),
                                          static_cast<unsigned long long>(v)));
  }
  // the pair's two int32 counts as one little-endian 64-bit word (8-byte
  // aligned), so the add returns both
  __device__ __forceinline__ long long add_pair(int32_t* pair, int which, int v) const {
    const unsigned long long old =
        atomicAdd(reinterpret_cast<unsigned long long*>(pair),
                  static_cast<unsigned long long>(static_cast<uint32_t>(v)) << (32 * which));
    return static_cast<long long>(static_cast<uint32_t>(old)) +
           static_cast<uint32_t>(old >> 32) + v;
  }
  __device__ __forceinline__ void set(uint32_t* w, uint32_t bits) const {
    if ((*w & bits) != bits) atomicOr(w, bits);
  }
  // an atomicAdd whose result is unused compiles to a reduction (RED): no
  // round trip to L2 on the thread's path
  __device__ __forceinline__ void red64(int64_t* p, int64_t v) const {
    atomicAdd(reinterpret_cast<unsigned long long*>(p), static_cast<unsigned long long>(v));
  }
  __device__ __forceinline__ void or_bits(uint32_t* w, uint32_t bits) const { atomicOr(w, bits); }
  __device__ __forceinline__ void put_bit(uint32_t* w, uint32_t bit, bool on) const {
    if (on)
      atomicOr(w, bit);
    else
      atomicAnd(w, ~bit);
  }
  __device__ __forceinline__ int take(int* count, int k) const { return atomicAdd(count, k); }
  // through L2: the reductions land there, past this SM's L1
  __device__ __forceinline__ int64_t load(const int64_t* p) const {
    return static_cast<int64_t>(__ldcg(reinterpret_cast<const long long*>(p)));
  }
};
#endif

// context.quantize_bias of one context: the rounded mean error in 1/16 px,
// half away from zero on magnitudes, the numerator wrapped to int32 as
// nblic_tpu's int32 arithmetic wraps it (|sum| past 2^26), clipped to
// [-2048, 2047].  The floor division runs in 32 bits where the divisor
// fits them: the wrapped numerator, or d2 - 1 - it, lies below 2^32.
NBT_HD int quantize_bias(int64_t sum, int64_t cnt, int shrink) {
  const int64_t dn = cnt + shrink;
  const int64_t denom = dn < 1 ? 1 : dn;
  const uint64_t mag_sum =
      sum < 0 ? 0ull - static_cast<uint64_t>(sum) : static_cast<uint64_t>(sum);
  const uint64_t num = (mag_sum << (kBiasFrac + 1)) + static_cast<uint64_t>(denom);
  const int64_t wrapped = static_cast<int32_t>(static_cast<uint32_t>(num));
  const int64_t d2 = 2 * denom;
  int64_t mag;
  if (d2 < (int64_t{1} << 31)) {
    const uint32_t n = static_cast<uint32_t>(wrapped >= 0 ? wrapped : d2 - 1 - wrapped);
    const int64_t q = n / static_cast<uint32_t>(d2);
    mag = wrapped >= 0 ? q : -q;
  } else {
    mag = wrapped >= 0 ? wrapped / d2 : -((d2 - 1 - wrapped) / d2);  // floor
  }
  if (cnt <= 0 || sum == 0) return 0;
  const int64_t bias = sum > 0 ? mag : -mag;
  return bias < -kBiasMax ? -kBiasMax
                          : (bias > kBiasMax - 1 ? kBiasMax - 1 : static_cast<int>(bias));
}

// Thread t's vote in the AutoMapper's rank of y < 20 among its key's 20
// counts h (coder3.mapper_ranks: the stable descending order): count t
// ranks before y.  The rank is the number of votes: a ballot on the card.
NBT_HD bool rank_vote(const int64_t* h, int y, int t) {
  return t < kNMap && (h[t] > h[y] || (t < y && h[t] == h[y]));
}

NBT_HD int mapper_rank(const int64_t* h, int y) {
  int z = 0;
  for (int t = 0; t < kNMap; ++t) z += rank_vote(h, y, t);
  return z;
}

// One pixel's mapper event (coder3.mapper_updates): y < 20 bumps its
// key's count of y, and the key is marked where the add takes that count
// past map_halve.
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <class At>
NBT_HD void mapper_add(const At& at, int64_t* mhist, uint32_t* mmark, int key, int y, int bump,
                       int halve) {
  if (y < kNMap && at.add64(&mhist[key * kNMap + y], bump) + bump > halve)
    at.set(mmark + key / 32, 1u << (key % 32));
}

// One pixel's bias event (strips._bias_update): its raw error into its
// context's sum, one into its count, the context marked where the count
// passes bias_cap.
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <class At>
NBT_HD void bias_add(const At& at, int64_t* bsum, int64_t* bcnt, uint32_t* bmark, int adr,
                     int64_t err, int cap) {
  at.add64(&bsum[adr], err);
  if (at.add64(&bcnt[adr], 1) + 1 > cap) at.set(bmark + adr / 32, 1u << (adr % 32));
}

// The lowest set bit of a nonzero word.
NBT_HD int low_bit(uint32_t bits) {
#if defined(__CUDA_ARCH__)
  return __ffs(bits) - 1;
#else
  return __builtin_ctz(bits);
#endif
}

NBT_HD int bit_count(uint32_t bits) {
#if defined(__CUDA_ARCH__)
  return __popc(bits);
#else
  return __builtin_popcount(bits);
#endif
}

// The mapper's halving, thread t of `n` (coder3.mapper_updates: every
// count of a key whose largest passes map_halve, >> 1), over one image's
// marked keys; a mark stays where the key is still past.  A thread takes a
// mark word and its set bits; `seen`, where given, gets the bits visited.
NBT_HD void sweep_mapper(int64_t* mhist, uint32_t* mmark, int halve, uint32_t* seen, int t,
                         int n) {
  for (int g = t; g < kMapWords; g += n) {
    uint32_t keep = 0;
    const uint32_t marked = mmark[g];
    for (uint32_t bits = marked; bits; bits &= bits - 1) {
      const int b = low_bit(bits);
      int64_t* h = mhist + (32 * g + b) * kNMap;
      int64_t mx = 0;
      for (int j = 0; j < kNMap; ++j) {
        h[j] >>= 1;
        mx = h[j] > mx ? h[j] : mx;
      }
      if (mx > halve) keep |= 1u << b;
    }
    mmark[g] = keep;
    if (seen) seen[g] |= marked;
  }
}

// The bias moments' halving, thread t of `n` (strips._bias_update: both
// moments of a context whose count passes bias_cap, >> 1), as
// sweep_mapper.
NBT_HD void sweep_bias(int64_t* bsum, int64_t* bcnt, uint32_t* bmark, int cap, uint32_t* seen,
                       int t, int n) {
  for (int g = t; g < kBiasWords; g += n) {
    uint32_t keep = 0;
    const uint32_t marked = bmark[g];
    for (uint32_t bits = marked; bits; bits &= bits - 1) {
      const int b = low_bit(bits), k = 32 * g + b;
      bsum[k] >>= 1;
      bcnt[k] >>= 1;
      if (bcnt[k] > cap) keep |= 1u << b;
    }
    bmark[g] = keep;
    if (seen) seen[g] |= marked;
  }
}

// ---- K9: the replay of one image's tables from a walk's pixels

// The replay's constants: the image's strip lanes and the walk's width,
// and the container's replay contract (strips.Tune).
struct ReplayContract {
  int lanes_per_image, w;
  int bias_cap, bias_shrink, map_bump, map_halve;
};

// A launch's columns: the mapper's events of [m0, j1) where `map`, the
// bias moments' of [b0, j1) where `bias`.
struct ReplaySpan {
  int map, m0, bias, b0, j1;
};

// The walk's planes, (W, L) int64 each, the lanes fastest: a pixel's image
// x 3072 + context address and its raw error x - px0 (the bias's), its
// mapper key and folded residual y (the mapper's; null where no launch
// replays the mapper).
struct ReplayPlanes {
  const int64_t* idx;
  const int64_t* dx;
  const int64_t* key;
  const int64_t* y;
  int lanes;
};

// One image's tables: its own rows of the walk's tensors.
struct ReplayTables {
  int64_t* bsum;
  int64_t* bcnt;
  uint32_t* bmark;
  int16_t* btab;
  int64_t* mhist;
  uint32_t* mmark;
  int64_t* order;
};

// What a launch keeps in its CTA's shared memory (8 KB): a bit a context
// and a key its adds touched, the marks as the launch found them, and the
// lists of the entries its sweep visits (touched or marked), as indices.
struct ReplayShared {
  uint32_t btouch[kBiasWords];
  uint32_t mtouch[kMapWords];
  uint32_t marks[kBiasWords + kMapWords];  // the launch's first view of bmark | mmark
  uint16_t ctx[kContexts];
  uint16_t key[kMapKeys];
  int n_ctx, n_key;
};

// Phase (a), thread t of `n`: the touched bits and the lists emptied, the
// marks copied.
NBT_HD void replay_clear(const ReplayTables& tb, ReplayShared& sh, int t, int n) {
  for (int g = t; g < kBiasWords; g += n) sh.btouch[g] = 0;
  for (int g = t; g < kMapWords; g += n) sh.mtouch[g] = 0;
  if (t == 0) sh.n_ctx = sh.n_key = 0;
  for (int g = t; g < kBiasWords + kMapWords; g += n)
    sh.marks[g] = g < kBiasWords ? tb.bmark[g] : tb.mmark[g - kBiasWords];
}

// Phase (b): the columns' events, a thread a pixel (the lanes of a column
// next to each other, as the planes lie; a pixel's mapper and bias planes
// loaded together), each added by a reduction whose result no one reads,
// and noted as touched.  A context or key outside the image's tables is
// dropped (the walks write none).  No mark is set here: phase (d) decides
// them.
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <class At>
NBT_HD void replay_reds(const ReplayContract& c, const ReplayPlanes& p, const ReplayTables& tb,
                        ReplayShared& sh, int img, const ReplaySpan& s, int t, int n,
                        const At& at) {
  const int lpi = c.lanes_per_image;
  const size_t lane0 = static_cast<size_t>(img) * lpi;
  const int n_map = s.map ? lpi * (s.j1 - s.m0) : 0;
  const int n_bias = s.bias ? lpi * (s.j1 - s.b0) : 0;
  for (int task = t; task < (n_map > n_bias ? n_map : n_bias); task += n) {
    const size_t lane = lane0 + task % lpi;
    int64_t key = -1, y = -1, adr = -1, err = 0;
    if (task < n_map) {
      const size_t o = static_cast<size_t>(s.m0 + task / lpi) * p.lanes + lane;
      key = p.key[o];
      y = p.y[o];
    }
    if (task < n_bias) {
      const size_t o = static_cast<size_t>(s.b0 + task / lpi) * p.lanes + lane;
      adr = p.idx[o] - static_cast<int64_t>(img) * kContexts;
      err = p.dx[o];
    }
    if (key >= 0 && key < kMapKeys && y >= 0 && y < kNMap) {  // y >= 20 counts nothing
      const int k = static_cast<int>(key);
      at.red64(tb.mhist + k * kNMap + y, c.map_bump);
      at.or_bits(sh.mtouch + k / 32, 1u << (k % 32));
    }
    if (adr >= 0 && adr < kContexts) {
      const int k = static_cast<int>(adr);
      at.red64(tb.bsum + k, err);
      at.red64(tb.bcnt + k, 1);
      at.or_bits(sh.btouch + k / 32, 1u << (k % 32));
    }
  }
}

// Phase (c), thread t of `n`: the entries the sweep visits listed, a word
// of touched | marked bits a thread (the marks of the tables this launch
// replays).  Counts only grow between sweeps and every unmarked entry is
// at or below its threshold, so an entry past it now is one of these.
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <class At>
NBT_HD void replay_lists(ReplayShared& sh, const ReplaySpan& s, int t, int n, const At& at) {
  for (int g = t; g < kBiasWords + kMapWords; g += n) {
    const bool is_bias = g < kBiasWords;
    if (is_bias ? !s.bias : !s.map) continue;
    const int w = is_bias ? g : g - kBiasWords;
    uint32_t bits = (is_bias ? sh.btouch[w] : sh.mtouch[w]) | sh.marks[g];
    if (!bits) continue;
    uint16_t* list = is_bias ? sh.ctx : sh.key;
    int slot = at.take(is_bias ? &sh.n_ctx : &sh.n_key, bit_count(bits));
    for (; bits; bits &= bits - 1) list[slot++] = static_cast<uint16_t>(32 * w + low_bit(bits));
  }
}

// A listed key's sweep and rewrite (coder3.mapper_updates' halving of a
// key whose largest count passes map_halve, then coder3.mapper_order):
// its 20 counts, halved where past, its mark where still past, and its
// order row, each y at its rank among them.
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <class At>
NBT_HD void replay_key(const ReplayContract& c, const ReplayTables& tb, int key, const At& at) {
  int64_t* row = tb.mhist + key * kNMap;
  int64_t h[kNMap];
  int64_t mx = 0;
#pragma unroll
  for (int j = 0; j < kNMap; ++j) {
    h[j] = at.load(row + j);
    mx = h[j] > mx ? h[j] : mx;
  }
  if (mx > c.map_halve) {
    mx = 0;
#pragma unroll
    for (int j = 0; j < kNMap; ++j) {
      h[j] >>= 1;
      row[j] = h[j];
      mx = h[j] > mx ? h[j] : mx;
    }
  }
  at.put_bit(tb.mmark + key / 32, 1u << (key % 32), mx > c.map_halve);
  int64_t* ord = tb.order + key * kNMap;
  bool small = mx < (int64_t{1} << 26);
#pragma unroll
  for (int j = 0; j < kNMap; ++j) small = small && h[j] >= 0;
  if (small) {
    // each count and its y as one 32-bit key, count high, the lower y the
    // larger (31 - y): the stable descending order is the keys' order
    uint32_t kk[kNMap];
#pragma unroll
    for (int j = 0; j < kNMap; ++j) kk[j] = static_cast<uint32_t>(h[j] << 5) | (31 - j);
#pragma unroll
    for (int y = 0; y < kNMap; ++y) {
      int z = 0;
#pragma unroll
      for (int j = 0; j < kNMap; ++j) z += kk[j] > kk[y];
      ord[z] = y;
    }
  } else {
#pragma unroll
    for (int y = 0; y < kNMap; ++y) ord[mapper_rank(h, y)] = y;
  }
}

// Phase (d), thread t of `n`: each listed entry swept and rewritten by one
// thread: a context's moments halved where its count passes bias_cap
// (strips._bias_update), its mark where it still does, its int16 value
// (context.quantize_bias); a key by replay_key.  Every entry the sweep
// halves is rewritten, touched or not (a halving reorders ties).
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <class At>
NBT_HD void replay_entries(const ReplayContract& c, const ReplayTables& tb,
                           const ReplayShared& sh, const ReplaySpan& s, int t, int n,
                           const At& at) {
  // the keys from the first thread up, the contexts from the last down:
  // where they are fewer than the threads, no warp runs both branches
  const int n_key = s.map ? sh.n_key : 0, n_ctx = s.bias ? sh.n_ctx : 0;
  for (int i = t; i < n_key; i += n) replay_key(c, tb, sh.key[i], at);
  for (int i = n - 1 - t; i < n_ctx; i += n) {
    const int k = sh.ctx[i];
    int64_t cnt = at.load(tb.bcnt + k), sum = at.load(tb.bsum + k);
    if (cnt > c.bias_cap) {
      cnt >>= 1;
      sum >>= 1;
      tb.bcnt[k] = cnt;
      tb.bsum[k] = sum;
    }
    at.put_bit(tb.bmark + k / 32, 1u << (k % 32), cnt > c.bias_cap);
    tb.btab[k] = static_cast<int16_t>(quantize_bias(sum, cnt, c.bias_shrink));
  }
}

// One launch's replay of image `img`: `team` runs a phase on each of its
// threads (`threads(f)`: f(t, n)), ends it with `sync()` and updates the
// tables with `at`: a CTA on the card, virtual threads one after another
// on the host.
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <class Team>
NBT_HD void replay_launch(const ReplayContract& c, const ReplayPlanes& p, const ReplayTables& tb,
                          ReplayShared& sh, int img, const ReplaySpan& s, const Team& team) {
  team.threads([&](int t, int n) { replay_clear(tb, sh, t, n); });
  team.sync();
  team.threads([&](int t, int n) { replay_reds(c, p, tb, sh, img, s, t, n, team.at); });
  team.sync();
  team.threads([&](int t, int n) { replay_lists(sh, s, t, n, team.at); });
  team.sync();
  team.threads([&](int t, int n) { replay_entries(c, tb, sh, s, t, n, team.at); });
}

}  // namespace
