// Lockstep decode of NBTC profile-1 and profile-2 interleave groups:
// kernel K2 (one group per CTA) and kernel K2' (eight groups per CTA).
//
// K2 replaces nblic_tpu/ops/pallas_decode.py::decode_groups_pallas, the TPU
// kernel, profile-1 and profile-2 branches; K2' replaces
// docs/experiments/pallas_decode8.py::decode_groups_pallas8.  Both compute
// what nblic_tpu_torch/ops/decode.py::group_decode_plain computes.  The g
// tile lanes of a group walk their th x tw tiles in raster order in
// lockstep.  Per pixel: the 11-register causal window (fresh at each row
// start, slid per column), the blend prediction (profile 2: or the lane's
// least-squares prediction, or their mean, by the lane's flag), the 12-bin
// activity and the context address, the static bias (1/16 px plus the sign
// bit), the symbol search y = #{v : acc[qd][v] <= state & 0x7FFF} - 1, the
// state update, the renormalization against ONE shared stream cursor per
// group (each lane that needs a word takes the word at cursor + its
// exclusive rank among the group's needing lanes), and the near-aware
// unfold.
//
// What bounds it on Hopper: latency.  Every pixel is a serial chain per lane
// (model -> table reads -> search -> state -> cursor -> next pixel) with two
// block barriers for the cursor; the bytes (streams, tables, one output byte
// per pixel) and the integer operations (a few hundred per pixel) would take
// microseconds.  Design: one thread per lane, so the cursor's prefix is a
// warp ballot plus a sum over the group's warps in shared memory; state,
// window registers, carried error and (profile 2) the lane's 12 weights and
// flag stay in registers.  The bias (int16), frequency and cumulative tables
// (uint16) sit in shared memory, 18 KB per group.  The output is
// (groups, th, tw, g), so each pixel's store coalesces across the lanes.
//
// K2 keeps the two previous rows (uint8, lane fastest) in shared memory too:
// the current row is written into the row-before-last behind the read
// frontier (pixel j reads column j+3 of row i-2), 34 KB per CTA at 64 x 64
// tiles and g = 128.  A Kodak-shaped image at 64 x 64 tiles is one group, so
// 24 images fill 24 of the 132 SMs.
//
// K2' packs eight groups into one CTA of 8 g threads.  Eight groups' tables
// (144 KB) and their two rows (128 KB at 64 x 64 tiles) would need 272 KB,
// over the 227 KB a block may have.  The tables stay in shared memory,
// because every table read is on the serial chain; the previous rows are
// read back from the output in device memory, because those reads are not:
// each pixel loads the row-above taps for the next pixel's window at its
// start, so the load has the whole pixel to arrive.  147.6 KB of shared
// memory at any tile width.  Packing makes fewer CTAs (24 groups: 3 CTAs).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCtx = 3072;  // 12 activity bins x 256 texture patterns
constexpr int kTableBytes = 3 * kCtx * 2;  // bias, freq, acc as 16-bit
constexpr int kWarpBytes = 32 * 4;         // one count per warp, 32 warps
constexpr int kWeights = 12;               // 11 taps + intercept
constexpr int kWRows = 16;                 // weight rows per lane in wcols

__device__ __forceinline__ int iabs(int v) { return v < 0 ? -v : v; }
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Blend of clipped-linear and best-of-7 angular predictions (effort 0).
__device__ __forceinline__ int simple_predict(int a, int b, int c, int d, int e,
                                              int f, int g, int h, int q, int r,
                                              int s) {
  const int px_lnr = clampi(9 * a + 9 * b + 2 * d - 2 * c - e - f, 0, 16 * 255);
  const int costs[7] = {
      2 * (iabs(a - e) + iabs(c - q) + iabs(b - c) + iabs(d - b)),
      2 * (iabs(a - c) + iabs(c - h) + iabs(b - f) + iabs(d - g)),
      2 * (iabs(a - q) + iabs(c - s) + iabs(b - h) + iabs(d - f)),
      2 * (iabs(a - b) + iabs(c - f) + iabs(b - g) + iabs(d - r)),
      iabs(2 * a - e - q) + iabs(2 * c - q - s) + iabs(2 * b - c - h) +
          iabs(2 * d - b - f),
      iabs(2 * a - q - c) + iabs(2 * c - s - h) + iabs(2 * b - h - f) +
          iabs(2 * d - f - g),
      iabs(2 * a - c - b) + iabs(2 * c - h - f) + iabs(2 * b - f - g) +
          iabs(2 * d - g - r),
  };
  const int preds[7] = {2 * a, 2 * b, 2 * c, 2 * d, a + c, c + b, b + d};
  int cmin = costs[0], px_ang = preds[0], csum = costs[0];
#pragma unroll
  for (int k = 1; k < 7; ++k) {
    csum += costs[k];
    if (cmin > costs[k]) {  // strict: the first minimum wins
      cmin = costs[k];
      px_ang = preds[k];
    }
  }
  csum = min((csum - 7 * cmin) >> 3, 607);
  const int wt = (csum >= 5) + (csum >= 12) + (csum >= 34) + (csum >= 78) +
                 (csum >= 194) + (csum >= 431) + (csum >= 601);
  return (8 * wt * px_ang + (8 - wt) * px_lnr + 64) >> 7;
}

// Profile-2 least-squares prediction: |acc| <= 11 * 32767 * 128 + 32767
// stays below 2^31, and >> is arithmetic, as in nblic_tpu/ops/lsq.py.
__device__ __forceinline__ int lsq_predict(const int (&w)[kWeights], int a,
                                           int b, int c, int d, int e, int f,
                                           int g, int h, int q, int r, int s) {
  const int acc = w[11] + w[0] * (a - 128) + w[1] * (b - 128) +
                  w[2] * (c - 128) + w[3] * (d - 128) + w[4] * (e - 128) +
                  w[5] * (f - 128) + w[6] * (g - 128) + w[7] * (h - 128) +
                  w[8] * (q - 128) + w[9] * (r - 128) + w[10] * (s - 128);
  return clampi(128 + ((acc + 2048) >> 12), 0, 255);
}

// The decode of kGroups groups by one CTA of kGroups * g threads.  Group
// blockIdx.x * kGroups + (threadIdx.x / g) uses table set (its index / npg).
template <int kProfile, int kGroups>
__device__ __forceinline__ void decode_body(
    const int32_t* __restrict__ streams, int W,
    const int32_t* __restrict__ n_active, const int32_t* __restrict__ bias,
    const int32_t* __restrict__ hist_n, const int32_t* __restrict__ acc,
    const int32_t* __restrict__ wcols, int npg, int g, int th, int tw,
    int near, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* bias_all = reinterpret_cast<int16_t*>(smem);
  uint16_t* freq_all = reinterpret_cast<uint16_t*>(smem + 2 * kGroups * kCtx);
  uint16_t* acc_all = reinterpret_cast<uint16_t*>(smem + 4 * kGroups * kCtx);
  int* warp_tot = reinterpret_cast<int*>(smem + kGroups * kTableBytes);

  const int grp = kGroups == 1 ? 0 : threadIdx.x / g;
  const int lane = kGroups == 1 ? threadIdx.x : threadIdx.x % g;
  const int gi = blockIdx.x * kGroups + grp;
  for (int k = threadIdx.x; k < kGroups * kCtx; k += blockDim.x) {
    const int set = (blockIdx.x * kGroups + k / kCtx) / npg;
    const int at = set * kCtx + k % kCtx;
    bias_all[k] = static_cast<int16_t>(bias[at]);
    freq_all[k] = static_cast<uint16_t>(hist_n[at]);
    acc_all[k] = static_cast<uint16_t>(acc[at]);
  }
  const int16_t* bias_s = bias_all + grp * kCtx;
  const uint16_t* freq_s = freq_all + grp * kCtx;
  const uint16_t* acc_s = acc_all + grp * kCtx;

  int w[kWeights];
  int flag = 0;
  if constexpr (kProfile == 2) {
    const int32_t* wl = wcols + static_cast<size_t>(gi) * kWRows * g + lane;
#pragma unroll
    for (int k = 0; k < kWeights; ++k) w[k] = wl[k * g];
    flag = wl[kWeights * g];
  }
  __syncthreads();

  const int32_t* stream = streams + static_cast<size_t>(gi) * W;
  uint32_t state = (static_cast<uint32_t>(stream[lane] & 0xFFFF) << 16) |
                   static_cast<uint32_t>(stream[g + lane] & 0xFFFF);
  int sp = 2 * g;
  const bool active = lane < n_active[gi];
  const int warp = lane >> 5;  // warp within the group
  const int n_warps = g >> 5;
  int* tot = warp_tot + grp * n_warps;
  const unsigned lanemask_lt = (1u << (lane & 31)) - 1u;
  const int qstep = 2 * near + 1;
  uint8_t* out_g = out + static_cast<size_t>(gi) * th * tw * g;

  // K2: p1 holds row i-1.  p2 holds row i-2, and row i is written into it
  // behind the read frontier (pixel j reads p2 at column j+3 and writes
  // column j), so two row buffers suffice; they swap at each row end.
  // K2': p1/p2 point at rows i-1 and i-2 of this group's output.
  uint8_t* rows = smem + kGroups * kTableBytes + kWarpBytes;  // K2 only
  uint8_t* p1 = kGroups == 1 ? rows : out_g;
  uint8_t* p2 = kGroups == 1 ? rows + tw * g : out_g;

  for (int i = 0; i < th; ++i) {
    if constexpr (kGroups > 1) {
      p1 = out_g + static_cast<size_t>(i > 0 ? i - 1 : 0) * tw * g;
      p2 = out_g + static_cast<size_t>(i > 1 ? i - 2 : 0) * tw * g;
    }
    // fresh window at (i, 0)
    int a = i > 0 ? p1[lane] : 128;
    int b = a, e = a, c = a;
    int d = (i > 0 && tw > 1) ? p1[g + lane] : b;
    int f = i > 1 ? p2[lane] : b;
    int gg = (i > 1 && tw > 1) ? p2[g + lane] : f;
    int h = f, q = c;
    int r = (i > 1 && tw > 2) ? p2[2 * g + lane] : gg;
    int s = h;
    int err = 0;

    for (int j = 0; j < tw; ++j) {
      // row-above taps of the next pixel's window, off the serial chain
      const int up1 = (i > 0 && j + 2 < tw) ? p1[(j + 2) * g + lane] : 0;
      const int up2 = (i > 1 && j + 3 < tw) ? p2[(j + 3) * g + lane] : 0;

      int px0 = simple_predict(a, b, c, d, e, f, gg, h, q, r, s);
      if constexpr (kProfile == 2) {
        const int px_l = lsq_predict(w, a, b, c, d, e, f, gg, h, q, r, s);
        px0 = flag == 1 ? px_l : (flag == 2 ? (px0 + px_l + 1) >> 1 : px0);
      }
      const int delta = iabs(a - e) + iabs(b - c) + iabs(b - d) + iabs(a - c) +
                        iabs(b - f) + iabs(d - gg) + 2 * iabs(err);
      const int v = min(delta, 151);
      const int qd = (v >= 1) + (v >= 2) + (v >= 4) + (v >= 6) + (v >= 9) +
                     (v >= 15) + (v >= 25) + (v >= 39) + (v >= 63) +
                     (v >= 101) + (v >= 151);
      const int adr = (qd << 8) | ((px0 > a) << 7) | ((px0 > b) << 6) |
                      ((px0 > c) << 5) | ((px0 > d) << 4) | ((px0 > e) << 3) |
                      ((px0 > f) << 2) | ((px0 > 2 * a - e) << 1) |
                      (px0 > 2 * b - f);
      const int bval = bias_s[adr];
      const int sign = (bval >> 3) & 1;  // arithmetic shift, as in the model
      const int px = clampi(px0 + (bval >> 4) + sign, 0, 255);

      // symbol: the last v with acc[qd][v] <= lb (acc[qd][0] == 0)
      const uint32_t lb = state & 0x7FFFu;
      const uint16_t* arow = acc_s + qd * 256;
      int y = 0;
#pragma unroll
      for (int step = 128; step; step >>= 1)
        if (arow[y + step] <= lb) y += step;
      state = (state >> 15) * freq_s[qd * 256 + y] + lb - arow[y];

      // renormalize against the group's shared cursor
      const bool need = active && state < (1u << 16);
      const unsigned ballot = __ballot_sync(0xFFFFFFFFu, need);
      if ((lane & 31) == 0) tot[warp] = __popc(ballot);
      __syncthreads();
      int base = 0, total = 0;
      for (int k = 0; k < n_warps; ++k) {
        const int t = tot[k];
        base += k < warp ? t : 0;
        total += t;
      }
      __syncthreads();
      if (need) {
        const int at = min(sp + base + __popc(ballot & lanemask_lt), W - 1);
        state = (state << 16) | static_cast<uint32_t>(stream[at] & 0xFFFF);
      }
      sp += total;

      // near-aware unfold (mapYtoX)
      const int ty = (min(px, 255 - px) + near) / qstep;
      int mag, sy;
      if (y <= 0) {
        mag = 0;
        sy = 0;
      } else if (y <= 2 * ty) {
        mag = (y + 1) >> 1;
        sy = (y & 1) ^ sign;
      } else {
        mag = y - ty;
        sy = px < 128;
      }
      mag *= qstep;
      const int x = clampi(px + (sy ? mag : -mag), 0, 255);
      err = x - px0;

      // slide the window one column
      const int nd = i <= 0 ? x : (j + 2 >= tw ? d : up1);
      const int nr = i <= 1 ? nd : (j + 3 >= tw ? r : up2);
      if constexpr (kGroups == 1) p2[j * g + lane] = static_cast<uint8_t>(x);
      out_g[(static_cast<size_t>(i) * tw + j) * g + lane] = static_cast<uint8_t>(x);
      e = a;
      a = x;
      q = c;
      c = b;
      b = d;
      s = h;
      h = f;
      f = gg;
      gg = r;
      d = nd;
      r = nr;
    }
    if constexpr (kGroups == 1) {
      uint8_t* t = p1;
      p1 = p2;
      p2 = t;
    }
  }
}

template <int kProfile>
__global__ void group_decode_kernel(const int32_t* streams, int W,
                                    const int32_t* n_active, const int32_t* bias,
                                    const int32_t* hist_n, const int32_t* acc,
                                    const int32_t* wcols, int npg, int g, int th,
                                    int tw, int near, uint8_t* out) {
  decode_body<kProfile, 1>(streams, W, n_active, bias, hist_n, acc, wcols, npg,
                           g, th, tw, near, out);
}

template <int kProfile>
__global__ void __launch_bounds__(1024, 1)
    group_decode8_kernel(const int32_t* streams, int W, const int32_t* n_active,
                         const int32_t* bias, const int32_t* hist_n,
                         const int32_t* acc, const int32_t* wcols, int npg,
                         int g, int th, int tw, int near, uint8_t* out) {
  decode_body<kProfile, 8>(streams, W, n_active, bias, hist_n, acc, wcols, npg,
                           g, th, tw, near, out);
}

long long smem_bytes(int tw, int g, int groups) {
  return static_cast<long long>(groups) * kTableBytes + kWarpBytes +
         (groups == 1 ? 2LL * tw * g : 0LL);
}

template <typename Kernel>
int launch(Kernel kernel, int blocks, int threads, long long smem,
           const int32_t* streams, int W, const int32_t* n_active,
           const int32_t* bias, const int32_t* hist_n, const int32_t* acc,
           const int32_t* wcols, int npg, int g, int th, int tw, int near,
           uint8_t* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, threads, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(streams, W, n_active, bias,
                                                hist_n, acc, wcols, npg, g, th,
                                                tw, near, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of one CTA decoding `groups` groups (1 or 8).
extern "C" long long nbt_group_decode_smem(int tw, int g, int groups) {
  return smem_bytes(tw, g, groups);
}

// K2.  streams: (G, W) int32 u16 words; n_active: (G,); bias: (B, 3072)
// int32; hist_n/acc: (B, 12, 256) int32, with G = B * npg; wcols: (G, 16, g)
// int32 (profile 2; not read at profile 1).  out: (G, th, tw, g) uint8.  g
// is the block size: a multiple of 32, at most 1024.  Launches on `stream`;
// returns cudaGetLastError() after the launch.
extern "C" int nbt_group_decode(const int32_t* streams, int W,
                                const int32_t* n_active, const int32_t* bias,
                                const int32_t* hist_n, const int32_t* acc,
                                const int32_t* wcols, int n_groups, int npg,
                                int g, int th, int tw, int near, int profile,
                                uint8_t* out, int device, void* stream) {
  const long long smem = smem_bytes(tw, g, 1);
  if (profile == 2)
    return launch(group_decode_kernel<2>, n_groups, g, smem, streams, W,
                  n_active, bias, hist_n, acc, wcols, npg, g, th, tw, near, out,
                  device, stream);
  return launch(group_decode_kernel<1>, n_groups, g, smem, streams, W, n_active,
                bias, hist_n, acc, wcols, npg, g, th, tw, near, out, device,
                stream);
}

// K2'.  The arguments of nbt_group_decode with one table set per group
// (npg = 1) and G a multiple of 8; each CTA of 8 g threads decodes 8 groups.
extern "C" int nbt_group_decode8(const int32_t* streams, int W,
                                 const int32_t* n_active, const int32_t* bias,
                                 const int32_t* hist_n, const int32_t* acc,
                                 const int32_t* wcols, int n_groups, int npg,
                                 int g, int th, int tw, int near, int profile,
                                 uint8_t* out, int device, void* stream) {
  const long long smem = smem_bytes(tw, g, 8);
  if (profile == 2)
    return launch(group_decode8_kernel<2>, n_groups / 8, 8 * g, smem, streams,
                  W, n_active, bias, hist_n, acc, wcols, npg, g, th, tw, near,
                  out, device, stream);
  return launch(group_decode8_kernel<1>, n_groups / 8, 8 * g, smem, streams, W,
                n_active, bias, hist_n, acc, wcols, npg, g, th, tw, near, out,
                device, stream);
}
