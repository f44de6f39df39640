// Lockstep decode of NBTC profile-1 interleave groups (kernel K2).
//
// Replaces the profile-1 branch of
// nblic_tpu/ops/pallas_decode.py::decode_groups_pallas, the TPU kernel, and
// computes what nblic_tpu_torch/ops/decode.py::group_decode_plain computes.
// The g tile lanes of a group walk their th x tw tiles in raster order in
// lockstep.  Per pixel: the 11-register causal window (fresh at each row
// start, slid per column), the blend prediction, the 12-bin activity and
// the context address, the static bias (1/16 px plus the sign bit), the
// symbol search y = #{v : acc[qd][v] <= state & 0x7FFF} - 1, the state
// update, the renormalization against ONE shared stream cursor (each lane
// that needs a word takes the word at cursor + its exclusive rank among the
// needing lanes), and the near-aware unfold.
//
// What bounds it on Hopper: latency.  Every pixel is a serial chain per lane
// (model -> table reads -> search -> state -> cursor -> next pixel) with two
// block barriers for the cursor, and a group has only g lanes.  Design: one
// CTA per group and one thread per lane, so the cursor's prefix is a warp
// ballot plus a cross-warp sum in shared memory; state, window registers and
// carried error stay in registers; the bias (int16), frequency and
// cumulative tables (uint16) and the two previous rows (uint8, lane fastest)
// sit in shared memory, about 34 KB at 64x64 tiles and g = 128.  The output
// is (groups, th, tw, g), so each pixel's store coalesces across the lanes.
// A Kodak-shaped image at 64x64 tiles is one group, so a batch of 24 images
// fills 24 of the 132 SMs (left for later).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCtx = 3072;  // 12 activity bins x 256 texture patterns
constexpr int kTableBytes = 3 * kCtx * 2;
constexpr int kWarpBytes = 32 * 4;

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

__global__ void group_decode_kernel(const int32_t* __restrict__ streams, int W,
                                    const int32_t* __restrict__ n_active,
                                    const int32_t* __restrict__ bias,
                                    const int32_t* __restrict__ hist_n,
                                    const int32_t* __restrict__ acc, int npg,
                                    int th, int tw, int near,
                                    uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* bias_s = reinterpret_cast<int16_t*>(smem);
  uint16_t* freq_s = reinterpret_cast<uint16_t*>(smem + 2 * kCtx);
  uint16_t* acc_s = reinterpret_cast<uint16_t*>(smem + 4 * kCtx);
  int* warp_tot = reinterpret_cast<int*>(smem + kTableBytes);
  uint8_t* rows = smem + kTableBytes + kWarpBytes;

  const int g = blockDim.x;
  const int lane = threadIdx.x;
  const int gi = blockIdx.x;
  const int img = gi / npg;
  for (int k = lane; k < kCtx; k += g) {
    bias_s[k] = static_cast<int16_t>(bias[img * kCtx + k]);
    freq_s[k] = static_cast<uint16_t>(hist_n[img * kCtx + k]);
    acc_s[k] = static_cast<uint16_t>(acc[img * kCtx + k]);
  }
  __syncthreads();

  const int32_t* stream = streams + static_cast<size_t>(gi) * W;
  uint32_t state = (static_cast<uint32_t>(stream[lane] & 0xFFFF) << 16) |
                   static_cast<uint32_t>(stream[g + lane] & 0xFFFF);
  int sp = 2 * g;
  const bool active = lane < n_active[gi];
  const int warp = lane >> 5;
  const int n_warps = g >> 5;
  const unsigned lanemask_lt = (1u << (lane & 31)) - 1u;
  const int qstep = 2 * near + 1;
  uint8_t* out_g = out + static_cast<size_t>(gi) * th * tw * g;

  // p1 holds row i-1.  p2 holds row i-2, and row i is written into it behind
  // the read frontier (pixel j reads p2 at column j+3 and writes column j),
  // so two row buffers suffice; they swap at each row end.
  uint8_t* p1 = rows;
  uint8_t* p2 = rows + tw * g;

  for (int i = 0; i < th; ++i) {
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
      const int px0 = simple_predict(a, b, c, d, e, f, gg, h, q, r, s);
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

      // renormalize against the shared cursor
      const bool need = active && state < (1u << 16);
      const unsigned ballot = __ballot_sync(0xFFFFFFFFu, need);
      if ((lane & 31) == 0) warp_tot[warp] = __popc(ballot);
      __syncthreads();
      int base = 0, total = 0;
      for (int w = 0; w < n_warps; ++w) {
        const int t = warp_tot[w];
        base += w < warp ? t : 0;
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
      const int nd = i <= 0 ? x : (j + 2 >= tw ? d : p1[(j + 2) * g + lane]);
      const int nr = i <= 1 ? nd : (j + 3 >= tw ? r : p2[(j + 3) * g + lane]);
      p2[j * g + lane] = static_cast<uint8_t>(x);
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
    uint8_t* t = p1;
    p1 = p2;
    p2 = t;
  }
}

}  // namespace

// Dynamic shared memory of one CTA: tables, warp totals and two rows.
extern "C" long long nbt_group_decode_smem(int tw, int g) {
  return static_cast<long long>(kTableBytes) + kWarpBytes +
         2LL * tw * g;
}

// streams: (G, W) int32 u16 words; n_active: (G,); bias: (B, 3072) int32;
// hist_n/acc: (B, 12, 256) int32, with G = B * npg.  out: (G, th, tw, g)
// uint8.  g is the block size: a multiple of 32, at most 1024.  Launches on
// `stream`; returns cudaGetLastError() after the launch.
extern "C" int nbt_group_decode(const int32_t* streams, int W,
                                const int32_t* n_active, const int32_t* bias,
                                const int32_t* hist_n, const int32_t* acc,
                                int n_groups, int npg, int g, int th, int tw,
                                int near, uint8_t* out, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long smem = nbt_group_decode_smem(tw, g);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(group_decode_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  group_decode_kernel<<<n_groups, g, static_cast<size_t>(smem),
                        static_cast<cudaStream_t>(stream)>>>(
      streams, W, n_active, bias, hist_n, acc, npg, th, tw, near, out);
  return static_cast<int>(cudaGetLastError());
}
