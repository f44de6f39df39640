// The tiled near-lossless reconstruction-feedback scan, profiles 1 and 2:
// kernel K7.
//
// K7 replaces no pallas_call: the JAX package runs this scan,
// nblic_tpu/models/tiled.py::_tile_encode_scan, as a jax.vmap of a nested
// lax.scan that XLA compiles.  Its plain version is
// nblic_tpu_torch/ops/near_scan.py::encode_scan_plain, a Python loop over
// the th x tw pixel steps with a dozen small launches each, which took
// ~99% of a near-lossless encode on the card.  K7 computes what it
// computes.  Every tile lane walks its tile in raster order; per pixel: the
// 11-register causal window over *reconstructed* pixels (fresh at each row
// start, slid per column), the blend prediction (profile 2: or the lane's
// least-squares prediction, or their mean, by the lane's flag), the 12-bin
// activity on the carried error and the context address, the image's
// static bias, the near fold of the original pixel into the symbol y, and
// the unfold to the reconstruction; the carried error is x_rec - px0.  It
// is K2's per-pixel chain (pixel_chain.cuh) with a fold where K2 reads a
// symbol.
//
// What bounds K7 on Hopper.  Not the bytes (a pixel reads 4 bytes and
// writes 8, or 20 with the statistics) and not the card's operations: a
// lane's pixels are serial, each pixel's window needs the previous
// pixel's reconstruction, and the lanes are few (the corpus's landscape
// batch at 64 x 64 tiles is 1,728 lanes, 54 warps on 132 SMs).  So the time
// is th x tw times the chain's latency a pixel: prediction, context
// address, a shared-memory bias read, two divisions by the quantizer step,
// the unfold.  The design keeps everything else off that chain:
// - One warp of lanes of one image a CTA, so that 54 warps spread over 54
//   SMs and no warp waits for another's issue slots.  Lanes share nothing,
//   so the pixel loop has no barrier; the one barrier follows the
//   prologue's table load, after which the threads past the image's tiles
//   leave and write nothing.
// - The image's bias table in shared memory as int16 (6 KB; the container
//   stores it as int16), read once a pixel.
// - The two previous reconstructed rows in shared memory as uint8, lane
//   fastest (row i is written into row i - 2 behind the read frontier,
//   since pixel j reads column j + 3 of row i - 2); each lane reads and
//   writes only its own column.  The window, the carried error and (profile
//   2) the lane's 12 weights and flag stay in registers.
// - The pixels reach the lane through a ring in shared memory, a 4-byte
//   cp.async a pixel requested kXAhead pixels before its read: the load's
//   latency never sits on the chain.
// - The wrapper hands the pixels as a (th x tw, lanes) plane and takes the
//   outputs in the same layout, so each pixel's load and stores coalesce
//   across a warp's lanes.
// - near is a runtime argument, so the divisions stay divisions.

#include <cstdint>
#include <cuda_runtime.h>

#include "pixel_chain.cuh"

namespace {

constexpr int kLanes = 32;   // tile lanes a CTA: one warp, all of one image
constexpr int kXAhead = 4;   // pixels from a ring request to its read
constexpr int kXRing = 8;    // ring slots, a power of two > kXAhead

// K7's dynamic shared memory: bias table (int16) | pixel ring | two rows.
// Offsets in bytes, each 16-byte aligned.
struct ScanLayout {
  int ring, rows, total;
  __host__ __device__ explicit ScanLayout(int tw) {
    ring = 2 * kCtx;
    rows = ring + 4 * kXRing * kLanes;
    total = rows + 2 * tw * kLanes;
  }
};

// K7: CTA blockIdx.x covers tiles [c * 32, c * 32 + 32) of image b, lane =
// threadIdx.x.  xs and the outputs are (th x tw, lanes) int32 planes,
// column b * n_tiles + t for tile t of image b; kStats adds adr (within the
// image's table), x - px0 and x_rec.
template <int kProfile, bool kStats>
__global__ void near_scan_kernel(const int32_t* __restrict__ xs,
                                 const int32_t* __restrict__ bias,
                                 const int32_t* __restrict__ wcols, int n_tiles,
                                 int lanes, int th, int tw, int near,
                                 int32_t* __restrict__ y_out, int32_t* __restrict__ qd_out,
                                 int32_t* __restrict__ adr_out,
                                 int32_t* __restrict__ err_out,
                                 int32_t* __restrict__ rec_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ScanLayout lay(tw);
  int16_t* bias_s = reinterpret_cast<int16_t*>(smem);
  int32_t* ring = reinterpret_cast<int32_t*>(smem + lay.ring);
  uint8_t* p1 = smem + lay.rows;    // row i-1
  uint8_t* p2 = p1 + tw * kLanes;   // row i-2, then row i behind the frontier

  const int lane = threadIdx.x;
  const int ctas = (n_tiles + kLanes - 1) / kLanes;  // CTAs an image
  const int b = blockIdx.x / ctas;
  const int t = (blockIdx.x - b * ctas) * kLanes + lane;
  // the image's table in 16-byte vectors (the wrapper aligns it)
  const int4* bias4 = reinterpret_cast<const int4*>(bias + static_cast<size_t>(b) * kCtx);
  for (int k = lane; k < kCtx / 4; k += kLanes) {
    const int4 bv = bias4[k];
    bias_s[4 * k] = static_cast<int16_t>(bv.x);
    bias_s[4 * k + 1] = static_cast<int16_t>(bv.y);
    bias_s[4 * k + 2] = static_cast<int16_t>(bv.z);
    bias_s[4 * k + 3] = static_cast<int16_t>(bv.w);
  }
  __syncthreads();
  if (t >= n_tiles) return;  // past the last barrier: no tile, no writes

  int w[kWeights];
  int flag = 0;
  if constexpr (kProfile == 2) {
    const int32_t* wl = wcols + static_cast<size_t>(b) * kWRows * n_tiles + t;
#pragma unroll
    for (int k = 0; k < kWeights; ++k) w[k] = wl[static_cast<size_t>(k) * n_tiles];
    flag = wl[static_cast<size_t>(kWeights) * n_tiles];
  }

  // the lane's column of the planes; pixel p of the lane sits at p * lanes
  const size_t col = static_cast<size_t>(b) * n_tiles + t;
  const long long n_px = static_cast<long long>(th) * tw;
  int32_t* slot = ring + lane;  // slot k of this lane: slot[k * kLanes]
  for (int p = 0; p < kXAhead; ++p) {
    if (p < n_px) cp_async4(slot + p * kLanes, xs + p * static_cast<size_t>(lanes) + col);
    cp_async_commit();
  }

  long long p = 0;  // pixel index, raster order
  for (int i = 0; i < th; ++i) {
    Window v = row_start(p1, p2, i, tw, kLanes, lane);
    int err = 0;
    for (int j = 0; j < tw; ++j, ++p) {
      const int up1 = (i > 0 && j + 2 < tw) ? p1[(j + 2) * kLanes + lane] : 0;
      const int up2 = (i > 1 && j + 3 < tw) ? p2[(j + 3) * kLanes + lane] : 0;
      const int qd = activity_bin(v, err);
      const int px0 = predict<kProfile>(v, w, flag);
      const int adr = context_adr(v, px0, qd);
      const int bval = bias_s[adr];
      const int sign = (bval >> 3) & 1;  // arithmetic shift, as in the model
      const int px = clampi(px0 + (bval >> 4) + sign, 0, 255);

      // pixel p's copy is complete once at most kXAhead - 1 younger ones
      // are pending; then request pixel p + kXAhead into the slot read
      // kXRing - kXAhead pixels ago
      cp_async_wait<kXAhead - 1>();
      const int x = slot[(p & (kXRing - 1)) * kLanes];
      const long long ahead = p + kXAhead;
      if (ahead < n_px)
        cp_async4(slot + (ahead & (kXRing - 1)) * kLanes,
                  xs + static_cast<size_t>(ahead) * lanes + col);
      cp_async_commit();

      const int y = fold(x, px, sign, near);
      const int x_rec = unfold<false>(y, px, sign, near);
      err = x_rec - px0;
      const size_t at = static_cast<size_t>(p) * lanes + col;
      y_out[at] = y;
      qd_out[at] = qd;
      if constexpr (kStats) {
        adr_out[at] = adr;
        err_out[at] = x - px0;
        rec_out[at] = x_rec;
      }
      p2[j * kLanes + lane] = static_cast<uint8_t>(x_rec);
      slide(v, x_rec, i, j, tw, up1, up2);
    }
    uint8_t* tmp = p1;
    p1 = p2;
    p2 = tmp;
  }
  cp_async_wait<0>();
}

}  // namespace

// Dynamic shared memory of one K7 CTA at tile width tw.
extern "C" long long nbt_near_scan_smem(int tw) { return ScanLayout(tw).total; }

// K7.  xs: (th x tw, n_images x n_tiles) int32 pixels; bias: (n_images,
// 3072) int32 with values in int16 (the wrapper refuses others), 16-byte
// aligned; wcols: (n_images, 16, n_tiles) int32, rows 0-11 the weights and
// row 12 the flag (profile 2; not read at profile 1); near in 1..255.  y, qd and, when adr is not null,
// adr, err, rec: (th x tw, n_images x n_tiles) int32.  Launches n_images x
// ceil(n_tiles / 32) CTAs of 32 threads on `stream`; returns
// cudaGetLastError() after the launch.
extern "C" int nbt_near_scan(const int32_t* xs, const int32_t* bias, const int32_t* wcols,
                             int n_images, int n_tiles, int th, int tw, int near,
                             int profile, int32_t* y, int32_t* qd, int32_t* adr,
                             int32_t* err, int32_t* rec, int device, void* stream) {
  const long long smem = ScanLayout(tw).total;
  const bool stats = adr != nullptr;
  auto kernel = profile == 2 ? (stats ? near_scan_kernel<2, true> : near_scan_kernel<2, false>)
                             : (stats ? near_scan_kernel<1, true> : near_scan_kernel<1, false>);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long ctas = static_cast<long long>(n_images) * ((n_tiles + kLanes - 1) / kLanes);
  kernel<<<static_cast<unsigned>(ctas), kLanes, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(xs, bias, wcols, n_tiles,
                                                n_images * n_tiles, th, tw, near, y, qd,
                                                adr, err, rec);
  return static_cast<int>(cudaGetLastError());
}
