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
// address, a shared-memory bias read, the fold and the unfold.  The design
// keeps everything else off that chain:
// - One warp of lanes of one image a CTA, so that 54 warps spread over 54
//   SMs and no warp waits for another's issue slots.  Lanes share nothing,
//   so the pixel loop has no barrier; the one barrier follows the
//   prologue's table load, after which the threads past the image's tiles
//   leave and write nothing.
// - The image's bias table in shared memory as int32 (12 KB), read once a
//   pixel: the kernel computes the plain scan for any int32 table, so the
//   wrapper reads nothing back to check one.
// - The two previous reconstructed rows in shared memory as uint8, lane
//   fastest (row i is written into row i - 2 behind the read frontier,
//   since pixel j reads column j + 3 of row i - 2); each lane reads and
//   writes only its own column.  The window, the carried error and (profile
//   2) the lane's 12 weights and flag stay in registers.
// - The kernel reads and writes the tiles' own (B, T, th, tw) layout, the
//   one the encoder's other stages use, so the wrapper copies nothing.  A
//   lane's pixels are contiguous, a warp's lanes 1 KB (16x16) to 16 KB
//   (64x64) apart, so a warp's access is 32 segments: each must be whole
//   32-byte sectors, or the L2 merges half-written sectors with reads from
//   device memory (a first design moving 16 bytes a lane ran 2.5x slower
//   at 16x16).  Where tw is a multiple of 8, a lane's 8 pixels (one
//   sector) reach it through a ring in shared memory by two 16-byte
//   cp.async requested 16 pixels before their read, and its 8 outputs of
//   a plane leave from registers as two 16-byte stores; the lane-major
//   ring rows are padded so that a warp's 16-byte reads hit distinct
//   banks.  Other widths move a pixel a 4-byte copy and store.
// - The fold and the unfold are one function (pixel_chain.cuh's
//   near_fold): ty once, both quotients by the step as a multiply-high by
//   its reciprocal, computed once a launch, where three divisions by a
//   runtime step stood (35% of a step before, by kernel_probe.py
//   near-scan-phases).

#include <cstdint>
#include <cuda_runtime.h>

#include "pixel_chain.cuh"

namespace {

constexpr int kLanes = 32;  // tile lanes a CTA: one warp, all of one image

// K7's movement of a lane's pixels, kG of them a chunk (8: one sector, by
// two 16-byte copies and two 16-byte stores a plane, where tw is a
// multiple of 8; else 1): the ring holds kRingChunks chunks, a chunk
// requested kAhead chunks before its read, each lane's ring row padded to
// kRingStride words.
template <int kG>
struct Chunks {
  static constexpr int kRingChunks = kG == 8 ? 4 : 8;
  static constexpr int kAhead = kG == 8 ? 2 : 4;
  static constexpr int kRingStride = kG == 8 ? kG * kRingChunks + 4 : kRingChunks + 1;
};

// K7's dynamic shared memory: bias table (int32) | pixel ring | two rows.
// Offsets in bytes, each 16-byte aligned.
struct ScanLayout {
  int ring, rows, total;
  __host__ __device__ ScanLayout(int tw, int g) {
    ring = 4 * kCtx;
    const int ring_words = g == 8 ? Chunks<8>::kRingStride : Chunks<1>::kRingStride;
    rows = ring + ((4 * ring_words * kLanes + 15) & ~15);
    total = rows + 2 * tw * kLanes;
  }
};

// What K7 writes of one pixel.
struct PixelOut {
  int y, qd, adr, err, rec;
};

// One pixel (i, j) of a lane's chain, x its original value: the window
// over the reconstructed rows p1 (row i - 1) and p2 (row i - 2, then row
// i behind the frontier) and the carried error in, both updated.
template <int kProfile>
__device__ __forceinline__ PixelOut near_pixel(Window& v, int& err, int x, int i, int j, int tw,
                                               const uint8_t* p1, uint8_t* p2, int lane,
                                               const int32_t* bias_s,
                                               const int (&w)[kWeights], int flag, int near,
                                               uint32_t recip) {
  const int up1 = (i > 0 && j + 2 < tw) ? p1[(j + 2) * kLanes + lane] : 0;
  const int up2 = (i > 1 && j + 3 < tw) ? p2[(j + 3) * kLanes + lane] : 0;
  const int qd = activity_bin(v, err);
  const int px0 = predict<kProfile>(v, w, flag);
  const int adr = context_adr(v, px0, qd);
  const int bval = bias_s[adr];
  const int sign = (bval >> 3) & 1;  // arithmetic shift, as in the model
  const int px = clampi(px0 + (bval >> 4) + sign, 0, 255);
  const NearFold f = near_fold(x, px, sign, near, recip);
  err = f.x_rec - px0;
  p2[j * kLanes + lane] = static_cast<uint8_t>(f.x_rec);
  slide(v, f.x_rec, i, j, tw, up1, up2);
  return {f.y, qd, adr, x - px0, f.x_rec};
}

// 8 ints to a 16-byte aligned address: one sector, two 16-byte stores.
__device__ __forceinline__ void store8(int32_t* at, const int (&v)[8]) {
  reinterpret_cast<int4*>(at)[0] = make_int4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<int4*>(at)[1] = make_int4(v[4], v[5], v[6], v[7]);
}

// K7: CTA blockIdx.x covers tiles [c * 32, c * 32 + 32) of image b, lane =
// threadIdx.x.  xs and the outputs are (B, T, th, tw) int32, tile t of
// image b at (b * n_tiles + t) * th * tw; kStats adds adr (within the
// image's table), x - px0 and x_rec.  recip: near_recip(near).  kG = 8
// needs tw a multiple of 8 and xs and the outputs 16-byte aligned.
template <int kProfile, bool kStats, int kG>
__global__ void near_scan_kernel(const int32_t* __restrict__ xs,
                                 const int32_t* __restrict__ bias,
                                 const int32_t* __restrict__ wcols, int n_tiles, int th,
                                 int tw, int near, uint32_t recip,
                                 int32_t* __restrict__ y_out, int32_t* __restrict__ qd_out,
                                 int32_t* __restrict__ adr_out,
                                 int32_t* __restrict__ err_out,
                                 int32_t* __restrict__ rec_out) {
  using C = Chunks<kG>;
  extern __shared__ __align__(16) unsigned char smem[];
  const ScanLayout lay(tw, kG);
  int32_t* bias_s = reinterpret_cast<int32_t*>(smem);
  uint8_t* p1 = smem + lay.rows;    // row i-1
  uint8_t* p2 = p1 + tw * kLanes;   // row i-2, then row i behind the frontier

  const int lane = threadIdx.x;
  const int ctas = (n_tiles + kLanes - 1) / kLanes;  // CTAs an image
  const int b = blockIdx.x / ctas;
  const int t = (blockIdx.x - b * ctas) * kLanes + lane;
  // the image's table in 16-byte vectors (the wrapper aligns it)
  const int4* bias4 = reinterpret_cast<const int4*>(bias + static_cast<size_t>(b) * kCtx);
  for (int k = lane; k < kCtx / 4; k += kLanes) reinterpret_cast<int4*>(bias_s)[k] = bias4[k];
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

  // the lane's tile: pixel p of it at base + p
  const long long n_px = static_cast<long long>(th) * tw;
  const size_t base = (static_cast<size_t>(b) * n_tiles + t) * static_cast<size_t>(n_px);
  const int32_t* x_tile = xs + base;
  int32_t* ring = reinterpret_cast<int32_t*>(smem + lay.ring) + lane * C::kRingStride;
  auto request = [&](long long chunk) {
    if (chunk * kG < n_px) {
      int32_t* dst = ring + (chunk % C::kRingChunks) * kG;
      if constexpr (kG == 8) {
        cp_async16(dst, x_tile + chunk * kG);
        cp_async16(dst + 4, x_tile + chunk * kG + 4);
      } else {
        cp_async4(dst, x_tile + chunk);
      }
    }
    cp_async_commit();
  };
  for (int k = 0; k < C::kAhead; ++k) request(k);

  long long p = 0;  // pixel index, raster order
  for (int i = 0; i < th; ++i) {
    Window v = row_start(p1, p2, i, tw, kLanes, lane);
    int err = 0;
    // a chunk's copy is complete once at most kAhead - 1 younger ones are
    // pending; then the chunk kAhead ahead is requested into the slot read
    // kRingChunks - kAhead chunks ago.  Off the chain: x waits only in the
    // fold.
    if constexpr (kG == 8) {
      for (int j0 = 0; j0 < tw; j0 += kG, p += kG) {
        const long long c = p / kG;
        cp_async_wait<C::kAhead - 1>();
        const int4* slot = reinterpret_cast<const int4*>(ring + (c % C::kRingChunks) * kG);
        const int4 xa = slot[0], xb = slot[1];
        request(c + C::kAhead);
        const int xv[kG] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
        int ys[kG], qds[kG], adrs[kG], errs[kG], recs[kG];
#pragma unroll
        for (int k = 0; k < kG; ++k) {
          const PixelOut o = near_pixel<kProfile>(v, err, xv[k], i, j0 + k, tw, p1, p2, lane,
                                                  bias_s, w, flag, near, recip);
          ys[k] = o.y;
          qds[k] = o.qd;
          adrs[k] = o.adr;
          errs[k] = o.err;
          recs[k] = o.rec;
        }
        // the chunk's 8 pixels, one sector a plane
        store8(y_out + base + p, ys);
        store8(qd_out + base + p, qds);
        if constexpr (kStats) {
          store8(adr_out + base + p, adrs);
          store8(err_out + base + p, errs);
          store8(rec_out + base + p, recs);
        }
      }
    } else {
      for (int j = 0; j < tw; ++j, ++p) {
        cp_async_wait<C::kAhead - 1>();
        const int x = ring[p % C::kRingChunks];
        request(p + C::kAhead);
        const PixelOut o = near_pixel<kProfile>(v, err, x, i, j, tw, p1, p2, lane, bias_s, w,
                                                flag, near, recip);
        const size_t at = base + p;
        y_out[at] = o.y;
        qd_out[at] = o.qd;
        if constexpr (kStats) {
          adr_out[at] = o.adr;
          err_out[at] = o.err;
          rec_out[at] = o.rec;
        }
      }
    }
    uint8_t* tmp = p1;
    p1 = p2;
    p2 = tmp;
  }
  cp_async_wait<0>();
}

using ScanKernel = decltype(&near_scan_kernel<1, false, 8>);

template <int kG>
ScanKernel pick(int profile, bool stats) {
  return profile == 2 ? (stats ? near_scan_kernel<2, true, kG> : near_scan_kernel<2, false, kG>)
                      : (stats ? near_scan_kernel<1, true, kG> : near_scan_kernel<1, false, kG>);
}

}  // namespace

// Dynamic shared memory of one K7 CTA at tile width tw and chunk g (8 or 1).
extern "C" long long nbt_near_scan_smem(int tw, int g) { return ScanLayout(tw, g).total; }

// K7.  xs: (n_images, n_tiles, th, tw) int32 pixels in [0, 255]; bias:
// (n_images, 3072) int32, 16-byte aligned; wcols: (n_images, 16, n_tiles)
// int32, rows 0-11 the weights and row 12 the flag (profile 2; not read at
// profile 1); near in 1..255.  y, qd and, when adr is not null, adr, err,
// rec: int32 of xs's shape.  Where tw is a multiple of 8 and xs and every
// output start 16-byte aligned, a lane moves 8 pixels a chunk, else one.
// Launches n_images x ceil(n_tiles / 32) CTAs of 32 threads on `stream`;
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// near outside 1..255).
extern "C" int nbt_near_scan(const int32_t* xs, const int32_t* bias, const int32_t* wcols,
                             int n_images, int n_tiles, int th, int tw, int near,
                             int profile, int32_t* y, int32_t* qd, int32_t* adr,
                             int32_t* err, int32_t* rec, int device, void* stream) {
  if (near < 1 || near > 255) return static_cast<int>(cudaErrorInvalidValue);
  const bool stats = adr != nullptr;
  bool vec = tw % 8 == 0;
  for (const void* ptr : {static_cast<const void*>(xs), static_cast<const void*>(y),
                          static_cast<const void*>(qd), static_cast<const void*>(adr),
                          static_cast<const void*>(err), static_cast<const void*>(rec)})
    vec = vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  const int g = vec ? 8 : 1;
  const long long smem = ScanLayout(tw, g).total;
  auto kernel = vec ? pick<8>(profile, stats) : pick<1>(profile, stats);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long ctas = static_cast<long long>(n_images) * ((n_tiles + kLanes - 1) / kLanes);
  kernel<<<static_cast<unsigned>(ctas), kLanes, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(xs, bias, wcols, n_tiles, th, tw, near,
                                                near_recip(near), y, qd, adr, err, rec);
  return static_cast<int>(cudaGetLastError());
}
