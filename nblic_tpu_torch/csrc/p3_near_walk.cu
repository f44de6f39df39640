// The profile-3 near-lossless reconstruction-feedback walk: kernel K5.
//
// K5 replaces no pallas_call: the JAX package runs this walk,
// nblic_tpu/models/strips.py::_near_rows, as a jitted lax.scan that XLA
// compiles.  Its plain version is
// nblic_tpu_torch/models/strips.py::_near_walk_plain, a Python loop over
// the th x W pixel steps with ~800 small launches each, which took 97-98%
// of a profile-3 near encode on the card.  One launch computes one row of
// that walk for every strip lane; the row loop, the bias table's
// quantization and the bias moments' update stay in torch
// (strips._near_walk_card), since an image's lanes meet only there.
//
// A lane at row i: first the F chain, the previous row's B accumulated
// right to left (and the mix chain's under mix_e), into the scratch f;
// then its W pixels in order.  Per pixel: the causal window over
// *reconstructed* pixels and the t tap; the AVP prediction, the ridge
// solve of E + F (int64 Gaussian elimination with partial pivoting), and
// under mix_e its blend with the simple prediction; the dual-bin activity
// quantizers and the context address; the row-frozen bias of the lane's
// image; the near fold of the original pixel into the symbol y and the
// unfold to the reconstruction xr; then B's column j, E and the carried
// error take xr.  The chain is avp_chain.cuh's (the window and contexts
// pixel_chain.cuh's).
//
// What bounds K5 on Hopper.  Not the bytes: a pixel reads and writes its
// column of B and reads its column of F (3 x 111 int64 at n = 10), ~2.7 KB
// a lane, against ~500 64-bit divisions and ~17,000 other operations.  A
// lane's pixels are serial, so a step's time is one lane's chain a pixel,
// and the lanes are few: 4,608 at the corpus's th 4, one an image at the
// default th 768.  The design puts one warp on a lane (avp_chain.cuh):
// the chain's ~500 serial divisions become ~2 x 9 dependent levels, each
// of a few multiply-high quotients by one shared reciprocal; B, F and E
// are laid out channels fastest (B and F (L, W, m)), so a warp's loads of
// a column coalesce, and column j + 1's B and F are loaded into registers
// while pixel j runs (each thread reads back only its own channels, so no
// shared staging is needed).  A CTA holds `warps` warps (1 to 4), each a
// lane; lanes past the count exit as whole warps, and the only barriers
// are each warp's own.

#include <cstdint>
#include <cuda_runtime.h>

#include "avp_chain.cuh"

namespace {

constexpr int kMaxWarps = 4;  // warps (lanes) a CTA at most

// K5, row i: warp `lane` walks its strip's row.  x: (W, lanes) originals
// of the row; bias: (n_images, 3072) int16; p1 / p2: (W, lanes) rows i-1
// and i-2 of the reconstruction, row i written into p2 behind the read
// frontier (pixel j reads column j + 3 of row i-2 and overwrites column
// j); b and f: (lanes, W, m); bm and fm: (lanes, W, 2) (kMix); out: five
// planes y, qu, qv, qw, key of (W, lanes) at the row, plane_stride apart;
// idx: image x 3072 + the context address; dx: xr - px0.
template <int kN, bool kMix>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
    p3_near_row_kernel(const uint8_t* __restrict__ x, const int16_t* __restrict__ bias,
                       uint8_t* p1, uint8_t* p2, int64_t* __restrict__ b,
                       int64_t* __restrict__ f, int64_t* __restrict__ bm,
                       int64_t* __restrict__ fm, int lanes, int lanes_per_image, int w, int i,
                       int near, long long plane_stride, int32_t* __restrict__ out,
                       int64_t* __restrict__ idx, int64_t* __restrict__ dx) {
  constexpr int kM = avp_m<kN>(), kS = avp_slots<kN>();
  __shared__ AvpShared<kN> shm[kMaxWarps];
  const int t = threadIdx.x % kWarp, wid = threadIdx.x / kWarp;
  const int lane = blockIdx.x * (blockDim.x / kWarp) + wid;
  if (lane >= lanes) return;  // the whole warp: its barriers are its own
  AvpShared<kN>& sh = shm[wid];
  const size_t n_l = static_cast<size_t>(lanes);
  const long long img_off = static_cast<long long>(lane / lanes_per_image) * kCtx;
  const int16_t* btab = bias + img_off;
  int64_t* bl = b + static_cast<size_t>(lane) * w * kM;
  int64_t* fl = f + static_cast<size_t>(lane) * w * kM;
  int64_t* bml = kMix ? bm + static_cast<size_t>(lane) * w * 2 : nullptr;
  int64_t* fml = kMix ? fm + static_cast<size_t>(lane) * w * 2 : nullptr;

  // F of the row from the previous row's B
  warp_f_chain<kS, kBeta, kAlpha>(bl, fl, w, kM, t);
  if constexpr (kMix) {
    if (t < 2) warp_f_chain<1, kBeta, kBeta>(bml, fml, w, 2, t);
    __syncwarp();  // the mix F is read by every thread
  }
  const Slots<kN> sl = slots_of<kN>(t);
  int64_t e[kS], bc[kS], fc[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) e[s] = 0;
  int64_t em[2] = {0, 0};
  load_col(bl, kM, t, bc);
  load_col(fl, kM, t, fc);

  Window v = row_start(p1, p2, i, w, lanes, lane);
  int err = 0;
  for (int j = 0; j < w; ++j) {
    // column j + 1's B and F, in flight while pixel j runs
    int64_t bn[kS], fn[kS];
    load_col(bl + static_cast<size_t>(j + 1) * kM, j + 1 < w ? kM : 0, t, bn);
    load_col(fl + static_cast<size_t>(j + 1) * kM, j + 1 < w ? kM : 0, t, fn);
    const size_t at = static_cast<size_t>(j) * n_l + lane;
    const int up1 = (i > 0 && j + 2 < w) ? p1[at + 2 * n_l] : 0;
    const int up2 = (i > 1 && j + 3 < w) ? p2[at + 3 * n_l] : 0;
    const int px_s = simple_predict(v);
    const int feat = avp_feature<kN>(v, (i >= 1 && j + 2 < w) ? up1 : v.d, t);
    if (t < kN) sh.feat[t] = feat;

    const int64_t s0 = warp_system<kN>(e, fc, sl, sh);  // channel 0 of E + F
    __syncwarp();
    int64_t num;
    const bool ok = warp_solve<kN>(sh, t, num);
    const int64_t px_f = warp_predict<kN>(sh, num, feat, t);
    const int px_hard = ok ? round_px(px_f) : px_s;
    int px0 = px_hard;
    int64_t bmc[2];
    if constexpr (kMix) {
      const int64_t* fmj = fml + 2 * j;
      bmc[0] = bml[2 * j];
      bmc[1] = bml[2 * j + 1];
      if (ok) px0 = mix_blend(px_hard, px_s, wadd(em[0], fmj[0]), wadd(em[1], fmj[1]));
    }

    const int delta = activity(v, err);
    int qu, qv, qw;
    n_quantize_activity(delta, qu, qv, qw);
    const int adr = context_adr(v, px0, quantize_activity(delta));
    int sign, pxc, key;
    pixel_correct(px0, btab[adr], sign, pxc, key);
    const int y = fold(x[at], pxc, sign, near);
    const int xr = unfold<false>(y, pxc, sign, near);
    err = clampi(xr - px0, -kMaxPxInc, kMaxPxInc);

    warp_update<kN>(xr, px_s, s0, sh.feat, sl, e, bc, bl + static_cast<size_t>(j) * kM, t);
    if constexpr (kMix) mix_update(xr, px_hard, px_s, em, bmc);
    if (t == 0) {
      if constexpr (kMix) {
        bml[2 * j] = bmc[0];
        bml[2 * j + 1] = bmc[1];
      }
      int32_t* o = out + at;
      o[0] = y;
      o[plane_stride] = qu;
      o[2 * plane_stride] = qv;
      o[3 * plane_stride] = qw;
      o[4 * plane_stride] = key;
      idx[at] = img_off + adr;
      dx[at] = xr - px0;
      p2[at] = static_cast<uint8_t>(xr);
    }
    slide(v, xr, i, j, w, up1, up2);
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      bc[s] = bn[s];
      fc[s] = fn[s];
    }
    __syncwarp();  // the pixel's reads of sh before the next pixel's writes
  }
}

template <int kN, bool kMix>
int launch(const uint8_t* x, const int16_t* bias, uint8_t* p1, uint8_t* p2, int64_t* b,
           int64_t* f, int64_t* bm, int64_t* fm, int lanes, int lanes_per_image, int w, int i,
           int near, long long plane_stride, int32_t* out, int64_t* idx, int64_t* dx,
           int warps, cudaStream_t stream) {
  const unsigned ctas = static_cast<unsigned>((lanes + warps - 1) / warps);
  p3_near_row_kernel<kN, kMix><<<ctas, warps * kWarp, 0, stream>>>(
      x, bias, p1, p2, b, f, bm, fm, lanes, lanes_per_image, w, i, near, plane_stride, out,
      idx, dx);
  return static_cast<int>(cudaGetLastError());
}

// The warp chain alone, for its tests: one warp a system, the solve and
// the prediction of avp_chain.cuh at the general instance (any n <= 12).
__global__ void __launch_bounds__(kWarp)
    avp_solve_kernel(const int64_t* __restrict__ a, const int* __restrict__ feats, int n,
                     int64_t* __restrict__ diag, int64_t* __restrict__ num,
                     int* __restrict__ ok, int64_t* __restrict__ px) {
  __shared__ AvpShared<kNTaps> sh;
  const int t = threadIdx.x;
  const size_t sys = blockIdx.x;
  const int64_t* as = a + sys * n * (n + 1);
  for (int k = t; k < n * (n + 1); k += kWarp) sh.a[k / (n + 1)][k % (n + 1)] = as[k];
  const int feat = t < n ? feats[sys * n + t] : 0;
  __syncwarp();
  int64_t x;
  const bool good = warp_solve<kNTaps>(sh, t, x, n);
  const int64_t p = warp_predict<kNTaps>(sh, x, feat, t, n);
  if (t < n) {
    diag[sys * n + t] = sh.a[t][t];
    num[sys * n + t] = x;
  }
  if (t == 0) {
    ok[sys] = good;
    px[sys] = p;
  }
}

}  // namespace

// K5, one row.  x: (W, lanes) uint8 originals of row i; bias: (lanes /
// lanes_per_image, 3072) int16; p1, p2: (W, lanes) uint8 rows i-1 and i-2,
// row i written into p2; b, f: (lanes, W, 1 + n + n^2) int64, b the
// columns' moments (updated in place), f scratch; bm, fm: (lanes, W, 2)
// int64 with mix_e, else null; out: five (W, lanes) int32 planes
// plane_stride elements apart (y, qu, qv, qw, key); idx, dx: (W, lanes)
// int64.  n_feat must be 10; near in 1..255; warps (lanes a CTA) in 1..4.
// Launches ceil(lanes / warps) CTAs of 32 warps threads on `stream`;
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// another n_feat or warps).
extern "C" int nbt_p3_near_row(const uint8_t* x, const int16_t* bias, uint8_t* p1, uint8_t* p2,
                               int64_t* b, int64_t* f, int64_t* bm, int64_t* fm, int lanes,
                               int lanes_per_image, int w, int i, int near, int n_feat,
                               long long plane_stride, int32_t* out, int64_t* idx,
                               int64_t* dx, int warps, int device, void* stream) {
  if (n_feat != 10 || warps < 1 || warps > kMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto s = static_cast<cudaStream_t>(stream);
  return bm != nullptr
             ? launch<10, true>(x, bias, p1, p2, b, f, bm, fm, lanes, lanes_per_image, w, i,
                                near, plane_stride, out, idx, dx, warps, s)
             : launch<10, false>(x, bias, p1, p2, b, f, bm, fm, lanes, lanes_per_image, w, i,
                                 near, plane_stride, out, idx, dx, warps, s);
}

// The warp chain's test entry: `systems` augmented n x (n + 1) int64
// systems a (systems, n, n + 1) and their int32 features (systems, n), n
// in 1..12, one warp each; writes each system's diagonal and solution
// numerators (systems, n), its ok (systems,) int32 and its FB1 prediction
// (systems,) int64, as avp.solve_batch and avp.predict_from_solve.
extern "C" int nbt_avp_solve(const int64_t* a, const int* feats, int n, int systems,
                             int64_t* diag, int64_t* num, int* ok, int64_t* px, int device,
                             void* stream) {
  if (n < 1 || n > kNTaps || systems < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (systems == 0) return 0;
  avp_solve_kernel<<<systems, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(a, feats, n, diag,
                                                                              num, ok, px);
  return static_cast<int>(cudaGetLastError());
}
