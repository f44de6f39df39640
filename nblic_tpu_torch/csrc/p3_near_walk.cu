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
// a lane, against ~500 runtime 64-bit divisions (~375 in the solve, 10 in
// the prediction, 110 in the moments), each a routine of nvcc's.  A lane's
// pixels are serial, so the time is th x W times one lane's chain a pixel,
// and the lanes are few (4,608 at the corpus's th 4, 144 warps; one an
// image at th 768).  The design is the simple one: one thread a lane, one
// warp a CTA (the warps spread over the SMs), lanes fastest in every
// array so a warp's loads and stores coalesce; E, the system and the
// features in the thread's local memory (cached in L1); no shared memory
// and no barrier.  Sharing a lane's solve across a warp is later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "avp_chain.cuh"

namespace {

constexpr int kWalkLanes = 32;  // lanes a CTA: one warp

// K5, row i: thread `lane` walks its strip's row.  x: (W, lanes) originals
// of the row; bias: (n_images, 3072) int16; p1 / p2: (W, lanes) rows i-1
// and i-2 of the reconstruction, row i written into p2 behind the read
// frontier (pixel j reads column j + 3 of row i-2 and overwrites column
// j); b and f: (W, m, lanes); bm and fm: (W, 2, lanes) (kMix); out: five
// planes y, qu, qv, qw, key of (W, lanes) at the row, plane_stride apart;
// idx: image x 3072 + the context address; dx: xr - px0.
template <int kN, bool kMix>
__global__ void __launch_bounds__(kWalkLanes)
    p3_near_row_kernel(const uint8_t* __restrict__ x, const int16_t* __restrict__ bias,
                       uint8_t* p1, uint8_t* p2, int64_t* __restrict__ b,
                       int64_t* __restrict__ f, int64_t* __restrict__ bm,
                       int64_t* __restrict__ fm, int lanes, int lanes_per_image, int w, int i,
                       int near, long long plane_stride, int32_t* __restrict__ out,
                       int64_t* __restrict__ idx, int64_t* __restrict__ dx) {
  constexpr int kM = avp_m<kN>();
  const int lane = blockIdx.x * kWalkLanes + threadIdx.x;
  if (lane >= lanes) return;  // no barrier follows: an idle thread writes nothing
  const size_t n_l = static_cast<size_t>(lanes);
  const long long img_off = static_cast<long long>(lane / lanes_per_image) * kCtx;
  const int16_t* btab = bias + img_off;

  int64_t e[kM];
  int64_t em[2] = {0, 0};
  // F of the row from the previous row's B (e serves as the scratch)
  f_chain<kM, kBeta, kAlpha>(b + lane, f + lane, w, n_l, e);
  if constexpr (kMix) f_chain<2, kBeta, kBeta>(bm + lane, fm + lane, w, n_l, em);
  for (int c = 0; c < kM; ++c) e[c] = 0;
  em[0] = em[1] = 0;

  Window v = row_start(p1, p2, i, w, lanes, lane);
  int err = 0;
  for (int j = 0; j < w; ++j) {
    const size_t at = static_cast<size_t>(j) * n_l + lane;
    const int up1 = (i > 0 && j + 2 < w) ? p1[at + 2 * n_l] : 0;
    const int up2 = (i > 1 && j + 3 < w) ? p2[at + 3 * n_l] : 0;
    const int px_s = simple_predict(v);
    int feat[kN];
    avp_features<kN>(v, (i >= 1 && j + 2 < w) ? up1 : v.d, feat);

    const size_t col = static_cast<size_t>(j) * kM * n_l + lane;  // channel c at + c * n_l
    int64_t a[kN][kN + 1];
    ridge_system<kN>(e, f + col, n_l, a);
    const int64_t s0 = wadd(e[0], f[col]);  // channel 0 of E + F
    const bool ok = ridge_solve<kN>(a);
    const int px_hard = ok ? round_px(predict_from_solve<kN>(a, feat)) : px_s;
    int px0 = px_hard;
    if constexpr (kMix) {
      const size_t mcol = static_cast<size_t>(j) * 2 * n_l + lane;
      if (ok)
        px0 = mix_blend(px_hard, px_s, wadd(em[0], fm[mcol]), wadd(em[1], fm[mcol + n_l]));
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

    avp_update<kN>(xr, px_s, feat, s0, e, b + col, n_l);
    if constexpr (kMix)
      mix_update(xr, px_hard, px_s, em, bm + static_cast<size_t>(j) * 2 * n_l + lane, n_l);

    int32_t* o = out + at;
    o[0] = y;
    o[plane_stride] = qu;
    o[2 * plane_stride] = qv;
    o[3 * plane_stride] = qw;
    o[4 * plane_stride] = key;
    idx[at] = img_off + adr;
    dx[at] = xr - px0;
    p2[at] = static_cast<uint8_t>(xr);
    slide(v, xr, i, j, w, up1, up2);
  }
}

template <int kN, bool kMix>
int launch(const uint8_t* x, const int16_t* bias, uint8_t* p1, uint8_t* p2, int64_t* b,
           int64_t* f, int64_t* bm, int64_t* fm, int lanes, int lanes_per_image, int w, int i,
           int near, long long plane_stride, int32_t* out, int64_t* idx, int64_t* dx,
           cudaStream_t stream) {
  const unsigned ctas = static_cast<unsigned>((lanes + kWalkLanes - 1) / kWalkLanes);
  p3_near_row_kernel<kN, kMix><<<ctas, kWalkLanes, 0, stream>>>(
      x, bias, p1, p2, b, f, bm, fm, lanes, lanes_per_image, w, i, near, plane_stride, out,
      idx, dx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K5, one row.  x: (W, lanes) uint8 originals of row i; bias: (lanes /
// lanes_per_image, 3072) int16; p1, p2: (W, lanes) uint8 rows i-1 and i-2,
// row i written into p2; b, f: (W, 1 + n + n^2, lanes) int64, b the
// columns' moments (updated in place), f scratch; bm, fm: (W, 2, lanes)
// int64 with mix_e, else null; out: five (W, lanes) int32 planes
// plane_stride elements apart (y, qu, qv, qw, key); idx, dx: (W, lanes)
// int64.  n_feat must be 10; near in 1..255.  Launches ceil(lanes / 32)
// CTAs of 32 threads on `stream`; returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for another n_feat).
extern "C" int nbt_p3_near_row(const uint8_t* x, const int16_t* bias, uint8_t* p1, uint8_t* p2,
                               int64_t* b, int64_t* f, int64_t* bm, int64_t* fm, int lanes,
                               int lanes_per_image, int w, int i, int near, int n_feat,
                               long long plane_stride, int32_t* out, int64_t* idx,
                               int64_t* dx, int device, void* stream) {
  if (n_feat != 10) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto s = static_cast<cudaStream_t>(stream);
  return bm != nullptr
             ? launch<10, true>(x, bias, p1, p2, b, f, bm, fm, lanes, lanes_per_image, w, i,
                                near, plane_stride, out, idx, dx, s)
             : launch<10, false>(x, bias, p1, p2, b, f, bm, fm, lanes, lanes_per_image, w, i,
                                 near, plane_stride, out, idx, dx, s);
}
