// The profile-3 image-table replay: kernel K9.
//
// K9 replaces no pallas_call: the JAX package replays these tables inside
// the jitted lax.scans of its walks (nblic_tpu/models/strips.py::_decode_seg
// quantizes the bias where a pixel reads it and updates the mapper and the
// moments in the segment scan; _near_rows updates the moments a row).  The
// port's walks run a kernel a row or a column segment (K4, the decode walk;
// K5, the near encoder's feedback walk), and what an image's strip lanes
// share between those launches, the bias moments with their int16 table
// and the mapper history with its order, is K9's: one launch after each K4
// launch (the mapper and, where the moments adapt, the bias) and after
// each K5 launch (the bias alone), on the same stream.  Its plain version
// is nblic_tpu_torch/ops/table_replay.py::replay_plain, the torch sequence
// the walks ran between launches before (strips._bias_update,
// context.quantize_bias, coder3.mapper_updates, coder3.mapper_order).
//
// Mapping: one CTA of kThreads threads an image.  The stream order is the
// barrier across an image's lanes, which span several K4 or K5 CTAs, so
// the replay cannot run in their epilogues.  The tables stay in device
// memory for the whole walk (an image's 3072 x 2 + 10240 int64 and the
// two tables the walk kernels read, 6 KB and 80 KB, all L2-resident);
// what a launch touched and the entries its sweep visits are bits and
// lists in the CTA's shared memory.  What it computes, and the order of
// its phases (the adds, the lists, each listed entry's sweep and
// rewrite), is image_tables.cuh's replay_launch, which the CPU tests run
// with virtual threads.
//
// What bounds K9 on Hopper.  At th 768 a launch replays 16 pixels of one
// image: its time is a launch's latency, a chain of dependent loads,
// reductions and barriers, against ~1 KB moved.  At th 4 (192 lanes an
// image, 16 columns) each CTA adds 3,072 pixels' events that contend on
// few contexts, then sweeps and rewrites up to 3,072 contexts and 512
// keys.  The design keeps that chain short:
// - The adds are reductions whose results no one reads (RED, not an
//   atomic's round trip), and no mark is set on the way.  (Summing a
//   warp's equal addresses first, by __match_any_sync and
//   __reduce_add_sync, made the adds 7-11x slower: the groups' masks
//   diverge.)
// - The marks are decided where the sweep visits an entry: over the
//   entries touched or marked, listed in shared memory (a word a thread),
//   each swept and rewritten by one thread, so every thread's work is a
//   few entries whatever the launch, and nothing walks the untouched ones.
// - A key's order is ranked from its 20 counts held in registers, as
//   32-bit keys (count, 31 - y) where the counts allow.
// - One team for every launch: 512 threads.  Teams of 32 and 128 were no
//   faster at a th-768 launch's 16 pixels an image and slower at a th-4
//   corpus's 3,072 (kernel_probe.py replay-phases builds and times them).

#include <cstdint>
#include <cuda_runtime.h>

#include "image_tables.cuh"

namespace {

constexpr int kThreads = 512;  // threads a CTA (an image)

// The CTA as replay_launch's team.
struct BlockTeam {
  DeviceAtomics at;
  template <class F>
  __device__ __forceinline__ void threads(F f) const {
    f(static_cast<int>(threadIdx.x), kThreads);
  }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

// The walk's tables of every image, image-major: bias moments and their
// int16 table (n_imgs x 3072), their marks (n_imgs x 96 words), the mapper
// history and its order (n_imgs x 512 x 20), their marks (n_imgs x 16).
struct WalkTables {
  int64_t* bsum;
  int64_t* bcnt;
  uint32_t* bmark;
  int16_t* btab;
  int64_t* mhist;
  uint32_t* mmark;
  int64_t* order;
};

__global__ void __launch_bounds__(kThreads)
    p3_table_replay_kernel(ReplayContract c, ReplayPlanes p, WalkTables w, ReplaySpan s) {
  __shared__ ReplayShared sh;
  const int img = blockIdx.x;
  const size_t ctx = static_cast<size_t>(img) * kContexts;
  const size_t map = static_cast<size_t>(img) * kMapKeys * kNMap;
  const ReplayTables tb{w.bsum + ctx,
                        w.bcnt + ctx,
                        w.bmark + static_cast<size_t>(img) * kBiasWords,
                        w.btab + ctx,
                        w.mhist + map,
                        w.mmark + static_cast<size_t>(img) * kMapWords,
                        w.order + map};
  replay_launch(c, p, tb, sh, img, s, BlockTeam{});
}

}  // namespace

// K9 over `n_imgs` images of lanes / n_imgs strip lanes each: the mapper's
// events of columns [m0, j1) where `map`, the bias moments' of [b0, j1)
// where `bias`.  idx, dx, key, y: the walk's (W, L) int64 planes (key and
// y may be null without `map`); the tables as WalkTables, each on
// `device`, contiguous; w the walk's width and bias_cap .. map_halve the replay
// contract's (strips.Tune).  Launches one CTA an image on `stream`;
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// contract or columns out of range, or a table it needs missing).
extern "C" int nbt_p3_table_replay(const int64_t* idx, const int64_t* dx, const int64_t* key,
                                   const int64_t* y, int64_t* bsum, int64_t* bcnt,
                                   uint32_t* bmark, int16_t* btab, int64_t* mhist,
                                   uint32_t* mmark, int64_t* order, int lanes, int n_imgs, int w,
                                   int bias_cap, int bias_shrink, int map_bump, int map_halve,
                                   int map, int m0, int bias, int b0, int j1, int device,
                                   void* stream) {
  const bool cols_ok =
      j1 <= w && (!map || (0 <= m0 && m0 < j1)) && (!bias || (0 <= b0 && b0 < j1));
  const bool tables_ok = idx && dx && (!map || (key && y)) && bsum && bcnt && bmark && btab &&
                         mhist && mmark && order;
  if (n_imgs < 1 || lanes < 1 || lanes % n_imgs || !cols_ok || !tables_ok || (!map && !bias) ||
      bias_cap < 1 || map_halve < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ReplayContract c{lanes / n_imgs, w, bias_cap, bias_shrink, map_bump, map_halve};
  const ReplayPlanes p{idx, dx, key, y, lanes};
  const WalkTables t{bsum, bcnt, bmark, btab, mhist, mmark, order};
  const ReplaySpan s{map, m0, bias, b0, j1};
  p3_table_replay_kernel<<<n_imgs, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(c, p, t, s);
  return static_cast<int>(cudaGetLastError());
}
