#!/usr/bin/env python3
"""Probes of the port's kernels (K1-K11) and of its encodes, on one NVIDIA GPU.

    python3 kernel_probe.py [--parent PATH] PROBE [PROBE ...]

PROBE is one of:
  cut-chain  variants of K2 (csrc/group_decode.cu) with one link of its
             per-pixel chain cut each, timed at the main path's shape: two
             512x768 images at 64x64 tiles, two groups of 128 lanes,
             profile 1.  Their output is wrong on purpose.  Also K2's
             wrapper against its launch alone there and at 288 groups of
             16x16 tiles.  With --parent PATH, the same for PATH, a
             group_decode.cu of the design before the staged stream (two
             block barriers a pixel, the 8-step symbol search, the stream
             word read from device memory, a division by the quantizer step).
  slot-bits  K2 with a slot table of k = 8..12 bits, at profiles 1 and 2
             at the main path's shape and at 288 groups of 16x16 tiles.
  k2-width   K2 (csrc/group_decode.cu) as it stands, and with --before
             PATH (repeatable) each group_decode.cu PATH too, named by its
             file's stem, at the main path's shape
             (two groups of 128 lanes at 64x64 tiles, profiles 1 and 2) and
             at 288 groups of 16x16 tiles: each held against the package's
             kernel, profile 1 at 64x64 against the plain decoder too.
  fold       K1 (csrc/rans_fold.cu) with blocks of 32, 64 and 128 streams
             at 3072 x 4096, its launch alone and the package's wrapper.
  near-stages  one near-lossless encode batch (18 synthetic 512x768 images,
             near 2, effort 1, 64x64 tiles), after a lossless warm-up,
             stage by stage with a device sync after each: the lossless
             proxy, the refinement scan and the final scan (each through
             K7, csrc/near_scan.cu, whose launches it counts), the coding
             tail with K1, container assembly, with the scans' share; the
             first image's container held against encode_batch's of that
             image alone; then the final scan over one image's tiles alone.
             Builds no variant.
  build      the package's build (kernels.build: one nvcc a csrc/*.cu
             source, all started together, then one link) against one
             `nvcc -shared` of every source, each from nothing into
             build/probe/, two rounds in opposite orders.  Builds no variant.
  p3-stages  one profile-3 encode of a synthetic 768x512 image at the
             default strip height (768: one strip), after a small warm-up,
             stage by stage as chip_smoke.py times the corpus: modeling, row
             scan, fold, packing and containers; with each stage's time a
             step (a row's column segment, a fold step).  Builds no
             variant.
  p3-corpus  profile-3 encode of a synthetic corpus shaped as chip_smoke.py's
             (18 512x768 and 6 768x512 images) as one strips.encode_batch at
             strip height 64, after a small warm-up, twice, stage by stage as
             chip_smoke.py times it.  Runs on the package beside it, so a
             copy of this file beside an older checkout times that one.
             Builds no variant.
  p3-model   the profile-3 modeling pass (ops/model_pass.py) at one
             768x512 image at strip height 768 (one lane) and at a
             synthetic corpus at 64 (288 lanes), TUNE_V4: the plain pass's
             parts on the card (the energy chains, the moment chains in
             blocks of 10 channels, the chunked solve, the mix chains and
             the blend; host clock and a sync each), then the kernels' in
             the same call (features; K10's energy launch, its moment
             launch, its mix launch; K11; the blend; CUDA events, median
             of 3), each part's output held to the plain one's, with the
             peak device memory of each path; then the plain pass at th
             768 and the kernels' under torch.profiler: their device
             launches.  Builds no variant.
  p3-model-forms  kernel K10 (csrc/p3_model_chains.cu) of the package
             beside copies with 2 and 8 steps between barriers (the
             package 4) and with 4 and 16 rows a thread in the 32-lane
             layout (the package 8), and the package with the moments'
             layout forced to 1 and to 32 channel lanes a warp, each the
             model's statistics at p3-model's two shapes, held exact to
             the package's, two rounds in opposite orders.
  p3-model-phases  kernels K10 (statistics, mix launch) and K11 at
             p3-model's two shapes: the package's, and K11's copies with
             two batches of systems in shared memory and with the next
             batch prefetched into L2, beside the parent design's
             (--parent: its csrc/, e.g. from `git archive` unpacked in
             build/: a two-pass K10 with its 2 GiB scratch and a
             warp-a-system K11), two rounds in opposite orders, each held
             exact to the other; then builds
             stamped by clock64() at each phase's end, each thread's
             cycles summed by phase: the package's K10 (hand-off,
             contributions, chains and stores, barrier; a thread's step)
             and K11 (staging, pivot searches, reciprocals, elimination,
             back substitution, prediction; a system), and the parent's,
             its stamps put in by text (K10's B pass and E/F pass by loads
             and chains; K11's statistics and system, pivot searches,
             reciprocals, elimination rounds, back substitution and
             prediction on a warp's first lane), each held exact; then
             K10's statistics in each design at the corpus's strip
             heights 128 and 256.
  p3-decode  the profile-3 decode walk (kernel K4) on the card: a
             48x64 and a 64x48 image as one batch at strip height 16 under
             TUNE_V4, TUNE_MAX, TUNE_V4S and TUNE_V1, each round trip held
             to the images, with the walk's time a pixel step; then TUNE_V4
             on 1, 64 and 1024 images of 64x16 (4, 256 and 4096 strip lanes,
             256 steps each), the step time against the lane count.  Builds
             no variant.
  p3-near    the profile-3 near-lossless encode (near 2; the walk on K5,
             the rest plain PyTorch) on
             the card, stage by stage (the feedback walk, the row coder, the
             fold, packing and containers; the stage functions called
             directly on strips of synthetic images, each lane its own
             image): 4, 256 and 1152 lanes of 16-column strips 16 rows tall
             and of 512-column strips 4 rows tall, the walk's time a pixel
             step against the lane count (the host's share against the
             lanes'); the smallest case's container held against the CPU's;
             then a walk row of 32 columns at 1152 lanes under
             torch.profiler: its device time against the wall time and its
             device launches a step.  Builds no variant.
  p3-walk    kernels K5 (csrc/p3_near_walk.cu) and K4
             (csrc/p3_decode_walk.cu), one warp a strip lane: the package's
             build with ptxas's registers and spills of each instance (when
             it builds); by cuobjdump -sass, the routines each instance
             calls (nvcc's 64-bit divisions) with their instructions and
             call sites (the whole listing goes to
             build/probe/p3_walk_sass.txt); then K5's time a pixel step at 1,
             32, 1152 and 4608 lanes of 512-column strips (2 rows each; the
             row loop's torch work included) and K4's at as many 16x16
             strips of 1-4 images (th 16, TUNE_V4: a launch a column, the
             replays included, each decode held to the images), each at 1,
             2 and 4 warps a CTA.  Builds no variant.
  p3-walk-bounds  K5 and K4 variants timed in turns beside the package's
             kernels at 4 warps a CTA, each held exact to them: with
             __launch_bounds__'s minimum of 5 and 9 CTAs an SM (registers
             capped at 102 and 56, for 20 and 36 resident warps), and with
             --chain-before DIR, on the avp_chain.cuh and udiv64.cuh in DIR;
             K5 at 1 and 4,608 lanes of 2 x 512, K4 on a corpus-shaped th-4
             input's first 2 rows (4,608 lanes).  Also K5 with one part of
             its chain cut (the reciprocals, the elimination, the back
             substitution, the moment update, the F chain; WALK_CUTS), whose
             output is wrong on purpose (reported, not failed on).
  p3-decode-feat  K4's three instances (10, 6 and the general one at 12
             AVP features) timed in turns beside variants of
             csrc/p3_decode_walk.cu (--decode-variant DIR, repeatable: DIR
             holds a p3_decode_walk.cu and any headers of its own, the
             package's csrc/ behind them), each held exact to the
             package's kernel: the ptxas registers and spills of every
             build, then K4 on a corpus-shaped th-4 input's first 2 rows
             (4,608 lanes) and on one 768x512 image at th 768 (one lane),
             its first 8 rows, TUNE_V4, the replays between launches
             included.
  p3-scan-phases  kernels K8 (csrc/p3_row_scan.cu) and K3
             (csrc/bin_fold.cu) of the package beside this file, split into
             their parts: K8 built with its block barrier stamping clock64()
             on each CTA's first thread, so each barrier-to-barrier interval
             is summed as the walk, the adds or the sweeps of a segment (the
             interval after the tables' set-up is the first walk's), as
             the package picks its walk and, where it has the choice,
             with the walk forced a pixel a thread; K8 at one lane (a
             768x512 image at strip height 768), at the th-64 corpus (24
             images, 12 lanes each) and as the near-2 coder of the th-4
             corpus (192 lanes an image), each launch held exact to the
             package's kernel; K3 at the same three scans' slots, the
             package's kernel in turns beside copies with its division cut
             and with its live step cut (wrong output on purpose): the
             split of a step into division, slot work and the ring.  A copy
             of this file beside an older checkout splits that checkout's
             kernels.
  near-scan-phases  kernel K7 (csrc/near_scan.cu) of the package beside
             this file at chip_smoke.py's shapes (the 18 landscape images
             of a synthetic corpus at near 2, their effort-1 containers'
             bias tables; 1,728 lanes of 64x64 and 27,648 of 16x16, profiles
             1 and 2 with the statistics): its wrapper and its launch alone
             (two rounds in opposite orders), then a build whose chain reads
             clock64() on every thread once each part's value is ready,
             summed by part on each CTA's first lane (the ring wait; the
             activity, prediction and context address; the bias read; the
             fold and unfold; the stores and the slide), in cycles a pixel
             step, held exact to the package's kernel.
  replay-phases  kernel K9 (csrc/p3_table_replay.cu) of the package beside
             this file on the middle launch of two decode walks, as
             chip_smoke.py times them (a synthetic corpus at strip height 4,
             24 images x 192 lanes, and its first image at 768, one lane,
             4 rows): the package's kernel in turns beside copies with one
             phase cut (wrong output on purpose: the zeroing, the adds, the
             sweeps or the lists, the rewrite or the listed entries' sweep
             and rewrite) and copies at 32 and 128 threads a CTA (held
             exact), each on the device behind a sleep; then builds whose
             barriers read clock64() on each CTA's first thread, the cycles
             of each phase at each team, held exact to the package's.  A
             copy of this file beside an older checkout (`git archive` into
             build/) measures that checkout's K7 and K9.
  interop    the interop engines (plain PyTorch, one lane) on the card: the
             Q0.2 encode of a synthetic 768x512 image and of a flat one (every
             pixel one context: the context chain's longest walk) with the
             chain and the fold (K1 at S = 1) timed, K1 held against its
             plain version on a crop's tables; the Q0.2 decode walk and the
             NBLIC0.3 walk (effort 1 near 0 and 2, effort 3; encode and
             decode) on full-width crops, each container held against the
             port's native runtime, in ms a pixel; one profiled
             NBLIC0.3 row: device time and launches a pixel.  Builds the
             native runtime, no variant.

Each variant is a copy of a source with some lines replaced, built by nvcc
into build/probe/ (all builds run at once) and called through ctypes; none
enters the package.  A replacement that no longer matches its source stops
the probe with the lines it looked for.  Every variant that is meant to be
exact is held against the package's kernel or the plain version.  Times
are CUDA-event medians of 20 launches, two rounds in opposite orders.
Run from the repository root.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import inspect
import io
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from nblic_tpu_torch import kernels
from nblic_tpu_torch.convert import group_args
from nblic_tpu_torch.models import tiled
from nblic_tpu_torch.ops import decode, fold, near_scan, rans
from nblic_tpu_torch.utils.synth import synth_image

PROBE_DIR = kernels.BUILD_DIR.parent / "probe"
CLOCK_HZ = 1.98e9  # the boost clock (Hopper white paper): cycles to time
K2_SRC = kernels.CSRC / "group_decode.cu"
K1_SRC = kernels.CSRC / "rans_fold.cu"
WALK_SRCS = {"k5": kernels.CSRC / "p3_near_walk.cu", "k4": kernels.CSRC / "p3_decode_walk.cu"}
# K10 (p3_model_chains.cu) forms: the steps between barriers (with a ring
# deep enough, model_chain.cuh: 2 chunks + 1), the rows a thread of the
# wavefront (the package's 2)
K10_SRC = kernels.CSRC / "p3_model_chains.cu"
K11_SRC = kernels.CSRC / "p3_model_solve.cu"
K10_CHUNK = ("constexpr int kChainChunk = 4;", "constexpr int kChainRing = 16;")
K10_CHUNKS = {2: 16, 8: 32}
K10_ROWS_LINE = "constexpr int kWaveRows = 2;"
K10_ROWS = (4, 8)
# K11 (p3_model_solve.cu) with its instance for any count (12) at n = 10
K11_N10_LINE = "  if (n == 10)\n    return w_quant ?"
# K11 with two batches of systems in shared memory (the next one's copies
# in flight while this one is solved); and with the next batch's
# statistics prefetched into L2 (one bulk prefetch, whole 16 B) before
# this batch is solved
K11_STAGES_LINE = "constexpr int kStages = 1;"
K11_L2_PREFETCH = (
    "    if (kStages > 1) stage(base + step, sys + ((b + 1) % kStages) * kWords);\n",
    "    if (lane == 0 && base + step < rows) {\n"
    "      const long long nxt = base + step;\n"
    "      const unsigned bytes = static_cast<unsigned>("
    "(rows - nxt < kSys ? rows - nxt : kSys) * m * 8) & ~15u;\n"
    "      if (bytes > 0)\n"
    "        asm volatile(\"cp.async.bulk.prefetch.L2.global [%0], %1;\\n\" "
    "::\"l\"(stats + nxt * m), \"r\"(bytes) : \"memory\");\n"
    "    }\n")
# p3-model-phases: the parent design's K10 and K11 with clock64() stamps
# put in by text (their phases' ends), each thread's sums added into
# nbt_probe_phase by atomics at its end
MODEL_STAMP_PRELUDE = r"""
#ifndef NBT_PROBE_PHASE_DECLARED
__device__ unsigned long long nbt_probe_phase[8];
#endif
extern "C" int nbt_probe_phases(unsigned long long* dst, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(dst, nbt_probe_phase, 8 * sizeof(unsigned long long));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    err = cudaMemcpyToSymbol(nbt_probe_phase, zero, sizeof(zero));
  }
  return static_cast<int>(err);
}
#define NBT_T0 long long nbt_last = clock64(); \
  unsigned long long nbt_acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#define NBT_AT(i) { const long long nbt_now = clock64(); nbt_acc[i] += nbt_now - nbt_last; \
  nbt_last = nbt_now; }
#define NBT_FLUSH(cond) if (cond) for (int nbt_i = 0; nbt_i < 8; ++nbt_i) \
  atomicAdd(&nbt_probe_phase[nbt_i], nbt_acc[nbt_i]);
"""
# the parent's K10: the B pass's loads and contributions (0), its chain and
# stores (1); the E/F pass's F loads (2), F chain and stores (3), E's
# loads (B and F read back, 4), E's chain and stores (5); threads of each
# pass (6, 7)
K10_PARENT_STAMPS = [
    ("namespace {\n\nconstexpr int kThreads = 256;",
     MODEL_STAMP_PRELUDE + "namespace {\n\nconstexpr int kThreads = 256;"),
    ("  int64_t bv = 0;\n", "  int64_t bv = 0;\n  NBT_T0\n"),
    ("                  : 0;\n#pragma unroll\n",
     "                  : 0;\n    NBT_AT(0)\n#pragma unroll\n"),
    ("        a.b[(px_top + static_cast<long long>(i0 + u) * a.w) * a.k + c] = bv;\n      }\n"
     "    }\n  }\n}\n",
     "        a.b[(px_top + static_cast<long long>(i0 + u) * a.w) * a.k + c] = bv;\n      }\n"
     "    }\n    NBT_AT(1)\n  }\n  nbt_acc[6] = 1;\n  NBT_FLUSH(true)\n}\n"),
    ("  const int seg = a.seg;  // 1 where plain: every column a start\n",
     "  const int seg = a.seg;  // 1 where plain: every column a start\n  NBT_T0\n"),
    ("    for (int u = 0; u < kAhead; ++u) bu[u] = (i > 0 && j0 - u >= 0) ? "
     "b_up[(j0 - u) * k] : 0;\n",
     "    for (int u = 0; u < kAhead; ++u) bu[u] = (i > 0 && j0 - u >= 0) ? "
     "b_up[(j0 - u) * k] : 0;\n    NBT_AT(2)\n"),
    ("        at = at == 0 ? seg - 1 : at - 1;\n      }\n    }\n  }\n",
     "        at = at == 0 ? seg - 1 : at - 1;\n      }\n    }\n    NBT_AT(3)\n  }\n"),
    ("        at_u = at_u == seg - 1 ? 0 : at_u + 1;\n      }\n    }\n",
     "        at_u = at_u == seg - 1 ? 0 : at_u + 1;\n      }\n    }\n    NBT_AT(4)\n"),
    ("        at = at == seg - 1 ? 0 : at + 1;\n      }\n    }\n  }\n}\n",
     "        at = at == seg - 1 ? 0 : at + 1;\n      }\n    }\n    NBT_AT(5)\n  }\n"
     "  nbt_acc[7] = 1;\n  NBT_FLUSH(true)\n}\n"),
]
K10_PARENT_PHASES = ("B loads and contributions", "B chain and stores", "F loads",
                     "F chain and stores", "E loads (B, F read back)", "E chain and stores")
# the parent's K11 (a warp a system), on each warp's first lane: the
# statistics' load and the system (0), the whole solve (1: 2 to 5), inside
# it (avp_chain.cuh's warp_solve) the pivot searches and swaps (2), the
# reciprocals (3), the elimination rounds (4), the back substitution (5);
# the prediction (6); the systems (7)
K11_PARENT_STAMPS = [
    ("namespace {\n\nconstexpr int kWarps = 4;",
     MODEL_STAMP_PRELUDE + "namespace {\n\nconstexpr int kWarps = 4;"),
    ("  const long long step = static_cast<long long>(gridDim.x) * kWarps;\n",
     "  const long long step = static_cast<long long>(gridDim.x) * kWarps;\n  NBT_T0\n"),
    ("    warp_system<kN>(st, none, sl, sh, n);\n    __syncwarp();\n",
     "    warp_system<kN>(st, none, sl, sh, n);\n    __syncwarp();\n    NBT_AT(0)\n"),
    ("    const bool ok = warp_solve<kN>(sh, t, num, n);\n",
     "    const bool ok = warp_solve<kN>(sh, t, num, n);\n    NBT_AT(1)\n"),
    ("    __syncwarp();  // this row's reads of sh before the next row's system\n  }\n}\n",
     "    NBT_AT(6)\n    nbt_acc[7] += 1;\n"
     "    __syncwarp();  // this row's reads of sh before the next row's system\n  }\n"
     "  NBT_FLUSH(t == 0)\n}\n"),
]
AVP_PARENT_STAMPS = [
    ("namespace {\n\nconstexpr int kNTaps = 12;",
     "__device__ unsigned long long nbt_probe_phase[8];\n#define NBT_PROBE_PHASE_DECLARED\n"
     "#define NBT_SOLVE_AT(i) { const long long nbt_now = clock64(); nbt_p[i] += nbt_now - "
     "nbt_s; nbt_s = nbt_now; }\nnamespace {\n\nconstexpr int kNTaps = 12;"),
    ("  bool ok = true;\n  for (int k = 0; k < n - 1; ++k) {\n    // the pivot",
     "  bool ok = true;\n  long long nbt_s = clock64();\n"
     "  unsigned long long nbt_p[4] = {0, 0, 0, 0};\n"
     "  for (int k = 0; k < n - 1; ++k) {\n    // the pivot"),
    ("      __syncwarp();\n    }\n    const int64_t d = sh.a[k][k];\n",
     "      __syncwarp();\n    }\n    NBT_SOLVE_AT(0)\n    const int64_t d = sh.a[k][k];\n"),
    ("    if (t == 0) sh.dv[k] = dv;\n", "    if (t == 0) sh.dv[k] = dv;\n    NBT_SOLVE_AT(1)\n"),
    ("      if (at[rnd] >= 0) (&sh.a[0][0])[at[rnd]] = upd[rnd];\n    __syncwarp();\n  }\n",
     "      if (at[rnd] >= 0) (&sh.a[0][0])[at[rnd]] = upd[rnd];\n    __syncwarp();\n"
     "    NBT_SOLVE_AT(2)\n  }\n"),
    ("  if (t == 0) sh.dv[n - 1] = last;\n",
     "  if (t == 0) sh.dv[n - 1] = last;\n  NBT_SOLVE_AT(1)\n"),
    ("    if (t < k) x = wsub(x, tdiv_by(wmul(xk, sh.a[t][k]), dv));\n  }\n  __syncwarp();\n"
     "  return ok;\n",
     "    if (t < k) x = wsub(x, tdiv_by(wmul(xk, sh.a[t][k]), dv));\n  }\n  __syncwarp();\n"
     "  NBT_SOLVE_AT(3)\n  if (t == 0) for (int nbt_i = 0; nbt_i < 4; ++nbt_i) "
     "atomicAdd(&nbt_probe_phase[2 + nbt_i], nbt_p[nbt_i]);\n  return ok;\n"),
]
K11_PARENT_PHASES = ("statistics load and system", None, "pivot searches and swaps",
                     "reciprocals", "elimination rounds", "back substitution", "prediction")
K10_PHASES = ("hand-off (ring, carry) and the next loads' issue",
              "contributions (waiting on their loads)",
              "chains and stores", "barrier")
K11_PHASES = ("statistics load (staging)", "pivot searches and swaps", "reciprocals",
              "elimination", "back substitution", "prediction")
WALK_BOUNDS_LINE = "__global__ void __launch_bounds__(kMaxWarps * kWarp)"
WALK_MIN_CTAS = (5, 9)  # CTAs of 4 warps an SM: <= 102 and <= 56 registers
# K5 with one part of its chain cut (avp_chain.cuh / udiv64.cuh edits):
# each variant's output is wrong on purpose; its time against the
# package's gives the part's share of a step
WALK_CUTS = {
    "no reciprocals": ("udiv64.cuh", "NBT_HD UDiv64 udiv64_gen(uint64_t d) {  // d >= 1\n",
                       "NBT_HD UDiv64 udiv64_gen(uint64_t d) {  // d >= 1\n"
                       "  if (d != 0) return {d | 1, 3, false};\n"),
    "no elimination": ("avp_chain.cuh", "  for (int k = 0; k < n - 1; ++k) {\n    // the pivot",
                       "  for (int k = 0; k < 0; ++k) {\n    // the pivot"),
    "no back substitution": ("avp_chain.cuh",
                             "  for (int k = n - 1; k > 0; --k) {\n    const int64_t xk",
                             "  for (int k = n - 1; k > n; --k) {\n    const int64_t xk"),
    "no moment update": ("avp_chain.cuh",
                         "  const int64_t s_curr = static_cast<int64_t>(iabs(x - px_s)) << kFb1;\n"
                         "  // s_curr * BETA",
                         "  if (t < kWarp) return;\n"
                         "  const int64_t s_curr = static_cast<int64_t>(iabs(x - px_s)) << kFb1;\n"
                         "  // s_curr * BETA"),
    "no F chain": ("avp_chain.cuh", "  int64_t acc[kS];\n#pragma unroll\n  for (int s = 0;",
                   "  if (t < kWarp) return;\n  int64_t acc[kS];\n#pragma unroll\n"
                   "  for (int s = 0;"),
}

# (old lines, new lines) per cut; each old text must occur in its source once
CUTS_PARENT = {
    "no_stream_read": [(
        "static_cast<uint32_t>(stream[at] & 0xFFFF)",
        "static_cast<uint32_t>(at & 0xFFFF)")],
    "one_load_search": [(
        "      int y = 0;\n#pragma unroll\n      for (int step = 128; step; step >>= 1)\n"
        "        if (arow[y + step] <= lb) y += step;\n",
        "      int y = arow[lb >> 7] & 255;\n")],
    "one_barrier": [(
        "      __syncthreads();\n      if (need) {", "      if (need) {")],
    "no_division": [
        ("const int ty = (min(px, 255 - px) + near) / qstep;",
         "const int ty = min(px, 255 - px);"),
        ("      mag *= qstep;\n", "")],
}
CUTS_PARENT["all_four"] = [r for cut in CUTS_PARENT.values() for r in cut]
CUTS_CURRENT = {
    "no_refill": [(
        "      if (at_copy < end) cp_async16(ring + (at_copy & (rw - 1)), stream + at_copy);\n"
        "      cp_async_commit();\n      filled = end;\n      cp_async_wait<kAhead - 1>();\n",
        "")],
    "no_span_search": [(
        "      while (n > 0) {\n        const int half = (n + 1) >> 1;\n"
        "        if (arow[y + half] <= lb) {\n          y += half;\n          n -= half;\n"
        "        } else {\n          n = half - 1;\n        }\n      }\n", "")],
    "no_barrier": [("      __syncthreads();\n      par ^= 1;", "      par ^= 1;")],
    "no_counts": [("        total += (four * 0x01010101u) >> 24;\n"
                   "        base += below ? ((four << (32 - 8 * below)) * 0x01010101u) >> 24 : 0;\n",
                   "")],
    "cheap_prediction": [(
        "      const int qd = activity_bin(v, err);\n"
        "      const int px0 = predict<kProfile>(v, w, flag);",
        "      const int qd = activity_bin(v, err);\n      const int px0 = v.a;")],
}
CUTS_CURRENT["all_five"] = [r for cut in CUTS_CURRENT.values() for r in cut]
# K8's block barrier, as p3_row_scan.cu defines it, and the stamping one
# p3-scan-phases builds in its place: its first thread sums the cycles
# between barriers by phase (walk, adds, sweeps, cyclically after the
# set-up's barrier) and writes them out when scan_image's copy of it ends
SCAN_SYNC = ("struct BlockSync {\n"
             "  __device__ __forceinline__ void operator()() const { __syncthreads(); }\n"
             "};\n")
SCAN_STAMPS = """__device__ unsigned long long nbt_probe_acc[4 * 4096];
struct BlockSync {
  mutable long long last = 0;
  mutable unsigned long long walk = 0, adds = 0, sweeps = 0, calls = 0;
  __device__ __forceinline__ void operator()() const {
    __syncthreads();
    if (threadIdx.x != 0) return;
    const long long now = clock64();
    const unsigned long long k = calls++;
    if (k > 0) {
      const unsigned long long dt = now - last;
      if ((k - 1) % 3 == 0) walk += dt;
      else if ((k - 1) % 3 == 1) adds += dt;
      else sweeps += dt;
    }
    last = now;
  }
  __device__ ~BlockSync() {
    if (threadIdx.x != 0 || calls == 0 || blockIdx.x >= 4096) return;
    unsigned long long* a = nbt_probe_acc + 4 * blockIdx.x;
    a[0] = walk;
    a[1] = adds;
    a[2] = sweeps;
    a[3] = calls;
  }
};
}  // namespace
extern "C" int nbt_probe_read(void* dst, int n_ctas) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, nbt_probe_acc,
                                               4 * sizeof(unsigned long long) * n_ctas));
}
namespace {
"""
# K8's walk forced a pixel a thread (row_scan.cuh's warp_pixels: a pixel a
# warp where a segment holds at most one pixel a warp), stamped and held
# exact; a package without the rule (a thread a lane) builds none
K8_WALKS = {"a pixel a thread": "  return false;\n"}
K8_WALK_LINE = ("  return !c.sym_cnt && static_cast<long long>(c.lanes_per_image) * c.ws <= "
                "n_warps;\n")
# K3 with a part of its step cut, each output wrong on purpose: (file,
# old, new) alternatives, the first whose old text occurs once in the
# package's sources is taken (the live chain's reciprocal and step, or
# before them fold_slot's division and step)
K3_CUTS = {
    "no division": [
        ("coder3.cuh", "  return static_cast<uint32_t>((t + x) >> r.shift);\n",
         "  return x >> kProbBits;\n"),
        ("coder3.cuh", "  const uint32_t q = state / f;\n",
         "  const uint32_t q = state >> kProbBits;\n"),
    ],
    "no step": [
        ("bin_fold.cu", "          state = fold_live(state, q, w + (q.y >> 24));\n", ""),
        ("coder3.cuh", "  if (!((slot >> 17) & 1u)) return word;\n", "  return word;\n"),
    ],
}
# K7 (near_scan.cu) with its chain stamped: clock64() read on every thread
# once the value a part ends with is ready (a predicate on it guards the
# read, so the read waits for it), the cycles summed by part, and each
# CTA's first thread writing its sums out.  Parts: 0 the ring wait (the
# pixel's copy and the next request), 1 the activity, prediction and
# context address, 2 the bias read, 3 the fold and the unfold, 4 the
# stores and the slide.  Each stamp is (old, new) alternatives; the first
# whose old text occurs once in the source is taken.
SCAN_STAMP_PRELUDE = r"""
__device__ unsigned long long nbt_probe_scan[6 * 65536];
__device__ __forceinline__ long long nbt_stamp(int v) {
  long long t;
  asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.s32 p, %1, -2147483647;\n\t"
               "@p mov.u64 %0, %%clock64;\n\t@!p mov.u64 %0, 0;\n\t}"
               : "=l"(t) : "r"(v) : "memory");
  return t;
}
#define NBT_STAMP(k, v)                     \
  {                                         \
    const long long now_ = nbt_stamp(v);    \
    nbt_acc[k] += now_ - nbt_last;          \
    nbt_last = now_;                        \
  }
extern "C" int nbt_probe_read(void* dst, int n_ctas) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, nbt_probe_scan,
                                               6 * sizeof(unsigned long long) * n_ctas));
}
"""
SCAN_STAMP_INIT = ("  unsigned long long nbt_acc[5] = {0, 0, 0, 0, 0};\n"
                   "  long long nbt_last = nbt_stamp(0);\n")
SCAN_STAMP_WRITE = ("  if (threadIdx.x == 0 && blockIdx.x < 65536) {\n"
                    "    for (int k = 0; k < 5; ++k)\n"
                    "      nbt_probe_scan[6 * blockIdx.x + k] = nbt_acc[k];\n"
                    "    nbt_probe_scan[6 * blockIdx.x + 5] = n_px;\n  }\n")
SCAN_STAMPS_AT = [
    [('#include "pixel_chain.cuh"\n', '#include "pixel_chain.cuh"\n' + SCAN_STAMP_PRELUDE)],
    [("  long long p = 0;  // pixel index, raster order\n",
      SCAN_STAMP_INIT + "  long long p = 0;  // pixel index, raster order\n")],
    [("      const int adr = context_adr(v, px0, qd);\n",
      "      const int adr = context_adr(v, px0, qd);\n      NBT_STAMP(1, adr)\n"),
     ("  const int adr = context_adr(v, px0, qd);\n",
      "  const int adr = context_adr(v, px0, qd);\n  NBT_STAMP(1, adr)\n")],
    [("      const int px = clampi(px0 + (bval >> 4) + sign, 0, 255);\n",
      "      const int px = clampi(px0 + (bval >> 4) + sign, 0, 255);\n      NBT_STAMP(2, px)\n"),
     ("  const int px = clampi(px0 + (bval >> 4) + sign, 0, 255);\n",
      "  const int px = clampi(px0 + (bval >> 4) + sign, 0, 255);\n  NBT_STAMP(2, px)\n")],
    [("      const int y = fold(x, px, sign, near);\n",
      "      NBT_STAMP(0, x)\n      const int y = fold(x, px, sign, near);\n"),
     ("        const int xv[kG] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};\n",
      "        const int xv[kG] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};\n"
      "        NBT_STAMP(0, xv[0] ^ xv[7])\n"),
     ("        const int x = ring[p % C::kRingChunks];\n",
      "        const int x = ring[p % C::kRingChunks];\n        NBT_STAMP(0, x)\n")],
    # where the chain is a function of its own (near_pixel), the sums ride
    # in by reference
    [("", ""),
     ("__device__ __forceinline__ PixelOut near_pixel(Window& v, int& err,",
      "__device__ __forceinline__ PixelOut near_pixel(unsigned long long (&nbt_acc)[5], "
      "long long& nbt_last, Window& v, int& err,")],
    [("", ""),
     ("near_pixel<kProfile>(v, err,", "near_pixel<kProfile>(nbt_acc, nbt_last, v, err,", "all")],
    [("      err = x_rec - px0;\n", "      err = x_rec - px0;\n      NBT_STAMP(3, err)\n"),
     ("  err = f.x_rec - px0;\n", "  err = f.x_rec - px0;\n  NBT_STAMP(3, err)\n")],
    [("      slide(v, x_rec, i, j, tw, up1, up2);\n",
      "      slide(v, x_rec, i, j, tw, up1, up2);\n      NBT_STAMP(4, v.d ^ v.r)\n"),
     ("  slide(v, f.x_rec, i, j, tw, up1, up2);\n",
      "  slide(v, f.x_rec, i, j, tw, up1, up2);\n  NBT_STAMP(4, v.d ^ v.r)\n")],
    [("  cp_async_wait<0>();\n}\n", "  cp_async_wait<0>();\n" + SCAN_STAMP_WRITE + "}\n")],
]
SCAN_PARTS = ("ring wait", "activity, prediction, address", "bias read", "fold and unfold",
              "stores and slide")
# K9 (p3_table_replay.cu over image_tables.cuh) with one phase cut (wrong
# output on purpose): (file, old, new) alternatives, the first whose old
# text occurs once in its source taken; a cut none of whose alternatives
# matches the sources (a phase of the other design) is not built.  "no
# zeroing" leaves the touched bits as the shared memory holds them, so
# the rest visits what they say (the design with marked sweeps: the adds,
# the sweeps, the rewrite; the design with lists: the adds, the lists,
# each listed entry's sweep and rewrite).  And K9 stamped: its CTA's
# barriers read clock64() on the first thread, the cycles from the
# kernel's start to each barrier and to its end kept by phase.
REPLAY_STAMP = ("  mutable long long last = 0;\n  mutable int calls = 0;\n"
                "  __device__ __forceinline__ void stamp() const {\n"
                "    if (threadIdx.x != 0) return;\n    const long long now = clock64();\n"
                "    if (calls > 0 && calls <= 4 && blockIdx.x < 4096)\n"
                "      nbt_probe_replay[4 * blockIdx.x + calls - 1] = now - last;\n"
                "    last = now;\n    ++calls;\n  }\n")
REPLAY_STAMP_READ = ("__device__ long long nbt_probe_replay[4 * 4096];\n"
                     "extern \"C\" int nbt_probe_read(void* dst, int n_ctas) {\n"
                     "  return static_cast<int>(cudaMemcpyFromSymbol(dst, nbt_probe_replay,\n"
                     "      4 * sizeof(long long) * n_ctas));\n"
                     "}\n")
REPLAY_CUTS = {
    "no zeroing": [
        ("image_tables.cuh",
         "  team.threads([&](int t, int n) {\n"
         "    for (int g = t; g < kBiasWords; g += n) tb.btouch[g] = 0;\n"
         "    for (int g = t; g < kMapWords; g += n) tb.mtouch[g] = 0;\n  });\n  team.sync();\n",
         ""),
        ("image_tables.cuh",
         "  for (int g = t; g < kBiasWords; g += n) sh.btouch[g] = 0;\n"
         "  for (int g = t; g < kMapWords; g += n) sh.mtouch[g] = 0;\n", ""),
    ],
    "no adds": [
        ("image_tables.cuh",
         "  team.threads([&](int t, int n) { replay_adds(c, p, tb, img, s, t, n, team.at); });\n",
         ""),
        ("image_tables.cuh",
         "  team.threads([&](int t, int n) { "
         "replay_reds(c, p, tb, sh, img, s, t, n, team.at); });\n",
         ""),
    ],
    "no lists": [
        ("image_tables.cuh",
         "  team.threads([&](int t, int n) { replay_lists(sh, s, t, n, team.at); });\n", ""),
    ],
    "no sweeps": [
        ("image_tables.cuh",
         "  team.threads([&](int t, int n) { replay_sweeps(c, tb, s, t, n); });\n", ""),
    ],
    "no rewrite": [
        ("image_tables.cuh",
         "  team.threads([&](int t, int n) { replay_rewrite(c, tb, s, t, n); });\n", ""),
        ("image_tables.cuh",
         "  team.threads([&](int t, int n) { replay_entries(c, tb, sh, s, t, n, team.at); });\n",
         ""),
    ],
}
REPLAY_STAMPS = [
    [("  __device__ __forceinline__ void sync() const { __syncthreads(); }\n",
      REPLAY_STAMP + "  __device__ __forceinline__ void sync() const {\n    __syncthreads();\n"
      "    stamp();\n  }\n"),
     ("  __device__ __forceinline__ void sync() const {\n    if constexpr (kThreads == 32)\n"
      "      __syncwarp();\n    else\n      __syncthreads();\n  }\n",
      REPLAY_STAMP + "  __device__ __forceinline__ void sync() const {\n"
      "    if constexpr (kThreads == 32)\n      __syncwarp();\n    else\n"
      "      __syncthreads();\n    stamp();\n  }\n")],
    [("  replay_image(c, p, tb, img, s, BlockTeam{});\n",
      "  const BlockTeam team{};\n  team.stamp();\n  replay_image(c, p, tb, img, s, team);\n"
      "  __syncthreads();\n  team.stamp();\n"),
     ("  replay_launch(c, p, tb, sh, img, s, BlockTeam{});\n",
      "  const BlockTeam team{};\n  team.stamp();\n  replay_launch(c, p, tb, sh, img, s, team);\n"
      "  __syncthreads();\n  team.stamp();\n"),
     ("  replay_launch(c, p, tb, sh, img, s, BlockTeam<kThreads>{});\n",
      "  const BlockTeam<kThreads> team{};\n  team.stamp();\n"
      "  replay_launch(c, p, tb, sh, img, s, team);\n  team.sync();\n")],
    [("namespace {\n\nconstexpr int kThreads",
      REPLAY_STAMP_READ + "namespace {\n\nconstexpr int kThreads"),
     ("namespace {\n\n// The CTA as replay_launch's team",
      REPLAY_STAMP_READ + "namespace {\n\n// The CTA as replay_launch's team")],
]
# K9 with another team a CTA (each exact): its threads-a-CTA line
REPLAY_TEAM_LINE = "constexpr int kThreads = 512;  // threads a CTA (an image)"
REPLAY_TEAMS = (32, 128)
# the phases between the stamps, by design (its phase function's name)
REPLAY_PHASES = {"replay_image": ("zeroing", "adds", "sweeps", "rewrite"),
                 "replay_launch": ("clearing", "adds", "lists", "sweep and rewrite")}
SLOT_LINE = "constexpr int kSlotBits = 12;"
BLOCK_LINE = "constexpr int kBlock = 128;"


def _ms(fn, reps: int = 20) -> float:
    """Median CUDA-event milliseconds of ``fn()`` over ``reps`` runs."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _rounds(runs: dict) -> dict:
    """Two timing rounds of every run, the second in reverse order."""
    times = {name: [] for name in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            runs[name]()  # warm-up
            times[name].append(_ms(runs[name]))
    return times


def _card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    return f"{torch.cuda.get_device_name(0)}; {smi}"


def variant(source: Path, name: str, repl) -> tuple[str, str]:
    """(name, text): ``source`` with each (old, new) of ``repl`` replaced."""
    text = source.read_text()
    for old, new in repl:
        if text.count(old) != 1:
            raise ValueError(f"{name}: {old!r} occurs {text.count(old)} times in {source}")
        text = text.replace(old, new)
    return name, text


def _build(name: str, text: str, where: Path = PROBE_DIR) -> Path:
    """nvcc ``text`` into ``where``/lib_``name``.so (its quoted includes
    found in ``where`` first, then in the package's csrc/)."""
    src, lib = where / f"{name}.cu", where / f"lib_{name}.so"
    src.write_text(text)
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-I", str(kernels.CSRC),
           "-Xptxas", "-v", "-o", str(lib), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{res.stdout}{res.stderr}")
    regs = [ln.split("ptxas info    : ")[-1].strip() for ln in res.stderr.splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"[build {name}] {regs}", flush=True)
    return lib


def _entry(lib: Path, name: str, n_args: int, ints: set):
    """A C entry of ``lib`` taking ``n_args`` arguments, int at ``ints``."""
    fn = getattr(ctypes.CDLL(str(lib)), name)
    fn.argtypes = [ctypes.c_int if i in ints else ctypes.c_void_p for i in range(n_args)]
    fn.restype = ctypes.c_int
    return fn


def _checked(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def _k2_runner(lib: Path, args, parent: bool):
    """One launch of the K2 entry in ``lib`` on ``group_args`` output; the
    parent's entry takes the rows as they are, the current one rows of a
    multiple of 4 words, as decode_groups prepares them."""
    streams, n_active, bias, hist_n, acc, wcols, th, tw, near, g, profile = args
    n_groups, w = streams.shape
    words = streams if parent else torch.nn.functional.pad(streams, (0, -w % 4))
    words = words.to(torch.int32).clone()  # fresh, so 16-byte aligned
    tables = [t.to(torch.int32).clone() for t in (n_active, bias, hist_n, acc)]
    wptr = wcols.to(torch.int32).clone() if profile == 2 else None
    out = torch.empty((n_groups, th, tw, g), dtype=torch.uint8, device=streams.device)
    head = [words.data_ptr(), w] + ([] if parent else [words.shape[1]])
    rest = [wptr.data_ptr() if wptr is not None else None, n_groups,
            n_groups // bias.shape[0], g, th, tw, near, profile, out.data_ptr(),
            *kernels.stream_of(streams)]
    call = head + [t.data_ptr() for t in tables] + rest
    ptrs = {0, len(head), len(head) + 1, len(head) + 2, len(head) + 3, len(head) + 4,
            len(call) - 3, len(call) - 1}
    fn = _entry(lib, "nbt_group_decode", len(call), set(range(len(call))) - ptrs)

    def run():
        _checked(fn(*call), lib.name)
        return out.permute(0, 3, 1, 2)
    run.keep = (words, tables, wptr)
    return run


def _main_shape_args(profile: int, dev):
    """Two 512x768 images at 64x64 tiles: two groups of 128 lanes."""
    rng = np.random.default_rng(3)
    imgs = [synth_image(rng, 512, 768) for _ in range(2)]
    conts = (tiled._encode_flag_cycle(imgs, 64, dev) if profile == 2 else
             tiled.encode_batch(imgs, tile_h=64, tile_w=64, device=dev))
    return group_args([tiled._Parsed(c) for c in conts], dev)


def _corpus16_args(dev):
    """A Kodak-shaped corpus at 16x16 tiles: 24 images, 288 groups."""
    rng = np.random.default_rng(0)
    corpus = [synth_image(rng, 512, 768) for _ in range(18)]
    corpus += [synth_image(rng, 768, 512).T.copy() for _ in range(6)]
    conts = tiled.encode_batch(corpus, tile_h=16, tile_w=16, device=dev)
    return group_args([tiled._Parsed(c) for c in conts], dev)


def cut_chain(libs: dict, design: str, card: str) -> bool:
    dev = torch.device("cuda")
    args = _main_shape_args(1, dev)
    runs = {name: _k2_runner(path, args, design == "parent") for name, path in libs.items()}
    exact = torch.equal(runs["base"](), decode.group_decode_plain(*args))
    print(f"[cut-chain {design}] base exact against the plain decoder: {exact}", flush=True)
    times = _rounds(runs)
    b = float(np.mean(times["base"]))
    for name, ts in times.items():
        print(f"[cut-chain {design}] {name}: {ts[0]:.3f} / {ts[1]:.3f} ms, saves "
              f"{b - float(np.mean(ts)):.3f} ms of {b:.3f} ({card})", flush=True)
    if design == "current":
        for label, a in (("2 groups 64x64", args), ("288 groups 16x16", _corpus16_args(dev))):
            launch = _k2_runner(libs["base"], a, False)
            exact &= torch.equal(launch(), decode.decode_groups(*a))
            print(f"[cut-chain current] base at {label}: wrapper (decode_groups) "
                  f"{_ms(lambda: decode.decode_groups(*a)):.3f} ms, launch alone "
                  f"{_ms(launch):.3f} ms ({card})", flush=True)
    return exact


def slot_bits(libs: dict, card: str) -> bool:
    dev = torch.device("cuda")
    cases = {"p1 2 groups 64x64": _main_shape_args(1, dev),
             "p2 2 groups 64x64": _main_shape_args(2, dev),
             "p1 288 groups 16x16": _corpus16_args(dev)}
    ok = True
    for label, args in cases.items():
        ref = decode.decode_groups(*args)
        runs = {k: _k2_runner(path, args, False) for k, path in libs.items()}
        same = {k: torch.equal(run(), ref) for k, run in runs.items()}
        ok &= all(same.values())
        times = _rounds(runs)
        print(f"[slot-bits] {label}: " + " | ".join(
            f"k={k} {ts[0]:.3f} / {ts[1]:.3f}{'' if same[k] else ' DIFFERS'}"
            for k, ts in times.items()) + f" ms ({card})", flush=True)
    return ok


def k2_width(libs: dict, card: str) -> bool:
    dev = torch.device("cuda")
    cases = {"p1 2 groups 64x64": _main_shape_args(1, dev),
             "p2 2 groups 64x64": _main_shape_args(2, dev),
             "p1 288 groups 16x16": _corpus16_args(dev)}
    ok = True
    for label, args in cases.items():
        ref = decode.decode_groups(*args)
        if label == "p1 2 groups 64x64":
            ok &= torch.equal(ref, decode.group_decode_plain(*args))
        runs = {k: _k2_runner(path, args, False) for k, path in libs.items()}
        same = {k: torch.equal(run(), ref) for k, run in runs.items()}
        ok &= all(same.values())
        times = _rounds(runs)
        print(f"[k2-width] {label}: " + " | ".join(
            f"{k} {ts[0]:.3f} / {ts[1]:.3f}{'' if same[k] else ' DIFFERS'}"
            for k, ts in times.items()) + f" ms; package kernel exact {ok} ({card})",
              flush=True)
    return ok


def fold_blocks(libs: dict, card: str) -> bool:
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    s, l = 3072, 4096
    freq = torch.from_numpy(rng.integers(1, 1 << 15, size=(l, s)).astype(np.int32)).to(dev)
    facc = torch.from_numpy(rng.integers(0, 1 << 14, size=(l, s)).astype(np.int32)).to(dev)
    w2, e2, s2 = rans.encode_scan(freq.t(), facc.t())
    out = torch.empty((l, s), dtype=torch.int32, device=dev)
    state = torch.empty(s, dtype=torch.int32, device=dev)
    call = [freq.data_ptr(), facc.data_ptr(), out.data_ptr(), state.data_ptr(), s, l,
            *kernels.stream_of(freq)]
    runs = {}
    for block, path in libs.items():
        fn = _entry(path, "nbt_rans_fold", len(call), {4, 5, 6})
        runs[block] = lambda fn=fn, path=path: _checked(fn(*call), path.name)
    ok = True
    for block, run in runs.items():
        run()
        folded = out.t()
        ok &= (torch.equal(folded > rans.ANS_MASK, e2)
               and torch.equal((folded & rans.ANS_MASK)[e2], w2[e2])
               and torch.equal(state.to(torch.int64) & rans.U32_MASK, s2))
    times = _rounds(runs)
    print(f"[fold] S={s} L={l} exact={ok} launch alone: " + " | ".join(
        f"{block} threads {ts[0]:.3f} / {ts[1]:.3f}" for block, ts in times.items())
        + f" ms; the package's wrapper (128 threads) "
        f"{_ms(lambda: fold.encode_fold(freq.t(), facc.t())):.3f} ms ({card})", flush=True)
    return ok


def near_stages(card: str) -> bool:
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    imgs = [synth_image(rng, 512, 768) for _ in range(18)]
    b, (h, w), t, near = len(imgs), imgs[0].shape, 64, 2
    tiled.encode_batch(imgs[:2], device=dev)  # warm-up: the lossless pass and the tail
    torch.cuda.synchronize()
    marks = [time.perf_counter()]

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    tiles = tiled.to_tiles(torch.from_numpy(np.stack(imgs)).to(dev), t, t)
    _, _, bias, _ = tiled._model_lossless_impl(tiles)
    mark()
    x = tiles.to(torch.int32)
    near_scan.encode_scan.launches = 0
    bias, _ = tiled._refine_near_bias(x, bias, None, None, t, t, near, 1)
    mark()
    y, qd, hist = tiled._model_near(x, bias, None, t, t, near, 1)
    mark()
    k7 = near_scan.encode_scan.launches
    hist_n, acc = tiled._norm_tables(hist)
    totals, flats = tiled._pack_groups(*fold.encode_fold(
        *tiled._encode_tables(y, qd, hist_n, acc)))
    words = tiled._live_payload(flats, totals).cpu().numpy().astype(np.uint16)
    totals = totals.cpu().numpy().reshape(b, -1)
    bias_h = bias.cpu().numpy().astype(np.int16)
    hist_h = hist_n.cpu().numpy().astype(np.uint32)
    mark()
    ends = np.cumsum(totals.sum(axis=1))
    conts = [tiled._emit_container(
        1, near, h, w, t, t, x.shape[1], tiled.G_LANES, totals[i], bias_h[i], hist_h[i],
        words[ends[i] - totals[i].sum() : ends[i]].tobytes(), b"", False) for i in range(b)]
    mark()
    ms = [1e3 * (t1 - t0) for t0, t1 in zip(marks, marks[1:])]
    names = ("lossless proxy", "refinement scan", "final scan", "coding tail with K1",
             "containers")
    one = tiled.encode_batch(imgs[:1], near=near, device=dev)
    start = time.perf_counter()
    tiled._model_near(x[:1], bias[:1], None, t, t, near, 1)
    torch.cuda.synchronize()
    one_ms = 1e3 * (time.perf_counter() - start)
    same = conts[0] == one[0] and k7 == 2
    print(f"[near-stages] {b}x{(h, w)} near {near} effort 1, {t}x{t} tiles, {b * x.shape[1]} "
          f"lanes: " + ", ".join(f"{n} {v:.3f} ms" for n, v in zip(names, ms))
          + f"; scans {100 * (ms[1] + ms[2]) / sum(ms):.2f}% (K7 launches {k7}), "
          f"{1e3 * ms[2] / (t * t):.3f} us a pixel step | the final scan over one image "
          f"({x.shape[1]} lanes) {one_ms:.3f} ms "
          f"| image 0's container equals encode_batch's alone: {same} ({card})", flush=True)
    return same


def build_ways(card: str) -> bool:
    """Seconds of the package's build against one nvcc of every source."""
    srcs = [str(src) for src in kernels._sources()]
    times = {"kernels.build": [], "one nvcc": []}
    package_dir = kernels.BUILD_DIR
    for ways in (list(times), list(times)[::-1]):
        rnd = len(times[ways[0]])
        for way in ways:
            start = time.perf_counter()
            if way == "kernels.build":
                kernels.BUILD_DIR = PROBE_DIR / f"build_{rnd}"
                shutil.rmtree(kernels.BUILD_DIR, ignore_errors=True)
                try:
                    kernels.build()
                finally:
                    kernels.BUILD_DIR = package_dir
            else:
                cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-I", str(kernels.CSRC),
                       "-o", str(PROBE_DIR / f"lib_one_nvcc_{rnd}.so"), *srcs]
                res = subprocess.run(cmd, capture_output=True, text=True)
                if res.returncode != 0:
                    print(f"[build] one nvcc failed:\n{res.stdout}{res.stderr}")
                    return False
            times[way].append(time.perf_counter() - start)
    print(f"[build] {len(srcs)} sources, from nothing, two rounds in opposite orders: "
          + "; ".join(f"{way} " + " / ".join(f"{t:.2f}" for t in ts) + " s"
                      for way, ts in times.items()) + f" ({card})", flush=True)
    return True


def p3_stages(card: str) -> bool:
    from chip_smoke import StageClock, p3_stage_targets
    from nblic_tpu_torch.models import strips

    dev = torch.device("cuda")
    img = synth_image(np.random.default_rng(0), 768, 512)
    strips.encode(img[:64, :48], device=dev)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    with StageClock(p3_stage_targets(strips)) as clock:
        cont = strips.encode(img, device=dev)
    stages = clock.stages()
    total = sum(stages.values())
    tune = strips.TUNE
    th, w = strips.TH_DEFAULT, img.shape[1]
    n_seg = strips._eff_seg(tune.n_seg, w)
    steps = th * w * (tune.n_unary + strips.L_R) // strips.N_PHASE
    print(f"[p3-stages] 1x{img.shape} th {th}: {8.0 * len(cont) / img.size:.4f} bpp, "
          f"{total / 1e3:.2f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          + ", ".join(f"{k} {v:.1f} ms ({100 * v / total:.1f}%)" for k, v in stages.items())
          + f"; row scan {1e3 * stages['row scan'] / (th * n_seg):.1f} us a segment "
          f"({th} rows x {n_seg} segments), fold {1e3 * stages['fold'] / steps:.1f} us a "
          f"step ({steps} steps) ({card})", flush=True)
    return len(cont) > 0


def p3_corpus(card: str) -> bool:
    from chip_smoke import StageClock, p3_stage_targets
    from nblic_tpu_torch.models import strips

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    corpus = [synth_image(rng, 512, 768) for _ in range(18)]
    corpus += [synth_image(rng, 768, 512) for _ in range(6)]
    n_px = sum(im.size for im in corpus)
    strips.encode_batch([im[:64, :48] for im in corpus[:2]], th=64, device=dev)  # warm-up
    for rep in range(2):
        with StageClock(p3_stage_targets(strips)) as clock:
            conts = strips.encode_batch(corpus, th=64, device=dev)
        stages = clock.stages()
        total = sum(stages.values())
        print(f"[p3-corpus] rep {rep}: {len(corpus)} images th 64, "
              f"{8.0 * sum(map(len, conts)) / n_px:.4f} bpp, {total / 1e3:.2f} s "
              f"({n_px / total / 1e3:.4f} MPix/s); "
              + ", ".join(f"{k} {v:.1f} ms" for k, v in stages.items()) + f" ({card})",
              flush=True)
    return len(conts) == len(corpus)


P3_MODEL_SHAPES = (("th 768, one image", 1, 768), ("th-64 corpus", 24, 64))


def _p3_model_inputs(dev, shapes=P3_MODEL_SHAPES) -> list:
    """(label, (L, th, w) int32 strips on the card) of p3-model's shapes:
    (label, images of the corpus, strip height) each."""
    from nblic_tpu_torch.models import strips

    rng = np.random.default_rng(0)
    corpus = [synth_image(rng, 512, 768) for _ in range(18)]
    corpus += [synth_image(rng, 768, 512) for _ in range(6)]
    out = []
    for label, count, th in shapes:
        st, *_ = strips._prepare(corpus[:count], th)
        b, s, th_, w = st.shape
        out.append((label, torch.from_numpy(st).to(dev).reshape(b * s, th_, w).to(torch.int32)))
    return out


def _plain_model_parts(x, n: int) -> tuple[dict, dict]:
    """The plain modeling pass on card tensors under TUNE_V4 (mix_e, no
    segments), part by part ({part: output}, {part: ms by host clock and
    a sync})."""
    from nblic_tpu_torch.ops import model_pass, pavp
    from nblic_tpu_torch.ops.avp import BETA, FB1

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    out, ms = {}, {}
    shape = tuple(x.shape)
    (fe, px_s), ms["features"] = timed(lambda: model_pass.features(x, n))
    xl = x.to(torch.int64)
    s_curr = torch.abs(xl - px_s.to(torch.int64)) << FB1
    out["energy"], ms["energy chains"] = timed(
        lambda: pavp._run_chains(s_curr[None], BETA, 0, False)[0])
    del s_curr
    out["stats"], ms["moment chains"] = timed(
        lambda: model_pass.chains_plain(fe, px_s.reshape(1, -1), shape, n))
    # chains_plain runs the energy chains again before the moments
    ms["moment chains"] -= ms["energy chains"]
    (px_hard, ok), ms["solve"] = timed(lambda: model_pass.solve_plain(
        out["stats"], fe, px_s.reshape(-1), n))
    preds = torch.stack([px_hard, px_s.reshape(-1)])
    out["mix"], ms["mix chains"] = timed(lambda: model_pass.chains_plain(fe, preds, shape, n))
    out["px"], ms["blend"] = timed(lambda: pavp.mix_blend(
        px_hard, px_s.reshape(-1), out["mix"][:, 0], out["mix"][:, 1], ok))
    out["px_hard"] = px_hard
    return out, ms


def _kernel_model_parts(x, n: int, reps: int = 3) -> tuple[dict, dict]:
    """The modeling pass on K10 and K11 under TUNE_V4, part by part
    ({part: output}, {part: CUDA-event median ms of ``reps``})."""
    from nblic_tpu_torch.ops import model_pass as mp
    from nblic_tpu_torch.ops import pavp

    out, ms = {}, {}
    shape = tuple(x.shape)
    p = x.numel()
    fe, px_s = mp.features(x, n)
    ms["features"] = _ms(lambda: mp.features(x, n), reps)
    dev = x.device
    ssum = torch.empty(p, dtype=torch.int32, device=dev)
    srecip = torch.empty(p, dtype=torch.int64, device=dev)
    stats = torch.empty((p, pavp.get_m(n)), dtype=torch.int64, device=dev)
    preds = px_s.reshape(1, -1)
    k = n + n * n
    design = mp.chain_design(shape[0], shape[1], k,
                             torch.cuda.get_device_properties(dev).multi_processor_count)
    blocks = [(0, k)] if design == mp.WAVE else mp._moment_blocks(n, p)

    def energy():
        mp._launch_chains(mp.ENERGY, fe, preds, ssum, srecip, stats, shape, n, 0, 1, 0,
                          mp.PLAIN, 1)

    def moments():
        for q0, kk in blocks:
            mp._launch_chains(mp.MOMENTS, fe, preds, ssum, srecip, stats, shape, n, q0, kk,
                              1 + q0, mp.PLAIN, 1, design)

    ms["K10 energy"] = _ms(energy, reps)
    name = "wavefront" if design == mp.WAVE else f"two passes, {len(blocks)} launches"
    ms[f"K10 moments ({name})"] = _ms(moments, reps)
    out["stats"] = stats
    out["energy"] = stats[:, 0]
    (px_hard, ok) = mp.solve(stats, fe, px_s.reshape(-1), n)
    ms["K11"] = _ms(lambda: mp.solve(stats, fe, px_s.reshape(-1), n), reps)
    mix_preds = torch.stack([px_hard, px_s.reshape(-1)])
    out["mix"] = mp.chains(fe, mix_preds, shape, n)
    ms["K10 mix"] = _ms(lambda: mp.chains(fe, mix_preds, shape, n), reps)
    out["px"] = pavp.mix_blend(px_hard, px_s.reshape(-1), out["mix"][:, 0], out["mix"][:, 1],
                               ok)
    ms["blend"] = _ms(lambda: pavp.mix_blend(px_hard, px_s.reshape(-1), out["mix"][:, 0],
                                             out["mix"][:, 1], ok), reps)
    out["px_hard"] = px_hard
    ms["whole pass"] = _ms(lambda: mp.predict_plane(x, n, mix=True), reps)
    return out, ms


def p3_model(card: str) -> bool:
    from nblic_tpu_torch.ops import model_pass

    dev = torch.device("cuda")
    n = 10
    ok = True
    inputs = _p3_model_inputs(dev)
    model_pass.predict_plane(inputs[0][1][:, :32, :48].contiguous(), n, mix=True)  # warm-up
    for label, x in inputs:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        plain, pms = _plain_model_parts(x, n)
        plain_peak = torch.cuda.max_memory_allocated() / 2**30
        plain = {k: v.cpu() for k, v in plain.items()}  # the card holds one path's planes
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mine, kms = _kernel_model_parts(x, n)
        peak = torch.cuda.max_memory_allocated() / 2**30
        same = {k: torch.equal(mine[k].reshape(plain[k].shape).cpu(), plain[k])
                for k in ("energy", "stats", "px_hard", "mix", "px")}
        del mine
        ok &= all(same.values())
        l, th, w = x.shape
        print(f"[p3-model] {label} ({l} lanes x {th} x {w}): plain on the card "
              f"{sum(pms.values()):.1f} ms (" + ", ".join(f"{k} {v:.1f}" for k, v in pms.items())
              + f"), peak {plain_peak:.2f} GiB | kernels "
              + ", ".join(f"{k} {v:.3f}" for k, v in kms.items())
              + f" ms, peak {peak:.2f} GiB | equal {same} ({card})", flush=True)
    # device launches of each path at th 768
    label, x = inputs[0]
    for name, fn in (("plain", lambda: _plain_model_parts(x, n)),
                     ("kernels", lambda: model_pass.predict_plane(x, n, mix=True))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        dev_ms, count = _device_kernels(prof)
        print(f"[p3-model] {label}, {name} pass under torch.profiler: {count} device launches "
              f"(kernels and copies), {dev_ms:.1f} ms of device time, {wall:.1f} s with the "
              f"profiler ({card})", flush=True)
    return ok


def _swapped_call(entries: dict, fn):
    """``fn()`` with the package's library's C entries ``entries`` (name:
    function) replaced."""
    base, saved = kernels.library(), kernels.library
    swapped = _SwappedLib(base, **entries)
    kernels.library = lambda: swapped
    try:
        return fn()
    finally:
        kernels.library = saved


def _typed(path: Path, name: str):
    """C entry ``name`` of a variant library, typed as the package's."""
    fn = getattr(ctypes.CDLL(str(path)), name)
    fn.argtypes, fn.restype = getattr(kernels.library(), name).argtypes, ctypes.c_int
    return fn


def p3_model_forms(libs: dict, card: str) -> bool:
    """K10's statistics (its energy and moment launches) of the package
    beside copies with other steps between barriers and other rows a
    thread of the 32-lane layout, and with the design forced to each of
    the three, at p3-model's shapes, each held exact to the package's, two
    rounds in opposite orders; then K11's instances and w_pred."""
    from nblic_tpu_torch.ops import model_pass

    dev = torch.device("cuda")
    n, ok = 10, True
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, x in _p3_model_inputs(dev):
        fe, px_s = model_pass.features(x, n)
        preds, shape = px_s.reshape(1, -1), tuple(x.shape)
        ref = model_pass.chains(fe, preds, shape, n)
        runs = {"package": lambda: model_pass.chains(fe, preds, shape, n)}
        for key, path in libs.items():
            if key.startswith("k11"):
                continue
            entries = {name: _typed(path, name) for name in (
                "nbt_p3_model_chains", "nbt_p3_model_chains_scratch")}
            runs[key] = lambda e=entries: _swapped_call(
                e, lambda: model_pass.chains(fe, preds, shape, n))
        saved = model_pass.chain_design
        for design, name in ((model_pass.TWO_PASS, "two passes"),
                             (model_pass.WAVE, "wavefront")):
            if design == model_pass.WAVE and shape[0] * -(-(n + n * n) // 32) < 2 * sms:
                continue  # 4 CTAs in all at th 768

            def forced(d=design):
                model_pass.chain_design = lambda s, h, k, sms: d
                try:
                    return model_pass.chains(fe, preds, shape, n)
                finally:
                    model_pass.chain_design = saved

            runs[f"package, {name}"] = forced
        runs = {key: run for key, run in runs.items() if not key.startswith("k11")}
        same = {key: torch.equal(run(), ref) for key, run in runs.items()}
        ok &= all(same.values())
        del ref
        times = _rounds(runs)
        print(f"[p3-model-forms] {label} ({shape[0]} lanes x {shape[1]} x {shape[2]}), K10's "
              f"statistics (energy and moment launches), ms (median of 20, two rounds): "
              + "; ".join(f"{k} " + " / ".join(f"{v:.3f}" for v in ts) + f" (equal {same[k]})"
                          for k, ts in times.items()) + f" ({card})", flush=True)
        # K11: the instance for any count at n = 10, and w_pred (a system a
        # segment of 8), each with its CTAs an SM
        pxs = px_s.reshape(-1)
        runs11, same11, base11 = {}, {}, None
        for seg_w, w_quant in ((0, False), (8, True)):
            stats = model_pass.chains(fe, preds, shape, n, seg_w, w_quant)
            seg = seg_w if w_quant else 1
            want = model_pass.solve(stats, fe, pxs, n, seg, w_quant)
            tag = f"w_pred, a system a segment of {seg}" if w_quant else "a system a pixel"
            runs11[f"package, {tag}"] = lambda a=(stats, seg, w_quant): model_pass.solve(
                a[0], fe, pxs, n, a[1], a[2])
            for key, path in libs.items():
                if not key.startswith("k11"):
                    continue
                entry = {"nbt_p3_model_solve": _typed(path, "nbt_p3_model_solve")}
                run = (lambda e=entry, a=(stats, seg, w_quant): _swapped_call(
                    e, lambda: model_pass.solve(a[0], fe, pxs, n, a[1], a[2])))
                got = run()
                same11[f"{key}, {tag}"] = all(torch.equal(u, v) for u, v in zip(got, want))
                runs11[f"{key}, {tag}"] = run
            del stats
        ok &= all(same11.values())
        lib = kernels.library()
        occ = {f"<{kn}{', w_pred' if wq else ''}>": lib.nbt_p3_model_solve_per_sm(kn, int(wq))
               for kn in (10, 12) for wq in (0, 1)}
        times = _rounds(runs11)
        print(f"[p3-model-forms] {label}, K11 ms (median of 20, two rounds): "
              + "; ".join(f"{k} " + " / ".join(f"{v:.3f}" for v in ts)
                          + (f" (equal {same11[k]})" if k in same11 else "")
                          for k, ts in times.items())
              + f"; one-warp CTAs an SM by occupancy {occ} ({card})", flush=True)
    return ok


def _parent_chains(fn, fe, preds, shape, n: int):
    """The parent design's model_pass.chains (the two passes: the energy launch,
    then the moments in launches whose B scratch stays within 2 GiB) on
    its C entry ``fn``; the plain form."""
    from nblic_tpu_torch.ops import model_pass as mp
    from nblic_tpu_torch.ops import pavp

    s, h, w = shape
    p, dev = s * h * w, fe.device
    total = n + n * n
    k_max = max(1, (1 << 31) // (8 * p))
    k = -(-total // -(-total // k_max))
    blocks = [(q, min(k, total - q)) for q in range(0, total, k)]
    ssum = torch.empty(p, dtype=torch.int32, device=dev)
    srecip = torch.empty(p, dtype=torch.int64, device=dev)
    out = torch.empty((p, pavp.get_m(n)), dtype=torch.int64, device=dev)
    scratch = torch.empty(p * k, dtype=torch.int64, device=dev)
    for kind, q0, kk, c0 in [(mp.ENERGY, 0, 1, 0)] + [(mp.MOMENTS, q, c, 1 + q)
                                                       for q, c in blocks]:
        _checked(fn(kind, fe.data_ptr(), preds.data_ptr(), ssum.data_ptr(), srecip.data_ptr(),
                    scratch.data_ptr(), out.data_ptr(), s, h, w, n, q0, kk, out.shape[1], c0, 1,
                    mp.PLAIN, *kernels.stream_of(fe)), "parent K10")
    return out


def _parent_mix(fn, fe, preds, shape, n: int):
    """The parent design's mix launch (the two mix channels, two passes)
    on its C entry ``fn``."""
    from nblic_tpu_torch.ops import model_pass as mp

    s, h, w = shape
    p, dev = s * h * w, fe.device
    ssum = torch.empty(p, dtype=torch.int32, device=dev)
    srecip = torch.empty(p, dtype=torch.int64, device=dev)
    out = torch.empty((p, 2), dtype=torch.int64, device=dev)
    scratch = torch.empty(p * 2, dtype=torch.int64, device=dev)
    _checked(fn(mp.MIX, fe.data_ptr(), preds.data_ptr(), ssum.data_ptr(), srecip.data_ptr(),
                scratch.data_ptr(), out.data_ptr(), s, h, w, n, 0, 2, 2, 0, 1, mp.PLAIN,
                *kernels.stream_of(fe)), "parent K10 mix")
    return out


def _parent_solve(fn, stats, fe, px_s, n: int):
    """The parent design's model_pass.solve on its C entry ``fn``."""
    p = stats.shape[0]
    px = torch.empty(p, dtype=torch.int32, device=stats.device)
    okv = torch.empty(p, dtype=torch.bool, device=stats.device)
    _checked(fn(stats.data_ptr(), fe.data_ptr(), px_s.data_ptr(), px.data_ptr(), okv.data_ptr(),
                p, 1, n, 0, *kernels.stream_of(stats)), "parent K11")
    return px, okv


def _phases(path: Path, fn) -> np.ndarray:
    """The stamp sums of the probe library ``path`` over ``fn()`` (reset
    first, read after a sync)."""
    reader = ctypes.CDLL(str(path)).nbt_probe_phases
    reader.argtypes, reader.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    acc = np.zeros(8, dtype=np.uint64)
    _checked(reader(acc.ctypes.data, 1), "nbt_probe_phases")
    out = fn()
    torch.cuda.synchronize()
    _checked(reader(acc.ctypes.data, 1), "nbt_probe_phases")
    return acc.astype(np.float64), out


def _split(names, values, total=None) -> str:
    total = sum(v for name, v in zip(names, values) if name) if total is None else total
    return ", ".join(f"{name} {v:.1f} ({100 * v / total:.1f}%)" for name, v in zip(names, values)
                     if name)


def p3_model_phases(libs: dict, card: str) -> bool:
    """K10 and K11 at p3-model's two shapes (TUNE_V4's statistics, plain
    form): the package's kernels, K10's statistics and its mix launch and
    K11 (beside its copies with two batches of systems in shared memory
    and with the next batch prefetched into L2), timed beside the
    parent design's (``libs`` ("parent k10"), ("parent k11"), with
    --parent) in two rounds of opposite orders, each held exact to the
    other; then each design's stamped build, its cycles by phase, its
    output held exact to the package's; then K10's statistics in each
    design at the corpus's strip heights 128 and 256, where the package's
    choice between them is not otherwise measured."""
    from nblic_tpu_torch.ops import model_pass as mp

    dev = torch.device("cuda")
    n, ok = 10, True
    for label, x in _p3_model_inputs(dev):
        shape = tuple(x.shape)
        s, h, w = shape
        fe, px_s = mp.features(x, n)
        preds, pxs = px_s.reshape(1, -1), px_s.reshape(-1)
        stats = mp.chains(fe, preds, shape, n)
        want = mp.solve(stats, fe, pxs, n)
        mix_preds = torch.stack([want[0], pxs])
        mix = mp.chains(fe, mix_preds, shape, n)
        runs10 = {"package": lambda: mp.chains(fe, preds, shape, n)}
        runs_mix = {"package": lambda: mp.chains(fe, mix_preds, shape, n)}
        runs11 = {"package": lambda: mp.solve(stats, fe, pxs, n)}
        same11v = {}
        for key, path in libs.items():
            if key in ("k11 two stages", "k11 next batch to L2"):
                entry = {"nbt_p3_model_solve": _typed(path, "nbt_p3_model_solve")}
                runs11[key[4:]] = lambda e=entry: _swapped_call(
                    e, lambda: mp.solve(stats, fe, pxs, n))
                got = runs11[key[4:]]()
                same11v[key[4:]] = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        ok &= all(same11v.values())
        parent10 = parent11 = None
        same_mix = None
        if "parent k10" in libs:
            parent10 = ctypes.CDLL(str(libs["parent k10"])).nbt_p3_model_chains
            parent10.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [
                ctypes.c_void_p]
            parent10.restype = ctypes.c_int
            parent11 = _typed(libs["parent k11"], "nbt_p3_model_solve")
            runs10["parent"] = lambda: _parent_chains(parent10, fe, preds, shape, n)
            runs_mix["parent"] = lambda: _parent_mix(parent10, fe, mix_preds, shape, n)
            runs11["parent"] = lambda: _parent_solve(parent11, stats, fe, pxs, n)
            same_mix = torch.equal(runs_mix["parent"](), mix)
            ok &= same_mix
            same10 = torch.equal(runs10["parent"](), stats)
            got = runs11["parent"]()
            same11 = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            ok &= same10 and same11
            del got
        t10, t_mix, t11 = _rounds(runs10), _rounds(runs_mix), _rounds(runs11)

        def listed(times):
            return "; ".join(f"{k} " + " / ".join(f"{v:.3f}" for v in ts)
                             for k, ts in times.items())

        print(f"[p3-model-phases] {label} ({s} lanes x {h} x {w}): K10's statistics (energy and "
              f"moment launches) ms, median of 20, two rounds: {listed(t10)}; K10's mix launch: "
              f"{listed(t_mix)}; K11: {listed(t11)}"
              + (f"; the parent's statistics, mix and predictions equal the package's {same10} / "
                 f"{same_mix} / {same11}" if parent10 else "")
              + "".join(f"; K11 {k} equals the package's {v}" for k, v in same11v.items())
              + f" ({card})", flush=True)
        # the package's stamped builds; K10 on the wavefront even where the
        # package takes the two passes (they carry no stamps)
        path = libs["k10 stamped"]
        entries = {name: _typed(path, name) for name in ("nbt_p3_model_chains",
                                                         "nbt_p3_model_chains_scratch")}
        saved = mp.chain_design
        package = saved(s, h, n + n * n, torch.cuda.get_device_properties(dev)
                        .multi_processor_count)
        mp.chain_design = lambda *args: mp.WAVE
        try:
            acc, got = _phases(path, lambda: _swapped_call(entries, runs10["package"]))
        finally:
            mp.chain_design = saved
        same = torch.equal(got, stats)
        ok &= same
        del got
        steps = acc[4]
        print(f"[p3-model-phases] {label}, K10 stamped (the moments on the wavefront"
              + ("" if package == mp.WAVE else ", which the package runs in two passes here")
              + "): cycles a thread and step: " + _split(K10_PHASES, acc[:4] / steps)
              + f"; {steps:.0f} thread-steps; exact {same} ({card})", flush=True)
        path = libs["k11 stamped"]
        entries = {"nbt_p3_model_solve": _typed(path, "nbt_p3_model_solve")}
        acc, got = _phases(path, lambda: _swapped_call(entries, runs11["package"]))
        same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        ok &= same
        print(f"[p3-model-phases] {label}, K11 stamped (the package's, a system a thread): "
              f"cycles a system: " + _split(K11_PHASES, acc[:6] / acc[7])
              + f"; {acc[7]:.0f} systems; exact {same} ({card})", flush=True)
        if parent10 is None:
            continue
        path = libs["parent k10 stamped"]
        fn = ctypes.CDLL(str(path)).nbt_p3_model_chains
        fn.argtypes, fn.restype = parent10.argtypes, ctypes.c_int
        acc, got = _phases(path, lambda: _parent_chains(fn, fe, preds, shape, n))
        same = torch.equal(got, stats)
        ok &= same
        del got
        per = np.concatenate([acc[0:2] / (acc[6] * h), acc[2:6] / (acc[7] * w)])
        print(f"[p3-model-phases] {label}, K10 stamped (the parent's): the B pass, cycles a "
              f"thread and row: " + _split(K10_PARENT_PHASES[:2], per[:2])
              + "; the E/F pass, cycles a thread and column: "
              + _split(K10_PARENT_PHASES[2:], per[2:])
              + f"; {acc[6]:.0f} B and {acc[7]:.0f} E/F threads; exact {same} ({card})",
              flush=True)
        path = libs["parent k11 stamped"]
        fn = _typed(path, "nbt_p3_model_solve")
        acc, got = _phases(path, lambda: _parent_solve(fn, stats, fe, pxs, n))
        same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        ok &= same
        per = acc[:7] / acc[7]
        print(f"[p3-model-phases] {label}, K11 stamped (the parent's, a warp a system, its "
              f"first lane): cycles a system: " + _split(K11_PARENT_PHASES, per)
              + f" (the solve whole {per[1]:.1f}); {acc[7]:.0f} systems; exact {same} ({card})",
              flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    saved = mp.chain_design
    for label, x in _p3_model_inputs(dev, (("th-128 corpus", 24, 128),
                                           ("th-256 corpus", 24, 256))):
        shape = tuple(x.shape)
        fe, px_s = mp.features(x, n)
        preds = px_s.reshape(1, -1)
        runs = {}
        for design, name in ((mp.WAVE, "wavefront"), (mp.TWO_PASS, "two passes")):
            def forced(d=design):
                mp.chain_design = lambda *args: d
                try:
                    return mp.chains(fe, preds, shape, n)
                finally:
                    mp.chain_design = saved

            runs[name] = forced
        same = torch.equal(runs["wavefront"](), runs["two passes"]())
        ok &= same
        chosen = saved(shape[0], shape[1], n + n * n, sms)
        print(f"[p3-model-phases] {label} ({shape[0]} lanes x {shape[1]} x {shape[2]}), K10's "
              f"statistics in each design, ms, median of 20, two rounds: {listed(_rounds(runs))}"
              f"; the package takes {'the wavefront' if chosen == mp.WAVE else 'two passes'}; "
              f"equal {same} ({card})", flush=True)
    return ok


def p3_decode(card: str) -> bool:
    from chip_smoke import StageClock
    from nblic_tpu_torch.models import strips

    dev = torch.device("cuda")
    rng = np.random.default_rng(9)
    pair = [synth_image(rng, 48, 64), synth_image(rng, 64, 48)]
    small = [synth_image(rng, 64, 16) for _ in range(1024)]
    cases = [(t, pair) for t in ("TUNE_V4", "TUNE_MAX", "TUNE_V4S", "TUNE_V1")]
    cases += [("TUNE_V4", small[:k]) for k in (1, 64, 1024)]
    default, ok = strips.TUNE, True
    try:
        for tune, imgs in cases:
            strips.TUNE = getattr(strips, tune)
            conts = strips.encode_batch(imgs, th=16, device=dev)
            with StageClock([(strips, "_parse", "parse"),
                             (strips, "_decode_walk", "walk")]) as clock:
                back = strips.decode_batch(conts, device=dev)
            walk_ms = clock.stages()["walk"]
            same = all(np.array_equal(b, im) for b, im in zip(back, imgs))
            ok &= same
            h, w = max(imgs[0].shape), min(imgs[0].shape)
            steps = 16 * w
            print(f"[p3-decode] {tune} {len(imgs)}x{imgs[0].shape} th 16, "
                  f"{len(imgs) * -(-h // 16)} lanes, {steps} steps: exact {same}, walk "
                  f"{walk_ms / 1e3:.2f} s, {walk_ms / steps:.3f} ms a pixel step ({card})",
                  flush=True)
    finally:
        strips.TUNE = default
    return ok


def _near_strips(x: np.ndarray, near: int, dev) -> list[bytes]:
    """Near-lossless profile-3 containers of (L, th, w) strips, each lane
    its own image, through the encoder's stage functions."""
    from nblic_tpu_torch.models import strips

    lanes, th, w = x.shape
    tune = strips._near_tune(strips.TUNE)
    planes = strips._near_walk(torch.from_numpy(x).to(dev), lanes, near, strips.AVP_N, tune)
    slots = strips._near_code(*planes, lanes, strips._k_step(near), tune)
    lengths, flat = strips._fold_pack(*slots, lanes)
    return strips._finalize(lengths, flat, [(th, w)] * lanes, [False] * lanes, 1, th, near,
                            tune)


def _device_kernels(prof) -> tuple[float, int]:
    """(summed ms, count) of the device-side events (kernels, copies) of a
    torch.profiler run; (0, 0) where the profiler saw none."""
    from torch.autograd import DeviceType

    ms, n = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            ms += getattr(ev, "self_device_time_total", 0.0) / 1e3
            n += ev.count
    return ms, n


def p3_near(card: str) -> bool:
    from chip_smoke import StageClock
    from nblic_tpu_torch.models import strips
    from nblic_tpu_torch.ops import rans_bin

    dev = torch.device("cuda")
    near = 2
    rng = np.random.default_rng(12)
    targets = [(strips, "_near_walk", "walk"), (strips, "_near_code", "row coder"),
               (rans_bin, "fold", "fold"), (strips, "_finalize", "packing and containers")]
    l_tot = strips._near_tune(strips.TUNE).n_unary + strips.L_R
    _near_strips(synth_image(rng, 4, 16).reshape(1, 4, 16), near, dev)  # warm-up
    ok = True
    for w, th in ((16, 16), (512, 4)):
        for lanes in (4, 256, 1152):
            x = synth_image(rng, lanes * th, w).reshape(lanes, th, w)
            torch.cuda.reset_peak_memory_stats()
            with StageClock(targets) as clock:
                conts = _near_strips(x, near, dev)
            st = clock.stages()
            total = sum(st.values())
            steps = th * w
            fold_steps = steps * l_tot // strips.N_PHASE
            same = ""
            if lanes == 4 and w == 16:
                cpu = _near_strips(x, near, torch.device("cpu"))
                same = f"; card == cpu containers {cpu == conts}"
                ok &= cpu == conts
            print(f"[p3-near] {lanes} lanes x {th}x{w} near {near}: {total / 1e3:.2f} s, "
                  f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
                  + ", ".join(f"{k} {v:.1f} ms ({100 * v / total:.1f}%)" for k, v in st.items())
                  + f"; walk {st['walk'] / steps:.3f} ms a pixel step ({steps} steps), row "
                  f"coder {st['row coder'] / th:.1f} ms a row "
                  f"({strips._eff_seg(strips.TUNE.n_seg, w)} segments), fold "
                  f"{1e3 * st['fold'] / fold_steps:.1f} us a step ({fold_steps} steps)"
                  f"{same} ({card})", flush=True)
    # a walk row under the profiler (its post-processing takes minutes for
    # every ~300k events, so 32 columns): the device's busy time
    w = 32
    x = torch.from_numpy(synth_image(rng, 1152, w).reshape(1152, 1, w)).to(dev)
    tune = strips._near_tune(strips.TUNE)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        strips._near_walk(x, 1152, near, strips.AVP_N, tune)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    dev_ms, n_dev = _device_kernels(prof)
    busy = (f"device time {dev_ms:.1f} ms, busy {100 * dev_ms / wall:.1f}%, {n_dev / w:.0f} "
            f"device launches a step" if n_dev else "device time not measured (the "
            "profiler saw no device event)")
    print(f"[p3-near profile] one walk row, 1152 lanes x {w} columns: wall {wall:.1f} ms "
          f"under the profiler ({wall / w:.3f} ms a step), {busy} ({card})", flush=True)
    return ok


def _routines(body: str) -> dict:
    """{call target: (instructions from it to its RET, call sites)} of one
    function's SASS: nvcc's out-of-line routines, such as 64-bit
    division."""
    ins = [(int(m.group(1), 16), m.group(2).strip()) for m in
           re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    at = {a: k for k, (a, _) in enumerate(ins)}
    sites: dict = {}
    for _, t in ins:
        if t.startswith("CALL.REL"):
            target = int(t.split()[-1], 16)
            sites[target] = sites.get(target, 0) + 1
    out = {}
    for target, n_sites in sorted(sites.items()):
        k = at[target]
        while not ins[k][1].startswith("RET"):
            k += 1
        out[hex(target)] = (k - at[target] + 1, n_sites)
    return out


def _package_ptxas(tag: str, card: str) -> None:
    """Build the package's library and print ptxas's line of each walk
    kernel instance (when this run built it)."""
    from chip_smoke import ptxas_summary

    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        kernels.build(verbose=True)
    for line in ptxas_summary(report.getvalue()) or ["not reported: the library was built "
                                                     "before this run"]:
        print(f"[{tag} ptxas] {line} ({card})", flush=True)


def p3_walk(card: str) -> bool:
    from nblic_tpu_torch.models import strips
    from nblic_tpu_torch.ops import decode_walk, near_walk

    _package_ptxas("p3-walk", card)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(kernels.library_path())], capture_output=True,
                          text=True, check=True).stdout
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    (PROBE_DIR / "p3_walk_sass.txt").write_text(text)
    for part in text.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        if "p3_near_row" in name or "p3_decode_kernel" in name:
            print(f"[p3-walk sass] {name}: called routines (their instructions to RET, call "
                  f"sites): {_routines(part)}; listing in {PROBE_DIR / 'p3_walk_sass.txt'}",
                  flush=True)

    dev = torch.device("cuda")
    rng = np.random.default_rng(13)
    tune = strips._near_tune(strips.TUNE)
    ok, default = True, near_walk.CTA_WARPS
    try:
        for lanes in (1, 32, 1152, 4608):
            th, w = 2, 512
            x = torch.from_numpy(synth_image(rng, lanes * th, w).reshape(lanes, th, w)).to(dev)
            strips._near_walk(x[:, :1, :32].contiguous(), 1, 2, strips.AVP_N, tune)  # warm-up
            for warps in (1, 2, 4):
                near_walk.CTA_WARPS = warps
                launches = near_walk.launch_row.launches
                ms = _ms(lambda: strips._near_walk(x, 1, 2, strips.AVP_N, tune), reps=3)
                print(f"[p3-walk] K5 at {lanes} lanes x {th}x{w} (near 2, TUNE_V4's contract), "
                      f"{warps} warps a CTA: {ms:.2f} ms, {1e3 * ms / (th * w):.2f} us a pixel "
                      f"step, {near_walk.launch_row.launches - launches} launches ({card})",
                      flush=True)
    finally:
        near_walk.CTA_WARPS = default
    # K4 on images 16 columns wide at th 16 (lanes strips of 256 steps,
    # at most 1,152 an image: an image holds 65,535 rows; TUNE_V4: a launch
    # a one-column segment, the images' replays between launches)
    default = decode_walk.CTA_WARPS
    try:
        for lanes in (1, 32, 1152, 4608):
            n_img = -(-lanes // 1152)
            imgs = [synth_image(rng, 16 * lanes // n_img, 16) for _ in range(n_img)]
            conts = strips.encode_batch(imgs, th=16, device=dev)
            args = strips._walk_args([strips._parse(c) for c in conts], dev)[0]
            want = torch.from_numpy(np.concatenate(imgs).reshape(lanes, 16, 16)).to(dev)
            for warps in (1, 2, 4):
                decode_walk.CTA_WARPS = warps
                same = torch.equal(strips._decode_walk(*args), want)
                ok &= same
                ms = _ms(lambda: strips._decode_walk(*args), reps=3)
                print(f"[p3-walk] K4 at {lanes} lanes x 16x16 ({n_img} images, TUNE_V4), {warps} "
                      f"warps a CTA: exact {same}, {ms:.2f} ms, {1e3 * ms / 256:.2f} us a pixel "
                      f"step, the replays between launches included ({card})", flush=True)
    finally:
        decode_walk.CTA_WARPS = default
    return ok


class _SwappedLib:
    """The package's kernel library with some C entries replaced."""

    def __init__(self, base, **entries):
        self._base = base
        self.__dict__.update(entries)

    def __getattr__(self, name):
        return getattr(self._base, name)


def _walk_entries(lib_path: Path) -> dict:
    """The K5 or K4 entry of a variant library, typed as the package's."""
    lib, base = ctypes.CDLL(str(lib_path)), kernels.library()
    out = {}
    for name in ("nbt_p3_near_row", "nbt_p3_decode_segment"):
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = getattr(base, name).argtypes, ctypes.c_int
            out[name] = fn
    return out


def p3_walk_bounds(libs: dict, card: str) -> bool:
    """K5 and K4 variants (``libs``: {(kernel, tag): library}) timed in
    turns beside the package's kernels, each held exact to them."""
    from nblic_tpu_torch.models import strips
    from nblic_tpu_torch.ops import decode_walk, near_walk

    dev = torch.device("cuda")
    rng = np.random.default_rng(15)
    base = kernels.library()
    tune = strips._near_tune(strips.TUNE)
    lanes_x = {n: torch.from_numpy(synth_image(rng, n * 2, 512).reshape(n, 2, 512)).to(dev)
               for n in (1, 4608)}
    corpus = [synth_image(rng, 512, 768) for _ in range(18)]
    corpus += [synth_image(rng, 768, 512) for _ in range(6)]
    conts = strips.encode_batch(corpus, th=4, device=dev)
    args = strips._walk_args([strips._parse(c) for c in conts], dev)[0]
    args = (args[0], args[1], 2, *args[3:])  # the first 2 rows of each strip

    def k5(n):
        return lambda: strips._near_walk(lanes_x[n], n, 2, strips.AVP_N, tune)

    def k4():
        return strips._decode_walk(*args)

    runs = {"k5 at 1 lane": (k5(1), "nbt_p3_near_row"),
            "k5 at 4608 lanes": (k5(4608), "nbt_p3_near_row"),
            "k4 at 4608 lanes (the th-4 corpus, 2 rows)": (k4, "nbt_p3_decode_segment")}
    want = {what: fn() for what, (fn, _) in runs.items()}
    ok, saved = True, (kernels.library, near_walk.CTA_WARPS, decode_walk.CTA_WARPS)
    near_walk.CTA_WARPS = decode_walk.CTA_WARPS = 4
    try:
        for rnd in range(2):
            for what, (fn, entry) in runs.items():
                kernel = "k5" if entry == "nbt_p3_near_row" else "k4"
                tags = ["package"] + [t for (k, t) in libs if k == kernel]
                for tag in (tags if rnd == 0 else tags[::-1]):
                    kernels.library = ((lambda: base) if tag == "package" else
                                       (lambda s=_SwappedLib(base, **_walk_entries(
                                           libs[kernel, tag])): s))
                    got = fn()
                    same = all(torch.equal(u, v) for u, v in zip(got, want[what])) \
                        if isinstance(got, tuple) else torch.equal(got, want[what])
                    ok &= same or tag in WALK_CUTS
                    ms = _ms(fn, reps=3)
                    print(f"[p3-walk-bounds] round {rnd + 1}, {what}, 4 warps a CTA, {tag}: "
                          f"{ms:.3f} ms, exact against the package's {same} ({card})",
                          flush=True)
    finally:
        kernels.library, near_walk.CTA_WARPS, decode_walk.CTA_WARPS = saved
    return ok


def p3_decode_feat(libs: dict, card: str) -> bool:
    """K4 at 10, 6 and 12 AVP features: the package's kernel and the
    variants ``libs`` ({tag: library}) timed in turns, each held exact to
    the package's."""
    from nblic_tpu_torch.models import strips

    _package_ptxas("p3-decode-feat", card)
    dev = torch.device("cuda")
    rng = np.random.default_rng(16)
    corpus = [synth_image(rng, 512, 768) for _ in range(18)]
    corpus += [synth_image(rng, 768, 512) for _ in range(6)]
    inputs = {"4608 lanes (a th-4 corpus, 2 rows)": (corpus, 4, 2),
              "1 lane (a 768x512 image at th 768, 8 rows)": (corpus[-1:], 768, 8)}
    base, default_n = kernels.library(), strips.AVP_N
    ok, saved = True, kernels.library
    try:
        for n_feat in (10, 6, 12):
            strips.AVP_N = n_feat
            for what, (imgs, th, rows) in inputs.items():
                conts = strips.encode_batch(imgs, th=th, device=dev)
                args = strips._walk_args([strips._parse(c) for c in conts], dev)[0]
                args = (args[0], args[1], rows, *args[3:])
                kernels.library = lambda: base
                want = strips._decode_walk(*args)
                for rnd in range(2):
                    tags = ["package", *libs]
                    for tag in (tags if rnd == 0 else tags[::-1]):
                        kernels.library = ((lambda: base) if tag == "package" else
                                           (lambda s=_SwappedLib(base, **_walk_entries(
                                               libs[tag])): s))
                        same = torch.equal(strips._decode_walk(*args), want)
                        ok &= same
                        ms = _ms(lambda: strips._decode_walk(*args), reps=3)
                        print(f"[p3-decode-feat] round {rnd + 1}, K4 at {n_feat} features, "
                              f"{what}, {tag}: {ms:.3f} ms, exact against the package's "
                              f"{same} ({card})", flush=True)
    finally:
        kernels.library, strips.AVP_N = saved, default_n
    return ok


def _scan_cases(dev) -> dict:
    """K8's arguments at one lane, at the th-64 corpus and as the near-2
    coder of the th-4 corpus: {name: (planes in K8's order, n_imgs, tune,
    k_step, n_seg, near)}."""
    from nblic_tpu_torch.models import strips

    rng = np.random.default_rng(0)
    corpus = [synth_image(rng, 512, 768) for _ in range(18)]
    corpus += [synth_image(rng, 768, 512) for _ in range(6)]
    tune = strips.TUNE
    cases = {}
    for name, imgs, th in (("one lane (768x512 at th 768)", corpus[:1], 768),
                           ("the th-64 corpus (24 x 12 lanes)", corpus, 64)):
        st, *_ = strips._prepare(imgs, th)
        b, s, th, w = st.shape
        x = torch.from_numpy(st).reshape(b * s, th, w).to(dev)
        n_seg = strips._eff_seg(tune.n_seg, w)
        seg_w = w // n_seg if tune.seg_stats else 0
        x, px0, adr, qu, qv, qw = strips._model_planes(x, strips.AVP_N, seg_w,
                                                       bool(tune.mix_e), bool(tune.w_pred))
        cases[name] = ((qu, qv, qw, x, px0, adr), b, tune, strips.K_STEP, n_seg, False)
    tune_n = strips._near_tune(tune)
    st, *_ = strips._prepare(corpus, 4)
    b, s, th, w = st.shape
    x = torch.from_numpy(st).reshape(b * s, th, w).to(dev)
    y, qu, qv, qw, key = strips._near_walk(x, b, 2, strips.AVP_N, tune_n)
    cases["the near-2 coder (24 x 192 lanes, th 4)"] = (
        (qu, qv, qw, y, key), b, tune_n, strips._k_step(2), strips._eff_seg(tune_n.n_seg, w),
        True)
    return cases


def p3_scan_phases(libs: dict, card: str) -> bool:
    """K8's phases by its stamping builds (``libs[("k8", walk)]``: the
    package's, and each forced walk of K8_WALKS) and K3's step by its cut
    copies (``libs[("k3", cut)]``), on the package beside this file; every
    K8 launch held exact to the package's kernel."""
    from nblic_tpu_torch.models import strips
    from nblic_tpu_torch.ops import rans_bin, row_scan

    dev = torch.device("cuda")
    base, saved = kernels.library(), kernels.library
    stamped, k3_entries = {}, {}
    for (kind, tag), path in libs.items():
        lib = ctypes.CDLL(str(path))
        if kind == "k8":
            lib.nbt_p3_row_scan.argtypes = base.nbt_p3_row_scan.argtypes
            lib.nbt_p3_row_scan.restype = ctypes.c_int
            lib.nbt_probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
            stamped[tag] = lib
        else:
            lib.nbt_bin_fold.argtypes = base.nbt_bin_fold.argtypes
            lib.nbt_bin_fold.restype = ctypes.c_int
            k3_entries[tag] = _SwappedLib(base, nbt_bin_fold=lib.nbt_bin_fold)
    ok = True
    folds = {}
    try:
        for name, (planes, n_imgs, tune, k_step, n_seg, near) in _scan_cases(dev).items():
            def run():
                return row_scan.scan(planes, n_imgs, tune, k_step, n_seg, near)

            kernels.library = lambda: base
            want = run()
            ms = _ms(run, reps=3)
            for tag, lib in stamped.items():
                kernels.library = lambda: _SwappedLib(base, nbt_p3_row_scan=lib.nbt_p3_row_scan)
                got = run()
                torch.cuda.synchronize()
                acc = np.zeros((n_imgs, 4), dtype=np.uint64)
                _checked(lib.nbt_probe_read(acc.ctypes.data, n_imgs), "nbt_probe_read")
                same = all(torch.equal(u, v) for u, v in zip(got, want))
                ok &= same
                ms_stamped = _ms(run, reps=3)
                th, w = planes[0].shape[1:]
                segs = th * n_seg
                mean = acc[:, :3].astype(np.float64).mean(0)
                worst = acc[:, :3].sum(1).argmax()
                print(f"[p3-scan-phases] K8 {name}, {tag}: {n_imgs} CTAs, {segs} segments "
                      f"each, {int(acc[0, 3])} barriers a CTA; exact against the package's "
                      f"{same}; package {ms:.3f} ms, this build stamped {ms_stamped:.3f}; "
                      f"cycles a segment, mean over CTAs: walk {mean[0] / segs:.0f} "
                      f"({100 * mean[0] / mean.sum():.1f}%), adds {mean[1] / segs:.0f} "
                      f"({100 * mean[1] / mean.sum():.1f}%), sweeps {mean[2] / segs:.0f} "
                      f"({100 * mean[2] / mean.sum():.1f}%); slowest CTA "
                      f"{acc[worst, :3].tolist()} cycles ({card})", flush=True)
            folds[name] = tuple(strips._fold_layout(t) for t in want)
        for name, args in folds.items():
            kernels.library = lambda: base
            want = rans_bin.fold_card(*args)
            live = args[2].sum(1)
            runs = {"package": lambda: base, **{cut: (lambda s=s: s)
                                                for cut, s in k3_entries.items()}}
            times = {tag: [] for tag in runs}
            for order in (list(runs), list(runs)[::-1]):
                for tag in order:
                    kernels.library = runs[tag]
                    got = rans_bin.fold_card(*args)
                    if tag == "package":
                        ok &= all(torch.equal(u, v) for u, v in zip(got, want))
                    times[tag].append(_ms(lambda: rans_bin.fold_card(*args), reps=5))
            longest = int(live.max())
            print(f"[p3-scan-phases] K3 the slots of {name}: {args[0].shape[0]} states x "
                  f"{args[0].shape[1]} slots, {int(live.sum())} live ({longest} on the "
                  f"longest chain); ms by round: "
                  + "; ".join(f"{tag} {' / '.join(f'{t:.3f}' for t in ts)} "
                              f"({1e6 * min(ts) / longest:.1f} ns a live step)"
                              for tag, ts in times.items()) + f" ({card})", flush=True)
    finally:
        kernels.library = saved
    return ok


def _stamped(source: Path, name: str, stamps) -> tuple[str, str]:
    """(name, text): ``source`` with each stamp of ``stamps`` (a list of
    (old, new) alternatives each, the first whose old text occurs once
    taken) applied."""
    text = source.read_text()
    for alternatives in stamps:
        # ("", "") matches nothing and changes nothing: a stamp only one
        # design needs; a third element "all" replaces every occurrence
        matching = [a for a in alternatives
                    if a[0] and (text.count(a[0]) == 1 or (a[2:] == ("all",) and a[0] in text))]
        if matching:
            text = text.replace(*matching[0][:2])
        elif ("", "") not in alternatives:
            raise ValueError(f"{name}: none of {[a[0] for a in alternatives]!r} occurs once "
                             f"in {source}")
    return name, text


def _scan_layout(x):
    """x as the package's K7 launch takes it: the tiles' own (B, T, th, tw)
    layout, or (th, tw, B, T) where its wrapper permutes (the earlier one)."""
    if "permute" in inspect.getsource(near_scan.encode_scan):
        return x.permute(2, 3, 0, 1).contiguous()
    return x


def _k7_cases(dev) -> dict:
    """K7's inputs as chip_smoke.py times them: the 18 landscape images of
    a synthetic corpus at near 2 with the bias tables of their effort-1
    containers, at 64x64 and 16x16 tiles, at profile 1 and at profile 2
    (each tile's fitted weights, flags cycling 0/1/2)."""
    from nblic_tpu_torch.ops import lsq

    rng = np.random.default_rng(0)
    imgs = [synth_image(rng, 512, 768) for _ in range(18)]
    conts = tiled.encode_batch(imgs, near=2, device=dev)
    bias = torch.from_numpy(np.stack([tiled._Parsed(c).bias for c in conts])).to(dev)
    bias = bias.to(torch.int32)
    stack = torch.from_numpy(np.stack(imgs)).to(dev)
    cases = {}
    for t in (64, 16):
        x = tiled.to_tiles(stack, t, t).to(torch.int32).contiguous()
        b, n = x.shape[:2]
        w_q, _ = lsq.fit_tile_weights(x.reshape(b * n, t, t))
        flags = torch.arange(b * n, dtype=torch.int32, device=dev).view(b, n) % 3
        wcols = tiled._lane_wcols(w_q.view(b, n, lsq.N_FEAT), flags)
        for profile in (1, 2):
            cases[f"{b * n} lanes of {t}x{t}, p{profile}"] = (
                x, bias, wcols if profile == 2 else None, profile)
    return cases


def near_scan_phases(libs: dict, card: str) -> bool:
    """K7 of the package beside this file: its wrapper (with the
    statistics), its launch alone, and its stamped build (``libs["k7"]``),
    whose chain parts' cycles a pixel step the CTAs' first threads sum;
    every stamped launch held exact to the package's."""
    dev = torch.device("cuda")
    base, saved = kernels.library(), kernels.library
    lib = ctypes.CDLL(str(libs["k7"]))
    lib.nbt_near_scan.argtypes = base.nbt_near_scan.argtypes
    lib.nbt_near_scan.restype = ctypes.c_int
    lib.nbt_probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    stamped = _SwappedLib(base, nbt_near_scan=lib.nbt_near_scan)
    ok = True
    try:
        for name, (x, bias, wcols, profile) in _k7_cases(dev).items():
            t = x.shape[-1]
            args = (x, bias, wcols, t, t, 2, profile, True)
            xs = _scan_layout(x)
            outs = [torch.empty_like(xs) for _ in range(5)]
            runs = {"wrapper": lambda: near_scan.encode_scan(*args),
                    "launch": lambda: near_scan.launch(xs, bias, wcols, 2, profile, outs)}
            kernels.library = lambda: base
            want = runs["wrapper"]()
            times = _rounds(runs)
            kernels.library = lambda: stamped
            got = runs["wrapper"]()
            stamped_ms = _ms(runs["launch"], reps=5)
            torch.cuda.synchronize()
            acc = np.zeros((65536, 6), dtype=np.uint64)
            _checked(lib.nbt_probe_read(acc.ctypes.data, 65536), "nbt_probe_read")
            same = all(torch.equal(u, v) for u, v in zip(got, want))
            ok &= same
            rows = acc[acc[:, 5] > 0].astype(np.float64)
            per = rows[:, :5].sum(0) / rows[:, 5].sum()
            print(f"[near-scan-phases] K7 {name}, near 2, {t * t} steps, {len(rows)} CTAs: "
                  f"wrapper {' / '.join(f'{v:.3f}' for v in times['wrapper'])} ms, launch "
                  f"alone {' / '.join(f'{v:.3f}' for v in times['launch'])} ms (two rounds), "
                  f"stamped launch {stamped_ms:.3f} ms, exact against the package's {same}; "
                  f"cycles a pixel step on a CTA's first lane, stamped: "
                  + ", ".join(f"{part} {v:.1f} ({100 * v / per.sum():.1f}%)"
                              for part, v in zip(SCAN_PARTS, per))
                  + f"; total {per.sum():.1f} (the launch alone "
                  f"{1e-3 * min(times['launch']) * CLOCK_HZ / (t * t):.1f} a step at "
                  f"{CLOCK_HZ / 1e9:.2f} GHz) ({card})", flush=True)
    finally:
        kernels.library = saved
    return ok


def _k9_inputs(dev) -> dict:
    """K9's middle launch of two decode walks as chip_smoke.py times them,
    captured on the package's own walk: {name: (tables it found, planes,
    contract, map_cols, bias_cols)}: a synthetic corpus (18 512x768 and 6
    768x512 images) at strip height 4 (24 images x 192 lanes, 16-column
    segments) and its first image at strip height 768 (one lane), that
    walk cut to its first 4 rows."""
    from nblic_tpu_torch.models import strips
    from nblic_tpu_torch.ops import table_replay

    rng = np.random.default_rng(0)
    corpus = [synth_image(rng, 512, 768) for _ in range(18)]
    corpus += [synth_image(rng, 768, 512) for _ in range(6)]
    out = {}
    for name, imgs, th, rows in (("the th-4 corpus", corpus, 4, None),
                                 ("one image at th 768, 4 rows", corpus[:1], 768, 4)):
        conts = strips.encode_batch(imgs, th=th, device=dev)
        args = strips._walk_args([strips._parse(c) for c in conts], dev)[0]
        if rows is not None:
            args = (args[0], args[1], rows, *args[3:])
        launch, seen = table_replay.launch, []

        def capture(walk, map_cols=None, bias_cols=None):
            seen.append((table_replay.Tables(*(t.clone() for t in walk.tables)),
                         tuple(None if v is None else v.clone() for v in walk.planes),
                         walk.con, map_cols, bias_cols))
            launch(walk, map_cols, bias_cols)

        capture.launches = 0
        table_replay.launch = capture
        try:
            strips._decode_walk(*args)
            torch.cuda.synchronize()
        finally:
            table_replay.launch = launch
        out[name] = seen[len(seen) // 2]
    return out


def _queued_ms(fn, reps: int = 5, runs: int = 50) -> float:
    """Median device milliseconds of one of ``runs`` calls of ``fn``, the
    calls queued behind a ~20 ms sleep kernel so that their issue on the
    host hides behind it; ``reps`` runs."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(0.02 * CLOCK_HZ))
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / runs)
    return float(np.median(times))


def replay_phases(libs: dict, card: str) -> bool:
    """K9 of the package beside this file on the middle launch of two
    walks: the package's kernel and its copies with one phase cut
    (``libs[cut]``, wrong output on purpose), each timed on the device
    queued behind a sleep (50 successive launches on a copy of the tables
    the launch found, median of 5 runs, two rounds in opposite orders),
    and its copies at another team a CTA (``libs["team n"]``, exact against
    the package's); then the stamped builds (``libs["stamped..."]``, at
    each team), exact against the package's, their phases' cycles on each
    CTA's first thread."""
    from nblic_tpu_torch.ops import table_replay

    dev = torch.device("cuda")
    base, saved = kernels.library(), kernels.library
    text = (kernels.CSRC / "image_tables.cuh").read_text()
    phases = next(v for k, v in REPLAY_PHASES.items() if f"NBT_HD void {k}(" in text)
    entries = {}
    for tag, path in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.nbt_p3_table_replay.argtypes = base.nbt_p3_table_replay.argtypes
        lib.nbt_p3_table_replay.restype = ctypes.c_int
        if tag.startswith("stamped"):
            lib.nbt_probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        entries[tag] = (lib, _SwappedLib(base, nbt_p3_table_replay=lib.nbt_p3_table_replay))
    ok = True
    try:
        for name, (tb0, planes, con, map_cols, bias_cols) in _k9_inputs(dev).items():
            def fresh():
                return table_replay.prepare(table_replay.Tables(*(t.clone() for t in tb0)),
                                            planes, con)

            kernels.library = lambda: base
            want = fresh()
            table_replay.launch(want, map_cols, bias_cols)
            runs = {"package": base, **{tag: sw for tag, (_, sw) in entries.items()
                                        if not tag.startswith("stamped")}}
            times = {tag: [] for tag in runs}
            for order in (list(runs), list(runs)[::-1]):
                for tag in order:
                    kernels.library = lambda lib=runs[tag]: lib
                    work = fresh()
                    times[tag].append(_queued_ms(
                        lambda: table_replay.launch(work, map_cols, bias_cols)))
            for tag in runs:  # another team computes what the package's does
                if tag.startswith("team"):
                    kernels.library = lambda lib=runs[tag]: lib
                    check = fresh()
                    table_replay.launch(check, map_cols, bias_cols)
                    ok &= all(torch.equal(u, v) for u, v in zip(check.tables, want.tables))
            n_imgs = planes[0].shape[1] // con.lanes_per_image
            print(f"[replay-phases] K9 {name}'s middle launch ({n_imgs} images x "
                  f"{con.lanes_per_image} lanes, mapper columns {map_cols}, bias columns "
                  f"{bias_cols}): us on the device by round, "
                  + "; ".join(f"{tag} {' / '.join(f'{1e3 * v:.2f}' for v in ts)}"
                              for tag, ts in times.items()) + f" ({card})", flush=True)
            for tag, (lib, sw) in entries.items():
                if not tag.startswith("stamped"):
                    continue
                kernels.library = lambda sw=sw: sw
                got = fresh()
                table_replay.launch(got, map_cols, bias_cols)
                torch.cuda.synchronize()
                same = all(torch.equal(u, v) for u, v in zip(got.tables, want.tables))
                ok &= same
                acc = np.zeros((n_imgs, 4), dtype=np.int64)
                _checked(lib.nbt_probe_read(acc.ctypes.data, n_imgs), "nbt_probe_read")
                mean = acc.mean(0)
                print(f"[replay-phases] K9 {name}, {tag} build: exact {same}, cycles on a "
                      f"CTA's first thread, mean over CTAs: "
                      + ", ".join(f"{ph} {v:.0f}" for ph, v in zip(phases, mean))
                      + f" (total {mean.sum():.0f}, {1e6 * mean.sum() / CLOCK_HZ:.2f} us at "
                      f"{CLOCK_HZ / 1e9:.2f} GHz) ({card})", flush=True)
    finally:
        kernels.library = saved
    return ok


def interop(card: str) -> bool:
    from chip_smoke import StageClock
    from nblic_tpu_torch import runtime
    from nblic_tpu_torch.models import nblic, qnblic

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    runtime.build()
    print(f"[interop] native runtime built in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(11)
    img = synth_image(rng, 512, 768)
    ok = True
    qnblic.encode(img[:8], device=dev)  # warm-up
    for name, im in (("synthetic", img), ("flat", np.full((512, 768), 97, np.uint8))):
        fold.encode_fold.launches = 0
        with StageClock([(qnblic, "_context_chain", "stage 1 and chain"),
                         (qnblic, "encode_fold", "fold")]) as clock:
            t0 = time.perf_counter()
            c = qnblic.encode(im, device=dev)
            enc_s = time.perf_counter() - t0
        same = c == runtime.q_encode(im, n_threads=1)
        ok &= same
        print(f"[interop q0.2 encode] {name} 768x512 on the card {enc_s:.2f} s, stages ms "
              f"{ {k: round(v, 1) for k, v in clock.stages().items()} }, K1 launches "
              f"{fold.encode_fold.launches}, equal to native {same} ({card})", flush=True)
    crop = img[:4]
    sym = torch.from_numpy(rng.integers(1, 1 << 15, size=(2, crop.size))).to(dev)
    k = fold.encode_fold(sym[:1], sym[1:] // 2)
    p = rans.encode_scan(sym[:1], sym[1:] // 2)
    same = all(torch.equal(a, b) for a, b in zip(k, p))
    ok &= same
    print(f"[interop K1 S=1] L={crop.size} kernel == plain {same}", flush=True)
    for rows in (1, 2):
        crop = img[:rows]
        ref = runtime.q_encode(crop, n_threads=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back = qnblic.decode(ref, device=dev)
        s = time.perf_counter() - t0
        same = np.array_equal(back, crop)
        ok &= same
        print(f"[interop q0.2 decode] {crop.shape} {s:.2f} s, {1e3 * s / crop.size:.3f} ms a "
              f"pixel, exact {same} ({card})", flush=True)
    for effort, near, rows in ((1, 0, 1), (1, 2, 1), (3, 0, 1)):
        crop = img[:rows]
        ref = runtime.n_encode(crop, near=near, effort=effort)
        t0 = time.perf_counter()
        c = nblic.encode(crop, near=near, effort=effort, device=dev)
        enc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = nblic.decode(c, device=dev)
        dec_s = time.perf_counter() - t0
        same = c == ref and np.array_equal(back, runtime.n_decode(ref)[0])
        ok &= same
        print(f"[interop nblic] e{effort} near {near} {crop.shape}: "
              f"encode {1e3 * enc_s / crop.size:.3f} ms a pixel, decode "
              f"{1e3 * dec_s / crop.size:.3f} ms a pixel, {8 * len(c) / crop.size:.3f} "
              f"bpp, equal to native {same} ({card})", flush=True)
    crop = img[:1, :64]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        nblic.encode(crop, effort=1, device=dev)
        wall = time.perf_counter() - t0
    dev_ms, launches = _device_kernels(prof)
    print(f"[interop profile] e1 encode of {crop.shape}: device {dev_ms:.1f} ms in "
          f"{1e3 * wall:.1f} ms of wall ({100 * dev_ms / (1e3 * wall):.1f}%), "
          f"{launches / crop.size:.0f} device launches a pixel ({card})", flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probes", nargs="+", choices=("cut-chain", "slot-bits", "k2-width", "fold",
                                                     "build", "near-stages", "p3-stages",
                                                     "p3-corpus", "p3-model", "p3-model-forms",
                                                     "p3-model-phases",
                                                     "p3-decode",
                                                     "p3-near", "p3-walk", "p3-walk-bounds",
                                                     "p3-decode-feat", "p3-scan-phases",
                                                     "near-scan-phases", "replay-phases",
                                                     "interop"))
    ap.add_argument("--parent", type=Path,
                    help="cut-chain: also cut this group_decode.cu of the parent design; "
                         "p3-model-phases: the parent design's csrc/ (or a file in it)")
    ap.add_argument("--before", type=Path, action="append", default=[],
                    help="k2-width: also time this group_decode.cu (repeatable)")
    ap.add_argument("--chain-before", type=Path,
                    help="p3-walk-bounds: also build K5 and K4 on the avp_chain.cuh and "
                         "udiv64.cuh in this directory")
    ap.add_argument("--decode-variant", type=Path, action="append", default=[],
                    help="p3-decode-feat: also time the p3_decode_walk.cu in this directory "
                         "(repeatable)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_probe: needs a CUDA GPU", file=sys.stderr)
        return 1
    specs = {}  # (probe, key) -> (name, text)
    cut_dirs = {}  # (probe, key) -> the directory a variant builds in
    if "cut-chain" in args.probes:
        designs = [("current", K2_SRC, CUTS_CURRENT)]
        if args.parent:
            designs.append(("parent", args.parent, CUTS_PARENT))
        for design, src, cuts in designs:
            for cut, repl in {"base": [], **cuts}.items():
                specs[(design, cut)] = variant(src, f"{design}_{cut}", repl)
    if "slot-bits" in args.probes:
        for k in range(8, 13):
            specs[("slot-bits", k)] = variant(K2_SRC, f"slot_bits_{k}",
                                              [(SLOT_LINE, f"constexpr int kSlotBits = {k};")])
    if "k2-width" in args.probes:
        specs[("k2-width", "current")] = variant(K2_SRC, "width_current", [])
        for path in args.before:
            specs[("k2-width", path.stem)] = variant(path, f"width_{path.stem}", [])
    if "fold" in args.probes:
        for block in (32, 64, 128):
            specs[("fold", block)] = variant(K1_SRC, f"fold_{block}",
                                             [(BLOCK_LINE, f"constexpr int kBlock = {block};")])
    if "p3-model-forms" in args.probes:
        for chunk, ring in K10_CHUNKS.items():
            where = PROBE_DIR / f"k10_chunk_{chunk}"
            where.mkdir(parents=True, exist_ok=True)
            header = (kernels.CSRC / "model_chain.cuh").read_text()
            for old, new in zip(K10_CHUNK, (f"constexpr int kChainChunk = {chunk};",
                                            f"constexpr int kChainRing = {ring};")):
                if header.count(old) != 1:
                    raise ValueError(f"{old!r} occurs {header.count(old)} times in "
                                     "model_chain.cuh")
                header = header.replace(old, new)
            (where / "model_chain.cuh").write_text(header)
            specs[("k10", f"{chunk} steps between barriers")] = (f"k10_chunk_{chunk}",
                                                                  K10_SRC.read_text())
            cut_dirs[("k10", f"{chunk} steps between barriers")] = where
        for rows in K10_ROWS:
            specs[("k10", f"{rows} rows a thread at 32 lanes")] = variant(
                K10_SRC, f"k10_rows_{rows}",
                [(K10_ROWS_LINE, K10_ROWS_LINE.replace("= 2;", f"= {rows};"))])
        specs[("k10", "k11 <12> at n = 10")] = variant(
            K11_SRC, "k11_n10_as_12", [(K11_N10_LINE, K11_N10_LINE.replace("n == 10", "false"))])
    if "p3-model-phases" in args.probes:
        for tag, src in (("k10", K10_SRC), ("k11", K11_SRC)):
            specs[("model-phases", f"{tag} stamped")] = (
                f"{tag}_stamped", "#define NBT_PROBE_STAMPS\n" + src.read_text())
        if K11_STAGES_LINE in K11_SRC.read_text():
            specs[("model-phases", "k11 two stages")] = variant(
                K11_SRC, "k11_two_stages",
                [(K11_STAGES_LINE, K11_STAGES_LINE.replace("= 1;", "= 2;"))])
            specs[("model-phases", "k11 next batch to L2")] = variant(
                K11_SRC, "k11_l2", [K11_L2_PREFETCH])
        if args.parent:
            parent = args.parent if args.parent.is_dir() else args.parent.parent
            for tag, name, stamps, avp_stamps in (
                    ("k10", "p3_model_chains.cu", K10_PARENT_STAMPS, None),
                    ("k11", "p3_model_solve.cu", K11_PARENT_STAMPS, AVP_PARENT_STAMPS)):
                for stamped in (False, True):
                    key = f"parent {tag}" + (" stamped" if stamped else "")
                    where = PROBE_DIR / key.replace(" ", "_")
                    where.mkdir(parents=True, exist_ok=True)
                    for h in parent.glob("*.cuh"):
                        text = h.read_text()
                        if stamped and avp_stamps and h.name == "avp_chain.cuh":
                            text = variant(h, key, avp_stamps)[1]
                        (where / h.name).write_text(text)
                    specs[("model-phases", key)] = variant(parent / name, key.replace(" ", "_"),
                                                           stamps if stamped else [])
                    cut_dirs[("model-phases", key)] = where
    if "p3-walk-bounds" in args.probes:
        for kernel, src in WALK_SRCS.items():
            for n in WALK_MIN_CTAS:
                specs[(kernel, f"min {n} CTAs")] = variant(
                    src, f"{kernel}_min{n}",
                    [(WALK_BOUNDS_LINE, f"{WALK_BOUNDS_LINE[:-1]}, {n})")])
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    before_dir = PROBE_DIR / "chain_before"
    if "p3-decode-feat" in args.probes:
        for where in args.decode_variant:
            specs[("k4-feat", where.name)] = (f"k4_{where.name}",
                                              (where / "p3_decode_walk.cu").read_text())
            cut_dirs[("k4-feat", where.name)] = where
    if "p3-walk-bounds" in args.probes:
        for cut, (header, old, new) in WALK_CUTS.items():
            where = PROBE_DIR / ("cut_" + cut.replace(" ", "_"))
            where.mkdir(parents=True, exist_ok=True)
            for h in ("avp_chain.cuh", "udiv64.cuh"):
                text = (kernels.CSRC / h).read_text()
                if h == header:
                    if text.count(old) != 1:
                        raise ValueError(f"{cut}: {old!r} occurs {text.count(old)} times in {h}")
                    text = text.replace(old, new)
                (where / h).write_text(text)
            specs[("k5", cut)] = (f"k5_{where.name}", WALK_SRCS["k5"].read_text())
            cut_dirs[("k5", cut)] = where
    if "p3-walk-bounds" in args.probes and args.chain_before:
        before_dir.mkdir(exist_ok=True)
        for header in ("avp_chain.cuh", "udiv64.cuh"):
            shutil.copy(args.chain_before / header, before_dir / header)
        for kernel, src in WALK_SRCS.items():
            specs[(kernel, "chain before")] = (f"{kernel}_chain_before", src.read_text())
    if "p3-scan-phases" in args.probes:
        header = (kernels.CSRC / "row_scan.cuh").read_text()
        walks = {"package": header}
        if K8_WALK_LINE in header:
            walks.update({tag: header.replace(K8_WALK_LINE, line)
                          for tag, line in K8_WALKS.items()})
        for tag, text in walks.items():
            where = PROBE_DIR / ("k8_" + tag.replace(" ", "_"))
            where.mkdir(parents=True, exist_ok=True)
            (where / "row_scan.cuh").write_text(text)
            specs[("scan", ("k8", tag))] = variant(kernels.CSRC / "p3_row_scan.cu",
                                                   f"k8_stamps_{tag.replace(' ', '_')}",
                                                   [(SCAN_SYNC, SCAN_STAMPS)])
            cut_dirs[("scan", ("k8", tag))] = where
        for cut, alternatives in K3_CUTS.items():
            cut_dir = PROBE_DIR / ("k3_" + cut.replace(" ", "_"))
            cut_dir.mkdir(parents=True, exist_ok=True)
            matching = [a for a in alternatives
                        if (kernels.CSRC / a[0]).read_text().count(a[1]) == 1]
            if not matching:
                raise ValueError(f"K3 cut {cut!r}: no alternative matches the sources")
            header, old, new = matching[0]
            for h in ("coder3.cuh", "bin_fold.cu"):
                text = (kernels.CSRC / h).read_text()
                (cut_dir / h).write_text(text.replace(old, new) if h == header else text)
            specs[("scan", ("k3", cut))] = (f"k3_{cut_dir.name}", (cut_dir / "bin_fold.cu")
                                            .read_text())
            cut_dirs[("scan", ("k3", cut))] = cut_dir
    if "near-scan-phases" in args.probes:
        specs[("k7-phases", "k7")] = _stamped(kernels.CSRC / "near_scan.cu", "k7_stamped",
                                              SCAN_STAMPS_AT)
    if "replay-phases" in args.probes:
        k9_src = kernels.CSRC / "p3_table_replay.cu"
        specs[("k9-phases", "stamped")] = _stamped(k9_src, "k9_stamped", REPLAY_STAMPS)
        if REPLAY_TEAM_LINE in k9_src.read_text():
            for n in REPLAY_TEAMS:
                team = [[(REPLAY_TEAM_LINE, REPLAY_TEAM_LINE.replace("512", str(n)))]]
                specs[("k9-phases", f"team {n}")] = _stamped(k9_src, f"k9_team_{n}", team)
                specs[("k9-phases", f"stamped team {n}")] = _stamped(
                    k9_src, f"k9_stamped_team_{n}", team + REPLAY_STAMPS)
        for cut, alternatives in REPLAY_CUTS.items():
            cut_dir = PROBE_DIR / ("k9_" + cut.replace(" ", "_"))
            cut_dir.mkdir(parents=True, exist_ok=True)
            matching = [a for a in alternatives
                        if (kernels.CSRC / a[0]).read_text().count(a[1]) == 1]
            if not matching:  # a phase of the other design
                continue
            header, old, new = matching[0]
            for h in ("image_tables.cuh", "p3_table_replay.cu"):
                text = (kernels.CSRC / h).read_text()
                (cut_dir / h).write_text(text.replace(old, new) if h == header else text)
            specs[("k9-phases", cut)] = (f"k9_{cut_dir.name}",
                                         (cut_dir / "p3_table_replay.cu").read_text())
            cut_dirs[("k9-phases", cut)] = cut_dir
    libs = {}
    if specs:
        def build(key):
            name, text = specs[key]
            return _build(name, text, cut_dirs.get(key, before_dir if key[1] == "chain before"
                                                   else PROBE_DIR))

        with ThreadPoolExecutor(len(specs)) as pool:
            libs = dict(zip(specs, pool.map(build, specs)))

    def of(group):
        return {key: lib for (g, key), lib in libs.items() if g == group}

    card = _card()
    ok = True
    for design in ("current", "parent"):
        if of(design):
            ok &= cut_chain(of(design), design, card)
    if of("slot-bits"):
        ok &= slot_bits(of("slot-bits"), card)
    if of("k2-width"):
        ok &= k2_width(of("k2-width"), card)
    if of("fold"):
        ok &= fold_blocks(of("fold"), card)
    if "build" in args.probes:
        ok &= build_ways(card)
    if "near-stages" in args.probes:
        ok &= near_stages(card)
    if "p3-stages" in args.probes:
        ok &= p3_stages(card)
    if "p3-corpus" in args.probes:
        ok &= p3_corpus(card)
    if "p3-model" in args.probes:
        ok &= p3_model(card)
    if of("k10"):
        ok &= p3_model_forms(of("k10"), card)
    if of("model-phases"):
        ok &= p3_model_phases(of("model-phases"), card)
    if "p3-decode" in args.probes:
        ok &= p3_decode(card)
    if "p3-near" in args.probes:
        ok &= p3_near(card)
    if "p3-walk" in args.probes:
        ok &= p3_walk(card)
    if "p3-decode-feat" in args.probes:
        ok &= p3_decode_feat(of("k4-feat"), card)
    if of("scan"):
        ok &= p3_scan_phases(of("scan"), card)
    if of("k7-phases"):
        ok &= near_scan_phases(of("k7-phases"), card)
    if of("k9-phases"):
        ok &= replay_phases(of("k9-phases"), card)
    walk_libs = {key: lib for key, lib in libs.items() if key[0] in WALK_SRCS}
    if walk_libs:
        ok &= p3_walk_bounds(walk_libs, card)
    if "interop" in args.probes:
        ok &= interop(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
