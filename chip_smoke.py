#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: compile the CUDA kernels from nblic_tpu_torch/csrc (nvcc, sm_90a,
     one process a source), with ptxas's report and a line of registers,
     stack frame and spills for each K5 and K4 instance, then K5's warp
     chain alone (one warp a system: the solve and the prediction) held
     exact to avp.solve_batch / predict_from_solve at n = 1..12, then K2's
     slot-table k, stream ring and shared memory a CTA, K7's shared memory
     a CTA and K1's a block;
  3. K1 (rANS fold) against its plain version on the card, exact;
  4. K2 (group decode), profile 1, against its plain version, exact;
  5. reference: the card's containers and pixels equal the CPU plain path's
     on small images;
  6. main path, effort 1: a Kodak-shaped synthetic corpus (24 images) and
     one 3072x4096 frame through compress_tiled / encode_corpus /
     decode_batches, pixel-exact, with K1 and K2 launched during the run;
  7. K2, profile 2 (per-tile least-squares predictors), against its plain
     version, exact, at the main path's 64x64 tiles and at 16x16 and 8x8;
  8. K2' (K2's kernel with one table set per group) against its plain
     version and against K2 on the corpus's groups at 16x16 tiles, exact,
     and beside K2 on the frame (and, in the mesh phase, at g = 48);
  9. reference, effort 2: with the same per-tile weights and flags, the
     card's containers equal the CPU's byte for byte; free-running, each
     side's containers decode pixel-exact on the other;
 10. main path, effort 2: the corpus and the frame at effort 2, pixel-exact,
     with K1 and K2 launched during the run;
 11. near-lossless (near 2 and 9): the card's containers equal the CPU's on
     small images at efforts 1 and 2, each side decoding the other's within
     near; the corpus at near 2 through encode_corpus / decode_batches at
     efforts 1 and 2 (all 24 images each), and the 3072x4096 frame at near
     2, effort 1, through api.compress_tiled / decompress_tiled, max error
     <= 2, with K7, K1 and K2 launched during each run; K7 (the feedback
     scan) against its plain version, exact on all five planes with the
     statistics and on y and qd without: at 64x64 tiles over the 18
     landscape images (1,728 lanes) and over the first alone (96 lanes),
     profile 1, over the 18 at profile 2 (flags 0/1/2), and at 16x16 tiles
     over the 18 (27,648 lanes), profiles 1 and 2, each timed as the wrapper
     and as its launch alone; the final scan's histograms equal the
     corpus containers'; K2's near instances (<1, false>, <2, false>, the
     latter at 64x64 and 16x16 tiles) against the plain decoder, exact,
     <1, false> beside <1, true>.  (kernel_probe.py near-stages times a
     near encode's stages.)
 12. profile 3 (effort 3; the modeling pass on K10 and K11,
     csrc/p3_model_chains.cu and p3_model_solve.cu; the decodes on K4,
     csrc/p3_decode_walk.cu): the card's
     containers equal the CPU's for a 48x64 and a 64x48 image as one batch
     at strip heights 16 and 64, and each alone at 16, under TUNE_V4,
     TUNE_MAX and TUNE_V4S; the whole corpus as one strips.encode_batch at
     strip height 64 (288 strip lanes), with its bpp, MPix/s, peak device
     memory and the time of each stage (modeling, row scan, fold, packing
     and containers; each stage function wrapped here to sync the card when
     it returns), two of its containers held against the CPU's; on the
     corpus's own strips the modeling pass on K10 and K11 against the plain
     loops on the card (time, peak memory, px0), then K10 (the statistics
     and the mix chains) and K11 (the solve) each against its plain version
     on the same tensors, exact, timed beside its bound and floor (and the
     same at the th-768 image of phase 14's full encode); one 16x32
     image through api.compress_tiled(effort=3).  Decode: the pairs on the
     card equal to the images (at strip height 8), the three committed
     fixtures (near 2, legacy, static bias; tests/data_torch_p3) equal to
     nblic_tpu's pixels, the corpus at strip height 4 (4608 lanes, 2048
     pixel steps) through tiled.decode_batch, exact, with its MPix/s, the
     walk's time a pixel step, the peak device memory and the projected
     time of one image at strip height 768, and
     api.decompress of the effort-3 container; a process of its own decodes
     the same containers on the CPU meanwhile, which must agree.  Every
     decode runs K4 (counted).
     (kernel_probe.py p3-stages times one 768x512 encode at the default
     strip height.)
 13. profile 3, near-lossless (the feedback walk on K5, csrc/p3_near_walk.cu,
     one launch a row): the card's near-2 container of the committed
     fixture's image equals nblic_tpu's bytes (tests/data_torch_p3/near2.nbtc);
     the 48x64 / 64x48 pair as one batch at strip height 8, near 1 and
     near 3, equal to the CPU's and decoded on the card within near; the
     four edge images (utils/synth.py: checkerboard, saturated ramp,
     constant, 1-pixel stripes) at th 8, near 1, equal to the CPU's; K5
     against the plain walk on the card, exact on all five planes and each
     timed in ms a pixel step: the pair at near 1 and 3 and the edge images
     under TUNE_V4's and TUNE_V4S's near contracts (mix_e 1 and 0); the
     whole corpus at near 2 through tiled.encode_corpus(effort=3) at strip
     height 4 (4608 lanes, 2048 pixel steps), with its bpp, MPix/s, peak
     device memory, the stages' times and K5's launches, two of its
     containers held against the CPU's, then K5 against the plain walk on
     that walk's own input, K5 timed beside its bound and floor; one corpus
     corpus's walk at th 768 (24 lanes, one an image, 393,216 steps)
     timed; the corpus
     decoded on the card through tiled.decode_batch within 2 (K4).  The
     CPU's encodes of phases 12-14 and its decodes run in a pool of three
     processes started before phase 12, beside the card's work.
     (kernel_probe.py p3-walk: K5's SASS and step times by lane count;
     p3-near: the stages against the lane count.)
 14. K4, the profile-3 decode walk (csrc/p3_decode_walk.cu, a launch a
     row or a column segment, each followed by K9): K4 against the plain
     walk on the card on the same walk inputs, exact and each timed: the
     pair at th 8 under TUNE_V4, TUNE_MAX and TUNE_V4S, the edge images at
     near 0 and 3, the pair with 6 AVP features; on the corpus walk's own
     input of phase 12 (th 4), K4 timed (median of 3) beside its bound and
     floor, its divisions priced by path and its bins counted on a plain
     walk of the same input, which it must equal; K9 (the image tables'
     replay, csrc/p3_table_replay.cu) held to replay_plain on every launch
     of that walk, each on the tables it found, then its middle launch
     timed beside the plain replay, its bound and its floor; one corpus
     image encoded on the CPU at th 768 (one lane, 393,216 steps) decoded
     through strips.decode on K4 and K9, exact, with its seconds and us a
     step, K9 held and timed likewise on that walk's first P3_K9_ROWS rows,
     then that container as the corpus's 24 lanes at th 768, the walk cut
     to its first 192 rows, exact.  Every profile-3 decode and near encode
     on an entry point counts K9's launches, which must equal K4's or K5's.
 15. interop (Q0.2, NBLIC0.3): the port's copy of the native runtime built
     with g++; the 24-image corpus through api.compress / decompress(
     backend="native") at effort 0 (1 and 4 threads), 1, 2, 3 and effort 1
     near 2 in a pool of four processes, with host MPix/s and bpp, all
     collected before the card's walks are timed (the walks are bound by
     the host's issue rate); the runtime copy's containers equal the committed
     nblic_tpu fixtures (tests/data_torch_interop); the device engines on
     the card (plain PyTorch walks, one lane) on the fixture's 2x768 crop of
     a Kodak-shaped image: Q0.2, effort 1 near 0 and 2, effort 3, each
     container equal to the fixture's and the native copy's and decoded on
     the card as the native copy decodes it, in ms a pixel with the
     projected time of one 768x512 image; the Q0.2 encode of a whole corpus
     image on the card (the context chain's lanes, then K1 at S = 1, L =
     393,216), equal to the native copy's; K1 at S = 1 held to its plain
     version on the crop's tables (on the card) and on the image's (the
     plain fold on the CPU), and timed on the image's beside its bound and
     its serial chain.  (kernel_probe.py interop also times a flat
     image's chain.)
 16. the mesh (nblic_tpu_torch/parallel/mesh.py): ranks spawned by
     mesh.launch on the one card (gloo; ranks sharing a card measure
     correctness, not scaling): two ranks run the corpus by shape through
     encode_batch_mesh / decode_batch_mesh at (1, 2) (g = 48) and (2, 1)
     (g = 96), with MPix/s, the all-reduce's ms and K1's and K2's launches
     per rank, the single-process tiled.decode_batches on the card reading
     their containers; p3_encode_batch_mesh of the corpus at (2, 1), th 64,
     equal to phase 12's containers, and p3_decode_batch_mesh of the pair at
     th 8 (K4 on each rank); four ranks encode the committed JAX mesh fixtures
     (tests/data_torch_mesh) at (2, 2) and (1, 4), equal to nblic_tpu's
     bytes, and decode them; K2 against its plain version at g = 2, 6, 24
     and 48 (16x16 tiles) and at the corpus's g = 96 (64x64 tiles), K2' and
     K2 against it at g = 48 (64x64 tiles, 7 images of the (1, 2) run),
     K1 against its plain fold at a (1, 2) shard's S = 864, L = 4096; one
     NCCL rank encodes and decodes the 6 portrait images.
Each kernel's time stands beside its bound (the whole card's roofline:
bytes over the memory rate, integer operations over the int32 rate) and
its floor (the least time at the launch's own parallelism: the issue of
one SM's schedulers for K2 and K2', of one scheduler's warps for K7, the
larger of a scheduler's warps' issue and the chain's dependent path for
K5 and K4 (one warp a lane), the serial chain for K1, the dependent path
of its CTA for K9).  Then one
JSON line of the kernels' measured numbers and bounds, the whole command's
time, and as the last line {"ok": true, "device": {...}}.  Needs no
network; imports no JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import multiprocessing
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
SMS, CLOCK_HZ = 132, 1.98e9  # SMs and boost clock (Hopper white paper)
# int32 operations: 132 SMs x 64 INT32 lanes x 1.98 GHz boost
INT32_OPS_PER_S = SMS * 64 * CLOCK_HZ
# integer operations per step, counted from the CUDA sources (a division, a
# load, a store, a barrier or a cp.async counts as one): K1 per symbol; K2
# per pixel of an active lane of group_decode_kernel<profile, true>, as a
# warp issues them: the previous pixel's renormalization (byte-packed warp
# counts ~20, ring word and state ~10), row-above taps ~10, activity bin
# ~43, blend predictor ~147 (eight candidates' costs ~100, the three-round
# argmin ~18, blend ~29), context address ~27, bias ~9, slot lookup ~9,
# span search ~11 (one round: most warps hold a lane whose span is one
# symbol wide), state ~7, ballot, rank and count ~9, unfold ~19, error and
# stores ~8, window slide ~15, ring refill (the end, the 16-byte cp.async,
# commit, wait) ~15, barrier, parity and loop ~5; profile 2 adds the
# 12-weight prediction ~27 and the flag select ~5.  K2' is held to K2's
# count: the same work.
K1_OPS_PER_SYMBOL = 13
K2_OPS_PER_PIXEL = {1: 364, 2: 396}
# near > 0 (group_decode_kernel<profile, false>): the unfold adds near to the
# fold bound, divides it by the step and multiplies the magnitude by it
K2_NEAR_OPS = 3
# K7 per pixel of a lane of near_scan_kernel<profile, false>, the scan's own
# work only, from K2's tally: row-above taps ~10, activity bin ~43, blend
# predictor ~147, context address ~27, bias ~9, fold ~14 (two divisions),
# unfold ~22, error ~1, window slide ~15; profile 2 adds K2's ~32.  The
# pixel ring, the loop and the stores are the implementation's (the stores'
# bytes are the bound's other term).  The statistics (<profile, true>) add
# the subtraction x - px0.
K7_OPS_PER_PIXEL = {1: 276, 2: 308}
K7_STATS_OPS = 1
K7_LANES = 32  # lanes a CTA: one warp
# (The fold and the unfold are one function, near_fold: ty once, the
# quotients by a multiply-high, ~24 ops where a fold of ~14 and an unfold
# of ~22 stood: 12 fewer a pixel.)  K7's times in its earlier design (a
# wrapper copying to and from a (th, tw, B, T) layout, three divisions a
# pixel), as PERF.md §6 records them (NVIDIA H100 80GB HBM3, 700.00 W), by
# (lanes, tile side, profile): the wrapper with the statistics; its launch
# alone.
K7_EARLIER = {
    (1728, 64, 1): "wrapper 2.175-2.355 ms, launch alone 1.811-1.821 ms",
    (1728, 64, 2): "wrapper 2.214-2.323 ms, launch alone 1.770-1.776 ms",
    (96, 64, 1): "wrapper 1.867-2.061 ms, launch alone 1.815-1.829 ms",
    (27648, 16, 1): "wrapper 0.560-0.619 ms, launch alone 0.170-0.182 ms",
    (27648, 16, 2): "wrapper 0.546-0.726 ms, launch alone 0.182-0.206 ms",
}
# K5 per pixel of a lane of p3_near_row_kernel<10, mix>: arithmetic only,
# as K7's tally (loads, stores, address and loop arithmetic, the swap of
# pivot rows are the implementation's), a 64-bit add, shift or compare as
# two 32-bit instructions and a 64-bit product as three.  Its 495 runtime
# 64-bit divisions are priced by the path nvcc's code takes for their
# operands (the SASS listing of kernel_probe.py p3-walk): 385 of tdiv_by
# (330 in the elimination, 45 in the back substitution, 10 in the
# prediction) divide magnitudes, unsigned, by a 70-instruction routine;
# the moments' 110 divide signed by an 84-instruction routine; either
# takes an inline 19-instruction path where both operands lie in [0,
# 2^32).  Which path each takes depends on the data, so the walk's own
# split is counted (_division_paths).  The rest, K5_OTHER_OPS: the window
# to the unfold, as K7's tally, 288; the dual-bin quantizers (a 32-bit
# division) 70; the features and the t tap 13; the system from E + F 482;
# the 375 elimination and back-substitution updates (the wrapping
# product 3, the magnitude 5, the sign test 1, the division's path test
# 3, the sign fix 5, the subtraction 2) 7,125; the pivot search and the
# 18 divisors 675; the prediction's 10 terms (28 each, the path test
# included), the clip and the rounding 295; the moments' update (the
# sample weight 23; 111 channels of B and E each decayed and summed, 20
# an update as the listing's F chain shows; 110 moments' numerators and
# path tests, 9 each) 5,455; the row's F chain, amortized a pixel, 2,220;
# the bias moments' index and error 4.  Under mix_e, K5_MIX_OPS: the mix
# F chain 40, the mix E + F 4, the blend 34 and its division at the
# inline path (its operands lie below 2^32 wherever the decayed energies
# stay below 2^28; counted at the least, 19), the mix update 88, the
# select 1.
K5_UDIV64 = 70   # the unsigned 64-bit division routine, instructions
K5_SDIV64 = 84   # the signed one
K5_DIV32 = 19    # the inline path of either, both operands in [0, 2^32)
K5_OTHER_OPS = 16627
K5_MIX_OPS = 186
# K5 and K4 run one warp a lane, and a warp instruction does as
# many of a lane's operations as it has threads at work on them.  So the
# operations above go to the floor's issue term by the share of a warp's
# 32 threads each part of the chain keeps busy (avp_chain.cuh): what is
# one value a pixel (the window to the unfold, the quantizers, the
# features, the pivot search and the divisors' preparation, the mix
# chain, the bias moments' index) every thread computes alike, 1/32; the
# system, the moments and their update and the F chain run over the m =
# 111 channels in 4 slots of 32, 111/128; the elimination's 330 updates
# (and their quotients) in 15 rounds of 32 over the 9 levels, 330/480; the
# back substitution's 45 in 9 rounds, 45/288; the prediction's 10 terms
# in one round, 10/32.  (K5_OPS_BY_SHARE: ops a pixel, share.)
K5_OPS_BY_SHARE = ((288 + 70 + 13 + 4 + 675, 1 / 32), (482 + 5455 + 2220, 111 / 128),
                   (7125 * 330 / 375, 330 / 480), (7125 * 45 / 375, 45 / 288), (295, 10 / 32))
K5_TDIV_SHARES = ((330 / 385, 330 / 480), (45 / 385, 45 / 288), (10 / 385, 10 / 32))
# The chain's dependent path a pixel on one warp, in cycles, counted from
# avp_chain.cuh at ~4 cycles a dependent integer instruction, ~30 a
# shared-memory load, a shuffle or a warp barrier, ~100 an FP64 division:
# an elimination level 780 (the pivot's load and its butterfly of 4
# shuffle rounds 190, the swap and the divisor's load 90, its reciprocal
# 350 (two FP64 divisions, two 128-bit products and the fixes), up to
# three rounds of updates, each three shared loads, a wrapping product, a
# multiply-high quotient and a store, 150) x 9; the last divisor's
# reciprocal 350; the back substitution 9 x (a shuffle, a product and a
# quotient) 90; the prediction 260 (a quotient, 5 shuffle rounds); the
# update 450 (s and its reciprocal 350, the channels 100); the window to
# the unfold 400; the system's stores and the barriers 100.
K5_PATH_CYCLES = 780 * 9 + 350 + 90 * 9 + 260 + 450 + 400 + 100
# K4 per pixel of a lane of p3_decode_kernel<10>, counted as K5's: the AVP
# chain is K5's without the fold (14), its divisions priced by path on the
# walk's own input; the coder's work, from the source: a pixel's fixed work
# K4_PIXEL_OPS (the bins' phase, a 64-bit product 9; adjust_qv's two
# 32-bit divisions by k_step and the select 40, each division ~19 as the
# inline path; the stop layer, its row and k_end 50; the mapper's index
# and select 5); an active unary bin K4_UNARY_OPS (two escalated rows,
# each a 32-bit division 24; the two cells 4; two pair probabilities,
# each a 64-bit unsigned division at the inline path (4096 c1 < 2^32) 19
# plus its shift, sum and clip 6; mix_prob 8; the phase 2; the rANS step
# with its renormalization 19; the count and the loop 4); an active
# refinement or escape bin K4_REFINE_OPS (the bit position and pair 6, the
# pair probability 25, the select 1, the phase 3, the rANS step 19, msb
# and z 4, the loop 2); without sym_cnt the segment's events re-derived
# from z, K4_EVENT_OPS (a unary layer: two escalated rows 48, the go test
# with its division 21, the two adds 10, the loop 3; a refinement bit 11;
# k_end of a pixel 20); a counter pair at a segment's end K4_SWEEP_OPS
# (the delta's two adds, the sum and test, the two halvings).  Loads,
# stores, address and loop arithmetic are the implementation's.
K4_AVP_OPS = K5_OTHER_OPS - 14
K4_PIXEL_OPS = 104
K4_UNARY_OPS = 135
K4_REFINE_OPS = 60
K4_EVENT_OPS = (82, 11, 20)
K4_SWEEP_OPS = 8
# On one warp a lane K4's coder runs on the warp's first thread (share
# 1/32); a symbol's events over the layers' and bits' threads (one round:
# warp instructions a pixel the ops of one layer and one bit, K4_EVENT_OPS
# [0] + [1] + [2]); the segment end's sweep over the pairs, 32 a round.
# Its dependent path adds to K5's K4_BIN_CYCLES an active bin (its two
# counter pairs' shared loads, the probability's division at the inline
# path, the rANS step, a stream word from L2) and K4_SYMBOL_CYCLES a pixel
# (the symbol's shuffle, the mapper's load, the events' ballot and atomics).
K4_BIN_CYCLES = 150
K4_SYMBOL_CYCLES = 300
# K8 (row_scan.cuh under p3_row_scan_kernel): the arithmetic the function
# needs, each value counted once (loads, stores, address and loop
# arithmetic, and what the kernel recomputes, are the implementation's): a
# pixel's fixed work K8_PIXEL_OPS[near] (both: qu / k_step and qv / k_step,
# two 32-bit divisions 21 each, adjust_qv's compare and select 2, the
# mapper's rank 40 (20 compares of 64-bit counts), the kept word 3;
# lossless also: the bias quantization, its 64-bit division at the inline
# path 19 and the rest 16, the correction and the fold 18, the key 2); a
# unary slot K8_UNARY_OPS (two escalated rows from the pixel's quotients,
# each an add, a multiply, a min and the select of esc == 0 4; the two
# cells 4; two pair probabilities, each a division at the inline path 19
# plus its shift, sum and clip 6; mix_prob 8; the go test, the layer's
# quotient as a min and a select and z's shift and compare 4; the bin and
# mask 4); a refinement slot of a symbol that did not escape K8_REFINE_OPS
# (the pair 6, its probability 25, the bit 4, msb 2); any other slot
# K8_PAD_OPS (the bypass, the escape bit 4); the events, with or without
# sym_cnt, their adds alone: a reached unary layer's K8_EVENT_OPS[0], a
# refinement bit's K8_EVENT_OPS[1]; a counter pair at a segment's end
# K8_SWEEP_OPS (the sum, the test, the two halvings); a mapper count swept
# K8_MAP_OPS[0] (the max and the shift), a mapper event K8_MAP_OPS[1] (the
# cell and the add); a bias context swept K8_BIAS_OPS[0], a bias event
# K8_BIAS_OPS[1].
K8_PIXEL_OPS = {False: 142, True: 87}
K8_UNARY_OPS = 78
K8_REFINE_OPS = 37
K8_PAD_OPS = 4
K8_EVENT_OPS = (4, 2)
K8_SWEEP_OPS = 6
K8_MAP_OPS = (3, 6)
K8_BIAS_OPS = (4, 8)
K8_THREADS = 512  # threads a CTA (an image): 16 warps, a pixel a warp or a thread
K8_LANE_THREADS = 256  # the earlier design's CTA, a thread walking lanes t, t + 256, ...
# K3 (bin_fold.cu) a slot: a live one K3_LIVE_OPS (the word 1, the live
# test 2, p1's sign extension and clip 4, the bin 2, f and the offset 3, the
# renormalization test and shift 4, the 32-bit division 19, the remainder
# and the new state 5, the emit flag 2), a masked one K3_MASKED_OPS (the
# word, the live test, the store's value).  On the chain, which skips the
# masked slots, a live step's K3_CHAIN_OPS: the renormalization test and
# shift 2, the multiply-high 1, the 64-bit add and shift 3, the remainder
# and the new state 3; the rest, and every masked slot, is the producers'.
K3_LIVE_OPS = 42
K3_MASKED_OPS = 4
K3_CHAIN_OPS = 9
# K9 (image_tables.cuh's replay under p3_table_replay_kernel), the
# arithmetic the function needs, each value counted once: a mapper event
# K9_MAP_OPS[1] (the cell and the add), a bias event K9_BIAS_OPS[1] (the
# index, the two adds, the cap's test); a key halved K9_MAP_OPS[0] (20
# shifts and maxima), a context halved K9_BIAS_OPS[0]; a changed context's
# quantization K9_QUANT_OPS (its division at the inline path 19 and the
# rest 16), a changed key's order K9_RANK_OPS (20 ranks of 20 compares of
# 64-bit counts, two instructions each).  Its floor, the launch's
# dependent path on its CTA of K9_THREADS threads, in cycles: the three
# barriers K9_BARRIER_CYCLES each; a round of adds (a thread's 64-bit
# atomic in L2 and the dependent mark) K9_ADD_CYCLES; a marked entry's
# halving on its word's thread (a key's 20 counts or a context's two
# moments, loaded and stored) K9_ENTRY_CYCLES; a round of the rewrite's
# (key, y) slots or contexts (a row of loads and the rank or the division)
# K9_ENTRY_CYCLES too.
# The adds are reductions whose result no one reads: a round of adds is
# a thread's plane loads and its reduction's issue, K9_RED_CYCLES; the
# lists a round of mark words' loads, K9_ENTRY_CYCLES; each listed entry's
# sweep and rewrite a round of K9_ENTRY_CYCLES on its thread.  The earlier
# design's floor (returned atomics, K9_ADD_CYCLES; the rewrite's rounds
# over every (key, y) and context) is printed beside.  K9's times in that
# design, as PERF.md §6 records them (NVIDIA H100 80GB HBM3, 700.00 W; on
# the device, queued behind a sleep; two runs issued back to back), by
# lanes an image.
K9_RED_CYCLES = 600
K9_EARLIER = {192: "37.60 us on the device, 38.38 / 37.19 us issued back to back",
              1: "8.89 us on the device, 14.22 / 10.97 us issued back to back"}
K9_MAP_OPS = (60, 6)
K9_BIAS_OPS = (4, 8)
K9_QUANT_OPS = 35
K9_RANK_OPS = 800
K9_THREADS = 512
K9_BARRIER_CYCLES = 50
K9_ADD_CYCLES = 1200
K9_ENTRY_CYCLES = 700
K9_MAIN = {"launches": 0, "last": 0}  # K9's launches on the entry points, and the last call's
# K10 (p3_model_chains.cu), the arithmetic a statistics channel needs at a
# pixel, each value once (model_chain.cuh): B's step (the decay: a 64-bit
# product 3, the add 2, the division by the constant 3 or 5 as a
# multiply-high with its shifts and sign fix 8; the contribution's add 2)
# 15; the contribution (a moment: the product 1, the shift 2, the half
# weight's add 3, the magnitude 3, the domain test 2, the quotient's
# multiply-high 6, the sign 3) 20; F's and E's steps 15 each; E + F and the
# segment test 4: K10_OPS a value.  Its floor, the dependent path: each
# launch in series (the energy's, then the moments'; the mix's after K11);
# on the wavefront a forward and a reverse pass over each band of w + h
# steps (and kChainChunk more at each warp boundary) a wave of its CTAs, on
# the two passes h B steps and 2 w E/F steps a wave of threads (_k10_path);
# K10_STEP_CYCLES a step (the decay's dependent product, multiply-high,
# shift and add, ~12 instructions at ~4 cycles, and the add).
K10_OPS = 69
K10_STEP_CYCLES = 60
# K11 (p3_model_solve.cu), a system's operations, from K5's tally of the
# same solve (K5_OTHER_OPS' parts): the system from the statistics
# 482, the pivot search and the divisors 675, the 375 elimination and
# back-substitution updates 7,125, the prediction 295; their 385 quotients
# by a divisor's reciprocal (udiv64.cuh: the multiply-high 6, the shift and
# the add-path's fix 2, the path test 3) 11 each, and the 10 reciprocals
# (two FP64 divisions and the 128-bit fixes, ~60 each).  Under w_pred the
# prediction becomes the 10 weights' quantization (~40 each) and a pixel's
# int32 dot and reduction K11_WQ_PIXEL_OPS.  Its floor: a system a thread,
# the systems over the threads the card holds at once (the CTAs an SM by
# occupancy), each thread's path its system's operations at one a cycle.
K11_OPS = {False: 482 + 675 + 7125 + 295 + 385 * 11 + 10 * 60,
           True: 482 + 675 + 7125 + 10 * 40 + 385 * 11 + 10 * 60}
K11_WQ_PIXEL_OPS = 20
# K10's and K11's launches on the entry points, and the last call's
MODEL_MAIN = {"chains": 0, "solve": 0, "last": (0, 0)}
P3_FULL_TH = 768  # the full-depth strip height: one corpus image a lane
P3_FULL_ROWS = 192  # rows of the th-768 walk over the corpus's 24 lanes (K4)
NEAR = 2  # the near phase's max error
T_START = time.perf_counter()


def ptxas_summary(report: str, names=("p3_near_row_kernel", "p3_decode_kernel",
                                       "avp_solve_kernel", "p3_row_scan_kernel",
                                       "bin_fold_kernel", "p3_model_solve_kernel",
                                       "chains_kernel", "b_pass_kernel", "ef_pass_kernel",
                                       "weight_kernel")) -> list:
    """One line a kernel instance named in ``names`` from nvcc's ``-Xptxas
    -v`` report: its template arguments, registers, stack frame and spill
    bytes."""
    import re

    lines = []
    for part in report.split("Compiling entry function '")[1:]:
        mangled = part.split("'", 1)[0]
        name = next((n for n in names if n in mangled), None)
        if name is None:
            continue
        args = re.match(r"I((?:L[ib]\d+E)+)E", mangled.split(name, 1)[1])
        targs = [("true" if v == "1" else "false") if k == "b" else v
                 for k, v in re.findall(r"L([ib])(\d+)E", args.group(1))] if args else []
        regs = re.search(r"Used (\d+) registers", part)
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
                          r"spill loads", part)
        lines.append(f"{name}<{', '.join(targs)}>: {regs.group(1) if regs else '?'} registers, "
                     + (f"{frame.group(1)} B stack frame, {frame.group(2)} B spill stores, "
                        f"{frame.group(3)} B spill loads" if frame else "no frame line"))
    return lines


def _warp_chain_check(dev, card) -> bool:
    """K5's warp chain alone (ops/near_walk.py::solve_systems, one warp a
    system) against avp.solve_batch / predict_from_solve on the CPU, at n =
    1..12: ridge systems at the walk's magnitudes, wrapping entries, small
    entries full of pivot ties and zeros, and INT64_MIN / INT64_MAX among
    them; exact."""
    import torch

    from nblic_tpu_torch.ops import avp, near_walk

    rng = np.random.default_rng(15)
    p, same = 128, True
    t0 = time.perf_counter()
    for n in range(1, 13):
        x = rng.integers(-128, 128, size=(n, 40, p)).astype(np.int64)
        ridge = np.concatenate([np.einsum("kip,lip->klp", x, x) << 16,
                                rng.integers(-(1 << 40), 1 << 40, size=(n, 1, p))], 1)
        wrapping = rng.integers(-(1 << 62), 1 << 62, size=(n, n + 1, p), dtype=np.int64)
        ties = rng.integers(-2, 3, size=(n, n + 1, p)).astype(np.int64)
        edges = rng.integers(-50, 50, size=(n, n + 1, p)).astype(np.int64)
        pick = rng.random(edges.shape)
        edges[pick < 0.15] = np.iinfo(np.int64).min
        edges[pick > 0.9] = np.iinfo(np.int64).max
        full = torch.from_numpy(np.concatenate([ridge, wrapping, ties, edges], 2))
        feats = torch.from_numpy(rng.integers(-128, 128, size=(n, 4 * p)).astype(np.int64))
        a, b = full[:, :n], full[:, n]
        diag, num, ok = avp.solve_batch(a.clone(), b.clone(), n)
        want = (diag, num, ok, avp.predict_from_solve(diag, num, feats))
        got = near_walk.solve_systems(a.to(dev), b.to(dev), feats.to(dev))
        same &= all(torch.equal(u.cpu(), v) for u, v in zip(got, want))
    print(f"[K5 chain] the warp chain alone (one warp a system: solve and prediction) on "
          f"{4 * p} systems at each n = 1..12 (ridge, wrapping, ties and zeros, int64 edges): "
          f"equal to avp.solve_batch / predict_from_solve {same} "
          f"({time.perf_counter() - t0:.1f} s) ({card})", flush=True)
    return same


def _cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _queued_ms(fn, reps: int, runs: int) -> float:
    """Median device milliseconds of one of ``runs`` calls of ``fn``, by
    CUDA events, the calls queued behind a ~20 ms sleep kernel so that
    the host's issue of them hides behind it (for launches shorter than
    their issue on the host); ``reps`` runs."""
    import torch

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
    return statistics.median(times)


def _timed(fn):
    """(``fn()``, its milliseconds by CUDA events): one run that both
    compares and times."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least milliseconds, what binds): bytes over the memory rate against
    integer operations over the int32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / INT32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _decode_floor(args) -> float:
    """Least milliseconds of a group decode at the launch's own parallelism:
    a CTA of 32 w warps keeps each of its SM's 4 schedulers issuing w / 4
    warps' th x tw x K2_OPS_PER_PIXEL instructions, one a cycle, and the
    CTAs beyond one per SM come in waves of 132."""
    streams, *_, th, tw, near, g, profile = args
    per_scheduler = -(-g // 128)  # warps on one scheduler
    waves = -(-streams.shape[0] // SMS)
    return 1e3 * waves * per_scheduler * th * tw * _k2_ops(profile, near) / CLOCK_HZ


def _scan_ops(profile: int, stats: bool) -> int:
    return K7_OPS_PER_PIXEL[profile] + (K7_STATS_OPS if stats else 0)


def _scan_bound(x, bias, wcols, profile: int, stats: bool) -> tuple[float, str]:
    """Bound of a feedback scan: the int32 pixels, tables and (profile 2)
    weights read once, two int32 planes (five with the statistics) written
    once; the operations of every lane's pixels."""
    inputs = [x, bias] + ([wcols] if profile == 2 else [])
    n_bytes = sum(t.numel() * t.element_size() for t in inputs)
    n_bytes += x.numel() * 4 * (5 if stats else 2)
    return _bound(n_bytes, x.numel() * _scan_ops(profile, stats))


def _scan_floor(x, profile: int, stats: bool) -> float:
    """Least milliseconds of a feedback scan at the launch's own
    parallelism: CTAs of one warp (32 lanes of one image) spread over the
    SMs' 4 x 132 schedulers, each issuing its warps' th x tw x K7 ops, one
    a cycle."""
    b, t, th, tw = x.shape
    warps = b * -(-t // K7_LANES)
    per_scheduler = -(-warps // (4 * SMS))
    return 1e3 * per_scheduler * th * tw * _scan_ops(profile, stats) / CLOCK_HZ


def _k2_ops(profile: int, near: int) -> int:
    return K2_OPS_PER_PIXEL[profile] + (K2_NEAR_OPS if near else 0)


def _decode_bound(args) -> tuple[float, str]:
    """Bound of a group decode: streams, n_active, tables and (profile 2)
    weights read once, one output byte per lane pixel written once; the
    operations of every active lane's pixels."""
    streams, n_active, bias, hist_n, acc, wcols, th, tw, near, g, profile = args
    inputs = [streams, n_active, bias, hist_n, acc] + ([wcols] if profile == 2 else [])
    n_bytes = sum(t.numel() * t.element_size() for t in inputs)
    n_bytes += streams.shape[0] * g * th * tw
    n_ops = int(n_active.sum()) * th * tw * _k2_ops(profile, near)
    return _bound(n_bytes, n_ops)


def _k2p_beside_k2(parsed, dev, what, card, plain=True):
    """K2' (``decode_groups8``: a table set a group, the groups padded to a
    multiple of 8) against K2 (``decode_groups``: a table set an image, the
    main path's layout) on the same containers, and against the plain
    decoder unless ``plain`` is False; the two kernels timed in turns in one
    call.  Returns None on a mismatch or if a K2' call counted a K2 launch,
    else (max error, K2' ms, plain ms or None, bound)."""
    import torch

    from nblic_tpu_torch.convert import group_args
    from nblic_tpu_torch.ops.decode import decode_groups, decode_groups8, group_decode_plain

    args = group_args(parsed, dev, per_group_tables=True)
    shared = group_args(parsed, dev)
    n = shared[0].shape[0]
    k2_before, k8_before = decode_groups.launches, decode_groups8.launches
    g8 = decode_groups8(*args)
    counted = (decode_groups.launches, decode_groups8.launches) == (k2_before, k8_before + 1)
    k = decode_groups(*shared)
    ref, pms = _timed(lambda: group_decode_plain(*args)) if plain else (k, None)
    same = counted and torch.equal(g8[:n], k) and torch.equal(g8[:ref.shape[0]], ref)
    err = int((g8[:ref.shape[0]].int() - ref.int()).abs().max())
    times = {"K2'": [], "K2": []}
    for _ in range(5):  # in turns
        times["K2'"].append(_timed(lambda: decode_groups8(*args))[1])
        times["K2"].append(_timed(lambda: decode_groups(*shared))[1])
    ms8, ms2 = (statistics.median(times[k_]) for k_ in ("K2'", "K2"))
    bound = _decode_bound(args)
    beside = f" | plain {pms:.3f} ms" if plain else ""
    print(f"{what}: g={args[9]} groups={args[0].shape[0]} ({n} live, one CTA each) exact "
          f"against {'the plain decoder and ' if plain else ''}K2 {same} (a K2' call counts "
          f"no K2 launch: {counted}); K2' {ms8:.3f} ms | K2 {ms2:.3f} ms (its own layout) | "
          f"K2' / K2 {ms8 / ms2:.3f}{beside} | bound {bound[0]:.4f} ms ({bound[1]}), "
          f"{bound[0] / ms8:.1%} of it | floor {_decode_floor(args):.4f} ms ({card})",
          flush=True)
    return (err, ms8, pms, bound) if same else None


def _max_err(a, b) -> int:
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def _k7_case(what, x, bias, wcols, profile, card, plain=None):
    """K7 (``encode_scan``) against its plain version on the same card
    tensors: with the statistics exact on all five planes, without them
    (the final scan's instance) on the two; one plain run, unless ``plain``
    gives its planes (a slice of a batch's).  Times by CUDA-event medians
    of 5: the wrapper with the statistics, and its launch alone (no layout
    copies), beside the bound and floor.  Returns (None on a mismatch, else
    (max error, ms, plain ms or None, bound); the plain planes)."""
    import torch

    from nblic_tpu_torch.ops import near_scan

    t, stats = x.shape[-1], True
    args = (x, bias, wcols, x.shape[2], t, NEAR, profile, stats)
    k = near_scan.encode_scan(*args)
    k_ys = near_scan.encode_scan(*args[:-1], False)
    pms = None
    if plain is None:
        plain, pms = _timed(lambda: near_scan.encode_scan_plain(*args))
    same = all(torch.equal(u, v) for u, v in zip(k, plain))
    same_ys = len(k_ys) == 2 and all(torch.equal(u, v) for u, v in zip(k_ys, plain))
    err = max(int((u - v).abs().max()) for u, v in zip([*k, *k_ys], [*plain, *plain]))
    ms = _cuda_ms(lambda: near_scan.encode_scan(*args), 5)
    xs = x.to(torch.int32).contiguous()  # what the wrapper hands the kernel: x itself
    outs = [torch.empty_like(xs) for _ in range(5)]
    launch_ms = _cuda_ms(lambda: near_scan.launch(xs, bias, wcols, NEAR, profile, outs), 5)
    # on the device alone, queued behind a sleep: the wrapper's device work
    # against the launch's, without the host's issue of either
    dev_ms = _queued_ms(lambda: near_scan.encode_scan(*args), 5, 5)
    dev_launch_ms = _queued_ms(lambda: near_scan.launch(xs, bias, wcols, NEAR, profile, outs),
                               5, 5)
    bound, floor = _scan_bound(x, bias, wcols, profile, stats), _scan_floor(x, profile, stats)
    beside = f"plain {pms:.3f} ms" if pms is not None else "plain: the batch's run"
    earlier = K7_EARLIER.get((x.shape[0] * x.shape[1], t, profile), "not recorded")
    print(f"[K7 near_scan p{profile}] {what}: {x.shape[0] * x.shape[1]} lanes, "
          f"{x.shape[2] * t} steps, near {NEAR}, exact on 5 planes with the statistics "
          f"{same}, on 2 without {same_ys} (max error {err}); kernel {ms:.3f} ms, its "
          f"launch alone {launch_ms:.3f} ms (the wrapper {ms / launch_ms - 1:+.1%} over it; "
          f"on the device, queued behind a sleep: the wrapper {dev_ms:.3f} ms, the launch "
          f"{dev_launch_ms:.3f} ms, {dev_ms / dev_launch_ms - 1:+.1%}) | "
          f"earlier (the copying wrapper's design, PERF.md §6): {earlier} | {beside} | bound "
          f"{bound[0]:.4f} ms ({bound[1]}) | floor {floor:.4f} ms ({card})", flush=True)
    return (err, ms, pms, bound) if same and same_ys else None, plain


def _near_phase(tiled, api, corpus, frame, dev, card):
    """Near-lossless encode (the feedback scan, K7) and K2's near instances.

    Returns None on a failure, else (K1, K2 at effort 1, K2 at effort 2, K7
    launches, K7's numbers at 64x64 tiles over the 18 landscape images):
    the launches over the corpus and frame runs, each counted from 0 just
    before its run."""
    import torch

    from nblic_tpu_torch.convert import group_args
    from nblic_tpu_torch.ops import lsq
    from nblic_tpu_torch.ops.decode import decode_groups, group_decode_plain
    from nblic_tpu_torch.ops.fold import encode_fold
    from nblic_tpu_torch.ops.near_scan import encode_scan
    from nblic_tpu_torch.utils.synth import synth_image

    def zero():
        encode_fold.launches = decode_groups.launches = encode_scan.launches = 0

    def counts():
        return encode_fold.launches, decode_groups.launches, encode_scan.launches

    # ---- the card against the CPU on small inputs
    rng = np.random.default_rng(4)
    for shape, t in (((70, 90), 16), ((96, 104), 8)):
        img = synth_image(rng, *shape)
        for near in (NEAR, 9):
            for effort in (1, 2):
                kw = dict(near=near, tile_h=t, tile_w=t, effort=effort)
                on_card = tiled.encode(img, device=dev, **kw)
                on_cpu = tiled.encode(img, device="cpu", **kw)
                err_card = _max_err(tiled.decode(on_cpu, device=dev), img)
                err_cpu = _max_err(tiled.decode(on_card, device="cpu"), img)
                ok = on_card == on_cpu and max(err_card, err_cpu) <= near
                print(f"[near reference] {shape} tiles {t} near {near} effort {effort}: "
                      f"card == cpu containers {on_card == on_cpu}, max error decoded on "
                      f"the card {err_card}, on the cpu {err_cpu}", flush=True)
                if not ok:
                    return None

    # ---- the corpus at near 2 through the entry points, efforts 1 and 2,
    # all 24 images each (two batches: nothing is transposed at near > 0)
    k1 = k7 = 0
    k2 = {}
    near_conts = {}
    n_px = sum(im.size for im in corpus)
    for effort in (1, 2):
        zero()
        t0 = time.perf_counter()
        conts = tiled.encode_corpus(corpus, near=NEAR, effort=effort, device=dev)
        enc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        decoded = sum(tiled.decode_batches([conts[:18], conts[18:]], device=dev), [])
        dec_s = time.perf_counter() - t0
        n1, n2, n7 = counts()
        k1 += n1
        k7 += n7
        k2[effort] = n2
        near_conts[effort] = conts
        err = max(_max_err(d, im) for d, im in zip(decoded, corpus))
        parsed = [tiled._Parsed(c) for c in conts]
        untransposed = not any(p.hdr.transposed for p in parsed)
        learned = ""
        if effort == 2:
            flags = np.concatenate([p.flags for p in parsed])
            learned = (f", tiles with a learned predictor (flag > 0) "
                       f"{int((flags > 0).sum())}/{flags.size}")
        print(f"[near corpus e{effort}] 24 images near {NEAR}: max error {err}, "
              f"{8.0 * sum(map(len, conts)) / n_px:.4f} bpp{learned}, encode_corpus "
              f"{n_px / enc_s / 1e6:.3f} MPix/s ({enc_s:.2f} s), decode_batches "
              f"{n_px / dec_s / 1e6:.2f} MPix/s, untransposed {untransposed}; launches "
              f"K7 {n7} K1 {n1} K2 {n2} ({card})", flush=True)
        if err > NEAR or not untransposed or min(n1, n2, n7) <= 0:
            return None

    # ---- the frame at near 2, effort 1, through the API
    zero()
    t0 = time.perf_counter()
    frame_c = api.compress_tiled(frame, near=NEAR, effort=1, device=dev)
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    frame_err = _max_err(api.decompress_tiled(frame_c, device=dev), frame)
    dec_s = time.perf_counter() - t0
    n1, n2, n7 = counts()
    k1 += n1
    k2[1] += n2
    k7 += n7
    print(f"[near frame] {frame.shape} near {NEAR} effort 1: max error {frame_err}, "
          f"{8.0 * len(frame_c) / frame.size:.4f} bpp, encode {frame.size / enc_s / 1e6:.2f} "
          f"MPix/s ({enc_s:.2f} s), decode {frame.size / dec_s / 1e6:.2f} MPix/s; launches "
          f"K7 {n7} K1 {n1} K2 {n2} ({card})", flush=True)
    if frame_err > NEAR or min(n1, n2, n7) <= 0:
        return None

    # ---- K7 against its plain version at the main path's 64x64 tiles over
    # the 18 landscape images (one plain run, 4,096 steps) and over the
    # first alone, with the bias tables of their effort-1 containers, and
    # over the 18 at profile 2; then 16x16 tiles over the same images at
    # profiles 1 and 2
    land = [tiled._Parsed(c) for c in near_conts[1][:18]]
    imgs = torch.from_numpy(np.stack(corpus[:18])).to(dev)
    bias = torch.from_numpy(np.stack([p.bias for p in land])).to(dev).to(torch.int32)
    x = tiled.to_tiles(imgs, 64, 64).to(torch.int32)
    k7_main, plain = _k7_case("64x64 tiles, the 18 landscape images", x, bias, None, 1, card)
    if k7_main is None:
        return None
    if _k7_case("64x64 tiles, the first landscape image alone", x[:1], bias[:1], None, 1,
                card, plain=[p[:1] for p in plain])[0] is None:
        return None
    del plain
    _, _, hist = tiled._model_near(x, bias, None, 64, 64, NEAR, 1)
    same = np.array_equal(tiled._norm_tables(hist)[0].cpu().numpy(),
                          np.stack([p.hist_n for p in land]))
    print(f"[near scan] the final scan's histograms (K7, 64x64 tiles) equal the corpus "
          f"containers' {same}", flush=True)
    if not same:
        return None
    def cycled_wcols(tiles):
        """Each tile's fitted weights, its flag cycling through 0/1/2."""
        b, n, th, tw = tiles.shape
        w_q, _ = lsq.fit_tile_weights(tiles.reshape(b * n, th, tw))
        flags = torch.arange(b * n, dtype=torch.int32, device=dev).view(b, n) % 3
        return tiled._lane_wcols(w_q.view(b, n, lsq.N_FEAT), flags)

    if _k7_case("64x64 tiles, the 18 landscape images, flags 0/1/2", x, bias,
                cycled_wcols(x), 2, card)[0] is None:
        return None
    x16 = tiled.to_tiles(imgs, 16, 16).to(torch.int32)
    wcols = cycled_wcols(x16)
    for profile in (1, 2):
        if _k7_case("16x16 tiles, the 18 landscape images" + (", flags 0/1/2" if profile == 2
                                                              else ""),
                    x16, bias, wcols if profile == 2 else None, profile, card)[0] is None:
            return None

    # ---- K2's near instances against the plain decoder; <1, true> beside
    lossless = group_args([tiled._Parsed(c) for c in tiled.encode_batch(corpus[:1],
                                                                         device=dev)], dev)
    ms_lossless = _cuda_ms(lambda: decode_groups(*lossless), 5)
    rng3 = np.random.default_rng(3)
    cases = [(1, near_conts[1][:1], "1x(512, 768) tiles 64x64"),
             (2, tiled._encode_flag_cycle([synth_image(rng3, 512, 768) for _ in range(2)],
                                          64, dev, near=NEAR),
              "2x(512, 768) tiles 64x64 flags 0/1/2"),
             (2, tiled._encode_flag_cycle([synth_image(rng, 128, 256)], 16, dev, near=NEAR),
              "1x(128, 256) tiles 16x16 flags 0/1/2")]
    for profile, conts, what in cases:
        args = group_args([tiled._Parsed(c) for c in conts], dev)
        k = decode_groups(*args)
        p, pms = _timed(lambda: group_decode_plain(*args))  # one plain run
        same = torch.equal(k, p)
        ms = _cuda_ms(lambda: decode_groups(*args), 5)
        bound, floor = _decode_bound(args), _decode_floor(args)
        beside = f" | <1,true> {ms_lossless:.3f} ms" if profile == 1 else ""
        print(f"[K2 group_decode p{profile} near {NEAR}] {what} groups={args[0].shape[0]} "
              f"g={args[9]} exact={same} <{profile},false> {ms:.3f} ms{beside} | plain "
              f"{pms:.3f} ms | bound {bound[0]:.4f} ms ({bound[1]}) | floor {floor:.4f} ms "
              f"({card})", flush=True)
        if not same:
            return None
    return k1, k2[1], k2[2], k7, k7_main


class StageClock:
    """Wraps functions (module, name, label) so that each syncs the card
    when it returns and records the time; the originals come back on exit.
    ``stages()`` gives each stage's ms from the previous mark."""

    def __init__(self, targets):
        self.targets, self.marks = targets, []

    def __enter__(self):
        import torch

        self.saved = [getattr(m, a) for m, a, _ in self.targets]
        for (mod, attr, label), orig in zip(self.targets, self.saved):
            def timed(*args, _orig=orig, _label=label, **kw):
                out = _orig(*args, **kw)
                torch.cuda.synchronize()
                self.marks.append((_label, time.perf_counter()))
                return out
            setattr(mod, attr, timed)
        torch.cuda.synchronize()
        self.marks = [("start", time.perf_counter())]
        return self

    def __exit__(self, *exc):
        for (mod, attr, _), orig in zip(self.targets, self.saved):
            setattr(mod, attr, orig)

    def stages(self) -> dict:
        return {b[0]: 1e3 * (b[1] - a[1]) for a, b in zip(self.marks, self.marks[1:])}


def p3_stage_targets(strips):
    """The strip engine's stages, in order, as StageClock targets."""
    from nblic_tpu_torch.ops import rans, rans_bin

    return [(strips, "_model_planes", "modeling"), (strips, "_row_scan", "row scan"),
            (rans_bin, "fold", "fold"), (strips, "_finalize", "packing and containers")]


def _cpu_decode(groups):
    """The port's plain profile-3 decode on the CPU, one strips.decode_batch
    per group of containers; runs in a process of its own beside the card's
    work."""
    import torch

    torch.set_num_threads(1)
    from nblic_tpu_torch.models import strips

    return [strips.decode_batch(g, device="cpu") for g in groups]


def _cpu_encode(jobs):
    """The port's profile-3 encode on the CPU, one strips.encode_batch per
    (images, th, near, contract name); runs in a process of its own beside
    the card's work."""
    import torch

    torch.set_num_threads(1)
    from nblic_tpu_torch.models import strips

    out = []
    for imgs, th, near, tune in jobs:
        strips.TUNE = getattr(strips, tune)
        out.append(strips.encode_batch(imgs, th=th, near=near, device="cpu"))
    return out


def _p3_pair():
    """The 48x64 and 64x48 images the profile-3 phases code as one batch."""
    from nblic_tpu_torch.utils.synth import synth_image

    rng = np.random.default_rng(5)
    return [synth_image(rng, 48, 64), synth_image(rng, 64, 48)]


PICKS = (0, 23)  # corpus images held against the CPU: transposed landscape, portrait
# the depth cuts of the plain profile-3 walks, whose time is th x w steps:
# the pair's short strip height (its decodes walk 8 x 48 steps), the
# lossless corpus decode's and the near-2 corpus's (4 x 512 each)
P3_PAIR_TH = 8
P3_DECODE_TH = 4
P3_NEAR_TH = 4
P3_TUNES = ("TUNE_V4", "TUNE_MAX", "TUNE_V4S")
P3_K9_ROWS = 4  # rows of the th-768 walk whose K9 launches are held to replay_plain


def _p3_cpu_jobs(corpus):
    """The CPU encodes the card's profile-3 containers are held to, as
    :func:`_cpu_encode` jobs: (lossless, near-lossless).  Lossless: the pair
    under each contract at th P3_PAIR_TH and 64, then the picked corpus
    images at th 64; near: the pair at near 1 and 3 (th P3_PAIR_TH), the
    picks at near 2 (th P3_NEAR_TH), the edge images at near 1 (th 8)."""
    from nblic_tpu_torch.utils.synth import edge_images

    pair, picks = _p3_pair(), [corpus[i] for i in PICKS]
    lossless = [(pair, th, 0, t) for t in P3_TUNES for th in (P3_PAIR_TH, 64)]
    near = [(pair, P3_PAIR_TH, 1, "TUNE_V4"), (pair, P3_PAIR_TH, 3, "TUNE_V4"),
            (picks, P3_NEAR_TH, NEAR, "TUNE_V4"), (edge_images(), 8, 1, "TUNE_V4")]
    return lossless + [(picks, 64, 0, "TUNE_V4")], near


def _p3_fixtures():
    """{name: (container, nblic_tpu's decode)}: the committed profile-3
    containers (near 2, legacy without a Tune block, a legacy static-bias
    table; tests/test_torch_p3_fixtures.py regenerates them with
    nblic_tpu)."""
    import os

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data_torch_p3")
    out = {}
    for name in ("near2", "legacy", "static"):
        with open(os.path.join(data, name + ".nbtc"), "rb") as f:
            out[name] = (f.read(), np.load(os.path.join(data, name + ".npy")))
    return out


def _p3_phase(api, tiled, corpus, dev, card, pool, cpu_job):
    """Profile 3: the card against the CPU (``cpu_job``, a future of the
    lossless :func:`_p3_cpu_jobs`) on small images, the corpus as one batch
    stage by stage (its scan on K8, its fold on K3, each then held exact
    against its plain version on the corpus's own input), the public route;
    then decode: the small containers and the fixtures on the card against
    the image (or nblic_tpu's pixels) and the CPU (a job of ``pool``), the
    corpus at th = P3_DECODE_TH through tiled.decode_batch with the walk's
    time a pixel step, and api.decompress, each decode on K4.  Returns None
    on a failure, else (the corpus's containers at th 64, the pair's
    containers by (contract, th), K4's launches in the decodes, the corpus
    walk's arguments, K8's and K3's launches in the corpus encode, K8's and
    K3's numbers for the kernels line)."""
    import torch

    from nblic_tpu_torch.models import strips
    from nblic_tpu_torch.ops import rans_bin
    from nblic_tpu_torch.ops.decode import decode_groups
    from nblic_tpu_torch.ops.fold import encode_fold
    from nblic_tpu_torch.utils.synth import synth_image

    pair = _p3_pair()
    pair_conts, singles, batch_s = {}, {}, {}
    default = strips.TUNE
    try:
        for tune in P3_TUNES:
            strips.TUNE = getattr(strips, tune)
            for th in (P3_PAIR_TH, 64):
                t0 = time.perf_counter()
                pair_conts[tune, th] = strips.encode_batch(pair, th=th, device=dev)
                batch_s[tune, th] = time.perf_counter() - t0
                # each image alone as well, at the short strip height
                singles[tune, th] = ([strips.encode(im, th=th, device=dev) for im in pair]
                                     if th == P3_PAIR_TH else pair_conts[tune, th])
    finally:
        strips.TUNE = default

    # ---- the corpus at th = 64: one batch of 24 x 12 strips, staged, its
    # scan's and fold's arguments kept for K8's and K3's holds
    th = 64
    n_px = sum(im.size for im in corpus)
    encode_fold.launches = decode_groups.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with Kept(strips, "_row_scan") as scans, Kept(rans_bin, "fold") as folds, \
            Kept(strips, "_model_planes") as models, \
            StageClock(p3_stage_targets(strips)) as clock:
        t0 = time.perf_counter()
        conts, n8, n3 = _entry_codes(lambda: strips.encode_batch(corpus, th=th, device=dev))
        enc_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    stages = clock.stages()
    total = sum(stages.values())
    h, w = max(corpus[0].shape), min(corpus[0].shape)  # portrait-normalized
    lanes = len(corpus) * -(-h // th)
    steps = th * w * (strips.TUNE.n_unary + strips.L_R) // strips.N_PHASE
    print(f"[p3 corpus] {len(corpus)} images ({n_px / 1e6:.2f} MPix) th {th}, {lanes} strip "
          f"lanes, {steps} fold steps: {8.0 * sum(map(len, conts)) / n_px:.4f} bpp, "
          f"strips.encode_batch {n_px / enc_s / 1e6:.4f} MPix/s ({enc_s:.2f} s), peak "
          f"device memory {peak:.2f} GiB; stages ms "
          + ", ".join(f"{k} {v:.1f} ({100 * v / total:.1f}%)" for k, v in stages.items())
          + f"; launches K10 {MODEL_MAIN['last'][0]} K11 {MODEL_MAIN['last'][1]} K8 {n8} K3 "
          f"{n3} K1 {encode_fold.launches} K2 {decode_groups.launches} ({card})", flush=True)
    if not (n8 > 0 and n3 > 0 and min(MODEL_MAIN["last"]) > 0 and len(scans.calls) == 1
            and len(folds.calls) == 1 and len(models.calls) == 1):
        return None
    # K10 and K11 against their plain versions on the corpus's own strips
    model = _model_case(f"the corpus at th {th}", models.calls.pop(), card)
    if model is None:
        return None
    # K8 and K3 against their plain versions on the corpus's own planes and
    # slots (the plain scan and fold run once each here)
    k8 = _k8_case(f"the corpus's scan at th {th}", scans.calls.pop(), False, card)
    k3 = _k3_case(f"the corpus's fold at th {th}", folds.calls.pop(), card)
    if k8[0] is None or k3[0] is None:
        return None
    t0 = time.perf_counter()
    *cpu_pairs, on_cpu = cpu_job.result()
    wait_s = time.perf_counter() - t0
    for (tune, th_), cpu in zip(pair_conts, cpu_pairs):
        ok = pair_conts[tune, th_] == cpu and singles[tune, th_] == cpu
        print(f"[p3 reference] {tune} th {th_}: the 48x64 and 64x48 images as a "
              f"batch{' and alone' if th_ == P3_PAIR_TH else ''}, card == cpu containers {ok} "
              f"(batch on the card {batch_s[tune, th_]:.2f} s)", flush=True)
        if not ok:
            return None
    picks = list(PICKS)
    same = on_cpu == [conts[i] for i in picks]
    print(f"[p3 corpus] images {picks} encoded on the cpu: containers equal {same} (the "
          f"cpu's encodes waited for {wait_s:.1f} s)", flush=True)

    # ---- the public route (a 16x32 image: 512 steps to decode)
    img = synth_image(np.random.default_rng(6), 16, 32)
    via_api = _entry_codes(lambda: api.compress_tiled(img, effort=3, device=dev))[0]
    routed = (via_api == strips.encode(img, device=dev) and via_api[10] == 3
              and min(MODEL_MAIN["last"]) > 0)
    print(f"[p3 api] compress_tiled(effort=3) on a 16x32 image: profile {via_api[10]}, "
          f"{len(via_api)} B, equal to strips.encode {routed}", flush=True)
    if not (same and routed):
        return None

    # ---- decode.  The corpus at th = P3_DECODE_TH (the depth cut: th x 512
    # pixel steps; a 768-row strip is 393,216)
    th_dec = P3_DECODE_TH
    conts_dec = strips.encode_batch(corpus, th=th_dec, device=dev)
    fixtures = _p3_fixtures()
    # the pairs decode on the card at th P3_PAIR_TH under each contract (their
    # th-64 decodes are cut for time; those encodes were held to the CPU's above)
    decoded_pairs = {k: v for k, v in pair_conts.items() if k[1] == P3_PAIR_TH}
    # the CPU's decodes run in a process of their own meanwhile
    cpu_groups = (list(decoded_pairs.values()) + [[c] for c, _ in fixtures.values()]
                  + [[conts_dec[i] for i in picks]])
    cpu_job = pool.submit(_cpu_decode, cpu_groups)
    card_groups = []
    k4 = 0
    for (tune, th_), batch in decoded_pairs.items():
        t0 = time.perf_counter()
        back, n = _entry_decodes(lambda: strips.decode_batch(batch, device=dev))
        dec_s = time.perf_counter() - t0
        k4 += n
        card_groups.append(back)
        ok = all(np.array_equal(b, im) for b, im in zip(back, pair))
        print(f"[p3 decode] {tune} th {th_}: the pair decoded on the card as one batch "
              f"equal to the images {ok} ({dec_s:.2f} s, K4 launches {n})", flush=True)
        if not ok:
            return None
    for name, (c, want) in fixtures.items():
        back, n = _entry_decodes(lambda: strips.decode(c, device=dev))
        k4 += n
        card_groups.append([back])
        ok = np.array_equal(back, want)
        print(f"[p3 decode] fixture {name} ({len(c)} B, near "
              f"{strips._parse(c)[0][6]}): decoded on the card equal to nblic_tpu's "
              f"pixels {ok} (K4 launches {n})", flush=True)
        if not ok:
            return None

    # the corpus walk's input is kept for K4's comparison and timing
    seen, walk = [], strips._decode_walk

    def kept_walk(*args):
        seen.append(args)
        return walk(*args)

    torch.cuda.reset_peak_memory_stats()
    strips._decode_walk = kept_walk
    try:
        with StageClock([(strips, "_decode_walk", "walk")]) as clock:
            t0 = time.perf_counter()
            decoded, n = _entry_decodes(lambda: tiled.decode_batch(conts_dec, device=dev))
            dec_s = time.perf_counter() - t0
    finally:
        strips._decode_walk = walk
    k4 += n
    peak = torch.cuda.max_memory_allocated() / 2**30
    walk_ms = clock.stages()["walk"]
    exact = all(np.array_equal(d, im) for d, im in zip(decoded, corpus))
    n_steps = th_dec * w
    ms_step = walk_ms / n_steps
    lanes_dec = len(corpus) * -(-h // th_dec)
    print(f"[p3 decode corpus] {len(corpus)} images th {th_dec}, {lanes_dec} strip lanes, "
          f"{n_steps} pixel steps: round trip {exact}, "
          f"{8.0 * sum(map(len, conts_dec)) / n_px:.4f} bpp at th {th_dec}, "
          f"tiled.decode_batch {n_px / dec_s / 1e6:.4f} MPix/s ({dec_s:.2f} s), walk "
          f"{walk_ms / 1e3:.2f} s = {ms_step:.3f} ms a pixel step, peak device memory "
          f"{peak:.2f} GiB; one 768x512 image at th 768 ({768 * 512} steps) would take "
          f"{768 * 512 * ms_step / 6e4:.1f} min at this step time; K4 launches {n} (one a "
          f"column segment of {len(seen)} walk) ({card})", flush=True)
    if not (exact and n > 0 and len(seen) == 1):
        return None
    card_groups.append([decoded[i] for i in picks])

    t0 = time.perf_counter()
    back, n = _entry_decodes(lambda: api.decompress(via_api, device=dev))
    k4 += n
    ok = np.array_equal(back, img)
    print(f"[p3 decode api] api.decompress of the 16x32 effort-3 container equal to "
          f"the image {ok} ({time.perf_counter() - t0:.2f} s, K4 launches {n})", flush=True)
    if not ok:
        return None

    t0 = time.perf_counter()
    cpu = cpu_job.result()
    wait_s = time.perf_counter() - t0
    same = all(np.array_equal(a, b) for g_cpu, g_card in zip(cpu, card_groups)
               for a, b in zip(g_cpu, g_card))
    print(f"[p3 decode] the cpu's decodes of the {len(cpu_groups)} groups (the pairs, each "
          f"fixture, corpus images {picks}) equal the card's {same} (waited {wait_s:.1f} s "
          f"for them)", flush=True)
    return (conts, pair_conts, k4, seen[0], (n8, n3), k8, k3, model) if same else None


def _division_paths(walk, n_px: int, bins=None) -> tuple:
    """``walk()``, a plain profile-3 walk over ``n_px`` pixels, with its
    64-bit divisions sorted by the path K5's and K4's code takes for the
    same operands (the SASS's test: both in [0, 2^32) takes the inline
    path): {"u64", "u32", "s64", "s32"}, divisions a pixel by tdiv_by's
    unsigned routine or its inline path, by the moments' signed routine or
    its inline path.  avp.tdiv_by serves the elimination, the back
    substitution and the prediction, pavp.tdiv the moments, one for one
    with the kernels' divisions.  With ``bins`` = (n_unary, l_tot), a
    decode walk's active bins a pixel too: "unary", then "refine" (the
    refinement and escape bits), each bin by its place among its pixel's
    l_tot calls of rans_bin.dec_masked.  Returns the dict and walk()'s
    result."""
    import torch

    from nblic_tpu_torch.ops import avp, pavp, rans_bin

    tdiv_by, tdiv, dec_masked = avp.tdiv_by, pavp.tdiv, rans_bin.dec_masked
    n = [0, 0, 0]
    fast = [0, 0, 0, 0]  # device tensors once counted: no sync until the end

    def counted_tdiv_by(a, b_abs, b_neg):  # the kernels: |a| / |b|, unsigned
        n[0] += a.numel()
        fast[0] += (((torch.abs(a) | b_abs) >> 32) == 0).sum()
        return tdiv_by(a, b_abs, b_neg)

    def counted_tdiv(a, b):  # the kernels: a / b, signed
        n[1] += a.numel()
        fast[1] += (((a | b) >> 32) == 0).sum()
        return tdiv_by(a, torch.abs(b), b < 0)

    def counted_dec_masked(state, ptr, p1, active, words):
        fast[2 + int(n[2] % bins[1] >= bins[0])] += active.sum()
        n[2] += 1
        return dec_masked(state, ptr, p1, active, words)

    avp.tdiv_by, pavp.tdiv = counted_tdiv_by, counted_tdiv
    if bins:
        rans_bin.dec_masked = counted_dec_masked
    try:
        out = walk()
    finally:
        avp.tdiv_by, pavp.tdiv, rans_bin.dec_masked = tdiv_by, tdiv, dec_masked
    u32, s32, unary, refine = (int(v) for v in fast)
    paths = {"u64": (n[0] - u32) / n_px, "u32": u32 / n_px, "s64": (n[1] - s32) / n_px,
             "s32": s32 / n_px}
    if bins:
        paths.update(unary=unary / n_px, refine=refine / n_px)
    return paths, out


def _k5_ops(paths: dict, mix: bool) -> float:
    """K5's operations a pixel: K5_OTHER_OPS (with K5_MIX_OPS under mix_e)
    and the walk's divisions, each priced by its path (``paths`` of
    :func:`_division_paths`)."""
    return (K5_OTHER_OPS + (K5_MIX_OPS if mix else 0) + K5_UDIV64 * paths["u64"]
            + K5_SDIV64 * paths["s64"] + K5_DIV32 * (paths["u32"] + paths["s32"]))


def _k4_ops(paths: dict, con) -> float:
    """K4's operations a pixel under the walk's ``con``
    (decode_walk.Contract): K5's AVP chain without the fold and the walk's
    divisions by path, then the coder's work at the walk's own counts of
    active bins (``paths`` of :func:`_division_paths` with bins) and the
    counter sweep of each segment's end."""
    pairs = 16 * con.n_class + 16 * 5 * 2  # unary and refine counter pairs
    u, r = paths["unary"], paths["refine"]
    ops = (_k5_ops(paths, bool(con.mix_e)) - K5_OTHER_OPS + K4_AVP_OPS + K4_PIXEL_OPS
           + K4_UNARY_OPS * u + K4_REFINE_OPS * r + K4_SWEEP_OPS * pairs / con.ws)
    if not con.sym_cnt:
        ops += K4_EVENT_OPS[0] * u + K4_EVENT_OPS[1] * r + K4_EVENT_OPS[2]
    return ops


def _walk_bound(x, ops: float) -> tuple[float, str]:
    """Bound of a feedback walk over (L, th, W) strips: the uint8 pixels
    read once, five int64 planes written once; ``ops`` a pixel of every
    lane.  (B and F are the walk's own state, neither input nor output.)"""
    return _bound(x.numel() * (1 + 5 * 8), x.numel() * ops)


def _k5_issue(paths: dict, mix: bool) -> float:
    """K5's warp instructions a pixel on one warp a lane: each part of
    K5_OTHER_OPS (with K5_MIX_OPS, all alike, under mix_e) and each
    division by its path (``paths`` of :func:`_division_paths`) over the
    share of the warp's threads that part keeps busy (K5_OPS_BY_SHARE,
    K5_TDIV_SHARES; the moments' divisions at 111/128)."""
    tdiv = K5_UDIV64 * paths["u64"] + K5_DIV32 * paths["u32"]
    moments = K5_SDIV64 * paths["s64"] + K5_DIV32 * paths["s32"]
    return (sum(ops / (32 * share) for ops, share in K5_OPS_BY_SHARE)
            + sum(tdiv * part / (32 * share) for part, share in K5_TDIV_SHARES)
            + moments / (32 * 111 / 128) + (K5_MIX_OPS if mix else 0))


def _k4_issue(paths: dict, con) -> float:
    """K4's warp instructions a pixel on one warp a lane under ``con``:
    K5's chain without the fold (14, every thread alike), the coder's
    fixed work and its active bins on one thread, the events in one round,
    the segment end's sweep 32 pairs a round."""
    pairs = 16 * con.n_class + 16 * 5 * 2
    issue = (_k5_issue(paths, bool(con.mix_e)) - 14 + K4_PIXEL_OPS
             + K4_UNARY_OPS * paths["unary"] + K4_REFINE_OPS * paths["refine"]
             + K4_SWEEP_OPS * pairs / 32 / con.ws)
    return issue + (0 if con.sym_cnt else sum(K4_EVENT_OPS))


def _k4_path(paths: dict) -> float:
    """K4's dependent path a pixel in cycles: K5's and the coder's."""
    return (K5_PATH_CYCLES + K4_BIN_CYCLES * (paths["unary"] + paths["refine"])
            + K4_SYMBOL_CYCLES)


def _walk_floor(lanes: int, steps: int, issue: float, path: float) -> tuple:
    """Least milliseconds of a profile-3 walk (K5, K4) at the launch's own
    parallelism, one warp a lane: the larger of the issue term, each of the
    SMs' 4 x 132 schedulers issuing its share of the warps' ``issue`` warp
    instructions a step, one a cycle, and the chain's dependent ``path``
    cycles a step.  Returns (floor ms, issue ms, path ms)."""
    per_scheduler = -(-lanes // (4 * SMS))
    issue_ms = 1e3 * per_scheduler * steps * issue / CLOCK_HZ
    path_ms = 1e3 * steps * path / CLOCK_HZ
    return max(issue_ms, path_ms), issue_ms, path_ms


def _floor_text(floor: tuple, issue: float, path: float) -> str:
    """A floor of :func:`_walk_floor` with its two terms."""
    return (f"floor {floor[0]:.3f} ms (issue {floor[1]:.3f} ms at {issue:.1f} warp "
            f"instructions a step, path {floor[2]:.3f} ms at {path:.0f} cycles a step)")


def _k5_case(what, x, n_imgs, near, tune, card):
    """K5 (``strips._near_walk`` on a CUDA tensor) against the plain walk
    on the same card tensor, exact on all five planes; each timed by CUDA
    events in one run (the plain walk takes seconds).  The launches made
    here are comparisons, not the main path's.  Returns (max error, or None
    on a mismatch; K5 ms; plain ms)."""
    import torch

    from nblic_tpu_torch.models import strips

    k, ms = _timed(lambda: strips._near_walk(x, n_imgs, near, strips.AVP_N, tune))
    plain, pms = _timed(lambda: strips._near_walk_plain(x, n_imgs, near, strips.AVP_N, tune))
    same = all(torch.equal(u, v) for u, v in zip(k, plain))
    err = max(int((u - v).abs().max()) for u, v in zip(k, plain))
    lanes, th, w = x.shape
    steps = th * w
    print(f"[K5 p3_near_walk] {what}: {lanes} lanes, {steps} steps, near {near}, mix_e "
          f"{tune.mix_e}: exact on 5 planes {same} (max error {err}); K5 {ms:.3f} ms "
          f"({1e3 * ms / steps:.3f} us a step) | plain {pms:.1f} ms ({pms / steps:.3f} ms "
          f"a step) ({card})", flush=True)
    return (err if same else None), ms, pms


def _k8_work(planes, n_imgs: int, tune, k_step: int, near: bool, masks) -> tuple:
    """K8's operations on these planes (L, th, W) at this run's slots
    (``masks`` of the scan): (the lanes' walks; the dependent path of a
    CTA's walk, a segment after another: a pixel's fixed work, a unary
    slot and a refinement slot where a segment holds at most a pixel a
    warp, else the most pixels a thread walks, each its whole work; the
    earlier design's, a lane's chain at the most lanes a thread; the shared
    tables' adds and sweeps a CTA)."""
    from nblic_tpu_torch.models import strips

    n_l, th, w = planes[0].shape
    n_px, n_u = n_l * th * w, tune.n_unary
    n_seg = strips._eff_seg(tune.n_seg, w)
    live = masks.sum(dim=(0, 2, 3)).tolist()  # active slots by layer
    esc = live[n_u + strips.L_R - 1]  # only an escaped symbol masks in the last layer
    reached, bits = sum(live[:n_u]), sum(live[n_u:n_u + 5]) - 5 * esc
    walk = (n_px * (K8_PIXEL_OPS[near] + n_u * K8_UNARY_OPS + 3 * K8_PAD_OPS)
            + (n_px - esc) * 5 * K8_REFINE_OPS + esc * 5 * K8_PAD_OPS
            + reached * K8_EVENT_OPS[0] + bits * K8_EVENT_OPS[1])
    seg_map = bool(tune.seg_map) and n_seg > 1 and not near
    seg_bias = bool(tune.seg_bias) and n_seg > 1 and not near
    pairs = 16 * (256 >> (15 // k_step)) + 160  # unary and refine counter pairs a lane
    tables = (th * n_seg * n_l * pairs * K8_SWEEP_OPS
              + th * (n_seg if seg_map else 1) * n_imgs * 512 * 20 * K8_MAP_OPS[0]
              + n_px * K8_MAP_OPS[1])
    if not near:
        tables += (th * (n_seg if seg_bias else 1) * n_imgs * 3072 * K8_BIAS_OPS[0]
                   + n_px * K8_BIAS_OPS[1])
    lpi = n_l // n_imgs
    tasks = lpi * (w // n_seg)
    if tasks <= K8_THREADS // 32 and not tune.sym_cnt:
        path = th * n_seg * (K8_PIXEL_OPS[near] + K8_UNARY_OPS + K8_REFINE_OPS)
    else:
        path = th * n_seg * -(-tasks // K8_THREADS) * walk / n_px
    chain = -(-lpi // K8_LANE_THREADS) * walk / n_l
    return walk, path, chain, tables / n_imgs


def _k8_bound_floor(planes, n_imgs, tune, k_step, near, got) -> tuple:
    """(bound, floor, the earlier design's floor, text) of K8 on these
    planes and its slot planes ``got``: the bound over the function's
    bytes and operations; the floor the walk's dependent path and the
    tables' work over K8_THREADS threads, one op a cycle; the earlier
    design's (a thread a lane) a lane's chain and the tables over
    K8_LANE_THREADS."""
    walk, path, chain, tables = _k8_work(planes, n_imgs, tune, k_step, near, got[2])
    n_bytes = sum(p.numel() * p.element_size() for p in planes) + sum(
        t.numel() * t.element_size() for t in got)
    bound = _bound(n_bytes, walk + tables * n_imgs)
    floor = max(bound[0], 1e3 * (path + tables / K8_THREADS) / CLOCK_HZ)
    old = max(bound[0], 1e3 * (chain + tables / K8_LANE_THREADS) / CLOCK_HZ)
    th, w = planes[0].shape[1:]
    text = (f"bound {bound[0]:.4f} ms ({bound[1]}) | floor {floor:.3f} ms (the walk's path "
            f"{path / (th * w):.0f} ops a pixel column, one a cycle, and the tables' sweeps "
            f"over {K8_THREADS} threads; a thread a lane {old:.3f} ms, a lane's chain "
            f"{chain / (th * w):.0f} ops a pixel, the sweeps over {K8_LANE_THREADS})")
    return bound, floor, old, text


def _k8_case(what, args, near: bool, card, reps: int = 3):
    """K8 (``strips._row_scan`` / ``_near_code`` on card tensors, the scan's
    arguments ``args``) against its plain version on the same tensors,
    exact on the three slot planes; K8 timed (median of ``reps``) beside
    the plain version's one run, its bound and its floor.  The launches
    made here are comparisons, not the main path's.  Returns (max error, or
    None on a mismatch; K8 ms; plain ms; bound)."""
    import torch

    from nblic_tpu_torch.models import strips

    if near:
        *planes, n_imgs, k_step, tune = args
        kern, plain = strips._near_code, strips._near_code_plain
    else:
        *planes, n_imgs, tune = args
        k_step = strips.K_STEP
        kern, plain = strips._row_scan, strips._row_scan_plain
    got = kern(*args)
    want, pms = _timed(lambda: plain(*args))
    same = all(torch.equal(u, v) for u, v in zip(got, want))
    err = max(int((u.int() - v.int()).abs().max()) for u, v in zip(got, want))
    ms = _cuda_ms(lambda: kern(*args), reps)
    bound, _, _, text = _k8_bound_floor(planes, n_imgs, tune, k_step, near, got)
    n_l, th, w = planes[0].shape
    n_seg = strips._eff_seg(tune.n_seg, w)
    print(f"[K8 p3_row_scan] {what}: {n_imgs} images x {n_l // n_imgs} lanes, {th}x{w}, "
          f"{n_seg} segments a row, {'near coder' if near else 'lossless scan'}, sym_cnt "
          f"{tune.sym_cnt} seg_bias {tune.seg_bias} seg_map {tune.seg_map}: exact on 3 "
          f"slot planes {same} (max error {err}); K8 {ms:.3f} ms (median of {reps}) | plain "
          f"{pms:.1f} ms ({pms / ms:.0f}x) | {text} ({card})", flush=True)
    return (err if same else None), ms, pms, bound


def _model_case(what, args, card, reps: int = 3):
    """The modeling pass on its own input (``args`` of strips._model_planes
    on card tensors): the whole pass on K10 and K11 against the plain
    loops on the card (pavp.predict_plane_loops), each with its time and
    its peak device memory above what it found; then K10 (the model's
    statistics, and the mix chains under mix_e) and K11 against their
    plain versions on the same tensors, exact, each timed (median of
    ``reps``) beside its bound and floor.  The launches made here are
    comparisons, not the main path's.  Returns None on a mismatch, else
    K10's and K11's (max error, ms, plain ms, bound) for the kernels line."""
    import torch

    from nblic_tpu_torch.ops import model_pass as mp
    from nblic_tpu_torch.ops import pavp

    x, n, seg_w, mix, w_quant = args
    shape = tuple(x.shape)
    lanes, h, w = shape
    p = x.numel()
    m = pavp.get_m(n)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    want_px, plain_pass_ms = _timed(lambda: pavp.predict_plane_loops(x, n, seg_w, mix, w_quant))
    plain_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    torch.cuda.reset_peak_memory_stats()
    got_px, pass_ms = _timed(lambda: mp.predict_plane(x, n, seg_w, mix, w_quant))
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    same_pass = torch.equal(got_px, want_px)
    print(f"[p3 model pass] {what}: {lanes} lanes x {h} x {w}, seg_w {seg_w} mix {mix} w_quant "
          f"{w_quant}: the pass on K10 and K11 {pass_ms:.1f} ms, peak {peak:.2f} GiB above "
          f"what it found | the plain loops on the card {plain_pass_ms:.1f} ms "
          f"({plain_pass_ms / pass_ms:.0f}x), peak {plain_peak:.2f} GiB | px0 equal "
          f"{same_pass} ({card})", flush=True)
    del want_px, got_px

    def err(a, b):
        return 0 if torch.equal(a, b) else int((a.long() - b.long()).abs().max())

    fe, px_s = mp.features(x, n)
    form, seg = mp.form_of(w, seg_w, w_quant)
    preds = px_s.reshape(1, -1)
    stats = mp.chains(fe, preds, shape, n, seg_w, w_quant)
    want, pms10 = _timed(lambda: mp.chains_plain(fe, preds, shape, n, seg_w, w_quant))
    err10 = err(stats, want)
    del want
    ms10 = _cuda_ms(lambda: mp.chains(fe, preds, shape, n, seg_w, w_quant), reps)
    rows = stats.shape[0]
    rows_seg = seg if form == mp.HOLD else 1
    got11 = mp.solve(stats, fe, px_s.reshape(-1), n, rows_seg, w_quant)
    want11, pms11 = _timed(lambda: mp.solve_plain(stats, fe, px_s.reshape(-1), n, rows_seg,
                                                  w_quant))
    err11 = max(err(a, b) for a, b in zip(got11, want11))
    failed = int((~want11[1]).sum())
    del want11
    ms11 = _cuda_ms(lambda: mp.solve(stats, fe, px_s.reshape(-1), n, rows_seg, w_quant), reps)
    del stats
    design = mp.chain_design(lanes, h, m - 1, SMS)
    blocks = [(0, m - 1)] if design == mp.WAVE else mp._moment_blocks(n, p)
    launches = [(mp.ENERGY, mp.TWO_PASS, 1)] + [(mp.MOMENTS, design, kk) for _, kk in blocks]
    n_bytes = rows * m * 8 + p * (n + 2) * 4
    n_ops = p * m * K10_OPS
    ms_mix = pms_mix = 0.0
    if mix:
        mix_preds = torch.stack([got11[0], px_s.reshape(-1)])
        got_m = mp.chains(fe, mix_preds, shape, n)
        want_m, pms_mix = _timed(lambda: mp.chains_plain(fe, mix_preds, shape, n))
        err10 = max(err10, err(got_m, want_m))
        ms_mix = _cuda_ms(lambda: mp.chains(fe, mix_preds, shape, n), reps)
        n_bytes += p * 2 * 8 + p * (n + 3) * 4
        n_ops += p * 2 * K10_OPS
        launches.append((mp.MIX, mp.TWO_PASS, 2))
    steps, path = _k10_path(launches, shape)
    bound10 = _bound(n_bytes, n_ops)
    floor10 = max(bound10[0], 1e3 * steps * K10_STEP_CYCLES / CLOCK_HZ)
    print(f"[K10 p3_model_chains] {what}: {lanes} lanes x {h} x {w}, {m} channels, form "
          f"{('plain', 'freeze', 'hold')[form]}, {rows} statistics rows; {1 + len(blocks)} "
          f"launches (energy, then the moments "
          f"{'on the wavefront' if design == mp.WAVE else 'in two passes'})"
          f"{' + 1 mix' if mix else ''}: exact "
          f"{err10 == 0} (max error {err10}); K10 {ms10 + ms_mix:.3f} ms (median of {reps}; "
          f"statistics {ms10:.3f}, mix {ms_mix:.3f}) | plain {pms10 + pms_mix:.1f} ms "
          f"({(pms10 + pms_mix) / (ms10 + ms_mix):.0f}x) | bound {bound10[0]:.4f} ms "
          f"({bound10[1]}: {n_bytes / 1e9:.3f} GB written and read once, {K10_OPS} ops a "
          f"channel and pixel) | floor {floor10:.4f} ms (the dependent path: {steps} chain "
          f"steps in series, {K10_STEP_CYCLES} cycles each; {path}) | launches on "
          f"the entry point {MODEL_MAIN['last'][0]} ({card})", flush=True)
    n_bytes11 = rows * m * 8 + p * (n + 2) * 4 + p * 5
    n_ops11 = rows * K11_OPS[w_quant] + (p * K11_WQ_PIXEL_OPS if w_quant else 0)
    bound11 = _bound(n_bytes11, n_ops11)
    from nblic_tpu_torch import kernels

    per_sm = kernels.library().nbt_p3_model_solve_per_sm(n, int(w_quant))
    resident = max(per_sm, 1) * 32 * SMS
    floor11 = max(bound11[0], 1e3 * -(-rows // resident) * K11_OPS[w_quant] / CLOCK_HZ)
    print(f"[K11 p3_model_solve] {what}: {rows} systems of n = {n}, {p} pixels "
          f"({'w_pred, ' if w_quant else ''}{failed} failed pivots): exact {err11 == 0} (max "
          f"error {err11}); K11 {ms11:.3f} ms (median of {reps}) | plain {pms11:.1f} ms "
          f"({pms11 / ms11:.0f}x) | bound {bound11[0]:.4f} ms ({bound11[1]}: "
          f"{K11_OPS[w_quant]} ops a system) | floor {floor11:.4f} ms (a system a thread: the "
          f"systems over {resident} resident threads ({per_sm} one-warp CTAs an SM), "
          f"{K11_OPS[w_quant]} cycles of path each) | launches on the entry point "
          f"{MODEL_MAIN['last'][1]} ({card})", flush=True)
    if not (same_pass and err10 == 0 and err11 == 0):
        return None
    return ((err10, ms10 + ms_mix, pms10 + pms_mix, bound10),
            (err11, ms11, pms11, bound11))


def _k10_path(launches, shape) -> tuple:
    """(steps, text) of K10's dependent path over ``launches`` ((kind,
    design, channels) each, in series) of (S, H, W) strips.  The wavefront:
    each launch's waves of CTAs one after another, each wave a forward and
    a reverse pass over every band (model_chain.cuh's chain_steps).  The
    two passes: a thread a chain, the B pass h steps, the E/F
    pass 2 w, each in waves of the 2,048 threads an SM holds."""
    import ctypes

    from nblic_tpu_torch import kernels

    s, h, w = shape
    steps, parts = 0, []
    for kind, design, k in launches:
        if design == 0:
            waves = [-(-threads // (2048 * SMS)) for threads in (s * w * k, s * h * k)]
            steps += waves[0] * h + waves[1] * 2 * w
            parts.append(f"{('energy', 'moments', 'mix')[kind]} two passes: {waves[0]} waves x "
                         f"{h} B steps, {waves[1]} x {2 * w} E/F steps")
            continue
        out = (ctypes.c_int * 5)()
        kernels.check(kernels.library().nbt_p3_model_chains_plan(h, w, out),
                      "p3_model_chains_plan")
        warps, band, bands, full, per_sm = list(out)
        ctas = s * -(-k // 32)
        waves = -(-ctas // (max(per_sm, 1) * SMS))
        last = h - (bands - 1) * band  # the last band's rows, their lag (chain_lag)
        lag = last - 1 + (last - 1) // (band // warps) * 4
        per_pass = (bands - 1) * full + -(-(w + lag) // 4) * 4
        steps += waves * 2 * per_pass
        parts.append(f"{('energy', 'moments', 'mix')[kind]} {ctas} CTAs of {warps} warps, "
                     f"{per_sm} an SM, {waves} waves x 2 passes x {per_pass} steps")
    return steps, "; ".join(parts)


def _k3_bound_floor(args) -> tuple:
    """(bound, floor, the earlier design's floor, text, live slots, the
    longest chain's) of K3 on its arguments: the bound over the fold's
    bytes and operations; the floor the longest chain's live steps on the
    chain, K3_CHAIN_OPS each, one op a cycle; the earlier design's every
    slot of it on the chain."""
    p1, bins, mask = args
    s, n = p1.shape
    live = mask.sum(1)
    n_live, longest = int(live.sum()), int(live.max())
    ops = n_live * K3_LIVE_OPS + (s * n - n_live) * K3_MASKED_OPS
    n_bytes = sum(t.numel() * t.element_size() for t in args) + s * n * (4 + 1) + s * 8
    bound = _bound(n_bytes, ops)
    floor = max(bound[0], 1e3 * longest * K3_CHAIN_OPS / CLOCK_HZ)
    old = max(bound[0], 1e3 * (longest * K3_LIVE_OPS + (n - longest) * K3_MASKED_OPS)
              / CLOCK_HZ)
    text = (f"bound {bound[0]:.4f} ms ({bound[1]}) | floor {floor:.3f} ms (the longest "
            f"chain's live steps, {K3_CHAIN_OPS} ops each, one a cycle; with every slot on "
            f"the chain {old:.3f} ms)")
    return bound, floor, old, text, n_live, longest


def _k3_case(what, args, card, reps: int = 3):
    """K3 (``rans_bin.fold`` on card tensors, the fold's arguments
    ``args``) against :func:`rans_bin.fold_plain` on the same tensors,
    exact on every word, emit and state; K3 timed (median of ``reps``)
    beside the plain fold's one run, its bound and its floor.  Returns
    (max error, or None on a mismatch; K3 ms; plain ms; bound)."""
    import torch

    from nblic_tpu_torch.ops import rans_bin

    p1, bins, mask = args
    got = rans_bin.fold(*args)
    want, pms = _timed(lambda: rans_bin.fold_plain(*args))
    same = all(torch.equal(u, v) for u, v in zip(got, want))
    err = max(int((u.long() - v.long()).abs().max()) for u, v in zip(got, want))
    ms = _cuda_ms(lambda: rans_bin.fold(*args), reps)
    s, n = p1.shape
    bound, _, _, text, n_live, longest = _k3_bound_floor(args)
    print(f"[K3 bin_fold] {what}: {s} states x {n} slots, {n_live} live ({longest} on the "
          f"longest chain), {int(got[1].sum())} words emitted: exact {same} (max error "
          f"{err}); K3 {ms:.3f} ms (median of {reps}; {1e6 * ms / longest:.1f} ns a live "
          f"step of the longest chain) | plain {pms:.1f} ms ({pms / ms:.0f}x) | {text} "
          f"({card})", flush=True)
    return (err if same else None), ms, pms, bound


def _entry_codes(fn):
    """``fn()`` with K8's, K3's, K10's and K11's counts set to 0 just before
    and read just after: (its result, K8's launches, K3's); K10's and
    K11's go to MODEL_MAIN (and its "last")."""
    from nblic_tpu_torch.ops import model_pass, rans_bin, row_scan

    row_scan.scan.launches = rans_bin.fold_card.launches = 0
    model_pass.chains.launches = model_pass.solve.launches = 0
    out = fn()
    MODEL_MAIN["chains"] += model_pass.chains.launches
    MODEL_MAIN["solve"] += model_pass.solve.launches
    MODEL_MAIN["last"] = (model_pass.chains.launches, model_pass.solve.launches)
    return out, row_scan.scan.launches, rans_bin.fold_card.launches


class Kept:
    """Wraps ``module.name`` so that every call's arguments are kept in
    ``calls``; the original comes back on exit."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        self.orig = fn = getattr(self.module, self.name)

        def kept(*args):
            self.calls.append(args)
            return fn(*args)

        setattr(self.module, self.name, kept)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def _k9_count(n: int) -> None:
    """Add K9's launches of an entry-point run (read just after it) to
    K9_MAIN; raise unless K9 followed each of the walk kernel's ``n``."""
    from nblic_tpu_torch.ops import table_replay

    n9 = table_replay.launch.launches
    if n9 != n:
        raise RuntimeError(f"K9 launched {n9} times beside the walk kernel's {n}")
    K9_MAIN["launches"] += n9
    K9_MAIN["last"] = n9


def _entry_walks(fn):
    """``fn()`` with K5's and K9's counts set to 0 just before and read
    just after: (its result, K5's launches); K9's go to K9_MAIN."""
    from nblic_tpu_torch.ops import near_walk, table_replay

    near_walk.launch_row.launches = table_replay.launch.launches = 0
    out = fn()
    _k9_count(near_walk.launch_row.launches)
    return out, near_walk.launch_row.launches


def _entry_decodes(fn):
    """``fn()`` with K4's and K9's counts set to 0 just before and read
    just after: (its result, K4's launches); K9's go to K9_MAIN."""
    from nblic_tpu_torch.ops import decode_walk, table_replay

    decode_walk.launch_segment.launches = table_replay.launch.launches = 0
    out = fn()
    _k9_count(decode_walk.launch_segment.launches)
    return out, decode_walk.launch_segment.launches


def _p3_near_phase(tiled, corpus, dev, card, cpu_job):
    """Profile-3 near-lossless encode, its walk on K5: the committed
    fixture's bytes, the pair at near 1 and 3 against the CPU (``cpu_job``,
    a future of the near-lossless :func:`_p3_cpu_jobs`) and decoded on the
    card, the edge images against the CPU, the corpus at near 2 through
    tiled.encode_corpus at th = P3_NEAR_TH stage by stage, then its decode
    on the card through tiled.decode_batch; K5 against the plain walk on
    the pair (near 1 and 3, both near contracts), the edge images and the
    corpus's walk, K8's near mode against the plain row coder on the
    corpus's planes, and the corpus's walk at th 768, timed.  Returns None
    on a failure, else (K5's launches in the entry-point runs, K5's numbers
    on the corpus for the kernels line, K4's launches in the decodes, K8's
    and K3's launches in the corpus encode, K8's numbers on its planes)."""
    import torch

    from nblic_tpu_torch.models import strips
    from nblic_tpu_torch.ops import rans_bin
    from nblic_tpu_torch.ops.decode import decode_groups
    from nblic_tpu_torch.ops.fold import encode_fold
    from nblic_tpu_torch.utils.synth import edge_images, synth_image

    contracts = {name: strips._near_tune(getattr(strips, name))
                 for name in ("TUNE_V4", "TUNE_V4S")}
    launches, errs, k4 = 0, [], 0

    # ---- (a) nblic_tpu's bytes without JAX: the committed near-2 fixture
    # (tests/test_torch_p3_fixtures.py: fixture_image(), th 16)
    img = synth_image(np.random.default_rng(71), 40, 24)
    want = _p3_fixtures()["near2"][0]
    t0 = time.perf_counter()
    got, n = _entry_walks(lambda: strips.encode(img, th=16, near=NEAR, device=dev))
    launches += n
    ok = got == want
    print(f"[p3 near fixture] strips.encode of the fixture image (40x24, th 16, near "
          f"{NEAR}) on the card equal to nblic_tpu's committed bytes {ok} "
          f"({time.perf_counter() - t0:.2f} s, K5 launches {n})", flush=True)
    if not ok:
        return None

    # ---- (b) the pair as one batch at near 1 and 3, against the CPU's, and
    # K5 against the plain walk on its strips under both near contracts
    pair = _p3_pair()
    t0 = time.perf_counter()
    cpu = cpu_job.result()
    wait_s = time.perf_counter() - t0
    for k, near in enumerate((1, 3)):
        t0 = time.perf_counter()
        on_card, n = _entry_walks(
            lambda: strips.encode_batch(pair, th=P3_PAIR_TH, near=near, device=dev))
        launches += n
        enc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, n4 = _entry_decodes(lambda: strips.decode_batch(on_card, device=dev))
        k4 += n4
        dec_s = time.perf_counter() - t0
        err = max(_max_err(b, im) for b, im in zip(back, pair))
        ok = on_card == cpu[k] and 0 < err <= near
        print(f"[p3 near reference] near {near} th {P3_PAIR_TH}: the 48x64 and 64x48 "
              f"images as a batch, card == cpu containers {on_card == cpu[k]} (the cpu's encodes "
              f"waited for {wait_s:.1f} s), max error decoded on the card {err} (encode "
              f"{enc_s:.2f} s, K5 launches {n}; decode {dec_s:.2f} s, K4 launches {n4})",
              flush=True)
        if not ok:
            return None
        st, *_ = strips._prepare(pair, P3_PAIR_TH)
        x = torch.from_numpy(st).reshape(-1, *st.shape[2:]).to(dev)
        for name, tune in contracts.items():
            errs.append(_k5_case(f"the pair at th {P3_PAIR_TH}, {name}'s near contract",
                                 x, len(pair), near, tune, card)[0])

    # ---- the edge images (a checkerboard, a saturated ramp, a constant
    # image, 1-pixel stripes) at th 8, near 1: the container against the
    # CPU's, K5 against the plain walk under both contracts
    edges = edge_images()
    on_card, n = _entry_walks(lambda: strips.encode_batch(edges, th=8, near=1, device=dev))
    launches += n
    print(f"[p3 near edges] {len(edges)} edge images {edges[0].shape} th 8 near 1: card == "
          f"cpu containers {on_card == cpu[3]} (K5 launches {n})", flush=True)
    if on_card != cpu[3]:
        return None
    st, *_ = strips._prepare(edges, 8)
    x = torch.from_numpy(st).reshape(-1, *st.shape[2:]).to(dev)
    for name, tune in contracts.items():
        errs.append(_k5_case(f"the edge images at th 8, {name}'s near contract", x,
                             len(edges), 1, tune, card)[0])
    if any(e is None for e in errs):
        return None

    # ---- (c) the corpus at near 2 through the entry point, strip height
    # P3_NEAR_TH (the depth cut: th x 512 walk steps against 393,216 at
    # 768); the walk's input is kept for the comparison
    th = P3_NEAR_TH
    n_px = sum(im.size for im in corpus)
    h, w = max(corpus[0].shape), min(corpus[0].shape)  # portrait-normalized
    lanes = len(corpus) * -(-h // th)
    n_steps = th * w
    saved, walk = strips.TH_DEFAULT, strips._near_walk
    seen = []

    def kept_walk(*args):
        seen.append(args)
        return walk(*args)

    strips.TH_DEFAULT, strips._near_walk = th, kept_walk
    encode_fold.launches = decode_groups.launches = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        with Kept(strips, "_near_code") as codes, \
                StageClock([(strips, "_near_walk", "walk"), (strips, "_near_code", "row coder"),
                            (rans_bin, "fold", "fold"),
                            (strips, "_finalize", "packing and containers")]) as clock:
            t0 = time.perf_counter()
            (conts, n), n8, n3 = _entry_codes(lambda: _entry_walks(
                lambda: tiled.encode_corpus(corpus, near=NEAR, effort=3, device=dev)))
            enc_s = time.perf_counter() - t0
    finally:
        strips.TH_DEFAULT, strips._near_walk = saved, walk
    launches += n
    peak = torch.cuda.max_memory_allocated() / 2**30
    st = clock.stages()
    total = sum(st.values())
    tune = strips._near_tune(strips.TUNE)
    fold_steps = n_steps * (tune.n_unary + strips.L_R) // strips.N_PHASE
    hdrs = [tiled.NbtcHeader.from_bytes(c) for c in conts]
    form = all((hd.profile, hd.near, hd.tile_h) == (3, NEAR, th) for hd in hdrs)
    print(f"[p3 near corpus] {len(corpus)} images ({n_px / 1e6:.2f} MPix) near {NEAR} th "
          f"{th}, {lanes} strip lanes, {n_steps} pixel steps: "
          f"{8.0 * sum(map(len, conts)) / n_px:.4f} bpp, tiled.encode_corpus "
          f"{n_px / enc_s / 1e6:.4f} MPix/s ({enc_s:.2f} s), peak device memory {peak:.2f} "
          f"GiB; stages ms " + ", ".join(f"{k} {v:.1f} ({100 * v / total:.1f}%)"
                                         for k, v in st.items())
          + f"; walk {1e3 * st['walk'] / n_steps:.2f} us a pixel step, row coder "
          f"{st['row coder'] / th:.1f} ms a row ({strips._eff_seg(tune.n_seg, w)} segments), "
          f"fold {1e3 * st['fold'] / fold_steps:.1f} us a step ({fold_steps} steps); profile "
          f"3, near {NEAR}, th {th} in every header {form}; launches K5 {n} (one a row of "
          f"{len(seen)} walk), K8 {n8}, K3 {n3}, K1 {encode_fold.launches} K2 "
          f"{decode_groups.launches} ({card})", flush=True)
    same = cpu[2] == [conts[i] for i in PICKS]
    print(f"[p3 near corpus] images {list(PICKS)} encoded on the cpu: containers equal "
          f"{same}", flush=True)
    if not (form and same and n > 0 and len(seen) == 1 and n8 > 0 and n3 > 0
            and len(codes.calls) == 1):
        return None
    # K8's near mode against the plain row coder on the corpus's own planes
    k8 = _k8_case(f"the near-{NEAR} corpus's row coder at th {th}", codes.calls.pop(), True,
                  card)
    if k8[0] is None:
        return None

    # K5 against the plain walk on the corpus walk's own input (the plain
    # walk runs once here), then K5 alone, timed
    x, n_imgs, near, n_feat, tune_w = seen.pop()
    err, _, pms = _k5_case(f"the corpus's walk at th {th}", x, n_imgs, near, tune_w, card)
    if err is None or n_feat != strips.AVP_N:
        return None
    errs.append(err)
    ms = _cuda_ms(lambda: strips._near_walk(x, n_imgs, near, n_feat, tune_w), 3)
    t0 = time.perf_counter()
    paths, _ = _division_paths(
        lambda: strips._near_walk_plain(x, n_imgs, near, strips.AVP_N, tune_w), x.numel())
    ops = _k5_ops(paths, bool(tune_w.mix_e))
    issue = _k5_issue(paths, bool(tune_w.mix_e))
    bound, floor = _walk_bound(x, ops), _walk_floor(x.shape[0], th * w, issue, K5_PATH_CYCLES)
    print(f"[K5 p3_near_walk] the corpus's walk ({x.shape[0]} lanes x {th}x{w}): K5 {ms:.3f} ms "
          f"(median of 3; {1e3 * ms / n_steps:.3f} us a step) | plain {pms:.1f} ms "
          f"({pms / ms:.0f}x) | bound {bound[0]:.4f} ms ({bound[1]}) | "
          f"{_floor_text(floor, issue, K5_PATH_CYCLES)} ({ops:.1f} ops a pixel; divisions a "
          f"pixel by path, counted on a plain walk of the same input in "
          f"{time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{k} {v:.3f}" for k, v in paths.items()) + f") ({card})", flush=True)
    del x

    # the corpus's walk at th 768 (24 lanes, one an image: the default
    # strip height's own parallelism), timed, not compared (a plain walk
    # there takes about an hour)
    st768, *_ = strips._prepare(corpus, strips.TH_DEFAULT)
    x768 = torch.from_numpy(st768).reshape(-1, *st768.shape[2:]).to(dev)
    lanes768, steps768 = x768.shape[0], x768.shape[1] * x768.shape[2]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    strips._near_walk(x768, lanes768, NEAR, strips.AVP_N, tune)
    torch.cuda.synchronize()
    s768 = time.perf_counter() - t0
    floor768 = _walk_floor(lanes768, steps768, issue, K5_PATH_CYCLES)
    rest = (768 * st["row coder"] / th + 768 * st["fold"] / th) / 1e3
    print(f"[K5 p3_near_walk] the corpus at th {x768.shape[1]} ({lanes768} lanes, one an image, "
          f"{steps768} steps): the walk took {s768:.2f} s ({1e6 * s768 / steps768:.2f} us a "
          f"step; {_floor_text(floor768, issue, K5_PATH_CYCLES)} at the th-{th} walk's ops a "
          f"pixel); with the row coder and the fold at the th-{th} corpus's times a row "
          f"({rest:.1f} s projected) the corpus's encode would take {s768 + rest:.1f} s "
          f"({card})", flush=True)
    del x768

    torch.cuda.reset_peak_memory_stats()
    with StageClock([(strips, "_decode_walk", "walk")]) as clock:
        t0 = time.perf_counter()
        decoded, n4 = _entry_decodes(lambda: tiled.decode_batch(conts, device=dev))
        dec_s = time.perf_counter() - t0
    k4 += n4
    peak = torch.cuda.max_memory_allocated() / 2**30
    walk_ms = clock.stages()["walk"]
    err = max(_max_err(d, im) for d, im in zip(decoded, corpus))
    print(f"[p3 near decode corpus] {len(corpus)} images near {NEAR} th {th}: max error "
          f"{err}, tiled.decode_batch {n_px / dec_s / 1e6:.4f} MPix/s ({dec_s:.2f} s), walk "
          f"{walk_ms / 1e3:.2f} s = {walk_ms / n_steps:.3f} ms a pixel step, peak device "
          f"memory {peak:.2f} GiB, K4 launches {n4} ({card})", flush=True)
    if not (0 < err <= NEAR and n4 > 0):
        return None
    return launches, (max(errs), ms, pms, bound), k4, (n8, n3), k8


def _k9_work(kept) -> tuple:
    """((bytes, operations) bound, floor ms, the earlier design's floor ms) of one K9
    launch on ``kept`` (the tables it found, its planes, contract and
    columns), counted from this launch's data: each plane value of its
    columns read once, each entry it changes written once (a touched or
    halved context's moments and its int16 value, a touched key's counts
    and a changed key's order row); the floors the launch's dependent path
    on this design's CTAs of K9_THREADS threads and on the earlier one's."""
    import torch

    from nblic_tpu_torch.ops import coder3

    tb, (idx, dx, key, y), con, map_cols, bias_cols = kept
    lanes = idx.shape[1]
    n_imgs = lanes // con.lanes_per_image

    def bits(words):
        return int(sum(bin(v & 0xFFFFFFFF).count("1") for v in words.reshape(-1).tolist()))

    n_bytes = n_ops = 0
    per_image = rounds = 0
    entries = 0  # rounds of the entries the sweep visits
    if bias_cols is not None:
        cols = slice(*bias_cols)
        px = idx[cols].numel()
        halved = (torch.tensor([(v >> b) & 1 for v in tb.bmark.reshape(-1).tolist()
                                for b in range(32)], device=idx.device).bool())
        changed = halved.clone()
        changed[idx[cols].reshape(-1)] = True
        n_ctx, n_halved = int(changed.sum()), int(halved.sum())
        n_bytes += 16 * px + 18 * n_ctx
        n_ops += K9_BIAS_OPS[1] * px + K9_BIAS_OPS[0] * n_halved + K9_QUANT_OPS * n_ctx
        per_image = max(per_image, px // n_imgs)
        rounds += -(-n_ctx // (n_imgs * K9_THREADS))
        entries += -(-n_ctx // (n_imgs * K9_THREADS))
    if map_cols is not None:
        cols = slice(*map_cols)
        px = key[cols].numel()
        img = torch.arange(lanes, device=key.device) // con.lanes_per_image
        small = y[cols] < coder3.N_MAP
        cell = ((img * coder3.MAP_KEYS + key[cols]) * coder3.N_MAP + y[cols])[small]
        touched = torch.zeros(n_imgs * coder3.MAP_KEYS, dtype=torch.bool, device=key.device)
        touched[cell // coder3.N_MAP] = True
        n_halved = bits(tb.mmark)
        n_keys = int(touched.sum()) + n_halved  # at most: a key both touched and halved
        n_bytes += 16 * px + 8 * int(cell.unique().numel()) + 160 * (n_keys + n_halved)
        n_ops += K9_MAP_OPS[1] * int(small.sum()) + K9_MAP_OPS[0] * n_halved \
            + K9_RANK_OPS * n_keys
        per_image = max(per_image, px // n_imgs)
        rounds += -(-n_keys * coder3.N_MAP // (n_imgs * K9_THREADS))
        entries += -(-n_keys // (n_imgs * K9_THREADS))
    bound = _bound(n_bytes, n_ops)
    cycles = (3 * K9_BARRIER_CYCLES + -(-per_image // K9_THREADS) * K9_RED_CYCLES
              + K9_ENTRY_CYCLES * (1 + entries))
    before = (3 * K9_BARRIER_CYCLES + -(-per_image // K9_THREADS) * K9_ADD_CYCLES
              + K9_ENTRY_CYCLES * (1 + rounds))
    return bound, max(bound[0], 1e3 * cycles / CLOCK_HZ), max(bound[0], 1e3 * before / CLOCK_HZ)


def _k9_case(what, args, card, runs: int = 50, reps: int = 5):
    """K9 against replay_plain on every launch of the decode walk of
    ``args`` on the card (each on a copy of the tables it found, every
    table exact), then the walk's middle launch's inputs timed: K9 alone
    (``runs`` successive launches on a copy of its tables, median of
    ``reps``, a launch's share: on the device, queued behind a sleep, and
    as the host issues them back to back) beside replay_plain's time on
    the same, its bound and its floor.  The launches made here are comparisons, not
    the main path's.  Returns (max error or None on a mismatch, K9 ms,
    plain ms, bound)."""
    import torch

    from nblic_tpu_torch.models import strips
    from nblic_tpu_torch.ops import table_replay

    words, bias, th, w, s, n_imgs, n_feat, near, tune = args
    n_seg = strips._eff_seg(tune.n_seg, w)
    per_row = n_seg if n_seg > 1 and ((tune.seg_bias and bias is None) or tune.seg_map) else 1
    middle = th * per_row // 2
    launch, kept, errs = table_replay.launch, [], []

    def checked(walk, map_cols=None, bias_cols=None):
        want = table_replay.Tables(*(t.clone() for t in walk.tables))
        if len(errs) == middle:
            kept.append((table_replay.Tables(*(t.clone() for t in walk.tables)),
                         tuple(None if p is None else p.clone() for p in walk.planes),
                         walk.con, map_cols, bias_cols))
        table_replay.replay_plain(want, walk.planes, walk.con, map_cols, bias_cols)
        launch(walk, map_cols, bias_cols)
        errs.append(max(int((g.long() - v.long()).abs().max()) for g, v in
                        zip(walk.tables, want)))

    t0 = time.perf_counter()
    checked.launches = 0  # the wrapped launch counts on the name it is called by
    table_replay.launch = checked
    try:
        strips._decode_walk(*args)
        torch.cuda.synchronize()
    finally:
        table_replay.launch = launch
    check_s = time.perf_counter() - t0
    tb0, planes, con, map_cols, bias_cols = kept[0]
    work = table_replay.prepare(table_replay.Tables(*(t.clone() for t in tb0)), planes, con)
    ms = _queued_ms(lambda: launch(work, map_cols, bias_cols), reps, runs)
    issued = _cuda_ms(lambda: [launch(work, map_cols, bias_cols) for _ in range(runs)],
                      reps) / runs
    plain = table_replay.Tables(*(t.clone() for t in tb0))
    pms = _queued_ms(lambda: table_replay.replay_plain(plain, planes, con, map_cols, bias_cols),
                     reps, 5)
    bound, floor, floor18 = _k9_work(kept[0])
    err = max(errs)
    lanes = planes[0].shape[1]
    print(f"[K9 p3_table_replay] {what}: {len(errs)} launches each held to replay_plain on the "
          f"tables it found, exact {err == 0} (max error {err}; {check_s:.1f} s with the "
          f"checks); its middle launch ({n_imgs} images x {lanes // n_imgs} lanes, mapper "
          f"columns {map_cols}, bias columns {bias_cols}): K9 {1e3 * ms:.2f} us on the device "
          f"(median of {reps} runs of {runs} launches queued behind a sleep; "
          f"{1e3 * issued:.2f} us a launch issued back to back from the host) | earlier "
          f"(the returned-atomics design, PERF.md §6): "
          f"{K9_EARLIER.get(lanes // n_imgs, 'not recorded')} | plain "
          f"{1e3 * pms:.1f} us ({pms / ms:.0f}x; 5 calls a run, queued alike) | "
          f"bound {1e3 * bound[0]:.3f} us ({bound[1]}) | floor {1e3 * floor:.2f} us (the "
          f"launch's dependent path on its {K9_THREADS}-thread CTAs; the earlier design "
          f"{1e3 * floor18:.2f} us) | library none ({card})", flush=True)
    return (err if err == 0 else None), ms, pms, bound


def _k4_case(what, args, card):
    """K4 (``strips._decode_walk`` on card tensors) against the plain walk
    on the same card tensors (the walk's arguments ``args``), exact; each
    timed by CUDA events in one run.  The launches made here are
    comparisons, not the main path's.  Returns (max error, or None on a
    mismatch; K4 ms; plain ms)."""
    import torch

    from nblic_tpu_torch.models import strips

    words, _, th, w, s, n_imgs, n_feat, near, tune = args
    k, ms = _timed(lambda: strips._decode_walk(*args))
    plain, pms = _timed(lambda: strips._decode_walk_plain(words.to(torch.int64), *args[1:]))
    same = torch.equal(k, plain)
    err = int((k.int() - plain.int()).abs().max())
    steps = th * w
    print(f"[K4 p3_decode_walk] {what}: {n_imgs * s} lanes, {steps} steps, near {near}, "
          f"{n_feat} features, n_seg {tune.n_seg} seg_stats {tune.seg_stats} sym_cnt "
          f"{tune.sym_cnt} mix_e {tune.mix_e}: exact {same} (max error {err}); K4 {ms:.3f} ms "
          f"({1e3 * ms / steps:.3f} us a step) | plain {pms:.1f} ms ({pms / steps:.3f} ms a "
          f"step) ({card})", flush=True)
    return (err if same else None), ms, pms


def _k4_phase(corpus, pair_conts, walk_args, dev, card, full_job):
    """K4 against the plain walk on the card: the pair under each contract
    (``pair_conts`` of :func:`_p3_phase`), the edge images at near 0 and 3,
    the pair with 6 AVP features, the corpus walk's own input
    (``walk_args``), there timed beside its bound and floor; then one
    corpus image encoded on the CPU at th P3_FULL_TH (``full_job``, a
    future of :func:`_cpu_encode`) decoded through strips.decode.  Returns
    None on a failure, else (K4's launches in the full-depth decode, K4's
    numbers on the corpus for the kernels line)."""
    import torch

    from nblic_tpu_torch.models import strips
    from nblic_tpu_torch.ops import decode_walk
    from nblic_tpu_torch.utils.synth import edge_images

    def args_of(conts):
        return strips._walk_args([strips._parse(c) for c in conts], dev)[0]

    errs = []
    for tune in P3_TUNES:
        errs.append(_k4_case(f"the pair at th {P3_PAIR_TH} under {tune}",
                             args_of(pair_conts[tune, P3_PAIR_TH]), card)[0])
    edges = edge_images()
    for near in (0, 3):
        conts = strips.encode_batch(edges, th=8, near=near, device=dev)
        errs.append(_k4_case(f"the edge images at th 8, near {near}", args_of(conts), card)[0])
    saved = strips.AVP_N
    strips.AVP_N = 6
    try:
        conts = strips.encode_batch(_p3_pair(), th=P3_PAIR_TH, device=dev)
    finally:
        strips.AVP_N = saved
    errs.append(_k4_case(f"the pair at th {P3_PAIR_TH} with 6 AVP features", args_of(conts),
                         card)[0])
    if any(e is None for e in errs):
        return None

    # the corpus walk's own input: K4 against the plain walk, then K4 alone
    # timed, then a plain walk of it with its divisions and bins counted
    words, bias, th, w, s, n_imgs, n_feat, near, tune = walk_args
    lanes, n_px = n_imgs * s, n_imgs * s * th * w
    err, _, pms = _k4_case(f"the corpus's walk at th {th}", walk_args, card)
    ms = _cuda_ms(lambda: strips._decode_walk(*walk_args), 3)
    con = decode_walk.contract(near, n_feat, tune, w // strips._eff_seg(tune.n_seg, w), s)
    t0 = time.perf_counter()
    paths, _ = _division_paths(
        lambda: strips._decode_walk_plain(words.to(torch.int64), *walk_args[1:]), n_px,
        (tune.n_unary, tune.n_unary + strips.L_R))
    count_s = time.perf_counter() - t0
    ops, issue, path = _k4_ops(paths, con), _k4_issue(paths, con), _k4_path(paths)
    # each input read once (the stream words), each output written once
    # (the pixels, and the replay's four int64 planes torch reads)
    bound = _bound(words.numel() * 4 + n_px * (1 + 4 * 8), n_px * ops)
    floor = _walk_floor(lanes, th * w, issue, path)
    print(f"[K4 p3_decode_walk] the corpus's walk ({lanes} lanes x {th}x{w}, {th * w} steps): "
          f"K4 {ms:.3f} ms (median of 3; {1e3 * ms / (th * w):.3f} us a step, K9's "
          f"replays between launches included) | plain {pms:.1f} ms ({pms / ms:.0f}x) | bound "
          f"{bound[0]:.4f} ms ({bound[1]}) | {_floor_text(floor, issue, path)} ({ops:.1f} ops "
          f"a pixel; a pixel's divisions by path and active bins, counted on a plain walk of "
          f"the same input in {count_s:.1f} s: "
          + ", ".join(f"{key} {v:.3f}" for key, v in paths.items()) + f") ({card})",
          flush=True)
    if err is None:
        return None
    k9 = _k9_case(f"the corpus's walk at th {th}", walk_args, card)
    if k9[0] is None:
        return None

    # one corpus image at full depth: one lane of 768 x 512 steps
    t0 = time.perf_counter()
    ((cont,),) = full_job.result()
    wait_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    back, n = _entry_decodes(lambda: strips.decode(cont, device=dev))
    dec_s = time.perf_counter() - t0
    steps = P3_FULL_TH * min(corpus[0].shape)
    ok = np.array_equal(back, corpus[0])
    print(f"[K4 p3_decode_walk] one corpus image at th {P3_FULL_TH} (1 lane, {steps} steps; "
          f"encoded on the cpu meanwhile, {8.0 * len(cont) / corpus[0].size:.4f} bpp, waited "
          f"{wait_s:.1f} s for it): strips.decode on K4 exact {ok} in {dec_s:.2f} s "
          f"({1e6 * dec_s / steps:.2f} us a step; "
          f"{_floor_text(_walk_floor(1, steps, issue, path), issue, path)} at the th-{th} "
          f"walk's ops a pixel), K4 launches {n}, K9 launches {K9_MAIN['last']} ({card})",
          flush=True)
    if not (ok and n > 0):
        return None
    args768 = strips._walk_args([strips._parse(cont)], dev)[0]
    args768 = (args768[0], args768[1], P3_K9_ROWS, *args768[3:])
    if _k9_case(f"that image's walk at th {P3_FULL_TH}, its first {P3_K9_ROWS} rows", args768,
                card)[0] is None:
        return None
    # that container as the corpus's 24 lanes (one an image, the default
    # strip height's parallelism), the walk cut to its first P3_FULL_ROWS
    # rows (the depth cut: its launches are host-bound as the image's)
    n_lanes, rows = len(corpus), P3_FULL_ROWS
    args24 = strips._walk_args([strips._parse(c) for c in [cont] * n_lanes], dev)[0]
    args24 = (args24[0], args24[1], rows, *args24[3:])
    want = torch.from_numpy(np.ascontiguousarray(corpus[0].T[:rows])).to(dev)  # its strip
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out24 = strips._decode_walk(*args24)
    torch.cuda.synchronize()
    dec24_s = time.perf_counter() - t0
    steps24 = rows * min(corpus[0].shape)
    ok24 = all(torch.equal(o, want) for o in out24)
    print(f"[K4 p3_decode_walk] that container as {n_lanes} lanes at th {P3_FULL_TH}, the "
          f"walk's first {rows} rows ({steps24} steps): K4 exact {ok24} in {dec24_s:.2f} s "
          f"({1e6 * dec24_s / steps24:.2f} us a step, the replays included; "
          f"{_floor_text(_walk_floor(n_lanes, steps24, issue, path), issue, path)}) ({card})",
          flush=True)
    if not ok24:
        return None
    return n, (max(errs + [err]), ms, pms, bound), k9


def _p3_full_encode(corpus, dev, card, full_job, reps: int = 3):
    """One corpus image encoded on the card at th P3_FULL_TH (one lane, the
    default strip height's own depth), stage by stage, its container
    against the CPU's (``full_job``, a future of :func:`_cpu_encode`) byte
    for byte; then K8 and K3 timed alone (median of ``reps``) on that
    encode's own arguments beside their bounds and floors (their exactness
    there is the container's).  Returns None on a failure, else K8's and
    K3's launches in that encode."""
    import torch

    from nblic_tpu_torch.models import strips
    from nblic_tpu_torch.ops import rans_bin

    ((cont,),) = full_job.result()
    torch.cuda.synchronize()
    with Kept(strips, "_row_scan") as scans, Kept(rans_bin, "fold") as folds, \
            Kept(strips, "_model_planes") as models, \
            StageClock(p3_stage_targets(strips)) as clock:
        t0 = time.perf_counter()
        mine, n8, n3 = _entry_codes(lambda: strips.encode(corpus[0], th=P3_FULL_TH, device=dev))
        enc_s = time.perf_counter() - t0
    stages = clock.stages()
    total = sum(stages.values())
    same = mine == cont
    print(f"[p3 full] corpus image 0 ({corpus[0].shape}) at th {P3_FULL_TH}, one lane: "
          f"strips.encode on the card {enc_s:.2f} s, {8.0 * len(mine) / corpus[0].size:.4f} "
          f"bpp, container equal to the cpu's byte for byte {same}; stages ms "
          + ", ".join(f"{k} {v:.1f} ({100 * v / total:.1f}%)" for k, v in stages.items())
          + f"; launches K10 {MODEL_MAIN['last'][0]} K11 {MODEL_MAIN['last'][1]} K8 {n8} K3 "
          f"{n3} ({card})", flush=True)
    if _model_case(f"that encode's pass at th {P3_FULL_TH}", models.calls.pop(), card) is None:
        return None
    args8, args3 = scans.calls.pop(), folds.calls.pop()
    *planes, n_imgs, tune = args8
    got = strips._row_scan(*args8)
    ms8 = _cuda_ms(lambda: strips._row_scan(*args8), reps)
    text8 = _k8_bound_floor(planes, n_imgs, tune, strips.K_STEP, False, got)[3]
    print(f"[K8 p3_row_scan] that encode's scan, one lane {tuple(planes[0].shape[1:])}: K8 "
          f"{ms8:.3f} ms (median of {reps}) | {text8} ({card})", flush=True)
    ms3 = _cuda_ms(lambda: rans_bin.fold(*args3), reps)
    text3 = _k3_bound_floor(args3)[3]
    print(f"[K3 bin_fold] that encode's fold, {tuple(args3[0].shape)}: K3 {ms3:.3f} ms "
          f"(median of {reps}) | {text3} ({card})", flush=True)
    return (n8, n3) if same and n8 > 0 and n3 > 0 and min(MODEL_MAIN["last"]) > 0 else None


# the native runtime's corpus runs: (label, near, effort, n_threads)
NATIVE_MODES = (("e0 t1", 0, 0, 1), ("e0 t4", 0, 0, 4), ("e1", 0, 1, 0), ("e2", 0, 2, 0),
                ("e3", 0, 3, 0), (f"e1 near {NEAR}", NEAR, 1, 0))
# the device engines' runs on the fixture crop: (fixture mode, near, effort)
INTEROP_WALKS = (("q0", 0, 0), ("e1", 0, 1), ("e1n2", NEAR, 1), ("e3", 0, 3))
# K6's whole-image runs on corpus image 0, both ways: (mode, near, effort)
K6_IMAGE_MODES = INTEROP_WALKS[:3] + (("e2", 0, 2), ("e3", 0, 3))
# K6's integer operations, counted from csrc/interop_chain.cuh (a division,
# a load, a store, a compare or a select counts as one, an int64 operation
# as one): a pixel's fixed work at effort 1 (template 22, blend 120,
# activity 15, quantizer 25, address 20, bias 6, fold and unfold 22,
# mapper 18, context update 7, the symbol's set-up 10); each binary
# decision (two probabilities 10, the mix 7, the split 7, the
# renormalization's test 3, two bumps 18, the unary index 8); at efforts
# 2-3 the two systems' build (4 a channel), the two solves (per system at
# n = 10: 330 updated entries at 8, pivot searches 162, ten reciprocals at
# 40, back substitution 270, prediction 100; at n = 6: 70 entries, 60, six
# reciprocals, 90, 60), the sample weight 70, the update (21 a channel)
# and the F chain's step (6 a channel).  The serial part is what one
# thread issues: the fixed work, one system's solve, the weight and its
# share of the update and the F chain over the warp's 32 threads.  The
# Q0.2 decode's pixel: slide 12, blend 120, quantizer 15, address 20, bias
# 6, the rANS step and its loads 16, unfold 10, update 7.  The chain's
# step: two loads, the multiply-add, the shift, the store.
K6_PIXEL_OPS = {1: 265, 2: 265 + 4 * 43 + 2 * 1010 + 70 + 21 * 43 + 6 * 43,
                3: 265 + 4 * 111 + 2 * 3570 + 70 + 21 * 111 + 6 * 111}
K6_SERIAL_OPS = {1: 265, 2: 265 + 1010 + 70 + (21 + 6 + 4) * 43 // 32,
                 3: 265 + 3570 + 70 + (21 + 6 + 4) * 111 // 32}
K6_BIN_OPS = 53
K6_Q_PIXEL_OPS = 206
K6_CHAIN_OPS = 6


@contextlib.contextmanager
def _plain_walks():
    """The interop entry points on their plain walks for the block (any
    device): the comparisons' runs, which launch no K6."""
    from nblic_tpu_torch.models import nblic, qnblic

    saved = nblic._walk, qnblic._decode_walk, qnblic._context_chain
    nblic._walk = nblic._walk_plain
    qnblic._decode_walk = qnblic._decode_walk_plain
    qnblic._context_chain = qnblic._context_chain_plain
    try:
        yield
    finally:
        nblic._walk, qnblic._decode_walk, qnblic._context_chain = saved


def _native_run(imgs, near, effort, n_threads):
    """api.compress / decompress(backend="native") of each image, in a
    process of its own: [(container, encode s, decode s, max error)]."""
    from nblic_tpu_torch import api

    out = []
    for img in imgs:
        t0 = time.perf_counter()
        c = api.compress(img, near=near, effort=effort, backend="native", n_threads=n_threads)
        t1 = time.perf_counter()
        back = api.decompress(c, backend="native")
        out.append((c, t1 - t0, time.perf_counter() - t1, _max_err(back, img)))
    return out


def _interop_fixtures():
    """(images {name: array}, containers {(image, mode): bytes}): the
    committed interop fixtures (tests/test_torch_runtime.py regenerates
    them with nblic_tpu.runtime)."""
    import os

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data_torch_interop")
    imgs = {n: np.load(os.path.join(data, n + ".npy")) for n in ("crop", "small")}
    conts = {}
    for name in imgs:
        for mode in ("q0", "e1", "e2", "e3", "e1n2"):
            with open(os.path.join(data, f"{name}_{mode}.nblic"), "rb") as f:
                conts[name, mode] = f.read()
    return imgs, conts


def _plain_fold(f, a):
    """rans.encode_scan of int32 (1, L) tables on the CPU, in a process of
    its own: (words, emits, state) as numpy arrays."""
    import torch

    from nblic_tpu_torch.ops import rans

    return tuple(t.numpy() for t in rans.encode_scan(torch.from_numpy(f), torch.from_numpy(a)))


def _interop_phase(api, corpus, dev, card):
    """The interop containers: the port's native runtime copy on the corpus
    (a pool of processes, collected before the card's walks are timed) and
    on the fixtures; the device engines on the card on the fixture crop
    (full width) and, for Q0.2, a whole corpus image; K1 at S = 1.  Returns
    None on a failure, else K1's launches in the engines' runs."""
    import torch

    from nblic_tpu_torch import runtime
    from nblic_tpu_torch.models import qnblic
    from nblic_tpu_torch.ops import interop_walk as k6
    from nblic_tpu_torch.ops import rans
    from nblic_tpu_torch.ops.fold import encode_fold

    def tables(im):
        """K1's (1, h * w) int32 freq / cum tables of a Q0.2 encode of im."""
        x = torch.from_numpy(im).to(dev).to(torch.int32)
        px0, err_, qd, adr = qnblic.model_stage1(x)
        y = qnblic._context_chain(x, px0, err_, adr)
        sym = (qd * 256 + y).reshape(-1).to(torch.int64)
        hist = torch.bincount(sym, minlength=12 * 256).view(12, 256).cpu().numpy()
        hist_n = np.stack([qnblic.hist_ops.normalize(h_) for h_ in hist])
        acc = np.stack([qnblic.hist_ops.accumulate(h_) for h_ in hist_n])
        f = torch.from_numpy(hist_n.astype(np.int32)).to(dev).view(-1)[sym][None]
        a = torch.from_numpy(acc.astype(np.int32)).to(dev).view(-1)[sym][None]
        return f, a

    t0 = time.perf_counter()
    lib = runtime.build()
    print(f"[interop build] the native runtime copy (g++) in {time.perf_counter() - t0:.2f} "
          f"s -> {lib}, {runtime.version()}", flush=True)
    img = corpus[0]
    pool = ProcessPoolExecutor(4, mp_context=multiprocessing.get_context("spawn"))
    try:
        chunks = [corpus[k : k + 6] for k in range(0, len(corpus), 6)]
        jobs = {m: [pool.submit(_native_run, ch, *m[1:]) for ch in chunks]
                for m in NATIVE_MODES}
        imgs, fixtures = _interop_fixtures()
        same = all(
            fixtures[name, mode] == api.compress(imgs[name], near=near, effort=effort,
                                                 backend="native", n_threads=1)
            for name in imgs for mode, near, effort in
            (("q0", 0, 0), ("e1", 0, 1), ("e2", 0, 2), ("e3", 0, 3), ("e1n2", NEAR, 1)))
        print(f"[interop fixtures] the native runtime copy's containers equal the "
              f"committed nblic_tpu containers {same}", flush=True)
        if not same:
            return None
        # the plain fold of the whole image's tables, on the CPU beside the
        # native runs
        f_img, a_img = tables(img)
        plain_job = pool.submit(_plain_fold, f_img.cpu().numpy(), a_img.cpu().numpy())

        # ---- the native corpus runs, all collected before the card's walks
        # are timed
        n_px = sum(im.size for im in corpus)
        native_img = {}  # the image's native containers, by K6's modes
        for m, futs in jobs.items():
            res = [r for fut in futs for r in fut.result()]
            for mode, near, effort in K6_IMAGE_MODES:
                if (near, effort) == m[1:3] and m[3] in (0, 1):
                    native_img[mode] = res[0][0]
            enc_s, dec_s = sum(r[1] for r in res), sum(r[2] for r in res)
            err = max(r[3] for r in res)
            ok = err <= m[1] and (m[1] > 0 or err == 0)
            print(f"[interop native] {m[0]}: {len(res)} images, "
                  f"{8.0 * sum(len(r[0]) for r in res) / n_px:.4f} bpp, max error {err}, "
                  f"encode {n_px / enc_s / 1e6:.2f} MPix/s, decode {n_px / dec_s / 1e6:.2f} "
                  f"MPix/s (host time on the card's machine, one process a call, four "
                  f"processes at once)", flush=True)
            if not ok:
                return None
        t0 = time.perf_counter()
        plain_img = plain_job.result()
        print(f"[interop native] all collected; the plain fold of the image's tables on "
              f"the CPU waited for {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)

    # ---- the device engines on the card, each walk on K6 (the main path's
    # run: K6's counts from here to the image's Q0.2 encode): the crop (full
    # width, a depth cut of the rows), one whole corpus image a mode both
    # ways, a flat image's Q0.2 encode
    crop = imgs["crop"]
    encode_fold.launches = 0
    k6.nblic_walk.launches = k6.q_decode_walk.launches = k6.context_before.launches = 0
    card_crop = {}
    for mode, near, effort in INTEROP_WALKS:
        c = api.compress(crop, near=near, effort=effort, device=dev)
        back = api.decompress(c, device=dev)
        native = api.compress(crop, near=near, effort=effort, backend="native")
        err = _max_err(back, crop)
        ok = c == fixtures["crop", mode] == native and np.array_equal(
            back, api.decompress(native, backend="native")) and err <= near
        card_crop[mode] = (c, back)
        print(f"[interop walk] {mode} {crop.shape} on the card (K6): container equal to the "
              f"fixture's and the native copy's, decode equal to the native's {ok} (max "
              f"error {err})", flush=True)
        if not ok:
            return None
    image_runs = {}
    for mode, near, effort in K6_IMAGE_MODES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c = api.compress(img, near=near, effort=effort, device=dev)
        t1 = time.perf_counter()
        back = api.decompress(c, device=dev)
        t2 = time.perf_counter()
        bins = int(k6.nblic_walk.bins) if effort else 0
        err = _max_err(back, img)
        ok = c == native_img[mode] and err <= near
        image_runs[mode] = (t1 - t0, t2 - t1, bins, len(c))
        print(f"[K6 image] {mode} {img.shape} both ways on the card: container equal to the "
              f"native copy's {c == native_img[mode]}, max error {err} (near {near}); encode "
              f"{1e6 * (t1 - t0) / img.size:.3f} us a pixel ({t1 - t0:.3f} s), decode "
              f"{1e6 * (t2 - t1) / img.size:.3f} us a pixel ({t2 - t1:.3f} s)"
              + (f"; {bins / img.size:.3f} bins a pixel" if effort else "") + f" ({card})",
              flush=True)
        if not ok:
            return None
    flat = np.full(img.shape, 77, np.uint8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c = api.compress(flat, effort=0, device=dev)
    flat_s = time.perf_counter() - t0
    ok = c == api.compress(flat, effort=0, backend="native", n_threads=1)
    print(f"[K6 flat q0.2] {flat.shape} of one value encoded on the card in {flat_s:.4f} s "
          f"(one context of {flat.size} pixels: the chain's one thread), equal to the native "
          f"copy's {ok} ({card})", flush=True)
    if not ok:
        return None

    # ---- Q0.2 encode of a whole image on the card: the context chain (K6)
    # and K1 at S = 1 over all 393,216 symbols
    with StageClock([(qnblic, "model_stage1", "stage 1"),
                     (qnblic, "_context_chain", "chain (K6)"),
                     (qnblic, "encode_fold", "fold (K1)"),
                     (qnblic.rans, "finalize_streams", "stream")]) as clock:
        t0 = time.perf_counter()
        c = api.compress(img, effort=0, device=dev)
        enc_s = time.perf_counter() - t0
    ok = c == api.compress(img, effort=0, backend="native", n_threads=1)
    launches = encode_fold.launches
    k6_main = {"nblic": k6.nblic_walk.launches, "q_decode": k6.q_decode_walk.launches,
               "chain": k6.context_before.launches}
    print(f"[interop q0.2 image] {img.shape} encoded on the card in {enc_s:.3f} s, "
          f"stages ms " + ", ".join(f"{k} {v:.1f}" for k, v in clock.stages().items())
          + f", equal to the native copy's {ok}; K1 launches in the phase {launches}, K6's "
          f"{k6_main} ({card})", flush=True)
    if not ok or launches <= 0 or min(k6_main.values()) <= 0:
        return None

    # ---- K6 against the plain walks on the card, on the same inputs: the
    # crop's walks both ways (each timed, K6 by CUDA events over 3 calls,
    # the plain walk one call), the image's and the flat image's chains
    k6_ms = {}
    for mode, near, effort in INTEROP_WALKS:
        c_k6 = card_crop[mode][0]
        k6_ms[mode] = (_cuda_ms(lambda: api.compress(crop, near=near, effort=effort,
                                                     device=dev), 3),
                       _cuda_ms(lambda: api.decompress(c_k6, device=dev), 3))
        if mode == "e3":
            e3_bins = int(k6.nblic_walk.bins)  # the last call's: the crop's e3 decode
    k6_err, plain_ms = 0, {}
    with _plain_walks():
        for mode, near, effort in INTEROP_WALKS:
            c_k6, back_k6 = card_crop[mode]
            pc, p_enc = _timed(lambda: api.compress(crop, near=near, effort=effort, device=dev))
            pback, p_dec = _timed(lambda: api.decompress(c_k6, device=dev))
            same = pc == c_k6 and np.array_equal(pback, back_k6)
            k6_err = max(k6_err, _max_err(pback, back_k6), 0 if pc == c_k6 else 256)
            plain_ms[mode] = (p_enc, p_dec)
            print(f"[K6 vs plain] {mode} {crop.shape}: K6's container and decode equal to the "
                  f"plain walk's on the card {same}; encode K6 {k6_ms[mode][0]:.3f} ms | plain "
                  f"{p_enc:.1f} ms, decode K6 {k6_ms[mode][1]:.3f} ms | plain {p_dec:.1f} ms "
                  f"(plain {p_dec / crop.size:.3f} ms a pixel; {card})", flush=True)
            if not same:
                return None
    for mode, near, effort in K6_IMAGE_MODES:
        enc, dec, _, _ = image_runs[mode]
        plain = plain_ms.get(mode)
        print(f"[K6 image vs plain] {mode}: K6 {1e6 * enc / img.size:.3f} / "
              f"{1e6 * dec / img.size:.3f} us a pixel on the image (encode / decode) | plain "
              + (f"{plain[0] / crop.size:.3f} / {plain[1] / crop.size:.3f} ms a pixel on the crop"
                 if plain else "not run (the crop's modes are q0, e1, e1n2, e3)")
              + f" ({card})", flush=True)
    chain = {}
    for what, im in (("image", img), ("flat", flat)):
        x = torch.from_numpy(im).to(dev).to(torch.int32)
        px0, err_, _, adr = qnblic.model_stage1(x)
        y_k6 = qnblic._context_chain_card(x, px0, err_, adr)
        y_plain, p_ms = _timed(lambda: qnblic._context_chain_plain(x, px0, err_, adr))
        ms = _cuda_ms(lambda: qnblic._context_chain_card(x, px0, err_, adr), 5)
        steps = int(torch.bincount(adr.reshape(-1).long()).max())
        chain[what] = (int((y_k6 - y_plain).abs().max()), ms, p_ms, x.numel(), steps)
        print(f"[K6 chain] the {what}'s {im.shape} context chain: K6 equal to the plain chain "
              f"{torch.equal(y_k6, y_plain)}; K6 (with its sort and the fold) {ms:.3f} ms | "
              f"plain {p_ms:.1f} ms (the fullest context {steps} steps) ({card})", flush=True)
        if not torch.equal(y_k6, y_plain):
            return None

    # ---- K6's numbers: bound (bytes over the memory rate against the
    # operations the run's data needs over the int32 rate) and floor (one
    # thread issuing the dependent part, an operation a cycle)
    n = crop.size
    e3_bytes = 2 * n + len(card_crop["e3"][0])
    nblic_bound = _bound(e3_bytes, n * K6_PIXEL_OPS[3] + e3_bins * K6_BIN_OPS)
    nblic_floor = 1e3 * (n * K6_SERIAL_OPS[3] + e3_bins * K6_BIN_OPS) / CLOCK_HZ
    q_bytes = len(card_crop["q0"][0]) + 2 * 12 * 256 * 4 + 12 * 2 ** 15 + n
    q_bound = _bound(q_bytes, n * K6_Q_PIXEL_OPS)
    q_floor = 1e3 * n * K6_Q_PIXEL_OPS / CLOCK_HZ
    c_err, c_ms, c_plain, c_n, c_steps = chain["image"]
    chain_bound = _bound(c_n * (4 + 8 + 4) + 3073 * 8, c_n * K6_CHAIN_OPS)
    chain_floor = 1e3 * c_steps * K6_CHAIN_OPS / CLOCK_HZ
    e3_enc, e3_dec, e3_img_bins, _ = image_runs["e3"]
    print(f"[K6 interop_walk] the crop's e3 encode: kernel {k6_ms['e3'][0]:.3f} ms | plain "
          f"{plain_ms['e3'][0]:.1f} ms | bound {nblic_bound[0]:.5f} ms ({nblic_bound[1]}) | "
          f"floor {nblic_floor:.3f} ms (one thread's issue, {e3_bins / n:.2f} bins a pixel); "
          f"the image's e3 walk {1e6 * e3_enc / img.size:.2f} / {1e6 * e3_dec / img.size:.2f} "
          f"us a pixel (floor {1e6 * (K6_SERIAL_OPS[3] + e3_img_bins / img.size * K6_BIN_OPS) / CLOCK_HZ:.2f}) "
          f"| the q0 decode: kernel {k6_ms['q0'][1]:.3f} ms | plain {plain_ms['q0'][1]:.1f} ms | "
          f"bound {q_bound[0]:.5f} ms ({q_bound[1]}) | floor {q_floor:.4f} ms | the image's "
          f"chain: {c_ms:.3f} ms | plain {c_plain:.1f} ms | bound {chain_bound[0]:.5f} ms "
          f"({chain_bound[1]}) | floor {chain_floor:.4f} ms; the flat's: {chain['flat'][1]:.3f} "
          f"ms | plain {chain['flat'][2]:.1f} ms ({card})", flush=True)
    k6_stats = {"nblic": (k6_err, k6_ms["e3"][0], plain_ms["e3"][0], nblic_bound),
                "q_decode": (k6_err, k6_ms["q0"][1], plain_ms["q0"][1], q_bound),
                "chain": (max(c_err, chain["flat"][0]), c_ms, c_plain, chain_bound)}

    # ---- K1 at S = 1: held to its plain version on the crop's tables (on
    # the card) and on the image's (the CPU's plain fold above), timed on
    # the image's
    f, a = tables(crop)
    k_out, p_out = encode_fold(f, a), rans.encode_scan(f, a)
    exact = all(torch.equal(u, v) for u, v in zip(k_out, p_out))
    k_img = encode_fold(f_img, a_img)
    exact_img = all(np.array_equal(u.cpu().numpy(), v) for u, v in zip(k_img, plain_img))
    l_ = f_img.shape[1]
    ms = _cuda_ms(lambda: encode_fold(f_img, a_img), 5)
    bound = _bound(l_ * (4 + 4 + 4) + 4, l_ * K1_OPS_PER_SYMBOL)
    floor = 1e3 * l_ * K1_OPS_PER_SYMBOL / CLOCK_HZ
    print(f"[K1 rans_fold S=1] held to its plain version on the crop's tables "
          f"(L={crop.size}) exact={exact}, on the image's (L={l_}, the plain fold on the "
          f"CPU) exact={exact_img}; on the image's: kernel {ms:.3f} ms | bound "
          f"{bound[0]:.4f} ms ({bound[1]}) | issue floor {floor:.4f} ms | at 182 cycles a "
          f"step {1e3 * l_ * 182 / CLOCK_HZ:.1f} ms ({card})", flush=True)
    if not (exact and exact_img):
        return None
    return launches, k6_main, k6_stats


# ---- the mesh phase: ranks spawned on the one card.  Ranks that share a
# card measure correctness, not scaling: their times are the card's shared
# by every rank.  The rank jobs are module-level, so that the spawned
# ranks find them by name.
MESH_TIMEOUT = 300.0  # seconds for each spawned group and each collective


def _mesh_fixtures():
    """{name: (images, nblic_tpu's mesh containers)}: the committed JAX mesh
    containers (tests/test_torch_mesh.py regenerates them): p1_1x4 at (1, 4),
    6 tiles in 4 groups of 2; p1_2x2 at (2, 2), groups of 6; 16x16 tiles."""
    import os

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data_torch_mesh")
    out = {}
    for name in ("p1_1x4", "p1_2x2"):
        imgs = np.load(os.path.join(data, name + ".npy"))
        conts = []
        for i in range(len(imgs)):
            with open(os.path.join(data, f"{name}_{i}.nbtc"), "rb") as f:
                conts.append(f.read())
        out[name] = (list(imgs), conts)
    return out


def _timed_all_reduce(pmesh) -> list:
    """Wrap the mesh's all-reduce so that each call syncs the card before
    and after and records its ms in the returned list (inside a rank)."""
    import torch

    times = []
    orig = pmesh._all_reduce

    def timed(t, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(t, group)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        return out

    pmesh._all_reduce = timed
    return times


def _mesh_p1_run(mesh, groups, tile=64):
    """Inside a rank: encode_batch_mesh then decode_batch_mesh of each
    same-shape group, each timed between barriers, the kernels' counts set
    to 0 just before and read just after.  Returns (containers, images,
    encode s, decode s, K1 launches, K2 launches)."""
    import torch
    import torch.distributed as dist

    from nblic_tpu_torch.ops.decode import decode_groups
    from nblic_tpu_torch.ops.fold import encode_fold
    from nblic_tpu_torch.parallel import mesh as pmesh

    encode_fold.launches = decode_groups.launches = 0
    dist.barrier()
    t0 = time.perf_counter()
    conts = [pmesh.encode_batch_mesh(g, mesh, tile, tile) for g in groups]
    torch.cuda.synchronize()
    dist.barrier()
    t1 = time.perf_counter()
    decoded = [pmesh.decode_batch_mesh(c, mesh) for c in conts]
    torch.cuda.synchronize()
    dist.barrier()
    return (conts, decoded, t1 - t0, time.perf_counter() - t1, encode_fold.launches,
            decode_groups.launches)


def _mesh_pairs_job(corpus, small, p3_pair):
    """Two ranks: the corpus by shape at (1, 2) and (2, 1) (a warm-up of
    the portrait group first), ``small`` at (1, 2) at 16x16 tiles, the
    corpus through p3_encode_batch_mesh at (2, 1), th 64, and the p3 pair's
    containers through p3_decode_batch_mesh."""
    import torch.distributed as dist

    from nblic_tpu_torch.parallel import mesh as pmesh

    ar_ms = _timed_all_reduce(pmesh)
    groups = [corpus[:18], corpus[18:]]
    out = {}
    for layout in ((1, 2), (2, 1)):
        mesh = pmesh.make_mesh2(*layout)
        _mesh_p1_run(mesh, groups[1:])  # warm-up
        del ar_ms[:]
        out[layout] = _mesh_p1_run(mesh, groups) + (list(ar_ms), mesh.backend)
    out["small"] = pmesh.encode_batch_mesh([small], pmesh.make_mesh2(1, 2), 16, 16)
    mesh = pmesh.make_mesh2(2, 1)
    dist.barrier()
    t0 = time.perf_counter()
    out["p3"] = pmesh.p3_encode_batch_mesh(corpus, mesh, th=64)
    dist.barrier()
    t1 = time.perf_counter()
    out["p3 dec"], out["p3 k4"] = _entry_decodes(lambda: pmesh.p3_decode_batch_mesh(p3_pair,
                                                                                  mesh))
    dist.barrier()
    out["p3 s"] = (t1 - t0, time.perf_counter() - t1)
    return out


def _mesh_quad_job(fixtures, small):
    """Four ranks: the fixtures' images at their JAX layouts, (2, 2) and
    (1, 4), then decoded there; ``small`` at (1, 4), 16x16 tiles."""
    from nblic_tpu_torch.parallel import mesh as pmesh

    out = {}
    for name, layout in (("p1_2x2", (2, 2)), ("p1_1x4", (1, 4))):
        mesh = pmesh.make_mesh2(*layout)
        out[name] = _mesh_p1_run(mesh, [fixtures[name]], tile=16)
    out["small"] = pmesh.encode_batch_mesh([small], mesh, 16, 16)
    return out


def _mesh_nccl_job(imgs):
    """One NCCL rank: the profile-1 encode and decode of ``imgs`` at (1, 1)."""
    from nblic_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.make_mesh2(1, 1)
    return _mesh_p1_run(mesh, [imgs]) + (mesh.backend,)


def _mesh_phase(tiled, corpus, p3_corpus, p3_pair, dev, card):
    """The mesh on the card (nblic_tpu_torch/parallel/mesh.py): gloo ranks
    sharing the card at (1, 2) and (2, 1) over the corpus and at (2, 2) and
    (1, 4) over the committed JAX fixtures, the profile-3 data-parallel
    encode and decode at (2, 1), one NCCL rank; the single-process decoder
    on the mesh's containers, K2 against its plain version at the widths
    the mesh writes.  Returns (K1, K2, K4) launches summed over the ranks'
    runs; raises on any failure."""
    import torch

    from nblic_tpu_torch.convert import group_args
    from nblic_tpu_torch.ops import rans
    from nblic_tpu_torch.ops.decode import decode_groups, group_decode_plain
    from nblic_tpu_torch.ops.fold import encode_fold
    from nblic_tpu_torch.parallel import mesh as pmesh
    from nblic_tpu_torch.utils.synth import synth_image

    def exact(got, want):
        return len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))

    print("[mesh] gloo ranks share the one card: these runs measure correctness, not "
          "scaling (every rank's time is the card's, shared)", flush=True)
    small = synth_image(np.random.default_rng(12), 128, 192)  # 96 tiles of 16x16
    fixtures = _mesh_fixtures()
    groups = [corpus[:18], corpus[18:]]
    n_px = sum(im.size for im in corpus)
    k1 = k2 = 0
    t0 = time.perf_counter()
    pairs = pmesh.launch(2, _mesh_pairs_job, corpus, small, p3_pair, timeout=MESH_TIMEOUT)
    t_pairs = time.perf_counter() - t0
    mesh_conts = {}
    for layout in ((1, 2), (2, 1)):
        conts, decoded, enc_s, dec_s, _, _, ar_ms, backend = pairs[0][layout]
        agree = all(r[layout][0] == conts and exact(sum(r[layout][1], []), corpus)
                    for r in pairs)
        single = tiled.decode_batches(conts, device=dev)
        ok = (agree and exact(sum(decoded, []), corpus) and exact(sum(single, []), corpus))
        g = tiled._Parsed(conts[0][0]).group_size
        l1 = [r[layout][4] for r in pairs]
        l2 = [r[layout][5] for r in pairs]
        k1, k2 = k1 + sum(l1), k2 + sum(l2)
        mesh_conts[layout] = conts
        print(f"[mesh {layout}] {backend}, 2 ranks on one card, the corpus by shape, 64x64 "
              f"tiles, g={g}: encode_batch_mesh {n_px / enc_s / 1e6:.2f} MPix/s ({enc_s:.3f} "
              f"s), decode_batch_mesh {n_px / dec_s / 1e6:.2f} MPix/s ({dec_s:.3f} s); round "
              f"trip {ok} (ranks agree, the mesh's and the single-process tiled.decode_batches "
              f"on the card exact); all-reduce {len(ar_ms)} calls on rank 0, median "
              f"{statistics.median(ar_ms):.3f} ms, max {max(ar_ms):.3f} ms; launches per rank "
              f"K1 {l1} K2 {l2} ({card})", flush=True)
        if not ok or min(l1 + l2) <= 0:
            raise RuntimeError(f"mesh {layout}: a round trip failed or a kernel never launched")

    p3_enc_s, p3_dec_s = pairs[0]["p3 s"]
    ok = all(r["p3"] == p3_corpus for r in pairs)
    print(f"[mesh p3 (2, 1)] gloo, p3_encode_batch_mesh of the corpus at th 64: each container "
          f"equal to the profile-3 phase's strips.encode_batch container {ok} "
          f"({n_px / p3_enc_s / 1e6:.4f} MPix/s, {p3_enc_s:.2f} s) ({card})", flush=True)
    ok_dec = all(exact(r["p3 dec"], _p3_pair()) for r in pairs)
    k4 = [r["p3 k4"] for r in pairs]
    print(f"[mesh p3 (2, 1)] p3_decode_batch_mesh of the 48x64 and 64x48 pair at th "
          f"{P3_PAIR_TH} (the depth cut: {P3_PAIR_TH} x 48 walk steps) exact {ok_dec} "
          f"({p3_dec_s:.2f} s), K4 launches per rank {k4} ({card})", flush=True)
    if not (ok and ok_dec and min(k4) > 0):
        raise RuntimeError("mesh p3: a container or a decode differed, or K4 never launched")

    t0 = time.perf_counter()
    quad = pmesh.launch(4, _mesh_quad_job, {k: v[0] for k, v in fixtures.items()}, small,
                        timeout=MESH_TIMEOUT)
    t_quad = time.perf_counter() - t0
    for name, layout in (("p1_2x2", (2, 2)), ("p1_1x4", (1, 4))):
        imgs, want = fixtures[name]
        conts, decoded, enc_s, dec_s, _, _ = quad[0][name]
        l1 = [r[name][4] for r in quad]
        l2 = [r[name][5] for r in quad]
        k1, k2 = k1 + sum(l1), k2 + sum(l2)
        ok = (all(r[name][0] == [want] for r in quad) and exact(decoded[0], imgs)
              and exact(tiled.decode_batch(conts[0], device=dev), imgs))
        print(f"[mesh {layout}] gloo, 4 ranks on one card: the committed JAX mesh fixture "
              f"{name} ({len(imgs)} images, g={tiled._Parsed(want[0]).group_size}), the "
              f"card's containers equal nblic_tpu's bytes on every rank and decode exact "
              f"(mesh and single-process) {ok}; launches per rank K1 {l1} K2 {l2} ({card})",
              flush=True)
        if not ok or min(l1 + l2) <= 0:
            raise RuntimeError(f"mesh {layout}: the fixture's bytes or decode differed")

    # K2 against its plain version at the widths the mesh writes
    cases = [(2, fixtures["p1_1x4"][1]), (6, fixtures["p1_2x2"][1]),
             (24, quad[0]["small"]), (48, pairs[0]["small"])]
    for g, conts in cases:
        args = group_args([tiled._Parsed(c) for c in conts], dev)
        k = decode_groups(*args)
        p, pms = _timed(lambda: group_decode_plain(*args))
        same = torch.equal(k, p) and args[9] == g
        ms = _cuda_ms(lambda: decode_groups(*args), 5)
        print(f"[K2 mesh width] g={args[9]} groups={args[0].shape[0]} tiles 16x16: exact "
              f"against the plain decoder {same}, kernel {ms:.3f} ms | plain {pms:.3f} ms "
              f"({card})", flush=True)
        if not same:
            raise RuntimeError(f"K2 at g={g} differs from its plain version")
    # the main path's shape at the mesh's widths.  g = 48: K2' at a width
    # that is not a multiple of 32 on 7 images of (1, 2) (14 groups and 2 pad
    # groups), against the plain decoder and K2, which holds K2 there too
    if _k2p_beside_k2([tiled._Parsed(c) for c in mesh_conts[(1, 2)][0][:7]], dev,
                      "[K2' mesh width] 7 images of 512x768, 64x64 tiles", card) is None:
        raise RuntimeError("K2' or K2 at g = 48 differs from the plain decoder")
    args = group_args([tiled._Parsed(c) for c in mesh_conts[2, 1][0][:2]], dev)
    p, pms = _timed(lambda: group_decode_plain(*args))  # one plain run
    same = torch.equal(decode_groups(*args), p)
    ms = _cuda_ms(lambda: decode_groups(*args), 5)
    print(f"[K2 mesh width] g={args[9]} 2 images of 512x768, groups={args[0].shape[0]} "
          f"tiles 64x64: exact against the plain decoder {same}, kernel {ms:.3f} ms | "
          f"plain {pms:.3f} ms | bound {_decode_bound(args)[0]:.4f} ms ({card})", flush=True)
    if not same:
        raise RuntimeError(f"K2 at g={args[9]}, 64x64 tiles, differs from its plain version")

    # K1 at a shard's shape: shard 0 of (1, 2) over the 18 landscape images,
    # its lanes folded with the tables the all-reduce gives (the whole
    # images'), against the plain fold on the card
    tiles = tiled.to_tiles(torch.from_numpy(np.stack(groups[0])).to(dev), 64, 64)
    y, qd, _, hist = tiled._model_lossless_impl(tiles)
    g = tiles.shape[1] // 2
    freq, facc = tiled._encode_tables(y[:, :g], qd[:, :g], *tiled._norm_tables(hist),
                                      g_lanes=g)
    w1, e1, s1 = encode_fold(freq, facc)
    (w2, e2, s2), pms = _timed(lambda: rans.encode_scan(freq, facc))
    same = torch.equal(e1, e2) and torch.equal(w1[e1], w2[e2]) and torch.equal(s1, s2)
    ms = _cuda_ms(lambda: encode_fold(freq, facc), 5)
    s_, l_ = freq.shape
    bound = _bound(s_ * l_ * (4 + 4 + 4) + s_ * 4, s_ * l_ * K1_OPS_PER_SYMBOL)
    print(f"[K1 mesh shard] S={s_} L={l_} (18 images x g={g} lanes, shard 0 of (1, 2)): "
          f"exact against the plain fold {same}, kernel {ms:.3f} ms | plain {pms:.3f} ms | "
          f"bound {bound[0]:.4f} ms ({bound[1]}) ({card})", flush=True)
    if not same:
        raise RuntimeError("K1 at the mesh shard's shape differs from its plain version")

    t0 = time.perf_counter()
    (nccl,) = pmesh.launch(1, _mesh_nccl_job, corpus[18:], backend="nccl",
                           timeout=MESH_TIMEOUT)
    t_nccl = time.perf_counter() - t0
    conts, decoded, enc_s, dec_s, l1, l2, backend = nccl
    ok = backend == "nccl" and exact(decoded[0], corpus[18:]) and exact(
        tiled.decode_batch(conts[0], device=dev), corpus[18:])
    k1, k2 = k1 + l1, k2 + l2
    print(f"[mesh (1, 1)] {backend}, one rank: the 6 portrait images encoded and decoded "
          f"through the mesh exact {ok}, launches K1 {l1} K2 {l2} ({card})", flush=True)
    if not ok or min(l1, l2) <= 0:
        raise RuntimeError("mesh nccl: a round trip failed or a kernel never launched")
    print(f"[mesh] spawned groups' wall times: 2 ranks {t_pairs:.1f} s, 4 ranks "
          f"{t_quad:.1f} s, 1 NCCL rank {t_nccl:.1f} s", flush=True)
    return k1, k2, sum(k4)


def _main_path(api, tiled, corpus, frame, dev, effort, tag, card):
    """Drive the corpus and the frame through the entry points at ``effort``;
    returns (ok, corpus bpp)."""
    singles = [api.compress_tiled(im, effort=effort, device=dev) for im in corpus]
    single_ok = all(np.array_equal(api.decompress(c, device=dev), im)
                    for c, im in zip(singles, corpus))

    tiled.encode_corpus(corpus, effort=effort, device=dev)  # warm-up
    t0 = time.perf_counter()
    conts = tiled.encode_corpus(corpus, effort=effort, device=dev)
    enc_s = time.perf_counter() - t0
    groups = [conts[:18], conts[18:]]  # landscape, then transposed portrait
    tiled.decode_batches(groups, device=dev)
    t0 = time.perf_counter()
    decoded = tiled.decode_batches(groups, device=dev)
    dec_s = time.perf_counter() - t0
    corpus_ok = all(np.array_equal(d, im)
                    for d, im in zip(decoded[0] + decoded[1], corpus))
    n_px = sum(im.size for im in corpus)
    bpp = 8.0 * sum(len(c) for c in conts) / n_px

    t0 = time.perf_counter()
    frame_c = api.compress_tiled(frame, effort=effort, device=dev)
    frame_enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    frame_ok = np.array_equal(api.decompress_tiled(frame_c, device=dev), frame)
    frame_dec_s = time.perf_counter() - t0
    n_groups = tiled._Parsed(frame_c).counts.size
    print(f"[{tag}] corpus 24 images ({n_px / 1e6:.2f} MPix) round trip "
          f"{single_ok and corpus_ok}, {bpp:.4f} bpp, encode_corpus "
          f"{n_px / enc_s / 1e6:.2f} MPix/s, decode_batches "
          f"{n_px / dec_s / 1e6:.2f} MPix/s | frame {frame.shape} ({n_groups} "
          f"groups) round trip {frame_ok}, "
          f"{8.0 * len(frame_c) / frame.size:.4f} bpp, encode "
          f"{frame.size / frame_enc_s / 1e6:.2f} MPix/s, decode "
          f"{frame.size / frame_dec_s / 1e6:.2f} MPix/s ({card})", flush=True)
    return single_ok and corpus_ok and frame_ok, bpp, frame_c


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs a GPU",
              file=sys.stderr)
        return 1

    from nblic_tpu_torch import api, kernels
    from nblic_tpu_torch.convert import group_args
    from nblic_tpu_torch.models import tiled
    from nblic_tpu_torch.ops import rans
    from nblic_tpu_torch.ops.decode import (
        SLOT_BITS, decode_groups, decode_groups8, group_decode_plain,
    )
    from nblic_tpu_torch.ops.fold import encode_fold
    from nblic_tpu_torch.utils.synth import synth_image

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"{name}; {smi}"
    print(f"[device] {name} | nvidia-smi: {smi}", flush=True)

    # ---- build
    t0 = time.perf_counter()
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        kernels.build(verbose=True)
    print(report.getvalue(), end="")
    lib = kernels.library()
    print(f"[build] {time.perf_counter() - t0:.2f} s -> {kernels.library_path()} "
          f"({card})", flush=True)
    for line in ptxas_summary(report.getvalue()) or ["not reported: the library was built "
                                                     "before this run"]:
        print(f"[build ptxas] {line}", flush=True)
    if not _warp_chain_check(dev, card):
        print("[K5 chain] failed: the warp chain differed from avp.solve_batch")
        return 1
    print(f"[layout] K2: slot table k={SLOT_BITS}, stream ring "
          f"{lib.nbt_group_decode_ring_words(128)} words at g=128, shared memory "
          f"{lib.nbt_group_decode_smem(64, 128)} B a CTA at 64x64 tiles, "
          f"{lib.nbt_group_decode_smem(16, 128)} B at 16x16 (K2' the same) | K7: "
          f"{lib.nbt_near_scan_smem(64, 8)} B a CTA of {K7_LANES} lanes at 64x64 | K1: "
          f"{lib.nbt_rans_fold_smem()} B a block | K8: {lib.nbt_p3_row_scan_smem()} B a CTA "
          f"(an image's bias moments and mapper)", flush=True)

    # ---- K1 against the plain fold on the card
    rng = np.random.default_rng(0)
    s, l = 3072, 4096
    freq = rng.integers(1, 1 << 15, size=(l, s)).astype(np.int32)
    facc = rng.integers(0, 1 << 14, size=(l, s)).astype(np.int32)
    freq[:, :64] = 1 << 15  # identity lanes, as pad lanes are
    facc[:, :64] = 0
    freq_t = torch.from_numpy(freq).to(dev).t()  # (S, L) views of (L, S)
    facc_t = torch.from_numpy(facc).to(dev).t()
    w1, e1, s1 = encode_fold(freq_t, facc_t)
    w2, e2, s2 = rans.encode_scan(freq_t, facc_t)
    torch.cuda.synchronize()
    fold_ok = (torch.equal(e1, e2) and torch.equal(w1[e1], w2[e2])
               and torch.equal(s1, s2))
    fold_err = max(int((w1 - w2).abs().masked_fill(~(e1 & e2), 0).max()),
                   int((s1 - s2).abs().max()))
    fold_ms = _cuda_ms(lambda: encode_fold(freq_t, facc_t), 5)
    fold_plain_ms = _cuda_ms(lambda: rans.encode_scan(freq_t, facc_t), 5)
    fold_bound = _bound(s * l * (4 + 4 + 4) + s * 4, s * l * K1_OPS_PER_SYMBOL)
    fold_floor = max(fold_bound[0], 1e3 * l * K1_OPS_PER_SYMBOL / CLOCK_HZ)
    print(f"[K1 rans_fold] S={s} L={l} exact={fold_ok} emits={int(e1.sum())} "
          f"kernel {fold_ms:.3f} ms | plain {fold_plain_ms:.3f} ms | bound "
          f"{fold_bound[0]:.4f} ms ({fold_bound[1]}) | floor {fold_floor:.4f} ms "
          f"({card})", flush=True)
    if not fold_ok:
        return 1

    # ---- K2, profile 1, against the plain decoder on the card
    dec_cases = [
        ([synth_image(rng, 512, 768) for _ in range(2)], 64),
        ([rng.integers(0, 256, size=(96, 104), dtype=np.uint8)], 8),
    ]
    dec = {}
    for imgs, t in dec_cases:
        conts = tiled.encode_batch(imgs, tile_h=t, tile_w=t, device=dev)
        args = group_args([tiled._Parsed(c) for c in conts], dev)
        k = decode_groups(*args)
        p, pms = _timed(lambda: group_decode_plain(*args))  # one plain run
        same = torch.equal(k, p)
        err = int((k.int() - p.int()).abs().max())
        ms = _cuda_ms(lambda: decode_groups(*args), 5)
        bound, floor = _decode_bound(args), _decode_floor(args)
        if t == 64:
            dec[1] = (err, ms, pms, bound)
        print(f"[K2 group_decode p1] {len(imgs)}x{imgs[0].shape} tiles {t}x{t} "
              f"groups={args[0].shape[0]} g={args[9]} exact={same} kernel {ms:.3f} ms"
              f" | plain {pms:.3f} ms | bound {bound[0]:.4f} ms ({bound[1]}) | "
              f"floor {floor:.4f} ms ({card})", flush=True)
        if not same:
            return 1

    # ---- the card's main path against the CPU plain path on small inputs
    for shape, t in (((70, 90), 16), ((96, 104), 8)):
        img = synth_image(rng, *shape)
        on_card = tiled.encode(img, tile_h=t, tile_w=t, device=dev)
        on_cpu = tiled.encode(img, tile_h=t, tile_w=t, device="cpu")
        back = tiled.decode(on_cpu, device=dev)
        ok = on_card == on_cpu and np.array_equal(back, img) \
            and np.array_equal(tiled.decode(on_card, device="cpu"), img)
        print(f"[reference] {shape} tiles {t}: card == cpu containers and "
              f"pixels: {ok}", flush=True)
        if not ok:
            return 1

    # ---- main path, effort 1
    corpus = [synth_image(rng, 512, 768) for _ in range(18)]
    corpus += [synth_image(rng, 768, 512) for _ in range(6)]
    frame = synth_image(rng, 3072, 4096)
    encode_fold.launches = 0
    decode_groups.launches = 0
    ok, bpp1, _ = _main_path(api, tiled, corpus, frame, dev, 1, "main path e1", card)
    launches1 = {"rans_fold": encode_fold.launches,
                 "group_decode": decode_groups.launches}
    print(f"[main path e1] launches {launches1}", flush=True)
    if not ok or min(launches1.values()) <= 0:
        print("[main path e1] failed: round trip or a kernel never launched")
        return 1

    # ---- K2, profile 2, against the plain decoder on the card: the main
    # path's shape (two Kodak-sized images, 64x64 tiles, 128 lanes), then
    # 16x16 tiles and the 8x8 multi-group case; flags 0, 1, 2 in turn
    rng2, rng3 = np.random.default_rng(2), np.random.default_rng(3)
    p2_cases = [([synth_image(rng3, 512, 768) for _ in range(2)], 64),
                ([synth_image(rng2, 128, 256)], 16),
                ([synth_image(rng2, 96, 104)], 8)]
    for imgs, t in p2_cases:
        conts = tiled._encode_flag_cycle(imgs, t, dev)
        args = group_args([tiled._Parsed(c) for c in conts], dev)
        k = decode_groups(*args)
        p, pms = _timed(lambda: group_decode_plain(*args))  # one plain run
        same = torch.equal(k, p)
        err = int((k.int() - p.int()).abs().max())
        ms = _cuda_ms(lambda: decode_groups(*args), 5)
        bound, floor = _decode_bound(args), _decode_floor(args)
        if t == 64:
            dec[2] = (err, ms, pms, bound)
        print(f"[K2 group_decode p2] {len(imgs)}x{imgs[0].shape} tiles {t}x{t} "
              f"groups={args[0].shape[0]} g={args[9]} flags 0/1/2 exact={same} "
              f"kernel {ms:.3f} ms | plain {pms:.3f} ms | bound {bound[0]:.4f} ms "
              f"({bound[1]}) | floor {floor:.4f} ms ({card})", flush=True)
        if not same:
            return 1

    # ---- K2' against the plain decoder and K2, on the corpus's groups
    k8 = None
    for profile in (1, 2):
        conts = []
        for batch in (corpus[:18], [im.T.copy() for im in corpus[18:]]):
            conts += (tiled._encode_flag_cycle(batch, 16, dev) if profile == 2 else
                      tiled.encode_batch(batch, tile_h=16, tile_w=16, device=dev))
        stats = _k2p_beside_k2([tiled._Parsed(c) for c in conts], dev,
                               f"[K2' group_decode8 p{profile}] corpus at 16x16 tiles", card)
        if stats is None:
            return 1
        if profile == 2:
            k8 = stats

    # ---- effort 2: the card against the CPU plain path on small inputs
    for shape, t in (((70, 90), 16), ((96, 104), 8)):
        img = synth_image(rng2, *shape)
        tiles = tiled.to_tiles(torch.from_numpy(img)[None], t, t)
        *_, w_q, flags = tiled._model_lossless2_impl(tiles)
        on_cpu = tiled._encode_batch([img], t, t, 2, None, torch.device("cpu"),
                                     (w_q, flags))
        on_card = tiled._encode_batch([img], t, t, 2, None, dev,
                                      (w_q.to(dev), flags.to(dev)))
        free_card = tiled.encode(img, tile_h=t, tile_w=t, effort=2, device=dev)
        free_cpu = tiled.encode(img, tile_h=t, tile_w=t, effort=2, device="cpu")
        f_card, f_cpu = (tiled._Parsed(c).flags for c in (free_card, free_cpu))
        ok = (on_card == on_cpu
              and np.array_equal(tiled.decode(free_card, device="cpu"), img)
              and np.array_equal(tiled.decode(free_cpu, device=dev), img))
        print(f"[reference e2] {shape} tiles {t}: carried weights card == cpu "
              f"containers {on_card == on_cpu}; free-running cross-decode "
              f"{ok}, flags agree on {int((f_card == f_cpu).sum())}/{len(f_cpu)} "
              f"tiles, containers equal {free_card == free_cpu}", flush=True)
        if not ok:
            return 1

    # ---- main path, effort 2
    encode_fold.launches = 0
    decode_groups.launches = 0
    decode_groups8.launches = 0
    ok, bpp2, frame_c2 = _main_path(api, tiled, corpus, frame, dev, 2,
                                    "main path e2", card)
    launches2 = {"rans_fold": encode_fold.launches,
                 "group_decode": decode_groups.launches,
                 "group_decode8": decode_groups8.launches}
    print(f"[main path e2] launches {launches2}; corpus bpp {bpp2:.4f} at effort 2 "
          f"against {bpp1:.4f} at effort 1 ({card})", flush=True)
    if not ok or min(launches2["rans_fold"], launches2["group_decode"]) <= 0 \
            or launches2["group_decode8"]:
        print("[main path e2] failed: round trip, a kernel never launched, or K2' (on no "
              "entry point) launched")
        return 1
    launches8 = launches2["group_decode8"]

    # ---- K2' beside K2 on the frame's 24 groups (64x64 tiles)
    if _k2p_beside_k2([tiled._Parsed(frame_c2)], dev, f"[K2' frame] {frame.shape} effort 2",
                      card, plain=False) is None:
        return 1

    # ---- near-lossless: the feedback scan and K2's near instances
    t0 = time.perf_counter()
    near = _near_phase(tiled, api, corpus, frame, dev, card)
    if near is None:
        print("[near] failed: a mismatch, an error past near or a kernel never launched")
        return 1
    near_k1, near_k2_e1, near_k2_e2, near_k7, k7_stats = near
    print(f"[near] the phase took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- profile 3, its decodes on K4; a process pool of the CPU's encodes
    # and decodes for comparison, and of the full-depth encode K4 decodes
    pool = ProcessPoolExecutor(3, mp_context=multiprocessing.get_context("spawn"))
    try:
        lossless_jobs, near_jobs = _p3_cpu_jobs(corpus)
        lossless_job = pool.submit(_cpu_encode, lossless_jobs)
        near_job = pool.submit(_cpu_encode, near_jobs)
        full_job = pool.submit(_cpu_encode, [([corpus[0]], P3_FULL_TH, 0, "TUNE_V4")])
        t0 = time.perf_counter()
        p3 = _p3_phase(api, tiled, corpus, dev, card, pool, lossless_job)
        if p3 is None:
            print("[p3] failed: a container or a decode differed from the CPU's, the image "
                  "or nblic_tpu's pixels, or the route")
            return 1
        p3_conts, pair_conts, k4_launches, walk_args, (k8_launches, k3_launches), k8_stats, \
            k3_stats, (k10_stats, k11_stats) = p3
        print(f"[p3] the phase took {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        p3_near = _p3_near_phase(tiled, corpus, dev, card, near_job)
        if p3_near is None:
            print("[p3 near] failed: a container differed from nblic_tpu's or the CPU's, "
                  "a header, an error past near, K5 differed from the plain walk or never "
                  "launched")
            return 1
        k5_launches, k5_stats, n4, (n8, n3), _ = p3_near
        k4_launches += n4
        k8_launches += n8
        k3_launches += n3
        print(f"[p3 near] the phase took {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        k4 = _k4_phase(corpus, pair_conts, walk_args, dev, card, full_job)
        del walk_args
        if k4 is None:
            print("[K4] failed: K4 differed from the plain walk, or the full-depth image did "
                  "not come back exact or never launched K4")
            return 1
        k4_launches += k4[0]
        k4_stats, k9_stats = k4[1], k4[2]
        print(f"[K4] the phase took {time.perf_counter() - t0:.1f} s; K4 launches on the "
              f"entry points {k4_launches}", flush=True)
        full = _p3_full_encode(corpus, dev, card, full_job)
        if full is None:
            print("[p3 full] failed: the card's th-768 container differed from the CPU's, the "
                  "modeling pass's kernels differed from their plain versions, or K10, K11, K8 "
                  "or K3 never launched")
            return 1
        k8_launches += full[0]
        k3_launches += full[1]
    finally:
        pool.shutdown(wait=True, cancel_futures=True)

    # ---- the interop containers (Q0.2, NBLIC0.3): the native runtime copy,
    # the device engines, K1 at S = 1
    t0 = time.perf_counter()
    interop = _interop_phase(api, corpus, dev, card)
    if interop is None:
        print("[interop] failed: a container differed from the fixture's or the native "
              "copy's, a decode differed, K6 differed from the plain walks, or K1 or K6 "
              "never launched")
        return 1
    interop_k1, k6_main, k6_stats = interop
    print(f"[interop] the phase took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- the mesh: gloo ranks sharing the card, then one NCCL rank
    t0 = time.perf_counter()
    torch.cuda.empty_cache()  # the ranks allocate on the same card
    mesh_k1, mesh_k2, mesh_k4 = _mesh_phase(tiled, corpus, p3_conts,
                                            pair_conts["TUNE_V4", P3_PAIR_TH], dev, card)
    print(f"[mesh] the phase took {time.perf_counter() - t0:.1f} s", flush=True)

    def row(name_, source, replaces, launches, stats, **extra):
        err_, ms_, pms_, (bound_ms, bound_by) = stats
        return {"name": name_, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches, "max_abs_err": err_,
                "ms": ms_, "plain_ms": pms_, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None, **extra}

    k2_src = "nblic_tpu_torch/csrc/group_decode.cu"
    if K9_MAIN["launches"] <= 0:
        print("[K9] failed: K9 never launched on the entry points")
        return 1
    if min(MODEL_MAIN["chains"], MODEL_MAIN["solve"]) <= 0:
        print("[K10 K11] failed: K10 or K11 never launched on the entry points")
        return 1
    print(f"[time] the whole command {time.perf_counter() - T_START:.1f} s ({card})",
          flush=True)
    print(json.dumps({"kernels": [
        row("rans_fold", "nblic_tpu_torch/csrc/rans_fold.cu",
            "nblic_tpu/ops/pallas_fold.py:93",
            launches1["rans_fold"] + launches2["rans_fold"] + near_k1 + interop_k1 + mesh_k1,
            (fold_err, fold_ms, fold_plain_ms, fold_bound)),
        row("group_decode_p1", k2_src, "nblic_tpu/ops/pallas_decode.py:247",
            launches1["group_decode"] + near_k2_e1 + mesh_k2, dec[1]),
        row("group_decode_p2", k2_src, "nblic_tpu/ops/pallas_decode.py:123",
            launches2["group_decode"] + near_k2_e2, dec[2]),
        row("group_decode8", k2_src, "docs/experiments/pallas_decode8.py:238",
            launches8, k8),
        row("near_scan", "nblic_tpu_torch/csrc/near_scan.cu", "nblic_tpu/models/tiled.py:594",
            near_k7, k7_stats, note="an XLA scan (jax.vmap of lax.scan), no pallas_call"),
        row("p3_near_walk", "nblic_tpu_torch/csrc/p3_near_walk.cu",
            "nblic_tpu/models/strips.py:796", k5_launches, k5_stats,
            note="an XLA scan (lax.scan), no pallas_call"),
        row("p3_decode_walk", "nblic_tpu_torch/csrc/p3_decode_walk.cu",
            "nblic_tpu/models/strips.py:1222", k4_launches + mesh_k4, k4_stats,
            note="an XLA scan (lax.scan), no pallas_call"),
        row("bin_fold", "nblic_tpu_torch/csrc/bin_fold.cu", "nblic_tpu/ops/rans_bin.py:48",
            k3_launches, k3_stats, note="an XLA scan (lax.scan), no pallas_call"),
        row("p3_row_scan", "nblic_tpu_torch/csrc/p3_row_scan.cu",
            "nblic_tpu/models/strips.py:649", k8_launches, k8_stats,
            note="an XLA scan (lax.scan), no pallas_call"),
        row("p3_table_replay", "nblic_tpu_torch/csrc/p3_table_replay.cu",
            "nblic_tpu/models/strips.py:1914", K9_MAIN["launches"], k9_stats,
            note="the tables' replay inside an XLA scan (lax.scan), no pallas_call"),
        row("p3_model_chains", "nblic_tpu_torch/csrc/p3_model_chains.cu",
            "nblic_tpu/ops/pavp.py:474", MODEL_MAIN["chains"], k10_stats,
            note="an XLA scan (lax.scan), no pallas_call"),
        row("p3_model_solve", "nblic_tpu_torch/csrc/p3_model_solve.cu",
            "nblic_tpu/ops/pavp.py:346", MODEL_MAIN["solve"], k11_stats,
            note="an XLA scan (lax.scan), no pallas_call"),
        row("interop_nblic_walk", "nblic_tpu_torch/csrc/interop_walk.cu",
            "nblic_tpu/models/nblic.py:40", k6_main["nblic"], k6_stats["nblic"],
            note="an XLA scan (lax.scan), no pallas_call"),
        row("interop_q_decode", "nblic_tpu_torch/csrc/interop_walk.cu",
            "nblic_tpu/models/qnblic.py:103", k6_main["q_decode"], k6_stats["q_decode"],
            note="an XLA scan (lax.scan), no pallas_call"),
        row("interop_q_chain", "nblic_tpu_torch/csrc/interop_walk.cu",
            "nblic_tpu/models/qnblic.py:46", k6_main["chain"], k6_stats["chain"],
            note="an XLA scan (lax.scan), no pallas_call"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
