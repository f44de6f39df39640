#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: compile the CUDA kernels from nblic_tpu_torch/csrc (nvcc, sm_90a);
  3. K1 (rANS fold) against its plain version on the card, exact;
  4. K2 (group decode) against its plain version on the card, exact;
  5. reference: the card's containers and pixels equal the CPU plain path's
     on small images;
  6. main path: a Kodak-shaped synthetic corpus (24 images) and one 3072x4096
     frame through compress_tiled / encode_corpus / decode_batches,
     pixel-exact, with both kernels launched during the run.
Then one JSON line of the kernels' numbers, and as the last line
{"ok": true, "device": {...}}.  Needs no network; imports no JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np


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


def synth_image(rng, h: int, w: int) -> np.ndarray:
    """A natural-looking gray-8 plane: smooth gradients, texture and mild noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yy /= h
    xx /= w
    img = 128.0 + 50.0 * (xx - 0.5) * rng.uniform(-1, 1) + 40.0 * (yy - 0.5)
    for _ in range(4):  # low-frequency shading
        fx, fy = rng.uniform(0.5, 4.0, size=2)
        img += rng.uniform(10, 30) * np.sin(2 * np.pi * (fx * xx + fy * yy)
                                            + rng.uniform(0, 2 * np.pi))
    # a textured band and a few textured blocks
    band = (yy > rng.uniform(0.2, 0.5)) & (yy < rng.uniform(0.6, 0.9))
    tex = 12.0 * np.sin(2 * np.pi * (rng.uniform(20, 60) * xx)) \
        * np.sin(2 * np.pi * (rng.uniform(20, 60) * yy))
    img += np.where(band, tex, 0.0)
    img += rng.normal(0.0, 2.5, size=(h, w)).astype(np.float32)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs a GPU",
              file=sys.stderr)
        return 1

    from nblic_tpu_torch import api, kernels
    from nblic_tpu_torch.convert import streams_from_parsed, tables_from_numpy
    from nblic_tpu_torch.models import tiled
    from nblic_tpu_torch.ops import rans
    from nblic_tpu_torch.ops.decode import decode_groups, group_decode_plain
    from nblic_tpu_torch.ops.fold import encode_fold

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {name} | nvidia-smi: {smi}", flush=True)

    # ---- build
    t0 = time.perf_counter()
    kernels.build(verbose=True)
    kernels.library()
    print(f"[build] {time.perf_counter() - t0:.2f} s -> {kernels.library_path()}",
          flush=True)

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
    print(f"[K1 rans_fold] S={s} L={l} exact={fold_ok} emits={int(e1.sum())} "
          f"kernel {fold_ms:.3f} ms | plain {fold_plain_ms:.3f} ms "
          f"({name}; {smi})", flush=True)
    if not fold_ok:
        return 1

    # ---- K2 against the plain decoder on the card
    dec_cases = [
        ([synth_image(rng, 512, 768) for _ in range(2)], 64),
        ([rng.integers(0, 256, size=(96, 104), dtype=np.uint8)], 8),
    ]
    dec_ok, dec_err, dec_ms, dec_plain_ms = True, 0, 0.0, 0.0
    for imgs, t in dec_cases:
        conts = tiled.encode_batch(imgs, tile_h=t, tile_w=t, device=dev)
        parsed = [tiled._Parsed(c) for c in conts]
        bias, hist_n, acc = tables_from_numpy(
            np.stack([p.bias for p in parsed]), np.stack([p.hist_n for p in parsed]),
            np.stack([p.acc for p in parsed]), dev,
        )
        words, n_active = streams_from_parsed(parsed, dev)
        g = parsed[0].group_size
        args = (words, n_active, bias, hist_n, acc, t, t, 0, g)
        k = decode_groups(*args)
        p = group_decode_plain(*args)
        torch.cuda.synchronize()
        same = torch.equal(k, p)
        dec_ok &= same
        dec_err = max(dec_err, int((k.int() - p.int()).abs().max()))
        ms = _cuda_ms(lambda: decode_groups(*args), 5)
        pms = _cuda_ms(lambda: group_decode_plain(*args), 3)
        if t == 64:
            dec_ms, dec_plain_ms = ms, pms
        print(f"[K2 group_decode] {len(imgs)}x{imgs[0].shape} tiles {t}x{t} "
              f"groups={words.shape[0]} g={g} exact={same} kernel {ms:.3f} ms | "
              f"plain {pms:.3f} ms ({name}; {smi})", flush=True)
    if not dec_ok:
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

    # ---- main path
    corpus = [synth_image(rng, 512, 768) for _ in range(18)]
    corpus += [synth_image(rng, 768, 512) for _ in range(6)]
    frame = synth_image(rng, 3072, 4096)
    encode_fold.launches = 0
    decode_groups.launches = 0

    singles = [api.compress_tiled(im, device=dev) for im in corpus]
    single_ok = all(np.array_equal(api.decompress(c, device=dev), im)
                    for c, im in zip(singles, corpus))

    tiled.encode_corpus(corpus, device=dev)  # warm-up: allocator, first launches
    t0 = time.perf_counter()
    conts = tiled.encode_corpus(corpus, device=dev)
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
    frame_c = api.compress_tiled(frame, device=dev)
    frame_enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    frame_ok = np.array_equal(api.decompress_tiled(frame_c, device=dev), frame)
    frame_dec_s = time.perf_counter() - t0
    n_groups = tiled._Parsed(frame_c).counts.size
    launches = {"rans_fold": encode_fold.launches,
                "group_decode": decode_groups.launches}
    print(f"[main path] corpus 24 images ({n_px / 1e6:.2f} MPix) round trip "
          f"{single_ok and corpus_ok}, {bpp:.4f} bpp, encode_corpus "
          f"{n_px / enc_s / 1e6:.2f} MPix/s, decode_batches "
          f"{n_px / dec_s / 1e6:.2f} MPix/s | frame {frame.shape} ({n_groups} "
          f"groups) round trip {frame_ok}, "
          f"{8.0 * len(frame_c) / frame.size:.4f} bpp, encode "
          f"{frame.size / frame_enc_s / 1e6:.2f} MPix/s, decode "
          f"{frame.size / frame_dec_s / 1e6:.2f} MPix/s | launches {launches} "
          f"({name}; {smi})", flush=True)
    if not (single_ok and corpus_ok and frame_ok):
        return 1
    if min(launches.values()) <= 0:
        print("[main path] a kernel of the path was never launched", flush=True)
        return 1

    print(json.dumps({"kernels": [
        {"name": "rans_fold", "route": "cuda",
         "source": "nblic_tpu_torch/csrc/rans_fold.cu",
         "replaces": "nblic_tpu/ops/pallas_fold.py:93",
         "launches": launches["rans_fold"], "max_abs_err": fold_err,
         "ms": fold_ms, "plain_ms": fold_plain_ms},
        {"name": "group_decode", "route": "cuda",
         "source": "nblic_tpu_torch/csrc/group_decode.cu",
         "replaces": "nblic_tpu/ops/pallas_decode.py:247",
         "launches": launches["group_decode"], "max_abs_err": dec_err,
         "ms": dec_ms, "plain_ms": dec_plain_ms},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
