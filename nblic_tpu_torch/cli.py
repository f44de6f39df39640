"""Command-line interface of the port, flag-compatible with nblic_tpu's CLI.

Usage:
    python -m nblic_tpu_torch -c [-n0 -e1] [--device=cuda] in.{bmp,pgm,pnm} out.nblic
    python -m nblic_tpu_torch -c --tiled [--device=cuda] in.{bmp,pgm,pnm} out.nbtc
    python -m nblic_tpu_torch -d [--device=cuda] in.{nblic,nbtc} out.{bmp,pgm,pnm}

Switches, combinable (``-cn2e2V``): ``-v`` verbose, ``-V`` verbose with the
native runtime's row progress, ``-n<int>`` near (0 lossless; k > 0
near-lossless, max error k), ``-e<digit>`` effort, ``-t`` threads for the
native effort-0 encoder.  Without ``--tiled`` the interop containers: Q0.2
at effort 0 (near 0), NBLIC0.3 at efforts 1-3, by ``--backend=torch`` (the
device engines on ``--device``, the default) or ``--backend=native`` (the
C++ host runtime).  With ``--tiled`` the NBTC container: effort 0-1
profile 1, 2 profile 2, 3 profile 3, ``--tile-h=N`` / ``--tile-w=N`` tile
geometry (default 64x64; profile 3 cuts full-width strips instead).
``-d`` reads every container.
"""

from __future__ import annotations

import re
import sys
import time

from . import api
from .utils import imageio

USAGE = """\
nblic_tpu_torch: the PyTorch / CUDA port of the nblic_tpu codec
  compress:    python -m nblic_tpu_torch -c [-switches] <input-image> <output>
  decompress:  python -m nblic_tpu_torch -d [-switches] <input> <output-image>
  switches:
    -v / -V      verbose / verbose with the native runtime's row progress
    -n<number>   near: 0 lossless (default), k > 0 near-lossless (max error k)
    -e<number>   effort: 0 (Q0.2) .. 3; with --tiled 0 or 1 (profile 1),
                 2 (profile 2: per-tile least squares), 3 (profile 3: adaptive strips)
    -t           multithread native effort-0 encode
    --tiled      the tile-parallel NBTC container
    --backend=B  'torch' (device engines, default) or 'native' (C++ host runtime)
    --device=D   torch device, default cuda
    --tile-h=N / --tile-w=N   NBTC tile geometry (default 64x64)
"""


def parse_args(argv: list[str]) -> dict:
    opts = {"decompress": None, "near": 0, "effort": 1, "verbose": 0, "threads": 0,
            "tiled": False, "backend": "torch", "device": "cuda", "tile_h": 64,
            "tile_w": 64, "files": []}
    for arg in argv:
        if arg.startswith("--"):
            key, _, value = arg[2:].partition("=")
            if key == "tiled":
                opts["tiled"] = True
            elif key in ("device", "backend"):
                opts[key] = value
            elif key in ("tile-h", "tile-w"):
                opts[key.replace("-", "_")] = int(value)
            else:
                raise ValueError(f"unknown option --{key}")
        elif arg.startswith("-") and len(arg) > 1:
            for k, ch in enumerate(arg[1:], 1):
                if ch in "cC":
                    opts["decompress"] = False
                elif ch in "dD":
                    opts["decompress"] = True
                elif ch == "v":
                    opts["verbose"] = max(opts["verbose"], 1)
                elif ch == "V":
                    opts["verbose"] = 2
                elif ch in "tT":
                    opts["threads"] = -1  # automatic
                elif ch in "eE" and arg[k + 1 : k + 2].isdigit():
                    opts["effort"] = int(arg[k + 1])
                elif ch in "nN":
                    opts["near"] = int(re.match(r"\d*", arg[k + 1 :]).group() or 0)
                elif not ch.isdigit():
                    raise ValueError(f"unknown switch -{ch}")
        else:
            opts["files"].append(arg)
    return opts


def main(argv: list[str] | None = None) -> int:
    try:
        opts = parse_args(sys.argv[1:] if argv is None else argv)
    except ValueError as exc:
        print(f"  ***Error : {exc}")
        print(USAGE)
        return -1
    if opts["decompress"] is None or len(opts["files"]) != 2:
        print(USAGE)
        return -1
    src, dst = opts["files"]
    t0 = time.time()
    try:
        if opts["verbose"] >= 2 and opts["backend"] == "native" and not opts["tiled"]:
            from . import runtime

            runtime.set_verbose(opts["verbose"])
        if not opts["decompress"]:
            img = imageio.load_image(src)
            if opts["tiled"]:
                stream = api.compress_tiled(
                    img, near=opts["near"], effort=opts["effort"], tile_h=opts["tile_h"],
                    tile_w=opts["tile_w"], device=opts["device"],
                )
            else:
                stream = api.compress(
                    img, near=opts["near"], effort=opts["effort"], backend=opts["backend"],
                    device=opts["device"], n_threads=opts["threads"],
                )
            with open(dst, "wb") as f:
                f.write(stream)
            if opts["verbose"]:
                h, w = img.shape
                print(f"  effort             = {opts['effort']}")
                print(f"  near               = {opts['near']}")
                print(f"  output size        = {len(stream)} B")
                print(f"  compression bpp    = {8.0 * len(stream) / (w * h):.5f}")
        else:
            with open(src, "rb") as f:
                stream = f.read()
            img = api.decompress(stream, backend=opts["backend"], device=opts["device"])
            imageio.save_image(dst, img)
        if opts["verbose"]:
            px = img.shape[0] * img.shape[1]
            dt = time.time() - t0
            print(f"  image              = {img.shape[1]} x {img.shape[0]}")
            print(f"  time               = {dt:.3f} s ({px / dt / 1e6:.2f} MPix/s)")
    except (ValueError, RuntimeError, OSError, NotImplementedError) as exc:
        print(f"  ***Error : {exc}")
        return -1
    return 0
