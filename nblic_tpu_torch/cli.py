"""Command-line driver of the port: the ``--tiled`` path of nblic_tpu's CLI.

Usage:
    python -m nblic_tpu_torch -c --tiled [--device=cuda] in.{bmp,pgm,pnm} out.nbtc
    python -m nblic_tpu_torch -d [--device=cuda] in.nbtc out.{bmp,pgm,pnm}

Switches: ``-v`` verbose, ``-n<int>`` near (0 so far), ``-e<digit>`` effort
(0 or 1 so far),
``--tile-h=N`` / ``--tile-w=N`` tile geometry (default 64x64).
"""

from __future__ import annotations

import re
import sys
import time

from nblic_tpu.utils import imageio

from . import api

USAGE = """\
nblic_tpu_torch: the PyTorch / CUDA port of the NBTC tiled codec
  compress:    python -m nblic_tpu_torch -c --tiled [-switches] <input-image> <output.nbtc>
  decompress:  python -m nblic_tpu_torch -d [-switches] <input.nbtc> <output-image>
  switches:
    -v           verbose
    -n<number>   near: 0 (lossless; near-lossless encode is not ported yet)
    -e<number>   effort: 0 or 1 (profile 1)
    --tiled      the tile-parallel NBTC container (the only one ported)
    --device=D   torch device, default cuda
    --tile-h=N / --tile-w=N   NBTC tile geometry (default 64x64)
"""


def parse_args(argv: list[str]) -> dict:
    opts = {"decompress": None, "near": 0, "effort": 1, "verbose": False, "tiled": False,
            "device": "cuda", "tile_h": 64, "tile_w": 64, "files": []}
    for arg in argv:
        if arg.startswith("--"):
            key, _, value = arg[2:].partition("=")
            if key == "tiled":
                opts["tiled"] = True
            elif key == "device":
                opts["device"] = value
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
                elif ch in "vV":
                    opts["verbose"] = True
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
        if not opts["decompress"]:
            if not opts["tiled"]:
                raise NotImplementedError(
                    "the interop containers are not ported yet: ROADMAP Queue 1 "
                    "item 13 (pass --tiled)"
                )
            img = imageio.load_image(src)
            stream = api.compress_tiled(
                img, near=opts["near"], effort=opts["effort"], tile_h=opts["tile_h"],
                tile_w=opts["tile_w"], device=opts["device"],
            )
            with open(dst, "wb") as f:
                f.write(stream)
            if opts["verbose"]:
                h, w = img.shape
                print(f"  output size        = {len(stream)} B")
                print(f"  compression bpp    = {8.0 * len(stream) / (w * h):.5f}")
        else:
            with open(src, "rb") as f:
                stream = f.read()
            img = api.decompress(stream, device=opts["device"])
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
