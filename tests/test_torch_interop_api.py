"""The port's interop engines on hostile streams, its API and its CLI.

Truncated and garbage Q0.2 and NBLIC0.3 streams decode to the JAX engine's
pixels, or raise where it raises; an encode past its buffer raises.  Then
``api.compress`` / ``decompress`` under both backends (the device engines
on the CPU here, and the port's native runtime copy), the refusal of a
missing card with no fallback, and the CLI without ``--tiled``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nblic_tpu import runtime as j_runtime
from nblic_tpu.models import nblic as j_nblic
from nblic_tpu.models import qnblic as j_qnblic
from nblic_tpu_torch import api, runtime
from nblic_tpu_torch.models import nblic, qnblic
from nblic_tpu_torch.utils import imageio

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = np.random.default_rng(1234).integers(0, 256, (8, 8), dtype=np.uint8)


def _err(a, b) -> int:
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def test_nblic_truncated_and_garbage_streams_match_jax():
    img = np.random.default_rng(0).integers(0, 256, (4, 5), dtype=np.uint8)
    stream = j_runtime.n_encode(img, near=0, effort=1)
    rng = np.random.default_rng(1)
    bad = [stream[:-1], stream[:-3]]
    bad += [stream[:16] + rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (1, 3, 40)]
    for b in bad:  # reads past the end give 0; the unary walks stop at the guard
        np.testing.assert_array_equal(nblic.decode(b, device="cpu"), j_nblic.decode(b))
    tiny = np.array([[9, 200]], np.uint8)
    cut = j_runtime.n_encode(tiny, near=0, effort=1)[:17]
    np.testing.assert_array_equal(nblic.decode(cut, device="cpu"), j_nblic.decode(cut))
    head = bytearray(stream)
    for at, value in ((15, 0), (15, 4), (10, 0), (14, 0)):  # effort 0, 4; height 0; k_step 0
        head[at] = value
        with pytest.raises((ValueError, ZeroDivisionError)):
            j_nblic.decode(bytes(head))
        with pytest.raises(ValueError):
            nblic.decode(bytes(head), device="cpu")
        head[at] = stream[at]
    for b in (stream[:16], stream[:12]):  # no payload; a cut header
        with pytest.raises((ValueError, IndexError)):
            j_nblic.decode(b)
        with pytest.raises(ValueError):
            nblic.decode(b, device="cpu")


def test_q_truncated_and_garbage_streams_match_jax():
    img = np.random.default_rng(2).integers(0, 256, (6, 7), dtype=np.uint8)
    stream = j_runtime.q_encode(img, n_threads=1)
    rng = np.random.default_rng(3)
    body = len(stream) // 2 * 2
    # (one truncation, then garbage of the stream's length: the JAX decoder
    # compiles once for each payload length)
    bad = [stream[:body - 20], stream[:-2] + rng.integers(0, 256, 2, dtype=np.uint8).tobytes()]
    for b in bad:  # reads past the end take the last word
        np.testing.assert_array_equal(qnblic.decode(b, device="cpu"), j_qnblic.decode(b))
    for b in (stream[:30], stream[:-1], stream[:6], b"Q0.2" + bytes(4)):
        # a cut histogram, an odd length, a cut header, a zero size
        with pytest.raises(ValueError):
            j_qnblic.decode(b)
        with pytest.raises(ValueError):
            qnblic.decode(b, device="cpu")


def test_encode_past_capacity_raises(monkeypatch):
    img = np.random.default_rng(4).integers(0, 256, (6, 6), dtype=np.uint8)
    monkeypatch.setattr(nblic, "capacity", lambda h, w: 8)
    with pytest.raises(ValueError, match="capacity"):
        nblic.encode(img, device="cpu")


def test_api_both_backends():
    img = IMG
    for near, effort in ((0, 0), (0, 1), (2, 0), (0, 3)):
        native = api.compress(img, near=near, effort=effort, backend="native")
        assert native == api.compress(img, near=near, effort=effort, device="cpu")
        assert native[:4] == (b"Q0.2" if near == effort == 0 else b"NBLI")
        for backend in ("native", "torch"):
            dec = api.decompress(native, backend=backend, device="cpu")
            assert _err(dec, img) <= near
    assert api.compress(img, effort=0, backend="native", n_threads=4) == \
        api.compress(img, effort=0, device="cpu")
    tiled = api.compress_tiled(img, device="cpu", tile_h=8, tile_w=8)
    np.testing.assert_array_equal(api.decompress(tiled, backend="native", device="cpu"), img)
    for kwargs in ({"backend": "jax"}, {"near": 10}, {"effort": 4}):
        with pytest.raises(ValueError):
            api.compress(img, device="cpu", **kwargs)
    with pytest.raises(ValueError, match="backend"):
        api.decompress(native, backend="jax", device="cpu")
    with pytest.raises(ValueError):
        api.compress(np.zeros((0, 5), np.uint8), device="cpu")


def test_torch_backend_on_a_missing_card_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    img = IMG
    stream = runtime.q_encode(img, n_threads=1)

    def no_fallback(*args, **kwargs):
        raise AssertionError("fell back to the native runtime")

    for name in ("q_encode", "q_decode", "n_encode", "n_decode"):
        monkeypatch.setattr(runtime, name, no_fallback)
    for effort in (0, 1):
        with pytest.raises(RuntimeError, match="cuda"):
            api.compress(img, effort=effort)
    with pytest.raises(RuntimeError, match="cuda"):
        api.decompress(stream)


def test_cli_roundtrip_without_tiled(tmp_path):
    # every command line runs in one fresh process, through the CLI's main
    img = IMG
    src, out, dec = (str(tmp_path / n) for n in ("in.pgm", "out.nblic", "dec.bmp"))
    imageio.save_image(src, img)
    runs = [
        (["-c", "--device=cpu", src, out + "1"], 0, 1, {}),
        (["-cn2e2V", "--device=cpu", src, out + "2"], 2, 2, {}),
        (["-e0", "-t", "-c", "--backend=native", src, out + "3"], 0, 0, {"n_threads": -1}),
    ]
    argvs = [r[0] for r in runs]
    argvs += [["-d", "--device=cpu", out + str(k), dec + str(k)] for k in (1, 2, 3)]
    argvs += [["-cV", "--backend=native", src, out + "4"], ["-c", "--backend=jax", src, out]]
    code = ("import json, sys\nfrom nblic_tpu_torch import cli\n"
            "print(json.dumps([cli.main(a) for a in json.loads(sys.argv[1])]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code, json.dumps(argvs)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    rcs = json.loads(res.stdout.splitlines()[-1])
    assert rcs == [0] * 7 + [-1], res.stdout
    log = res.stdout + res.stderr
    assert "output size" in log and "encoding row" in log and "***Error" in log, log
    for k, (_, near, effort, native_args) in enumerate(runs, 1):
        with open(out + str(k), "rb") as f:
            assert f.read() == api.compress(img, near=near, effort=effort, backend="native",
                                            **native_args), k
        assert _err(imageio.load_image(dec + str(k)), img) <= near
