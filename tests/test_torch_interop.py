"""The port's interop engines (Q0.2, NBLIC0.3) against nblic_tpu's.

On the CPU the port's ``models/qnblic`` and ``models/nblic`` write the
containers ``nblic_tpu.runtime`` writes (effort 0; effort 1 at near 0, 2,
5 and 9; efforts 2 and 3 at near 0, effort 2 at near 2) and
``nblic_tpu.models.qnblic`` / ``nblic`` write (effort 0 and 1; efforts 2
and 3 on one tiny image in a fresh process, as XLA:CPU's x64 scan compiles
are kept out of long-lived test processes).  Each package decodes the
other's containers, exactly or within near.  (Hostile streams, the API
and the CLI: ``test_torch_interop_api.py``.)  The walks cost ~1-3 ms a
pixel on this CPU (effort 0 decode, effort 1), ~5 ms at efforts 2-3: the
NBLIC0.3 cases keep to the small test images.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from conftest import make_test_images

from nblic_tpu import runtime as j_runtime
from nblic_tpu.models import nblic as j_nblic
from nblic_tpu.models import qnblic as j_qnblic
from nblic_tpu_torch.models import nblic, qnblic

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGES = make_test_images(np.random.default_rng(1234))
# 1x1, 1x7, 5x1, 8x8, 23x17 (random), 16x16 flat 0 and 255: 980 pixels
SMALL = [IMAGES[k] for k in (0, 1, 2, 3, 4, 6, 7)]


def _err(a, b) -> int:
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def test_q_encode_equals_runtime_and_jax():
    for img in IMAGES:
        stream = qnblic.encode(img, device="cpu")
        assert stream == j_runtime.q_encode(img, n_threads=1), img.shape
        assert stream == j_qnblic.encode(img), img.shape


def test_q_decode_both_ways():
    for img in IMAGES[:5] + IMAGES[6:8]:
        stream = j_runtime.q_encode(img, n_threads=1)
        np.testing.assert_array_equal(qnblic.decode(stream, device="cpu"), img)
    for img in (IMAGES[3], IMAGES[6]):
        stream = qnblic.encode(img, device="cpu")
        np.testing.assert_array_equal(j_qnblic.decode(stream), img)
        np.testing.assert_array_equal(j_runtime.q_decode(stream), img)


@pytest.mark.parametrize("effort,near", [(1, 0), (1, 2), (1, 5), (1, 9), (2, 0), (3, 0),
                                         (2, 2)])
def test_nblic_equals_runtime_both_ways(effort, near):
    imgs = SMALL if effort == 1 else SMALL[:5]
    for img in imgs:
        stream = nblic.encode(img, near=near, effort=effort, device="cpu")
        assert stream == j_runtime.n_encode(img, near=near, effort=effort), img.shape
        dec = nblic.decode(stream, device="cpu")
        ref, got_near, got_effort = j_runtime.n_decode(stream)
        np.testing.assert_array_equal(dec, ref)
        assert (got_near, got_effort) == (near, effort)
        assert _err(dec, img) <= near


@pytest.mark.parametrize("near", [0, 2])
def test_nblic_effort1_equals_jax_engine(near):
    for img in (IMAGES[3], IMAGES[4]):
        stream = nblic.encode(img, near=near, device="cpu")
        assert stream == j_nblic.encode(img, near=near), img.shape
        np.testing.assert_array_equal(j_nblic.decode(stream), nblic.decode(stream, device="cpu"))


def test_nblic_efforts_2_3_equal_jax_engine_in_a_fresh_process():
    img = IMAGES[3]  # 8x8
    code = (
        "import json, sys, numpy as np\n"
        "from nblic_tpu.models import nblic\n"
        "img = np.array(json.loads(sys.argv[1]), np.uint8)\n"
        "out = []\n"
        "for effort, near in ((3, 0), (2, 2)):\n"
        "    c = nblic.encode(img, near=near, effort=effort)\n"
        "    out.append([c.hex(), nblic.decode(c).tolist()])\n"
        "print(json.dumps(out))\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code, json.dumps(img.tolist())], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    for (effort, near), (hexed, pixels) in zip(((3, 0), (2, 2)),
                                               json.loads(res.stdout.splitlines()[-1])):
        stream = nblic.encode(img, near=near, effort=effort, device="cpu")
        assert stream == bytes.fromhex(hexed), (effort, near)
        np.testing.assert_array_equal(nblic.decode(stream, device="cpu"),
                                      np.array(pixels, np.uint8))
