"""Effort 3 through the port's entry points, against nblic_tpu.

``tiled.encode`` / ``encode_batch`` / ``encode_batches`` /
``encode_corpus``, ``api.compress_tiled`` and the CLI's ``-c --tiled -e3``
write the JAX package's ``tiled.encode(img, effort=3)`` bytes (profile 3 at
the default strip height, clamped to the image), and nblic_tpu's strip
decoder reads a port container back pixel-exact.
"""

import numpy as np
import pytest
import torch

from nblic_tpu.models import strips as j_strips
from nblic_tpu.models import tiled as j_tiled
from nblic_tpu_torch import api, cli
from nblic_tpu_torch.models import strips, tiled
from nblic_tpu_torch.utils import imageio
from nblic_tpu_torch.utils.synth import synth_image

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _oracle_untuned():
    # nblic_tpu reads its tune from NBLIC_P3_* at import; the oracle must
    # run the default contract
    assert j_strips.TUNE == j_strips.TUNE_V4 and j_strips.AVP_N == 10


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(51)
    # two orientations of one portrait shape, and a square image
    return [synth_image(rng, 48, 64), synth_image(rng, 64, 48), synth_image(rng, 40, 40)]


@pytest.fixture(scope="module")
def jax_bytes(images):
    return [j_tiled.encode(im, effort=3) for im in images[:2]]


def test_entry_points_write_jax_bytes(images, jax_bytes, tmp_path):
    img = images[0]
    want = jax_bytes[0]
    assert want[10] == 3
    assert tiled.encode(img, effort=3, tile_h=16, tile_w=16, device="cpu") == want
    assert api.compress_tiled(img, effort=3, device="cpu") == want
    assert tiled.encode_batch(images[:2], effort=4, device="cpu") == jax_bytes
    assert tiled.encode_batches([images[:1], images[1:2]], effort=3,
                                device="cpu") == [[jax_bytes[0]], [jax_bytes[1]]]
    assert strips.encode_batches([images[:2]], device="cpu") == [jax_bytes]
    corpus = tiled.encode_corpus(images, effort=3, device="cpu")
    assert corpus[:2] == jax_bytes
    assert corpus[2] == strips.encode(images[2], device="cpu")
    src, dst = str(tmp_path / "in.pgm"), str(tmp_path / "out.nbtc")
    imageio.save_image(src, img)
    assert cli.main(["-c", "--tiled", "-e3", "--device=cpu", src, dst]) == 0
    with open(dst, "rb") as f:
        assert f.read() == want


def test_jax_decodes_port_container(images, jax_bytes):
    port = strips.encode(images[1], device="cpu")
    assert port == jax_bytes[1]
    np.testing.assert_array_equal(j_strips.decode(port), images[1])
