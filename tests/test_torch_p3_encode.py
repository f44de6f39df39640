"""The port's profile-3 containers against nblic_tpu.models.strips, TUNE_V4.

Byte-identical containers at strip heights 16 and 64, for a same-shape
batch mixing orientations (one image transposed to portrait), an odd
height (edge-padded strips) and several strips; the port's decoder reads
each of nblic_tpu's containers back to the image.  Synthetic images only.
"""

import numpy as np
import pytest
import torch

from nblic_tpu.models import strips as j_strips
from nblic_tpu.utils.container import NbtcHeader
from nblic_tpu_torch.models import strips
from nblic_tpu_torch.utils.synth import synth_image

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _oracle_untuned():
    # nblic_tpu reads its tune from NBLIC_P3_* at import; the oracle must
    # run the default contract
    assert j_strips.TUNE == j_strips.TUNE_V4 and j_strips.AVP_N == 10
    assert tuple(strips.TUNE) == tuple(strips.TUNE_V4) == tuple(j_strips.TUNE_V4)


def test_batch_mixed_orientation_th16():
    rng = np.random.default_rng(31)
    imgs = [synth_image(rng, 48, 64), synth_image(rng, 64, 48)]
    port = strips.encode_batch(imgs, th=16, device="cpu")
    assert port == j_strips.encode_batch(imgs, th=16)
    hdrs = [NbtcHeader.from_bytes(c) for c in port]
    assert [h.tile_w & 1 for h in hdrs] == [1, 0] and hdrs[0].n_tiles == 4
    assert strips.encode(imgs[0], th=16, device="cpu") == port[0]
    for got, img in zip(strips.decode_batch(port, device="cpu"), imgs):
        np.testing.assert_array_equal(got, img)


def test_odd_height_padded_strips_th16():
    rng = np.random.default_rng(32)
    img = synth_image(rng, 45, 40)
    img[:, :8] = rng.integers(0, 256, size=(45, 8))  # a noisy band: escapes
    port = strips.encode(img, th=16, device="cpu")
    assert port == j_strips.encode(img, th=16)
    assert NbtcHeader.from_bytes(port).n_tiles == 3
    np.testing.assert_array_equal(strips.decode(port, device="cpu"), img)


def test_multi_strip_th64():
    img = synth_image(np.random.default_rng(33), 80, 48)
    port = strips.encode(img, th=64, device="cpu")
    assert port == j_strips.encode(img, th=64)
    hdr = NbtcHeader.from_bytes(port)
    assert (hdr.tile_h, hdr.n_tiles) == (64, 2)
    np.testing.assert_array_equal(strips.decode(port, device="cpu"), img)
