"""Profile-3 bytes nblic_tpu's encoder never wrote, which its decoder still
reads: the port's decode equals nblic_tpu's.

From the committed fixtures of ``test_torch_p3_fixtures.py``: the near-2
container with a payload tail of random bytes (garbage pixels of the
image's shape), and the legacy container with the header's feature count
cleared (a container from before the count, read with 6 AVP features).
The near-2 fixture's pixels are held to nblic_tpu's decode here too.
"""

import numpy as np
import pytest
import torch
from test_torch_p3_fixtures import load_fixture, with_header

from nblic_tpu.models import strips as j_strips
from nblic_tpu_torch.models import strips
from nblic_tpu_torch.utils.container import NbtcHeader

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _oracle_untuned():
    # nblic_tpu reads its tune from NBLIC_P3_* at import; the oracle must
    # run the default contract
    assert j_strips.TUNE == j_strips.TUNE_V4 and j_strips.AVP_N == 10


def _garbage():
    near2, pixels = load_fixture("near2")
    garbage = bytearray(near2)
    garbage[-40:] = np.random.default_rng(73).integers(0, 256, size=40,
                                                       dtype=np.uint8).tobytes()
    return bytes(garbage), pixels.shape


def _six_features():
    legacy, pixels = load_fixture("legacy")
    six = with_header(legacy, tile_w=NbtcHeader.from_bytes(legacy).tile_w & 0xF)
    assert strips._parse(six)[0][5] == 6
    return six, pixels.shape


def test_near2_fixture_is_nblic_tpu_decode():
    """The committed near-2 pixels are nblic_tpu's decode of the committed
    container (its program then serves the garbage form below)."""
    near2, pixels = load_fixture("near2")
    np.testing.assert_array_equal(pixels, j_strips.decode(near2))


@pytest.mark.parametrize("form", [_garbage, _six_features], ids=["garbage", "six-features"])
def test_decoder_only_forms_match_jax(form):
    stream, shape = form()
    got = strips.decode(stream, device="cpu")
    assert got.shape == shape
    np.testing.assert_array_equal(got, j_strips.decode(stream))
