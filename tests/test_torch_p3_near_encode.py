"""The port's profile-3 near-lossless encoder against nblic_tpu.models.strips.

``strips.encode(img, th=16, near=k)`` byte-identical to nblic_tpu's at k = 1
(one strip), 3 (three strips, an odd height) and 9 (k_step clamped at 16);
the committed near-2 fixture rebuilt by the port alone; a landscape and a
portrait image as one ``encode_batch``, equal to nblic_tpu's batch and to
the port's singles.  The port decodes every container within ``near``.
Tolerance 0 against nblic_tpu.
"""

import numpy as np
import pytest
import torch
from test_torch_p3_fixtures import fixture_image, load_fixture

from nblic_tpu.models import strips as j_strips
from nblic_tpu_torch.models import strips
from nblic_tpu_torch.utils.container import NbtcHeader
from nblic_tpu_torch.utils.synth import synth_image

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _oracle_untuned():
    # nblic_tpu reads its tune from NBLIC_P3_* at import; the oracle must
    # run the default contract
    assert j_strips.TUNE == j_strips.TUNE_V4 and j_strips.AVP_N == 10
    assert tuple(strips.TUNE) == tuple(strips.TUNE_V4) == tuple(j_strips.TUNE_V4)


def _max_err(got, img) -> int:
    return int(np.abs(got.astype(np.int32) - img).max())


@pytest.mark.parametrize("near,shape,n_strips,k_step", [
    (1, (16, 12), 1, 5), (3, (45, 16), 3, 9), (9, (24, 20), 2, 16)])
def test_near_encode_matches_jax(near, shape, n_strips, k_step):
    img = synth_image(np.random.default_rng(100 + near), *shape)
    port = strips.encode(img, th=16, near=near, device="cpu")
    assert port == j_strips.encode(img, th=16, near=near)
    hdr = NbtcHeader.from_bytes(port)
    assert (hdr.profile, hdr.near, hdr.n_tiles) == (3, near, n_strips)
    assert strips._k_step(near) == k_step
    # the recorded contract: TUNE_V4 with the bias and mapper row-frozen
    tune = strips._parse(port)[0][7]
    assert tune == strips.TUNE_V4._replace(seg_bias=0, seg_map=0)
    assert 0 < _max_err(strips.decode(port, device="cpu"), img) <= near


def test_committed_near2_fixture_rebuilt():
    """The port alone writes nblic_tpu's committed near-2 container, which
    decodes to nblic_tpu's pixels."""
    stream, pixels = load_fixture("near2")
    port = strips.encode(fixture_image(), th=16, near=2, device="cpu")
    assert port == stream
    np.testing.assert_array_equal(strips.decode(port, device="cpu"), pixels)


def test_batch_matches_jax_and_singles():
    rng = np.random.default_rng(111)
    imgs = [synth_image(rng, 24, 32), synth_image(rng, 32, 24)]
    port = strips.encode_batch(imgs, th=16, near=2, device="cpu")
    assert port == j_strips.encode_batch(imgs, th=16, near=2)
    assert port == [strips.encode(im, th=16, near=2, device="cpu") for im in imgs]
    assert [NbtcHeader.from_bytes(c).tile_w & 1 for c in port] == [1, 0]
    errs = [_max_err(got, im) for got, im in zip(strips.decode_batch(port, device="cpu"), imgs)]
    assert max(errs) <= 2 and max(errs) > 0
