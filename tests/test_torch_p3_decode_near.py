"""The port's profile-3 decoder on nblic_tpu's near-lossless containers.

nblic_tpu's ``strips.encode(img, th=16, near=k)`` at k = 1 (one strip) and
k = 3 (three strips, an odd height): the port decodes each to exactly the
pixels nblic_tpu's decoder gives, within k of the image.  Near 2 is the
committed fixture of ``test_torch_p3_fixtures.py``.  Tolerance 0 against
nblic_tpu.
"""

import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("near,shape,n_strips", [(1, (16, 12), 1), (3, (45, 16), 3)])
def test_near_containers_match_jax(near, shape, n_strips):
    img = synth_image(np.random.default_rng(100 + near), *shape)
    cont = j_strips.encode(img, th=16, near=near)
    hdr = NbtcHeader.from_bytes(cont)
    assert (hdr.near, hdr.n_tiles) == (near, n_strips)
    want = j_strips.decode(cont)
    got = strips.decode(cont, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert 0 < np.abs(got.astype(np.int32) - img).max() <= near
