"""Profile-3 decode through the port's entry points.

``tiled.decode`` / ``decode_batch`` / ``decode_batches``,
``api.decompress`` / ``decompress_tiled`` and the CLI's ``-d`` send a
profile-3 container to ``strips.decode_batch``, as nblic_tpu's
``tiled.decode*`` do, and give back the image; a batch mixing profile 3
with profile 1 raises ``ValueError`` in either order.  The containers are
the port's own (byte-identical to nblic_tpu's, ``test_torch_p3_routing.py``).
"""

import numpy as np
import pytest
import torch

from nblic_tpu_torch import api, cli
from nblic_tpu_torch.models import strips, tiled
from nblic_tpu_torch.utils import imageio
from nblic_tpu_torch.utils.synth import synth_image

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(97)
    imgs = [synth_image(rng, 16, 16), synth_image(rng, 16, 16)]
    return imgs, [api.compress_tiled(im, effort=3, device="cpu") for im in imgs]


def test_tiled_routes_decode_profile3(pair):
    imgs, conts = pair
    assert [c[10] for c in conts] == [3, 3]
    np.testing.assert_array_equal(tiled.decode(conts[0], device="cpu"), imgs[0])
    for got, img in zip(tiled.decode_batch(conts, device="cpu"), imgs):
        np.testing.assert_array_equal(got, img)
    got = tiled.decode_batches([conts[1:], conts[:1]], device="cpu")
    np.testing.assert_array_equal(got[0][0], imgs[1])
    np.testing.assert_array_equal(got[1][0], imgs[0])
    assert strips.decode_batch([], device="cpu") == []


def test_api_and_cli_decode_profile3(pair, tmp_path):
    imgs, conts = pair
    np.testing.assert_array_equal(api.decompress(conts[0], device="cpu"), imgs[0])
    np.testing.assert_array_equal(api.decompress_tiled(conts[1], device="cpu"), imgs[1])
    src, dst = str(tmp_path / "in.nbtc"), str(tmp_path / "out.pgm")
    with open(src, "wb") as f:
        f.write(conts[0])
    assert cli.main(["-d", "--device=cpu", src, dst]) == 0
    np.testing.assert_array_equal(imageio.load_image(dst), imgs[0])


def test_mixed_profile_batch_raises(pair):
    imgs, conts = pair
    p1 = tiled.encode(imgs[0], tile_h=8, tile_w=8, device="cpu")
    for batch in ([p1, conts[0]], [conts[0], p1]):
        with pytest.raises(ValueError, match="mixes profile 3"):
            tiled.decode_batch(batch, device="cpu")
        with pytest.raises(ValueError):
            tiled.decode_batches([batch], device="cpu")
    with pytest.raises(ValueError, match="not a profile-3 container"):
        strips.decode_batch([conts[0], p1], device="cpu")
