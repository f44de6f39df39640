"""The port's group decoder against nblic_tpu.

The plain decoder (``decode_groups`` on CPU tensors) decodes containers that
``nblic_tpu.models.tiled.encode`` wrote, pixel-exact, and its tiles equal the
Pallas decode kernel's in interpret mode, pad lanes included.  The CUDA
kernel is held against the plain decoder in test_torch_cuda.py.  Integer
math: tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from nblic_tpu.models import tiled as j_tiled
from nblic_tpu.ops import pallas_decode
from nblic_tpu_torch.convert import streams_from_parsed, tables_from_numpy
from nblic_tpu_torch.ops import decode

CASES = {
    "70x90-t16": ((70, 90), 16, 0),
    "96x104-t8-multigroup": ((96, 104), 8, 0),
    "48x64-t16-near2": ((48, 64), 16, 2),
}


def _inputs(parsed, device):
    bias, hist_n, acc = tables_from_numpy(parsed.bias, parsed.hist_n, parsed.acc, device)
    words, n_active = streams_from_parsed([parsed], device)
    hdr = parsed.hdr
    return (words, n_active, bias, hist_n, acc, hdr.tile_h, hdr.tile_w, hdr.near,
            parsed.group_size)


def _pallas_tiles(p):
    hdr = p.hdr
    wmax = j_tiled._bucket(int(p.counts.max()))
    return np.asarray(pallas_decode.decode_groups_pallas(
        jnp.asarray(p.stream_matrix32((wmax + 1) // 2)), jnp.asarray(p.n_active()),
        jnp.asarray(p.bias)[None], jnp.asarray(p.hist_n)[None],
        jnp.asarray(p.acc)[None], jnp.asarray(p.weight_cols()),
        hdr.tile_h, hdr.tile_w, hdr.near, p.group_size, hdr.profile, True,
    ))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_decoder_matches_jax(case):
    shape, t, near = CASES[case]
    img = np.random.default_rng(len(case)).integers(0, 256, size=shape, dtype=np.uint8)
    stream = j_tiled.encode(img, near=near, tile_h=t, tile_w=t)
    p = j_tiled._Parsed(stream)
    if case.endswith("multigroup"):
        assert len(p.counts) > 1
    launches = decode.decode_groups.launches
    tiles = decode.decode_groups(*_inputs(p, "cpu"))
    assert decode.decode_groups.launches == launches  # CPU tensors: plain version
    np.testing.assert_array_equal(tiles.numpy(), _pallas_tiles(p))
    flat = tiles.numpy().reshape(-1, t, t)[: p.hdr.n_tiles]
    dec = j_tiled.from_tiles(flat, *shape, t, t)
    assert np.abs(dec.astype(int) - img.astype(int)).max() <= near
    np.testing.assert_array_equal(dec, j_tiled.decode(stream))


def test_decode_groups_rejects_bad_inputs():
    img = np.random.default_rng(0).integers(0, 256, size=(16, 16), dtype=np.uint8)
    args = list(_inputs(j_tiled._Parsed(j_tiled.encode(img, tile_h=8, tile_w=8)), "cpu"))
    short = args.copy()
    short[0] = args[0][:, :100]  # narrower than the 2 g head words
    with pytest.raises(ValueError):
        decode.decode_groups(*short)
    tables = args.copy()
    tables[2] = args[2][:, :100]
    with pytest.raises(ValueError):
        decode.decode_groups(*tables)
