"""More forms of the port's profile-3 near-lossless encode.

A 48-row strip against nblic_tpu's chunked path (its ``SEG_ROWS`` cut to
16: three programs with the carry threaded between them; the port walks
the strip in one go); near 2 under the contracts derived from TUNE_MAX
(per-symbol counters kept) and TUNE_V4S (no mixing, 64 segments, 10 unary
layers), both packages' ``TUNE`` monkeypatched; and every entry point at
effort 3 and ``near`` > 0 routed to ``strips.encode_batch``.  The port
decodes each container within ``near``.  Tolerance 0 against nblic_tpu.
"""

import numpy as np
import pytest
import torch

from nblic_tpu.models import strips as j_strips
from nblic_tpu_torch import api, cli
from nblic_tpu_torch.models import strips, tiled
from nblic_tpu_torch.utils import imageio
from nblic_tpu_torch.utils.container import NbtcHeader
from nblic_tpu_torch.utils.synth import synth_image

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _oracle_untuned():
    # nblic_tpu reads its tune from NBLIC_P3_* at import; the oracle must
    # start from the default contract
    assert j_strips.TUNE == j_strips.TUNE_V4 and j_strips.AVP_N == 10


def _max_err(got, img) -> int:
    return int(np.abs(got.astype(np.int32) - img).max())


def test_tall_strip_matches_jax_chunked(monkeypatch):
    img = synth_image(np.random.default_rng(121), 48, 12)
    monkeypatch.setattr(j_strips, "SEG_ROWS", 16)
    port = strips.encode(img, th=48, near=2, device="cpu")
    assert port == j_strips.encode(img, th=48, near=2)
    hdr = NbtcHeader.from_bytes(port)
    assert (hdr.tile_h, hdr.n_tiles) == (48, 1)
    assert 0 < _max_err(strips.decode(port, device="cpu"), img) <= 2


@pytest.mark.parametrize("name,recorded", [
    ("TUNE_MAX", dict(sym_cnt=1, mix_e=1, n_seg=32, n_unary=13)),
    ("TUNE_V4S", dict(sym_cnt=0, mix_e=0, n_seg=64, n_unary=10))])
def test_near_tune_contracts(name, recorded, monkeypatch):
    monkeypatch.setattr(j_strips, "TUNE", getattr(j_strips, name))
    monkeypatch.setattr(strips, "TUNE", getattr(strips, name))
    img = synth_image(np.random.default_rng(122), 32, 20)
    port = strips.encode(img, th=16, near=2, device="cpu")
    assert port == j_strips.encode(img, th=16, near=2)
    tune = strips._parse(port)[0][7]
    assert {k: getattr(tune, k) for k in recorded} == recorded
    assert not (tune.seg_bias or tune.seg_map or tune.seg_stats or tune.w_pred)
    assert 0 < _max_err(strips.decode(port, device="cpu"), img) <= 2


def test_entry_points_route_near_effort3(tmp_path):
    rng = np.random.default_rng(123)
    img = synth_image(rng, 12, 16)  # landscape: stored transposed
    pair = [img, synth_image(rng, 16, 12)]
    want = strips.encode_batch([img], near=2, device="cpu")[0]
    want_pair = strips.encode_batch(pair, near=2, device="cpu")
    assert tiled.encode(img, near=2, effort=3, device="cpu") == want
    assert api.compress_tiled(img, near=2, effort=3, device="cpu") == want
    assert tiled.encode_batch(pair, near=2, effort=4, device="cpu") == want_pair
    assert tiled.encode_batches([pair, [img]], near=2, effort=3, device="cpu") \
        == [want_pair, [want]]
    assert tiled.encode_corpus([pair[1], img], near=2, effort=3, device="cpu") \
        == want_pair[::-1]
    src, enc, dec = (str(tmp_path / n) for n in ("in.pgm", "out.nbtc", "out.pgm"))
    imageio.save_image(src, img)
    assert cli.main(["-c", "--tiled", "-e3", "-n2", "--device=cpu", src, enc]) == 0
    with open(enc, "rb") as f:
        assert f.read() == want
    hdr = NbtcHeader.from_bytes(want)
    assert (hdr.profile, hdr.near, hdr.tile_w & 1) == (3, 2, 1)
    assert cli.main(["-d", "--device=cpu", enc, dec]) == 0
    assert 0 < _max_err(imageio.load_image(dec), img) <= 2
