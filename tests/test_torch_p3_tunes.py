"""The port's profile-3 containers under every named replay contract.

TUNE_V1 and TUNE_V2 (legacy, whole-row adaptation), TUNE_MAX (per-symbol
counters) and TUNE_V4S (the serving contract: segment-held AVP statistics
and quantized-weight prediction), byte-identical to nblic_tpu at strip
height 16; the port's decoder reads each back to the image, and the
TUNE_V1 and TUNE_V2 ones also with their Tune block cut out (legacy
containers: the version bit names the contract).  Both packages' ``TUNE``
is monkeypatched, as nblic_tpu's own tests select a contract.
"""

import numpy as np
import pytest
import torch
from test_torch_p3_fixtures import strip_tune_block

from nblic_tpu.models import strips as j_strips
from nblic_tpu.utils.container import NbtcHeader
from nblic_tpu_torch.models import strips
from nblic_tpu_torch.utils.synth import synth_image

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _oracle_untuned():
    # nblic_tpu reads its tune from NBLIC_P3_* at import; the oracle must
    # start from the default contract
    assert j_strips.TUNE == j_strips.TUNE_V4 and j_strips.AVP_N == 10


CASES = {
    # name: (image shape, seed); 80 columns give TUNE_V4S 40 segments of 2
    "TUNE_V1": ((48, 64), 41),
    "TUNE_V2": ((64, 48), 42),
    "TUNE_MAX": ((45, 40), 43),
    "TUNE_V4S": ((80, 80), 44),
}


@pytest.mark.parametrize("name", list(CASES))
def test_tune_containers_byte_identical(name, monkeypatch):
    shape, seed = CASES[name]
    assert tuple(getattr(strips, name)) == tuple(getattr(j_strips, name))
    monkeypatch.setattr(j_strips, "TUNE", getattr(j_strips, name))
    monkeypatch.setattr(strips, "TUNE", getattr(strips, name))
    img = synth_image(np.random.default_rng(seed), *shape)
    port = strips.encode(img, th=16, device="cpu")
    assert port == j_strips.encode(img, th=16)
    legacy_bit = NbtcHeader.from_bytes(port).tile_w & 2
    assert legacy_bit == (0 if name == "TUNE_V1" else 2)
    if name in ("TUNE_V1", "TUNE_V2"):
        # the legacy form parses to the same plane, contract and streams,
        # so one decode covers both
        legacy = strip_tune_block(port)
        assert not NbtcHeader.from_bytes(legacy).tile_w & 4
        (geom, bias, lens, words), parsed = strips._parse(legacy), strips._parse(port)
        assert geom == parsed[0] and geom[7] == getattr(strips, name) and bias is None
        assert np.array_equal(lens, parsed[2]) and np.array_equal(words, parsed[3])
        port = legacy
    np.testing.assert_array_equal(strips.decode(port, device="cpu"), img)
