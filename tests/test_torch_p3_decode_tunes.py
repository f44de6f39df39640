"""The port's profile-3 decoder on nblic_tpu's containers under the seven
sub-row contract variants that nblic_tpu's own round-trip test names
(tests/test_strips.py::test_segment_adaptation_roundtrip): TUNE_V2 at 4
column segments with the bias, the mapper, the AVP statistics and the
counters adapting per segment or per symbol, predictor mixing, counter
dynamics overridden, and quantized-weight prediction.  Each container
nblic_tpu writes at strip height 16 decodes to the image.  Four run here,
the three with predictor mixing or quantized weights in
``test_torch_p3_decode_mixing.py``; the named contracts (TUNE_V1, V2, MAX,
V4S) decode in ``test_torch_p3_tunes.py`` beside the encoder's checks, and
TUNE_V4 in ``test_torch_p3_encode.py``, where nblic_tpu's containers are
already written.
"""

import numpy as np
import pytest
import torch

from nblic_tpu.models import strips as j_strips
from nblic_tpu_torch.models import strips
from nblic_tpu_torch.utils.synth import synth_image

torch.set_num_threads(1)

VARIANTS = {
    "seg4": dict(n_seg=4),
    "seg4-bias-map": dict(n_seg=4, seg_bias=1, seg_map=1),
    "seg4-stats": dict(n_seg=4, seg_bias=1, seg_map=1, seg_stats=1),
    "seg4-sym": dict(n_seg=4, seg_bias=1, seg_map=1, sym_cnt=1),
    "seg4-mix": dict(n_seg=4, mix_e=1),
    "seg4-sym-mix-cnt": dict(n_seg=4, seg_bias=1, seg_map=1, sym_cnt=1, mix_e=1,
                             cnt_init=16, cnt_halve=4096),
    "seg4-wpred": dict(n_seg=4, seg_bias=1, seg_map=1, seg_stats=1, w_pred=1),
}


@pytest.fixture(autouse=True)
def _oracle_untuned():
    # nblic_tpu reads its tune from NBLIC_P3_* at import; the oracle must
    # start from the default contract
    assert j_strips.TUNE == j_strips.TUNE_V4 and j_strips.AVP_N == 10


HERE = ("seg4", "seg4-bias-map", "seg4-sym", "seg4-stats")


def check_variant(name, monkeypatch):
    tune = j_strips.TUNE_V2._replace(**VARIANTS[name])
    monkeypatch.setattr(j_strips, "TUNE", tune)
    img = synth_image(np.random.default_rng(95), 32, 16)
    cont = j_strips.encode(img, th=16)
    assert tuple(strips._parse(cont)[0][7]) == tuple(tune)
    np.testing.assert_array_equal(strips.decode(cont, device="cpu"), img)


@pytest.mark.parametrize("name", HERE)
def test_variant_containers_decode(name, monkeypatch):
    check_variant(name, monkeypatch)
