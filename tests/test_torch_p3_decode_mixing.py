"""The port's profile-3 decoder on nblic_tpu's containers under the
sub-row contract variants with predictor mixing (alone, and with
per-symbol counters and overridden counter dynamics) and with
quantized-weight prediction; the other four of nblic_tpu's seven
variants run in ``test_torch_p3_decode_tunes.py``.  Each container
nblic_tpu writes at strip height 16 decodes to the image.
"""

import pytest
import torch
from test_torch_p3_decode_tunes import HERE, VARIANTS, check_variant

from nblic_tpu.models import strips as j_strips

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _oracle_untuned():
    # nblic_tpu reads its tune from NBLIC_P3_* at import; the oracle must
    # start from the default contract
    assert j_strips.TUNE == j_strips.TUNE_V4 and j_strips.AVP_N == 10


@pytest.mark.parametrize("name", [v for v in VARIANTS if v not in HERE])
def test_variant_containers_decode(name, monkeypatch):
    check_variant(name, monkeypatch)
