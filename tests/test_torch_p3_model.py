"""The port's profile-3 modeling planes and coding scan against nblic_tpu's.

``strips._model_planes`` must give the six planes of the JAX package's, and
the row scan with the fold (``strips._row_scan``, ``strips._fold_pack``)
the stream lengths and words of its ``_code_impl``, on the CPU with
tolerance 0.  The JAX side runs under ``jax.enable_x64`` as its encoder does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nblic_tpu.models import strips as j_strips
from nblic_tpu_torch.models import strips
from nblic_tpu_torch.utils.synth import synth_image

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _oracle_untuned():
    # nblic_tpu reads its tune from NBLIC_P3_* at import; the oracle must
    # run the default contract
    assert j_strips.TUNE == j_strips.TUNE_V4 and j_strips.AVP_N == 10


def test_model_planes_and_coding_scan():
    img = synth_image(np.random.default_rng(21), 64, 48)
    strip_arr, _, _, th = strips._prepare([img], 16)
    assert strip_arr.shape == (1, 4, 16, 48)
    tune = strips.TUNE
    assert tuple(tune) == tuple(j_strips.TUNE)
    with jax.enable_x64():
        planes_j = j_strips._model_jit(jnp.asarray(strip_arr[0]), 10, False, 0, True, False)
        len_j, flat_j = j_strips._code_jit(*planes_j, j_strips.TUNE)
        planes_j = [np.asarray(p) for p in planes_j]
        len_j, flat_j = np.asarray(len_j), np.asarray(flat_j)
    planes_p = strips._model_planes(torch.from_numpy(strip_arr[0]), 10, mix=True)
    for p, r in zip(planes_p, planes_j):
        np.testing.assert_array_equal(p.numpy(), r)
    len_p, flat_p = strips._fold_pack(*strips._row_scan(*planes_p, 1, tune), 1)
    np.testing.assert_array_equal(len_p[0].numpy(), len_j)
    words_j = np.stack([flat_j & 0xFFFF, (flat_j >> 16) & 0xFFFF], 1).reshape(-1)
    n = int(len_j.sum())
    np.testing.assert_array_equal(flat_p[:n].numpy(), words_j[:n])
