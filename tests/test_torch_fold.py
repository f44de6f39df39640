"""The port's rANS fold and stream layout against nblic_tpu.

The plain fold and ``encode_fold`` on CPU tensors are held against JAX's
``encode_scan`` and the Pallas fold kernel in interpret mode; the CUDA
kernel is held against the plain fold in test_torch_cuda.py.  Integer math:
tolerance 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nblic_tpu.ops import pallas_fold
from nblic_tpu.ops import rans as j_rans
from nblic_tpu_torch.ops import fold, rans


def _tables(seed, s=200, l=512, identity=5):
    rng = np.random.default_rng(seed)
    freq = rng.integers(1, 32768, size=(s, l)).astype(np.int32)
    acc = rng.integers(0, 1 << 14, size=(s, l)).astype(np.int32)
    freq[:identity] = 32768  # identity lanes (the pad-lane case)
    acc[:identity] = 0
    return freq, acc


def test_encode_fold_matches_jax_and_pallas():
    freq, acc = _tables(0)
    launches = fold.encode_fold.launches
    w0, e0, s0 = rans.encode_scan(torch.from_numpy(freq), torch.from_numpy(acc))
    w1, e1, s1 = fold.encode_fold(torch.from_numpy(freq), torch.from_numpy(acc))
    assert fold.encode_fold.launches == launches  # CPU tensors: plain version
    wj, ej, sj = jax.jit(j_rans.encode_scan)(
        jnp.asarray(freq.astype(np.uint32)), jnp.asarray(acc.astype(np.uint32))
    )
    wp, ep, sp = pallas_fold.encode_fold(jnp.asarray(freq), jnp.asarray(acc), True)
    ej = np.asarray(ej)
    for w, e, s in ((w0, e0, s0), (w1, e1, s1)):
        np.testing.assert_array_equal(e.numpy(), ej)
        np.testing.assert_array_equal(np.asarray(ep), ej)
        np.testing.assert_array_equal(w.numpy()[ej], np.asarray(wj)[ej])
        np.testing.assert_array_equal(w.numpy()[ej], np.asarray(wp)[ej])
        np.testing.assert_array_equal(s.numpy(), np.asarray(sj).astype(np.int64))
        np.testing.assert_array_equal(s.numpy(), np.asarray(sp).astype(np.int64))


@pytest.mark.parametrize("n_groups,g,l", [(1, 8, 16), (3, 32, 40)])
def test_interleave_pack_matches_jax(n_groups, g, l):
    freq, acc = _tables(n_groups, s=n_groups * g, l=l, identity=3)
    words, emits, state = rans.encode_scan(torch.from_numpy(freq), torch.from_numpy(acc))
    flat, total = rans.interleave_pack(
        words.reshape(n_groups, g, l), emits.reshape(n_groups, g, l),
        state.reshape(n_groups, g),
    )
    for k in range(n_groups):
        sl = slice(k * g, (k + 1) * g)
        jflat, jtotal = j_rans.interleave_pack(
            jnp.asarray(words[sl].numpy()), jnp.asarray(emits[sl].numpy()),
            jnp.asarray(state[sl].numpy().astype(np.uint32)),
        )
        assert int(total[k]) == int(jtotal)
        np.testing.assert_array_equal(flat[k, : int(total[k])].numpy(),
                                      np.asarray(jflat)[: int(jtotal)])


def test_interleaved_decoder_steps_match_jax():
    rng = np.random.default_rng(9)
    g, w = 32, 200
    stream = rng.integers(0, 1 << 16, size=(w,)).astype(np.int32)
    state, sp = rans.interleaved_dec_init(torch.from_numpy(stream), g)
    jstate, jsp = j_rans.interleaved_dec_init(jnp.asarray(stream), g)
    np.testing.assert_array_equal(state.numpy(), np.asarray(jstate).astype(np.int64))
    assert int(sp) == int(jsp)
    for _ in range(12):  # cursor runs past the end: reads clamp to the last word
        low = rng.integers(0, 1 << 17, size=(g,))
        active = rng.random(g) < 0.8
        state, sp = rans.interleaved_dec_renorm(
            torch.from_numpy(low), sp, torch.from_numpy(stream), torch.from_numpy(active)
        )
        jstate, jsp = j_rans.interleaved_dec_renorm(
            jnp.asarray(low.astype(np.uint32)), jsp, jnp.asarray(stream),
            jnp.asarray(active),
        )
        np.testing.assert_array_equal(state.numpy(), np.asarray(jstate).astype(np.int64))
        assert int(sp) == int(jsp)


def test_pad_streams_matches_jax():
    rng = np.random.default_rng(4)
    lengths = np.array([5, 0, 9, 3])
    flat = rng.integers(0, 1 << 16, size=lengths.sum()).astype(np.uint16)
    np.testing.assert_array_equal(rans.pad_streams(flat, lengths, 12),
                                  j_rans.pad_streams(flat, lengths, 12))
