"""The port's profile-3 coding ops against nblic_tpu's, on the CPU,
tolerance 0: C-truncating division, the quantizers, the Zcodec layers, the
counter and mapper tables, a column segment's slots, the binary rANS fold
and the stream packing.  (``test_torch_p3_pavp.py`` holds the AVP math.)

Inputs are random tables and symbol planes from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nblic_tpu.models import strips as j_strips
from nblic_tpu.ops import coder3 as j_coder3
from nblic_tpu.ops import context as j_context
from nblic_tpu.ops import predict as j_predict
from nblic_tpu.ops import rans as j_rans
from nblic_tpu.ops import rans_bin as j_rans_bin
from nblic_tpu.ops import zcodec3 as j_zcodec3
from nblic_tpu.ops.avp import tdiv as j_tdiv
from nblic_tpu_torch.models import strips
from nblic_tpu_torch.ops import coder3, context, predict, rans, rans_bin, zcodec3
from nblic_tpu_torch.ops.avp import tdiv

torch.set_num_threads(1)


def _t(a, dtype=torch.int64):
    return torch.from_numpy(np.array(a)).to(dtype)


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_tdiv_truncates_toward_zero():
    rng = np.random.default_rng(0)
    a = np.concatenate([rng.integers(-(2**62), 2**62, 500), [0, -7, 7, -1, 1]])
    b = np.concatenate([rng.integers(-(2**31), 2**31, 500) | 1, [5, 2, -2, -1, 3]])
    with jax.enable_x64():
        ref = j_tdiv(jnp.asarray(a), jnp.asarray(b))
    _eq(tdiv(_t(a), _t(b)), ref)


def test_quantizers():
    delta = np.arange(0, 700, dtype=np.int32).reshape(25, 28)
    for p, r in zip(predict.n_quantize_activity(_t(delta, torch.int32)),
                    j_predict.n_quantize_activity(jnp.asarray(delta))):
        _eq(p, r)
    rng = np.random.default_rng(6)
    sums = rng.integers(-(2**20), 2**20, 3072).astype(np.int32)
    cnts = rng.integers(0, 4000, 3072).astype(np.int32)
    cnts[:100] = 0
    for shrink in (0, 16, 48):
        _eq(context.quantize_bias(_t(sums), _t(cnts), shrink),
            j_context.quantize_bias(jnp.asarray(sums), jnp.asarray(cnts), shrink))


def _symbol_planes(seed, lanes=3, w=8):
    """Random (z, qu, qv, qw) planes: mostly small symbols, some escapes."""
    rng = np.random.default_rng(seed)
    z = np.minimum(rng.geometric(0.08, size=(lanes, w)) - 1, 255)
    z[0, :2] = (255, 200)
    qu = rng.integers(0, 16, size=(lanes, w))
    qv = np.clip(qu + rng.integers(-1, 2, size=(lanes, w)), 0, 15)
    qw = rng.integers(0, 33, size=(lanes, w))
    return [a.astype(np.int32) for a in (z, qu, qv, qw)]


@pytest.mark.parametrize("n_unary", [9, 13])
def test_zcodec3_layers(n_unary):
    z, qu, qv, _ = _symbol_planes(7, lanes=8, w=32)
    (ru, rv, b, act), row_end, k_end, esc = zcodec3.unary_layers(
        _t(z, torch.int32), _t(qu, torch.int32), _t(qv, torch.int32), 3, n_unary)
    ref, r_end, r_k, r_esc = j_zcodec3.unary_layers(
        jnp.asarray(z), jnp.asarray(qu), jnp.asarray(qv), 3, n_unary)
    for l, (a1, a2, a3, a4) in enumerate(ref):
        for p, r in ((ru[l], a1), (rv[l], a2), (b[l], a3), (act[l], a4)):
            _eq(p, r)
    for p, r in ((row_end, r_end), (k_end, r_k), (esc, r_esc)):
        _eq(p, r)
    assert bool(esc.any())
    bit, ract, msb = zcodec3.refine_layers(_t(z, torch.int32), k_end, esc)
    for l, (a1, a2, a3) in enumerate(j_zcodec3.refine_layers(
            jnp.asarray(z), jnp.asarray(np.asarray(r_k)), r_esc)):
        _eq(bit[l], a1)
        _eq(ract[l], a2)
        _eq(msb[l], a3)


def _tables(seed, lanes, n_class):
    rng = np.random.default_rng(seed)
    utab = rng.integers(1, 5000, size=(lanes, 16, n_class, 2))
    rtab = rng.integers(1, 5000, size=(lanes, 16, 5, 2, 2))
    return utab.astype(np.int32), rtab.astype(np.int32)


@pytest.mark.parametrize("tune", ["TUNE_V4", "TUNE_MAX"])
def test_segment_slots_and_counter_updates(tune):
    """One column segment's (prob, bin, mask) slots and table updates, per
    segment and (TUNE_MAX) per symbol; also the counters' halving."""
    tj, tp = getattr(j_strips, tune), getattr(strips, tune)
    lanes, n_class = 3, 8
    z, qu, qv, qw = _symbol_planes(8)
    utab, rtab = _tables(9, lanes, n_class)
    ev = j_strips._code_events(jnp.asarray(z), jnp.asarray(qu), jnp.asarray(qv), 3,
                               tj.n_unary)
    (p_j, b_j, m_j), (u_j, r_j) = j_strips._seg_slots_update(
        jnp.asarray(utab), jnp.asarray(rtab), jnp.asarray(z), jnp.asarray(qw), *ev, 3, tj)
    (p_p, b_p, m_p), (u_p, r_p) = strips._seg_slots_update(
        _t(utab), _t(rtab), _t(z), _t(qu), _t(qv), _t(qw),
        torch.arange(lanes)[:, None], 3, tp)
    for p, r in ((p_p, p_j), (b_p, b_j), (m_p, m_j), (u_p, u_j), (r_p, r_j)):
        _eq(p, r)
    assert bool((np.asarray(u_j) < utab).any())  # some pairs halved


def test_mapper_and_probability_tables():
    rng = np.random.default_rng(10)
    mhist = rng.integers(0, 40, size=(2, 512, 20)).astype(np.int32)
    mhist[0, :, :5] = 7  # ties: the stable order keeps y ascending
    img_of_lane = np.array([0, 0, 1], np.int32)
    key = rng.integers(0, 512, size=(3, 16)).astype(np.int32)
    y = rng.integers(0, 40, size=(3, 16)).astype(np.int32)
    ranks_j, _ = j_coder3.mapper_ranks(jnp.asarray(mhist))
    ranks_p = coder3.mapper_ranks(_t(mhist))
    _eq(ranks_p, ranks_j)
    _eq(coder3.mapper_lookup(ranks_p, _t(img_of_lane), _t(key), _t(y)),
        j_coder3.mapper_lookup(ranks_j, jnp.asarray(img_of_lane), jnp.asarray(key),
                               jnp.asarray(y)))
    for bump, halve in ((2, 256), (4, 4096)):
        _eq(coder3.mapper_updates(_t(mhist), _t(img_of_lane), _t(key), _t(y), bump, halve),
            j_coder3.mapper_updates(jnp.asarray(mhist), jnp.asarray(img_of_lane),
                                    jnp.asarray(key), jnp.asarray(y), bump, halve))
    _eq(coder3.init_mapper(2), j_coder3.init_mapper(2))
    utab, _ = _tables(12, 2, 8)
    _eq(coder3.prob_table(_t(utab)), j_coder3.prob_table(jnp.asarray(utab)))
    pu, pv, qw = (rng.integers(1, 4096, 50), rng.integers(1, 4096, 50),
                  rng.integers(0, 33, 50))
    _eq(coder3.mix_prob(_t(pu), _t(pv), _t(qw)),
        j_coder3.mix_prob(jnp.asarray(pu), jnp.asarray(pv), jnp.asarray(qw)))
    _eq(coder3.halve_pairs(_t(utab), 6000), j_coder3.halve_pairs(jnp.asarray(utab), 6000))


def test_fold_and_pack_with_masks():
    rng = np.random.default_rng(13)
    s, l = 6, 900
    p1 = rng.integers(-5, 4200, (s, l)).astype(np.int32)  # clipped to [1, 4095]
    bins = (rng.random((s, l)) < np.clip(p1, 1, 4095) / 4096.0).astype(np.int32)
    mask = rng.random((s, l)) < 0.6
    mask[1] = False  # a lane with no live slot
    words_j, emits_j, state_j = jax.jit(j_rans_bin.fold)(
        jnp.asarray(p1), jnp.asarray(bins), jnp.asarray(mask))
    words_p, emits_p, state_p = rans_bin.fold(_t(p1, torch.int32), _t(bins, torch.int32),
                                              _t(mask, torch.bool))
    _eq(emits_p, emits_j)
    _eq(words_p[emits_p], np.asarray(words_j)[np.asarray(emits_j)])
    _eq(state_p, np.asarray(state_j).astype(np.int64))
    flat_j, len_j = j_rans.pack_streams(words_j, emits_j, state_j)
    flat_p, len_p = rans.pack_streams(words_p, emits_p, state_p)
    _eq(len_p, len_j)
    n = int(len_j.sum())
    _eq(flat_p[:n], np.asarray(flat_j)[:n].astype(np.int32))


def test_fold_layout_matches_per_image_reshape():
    """(th, slots, B * S, W) -> phase-major state rows, image-major: the JAX
    package's per-image layout concatenated over images, S > 1; th is 48
    after the clamp of a requested 64 for 40-row strips."""
    imgs = [np.zeros((40, 24), np.uint8)] * 3
    strip_arr, _, _, th = strips._prepare(imgs, 64)
    assert th == 48 and strip_arr.shape[1] == 1
    b, s, w, l_tot = 3, 2, 24, 21
    a = np.random.default_rng(14).integers(0, 4096, size=(th, l_tot, b * s, w))
    ref = []
    for i in range(b):  # the JAX package's fold_layout of one image
        ai = a[:, :, i * s : (i + 1) * s].transpose(2, 0, 3, 1).reshape(s, -1)
        ref.append(ai.reshape(s, -1, 16).transpose(0, 2, 1).reshape(s * 16, -1))
    _eq(strips._fold_layout(_t(a)), np.concatenate(ref))


def test_tune_block_matches_jax():
    """The replay contract's 32-byte block, its 20-byte legacy form and the
    range check agree with the JAX package's, field for field."""
    for name in ("TUNE_V1", "TUNE_V2", "TUNE_V3", "TUNE_V4", "TUNE_MAX", "TUNE_V3S",
                 "TUNE_V4S"):
        tp, tj = getattr(strips, name), getattr(j_strips, name)
        assert tp.to_bytes() == tj.to_bytes()
        assert strips.Tune.from_bytes(tj.to_bytes(), extended=True) == tp.validate()
        legacy = strips.Tune.from_bytes(tj.to_bytes()[: strips.Tune.SIZE])
        assert tuple(legacy) == tuple(j_strips.Tune.from_bytes(tj.to_bytes()[:20]))
    for bad in (dict(n_unary=21), dict(bias_cap=40000), dict(w_pred=1),
                dict(seg_stats=1), dict(spare=1)):
        with pytest.raises(ValueError):
            strips.TUNE_V4._replace(**bad).validate()
        with pytest.raises(ValueError):
            j_strips.TUNE_V4._replace(**bad).validate()
    with pytest.raises(ValueError):
        strips.Tune.from_bytes(bytes(31), extended=True)
