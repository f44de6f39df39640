"""The port's modeling ops equal their nblic_tpu counterparts element for
element.  Everything here is integer math, so the tolerance is 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_test_images

from nblic_tpu.ops import context as j_ctx
from nblic_tpu.ops import histogram as j_hist
from nblic_tpu.ops import neighbors as j_nb
from nblic_tpu.ops import predict as j_pred
from nblic_tpu.ops import window as j_win
from nblic_tpu_torch.ops import context, histogram, neighbors, predict, window

IMAGES = make_test_images(np.random.default_rng(1234))
IMAGE_IDS = [f"{i}-{im.shape[0]}x{im.shape[1]}" for i, im in enumerate(IMAGES)]


def _eq(port, ref):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref))


def _planes(rng, shape, lo=0, hi=256, n=11):
    return [rng.integers(lo, hi, size=shape).astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize("img", IMAGES, ids=IMAGE_IDS)
def test_sample_slide(img):
    port = neighbors.sample(torch.from_numpy(img))
    ref = j_nb.sample(jnp.asarray(img))
    for name, p, r in zip(neighbors.Neighbors._fields, port, ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r), err_msg=name)


@pytest.mark.parametrize("img", IMAGES, ids=IMAGE_IDS)
def test_model_stage1(img):
    port = predict.model_stage1(torch.from_numpy(img))
    ref = j_pred.model_stage1(jnp.asarray(img))
    for name, p, r in zip(("px0", "err", "qd", "adr"), port, ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r), err_msg=name)


def test_model_stage1_batched_tiles():
    rng = np.random.default_rng(5)
    tiles = rng.integers(0, 256, size=(6, 8, 8), dtype=np.uint8)
    port = predict.model_stage1(torch.from_numpy(tiles))
    for k in range(tiles.shape[0]):
        ref = j_pred.model_stage1(jnp.asarray(tiles[k]))
        for p, r in zip(port, ref):
            _eq(p[k], r)


def test_predict_ops_on_random_planes():
    rng = np.random.default_rng(7)
    planes = _planes(rng, (17, 23))
    tn = neighbors.Neighbors(*map(torch.from_numpy, planes))
    jn = j_nb.Neighbors(*map(jnp.asarray, planes))
    px = predict.simple_predict(tn)
    _eq(px, j_pred.simple_predict(jn))
    err = rng.integers(-255, 256, size=(17, 23)).astype(np.int32)
    delta = predict.activity(tn, torch.from_numpy(err))
    _eq(delta, j_pred.activity(jn, jnp.asarray(err)))
    qd = predict.quantize_activity(delta)
    _eq(qd, j_pred.quantize_activity(jnp.asarray(delta.numpy())))
    _eq(predict.context_address(tn, px, qd),
        j_pred.context_address(jn, jnp.asarray(px.numpy()), jnp.asarray(qd.numpy())))
    _eq(predict.shift_err(torch.from_numpy(err)), j_pred.shift_err(jnp.asarray(err)))


@pytest.mark.parametrize("seed", [11, 14])
def test_bias_moments_and_quantize(seed):
    rng = np.random.default_rng(seed)
    # few samples over many contexts: empty, single and heavily used ones,
    # negative and positive means, exact .5 roundings
    adr = rng.integers(0, 300, size=(40, 50)).astype(np.int32)
    adr[:, :10] = 7
    err = rng.integers(-255, 256, size=(40, 50)).astype(np.int32)
    err[0, :10] = -3
    sums, cnts = context.bias_moments(torch.from_numpy(adr), torch.from_numpy(err), 3072)
    j_sums, j_cnts = j_ctx.bias_moments(jnp.asarray(adr), jnp.asarray(err), 3072)
    _eq(sums, j_sums)
    _eq(cnts, j_cnts)
    _eq(context.quantize_bias(sums, cnts), j_ctx.quantize_bias(j_sums, j_cnts))
    half = torch.tensor([-1, 1, -3, 3, -5000, 5000, 0]), torch.tensor([32, 32, 32, 32, 1, 1, 0])
    _eq(context.quantize_bias(*half),
        j_ctx.quantize_bias(*(jnp.asarray(t.numpy().astype(np.int32)) for t in half)))
    _eq(context.build_static_bias(torch.from_numpy(adr), torch.from_numpy(err), 3072),
        j_ctx.build_static_bias(jnp.asarray(adr), jnp.asarray(err), 3072))


@pytest.mark.parametrize("n", [100, 5000])
def test_apply_static_bias_negative_biases(n):
    rng = np.random.default_rng(n)
    bias = rng.integers(-(1 << 11), 1 << 11, size=3072).astype(np.int32)
    adr = rng.integers(0, 3072, size=(n,)).astype(np.int32)
    px0 = rng.integers(0, 256, size=(n,)).astype(np.int32)
    port = context.apply_static_bias(*map(torch.from_numpy, (bias, adr, px0)))
    ref = j_ctx.apply_static_bias(*map(jnp.asarray, (bias, adr, px0)))
    for p, r in zip(port, ref):
        _eq(p, r)


@pytest.mark.parametrize("near", [0, 1, 2, 9])
def test_residual_fold_unfold(near):
    x, px, sign = np.meshgrid(np.arange(256), np.arange(256), np.arange(2),
                              indexing="ij")
    x, px, sign = (a.reshape(-1).astype(np.int32) for a in (x, px, sign))
    y = context.residual_fold(*map(torch.from_numpy, (x, px, sign)), near)
    _eq(y, j_ctx.residual_fold(*map(jnp.asarray, (x, px, sign)), near))
    # every symbol z in 0..255 against every (px, sign)
    back = context.residual_unfold(*map(torch.from_numpy, (x, px, sign)), near)
    _eq(back, j_ctx.residual_unfold(*map(jnp.asarray, (x, px, sign)), near))
    rec = context.residual_unfold(y, torch.from_numpy(px), torch.from_numpy(sign), near)
    assert int((rec - torch.from_numpy(x)).abs().max()) <= near


@pytest.mark.parametrize("w", [1, 2, 3, 5, 16])
def test_row_start_and_slide_window(w):
    rng = np.random.default_rng(w)
    prev1, prev2 = (rng.integers(0, 256, size=(4, w)).astype(np.int32) for _ in range(2))
    tp1, tp2 = torch.from_numpy(prev1), torch.from_numpy(prev2)
    jp1, jp2 = jnp.asarray(prev1), jnp.asarray(prev2)
    for i in range(3):
        regs = window.row_start_window(i, tp1, tp2, w)
        jregs = j_win.row_start_window(i, jp1, jp2, w)
        for j in range(w):
            for p, r in zip(regs, jregs):
                _eq(p, r)
            x = rng.integers(0, 256, size=(4,)).astype(np.int32)
            regs = window.slide_window(regs, torch.from_numpy(x), i, j, tp1, tp2, w)
            jregs = j_win.slide_window(jregs, jnp.asarray(x), i, j, jp1, jp2, w)
        for p, r in zip(regs, jregs):
            _eq(p, r)


def test_pixel_model():
    rng = np.random.default_rng(3)
    regs = _planes(rng, (64,))
    err = rng.integers(-255, 256, size=(64,)).astype(np.int32)
    port = window.pixel_model(tuple(map(torch.from_numpy, regs)), torch.from_numpy(err))
    ref = j_win.pixel_model(tuple(map(jnp.asarray, regs)), jnp.asarray(err))
    for p, r in zip(port, ref):
        _eq(p, r)


@pytest.mark.parametrize("kind", ["random", "sparse", "single", "runs"])
def test_histogram_serialize_roundtrip(kind):
    rng = np.random.default_rng(len(kind))
    counts = {
        "random": rng.integers(0, 1000, size=256),
        "sparse": np.where(rng.random(256) < 0.1, rng.integers(1, 50, size=256), 0),
        "single": np.eye(256, dtype=np.int64)[200] * 77,
        "runs": np.repeat(rng.integers(0, 3, size=32), 8),
    }[kind]
    hist = j_hist.normalize(counts)
    words = histogram.serialize(hist)
    assert words == j_hist.serialize(hist)
    back, pos = histogram.deserialize(np.asarray(words, np.uint16), 0)
    _eq(back, hist)
    assert pos == len(words)
    _eq(histogram.accumulate(hist), j_hist.accumulate(hist))
    with pytest.raises(ValueError):
        histogram.deserialize(np.asarray(words[:-1], np.uint16), 0)
