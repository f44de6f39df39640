"""The port's modeling ops equal their nblic_tpu counterparts element for
element.  Everything here is integer math, or (the least-squares fit)
float32 that rounds the same way, so the tolerance is 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_test_images

from nblic_tpu.ops import context as j_ctx
from nblic_tpu.ops import histogram as j_hist
from nblic_tpu.ops import lsq as j_lsq
from nblic_tpu.ops import neighbors as j_nb
from nblic_tpu.ops import predict as j_pred
from nblic_tpu.ops import window as j_win
from nblic_tpu_torch.ops import context, histogram, lsq, neighbors, predict, window

IMAGES = make_test_images(np.random.default_rng(1234))
IMAGE_IDS = [f"{i}-{im.shape[0]}x{im.shape[1]}" for i, im in enumerate(IMAGES)]

# one intra-op thread: parallel test workers each run many tiny torch ops,
# and idle OpenMP threads spinning between them starve the other workers
torch.set_num_threads(1)


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


@pytest.mark.parametrize("shrink", [0, 16, 48])
def test_quantize_bias_wraps_as_int32(shrink):
    # |sum| in [2^26, 2^31): nblic_tpu's int32 numerator (|sum| << 4) * 2 +
    # denom wraps there; the port's must wrap the same way (the tiled
    # encoders use shrink 0, the profile-3 tunes 0, 16 and 48)
    rng = np.random.default_rng(26 + shrink)
    mag = np.concatenate([rng.integers(1 << 26, 1 << 31, 3000),
                          [1 << 26, (1 << 27) - 1, 1 << 27, 1 << 30, (1 << 31) - 1]])
    sums = (mag * rng.choice([-1, 1], mag.size)).astype(np.int32)
    cnts = rng.integers(0, 1 << 20, sums.size).astype(np.int32)
    cnts[:5] = (0, 1, 2, 3, 1 << 24)
    port = context.quantize_bias(torch.from_numpy(sums).to(torch.int64),
                                 torch.from_numpy(cnts).to(torch.int64), shrink)
    _eq(port, j_ctx.quantize_bias(jnp.asarray(sums), jnp.asarray(cnts), shrink))


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


def _weights(rng, shape):
    """Random int16-range weights with an int16-range intercept."""
    return rng.integers(-(1 << 15) + 1, 1 << 15, size=shape).astype(np.int32)


def test_pixel_model_profile2():
    rng = np.random.default_rng(4)
    g = 96
    regs = _planes(rng, (g,))
    err = rng.integers(-255, 256, size=(g,)).astype(np.int32)
    wcols = np.zeros((16, g), np.int32)
    wcols[:12] = _weights(rng, (12, g))
    wcols[12] = np.arange(g) % 3
    port = window.pixel_model(tuple(map(torch.from_numpy, regs)), torch.from_numpy(err),
                              torch.from_numpy(wcols))
    # the model of nblic_tpu.models.tiled._group_decode_scan at profile 2
    jregs = tuple(map(jnp.asarray, regs))
    nb = j_nb.Neighbors(*jregs)
    px0 = j_pred.simple_predict(nb)
    px_l = j_lsq.predict_lanes(jregs, jnp.asarray(wcols))[0]
    px0 = jnp.where(wcols[12] == 1, px_l, jnp.where(wcols[12] == 2, (px0 + px_l + 1) >> 1, px0))
    qd = j_pred.quantize_activity(j_pred.activity(nb, jnp.asarray(err)))
    for p, r in zip(port, (px0, qd, j_pred.context_address(nb, px0, qd))):
        _eq(p, r)


@pytest.mark.parametrize("img", IMAGES[3:], ids=IMAGE_IDS[3:])
def test_lsq_features_and_predict_plane(img):
    rng = np.random.default_rng(img.size)
    tiles = np.stack([img, img[::-1].copy()])
    tn = neighbors.sample(torch.from_numpy(tiles))
    jn = j_nb.Neighbors(*(jnp.stack([a, b]) for a, b in zip(
        j_nb.sample(jnp.asarray(tiles[0])), j_nb.sample(jnp.asarray(tiles[1])))))
    _eq(lsq.features(tn), j_lsq.features(jn))
    w_q = _weights(rng, (2, 12))
    _eq(lsq.predict_plane(tn, torch.from_numpy(w_q)), j_lsq.predict_plane(jn, jnp.asarray(w_q)))


def test_lsq_predict_lanes():
    rng = np.random.default_rng(6)
    regs = _planes(rng, (50,))
    w_cols = _weights(rng, (16, 50))
    w_cols[:12, 0], w_cols[:12, 1] = lsq.W_CLIP, -lsq.W_CLIP  # extreme weights
    regs[0][:2] = 255
    port = lsq.predict_lanes(tuple(map(torch.from_numpy, regs)), torch.from_numpy(w_cols))
    _eq(port, j_lsq.predict_lanes(tuple(map(jnp.asarray, regs)), jnp.asarray(w_cols))[0])


def test_lsq_solve_spd_rounds_as_jitted_jax():
    # the encoder runs the solve jitted: XLA fuses each row update into one
    # multiply-subtract, which the port reproduces bit for bit
    rng = np.random.default_rng(8)
    f = rng.integers(-128, 128, size=(40, 300, 12)).astype(np.float32)
    a = np.einsum("tpi,tpj->tij", f, f) + 64.0 * np.eye(12, dtype=np.float32)
    b = np.einsum("tpi,tp->ti", f, rng.integers(-128, 128, size=(40, 300)).astype(np.float32))
    a, b = a.astype(np.float32), b.astype(np.float32)
    port = lsq._solve_spd(torch.from_numpy(a), torch.from_numpy(b))
    _eq(port, jax.jit(j_lsq._solve_spd)(jnp.asarray(a), jnp.asarray(b)))


def test_lsq_fused_sub_mul_rounds_once():
    rng = np.random.default_rng(9)
    a, b, c = (rng.standard_normal(100000).astype(np.float32) * s for s in (1e3, 1.0, 7.0))
    exact = np.asarray([np.float32(x) for x in
                        (a.astype(np.longdouble) - b.astype(np.longdouble) * c)])
    port = lsq._fused_sub_mul(*map(torch.from_numpy, (a, b, c))).numpy()
    _eq(port, exact)
    assert (port != (a - b * c)).any()  # a separate multiply rounds twice


def _smooth():
    yy, xx = np.mgrid[0:128, 0:128]
    return ((2 * yy + xx) % 251).astype(np.uint8)


@pytest.mark.parametrize("kind", ["smooth", "noise"])
def test_lsq_fit_tile_weights_matches_jax(kind):
    from nblic_tpu.models import tiled as j_tiled

    img = _smooth() if kind == "smooth" else \
        np.random.default_rng(10).integers(0, 256, size=(64, 96), dtype=np.uint8)
    tiles = j_tiled.to_tiles(img, 16, 16)
    w_q, valid = lsq.fit_tile_weights(torch.from_numpy(tiles))
    j_w, j_valid = jax.jit(j_lsq.fit_tile_weights)(jnp.asarray(tiles))
    _eq(w_q, j_w)
    _eq(valid, j_valid)
    assert valid.all() and (w_q != 0).any()


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
