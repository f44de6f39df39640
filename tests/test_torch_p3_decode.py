"""The port's profile-3 decoder against nblic_tpu.models.strips, TUNE_V4.

The rANS decode steps and the per-pixel model against nblic_tpu's on random
inputs, and the port's own containers round trip (a transposed image, an
odd height, several strips, a same-shape batch and a batch of mixed
geometries).  nblic_tpu's TUNE_V4 containers (strip heights 16 and 64,
transposed, odd height, several strips, batched) decode to the image in
``test_torch_p3_encode.py``, where they are already written.  Tolerance 0
throughout, synthetic images only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nblic_tpu.models import strips as j_strips
from nblic_tpu.ops import pavp as j_pavp
from nblic_tpu.ops import rans_bin as j_rans_bin
from nblic_tpu_torch.models import strips, tiled
from nblic_tpu_torch.ops import pavp, rans_bin
from nblic_tpu_torch.utils.container import NbtcHeader
from nblic_tpu_torch.utils.synth import synth_image

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _oracle_untuned():
    # nblic_tpu reads its tune from NBLIC_P3_* at import; the oracle must
    # run the default contract
    assert j_strips.TUNE == j_strips.TUNE_V4 and j_strips.AVP_N == 10
    assert tuple(strips.TUNE) == tuple(strips.TUNE_V4) == tuple(j_strips.TUNE_V4)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# the rANS decode steps and the per-pixel model
# ---------------------------------------------------------------------------


def test_rans_decode_steps_match_jax():
    rng = np.random.default_rng(81)
    words = rng.integers(0, 1 << 16, size=(64, 9)).astype(np.int32)
    state = rng.integers(0, 1 << 32, size=64, dtype=np.uint64)
    state[:8] = rng.integers(0, 1 << 16, size=8)  # below 2^16: renormalizes
    p1 = rng.integers(0, 4097, size=64).astype(np.int32)
    p1[:4] = [0, 4096, 1, 4095]  # clipped to [1, 4095]
    ptr = rng.integers(0, 12, size=64).astype(np.int32)  # at and past the end
    ptr[:3] = [8, 9, 100]
    with jax.enable_x64():
        js, jp = j_rans_bin.dec_init(jnp.asarray(words))
        jb, jst = j_rans_bin.dec_bit(jnp.asarray(state.astype(np.uint32)), jnp.asarray(p1))
        jst2, jp2 = j_rans_bin.dec_renorm(jst, jnp.asarray(ptr), jnp.asarray(words))
        want = [np.asarray(v).astype(np.int64) for v in (js, jp, jb, jst, jst2, jp2)]
    ps, pp = rans_bin.dec_init(_t(words))
    np.testing.assert_array_equal(ps.numpy(), want[0])
    np.testing.assert_array_equal(pp.numpy(), want[1])
    # the walk's one step, p1 clipped as nblic_tpu's dec_bit clips it: on
    # every lane the symbol and the renormalized state and pointer
    p1c = _t(np.clip(p1, 1, 4095)).long()
    st, pt, wd = _t(state.astype(np.int64)), _t(ptr).long(), _t(words).long()
    b, st2, pt2 = rans_bin.dec_masked(st, pt, p1c, torch.ones(64, dtype=torch.bool), wd)
    for got, exp in zip((b, st2, pt2), (want[2], want[4], want[5])):
        np.testing.assert_array_equal(got.numpy().astype(np.int64), exp)
    # masked lanes keep their state and pointer and decode 0
    active = _t(rng.random(64) < 0.7)
    b3, st3, pt3 = rans_bin.dec_masked(st, pt, p1c, active, wd)
    np.testing.assert_array_equal(b3.numpy(), (b & active).numpy())
    np.testing.assert_array_equal(st3.numpy(), torch.where(active, st2, st).numpy())
    np.testing.assert_array_equal(pt3.numpy(), torch.where(active, pt2, pt).numpy())


@pytest.mark.parametrize("n", [10, 6])
def test_pixel_model_matches_jax(n):
    """_pixel_taps / _features / _px0_from_solve / _correct / _update on
    random windows, rows and moment chains, at several (i, j)."""
    rng = np.random.default_rng(82 + n)
    lanes, w = 24, 12
    m = pavp.get_m(n)
    prev1 = rng.integers(0, 256, size=(lanes, w)).astype(np.int32)
    err = rng.integers(-127, 128, size=lanes).astype(np.int32)
    bias = rng.integers(-2048, 2048, size=lanes).astype(np.int32)
    x = rng.integers(0, 256, size=lanes).astype(np.int32)
    # moment chains as a decode builds them: decayed sums of contributions
    e_acc = rng.integers(0, 1 << 26, size=(m, lanes)).astype(np.int64)
    f_row = rng.integers(0, 1 << 26, size=(m, lanes)).astype(np.int64)
    b_row = rng.integers(0, 1 << 24, size=(m, lanes, w)).astype(np.int64)
    for (i, j) in [(0, 0), (3, 5), (5, w - 2), (7, w - 1)]:
        regs = rng.integers(0, 256, size=(11, lanes)).astype(np.int32)
        with jax.enable_x64():
            jout = j_strips._pixel_features(
                tuple(jnp.asarray(r) for r in regs), jnp.asarray(prev1), jnp.asarray(err),
                jnp.asarray(f_row), jnp.asarray(e_acc), i, j, w, n)
            _, jpx_s, jfeats, jstats, jpx0, *jctx = jout
            jdiag, jnum, jok = j_pavp.solve_batch(
                jstats[1 + n :].reshape(n, n, -1)
                + jnp.eye(n, dtype=jnp.int64)[:, :, None] * (j_pavp.RIDGE_BIAS * n),
                jstats[1 : 1 + n] + (jnp.int64(j_pavp.RIDGE_BIAS) << j_pavp.FB3), n)
            jpx0s = j_strips._pixel_px0_from_solve(jdiag, jnum, jok, jfeats, jpx_s)
            jcorr = j_strips._pixel_correct(jpx0, jnp.asarray(bias))
            jab = j_pavp._ab_vec(m)
            je, jb = j_strips._pixel_update(jnp.asarray(x), jpx_s, jfeats, jstats,
                                            jnp.asarray(e_acc), jnp.asarray(b_row), j, jab, n)
            want = [np.asarray(v) for v in (jpx_s, jfeats, jstats, jpx0, *jctx, jpx0s, *jcorr,
                                            je, jb)]
        regs_t = tuple(_t(r).long() for r in regs)
        out = strips._pixel_features(regs_t, _t(prev1).long(), _t(err).long(), _t(f_row),
                                     _t(e_acc), i, j, w, n)
        _, px_s, feats, stats, px0, *ctx = out
        diag, num, ok = pavp.solve_stats(stats, n)
        px0s = strips._pixel_px0_from_solve(diag, num, ok, feats, px_s)
        corr = strips._pixel_correct(px0, _t(bias).long())
        b_t = _t(b_row).permute(2, 0, 1).contiguous()  # the port's (W, m, L)
        e = strips._pixel_update(_t(x).long(), px_s, feats, stats, _t(e_acc), b_t, j,
                                 pavp.ab_vec(m), n)
        got = [px_s, feats, stats, px0, *ctx, px0s, *corr, e, b_t.permute(1, 2, 0)]
        for g, exp in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), exp.astype(np.int64))


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------


def _noisy(rng, h, w):
    img = synth_image(rng, h, w)
    img[:, :4] = rng.integers(0, 256, size=(h, 4))  # a noisy band: escaped symbols
    return img


def test_port_containers_roundtrip_and_mixed_geometry():
    """The port's own containers: an odd-height image and a transposed one
    as one walk, and a batch of two plane geometries (strip heights 16 and
    32), which decodes one by one."""
    rng = np.random.default_rng(85)
    imgs = [_noisy(rng, 35, 16), np.ascontiguousarray(_noisy(rng, 35, 16).T)]
    conts = strips.encode_batch(imgs, th=16, device="cpu")
    assert [NbtcHeader.from_bytes(c).tile_w & 1 for c in conts] == [0, 1]
    for got, img in zip(strips.decode_batch(conts, device="cpu"), imgs):
        np.testing.assert_array_equal(got, img)
    tall = synth_image(rng, 32, 8)
    mixed = [strips.encode(tall, th=32, device="cpu"), conts[1]]
    assert strips._plane_geom(strips._parse(mixed[0])[0]) != \
        strips._plane_geom(strips._parse(mixed[1])[0])
    got = tiled.decode_batch(mixed, device="cpu")
    np.testing.assert_array_equal(got[0], tall)
    np.testing.assert_array_equal(got[1], imgs[1])
