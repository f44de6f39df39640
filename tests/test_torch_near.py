"""The port's near-lossless NBTC encode against nblic_tpu.models.tiled.

- The reconstruction-feedback scan, run in lockstep over a batch of images,
  gives the planes that the JAX scan gives tile by tile and image by image,
  statistics included, at profiles 1 and 2.
- The least-squares refit on a reconstruction and the race at ``near``
  equal the JAX package's.
- Containers are byte-identical to ``j_tiled.encode(img, near=n, ...)``:
  profile 1 at every near tried, profile 2 at 16 x 16 and 8 x 8 tiles, and
  at 64 x 64 with the JAX package's weights carried in (its float32 fit may
  round past 2^24 there).  Batches and corpora give each image the JAX
  package's per-image container, untransposed.
- Each package decodes the other's near containers within ``near``, and
  both decode the port's alike.

All on CPU tensors; JAX on the CPU as its own tests run it.  Integer math:
tolerance 0.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decode import _wave, mixed

from nblic_tpu import api as j_api
from nblic_tpu.models import tiled as j_tiled
from nblic_tpu.ops import lsq as j_lsq
from nblic_tpu.utils import imageio
from nblic_tpu_torch import api, cli, convert
from nblic_tpu_torch.models import tiled
from nblic_tpu_torch.ops import lsq

CPU = torch.device("cpu")

# one intra-op thread: parallel test workers each run many tiny torch ops,
# and idle OpenMP threads spinning between them starve the other workers
torch.set_num_threads(1)


def _natural(seed, h, w):
    """Gradient plus noise: a mix of short and long residual codes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (yy * 3 + xx * 2) % 256 + rng.normal(0, 6, size=(h, w))
    return np.clip(base, 0, 255).astype(np.uint8)


def _wild(h, w):
    """Three images that share no statistics: flat, noise, a gradient.  A
    bias table or histogram leaking across images of a batch shows here."""
    rng = np.random.default_rng(h * w)
    flat = np.full((h, w), 77, dtype=np.uint8)
    noise = rng.integers(0, 256, size=(h, w), dtype=np.uint8)
    return [flat, noise, _natural(h + w, h, w)]


def _check_decodes(streams, imgs, near):
    """Both packages decode the port's containers alike, within ``near``."""
    for s, im in zip(streams, imgs):
        dec = tiled.decode(s, device="cpu")
        np.testing.assert_array_equal(dec, j_tiled.decode(s))
        assert np.abs(dec.astype(int) - im.astype(int)).max() <= near


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


SCAN_CASES = {"p1-near1": (1, 1), "p1-near9": (1, 9), "p2-flags012": (2, 3)}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_encode_scan_stats_match_jax(case):
    profile, near = SCAN_CASES[case]
    rng = np.random.default_rng(near)
    imgs = [mixed(near, 32, 48), _natural(near, 32, 48)]
    tiles = np.stack([j_tiled.to_tiles(im, 16, 16) for im in imgs]).astype(np.int32)
    b, t = tiles.shape[:2]
    bias = rng.integers(-64, 64, size=(b, 3072)).astype(np.int32)
    w_q, _ = lsq.fit_tile_weights(torch.from_numpy(tiles).view(b * t, 16, 16))
    w_q = w_q.view(b, t, lsq.N_FEAT)
    flags = torch.arange(b * t, dtype=torch.int32).view(b, t) % 3
    wcols = tiled._lane_wcols(w_q, flags)
    port = tiled._tile_encode_scan(torch.from_numpy(tiles), torch.from_numpy(bias), wcols,
                                   16, 16, near, profile, stats=True)
    assert len(port) == 5
    fn = jax.jit(jax.vmap(functools.partial(
        j_tiled._tile_encode_scan, th=16, tw=16, near=near, profile=profile, stats=True),
        in_axes=(0, None, 0)))
    for k in range(b):
        ref = fn(jnp.asarray(tiles[k]), jnp.asarray(bias[k]),
                 jnp.asarray(wcols[k].t().numpy()))
        for name, p, r in zip(("y", "qd", "adr", "err", "rec"), port, ref):
            np.testing.assert_array_equal(p[k].numpy(), np.asarray(r), err_msg=name)
    y, qd = tiled._tile_encode_scan(torch.from_numpy(tiles), torch.from_numpy(bias),
                                    wcols, 16, 16, near, profile)
    assert torch.equal(y, port[0]) and torch.equal(qd, port[1])
    assert (port[4] - torch.from_numpy(tiles)).abs().max() <= near


def test_fit_tile_weights_on_reconstruction_matches_jax():
    # the near refit: windows from a reconstruction, targets the originals
    img = mixed(5, 64, 64)
    x = j_tiled.to_tiles(img, 16, 16).astype(np.int32)
    rec = np.clip(x + np.random.default_rng(5).integers(-3, 4, size=x.shape), 0, 255)
    w_q, valid = lsq.fit_tile_weights(torch.from_numpy(rec), target=torch.from_numpy(x))
    j_w, j_valid = jax.jit(j_lsq.fit_tile_weights)(jnp.asarray(rec), jnp.asarray(x))
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(j_w))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))
    own, _ = lsq.fit_tile_weights(torch.from_numpy(rec))
    assert not torch.equal(own, w_q)  # the target is used


@pytest.mark.parametrize("near", [0, 3])
def test_model_lossless2_race_at_near_matches_jax(near):
    imgs = [mixed(6, 64, 96), mixed(7, 64, 96)]
    tiles = np.stack([j_tiled.to_tiles(im, 16, 16) for im in imgs])
    port = tiled._model_lossless2_impl(torch.from_numpy(tiles), near=near)
    fn = jax.jit(jax.vmap(functools.partial(j_tiled._model_lossless2_impl, near=near)))
    ref = fn(jnp.asarray(tiles))
    np.testing.assert_array_equal(port[5].numpy(), np.asarray(ref[4]))  # flags
    np.testing.assert_array_equal(port[4].numpy(), np.asarray(ref[3]))  # w_q
    np.testing.assert_array_equal(port[2].numpy(), np.asarray(ref[2]))  # bias
    if near == 0:  # the lossless default is the near = 0 race
        for a, b in zip(port, tiled._model_lossless2_impl(torch.from_numpy(tiles))):
            assert torch.equal(a, b)
    else:  # the rescaled proxy moves some flag on these images
        lossless = tiled._model_lossless2_impl(torch.from_numpy(tiles))
        assert not torch.equal(lossless[5], port[5])


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------


P1_CASES = {
    "t16-near1": (_natural(40, 48, 64), 16, 1),
    "t16-near2": (_natural(41, 48, 64), 16, 2),
    "t16-near3": (_natural(42, 48, 64), 16, 3),
    "t16-near9": (_natural(43, 48, 64), 16, 9),
    "t8-multigroup": (_natural(44, 96, 104), 8, 2),
    "t16-padded": (_natural(45, 37, 53), 16, 2),
}


@pytest.mark.parametrize("case", list(P1_CASES))
def test_profile1_byte_identical(case):
    img, t, near = P1_CASES[case]
    ref = j_tiled.encode(img, near=near, tile_h=t, tile_w=t)
    port = tiled.encode(img, near=near, tile_h=t, tile_w=t, device="cpu")
    hdr = tiled._Parsed(port).hdr
    assert (hdr.profile, hdr.near, hdr.transposed) == (1, near, False)
    if case == "t8-multigroup":
        assert len(tiled._Parsed(port).counts) == 2
    assert port == ref
    if case == "t16-near2":  # effort 0 is profile 1 too
        assert tiled.encode(img, near=near, tile_h=t, tile_w=t, effort=0, device="cpu") == ref
    # the JAX package's container decodes in the port within near
    assert np.abs(tiled.decode(ref, device="cpu").astype(int) - img.astype(int)).max() <= near


P2_CASES = {f"t{t}-near{n}": (t, n) for t in (16, 8) for n in (1, 3)}


@pytest.mark.parametrize("case", list(P2_CASES))
def test_profile2_byte_identical(case):
    t, near = P2_CASES[case]
    img = mixed(50 + near, 48, 64)
    ref = j_tiled.encode(img, near=near, tile_h=t, tile_w=t, effort=2)
    port = tiled.encode(img, near=near, tile_h=t, tile_w=t, effort=2, device="cpu")
    parsed = tiled._Parsed(port)
    assert (parsed.hdr.profile, parsed.hdr.near) == (2, near)
    if t == 16:  # learned predictors ride along (8 x 8 tiles cannot pay for them)
        assert set(parsed.flags.tolist()) > {0}
    assert port == ref


def test_profile2_t64_carried_weights_byte_identical():
    # at 64 x 64 tiles the normal equations pass 2^24, where the JAX
    # package's float32 sums may round otherwise: carry its race and refit
    imgs = [_wave(60, 128, 128, 0.5)]
    ref = [j_tiled.encode(im, near=2, tile_h=64, tile_w=64, effort=2) for im in imgs]
    tiles = jnp.asarray(np.stack([j_tiled.to_tiles(im, 64, 64) for im in imgs]))
    *_, w_race, flags = jax.jit(jax.vmap(functools.partial(
        j_tiled._model_lossless2_impl, near=2)))(tiles)
    w_final = [j_tiled._Parsed(r) for r in ref]
    w_final = np.stack([p.weight_cols()[:, : lsq.N_FEAT].transpose(0, 2, 1).reshape(
        -1, lsq.N_FEAT)[: p.hdr.n_tiles] for p in w_final])
    w_race, flags = convert.weights_from_numpy(np.asarray(w_race), np.asarray(flags), CPU)
    assert (flags > 0).any()
    port = tiled._encode_batch(imgs, 64, 64, 2, None, CPU,
                               (w_race, flags, torch.from_numpy(w_final)), near=2)
    assert port == ref


def test_encode_batch_wild_images_byte_identical():
    imgs = _wild(48, 64)
    for effort in (1, 2):
        ref = [j_tiled.encode(im, near=3, tile_h=16, tile_w=16, effort=effort)
               for im in imgs]
        port = tiled.encode_batch(imgs, near=3, tile_h=16, tile_w=16, effort=effort,
                                  transposed=[True, False, True], device="cpu")
        assert port == ref
        assert not any(tiled._Parsed(c).hdr.transposed for c in port)
        _check_decodes(port, imgs, 3)


def test_encode_corpus_and_batches_untransposed_byte_identical():
    imgs = [_natural(70, 48, 64), _natural(71, 64, 48), _natural(72, 48, 64),
            _natural(73, 64, 48)]
    ref = [j_tiled.encode(im, near=2, tile_h=16, tile_w=16) for im in imgs]
    port = tiled.encode_corpus(imgs, near=2, tile_h=16, tile_w=16, device="cpu")
    assert port == ref
    assert not any(tiled._Parsed(c).hdr.transposed for c in port)
    groups = tiled.encode_batches([[imgs[0], imgs[2]], [imgs[1], imgs[3]]], near=2,
                                  tile_h=16, tile_w=16,
                                  transposed_groups=[[False, False], [True, True]],
                                  device="cpu")
    assert groups == [[ref[0], ref[2]], [ref[1], ref[3]]]
    dec = tiled.decode_batches(groups, device="cpu")
    for d, im in zip(dec[0] + dec[1], [imgs[0], imgs[2], imgs[1], imgs[3]]):
        assert np.abs(d.astype(int) - im.astype(int)).max() <= 2


def test_cli_near_roundtrip(tmp_path):
    img = mixed(90, 48, 64)
    src, enc, dec = (str(tmp_path / n) for n in ("in.bmp", "out.nbtc", "out.bmp"))
    imageio.save_image(src, img)
    for switches, near, effort in ((["-c", "-n2"], 2, 1), (["-c", "-n1", "-e2"], 1, 2)):
        assert cli.main(switches + ["--tiled", "--device=cpu", "--tile-h=16",
                                    "--tile-w=16", src, enc]) == 0
        with open(enc, "rb") as f:
            stream = f.read()
        assert stream == j_api.compress_tiled(img, near=near, effort=effort,
                                              tile_h=16, tile_w=16)
        assert stream == api.compress_tiled(img, near=near, effort=effort, tile_h=16,
                                            tile_w=16, device="cpu")
        assert cli.main(["-d", "--device=cpu", enc, dec]) == 0
        out = imageio.load_image(dec)
        assert np.abs(out.astype(int) - img.astype(int)).max() <= near
    # the header keeps near in one byte
    assert cli.main(["-c", "-n256", "--tiled", "--device=cpu", src, enc]) == -1
    with pytest.raises(ValueError, match="near"):
        tiled.encode_batch([img], near=-1, device="cpu")
