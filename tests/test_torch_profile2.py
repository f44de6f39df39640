"""The port's NBTC profile 2 (effort 2) against nblic_tpu.models.tiled.

- With the JAX package's per-tile (weights, flags) carried into the port's
  encoder (``convert.weights_from_numpy`` -> the private ``weights``
  argument), the containers are byte-identical: tiles 16 and 64, several
  groups per image, and a mixed-orientation corpus.
- Free-running, the port fits its own weights.  At tiles up to 16 x 16 the
  normal equations are below 2^24 and every fit equals the JAX package's,
  so the containers are byte-identical.  At 64 x 64 the sums can pass 2^24
  and XLA's float32 product then rounds them in its own order (ROADMAP
  Queue 3), so a tile's weights may differ: a case whose bytes differ is
  held to pixel-exact cross-decode and bpp within 0.1%.
- Each package decodes the other's containers pixel-exact, near-lossless
  profile-2 containers of the JAX package included.
- The port's copies of the JAX package's constants, container header and
  image I/O write the same bytes.

All on CPU tensors; JAX on the CPU as its own tests run it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decode import mixed

from nblic_tpu import constants as j_constants
from nblic_tpu.models import tiled as j_tiled
from nblic_tpu.utils import container as j_container
from nblic_tpu.utils import imageio as j_imageio
from nblic_tpu_torch import constants, convert
from nblic_tpu_torch.models import tiled
from nblic_tpu_torch.utils import container, imageio

CPU = torch.device("cpu")

# one intra-op thread: parallel test workers each run many tiny torch ops,
# and idle OpenMP threads spinning between them starve the other workers
torch.set_num_threads(1)


def _jax_weights(imgs, t):
    """The JAX encoder's (w_q, flags) for a same-shape batch."""
    tiles = jnp.asarray(np.stack([j_tiled.to_tiles(im, t, t) for im in imgs]))
    *_, w_q, flags = jax.jit(jax.vmap(j_tiled._model_lossless2_impl))(tiles)
    return convert.weights_from_numpy(np.asarray(w_q), np.asarray(flags), CPU)


CASES = {
    "t16-batch2": ([mixed(1, 96, 128), mixed(2, 96, 128)], 16),
    "t64": ([mixed(3, 128, 192)], 64),
    "t8-multigroup": ([mixed(4, 96, 104)], 8),
}


@pytest.mark.parametrize("case", list(CASES))
def test_carried_weights_byte_identical(case):
    imgs, t = CASES[case]
    ref = j_tiled.encode_batch(imgs, tile_h=t, tile_w=t, effort=2)
    assert all(j_tiled._Parsed(c).hdr.profile == 2 for c in ref)
    if case.endswith("multigroup"):
        assert len(j_tiled._Parsed(ref[0]).counts) > 1
    port = tiled._encode_batch(imgs, t, t, 2, None, CPU, _jax_weights(imgs, t))
    assert port == ref


def test_carried_weights_corpus_mixed_orientation():
    imgs = [mixed(10, 48, 80), mixed(11, 80, 48), mixed(12, 48, 80), mixed(13, 80, 48)]
    ref = j_tiled.encode_corpus(imgs, tile_h=16, tile_w=16, effort=2)
    out = [b""] * len(imgs)
    for idx, batch, flags in zip(*tiled._orientation_batches(imgs)):
        conts = tiled._encode_batch(batch, 16, 16, 2, flags, CPU, _jax_weights(batch, 16))
        for i, c in zip(idx, conts):
            out[i] = c
    assert out == ref
    assert [tiled._Parsed(c).hdr.transposed for c in out] == [False, True, False, True]
    # free-running at 16 x 16 tiles: the same containers
    assert tiled.encode_corpus(imgs, tile_h=16, tile_w=16, effort=2, device="cpu") == ref
    for dec in tiled.decode_batches([[out[0], out[2]], [out[1], out[3]]], device="cpu"):
        for d in dec:
            assert any(np.array_equal(d, im) for im in imgs)


@pytest.mark.parametrize("case", list(CASES))
def test_free_running_and_cross_decode(case):
    imgs, t = CASES[case]
    ref = j_tiled.encode_batch(imgs, tile_h=t, tile_w=t, effort=2)
    port = tiled.encode_batch(imgs, tile_h=t, tile_w=t, effort=2, device="cpu")
    for r, p, im in zip(ref, port, imgs):
        np.testing.assert_array_equal(tiled._Parsed(p).flags, j_tiled._Parsed(r).flags)
        if t <= 16:
            assert p == r
        if p != r:  # equal bytes decode alike; differing ones are held here
            assert abs(len(p) - len(r)) <= 0.001 * len(r)
            np.testing.assert_array_equal(j_tiled.decode(p), im)
            np.testing.assert_array_equal(tiled.decode(p, device="cpu"), im)
    for d, im in zip(tiled.decode_batch(ref, device="cpu"), imgs):
        np.testing.assert_array_equal(d, im)


def test_fit_past_2_24_differs_only_in_unsent_weights():
    # a linear ramp at 64 x 64 tiles: its normal equations pass 2^24, and the
    # JAX package's float32 sums of two tiles differ from the exact ones
    # rounded once; those tiles pick the blend predictor, whose container
    # carries no weights, so the containers stay byte-identical
    from nblic_tpu.ops import lsq as j_lsq
    from nblic_tpu_torch.ops import lsq

    yy, xx = np.mgrid[0:128, 0:128]
    img = ((2 * yy + xx) % 251).astype(np.uint8)
    tiles = j_tiled.to_tiles(img, 64, 64)
    w_q, _ = lsq.fit_tile_weights(torch.from_numpy(tiles))
    j_w, _ = jax.jit(j_lsq.fit_tile_weights)(jnp.asarray(tiles))
    ref = j_tiled.encode(img, tile_h=64, tile_w=64, effort=2)
    flags = j_tiled._Parsed(ref).flags
    assert not ((w_q.numpy() != np.asarray(j_w)).any(-1) & (flags > 0)).any()
    assert tiled.encode(img, tile_h=64, tile_w=64, effort=2, device="cpu") == ref


def test_jax_near2_profile2_decodes_in_the_port():
    img = mixed(20, 48, 64)
    stream = j_tiled.encode(img, near=2, tile_h=16, tile_w=16, effort=2)
    hdr = j_tiled._Parsed(stream).hdr
    assert (hdr.profile, hdr.near) == (2, 2)
    dec = tiled.decode(stream, device="cpu")
    assert np.abs(dec.astype(int) - img.astype(int)).max() <= 2
    np.testing.assert_array_equal(dec, j_tiled.decode(stream))


def test_port_constants_equal_jax():
    for name in ("MAX_VAL", "MID_VAL", "Q_N_QD", "Q_N_CONTEXT", "Q_PT_THRESH",
                 "Q_QD_THRESH", "MAX_NEAR", "EFFORTS", "MIN_K_STEP", "N_QD", "N_CONTEXT",
                 "MAX_PX_INC", "C_THRESHOLDS", "Q_MID"):
        assert getattr(constants, name) == getattr(j_constants, name), name
    for name in ("MAX_HEIGHT", "MAX_WIDTH", "MAX_IMG_SIZE", "NBLIC_MAGIC",
                 "QNBLIC_MAGIC", "NBTC_MAGIC"):
        assert getattr(container, name) == getattr(j_constants, name), name


def test_port_container_header_equals_jax():
    fields = dict(profile=2, near=3, height=768, width=512, tile_h=64, tile_w=16,
                  n_tiles=96, bias_len=1234, hist_len=56, flags=1)
    port, ref = container.NbtcHeader(**fields), j_container.NbtcHeader(**fields)
    assert port.to_bytes() == ref.to_bytes() and port.SIZE == ref.SIZE
    assert container.NbtcHeader.from_bytes(ref.to_bytes()) == port
    assert port.transposed
    for data in (ref.to_bytes(), b"Q0.2" + bytes(4), b"NBLIC0.3" + bytes(8)):
        assert container.sniff_format(data) == j_container.sniff_format(data)
    for bad in (b"junk", ref.to_bytes()[:20]):
        with pytest.raises(ValueError):
            container.NbtcHeader.from_bytes(bad)
    with pytest.raises(ValueError):
        container.sniff_format(b"junk")
    interop = ((container.NblicHeader(1, 768, 512, 2, 7, 3), j_container.NblicHeader(
        1, 768, 512, 2, 7, 3)), (container.QnblicHeader(512, 768),
                                 j_container.QnblicHeader(512, 768)))
    for port_h, ref_h in interop:
        assert port_h.to_bytes() == ref_h.to_bytes() and port_h.SIZE == ref_h.SIZE
        assert type(port_h).from_bytes(ref_h.to_bytes()) == port_h
        for bad in (b"junk", ref_h.to_bytes()[: ref_h.SIZE - 1]):
            with pytest.raises(ValueError):
                type(port_h).from_bytes(bad)
            with pytest.raises(ValueError):
                type(ref_h).from_bytes(bad)
    for h, w in ((0, 5), (70000, 1), (20000, 20000)):
        with pytest.raises(ValueError):
            container.check_size(h, w)


@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (33, 31)])
def test_port_imageio_equals_jax(tmp_path, shape):
    img = np.random.default_rng(shape[1]).integers(0, 256, size=shape, dtype=np.uint8)
    assert imageio.save_bmp_gray(img) == j_imageio.save_bmp_gray(img)
    assert imageio.save_pgm(img) == j_imageio.save_pgm(img)
    for suffix in ("bmp", "pgm"):
        path = str(tmp_path / f"x.{suffix}")
        imageio.save_image(path, img)
        np.testing.assert_array_equal(j_imageio.load_image(path), img)
        np.testing.assert_array_equal(imageio.load_image(path), img)
