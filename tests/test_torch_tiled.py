"""The port's NBTC profile-1 codec against nblic_tpu.models.tiled.

Containers are byte-identical, each package decodes the other's pixel-exact,
and the JAX modeling outputs fed through ``convert`` into the port's coding
tail reproduce the JAX buffers.  Everything runs on CPU tensors.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_test_images

from nblic_tpu import api as j_api
from nblic_tpu.models import tiled as j_tiled
from nblic_tpu.utils import imageio
from nblic_tpu_torch import api, cli, convert
from nblic_tpu_torch.models import tiled
from nblic_tpu_torch.ops import fold

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _natural(seed, h, w):
    """Gradient plus noise: a mix of short and long residual codes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (yy * 3 + xx * 2) % 256 + rng.normal(0, 6, size=(h, w))
    return np.clip(base, 0, 255).astype(np.uint8)


ENCODE_CASES = {
    "t8-multigroup": ([_natural(1, 96, 104)], 8),
    "t16-batch3": ([_natural(s, 40, 56) for s in (2, 3, 4)], 16),
    "t64-padded": ([_natural(5, 130, 200)], 64),
    "t64-batch2-aligned": ([_natural(s, 128, 192) for s in (6, 7)], 64),
}


@pytest.mark.parametrize("case", list(ENCODE_CASES))
def test_encode_batch_byte_identical(case):
    imgs, t = ENCODE_CASES[case]
    port = tiled.encode_batch(imgs, tile_h=t, tile_w=t, device="cpu")
    assert port == j_tiled.encode_batch(imgs, tile_h=t, tile_w=t)
    if len(imgs) == 1:
        assert tiled.encode(imgs[0], tile_h=t, tile_w=t, device="cpu") == port[0]


def test_small_images_byte_identical_and_roundtrip():
    for img in make_test_images(np.random.default_rng(1234)):
        port = tiled.encode(img, tile_h=8, tile_w=8, device="cpu")
        assert port == j_tiled.encode(img, tile_h=8, tile_w=8), img.shape
        np.testing.assert_array_equal(tiled.decode(port, device="cpu"), img)


def test_encode_corpus_mixed_orientation_and_cross_decode():
    imgs = [_natural(10, 32, 48), _natural(11, 48, 32), _natural(12, 32, 48),
            _natural(13, 40, 40), _natural(14, 48, 32)]
    port = tiled.encode_corpus(imgs, tile_h=16, tile_w=16, device="cpu")
    assert port == j_tiled.encode_corpus(imgs, tile_h=16, tile_w=16)
    assert [j_tiled._Parsed(c).hdr.transposed for c in port] == [
        False, True, False, False, True]
    for dec in (tiled.decode_batch(port, device="cpu"), j_tiled.decode_batch(port)):
        for d, im in zip(dec, imgs):
            np.testing.assert_array_equal(d, im)
    groups = [[port[0], port[2]], [port[1], port[4]]]
    for dec, ref in zip(tiled.decode_batches(groups, device="cpu"),
                        ([imgs[0], imgs[2]], [imgs[1], imgs[4]])):
        for d, im in zip(dec, ref):
            np.testing.assert_array_equal(d, im)


@pytest.mark.parametrize("shape,t", [((96, 104), 8), ((50, 70), 64)])
def test_cross_decode(shape, t):
    img = _natural(shape[0], *shape)
    j_stream = j_tiled.encode(img, tile_h=t, tile_w=t)
    np.testing.assert_array_equal(tiled.decode(j_stream, device="cpu"), img)
    p_stream = tiled.encode(img, tile_h=t, tile_w=t, device="cpu")
    np.testing.assert_array_equal(j_tiled.decode(p_stream), img)


@pytest.mark.parametrize("kind", ["random", "tie", "spill-wraps", "single", "empty", "sparse"])
def test_norm_hist_dev_matches_jax(kind):
    rng = np.random.default_rng(len(kind))
    h = {
        "random": rng.integers(0, 3000, size=256),
        "tie": np.where(np.arange(256) % 64 == 3, 5000, rng.integers(0, 4, size=256)),
        "spill-wraps": np.eye(256, dtype=np.int64)[255] * 90000 + (np.arange(256) == 7),
        "single": np.eye(256, dtype=np.int64)[40] * 12345,
        "empty": np.zeros(256, dtype=np.int64),
        "sparse": np.where(rng.random(256) < 0.05, rng.integers(1, 9, size=256), 0),
    }[kind].astype(np.int32)
    port = tiled._norm_hist_dev(torch.from_numpy(h)).numpy()
    np.testing.assert_array_equal(port, np.asarray(j_tiled._norm_hist_dev(jnp.asarray(h))))
    assert port.sum() == tiled.NORM_SUM and (port[h > 0] > 0).all()
    batched = tiled._norm_hist_dev(torch.from_numpy(np.stack([h, h[::-1].copy()])))
    np.testing.assert_array_equal(batched[0].numpy(), port)


def test_tail_from_jax_modeling_reproduces_jax_buffers():
    tiles = j_tiled.to_tiles(_natural(20, 48, 80), 16, 16)
    y, qd, bias, hist = jax.jit(j_tiled._model_lossless_impl)(jnp.asarray(tiles))
    # the port's modeling pass gives the same planes and tables
    port_model = tiled._model_lossless_impl(torch.from_numpy(tiles)[None])
    for p, r in zip(port_model, (y, qd, bias, hist)):
        np.testing.assert_array_equal(p[0].numpy(), np.asarray(r))
    freq, facc, hist_n = j_tiled._encode_tables(y, qd, bias)
    hist_n = np.asarray(hist_n)
    totals, _, _, flat32 = j_tiled._finish_encode_parts(y, qd, bias)
    acc = np.cumsum(hist_n, axis=-1) - hist_n
    _, t_hist_n, t_acc = convert.tables_from_numpy(np.asarray(bias), hist_n, acc, "cpu")
    t_freq, t_facc = tiled._encode_tables(
        torch.tensor(np.asarray(y))[None], torch.tensor(np.asarray(qd))[None],
        t_hist_n, t_acc,
    )
    np.testing.assert_array_equal(t_freq.numpy(), np.asarray(freq))
    np.testing.assert_array_equal(t_facc.numpy(), np.asarray(facc))
    t_totals, t_flats = tiled._pack_groups(*fold.encode_fold(t_freq, t_facc))
    np.testing.assert_array_equal(t_totals.numpy(), np.asarray(totals))
    flat32 = np.asarray(flat32).astype(np.uint32)
    words = np.stack([flat32 & 0xFFFF, flat32 >> 16], axis=-1).reshape(len(flat32), -1)
    for g, total in enumerate(np.asarray(totals)):
        np.testing.assert_array_equal(t_flats[g, :total].numpy(), words[g, :total])


@pytest.mark.parametrize("shape", [(1, 1), (5, 1), (17, 33), (64, 64)])
def test_to_from_tiles_match_numpy(shape):
    img = np.random.default_rng(0).integers(0, 256, size=shape, dtype=np.uint8)
    tiles = tiled.to_tiles(torch.from_numpy(img), 8, 16)
    np.testing.assert_array_equal(tiles.numpy(), j_tiled.to_tiles(img, 8, 16))
    np.testing.assert_array_equal(tiled.from_tiles(tiles, *shape, 8, 16).numpy(), img)


def test_port_never_imports_jax():
    code = (
        "import sys, numpy as np\n"
        "import nblic_tpu_torch\n"
        "from nblic_tpu_torch import api\n"
        "img = (np.arange(40 * 24) % 251).astype(np.uint8).reshape(40, 24)\n"
        "c = api.compress_tiled(img, device='cpu', tile_h=8, tile_w=8)\n"
        "assert (api.decompress(c, device='cpu') == img).all()\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-2000:]


def test_unported_modes_raise():
    img = _natural(0, 16, 16)
    with pytest.raises(NotImplementedError, match="item 7"):
        api.compress_tiled(img, near=2, device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        api.compress_tiled(img, effort=2, device="cpu")
    with pytest.raises(NotImplementedError, match="items 9-11"):
        tiled.encode_corpus([img], effort=3, device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        api.decompress(j_tiled.encode(img, effort=2), device="cpu")
    with pytest.raises(ValueError, match="tile size"):
        api.compress_tiled(img, tile_h=0, device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        api.decompress(b"Q0.2" + bytes(8), device="cpu")


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    img = _natural(0, 16, 16)
    with pytest.raises(RuntimeError, match="cuda"):
        api.compress_tiled(img)
    stream = tiled.encode(img, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        api.decompress_tiled(stream, device="cuda")


def test_cli_roundtrip_matches_jax_container(tmp_path):
    img = _natural(30, 40, 72)
    src, enc, dec = (str(tmp_path / n) for n in ("in.bmp", "out.nbtc", "out.bmp"))
    imageio.save_image(src, img)
    assert cli.main(["-c", "--tiled", "--device=cpu", "--tile-h=16", "--tile-w=16",
                     src, enc]) == 0
    with open(enc, "rb") as f:
        assert f.read() == j_api.compress_tiled(img, tile_h=16, tile_w=16)
    assert cli.main(["-d", "--device=cpu", enc, dec]) == 0
    np.testing.assert_array_equal(imageio.load_image(dec), img)
    assert cli.main(["-c", "-n2", "--tiled", "--device=cpu", src, enc]) == -1
