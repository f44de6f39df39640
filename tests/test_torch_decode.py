"""The port's group decoders against nblic_tpu.

The plain decoder (``decode_groups`` and ``decode_groups8`` on CPU tensors)
decodes containers that ``nblic_tpu.models.tiled.encode`` wrote,
pixel-exact, and its tiles equal the Pallas decode kernels' in interpret
mode, pad lanes included: K2 at profiles 1 and 2, and K2', the 8-group
kernel of ``docs/experiments/pallas_decode8.py`` (at g = 128; at g = 48
the port is held to K2 and to nblic_tpu's decoder instead, see below).
The CUDA kernels are held against the plain decoder in
test_torch_cuda.py.  Integer math: tolerance 0.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import nblic_tpu.ops  # noqa: F401  (parent package of the 8-group kernel)
import numpy as np
import pytest
import torch

from nblic_tpu.models import tiled as j_tiled
from nblic_tpu.ops import pallas_decode
from nblic_tpu_torch.convert import group_args
from nblic_tpu_torch.models import tiled
from nblic_tpu_torch.ops import decode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one intra-op thread: parallel test workers each run many tiny torch ops,
# and idle OpenMP threads spinning between them starve the other workers
torch.set_num_threads(1)


def _load_pallas8():
    path = os.path.join(REPO, "docs", "experiments", "pallas_decode8.py")
    spec = importlib.util.spec_from_file_location("nblic_tpu.ops.pallas_decode8", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _wave(seed, h, w, noise):
    """A noisy plane wave: least-squares predictors win some tiles."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    fx, fy = rng.uniform(0.6, 1.2, 2)
    img = 128 + 100 * np.sin(fx * xx + fy * yy + rng.uniform(0, 6))
    return np.clip(np.rint(img + rng.normal(0, noise, (h, w))), 0, 255).astype(np.uint8)


def mixed(seed, h, w):
    """16 x 16 blocks of a wave and of noise, in a checkerboard: at 16 x 16
    tiles the race picks the learned predictor on about half the tiles."""
    yy, xx = np.mgrid[0:h, 0:w]
    on = ((yy // 16) + (xx // 16)) % 2 == 0
    noise = np.random.default_rng(seed + 1).integers(0, 256, size=(h, w))
    return np.where(on, _wave(seed, h, w, 0.5), noise).astype(np.uint8)


CASES = {
    "70x90-t16": ((70, 90), 16, 0, 1),
    "96x104-t8-multigroup": ((96, 104), 8, 0, 1),
    "48x64-t16-near2": ((48, 64), 16, 2, 1),
    "64x96-t16-p2": ((64, 96), 16, 0, 2),
    "48x64-t16-p2-near2": ((48, 64), 16, 2, 2),
}


def _pallas_tiles(p):
    hdr = p.hdr
    wmax = j_tiled._bucket(int(p.counts.max()))
    return np.asarray(pallas_decode.decode_groups_pallas(
        jnp.asarray(p.stream_matrix32((wmax + 1) // 2)), jnp.asarray(p.n_active()),
        jnp.asarray(p.bias)[None], jnp.asarray(p.hist_n)[None],
        jnp.asarray(p.acc)[None], jnp.asarray(p.weight_cols()),
        hdr.tile_h, hdr.tile_w, hdr.near, p.group_size, hdr.profile, True,
    ))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_decoder_matches_jax(case):
    shape, t, near, profile = CASES[case]
    if profile == 2:
        img = mixed(len(case), *shape)
    else:
        img = np.random.default_rng(len(case)).integers(0, 256, size=shape, dtype=np.uint8)
    stream = j_tiled.encode(img, near=near, tile_h=t, tile_w=t, effort=profile)
    p = j_tiled._Parsed(stream)
    assert p.hdr.profile == profile
    if case.endswith("multigroup"):
        assert len(p.counts) > 1
    if profile == 2 and near == 0:
        assert 0 < (p.flags > 0).sum() < len(p.flags)  # both predictors in play
    launches = decode.decode_groups.launches
    tiles = decode.decode_groups(*group_args([p], "cpu"))
    assert decode.decode_groups.launches == launches  # CPU tensors: plain version
    np.testing.assert_array_equal(tiles.numpy(), _pallas_tiles(p))
    flat = tiles.numpy().reshape(-1, t, t)[: p.hdr.n_tiles]
    dec = j_tiled.from_tiles(flat, *shape, t, t)
    assert np.abs(dec.astype(int) - img.astype(int)).max() <= near
    np.testing.assert_array_equal(dec, j_tiled.decode(stream))


def test_plain_decoder_profile2_every_flag_multigroup():
    imgs = [_wave(s, 96, 104, noise=1.0) for s in (1, 2)]
    conts = tiled._encode_flag_cycle(imgs, 8, "cpu")
    for c, im in zip(conts, imgs):
        p = j_tiled._Parsed(c)
        assert len(p.counts) > 1 and set(np.unique(p.flags)) == {0, 1, 2}
        np.testing.assert_array_equal(
            decode.decode_groups(*group_args([p], "cpu")).numpy(), _pallas_tiles(p))
        np.testing.assert_array_equal(j_tiled.decode(c), im)
    batch = tiled.decode_batch(conts, device="cpu")
    for d, im in zip(batch, imgs):
        np.testing.assert_array_equal(d, im)


@pytest.mark.parametrize("profile", [1, 2])
def test_decode_groups8_matches_pallas8_and_k2(profile):
    rng = np.random.default_rng(profile)
    imgs = [rng.integers(0, 256, size=(96, 104), dtype=np.uint8) for _ in range(5)]
    if profile == 2:
        conts = tiled._encode_flag_cycle(imgs, 8, "cpu")
    else:
        conts = tiled.encode_batch(imgs, tile_h=8, tile_w=8, device="cpu")
    parsed = [tiled._Parsed(c) for c in conts]
    n_groups = sum(len(p.counts) for p in parsed)
    args = group_args(parsed, "cpu", per_group_tables=True)
    assert n_groups > 8 and args[0].shape[0] == 16
    launches = decode.decode_groups8.launches
    tiles8 = decode.decode_groups8(*args)
    assert decode.decode_groups8.launches == launches
    words, n_active, bias, hist_n, acc, wcols, th, tw, near, g, _ = args
    if wcols is None:  # profile 1: the Pallas kernel takes the table all the same
        wcols = torch.zeros((words.shape[0], decode.N_WROWS, g), dtype=torch.int32)
    ref = _load_pallas8().decode_groups_pallas8(
        *(jnp.asarray(v.numpy()) for v in (words, n_active, bias, hist_n, acc, wcols)),
        th, tw, near, g, profile, True)
    np.testing.assert_array_equal(tiles8.numpy(), np.asarray(ref))
    k2 = decode.decode_groups(*group_args(parsed, "cpu"))
    np.testing.assert_array_equal(tiles8[:n_groups].numpy(), k2.numpy())


def test_decode_groups8_at_g48_matches_k2_and_nblic_tpu():
    # nblic_tpu's mesh at (1, 2) writes groups of t_total / 2 = 48 lanes: 3
    # images, 6 groups and 2 pad groups.  decode_groups_pallas8 is no
    # reference at this width: it reads each group's words from a 2 g-word
    # window at a 128-aligned base, which holds cursor + rank only where
    # g >= 128, and at g = 48 it returns other pixels without raising.
    from nblic_tpu.parallel import mesh as j_mesh

    rng = np.random.default_rng(48)
    imgs = [rng.integers(0, 256, size=(48, 128), dtype=np.uint8) for _ in range(3)]
    conts = j_mesh.encode_batch_mesh(
        imgs, j_mesh.make_mesh2(1, 2, devices=jax.devices("cpu")), 8, 8)
    parsed = [tiled._Parsed(c) for c in conts]
    assert {p.group_size for p in parsed} == {48}
    args = group_args(parsed, "cpu", per_group_tables=True)
    assert args[0].shape[0] == 8 and args[1][6:].tolist() == [0, 0]
    launches = decode.decode_groups8.launches
    tiles8 = decode.decode_groups8(*args)
    assert decode.decode_groups8.launches == launches
    k2 = decode.decode_groups(*group_args(parsed, "cpu"))
    np.testing.assert_array_equal(tiles8[:6].numpy(), k2.numpy())
    for b, (c, im) in enumerate(zip(conts, imgs)):
        flat = tiles8[2 * b : 2 * b + 2].numpy().reshape(-1, 8, 8)
        np.testing.assert_array_equal(j_tiled.from_tiles(flat, 48, 128, 8, 8), im)
        np.testing.assert_array_equal(j_tiled.decode(c), im)


def test_decode_groups_rejects_bad_inputs():
    img = np.random.default_rng(0).integers(0, 256, size=(16, 16), dtype=np.uint8)
    p = j_tiled._Parsed(j_tiled.encode(img, tile_h=8, tile_w=8))
    args = list(group_args([p], "cpu"))
    short = args.copy()
    short[0] = args[0][:, :100]  # narrower than the 2 g head words
    with pytest.raises(ValueError):
        decode.decode_groups(*short)
    tables = args.copy()
    tables[2] = args[2][:, :100]
    with pytest.raises(ValueError):
        decode.decode_groups(*tables)
    no_weights = args.copy()
    no_weights[5], no_weights[-1] = None, 2
    with pytest.raises(ValueError, match="wcols"):
        decode.decode_groups(*no_weights)
    with pytest.raises(ValueError, match="multiple of 8"):
        decode.decode_groups8(*args)  # one group, one table set
    padded = group_args([p], "cpu", per_group_tables=True)
    with pytest.raises(ValueError, match="one table set per group"):
        decode.decode_groups8(*padded[:2], *(t[:1] for t in padded[2:5]), *padded[5:])


def _slot_rows(case):
    """(R, 256) cumulative-frequency rows for the slot-table cases."""
    rng = np.random.default_rng(len(case))
    if case.startswith("container"):
        t = int(case.split("x")[-1])
        img = mixed(3, 128, 128)
        return torch.from_numpy(
            tiled._Parsed(tiled.encode(img, tile_h=t, tile_w=t, device="cpu")).acc)
    if case == "zero-bins":  # sparse counts, runs of empty bins mid-row
        hist = rng.integers(1, 400, size=(12, 256)) * (rng.random((12, 256)) < 0.25)
        hist[:, 40:120] = 0
        hist_n = tiled._norm_hist_dev(torch.from_numpy(hist))
    elif case == "empty-rows":  # _norm_hist_dev's (32767, 1, 0, ...)
        hist_n = tiled._norm_hist_dev(torch.zeros((12, 256), dtype=torch.int64))
        assert hist_n[0, 0] == 32767 and hist_n[0, 1] == 1
    else:  # the whole mass on symbol 255: exactly, and as _norm_hist_dev spills it
        one_hot = torch.zeros((1, 256), dtype=torch.int64)
        one_hot[0, 255] = 1000
        hist_n = torch.cat([torch.zeros((1, 256), dtype=torch.int32),
                            tiled._norm_hist_dev(one_hot)])
        hist_n[0, 255] = 1 << 15
    return torch.cumsum(hist_n, -1, dtype=torch.int32) - hist_n


@pytest.mark.parametrize("k", [8, 9, 10, 11, 12])
@pytest.mark.parametrize("case", ["container-8x8", "container-64x64", "zero-bins",
                                  "empty-rows", "mass-on-255"])
def test_slot_table_lookup_is_exact_for_every_slot(case, k):
    # K2's symbol search: the slot lookup and the bounded search in the span
    # give #{v : acc[v] <= lb} - 1 for all 2^15 slots of every row
    acc = _slot_rows(case).to(torch.int64).reshape(-1, 256)
    slots = decode.slot_table(acc, k)
    assert slots.shape == (acc.shape[0], (1 << k) + decode.SLOT_PAD)
    assert slots.dtype == torch.uint8 and (slots[:, 1 << k:] == 255).all()
    lb = torch.arange(1 << 15, dtype=torch.int64)
    rows = torch.arange(acc.shape[0])[:, None].expand(-1, lb.numel())
    y = decode.slot_search(acc, slots, rows, lb.expand(acc.shape[0], -1), k)
    want = torch.stack([(r[None, :] <= lb[:, None]).sum(-1) - 1 for r in acc])
    assert torch.equal(y, want)


@pytest.mark.parametrize("profile", [1, 2])
def test_plain_decoder_through_slot_table(profile):
    rng = np.random.default_rng(profile)
    imgs = [rng.integers(0, 256, size=(96, 104), dtype=np.uint8), _wave(4, 96, 104, 1.0)]
    conts = (tiled._encode_flag_cycle(imgs, 8, "cpu") if profile == 2
             else tiled.encode_batch(imgs, tile_h=8, tile_w=8, device="cpu"))
    args = group_args([tiled._Parsed(c) for c in conts], "cpu")
    assert args[0].shape[0] == 4  # two groups an image
    ref = decode.group_decode_plain(*args)
    for k in (8, decode.SLOT_BITS):
        assert torch.equal(decode.group_decode_plain(*args, slot_bits=k), ref)
