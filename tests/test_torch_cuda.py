"""The CUDA kernels against their plain versions, on the card.

Every test here needs a GPU and skips without one.  The file imports no JAX,
so it runs on a machine that has none:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Inputs come from numpy seeds and from the port's own encoder, whose
containers the CPU tests hold byte-identical to nblic_tpu's.  Integer math:
tolerance 0.
"""

import os

import numpy as np
import pytest
import torch

from nblic_tpu_torch.convert import group_args, tables_from_numpy
from nblic_tpu_torch.models import strips, tiled
from nblic_tpu_torch.ops import (
    avp, decode, decode_walk, fold, lsq, model_pass, near_scan, near_walk, pavp, rans, rans_bin,
    row_scan, table_replay,
)
from nblic_tpu_torch.utils.synth import edge_images, synth_image


def scan_inputs(seed, b, n_tiles, t, profile):
    """(x, bias, wcols) of ``b`` images of ``n_tiles`` t x t tiles each
    (``t`` an int, or (th, tw)).

    Tiles cycle through a noisy ramp, uniform noise and a saturated plateau
    (0 or 255 with a few outliers), so the fold takes both of its branches
    and the clamps bind.  Each image's bias table is its own, with a twentieth
    of its entries at -32768 or 32767.  At profile 2 the weights are each
    tile's least-squares fit, every fourth tile random int16 weights, and
    the flags cycle 0, 1, 2.
    """
    rng = np.random.default_rng(seed)
    th, tw = (t, t) if isinstance(t, int) else t
    yy, xx = np.mgrid[0:th, 0:tw]
    x = np.empty((b, n_tiles, th, tw), dtype=np.int32)
    for k in range(b * n_tiles):
        kind = k % 3
        if kind == 0:
            tile = (yy * rng.integers(1, 9) + xx * rng.integers(-4, 5)
                    + rng.integers(0, 256) + rng.normal(0, 4, (th, tw)))
        elif kind == 1:
            tile = rng.integers(0, 256, (th, tw))
        else:
            tile = np.where(rng.random((th, tw)) < 0.1, rng.integers(0, 256, (th, tw)),
                            255 * (k % 2))
        x.flat[k * th * tw:(k + 1) * th * tw] = np.clip(tile, 0, 255).astype(np.int32).ravel()
    bias = rng.integers(-2048, 2048, size=(b, 3072)).astype(np.int32)
    ends = rng.random((b, 3072)) < 0.05
    bias[ends] = rng.choice([-32768, 32767], size=int(ends.sum()))
    wcols = None
    if profile == 2:
        w_q, _ = lsq.fit_tile_weights(torch.from_numpy(x).view(b * n_tiles, th, tw))
        w_q = w_q.view(b, n_tiles, lsq.N_FEAT)
        wild = torch.from_numpy(rng.integers(-32768, 32768, size=w_q.shape).astype(np.int32))
        w_q = torch.where((torch.arange(n_tiles) % 4 == 3)[None, :, None], wild, w_q)
        flags = torch.arange(b * n_tiles, dtype=torch.int32).view(b, n_tiles) % 3
        wcols = tiled._lane_wcols(w_q, flags)
    return torch.from_numpy(x), torch.from_numpy(bias), wcols


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("s,l", [(3000, 700), (1, 1), (129, 0)])
def test_fold_kernel_matches_plain(cuda_device, s, l):
    rng = np.random.default_rng(s + l)
    freq = rng.integers(1, 1 << 15, size=(s, l)).astype(np.int32)
    acc = rng.integers(0, 1 << 14, size=(s, l)).astype(np.int32)
    freq[: s // 10] = 1 << 15  # identity lanes
    acc[: s // 10] = 0
    f, a = torch.from_numpy(freq).to(cuda_device), torch.from_numpy(acc).to(cuda_device)
    launches = fold.encode_fold.launches
    w1, e1, s1 = fold.encode_fold(f, a)
    w2, e2, s2 = rans.encode_scan(f, a)
    torch.cuda.synchronize()
    assert fold.encode_fold.launches == launches + 1
    assert torch.equal(e1, e2) and torch.equal(w1[e1], w2[e2]) and torch.equal(s1, s2)


@pytest.mark.cuda
@pytest.mark.parametrize("s,l,offset", [(3072, 300, 0), (3001, 37, 0), (512, 70, 1)])
def test_fold_kernel_unaligned_tables(cuda_device, s, l, offset):
    # S % 4 != 0 and a table 4 bytes off 16-byte alignment take the kernel's
    # 4-byte copies; L % 16 != 0 leaves a partial chunk
    rng = np.random.default_rng(s)
    freq = rng.integers(1, 1 << 15, size=(l, s)).astype(np.int32)
    acc = rng.integers(0, 1 << 14, size=(l, s)).astype(np.int32)
    flat_f = torch.zeros(l * s + offset, dtype=torch.int32, device=cuda_device)
    flat_a = torch.zeros_like(flat_f)
    f = flat_f[offset:].view(l, s)
    a = flat_a[offset:].view(l, s)
    f.copy_(torch.from_numpy(freq))
    a.copy_(torch.from_numpy(acc))
    w1, e1, s1 = fold.encode_fold(f.t(), a.t())
    w2, e2, s2 = rans.encode_scan(f.t(), a.t())
    torch.cuda.synchronize()
    assert torch.equal(e1, e2) and torch.equal(w1[e1], w2[e2]) and torch.equal(s1, s2)


@pytest.mark.cuda
@pytest.mark.parametrize("profile", [1, 2])
@pytest.mark.parametrize("shape,t,n", [((70, 90), 16, 1), ((96, 104), 8, 1),
                                       ((130, 200), 64, 3), ((9, 300), 4, 2)])
def test_decode_kernel_matches_plain(cuda_device, shape, t, n, profile):
    rng = np.random.default_rng(t)
    imgs = [rng.integers(0, 256, size=shape, dtype=np.uint8) for _ in range(n)]
    conts = (tiled._encode_flag_cycle(imgs, t, "cpu") if profile == 2
             else tiled.encode_batch(imgs, tile_h=t, tile_w=t, device="cpu"))
    args = group_args([tiled._Parsed(c) for c in conts], cuda_device)
    launches = decode.decode_groups.launches
    k = decode.decode_groups(*args)
    torch.cuda.synchronize()
    assert decode.decode_groups.launches == launches + 1
    assert torch.equal(k, decode.group_decode_plain(*args))


def _container_args(imgs, t, profile, device):
    conts = (tiled._encode_flag_cycle(imgs, t, device) if profile == 2
             else tiled.encode_batch(imgs, tile_h=t, tile_w=t, device=device))
    return list(group_args([tiled._Parsed(c) for c in conts], device))


@pytest.mark.cuda
@pytest.mark.parametrize("profile", [1, 2])
@pytest.mark.parametrize("width", ["2g", "2g+8", "2g+100", "half"])
def test_decode_kernel_truncated_streams(cuda_device, profile, width):
    # the cursor runs past W: every later read takes word W - 1, which the
    # kernel's stream ring must keep, as the plain decoder does
    rng = np.random.default_rng(7)
    imgs = [rng.integers(0, 256, size=(96, 104), dtype=np.uint8)]
    args = _container_args(imgs, 8, profile, cuda_device)
    g = args[9]
    w = {"2g": 2 * g, "2g+8": 2 * g + 8, "2g+100": 2 * g + 100,
         "half": args[0].shape[1] // 2}[width]
    args[0] = args[0][:, :w]
    k = decode.decode_groups(*args)
    torch.cuda.synchronize()
    assert torch.equal(k, decode.group_decode_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("profile", [1, 2])
def test_decode_kernel_long_multigroup_streams(cuda_device, profile):
    # noise at 64x64 tiles: 2 groups whose streams wrap the ring hundreds of times
    rng = np.random.default_rng(11)
    args = _container_args([rng.integers(0, 256, size=(768, 1024), dtype=np.uint8)],
                           64, profile, cuda_device)
    ring = decode.kernels.library().nbt_group_decode_ring_words(args[9])
    assert args[0].shape[0] == 2 and args[0].shape[1] > 100 * ring
    k = decode.decode_groups(*args)
    torch.cuda.synchronize()
    assert torch.equal(k, decode.group_decode_plain(*args))


def _arbitrary(rng, b, npg, g, near, profile, device, hist_n=None):
    """Random words, bias, tables and weights: the output is noise, but the
    kernels and the plain version must walk the same states, cursor clamps,
    predictions and near unfolds."""
    if hist_n is None:
        hist = rng.integers(0, 50, size=(b, 12, 256))
        hist_n = tiled._norm_hist_dev(torch.from_numpy(hist)).numpy()
    acc = np.cumsum(hist_n, axis=-1) - hist_n
    bias = rng.integers(-(1 << 11), 1 << 11, size=(b, 3072))
    words = torch.from_numpy(rng.integers(0, 1 << 16, size=(b * npg, 300)).astype(np.int32))
    n_active = torch.from_numpy(rng.integers(0, g + 1, size=b * npg).astype(np.int32))
    n_active[0] = g
    wcols = rng.integers(-(1 << 15) + 1, 1 << 15, size=(b * npg, 16, g))
    wcols[:, 12] = rng.integers(0, 3, size=(b * npg, g))
    return (words.to(device), n_active.to(device),
            *tables_from_numpy(bias, hist_n, acc, device),
            torch.from_numpy(wcols.astype(np.int32)).to(device), 8, 8, near, g, profile)


@pytest.mark.cuda
@pytest.mark.parametrize("profile", [1, 2])
@pytest.mark.parametrize("near", [0, 2, 9])
def test_decode_kernel_matches_plain_on_arbitrary_streams(cuda_device, near, profile):
    args = _arbitrary(np.random.default_rng(near), 2, 2, 64, near, profile, cuda_device)
    k = decode.decode_groups(*args)
    torch.cuda.synchronize()
    assert torch.equal(k, decode.group_decode_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("profile", [1, 2])
@pytest.mark.parametrize("g", [1, 2, 3, 6, 24, 33, 48, 128])
@pytest.mark.parametrize("width", ["300", "2g"])
def test_decode_kernel_any_group_width(cuda_device, g, profile, width):
    # the mesh writes groups of t_total / n_tiles lanes (2, 6, 24, 48, ...):
    # the threads past g idle, and a stream of exactly 2 g words (an odd g's
    # head chunk starts at word 2 g - 2) still clamps to word W - 1
    args = list(_arbitrary(np.random.default_rng(g), 2, 3, g, 2 if g % 2 else 0, profile,
                           cuda_device))
    if width == "2g":
        args[0] = args[0][:, : 2 * g]
    launches = decode.decode_groups.launches
    k = decode.decode_groups(*args)
    torch.cuda.synchronize()
    assert decode.decode_groups.launches == launches + 1
    assert torch.equal(k, decode.group_decode_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["p1_1x4", "p1_2x2"])
def test_decode_kernel_on_jax_mesh_fixtures(cuda_device, name):
    # nblic_tpu's mesh containers (g = 2 with a whole pad group, g = 6)
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data_torch_mesh")
    imgs = np.load(os.path.join(data, name + ".npy"))
    conts = []
    for i in range(len(imgs)):
        with open(os.path.join(data, f"{name}_{i}.nbtc"), "rb") as f:
            conts.append(f.read())
    args = group_args([tiled._Parsed(c) for c in conts], cuda_device)
    k = decode.decode_groups(*args)
    torch.cuda.synchronize()
    assert torch.equal(k, decode.group_decode_plain(*args))
    for back, img in zip(tiled.decode_batch(conts, device=cuda_device), imgs):
        np.testing.assert_array_equal(back, img)


@pytest.mark.cuda
@pytest.mark.parametrize("profile", [1, 2])
@pytest.mark.parametrize("case", ["zero-bins", "empty-rows", "mass-on-255"])
def test_decode_kernel_slot_table_edge_cases(cuda_device, case, profile):
    # the slot table each CTA builds must give the last of a run of empty
    # bins, and cover rows whose whole mass sits on one symbol
    rng = np.random.default_rng(len(case))
    hist = np.zeros((2, 12, 256), dtype=np.int64)
    if case == "zero-bins":
        hist = rng.integers(1, 400, size=hist.shape) * (rng.random(hist.shape) < 0.25)
        hist[..., 40:120] = 0
    elif case == "mass-on-255":
        hist[..., 255] = 1000
    hist_n = tiled._norm_hist_dev(torch.from_numpy(hist)).numpy()
    if case == "mass-on-255":  # exactly, in the first row of each set
        hist_n[:, 0] = 0
        hist_n[:, 0, 255] = 1 << 15
    args = _arbitrary(rng, 2, 2, 128, 0, profile, cuda_device, hist_n)
    k = decode.decode_groups(*args)
    torch.cuda.synchronize()
    assert torch.equal(k, decode.group_decode_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("profile", [1, 2])
@pytest.mark.parametrize("g,t", [(128, 8), (64, 16), (32, 64), (48, 16), (6, 8)])
def test_decode8_kernel_matches_plain_and_k2(cuda_device, profile, g, t):
    # 16 groups with per-group tables, one CTA each; g = 48 and 6 leave the
    # last warp's threads past g idle; the last group is a pad group
    # (n_active = 0, zero words), as group_args pads
    rng = np.random.default_rng(g + profile)
    args = list(_arbitrary(rng, 16, 1, g, 2, profile, cuda_device))
    args[6] = args[7] = t
    args[0][-1] = 0
    args[1][-1] = 0
    launches, k2_launches = decode.decode_groups8.launches, decode.decode_groups.launches
    k8 = decode.decode_groups8(*args)
    torch.cuda.synchronize()
    assert decode.decode_groups8.launches == launches + 1
    assert decode.decode_groups.launches == k2_launches  # a K2' launch is not K2's
    assert torch.equal(k8, decode.group_decode_plain(*args))
    assert torch.equal(k8, decode.decode_groups(*args))


@pytest.mark.cuda
def test_decode8_kernel_on_containers(cuda_device):
    rng = np.random.default_rng(8)
    imgs = [rng.integers(0, 256, size=(96, 104), dtype=np.uint8) for _ in range(4)]
    conts = tiled._encode_flag_cycle(imgs, 8, "cpu")
    # one table set per group: 8 groups
    args = group_args([tiled._Parsed(c) for c in conts], cuda_device,
                      per_group_tables=True)
    assert args[0].shape[0] == 8
    k8 = decode.decode_groups8(*args)
    torch.cuda.synchronize()
    assert torch.equal(k8, decode.decode_groups(*args))
    assert torch.equal(k8, decode.group_decode_plain(*args))


@pytest.mark.cuda
def test_main_path_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, size=(80, 120), dtype=np.uint8),
            rng.integers(0, 256, size=(120, 80), dtype=np.uint8)]
    on_card = tiled.encode_corpus(imgs, tile_h=16, tile_w=16, device=cuda_device)
    assert on_card == tiled.encode_corpus(imgs, tile_h=16, tile_w=16, device="cpu")
    for im, c in zip(imgs, on_card):
        np.testing.assert_array_equal(tiled.decode(c, device=cuda_device), im)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [16, 64])
def test_profile2_on_card_matches_cpu(cuda_device, t):
    rng = np.random.default_rng(t)
    yy, xx = np.mgrid[0:128, 0:192]
    wave = np.clip(128 + 100 * np.sin(0.9 * xx + 0.7 * yy) + rng.normal(0, 1, yy.shape),
                   0, 255).astype(np.uint8)
    imgs = [wave, rng.integers(0, 256, size=(128, 192), dtype=np.uint8)]
    # the fit is exact on both devices; the float32 race may flip a near-tie
    tiles = tiled.to_tiles(torch.from_numpy(np.stack(imgs)), t, t)
    *_, w_q, flags = tiled._model_lossless2_impl(tiles)
    cpu = tiled._encode_batch(imgs, t, t, 2, None, torch.device("cpu"), (w_q, flags))
    card = tiled._encode_batch(imgs, t, t, 2, None, cuda_device,
                               (w_q.to(cuda_device), flags.to(cuda_device)))
    assert card == cpu
    free = tiled.encode_batch(imgs, tile_h=t, tile_w=t, effort=2, device=cuda_device)
    for im, c in zip(imgs, free):
        np.testing.assert_array_equal(tiled.decode(c, device=cuda_device), im)
        np.testing.assert_array_equal(tiled.decode(c, device="cpu"), im)


@pytest.mark.cuda
@pytest.mark.parametrize("effort", [1, 2])
def test_near_encode_on_card_matches_cpu(cuda_device, effort):
    rng = np.random.default_rng(20 + effort)
    yy, xx = np.mgrid[0:64, 0:96]
    wave = np.clip(128 + 100 * np.sin(0.9 * xx + 0.7 * yy) + rng.normal(0, 1, yy.shape),
                   0, 255).astype(np.uint8)
    imgs = [wave, rng.integers(0, 256, size=(64, 96), dtype=np.uint8)]
    card = tiled.encode_batch(imgs, near=2, tile_h=16, tile_w=16, effort=effort,
                              device=cuda_device)
    assert card == tiled.encode_batch(imgs, near=2, tile_h=16, tile_w=16, effort=effort,
                                      device="cpu")
    launches = decode.decode_groups.launches
    for im, c in zip(imgs, card):
        for dev in (cuda_device, "cpu"):
            err = tiled.decode(c, device=dev).astype(int) - im.astype(int)
            assert np.abs(err).max() <= 2
    assert decode.decode_groups.launches == launches + len(imgs)


@pytest.mark.cuda
@pytest.mark.parametrize("tune", ["TUNE_V4", "TUNE_MAX", "TUNE_V4S"])
@pytest.mark.parametrize("th", [16, 64])
def test_profile3_on_card_matches_cpu(cuda_device, monkeypatch, tune, th):
    monkeypatch.setattr(strips, "TUNE", getattr(strips, tune))
    rng = np.random.default_rng(th)
    imgs = [rng.integers(0, 256, size=(48, 64), dtype=np.uint8),
            np.clip(np.add.outer(np.arange(64), np.arange(48)) * 2 + rng.integers(
                0, 6, size=(64, 48)), 0, 255).astype(np.uint8)]
    card = strips.encode_batch(imgs, th=th, device=cuda_device)
    assert card == strips.encode_batch(imgs, th=th, device="cpu")
    assert card[0] == strips.encode(imgs[0], th=th, device=cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("tune", ["TUNE_V4", "TUNE_MAX", "TUNE_V4S"])
@pytest.mark.parametrize("th", [16, 64])
def test_profile3_decode_on_card_matches_cpu(cuda_device, monkeypatch, tune, th):
    monkeypatch.setattr(strips, "TUNE", getattr(strips, tune))
    rng = np.random.default_rng(th + 1)
    # 70 rows: two strips at either height (th is clamped to the image)
    imgs = [rng.integers(0, 256, size=(70, 24), dtype=np.uint8),
            np.clip(np.add.outer(np.arange(24), np.arange(70)) * 3 + rng.integers(
                0, 6, size=(24, 70)), 0, 255).astype(np.uint8)]
    conts = strips.encode_batch(imgs, th=th, device="cpu")
    card = strips.decode_batch(conts, device=cuda_device)
    cpu = strips.decode_batch(conts, device="cpu")
    for a, b, im in zip(card, cpu, imgs):
        np.testing.assert_array_equal(a, im)
        np.testing.assert_array_equal(b, im)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["near2", "legacy", "static"])
def test_profile3_fixtures_decode_on_card(cuda_device, name):
    import os

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data_torch_p3")
    with open(os.path.join(data, name + ".nbtc"), "rb") as f:
        stream = f.read()
    np.testing.assert_array_equal(strips.decode(stream, device=cuda_device),
                                  np.load(os.path.join(data, name + ".npy")))


@pytest.mark.cuda
@pytest.mark.parametrize("tune", ["TUNE_V4", "TUNE_MAX", "TUNE_V4S"])
@pytest.mark.parametrize("near", [1, 2, 3])
def test_profile3_near_on_card_matches_cpu(cuda_device, monkeypatch, tune, near):
    monkeypatch.setattr(strips, "TUNE", getattr(strips, tune))
    rng = np.random.default_rng(30 + near)
    imgs = [synth_image(rng, 24, 32), synth_image(rng, 32, 24)]
    card = strips.encode_batch(imgs, th=16, near=near, device=cuda_device)
    assert card == strips.encode_batch(imgs, th=16, near=near, device="cpu")
    assert all(strips._parse(c)[0][6] == near for c in card)
    for got, im in zip(strips.decode_batch(card, device=cuda_device), imgs):
        assert np.abs(got.astype(int) - im.astype(int)).max() <= near


@pytest.mark.cuda
def test_profile3_near2_fixture_encoded_on_card(cuda_device):
    import os

    # the image of test_torch_p3_fixtures.fixture_image(), whose near-2
    # container nblic_tpu wrote
    img = synth_image(np.random.default_rng(71), 40, 24)
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data_torch_p3")
    with open(os.path.join(data, "near2.nbtc"), "rb") as f:
        assert strips.encode(img, th=16, near=2, device=cuda_device) == f.read()


@pytest.mark.cuda
@pytest.mark.parametrize("l", [1, 17, 4099])
def test_fold_kernel_one_stream(cuda_device, l):
    # the Q0.2 encoder's shape: S = 1, one thread walks the chain, L not a
    # multiple of the kernel's 16-row chunk
    rng = np.random.default_rng(l)
    f = torch.from_numpy(rng.integers(1, 1 << 15, size=(1, l))).to(cuda_device)
    a = torch.from_numpy(rng.integers(0, 1 << 14, size=(1, l))).to(cuda_device)
    out, ref = fold.encode_fold(f, a), rans.encode_scan(f, a)
    assert all(torch.equal(u, v) for u, v in zip(out, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("near,effort", [(0, 0), (0, 1), (2, 1), (0, 3)])
def test_interop_engines_on_card_match_cpu(cuda_device, near, effort):
    from nblic_tpu_torch import api

    img = synth_image(np.random.default_rng(8), 6, 10)
    on_card = api.compress(img, near=near, effort=effort, device=cuda_device)
    assert on_card == api.compress(img, near=near, effort=effort, device="cpu")
    assert on_card == api.compress(img, near=near, effort=effort, backend="native")
    np.testing.assert_array_equal(api.decompress(on_card, device=cuda_device),
                                  api.decompress(on_card, backend="native"))


# K6 (the interop walks) against the plain walks and the native runtime
# copy: the CPU test's images (make_test_images's small ones), the 6x10
# synth image, a width of 33 (not a multiple of the warp) and a 64x64 flat
# image.  The plain walks run on the card where an image has at most 64
# pixels (a plain step takes 3-15 ms there), on the CPU beside them.
def _k6_images():
    rng = np.random.default_rng(1234)
    imgs = {f"{h}x{w}": rng.integers(0, 256, size=(h, w), dtype=np.uint8)
            for h, w in ((1, 1), (1, 7), (5, 1), (8, 8), (23, 17))}
    imgs["flat0"] = np.zeros((16, 16), np.uint8)
    imgs["flat255"] = np.full((16, 16), 255, np.uint8)
    imgs["synth6x10"] = synth_image(np.random.default_rng(8), 6, 10)
    imgs["w33"] = synth_image(np.random.default_rng(9), 7, 33)
    imgs["flat64"] = np.full((64, 64), 131, np.uint8)
    return imgs


K6_MODES = [(1, 0), (2, 0), (3, 0), (1, 2), (1, 9), (2, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("effort,near", K6_MODES)
@pytest.mark.parametrize("name", list(_k6_images()))
def test_interop_walk_nblic_matches_plain(cuda_device, effort, near, name):
    from nblic_tpu_torch import runtime
    from nblic_tpu_torch.models import nblic
    from nblic_tpu_torch.ops import interop_walk

    img = _k6_images()[name]
    launches = interop_walk.nblic_walk.launches
    on_card = nblic.encode(img, near=near, effort=effort, device=cuda_device)
    back = nblic.decode(on_card, device=cuda_device)
    assert interop_walk.nblic_walk.launches == launches + 2  # one launch a walk
    assert on_card == runtime.n_encode(img, near=near, effort=effort)
    np.testing.assert_array_equal(back, runtime.n_decode(on_card)[0])
    assert int(np.abs(back.astype(int) - img.astype(int)).max()) <= near
    if img.size > 400:  # the native copy alone, which the CPU tests hold to the plain walk
        return
    with pytest.MonkeyPatch.context() as m:
        m.setattr(nblic, "_walk", nblic._walk_plain)
        where = cuda_device if img.size <= 64 else "cpu"
        assert on_card == nblic.encode(img, near=near, effort=effort, device=where)
        np.testing.assert_array_equal(back, nblic.decode(on_card, device=where))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_k6_images()))
def test_interop_walk_q_decode_matches_plain(cuda_device, name):
    from nblic_tpu_torch import runtime
    from nblic_tpu_torch.models import qnblic
    from nblic_tpu_torch.ops import interop_walk

    img = _k6_images()[name]
    stream = runtime.q_encode(img, n_threads=1)
    launches = interop_walk.q_decode_walk.launches
    got = qnblic.decode(stream, device=cuda_device)
    assert interop_walk.q_decode_walk.launches == launches + 1
    np.testing.assert_array_equal(got, img)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(qnblic, "_decode_walk", qnblic._decode_walk_plain)
        where = cuda_device if img.size <= 256 else "cpu"
        np.testing.assert_array_equal(got, qnblic.decode(stream, device=where))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["random", "flat64", "w33", "synth6x10", "1x1"])
def test_interop_walk_context_chain_matches_plain(cuda_device, name):
    from nblic_tpu_torch import runtime
    from nblic_tpu_torch.models import qnblic
    from nblic_tpu_torch.ops import interop_walk, predict

    imgs = _k6_images()
    imgs["random"] = np.random.default_rng(7).integers(0, 256, (37, 29), dtype=np.uint8)
    img = imgs[name]
    x = torch.from_numpy(img).to(cuda_device).to(torch.int32)
    px0, err, _, adr = predict.model_stage1(x)
    launches = interop_walk.context_before.launches
    got = qnblic._context_chain_card(x, px0, err, adr)
    assert interop_walk.context_before.launches == launches + 1
    assert torch.equal(got, qnblic._context_chain_plain(x, px0, err, adr))
    assert qnblic.encode(img, device=cuda_device) == runtime.q_encode(img, n_threads=1)


def _k6_hostile():
    """The hostile streams of test_torch_interop_api.py, built by the
    native runtime copy: (kind, stream)."""
    from nblic_tpu_torch import runtime
    from nblic_tpu_torch.ops import histogram
    from nblic_tpu_torch.utils.container import QnblicHeader

    img = np.random.default_rng(0).integers(0, 256, (4, 5), dtype=np.uint8)
    stream = runtime.n_encode(img, near=0, effort=1)
    rng = np.random.default_rng(1)
    bad = [stream[:-1], stream[:-3]]
    bad += [stream[:16] + rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (1, 3, 40)]
    bad.append(runtime.n_encode(np.array([[9, 200]], np.uint8), near=0, effort=1)[:17])
    for effort, near in ((2, 0), (3, 0), (1, 5)):
        b = bytearray(bad[4])
        b[13], b[15] = near, effort
        bad.append(bytes(b))
    out = [("nblic", b) for b in bad]
    img = np.random.default_rng(2).integers(0, 256, (6, 7), dtype=np.uint8)
    stream = runtime.q_encode(img, n_threads=1)
    body = len(stream) // 2 * 2
    words = np.frombuffer(stream[:body], dtype=np.uint16)
    pos = QnblicHeader.SIZE // 2
    for _ in range(12):
        _, pos = histogram.deserialize(words, pos)
    rng = np.random.default_rng(3)
    out += [("q", stream[:body - 20]),
            ("q", stream[:-2] + rng.integers(0, 256, 2, dtype=np.uint8).tobytes()),
            ("q", stream[:2 * pos + 2])]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(12))
def test_interop_walk_hostile_streams_match_plain(cuda_device, case):
    from nblic_tpu_torch.models import nblic, qnblic

    kind, b = _k6_hostile()[case]
    model = nblic if kind == "nblic" else qnblic
    got = model.decode(b, device=cuda_device)
    np.testing.assert_array_equal(got, model.decode(b, device="cpu"))  # the plain walk


@pytest.mark.cuda
def test_interop_walk_refusals_on_card(cuda_device, monkeypatch):
    from nblic_tpu_torch import kernels, runtime
    from nblic_tpu_torch.models import nblic, qnblic

    img = np.random.default_rng(4).integers(0, 256, (6, 6), dtype=np.uint8)
    with monkeypatch.context() as m:
        m.setattr(nblic, "capacity", lambda h, w: 8)
        for effort in (1, 3):
            with pytest.raises(ValueError, match="capacity"):
                nblic.encode(img, effort=effort, device=cuda_device)
    stream = bytearray(runtime.n_encode(img, near=0, effort=1))
    stream[14] = 1  # k_step 1
    with pytest.raises(ValueError, match="k_step"):
        nblic.decode(bytes(stream), device=cuda_device)
    with pytest.raises(ValueError, match="empty"):
        qnblic._decode_walk(torch.zeros(0, dtype=torch.int64, device=cuda_device), None, None,
                            None, 2, 2)
    lib = kernels.library()
    assert lib.nbt_interop_nblic_walk(None, None, None, None, None, None, None, 0, None, None,
                                      None, 1, 1, 0, 3, 4, 1, 0, None) != 0  # effort 4
    assert lib.nbt_interop_walk_smem(3) <= kernels.SMEM_LIMIT


# K7 against its plain version: the CPU cases of test_torch_near_scan.py
# (three images, (tile side or (th, tw), tiles an image, profile, near)),
# then lane counts that are not a multiple of the CTA's 32 lanes (1, 31,
# 33, a mesh-like 48) and the corpus's 1,728 at 8x8 tiles; then the main
# path's 64x64 and 16x16 tiles at profiles 1 and 2 and near 1, 2, 9 and
# 255, and widths not divisible by 4: 6x6 (36 pixels a tile: the 16-byte
# chunks straddle rows) and 5x7 (35: a pixel a copy and a store)
K7_CASES = {
    "t8-p1-near1": (3, 15, 8, 1, 1),
    "t8-p1-near255": (3, 15, 8, 1, 255),
    "t8-p2-near2": (3, 15, 8, 2, 2),
    "t8-p2-near9": (3, 15, 8, 2, 9),
    "t16-p1-near2": (3, 6, 16, 1, 2),
    "t16-p1-near9": (3, 6, 16, 1, 9),
    "t16-p2-near1": (3, 6, 16, 2, 1),
    "t16-p2-near255": (3, 6, 16, 2, 255),
    "t64-p1-near2": (3, 2, 64, 1, 2),
    "lanes1": (1, 1, 16, 1, 2),
    "lanes31-p2": (1, 31, 8, 2, 9),
    "lanes33": (3, 11, 16, 1, 255),
    "lanes48-p2": (2, 24, 16, 2, 1),
    "lanes1728": (18, 96, 8, 1, 2),
    "lanes1728-p2": (18, 96, 8, 2, 2),
    "t64-p1-near1": (2, 3, 64, 1, 1),
    "t64-p2-near2": (2, 3, 64, 2, 2),
    "t64-p2-near9": (2, 3, 64, 2, 9),
    "t64-p1-near255": (2, 3, 64, 1, 255),
    "t16-p1-near1-lanes96": (2, 48, 16, 1, 1),
    "t16-p2-near2-lanes96": (2, 48, 16, 2, 2),
    "t6x6-p1-near2": (3, 40, (6, 6), 1, 2),
    "t6x6-p2-near9": (3, 40, (6, 6), 2, 9),
    "t5x7-p1-near1": (2, 35, (5, 7), 1, 1),
    "t5x7-p2-near255": (2, 35, (5, 7), 2, 255),
    "t16x6-p2-near2": (2, 33, (16, 6), 2, 2),
}


def _tile_shape(t):
    return (t, t) if isinstance(t, int) else t


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K7_CASES))
def test_near_scan_kernel_matches_plain(cuda_device, monkeypatch, case):
    b, n_tiles, t, profile, near = K7_CASES[case]
    th, tw = _tile_shape(t)
    x, bias, wcols = (v.to(cuda_device) if v is not None else None
                      for v in scan_inputs(b + n_tiles + (t if isinstance(t, int) else th * tw)
                                           + profile + near, b, n_tiles, t, profile))
    launch, handed = near_scan.launch, []

    def seen(xs, *args):
        handed.append(xs.data_ptr())
        launch(xs, *args)

    monkeypatch.setattr(near_scan, "launch", seen)
    launches = near_scan.encode_scan.launches
    k = near_scan.encode_scan(x, bias, wcols, th, tw, near, profile, stats=True)
    k_ys = near_scan.encode_scan(x, bias, wcols, th, tw, near, profile)
    torch.cuda.synchronize()
    assert near_scan.encode_scan.launches == launches + 2
    assert handed == [x.data_ptr()] * 2  # the tiles' own layout: no copy
    ref = near_scan.encode_scan_plain(x, bias, wcols, th, tw, near, profile, stats=True)
    for name, u, v in zip(("y", "qd", "adr", "err", "rec"), k, ref):
        assert u.shape == x.shape and torch.equal(u, v), name
    assert len(k_ys) == 2 and torch.equal(k_ys[0], ref[0]) and torch.equal(k_ys[1], ref[1])


@pytest.mark.cuda
def test_near_scan_kernel_refuses_what_it_cannot_hold(cuda_device):
    x = torch.zeros((1, 1, 1, 4000), dtype=torch.int32, device=cuda_device)
    bias = torch.zeros((1, 3072), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):  # two rows of 4000 columns x 32 lanes
        near_scan.encode_scan(x, bias, None, 1, 4000, 2, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("effort", [1, 2])
@pytest.mark.parametrize("near", [2, 9])
def test_near_encode_corpus_on_card_matches_cpu(cuda_device, near, effort):
    rng = np.random.default_rng(30 + near + effort)
    imgs = [synth_image(rng, 48, 80), synth_image(rng, 80, 48)]
    launches = near_scan.encode_scan.launches
    card = tiled.encode_corpus(imgs, near=near, tile_h=16, tile_w=16, effort=effort,
                               device=cuda_device)
    # two shapes, two batches, each a refinement scan and a final scan
    assert near_scan.encode_scan.launches == launches + 4
    assert card == tiled.encode_corpus(imgs, near=near, tile_h=16, tile_w=16, effort=effort,
                                       device="cpu")
    for im, c in zip(imgs, card):
        err = tiled.decode(c, device=cuda_device).astype(int) - im.astype(int)
        assert np.abs(err).max() <= near


# K5 against the plain walk on the card: (lanes, images, strip height,
# width, near, contract); lanes that are not a multiple of the CTA's 32,
# images mixed in a warp, a strip of one row and one taller than 16 rows
K5_CASES = {
    "lanes1-mix-near1": (1, 1, 5, 16, 1, "TUNE_V4"),
    "lanes1-nomix-near9": (1, 1, 4, 12, 9, "TUNE_V4S"),
    "lanes31-nomix-near2": (31, 1, 3, 12, 2, "TUNE_V4S"),
    "lanes31-mix-near255": (31, 31, 2, 10, 255, "TUNE_V4"),
    "lanes33-mix-near9": (33, 3, 3, 12, 9, "TUNE_V4"),
    "lanes33-nomix-near255": (33, 11, 2, 12, 255, "TUNE_V4S"),
    "lanes40-mix-near2-th1": (40, 8, 1, 24, 2, "TUNE_V4"),
    "lanes2-nomix-near1-th20": (2, 1, 20, 6, 1, "TUNE_V4S"),
    "lanes100-mix-near2": (100, 4, 2, 12, 2, "TUNE_V4"),
    "lanes99-nomix-near3": (99, 9, 2, 10, 3, "TUNE_V4S"),
}


def _k5_against_plain(x, n_imgs, near, tune):
    """K5 through the dispatcher and the plain walk on the same card
    tensor; asserts one launch a row and equal planes."""
    before = near_walk.launch_row.launches
    k = strips._near_walk(x, n_imgs, near, strips.AVP_N, tune)
    torch.cuda.synchronize()
    assert near_walk.launch_row.launches == before + x.shape[1]
    ref = strips._near_walk_plain(x, n_imgs, near, strips.AVP_N, tune)
    for name, u, v in zip(("y", "qu", "qv", "qw", "key"), k, ref):
        assert u.shape == x.shape and u.dtype == torch.int64 and torch.equal(u, v), name


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K5_CASES))
def test_near_walk_kernel_matches_plain(cuda_device, case):
    lanes, n_imgs, th, w, near, tune = K5_CASES[case]
    rng = np.random.default_rng(lanes + th + near)
    x = torch.from_numpy(synth_image(rng, lanes * th, w).reshape(lanes, th, w))
    _k5_against_plain(x.to(cuda_device), n_imgs, near,
                      strips._near_tune(getattr(strips, tune)))


@pytest.mark.cuda
@pytest.mark.parametrize("tune", ["TUNE_V4", "TUNE_V4S"])
@pytest.mark.parametrize("near", [1, 2, 9, 255])
def test_near_walk_kernel_on_edge_images(cuda_device, tune, near):
    # a checkerboard, a saturated ramp, a constant image and 1-pixel stripes
    # as one batch at strip height 8, as strips.encode_batch lays them out
    st, *_ = strips._prepare(edge_images(), 8)
    x = torch.from_numpy(st).reshape(-1, *st.shape[2:]).to(cuda_device)
    _k5_against_plain(x, st.shape[0], near, strips._near_tune(getattr(strips, tune)))


@pytest.mark.cuda
def test_near_walk_edge_images_on_card_match_cpu(cuda_device):
    imgs = edge_images()
    card = strips.encode_batch(imgs, th=8, near=1, device=cuda_device)
    assert card == strips.encode_batch(imgs, th=8, near=1, device="cpu")


@pytest.mark.cuda
def test_near_walk_kernel_refuses_what_it_cannot_run(cuda_device):
    tune = strips._near_tune(strips.TUNE)
    x = torch.zeros((2, 2, 8), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="features"):
        strips._near_walk(x, 1, 2, 6, tune)
    w, lanes, m = 8, 2, 1 + 10 + 100
    u8 = dict(dtype=torch.uint8, device=cuda_device)
    i64 = dict(dtype=torch.int64, device=cuda_device)
    args = [torch.zeros((w, lanes), **u8), None, torch.zeros((w, lanes), **u8),
            torch.zeros((w, lanes), **u8), torch.zeros((lanes, w, m), **i64),
            torch.zeros((lanes, w, m), **i64), None, None,
            torch.zeros((5, 2, w, lanes), dtype=torch.int32, device=cuda_device),
            torch.zeros((w, lanes), **i64), torch.zeros((w, lanes), **i64), 0, 2]
    for bad in (32768, -32769):
        args[1] = torch.zeros(3072, dtype=torch.int32, device=cuda_device)
        args[1][7] = bad
        with pytest.raises(ValueError, match="int16"):
            near_walk.launch_row(*args)
    args[1][7] = 32767  # the int16 ends themselves run
    near_walk.launch_row(*args)
    args[1][7] = -32768
    near_walk.launch_row(*args)
    args[1] = args[1].to(torch.int16)  # an int16 table runs as it is
    near_walk.launch_row(*args)
    torch.cuda.synchronize()
    args[1] = args[1].to(torch.int64)
    with pytest.raises(ValueError, match="bias"):
        near_walk.launch_row(*args)


# K4 against the plain walk on the card, on containers of the port's
# encoder: every tune the parser accepts, near 0, 1, 3 and 255, the three
# AVP instances (10, 6, the general one at 12), lane counts 1, 31, 33 and
# 4,608, a 1-row strip, a strip taller than the image, a width no segment
# count divides, a 1-pixel column, the legacy fixtures and a garbage
# payload.  The plain walk takes ~15 ms a step on the card, so the walks
# are short.
def _k4_against_plain(conts, rows=None):
    """K4 through the dispatcher and the plain walk on the same card
    tensors; asserts K4's launches (a row or a segment each) and equal
    pixels.  ``rows`` cuts the walk's rows."""
    args, _ = strips._walk_args([strips._parse(c) for c in conts], torch.device("cuda"))
    if rows is not None:
        args = (args[0], args[1], min(rows, args[2]), *args[3:])
    words, bias, th, w, s, n_imgs, n_feat, near, tune = args
    n_seg = strips._eff_seg(tune.n_seg, w)
    per_seg = n_seg > 1 and ((tune.seg_bias and bias is None) or tune.seg_map)
    before = decode_walk.launch_segment.launches
    k = strips._decode_walk(*args)
    torch.cuda.synchronize()
    assert decode_walk.launch_segment.launches - before == th * (n_seg if per_seg else 1)
    ref = strips._decode_walk_plain(words.to(torch.int64), *args[1:])
    assert k.shape == (n_imgs * s, th, w) and k.dtype == torch.uint8
    assert torch.equal(k, ref)


K4_TUNES = ("TUNE_V1", "TUNE_V2", "TUNE_V3", "TUNE_V4", "TUNE_MAX", "TUNE_V3S", "TUNE_V4S")


@pytest.mark.cuda
@pytest.mark.parametrize("tune", K4_TUNES)
@pytest.mark.parametrize("near", [0, 3])
def test_decode_walk_kernel_under_every_tune(cuda_device, monkeypatch, tune, near):
    monkeypatch.setattr(strips, "TUNE", getattr(strips, tune))
    imgs = [synth_image(np.random.default_rng(K4_TUNES.index(tune)), 24, 16)]
    conts = strips.encode_batch(imgs, th=4, near=near, device="cpu")
    _k4_against_plain(conts, rows=2)


def _thin(seed, n, h, w):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(h, w), dtype=np.uint8) for _ in range(n)]


# (images, th, near, AVP_N): each container's strips of th rows are lanes
K4_CASES = {
    "lanes1-near1": (lambda: _thin(1, 1, 4, 4), 4, 1, 10),
    "lanes31-near255": (lambda: _thin(2, 31, 4, 4), 4, 255, 10),
    "lanes33-three-strips": (lambda: _thin(3, 11, 12, 4), 4, 0, 10),
    "lanes100": (lambda: _thin(12, 25, 16, 8), 4, 0, 10),
    "lanes99-near3": (lambda: _thin(13, 33, 12, 4), 4, 3, 10),
    "lanes4608": (lambda: [synth_image(np.random.default_rng(4), 1024, 8) for _ in range(9)],
                  2, 0, 10),
    "th1": (lambda: _thin(5, 2, 16, 16), 1, 0, 10),
    "strip-taller-than-image": (lambda: _thin(6, 1, 5, 8), 16, 0, 10),
    "w48": (lambda: _thin(7, 1, 48, 48), 1, 0, 10),
    "w1": (lambda: _thin(8, 3, 16, 1), 16, 2, 10),
    "n_feat6": (lambda: _thin(9, 2, 8, 8), 4, 0, 6),
    "n_feat12": (lambda: _thin(10, 2, 8, 8), 4, 1, 12),
    "n_feat3": (lambda: _thin(11, 2, 8, 8), 4, 0, 3),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K4_CASES))
def test_decode_walk_kernel_matches_plain(cuda_device, monkeypatch, case):
    make, th, near, n_feat = K4_CASES[case]
    monkeypatch.setattr(strips, "AVP_N", n_feat)
    conts = strips.encode_batch(make(), th=th, near=near, device="cpu")
    _k4_against_plain(conts, rows=4)


@pytest.mark.cuda
@pytest.mark.parametrize("near", [0, 3])
def test_decode_walk_kernel_on_edge_images(cuda_device, near):
    # a checkerboard, a saturated ramp, a constant image and 1-pixel
    # stripes as one batch at strip height 8
    imgs = edge_images()
    conts = strips.encode_batch(imgs, th=8, near=near, device="cpu")
    _k4_against_plain(conts, rows=4)
    for got, im in zip(strips.decode_batch(conts, device=cuda_device), imgs):
        assert np.abs(got.astype(int) - im.astype(int)).max() <= near


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["legacy", "static", "near2", "garbage"])
def test_decode_walk_kernel_on_fixtures(cuda_device, form):
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data_torch_p3")
    with open(os.path.join(data, ("near2" if form == "garbage" else form) + ".nbtc"),
              "rb") as f:
        stream = bytearray(f.read())
    if form == "garbage":  # random payload bytes: z's events, not the bins read
        stream[-40:] = np.random.default_rng(73).integers(0, 256, 40, dtype=np.uint8).tobytes()
    _k4_against_plain([bytes(stream)], rows=4)


@pytest.mark.cuda
def test_decode_walk_kernel_refuses_what_it_cannot_run(cuda_device):
    tune = strips.TUNE_V4
    w, lanes, th = 8, 2, 3
    con = decode_walk.contract(0, 10, tune, 4, lanes)
    words = torch.zeros((16, lanes, 64), dtype=torch.int32, device=cuda_device)
    st = decode_walk.new_state(words, th, w, con, tune.cnt_init)
    order = strips.coder3.mapper_order(strips.coder3.init_mapper(1, cuda_device))
    rows = [torch.zeros((w, lanes), dtype=torch.uint8, device=cuda_device) for _ in range(2)]
    bias = torch.zeros(3072, dtype=torch.int32, device=cuda_device)
    for bad in (32768, -32769):
        bias[7] = bad
        with pytest.raises(ValueError, match="int16"):
            decode_walk.launch_segment(st, bias, order, *rows, 0, 0, 4, con)
    bias[7] = 32767  # the int16 ends themselves run
    decode_walk.launch_segment(st, bias, order, *rows, 0, 0, 4, con)
    decode_walk.launch_segment(st, bias.to(torch.int16), order, *rows, 0, 4, 8, con)
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="features"):
        decode_walk.launch_segment(st, bias, order, *rows, 1, 0, 4, con._replace(n_feat=13))
    with pytest.raises(ValueError, match="bias"):
        decode_walk.launch_segment(st, bias.to(torch.int64), order, *rows, 1, 0, 4, con)
    with pytest.raises(ValueError, match="CUDA"):
        decode_walk.launch_segment(st, bias, order.cpu(), *rows, 1, 0, 4, con)
    with pytest.raises(ValueError, match="contiguous"):
        decode_walk.launch_segment(st._replace(b=st.b.transpose(0, 2).contiguous().transpose(
            0, 2)), bias, order, *rows, 1, 0, 4, con)


# K9, the image-table replay (ops/table_replay.py, csrc/p3_table_replay.cu),
# against its plain version on the card: every launch of a walk held to
# replay_plain on a copy of the tables it found, on the walks' own planes
# (the decode walk under every tune, a static bias table, the near walk at
# near 2), then on seeded planes of 192 lanes an image with low caps.
@pytest.fixture
def k9_checked(monkeypatch):
    """table_replay.launch wrapped: each K9 launch also runs replay_plain
    on a copy of the tables before it, and the two must agree on every
    table; returns the list of launches checked."""
    launch, seen = table_replay.launch, []

    def checked(walk, map_cols=None, bias_cols=None):
        want = table_replay.Tables(*(t.clone() for t in walk.tables))
        table_replay.replay_plain(want, walk.planes, walk.con, map_cols, bias_cols)
        launch(walk, map_cols, bias_cols)
        for name, got, ref in zip(table_replay.Tables._fields, walk.tables, want):
            assert torch.equal(got, ref), f"{name} after launch {len(seen)}"
        seen.append((map_cols, bias_cols))

    checked.launches = 0  # the wrapped launch counts on the name it is called by
    monkeypatch.setattr(table_replay, "launch", checked)
    return seen


@pytest.mark.cuda
@pytest.mark.parametrize("tune", K4_TUNES)
def test_table_replay_kernel_under_every_tune(cuda_device, monkeypatch, k9_checked, tune):
    monkeypatch.setattr(strips, "TUNE", getattr(strips, tune))
    imgs = [synth_image(np.random.default_rng(40 + K4_TUNES.index(tune)), 24, 16),
            synth_image(np.random.default_rng(50), 24, 16)]
    conts = strips.encode_batch(imgs, th=4, device="cpu")
    before = decode_walk.launch_segment.launches
    for got, im in zip(strips.decode_batch(conts, device=cuda_device), imgs):
        assert np.array_equal(got, im)
    assert len(k9_checked) == decode_walk.launch_segment.launches - before > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["static", "legacy", "near2"])
def test_table_replay_kernel_on_fixtures(cuda_device, k9_checked, name):
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data_torch_p3")
    with open(os.path.join(data, name + ".nbtc"), "rb") as f:
        stream = f.read()
    args, _ = strips._walk_args([strips._parse(stream)], torch.device("cuda"))
    args = (args[0], args[1], min(4, args[2]), *args[3:])
    strips._decode_walk(*args)
    torch.cuda.synchronize()
    assert k9_checked
    if name == "static":  # the mapper alone: a static table is never replayed
        assert all(b is None and m is not None for m, b in k9_checked)


@pytest.mark.cuda
@pytest.mark.parametrize("tune", ["TUNE_V4", "TUNE_V4S"])
def test_table_replay_kernel_in_the_near_walk(cuda_device, k9_checked, tune):
    x = torch.from_numpy(np.stack([synth_image(np.random.default_rng(60 + k), 8, 24)
                                   for k in range(6)])).to(cuda_device)
    t = strips._near_tune(getattr(strips, tune))
    k = strips._near_walk(x, 2, 2, strips.AVP_N, t)
    ref = strips._near_walk_plain(x, 2, 2, strips.AVP_N, t)
    assert all(torch.equal(u, v) for u, v in zip(k, ref))
    assert k9_checked == [(None, (0, 24))] * 8  # the bias alone, a row


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["segments", "rows", "near"])
def test_table_replay_kernel_at_192_lanes_an_image(cuda_device, kind):
    """K9 against replay_plain on seeded planes of 2 images x 192 lanes
    (the th-4 corpus's lanes an image), 16 columns a launch, 40 contexts an
    image against a cap of 24, so that halvings leave contexts past it,
    errors of both signs."""
    rng = np.random.default_rng(("segments", "rows", "near").index(kind))
    n_imgs, lpi, w, ws = 2, 192, 64, 16
    lanes = n_imgs * lpi
    con = table_replay.Contract(lpi, w, 24, 3, 4, 60)
    tb = table_replay.new_tables(n_imgs, con, cuda_device)
    want = table_replay.Tables(*(t.clone() for t in tb))
    img = torch.arange(lanes) // lpi
    for row in range(3):
        idx = img * 3072 + torch.from_numpy(rng.integers(0, 40, (w, lanes))) * 73
        dx = torch.from_numpy(rng.integers(-255, 256, (w, lanes)))
        key = torch.from_numpy(rng.integers(0, 512, (w, lanes)))
        y = torch.from_numpy(np.where(rng.random((w, lanes)) < 0.7,
                                      rng.integers(0, 5, (w, lanes)),
                                      rng.integers(0, 60, (w, lanes))))
        planes = tuple(p.to(cuda_device) for p in (idx, dx, key, y))
        if kind == "near":
            planes = (*planes[:2], None, None)
        walk = table_replay.prepare(tb, planes, con)
        spans = {"segments": [((c, c + ws), (c, c + ws)) for c in range(0, w, ws)],
                 "rows": [((0, w), (0, w))], "near": [(None, (0, w))]}[kind]
        for map_cols, bias_cols in spans:
            before = table_replay.launch.launches
            table_replay.launch(walk, map_cols, bias_cols)
            assert table_replay.launch.launches == before + 1
            table_replay.replay_plain(want, planes, con, map_cols, bias_cols)
            for name, got, ref in zip(table_replay.Tables._fields, tb, want):
                assert torch.equal(got, ref), f"{name}, row {row}, columns {map_cols}"
    assert int(tb.bmark.count_nonzero()) > 0  # entries stayed past the cap


# (images, lanes an image, W, columns a launch, bias_cap, map_halve)
K9_SHAPES = {"th768": (2, 1, 64, 16, 5, 14), "th4": (2, 192, 32, 16, 24, 60),
             "equal-addresses": (2, 64, 32, 16, 40, 90)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(K9_SHAPES))
def test_table_replay_kernel_launch_shapes(cuda_device, shape):
    """K9 against replay_plain, launch by launch: a th-768 walk's launches
    (one lane an image, 16 columns), a th-4 corpus's (192 lanes an image),
    and ones whose warps' lanes mostly share one context and one (key, y)
    (the reductions' contention), with caps low enough that entries halve,
    and halve again untouched."""
    rng = np.random.default_rng(list(K9_SHAPES).index(shape))
    n_imgs, lpi, w, ws, cap, halve = K9_SHAPES[shape]
    lanes = n_imgs * lpi
    con = table_replay.Contract(lpi, w, cap, 2, 4, halve)
    tb = table_replay.new_tables(n_imgs, con, cuda_device)
    want = table_replay.Tables(*(t.clone() for t in tb))
    img = torch.arange(lanes) // lpi
    halved = False
    for row in range(4):
        ctx = rng.integers(0, 12, (w, lanes)) * 131
        key = rng.integers(0, 8, (w, lanes)) * 61
        y = rng.integers(0, 24, (w, lanes))
        if shape == "equal-addresses":
            same = rng.random((w, lanes)) < 0.8
            ctx, key, y = np.where(same, 77, ctx), np.where(same, 5, key), np.where(same, 3, y)
        planes = tuple(torch.from_numpy(np.ascontiguousarray(v)).to(cuda_device) for v in (
            img.numpy() * 3072 + ctx, rng.integers(-255, 256, (w, lanes)), key, y))
        walk = table_replay.prepare(tb, planes, con)
        for c0 in range(0, w, ws):
            cols = (c0, c0 + ws)
            before = table_replay.Tables(*(t.clone() for t in want))
            table_replay.launch(walk, cols, cols)
            table_replay.replay_plain(want, planes, con, cols, cols)
            for name, got, ref in zip(table_replay.Tables._fields, tb, want):
                assert torch.equal(got, ref), f"{name}, row {row}, columns {cols}"
            halved |= bool((want.bcnt < before.bcnt).any() or (want.mhist < before.mhist).any())
    assert halved  # the launches' sweeps halved entries


@pytest.mark.cuda
def test_table_replay_kernel_refuses_what_it_cannot_run(cuda_device):
    con = table_replay.Contract(2, 8, 4, 0, 4, 9)
    tb = table_replay.new_tables(1, con, cuda_device)
    planes = [torch.zeros((8, 2), dtype=torch.int64, device=cuda_device) for _ in range(4)]
    walk = table_replay.prepare(tb, planes, con)
    for map_cols, bias_cols in (((0, 9), None), (None, (4, 4)), ((-1, 8), (2, 8))):
        with pytest.raises(RuntimeError, match="nbt_p3_table_replay"):
            table_replay.launch(walk, map_cols, bias_cols)
    with pytest.raises(RuntimeError, match="nbt_p3_table_replay"):  # neither replay
        table_replay.launch(walk)
    with pytest.raises(ValueError, match="CUDA"):
        table_replay.prepare(tb, [p.cpu() for p in planes], con)
    with pytest.raises(ValueError, match="contiguous"):
        table_replay.prepare(tb._replace(mhist=tb.mhist.transpose(1, 2).contiguous().transpose(
            1, 2)), planes, con)


# K5's warp chain alone (ops/near_walk.py::solve_systems) against
# avp.solve_batch / predict_from_solve on the CPU: systems of every size
# n = 1..12, at the walk's magnitudes and at the int64 edges.
I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1


def _systems(kind, n, p, rng):
    """(a (n, n, P), b (n, P), feats (n, P)) int64 of one kind."""
    shape = (n, n + 1, p)
    if kind == "ridge":  # E + F of random features, as a walk builds them
        x = rng.integers(-128, 128, size=(n, 40, p)).astype(np.int64)
        m = np.einsum("kip,lip->klp", x, x) << 16
        m += (8 * n * np.eye(n, dtype=np.int64))[:, :, None]
        rhs = rng.integers(-(1 << 40), 1 << 40, size=(n, 1, p))
        full = np.concatenate([m, rhs], 1)
    elif kind == "wrapping":  # products of the elimination pass 2^63
        full = rng.integers(-(1 << 62), 1 << 62, size=shape, dtype=np.int64)
    elif kind == "ties":  # equal |pivot| candidates of either sign, zero pivots
        full = rng.integers(-2, 3, size=shape).astype(np.int64)
    elif kind == "zero-columns":
        full = rng.integers(-1000, 1000, size=shape).astype(np.int64)
        full[:, rng.integers(0, n)] = 0
        full[rng.integers(0, n)] = 0
    else:  # "int64-edges": INT64_MIN, INT64_MAX and 0 among small values
        full = rng.integers(-50, 50, size=shape).astype(np.int64)
        pick = rng.random(shape)
        full[pick < 0.15] = I64_MIN
        full[(pick >= 0.15) & (pick < 0.25)] = I64_MAX
        full[(pick >= 0.25) & (pick < 0.3)] = 0
    feats = rng.integers(-128, 128, size=(n, p)).astype(np.int64)
    return full[:, :n], full[:, n], feats


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ridge", "wrapping", "ties", "zero-columns", "int64-edges"])
@pytest.mark.parametrize("n", range(1, 13))
def test_warp_chain_matches_plain_solve(cuda_device, kind, n):
    rng = np.random.default_rng(100 * n + len(kind))
    a, b, feats = (torch.from_numpy(v) for v in _systems(kind, n, 97, rng))
    diag, num, ok = avp.solve_batch(a.clone(), b.clone(), n)
    px = avp.predict_from_solve(diag, num, feats)
    got = near_walk.solve_systems(a.to(cuda_device), b.to(cuda_device), feats.to(cuda_device))
    torch.cuda.synchronize()
    for name, u, v in zip(("diag", "num", "ok", "px"), got, (diag, num, ok, px)):
        assert torch.equal(u.cpu(), v), name


# ---- K8, the profile-3 coding scan, and K3, its binary fold: each held to
# its plain version on the same card tensors.  The plain scan makes ~200
# launches a column segment, so the strips are short.


def _k8_lossless(imgs, th, tune):
    """K8 and the plain row scan on the card planes of ``imgs`` at strip
    height ``th``; asserts one launch and equal slots."""
    st, *_ = strips._prepare(imgs, th)
    b, s, th, w = st.shape
    x = torch.from_numpy(st).reshape(b * s, th, w).cuda()
    seg_w = w // strips._eff_seg(tune.n_seg, w) if tune.seg_stats else 0
    planes = strips._model_planes(x, strips.AVP_N, seg_w, bool(tune.mix_e), bool(tune.w_pred))
    before = row_scan.scan.launches
    got = strips._row_scan(*planes, b, tune)
    torch.cuda.synchronize()
    assert row_scan.scan.launches == before + 1
    want = strips._row_scan_plain(*planes, b, tune)
    for g, w_, name in zip(got, want, ("probs", "bins", "masks")):
        assert g.dtype == w_.dtype and g.shape == w_.shape and torch.equal(g, w_), name


# (images, th): one, 12, 192 and 300 strip lanes an image (portrait images,
# so no transpose changes the count); past 256 a thread of K8's adds takes
# several lanes' pixels
K8_LANES = {
    "lanes1": (lambda: [synth_image(np.random.default_rng(1), 32, 16) for _ in range(2)], 32),
    "lanes12": (lambda: [synth_image(np.random.default_rng(2), 48, 32) for _ in range(2)], 4),
    "lanes192": (lambda: [synth_image(np.random.default_rng(3), 768, 32) for _ in range(2)], 4),
    "lanes300": (lambda: [synth_image(np.random.default_rng(4), 1200, 16) for _ in range(2)],
                 4),
}


# TUNE_V1: one segment a row (ws = W), 9 unary layers
@pytest.mark.cuda
@pytest.mark.parametrize("tune", ["TUNE_V4", "TUNE_MAX", "TUNE_V4S", "TUNE_V1"])
@pytest.mark.parametrize("lanes", list(K8_LANES))
def test_row_scan_kernel_matches_plain(cuda_device, tune, lanes):
    make, th = K8_LANES[lanes]
    _k8_lossless(make(), th, getattr(strips, tune))


@pytest.mark.cuda
@pytest.mark.parametrize("sym", [0, 1])
@pytest.mark.parametrize("lanes", ["lanes1", "lanes12"])
def test_row_scan_kernel_at_20_unary_layers(cuda_device, sym, lanes):
    make, th = K8_LANES[lanes]
    _k8_lossless(make(), th, strips.TUNE_V4._replace(n_unary=20, sym_cnt=sym))


# 16-pixel segments, as the default contract cuts a 512-wide row: at one
# lane 16 pixel tasks, a pixel a warp on every warp; at 12 lanes 192, a
# pixel a thread
@pytest.mark.cuda
@pytest.mark.parametrize("sym", [0, 1])
@pytest.mark.parametrize("lanes", ["lanes1", "lanes12"])
def test_row_scan_kernel_at_16_pixel_segments(cuda_device, sym, lanes):
    make, th = K8_LANES[lanes]
    imgs = make()
    w = min(imgs[0].shape)
    _k8_lossless(imgs, th, strips.TUNE_V4._replace(n_seg=w // 16, sym_cnt=sym))


# near 7: k_step 16, 256 counter classes (34 KB of counters a lane: in the
# CTA's shared memory at one lane, in device memory at more)
@pytest.mark.cuda
@pytest.mark.parametrize("tune", ["TUNE_V4", "TUNE_MAX", "TUNE_V4S"])
@pytest.mark.parametrize("near", [1, 2, 3, 7])
@pytest.mark.parametrize("lanes", list(K8_LANES))
def test_row_scan_kernel_near_mode_matches_plain(cuda_device, tune, near, lanes):
    make, th = K8_LANES[lanes]
    tune_n = strips._near_tune(getattr(strips, tune))
    st, *_ = strips._prepare(make(), th)
    b, s, th, w = st.shape
    x = torch.from_numpy(st).reshape(b * s, th, w).cuda()
    planes = strips._near_walk(x, b, near, strips.AVP_N, tune_n)
    k_step = strips._k_step(near)
    before = row_scan.scan.launches
    got = strips._near_code(*planes, b, k_step, tune_n)
    torch.cuda.synchronize()
    assert row_scan.scan.launches == before + 1
    want = strips._near_code_plain(*planes, b, k_step, tune_n)
    for g, w_, name in zip(got, want, ("probs", "bins", "masks")):
        assert g.dtype == w_.dtype and g.shape == w_.shape and torch.equal(g, w_), name


@pytest.mark.cuda
def test_row_scan_kernel_refuses_out_of_range_planes(cuda_device):
    t = torch.zeros((2, 2, 16), dtype=torch.int32, device=cuda_device)
    bad = t.clone()
    bad[0, 0, 0] = 3072  # a context address past the table
    before = row_scan.scan.launches
    with pytest.raises(ValueError, match="outside the range"):
        row_scan.scan((t, t, t, t, t, bad), 1, strips.TUNE_V4, strips.K_STEP, 16, near=False)
    assert row_scan.scan.launches == before


# (states, slots, live share): S = 16 (one lane), states not a multiple of
# the CTA's 32, slots not a multiple of the 4-slot copies or of the chunk,
# every slot masked
K3_CASES = {
    "s16": (16, 21 * 16 * 8, 0.4),
    "s100-n4099": (100, 4099, 0.5),
    "s33-n1": (33, 1, 1.0),
    "s4608-n1344": (4608, 1344, 0.3),
    "s7-n62": (7, 62, 0.9),
    "s40-n99-masked": (40, 99, 0.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K3_CASES))
def test_bin_fold_kernel_matches_plain(cuda_device, case):
    s, n, live = K3_CASES[case]
    rng = np.random.default_rng(s + n)
    p1 = rng.integers(1, 4096, (s, n))
    p1[:, ::5] = rng.choice([-3, 1, 4095, 5000], size=p1[:, ::5].shape)  # the clip
    bins = (rng.random((s, n)) < np.clip(p1, 1, 4095) / 4096.0).astype(np.int8)
    mask = rng.random((s, n)) < live
    mask[0] = False  # an all-masked state
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (p1.astype(np.int16), bins, mask)]
    before = rans_bin.fold_card.launches
    got = rans_bin.fold(*args)
    torch.cuda.synchronize()
    assert rans_bin.fold_card.launches == before + 1
    want = rans_bin.fold_plain(*args)
    for g, w_, name in zip(got, want, ("words", "emits", "state")):
        assert g.dtype == w_.dtype and g.shape == w_.shape and torch.equal(g, w_), name
    assert int(got[2][0]) == rans_bin.ANS_LOW and not got[1][0].any()


@pytest.mark.cuda
def test_bin_fold_kernel_on_strided_views(cuda_device):
    # views of wider planes, as a caller may hand them in
    rng = np.random.default_rng(8)
    p1 = torch.from_numpy(rng.integers(1, 4096, (40, 203)).astype(np.int32)).to(cuda_device)
    bins = (torch.rand((40, 203), device=cuda_device) < 0.5).to(torch.int32)
    mask = torch.rand((40, 203), device=cuda_device) < 0.6
    a, b, m = p1[:, 3:], bins[:, 3:], mask[:, 3:]
    got, want = rans_bin.fold(a, b, m), rans_bin.fold_plain(a, b, m)
    assert all(torch.equal(u, v) for u, v in zip(got, want))


@pytest.mark.cuda
def test_bin_fold_reciprocal_step_on_the_card(cuda_device):
    """K3's chain step (the producers' record, f's reciprocal from the
    magic table, the division-free step) for every f in [1, 4095] at the
    edge states of tests/test_torch_p3_bin_fold.py, against the plain
    step's arithmetic."""
    import sys

    from nblic_tpu_torch import kernels

    sys.path.insert(0, os.path.dirname(__file__))
    from test_torch_p3_bin_fold import edge_steps

    states, p1, bins, live, want = edge_steps()
    st, p16, b8, m8 = (torch.from_numpy(a).to(cuda_device)
                       for a in (states.view(np.int32), p1, bins, live))
    out = torch.empty((states.size, 3), dtype=torch.int32, device=cuda_device)
    dev, stream = kernels.stream_of(st)
    rc = kernels.library().nbt_bin_fold_steps(st.data_ptr(), p16.data_ptr(), b8.data_ptr(),
                                              m8.data_ptr(), out.data_ptr(), states.size, dev,
                                              stream)
    kernels.check(rc, "bin_fold_steps")
    torch.cuda.synchronize()
    np.testing.assert_array_equal(out.cpu().numpy().view(np.uint32), want)


# ---- K10 and K11, the profile-3 modeling pass: each held to its plain
# version on the same card tensors, the pass to the CPU's loops.  The
# plain chains take H + 2 W torch steps a channel block, so the strips are
# short.

# (lanes, th, w): one lane, many, odd widths (37: no segment width divides
# it, so the segment forms fall back to plain chains; 33 under TUNE_V3S /
# V4S: segments of 11 columns)
MODEL_SHAPES = {"lane1": (1, 24, 48), "lanes24": (24, 6, 32), "odd37": (3, 9, 37),
                "odd33": (2, 7, 33), "lanes288": (288, 2, 16)}
MODEL_TUNES = ["TUNE_V4", "TUNE_V3S", "TUNE_V4S", "TUNE_MAX"]


def _model_strips(shape, seed=0):
    """(lanes, th, w) int32 strips: a synthetic image cut into lanes, its
    first lane flat and its second a 0 / 255 checkerboard where there are
    several."""
    lanes, th, w = shape
    x = synth_image(np.random.default_rng(seed), lanes * th, w).reshape(lanes, th, w)
    x = x.astype(np.int32)
    if lanes > 1:
        x[0] = 77
        x[1] = (np.add.outer(np.arange(th), np.arange(w)) % 2) * 255
    return torch.from_numpy(x)


def _model_form(tune, w):
    """(seg_w, mix, w_quant) of a contract at width w, as strips.encode_batch
    gives them."""
    seg_w = w // strips._eff_seg(tune.n_seg, w) if tune.seg_stats else 0
    return seg_w, bool(tune.mix_e), bool(tune.w_pred)


# K10's chains at more shapes: 512 columns (segments of 8 under TUNE_V3S
# and V4S: the freeze and hold forms), h > w, strips past the wavefront's
# band of 32 rows (the carry between bands): 3 bands, and 35
CHAIN_SHAPES = {**MODEL_SHAPES, "w512": (2, 4, 512), "tall": (3, 40, 9),
                "band32": (2, 72, 8), "rows1100": (1, 1100, 8)}


def _force_design(monkeypatch, design):
    """K10's moments in ``design``."""
    monkeypatch.setattr(model_pass, "chain_design", lambda s, h, k, sms: design)


K10_DESIGNS = [model_pass.TWO_PASS, model_pass.WAVE]


@pytest.mark.cuda
@pytest.mark.parametrize("design", K10_DESIGNS)
@pytest.mark.parametrize("tune", MODEL_TUNES)
@pytest.mark.parametrize("shape", list(CHAIN_SHAPES))
def test_model_chains_kernel_matches_plain(cuda_device, monkeypatch, tune, shape, design):
    """K10 in each design of its moments (the wavefront: the last of 4
    channel blocks 14 lanes live) against chains_plain."""
    _force_design(monkeypatch, design)
    dims = CHAIN_SHAPES[shape]
    seg_w, mix, w_quant = _model_form(getattr(strips, tune), dims[2])
    fe, px_s = model_pass.features(_model_strips(dims).to(cuda_device), 10)
    preds = px_s.reshape(1, -1)
    before = model_pass.chains.launches
    got = model_pass.chains(fe, preds, dims, 10, seg_w, w_quant)
    torch.cuda.synchronize()
    assert model_pass.chains.launches == before + 2  # a moment launch fits the budget here
    want = model_pass.chains_plain(fe, preds, dims, 10, seg_w, w_quant)
    assert got.shape == want.shape and torch.equal(got, want)
    if mix:
        hard = torch.clamp(px_s + (fe[:, 0].reshape(px_s.shape) % 7) - 3, 0, 255)
        preds = torch.stack([hard.reshape(-1), px_s.reshape(-1)]).to(torch.int32)
        got = model_pass.chains(fe, preds, dims, 10)
        assert torch.equal(got, model_pass.chains_plain(fe, preds, dims, 10))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [6, 12])
def test_model_chains_kernel_channel_blocks(cuda_device, monkeypatch, n):
    """K10's moments at n + n^2 = 42 and 156 channels: 32-lane blocks with
    10 and 28 lanes of the last live, and the two passes."""
    dims = (5, 6, 24)
    fe, px_s = model_pass.features(_model_strips(dims, n).to(cuda_device), n)
    want = model_pass.chains_plain(fe, px_s.reshape(1, -1), dims, n)
    for design in K10_DESIGNS:
        _force_design(monkeypatch, design)
        assert torch.equal(model_pass.chains(fe, px_s.reshape(1, -1), dims, n), want)


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [1 << 20, 1 << 14])
def test_model_chains_kernel_in_small_launches(cuda_device, monkeypatch, budget):
    """The two passes' moment channels cut into several K10 launches (as at
    24 images at th 768), the scratch within the budget."""
    monkeypatch.setattr(model_pass, "SCRATCH_BYTES", budget)
    dims = MODEL_SHAPES["lanes24"]
    fe, px_s = model_pass.features(_model_strips(dims, 3).to(cuda_device), 10)
    before = model_pass.chains.launches
    got = model_pass.chains(fe, px_s.reshape(1, -1), dims, 10)
    n_launch = model_pass.chains.launches - before
    assert n_launch == 1 + len(model_pass._moment_blocks(10, fe.shape[0])) > 2
    assert torch.equal(got, model_pass.chains_plain(fe, px_s.reshape(1, -1), dims, 10))


@pytest.mark.cuda
@pytest.mark.parametrize("design", K10_DESIGNS)
def test_model_chains_kernel_many_strips_in_one_launch(cuda_device, monkeypatch, design):
    """All the moment channels of 4,608 strips (the th-4 corpus's count) in
    one K10 launch, beside the energy's."""
    _force_design(monkeypatch, design)
    dims = (4608, 2, 16)
    fe, px_s = model_pass.features(_model_strips(dims, 3).to(cuda_device), 10)
    before = model_pass.chains.launches
    got = model_pass.chains(fe, px_s.reshape(1, -1), dims, 10)
    assert model_pass.chains.launches - before == 2
    assert torch.equal(got, model_pass.chains_plain(fe, px_s.reshape(1, -1), dims, 10))


def _model_systems(n, rows, seed):
    """(rows, m) int64 statistics: ridge systems at the chains'
    magnitudes, zero ones (ok false), wrapping ones, INT64_MIN pivots and
    int64 edges."""
    rng = np.random.default_rng(seed)
    m = pavp.get_m(n)
    st = rng.integers(-(1 << 40), 1 << 40, size=(m, rows))
    a = st[1 + n :].reshape(n, n, rows)
    a += (np.eye(n, dtype=np.int64) << 44)[:, :, None]
    q = rows // 8
    a[:, :, :q] = -(np.eye(n, dtype=np.int64) * (8 * n))[:, :, None]
    st[:, q : 2 * q] = rng.integers(-(1 << 62), 1 << 62, size=(m, q))
    a[:, 0, 2 * q : 3 * q] = np.iinfo(np.int64).min
    a[0, 0, 2 * q : 3 * q] = np.iinfo(np.int64).max - 8 * n + 1
    pick = rng.random((m, q))
    blk = st[:, 3 * q : 4 * q]
    blk[pick < 0.2] = np.iinfo(np.int64).min
    blk[pick > 0.9] = np.iinfo(np.int64).max
    return torch.from_numpy(st.T.copy())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [4096, 4099])
@pytest.mark.parametrize("n", [10, 6, 12])
@pytest.mark.parametrize("w_quant,seg", [(False, 1), (True, 1), (True, 4), (True, 11)])
def test_model_solve_kernel_matches_plain(cuda_device, n, w_quant, seg, rows):
    """K11, a system a thread, against solve_plain: its warps' batches of
    32 rows whole and (4099) the last one 3 rows."""
    stats = _model_systems(n, rows, n + seg).to(cuda_device)
    rng = np.random.default_rng(seg)
    fe = torch.from_numpy(rng.integers(-128, 128, size=(rows * seg, n + 1)).astype(np.int32))
    px_s = torch.from_numpy(rng.integers(0, 256, size=rows * seg).astype(np.int32))
    fe, px_s = fe.to(cuda_device), px_s.to(cuda_device)
    before = model_pass.solve.launches
    got = model_pass.solve(stats, fe, px_s, n, seg, w_quant)
    torch.cuda.synchronize()
    assert model_pass.solve.launches == before + 1
    want = model_pass.solve_plain(stats, fe, px_s, n, seg, w_quant)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not bool(want[1][: rows // 8 * seg].any()) and bool(want[1].any())


@pytest.mark.cuda
@pytest.mark.parametrize("tune", MODEL_TUNES)
@pytest.mark.parametrize("shape", ["lane1", "lanes24", "odd33"])
def test_model_pass_on_the_card_matches_the_cpu(cuda_device, tune, shape):
    """pavp.predict_plane on a card tensor (K10 and K11) against its loops
    on the CPU."""
    dims = MODEL_SHAPES[shape]
    seg_w, mix, w_quant = _model_form(getattr(strips, tune), dims[2])
    x = _model_strips(dims, 5)
    before = (model_pass.chains.launches, model_pass.solve.launches)
    got = pavp.predict_plane(x.to(cuda_device), 10, seg_w=seg_w, mix=mix, w_quant=w_quant)
    assert model_pass.chains.launches - before[0] == (3 if mix else 2)
    assert model_pass.solve.launches - before[1] == 1
    want = pavp.predict_plane(x, 10, seg_w=seg_w, mix=mix, w_quant=w_quant)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("tune", MODEL_TUNES)
def test_model_kernels_launch_on_encode_batch(cuda_device, monkeypatch, tune):
    """strips.encode_batch on the card runs its modeling pass on K10 and
    K11 (their counters move), and its containers decode to the images."""
    monkeypatch.setattr(strips, "TUNE", getattr(strips, tune))
    imgs = [synth_image(np.random.default_rng(k), 32, 48) for k in range(2)]
    model_pass.chains.launches = model_pass.solve.launches = 0
    conts = strips.encode_batch(imgs, th=16, device=cuda_device)
    assert model_pass.chains.launches >= 2 and model_pass.solve.launches == 1
    for c, im in zip(conts, imgs):
        assert np.array_equal(strips.decode(c, device=cuda_device), im)


@pytest.mark.cuda
def test_model_kernels_refuse_what_they_cannot_run(cuda_device):
    dims = (1, 4, 8)
    fe, px_s = model_pass.features(_model_strips(dims).to(cuda_device), 10)
    preds = px_s.reshape(1, -1)
    with pytest.raises(ValueError):
        model_pass.chains(fe.to(torch.int64), preds, dims, 10)
    with pytest.raises(ValueError):
        model_pass.chains(fe, preds.cpu(), dims, 10)
    with pytest.raises(ValueError):
        model_pass.chains(fe, preds, dims, 13)
    stats = model_pass.chains(fe, preds, dims, 10)
    with pytest.raises(ValueError):
        model_pass.solve(stats[:, :-1].contiguous(), fe, px_s.reshape(-1), 10)
    with pytest.raises(ValueError):
        model_pass.solve(stats, fe, px_s.reshape(-1), 10, seg=4)
    with pytest.raises(ValueError):
        model_pass.solve(stats.t(), fe, px_s.reshape(-1), 10)
