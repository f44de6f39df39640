"""The CUDA kernels against their plain versions, on the card.

Every test here needs a GPU and skips without one.  The file imports no JAX,
so it runs on a machine that has none:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Inputs come from numpy seeds and from the port's own encoder, whose
containers the CPU tests hold byte-identical to nblic_tpu's.  Integer math:
tolerance 0.
"""

import numpy as np
import pytest
import torch

from nblic_tpu_torch.convert import streams_from_parsed, tables_from_numpy
from nblic_tpu_torch.models import tiled
from nblic_tpu_torch.ops import decode, fold, rans


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


def _decode_args(conts, device):
    parsed = [tiled._Parsed(c) for c in conts]
    tables = tables_from_numpy(np.stack([p.bias for p in parsed]),
                               np.stack([p.hist_n for p in parsed]),
                               np.stack([p.acc for p in parsed]), device)
    hdr = parsed[0].hdr
    return (*streams_from_parsed(parsed, device), *tables, hdr.tile_h, hdr.tile_w,
            hdr.near, parsed[0].group_size)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,t,n", [((70, 90), 16, 1), ((96, 104), 8, 1),
                                       ((130, 200), 64, 3), ((9, 300), 4, 2)])
def test_decode_kernel_matches_plain(cuda_device, shape, t, n):
    rng = np.random.default_rng(t)
    imgs = [rng.integers(0, 256, size=shape, dtype=np.uint8) for _ in range(n)]
    args = _decode_args(tiled.encode_batch(imgs, tile_h=t, tile_w=t, device="cpu"),
                        cuda_device)
    launches = decode.decode_groups.launches
    k = decode.decode_groups(*args)
    torch.cuda.synchronize()
    assert decode.decode_groups.launches == launches + 1
    assert torch.equal(k, decode.group_decode_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("near", [0, 2, 9])
def test_decode_kernel_matches_plain_on_arbitrary_streams(cuda_device, near):
    # random words, bias and tables: the output is noise, but kernel and plain
    # version must walk the same states, cursor clamps and near unfolds
    rng = np.random.default_rng(near)
    b, npg, g, t = 2, 2, 64, 8
    hist = rng.integers(0, 50, size=(b, 12, 256))
    hist_n = tiled._norm_hist_dev(torch.from_numpy(hist)).numpy()
    acc = np.cumsum(hist_n, axis=-1) - hist_n
    bias = rng.integers(-(1 << 11), 1 << 11, size=(b, 3072))
    words = torch.from_numpy(rng.integers(0, 1 << 16, size=(b * npg, 300)).astype(np.int32))
    n_active = torch.tensor([g, g - 5, 17, g], dtype=torch.int32)
    args = (words.to(cuda_device), n_active.to(cuda_device),
            *tables_from_numpy(bias, hist_n, acc, cuda_device), t, t, near, g)
    k = decode.decode_groups(*args)
    torch.cuda.synchronize()
    assert torch.equal(k, decode.group_decode_plain(*args))


@pytest.mark.cuda
def test_main_path_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, size=(80, 120), dtype=np.uint8),
            rng.integers(0, 256, size=(120, 80), dtype=np.uint8)]
    on_card = tiled.encode_corpus(imgs, tile_h=16, tile_w=16, device=cuda_device)
    assert on_card == tiled.encode_corpus(imgs, tile_h=16, tile_w=16, device="cpu")
    for im, c in zip(imgs, on_card):
        np.testing.assert_array_equal(tiled.decode(c, device=cuda_device), im)
