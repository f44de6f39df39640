"""The port's tiled near-lossless feedback scan (``ops/near_scan.py``, the
plain version of kernel K7) against nblic_tpu's ``_tile_encode_scan``.

- ``near_scan.encode_scan`` on CPU tensors gives, on all five planes (y,
  qd, adr, x - px0, x_rec), what ``jax.jit(jax.vmap(_tile_encode_scan))``
  gives image by image: 8x8, 16x16 and 64x64 tiles, near 1, 2, 9 and 255,
  profile 1 and profile 2 with flags 0/1/2, a batch of three images with
  distinct bias tables that reach the int16 ends.
- The dispatcher raises on a device other than cpu or cuda, on profile 2
  without weights, on near outside 1..255, and on bias tables that are not
  int32 or leave int16.
- ``kernels.library_path`` hashes the ``.cuh`` headers, and nvcc compiles
  the ``.cu`` sources alone.

All on CPU tensors; JAX on the CPU.  Integer math: tolerance 0.  K7 itself
is held to the plain version on the card in ``tests/test_torch_cuda.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cuda import scan_inputs

from nblic_tpu.models import tiled as j_tiled
from nblic_tpu_torch import kernels
from nblic_tpu_torch.ops import near_scan

# one intra-op thread: parallel test workers each run many tiny torch ops,
# and idle OpenMP threads spinning between them starve the other workers
torch.set_num_threads(1)

PLANES = ("y", "qd", "adr", "err", "rec")


def _jax_scan(x, bias, wcols, t, near, profile):
    """nblic_tpu's scan, image by image: a tuple of five (B, T, t, t) arrays."""
    fn = jax.jit(jax.vmap(functools.partial(
        j_tiled._tile_encode_scan, th=t, tw=t, near=near, profile=profile, stats=True),
        in_axes=(0, None, 0)))
    b, n = x.shape[:2]
    w = (wcols.transpose(1, 2).numpy() if wcols is not None
         else np.zeros((b, n, 16), dtype=np.int32))
    refs = [fn(jnp.asarray(x[k].numpy()), jnp.asarray(bias[k].numpy()), jnp.asarray(w[k]))
            for k in range(b)]
    return tuple(np.stack([np.asarray(r[p]) for r in refs]) for p in range(len(PLANES)))


# (tile side, tiles an image, profile, near); the 64x64 case (4,096 steps,
# ~8 s of plain scan) runs at one near and profile only
CASES = {
    "t8-p1-near1": (8, 15, 1, 1),
    "t8-p1-near255": (8, 15, 1, 255),
    "t8-p2-near2": (8, 15, 2, 2),
    "t8-p2-near9": (8, 15, 2, 9),
    "t16-p1-near2": (16, 6, 1, 2),
    "t16-p1-near9": (16, 6, 1, 9),
    "t16-p2-near1": (16, 6, 2, 1),
    "t16-p2-near255": (16, 6, 2, 255),
    "t64-p1-near2": (64, 2, 1, 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_encode_scan_matches_jax(case):
    t, n_tiles, profile, near = CASES[case]
    x, bias, wcols = scan_inputs(sum(CASES[case]), 3, n_tiles, t, profile)
    port = near_scan.encode_scan(x, bias, wcols, t, t, near, profile, stats=True)
    ref = _jax_scan(x, bias, wcols, t, near, profile)
    assert len(port) == len(PLANES)
    for name, p, r in zip(PLANES, port, ref):
        assert p.dtype == torch.int32 and p.shape == x.shape, name
        np.testing.assert_array_equal(p.numpy(), r, err_msg=name)
    y, qd = near_scan.encode_scan(x, bias, wcols, t, t, near, profile)
    assert torch.equal(y, port[0]) and torch.equal(qd, port[1])
    assert (port[4] - x).abs().max() <= near


BAD_CALLS = {
    "meta-device": dict(device="meta"),
    "p2-without-wcols": dict(profile=2),
    "p2-wcols-misshapen": dict(profile=2, wcols=torch.zeros((1, 16, 3), dtype=torch.int32)),
    "near0": dict(near=0),
    "near256": dict(near=256),
    "profile3": dict(profile=3),
    "bias-misshapen": dict(bias=torch.zeros((2, 3072), dtype=torch.int32)),
    "bias-int64": dict(bias=torch.zeros((1, 3072), dtype=torch.int64)),
    "bias-above-int16": dict(bias=torch.full((1, 3072), 1 << 15, dtype=torch.int32)),
    "bias-below-int16": dict(bias=torch.full((1, 3072), -(1 << 15) - 1, dtype=torch.int32)),
}


@pytest.mark.parametrize("bad", list(BAD_CALLS))
def test_encode_scan_refuses(bad):
    kw = dict(device="cpu", profile=1, near=2, wcols=None,
              bias=torch.zeros((1, 3072), dtype=torch.int32))
    kw.update(BAD_CALLS[bad])
    x = torch.zeros((1, 2, 4, 4), dtype=torch.int32, device=kw["device"])
    with pytest.raises(ValueError):
        near_scan.encode_scan(x, kw["bias"].to(kw["device"]), kw["wcols"], 4, 4, kw["near"],
                              kw["profile"])


def test_library_path_hashes_headers(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// one\n")
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    before = kernels.library_path()
    (tmp_path / "b.cuh").write_text("// two\n")
    assert kernels.library_path() != before
    (tmp_path / "b.cuh").write_text("// one\n")
    assert kernels.library_path() == before
    # nvcc compiles the .cu sources alone, one process each
    assert kernels._sources() == [tmp_path / "a.cu"]

