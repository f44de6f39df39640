"""The profile-3 containers that the port's smoke run decodes on the card,
where no JAX is installed, regenerated here by nblic_tpu.

``tests/data_torch_p3/`` holds three containers nblic_tpu writes or reads,
each beside its pixels: a near-lossless container (near 2) with nblic_tpu's
decode of it, which the port also writes (``test_torch_p3_near_encode.py``
and the smoke run hold the port's bytes to it), a legacy container with
no Tune block (the TUNE_V1 version bit) with the image it encodes, and
that legacy container with a transmitted static-bias table, with
nblic_tpu's decode.  This test rebuilds each container with nblic_tpu and
holds the committed bytes to it and the pixels to the image or nblic_tpu's
decode, then the port's decode to the pixels.
``test_torch_p3_decode_forms.py`` holds the near-2 pixels and derives two
more forms.  Regenerate after a deliberate format change, from the repo
root, with
``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_p3_fixtures.py``.
"""

import os
import zlib

import numpy as np
import pytest
import torch

from nblic_tpu.models import strips as j_strips
from nblic_tpu_torch.models import strips
from nblic_tpu_torch.utils.container import NbtcHeader
from nblic_tpu_torch.utils.synth import synth_image

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data_torch_p3")
NAMES = ("near2", "legacy", "static")
TH = 16


def fixture_image() -> np.ndarray:
    return synth_image(np.random.default_rng(71), 40, 24)


def with_header(stream: bytes, **fields) -> bytes:
    """``stream`` with some NBTC header fields replaced."""
    h = NbtcHeader.from_bytes(stream)
    keys = ("profile", "near", "height", "width", "tile_h", "tile_w", "n_tiles",
            "bias_len", "hist_len", "flags")
    vals = {k: getattr(h, k) for k in keys}
    vals.update(fields)
    return NbtcHeader(**vals).to_bytes() + stream[NbtcHeader.SIZE :]


def strip_tune_block(stream: bytes) -> bytes:
    """A legacy container: the Tune block cut out, tile_w bits 2-3 cleared
    (the version bit 1 then names TUNE_V1 or TUNE_V2)."""
    h = NbtcHeader.from_bytes(stream)
    size = strips.Tune.SIZE2 if h.tile_w & 8 else strips.Tune.SIZE
    cut = stream[: NbtcHeader.SIZE] + stream[NbtcHeader.SIZE + size :]
    return with_header(cut, tile_w=h.tile_w & ~12)


def splice_static_bias(stream: bytes, seed: int, block: bytes = b"") -> bytes:
    """``stream`` with a static-bias block spliced in before its length
    table: ``block``, or a zlib'd random int16 table."""
    if not block:
        table = np.random.default_rng(seed).integers(-400, 400, size=3072).astype("<i2")
        block = zlib.compress(table.tobytes(), 6)
    h = NbtcHeader.from_bytes(stream)
    at = NbtcHeader.SIZE
    if h.tile_w & 4:
        at += strips.Tune.SIZE2 if h.tile_w & 8 else strips.Tune.SIZE
    return with_header(stream[:at] + block + stream[at:], bias_len=len(block))


def build_containers() -> dict:
    """{name: container}, all written by nblic_tpu (the static-bias one
    spliced from the legacy one)."""
    img = fixture_image()
    saved = j_strips.TUNE
    j_strips.TUNE = j_strips.TUNE_V1
    try:
        legacy = strip_tune_block(j_strips.encode(img, th=TH))
    finally:
        j_strips.TUNE = saved
    return {"near2": j_strips.encode(img, th=TH, near=2), "legacy": legacy,
            "static": splice_static_bias(legacy, 72)}


def build_fixtures() -> dict:
    """{name: (container, its pixels)}: the pixels are nblic_tpu's decode,
    and for the lossless legacy container the image it encoded."""
    conts = build_containers()
    return {name: (c, fixture_image() if name == "legacy" else j_strips.decode(c))
            for name, c in conts.items()}


def load_fixture(name: str):
    with open(os.path.join(DATA, name + ".nbtc"), "rb") as f:
        stream = f.read()
    return stream, np.load(os.path.join(DATA, name + ".npy"))


@pytest.fixture(scope="module")
def rebuilt():
    assert j_strips.TUNE == j_strips.TUNE_V4 and j_strips.AVP_N == 10
    return build_containers()


@pytest.mark.parametrize("name", NAMES)
def test_fixture_matches_nblic_tpu(rebuilt, name):
    """The committed bytes are nblic_tpu's, the pixels the image where the
    container is lossless, else nblic_tpu's decode (held to it here for the
    static-bias table; the near-2 pixels in ``test_torch_p3_decode_forms.py``,
    beside the garbage form that shares their decode program); the port
    decodes each to those pixels."""
    stream, pixels = load_fixture(name)
    assert stream == rebuilt[name]
    img = fixture_image()
    if name == "legacy":
        np.testing.assert_array_equal(pixels, img)
    elif name == "static":
        np.testing.assert_array_equal(pixels, j_strips.decode(stream))
    else:
        assert np.abs(pixels.astype(np.int32) - img).max() <= 2
    np.testing.assert_array_equal(strips.decode(stream, device="cpu"), pixels)
    hdr = NbtcHeader.from_bytes(stream)
    assert (hdr.near, bool(hdr.tile_w & 4), hdr.bias_len > 0) == {
        "near2": (2, True, False), "legacy": (0, False, False),
        "static": (0, False, True)}[name]


if __name__ == "__main__":
    os.makedirs(DATA, exist_ok=True)
    for name, (stream, pixels) in build_fixtures().items():
        with open(os.path.join(DATA, name + ".nbtc"), "wb") as f:
            f.write(stream)
        np.save(os.path.join(DATA, name + ".npy"), pixels)
        print(name, len(stream), pixels.shape)
