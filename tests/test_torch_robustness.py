"""Hostile and corrupt NBTC containers in the port, and geometries and
near values the other tests do not reach, against nblic_tpu.

The port's decoder must never hang, crash or leak a library error:
decoding bad input raises ``ValueError`` or returns pixels of the image's
shape, within a few seconds.  A header whose tile grid does not hold its
tile count is refused before any decode, as is a profile-3 header whose
strips, Tune block, feature count, static-bias block or length table is
out of range.  Non-square tiles and ``near``
above 9 write the JAX package's bytes.
"""

import os
import time
import zlib

import numpy as np
import pytest
import torch
from test_torch_p3_fixtures import splice_static_bias

from nblic_tpu.models import tiled as j_tiled
from nblic_tpu_torch.models import strips, tiled
from nblic_tpu_torch.utils.container import NbtcHeader
from nblic_tpu_torch.utils.synth import synth_image

torch.set_num_threads(1)

KINDS = {"p1": dict(), "p2": dict(effort=2), "near2": dict(near=2)}
LIMIT_S = 10.0  # a plain decode of these images takes well under a second


@pytest.fixture(scope="module")
def image():
    return synth_image(np.random.default_rng(61), 48, 40)


@pytest.fixture(scope="module")
def containers(image):
    return {k: tiled.encode(image, tile_h=16, tile_w=16, device="cpu", **kw)
            for k, kw in KINDS.items()}


def _decode_or_value_error(stream: bytes, shape):
    """Decode ``stream``: a ValueError or pixels of ``shape``, in time."""
    t0 = time.perf_counter()
    try:
        out = tiled.decode(stream, device="cpu")
        assert out.shape == shape
    except ValueError:
        pass
    assert time.perf_counter() - t0 < LIMIT_S


def _patched(stream: bytes, fmt_offset: int, value: int, size: int) -> bytes:
    s = bytearray(stream)
    s[fmt_offset : fmt_offset + size] = value.to_bytes(size, "little")
    return bytes(s)


@pytest.mark.parametrize("kind", list(KINDS))
def test_flipped_bytes(containers, image, kind):
    stream = containers[kind]
    rng = np.random.default_rng(len(kind))
    # every byte after the header: the tables, the group table, the payload
    for pos in rng.choice(np.arange(NbtcHeader.SIZE, len(stream)), size=40, replace=False):
        s = bytearray(stream)
        s[pos] ^= int(rng.integers(1, 256))
        _decode_or_value_error(bytes(s), image.shape)


@pytest.mark.parametrize("kind", list(KINDS))
def test_truncations_raise(containers, kind):
    stream = containers[kind]
    for cut in (1, 8, NbtcHeader.SIZE - 1, NbtcHeader.SIZE + 5, len(stream) // 3,
                len(stream) // 2, len(stream) - 40, len(stream) - 1):
        t0 = time.perf_counter()
        with pytest.raises(ValueError):
            tiled.decode(stream[:cut], device="cpu")
        assert time.perf_counter() - t0 < LIMIT_S


# header fields of a 48x40 image at 16x16 tiles (3 x 3 tiles): tile_h at
# byte 20, tile_w at 22 (u16), n_tiles at 24 (u32)
HOSTILE = {
    "tile_w 272": (22, 272, 2),
    "tile_w high byte": (22, 0xFF10, 2),
    "tile_w 0": (22, 0, 2),
    "tile_h 8": (20, 8, 2),
    "n_tiles 200": (24, 200, 4),
    "n_tiles 0": (24, 0, 4),
    "profile 7": (10, 7, 1),
}


@pytest.mark.parametrize("field", list(HOSTILE))
@pytest.mark.parametrize("kind", list(KINDS))
def test_hostile_header_fields_raise(containers, kind, field):
    t0 = time.perf_counter()
    with pytest.raises(ValueError):
        tiled.decode(_patched(containers[kind], *HOSTILE[field]), device="cpu")
    assert time.perf_counter() - t0 < LIMIT_S


def test_hostile_group_table_raises(containers):
    stream = containers["p1"]
    p = tiled._Parsed(stream)
    at = len(stream) - 2 * p.payload.size - 4 * len(p.counts) - 8  # g, n_groups
    for value, off in ((0, 0), (1 << 20, 0), (2, 4), (0xFFFFFFFF, 8)):
        with pytest.raises(ValueError):
            tiled.decode(_patched(stream, at + off, value, 4), device="cpu")


def test_mesh_pad_group_geometry_parses_and_the_rest_stays_refused(containers):
    # nblic_tpu's mesh pads the tile axis to a multiple of its shards and
    # writes a group a shard: 6 tiles as 4 groups of 2 lanes, the last all
    # pad (fewer pad lanes than groups), which decodes
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data_torch_mesh")
    with open(os.path.join(data, "p1_1x4_0.nbtc"), "rb") as f:
        mesh = f.read()
    p = tiled._Parsed(mesh)
    assert (p.hdr.n_tiles, p.group_size, len(p.counts)) == (6, 2, 4)
    np.testing.assert_array_equal(p.n_active(), [2, 2, 2, 0])
    np.testing.assert_array_equal(tiled.decode(mesh, device="cpu"),
                                  np.load(os.path.join(data, "p1_1x4.npy"))[0])
    # group tables that hold too few lanes, or as many pad lanes as both the
    # group width and the group count, stay refused before anything is read
    at = len(mesh) - 2 * p.payload.size - 4 * len(p.counts) - 8
    for value, off in ((2, 4), (1, 0), (8, 4)):  # 2 groups; 4 groups of 1; 8 groups
        with pytest.raises(ValueError, match="do not hold"):
            tiled.decode(_patched(mesh, at + off, value, 4), device="cpu")
    # a whole group table of 10^5 empty groups of 1 lane for the 6 tiles
    # (fewer pad lanes than groups): the group count is bounded by the tiles
    n_groups = 10**5
    wide = (mesh[:at] + np.asarray([1, n_groups], np.uint32).tobytes()
            + bytes(4 * n_groups))
    with pytest.raises(ValueError, match="do not hold"):
        tiled.decode(wide, device="cpu")
    stream = containers["p1"]  # 9 tiles in 1 group of 128
    p = tiled._Parsed(stream)
    at = len(stream) - 2 * p.payload.size - 4 * len(p.counts) - 8
    for n_groups in (2, 3, 9):
        with pytest.raises(ValueError, match="do not hold"):
            tiled.decode(_patched(stream, at + 4, n_groups, 4), device="cpu")


@pytest.mark.parametrize("tile", [(8, 16), (16, 8), (32, 16)])
@pytest.mark.parametrize("effort", [1, 2])
def test_non_square_tiles_byte_identical(tile, effort):
    img = synth_image(np.random.default_rng(62), 70, 90)
    kw = dict(tile_h=tile[0], tile_w=tile[1], effort=effort)
    port = tiled.encode(img, device="cpu", **kw)
    assert port == j_tiled.encode(img, **kw)
    np.testing.assert_array_equal(tiled.decode(port, device="cpu"), img)
    np.testing.assert_array_equal(j_tiled.decode(port), img)


@pytest.mark.parametrize("near", [10, 40, 127, 255])
@pytest.mark.parametrize("effort", [1, 2])
def test_large_near_byte_identical(near, effort):
    img = synth_image(np.random.default_rng(63), 32, 48)
    port = tiled.encode(img, near=near, tile_h=16, tile_w=16, effort=effort, device="cpu")
    assert port == j_tiled.encode(img, near=near, tile_h=16, tile_w=16, effort=effort)
    err = np.abs(tiled.decode(port, device="cpu").astype(np.int32) - img)
    assert err.max() <= near


# ---------------------------------------------------------------------------
# profile 3 (the strip engine)
# ---------------------------------------------------------------------------

P3_LIMIT_S = 30.0  # a decode of this 128-step image takes about a second alone


@pytest.fixture(scope="module")
def p3():
    img = synth_image(np.random.default_rng(64), 16, 8)
    return img, strips.encode(img, th=16, device="cpu")


def _p3_decode_or_value_error(stream: bytes, shape):
    t0 = time.perf_counter()
    try:
        assert tiled.decode(stream, device="cpu").shape == shape
    except ValueError:
        pass
    assert time.perf_counter() - t0 < P3_LIMIT_S


def test_p3_truncations_raise(p3):
    _, stream = p3
    for cut in (1, 8, NbtcHeader.SIZE - 1, NbtcHeader.SIZE + 4, NbtcHeader.SIZE + 40,
                NbtcHeader.SIZE + 32 + 30, int(len(stream) * 0.7), len(stream) - 2):
        with pytest.raises(ValueError):
            tiled.decode(stream[:cut], device="cpu")


# offsets: Tune fields after the 36-byte header (u16 each); height u32 at 12,
# tile_h u16 at 20, tile_w u16 at 22, n_tiles u32 at 24
P3_HOSTILE = {
    "n_unary 0xFFFF": (NbtcHeader.SIZE + 6, 0xFFFF, 2),
    "seg_bias 7": (NbtcHeader.SIZE + 12, 7, 2),
    "spare 1": (NbtcHeader.SIZE + 30, 1, 2),
    "height 2^32 - 1": (12, 0xFFFFFFFF, 4),
    "n_tiles 4096": (24, 0x1000, 4),
    "tile_h 0": (20, 0, 2),
    # nblic_tpu refuses it too (a TypeError of mismatched shapes in its walk)
    "15 AVP features": (22, (15 << 4) | 14, 2),
    "profile 3 -> 4": (10, 4, 1),
}


@pytest.mark.parametrize("field", list(P3_HOSTILE))
def test_p3_hostile_fields_raise(p3, field):
    t0 = time.perf_counter()
    with pytest.raises(ValueError):
        tiled.decode(_patched(p3[1], *P3_HOSTILE[field]), device="cpu")
    assert time.perf_counter() - t0 < LIMIT_S


@pytest.fixture(scope="module")
def p3_tall_ref(p3):
    """nblic_tpu's decode of the container with a 32-row strip."""
    return j_tiled.decode(_patched(p3[1], 20, 32, 2))


@pytest.mark.parametrize("tile_h", [17, 32, 0xFFFF])
def test_p3_tall_strip_decodes_as_nblic_tpu(p3, p3_tall_ref, tile_h):
    # one strip taller than the image rounded up to 16 rows: no encoder
    # writes it, and nblic_tpu reads it, walks all tile_h rows and returns
    # the image (at 65,535 rows its walk takes tens of minutes on a CPU, so
    # its pixels are taken at 32); the port walks only the image's rows
    img, stream = p3
    np.testing.assert_array_equal(p3_tall_ref, img)
    t0 = time.perf_counter()
    back = tiled.decode(_patched(stream, 20, tile_h, 2), device="cpu")
    assert time.perf_counter() - t0 < P3_LIMIT_S
    np.testing.assert_array_equal(back, p3_tall_ref)


def test_p3_corrupt_static_bias_raises(p3):
    _, stream = p3
    for block in (b"\x78\x9c" + bytes(30), zlib.compress(bytes(200))):  # bad zlib, short table
        with pytest.raises(ValueError):
            tiled.decode(splice_static_bias(stream, 0, block), device="cpu")


def test_p3_flipped_payload_bytes(p3):
    img, stream = p3
    rng = np.random.default_rng(65)
    payload_at = len(stream) - 2 * int(strips._parse(stream)[2].sum())
    for pos in rng.choice(np.arange(payload_at, len(stream)), size=4, replace=False):
        s = bytearray(stream)
        s[pos] ^= int(rng.integers(1, 256))
        _p3_decode_or_value_error(bytes(s), img.shape)
    # the length table's own bytes
    s = bytearray(stream)
    s[payload_at - 3] ^= 0x40
    _p3_decode_or_value_error(bytes(s), img.shape)
