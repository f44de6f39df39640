"""The port's mesh (nblic_tpu_torch/parallel/mesh.py) against nblic_tpu's.

Each layout runs once, as gloo groups of 2 and 4 CPU ranks spawned by
``mesh.launch`` (one intra-op thread a rank, a timeout a group); every rank
returns every result, and all ranks must agree.  The JAX package runs on
its 8 virtual CPU devices (tests/conftest.py).  Integer codecs: tolerance
0.  JAX is imported inside the tests, not at the top: the spawned ranks
import this module by name to find their job, and need no JAX.

The committed containers in ``tests/data_torch_mesh/`` (nblic_tpu's mesh
at (1, 4), 6 tiles in 4 groups of 2, and at (2, 2), groups of 6) feed the
card's checks; regenerate them with

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        PYTHONPATH=. python tests/test_torch_mesh.py
"""

import os

import numpy as np
import pytest
import torch

from nblic_tpu_torch.models import tiled
from nblic_tpu_torch.parallel import mesh as pmesh
from nblic_tpu_torch.utils.synth import synth_image

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data_torch_mesh")
T = 16  # tile side: 48x64 is 12 tiles, 48x32 6
LAYOUTS = [(1, 2), (2, 1), (2, 2), (1, 4)]
TIMEOUT = 240.0


def case_images() -> dict:
    """The encode cases: two 48x64 images, and one 48x32 image whose 6
    tiles pad to 8 over four tile shards (a whole pad group)."""
    rng = np.random.default_rng(91)
    return {"pair": [synth_image(rng, 48, 64) for _ in range(2)],
            "six": [synth_image(rng, 48, 32)]}


def fixture_cases() -> dict:
    """The committed fixtures: (images, mesh layout) by name."""
    imgs = case_images()
    return {"p1_1x4": (imgs["six"], (1, 4)), "p1_2x2": (imgs["pair"], (2, 2))}


def _jax_mesh(layout):
    import jax

    from nblic_tpu.parallel import mesh as j_mesh

    return j_mesh.make_mesh2(*layout, devices=jax.devices("cpu"))


def jax_containers(imgs, layout) -> list[bytes]:
    from nblic_tpu.parallel import mesh as j_mesh

    return j_mesh.encode_batch_mesh(imgs, _jax_mesh(layout), T, T)


def write_fixtures() -> None:
    os.makedirs(DATA, exist_ok=True)
    for name, (imgs, layout) in fixture_cases().items():
        np.save(os.path.join(DATA, f"{name}.npy"), np.stack(imgs))
        for i, c in enumerate(jax_containers(imgs, layout)):
            with open(os.path.join(DATA, f"{name}_{i}.nbtc"), "wb") as f:
                f.write(c)


def read_fixture(name: str):
    """(images (B, H, W), containers) of a committed fixture."""
    imgs = np.load(os.path.join(DATA, f"{name}.npy"))
    conts = []
    for i in range(len(imgs)):
        with open(os.path.join(DATA, f"{name}_{i}.nbtc"), "rb") as f:
            conts.append(f.read())
    return imgs, conts


# ---------------------------------------------------------------------------
# the ranks' jobs (module level: the spawned ranks find them by name)
# ---------------------------------------------------------------------------


def _model_fold(mesh, tiles):
    """sharded_model_lossless, then sharded_rans_fold on the tables it
    gives: this rank's (y, qd, bias, hist, words, emits, state)."""
    local = pmesh.shard_tiles(torch.from_numpy(tiles), mesh)
    y, qd, bias, hist = pmesh.sharded_model_lossless(local, mesh)
    hist_n, acc = tiled._norm_tables(hist)
    return tuple(t.numpy() for t in
                 (y, qd, bias, hist, *pmesh.sharded_rans_fold(y, qd, hist_n, acc)))


def _job(layout, encodes, decodes, tiles=None):
    """One rank: the mesh encode of each images list, the mesh decode of
    each container list (a ValueError's message in place of a result), and
    with ``tiles`` the modeling pass and fold over ``make_mesh()``."""
    mesh = pmesh.make_mesh2(*layout, device="cpu")
    out = {}
    for name, imgs in encodes.items():
        try:
            out["enc", name] = pmesh.encode_batch_mesh(imgs, mesh, T, T)
        except ValueError as e:
            out["enc", name] = str(e)
    for name, conts in decodes.items():
        out["dec", name] = pmesh.decode_batch_mesh(conts, mesh)
    if tiles is not None:
        out["model_fold"] = _model_fold(pmesh.make_mesh(device="cpu"), tiles)
    return out


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def imgs():
    return case_images()


@pytest.fixture(scope="module")
def jax_side(imgs):
    """nblic_tpu's containers: the mesh's at every layout, a profile-2 and a
    near-2 container of the pair, and its mesh decode of those two."""
    from nblic_tpu.models import tiled as j_tiled
    from nblic_tpu.parallel import mesh as j_mesh

    out = {layout: jax_containers(imgs["pair"], layout) for layout in LAYOUTS}
    out["six"] = jax_containers(imgs["six"], (1, 4))
    out["p2"] = j_tiled.encode_batch(imgs["pair"], tile_h=T, tile_w=T, effort=2)
    out["near2"] = [j_tiled.encode(im, near=2, tile_h=T, tile_w=T) for im in imgs["pair"]]
    for kind in ("p2", "near2"):
        out["dec", kind] = j_mesh.decode_batch_mesh(out[kind], _jax_mesh((2, 2)))
    return out


@pytest.fixture(scope="module")
def port_side(imgs, jax_side):
    """Every layout's ranks, each running every case; the results of each
    layout's rank 0 after checking that all ranks agree."""
    tiles = tiled.to_tiles(torch.from_numpy(imgs["pair"][0]), T, T).numpy()
    out = {}
    for layout in LAYOUTS:
        encodes = {"pair": imgs["pair"]}
        decodes = {"jax": jax_side[layout], "p2": jax_side["p2"], "near2": jax_side["near2"]}
        if layout == (1, 4):
            encodes["six"] = imgs["six"]
            decodes["six"] = jax_side["six"]
        if layout[0] == 2:
            encodes["odd"] = imgs["pair"] + imgs["pair"][:1]  # 3 over 2 rows
        ranks = pmesh.launch(layout[0] * layout[1], _job, layout, encodes, decodes,
                             tiles if layout == (1, 4) else None, timeout=TIMEOUT)
        for r in ranks[1:]:
            for key, v in r.items():
                if key[0] == "enc":
                    assert v == ranks[0][key], (layout, key)
                elif key[0] == "dec":
                    assert all(np.array_equal(a, b) for a, b in zip(v, ranks[0][key]))
        out[layout] = ranks
    return out


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", LAYOUTS)
def test_encode_batch_mesh_writes_jax_bytes(port_side, jax_side, imgs, layout):
    got = port_side[layout][0]["enc", "pair"]
    assert got == jax_side[layout]
    g = 12 // layout[1]  # the group width the mesh writes: a shard's tiles
    assert all(tiled._Parsed(c).group_size == g for c in got)
    for back, im in zip(tiled.decode_batch(got, device="cpu"), imgs["pair"]):
        np.testing.assert_array_equal(back, im)


def test_encode_pad_group_writes_jax_bytes_and_decodes(port_side, jax_side, imgs):
    # 6 tiles over 4 shards: 4 groups of 2 lanes, the last all pad
    got = port_side[1, 4][0]["enc", "six"]
    assert got == jax_side["six"]
    p = tiled._Parsed(got[0])
    assert (p.group_size, len(p.counts)) == (2, 4)
    np.testing.assert_array_equal(p.n_active(), [2, 2, 2, 0])
    np.testing.assert_array_equal(tiled.decode_batch(got, device="cpu")[0], imgs["six"][0])


@pytest.mark.parametrize("layout", [(2, 1), (2, 2)])
def test_encode_batch_not_dividing_data_raises(port_side, layout):
    assert port_side[layout][0]["enc", "odd"] == "batch/tile axes must divide the mesh"


def test_sharded_model_and_fold_match_jax(port_side, imgs):
    import jax
    import jax.numpy as jnp

    from nblic_tpu.models import tiled as j_tiled
    from nblic_tpu.parallel import mesh as j_mesh

    ranks = [r["model_fold"] for r in port_side[1, 4]]
    tiles = j_tiled.to_tiles(imgs["pair"][0], T, T)
    j_mesh4 = j_mesh.make_mesh(4, devices=jax.devices("cpu"))
    sharded = j_mesh.shard_tiles(jnp.asarray(tiles), j_mesh4)
    y, qd, bias, hist = (np.asarray(v) for v in j_mesh.sharded_model_lossless(j_mesh4)(sharded))
    np.testing.assert_array_equal(np.concatenate([r[0] for r in ranks]), y)
    np.testing.assert_array_equal(np.concatenate([r[1] for r in ranks]), qd)
    for r in ranks:  # replicated tables
        np.testing.assert_array_equal(r[2], bias)
        np.testing.assert_array_equal(r[3], hist)
    # and the port's single-process modeling pass of the whole image
    one = tiled._model_lossless_impl(torch.from_numpy(np.asarray(tiles))[None])
    for got, want in zip((y, qd, bias, hist), one):
        np.testing.assert_array_equal(got, want[0].numpy())
    # the tables each rank folded with (the JAX package's host normalizer
    # rounds otherwise: its encoders use the device one, as the port does)
    hist_n, acc = (t.numpy() for t in tiled._norm_tables(torch.from_numpy(ranks[0][3])))
    words, emits, state = (np.asarray(v) for v in j_mesh.sharded_rans_fold(j_mesh4)(
        jnp.asarray(y), jnp.asarray(qd), jnp.asarray(hist_n), jnp.asarray(acc)))
    np.testing.assert_array_equal(np.concatenate([r[5] for r in ranks]), emits)
    np.testing.assert_array_equal(np.concatenate([r[4] for r in ranks])[emits], words[emits])
    np.testing.assert_array_equal(np.concatenate([r[6] for r in ranks]), state)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_decode_batch_mesh_reads_jax_mesh_containers(port_side, imgs, layout):
    for back, im in zip(port_side[layout][0]["dec", "jax"], imgs["pair"]):
        np.testing.assert_array_equal(back, im)


@pytest.mark.parametrize("kind", ["p2", "near2"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_decode_batch_mesh_matches_jax(port_side, jax_side, imgs, layout, kind):
    got = port_side[layout][0]["dec", kind]
    for back, want, im in zip(got, jax_side["dec", kind], imgs["pair"]):
        np.testing.assert_array_equal(back, want)
        assert np.abs(back.astype(int) - im).max() <= (2 if kind == "near2" else 0)


def test_decode_pad_group_on_four_shards(port_side, imgs):
    np.testing.assert_array_equal(port_side[1, 4][0]["dec", "six"][0], imgs["six"][0])


def test_single_process_decode_takes_mixed_group_counts(jax_side, imgs):
    # one image over 3 and over 4 tile shards: groups of 2 either way, 3 or
    # 4 of them; a batch of both decodes (one by one)
    three = jax_containers(imgs["six"], (1, 3))
    assert [len(tiled._Parsed(c).counts) for c in three + jax_side["six"]] == [3, 4]
    for back in tiled.decode_batch(three + jax_side["six"], device="cpu"):
        np.testing.assert_array_equal(back, imgs["six"][0])


def test_decode_batch_mesh_refuses_mixed_geometry(jax_side):
    # refused on the host before any rank is needed: the check runs first
    with pytest.raises(ValueError, match="same-geometry"):
        pmesh.decode_batch_mesh(jax_side[1, 2] + jax_side[1, 4], mesh=None)


def test_fixtures_are_jax_mesh_bytes():
    for name, (imgs, layout) in fixture_cases().items():
        stored, conts = read_fixture(name)
        np.testing.assert_array_equal(stored, np.stack(imgs))
        assert conts == jax_containers(imgs, layout), name


if __name__ == "__main__":
    write_fixtures()
    print(f"wrote {DATA}")
