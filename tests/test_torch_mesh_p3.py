"""The port's profile-3 mesh (images over ``data``) against its
single-process strip engine and nblic_tpu's mesh.

Gloo groups of 2 and 4 CPU ranks spawned by ``mesh.launch``; every rank
returns every container or image.  One JAX compile (the mesh's near-2
encode of the 48x64 batch); the other containers are held to the port's
single-process ``strips.encode_batch``, which the p3 tests hold to
nblic_tpu.  Tolerance 0.  JAX is imported inside the test: the ranks import
this module to find their job.
"""

import multiprocessing
import os
import time

import numpy as np
import pytest
import torch

from nblic_tpu_torch.models import strips
from nblic_tpu_torch.parallel import mesh as pmesh
from nblic_tpu_torch.utils.synth import synth_image

torch.set_num_threads(1)

TH = 16
TIMEOUT = 240.0


def _job(layout, imgs, decode: bool):
    """One rank: the mesh encode of ``imgs`` at near 0 and 2, then (with
    ``decode``) the mesh decode of the near-0 containers."""
    mesh = pmesh.make_mesh2(*layout, device="cpu")
    out = {near: pmesh.p3_encode_batch_mesh(imgs, mesh, th=TH, near=near) for near in (0, 2)}
    if decode:
        out["dec"] = pmesh.p3_decode_batch_mesh(out[0], mesh)
    return out


def _fail_on_rank_1():
    """Rank 1 raises while rank 0 waits for it in a collective."""
    if torch.distributed.get_rank() == 1:
        raise ValueError("rank 1 gives up")
    torch.distributed.barrier()


def _sleep(seconds: float):
    time.sleep(seconds)


@pytest.fixture(scope="module")
def imgs():
    """An odd batch: three 48x64 images, one of them portrait (the engine
    normalizes orientation, so all three share one plane)."""
    rng = np.random.default_rng(93)
    return [synth_image(rng, 48, 64), synth_image(rng, 64, 48), synth_image(rng, 48, 64)]


@pytest.fixture(scope="module")
def single(imgs):
    """The port's single-process containers at near 0 and 2."""
    return {near: strips.encode_batch(imgs, th=TH, near=near, device="cpu") for near in (0, 2)}


@pytest.fixture(scope="module")
def ranks(imgs):
    out = {(2, 1): pmesh.launch(2, _job, (2, 1), imgs, True, timeout=TIMEOUT),
           (2, 2): pmesh.launch(4, _job, (2, 2), imgs[:2], False, timeout=TIMEOUT)}
    return out


@pytest.mark.parametrize("near", [0, 2])
@pytest.mark.parametrize("layout", [(2, 1), (2, 2)])
def test_p3_encode_batch_mesh_equals_single_process(ranks, single, layout, near):
    n = 3 if layout == (2, 1) else 2
    for r in ranks[layout]:  # every rank returns every container
        assert r[near] == single[near][:n]


def test_p3_encode_batch_mesh_writes_jax_mesh_bytes(ranks, imgs):
    import jax

    from nblic_tpu.parallel import mesh as j_mesh

    j = j_mesh.p3_encode_batch_mesh(
        imgs, j_mesh.make_mesh2(2, 1, devices=jax.devices("cpu")), th=TH, near=2)
    assert ranks[2, 1][0][2] == j


def test_p3_decode_batch_mesh_exact_on_odd_batch(ranks, imgs):
    for r in ranks[2, 1]:
        assert len(r["dec"]) == 3
        for back, im in zip(r["dec"], imgs):
            np.testing.assert_array_equal(back, im)


def test_p3_mesh_refuses_what_jax_refuses(single, imgs):
    # checked on the host before any rank is needed
    with pytest.raises(ValueError, match="same-shape"):
        pmesh.p3_encode_batch_mesh([imgs[0], imgs[0][:32]], mesh=None)
    with pytest.raises(ValueError, match="same-geometry adaptive"):
        pmesh.p3_decode_batch_mesh(single[0] + single[2], mesh=None)  # near 0 and 2
    static = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data_torch_p3",
                          "static.nbtc")
    with open(static, "rb") as f:
        with pytest.raises(ValueError, match="same-geometry adaptive"):
            pmesh.p3_decode_batch_mesh([f.read()], mesh=None)  # a static-bias table


def test_launch_raises_the_failing_ranks_traceback_and_ends_every_rank():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"rank 1 failed:(.|\n)*ValueError: rank 1 gives up"):
        pmesh.launch(2, _fail_on_rank_1, timeout=TIMEOUT)
    assert time.monotonic() - t0 < TIMEOUT / 2  # rank 0 did not wait out its collective
    assert not multiprocessing.active_children()


def test_launch_ends_a_group_that_outlasts_its_timeout():
    with pytest.raises(RuntimeError, match="the group of 2 ranks outlasted 20.0 s"):
        pmesh.launch(2, _sleep, 600.0, timeout=20.0)
    assert not multiprocessing.active_children()
