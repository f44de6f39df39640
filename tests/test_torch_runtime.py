"""The port's copy of the native runtime, and the committed interop fixtures.

``nblic_tpu_torch/runtime/src`` must equal ``nblic_tpu/runtime/src`` byte
for byte; its library builds under ``build/`` (never in the package) with
the Makefile's flags, and writes the bytes ``nblic_tpu.runtime`` writes at
every effort and near tested here, the multithreaded effort-0 encoder
included.

``tests/data_torch_interop/`` holds two small images (a full-width crop of
a Kodak-shaped synthetic image and a 12x16 one) and the Q0.2 and NBLIC0.3
(efforts 1-3, and effort 1 at near 2) containers that ``nblic_tpu.runtime``
writes for them; the smoke run on the card, where there is no JAX, holds
the port's device engines to them.  This test rebuilds them with
``nblic_tpu`` so they cannot drift.  Regenerate after a deliberate format
change, from the repo root, with
``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_runtime.py``.
"""

import filecmp
import os

import numpy as np
import pytest
import torch
from conftest import make_test_images

from nblic_tpu import runtime as j_runtime
from nblic_tpu_torch import api, runtime
from nblic_tpu_torch.utils.synth import synth_image

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data_torch_interop")
CROP_ROWS = 2
# (name, near, effort) of every fixture container
MODES = (("q0", 0, 0), ("e1", 0, 1), ("e2", 0, 2), ("e3", 0, 3), ("e1n2", 2, 1))


def fixture_images() -> dict:
    """{name: image}: the first CROP_ROWS rows of a Kodak-shaped synthetic
    image at full width, and a 12x16 one."""
    crop = synth_image(np.random.default_rng(91), 512, 768)[:CROP_ROWS]
    return {"crop": np.ascontiguousarray(crop),
            "small": synth_image(np.random.default_rng(92), 12, 16)}


def fixture_containers(encode_q, encode_n) -> dict:
    """{(image name, mode name): container} written by the given encoders."""
    out = {}
    for name, img in fixture_images().items():
        for mode, near, effort in MODES:
            out[(name, mode)] = encode_q(img) if effort == 0 else encode_n(img, near, effort)
    return out


def _jax_containers():
    return fixture_containers(lambda im: j_runtime.q_encode(im, n_threads=1),
                              lambda im, near, effort: j_runtime.n_encode(im, near, effort))


def write_fixtures() -> None:
    os.makedirs(DATA, exist_ok=True)
    for name, img in fixture_images().items():
        np.save(os.path.join(DATA, f"{name}.npy"), img)
    for (name, mode), stream in _jax_containers().items():
        with open(os.path.join(DATA, f"{name}_{mode}.nblic"), "wb") as f:
            f.write(stream)


def test_sources_equal_the_originals():
    src = os.path.join(REPO, "nblic_tpu_torch", "runtime", "src")
    ref = os.path.join(REPO, "nblic_tpu", "runtime", "src")
    names = sorted(n for n in os.listdir(ref) if not n.startswith("."))
    assert sorted(os.listdir(src)) == names
    match, mismatch, errors = filecmp.cmpfiles(ref, src, names, shallow=False)
    assert match == names and not mismatch and not errors
    with open(os.path.join(src, "Makefile")) as f:
        makefile = f.read()
    for flag in runtime.CXXFLAGS + runtime.LDFLAGS:
        assert flag in makefile, flag
    assert all(s in makefile for s in runtime.SOURCES)


def test_library_lands_under_build():
    path = runtime.build()
    assert path.exists() and path.parent == runtime.BUILD_DIR
    assert runtime.BUILD_DIR.parts[-2:] == ("build", "nblic_tpu_torch")
    assert os.path.commonpath([str(path), REPO]) == REPO
    pkg = os.path.join(REPO, "nblic_tpu_torch")
    for root, _, files in os.walk(pkg):
        assert not [f for f in files if f.endswith((".so", ".lock"))], root
    assert runtime.version() == j_runtime.load().nbrt_version().decode()


@pytest.mark.parametrize("n_threads", [1, 4])
def test_effort0_bytes_equal(n_threads):
    for img in make_test_images(np.random.default_rng(1234)) + [fixture_images()["crop"]]:
        stream = runtime.q_encode(img, n_threads=n_threads)
        assert stream == j_runtime.q_encode(img, n_threads=n_threads), img.shape
        np.testing.assert_array_equal(runtime.q_decode(stream), img)


@pytest.mark.parametrize("effort,near", [(1, 0), (2, 0), (3, 0), (2, 1), (1, 3), (3, 9)])
def test_nblic_bytes_equal(effort, near):
    for img in make_test_images(np.random.default_rng(1234)):
        stream = runtime.n_encode(img, near=near, effort=effort)
        assert stream == j_runtime.n_encode(img, near=near, effort=effort), img.shape
        dec, got_near, got_effort = runtime.n_decode(stream)
        ref_dec, _, _ = j_runtime.n_decode(stream)
        np.testing.assert_array_equal(dec, ref_dec)
        assert (got_near, got_effort) == (near, effort)
        assert np.abs(dec.astype(int) - img).max() <= near


def test_native_errors_raise():
    with pytest.raises(RuntimeError, match="nbrt error"):
        runtime.n_decode(b"NBLIC0.3" + bytes(4))
    with pytest.raises(RuntimeError, match="nbrt error"):
        runtime.q_decode(b"Q0.2" + bytes(2))


def test_fixtures_are_nblic_tpus_bytes():
    for name, img in fixture_images().items():
        np.testing.assert_array_equal(np.load(os.path.join(DATA, f"{name}.npy")), img)
    ours = fixture_containers(lambda im: runtime.q_encode(im, n_threads=1),
                              lambda im, near, effort: runtime.n_encode(im, near, effort))
    for key, stream in _jax_containers().items():
        with open(os.path.join(DATA, "%s_%s.nblic" % key), "rb") as f:
            assert f.read() == stream == ours[key], key


def test_fixtures_on_the_device_engines():
    # the card runs the crop in the smoke run; here the small image, both ways
    img = fixture_images()["small"]
    for mode, near, effort in MODES:
        with open(os.path.join(DATA, f"small_{mode}.nblic"), "rb") as f:
            stream = f.read()
        assert api.compress(img, near=near, effort=effort, device="cpu") == stream, mode
        dec = api.decompress(stream, device="cpu")
        np.testing.assert_array_equal(dec, api.decompress(stream, backend="native"))
        assert np.abs(dec.astype(int) - img).max() <= near


if __name__ == "__main__":
    write_fixtures()
    print(f"wrote {DATA}")
