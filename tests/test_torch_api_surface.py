"""The port's top-level surface against nblic_tpu's.

Every public name of ``nblic_tpu`` and ``nblic_tpu.api`` exists in the
port: the same values for constants, the same parameter names (the port
adds ``device``) for functions, the port's own module for a subpackage.
A fresh ``import nblic_tpu_torch`` loads neither JAX nor ``nblic_tpu``.
"""

import __future__
import inspect
import os
import subprocess
import sys

import nblic_tpu
import nblic_tpu.api as j_api
import nblic_tpu.runtime as j_runtime
import pytest

import nblic_tpu_torch
import nblic_tpu_torch.api as t_api
import nblic_tpu_torch.runtime as t_runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# fixed lists: what dir() shows depends on which modules this process has
# imported, and every test worker must collect the same tests
TOP = ["compress", "decompress", "compress_tiled", "decompress_tiled", "MAX_NEAR",
       "EFFORTS", "__version__", "api", "constants", "utils", "models", "ops",
       "parallel", "runtime"]
API = ["compress", "decompress", "compress_tiled", "decompress_tiled", "MAX_NEAR",
       "EFFORTS", "check_size", "sniff_format"]


def _public(mod) -> set:
    """Names a user of ``mod`` reaches: no leading underscore, neither a
    module from outside the package nor a ``__future__`` feature."""
    names = set()
    for n in dir(mod):
        v = getattr(mod, n)
        if n.startswith("_") or isinstance(v, __future__._Feature):
            continue
        if inspect.ismodule(v) and not v.__name__.startswith("nblic_tpu."):
            continue
        names.add(n)
    return names


def _same(j, t, name):
    if inspect.ismodule(j):
        assert inspect.ismodule(t), name
        assert t.__name__ == "nblic_tpu_torch" + j.__name__[len("nblic_tpu"):]
    elif callable(j):
        kinds = (inspect.Parameter.VAR_KEYWORD, inspect.Parameter.VAR_POSITIONAL)
        j_params = [p for p, v in inspect.signature(j).parameters.items()
                    if v.kind not in kinds]
        assert set(j_params) <= set(inspect.signature(t).parameters), name
    else:
        assert t == j, name


def test_lists_hold_every_public_name():
    assert _public(nblic_tpu) | set(nblic_tpu._SUBPACKAGES) | {"__version__"} <= set(TOP)
    assert _public(j_api) <= set(API)


@pytest.mark.parametrize("name", TOP)
def test_top_level_name(name):
    _same(getattr(nblic_tpu, name), getattr(nblic_tpu_torch, name), name)


@pytest.mark.parametrize("name", API)
def test_api_name(name):
    _same(getattr(j_api, name), getattr(t_api, name), name)


def test_unknown_top_level_name_raises():
    with pytest.raises(AttributeError):
        nblic_tpu_torch.no_such_name  # noqa: B018


def test_runtime_available(monkeypatch):
    assert t_runtime.available() == j_runtime.available()
    assert t_runtime.available()  # the copy builds with g++ where nblic_tpu's does

    def unavailable():
        raise t_runtime.RuntimeUnavailable("no compiler")

    monkeypatch.setattr(t_runtime, "load", unavailable)
    assert not t_runtime.available()


def test_fresh_import_loads_neither_jax_nor_nblic_tpu():
    code = (
        "import sys, nblic_tpu_torch\n"
        "nblic_tpu_torch.parallel, nblic_tpu_torch.runtime\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'nblic_tpu')]\n"
        "print(len(bad), bad[:5])\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, timeout=300,
                         capture_output=True, text=True, check=True).stdout
    assert out.split()[0] == "0", out
