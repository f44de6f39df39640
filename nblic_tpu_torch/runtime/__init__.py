"""ctypes bindings to the port's copy of the nbrt native host runtime.

``src/`` is a byte-for-byte copy of ``nblic_tpu/runtime/src/``: the C++
encoders and decoders of the Q0.2 and NBLIC0.3 containers, the host fast
path (``api.compress(backend="native")``).  :func:`load` compiles it with
g++ at first use into ``build/nblic_tpu_torch/`` beside the package (the
flags are the Makefile's), under a name that carries a hash of the sources
and flags, so an edited source rebuilds; an flock lets concurrent processes
build it once.  A failed build raises :class:`RuntimeUnavailable`.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "nblic_tpu_torch"
SOURCES = ("nbrt_qnblic.cpp", "nbrt_nblic.cpp")
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-fno-strict-aliasing")
LDFLAGS = ("-shared", "-lpthread")


class RuntimeUnavailable(RuntimeError):
    pass


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(CXXFLAGS + LDFLAGS).encode())
    for src in sorted(SRC_DIR.iterdir()):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libnbrt_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the runtime unless a library for these sources exists."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libnbrt.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():  # another process built it while this one waited
            return path
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if cxx is None:
            raise RuntimeUnavailable("no C++ compiler (g++) to build the native runtime")
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [cxx, *CXXFLAGS, *(str(SRC_DIR / s) for s in SOURCES), *LDFLAGS, "-o", str(tmp)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeUnavailable(f"nbrt build failed:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)
    return path


@functools.cache
def load() -> ctypes.CDLL:
    """The loaded runtime library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    lib.nbrt_q_encode.restype = i64
    lib.nbrt_q_encode.argtypes = [u8p, i32, i32, u8p, i64, i32]
    lib.nbrt_q_decode.restype = i64
    lib.nbrt_q_decode.argtypes = [u8p, i64, u8p, i64, i32p, i32p]
    lib.nbrt_n_encode.restype = i64
    lib.nbrt_n_encode.argtypes = [u8p, i32, i32, i32, i32, u8p, i64, u8p]
    lib.nbrt_n_decode.restype = i64
    lib.nbrt_n_decode.argtypes = [u8p, i64, u8p, i64, i32p, i32p, i32p, i32p]
    lib.nbrt_version.restype = ctypes.c_char_p
    lib.nbrt_version.argtypes = []
    lib.nbrt_set_verbose.restype = None
    lib.nbrt_set_verbose.argtypes = [i32]
    return lib


def available() -> bool:
    """Whether the runtime builds (or is already built) and loads."""
    try:
        load()
        return True
    except (RuntimeUnavailable, OSError):
        return False


def _u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _check(ret: int) -> int:
    if ret < 0:
        raise RuntimeError(f"nbrt error {ret}")
    return int(ret)


def q_encode(img: np.ndarray, n_threads: int = 0) -> bytes:
    """Effort-0 encode into a Q0.2 container; ``n_threads`` <= 0 picks up to
    8 threads for images of at least 512 rows and 512 x 512 pixels."""
    lib = load()
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 8) if h >= 512 and h * w > 512 * 512 else 1
    cap = 2 * h * w + (1 << 16)
    out = np.empty(cap, dtype=np.uint8)
    n = _check(lib.nbrt_q_encode(_u8p(img), h, w, _u8p(out), cap, n_threads))
    return out[:n].tobytes()


def q_decode(stream: bytes) -> np.ndarray:
    """Decode a Q0.2 container."""
    lib = load()
    buf = np.frombuffer(stream, dtype=np.uint8)
    cap = 100_000_000
    img = np.empty(cap, dtype=np.uint8)
    h, w = ctypes.c_int32(), ctypes.c_int32()
    _check(lib.nbrt_q_decode(_u8p(buf), len(stream), _u8p(img), cap, ctypes.byref(h),
                             ctypes.byref(w)))
    return img[: h.value * w.value].reshape(h.value, w.value).copy()


def n_encode(img: np.ndarray, near: int = 0, effort: int = 1) -> bytes:
    """Effort-1..3 encode into an NBLIC0.3 container."""
    lib = load()
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape
    cap = 4 * h * w + (1 << 16)
    out = np.empty(cap, dtype=np.uint8)
    n = _check(lib.nbrt_n_encode(_u8p(img), h, w, near, effort, _u8p(out), cap,
                                 ctypes.POINTER(ctypes.c_uint8)()))
    return out[:n].tobytes()


def n_decode(stream: bytes):
    """Decode an NBLIC0.3 container: (image, near, effort)."""
    lib = load()
    buf = np.frombuffer(stream, dtype=np.uint8)
    cap = 100_000_000
    img = np.empty(cap, dtype=np.uint8)
    h, w, near, effort = (ctypes.c_int32() for _ in range(4))
    _check(lib.nbrt_n_decode(_u8p(buf), len(stream), _u8p(img), cap, ctypes.byref(h),
                             ctypes.byref(w), ctypes.byref(near), ctypes.byref(effort)))
    return img[: h.value * w.value].reshape(h.value, w.value).copy(), near.value, effort.value


def set_verbose(level: int) -> None:
    """The runtime's row-progress reporting on stderr (the CLI's ``-V``)."""
    load().nbrt_set_verbose(int(level))


def version() -> str:
    return load().nbrt_version().decode()
