"""ctypes loader for the native C++ reference kernels — the port's twin of
``vq_tpu.native``, over its own copy of ``hsd.cpp``.

The library is the CPU oracle and the live CPU baseline: pair distances
(squared Euclidean, Manhattan, dot, cosine similarity), a batched squared
distance, a multithreaded PQ encode and a nearest-centroid assignment,
plus the name of the SIMD level it was compiled for. It is compiled with
g++ (``-O3 -march=native``) on first use into the git-ignored ``build/``
beside the package's checkout, keyed by a hash of the source, the flags
and the host, and loaded with ctypes. The compiler writes a name of its own
process and the finished object is moved into place with ``os.replace``,
so processes that build at once (pytest-xdist workers) never read a
half-written library. A build or load that fails raises
:class:`~vq_tpu_torch.errors.NativeLibraryError`; :func:`available`
reports it as False.

Inputs are anything numpy takes; outputs are numpy arrays or floats.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from vq_tpu_torch.errors import NativeLibraryError

__all__ = ["available", "get_native_backend", "sqeuclidean", "manhattan", "dot",
           "cosine_similarity", "sqeuclidean_batch", "pq_encode", "assign"]

_SRC = Path(__file__).resolve().parent / "hsd.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vq_tpu_torch" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared")

_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[str] = None


def _build_and_load() -> ctypes.CDLL:
    # -march=native: a library built on one host is never loaded on another.
    host = " ".join((os.uname().nodename, os.uname().machine, *CXX_FLAGS))
    digest = hashlib.sha256(_SRC.read_bytes() + host.encode()).hexdigest()[:16]
    so_path = BUILD_DIR / f"libhsd-{digest}.so"
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so_path.with_name(f"{so_path.name}.{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC), "-lpthread"],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise NativeLibraryError(f"g++ failed building hsd kernels: {proc.stderr[-500:]}")
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(str(so_path))

    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    st = ctypes.c_size_t
    for name in ("hsd_sqeuclidean_f32", "hsd_manhattan_f32", "hsd_dot_f32", "hsd_cosine_sim_f32"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_float
        fn.argtypes = [f32p, f32p, st]
    lib.hsd_get_backend.restype = ctypes.c_char_p
    lib.hsd_get_backend.argtypes = []
    lib.hsd_sqeuclidean_batch_f32.restype = None
    lib.hsd_sqeuclidean_batch_f32.argtypes = [f32p, f32p, f32p, st, st, st]
    lib.hsd_pq_encode_f32.restype = None
    lib.hsd_pq_encode_f32.argtypes = [f32p, f32p, u8p, st, st, st, st, ctypes.c_int]
    lib.hsd_assign_f32.restype = None
    lib.hsd_assign_f32.argtypes = [f32p, f32p, i32p, st, st, st, ctypes.c_int]
    return lib


def _get() -> ctypes.CDLL:
    global _lib, _load_error
    if _lib is None:
        if _load_error is not None:
            raise NativeLibraryError(_load_error)
        try:
            _lib = _build_and_load()
        except Exception as e:  # noqa: BLE001 — recorded, raised typed
            _load_error = str(e)
            raise NativeLibraryError(_load_error) from e
    return _lib


def available() -> bool:
    """True if the native library builds and loads on this machine."""
    try:
        _get()
        return True
    except NativeLibraryError:
        return False


def get_native_backend() -> str:
    """The SIMD level the library was compiled for, e.g. ``"AVX2 (native)"``."""
    return _get().hsd_get_backend().decode()


def _f32c(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a torch tensor
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(x, dtype=np.float32)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _pair(name: str, a, b) -> float:
    a, b = _f32c(a), _f32c(b)
    if a.shape != b.shape or a.ndim != 1:
        raise ValueError(f"expected two vectors of one length, got {a.shape} and {b.shape}")
    return float(getattr(_get(), name)(_ptr(a, ctypes.c_float), _ptr(b, ctypes.c_float), a.size))


def sqeuclidean(a, b) -> float:
    return _pair("hsd_sqeuclidean_f32", a, b)


def manhattan(a, b) -> float:
    return _pair("hsd_manhattan_f32", a, b)


def dot(a, b) -> float:
    return _pair("hsd_dot_f32", a, b)


def cosine_similarity(a, b) -> float:
    return _pair("hsd_cosine_sim_f32", a, b)


def sqeuclidean_batch(x, c) -> np.ndarray:
    """``[n, k]`` squared distances of rows ``x [n, d]`` to ``c [k, d]``."""
    x, c = _f32c(x), _f32c(c)
    n, d = x.shape
    k = c.shape[0]
    out = np.empty((n, k), dtype=np.float32)
    _get().hsd_sqeuclidean_batch_f32(_ptr(x, ctypes.c_float), _ptr(c, ctypes.c_float),
                                     _ptr(out, ctypes.c_float), n, k, d)
    return out


def pq_encode(x, codebooks, num_threads: int = 0) -> np.ndarray:
    """CPU PQ encode: ``x [n, m*s]``, ``codebooks [m, k, s]`` (k <= 256) ->
    codes ``[n, m]`` u8; ``num_threads`` 0 takes every core."""
    x, cb = _f32c(x), _f32c(codebooks)
    n = x.shape[0]
    m, k, s = cb.shape
    if x.shape[1] != m * s or k > 256:
        raise ValueError(f"rows of width {x.shape[1]} against codebooks {cb.shape}")
    codes = np.empty((n, m), dtype=np.uint8)
    _get().hsd_pq_encode_f32(_ptr(x, ctypes.c_float), _ptr(cb, ctypes.c_float),
                             _ptr(codes, ctypes.c_uint8), n, m, k, s, num_threads)
    return codes


def assign(x, centroids, num_threads: int = 0) -> np.ndarray:
    """CPU nearest-centroid assignment: ``x [n, d]``, ``c [k, d]`` -> ``[n]``
    int32."""
    x, c = _f32c(x), _f32c(centroids)
    n, d = x.shape
    k = c.shape[0]
    out = np.empty((n,), dtype=np.int32)
    _get().hsd_assign_f32(_ptr(x, ctypes.c_float), _ptr(c, ctypes.c_float),
                          _ptr(out, ctypes.c_int32), n, k, d, num_threads)
    return out
