"""ctypes binding for the native single-threaded HNSW baseline engine.

Compiled on first use with g++ -O3 (cached next to the source).  See
hnsw_ref.cpp for what this engine is and is not: it is the measurable
stand-in for the reference's single-threaded CPU performance and a fast
host-side oracle — not part of the accelerator serving path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "hnsw_ref.cpp")
_LIB = os.path.join(_DIR, "libhnswref.so")

_METRIC_CODE = {"l2": 0, "ip": 1, "cosine": 1}


def _build_lib() -> str:
    if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC):
        return _LIB
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        _SRC, "-o", _LIB,
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    return _LIB


_lib_handle = None


def _lib():
    global _lib_handle
    if _lib_handle is None:
        lib = ctypes.CDLL(_build_lib())
        lib.hnsw_ref_create.restype = ctypes.c_void_p
        lib.hnsw_ref_create.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint64,
        ]
        lib.hnsw_ref_add.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ]
        lib.hnsw_ref_query.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ]
        lib.hnsw_ref_count.restype = ctypes.c_int64
        lib.hnsw_ref_count.argtypes = [ctypes.c_void_p]
        lib.hnsw_ref_free.argtypes = [ctypes.c_void_p]
        _lib_handle = lib
    return _lib_handle


def native_available() -> bool:
    try:
        _lib()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


class NativeHNSW:
    """Single-threaded C++ HNSW (paper Algs 1–5) — the CPU baseline engine."""

    def __init__(self, dim: int, metric: str = "l2", M: int = 16,
                 ef_construction: int = 200, seed: int = 100):
        self.dim = dim
        self.metric = metric
        self._h = _lib().hnsw_ref_create(
            dim, _METRIC_CODE[metric], M, ef_construction, seed
        )

    def _prep(self, data) -> np.ndarray:
        data = np.ascontiguousarray(np.atleast_2d(data), dtype=np.float32)
        if self.metric == "cosine":
            n = np.linalg.norm(data, axis=1, keepdims=True)
            data = np.ascontiguousarray(data / np.where(n == 0, 1.0, n))
        return data

    def add_items(self, data) -> None:
        data = self._prep(data)
        _lib().hnsw_ref_add(self._h, data.shape[0], data)

    def knn_query(self, queries, k: int = 10, ef: int = 10):
        queries = self._prep(queries)
        nq = queries.shape[0]
        ids = np.empty((nq, k), np.int64)
        d = np.empty((nq, k), np.float32)
        _lib().hnsw_ref_query(self._h, nq, queries, k, max(ef, k), ids, d)
        return ids, d

    @property
    def element_count(self) -> int:
        return int(_lib().hnsw_ref_count(self._h))

    def __del__(self):
        # _lib_handle may already be torn down at interpreter shutdown;
        # losing the free there is fine (the process is exiting)
        if getattr(self, "_h", None) and _lib_handle is not None:
            _lib_handle.hnsw_ref_free(self._h)
            self._h = None
