"""ctypes binding of the host C++ AMG setup (``csrc/host/amg_setup.cc``).

Counterpart of ``tpu_sparse/native/__init__.py`` for the three kernels the
port's AMG setup runs: ``aggregate``, ``rap_pc`` and ``l1_row_norms``. The
source compiles with the host C++ compiler (``$CXX``, else ``c++`` or
``g++``) at first use into ``tpu_sparse_torch/_build/host-<hash>/``, keyed
by a hash of the source and flags. Each process builds to a name of its
own and moves the library into place with ``os.replace``, so processes that
build at once (test workers) never load a half-written file. A failed
build raises with the compiler's output and is not remembered: the next
call tries again. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "csrc" / "host" / "amg_setup.cc"
BUILD_DIR = PACKAGE_DIR / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None


def _compiler() -> str:
    for c in (os.environ.get("CXX"), "c++", "g++"):
        if c and shutil.which(c):
            return shutil.which(c)
    raise RuntimeError("no host C++ compiler (set CXX): the AMG setup of "
                       "tpu_sparse_torch builds from source at first use")


def build() -> Path:
    """Compile the source unless its library exists; returns its path."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    out_dir = BUILD_DIR / f"host-{h.hexdigest()[:16]}"
    lib_path = out_dir / "amg_setup.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"amg_setup.{os.getpid()}.{threading.get_ident()}.so"
    cmd = [_compiler(), *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host C++ build failed (exit {proc.returncode})"
                           f": {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64p = ctypes.POINTER(ctypes.c_int64)
            f64p = ctypes.POINTER(ctypes.c_double)
            lib.ts_aggregate.restype = ctypes.c_int64
            lib.ts_aggregate.argtypes = [ctypes.c_int64, i32p, i32p, f64p,
                                         ctypes.c_double, ctypes.c_int32,
                                         i64p]
            lib.ts_rap_pc.restype = ctypes.c_int64
            lib.ts_rap_pc.argtypes = [ctypes.c_int64, ctypes.c_int64, i32p,
                                      i32p, f64p, i64p, i32p, i32p, f64p,
                                      ctypes.c_int64]
            lib.ts_l1_row_norms.restype = None
            lib.ts_l1_row_norms.argtypes = [ctypes.c_int64, i32p, f64p, f64p]
            _lib = lib
        return _lib


def _as(arr, dtype) -> np.ndarray:
    return np.ascontiguousarray(arr, dtype=dtype)


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _check_csr(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
               n_cols: int) -> None:
    """Sizes and bounds the C++ loops trust, checked before any pointer
    goes across."""
    nnz = int(indptr[-1])
    if indptr[0] != 0 or np.any(np.diff(indptr) < 0):
        raise ValueError("indptr must start at 0 and not decrease")
    if indices.size < nnz or data.size < nnz:
        raise ValueError("indices/data shorter than indptr[-1]")
    if nnz and (indices[:nnz].min() < 0 or indices[:nnz].max() >= n_cols):
        raise ValueError("column index out of range")


def aggregate(indptr, indices, data, theta: float,
              target_size: int) -> Tuple[np.ndarray, int]:
    """Greedy strength-based aggregation of a square CSR matrix. Returns
    (aggregate id per row, number of aggregates)."""
    lib = library()
    indptr = _as(indptr, np.int32)
    indices = _as(indices, np.int32)
    data = _as(data, np.float64)
    n = indptr.size - 1
    _check_csr(indptr, indices, data, n)
    agg = np.empty(n, dtype=np.int64)
    na = lib.ts_aggregate(n, _ptr(indptr, ctypes.c_int32),
                          _ptr(indices, ctypes.c_int32),
                          _ptr(data, ctypes.c_double), float(theta),
                          int(target_size), _ptr(agg, ctypes.c_int64))
    return agg, int(na)


def rap_pc(indptr, indices, data, agg, nc: int
           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Galerkin product P^T A P for the piecewise-constant P of ``agg``.
    Returns the coarse CSR arrays (indptr, indices, data)."""
    lib = library()
    indptr = _as(indptr, np.int32)
    indices = _as(indices, np.int32)
    data = _as(data, np.float64)
    agg = _as(agg, np.int64)
    n = indptr.size - 1
    _check_csr(indptr, indices, data, n)
    if agg.size != n or (n and (agg.min() < 0 or agg.max() >= nc)):
        raise ValueError("aggregate ids out of range")
    cap = int(indptr[-1])
    indptr_c = np.empty(nc + 1, dtype=np.int32)
    indices_c = np.empty(cap, dtype=np.int32)
    data_c = np.empty(cap, dtype=np.float64)
    nnz_c = lib.ts_rap_pc(n, int(nc), _ptr(indptr, ctypes.c_int32),
                          _ptr(indices, ctypes.c_int32),
                          _ptr(data, ctypes.c_double),
                          _ptr(agg, ctypes.c_int64),
                          _ptr(indptr_c, ctypes.c_int32),
                          _ptr(indices_c, ctypes.c_int32),
                          _ptr(data_c, ctypes.c_double), cap)
    if nnz_c < 0:
        raise RuntimeError("rap_pc capacity overflow")
    return indptr_c, indices_c[:nnz_c].copy(), data_c[:nnz_c].copy()


def l1_row_norms(indptr, data) -> np.ndarray:
    """Row sums of |a_ij| of a CSR matrix."""
    lib = library()
    indptr = _as(indptr, np.int32)
    data = _as(data, np.float64)
    n = indptr.size - 1
    if data.size < int(indptr[-1]):
        raise ValueError("data shorter than indptr[-1]")
    out = np.empty(n, dtype=np.float64)
    lib.ts_l1_row_norms(n, _ptr(indptr, ctypes.c_int32),
                        _ptr(data, ctypes.c_double),
                        _ptr(out, ctypes.c_double))
    return out
