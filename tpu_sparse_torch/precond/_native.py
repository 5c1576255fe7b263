"""ctypes bindings of the port's host C++: the AMG setup
(``csrc/host/amg_setup.cc``) and the ILU(0) factor (``csrc/host/ilu0.cc``).

Counterpart of ``tpu_sparse/native/__init__.py`` for the three kernels the
port's AMG setup runs (``aggregate``, ``rap_pc`` and ``l1_row_norms``),
plus ``ilu0``, the factor and level schedule of ``precond/ilu.py``. Each
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
ILU_SOURCE = PACKAGE_DIR / "csrc" / "host" / "ilu0.cc"
BUILD_DIR = PACKAGE_DIR / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
# the factor must round as the JAX scan does: no fused multiply-adds
ILU_FLAGS = CXX_FLAGS + ("-ffp-contract=off",)

_lock = threading.Lock()
_libs: "dict[Path, ctypes.CDLL]" = {}


def _compiler() -> str:
    for c in (os.environ.get("CXX"), "c++", "g++"):
        if c and shutil.which(c):
            return shutil.which(c)
    raise RuntimeError("no host C++ compiler (set CXX): the host code of "
                       "tpu_sparse_torch builds from source at first use")


def build(source: Path = SOURCE, flags: Tuple[str, ...] = CXX_FLAGS
          ) -> Path:
    """Compile ``source`` unless its library exists; returns its path."""
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(flags).encode())
    out_dir = BUILD_DIR / f"host-{h.hexdigest()[:16]}"
    lib_path = out_dir / f"{source.stem}.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / (f"{source.stem}.{os.getpid()}."
                     f"{threading.get_ident()}.so")
    cmd = [_compiler(), *flags, str(source), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host C++ build failed (exit {proc.returncode})"
                           f": {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def _load(source: Path, flags: Tuple[str, ...], bind) -> ctypes.CDLL:
    """``source``'s library, built and loaded on first call; ``bind(lib)``
    sets its functions' argument and return types."""
    with _lock:
        if source not in _libs:
            lib = ctypes.CDLL(str(build(source, flags)))
            bind(lib)
            _libs[source] = lib
        return _libs[source]


_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)


def _bind_amg(lib: ctypes.CDLL) -> None:
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.ts_aggregate.restype = ctypes.c_int64
    lib.ts_aggregate.argtypes = [ctypes.c_int64, _i32p, _i32p, f64p,
                                 ctypes.c_double, ctypes.c_int32, _i64p]
    lib.ts_rap_pc.restype = ctypes.c_int64
    lib.ts_rap_pc.argtypes = [ctypes.c_int64, ctypes.c_int64, _i32p, _i32p,
                              f64p, _i64p, _i32p, _i32p, f64p,
                              ctypes.c_int64]
    lib.ts_l1_row_norms.restype = None
    lib.ts_l1_row_norms.argtypes = [ctypes.c_int64, _i32p, f64p, f64p]


# the factor's entry and the C type of its values' parts, by numpy dtype
_ILU_ENTRIES = {np.dtype(np.float64): ("ts_ilu0_f64", ctypes.c_double),
                np.dtype(np.float32): ("ts_ilu0_f32", ctypes.c_float),
                np.dtype(np.complex128): ("ts_ilu0_c128", ctypes.c_double),
                np.dtype(np.complex64): ("ts_ilu0_c64", ctypes.c_float)}


def _bind_ilu(lib: ctypes.CDLL) -> None:
    for name, fp in _ILU_ENTRIES.values():
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_int64, ctypes.c_int64, _i64p,
                       ctypes.POINTER(fp), ctypes.POINTER(fp), _i32p, _i32p,
                       _i64p]


def library() -> ctypes.CDLL:
    """The AMG setup's library, built on first call."""
    return _load(SOURCE, CXX_FLAGS, _bind_amg)


def ilu_library() -> ctypes.CDLL:
    """The ILU(0) factor's library, built on first call."""
    return _load(ILU_SOURCE, ILU_FLAGS, _bind_ilu)


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


def ilu0(offsets, data: np.ndarray
         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[int, int]]:
    """ILU(0) of a DIA matrix (``data`` (ndiag, n), float32, float64,
    complex64 or complex128, in that dtype) on its own pattern. Returns
    (factored band (ndiag, n): L's multipliers on the negative offsets, U
    on the rest; forward levels (n,) int32; backward levels (n,) int32;
    the two level counts).
    Raises JAX's ValueError without a stored main diagonal."""
    data = np.ascontiguousarray(data)
    if data.dtype not in _ILU_ENTRIES:
        raise TypeError(f"ilu0 takes float32, float64, complex64 or "
                        f"complex128 values, got {data.dtype}")
    offs = _as(offsets, np.int64)
    nd, n = data.shape
    if offs.size != nd:
        raise ValueError("one offset per stored diagonal")
    if 0 not in offs:
        raise ValueError("ILU(0) needs a stored main diagonal")
    lib = ilu_library()
    out = np.empty_like(data)
    lev_f = np.empty(n, np.int32)
    lev_b = np.empty(n, np.int32)
    n_lev = np.zeros(2, np.int64)
    name, fp = _ILU_ENTRIES[data.dtype]
    fn = getattr(lib, name)
    fn(n, nd, _ptr(offs, ctypes.c_int64), _ptr(data, fp), _ptr(out, fp),
       _ptr(lev_f, ctypes.c_int32), _ptr(lev_b, ctypes.c_int32),
       _ptr(n_lev, ctypes.c_int64))
    return out, lev_f, lev_b, (int(n_lev[0]), int(n_lev[1]))
