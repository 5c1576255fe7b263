"""The host C++ set-up kernels as a public module.

Counterpart of ``tpu_sparse/native/__init__.py``, over the port's own
host code (``precond/_native.py``, ``csrc/host/amg_setup.cc``, built with
the host C++ compiler at first use): ``available``, ``aggregate``,
``rap_pc`` and ``l1_row_norms`` call it; ``dia_to_csr`` and
``cwell_pack`` return the JAX functions' arrays through the port's own
converters (``convert.dia_to_csr_arrays`` and ``cwell.csr_to_cwell`` on
the CPU, torch ops), which the port's set-up runs in their place.
Inputs and outputs are numpy arrays. Nothing is built at import.
"""

from __future__ import annotations

import subprocess
from typing import Tuple

import numpy as np
import torch

from tpu_sparse_torch.precond import _native
from tpu_sparse_torch.precond._native import aggregate, l1_row_norms, rap_pc

__all__ = ["aggregate", "available", "cwell_pack", "dia_to_csr",
           "l1_row_norms", "rap_pc"]


def available() -> bool:
    """Whether the host library builds and loads (the first call builds
    it; a failure is not remembered)."""
    try:
        _native.library()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


def dia_to_csr(data: np.ndarray, offsets, shape
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """DIA -> CSR: (csr_data, indices, indptr). ``data`` is (ndiag, n)
    row-indexed (``data[d, i] = A[i, i + offsets[d]]``); keeps explicit
    in-band zeros and sorts each row's columns. indptr is int32 when nnz
    fits."""
    from tpu_sparse_torch.sparse.containers import DIA
    from tpu_sparse_torch.sparse.convert import dia_to_csr_arrays

    data = np.ascontiguousarray(data)
    if data.dtype not in (np.float32, np.float64):
        raise TypeError(f"unsupported dtype {data.dtype}")
    A = DIA(torch.from_numpy(data), tuple(int(o) for o in offsets), shape)
    out, indices, indptr = dia_to_csr_arrays(A)
    return out.numpy(), indices.numpy(), indptr.numpy()


def cwell_pack(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
               shape: Tuple[int, int], plane_pad: int = 8):
    """Pack CSR arrays into CWELL: (vals, idx2, srow, S), vals and idx2
    (blocks, S, 128), srow (blocks, S). Requires column-sorted indices.
    Returns None for a dtype other than float32 / float64, as the JAX
    function does."""
    from tpu_sparse_torch.sparse.containers import CSR
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell

    data = np.ascontiguousarray(data)
    if data.dtype not in (np.float32, np.float64):
        return None
    A = CSR(torch.from_numpy(data),
            torch.from_numpy(np.ascontiguousarray(indices, dtype=np.int32)),
            torch.from_numpy(np.ascontiguousarray(indptr, dtype=np.int64)),
            tuple(shape))
    W = csr_to_cwell(A, plane_pad=plane_pad)
    return (W.vals.numpy(), W.idx2.numpy(), W.srow.numpy(),
            int(W.vals.shape[1]))
