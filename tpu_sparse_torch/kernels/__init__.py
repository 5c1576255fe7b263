"""Kernel dispatch: SpMV for DIA, CWELL, CSR, COO and dense operands.

A DIA operand with a CUDA vector launches the hand-written DIA kernel
(``cuda_spmv``), a CWELL operand K4/K5 (``cuda_cwell``); a CPU vector takes
the plain version in ``reference``. A CWELLSeg sums its segments' SpMVs.
CSR/COO/dense SpMV are plain PyTorch on every device, as the JAX package
left them to XLA. No flag and no fallback selects between paths.
"""

from __future__ import annotations

from typing import Callable

import torch

from tpu_sparse_torch.kernels import reference as ref
from tpu_sparse_torch.sparse.containers import (COO, CSR, DIA, is_sparse,
                                                values, with_values)
from tpu_sparse_torch.sparse.cwell import CWELL, CWELLSeg


def _promote(A, x):
    """Cast the matrix values and x to their common dtype."""
    v = values(A)
    dt = torch.promote_types(v.dtype, x.dtype)
    if v.dtype != dt:
        A = with_values(A, v.to(dt))
    return A, x.to(dt)


def _cwellseg_apply(A: CWELLSeg, x: torch.Tensor, seg_fn) -> torch.Tensor:
    """Sum the segments' products, each on its own slice of x and into its
    own row range (JAX ``kernels/__init__.py::_cwellseg_apply``)."""
    n = A.shape[0]
    out = None
    for W, j0, w, r0 in zip(A.segments, A.starts, A.widths, A.rstarts):
        t = seg_fn(W, x[j0:j0 + w])
        if W.shape[0] == n and r0 == 0:
            out = t if out is None else out + t
        else:
            if out is None:
                out = t.new_zeros(n)
            r1 = r0 + W.shape[0]
            out = torch.cat([out[:r0], out[r0:r1] + t, out[r1:]])
    return out


def spmv(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a container or a dense matrix."""
    if isinstance(A, DIA):
        from tpu_sparse_torch.kernels.cuda_spmv import dia_spmv

        return dia_spmv(*_promote(A, x))
    if isinstance(A, CWELL):
        from tpu_sparse_torch.kernels.cuda_cwell import cwell_spmv

        return cwell_spmv(*_promote(A, x))
    if isinstance(A, CWELLSeg):
        return _cwellseg_apply(A, x, spmv)
    return spmv_reference(A, x)


def spmv_reference(A, x: torch.Tensor) -> torch.Tensor:
    """SpMV through the plain PyTorch kernels only."""
    if isinstance(A, DIA):
        return ref.dia_spmv(*_promote(A, x))
    if isinstance(A, CWELL):
        return ref.cwell_spmv(*_promote(A, x))
    if isinstance(A, CWELLSeg):
        return _cwellseg_apply(A, x, spmv_reference)
    if isinstance(A, CSR):
        return ref.csr_spmv(A, x)
    if isinstance(A, COO):
        return ref.coo_spmv(A, x)
    dt = torch.promote_types(A.dtype, x.dtype)
    return torch.mv(A.to(dt), x.to(dt))


def as_matvec(A) -> Callable:
    """Normalize an operator (container, dense matrix or callable) into a
    matvec closure."""
    if callable(A) and not is_sparse(A) and not isinstance(A, torch.Tensor):
        return A
    if is_sparse(A) or isinstance(A, torch.Tensor):
        return lambda x: spmv(A, x)
    raise TypeError(f"unsupported operator type: {type(A)}")
