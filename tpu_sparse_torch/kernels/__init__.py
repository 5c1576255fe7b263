"""Kernel dispatch: SpMV for DIA, CSR, COO and dense operands.

A DIA operand with a CUDA vector launches the hand-written DIA kernel
(``cuda_spmv``); a CPU vector takes the plain version in ``reference``.
CSR/COO/dense SpMV are plain PyTorch on every device, as the JAX package
left them to XLA. No flag and no fallback selects between paths.
"""

from __future__ import annotations

from typing import Callable

import torch

from tpu_sparse_torch.kernels import reference as ref
from tpu_sparse_torch.sparse.containers import COO, CSR, DIA, is_sparse


def _promote(A, x):
    """Cast the matrix values and x to their common dtype."""
    dt = torch.promote_types(A.data.dtype, x.dtype)
    if A.data.dtype != dt:
        A = A.with_data(A.data.to(dt))
    return A, x.to(dt)


def spmv(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a container or a dense matrix."""
    if isinstance(A, DIA):
        from tpu_sparse_torch.kernels.cuda_spmv import dia_spmv

        return dia_spmv(*_promote(A, x))
    return spmv_reference(A, x)


def spmv_reference(A, x: torch.Tensor) -> torch.Tensor:
    """SpMV through the plain PyTorch kernels only."""
    if isinstance(A, DIA):
        return ref.dia_spmv(*_promote(A, x))
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
