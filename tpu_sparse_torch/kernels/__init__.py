"""Kernel dispatch: SpMV and SpMM for DIA, CWELL, BELL, BSR, CSR, COO and
dense operands.

SpMV: a DIA operand with a CUDA vector launches the hand-written DIA kernel
(``cuda_spmv``), a CWELL operand K4/K5 (``cuda_cwell``), and a BELL or BSR
operand K4/K5 on the CWELL repack of its blocks (``sparse.bell.block_cwell``,
built once per matrix content), as the JAX package runs its block SpMV on
the CWELL kernel. SpMM: a CWELL operand with a CUDA block launches K6/K7
(``cuda_cwell``), a BELL operand K8 (``cuda_bell``). A CPU operand takes
the plain version in ``reference``; a CWELLSeg sums its segments'
products. The DIA, BSR, CSR, COO and dense SpMM and the CSR/COO/dense SpMV
are plain PyTorch on every device, as the JAX package left them to XLA
(it has no DIA SpMM kernel). No flag and no fallback selects between paths.

``as_matvec`` / ``as_matmat`` turn an operator into a function of a vector
/ of an (n, k) block. The JAX package batches its multi-RHS solvers with
``vmap`` and routes a batched matvec to its SpMM (``batch_safe_matvec``);
the port has no ``vmap``, so its batched solvers call ``as_matmat``, whose
product is one ``spmm``, directly. A callable operator is applied column
by column, which is what the JAX ``vmap`` of it means.
"""

from __future__ import annotations

from typing import Callable

import torch

from tpu_sparse_torch.kernels import reference as ref
from tpu_sparse_torch.sparse.bell import BELL, block_cwell
from tpu_sparse_torch.sparse.containers import (BSR, COO, CSR, DIA,
                                                is_sparse, values,
                                                with_values)
from tpu_sparse_torch.sparse.cwell import CWELL, CWELLSeg


def _promote(A, x):
    """Cast the matrix values and x to their common dtype."""
    v = values(A)
    dt = torch.promote_types(v.dtype, x.dtype)
    if v.dtype != dt:
        A = with_values(A, v.to(dt))
    return A, x.to(dt)


def _cwellseg_apply(A: CWELLSeg, x: torch.Tensor, seg_fn) -> torch.Tensor:
    """Sum the segments' products, each on its own rows of x (a vector or
    an (m, k) block) and into its own row range (JAX
    ``kernels/__init__.py::_cwellseg_apply``)."""
    n = A.shape[0]
    out = None
    for W, j0, w, r0 in zip(A.segments, A.starts, A.widths, A.rstarts):
        t = seg_fn(W, x[j0:j0 + w])
        if W.shape[0] == n and r0 == 0:
            out = t if out is None else out + t
        else:
            if out is None:
                out = t.new_zeros((n,) + tuple(t.shape[1:]))
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
    if isinstance(A, (BELL, BSR)) and x.is_cuda:
        from tpu_sparse_torch.kernels.cuda_cwell import cwell_spmv_cuda

        A, x = _promote(A, x)
        return cwell_spmv_cuda(block_cwell(A), x)
    return spmv_reference(A, x)


def spmv_reference(A, x: torch.Tensor) -> torch.Tensor:
    """SpMV through the plain PyTorch kernels only."""
    if isinstance(A, DIA):
        return ref.dia_spmv(*_promote(A, x))
    if isinstance(A, CWELL):
        return ref.cwell_spmv(*_promote(A, x))
    if isinstance(A, CWELLSeg):
        return _cwellseg_apply(A, x, spmv_reference)
    if isinstance(A, BELL):
        return ref.bell_spmv(*_promote(A, x))
    if isinstance(A, BSR):
        return ref.bsr_spmv(*_promote(A, x))
    if isinstance(A, CSR):
        return ref.csr_spmv(A, x)
    if isinstance(A, COO):
        return ref.coo_spmv(A, x)
    dt = torch.promote_types(A.dtype, x.dtype)
    return torch.mv(A.to(dt), x.to(dt))


def spmm(A, B: torch.Tensor) -> torch.Tensor:
    """Y = A @ B for a container or a dense matrix and a dense (m, k) B."""
    if isinstance(A, CWELL):
        from tpu_sparse_torch.kernels.cuda_cwell import cwell_spmm

        A, B = _promote(A, B)
        return cwell_spmm(A, B.contiguous())
    if isinstance(A, CWELLSeg):
        return _cwellseg_apply(A, B, spmm)
    if isinstance(A, BELL):
        from tpu_sparse_torch.kernels.cuda_bell import bell_spmm

        A, B = _promote(A, B)
        return bell_spmm(A, B.contiguous())
    if isinstance(A, DIA):
        return ref.dia_spmm(A, B)
    if isinstance(A, BSR):
        return ref.bsr_spmm(*_promote(A, B))
    if isinstance(A, CSR):
        return ref.csr_spmm(A, B)
    if isinstance(A, COO):
        return ref.coo_spmm(A, B)
    dt = torch.promote_types(A.dtype, B.dtype)
    return torch.mm(A.to(dt), B.to(dt))


def as_matvec(A) -> Callable:
    """Normalize an operator (container, dense matrix or callable) into a
    matvec closure."""
    if callable(A) and not is_sparse(A) and not isinstance(A, torch.Tensor):
        return A
    if is_sparse(A) or isinstance(A, torch.Tensor):
        return lambda x: spmv(A, x)
    raise TypeError(f"unsupported operator type: {type(A)}")


def as_matmat(A) -> Callable:
    """Normalize an operator into a function of an (n, k) block (JAX
    ``block._as_matmat``): None is the identity, a container or a dense
    matrix one ``spmm``, a Jacobi preconditioner one row scaling (what the
    JAX ``vmap`` of its diagonal product computes), and any other callable
    its product column by column."""
    from tpu_sparse_torch.precond.jacobi import DiagonalPreconditioner

    if A is None:
        return lambda V: V
    if is_sparse(A) or isinstance(A, torch.Tensor):
        return lambda V: spmm(A, V)
    if isinstance(A, DiagonalPreconditioner):
        return lambda V: A.dinv[:, None] * V
    if callable(A):
        return lambda V: torch.stack([A(V[:, j]) for j in range(V.shape[1])],
                                     dim=1)
    raise TypeError(f"unsupported operator type: {type(A)}")
