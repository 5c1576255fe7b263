"""Diagonal (Jacobi) preconditioner, diagonal and row-L1 extraction.

Counterpart of ``tpu_sparse/precond/jacobi.py``. ``jacobi_preconditioner``
returns a ``DiagonalPreconditioner``, which the router and the extended
fast path recognise as a diagonal (as the JAX router recognises
``Partial(_apply_diag, dinv)``). ``diagonal`` also reads CWELL and
CWELLSeg packs, which the JAX ``diagonal`` refuses with a TypeError
(ROADMAP queue 3, R6). ``l1_jacobi_diag`` (the L1-Jacobi smoother's
diagonal) is computed on the operand's device from its values, off the
pack for CWELL and CWELLSeg.
"""

from __future__ import annotations

import torch

from tpu_sparse_torch.sparse.containers import COO, CSR, DIA
from tpu_sparse_torch.sparse.cwell import LW, CWELL, CWELLSeg
from tpu_sparse_torch.utils.tree import tree_map


def diagonal(A) -> torch.Tensor:
    """diag(A) for a container or dense matrix."""
    if isinstance(A, DIA):
        if 0 in A.offsets:
            return A.data[A.offsets.index(0)]
        return A.data.new_zeros(A.shape[0])
    if isinstance(A, CWELL):
        return _cwell_diagonal(A, 0, 0)[:A.shape[0]]
    if isinstance(A, CWELLSeg):
        out = A.segments[0].vals.new_zeros(A.shape[0])
        for W, j0, r0 in zip(A.segments, A.starts, A.rstarts):
            d = _cwell_diagonal(W, r0, j0)[:W.shape[0]]
            out = torch.cat([out[:r0], out[r0:r0 + d.shape[0]] + d,
                             out[r0 + d.shape[0]:]])
        return out
    if isinstance(A, CSR):
        A = A.tocoo()
    if isinstance(A, COO):
        mask = (A.row == A.col).to(A.dtype)
        out = A.data.new_zeros(A.shape[0])
        return out.index_add_(0, A.row.long(), A.data * mask)
    return torch.diagonal(A)


def l1_jacobi_diag(A) -> torch.Tensor:
    """The L1-Jacobi smoother diagonal d_i = sum_j |a_ij| (row L1 norm),
    as the AMGX JACOBI_L1 smoother of the reference (torch_amgx.py:50-73).
    DIA sums every stored entry, as the JAX function does."""
    if isinstance(A, DIA):
        return torch.sum(torch.abs(A.data), dim=0)
    if isinstance(A, CWELL):
        return _cwell_l1(A)[:A.shape[0]]
    if isinstance(A, CWELLSeg):
        out = A.segments[0].vals.new_zeros(A.shape[0])
        for W, r0 in zip(A.segments, A.rstarts):
            out[r0:r0 + W.shape[0]] += _cwell_l1(W)[:W.shape[0]]
        return out
    if isinstance(A, CSR):
        A = A.tocoo()
    if isinstance(A, COO):
        out = A.data.new_zeros(A.shape[0])
        return out.index_add_(0, A.row.long(), torch.abs(A.data))
    return torch.sum(torch.abs(A), dim=1)


def _cwell_l1(W: CWELL) -> torch.Tensor:
    """Per packed row, the sum of |value| over its slots (padding slots
    hold 0); one value per row of the n_blocks * 128 padded rows."""
    return torch.sum(torch.abs(W.vals), dim=1).reshape(-1)


def _cwell_diagonal(W: CWELL, r0: int, j0: int) -> torch.Tensor:
    """Per packed row, the sum of the slots whose global column equals the
    global row (the pack's rows start at r0, its columns at j0); one value
    per row of the n_blocks * 128 padded rows."""
    rows = torch.arange(W.n_blocks * LW, device=W.device).reshape(
        W.n_blocks, 1, LW) + r0
    on_diag = W.gcols() + j0 == rows
    return torch.sum(W.vals * on_diag, dim=1).reshape(-1)


class DiagonalPreconditioner:
    """M v = dinv * v, leafwise."""

    def __init__(self, dinv: torch.Tensor):
        self.dinv = dinv

    def __call__(self, v):
        return tree_map(lambda leaf: self.dinv * leaf, v)

    def to(self, target) -> "DiagonalPreconditioner":
        """Move to a device or cast to a dtype."""
        return DiagonalPreconditioner(self.dinv.to(target))

    def __repr__(self):
        return (f"DiagonalPreconditioner(n={self.dinv.shape[0]}, "
                f"dtype={self.dinv.dtype})")


def jacobi_preconditioner(A) -> DiagonalPreconditioner:
    """M ~ A^-1 as inverse-diagonal scaling (zero diagonal entries -> 1)."""
    d = diagonal(A)
    nz = d != 0
    dinv = torch.where(nz, 1.0 / torch.where(nz, d, torch.ones_like(d)),
                       torch.ones_like(d))
    return DiagonalPreconditioner(dinv)
