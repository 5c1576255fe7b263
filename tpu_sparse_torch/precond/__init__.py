"""Preconditioners (Jacobi in this slice)."""

from tpu_sparse_torch.precond.jacobi import (DiagonalPreconditioner, diagonal,
                                             jacobi_preconditioner)

__all__ = ["DiagonalPreconditioner", "diagonal", "jacobi_preconditioner"]
