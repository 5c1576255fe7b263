"""Flexible GMRES (FGMRES): right-preconditioned GMRES with a stored
preconditioned basis, for nonsymmetric or iteration-varying M.

Counterpart of ``tpu_sparse/solvers/fgmres.py`` (Saad 1993). GMRES as the
reference writes it preconditions on the left, needs a fixed M and
converges on the M-residual; FGMRES applies M on the right (w = A M v_k),
keeps the vectors z_k = M v_k in a second basis Z and updates x from Z,
so M may change every step (an AMG V(0,3) cycle, an inner solve) and the
Givens recurrence tracks the true residual.

A restart cycle is ``krylov._gmres_incremental`` with ``flexible=True``:
the early exit ``err <= tol`` and a breakdown mask the later Arnoldi
steps on the device, and a host read every ``krylov.EXIT_CHECK`` steps
ends the cycle once every later step would be masked. The restart loop,
``krylov._gmres_restarts``, is GMRES's, monitoring the true residual and
reading the host once per cycle.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Optional

from tpu_sparse_torch.solvers.krylov import (Operator, _gmres_incremental,
                                             _gmres_restarts)


def fgmres_full(A: Operator, b: Any, x0: Optional[Any] = None, *,
                tol: float = 1e-5, atol: float = 0.0, restart: int = 20,
                maxiter: Optional[int] = None, M: Optional[Operator] = None):
    """FGMRES returning (x, info, restart_cycles, residual_norm); the
    residual is the true one."""
    return _gmres_restarts(A, b, x0, tol, atol, restart, maxiter, M,
                           partial(_gmres_incremental, flexible=True),
                           left=False)


def fgmres(A: Operator, b: Any, x0: Optional[Any] = None, *,
           tol: float = 1e-5, atol: float = 0.0, restart: int = 20,
           maxiter: Optional[int] = None, M: Optional[Operator] = None):
    """Flexible GMRES; returns (x, info)."""
    x, info, _, _ = fgmres_full(A, b, x0, tol=tol, atol=atol,
                                restart=restart, maxiter=maxiter, M=M)
    return x, info
