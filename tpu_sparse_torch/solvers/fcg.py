"""Flexible conjugate gradients (FCG).

Counterpart of ``tpu_sparse/solvers/fcg.py``. Standard CG needs a fixed
symmetric preconditioner; a nonsymmetric or iteration-varying M (the
AMG V(0,3) cycle, an inner iterative solve) breaks its recurrence. FCG
(Notay's variant) takes the Polak-Ribiere beta

    beta = <z_new, r_new - r> / <r, z>

which re-orthogonalizes against the previous direction and tolerates a
variable M at the cost of one more dot product per iteration. The loop
stops on the unpreconditioned <r, r>, as ``cg_full`` does, and reads the
host once every ``CHECK_EVERY`` iterations.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from tpu_sparse_torch import tracing
from tpu_sparse_torch.kernels import as_matvec
from tpu_sparse_torch.solvers.krylov import (CHECK_EVERY, Operator,
                                             _check_tree_compat,
                                             _default_maxiter,
                                             _final_check, _float_dtype,
                                             _identity, _thresholds)
from tpu_sparse_torch.utils.tree import (tree_axpy, tree_sub, tree_vdot_real,
                                         tree_where, tree_zeros_like)


def _fcg_loop(A: Callable, M: Callable, b, x0, atol2: torch.Tensor,
              maxiter: int, vdot_real: Callable = tree_vdot_real):
    """The FCG recurrence; batched like ``krylov._cg_loop`` through its dot
    products (``solvers.batched.batch_fcg``)."""
    dtype = _float_dtype(b)
    r = tree_sub(b, A(x0))
    z = M(r)
    p = z
    rz = vdot_real(r, z)
    x = x0
    k = torch.zeros((), dtype=torch.int32, device=rz.device)

    def active_now():
        return (k < maxiter) & (vdot_real(r, r) > atol2)

    active = active_now()
    # one host read per CHECK_EVERY iterations
    while bool(tracing.host_read(active.any())):
        for _ in range(CHECK_EVERY):
            q = A(p)
            alpha = (rz / vdot_real(p, q)).to(dtype)
            x_new = tree_axpy(alpha, p, x)
            r_new = tree_axpy(-alpha, q, r)
            z_new = M(r_new)
            rz_new = vdot_real(r_new, z_new)
            beta = ((rz_new - vdot_real(r, z_new)) / rz).to(dtype)
            p_new = tree_axpy(beta, p, z_new)
            x = tree_where(active, x_new, x)
            r = tree_where(active, r_new, r)
            p = tree_where(active, p_new, p)
            rz = torch.where(active, rz_new, rz)
            k = k + active.to(torch.int32)
            active = active_now()
    return x, k


def fcg_full(A: Operator, b: Any, x0: Optional[Any] = None, *,
             tol: float = 1e-5, atol: float = 0.0,
             maxiter: Optional[int] = None, M: Optional[Operator] = None):
    """Flexible CG returning (x, info, iterations, residual_norm)."""
    if x0 is None:
        x0 = tree_zeros_like(b)
    _check_tree_compat(x0, b)
    maxiter = _default_maxiter(b, maxiter)
    A_fn = as_matvec(A)
    M_fn = _identity if M is None else as_matvec(M)
    bs, atol_t, atol2 = _thresholds(b, tol, atol)
    x, k = _fcg_loop(A_fn, M_fn, b, x0, atol2, maxiter)
    info, res_norm = _final_check(A_fn, b, x, bs, atol_t, tol)
    return x, info, k, res_norm


def fcg(A: Operator, b: Any, x0: Optional[Any] = None, *, tol: float = 1e-5,
        atol: float = 0.0, maxiter: Optional[int] = None,
        M: Optional[Operator] = None):
    """Flexible CG; returns (x, info)."""
    x, info, _, _ = fcg_full(A, b, x0, tol=tol, atol=atol, maxiter=maxiter,
                             M=M)
    return x, info
