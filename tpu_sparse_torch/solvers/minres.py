"""MINRES: minimum-residual solves of symmetric, possibly indefinite,
systems.

Counterpart of ``tpu_sparse/solvers/minres.py``: the Paige-Saunders
recurrence (three-term Lanczos and Givens QR of its tridiagonal, as in
``scipy.sparse.linalg.minres``), one matvec per iteration and a handful
of vectors, for shifted Laplacians, saddle-point and Helmholtz-type
systems that CG cannot take. M must be symmetric positive definite (it
defines the Lanczos inner product). The loop stops on the M-norm
residual estimate ``phibar``; the final check recomputes the true
unpreconditioned residual (``krylov._final_check``). Where the estimate
passed and the true residual did not (a preconditioner changes the norm:
with Jacobi on a Poisson system the loop stops with the true residual
1.3x above tol ||b||), ``minres_full`` restarts from x and asks the
estimate for the reduction the true residual still needs, while
iterations remain and each restart lowers the true residual. The JAX
package stops there with info -1 (its fault R10); the batched and the
distributed MINRES keep its single pass.

The loop reads the host once every ``CHECK_EVERY`` iterations; the
iterations in between are masked by an ``active`` flag on the device, so
x and the iteration count are those of the JAX ``lax.while_loop``.
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
                                             _identity, _real_dtype,
                                             _thresholds)
from tpu_sparse_torch.utils.tree import (tree_axpy, tree_scalar_mul,
                                         tree_sub, tree_vdot_real,
                                         tree_where, tree_zeros_like)


def _minres_loop(A: Callable, M: Callable, b, x0, atol_norm: torch.Tensor,
                 maxiter: int, vdot_real: Callable = tree_vdot_real,
                 rel_goal: Optional[torch.Tensor] = None):
    """The MINRES recurrence; batched like ``krylov._cg_loop`` through its
    dot products (``solvers.batched.batch_minres``). It stops when
    ``phibar`` reaches ``atol_norm``, or with ``rel_goal`` when it reaches
    ``rel_goal`` times its starting value."""
    dtype = _float_dtype(b)
    rdtype = _real_dtype(dtype)
    tiny = torch.finfo(rdtype).tiny * 16

    def safe(v):
        return torch.where(v.abs() > tiny, v, torch.ones_like(v))

    r1 = tree_sub(b, A(x0))
    y = M(r1)
    beta = torch.sqrt(torch.clamp_min(vdot_real(r1, y), 0)).to(rdtype)
    if rel_goal is not None:
        atol_norm = rel_goal * beta
    zero = torch.zeros_like(beta)
    x, r2, w, w2 = x0, r1, tree_zeros_like(b), tree_zeros_like(b)
    oldb, dbar, epsln, phibar = zero, zero, zero, beta
    cs, sn = -torch.ones_like(beta), zero
    k = torch.zeros((), dtype=torch.int32, device=beta.device)

    def active_now():
        return (k < maxiter) & (phibar > atol_norm) & (beta > tiny)

    active = active_now()
    # one host read per CHECK_EVERY iterations
    while bool(tracing.host_read(active.any())):
        for _ in range(CHECK_EVERY):
            v = tree_scalar_mul((1.0 / safe(beta)).to(dtype), y)
            y_new = A(v)
            # three-term Lanczos: the (beta / oldb) r1 term from the second
            # iteration on (oldb == 0 in the first)
            coef1 = torch.where(k > 0, beta / safe(oldb),
                                torch.zeros_like(beta)).to(dtype)
            y_new = tree_axpy(-coef1, r1, y_new)
            alfa = vdot_real(v, y_new).to(rdtype)
            y_new = tree_axpy(-(alfa / safe(beta)).to(dtype), r2, y_new)
            r1_new, r2_new = r2, y_new
            y_new = M(r2_new)
            beta_new = torch.sqrt(torch.clamp_min(
                vdot_real(r2_new, y_new), 0)).to(rdtype)

            # Givens QR update of the Lanczos tridiagonal
            delta = cs * dbar + sn * alfa
            gbar = sn * dbar - cs * alfa
            epsln_new = sn * beta_new
            dbar_new = -cs * beta_new
            gamma = torch.clamp_min(
                torch.sqrt(gbar * gbar + beta_new * beta_new), tiny)
            cs_new = gbar / gamma
            sn_new = beta_new / gamma
            phi = cs_new * phibar
            phibar_new = sn_new * phibar

            w_new = tree_scalar_mul(
                (1.0 / gamma).to(dtype),
                tree_axpy(-delta.to(dtype), w,
                          tree_axpy(-epsln.to(dtype), w2, v)))
            x_new = tree_axpy(phi.to(dtype), w_new, x)

            x = tree_where(active, x_new, x)
            r1 = tree_where(active, r1_new, r1)
            r2 = tree_where(active, r2_new, r2)
            y = tree_where(active, y_new, y)
            w2 = tree_where(active, w, w2)
            w = tree_where(active, w_new, w)
            oldb = torch.where(active, beta, oldb)
            beta = torch.where(active, beta_new, beta)
            dbar = torch.where(active, dbar_new, dbar)
            epsln = torch.where(active, epsln_new, epsln)
            phibar = torch.where(active, phibar_new, phibar)
            cs = torch.where(active, cs_new, cs)
            sn = torch.where(active, sn_new, sn)
            k = k + active.to(torch.int32)
            active = active_now()
    return x, k


def minres_full(A: Operator, b: Any, x0: Optional[Any] = None, *,
                tol: float = 1e-5, atol: float = 0.0,
                maxiter: Optional[int] = None, M: Optional[Operator] = None):
    """MINRES returning (x, info, iterations, final_residual_norm),
    restarted from x while the true residual fails the check the
    estimate passed (module docstring)."""
    if x0 is None:
        x0 = tree_zeros_like(b)
    _check_tree_compat(x0, b)
    maxiter = _default_maxiter(b, maxiter)
    A_fn = as_matvec(A)
    M_fn = _identity if M is None else as_matvec(M)
    bs, atol_t, _ = _thresholds(b, tol, atol)
    atol_norm = torch.maximum(tol * torch.sqrt(bs), atol_t)
    x, k = _minres_loop(A_fn, M_fn, b, x0, atol_norm, maxiter)
    info, res_norm = _final_check(A_fn, b, x, bs, atol_t, tol)
    while bool(tracing.host_read(
            (info != 0) & (k < maxiter) & torch.isfinite(res_norm))):
        # the true residual must still fall by atol_norm / res_norm: ask
        # the same of the estimate, which restarts at the M-norm of r
        x_new, k_new = _minres_loop(A_fn, M_fn, b, x, atol_norm,
                                    maxiter - int(tracing.host_read(k)),
                                    rel_goal=atol_norm / res_norm)
        k = k + k_new
        info_new, res_new = _final_check(A_fn, b, x_new, bs, atol_t, tol)
        if not bool(tracing.host_read(res_new < res_norm)):
            break  # no progress: keep the better x
        x, info, res_norm = x_new, info_new, res_new
    return x, info, k, res_norm


def minres(A: Operator, b: Any, x0: Optional[Any] = None, *,
           tol: float = 1e-5, atol: float = 0.0,
           maxiter: Optional[int] = None, M: Optional[Operator] = None):
    """MINRES solve of symmetric (possibly indefinite) Ax = b; returns
    ``(x, info)`` with info 0 on convergence, -1 otherwise."""
    x, info, _, _ = minres_full(A, b, x0, tol=tol, atol=atol,
                                maxiter=maxiter, M=M)
    return x, info
