"""Single-reduction CG (Chronopoulos-Gear recurrence).

Counterpart of ``tpu_sparse/solvers/pipelined.py``. The three dot
products of an iteration (<r,u>, <w,u>, <r,r>) do not depend on each
other, so a distributed solve reduces them in one round:

    u = M r ;  w = A u
    gamma' = <r,u> ;  delta = <w,u>
    beta  = gamma'/gamma
    alpha = gamma' / (delta - beta*gamma'/alpha)
    p = u + beta p ;  s = w + beta s         (s tracks A p)
    x += alpha p ;  r -= alpha s

``alpha`` lives one state ahead of ``x``: each iteration applies the
previous alpha, so on exit x is the iterate whose residual passed the
stopping rule (maxiter=0 returns x0, as ``cg_full`` does). With ``M=None``
the monitored <r,r> is gamma. When rounding pushes the denominator
<p,Ap> to <= 0 near stagnation the iteration stalls with alpha = 0 and
the final true-residual check reports info -1.

The loop is ``krylov``'s: one host read of the loop condition every
``CHECK_EVERY`` iterations, the iterations in between masked by an
``active`` flag on the device.
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
from tpu_sparse_torch.utils.tree import (tree_axpy, tree_sub, tree_vdot_real,
                                         tree_where, tree_zeros_like)


def _positive_ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den where den > 0, else 0 (the stall of the recurrence)."""
    pos = den > 0
    return torch.where(pos, num / torch.where(pos, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def _cg_sr_loop(A: Callable, M: Callable, b, x0, atol2: torch.Tensor,
                maxiter: int, precond_is_identity: bool,
                vdot_real: Callable = tree_vdot_real,
                vdots_real: Optional[Callable] = None):
    """The Chronopoulos-Gear recurrence; batched like ``krylov._cg_loop``
    through its dot products (``solvers.batched.batch_cg_sr``).
    ``vdots_real`` takes the list of an iteration's (a, b) pairs and
    returns their dot products together: the distributed solver reduces
    them in one all-reduce (default: ``vdot_real`` of each pair)."""
    if vdots_real is None:
        def vdots_real(pairs):
            return [vdot_real(a, c) for a, c in pairs]

    def dots(r, u, w):
        """<r,u>, <w,u> and the monitored <r,r> (gamma without M)."""
        pairs = [(r, u), (w, u)] + ([] if precond_is_identity else [(r, r)])
        out = [d.to(rdtype) for d in vdots_real(pairs)]
        return out[0], out[1], out[0] if precond_is_identity else out[2]

    r = tree_sub(b, A(x0))
    u = M(r)
    w = A(u)
    dtype = _float_dtype(u)
    rdtype = _real_dtype(dtype)
    gamma, delta, rr = dots(r, u, w)
    # a zero or indefinite start (r0 = 0) gives alpha 0
    alpha = _positive_ratio(gamma, delta)
    x, p, s = x0, u, w
    k = torch.zeros((), dtype=torch.int32, device=gamma.device)

    def active_now():
        return (k < maxiter) & (rr > atol2)

    active = active_now()
    # one host read per CHECK_EVERY iterations
    while bool(tracing.host_read(active.any())):
        for _ in range(CHECK_EVERY):
            x_new = tree_axpy(alpha.to(dtype), p, x)
            r_new = tree_axpy(-alpha.to(dtype), s, r)
            u = M(r_new)
            w = A(u)
            gamma_new, delta, rr_new = dots(r_new, u, w)
            beta = gamma_new / gamma
            alpha_new = _positive_ratio(gamma_new,
                                        delta - beta * gamma_new / alpha)
            p_new = tree_axpy(beta.to(dtype), p, u)
            s_new = tree_axpy(beta.to(dtype), s, w)
            x = tree_where(active, x_new, x)
            r = tree_where(active, r_new, r)
            p = tree_where(active, p_new, p)
            s = tree_where(active, s_new, s)
            gamma = torch.where(active, gamma_new, gamma)
            alpha = torch.where(active, alpha_new, alpha)
            rr = torch.where(active, rr_new, rr)
            k = k + active.to(torch.int32)
            active = active_now()
    return x, k


def cg_sr_full(A: Operator, b: Any, x0: Optional[Any] = None, *,
               tol: float = 1e-5, atol: float = 0.0,
               maxiter: Optional[int] = None, M: Optional[Operator] = None):
    """Single-reduction CG returning (x, info, iterations, residual), with
    ``cg_full``'s tolerance and info contract."""
    if x0 is None:
        x0 = tree_zeros_like(b)
    _check_tree_compat(x0, b)
    maxiter = _default_maxiter(b, maxiter)
    A_fn = as_matvec(A)
    M_fn = _identity if M is None else as_matvec(M)
    bs, atol_t, atol2 = _thresholds(b, tol, atol)
    x, k = _cg_sr_loop(A_fn, M_fn, b, x0, atol2, maxiter, M is None)
    info, res_norm = _final_check(A_fn, b, x, bs, atol_t, tol)
    return x, info, k, res_norm


def cg_sr(A: Operator, b: Any, x0: Optional[Any] = None, *,
          tol: float = 1e-5, atol: float = 0.0,
          maxiter: Optional[int] = None, M: Optional[Operator] = None):
    """Single-reduction CG; returns ``(x, info)`` like ``cg``."""
    x, info, _, _ = cg_sr_full(A, b, x0, tol=tol, atol=atol,
                               maxiter=maxiter, M=M)
    return x, info
