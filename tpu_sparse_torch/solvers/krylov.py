"""Krylov solvers: CG.

Counterpart of ``tpu_sparse/solvers/krylov.py`` (reference
module_a/torch_sparse_linalg.py: ``cg`` :1019-1088, ``_cg_solve``
:806-856). BiCGStab and GMRES follow in a later slice.

Tolerance contract (reference / non-legacy scipy): converged iff
``norm(residual) <= max(tol * norm(b), atol)``. ``info``: 0 converged,
-1 not converged / non-finite.

The JAX loop is one ``lax.while_loop``. Here the loop runs eagerly without
reading the device every iteration: it checks convergence once every
``CHECK_EVERY`` iterations, and between checks each iteration is masked by
an on-device ``active`` flag (the loop condition ``k < maxiter and
rs > atol2``), so the state freezes exactly at the iteration where the
per-iteration loop would have stopped and ``k`` counts the same iterations.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Union

import torch

from tpu_sparse_torch.kernels import as_matvec
from tpu_sparse_torch.utils.tree import (
    tree_axpy,
    tree_leaves,
    tree_norm,
    tree_size,
    tree_sub,
    tree_vdot_real,
    tree_where,
    tree_zeros_like,
)

Operator = Union[Any, Callable]

CHECK_EVERY = 16  # iterations between host reads of the loop condition


def _identity(x):
    return x


def _float_dtype(tree) -> torch.dtype:
    return tree_leaves(tree)[0].dtype


def _real_dtype(dtype: torch.dtype) -> torch.dtype:
    return dtype.to_real() if dtype.is_complex else dtype


def _default_maxiter(b, maxiter: Optional[int]) -> int:
    if maxiter is not None:
        return int(maxiter)
    return 10 * tree_size(b)  # same default as reference/scipy (:982-984)


def _check_tree_compat(x0, b):
    lx, lb = tree_leaves(x0), tree_leaves(b)
    if len(lx) != len(lb):
        raise ValueError("x0 and b must have matching tree structure")
    for a, c in zip(lx, lb):
        if a.shape != c.shape:
            raise ValueError(f"arrays in x0 and b must have matching shapes: "
                             f"{tuple(a.shape)} vs {tuple(c.shape)}")


def _final_check_relax(dtype: torch.dtype) -> float:
    """Residual-recheck relaxation: the loop stops on the recurrence
    residual, and in 32-bit arithmetic the recomputed true residual drifts
    slightly above it. The reference relaxes its final check 10x for this
    (torch_sparse_linalg.py:765-771); 64-bit stays strict."""
    return 10.0 if torch.finfo(dtype).bits <= 32 else 1.0


def _cg_loop(A: Callable, M: Callable, b, x0, atol2: torch.Tensor,
             maxiter: int, precond_is_identity: bool):
    r = tree_sub(b, A(x0))
    z = M(r)
    p = z
    dtype = _float_dtype(p)
    gamma = tree_vdot_real(r, z).to(_real_dtype(dtype))
    x = x0
    k = torch.zeros((), dtype=torch.int32, device=gamma.device)

    def active_now():
        rs = gamma if precond_is_identity else tree_vdot_real(r, r)
        return (k < maxiter) & (rs > atol2)

    active = active_now()
    while bool(active):  # one host read per CHECK_EVERY iterations
        for _ in range(CHECK_EVERY):
            Ap = A(p)
            alpha = (gamma / tree_vdot_real(p, Ap)).to(dtype)
            x_new = tree_axpy(alpha, p, x)
            r_new = tree_axpy(-alpha, Ap, r)
            z = M(r_new)
            gamma_new = tree_vdot_real(r_new, z).to(_real_dtype(dtype))
            beta = (gamma_new / gamma).to(dtype)
            p_new = tree_axpy(beta, p, z)
            x = tree_where(active, x_new, x)
            r = tree_where(active, r_new, r)
            p = tree_where(active, p_new, p)
            gamma = torch.where(active, gamma_new, gamma)
            k = k + active.to(torch.int32)
            active = active_now()
    return x, k


def cg(A: Operator, b: Any, x0: Optional[Any] = None, *, tol: float = 1e-5,
       atol: float = 0.0, maxiter: Optional[int] = None,
       M: Optional[Operator] = None):
    """Conjugate-gradient solve of Ax = b (A hermitian positive definite).

    Returns ``(x, info)`` with info 0 on convergence, -1 otherwise
    (reference ``cg``, torch_sparse_linalg.py:1019-1088)."""
    x, info, _, _ = cg_full(A, b, x0, tol=tol, atol=atol, maxiter=maxiter,
                            M=M)
    return x, info


def cg_full(A: Operator, b: Any, x0: Optional[Any] = None, *,
            tol: float = 1e-5, atol=0.0, maxiter: Optional[int] = None,
            M: Optional[Operator] = None):
    """CG returning (x, info, iterations, final_residual_norm)."""
    if x0 is None:
        x0 = tree_zeros_like(b)
    _check_tree_compat(x0, b)
    maxiter = _default_maxiter(b, maxiter)
    A_fn = as_matvec(A)
    precond_identity = M is None
    M_fn = _identity if M is None else as_matvec(M)

    bs = tree_vdot_real(b, b)
    atol_t = torch.as_tensor(atol, dtype=bs.dtype, device=bs.device)
    atol2 = torch.maximum((tol * tol) * bs, atol_t * atol_t)

    x, k = _cg_loop(A_fn, M_fn, b, x0, atol2, maxiter, precond_identity)

    # Unpreconditioned residual: the loop's stopping rule uses <r, r>
    # without M, and a strong M can inflate ||M r|| and flag a false pass.
    res_norm = tree_norm(tree_sub(b, A_fn(x)))
    b_norm = torch.sqrt(bs)
    thresh = torch.maximum(tol * b_norm, atol_t) * _final_check_relax(
        _real_dtype(_float_dtype(b)))
    failed = (~torch.isfinite(tree_norm(x))) | (~torch.isfinite(res_norm)) \
        | (res_norm > thresh)
    info = torch.where(failed, -1, 0).to(torch.int32)
    return x, info, k, res_norm
