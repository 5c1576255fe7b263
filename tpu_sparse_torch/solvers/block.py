"""Block CG: multi-RHS solves that share the Krylov space.

Counterpart of ``tpu_sparse/solvers/block.py`` (O'Leary's block CG with
its stabilisation): every iteration applies A once to an (n, k) direction
block (one ``spmm``: K6/K7 on a CWELL, K8 on a BELL on the card), the
per-column dot products become k x k Gram products, the direction block is
re-orthonormalised by modified Gram-Schmidt, the Galerkin step is
``alpha = (P^T A P)^-1 P^T R``, and the new directions are A-orthogonalised
against the previous block. Converged columns freeze through a zero
column and a unit pivot in the Gram systems, degenerate directions deflate
to zero columns, and the k x k systems are solved by the JAX package's
Gauss-Jordan without pivoting (``batched.gj_solve_batched``), so that the
port matches it in float64.

The JAX ``lax.while_loop`` becomes a loop that reads the host once per
``CHECK_EVERY`` iterations, the state frozen by an on-device ``active``
flag in between. The residual replacement every 32 iterations is decided
on the host loop count, which equals the iteration count while the loop
is active, so the extra SpMM runs only on those iterations.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from tpu_sparse_torch import tracing
from tpu_sparse_torch.kernels import as_matmat
from tpu_sparse_torch.solvers.batched import (cols_vdot_real,
                                              gj_solve_batched)
from tpu_sparse_torch.solvers.krylov import (CHECK_EVERY, _final_check_relax,
                                             _identity, _real_dtype)

REPLACE_EVERY = 32  # iterations between true-residual replacements


def _gj_matrix_solve(G: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """G Y = C (matrix right-hand side) by Gauss-Jordan."""
    return gj_solve_batched(G[None], C[None])[0]


def _mgs_block(P: torch.Tensor, allreduce: Optional[Callable] = None
               ) -> torch.Tensor:
    """Orthonormalise the k columns of P by modified Gram-Schmidt; a
    column that nearly vanishes after projection deflates to exact zero.
    ``allreduce`` sums each inner product over the ranks that hold rows
    of P (the distributed block CG)."""
    red = _identity if allreduce is None else allreduce
    k = P.shape[1]
    eps = torch.finfo(_real_dtype(P.dtype)).eps
    scale = torch.sqrt(red(torch.sum((P.conj() * P).real)))  # block norm
    rows = P.T.contiguous()  # column j of P as a contiguous row
    qs = []
    for j in range(k):
        v = rows[j]
        for q in qs:
            v = v - q * red(torch.vdot(q, v))
        nrm = torch.sqrt(red(torch.sum((v.conj() * v).real)))
        keep = nrm > 32 * eps * scale
        safe = torch.where(keep, nrm, torch.ones_like(nrm))
        qs.append(torch.where(keep, v / safe.to(P.dtype),
                              torch.zeros_like(v)))
    return torch.stack(qs, dim=1)


def block_cg(A, B: torch.Tensor, X0: Optional[torch.Tensor] = None, *,
             tol: float = 1e-5, atol: float = 0.0,
             maxiter: Optional[int] = None, M=None,
             allreduce: Optional[Callable] = None):
    """Stabilised block CG for SPD A with B of shape (n, k).

    Returns ``(X, infos, iterations, res_norms)``: infos and res_norms per
    column (k,), as ``batch_cg``; iterations the shared block count.
    ``allreduce`` sums the Gram products, column dots and norms over the
    ranks that hold rows of B (the distributed block CG, which passes
    ``maxiter``)."""
    if B.dim() != 2:
        raise ValueError("block_cg expects B of shape (n, k)")
    n, nrhs = B.shape
    if X0 is None:
        X0 = torch.zeros_like(B)
    if maxiter is None:
        maxiter = 10 * n
    A_mm, M_mm = as_matmat(A), as_matmat(M)
    dtype = B.dtype
    eye = torch.eye(nrhs, dtype=dtype, device=B.device)

    red = _identity if allreduce is None else allreduce

    def cols_dot(U, V):
        return red(cols_vdot_real(U, V))

    bs = cols_dot(B, B)
    atol_t = torch.as_tensor(atol, dtype=bs.dtype, device=bs.device)
    atol2 = torch.maximum((tol * tol) * bs, atol_t * atol_t)

    def gram(U, V):
        return red(U.conj().T @ V)

    def dead_fix(S):
        """Unit pivots for zero (inactive or deflated) direction columns."""
        d = torch.diagonal(S).real
        return S + eye * torch.where(d == 0, 1.0, 0.0).to(dtype)

    X = X0
    R = B - A_mm(X0)
    rs = cols_dot(R, R)
    P = _mgs_block(M_mm(R) * (rs > atol2).to(dtype)[None, :], allreduce)
    k = torch.zeros((), dtype=torch.int32, device=B.device)
    active = (k < maxiter) & torch.any(rs > atol2)
    it = 0  # host count of loop bodies: equals k while the loop is active
    # one host read per CHECK_EVERY iterations
    while bool(tracing.host_read(active)):
        for _ in range(CHECK_EVERY):
            act = (rs > atol2).to(dtype)
            Pm = P * act[None, :]
            Q = A_mm(Pm)
            S = dead_fix(gram(Pm, Q))
            # Galerkin step: masked columns get zero alpha columns, so
            # converged x_j / r_j freeze
            alpha = _gj_matrix_solve(S, gram(Pm, R * act[None, :]))
            X_new = X + Pm @ alpha
            if (it + 1) % REPLACE_EVERY == 0:
                # the recurrence residual drifts from the true one in low
                # precision; one extra A application pins them together
                R_new = B - A_mm(X_new)
            else:
                R_new = R - Q @ alpha
            rs_new = cols_dot(R_new, R_new)
            Z = M_mm(R_new) * (rs_new > atol2).to(dtype)[None, :]
            beta = _gj_matrix_solve(S, gram(Q, Z))
            P_new = _mgs_block(Z - Pm @ beta, allreduce)
            X = torch.where(active, X_new, X)
            R = torch.where(active, R_new, R)
            P = torch.where(active, P_new, P)
            rs = torch.where(active, rs_new, rs)
            k = k + active.to(torch.int32)
            active = (k < maxiter) & torch.any(rs > atol2)
            it += 1

    # per-column final check on recomputed residuals, relaxed for 32-bit
    # arithmetic as in cg_full
    E = B - A_mm(X)
    res = torch.sqrt(cols_dot(E, E))
    thresh = torch.maximum(tol * torch.sqrt(bs), atol_t) * _final_check_relax(
        _real_dtype(dtype))
    finite = torch.isfinite(res) & torch.all(torch.isfinite(X.real), dim=0)
    infos = torch.where(finite & (res <= thresh), 0, -1).to(torch.int32)
    return X, infos, k, res


__all__ = ["block_cg"]
