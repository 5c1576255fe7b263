"""Plain PyTorch reference for the HPCG cells: the DIA product, the
relative residual and CG, on the benchmark's own diagonals.

It imports torch alone: nothing of the program under test, no JAX. The
diagonals are the (ndiag, n) tensor the benchmark builds
(``core.stencil``); ``data[d, i]`` is ``A[i, i + offsets[d]]`` and entries
whose column falls outside the matrix are dropped. Every product runs
diagonal by diagonal, in blocks of rows, in the dtype asked for, so that
it fits beside the program's state and so that a lower dtype (the
control) computes every sum and product in that dtype.
"""

from __future__ import annotations

import torch

BLOCK_ROWS = 1 << 24


def matvec(data: torch.Tensor, offsets, x: torch.Tensor,
           dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """y = A x in ``dtype`` for x of shape (n,) or (n, k)."""
    n = data.shape[1]
    xd = x.to(dtype)
    y = torch.zeros(x.shape, dtype=dtype, device=x.device)
    for r0 in range(0, n, BLOCK_ROWS):
        r1 = min(n, r0 + BLOCK_ROWS)
        for d, o in enumerate(offsets):
            i0, i1 = max(r0, -o), min(r1, n - o)
            if i1 <= i0:
                continue
            a = data[d, i0:i1].to(dtype)
            if x.dim() == 2:
                a = a[:, None]
            y[i0:i1] += a * xd[i0 + o:i1 + o]
    return y


def rel_residuals(data: torch.Tensor, offsets, x: torch.Tensor,
                  b: torch.Tensor) -> list:
    """||b - A x|| / ||b|| in float64, one per column (one for a vector)."""
    r = b.to(torch.float64) - matvec(data, offsets, x, torch.float64)
    bn = torch.linalg.vector_norm(b.to(torch.float64), dim=0)
    rn = torch.linalg.vector_norm(r, dim=0)
    out = (rn / torch.where(bn > 0, bn, torch.ones_like(bn))).reshape(-1)
    return [float(v) for v in out.tolist()]


def cg(data: torch.Tensor, offsets, b: torch.Tensor, tol: float,
       maxiter: int, dtype: torch.dtype = torch.float64):
    """Unpreconditioned CG from x0 = 0 in ``dtype``, stopping at the first
    k with ||r_k|| <= tol ||b|| (the recurrence residual). Returns
    (x, iterations, converged)."""
    b = b.to(dtype)
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rr = torch.sum(r * r)
    thresh2 = float(tol) ** 2 * float(rr)
    for k in range(1, int(maxiter) + 1):
        Ap = matvec(data, offsets, p, dtype)
        alpha = rr / torch.sum(p * Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rr_new = torch.sum(r * r)
        if float(rr_new) <= thresh2:
            return x, k, True
        if not torch.isfinite(rr_new):
            return x, k, False
        p = r + (rr_new / rr) * p
        rr = rr_new
    return x, int(maxiter), False
