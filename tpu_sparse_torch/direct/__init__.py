"""Direct sparse solvers with the adjoint gradient (Module C, the cuDSS
backend of the reference): the port of ``tpu_sparse/direct``.

``direct_solve`` dispatches on the operand:

* DIA with bandwidth <= max(1, n // 4): ``banded_solve``. On the card,
  parallel cyclic reduction for a tridiagonal system with n >= 64 and
  block PCR for a wider band with n >= 512; otherwise, and on the CPU, the
  Thomas algorithm and the banded LU, whose n-step loops run on the host.
* a general sparse matrix with n > 4096 (``needs_host_splu``): scipy
  SuperLU on the host in float64, cast back (``host_splu_solve``). The
  router factors such a system once and solves it on the card by the
  supernodal LU (``direct/supernodal.py``), or on the CPU by the cached
  host factors.
* anything else: ``dense_solve``.

Every solver takes b of shape (n,) or (n, k). ``direct_solve_diff`` /
``direct_solve_full_diff`` differentiate with the same one-adjoint-solve
contract as the Krylov solvers (cudss_solver.py:78-173): the backward
solves A^T v = x_bar, b_bar = v, A_bar = -v x^T on A's pattern; the
solver is registered with ``autodiff.implicit`` as ``"direct"``.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_sparse_torch.autodiff import implicit as _implicit
from tpu_sparse_torch.direct.banded import (banded_lu_factor,
                                            banded_lu_solve, block_pcr_solve,
                                            dense_solve, pcr_solve,
                                            thomas_solve)
from tpu_sparse_torch.direct.sparse_lu import (SparseLU, sparse_lu_solve,
                                               sparse_lu_solve_diff)
from tpu_sparse_torch.direct.supernodal import (SupernodalLU, _apply,
                                                factored_solve,
                                                supernodal_solve,
                                                supernodal_solve_diff)
from tpu_sparse_torch.sparse.containers import DIA, is_sparse


def banded_solve(A: DIA, b: torch.Tensor) -> torch.Tensor:
    """Banded direct solve. Tridiagonal: PCR on the card for n >= 64,
    else the Thomas algorithm. Wider bands: block PCR on the card for
    n >= 512, else the banded LU."""
    on_card = A.data.is_cuda
    if A.bandwidth <= 1:
        if on_card and A.shape[0] >= 64:
            return pcr_solve(A, b)
        return thomas_solve(A, b)
    if on_card and A.shape[0] >= 512:
        return block_pcr_solve(A, b)
    return banded_lu_solve(A, b)


# Above this size, densifying a general sparse matrix is wasteful: the
# solve goes to a sparse LU instead.
_DENSE_DIRECT_LIMIT = 4096


def needs_host_splu(A) -> bool:
    """True when ``direct_solve`` routes A to the sparse LU (a general
    sparse matrix beyond the densify limit)."""
    if not is_sparse(A):
        return False
    if isinstance(A, DIA) and A.bandwidth <= max(1, A.shape[0] // 4):
        return False
    return A.shape[0] > _DENSE_DIRECT_LIMIT


class HostLU:
    """scipy SuperLU factors of A on the host, in float64 (complex128 for
    complex values), behind the ``solve`` / ``solve_transpose`` interface
    of the device factors: each solve moves b to the host and casts the
    result back to b's dtype and device."""

    def __init__(self, A):
        import scipy.sparse.linalg as spl

        from tpu_sparse_torch.sparse.convert import to_scipy_csr

        S = to_scipy_csr(A)
        self.work = np.complex128 if np.iscomplexobj(S.data) else np.float64
        self.lu = spl.splu(S.astype(self.work).tocsc())

    def _solve(self, b: torch.Tensor, trans: str) -> torch.Tensor:
        bb = b.detach().cpu()
        if bb.dtype == torch.bfloat16:  # numpy has no bf16: float32, exact
            bb = bb.float()
        out = self.lu.solve(bb.numpy().astype(self.work), trans=trans)
        return torch.from_numpy(out).to(b.device, b.dtype)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        return self._solve(b, "N")

    def solve_transpose(self, b: torch.Tensor) -> torch.Tensor:
        return self._solve(b, "T")


def host_splu_solve(A, b: torch.Tensor) -> torch.Tensor:
    """General sparse LU on the host (scipy SuperLU in float64, cast back
    to b's dtype and device): one factorization per call."""
    return HostLU(A).solve(b)


def direct_residual_info(A, b: torch.Tensor, x: torch.Tensor):
    """(info, res, rel) of a direct solve: ``res`` the residual norm (per
    column for an (n, k) b) and ``rel`` the largest relative residual;
    info 0 when every column meets 1e-8 relative (float64) or 1e-4
    (float32) and is finite, else -1."""
    with torch.no_grad():
        r = b - _apply(A, x)
        res = torch.linalg.vector_norm(r, dim=0)
        bn = torch.linalg.vector_norm(b, dim=0)
        fi = torch.finfo(b.dtype)
        rel_tol = 1e-8 if fi.bits >= 64 else 1e-4
        ok = torch.isfinite(res) & (res <= torch.clamp_min(rel_tol * bn,
                                                           fi.tiny))
        info = torch.where(torch.all(ok), 0, -1).to(torch.int32)
        rel = torch.max(res / torch.where(bn > 0, bn, torch.ones_like(bn)))
    return info, res, rel


def direct_solve(A, b: torch.Tensor) -> torch.Tensor:
    """Direct solve without the adjoint wiring (see the module
    docstring)."""
    if isinstance(A, DIA) and A.bandwidth <= max(1, A.shape[0] // 4):
        return banded_solve(A, b)
    if needs_host_splu(A):
        return host_splu_solve(A, b)
    if is_sparse(A) or isinstance(A, torch.Tensor):
        return dense_solve(A, b)
    raise TypeError(
        "direct solver requires a matrix operand (sparse container or "
        "dense tensor), not a matrix-free callable")


def _direct_full(A, b, x0=None, M=None, **_ignored):
    """Solver-registry adapter with the Krylov solvers' (x, info, iters,
    res) signature, so that ``autodiff.implicit`` wraps it."""
    x = direct_solve(A, b)
    info, res, _ = direct_residual_info(A, b, x)
    return x, info, torch.zeros((), dtype=torch.int32, device=b.device), res


_implicit._SOLVERS["direct"] = _direct_full
_implicit._SYMMETRIC["direct"] = False


def direct_solve_diff(A, b: torch.Tensor) -> torch.Tensor:
    """Differentiable direct solve; returns x only."""
    return direct_solve_full_diff(A, b)[0]


def direct_solve_full_diff(A, b: torch.Tensor):
    """Differentiable direct solve returning (x, info, iters, res)."""
    return _implicit._dispatch("direct", A, b, None, None, {})


__all__ = [
    "banded_solve", "direct_solve", "direct_solve_diff",
    "direct_solve_full_diff", "thomas_solve", "banded_lu_solve",
    "banded_lu_factor", "dense_solve", "host_splu_solve", "HostLU",
    "needs_host_splu", "direct_residual_info", "pcr_solve",
    "block_pcr_solve", "SparseLU", "sparse_lu_solve",
    "sparse_lu_solve_diff", "SupernodalLU", "supernodal_solve",
    "supernodal_solve_diff", "factored_solve",
]
