"""FSAI, the factorized sparse approximate inverse: the port of
``tpu_sparse/precond/fsai.py``.

For an SPD A, the set-up builds an explicit sparse lower-triangular
G ~ L^-1 (A ~ L L^T) on the lower pattern of A (``pattern_power=2``: of
A^2, "FSAI(2)"), so M = G^T G ~ A^-1 is SPD and every application is two
SpMVs (two SpMMs on a block), with no triangular solve. Row i solves the
k x k system A[P_i, P_i] g = e_k over its pattern P_i = {j <= i}, then
scales g by 1 / sqrt(g_k) so that diag(G A G^T) = 1. Rows are grouped by
pattern size and solved as one batched ``np.linalg.solve`` per group; the
A lookups vectorize through one ``searchsorted`` over (row, col) keys.

The set-up is host numpy, the same as JAX's; G and G^T land on A's device
through ``csr_from_arrays``, and ``fsai_preconditioner`` promotes them with
``to_gpu_operator`` (a stencil's G is DIA: kernel 1 / K3 on the card).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch

from tpu_sparse_torch.precond.amg import (_op_to, _operand_dtype_device,
                                          _product)
from tpu_sparse_torch.sparse.convert import (csr_from_arrays, numpy_dtype,
                                             to_scipy_csr)

__all__ = ["FSAIPreconditioner", "fsai_setup", "fsai_preconditioner"]


def _pattern_lower(S: sp.csr_matrix, pattern_power: int) -> sp.csr_matrix:
    """Lower-triangular (diagonal included) boolean pattern of S^p."""
    # int32 counts: int8 would wrap for rows sharing >= 128 neighbours
    base = (S != 0).astype(np.int32).tocsr()
    patt = base
    for _ in range(pattern_power - 1):
        patt = ((patt @ base) != 0).astype(np.int32).tocsr()
    n = S.shape[0]
    P = sp.tril(patt, 0) + sp.eye(n, dtype=np.int8, format="csr")
    P = (P != 0).astype(np.int8).tocsr()
    P.sort_indices()
    return P


def fsai_setup(A, *, pattern_power: int = 1,
               lookup_budget: int = 1 << 24) -> Tuple:
    """The FSAI factor G ~ L^-1 (lower triangular), computed on the host.
    Returns ``(G, Gt)`` as CSR containers on A's device, in A's dtype."""
    S = to_scipy_csr(A).astype(np.float64).tocsr()
    S.sort_indices()
    n = S.shape[0]
    P = _pattern_lower(S, pattern_power)
    indptr, indices = P.indptr, P.indices

    # composite-key table for vectorized A[p, q] lookups (missing -> 0)
    arows = np.repeat(np.arange(n, dtype=np.int64), np.diff(S.indptr))
    keys = arows * n + S.indices
    avals = S.data

    k_row = np.diff(indptr)
    Gdata = np.zeros(P.nnz)
    for k in np.unique(k_row):
        rows_k = np.flatnonzero(k_row == k).astype(np.int64)
        kk = int(k)
        nc_max = max(1, lookup_budget // max(kk * kk, 1))
        e = np.zeros((kk, 1))
        e[-1, 0] = 1.0
        for c0 in range(0, rows_k.size, nc_max):
            rk = rows_k[c0:c0 + nc_max]
            Pk = indices[indptr[rk][:, None] + np.arange(kk)]  # (nc, k)
            q = (Pk[:, :, None].astype(np.int64) * n
                 + Pk[:, None, :]).ravel()
            pos = np.searchsorted(keys, q)
            posc = np.minimum(pos, keys.size - 1)
            Bv = np.where(keys[posc] == q, avals[posc], 0.0)
            Bv = Bv.reshape(rk.size, kk, kk)
            try:
                g = np.linalg.solve(Bv, np.broadcast_to(
                    e, (rk.size, kk, 1)))[..., 0]
            except np.linalg.LinAlgError:
                # ridge-regularize numerically singular local systems
                tr = np.einsum("bii->b", Bv) / kk
                Bv = Bv + ((1e-10 * np.maximum(tr, 1.0))[:, None, None]
                           * np.eye(kk))
                g = np.linalg.solve(Bv, np.broadcast_to(
                    e, (rk.size, kk, 1)))[..., 0]
            d = g[:, -1]
            # g_k = (A[P,P]^-1)_kk > 0 for SPD input; an indefinite row
            # falls back to diagonal scaling
            bad = ~(d > 0)
            if bad.any():
                g[bad] = 0.0
                diag_a = Bv[bad, kk - 1, kk - 1]
                g[bad, -1] = 1.0 / np.sqrt(np.where(diag_a > 0, diag_a, 1.0))
                d = np.where(bad, 1.0, d)
            g = g / np.sqrt(d)[:, None]
            sl = (indptr[rk][:, None] + np.arange(kk)).ravel()
            Gdata[sl] = g.ravel()

    dtype, device = _operand_dtype_device(A)
    Gs = sp.csr_matrix((Gdata.astype(numpy_dtype(dtype)), indices.copy(),
                        indptr.copy()), shape=(n, n))
    Gs.eliminate_zeros()
    Gts = Gs.T.tocsr()
    Gts.sort_indices()
    G = csr_from_arrays(Gs.data, Gs.indices, Gs.indptr, (n, n),
                        device=device, dtype=dtype)
    Gt = csr_from_arrays(Gts.data, Gts.indices, Gts.indptr, (n, n),
                         device=device, dtype=dtype)
    return G, Gt


class FSAIPreconditioner:
    """M v = G^T (G v): two SpMVs, or two SpMMs on an (n, k) block."""

    def __init__(self, G, Gt):
        self.G = G
        self.Gt = Gt

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return _product(self.Gt, _product(self.G, v))

    matmat = __call__

    def to(self, target) -> "FSAIPreconditioner":
        return FSAIPreconditioner(_op_to(self.G, target),
                                  _op_to(self.Gt, target))


def fsai_preconditioner(A, *, pattern_power: int = 1,
                        optimize: bool = True) -> FSAIPreconditioner:
    """M = G^T G ~ A^-1 (SPD). ``optimize=True`` promotes G and G^T with
    ``to_gpu_operator``, so their products run the card's kernels."""
    G, Gt = fsai_setup(A, pattern_power=pattern_power)
    if optimize:
        from tpu_sparse_torch.sparse.optimize import to_gpu_operator

        G, Gt = to_gpu_operator(G), to_gpu_operator(Gt)
    return FSAIPreconditioner(G, Gt)
