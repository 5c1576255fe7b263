"""General sparse LU in block form: the port of
``tpu_sparse/direct/sparse_lu.py``.

* **factor (host, once per matrix).** scipy SuperLU (COLAMD) factors
  ``Pr A Pc = L U`` in float64. Each factor splits into dense (B, 256, 256)
  diagonal blocks (identity-padded) and its strictly block-triangular
  rest N, packed as a CWELL on A's device by ``csr_to_cwell`` (the TPU's
  format choice and CSR fallback are gone: every pack runs K4 / K5).
* **solve.** A block sweep: ``y <- D^-1 (c - N y)`` with D^-1 one batched
  ``torch.linalg.solve_triangular`` of the diagonal blocks and N y one
  ``kernels.spmv`` (K4 / K5 on the card; one ``spmm``, K6/K7, for an
  (n, k) right-hand side). It is exact after ``depth`` sweeps, the longest
  chain of the block dependency DAG: a block at level k is exact after k
  sweeps and is recomputed, not accumulated, by every sweep.

``sparse_lu_solve_diff`` differentiates in b by one transpose solve on the
same factors; the router's ``factored_solve`` adds A's values. The
diagonal blocks cost 2 n s values (s = 256), so this suits n up to ~10^5;
``direct/supernodal.py`` is the at-scale general direct path.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tpu_sparse_torch.direct.banded import full_fp32_matmul
from tpu_sparse_torch.direct.supernodal import _apply, factored_solve
from tpu_sparse_torch.sparse.containers import CSR
from tpu_sparse_torch.sparse.cwell import csr_to_cwell

_BLOCK = 256


def _block_levels(bi, bj, B: int) -> int:
    """Longest chain in the block dependency DAG (edges bj -> bi, bj !=
    bi), visiting blocks in substitution order. bi / bj are the block
    coordinates of every off-diagonal entry (lower: bj < bi; upper: bj >
    bi after the caller flips the order)."""
    level = np.zeros(B, dtype=np.int64)
    order = np.argsort(bi, kind="stable")
    bi, bj = bi[order], bj[order]
    starts = np.searchsorted(bi, np.arange(B))
    ends = np.searchsorted(bi, np.arange(B) + 1)
    for i in range(B):
        js = bj[starts[i]:ends[i]]
        if len(js):
            level[i] = 1 + level[js].max()
    return int(level.max()) + 1 if B else 1


def _pack_factor(T_scipy, n_pad: int, s: int, lower: bool):
    """A scipy triangular factor as float64 (B, s, s) diagonal blocks
    (identity-padded), its strictly block-off part as scipy CSR
    (n_pad x n_pad), and its block depth."""
    import scipy.sparse as sp

    B = n_pad // s
    T = sp.coo_matrix(T_scipy)
    r, c, v = T.row, T.col, T.data
    same = (r // s) == (c // s)
    diag = np.zeros((B, s, s), dtype=np.float64)
    rd, cd, vd = r[same], c[same], v[same]
    diag[rd // s, rd % s, cd % s] = vd
    pad_ids = np.arange(T.shape[0], n_pad)
    diag[pad_ids // s, pad_ids % s, pad_ids % s] = 1.0
    ro, co, vo = r[~same], c[~same], v[~same]
    if lower:
        order = ro // s, co // s
    else:  # upper-factor blocks are visited last to first
        order = (B - 1) - ro // s, (B - 1) - co // s
    depth = _block_levels(order[0], order[1], B)
    off = sp.csr_matrix((vo, (ro, co)), shape=(n_pad, n_pad))
    return diag, off, depth


def _to_device_operator(off_scipy, dtype: torch.dtype, device):
    """The off-diagonal factor part as a CWELL on ``device``."""
    off = off_scipy.tocsr()
    off.sort_indices()
    return csr_to_cwell(CSR(
        torch.from_numpy(off.data).to(device, dtype),
        torch.from_numpy(off.indices.astype(np.int32)).to(device),
        torch.from_numpy(off.indptr.astype(np.int32)).to(device),
        off.shape))


class SparseLU:
    """SuperLU factors in block form on a device, with sweep solves (see
    the module docstring). Build with :meth:`factor`."""

    def __init__(self, Ldiag, Udiag, Nl, Nu, NlT, NuT, perm_r, perm_c,
                 depth_l: int, depth_u: int, shape: Tuple[int, int],
                 block: int = _BLOCK):
        self.Ldiag = Ldiag      # (B, s, s) unit-lower diagonal blocks
        self.Udiag = Udiag      # (B, s, s) upper diagonal blocks
        self.Nl = Nl            # strictly block-lower part of L (CWELL)
        self.Nu = Nu            # strictly block-upper part of U (CWELL)
        self.NlT = NlT          # their transposes, packed for the
        self.NuT = NuT          # adjoint solves
        self.perm_r = perm_r
        self.perm_c = perm_c
        self.depth_l = int(depth_l)   # block depths
        self.depth_u = int(depth_u)
        self.shape = tuple(int(x) for x in shape)
        self.block = int(block)

    @property
    def n_pad(self) -> int:
        return self.Ldiag.shape[0] * self.Ldiag.shape[1]

    @staticmethod
    def factor(A, block: int = _BLOCK) -> "SparseLU":
        """Factor a square sparse matrix on the host; the factors live on
        A's device. scipy computes ``Pr A Pc = L U`` ((Pr b)[perm_r] = b,
        (Pc z)[i] = z[perm_c[i]]); the solve applies x = Pc U^-1 L^-1 Pr b.
        Raises scipy's RuntimeError for a singular matrix."""
        import scipy.sparse.linalg as spl

        from tpu_sparse_torch.sparse.convert import to_scipy_csr

        n, m = A.shape
        if n != m:
            raise ValueError("SparseLU requires a square system")
        device = A.device
        dtype = A.dtype if A.dtype.is_floating_point else torch.float64
        lu = spl.splu(to_scipy_csr(A).astype(np.float64).tocsc())
        s = block
        n_pad = ((n + s - 1) // s) * s
        Ldiag, Nl, depth_l = _pack_factor(lu.L, n_pad, s, True)
        Udiag, Nu, depth_u = _pack_factor(lu.U, n_pad, s, False)

        def dev(a):
            return torch.from_numpy(a).to(device, dtype)

        def op(off):
            return _to_device_operator(off, dtype, device)

        return SparseLU(
            dev(Ldiag), dev(Udiag), op(Nl), op(Nu), op(Nl.T), op(Nu.T),
            torch.from_numpy(lu.perm_r.astype(np.int64)).to(device),
            torch.from_numpy(lu.perm_c.astype(np.int64)).to(device),
            depth_l, depth_u, (n, n), block=s)

    def _block_sweep(self, diag, N, c, depth: int, *, lower: bool,
                     transpose: bool):
        """y <- D^-1 (c - N y), exact after ``depth`` sweeps. ``lower`` is
        the storage of ``diag``; ``transpose`` solves with D^T."""
        B, s, _ = diag.shape
        D = diag.transpose(1, 2) if transpose else diag

        def trisolve(rhs):
            return torch.linalg.solve_triangular(
                D, rhs.reshape(B, s, -1), upper=(lower == transpose),
                unitriangular=lower).reshape(rhs.shape)

        with full_fp32_matmul():
            y = trisolve(c)
            for _ in range(depth - 1):
                y = trisolve(c - _apply(N, y))
        return y

    def _permuted(self, b: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        bp = self.Ldiag.new_zeros((self.n_pad,) + tuple(b.shape[1:]))
        bp[idx] = b.to(bp.dtype)
        return bp

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """x = A^-1 b for b of shape (n,) or (n, k)."""
        y = self._block_sweep(self.Ldiag, self.Nl,
                              self._permuted(b, self.perm_r), self.depth_l,
                              lower=True, transpose=False)
        z = self._block_sweep(self.Udiag, self.Nu, y, self.depth_u,
                              lower=False, transpose=False)
        return z[self.perm_c].to(b.dtype)

    def solve_transpose(self, b: torch.Tensor) -> torch.Tensor:
        """x = A^-T b with the same factors: A^T = Pc U^T L^T Pr, so
        (U^T)^-1 then (L^T)^-1 on Pc^-1 b, un-permuted by Pr."""
        w = self._block_sweep(self.Udiag, self.NuT,
                              self._permuted(b, self.perm_c), self.depth_u,
                              lower=False, transpose=True)
        y = self._block_sweep(self.Ldiag, self.NlT, w, self.depth_l,
                              lower=True, transpose=True)
        return y[self.perm_r].to(b.dtype)


def sparse_lu_solve(lu: SparseLU, b: torch.Tensor) -> torch.Tensor:
    """Functional alias: x = A^-1 b."""
    return lu.solve(b)


def sparse_lu_solve_diff(lu: SparseLU, b: torch.Tensor) -> torch.Tensor:
    """x = A^-1 b, differentiable in b: the backward runs one adjoint
    solve with the same factors (grad_b = A^-T x_bar, reference contract
    cudss_solver.py:115-148). The factors carry no gradient; for A's
    values solve through the router or ``direct_solve_diff``."""
    return factored_solve(lu, None, b)
