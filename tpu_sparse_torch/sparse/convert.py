"""Construction and conversion of containers.

Counterpart of ``tpu_sparse/sparse/convert.py``. Conversions are set-up
work with data-dependent shapes; those that run at the size of the matrix
on the main path (``dense_to_csr`` of a tensor, ``csr_to_dia``) are torch
ops on the input's device, the rest run in numpy or scipy on the host.
``dia_from_numpy`` and ``cwell_from_numpy`` carry a DIA or CWELL matrix
across from any array-like (for example the numpy view of a JAX
container's arrays), so that both packages solve the same system.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_sparse_torch.sparse.containers import COO, CSR, DIA
from tpu_sparse_torch.sparse.cwell import CWELL


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _tensor(a, device, dtype=None) -> torch.Tensor:
    """A tensor on ``device``: an array-like is copied, a tensor moved."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.array(a, copy=True))
    return t.to(device=device, dtype=dtype)


def dia_from_offsets(offsets, diag_data, shape, device="cuda") -> DIA:
    """DIA from offsets and an (ndiag, n) array on ``device`` (the card
    unless the caller asks for the CPU); numpy input is wrapped without a
    copy when it stays on the CPU."""
    if isinstance(diag_data, np.ndarray) and diag_data.flags.writeable:
        data = torch.from_numpy(diag_data)
    else:
        data = torch.as_tensor(_np(diag_data).copy())
    return DIA(data.to(device), tuple(int(o) for o in offsets), shape)


def dia_from_numpy(data, offsets, shape, device="cuda") -> DIA:
    """Copy an (ndiag, n) array-like and its offsets into a DIA on
    ``device`` (the card unless the caller asks for the CPU)."""
    t = torch.from_numpy(np.array(data, copy=True)).to(device)
    return DIA(t, tuple(int(o) for o in offsets), tuple(int(s) for s in shape))


def cwell_from_numpy(vals, idx2, srow, shape, *, nnz, fill, group,
                     device="cuda") -> CWELL:
    """Copy a CWELL pack's arrays (for example a JAX pack's, as numpy) into
    a CWELL on ``device`` (the card unless the caller asks for the CPU)."""
    return CWELL(_tensor(vals, device), _tensor(idx2, device, torch.int32),
                 _tensor(srow, device, torch.int32),
                 tuple(int(s) for s in shape), nnz=nnz, fill=fill,
                 group=group)


def dense_to_csr(A, tol: float = 0.0) -> CSR:
    """CSR from a dense matrix, dropping |a| <= tol entries. A tensor keeps
    its device; any other array-like lands on the CPU."""
    if not isinstance(A, torch.Tensor):
        A = torch.from_numpy(np.array(A, copy=True))
    row, col = (A.abs() > tol).nonzero(as_tuple=True)  # row-major order
    indptr = torch.zeros(A.shape[0] + 1, dtype=torch.int64, device=A.device)
    indptr[1:] = torch.cumsum(torch.bincount(row, minlength=A.shape[0]), 0)
    return CSR(A[row, col], col.to(torch.int32), indptr.to(torch.int32),
               A.shape)


def csr_from_arrays(data, indices, indptr, shape, device="cuda") -> CSR:
    """CSR from array-likes, on ``device`` (the card unless the caller asks
    for the CPU); indices and indptr become int32."""
    return CSR(_tensor(data, device), _tensor(indices, device, torch.int32),
               _tensor(indptr, device, torch.int32), shape)


def csr_to_dia(A: CSR, max_diags=None):
    """DIA from CSR when it has at most ``max_diags`` (default 64) distinct
    diagonals, else None; torch ops on the CSR's device. Duplicate entries
    sum, as in the containers' materialization."""
    n, m = A.shape
    rows = A.row_ids().long()
    offs = A.indices.long() - rows
    uniq = torch.unique(offs)  # sorted
    if uniq.numel() > (64 if max_diags is None else max_diags):
        return None
    data = A.data.new_zeros((uniq.numel(), n))
    data.index_put_((torch.searchsorted(uniq, offs), rows), A.data,
                    accumulate=True)
    return DIA(data, tuple(int(o) for o in uniq.tolist()), (n, m))


def coo_to_csr(A: COO) -> CSR:
    """COO -> CSR through scipy (duplicates summed, sorted columns)."""
    import scipy.sparse as sp

    S = sp.csr_matrix((_np(A.data), (_np(A.row), _np(A.col))), shape=A.shape)
    S.sort_indices()
    dev = A.data.device
    return CSR(torch.from_numpy(S.data).to(dev),
               torch.from_numpy(S.indices.astype(np.int32)).to(dev),
               torch.from_numpy(S.indptr.astype(np.int32)).to(dev), A.shape)


def dia_to_csr_arrays(A: DIA):
    """Vectorized host DIA -> CSR (numpy): (data, indices, indptr).

    Keeps explicit in-band zeros (pattern semantics, like ``DIA.tocoo``)
    and emits sorted column indices per row: with offsets sorted, the
    diagonals valid at row i are the contiguous range [lo(i), hi(i)).
    """
    data = _np(A.data)
    n, m = A.shape
    offs = np.asarray(A.offsets, dtype=np.int64)
    order = np.argsort(offs, kind="stable")
    offs_s = offs[order]
    i = np.arange(n, dtype=np.int64)
    lo = np.searchsorted(offs_s, -i)
    hi = np.searchsorted(offs_s, m - i)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(hi - lo, out=indptr[1:])
    dataT = data.T[:, order] if order.size else data.T
    k = np.arange(offs_s.size)
    mask = (k >= lo[:, None]) & (k < hi[:, None])
    out = dataT[mask]
    cols = np.arange(n, dtype=np.int32)[:, None] + offs_s.astype(np.int32)
    indices = cols[mask]
    if indptr[-1] <= np.iinfo(np.int32).max:
        indptr = indptr.astype(np.int32)
    return out, indices, indptr


def to_scipy_csr(A):
    """Any supported operand as a scipy CSR matrix on the host (set-up
    work such as the RCM ordering)."""
    import scipy.sparse as sp

    if isinstance(A, DIA):
        data, indices, indptr = dia_to_csr_arrays(A)
        S = sp.csr_matrix((data, indices, indptr), shape=A.shape)
        S.has_sorted_indices = True
        return S
    if isinstance(A, COO):
        S = sp.csr_matrix((_np(A.data), (_np(A.row), _np(A.col))),
                          shape=A.shape)
        S.sort_indices()
        return S
    if hasattr(A, "tocsr"):  # CWELL, CWELLSeg
        A = A.tocsr()
    if isinstance(A, CSR):
        return sp.csr_matrix((_np(A.data), _np(A.indices), _np(A.indptr)),
                             shape=A.shape)
    return sp.csr_matrix(_np(A))


def to_csr(A) -> CSR:
    """Best-effort conversion of a container or dense matrix to CSR."""
    if isinstance(A, CSR):
        return A
    if isinstance(A, COO):
        return coo_to_csr(A)
    if isinstance(A, DIA):
        data, indices, indptr = dia_to_csr_arrays(A)
        dev = A.data.device
        return CSR(torch.from_numpy(np.ascontiguousarray(data)).to(dev),
                   torch.from_numpy(indices).to(dev),
                   torch.from_numpy(indptr).to(dev), A.shape)
    if hasattr(A, "tocsr"):  # CWELL, CWELLSeg
        return A.tocsr()
    return dense_to_csr(A)
