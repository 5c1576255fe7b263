"""Host-side construction and conversion of containers.

Counterpart of ``tpu_sparse/sparse/convert.py``. Conversions run in numpy:
they are set-up work with data-dependent shapes. ``dia_from_numpy`` carries a
DIA matrix across from any array-like (for example the numpy view of a JAX
container's data), so that both packages solve the same system.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_sparse_torch.sparse.containers import COO, CSR, DIA


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


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


def dense_to_csr(A, tol: float = 0.0) -> CSR:
    """CSR from a dense matrix, dropping |a| <= tol entries."""
    An = _np(A)
    row, col = np.nonzero(np.abs(An) > tol)
    indptr = np.zeros(An.shape[0] + 1, dtype=np.int32)
    np.add.at(indptr, row + 1, 1)
    indptr = np.cumsum(indptr, dtype=np.int32)
    return CSR(torch.from_numpy(An[row, col].copy()),
               torch.from_numpy(col.astype(np.int32)),
               torch.from_numpy(indptr), An.shape)


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
    return dense_to_csr(A)
