"""Construction and conversion of containers.

Counterpart of ``tpu_sparse/sparse/convert.py``. Conversions are set-up
work with data-dependent shapes; those that run at the size of the matrix
on the main path (``dense_to_csr`` of a tensor, ``csr_to_dia``,
``dia_to_csr_arrays``, which the AMG set-up reads) are torch
ops on the input's device, the rest run in numpy or scipy on the host.
``dia_from_numpy``, ``cwell_from_numpy``, ``bsr_from_arrays`` and
``bell_from_numpy`` carry a DIA, CWELL, BSR or BELL matrix across from any
array-like (for example the numpy view of a JAX container's arrays), so
that both packages solve the same system. ``csr_to_bsr`` is torch ops on
the CSR's device, like the CWELL packer.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_sparse_torch.sparse.bell import BELL
from tpu_sparse_torch.sparse.containers import BSR, COO, CSR, DIA
from tpu_sparse_torch.sparse.cwell import CWELL


def _np(a) -> np.ndarray:
    """An array-like as a host array; a bf16 tensor crosses as float32
    (numpy has no bf16; the widening is exact)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a)


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype that carries a torch dtype on the host (float32 ->
    float32, ...; bf16 -> float32, cast back by torch on the way in)."""
    if dtype == torch.bfloat16:
        return np.dtype(np.float32)
    return np.dtype(str(dtype).replace("torch.", ""))


def _host_array(a) -> "tuple[np.ndarray, torch.dtype | None]":
    """(a copy of an array-like as a numpy array torch takes, the torch
    dtype it stands for when that is not its own). A bf16 array (numpy's
    ``bfloat16`` extension dtype, as ``np.asarray`` of a JAX bf16 array
    gives) is widened to float32, exactly, and stands for bf16: torch
    cannot wrap that dtype. The extension module is never imported here;
    callers without it pass float32 arrays of bf16-exact values and
    ``dtype=torch.bfloat16``."""
    arr = np.array(a, copy=True)
    if arr.dtype.name == "bfloat16":
        return arr.astype(np.float32), torch.bfloat16
    return arr, None


def _tensor(a, device, dtype=None) -> torch.Tensor:
    """A tensor on ``device``, cast to ``dtype`` when given: an array-like
    is copied, a tensor moved."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    arr, own = _host_array(a)
    return torch.from_numpy(arr).to(device=device, dtype=dtype or own)


def dia_from_offsets(offsets, diag_data, shape, device="cuda",
                     dtype=None) -> DIA:
    """DIA from offsets and an (ndiag, n) array on ``device`` (the card
    unless the caller asks for the CPU), cast to ``dtype`` when given;
    numpy input is wrapped without a copy when it stays on the CPU in its
    own dtype."""
    if isinstance(diag_data, np.ndarray) and diag_data.flags.writeable \
            and diag_data.dtype.name != "bfloat16":
        data = torch.from_numpy(diag_data).to(device, dtype)
    elif isinstance(diag_data, torch.Tensor):
        data = diag_data.detach().clone().to(device, dtype)
    else:
        data = _tensor(diag_data, device, dtype)
    return DIA(data, tuple(int(o) for o in offsets), shape)


def dia_from_numpy(data, offsets, shape, device="cuda", dtype=None) -> DIA:
    """Copy an (ndiag, n) array-like and its offsets into a DIA on
    ``device`` (the card unless the caller asks for the CPU), cast to
    ``dtype`` when given (bf16 crosses as float32 arrays of bf16-exact
    values, cast by torch)."""
    return DIA(_tensor(data, device, dtype), tuple(int(o) for o in offsets),
               tuple(int(s) for s in shape))


def cwell_from_numpy(vals, idx2, srow, shape, *, nnz, fill, group,
                     device="cuda", dtype=None) -> CWELL:
    """Copy a CWELL pack's arrays (for example a JAX pack's, as numpy) into
    a CWELL on ``device`` (the card unless the caller asks for the CPU),
    its values cast to ``dtype`` when given."""
    return CWELL(_tensor(vals, device, dtype),
                 _tensor(idx2, device, torch.int32),
                 _tensor(srow, device, torch.int32),
                 tuple(int(s) for s in shape), nnz=nnz, fill=fill,
                 group=group)


def bsr_from_arrays(data, indices, indptr, shape, device="cuda",
                    dtype=None) -> BSR:
    """Copy BSR arrays (for example a JAX BSR's, as numpy) into a BSR on
    ``device`` (the card unless the caller asks for the CPU), its values
    cast to ``dtype`` when given."""
    return BSR(_tensor(data, device, dtype),
               _tensor(indices, device, torch.int32),
               _tensor(indptr, device, torch.int32),
               tuple(int(s) for s in shape))


def bell_from_numpy(blocks, indices, shape, device="cuda",
                    dtype=None) -> BELL:
    """Copy a BELL's blocks and block-column ids (for example a JAX
    BELL's, as numpy) into a BELL on ``device`` (the card unless the
    caller asks for the CPU), its blocks cast to ``dtype`` when given."""
    return BELL(_tensor(blocks, device, dtype),
                _tensor(indices, device, torch.int32),
                tuple(int(s) for s in shape))


def csr_to_bsr(A: CSR, blocksize: int) -> BSR:
    """CSR -> BSR with square blocks of ``blocksize`` (the shape must
    divide), on the CSR's device. Blocks sort by (block row, block column);
    entries that share a slot sum."""
    n, m = A.shape
    bs = int(blocksize)
    if n % bs or m % bs:
        raise ValueError(f"shape {A.shape} not divisible by blocksize {bs}")
    rows = A.row_ids().long()
    cols = A.indices.long()
    nbc = m // bs
    uniq, inv = torch.unique(rows // bs * nbc + cols // bs, sorted=True,
                             return_inverse=True)
    blocks = A.data.new_zeros((uniq.numel(), bs, bs))
    blocks.index_put_((inv, rows % bs, cols % bs), A.data, accumulate=True)
    indptr = torch.zeros(n // bs + 1, dtype=torch.int64, device=rows.device)
    indptr[1:] = torch.cumsum(torch.bincount(uniq // nbc, minlength=n // bs),
                              0)
    return BSR(blocks, (uniq % nbc).to(torch.int32), indptr.to(torch.int32),
               (n, m))


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


def dense_to_coo(A, tol: float = 0.0) -> COO:
    """COO from a dense matrix, dropping |a| <= tol entries, in row-major
    order. A tensor keeps its device; any other array-like lands on the
    CPU."""
    if not isinstance(A, torch.Tensor):
        A = torch.from_numpy(np.array(A, copy=True))
    row, col = (A.abs() > tol).nonzero(as_tuple=True)
    return COO(A[row, col], row.to(torch.int32), col.to(torch.int32),
               A.shape)


def csr_from_arrays(data, indices, indptr, shape, device="cuda",
                    dtype=None) -> CSR:
    """CSR from array-likes, on ``device`` (the card unless the caller asks
    for the CPU), its values cast to ``dtype`` when given; indices and
    indptr become int32."""
    return CSR(_tensor(data, device, dtype),
               _tensor(indices, device, torch.int32),
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
    """DIA -> CSR arrays (data, indices, indptr) as tensors on the DIA's
    device, built by torch ops with no loop over rows.

    Keeps explicit in-band zeros (pattern semantics, like ``DIA.tocoo``)
    and emits sorted column indices per row: with offsets sorted, the
    diagonals valid at row i are the contiguous range [lo(i), hi(i)).
    indptr is int32 when nnz fits, else int64.
    """
    n, m = A.shape
    dev = A.data.device
    offs = torch.tensor(A.offsets, dtype=torch.int64, device=dev)
    offs_s, order = torch.sort(offs, stable=True)
    i = torch.arange(n, dtype=torch.int64, device=dev)
    lo = torch.searchsorted(offs_s, -i)
    hi = torch.searchsorted(offs_s, m - i)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(hi - lo, 0)
    k = torch.arange(offs_s.numel(), device=dev)
    mask = (k >= lo[:, None]) & (k < hi[:, None])
    data = A.data.T[:, order][mask]
    cols = (i.to(torch.int32)[:, None] + offs_s.to(torch.int32))[mask]
    if n == 0 or int(indptr[-1]) <= np.iinfo(np.int32).max:
        indptr = indptr.to(torch.int32)
    return data, cols, indptr


def to_scipy_csr(A):
    """Any supported operand as a scipy CSR matrix on the host (set-up
    work such as the RCM ordering)."""
    import scipy.sparse as sp

    if isinstance(A, DIA):
        # built on the DIA's device, copied to the host once per array
        data, indices, indptr = (_np(t) for t in dia_to_csr_arrays(A))
        S = sp.csr_matrix((data, indices, indptr), shape=A.shape)
        S.has_sorted_indices = True
        return S
    if isinstance(A, BSR):
        A = A.tocoo()
    if isinstance(A, COO):
        S = sp.csr_matrix((_np(A.data), (_np(A.row), _np(A.col))),
                          shape=A.shape)
        S.sort_indices()
        return S
    if hasattr(A, "tocsr"):  # CWELL, CWELLSeg, BELL
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
        return CSR(*dia_to_csr_arrays(A), A.shape)
    if isinstance(A, BSR):
        return coo_to_csr(A.tocoo())
    if hasattr(A, "tocsr"):  # CWELL, CWELLSeg, BELL (zero slots dropped)
        return A.tocsr()
    return dense_to_csr(A)
