"""Sparse matrix containers holding torch tensors.

Counterpart of ``tpu_sparse/sparse/containers.py``: ``COO``, ``CSR``,
``DIA`` and ``BSR`` with the same fields and methods. ``DIA`` keeps its
offsets as a static tuple of Python ints (the stencil kernels take them by
value). Containers are small classes with ``.to(device)``; nothing here is
trained. ``A @ x`` is an SpMV for a vector and an SpMM for an (m, k) block.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

__all__ = ["BSR", "COO", "CSR", "DIA", "is_sparse", "values", "with_values"]


def _matvec(A, x):
    from tpu_sparse_torch.kernels import spmm, spmv  # lazy: kernels use us

    if getattr(x, "ndim", 1) == 2:
        return spmm(A, x)
    return spmv(A, x)


class COO:
    """Coordinate-format sparse matrix: ``data``, ``row``, ``col`` (int32),
    static ``shape``. Duplicate entries sum on materialization."""

    def __init__(self, data, row, col, shape):
        self.data = data
        self.row = row
        self.col = col
        self.shape = tuple(int(s) for s in shape)

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def T(self) -> "COO":
        return COO(self.data, self.col, self.row,
                   (self.shape[1], self.shape[0]))

    def conj(self) -> "COO":
        return COO(self.data.conj(), self.row, self.col, self.shape)

    def with_data(self, data) -> "COO":
        return COO(data, self.row, self.col, self.shape)

    def to(self, device) -> "COO":
        return COO(self.data.to(device), self.row.to(device),
                   self.col.to(device), self.shape)

    def todense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        return out.index_put_((self.row.long(), self.col.long()), self.data,
                              accumulate=True)

    def tocsr(self) -> "CSR":
        """Sort by (row, col) and build row pointers."""
        o1 = torch.argsort(self.col, stable=True)
        o2 = torch.argsort(self.row[o1], stable=True)
        order = o1[o2]
        row = self.row[order]
        indptr = torch.searchsorted(
            row, torch.arange(self.shape[0] + 1, dtype=row.dtype,
                              device=row.device)).to(torch.int32)
        return CSR(self.data[order], self.col[order], indptr, self.shape)

    def __matmul__(self, x):
        return _matvec(self, x)

    def __repr__(self):
        return f"COO(shape={self.shape}, nnz={self.nnz}, dtype={self.dtype})"


class CSR:
    """Compressed-sparse-row matrix: ``data``, ``indices`` (int32),
    ``indptr`` (int32), static ``shape``."""

    def __init__(self, data, indices, indptr, shape):
        self.data = data
        self.indices = indices
        self.indptr = indptr
        self.shape = tuple(int(s) for s in shape)

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    def row_ids(self) -> torch.Tensor:
        """One row id per stored entry."""
        counts = torch.diff(self.indptr.long())
        rows = torch.arange(self.shape[0], dtype=torch.int32,
                            device=self.indptr.device)
        return torch.repeat_interleave(rows, counts, output_size=self.nnz)

    @property
    def T(self) -> "CSR":
        return self.tocoo().T.tocsr()

    def conj(self) -> "CSR":
        return CSR(self.data.conj(), self.indices, self.indptr, self.shape)

    def with_data(self, data) -> "CSR":
        return CSR(data, self.indices, self.indptr, self.shape)

    def to(self, device) -> "CSR":
        return CSR(self.data.to(device), self.indices.to(device),
                   self.indptr.to(device), self.shape)

    def tocoo(self) -> COO:
        return COO(self.data, self.row_ids(), self.indices, self.shape)

    def todense(self) -> torch.Tensor:
        return self.tocoo().todense()

    def __matmul__(self, x):
        return _matvec(self, x)

    def __repr__(self):
        return f"CSR(shape={self.shape}, nnz={self.nnz}, dtype={self.dtype})"


class DIA:
    """Diagonal (banded / stencil) storage with static offsets.

    ``data`` is (ndiag, n_rows): ``data[d, i]`` is ``A[i, i + offsets[d]]``;
    entries whose column falls outside the matrix are ignored. SpMV is
    ``y[i] = sum_d data[d, i] * x[i + offsets[d]]``.
    """

    def __init__(self, data, offsets: Sequence[int], shape):
        self.data = data
        self.offsets = tuple(int(o) for o in offsets)
        self.shape = tuple(int(s) for s in shape)

    @property
    def ndiag(self) -> int:
        return len(self.offsets)

    @property
    def bandwidth(self) -> int:
        return max(abs(o) for o in self.offsets) if self.offsets else 0

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def nnz(self) -> int:
        """Count of stored (in-bounds) entries."""
        n, m = self.shape
        return sum(max(0, min(n, m - o) - max(0, -o)) for o in self.offsets)

    @property
    def T(self) -> "DIA":
        # A^T[i, i - o] = A[i - o, i] = data[d, i - o]: shift by +o
        n, m = self.shape
        cols = [_shift(self.data[d], o, m)
                for d, o in enumerate(self.offsets)]
        return DIA(torch.stack(cols), tuple(-o for o in self.offsets), (m, n))

    def conj(self) -> "DIA":
        return DIA(self.data.conj(), self.offsets, self.shape)

    def with_data(self, data) -> "DIA":
        return DIA(data, self.offsets, self.shape)

    def to(self, device) -> "DIA":
        return DIA(self.data.to(device), self.offsets, self.shape)

    def tocoo(self) -> COO:
        n, m = self.shape
        rows, cols, vals = [], [], []
        for d, o in enumerate(self.offsets):
            i0, i1 = max(0, -o), min(n, m - o)
            if i1 <= i0:
                continue
            idx = torch.arange(i0, i1, dtype=torch.int32,
                               device=self.data.device)
            rows.append(idx)
            cols.append(idx + o)
            vals.append(self.data[d, i0:i1])
        return COO(torch.cat(vals), torch.cat(rows), torch.cat(cols),
                   self.shape)

    def todense(self) -> torch.Tensor:
        return self.tocoo().todense()

    def __matmul__(self, x):
        return _matvec(self, x)

    def __repr__(self):
        return (f"DIA(shape={self.shape}, ndiag={self.ndiag}, "
                f"offsets={self.offsets}, dtype={self.dtype})")


def _shift(v: torch.Tensor, k: int, out_len: int) -> torch.Tensor:
    """w with w[i] = v[i - k] (zero outside), length out_len."""
    n = v.shape[0]
    out = v.new_zeros(out_len)
    if k >= 0:
        length = min(n, out_len - k)
        if length > 0:
            out[k:k + length] = v[:length]
    else:
        length = min(n + k, out_len)
        if length > 0:
            out[:length] = v[-k:-k + length]
    return out


class BSR:
    """Block-sparse-row matrix with dense square blocks: ``data``
    (nblocks, bs, bs), ``indices`` (nblocks,) int32 block columns,
    ``indptr`` (n_block_rows + 1,) int32, static ``shape`` divisible by
    bs."""

    def __init__(self, data, indices, indptr, shape):
        self.data = data
        self.indices = indices
        self.indptr = indptr
        self.shape = tuple(int(s) for s in shape)

    @property
    def blocksize(self) -> int:
        return int(self.data.shape[1])

    @property
    def n_block_rows(self) -> int:
        return self.shape[0] // self.blocksize

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0]) * self.blocksize ** 2

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    def block_row_ids(self) -> torch.Tensor:
        """One block-row id per stored block."""
        counts = torch.diff(self.indptr.long())
        rows = torch.arange(self.n_block_rows, dtype=torch.int32,
                            device=self.indptr.device)
        return torch.repeat_interleave(rows, counts,
                                       output_size=int(self.data.shape[0]))

    def with_data(self, data) -> "BSR":
        return BSR(data, self.indices, self.indptr, self.shape)

    def to(self, device) -> "BSR":
        return BSR(self.data.to(device), self.indices.to(device),
                   self.indptr.to(device), self.shape)

    def tocoo(self) -> COO:
        """Every slot of every block, explicit zeros included, block by
        block in row-major order within a block."""
        bs = self.blocksize
        ii = torch.arange(bs, dtype=torch.int32, device=self.data.device)
        rows = self.block_row_ids()[:, None, None] * bs + ii[None, :, None]
        cols = self.indices[:, None, None] * bs + ii[None, None, :]
        rows = rows.expand(self.data.shape).reshape(-1).to(torch.int32)
        cols = cols.expand(self.data.shape).reshape(-1).to(torch.int32)
        return COO(self.data.reshape(-1), rows, cols, self.shape)

    def todense(self) -> torch.Tensor:
        return self.tocoo().todense()

    def __matmul__(self, x):
        return _matvec(self, x)

    def __repr__(self):
        return (f"BSR(shape={self.shape}, blocks={self.data.shape[0]}x"
                f"{self.blocksize}^2, dtype={self.dtype})")


# sparse/cwell.py appends CWELL, CWELLSeg; sparse/bell.py appends BELL
SPARSE_TYPES = [COO, CSR, DIA, BSR]


def is_sparse(A: Any) -> bool:
    return isinstance(A, tuple(SPARSE_TYPES))


def values(A) -> torch.Tensor:
    """The value tensor of a container: ``A.data``, ``A.vals`` for CWELL,
    ``A.blocks`` for BELL, and for CWELLSeg its segments' values flattened
    and concatenated."""
    if hasattr(A, "segments"):
        return torch.cat([values(W).reshape(-1) for W in A.segments])
    if hasattr(A, "blocks"):
        return A.blocks
    return A.vals if hasattr(A, "vals") else A.data


def with_values(A, vals):
    """``A`` with its value tensor replaced (the inverse of ``values``)."""
    return A.with_data(vals)
