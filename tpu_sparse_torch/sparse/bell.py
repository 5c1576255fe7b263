"""BELL — block-ELL, the regular form of BSR.

Counterpart of ``tpu_sparse/sparse/bell.py``. Each block row stores the
same number L of dense (bs, bs) blocks, padded with zero blocks at block
column 0:

  blocks:  (n_block_rows, L, bs, bs) dense blocks, zero-padded
  indices: (n_block_rows, L) int32 block-column ids (0 for padding)

An SpMM on a BELL runs K8 (``kernels/cuda_bell.py``) on the card. An SpMV
runs K4 on the CWELL repack of the blocks (``block_cwell``), built once
per matrix content with ``group=1`` and the padding zeros dropped, as the
JAX package repacks for its SpMV kernel (``pallas_spmv.py``
``_cached_cwell_of_block``). ``bsr_to_bell`` is torch ops on the BSR's
device, with the bytes of the JAX host loop.
"""

from __future__ import annotations

import torch

from tpu_sparse_torch.sparse.containers import BSR, COO, SPARSE_TYPES, _matvec
from tpu_sparse_torch.utils.opcache import OperandCache


class BELL:
    """Block-ELL matrix (see the module docstring)."""

    def __init__(self, blocks, indices, shape):
        self.blocks = blocks
        self.indices = indices
        self.shape = tuple(int(s) for s in shape)

    @property
    def blocksize(self) -> int:
        return int(self.blocks.shape[2])

    @property
    def n_block_rows(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def ell_width(self) -> int:
        return int(self.blocks.shape[1])

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def device(self):
        return self.blocks.device

    @property
    def nnz(self) -> int:
        """Stored slots, padding blocks included (as in JAX)."""
        return int(self.blocks.numel())

    def with_data(self, blocks) -> "BELL":
        return BELL(blocks, self.indices, self.shape)

    def to(self, device) -> "BELL":
        return BELL(self.blocks.to(device), self.indices.to(device),
                    self.shape)

    def tocoo(self) -> COO:
        """The nonzero slots as COO, block by block; zero slots (padding
        blocks among them) are dropped."""
        bs = self.blocksize
        r, l, i, j = (self.blocks != 0).nonzero(as_tuple=True)
        rows = (r * bs + i).to(torch.int32)
        cols = (self.indices[r, l].long() * bs + j).to(torch.int32)
        return COO(self.blocks[r, l, i, j], rows, cols, self.shape)

    def tocsr(self):
        """CSR of the nonzero slots, columns sorted within rows."""
        return self.tocoo().tocsr()

    def todense(self) -> torch.Tensor:
        bs = self.blocksize
        ii = torch.arange(bs, device=self.blocks.device)
        rows = (torch.arange(self.n_block_rows, device=ii.device)[:, None,
                                                                   None, None]
                * bs + ii[None, None, :, None])
        cols = self.indices.long()[:, :, None, None] * bs + ii[None, None,
                                                               None, :]
        out = torch.zeros(self.shape, dtype=self.dtype, device=ii.device)
        return out.index_put_((rows.expand(self.blocks.shape),
                               cols.expand(self.blocks.shape)), self.blocks,
                              accumulate=True)

    def __matmul__(self, x):
        return _matvec(self, x)

    def __repr__(self):
        return (f"BELL(shape={self.shape}, block_rows={self.n_block_rows}, "
                f"L={self.ell_width}, bs={self.blocksize})")


def bsr_to_bell(A: BSR, ell_width: "int | None" = None) -> BELL:
    """BSR -> BELL on the BSR's device: every block row padded with zero
    blocks to the largest number of blocks a row holds (or ``ell_width``)."""
    nbr, bs = A.n_block_rows, A.blocksize
    counts = torch.diff(A.indptr.long())
    most = int(counts.max()) if counts.numel() else 0
    L = most if ell_width is None else int(ell_width)
    if most > L:
        raise ValueError(f"ell_width {L} < max blocks per row {most}")
    rows = A.block_row_ids().long()
    # each block's place in its row: its index less its row's first index
    pos = torch.arange(rows.numel(), device=rows.device) \
        - A.indptr.long()[rows]
    blocks = A.data.new_zeros((nbr, L, bs, bs))
    idx = torch.zeros((nbr, L), dtype=torch.int32, device=rows.device)
    blocks[rows, pos] = A.data
    idx[rows, pos] = A.indices.to(torch.int32)
    return BELL(blocks, idx, A.shape)


_block_cwell_cache = OperandCache(max_entries=16)


def block_cwell(A):
    """The CWELL repack of a BSR or BELL matrix (``group=1``; a BELL's
    zero slots dropped, a BSR's kept, as in the JAX repack), built on the
    matrix's device and cached per matrix content."""
    from tpu_sparse_torch.sparse.cwell import coo_arrays_to_csr, csr_to_cwell

    def build():
        C = A.tocoo()
        return csr_to_cwell(coo_arrays_to_csr(C.row, C.col, C.data, A.shape))

    return _block_cwell_cache.get_or_build(A, build)


SPARSE_TYPES.append(BELL)

__all__ = ["BELL", "block_cwell", "bsr_to_bell"]
