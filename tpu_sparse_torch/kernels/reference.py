"""Plain PyTorch sparse kernels: the correctness oracle and the CPU path.

Counterpart of ``tpu_sparse/kernels/reference.py``. ``dia_spmv`` accumulates
the diagonals in ``offsets`` order exactly like the JAX loop; the CSR/COO
versions scatter-add products onto rows; ``cwell_spmv`` gathers x per
slot and sums the planes; the BSR / BELL versions contract dense blocks
with gathered chunks of x. Each ``*_spmm`` is the same function for a
dense ``(m, k)`` operand B, column by column.
"""

from __future__ import annotations

import torch

from tpu_sparse_torch.sparse.containers import BSR, COO, CSR, DIA


def coo_spmv(A: COO, x: torch.Tensor) -> torch.Tensor:
    prod = A.data * x[A.col.long()]
    out = torch.zeros(A.shape[0], dtype=prod.dtype, device=prod.device)
    return out.index_add_(0, A.row.long(), prod)


def csr_spmv(A: CSR, x: torch.Tensor) -> torch.Tensor:
    prod = A.data * x[A.indices.long()]
    out = torch.zeros(A.shape[0], dtype=prod.dtype, device=prod.device)
    return out.index_add_(0, A.row_ids().long(), prod)


def dia_spmv(A: DIA, x: torch.Tensor) -> torch.Tensor:
    """y[i] = sum_d data[d, i] * x[i + off_d], rows whose column falls
    outside the matrix skipped; diagonals summed in offsets order."""
    n, m = A.shape
    y = None
    for d, o in enumerate(A.offsets):
        i0, i1 = max(0, -o), min(n, m - o)
        if i1 <= i0:
            continue
        seg = A.data[d, i0:i1] * x[i0 + o:i1 + o]
        contrib = seg.new_zeros(n)
        contrib[i0:i1] = seg
        y = contrib if y is None else y + contrib
    if y is None:
        return x.new_zeros(n)
    return y


def cwell_spmv(A, x: torch.Tensor) -> torch.Tensor:
    """y[row] = sum over planes of vals * x[srow * 128 + idx2], where a
    column at or past m gathers 0 (JAX ``mode="fill"``), so a padding slot
    adds exactly 0 * x[col] or 0. Computed in the values' dtype."""
    n, m = A.shape
    gc = A.srow[:, :, None].long() * 128 + A.idx2
    x_fill = torch.cat([x, x.new_zeros(1)])  # x_fill[m] = 0
    xg = x_fill[torch.where((gc >= 0) & (gc < m), gc, m)]
    y = torch.sum(A.vals * xg.to(A.vals.dtype), dim=1)
    return y.reshape(-1)[:n]


def cwell_spmm(A, B: torch.Tensor) -> torch.Tensor:
    """Y = A @ B for a CWELL pack and a dense (m, k) B, with the fill rule
    of ``cwell_spmv``: a column at or past m gathers a row of zeros. The
    planes are summed one at a time, in order, so the gathered operand
    never holds more than one plane: (n_blocks * 128, k)."""
    n, m = A.shape
    k = B.shape[1]
    B_fill = torch.cat([B, B.new_zeros((1, k))]).to(A.vals.dtype)
    y = A.vals.new_zeros((A.vals.shape[0], A.vals.shape[2], k))
    for s in range(A.vals.shape[1]):
        gc = A.srow[:, s, None].long() * 128 + A.idx2[:, s]  # (nb, 128)
        y += A.vals[:, s, :, None] * B_fill[
            torch.where((gc >= 0) & (gc < m), gc, m)]
    return y.reshape(-1, k)[:n]


def coo_spmm(A: COO, B: torch.Tensor) -> torch.Tensor:
    prod = A.data[:, None] * B[A.col.long()]
    out = prod.new_zeros((A.shape[0], B.shape[1]))
    return out.index_add_(0, A.row.long(), prod)


def csr_spmm(A: CSR, B: torch.Tensor) -> torch.Tensor:
    prod = A.data[:, None] * B[A.indices.long()]
    out = prod.new_zeros((A.shape[0], B.shape[1]))
    return out.index_add_(0, A.row_ids().long(), prod)


def dia_spmm(A: DIA, B: torch.Tensor) -> torch.Tensor:
    """Y[i] = sum_d data[d, i] * B[i + off_d], diagonals in offsets order."""
    n, m = A.shape
    k = B.shape[1]
    y = B.new_zeros((n, k), dtype=torch.promote_types(A.data.dtype, B.dtype))
    for d, o in enumerate(A.offsets):
        i0, i1 = max(0, -o), min(n, m - o)
        if i1 <= i0:
            continue
        y[i0:i1] += A.data[d, i0:i1, None] * B[i0 + o:i1 + o]
    return y


def bsr_spmv(A: BSR, x: torch.Tensor) -> torch.Tensor:
    bs = A.blocksize
    gathered = x.reshape(-1, bs)[A.indices.long()]  # (nblocks, bs)
    prods = torch.einsum("nij,nj->ni", A.data, gathered)
    out = prods.new_zeros((A.n_block_rows, bs))
    return out.index_add_(0, A.block_row_ids().long(), prods).reshape(-1)


def bsr_spmm(A: BSR, B: torch.Tensor) -> torch.Tensor:
    bs, k = A.blocksize, B.shape[1]
    gathered = B.reshape(-1, bs, k)[A.indices.long()]  # (nblocks, bs, k)
    prods = torch.einsum("nij,njk->nik", A.data, gathered)
    out = prods.new_zeros((A.n_block_rows, bs, k))
    out.index_add_(0, A.block_row_ids().long(), prods)
    return out.reshape(A.shape[0], k)


def bell_spmv(A, x: torch.Tensor) -> torch.Tensor:
    """Block-ELL SpMV: per block row, L dense (bs, bs) blocks times the
    gathered chunks of x (padding blocks are zero)."""
    bs = A.blocksize
    gathered = x.reshape(-1, bs)[A.indices.long()]  # (nbr, L, bs)
    return torch.einsum("rlij,rlj->ri", A.blocks, gathered).reshape(-1)


def bell_spmm(A, B: torch.Tensor) -> torch.Tensor:
    """Y[r bs + i] = sum_l blocks[r, l, i, :] @ B[idx[r, l] bs : + bs]."""
    bs, k = A.blocksize, B.shape[1]
    gathered = B.reshape(-1, bs, k)[A.indices.long()]  # (nbr, L, bs, k)
    prods = torch.einsum("rlij,rljk->rik", A.blocks, gathered)
    return prods.reshape(A.shape[0], k)
