"""Plain PyTorch sparse kernels: the correctness oracle and the CPU path.

Counterpart of ``tpu_sparse/kernels/reference.py``. ``dia_spmv`` accumulates
the diagonals in ``offsets`` order exactly like the JAX loop; the CSR/COO
versions scatter-add products onto rows; ``cwell_spmv`` gathers x per
slot and sums the planes.
"""

from __future__ import annotations

import torch

from tpu_sparse_torch.sparse.containers import COO, CSR, DIA


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
