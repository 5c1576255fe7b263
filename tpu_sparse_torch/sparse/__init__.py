"""Sparse containers, conversions and generators (torch tensors)."""

from tpu_sparse_torch.sparse import convert, generators
from tpu_sparse_torch.sparse.containers import COO, CSR, DIA, is_sparse

__all__ = ["COO", "CSR", "DIA", "is_sparse", "convert", "generators"]
