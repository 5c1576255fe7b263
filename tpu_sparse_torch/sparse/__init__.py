"""Sparse containers, conversions, the CWELL pack, format promotion and
generators (torch tensors)."""

from tpu_sparse_torch.sparse import convert, generators
from tpu_sparse_torch.sparse.containers import (COO, CSR, DIA, is_sparse,
                                                values, with_values)
from tpu_sparse_torch.sparse.cwell import (CWELL, CWELLSeg, csr_to_cwell,
                                           csr_to_cwell_segments,
                                           rcm_permutation)
from tpu_sparse_torch.sparse.optimize import to_gpu_operator

__all__ = ["COO", "CSR", "CWELL", "CWELLSeg", "DIA", "convert",
           "csr_to_cwell", "csr_to_cwell_segments", "generators",
           "is_sparse", "rcm_permutation", "to_gpu_operator", "values",
           "with_values"]
