"""Sparse containers, conversions, the CWELL and BELL packs, format
promotion and generators (torch tensors)."""

from tpu_sparse_torch.sparse import convert, generators
from tpu_sparse_torch.sparse.bell import BELL, bsr_to_bell
from tpu_sparse_torch.sparse.containers import (BSR, COO, CSR, DIA,
                                                is_sparse, values,
                                                with_values)
from tpu_sparse_torch.sparse.convert import (coo_to_csr, csr_from_arrays,
                                             csr_to_bsr, csr_to_dia,
                                             dense_to_coo, dense_to_csr,
                                             dia_from_offsets, to_csr)
from tpu_sparse_torch.sparse.cwell import (CWELL, CWELLSeg, csr_to_cwell,
                                           csr_to_cwell_segments,
                                           rcm_permutation)
from tpu_sparse_torch.sparse.optimize import to_gpu_operator

__all__ = ["BELL", "BSR", "COO", "CSR", "CWELL", "CWELLSeg", "DIA",
           "bsr_to_bell", "convert", "coo_to_csr", "csr_from_arrays",
           "csr_to_bsr", "csr_to_cwell", "csr_to_cwell_segments",
           "csr_to_dia", "dense_to_coo", "dense_to_csr", "dia_from_offsets",
           "generators", "is_sparse", "rcm_permutation", "to_csr",
           "to_gpu_operator", "values", "with_values"]
