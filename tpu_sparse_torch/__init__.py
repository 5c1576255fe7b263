"""tpu_sparse_torch — the PyTorch / NVIDIA H100 port of ``tpu_sparse``.

Ported so far: DIA/CSR/COO/BSR containers and generators; the CWELL pack
of general matrices, the BELL (block-ELL) format and ``to_gpu_operator``;
the Krylov core (CG, BiCGStab, GMRES with no preconditioner or Jacobi)
with mixed-precision refinement and the adjoint gradient; multi-RHS solves
(batched CG / BiCGStab / GMRES, block CG, batched refinement); the
``SparseSolver`` / ``solve`` router with ``reorder="rcm"``; hand-written
CUDA kernels for the DIA SpMV, the fused CG iteration, the fused BiCGStab
iteration, the CWELL SpMV and SpMM and the BELL SpMM
(``tpu_sparse_torch/csrc``). The package
imports ``torch`` and never ``jax``; on CPU tensors every kernel runs its
plain PyTorch version. Entry points that build matrices default to the
card (``device="cuda"``).
"""

from tpu_sparse_torch import autodiff, config, kernels, sparse, utils
from tpu_sparse_torch.api import SolverResult, SparseSolver, solve
from tpu_sparse_torch.autodiff import bicgstab_diff, cg_diff, gmres_diff
from tpu_sparse_torch.solvers import (batch_bicgstab, batch_cg, batch_gmres,
                                      bicgstab, block_cg, cg, gmres)
from tpu_sparse_torch.sparse import (BELL, BSR, COO, CSR, CWELL, DIA,
                                     CWELLSeg, bsr_to_bell, csr_to_bsr,
                                     csr_to_cwell, to_gpu_operator)

__version__ = "0.4.0"

__all__ = [
    "autodiff", "config", "kernels", "sparse", "utils",
    "BELL", "BSR", "COO", "CSR", "CWELL", "CWELLSeg", "DIA", "bsr_to_bell",
    "csr_to_bsr", "csr_to_cwell", "to_gpu_operator",
    "batch_bicgstab", "batch_cg", "batch_gmres", "bicgstab", "block_cg",
    "cg", "gmres",
    "bicgstab_diff", "cg_diff", "gmres_diff",
    "SparseSolver", "SolverResult", "solve",
]
