"""tpu_sparse_torch — the PyTorch / NVIDIA H100 port of ``tpu_sparse``.

Ported so far: DIA/CSR/COO containers and generators; the CWELL pack of
general matrices and ``to_gpu_operator``; the Krylov core (CG, BiCGStab,
GMRES with no preconditioner or Jacobi) with mixed-precision refinement and
the adjoint gradient; the ``SparseSolver`` / ``solve`` router with
``reorder="rcm"``; hand-written CUDA kernels for the DIA SpMV, the fused CG
iteration, the fused BiCGStab iteration and the CWELL SpMV
(``tpu_sparse_torch/csrc``). The package
imports ``torch`` and never ``jax``; on CPU tensors every kernel runs its
plain PyTorch version. Entry points that build matrices default to the
card (``device="cuda"``).
"""

from tpu_sparse_torch import autodiff, config, kernels, sparse, utils
from tpu_sparse_torch.api import SolverResult, SparseSolver, solve
from tpu_sparse_torch.autodiff import bicgstab_diff, cg_diff, gmres_diff
from tpu_sparse_torch.solvers import bicgstab, cg, gmres
from tpu_sparse_torch.sparse import (COO, CSR, CWELL, DIA, CWELLSeg,
                                     csr_to_cwell, to_gpu_operator)

__version__ = "0.3.0"

__all__ = [
    "autodiff", "config", "kernels", "sparse", "utils",
    "COO", "CSR", "CWELL", "CWELLSeg", "DIA", "csr_to_cwell",
    "to_gpu_operator",
    "bicgstab", "cg", "gmres",
    "bicgstab_diff", "cg_diff", "gmres_diff",
    "SparseSolver", "SolverResult", "solve",
]
