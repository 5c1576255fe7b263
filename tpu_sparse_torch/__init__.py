"""tpu_sparse_torch — the PyTorch / NVIDIA H100 port of ``tpu_sparse``.

This slice ports the stencil-CG main path: DIA/CSR/COO containers and
generators, CG (no preconditioner or Jacobi) with mixed-precision
refinement, and the ``SparseSolver`` / ``solve`` router, with hand-written
CUDA kernels for the DIA SpMV and the fused CG iteration
(``tpu_sparse_torch/csrc``). The package imports ``torch`` and never
``jax``; on CPU tensors every kernel runs its plain PyTorch version.
"""

from tpu_sparse_torch import config, kernels, sparse, utils
from tpu_sparse_torch.api import SolverResult, SparseSolver, solve
from tpu_sparse_torch.solvers import cg
from tpu_sparse_torch.sparse import COO, CSR, DIA

__version__ = "0.1.0"

__all__ = [
    "config", "kernels", "sparse", "utils",
    "COO", "CSR", "DIA",
    "cg",
    "SparseSolver", "SolverResult", "solve",
]
