"""tpu_sparse_torch — the PyTorch / NVIDIA H100 port of ``tpu_sparse``.

Ported: DIA/CSR/COO/BSR containers and generators; the CWELL pack
of general matrices, the BELL (block-ELL) format and ``to_gpu_operator``;
the Krylov solvers (CG, single-reduction CG, flexible CG, MINRES,
BiCGStab, GMRES, flexible GMRES) with mixed-precision refinement and the
adjoint gradient, for matrices and matrix-free callables; multi-RHS
solves (each method batched, block CG, batched refinement); the
preconditioners (Jacobi, aggregation AMG, Chebyshev, Neumann, FSAI,
ILU(0)) and the
``amg`` backend; the direct solvers (banded, dense, SparseLU and the
supernodal level-scheduled LU) and the ``direct`` backend; the
``SparseSolver`` / ``solve`` router with ``reorder="rcm"``; the
lid-driven-cavity application (``python -m tpu_sparse_torch.apps.ldc``);
the row-partitioned solvers over several cards (``dist``); the tooling:
the benchmark harness (``bench``), ``python -m tpu_sparse_torch.run``,
checkpoints and timing (``utils``), the Poisson and inverse-problem demos
(``apps``); hand-written
CUDA kernels for the DIA SpMV, the fused CG iteration, the fused BiCGStab
iteration, the CWELL SpMV and SpMM and the BELL SpMM
(``tpu_sparse_torch/csrc``). The package
imports ``torch`` and never ``jax``; on CPU tensors every kernel runs its
plain PyTorch version. Entry points that build matrices default to the
card (``device="cuda"``).
"""

from tpu_sparse_torch import (autodiff, config, direct, kernels, precond,
                              sparse, tracing, utils)
from tpu_sparse_torch.api import SolverResult, SparseSolver, solve
from tpu_sparse_torch.autodiff import (bicgstab_diff, cg_diff, cg_sr_diff,
                                       fcg_diff, fgmres_diff, gmres_diff,
                                       minres_diff)
from tpu_sparse_torch.solvers import (batch_bicgstab, batch_cg, batch_fcg,
                                      batch_fgmres, batch_gmres,
                                      batch_minres, bicgstab, block_cg, cg,
                                      cg_sr, fcg, fgmres, gmres, minres)
from tpu_sparse_torch.sparse import (BELL, BSR, COO, CSR, CWELL, DIA,
                                     CWELLSeg, bsr_to_bell, csr_to_bsr,
                                     csr_to_cwell, to_gpu_operator)

__version__ = "0.5.0"

__all__ = [
    "autodiff", "config", "direct", "kernels", "precond", "sparse",
    "tracing", "utils",
    "BELL", "BSR", "COO", "CSR", "CWELL", "CWELLSeg", "DIA", "bsr_to_bell",
    "csr_to_bsr", "csr_to_cwell", "to_gpu_operator",
    "batch_bicgstab", "batch_cg", "batch_fcg", "batch_fgmres",
    "batch_gmres", "batch_minres", "bicgstab", "block_cg", "cg", "cg_sr",
    "fcg", "fgmres", "gmres", "minres",
    "bicgstab_diff", "cg_diff", "cg_sr_diff", "fcg_diff", "fgmres_diff",
    "gmres_diff", "minres_diff",
    "SparseSolver", "SolverResult", "solve",
]
