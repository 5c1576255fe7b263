"""Preconditioners: Jacobi, L1-Jacobi, aggregation AMG, Chebyshev, Neumann,
ILU(0) and FSAI (the JAX ``tpu_sparse.precond`` names)."""

from tpu_sparse_torch.precond.amg import (AMGHierarchy, AMGLevel,
                                          AMGPreconditioner, TentativeP,
                                          amg_hierarchy_from_numpy,
                                          amg_preconditioner, amg_setup,
                                          amg_solve, amg_stationary_solve,
                                          v_cycle)
from tpu_sparse_torch.precond.fsai import (FSAIPreconditioner,
                                           fsai_preconditioner, fsai_setup)
from tpu_sparse_torch.precond.jacobi import (DiagonalPreconditioner, diagonal,
                                             jacobi_preconditioner,
                                             l1_jacobi_diag)
from tpu_sparse_torch.precond.poly import (ChebyshevPreconditioner,
                                           ILU0Preconditioner,
                                           NeumannPreconditioner,
                                           chebyshev_preconditioner,
                                           ilu0_factor, ilu0_preconditioner,
                                           neumann_preconditioner)

__all__ = [
    "DiagonalPreconditioner", "diagonal", "jacobi_preconditioner",
    "l1_jacobi_diag",
    "AMGHierarchy", "AMGLevel", "AMGPreconditioner", "TentativeP",
    "amg_hierarchy_from_numpy", "amg_preconditioner", "amg_setup",
    "amg_solve", "amg_stationary_solve", "v_cycle",
    "ChebyshevPreconditioner", "ILU0Preconditioner",
    "NeumannPreconditioner",
    "chebyshev_preconditioner", "ilu0_factor", "ilu0_preconditioner",
    "neumann_preconditioner",
    "FSAIPreconditioner", "fsai_preconditioner", "fsai_setup",
]
