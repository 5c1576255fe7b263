"""Solver router and capability report."""

from tpu_sparse_torch.api.solver import (SolverResult, SparseSolver, bicgstab,
                                         cg, gmres, solve)

__all__ = ["SolverResult", "SparseSolver", "bicgstab", "cg", "gmres",
           "solve"]
