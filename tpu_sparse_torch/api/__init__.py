"""Solver router and capability report."""

from tpu_sparse_torch.api.solver import SolverResult, SparseSolver, cg, solve

__all__ = ["SolverResult", "SparseSolver", "cg", "solve"]
