"""Krylov solvers (CG) and mixed-precision refinement."""

from tpu_sparse_torch.solvers.krylov import cg, cg_full
from tpu_sparse_torch.solvers.mixed import cg_refined, refined_solve

__all__ = ["cg", "cg_full", "cg_refined", "refined_solve"]
