"""Krylov solvers (CG, BiCGStab, GMRES) and mixed-precision refinement."""

from tpu_sparse_torch.solvers.krylov import (bicgstab, bicgstab_full, cg,
                                             cg_full, gmres, gmres_full)
from tpu_sparse_torch.solvers.mixed import (bicgstab_refined, cg_refined,
                                            gmres_refined, refined_solve)

__all__ = ["bicgstab", "bicgstab_full", "bicgstab_refined", "cg", "cg_full",
           "cg_refined", "gmres", "gmres_full", "gmres_refined",
           "refined_solve"]
