"""Krylov solvers (CG, BiCGStab, GMRES), mixed-precision refinement, and
the multi-RHS solvers (batched and block)."""

from tpu_sparse_torch.solvers.batched import (batch_bicgstab, batch_cg,
                                              batch_fcg, batch_fgmres,
                                              batch_gmres, batch_minres)
from tpu_sparse_torch.solvers.block import block_cg
from tpu_sparse_torch.solvers.krylov import (bicgstab, bicgstab_full, cg,
                                             cg_full, gmres, gmres_full)
from tpu_sparse_torch.solvers.mixed import (batch_refined, bicgstab_refined,
                                            cg_refined, gmres_refined,
                                            refined_solve)

__all__ = ["batch_bicgstab", "batch_cg", "batch_fcg", "batch_fgmres",
           "batch_gmres", "batch_minres", "batch_refined", "bicgstab",
           "bicgstab_full", "bicgstab_refined", "block_cg", "cg", "cg_full",
           "cg_refined", "gmres", "gmres_full", "gmres_refined",
           "refined_solve"]
