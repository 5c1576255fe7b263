"""Krylov solves with the adjoint gradient."""

from tpu_sparse_torch.autodiff.implicit import (bicgstab_diff, cg_diff,
                                                cg_sr_diff, ext_krylov_diff,
                                                ext_krylov_diff_f64, fcg_diff,
                                                fgmres_diff, gmres_diff,
                                                minres_diff)

__all__ = ["cg_diff", "cg_sr_diff", "fcg_diff", "bicgstab_diff",
           "gmres_diff", "fgmres_diff", "minres_diff", "ext_krylov_diff",
           "ext_krylov_diff_f64"]
