"""Krylov solves with the adjoint gradient, and the extended-layout runs."""

from tpu_sparse_torch.autodiff.implicit import (bicgstab_diff, cg_diff,
                                                ext_krylov_diff,
                                                ext_krylov_diff_f64, ext_run,
                                                ext_run_f64, gmres_diff)

__all__ = ["bicgstab_diff", "cg_diff", "ext_krylov_diff",
           "ext_krylov_diff_f64", "ext_run", "ext_run_f64", "gmres_diff"]
