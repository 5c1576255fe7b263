"""Krylov solvers (CG, single-reduction CG, flexible CG, MINRES,
BiCGStab, GMRES, flexible GMRES), mixed-precision refinement, and the
multi-RHS solvers (batched, block, and the direct ``batch_direct``)."""

from tpu_sparse_torch.solvers.batched import (batch_bicgstab, batch_cg,
                                              batch_direct, batch_fcg,
                                              batch_fgmres, batch_gmres,
                                              batch_minres)
from tpu_sparse_torch.solvers.block import block_cg
from tpu_sparse_torch.solvers.fcg import fcg, fcg_full
from tpu_sparse_torch.solvers.fgmres import fgmres, fgmres_full
from tpu_sparse_torch.solvers.krylov import (bicgstab, bicgstab_full, cg,
                                             cg_full, gmres, gmres_full)
from tpu_sparse_torch.solvers.minres import minres, minres_full
from tpu_sparse_torch.solvers.mixed import (batch_refined, bicgstab_refined,
                                            cg_refined, cg_sr_refined,
                                            fcg_refined, fgmres_refined,
                                            gmres_refined, minres_refined,
                                            refined_solve)
from tpu_sparse_torch.solvers.pipelined import cg_sr, cg_sr_full


def cg_differentiable(A, b, **kwargs):
    """CG with the adjoint gradient under the reference's name
    (``cg_differentiable``); returns (x, info)."""
    from tpu_sparse_torch.autodiff import cg_diff

    out = cg_diff(A, b, **kwargs)
    return out[0], out[1]


def bicgstab_differentiable(A, b, **kwargs):
    from tpu_sparse_torch.autodiff import bicgstab_diff

    out = bicgstab_diff(A, b, **kwargs)
    return out[0], out[1]


def gmres_differentiable(A, b, **kwargs):
    from tpu_sparse_torch.autodiff import gmres_diff

    out = gmres_diff(A, b, **kwargs)
    return out[0], out[1]


__all__ = [
    "cg", "bicgstab", "gmres", "cg_full", "bicgstab_full", "gmres_full",
    "fcg", "fcg_full", "fgmres", "fgmres_full",
    "minres", "minres_full",
    "cg_sr", "cg_sr_full",
    "cg_refined", "bicgstab_refined", "gmres_refined", "refined_solve",
    "cg_sr_refined", "minres_refined", "fcg_refined", "fgmres_refined",
    "batch_cg", "batch_bicgstab", "batch_gmres", "batch_minres",
    "batch_direct",
    "batch_refined",
    "batch_fcg", "batch_fgmres",
    "block_cg",
    "cg_differentiable", "bicgstab_differentiable", "gmres_differentiable",
]
