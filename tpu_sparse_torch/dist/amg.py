"""Distributed AMG: a row-sharded hierarchy over a ``RowMesh``.

Counterpart of ``tpu_sparse/dist/amg.py``. The set-up is the port's
``amg_setup`` on the host, run identically on every rank; the hierarchy is
then cut by rows:

* a level whose row count divides the world size is row-sharded: its A by
  its rows (a DIA as a ``ShardedDIA`` with the halo / all_gather SpMV of
  ``dist.spmv``, kernel 1 in extended mode on the card; any other format
  as this rank's rows packed as CWELL, K4 / K5 on the card, applied to the
  gathered vector), its ``dinv_l1`` with its rows;
* P and R are cut by their output rows and applied to their gathered
  input vector, as GSPMD gathers for the window reads; the tentative
  prolongator ``TentativeP`` keeps its rows' ``agg`` and gathers from the
  gathered coarse vector;
* a level whose rows do not divide the world size, and the dense
  ``coarse_inv``, stay whole on every rank: a sharded input is gathered,
  the product computed on every rank, and a sharded output keeps the
  rank's rows.

The cycle is the port's ``precond.amg.v_cycle`` with a distributed
``product=``: every level vector is this rank's rows when its level is
sharded, the whole vector otherwise. Halo plans for R / P in place of the
all_gathers are ROADMAP queue 2c's.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_sparse_torch.dist.mesh import RowMesh, make_row_mesh
from tpu_sparse_torch.dist.partition import ShardedDIA
from tpu_sparse_torch.precond.amg import (AMGHierarchy, AMGLevel, TentativeP,
                                          _product, amg_setup, v_cycle)
from tpu_sparse_torch.sparse.containers import DIA


class ShardedLevelOp:
    """A level operator cut by rows. ``local`` maps the whole input vector
    to this rank's output rows (``out_sharded``) or to all of them;
    ``in_sharded`` says the input arrives as this rank's rows and is
    gathered first; ``matvec``, when set, is the distributed SpMV that
    takes the rank's rows directly (square sharded DIA levels)."""

    def __init__(self, local, shape, in_sharded: bool, out_sharded: bool,
                 mesh: RowMesh, matvec=None):
        self.local = local
        self.shape = tuple(int(v) for v in shape)
        self.in_sharded = bool(in_sharded)
        self.out_sharded = bool(out_sharded)
        self.mesh = mesh
        self.matvec = matvec

    @property
    def dtype(self):
        loc = self.local
        if isinstance(loc, torch.Tensor):
            return loc.dtype
        if isinstance(loc, TentativeP):
            return loc.vals.dtype
        return loc.dtype

    def __repr__(self):
        return (f"ShardedLevelOp(shape={self.shape}, "
                f"local={type(self.local).__name__}, in_sharded="
                f"{self.in_sharded}, out_sharded={self.out_sharded})")


def dist_product(op, x: torch.Tensor) -> torch.Tensor:
    """The V-cycle's product for a ``ShardedLevelOp``: this rank's rows
    (or the whole) of op @ x, x a vector or an (n, k) block."""
    if op.matvec is not None:
        return op.matvec(x)
    x_in = op.mesh.all_gather(x) if op.in_sharded else x
    loc = op.local
    if isinstance(loc, torch.Tensor):  # dense level or coarse_inv
        return (loc @ x_in.to(loc.dtype)).to(x.dtype)
    return _product(loc, x_in)


def _rows(op, i0: int, i1: int, device: torch.device):
    """Rows [i0, i1) of a level operator, on ``device``: a dense slice, a
    ``TentativeP`` with those rows' entries, else those rows of the CSR
    packed as CWELL."""
    from tpu_sparse_torch.sparse.convert import csr_from_arrays, to_scipy_csr
    from tpu_sparse_torch.sparse.cwell import csr_to_cwell

    if isinstance(op, torch.Tensor):
        return op[i0:i1].to(device).contiguous()
    if isinstance(op, TentativeP):
        return TentativeP(op.vals[i0:i1].to(device),
                          op.agg[i0:i1].to(device), (i1 - i0, op.shape[1]))
    S = to_scipy_csr(op)[i0:i1]
    return csr_to_cwell(csr_from_arrays(S.data, S.indices, S.indptr, S.shape,
                                        device=device))


def _shard_op(op, mesh: RowMesh, square: bool) -> ShardedLevelOp:
    from tpu_sparse_torch.dist.solvers import dia_matvec

    n_out, n_in = op.shape
    nd = mesh.world_size
    out_sh, in_sh = n_out % nd == 0, n_in % nd == 0
    if not out_sh:
        return ShardedLevelOp(op.to(mesh.device), op.shape, in_sh,
                              False, mesh)
    s = n_out // nd
    i0, i1 = mesh.rank * s, (mesh.rank + 1) * s
    if square and isinstance(op, DIA):
        A_sh = ShardedDIA(op.data[:, i0:i1].to(mesh.device).contiguous(),
                          op.offsets, op.shape, i0)
        return ShardedLevelOp(A_sh, op.shape, True, True, mesh,
                              matvec=dia_matvec(A_sh, mesh))
    return ShardedLevelOp(_rows(op, i0, i1, mesh.device), op.shape, in_sh,
                          True, mesh)


def shard_amg_hierarchy(hier: AMGHierarchy, mesh: RowMesh) -> AMGHierarchy:
    """The hierarchy cut by rows over the mesh (see the module docstring);
    its operators are ``ShardedLevelOp``s for ``dist_product``."""
    nd = mesh.world_size
    levels = []
    for lvl in hier.levels:
        n = lvl.A.shape[0]
        dinv = lvl.dinv_l1
        if n % nd == 0:
            s = n // nd
            dinv = dinv[mesh.rank * s:(mesh.rank + 1) * s]
        levels.append(AMGLevel(
            A=_shard_op(lvl.A, mesh, square=True),
            P=_shard_op(lvl.P, mesh, square=False),
            R=_shard_op(lvl.R, mesh, square=False),
            dinv_l1=dinv.to(mesh.device).contiguous()))
    return AMGHierarchy(levels, _shard_op(hier.coarse_inv, mesh,
                                          square=False))


class DistributedAMGPreconditioner:
    """M ~ A^-1 as one V-cycle of a row-sharded hierarchy, on this rank's
    rows of a vector or an (s, k) block (``matmat``)."""

    def __init__(self, hier: AMGHierarchy, pre_sweeps: int = 1,
                 post_sweeps: int = 1, omega: float = 0.9,
                 smoother: str = "l1_jacobi"):
        self.hier = hier
        self.pre_sweeps = int(pre_sweeps)
        self.post_sweeps = int(post_sweeps)
        self.omega = float(omega)
        self.smoother = smoother

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return v_cycle(self.hier, v, pre_sweeps=self.pre_sweeps,
                       post_sweeps=self.post_sweeps, omega=self.omega,
                       smoother=self.smoother, product=dist_product)

    matmat = __call__

    def __repr__(self):
        return (f"DistributedAMGPreconditioner({self.hier!r}, "
                f"V({self.pre_sweeps},{self.post_sweeps}))")


def distributed_amg_preconditioner(A, mesh: Optional[RowMesh] = None, *,
                                   pre_sweeps: int = 1, post_sweeps: int = 1,
                                   omega: float = 0.9,
                                   smoother: str = "l1_jacobi",
                                   **setup_kwargs
                                   ) -> DistributedAMGPreconditioner:
    """Host AMG set-up (the same on every rank) and the row-sharded
    hierarchy; returns a V-cycle usable as ``M=`` in the distributed
    solvers."""
    mesh = make_row_mesh() if mesh is None else mesh
    hier = shard_amg_hierarchy(amg_setup(A, **setup_kwargs), mesh)
    return DistributedAMGPreconditioner(hier, pre_sweeps, post_sweeps, omega,
                                        smoother)


__all__ = ["ShardedLevelOp", "dist_product", "shard_amg_hierarchy",
           "DistributedAMGPreconditioner", "distributed_amg_preconditioner"]
