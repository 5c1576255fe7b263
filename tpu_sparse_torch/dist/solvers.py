"""Distributed Krylov solves over a row-partitioned ``RowMesh``.

Counterpart of ``tpu_sparse/dist/solvers.py``. The solvers are the port's
single-device loops (``krylov._cg_loop``, ``_bicgstab_loop``,
``_gmres_restarts``, ``pipelined._cg_sr_loop``, ``minres._minres_loop``,
``block.block_cg``) run on every rank over its own rows, with a
distributed matvec (``dist.spmv``) and all-reduced reductions: each dot
product is the local one followed by one ``all_reduce(SUM)`` of a 0-d
tensor, a (k,) or (k, k) tensor for block CG, the (k + 1,) projection of
a GMRES Gram-Schmidt pass, and the stacked [<r,u>, <w,u>(, <r,r>)] of
single-reduction CG (``pipeline=True``: one round per iteration). The
all-reduced scalars are identical on every rank, so every rank's host
read of the loop condition takes the same branch.

Modes. ``halo``: DIA operands exchange w-wide boundary strips (degrading
to ``allgather`` when the bandwidth passes the shard); general operands
(CSR, COO, BSR, CWELL, ...) row-shard as CWELL blocks with a halo plan
from the whole pack (``cwell_halo``), or gather x when the partition has
no column locality (``cwell_allgather``). ``allgather``: gather x always.
``gspmd``, JAX's default, hands sharded operands to XLA's SPMD
partitioner, which inserts the collective-permutes and all-reduces
itself. PyTorch has no partitioner to call, so ``gspmd`` takes the
explicit halo route, whose collectives are the ones GSPMD inserts.

The solves return this rank's rows of x (those below b's length: the
rank's shard of JAX's ``x[:n]``), the info code, the iterations and the
residual norm, the last three identical on every rank;
``partition.gather_vector`` assembles the whole x. Preconditioners: a
Jacobi ``DiagonalPreconditioner`` of the whole matrix is cut to the rank's
rows, a single-device ``AMGPreconditioner`` has its hierarchy row-sharded
(``dist.amg``), a ``DistributedAMGPreconditioner`` runs as it is, and any
other callable is applied to the gathered vector (each rank keeping its
rows). As in JAX, a preconditioned solve needs n divisible by the world
size times the pad unit.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from tpu_sparse_torch.dist.mesh import RowMesh, make_row_mesh
from tpu_sparse_torch.dist.partition import (ShardedDIA, own_rows, shard_dia,
                                             shard_general_planned,
                                             shard_vector)
from tpu_sparse_torch.dist.spmv import (make_allgather_spmv,
                                        make_cwell_allgather_spmv,
                                        make_cwell_halo_spmv, make_halo_spmv)
from tpu_sparse_torch.sparse.containers import DIA
from tpu_sparse_torch.sparse.cwell import LW
from tpu_sparse_torch.utils.opcache import OperandCache
from tpu_sparse_torch.utils.tree import tree_vdot, tree_vdot_real

MODES = ("gspmd", "halo", "allgather")


def _vector_unit(A) -> int:
    """Vector pad granularity: CWELL row blocks are 128 rows tall, so
    general systems pad to world_size * 128; DIA pads to world_size."""
    return 1 if isinstance(A, DIA) else LW


def _check_precond_divisible(n: int, mesh: RowMesh, M, unit: int = 1
                             ) -> None:
    if M is not None and n % (mesh.world_size * unit) != 0:
        raise ValueError(
            f"preconditioned distributed solves need n ({n}) divisible by "
            f"mesh size x pad unit ({mesh.world_size}x{unit}): the "
            f"identity padding would not match the preconditioner's "
            f"dimension")


class DistributedOperator:
    """x_local -> this rank's rows of A x, for a vector or an (s, k) block
    (``matmat`` is the same function, so ``as_matmat`` takes it whole)."""

    def __init__(self, A_sh, mode: str, fn: Callable):
        self.A_sh = A_sh
        self.mode = mode
        self.fn = fn

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)

    matmat = __call__

    def __repr__(self):
        return f"DistributedOperator({self.A_sh!r}, mode={self.mode!r})"


def dia_matvec(A_sh: ShardedDIA, mesh: RowMesh, mode: str = "halo"
               ) -> DistributedOperator:
    """The DIA SpMV of ``mode`` ("halo" or "allgather"); halo degrades to
    allgather when the bandwidth passes the shard."""
    if mode == "halo" and max(A_sh.bandwidth, 1) > A_sh.rows:
        mode = "allgather"
    fn = make_halo_spmv(A_sh, mesh) if mode == "halo" \
        else make_allgather_spmv(A_sh, mesh)
    return DistributedOperator(A_sh, mode, fn)


_resolve_cache = OperandCache(max_entries=4)


def _matvec_builder(A_sh, mesh: RowMesh, mode: str) -> DistributedOperator:
    """The distributed SpMV of an already-sharded operator and resolved
    mode."""
    if mode == "cwell_halo":
        return DistributedOperator(A_sh, mode,
                                   make_cwell_halo_spmv(A_sh, mesh))
    if mode == "cwell_allgather":
        return DistributedOperator(A_sh, mode,
                                   make_cwell_allgather_spmv(A_sh, mesh))
    return dia_matvec(A_sh, mesh, mode)


def _shard_and_resolve(A, mesh: RowMesh, mode: str):
    """Shard A over the mesh and resolve the effective SpMV mode: returns
    ``(A_sharded, mode, operator)``, cached per (matrix content, mesh,
    mode) so that repeated solves on one operand shard and pack once.

    DIA: ``halo`` (``gspmd`` too) degrades to ``allgather`` when the
    bandwidth exceeds the shard. General operators: ``cwell_halo`` when
    the whole pack has a halo plan and the mode is not ``allgather``,
    else ``cwell_allgather``."""
    if mode not in MODES:
        raise ValueError(f"unknown mode: {mode!r}; expected one of {MODES}")

    def build():
        if isinstance(A, DIA):
            A_sh = shard_dia(A, mesh)
            op = dia_matvec(A_sh, mesh,
                            "allgather" if mode == "allgather" else "halo")
            return A_sh, op.mode, op
        W_sh, plan = shard_general_planned(A, mesh)
        if mode != "allgather" and plan is not None:
            A_sh, rmode = plan, "cwell_halo"
        else:
            A_sh, rmode = W_sh, "cwell_allgather"
        return A_sh, rmode, _matvec_builder(A_sh, mesh, rmode)

    return _resolve_cache.get_or_build(A, build, extra=(mesh, mode))


def distributed_matvec_op(A, mesh: Optional[RowMesh] = None,
                          mode: str = "gspmd"):
    """Shard A and return ``(A_sharded, matvec)`` for the chosen mode (see
    ``_shard_and_resolve``); the matvec maps this rank's rows of x (or of
    an (n, k) block) to its rows of A x."""
    mesh = make_row_mesh() if mesh is None else mesh
    A_sh, _, op = _shard_and_resolve(A, mesh, mode)
    return A_sh, op


class _Reductions:
    """The solvers' reductions over the mesh: local dot products, then one
    all-reduce each."""

    def __init__(self, mesh: RowMesh):
        self.allreduce = mesh.all_reduce

    def vdot(self, a, b):
        return self.allreduce(tree_vdot(a, b))

    def vdot_real(self, a, b):
        return self.allreduce(tree_vdot_real(a, b))

    def vdots_real(self, pairs):
        """Several dot products in one all-reduce."""
        local = torch.stack([tree_vdot_real(a, b) for a, b in pairs])
        return list(self.allreduce(local).unbind())

    def norm(self, v):
        return torch.sqrt(self.vdot_real(v, v))


_precond_cache = OperandCache(max_entries=4)


def _local_preconditioner(M, mesh: RowMesh, unit: int):
    """M on this rank's rows (see the module docstring)."""
    from tpu_sparse_torch.dist.amg import (DistributedAMGPreconditioner,
                                           shard_amg_hierarchy)
    from tpu_sparse_torch.precond.amg import AMGPreconditioner
    from tpu_sparse_torch.precond.jacobi import DiagonalPreconditioner

    if M is None or isinstance(M, DistributedAMGPreconditioner):
        return M
    if isinstance(M, DiagonalPreconditioner):
        return DiagonalPreconditioner(shard_vector(M.dinv, mesh, unit))
    if isinstance(M, AMGPreconditioner):
        return _precond_cache.get_or_build(
            M, lambda: DistributedAMGPreconditioner(
                shard_amg_hierarchy(M.hier, mesh), M.pre_sweeps,
                M.post_sweeps, M.omega, M.smoother), extra=(mesh,))
    if not callable(M):
        raise TypeError(f"unsupported preconditioner type: {type(M)}")

    def apply_gathered(v):
        s = v.shape[0]
        return M(mesh.all_gather(v))[mesh.rank * s:(mesh.rank + 1) * s]

    return apply_gathered


def _setup(A, b, x0, mesh, mode, M):
    """The shared preamble: shard A, b and x0; resolve M on the rank's
    rows. Returns (mesh, op, b_local, x0_local, M_local, n_pad, rows to
    keep)."""
    mesh = make_row_mesh() if mesh is None else mesh
    mesh.check(b)
    if x0 is not None:
        mesh.check(x0)
    n_orig = b.shape[0]
    unit = _vector_unit(A)
    _check_precond_divisible(n_orig, mesh, M, unit)
    A_sh, _, op = _shard_and_resolve(A, mesh, mode)
    b_l = shard_vector(b, mesh, unit)
    x0_l = torch.zeros_like(b_l) if x0 is None \
        else shard_vector(x0, mesh, unit)
    M_l = _local_preconditioner(M, mesh, unit)
    return (mesh, op, b_l, x0_l, M_l, A_sh.shape[0],
            own_rows(n_orig, mesh, unit))


def distributed_cg(A, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
                   *, mesh: Optional[RowMesh] = None, mode: str = "gspmd",
                   tol: float = 1e-6, atol: float = 0.0,
                   maxiter: Optional[int] = None, M=None,
                   pipeline: bool = False):
    """CG on a row-partitioned system. Returns ``(x_rows, info, iters,
    res)``, x_rows this rank's rows of x.

    ``pipeline=True`` runs the single-reduction Chronopoulos-Gear
    recurrence (``solvers.pipelined``): one all-reduce of the three stacked
    dot products per iteration instead of two dependent rounds, the trade
    to make when reduction latency bounds scaling."""
    from tpu_sparse_torch.solvers.krylov import (_cg_loop, _final_check,
                                                 _identity, _thresholds)
    from tpu_sparse_torch.solvers.pipelined import _cg_sr_loop

    mesh, op, b_l, x0_l, M_l, n_pad, keep = _setup(A, b, x0, mesh, mode, M)
    red = _Reductions(mesh)
    maxiter = 10 * n_pad if maxiter is None else int(maxiter)
    M_fn = _identity if M_l is None else M_l
    bs, atol_t, atol2 = _thresholds(b_l, tol, atol, red.vdot_real)
    if pipeline:
        x, k = _cg_sr_loop(op, M_fn, b_l, x0_l, atol2, maxiter, M_l is None,
                           vdot_real=red.vdot_real,
                           vdots_real=red.vdots_real)
    else:
        x, k = _cg_loop(op, M_fn, b_l, x0_l, atol2, maxiter, M_l is None,
                        vdot_real=red.vdot_real)
    info, res = _final_check(op, b_l, x, bs, atol_t, tol, red.norm)
    return x[:keep], info, k, res


def distributed_bicgstab(A, b: torch.Tensor,
                         x0: Optional[torch.Tensor] = None, *,
                         mesh: Optional[RowMesh] = None, mode: str = "gspmd",
                         tol: float = 1e-6, atol: float = 0.0,
                         maxiter: Optional[int] = None, M=None):
    """BiCGStab on a row-partitioned system (info -10 / -11 on breakdown,
    as ``bicgstab_full``)."""
    from tpu_sparse_torch.solvers.krylov import (_bicgstab_loop,
                                                 _final_check, _identity,
                                                 _thresholds)

    mesh, op, b_l, x0_l, M_l, n_pad, keep = _setup(A, b, x0, mesh, mode, M)
    red = _Reductions(mesh)
    maxiter = 10 * n_pad if maxiter is None else int(maxiter)
    bs, atol_t, atol2 = _thresholds(b_l, tol, atol, red.vdot_real)
    x, k = _bicgstab_loop(op, _identity if M_l is None else M_l, b_l, x0_l,
                          atol2, maxiter, vdot=red.vdot,
                          vdot_real=red.vdot_real)
    info, res = _final_check(op, b_l, x, bs, atol_t, tol, red.norm)
    info = torch.where(k < 0, k, info).to(torch.int32)
    return x[:keep], info, k, res


def distributed_gmres(A, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
                      *, mesh: Optional[RowMesh] = None, mode: str = "gspmd",
                      tol: float = 1e-6, atol: float = 0.0,
                      restart: int = 20, maxiter: Optional[int] = None,
                      M=None, solve_method: str = "batched"):
    """GMRES on a row-partitioned system: the Krylov basis holds this
    rank's rows; each Gram-Schmidt pass all-reduces its projection."""
    from tpu_sparse_torch.solvers.krylov import (_gmres_batched,
                                                 _gmres_incremental,
                                                 _gmres_restarts)

    if solve_method not in ("batched", "incremental"):
        raise ValueError(f"unsupported solve_method: {solve_method}")
    cycle_fn = _gmres_batched if solve_method == "batched" \
        else _gmres_incremental
    mesh, op, b_l, x0_l, M_l, n_pad, keep = _setup(A, b, x0, mesh, mode, M)
    maxiter = 10 * n_pad if maxiter is None else int(maxiter)
    x, info, k, res = _gmres_restarts(
        op, b_l, x0_l, tol, atol, min(restart, n_pad), maxiter, M_l,
        cycle_fn, left=True, allreduce=mesh.all_reduce)
    return x[:keep], info, k, res


def distributed_block_cg(A, B: torch.Tensor,
                         X0: Optional[torch.Tensor] = None, *,
                         mesh: Optional[RowMesh] = None, mode: str = "gspmd",
                         tol: float = 1e-6, atol: float = 0.0,
                         maxiter: Optional[int] = None, M=None):
    """Block CG with the (n, k) right-hand side split by rows: one
    distributed SpMM per iteration (the same strips k columns wide; K6 /
    K7 locally on a CWELL), the k x k Gram products all-reduced. The
    identity-padded rows carry zero right-hand sides, so the per-column
    norms and convergence do not change."""
    from tpu_sparse_torch.solvers.block import block_cg

    mesh, op, B_l, X0_l, M_l, n_pad, keep = _setup(A, B, X0, mesh, mode, M)
    maxiter = 10 * n_pad if maxiter is None else int(maxiter)
    X, infos, k, res = block_cg(op, B_l, X0_l, tol=tol, atol=atol,
                                maxiter=maxiter, M=M_l,
                                allreduce=mesh.all_reduce)
    return X[:keep], infos, k, res


def distributed_minres(A, b: torch.Tensor,
                       x0: Optional[torch.Tensor] = None, *,
                       mesh: Optional[RowMesh] = None, mode: str = "gspmd",
                       tol: float = 1e-6, atol: float = 0.0,
                       maxiter: Optional[int] = None, M=None):
    """MINRES on a row-partitioned symmetric (possibly indefinite)
    system; the Lanczos vectors hold this rank's rows."""
    from tpu_sparse_torch.solvers.krylov import (_final_check, _identity,
                                                 _thresholds)
    from tpu_sparse_torch.solvers.minres import _minres_loop

    mesh, op, b_l, x0_l, M_l, n_pad, keep = _setup(A, b, x0, mesh, mode, M)
    red = _Reductions(mesh)
    maxiter = 10 * n_pad if maxiter is None else int(maxiter)
    bs, atol_t, _ = _thresholds(b_l, tol, atol, red.vdot_real)
    atol_norm = torch.maximum(tol * torch.sqrt(bs), atol_t)
    x, k = _minres_loop(op, _identity if M_l is None else M_l, b_l, x0_l,
                        atol_norm, maxiter, vdot_real=red.vdot_real)
    info, res = _final_check(op, b_l, x, bs, atol_t, tol, red.norm)
    return x[:keep], info, k, res


__all__ = ["distributed_matvec_op", "distributed_cg", "distributed_bicgstab",
           "distributed_gmres", "distributed_block_cg", "distributed_minres",
           "DistributedOperator", "dia_matvec"]
