"""Which runner takes a DIA solve on the card, and the extended runners.

The one owner of the choice that the router (``api/solver.py``) and the
refinement's sweeps (``solvers/mixed.py``) both make. ``runner(method, A,
b, M, tol)`` answers ``ext_run``, ``ext_run_f64`` or None, where None
means the method's loop on the operand as it is (on the card every matvec
of a DIA is then kernel 1's plain mode). The rule, that of the JAX router
(:399-423):

* a DIA and a b on the card (``_on_card``, the one device test of the
  choice, so that a CPU test can stand in for the card by patching it)
  that the extended layout takes (square, at least one diagonal,
  bandwidth below n), with M None or a ``DiagonalPreconditioner`` (unit
  margins keep the zero-margin invariant), and a method with an extended
  fast path: cg, bicgstab or gmres;
* ``ext_run`` for the (data, b) dtypes in ``_PAIRS``;
* ``ext_run_f64`` for float64 data and b at tol >= 1e-11.

``sweep_runner(inner_solver, A, rhs, M)`` answers for one sweep of a
refinement (A d = rhs from zero), with the same eligibility (``_takes``)
for an inner solver that is a named method's loop and a float32 or bf16
sweep: a float32 CG sweep runs ``ext_run``, so the fused CG kernels 2-3,
which ``refine.fused_sweeps`` counts; every other sweep runs
``ext_loop``, the method's loop over kernel 1's extended mode. It differs
from ``runner`` twice, on H100 measurements:

* a float32 BiCGStab sweep with no M runs the loop, not K10. K10 makes a
  refined solve 3.3-6.5x faster (24^3-128^3 convection-diffusion), but
  its first sweep leaves another defect than the loop's (BiCGStab's
  residual is erratic near the float32 floor, and rounding alone moves
  a sweep's stop by 1-2), so on convection_diffusion_3d_27pt(24) the
  card's refined count is 53 against the CPU loop's 47, where the card
  tests allow 2; that choice is left open;
* cg_sr / fcg / minres / fgmres sweeps run over the extended operator,
  where the router's solve runs the loop on A (kernel 1's plain mode,
  the JAX router's general path): a refined cg_sr / fcg / minres solve
  at 128^3 Poisson takes 266.7 / 167.5 / 510.9 ms that way against
  286.8 / 196.0 / 627.3 ms on the plain mode, whose kernel alone is the
  faster one.

``ext_run`` solves a float32 DIA system in the halo-extended layout: CG
with no x0 and M None or diagonal runs the fused CG kernels 2-3
(``cuda_cg.fused_cg_ext``), BiCGStab with no x0 and no M runs K10
(``cuda_bicgstab.fused_bicgstab_ext``), and every other solve runs the
method's loop over kernel 1's extended mode; the fused kernels get the
keywords they take, ``_FUSED_KW``. A bf16 system with a float32 or bf16 b
runs as JAX's ``_ext_run`` takes it: the fused kernels refuse bf16 data
(``pallas_cg.py:275``), so every method runs its loop over kernel 1's
bf16 extended builds. ``ext_run_f64`` runs the method's loop over the
fp64 extended kernel. The JAX float64 runner matvecs in original space
through the double-f32 operator, which needs a hi/lo split per call; the
card has native fp64, so both dtypes here run the same extended-space
loop. Both runners take and return original-space vectors, as (x, info,
iterations, residual norm); the adjoint wrapper
(``autodiff.implicit.implicit_solve``) calls them for the forward and the
adjoint solve alike.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from tpu_sparse_torch.kernels.cuda_bicgstab import fused_bicgstab_ext
from tpu_sparse_torch.kernels.cuda_cg import fused_cg_ext
from tpu_sparse_torch.kernels.cuda_spmv import (ExtendedStencilOperator,
                                                extendable,
                                                make_extended_operator_f64)
from tpu_sparse_torch.precond.jacobi import DiagonalPreconditioner
from tpu_sparse_torch.solvers.fcg import fcg_full
from tpu_sparse_torch.solvers.fgmres import fgmres_full
from tpu_sparse_torch.solvers.krylov import bicgstab_full, cg_full, gmres_full
from tpu_sparse_torch.solvers.minres import minres_full
from tpu_sparse_torch.solvers.pipelined import cg_sr_full
from tpu_sparse_torch.sparse.containers import DIA

_SOLVERS = {"cg": cg_full, "cg_sr": cg_sr_full, "fcg": fcg_full,
            "bicgstab": bicgstab_full, "gmres": gmres_full,
            "fgmres": fgmres_full, "minres": minres_full}
_NAMES = {solver: name for name, solver in _SOLVERS.items()}

# the methods with extended-layout fast paths (JAX router :401-423)
_METHODS = ("cg", "bicgstab", "gmres")
# (A's data dtype, b's dtype) of ``ext_run``: JAX takes a float32 or bf16
# b over float32 or bf16 data (:399-407); a float32 matrix with a bf16 b
# solves in float32 (the router promotes b first)
_PAIRS = ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
          (torch.bfloat16, torch.bfloat16))
# the dtypes of a refinement sweep that may take an extended runner
_SWEEP_DTYPES = (torch.float32, torch.bfloat16)
# the keywords the fused kernels take
_FUSED_KW = ("tol", "atol", "maxiter")


def _on_card(A, b) -> bool:
    """Whether A is a DIA whose data lies on the card, and b a tensor
    there too."""
    return (isinstance(A, DIA) and A.data.is_cuda
            and isinstance(b, torch.Tensor) and b.is_cuda)


def _diagonal(M) -> bool:
    return M is None or isinstance(M, DiagonalPreconditioner)


def _takes(A, b, M) -> bool:
    """Whether the extended layout takes a solve of A x = b under M."""
    return _diagonal(M) and _on_card(A, b) and extendable(A)


def runner(method: str, A, b, M, tol: float) -> Optional[Callable]:
    """The runner of a solve of A x = b: ``ext_run``, ``ext_run_f64``, or
    None for the method's loop on A as it is (the rule of the module
    docstring)."""
    if not (method in _METHODS and _takes(A, b, M)):
        return None
    pair = (A.data.dtype, b.dtype)
    if pair in _PAIRS:
        return ext_run
    if pair == (torch.float64, torch.float64) and tol >= 1e-11:
        return ext_run_f64
    return None


def sweep_runner(inner_solver: Callable, A,
                 rhs, M) -> "tuple[Optional[Callable], bool]":
    """The runner of one refinement sweep, A d = rhs from zero, and whether
    it is the fused CG kernels 2-3 (the rule of the module docstring):
    ``ext_run`` for a float32 CG, ``ext_loop`` for the other methods and
    bf16, (None, False) for the inner solver on A as it is."""
    method = _NAMES.get(inner_solver)
    if (method is None or getattr(rhs, "dtype", None) not in _SWEEP_DTYPES
            or not _takes(A, rhs, M)):
        return None, False
    if method == "cg" and _fused(method, A, None, M):
        return ext_run, True
    return ext_loop, False


def _fused(method: str, A, x0, M) -> bool:
    """Whether ``ext_run`` takes a fused kernel: kernels 2-3 for CG with M
    None or diagonal, K10 for BiCGStab with no M; both need no x0 and
    float32 data."""
    return x0 is None and A.data.dtype == torch.float32 and (
        method == "cg" and _diagonal(M) or method == "bicgstab" and M is None)


def _ext_loop(method: str, kw: dict, op: ExtendedStencilOperator, b, x0, M):
    """Run the method's loop over ``op`` in extended space, with a diagonal
    M extended by unit margins. The default maxiter is 10 n, as in the
    original-space solve, not 10 times the extended length. Returns (x,
    info, iters, res)."""
    if kw.get("maxiter") is None:
        kw = {**kw, "maxiter": 10 * op.n}
    solver = _SOLVERS[method]
    b_ext = op.extend(b)
    x0_ext = None if x0 is None else op.extend(x0)
    M_ext = None
    if M is not None:
        M_ext = DiagonalPreconditioner(op.extend_diag(M.dinv))
    out = solver(op, b_ext, x0_ext, M=M_ext, **kw)
    return (op.extract(out[0]),) + tuple(out[1:])


def ext_loop(method: str, kw: dict, A, b, x0, M):
    """The method's loop over kernel 1's extended mode, on a float32 or
    bf16 DIA system. Returns (x, info, iters, res)."""
    return _ext_loop(method, kw, ExtendedStencilOperator(A), b, x0, M)


def ext_run(method: str, kw: dict, A, b, x0, M):
    """Solve a square float32 (or bf16) DIA system in extended space: the
    fused kernels where ``_fused`` takes the solve, with the keywords of
    ``_FUSED_KW``, else ``ext_loop``. Returns (x, info, iters, res)."""
    if not _fused(method, A, x0, M):
        return ext_loop(method, kw, A, b, x0, M)
    op = ExtendedStencilOperator(A)
    fkw = {k: v for k, v in kw.items() if k in _FUSED_KW and v is not None}
    if method == "cg":
        return fused_cg_ext(op, b, dinv=None if M is None else M.dinv, **fkw)
    return fused_bicgstab_ext(op, b, **fkw)


def ext_run_f64(method: str, kw: dict, A, b, x0, M):
    """Full-precision float64 solve over the fp64 extended kernel (the
    double-f32 operator's slot in the JAX package), in extended space."""
    op = make_extended_operator_f64(A)
    if op is None:
        raise ValueError(
            "ext_run_f64: the fp64 extended operator does not take this "
            "matrix (needs square float64 DIA with bandwidth below n)")
    return _ext_loop(method, kw, op, b, x0, M)
