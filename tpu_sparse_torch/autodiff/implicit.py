"""Krylov solves of DIA systems in the halo-extended layout (forward only).

Counterpart of the forward halves of ``tpu_sparse/autodiff/implicit.py``:
``ext_run`` (``_ext_run``, :154-205) and ``ext_run_f64`` (``_ext_run_f64``,
:225-236). The adjoint solve that makes these differentiable
(``torch.autograd.Function``) is ROADMAP queue 1, item 6; until it lands
the router refuses inputs that require grad.

The JAX float64 runner matvecs in original space through the double-f32
operator, which needs a hi/lo split per call. The card has native fp64, so
both dtypes here run the same extended-space loop: ``b`` is extended once
and every matvec is kernel 1 in extended mode, with no pad or slice per
iteration.
"""

from __future__ import annotations

from tpu_sparse_torch.kernels.cuda_cg import fused_cg_ext, make_fused_operator
from tpu_sparse_torch.kernels.cuda_spmv import (ExtendedStencilOperator,
                                                make_extended_operator_f64)
from tpu_sparse_torch.precond.jacobi import DiagonalPreconditioner
from tpu_sparse_torch.solvers.krylov import cg_full

_SOLVERS = {"cg": cg_full}


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


def ext_run(method: str, kw: dict, A, b, x0, M):
    """Solve a square float32 DIA system in extended space.

    CG with no x0 and M None or diagonal runs the fused CG kernels; other
    cases run the method's loop over the extended operator (kernel 1).
    Returns (x, info, iters, res)."""
    if method == "cg" and x0 is None and (
            M is None or isinstance(M, DiagonalPreconditioner)):
        dvec = None if M is None else M.dinv
        opf = make_fused_operator(A)
        if opf is not None:
            fkw = {k: v for k, v in kw.items()
                   if k in ("tol", "atol", "maxiter") and v is not None}
            return fused_cg_ext(opf, b, dinv=dvec, **fkw)
    return _ext_loop(method, kw, ExtendedStencilOperator(A), b, x0, M)


def ext_run_f64(method: str, kw: dict, A, b, x0, M):
    """Full-precision float64 solve over the fp64 extended kernel (the
    double-f32 operator's slot in the JAX package), in extended space."""
    op = make_extended_operator_f64(A)
    if op is None:
        raise ValueError(
            "ext_run_f64: the fp64 extended operator does not take this "
            "matrix (needs square float64 DIA with bandwidth below n)")
    return _ext_loop(method, kw, op, b, x0, M)
