"""Krylov solves with the adjoint gradient, and the halo-extended runners.

Counterpart of ``tpu_sparse/autodiff/implicit.py``. Gradients of a solve
x = A^-1 b come from one extra adjoint solve, never from differentiating
through the iterations (reference README.md:420-429,
torch_sparse_linalg.py:1161-1258):

    forward :  solve  A x = b          (no graph through the iterations)
    backward:  solve  A^H v = x_bar    (same method, adjoint operator)
               b_bar = v
               A_bar = -v x^H restricted to A's sparsity pattern

``_MatrixSolve`` (a ``torch.autograd.Function``) is the counterpart of the
JAX ``custom_vjp``s ``_implicit_matrix_solve``, ``ext_krylov_diff`` and
``ext_krylov_diff_f64``: one class, with the forward runner as its
argument. A_bar is the vector-Jacobian product of the plain
``spmv_reference`` with respect to A's values at cotangent -v, taken by
``torch.autograd`` on the plain SpMV, never on a kernel; for DIA, entries
whose column lies outside the matrix get zero, as in JAX; for CWELL every
slot gets one, padding slots included, as in JAX. x0 and M get no
gradient. Nonsymmetric methods solve the adjoint system without M (M^H of
an arbitrary operator cannot be formed).

Matrix-free callables are forward only here: the JAX package's
``_callable_solve`` / ``_callable_solve_explicit_T`` are ROADMAP queue 1,
item 6 (callable adjoint).

The extended runners: ``ext_run`` solves a float32 DIA system in the
halo-extended layout (fused CG kernels for cg, K10 for bicgstab, else the
method's loop over kernel 1); ``ext_run_f64`` runs the method's loop over
the fp64 extended kernel. The JAX float64 runner matvecs in original space
through the double-f32 operator, which needs a hi/lo split per call; the
card has native fp64, so both dtypes here run the same extended-space loop.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from tpu_sparse_torch.kernels import spmv_reference
from tpu_sparse_torch.kernels.cuda_bicgstab import fused_bicgstab_ext
from tpu_sparse_torch.kernels.cuda_cg import fused_cg_ext, make_fused_operator
from tpu_sparse_torch.kernels.cuda_spmv import (ExtendedStencilOperator,
                                                make_extended_operator_f64)
from tpu_sparse_torch.precond.jacobi import DiagonalPreconditioner
from tpu_sparse_torch.solvers.krylov import bicgstab_full, cg_full, gmres_full
from tpu_sparse_torch.sparse.containers import (CSR, DIA, is_sparse, values,
                                                with_values)
from tpu_sparse_torch.sparse.cwell import CWELL, CWELLSeg
from tpu_sparse_torch.utils.opcache import TensorCache

_SOLVERS = {"cg": cg_full, "bicgstab": bicgstab_full, "gmres": gmres_full}

# 'symmetric': the adjoint solve may reuse A and M (hermitian operators)
_SYMMETRIC = {"cg": True, "bicgstab": False, "gmres": False}

_FUSED_KW = ("tol", "atol", "maxiter")


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

    CG with no x0 and M None or diagonal runs the fused CG kernels;
    BiCGStab with no x0 and no M runs K10; other cases run the method's
    loop over the extended operator (kernel 1). Returns (x, info, iters,
    res)."""
    fkw = {k: v for k, v in kw.items() if k in _FUSED_KW and v is not None}
    if method == "cg" and x0 is None and (
            M is None or isinstance(M, DiagonalPreconditioner)):
        opf = make_fused_operator(A)
        if opf is not None:
            return fused_cg_ext(opf, b, dinv=None if M is None else M.dinv,
                                **fkw)
    if method == "bicgstab" and x0 is None and M is None:
        opf = make_fused_operator(A)
        if opf is not None:
            return fused_bicgstab_ext(opf, b, **fkw)
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


def _matrix_run(method: str, kw: dict, A, b, x0, M):
    return _SOLVERS[method](A, b, x0, M=M, **kw)


# Transpose plans of CWELL / CWELLSeg packs, keyed on the pack's structure
# (its first idx2 tensor, shared by every ``with_data`` copy, with the
# versions of every idx2 and srow as the extra key): the values of each
# forward solve are new tensors, the structure is not. One entry per live
# structure, dropped with it.
_TRANSPOSES = TensorCache()


def _structure_key(segs) -> tuple:
    return tuple((id(t), t._version) for W in segs for t in (W.idx2, W.srow))


def _transpose_plan(A):
    """(nonzero mask of A's values, A^T packed with 1-based slot ids of A as
    its values; 0 in padding). One repack on A's device."""
    v = values(A)
    ids = torch.arange(1, v.numel() + 1, device=v.device).reshape(v.shape)
    mask = v != 0
    return mask, with_values(A, torch.where(mask, ids, 0)).T


def _packed_transpose(A):
    """A^T for a CWELL or CWELLSeg, byte-equal to ``A.T`` (a repack of the
    transposed CSR), by one gather through a cached plan. The plan holds
    while the values' nonzero pattern does, since ``tocsr`` drops zeros;
    a pack whose CSR has duplicate entries repacks on every call."""
    segs = A.segments if isinstance(A, CWELLSeg) else (A,)
    v = values(A)
    key = _structure_key(segs)
    hit = _TRANSPOSES.get(segs[0].idx2, key)
    if hit is None or not torch.equal(hit[0], v != 0):
        hit = _transpose_plan(A)
        _TRANSPOSES.put(segs[0].idx2, hit, key)
    mask, At_ids = hit
    g = values(At_ids)
    if int(torch.count_nonzero(g)) != int(torch.count_nonzero(mask)):
        return A.T  # duplicates were summed: ids do not map one to one
    flat = v.reshape(-1)
    return with_values(At_ids, torch.where(
        g > 0, flat[(g - 1).clamp_min(0)], flat.new_zeros(())))


def _adjoint_matrix(A, symmetric: bool):
    """A^H for a container or a dense matrix."""
    if symmetric:
        return A
    if isinstance(A, DIA):
        At = A.T
    elif isinstance(A, (CWELL, CWELLSeg)):
        At = _packed_transpose(A)
    elif isinstance(A, CSR):
        At = A.tocoo().T
    elif is_sparse(A):
        At = A.T
    else:
        At = A.transpose(-1, -2)
    if At.dtype.is_complex:
        At = At.conj()
    return At


def _values(A) -> torch.Tensor:
    """The differentiable values of a matrix operand."""
    return A if isinstance(A, torch.Tensor) else values(A)


def _with_values(A, vals):
    return vals if isinstance(A, torch.Tensor) else with_values(A, vals)


class _MatrixSolve(torch.autograd.Function):
    """x = runner(A, b): differentiable in A's values and b through x (the
    first output); info, iterations and residual are not differentiable."""

    @staticmethod
    def forward(ctx, runner, method, kw, A, x0, M, a_vals, b):
        A_ = _with_values(A, a_vals.detach())
        x, info, iters, res = runner(method, kw, A_, b.detach(), x0, M)
        ctx.runner, ctx.method, ctx.kw, ctx.A, ctx.M = runner, method, kw, \
            A_, M
        ctx.save_for_backward(x)
        ctx.mark_non_differentiable(info, iters, res)
        return x, info, iters, res

    @staticmethod
    def backward(ctx, x_bar, *_):
        (x,) = ctx.saved_tensors
        sym = _SYMMETRIC[ctx.method]
        At = _adjoint_matrix(ctx.A, sym)
        v = ctx.runner(ctx.method, ctx.kw, At, x_bar.contiguous(), None,
                       ctx.M if sym else None)[0]
        grad_a = None
        if ctx.needs_input_grad[6]:
            with torch.enable_grad():
                a = _values(ctx.A).detach().requires_grad_()
                y = spmv_reference(_with_values(ctx.A, a), x)
                (grad_a,) = torch.autograd.grad(y, a, grad_outputs=-v)
        grad_b = v if ctx.needs_input_grad[7] else None
        return None, None, None, None, None, None, grad_a, grad_b


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def implicit_solve(runner: Callable, method: str, kw: dict, A, b, x0, M):
    """Run ``runner(method, kw, A, b, x0, M)`` with the adjoint gradient
    for A's values and b when either requires grad. Returns (x, info,
    iters, res)."""
    a_vals = _values(A)
    if not _needs_grad(a_vals, b):
        return runner(method, kw, A, b, x0, M)
    A_const = A if isinstance(A, torch.Tensor) else with_values(A, None)
    x0 = None if x0 is None else x0.detach()
    return _MatrixSolve.apply(runner, method, kw, A_const, x0, M, a_vals, b)


def ext_krylov_diff(method: str, kw: dict, A, b, x0, M):
    """``ext_run`` with the adjoint: forward and adjoint solves both take
    the float32 extended fast path (fused CG, K10 on A^T for bicgstab)."""
    return implicit_solve(ext_run, method, kw, A, b, x0, M)


def ext_krylov_diff_f64(method: str, kw: dict, A, b, x0, M):
    """``ext_run_f64`` with the adjoint."""
    return implicit_solve(ext_run_f64, method, kw, A, b, x0, M)


def _dispatch(method: str, A, b, x0, M, kw: dict):
    if callable(A) and not is_sparse(A) and not isinstance(A, torch.Tensor):
        if _needs_grad(b, x0):
            raise NotImplementedError(
                "gradients through a solve with a matrix-free operator are "
                "not ported yet: ROADMAP queue 1, item 6 (callable adjoint)")
        return _matrix_run(method, kw, A, b, x0, M)
    return implicit_solve(_matrix_run, method, kw, A, b, x0, M)


def cg_diff(A, b, x0=None, *, tol: float = 1e-5, atol: float = 0.0,
            maxiter: Optional[int] = None, M=None):
    """CG with the adjoint gradient (A hermitian: the adjoint solve reuses
    A and M). Returns (x, info, iterations, residual_norm); gradients flow
    to b and A's values through x."""
    return _dispatch("cg", A, b, x0, M,
                     dict(tol=tol, atol=atol, maxiter=maxiter))


def bicgstab_diff(A, b, x0=None, *, tol: float = 1e-5, atol: float = 0.0,
                  maxiter: Optional[int] = None, M=None):
    """BiCGStab with the adjoint gradient (adjoint solve on A^H, no M)."""
    return _dispatch("bicgstab", A, b, x0, M,
                     dict(tol=tol, atol=atol, maxiter=maxiter))


def gmres_diff(A, b, x0=None, *, tol: float = 1e-5, atol: float = 0.0,
               restart: int = 20, maxiter: Optional[int] = None, M=None,
               solve_method: str = "batched"):
    """GMRES with the adjoint gradient (adjoint solve on A^H, no M)."""
    return _dispatch("gmres", A, b, x0, M,
                     dict(tol=tol, atol=atol, restart=restart,
                          maxiter=maxiter, solve_method=solve_method))
