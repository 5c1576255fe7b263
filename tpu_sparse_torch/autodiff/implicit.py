"""Krylov solves with the adjoint gradient.

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
argument (the method's loop, or a runner of ``solvers.extended``). A_bar
is the vector-Jacobian product of the plain
``spmv_reference`` with respect to A's values at cotangent -v, taken by
``torch.autograd`` on the plain SpMV, never on a kernel; for DIA, entries
whose column lies outside the matrix get zero, as in JAX; for CWELL every
slot gets one, padding slots included, as in JAX. x0 and M get no
gradient. Nonsymmetric methods solve the adjoint system without M (M^H of
an arbitrary operator cannot be formed).

Matrix-free callables (``_callable_solve``, the counterpart of the JAX
``_callable_solve`` / ``_callable_solve_explicit_T``) solve under
``no_grad`` and return ``x* + Z(b - A_fn(x*))``, where ``Z`` is the
identity's zero: its forward returns zeros, its backward solves the
adjoint system for the cotangent. The one extra matvec ``A_fn(x*)`` is
on the autograd graph, so b and every tensor that A_fn's output depends
on through torch ops get their gradients, as closed-over arrays do under
JAX's ``custom_linear_solve``. Symmetric methods solve the adjoint
system with A_fn and M; the others with A^H as the vector-Jacobian
product of the linear A_fn, checked once per backward against A_fn by
<u, A w> = <A^H u, w>: an A_fn that autograd cannot transpose (one that
launches a kernel with no backward) raises an error naming
``A_transpose=`` and never yields partial gradients. With
``A_transpose`` the backward solves with it, without M, and only b gets
a gradient (the JAX contract).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from tpu_sparse_torch.kernels import spmv_reference
from tpu_sparse_torch.solvers.extended import _SOLVERS, ext_run, ext_run_f64
from tpu_sparse_torch.sparse.containers import (CSR, DIA, is_sparse, values,
                                                with_values)
from tpu_sparse_torch.sparse.cwell import CWELL, CWELLSeg
from tpu_sparse_torch.utils.opcache import TensorCache
from tpu_sparse_torch.utils.tree import (tree_add, tree_leaves, tree_norm,
                                         tree_sub, tree_vdot)

# 'symmetric': the adjoint solve may reuse A (hermitian operators); FCG
# also tolerates a nonsymmetric M, so the forward M is reused too
_SYMMETRIC = {"cg": True, "cg_sr": True, "fcg": True, "bicgstab": False,
              "gmres": False, "fgmres": False, "minres": True}


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
        # conjugated once here: a conjugate view would be resolved by
        # every kernel launch of the adjoint solve
        At = (At.conj().resolve_conj() if isinstance(At, torch.Tensor)
              else with_values(At, values(At).conj().resolve_conj()))
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
    """``extended.ext_run`` with the adjoint: forward and adjoint solves
    both take the float32 extended fast path (fused CG, K10 on A^T for
    bicgstab)."""
    return implicit_solve(ext_run, method, kw, A, b, x0, M)


def ext_krylov_diff_f64(method: str, kw: dict, A, b, x0, M):
    """``extended.ext_run_f64`` with the adjoint."""
    return implicit_solve(ext_run_f64, method, kw, A, b, x0, M)


class _AdjointSolve(torch.autograd.Function):
    """Zeros of the shape of r in the forward; in the backward, the
    solution v of the adjoint system for the cotangent g, as the gradient
    of r. Added to a solve's x it changes no value and puts the adjoint
    solve on the graph."""

    @staticmethod
    def forward(ctx, adjoint, spec, *leaves):
        ctx.adjoint, ctx.spec = adjoint, spec
        return tuple(torch.zeros_like(t) for t in leaves)

    @staticmethod
    def backward(ctx, *grads):
        g = pytree.tree_unflatten([t.contiguous() for t in grads], ctx.spec)
        return (None, None) + tuple(tree_leaves(ctx.adjoint(g)))


def _vjp_transpose(A_fn: Callable) -> Callable:
    """A^H u as the vector-Jacobian product of the linear A_fn (at 0)."""

    def At(u):
        leaves, spec = pytree.tree_flatten(u)
        with torch.enable_grad():
            z = [torch.zeros_like(t).requires_grad_() for t in leaves]
            y = tree_leaves(A_fn(pytree.tree_unflatten(z, spec)))
            try:
                g = torch.autograd.grad(y, z, grad_outputs=leaves)
            except RuntimeError as err:
                raise _no_transpose(str(err)) from err
        return pytree.tree_unflatten(list(g), spec)

    return At


def _no_transpose(why: str) -> RuntimeError:
    return RuntimeError(
        "the adjoint of this matrix-free operator is not available from "
        "torch autograd (for instance, A_fn launches a kernel that has no "
        f"backward): {why}. Pass A_transpose= (the adjoint matvec) to "
        "bicgstab_diff / gmres_diff / fgmres_diff, or give A as a matrix")


def _check_transpose(A_fn: Callable, At: Callable, u) -> None:
    """Raise unless <u, A w> = <A^H u, w> for a fixed pseudo-random w: an
    A_fn whose product leaves autograd's graph for part of the work would
    otherwise give partial gradients."""
    leaves, spec = pytree.tree_flatten(u)
    gen = torch.Generator(device=leaves[0].device).manual_seed(0)
    w = pytree.tree_unflatten(
        [torch.randn(t.shape, generator=gen, device=t.device,
                     dtype=t.dtype) for t in leaves], spec)
    Aw, Atu = A_fn(w), At(u)
    lhs, rhs = tree_vdot(u, Aw), tree_vdot(Atu, w)
    scale = tree_norm(u) * tree_norm(Aw) + tree_norm(Atu) * tree_norm(w)
    tol = 1e-3 if torch.finfo(leaves[0].dtype).bits <= 32 else 1e-8
    if not bool((lhs - rhs).abs() <= tol * scale):
        raise _no_transpose(
            f"<u, A w> = {complex(lhs):.6g} but <A^H u, w> = "
            f"{complex(rhs):.6g} for autograd's A^H")


def _callable_solve(method: str, kw: dict, A_fn: Callable, b, x0, M,
                    A_transpose: Optional[Callable]):
    """Solve with a matrix-free A_fn (JAX ``_callable_solve`` and, with
    ``A_transpose``, ``_callable_solve_explicit_T``). Returns (x, info,
    iters, res); x carries the adjoint gradient (module docstring)."""
    solver = _SOLVERS[method]
    with torch.no_grad():
        out = solver(A_fn, b, x0, M=M, **kw)
    if not torch.is_grad_enabled():
        return out
    x = out[0]
    if A_transpose is not None:
        r = b

        def adjoint(g):
            with torch.no_grad():
                return solver(A_transpose, g, None, M=None, **kw)[0]
    else:
        # A_fn(x*) on the graph: d/dtheta of b - A_theta x* is the source
        # term of every closed-over tensor theta
        r = tree_sub(b, A_fn(x))
        if _SYMMETRIC[method]:
            A_adj = A_fn
        else:
            A_adj = _vjp_transpose(A_fn)

        def adjoint(g):
            if A_adj is not A_fn:
                _check_transpose(A_fn, A_adj, g)
            with torch.no_grad():
                return solver(A_adj, g, None, M=M, **kw)[0]
    leaves, spec = pytree.tree_flatten(r)
    if not any(t.requires_grad for t in leaves):
        return out
    z = _AdjointSolve.apply(adjoint, spec, *leaves)
    return (tree_add(x, pytree.tree_unflatten(list(z), spec)),) + \
        tuple(out[1:])


def _dispatch(method: str, A, b, x0, M, kw: dict, A_transpose=None):
    if callable(A) and not is_sparse(A) and not isinstance(A, torch.Tensor):
        return _callable_solve(method, kw, A, b, x0, M, A_transpose)
    return implicit_solve(_matrix_run, method, kw, A, b, x0, M)


def cg_diff(A, b, x0=None, *, tol: float = 1e-5, atol: float = 0.0,
            maxiter: Optional[int] = None, M=None):
    """CG with the adjoint gradient (A hermitian: the adjoint solve reuses
    A and M). Returns (x, info, iterations, residual_norm); gradients flow
    to b and A's values through x (to b and the tensors a matrix-free A
    depends on, for a callable)."""
    return _dispatch("cg", A, b, x0, M,
                     dict(tol=tol, atol=atol, maxiter=maxiter))


def cg_sr_diff(A, b, x0=None, *, tol: float = 1e-5, atol: float = 0.0,
               maxiter: Optional[int] = None, M=None):
    """Single-reduction CG with the adjoint gradient (A hermitian: the
    adjoint solve reuses A and M); the contract of ``cg_diff``."""
    return _dispatch("cg_sr", A, b, x0, M,
                     dict(tol=tol, atol=atol, maxiter=maxiter))


def fcg_diff(A, b, x0=None, *, tol: float = 1e-5, atol: float = 0.0,
             maxiter: Optional[int] = None, M=None):
    """Flexible CG with the adjoint gradient (A hermitian, M arbitrary:
    the adjoint solve reuses both)."""
    return _dispatch("fcg", A, b, x0, M,
                     dict(tol=tol, atol=atol, maxiter=maxiter))


def minres_diff(A, b, x0=None, *, tol: float = 1e-5, atol: float = 0.0,
                maxiter: Optional[int] = None, M=None):
    """MINRES with the adjoint gradient (A symmetric, possibly indefinite:
    the adjoint solve reuses A and M)."""
    return _dispatch("minres", A, b, x0, M,
                     dict(tol=tol, atol=atol, maxiter=maxiter))


def bicgstab_diff(A, b, x0=None, *, tol: float = 1e-5, atol: float = 0.0,
                  maxiter: Optional[int] = None, M=None, A_transpose=None):
    """BiCGStab with the adjoint gradient (adjoint solve on A^H, no M).

    A_transpose: the adjoint matvec of a matrix-free A that autograd
    cannot transpose (a kernel without a backward); b alone then gets a
    gradient. Ignored for matrix operands."""
    return _dispatch("bicgstab", A, b, x0, M,
                     dict(tol=tol, atol=atol, maxiter=maxiter),
                     A_transpose=A_transpose)


def gmres_diff(A, b, x0=None, *, tol: float = 1e-5, atol: float = 0.0,
               restart: int = 20, maxiter: Optional[int] = None, M=None,
               solve_method: str = "batched", A_transpose=None):
    """GMRES with the adjoint gradient (adjoint solve on A^H, no M);
    A_transpose as in ``bicgstab_diff``."""
    return _dispatch("gmres", A, b, x0, M,
                     dict(tol=tol, atol=atol, restart=restart,
                          maxiter=maxiter, solve_method=solve_method),
                     A_transpose=A_transpose)


def fgmres_diff(A, b, x0=None, *, tol: float = 1e-5, atol: float = 0.0,
                restart: int = 20, maxiter: Optional[int] = None, M=None,
                A_transpose=None):
    """Flexible GMRES with the adjoint gradient (adjoint solve on A^H, no
    M); A_transpose as in ``bicgstab_diff``."""
    return _dispatch("fgmres", A, b, x0, M,
                     dict(tol=tol, atol=atol, restart=restart,
                          maxiter=maxiter),
                     A_transpose=A_transpose)
