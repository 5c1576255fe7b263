"""Mixed-precision iterative refinement (defect correction).

Counterpart of ``tpu_sparse/solvers/mixed.py`` (``refined_solve``,
``_make_inner``, ``cg_refined``, ``bicgstab_refined``, ``gmres_refined``):

    x = 0  (f64)
    repeat:
        r  = b - A x                (f64)
        d  = solve(A32, r32)        (f32 Krylov solve)
        x += d                      (accepted only if it lowers ||r||)
    until ||r|| <= max(tol*||b||, atol)

followed by one full-precision rescue solve when the sweeps stall. On CUDA
DIA operands the outer f64 residuals run the fp64 extended kernel and the
inner f32 sweeps run the method's loop over the f32 extended operator. A
CWELL operand is cast through ``with_values`` (the JAX ``_cast_operator``
reads ``A.data`` and fails on CWELL, ROADMAP queue 3, R5), so its inner
matvecs run K4 and its outer residuals K5.
The JAX version is a static unroll with masked no-op sweeps; here the sweep
loop is Python
with one host read per sweep and stops at the first done sweep, which
gives the same x, info and iteration count (a done sweep of the unroll
solves a zero right-hand side in 0 iterations and is never accepted).

``batch_refined`` is the column-batched ``refined_solve`` (the JAX
``batched.batch_refined`` ``vmap``s it): each column keeps its own
``done`` / ``stalled`` / ``accept``, the inner float32 sweeps solve the
(n, k) residual block with the batched solvers (every matvec one ``spmm``
on the float32-cast operand: K6/K7 on a CWELL, K8 on a BELL on the card),
the outer float64 residuals are ``spmm`` in float64 (the double builds of
the same kernels), and the loop reads the host once per sweep, on
``done.all()``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from tpu_sparse_torch.kernels import as_matvec
from tpu_sparse_torch.kernels.cuda_spmv import (make_extended_operator,
                                                make_extended_operator_f64)
from tpu_sparse_torch.precond.jacobi import DiagonalPreconditioner
from tpu_sparse_torch.solvers.krylov import (_default_maxiter, bicgstab_full,
                                             cg_full, gmres_full)
from tpu_sparse_torch.sparse.containers import (DIA, is_sparse, values,
                                                with_values)
from tpu_sparse_torch.utils.tree import (
    tree_add,
    tree_leaves,
    tree_map,
    tree_norm,
    tree_size,
    tree_sub,
    tree_where,
    tree_zeros_like,
)


def _cast_tree(tree, dtype):
    return tree_map(lambda leaf: leaf.to(dtype), tree)


def _cast_operator(A, dtype, outer_dtype=torch.float64):
    if is_sparse(A):
        return with_values(A, values(A).to(dtype))
    if callable(A) and not isinstance(A, torch.Tensor):
        # matrix-free: cast around the user's operator, which expects the
        # outer system's dtype
        def op(x_inner):
            return _cast_tree(A(_cast_tree(x_inner, outer_dtype)), dtype)

        return op
    return A.to(dtype)


def _cast_precond(M, dtype):
    if M is None:
        return None
    if isinstance(M, DiagonalPreconditioner):
        return M.to(dtype)
    if is_sparse(M) or isinstance(M, torch.Tensor):
        return _cast_operator(M, dtype)
    return M  # a plain callable carries no tensors to cast


def _first_dtype(tree) -> torch.dtype:
    return tree_leaves(tree)[0].dtype


def _make_df_operator(A, outer_dtype):
    """fp64 extended operator for the f64 outer system on CUDA, or None
    (the slot the double-f32 operator held in the JAX package)."""
    if not (isinstance(A, DIA) and A.data.is_cuda
            and outer_dtype == torch.float64):
        return None
    return make_extended_operator_f64(A)


def _make_inner(inner_solver, A32, M32, inner_tol, maxiter, inner_kwargs):
    """Per-sweep inner solve. CUDA f32 DIA systems (no or diagonal M) run
    through the extended operator, so every inner SpMV is kernel 1."""
    op32 = None
    if (isinstance(A32, DIA) and A32.data.is_cuda
            and (M32 is None or isinstance(M32, DiagonalPreconditioner))):
        op32 = make_extended_operator(A32)
    if op32 is not None:
        M32e = None if M32 is None else DiagonalPreconditioner(
            op32.extend_diag(M32.dinv))

        def _inner(rhs):
            out = inner_solver(op32, op32.extend(rhs), None, tol=inner_tol,
                               maxiter=maxiter, M=M32e, **inner_kwargs)
            return (op32.extract(out[0]),) + tuple(out[1:])

        return _inner

    def _inner(rhs):
        return inner_solver(A32, rhs, None, tol=inner_tol, maxiter=maxiter,
                            M=M32, **inner_kwargs)

    return _inner


def refined_solve(inner_solver: Callable, A, b, x0: Optional[Any] = None, *,
                  tol: float = 1e-8, atol: float = 0.0,
                  inner_tol: float = 1e-5, maxiter: Optional[int] = None,
                  max_sweeps: int = 6, M=None,
                  inner_dtype=torch.float32,
                  inner_maxiter: Optional[int] = None,
                  rescue_maxiter: Optional[int] = None, **inner_kwargs):
    """Defect-correction refinement around an f32 inner Krylov solve.

    Returns (x, info, total_inner_iterations, residual_norm) in b's dtype.
    """
    A_fn = as_matvec(A)
    outer_dtype = _first_dtype(b)
    A_rescue = A
    df_op = _make_df_operator(A, outer_dtype)
    if df_op is not None:
        A_fn = df_op.matvec64
        A_rescue = df_op.matvec64
    A32 = _cast_operator(A, inner_dtype, outer_dtype)
    M32 = _cast_precond(M, inner_dtype)
    maxiter = _default_maxiter(b, maxiter)
    if inner_maxiter is None:
        inner_maxiter = maxiter
    if rescue_maxiter is None:
        rescue_maxiter = maxiter

    b_norm = tree_norm(b)
    thresh = torch.clamp_min(tol * b_norm, atol)

    _inner = _make_inner(inner_solver, A32, M32, inner_tol, inner_maxiter,
                         inner_kwargs)

    x = tree_zeros_like(b) if x0 is None else x0
    res_norm = tree_norm(tree_sub(b, A_fn(x)))
    inner_iters = torch.zeros((), dtype=torch.int32, device=b_norm.device)
    stalled = torch.zeros((), dtype=torch.bool, device=b_norm.device)

    for _ in range(max_sweeps):
        done = (res_norm <= thresh) | (~torch.isfinite(res_norm)) | stalled
        if bool(done):  # the one host read of the sweep
            break
        r = tree_sub(b, A_fn(x))
        d32, _, it, _ = _inner(_cast_tree(r, inner_dtype))
        # accept the sweep only if it lowered the true residual: an f32
        # breakdown can return a finite but useless update
        x_new = tree_add(x, _cast_tree(d32, outer_dtype))
        res_new = tree_norm(tree_sub(b, A_fn(x_new)))
        accept = torch.isfinite(res_new) & (res_new < res_norm)
        x = tree_where(accept, x_new, x)
        res_norm = torch.where(accept, res_new, res_norm)
        stalled = stalled | ~accept
        inner_iters = inner_iters + torch.clamp_min(it, 0)

    # Full-precision rescue: one inner solve in the outer dtype on the
    # current defect, aimed at the true threshold (tol=0, atol=thresh).
    failed = (~torch.isfinite(res_norm)) | (res_norm > thresh)
    if bool(failed):
        r = tree_sub(b, A_fn(x))
        d, _, it_f, _ = inner_solver(A_rescue, r, None, tol=0.0, atol=thresh,
                                     maxiter=rescue_maxiter, M=M,
                                     **inner_kwargs)
        x_new = tree_add(x, d)
        res_new = tree_norm(tree_sub(b, A_fn(x_new)))
        accept = torch.isfinite(res_new) & (res_new < res_norm)
        x = tree_where(accept, x_new, x)
        res_norm = torch.where(accept, res_new, res_norm)
        inner_iters = inner_iters + torch.clamp_min(it_f, 0)
        failed = (~torch.isfinite(res_norm)) | (res_norm > thresh)
    info = torch.where(failed, -1, 0).to(torch.int32)
    return x, info, inner_iters, res_norm


def cg_refined(A, b, x0=None, *, tol: float = 1e-8, atol: float = 0.0,
               inner_tol: float = 1e-5, maxiter: Optional[int] = None,
               max_sweeps: int = 8, M=None):
    """f64-accurate CG at f32 speed via defect correction."""
    return refined_solve(cg_full, A, b, x0, tol=tol, atol=atol,
                         inner_tol=inner_tol, maxiter=maxiter,
                         max_sweeps=max_sweeps, M=M)


def bicgstab_refined(A, b, x0=None, *, tol: float = 1e-8, atol: float = 0.0,
                     inner_tol: float = 1e-5, maxiter: Optional[int] = None,
                     max_sweeps: int = 8, M=None):
    """f64-accurate BiCGStab at f32 speed via defect correction."""
    return refined_solve(bicgstab_full, A, b, x0, tol=tol, atol=atol,
                         inner_tol=inner_tol, maxiter=maxiter,
                         max_sweeps=max_sweeps, M=M)


# Systems at or below this size run full GMRES (restart = n) under the
# adaptive-restart policy: exact termination in <= n Arnoldi steps beats
# thousands of small restart cycles on ill-conditioned systems.
_ADAPTIVE_FULL_GMRES_N = 1024


def gmres_refined(A, b, x0=None, *, tol: float = 1e-8, atol: float = 0.0,
                  inner_tol: float = 1e-5, restart: int = 20,
                  maxiter: Optional[int] = None, max_sweeps: int = 8,
                  M=None, solve_method: str = "batched",
                  adaptive_restart: bool = True):
    """Mixed-precision GMRES via defect correction.

    ``adaptive_restart`` treats ``restart`` as a hint: for n <= 1024 the
    restart is raised to n (full GMRES). When the restart reaches n, each
    f32 sweep runs one cycle and the f64 rescue at most four: exact
    termination makes further cycles waste for a stalled inner solve.
    ``adaptive_restart=False`` keeps the reference's fixed restart."""
    n = tree_size(b)
    inner_cap = None
    rescue_cap = None
    if adaptive_restart and restart < n and n <= _ADAPTIVE_FULL_GMRES_N:
        restart = n
    if restart >= n:
        inner_cap = 1
        rescue_cap = 4
    return refined_solve(gmres_full, A, b, x0, tol=tol, atol=atol,
                         inner_tol=inner_tol, maxiter=maxiter,
                         max_sweeps=max_sweeps, M=M, restart=restart,
                         solve_method=solve_method,
                         inner_maxiter=inner_cap,
                         rescue_maxiter=rescue_cap)


def batch_refined_solve(inner_solver: Callable, A, B: torch.Tensor,
                        X0=None, *, tol: float = 1e-8, atol: float = 0.0,
                        inner_tol: float = 1e-5,
                        maxiter: Optional[int] = None, max_sweeps: int = 6,
                        M=None, inner_dtype=torch.float32,
                        inner_maxiter: Optional[int] = None,
                        rescue_maxiter: Optional[int] = None,
                        **inner_kwargs):
    """``refined_solve`` for each column of an (n, k) block B, with a
    batched inner solver (``batch_cg``, ``batch_bicgstab``,
    ``batch_gmres``). A column that is done solves a zero right-hand side,
    which takes 0 inner iterations, and is never accepted again: each
    column ends as ``refined_solve`` would end it alone. Returns (X,
    infos, inner iterations, res_norms), each per column."""
    from tpu_sparse_torch.kernels import as_matmat
    from tpu_sparse_torch.solvers.batched import cols_norm

    A_mm = as_matmat(A)
    outer_dtype = B.dtype
    A32 = _cast_operator(A, inner_dtype, outer_dtype)
    M32 = _cast_precond(M, inner_dtype)
    maxiter = 10 * B.shape[0] if maxiter is None else int(maxiter)
    if inner_maxiter is None:
        inner_maxiter = maxiter
    if rescue_maxiter is None:
        rescue_maxiter = maxiter

    thresh = torch.clamp_min(tol * cols_norm(B), atol)
    X = torch.zeros_like(B) if X0 is None else X0
    res = cols_norm(B - A_mm(X))
    zero = torch.zeros((), dtype=B.dtype, device=B.device)
    inner_iters = torch.zeros(B.shape[1], dtype=torch.int32, device=B.device)
    stalled = torch.zeros(B.shape[1], dtype=torch.bool, device=B.device)

    for _ in range(max_sweeps):
        done = (res <= thresh) | (~torch.isfinite(res)) | stalled
        if bool(done.all()):  # the one host read of the sweep
            break
        R = torch.where(done, zero, B - A_mm(X))
        D32, _, it, _ = inner_solver(A32, R.to(inner_dtype), None,
                                     tol=inner_tol, maxiter=inner_maxiter,
                                     M=M32, **inner_kwargs)
        # accept a column's sweep only if it lowered its true residual
        X_new = X + D32.to(outer_dtype)
        res_new = cols_norm(B - A_mm(X_new))
        accept = torch.isfinite(res_new) & (res_new < res) & ~done
        X = torch.where(accept, X_new, X)
        res = torch.where(accept, res_new, res)
        stalled = stalled | (~accept & ~done)
        inner_iters = inner_iters + torch.clamp_min(it, 0)

    # full-precision rescue of the columns the sweeps left above threshold
    failed = (~torch.isfinite(res)) | (res > thresh)
    if bool(failed.any()):
        R = torch.where(failed, B - A_mm(X), zero)
        D, _, it_f, _ = inner_solver(A, R, None, tol=0.0, atol=thresh,
                                     maxiter=rescue_maxiter, M=M,
                                     **inner_kwargs)
        X_new = X + D
        res_new = cols_norm(B - A_mm(X_new))
        accept = torch.isfinite(res_new) & (res_new < res) & failed
        X = torch.where(accept, X_new, X)
        res = torch.where(accept, res_new, res)
        inner_iters = inner_iters + torch.clamp_min(it_f, 0)
        failed = (~torch.isfinite(res)) | (res > thresh)
    info = torch.where(failed, -1, 0).to(torch.int32)
    return X, info, inner_iters, res


def batch_refined(method: str, A, B: torch.Tensor, X0=None, *,
                  tol: float = 1e-8, atol: float = 0.0,
                  maxiter: Optional[int] = None, M=None, **kw):
    """Mixed-precision solve of each column of B by the defect correction
    of ``cg_refined`` / ``bicgstab_refined`` / ``gmres_refined`` (their
    inner tolerance, sweep count and GMRES restart policy). Returns (X,
    infos, inner_iterations, res_norms)."""
    from tpu_sparse_torch.solvers.batched import (batch_bicgstab, batch_cg,
                                                  batch_gmres)

    inner = {"cg": batch_cg, "bicgstab": batch_bicgstab,
             "gmres": batch_gmres}
    if method not in inner:
        raise NotImplementedError(
            f"batch_refined for '{method}' is not ported yet: ROADMAP "
            "queue 1, item 14 (other solvers)")
    caps = {}
    if method == "gmres":
        n = B.shape[0]
        restart = kw.pop("restart", 20)
        if kw.pop("adaptive_restart", True) and restart < n \
                and n <= _ADAPTIVE_FULL_GMRES_N:
            restart = n
        if restart >= n:
            caps = dict(inner_maxiter=1, rescue_maxiter=4)
        kw["restart"] = restart
    return batch_refined_solve(inner[method], A, B, X0, tol=tol, atol=atol,
                               inner_tol=kw.pop("inner_tol", 1e-5),
                               maxiter=maxiter,
                               max_sweeps=kw.pop("max_sweeps", 8), M=M,
                               **caps, **kw)
