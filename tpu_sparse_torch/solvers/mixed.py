"""Mixed-precision iterative refinement (defect correction).

Counterpart of ``tpu_sparse/solvers/mixed.py`` (``refined_solve``,
``_make_inner``, ``cg_refined``, ``bicgstab_refined``, ``gmres_refined``,
``cg_sr_refined``, ``minres_refined``, ``fcg_refined``,
``fgmres_refined``):

    x = 0  (f64)
    repeat:
        r  = b - A x                (f64)
        d  = solve(A32, r32)        (f32 Krylov solve)
        x += d                      (accepted only if it lowers ||r||)
    until ||r|| <= max(tol*||b||, atol)

(complex128 outer, complex64 inner for a complex system: R12 repaired,
see ``_inner_dtype``; ``inner_dtype=torch.bfloat16`` sweeps in bf16, as
the JAX ``refined_solve`` takes it: on the card a DIA's inner sweeps run
kernel 1's bf16 extended build, a CWELL's K4's bf16 build)

followed by one full-precision rescue solve when the sweeps stall. On CUDA
DIA operands the outer f64 residuals run the fp64 extended kernel. Each
sweep runs the runner ``solvers.extended.sweep_runner`` names for the
inner solver, the cast operand, the cast residual and the cast M: on the
card a float32 CG sweep with M None or diagonal runs the fused CG kernels
2-3, and every other sweep of a named method's loop (bf16 ones too) runs
that loop over kernel 1's extended mode; with no runner (another inner
solver, M, operand, dtype or device) the sweep runs the inner solver on
the cast operand. A CWELL operand is cast through ``with_values`` (the
JAX ``_cast_operator`` reads ``A.data`` and fails on CWELL, ROADMAP queue
3, R5), so its inner matvecs run K4 and its outer residuals K5.
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

Both refinements run in a ``tsp.solver.refine`` span (attributes method,
inner dtype), each sweep's residual, inner solve and accept in a child
``tsp.solver.refine.sweep`` (attribute i) and the rescue in
``tsp.solver.refine.rescue``. The counter group ``refine`` counts host-side
events only, so that counting adds no host read: ``sweeps`` (sweeps that
ran an inner solve), ``fused_sweeps`` (those whose inner solve ran the
fused CG kernels), ``rescues``, ``residuals`` (outer residual products,
each A x or A X in the outer dtype) and ``operator_casts`` (casts of the
matrix values to the inner dtype).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from tpu_sparse_torch import tracing
from tpu_sparse_torch.kernels import as_matvec
from tpu_sparse_torch.kernels.cuda_spmv import make_extended_operator_f64
from tpu_sparse_torch.solvers import extended
from tpu_sparse_torch.solvers.fcg import fcg_full
from tpu_sparse_torch.solvers.fgmres import fgmres_full
from tpu_sparse_torch.solvers.krylov import (_default_maxiter, bicgstab_full,
                                             cg_full, gmres_full)
from tpu_sparse_torch.solvers.minres import minres_full
from tpu_sparse_torch.solvers.pipelined import cg_sr_full
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

REFINE = tracing.group("refine", {"sweeps": 0, "fused_sweeps": 0,
                                  "rescues": 0, "residuals": 0,
                                  "operator_casts": 0})


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


def _inner_operator(A, dtype, outer_dtype):
    """A for the inner sweeps, counted in ``refine.operator_casts`` when its
    values are cast (a matrix-free operator is wrapped, not cast)."""
    if is_sparse(A) or isinstance(A, torch.Tensor):
        REFINE["operator_casts"] += 1
    return _cast_operator(A, dtype, outer_dtype)


def _counted_residuals(A_fn):
    """``A_fn`` counted in ``refine.residuals``: the outer residual
    products."""

    def product(x):
        REFINE["residuals"] += 1
        return A_fn(x)

    return product


def _method_name(inner_solver) -> str:
    """The span's method attribute: ``cg`` for ``cg_full`` or
    ``batch_cg``."""
    name = getattr(inner_solver, "__name__", type(inner_solver).__name__)
    return name.removeprefix("batch_").removesuffix("_full")


def _cast_precond(M, dtype):
    """M for the inner sweeps: a matrix cast like the operator, and any
    preconditioner object with ``.to`` (Jacobi, AMG, Chebyshev, Neumann,
    FSAI) cast by it, as JAX casts the float leaves of a ``Partial``."""
    if M is None:
        return None
    if is_sparse(M) or isinstance(M, torch.Tensor):
        return _cast_operator(M, dtype)
    if callable(getattr(M, "to", None)):
        return M.to(dtype)
    return M  # a plain callable carries no tensors to cast


def _first_dtype(tree) -> torch.dtype:
    return tree_leaves(tree)[0].dtype


def _inner_dtype(outer_dtype: torch.dtype) -> torch.dtype:
    """The inner sweeps' dtype: complex64 for a complex outer system, else
    float32. The JAX package casts the operator of a complex system to
    float32 and drops its imaginary part (``solvers/mixed.py:52-53``),
    which converges only by defect correction (ROADMAP R12); the port keeps
    the imaginary part."""
    return torch.complex64 if outer_dtype.is_complex else torch.float32


def _make_df_operator(A, outer_dtype):
    """fp64 extended operator for the f64 outer system on CUDA, or None
    (the slot the double-f32 operator held in the JAX package)."""
    if not (isinstance(A, DIA) and A.data.is_cuda
            and outer_dtype == torch.float64):
        return None
    return make_extended_operator_f64(A)


def _sweep(inner_solver, A32, M32, rhs, inner_tol, maxiter, inner_kwargs):
    """One sweep's inner solve of A32 d = rhs from zero: on the runner
    ``extended.sweep_runner`` names, else the inner solver on ``A32`` as it
    is. A sweep on the fused CG kernels 2-3 counts in
    ``refine.fused_sweeps``."""
    run, fused = extended.sweep_runner(inner_solver, A32, rhs, M32)
    REFINE["fused_sweeps"] += int(fused)
    if run is None:
        return inner_solver(A32, rhs, None, tol=inner_tol, maxiter=maxiter,
                            M=M32, **inner_kwargs)
    kw = dict(tol=inner_tol, maxiter=maxiter, **inner_kwargs)
    return run(_method_name(inner_solver), kw, A32, rhs, None, M32)


@tracing.traced("tsp.solver.refine")
def refined_solve(inner_solver: Callable, A, b, x0: Optional[Any] = None, *,
                  tol: float = 1e-8, atol: float = 0.0,
                  inner_tol: float = 1e-5, maxiter: Optional[int] = None,
                  max_sweeps: int = 6, M=None,
                  inner_dtype: Optional[torch.dtype] = None,
                  inner_maxiter: Optional[int] = None,
                  rescue_maxiter: Optional[int] = None, **inner_kwargs):
    """Defect-correction refinement around an f32 inner Krylov solve
    (complex64 for a complex b; ``inner_dtype`` overrides).

    Returns (x, info, total_inner_iterations, residual_norm) in b's dtype.
    """
    A_fn = as_matvec(A)
    outer_dtype = _first_dtype(b)
    if inner_dtype is None:
        inner_dtype = _inner_dtype(outer_dtype)
    if tracing.enabled():
        tracing.annotate(method=_method_name(inner_solver),
                         inner_dtype=str(inner_dtype))
    A_rescue = A
    df_op = _make_df_operator(A, outer_dtype)
    if df_op is not None:
        A_fn = df_op.matvec64
        A_rescue = df_op.matvec64
    A_fn = _counted_residuals(A_fn)
    A32 = _inner_operator(A, inner_dtype, outer_dtype)
    M32 = _cast_precond(M, inner_dtype)
    maxiter = _default_maxiter(b, maxiter)
    if inner_maxiter is None:
        inner_maxiter = maxiter
    if rescue_maxiter is None:
        rescue_maxiter = maxiter

    b_norm = tree_norm(b)
    thresh = torch.clamp_min(tol * b_norm, atol)

    x = tree_zeros_like(b) if x0 is None else x0
    res_norm = tree_norm(tree_sub(b, A_fn(x)))
    inner_iters = torch.zeros((), dtype=torch.int32, device=b_norm.device)
    stalled = torch.zeros((), dtype=torch.bool, device=b_norm.device)

    for i in range(max_sweeps):
        done = (res_norm <= thresh) | (~torch.isfinite(res_norm)) | stalled
        if bool(tracing.host_read(done)):  # the one host read of the sweep
            break
        REFINE["sweeps"] += 1
        with tracing.span("tsp.solver.refine.sweep", i=i):
            r = tree_sub(b, A_fn(x))
            d32, _, it, _ = _sweep(inner_solver, A32, M32,
                                   _cast_tree(r, inner_dtype), inner_tol,
                                   inner_maxiter, inner_kwargs)
            # accept the sweep only if it lowered the true residual: an
            # f32 breakdown can return a finite but useless update
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
    if bool(tracing.host_read(failed)):
        REFINE["rescues"] += 1
        with tracing.span("tsp.solver.refine.rescue"):
            r = tree_sub(b, A_fn(x))
            d, _, it_f, _ = inner_solver(A_rescue, r, None, tol=0.0,
                                         atol=thresh, maxiter=rescue_maxiter,
                                         M=M, **inner_kwargs)
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


def cg_sr_refined(A, b, x0=None, *, tol: float = 1e-8, atol: float = 0.0,
                  inner_tol: float = 1e-5, maxiter: Optional[int] = None,
                  max_sweeps: int = 8, M=None):
    """Defect correction around the single-reduction CG."""
    return refined_solve(cg_sr_full, A, b, x0, tol=tol, atol=atol,
                         inner_tol=inner_tol, maxiter=maxiter,
                         max_sweeps=max_sweeps, M=M)


def minres_refined(A, b, x0=None, *, tol: float = 1e-8, atol: float = 0.0,
                   inner_tol: float = 1e-5, maxiter: Optional[int] = None,
                   max_sweeps: int = 8, M=None):
    """Defect correction around MINRES: symmetric indefinite systems with
    float32 sweeps (a sweep only needs the inner solve to lower the true
    residual, which MINRES does monotonically)."""
    return refined_solve(minres_full, A, b, x0, tol=tol, atol=atol,
                         inner_tol=inner_tol, maxiter=maxiter,
                         max_sweeps=max_sweeps, M=M)


def fcg_refined(A, b, x0=None, *, tol: float = 1e-8, atol: float = 0.0,
                inner_tol: float = 1e-5, maxiter: Optional[int] = None,
                max_sweeps: int = 8, M=None):
    """Defect correction around flexible CG. A preconditioner with ``.to``
    is cast to float32 for the sweeps; a plain callable M is applied to
    float32 vectors there and must accept them."""
    return refined_solve(fcg_full, A, b, x0, tol=tol, atol=atol,
                         inner_tol=inner_tol, maxiter=maxiter,
                         max_sweeps=max_sweeps, M=M)


def fgmres_refined(A, b, x0=None, *, tol: float = 1e-8, atol: float = 0.0,
                   inner_tol: float = 1e-5, restart: int = 20,
                   maxiter: Optional[int] = None, max_sweeps: int = 8,
                   M=None):
    """Defect correction around FGMRES (M as in ``fcg_refined``). Unlike
    ``gmres_refined`` it keeps the given restart, as the JAX package
    does."""
    return refined_solve(fgmres_full, A, b, x0, tol=tol, atol=atol,
                         inner_tol=inner_tol, maxiter=maxiter,
                         max_sweeps=max_sweeps, M=M, restart=restart)


@tracing.traced("tsp.solver.refine")
def batch_refined_solve(inner_solver: Callable, A, B: torch.Tensor,
                        X0=None, *, tol: float = 1e-8, atol: float = 0.0,
                        inner_tol: float = 1e-5,
                        maxiter: Optional[int] = None, max_sweeps: int = 6,
                        M=None, inner_dtype: Optional[torch.dtype] = None,
                        inner_maxiter: Optional[int] = None,
                        rescue_maxiter: Optional[int] = None,
                        **inner_kwargs):
    """``refined_solve`` for each column of an (n, k) block B, with a
    batched inner solver (``batch_cg``, ``batch_bicgstab``,
    ``batch_gmres``, ``batch_fcg``, ``batch_fgmres``, ``batch_minres``). A column that is done solves a zero right-hand side,
    which takes 0 inner iterations, and is never accepted again: each
    column ends as ``refined_solve`` would end it alone. Returns (X,
    infos, inner iterations, res_norms), each per column."""
    from tpu_sparse_torch.kernels import as_matmat
    from tpu_sparse_torch.solvers.batched import cols_norm

    outer_dtype = B.dtype
    if inner_dtype is None:
        inner_dtype = _inner_dtype(outer_dtype)
    if tracing.enabled():
        tracing.annotate(method=_method_name(inner_solver),
                         inner_dtype=str(inner_dtype))
    A_mm = _counted_residuals(as_matmat(A))
    A32 = _inner_operator(A, inner_dtype, outer_dtype)
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

    for i in range(max_sweeps):
        done = (res <= thresh) | (~torch.isfinite(res)) | stalled
        if bool(tracing.host_read(done.all())):  # the sweep's one read
            break
        REFINE["sweeps"] += 1
        with tracing.span("tsp.solver.refine.sweep", i=i):
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
    if bool(tracing.host_read(failed.any())):
        REFINE["rescues"] += 1
        with tracing.span("tsp.solver.refine.rescue"):
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
    of the method's ``*_refined`` (its inner tolerance, sweep count and,
    for GMRES, restart policy). Returns (X, infos, inner_iterations,
    res_norms)."""
    from tpu_sparse_torch.solvers import batched

    inner = {"cg": batched.batch_cg, "cg_sr": batched.batch_cg_sr,
             "bicgstab": batched.batch_bicgstab,
             "gmres": batched.batch_gmres, "fcg": batched.batch_fcg,
             "fgmres": batched.batch_fgmres,
             "minres": batched.batch_minres}
    if method not in inner:
        raise ValueError(f"unknown krylov method: {method}")
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
