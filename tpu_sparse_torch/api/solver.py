"""Unified solver router: ``SparseSolver``, ``solve``, ``SolverResult``.

Counterpart of ``tpu_sparse/api/solver.py`` for the slice this package
ports: the ``krylov`` backend with methods ``cg``, ``bicgstab`` and
``gmres``, no preconditioner or Jacobi, on any operand (a CWELL pack runs
every matvec on K4 / K5), ``reorder="rcm"``, with the extended-layout CUDA
fast paths for square DIA systems:

* float32 ``b`` on CUDA: ``autodiff.implicit.ext_run`` (fused CG kernels,
  K10 for bicgstab without x0 and M, else the method's loop over kernel 1);
* float64 ``b``, ``precision="auto"`` (tol >= 1e-12): defect correction
  (``solvers.mixed.cg_refined`` / ``bicgstab_refined`` / ``gmres_refined``),
  f32 inner sweeps over the extended operator and f64 outer residuals by
  the fp64 kernel on CUDA;
* float64 ``b``, ``precision="full"`` on CUDA (tol >= 1e-11): the method
  with matvecs by the fp64 extended kernel (``ext_run_f64``);
* everything else: the method's ``*_full`` on the operand (CUDA DIA SpMV
  is kernel 1).

Every full-precision solve runs through the adjoint wrappers of
``autodiff.implicit``, as in the JAX router, so ``solve()`` is
differentiable in ``b`` and in a matrix operand's values. The
mixed-precision path is not (nor is it in JAX), and refuses inputs that
require grad.

The JAX ``jit``/``lru_cache`` wrappers are plain calls here. Parts of the
JAX router outside this slice raise ``NotImplementedError`` naming their
ROADMAP queue-1 item; unknown names raise the JAX router's ``ValueError``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple, Union

import torch

from tpu_sparse_torch.api import availability
from tpu_sparse_torch.kernels import as_matvec
from tpu_sparse_torch.kernels.cuda_spmv import extendable
from tpu_sparse_torch.precond.jacobi import (DiagonalPreconditioner,
                                             jacobi_preconditioner)
from tpu_sparse_torch.sparse.containers import DIA, is_sparse, values
from tpu_sparse_torch.utils.tree import tree_norm, tree_sub

_BACKEND_ALIASES = {
    "module_a": "krylov",
    "module_b": "amg",
    "module_c": "direct",
    "auto": "auto",
    "krylov": "krylov",
    "amg": "amg",
    "direct": "direct",
}

_Q1 = "ROADMAP queue 1, item "
_KRYLOV_METHODS = ("cg", "bicgstab", "gmres")
_DEFERRED_METHODS = {
    "cg_sr": _Q1 + "14 (other solvers)",
    "fcg": _Q1 + "14 (other solvers)",
    "minres": _Q1 + "14 (other solvers)",
    "fgmres": _Q1 + "14 (other solvers)",
    "amg": _Q1 + "15 (preconditioners and AMG)",
    "direct": _Q1 + "16 (direct solvers)",
}
_DEFERRED_BACKENDS = {
    "amg": _Q1 + "15 (preconditioners and AMG)",
    "direct": _Q1 + "16 (direct solvers)",
}
_PRECOND_NAMES = ("jacobi", "fsai", "fsai2", "chebyshev", "neumann", "ilu0",
                  "amg")


def _not_ported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: {where}")


class SolverResult:
    """Mirror of the reference SolverResult (solver.py:73-82).

    ``converged``/``iterations``/``residual`` may be device scalars; they
    are read in one transfer on first access, so building a result costs no
    device-to-host round trip."""

    __slots__ = ("x", "backend", "method", "_converged", "_iterations",
                 "_residual", "_fetched")

    def __init__(self, x, converged, iterations, residual, backend, method):
        self.x = x
        self.backend = backend
        self.method = method
        self._converged = converged
        self._iterations = iterations
        self._residual = residual
        self._fetched = not any(isinstance(v, torch.Tensor)
                                for v in (converged, iterations, residual))

    def _materialize(self):
        if self._fetched:
            return
        fields = [self._converged, self._iterations, self._residual]
        on_device = [k for k, v in enumerate(fields)
                     if isinstance(v, torch.Tensor)]
        host = torch.stack([fields[k].detach().reshape(()).double()
                            for k in on_device]).tolist()  # one transfer
        for k, v in zip(on_device, host):
            fields[k] = v
        c, i, r = fields
        self._converged = bool(c)
        self._iterations = None if i is None else int(i)
        self._residual = None if r is None else float(r)
        self._fetched = True

    def replace_x(self, x) -> "SolverResult":
        out = SolverResult(x, self._converged, self._iterations,
                           self._residual, self.backend, self.method)
        out._fetched = self._fetched
        return out

    @property
    def converged(self) -> bool:
        self._materialize()
        return self._converged

    @property
    def iterations(self) -> Optional[int]:
        self._materialize()
        return self._iterations

    @property
    def residual(self) -> Optional[float]:
        self._materialize()
        return self._residual

    def __repr__(self):
        self._materialize()
        return (f"SolverResult(converged={self._converged}, "
                f"iterations={self._iterations}, "
                f"residual={self._residual}, backend={self.backend!r}, "
                f"method={self.method!r})")


class SparseSolver:
    """Unified sparse linear-system solver (reference solver.py:84-508).

    Example:
        >>> solver = SparseSolver()
        >>> x, result = solver.solve(A, b, method='cg')
    """

    def __init__(self, default_backend: str = "auto",
                 default_method: str = "cg", verbose: bool = False):
        self.verbose = verbose
        self.default_backend = default_backend
        self.default_method = default_method
        self._available: Optional[List[str]] = None

    @property
    def available_backends(self) -> List[str]:
        # an empty probe result is not kept: the next call probes again
        if not self._available:
            self._available = availability.get_available_backends()
        return self._available

    def _select_backend(self, backend: str, method: str) -> Tuple[str, str]:
        """Auto-selection of reference solver.py:194-254: direct -> direct
        backend, amg -> amg backend, otherwise krylov."""
        backend = _BACKEND_ALIASES.get(backend, backend)
        available = self.available_backends
        if not available:
            raise RuntimeError("No sparse solver backends are available!")
        if backend != "auto":
            if backend in _DEFERRED_BACKENDS:
                raise _not_ported(f"backend '{backend}'",
                                  _DEFERRED_BACKENDS[backend])
            if backend not in available:
                raise ValueError(
                    f"Backend '{backend}' is not available. "
                    f"Available backends: {available}")
            return backend, method
        if method in ("direct", "amg"):
            raise _not_ported(f"method '{method}'", _DEFERRED_METHODS[method])
        return "krylov", method

    def solve(self, A: Union[Any, Callable], b: torch.Tensor,
              x0: Optional[torch.Tensor] = None, *,
              method: Optional[str] = None, backend: Optional[str] = None,
              tol: float = 1e-6, atol: float = 0.0,
              maxiter: Optional[int] = None, M: Optional[Any] = None,
              restart: int = 20, solve_method: str = "batched",
              precision: str = "auto", reorder: Optional[str] = None,
              **kwargs) -> Tuple[torch.Tensor, SolverResult]:
        """Solve Ax = b. Returns (x, SolverResult).

        precision: 'full' solves in b's dtype; 'mixed' runs f32 inner
        Krylov sweeps with defect correction to the requested tolerance;
        'auto' picks 'mixed' for real float64 solves with tol >= 1e-12 and
        a matrix operand, 'full' otherwise. 'full' is differentiable in b
        and a matrix operand's values (one adjoint solve); 'mixed' is not.

        M: None, a preconditioner callable, or 'jacobi'.

        reorder: 'rcm' symmetrically permutes the system with a
        reverse-Cuthill-McKee ordering (on the host, cached per matrix
        content), solves the permuted system as CSR and un-permutes the
        solution. It needs a matrix operand.

        restart and solve_method: GMRES's restart length and
        'batched' | 'incremental'; the other methods do not read them.
        """
        if precision not in ("auto", "full", "mixed"):
            raise ValueError(f"unknown precision '{precision}'; use "
                             "'auto', 'full' or 'mixed'")
        if hasattr(A, "shape") and hasattr(b, "shape") and b.dim() >= 1 \
                and b.shape[0] != A.shape[0]:
            raise ValueError(
                f"dimension mismatch: A is {tuple(A.shape)}, b has length "
                f"{b.shape[0]}")
        if reorder is not None:
            return self._solve_reordered(
                A, b, x0, reorder, method=method, backend=backend, tol=tol,
                atol=atol, maxiter=maxiter, M=M, restart=restart,
                solve_method=solve_method, precision=precision, **kwargs)
        method = method or self.default_method
        backend = backend or self.default_backend
        sel_backend, sel_method = self._select_backend(backend, method)
        if sel_method in _DEFERRED_METHODS:
            raise _not_ported(f"method '{sel_method}'",
                              _DEFERRED_METHODS[sel_method])
        if sel_method not in _KRYLOV_METHODS:
            raise ValueError(f"unknown krylov method: {sel_method}")
        _check_in_slice(A, b, x0, M)
        if precision == "auto":
            precision = ("mixed" if _auto_mixed_ok(A, b, tol, sel_backend)
                         else "full")
        if precision == "mixed" and _requires_grad(A, b, x0, M):
            raise ValueError(
                "precision='mixed' is not differentiable (its inner solves "
                "are iteration loops; the JAX package refuses the same): "
                "pass precision='full' to differentiate through solve()")
        if self.verbose:
            print(f"[SparseSolver] backend={sel_backend} "
                  f"method={sel_method} precision={precision}")
        if isinstance(M, str):
            M = self._precond_M(A, M)

        kw = dict(tol=tol, atol=atol, maxiter=maxiter)
        if sel_method == "gmres":
            kw.update(restart=restart, solve_method=solve_method)
        if precision == "mixed":
            x, info, iters, res, rel = self._solve_krylov_mixed(
                A, b, x0, sel_method, kw, M)
        else:
            x, info, iters, res, rel = self._solve_krylov(
                A, b, x0, sel_method, kw, M)
        result = SolverResult(x=x, converged=(info == 0), iterations=iters,
                              residual=rel, backend=sel_backend,
                              method=sel_method)
        return x, result

    def _precond_M(self, A, spec: str):
        """Resolve a string preconditioner name."""
        name = spec.lower()
        if name not in _PRECOND_NAMES:
            raise ValueError(
                f"unknown preconditioner '{spec}'; available: "
                f"{', '.join(_PRECOND_NAMES)}")
        if name != "jacobi":
            raise _not_ported(f"M='{spec}'",
                              _Q1 + "15 (preconditioners and AMG)")
        if callable(A) and not is_sparse(A) \
                and not isinstance(A, torch.Tensor):
            raise ValueError(
                f"M='{spec}' needs a matrix operand to build from; "
                "matrix-free callables must pass M as a callable")
        return jacobi_preconditioner(A)

    def _reorder_cached(self, A):
        """(A_rcm as CSR, perm, inverse perm) for a matrix operand, cached
        per matrix content. The permuted matrix lives on A's device."""
        from tpu_sparse_torch.utils.opcache import OperandCache

        cached = getattr(self, "_reorder_cache", None)
        if cached is None:
            cached = self._reorder_cache = OperandCache(max_entries=8)

        def build():
            import numpy as np
            from scipy.sparse.csgraph import reverse_cuthill_mckee

            from tpu_sparse_torch.sparse.convert import (csr_from_arrays,
                                                         to_scipy_csr)

            # one scipy matrix serves the ordering and the permutation
            S = to_scipy_csr(A)
            perm = np.array(reverse_cuthill_mckee(S, symmetric_mode=False),
                            dtype=np.int64)  # scipy may return a reversed view
            Sp = S[perm][:, perm].tocsr()
            Sp.sort_indices()
            dev = A.device
            Ap = csr_from_arrays(Sp.data, Sp.indices, Sp.indptr, S.shape,
                                 device=dev)
            return (Ap, torch.from_numpy(perm).to(dev),
                    torch.from_numpy(np.argsort(perm)).to(dev))

        return cached.get_or_build(A, build, extra=("rcm",))

    def _solve_reordered(self, A, b, x0, reorder: str, *, M=None, **kw):
        """Symmetric RCM permutation (JAX ``_solve_reordered``): solve
        P A P^T (P x) = P b and un-permute. The permuted system is solved
        as CSR, as in the JAX package."""
        if reorder != "rcm":
            raise ValueError(f"unknown reorder '{reorder}'; use 'rcm'")
        if callable(A) and not is_sparse(A) \
                and not isinstance(A, torch.Tensor):
            raise ValueError("reorder requires a matrix operand, not a "
                             "matrix-free callable")
        if M is not None and not isinstance(M, str):
            raise ValueError(
                "reorder supports M=None or a built-in string name (the "
                "preconditioner is then built from the permuted matrix); a "
                "user callable M would act in the wrong ordering")
        Ap, perm, inv = self._reorder_cached(A)
        bp = b[perm.to(b.device)]
        x0p = None if x0 is None else x0[perm.to(x0.device)]
        x, result = self.solve(Ap, bp, x0p, M=M, reorder=None, **kw)
        xu = x[inv.to(x.device)]
        return xu, result.replace_x(xu)

    def _solve_krylov(self, A, b, x0, method, kw, M):
        from tpu_sparse_torch.autodiff import implicit

        fast = (isinstance(A, DIA) and _extendable_m(M)
                and isinstance(b, torch.Tensor) and b.is_cuda
                and A.data.is_cuda and A.data.dtype == b.dtype
                and extendable(A))
        if fast and b.dtype == torch.float32:
            out = implicit.ext_krylov_diff(method, kw, A, b, x0, M)
            return out + (out[3] / _safe_norm(b.detach()),)
        if fast and b.dtype == torch.float64 and kw["tol"] >= 1e-11:
            out = implicit.ext_krylov_diff_f64(method, kw, A, b, x0, M)
            return out + (out[3] / _safe_norm(b.detach()),)
        diff = {"cg": implicit.cg_diff, "bicgstab": implicit.bicgstab_diff,
                "gmres": implicit.gmres_diff}[method]
        out = diff(A, b, x0, M=M, **kw)
        return out + (_relative_residual(A, b, out[0]),)

    def _solve_krylov_mixed(self, A, b, x0, method, kw, M):
        from tpu_sparse_torch.solvers import mixed

        refined = {"cg": mixed.cg_refined,
                   "bicgstab": mixed.bicgstab_refined,
                   "gmres": mixed.gmres_refined}[method]
        out = refined(A, b, x0, M=M, **kw)
        return out + (_relative_residual(A, b, out[0]),)

    def cg(self, A, b, **kw):
        return self.solve(A, b, method="cg", **kw)

    def bicgstab(self, A, b, **kw):
        return self.solve(A, b, method="bicgstab", **kw)

    def gmres(self, A, b, **kw):
        return self.solve(A, b, method="gmres", **kw)


def _tensors(A, b, x0, M) -> list:
    out = [b, x0, A if isinstance(A, torch.Tensor)
           else values(A) if is_sparse(A) else None]
    if isinstance(M, DiagonalPreconditioner):
        out.append(M.dinv)
    return [t for t in out if isinstance(t, torch.Tensor)]


def _requires_grad(A, b, x0, M) -> bool:
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in _tensors(A, b, x0, M))


def _check_in_slice(A, b, x0, M) -> None:
    """Refuse inputs the slice does not cover yet, naming the queue item."""
    tensors = _tensors(A, b, x0, M)
    if isinstance(b, torch.Tensor) and b.dim() == 2:
        raise _not_ported("multi-RHS b", _Q1 + "13 (multi-RHS)")
    if any(t.is_complex() for t in tensors):
        raise _not_ported("complex input", _Q1 + "13 (native complex)")


def _safe_norm(b) -> torch.Tensor:
    bn = tree_norm(b)
    return torch.where(bn > 0, bn, torch.ones_like(bn))


def _relative_residual(A, b, x) -> torch.Tensor:
    """||b - A x|| / ||b||, off the autograd graph (a report)."""
    with torch.no_grad():
        return tree_norm(tree_sub(b, as_matvec(A)(x))) / _safe_norm(b)


def _extendable_m(M) -> bool:
    """The extended paths take M=None or a diagonal preconditioner (unit
    margins keep the zero-margin invariant)."""
    return M is None or isinstance(M, DiagonalPreconditioner)


def _auto_mixed_ok(A, b, tol: float, sel_backend: str) -> bool:
    """precision='auto': real-float64 Krylov solves with a matrix operand
    and a reachable tolerance run defect correction."""
    if sel_backend != "krylov" or tol < 1e-12:
        return False
    if callable(A) and not is_sparse(A) and not isinstance(A, torch.Tensor):
        return False  # matrix-free callables cannot be precision-cast
    return getattr(b, "dtype", None) == torch.float64


_default_solver: Optional[SparseSolver] = None


def _get_default_solver() -> SparseSolver:
    global _default_solver
    if _default_solver is None:
        _default_solver = SparseSolver()
    return _default_solver


def solve(A, b, method: str = "cg", backend: str = "auto", **kwargs):
    """Solve Ax=b via the shared default SparseSolver."""
    return _get_default_solver().solve(A, b, method=method, backend=backend,
                                       **kwargs)


def cg(A, b, **kwargs):
    return solve(A, b, method="cg", **kwargs)


def bicgstab(A, b, **kwargs):
    return solve(A, b, method="bicgstab", **kwargs)


def gmres(A, b, **kwargs):
    return solve(A, b, method="gmres", **kwargs)
