"""Unified solver router: ``SparseSolver``, ``solve``, ``SolverResult``.

Counterpart of ``tpu_sparse/api/solver.py``: the ``krylov`` backend with
methods ``cg``, ``cg_sr``, ``fcg``, ``minres``, ``bicgstab``, ``gmres`` and
``fgmres`` on any operand (a CWELL pack runs every matvec on K4 / K5), the
``amg`` backend (AMG-preconditioned CG, or with ``accelerant=None`` the
stationary V-cycle iteration), the ``direct`` backend (``method="direct"``,
``_solve_direct``), the preconditioners ``M="jacobi" | "amg" |
"chebyshev" | "neumann" | "fsai" | "fsai2" | "ilu0"`` (built once per
matrix content and cached), ``reorder="rcm"``, with the extended-layout
CUDA fast paths for square DIA systems (M None or Jacobi):

* float64 ``b``, ``precision="auto"`` (tol >= 1e-12), every method:
  defect correction (``solvers.mixed.*_refined``), f32 inner sweeps on
  the runner ``solvers.extended.runner`` names for them and f64 outer
  residuals by the fp64 kernel on CUDA;
* every other solve runs the runner ``solvers.extended.runner`` names
  (the one owner of that choice) under the adjoint wrapper: for cg /
  bicgstab / gmres on a CUDA DIA, ``ext_run`` for a float32 ``b`` and for
  bf16 data with a float32 or bf16 ``b`` (fused CG kernels, K10 for
  bicgstab without x0 and M, else the method's loop over kernel 1's
  extended mode), ``ext_run_f64`` for a float64 ``b`` at tol >= 1e-11 (the
  method with matvecs by the fp64 extended kernel);
* with no runner: the method's ``*_diff`` on the operand (CUDA DIA SpMV
  is kernel 1); ``cg_sr``, ``fcg``, ``minres`` and ``fgmres`` always take
  this general path, as in the JAX router.

A direct solve of a banded, small or dense system runs
``direct.direct_solve`` under the adjoint wrapper. A general sparse system
beyond the densify limit (n > 4096) is factored once per matrix (cached on
its values tensor): on the card by the supernodal LU, whose solves run K4 /
K5 (K6/K7 for an (n, k) b) and take one refinement step; on the CPU by
scipy's SuperLU on the host, as the JAX package does off the TPU. There is
no fallback between them: the card's path is the supernodal LU or an
exception.

Every full-precision solve runs through the adjoint wrappers of
``autodiff.implicit``, as in the JAX router, so ``solve()`` is
differentiable in ``b``, in a matrix operand's values and in the tensors
a matrix-free operator depends on. The mixed-precision path is not (nor
is it in JAX), and refuses inputs that require grad.

A 2-D ``b`` of shape (n, k) is a multi-RHS solve (``_solve_multirhs``,
JAX ``_solve_multirhs``): block CG (``solvers.block``) or the batched
solvers (``solvers.batched``), chosen by ``multi_rhs="auto" | "block" |
"batch"``, and ``batch_refined`` for the mixed precision; every matvec is
one SpMM. As in the JAX package it is not differentiable (its loops run
outside the adjoint wrappers), so inputs that require grad are refused.

A matrix operand and a right-hand side of different dtypes solve in
their common dtype: ``b`` and ``x0`` are promoted to
``torch.result_type(values(A), b)`` before any route is chosen (a
float64 matrix with a float32 b is a float64 solve for every method).

Complex64 and complex128 operands solve natively, as the JAX package
solves them off the TPU, through every route of a real operand but the
extended fast paths (those are real): the general Krylov loops, the
refinement (complex64 inner sweeps), the preconditioners, AMG, the
direct solvers and (n, k) right-hand sides; on the card every matvec
runs the complex build of the kernel its container takes (kernel 1, K4 /
K5, K6/K7, K8). A real matrix with a complex b is cast to b's dtype
once per solve (``_promote_operand``), so no matvec casts.

bf16 operands solve as the JAX package runs them: a bf16 matrix with a
float32 b solves in float32 (b promoted to the common dtype) over the
bf16 builds of the kernels, with no values cast; a bf16 b with bf16
values solves in bf16; a square bf16 DIA takes the extended route above
(JAX ``:399-407``); ``precision='auto'`` stays 'full'. A bf16 matrix
with a float64 or complex b is cast once per solve, as a real one with a
complex b.

The JAX ``jit``/``lru_cache`` wrappers are plain calls here. Unknown
names raise the JAX router's ``ValueError``.
"""

from __future__ import annotations

import functools
import warnings
from contextlib import contextmanager
from enum import Enum
from typing import Any, Callable, List, Optional, Tuple, Union

import torch

from tpu_sparse_torch import tracing
from tpu_sparse_torch.api import availability
from tpu_sparse_torch.kernels import as_matvec, cast_values
from tpu_sparse_torch.precond.jacobi import DiagonalPreconditioner
from tpu_sparse_torch.sparse.containers import is_sparse, values
from tpu_sparse_torch.utils.opcache import OperandCache, TensorCache, _leaves
from tpu_sparse_torch.utils.tree import tree_norm, tree_sub

class SolverMethod(Enum):
    """The method names ``solve()`` takes (as their string values)."""
    CG = "cg"
    CG_SR = "cg_sr"
    FCG = "fcg"
    MINRES = "minres"
    BICGSTAB = "bicgstab"
    GMRES = "gmres"
    FGMRES = "fgmres"
    AMG = "amg"
    DIRECT = "direct"


class SolverBackend(Enum):
    """The backend names ``solve()`` takes (as their string values)."""
    KRYLOV = "krylov"
    AMG = "amg"
    DIRECT = "direct"
    AUTO = "auto"


_BACKEND_ALIASES = {
    "module_a": "krylov",
    "module_b": "amg",
    "module_c": "direct",
    "auto": "auto",
    "krylov": "krylov",
    "amg": "amg",
    "direct": "direct",
}

_KRYLOV_METHODS = ("cg", "cg_sr", "fcg", "minres", "bicgstab", "gmres",
                   "fgmres")
_PRECOND_NAMES = ("jacobi", "fsai", "fsai2", "chebyshev", "neumann", "ilu0",
                  "amg")


class SolverResult:
    """Mirror of the reference SolverResult (solver.py:73-82).

    ``converged``/``iterations``/``residual`` may be device scalars; they
    are read in one transfer on first access, so building a result costs no
    device-to-host round trip. Under a profiler, that read is counted on
    the solve's ``tsp.solve`` record with the iterations it reports."""

    __slots__ = ("x", "backend", "method", "_converged", "_iterations",
                 "_residual", "_fetched", "_record")

    def __init__(self, x, converged, iterations, residual, backend, method):
        self.x = x
        self.backend = backend
        self.method = method
        self._converged = converged
        self._iterations = iterations
        self._residual = residual
        self._fetched = not any(isinstance(v, torch.Tensor)
                                for v in (converged, iterations, residual))
        self._record = None  # the tsp.solve record, while tracing

    def _materialize(self):
        if self._fetched:
            return
        fields = [self._converged, self._iterations, self._residual]
        on_device = [k for k, v in enumerate(fields)
                     if isinstance(v, torch.Tensor)]
        host = tracing.host_read(torch.stack(
            [fields[k].detach().reshape(()).double()
             for k in on_device])).tolist()  # one transfer
        for k, v in zip(on_device, host):
            fields[k] = v
        c, i, r = fields
        self._converged = bool(c)
        self._iterations = None if i is None else int(i)
        self._residual = None if r is None else float(r)
        self._fetched = True
        if self._record is not None:
            self._record.bump("solver.host_syncs")
            self._record.attrs["iterations"] = self._iterations

    def replace_x(self, x) -> "SolverResult":
        out = SolverResult(x, self._converged, self._iterations,
                           self._residual, self.backend, self.method)
        out._fetched = self._fetched
        out._record = self._record
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


def _solve_span(solve):
    """``SparseSolver.solve`` inside the request's ``tsp.solve`` span; the
    result keeps its record, so that reading it is counted there."""

    @functools.wraps(solve)
    def traced(self, A, b, *args, **kwargs):
        with tracing.span(tracing.ROOT) as sp:
            x, result = solve(self, A, b, *args, **kwargs)
        if sp.record is not None:
            result._record = sp.record
        return x, result

    return traced


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
        # built preconditioners, per matrix content (JAX sizes)
        self._m_cache = OperandCache(max_entries=16, name="M")
        self._amg_cache = OperandCache(max_entries=8, name="amg")
        # direct factors, one per live values tensor (a factor costs
        # seconds of host work: no size cap that would drop a live one)
        self._snlu_cache = TensorCache()
        self._host_lu_cache = TensorCache()
        # real operands cast to a complex b's dtype, per matrix content
        self._cast_cache = OperandCache(max_entries=8, name="cast")

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
            if backend not in available:
                raise ValueError(
                    f"Backend '{backend}' is not available. "
                    f"Available backends: {available}")
            return backend, method
        if method == "direct":
            if "direct" not in available:
                raise ValueError(
                    "Direct solver backend is not available; use an "
                    "iterative method (cg, bicgstab, gmres) instead.")
            return "direct", "direct"
        if method == "amg":
            if "amg" not in available:
                raise ValueError("AMG backend is not available.")
            return "amg", "amg"
        return "krylov", method

    @_solve_span
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

        M: None, a preconditioner callable, or one of the names 'jacobi' |
        'amg' | 'chebyshev' | 'neumann' | 'fsai' | 'fsai2' | 'ilu0' (built
        once per matrix content and cached; 'ilu0' takes a DIA matrix). A
        non-diagonal M leaves the extended DIA fast paths for the method's
        loop.

        A b (or x0) whose dtype differs from a matrix operand's values is
        promoted to their common dtype first.

        backend='amg' (or method='amg') solves with AMG-preconditioned CG;
        ``accelerant=None`` runs the stationary V-cycle iteration instead
        (AMGX's 0 pre / 3 post sweeps unless given). Other keyword
        arguments are the AMG set-up's and sweeps' (``theta``,
        ``pre_sweeps``, ...); maxiter defaults to 100 and M is ignored.

        reorder: 'rcm' symmetrically permutes the system with a
        reverse-Cuthill-McKee ordering (on the host, cached per matrix
        content), solves the permuted system as CSR and un-permutes the
        solution. It needs a matrix operand.

        restart: the restart length of GMRES and FGMRES; solve_method:
        GMRES's 'batched' | 'incremental'. The other methods do not read
        them.

        A 2-D b (n, k) solves every column: ``multi_rhs='auto'`` runs CG
        and single-reduction CG as block CG when M is given and batched CG
        otherwise (reported as the method asked for), the other methods
        batched; 'block' and 'batch' force CG's choice. 'auto' precision
        stays 'full' under multi_rhs='block'. The result reports the
        largest iteration count and relative residual over the columns,
        and converged only if every column did.
        """
        if precision not in ("auto", "full", "mixed"):
            raise ValueError(f"unknown precision '{precision}'; use "
                             "'auto', 'full' or 'mixed'")
        if hasattr(A, "shape") and hasattr(b, "shape") and b.dim() >= 1 \
                and b.shape[0] != A.shape[0]:
            raise ValueError(
                f"dimension mismatch: A is {tuple(A.shape)}, b has length "
                f"{b.shape[0]}")
        b, x0 = _promote_rhs(A, b, x0)
        A = self._promote_operand(A, b)
        if reorder is not None:
            return self._solve_reordered(
                A, b, x0, reorder, method=method, backend=backend, tol=tol,
                atol=atol, maxiter=maxiter, M=M, restart=restart,
                solve_method=solve_method, precision=precision, **kwargs)
        method = method or self.default_method
        backend = backend or self.default_backend
        sel_backend, sel_method = self._select_backend(backend, method)
        multi_rhs = kwargs.pop("multi_rhs", "auto")
        if sel_backend == "krylov":
            if sel_method not in _KRYLOV_METHODS:
                raise ValueError(f"unknown krylov method: {sel_method}")
        multi = isinstance(b, torch.Tensor) and b.dim() == 2
        if precision == "auto":
            # an explicit multi_rhs='block' keeps full precision: the mixed
            # multi-RHS path is the batched refinement (JAX router :240-246)
            precision = ("mixed" if _auto_mixed_ok(A, b, tol, sel_backend)
                         and multi_rhs != "block" else "full")
        if multi and _requires_grad(A, b, x0, M):
            raise ValueError(
                "a multi-RHS solve is not differentiable: the JAX package "
                "runs its block and batched loops (lax.while_loop) outside "
                "the adjoint wrappers, and the port keeps that contract; "
                "solve the columns one at a time to differentiate")
        if precision == "mixed" and _requires_grad(A, b, x0, M):
            raise ValueError(
                "precision='mixed' is not differentiable (its inner solves "
                "are iteration loops; the JAX package refuses the same): "
                "pass precision='full' to differentiate through solve()")
        if tracing.enabled():
            tensor = isinstance(b, torch.Tensor)
            tracing.annotate(backend=sel_backend, method=sel_method,
                             precision=precision,
                             n=int(b.shape[0]) if tensor else None,
                             dtype=str(b.dtype) if tensor else None)
        if self.verbose:
            print(f"[SparseSolver] backend={sel_backend} "
                  f"method={sel_method} precision={precision}")
        if M is not None and sel_backend in ("amg", "direct"):
            # AMG builds its own preconditioner and the direct path
            # factors A: say that M is dropped
            warnings.warn(
                f"M is ignored for backend='{sel_backend}' "
                f"(method='{sel_method}'); use a krylov method to apply a "
                "preconditioner.",
                stacklevel=2)
            M = None
        elif isinstance(M, str):
            M = self._precond_M(A, M)
        if multi:
            return self._solve_multirhs(
                A, b, x0, sel_backend, sel_method, tol, atol, maxiter, M,
                restart, solve_method, precision, multi_rhs, kwargs)
        if sel_backend != "krylov":
            x, info, iters, res, rel = (
                self._solve_amg(A, b, x0, tol, atol, maxiter, **kwargs)
                if sel_backend == "amg" else self._solve_direct(A, b))
            return x, SolverResult(x=x, converged=(info == 0),
                                   iterations=iters, residual=rel,
                                   backend=sel_backend, method=sel_method)

        kw = dict(tol=tol, atol=atol, maxiter=maxiter)
        if sel_method == "gmres":
            kw.update(restart=restart, solve_method=solve_method)
        elif sel_method == "fgmres":
            kw.update(restart=restart)
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

    def _promote_operand(self, A, b):
        """A matrix operand with real values and a complex b, or with bf16
        values and a b that no bf16 build takes (float64 or complex), cast
        once to b's dtype: cached per matrix content, so a repeat solve
        casts nothing and its preconditioner and factor caches hit; cast
        anew in each solve whose values require grad, so the gradient
        reaches the values through the cast. Any other operand as it is
        (a bf16 matrix with a float32 or bf16 b runs the bf16 builds)."""
        if _matrix_free(A) or not isinstance(b, torch.Tensor):
            return A
        v = A if isinstance(A, torch.Tensor) else values(A)
        cast = b.is_complex() or (v.dtype == torch.bfloat16
                                  and b.dtype == torch.float64)
        if v.is_complex() or not cast:
            return A
        if torch.is_grad_enabled() and v.requires_grad:
            return cast_values(A, b.dtype)
        return self._cast_cache.get_or_build(
            A, lambda: cast_values(A, b.dtype), extra=(b.dtype,))

    def _precond_M(self, A, spec: str):
        """Resolve a string preconditioner name to a preconditioner built
        once per matrix content (JAX ``_precond_M``)."""
        name = spec.lower()
        if name not in _PRECOND_NAMES:
            raise ValueError(
                f"unknown preconditioner '{spec}'; available: "
                f"{', '.join(_PRECOND_NAMES)}")
        if _matrix_free(A):
            raise ValueError(
                f"M='{spec}' needs a matrix operand to build from; "
                "matrix-free callables must pass M as a callable")
        if name == "amg":
            return self._amg_M(A)

        def build():
            from tpu_sparse_torch import precond as P

            if name == "jacobi":
                return P.jacobi_preconditioner(A)
            if name == "fsai":
                return P.fsai_preconditioner(A)
            if name == "fsai2":
                return P.fsai_preconditioner(A, pattern_power=2)
            if name == "chebyshev":
                return P.chebyshev_preconditioner(A)
            if name == "neumann":
                return P.neumann_preconditioner(A)
            return P.ilu0_preconditioner(A)  # DIA only; raises otherwise

        return self._m_cache.get_or_build(A, build, extra=(name,))

    def _amg_M(self, A, **kwargs):
        """The AMG preconditioner of A for the set-up and sweep options
        ``kwargs``. The hierarchy (a host graph phase) is built once per
        matrix content and set-up options; the sweep options only wrap it,
        so the stationary and the CG routes share one set-up."""
        from tpu_sparse_torch.precond.amg import (SWEEP_OPTIONS,
                                                  AMGPreconditioner,
                                                  amg_setup)

        if _matrix_free(A):
            raise ValueError("AMG needs a matrix operand to build its "
                             "hierarchy from, not a matrix-free callable")
        sweeps = {k: kwargs.pop(k) for k in SWEEP_OPTIONS if k in kwargs}
        hier = self._amg_cache.get_or_build(
            A, lambda: amg_setup(A, **kwargs),
            extra=tuple(sorted(kwargs.items())))
        return AMGPreconditioner(hier, **sweeps)

    def _solve_amg(self, A, b, x0, tol, atol, maxiter, **kwargs):
        """backend='amg' (JAX ``_solve_amg``): CG with the V-cycle as M
        (``accelerant='cg'``, the default), or the stationary iteration
        x <- x + V(b - A x) with AMGX's 0 / 3 / omega = 1 sweeps
        (``accelerant=None``)."""
        from tpu_sparse_torch.autodiff import cg_diff
        from tpu_sparse_torch.precond.amg import amg_stationary_solve

        accelerant = kwargs.pop("accelerant", "cg")
        maxiter = maxiter if maxiter is not None else 100
        if accelerant in (None, "none"):
            if _requires_grad(A, b, x0, None):
                raise ValueError(
                    "the stationary AMG iteration (accelerant=None) is not "
                    "differentiable; use the default accelerant='cg'")
            kwargs.setdefault("pre_sweeps", 0)
            kwargs.setdefault("post_sweeps", 3)
            kwargs.setdefault("omega", 1.0)
            x, info, iters, res = amg_stationary_solve(
                A, b, x0, tol=tol, atol=atol, maxiter=maxiter,
                precond=self._amg_M(A, **kwargs))
            return x, info, iters, res, res / _safe_norm(b)
        out = cg_diff(A, b, x0, tol=tol, atol=atol, maxiter=maxiter,
                      M=self._amg_M(A, **kwargs))
        return out + (_relative_residual(A, b, out[0]),)

    def _supernodal_lu(self, A, with_transpose: bool = False):
        """The supernodal LU of A (``direct.SupernodalLU``), cached on A's
        values tensor with its index tensors' versions as the extra key.
        The transpose solve's packs are built only when a gradient needs
        them (they double the off-diagonal pack memory); a cached factor
        without them is rebuilt with them then."""
        from tpu_sparse_torch.direct import SupernodalLU

        v, key = values(A), _index_key(A)
        lu = self._snlu_cache.get(v, key)
        if lu is None or (with_transpose and not lu.has_transpose):
            with tracing.span("tsp.router.build.factors"):
                lu = SupernodalLU.factor(A, with_transpose=with_transpose)
            self._snlu_cache.put(v, lu, key)
        return lu

    def _host_splu(self, A):
        """scipy's SuperLU factors of A on the host (``direct.HostLU``),
        cached as ``_supernodal_lu``."""
        from tpu_sparse_torch.direct import HostLU

        v, key = values(A), _index_key(A)
        lu = self._host_lu_cache.get(v, key)
        if lu is None:
            with tracing.span("tsp.router.build.factors"):
                lu = HostLU(A)
            self._host_lu_cache.put(v, lu, key)
        return lu

    def _direct_factors(self, A, b):
        """The cached factors a general sparse direct solve uses (None for
        the systems ``direct.direct_solve`` takes): the supernodal LU for
        a CUDA b, the host SuperLU for a CPU one."""
        from tpu_sparse_torch.direct import needs_host_splu

        if not needs_host_splu(A):
            return None
        if b.is_cuda:
            return self._supernodal_lu(
                A, with_transpose=_requires_grad(A, b, None, None))
        return self._host_splu(A)

    def _solve_direct(self, A, b):
        """method='direct' (JAX ``_solve_direct``): banded, dense and small
        systems by ``direct_solve`` under the adjoint wrapper; general
        sparse systems beyond the densify limit by their cached factors,
        with one refinement step on the card (the JAX TPU router's
        ``_jitted_supernodal``). Differentiable in b and A's values either
        way. Returns (x, info, None, res, rel)."""
        from tpu_sparse_torch import direct

        lu = self._direct_factors(A, b)
        if lu is None:
            x = direct.direct_solve_diff(A, b)
        else:
            x = direct.factored_solve(lu, A, b, refine=b.is_cuda)
        info, res, rel = direct.direct_residual_info(A, b, x)
        return x, info, None, res, rel

    def _reorder_cached(self, A):
        """(A_rcm as CSR, perm, inverse perm) for a matrix operand, cached
        per matrix content. The permuted matrix lives on A's device."""
        cached = getattr(self, "_reorder_cache", None)
        if cached is None:
            cached = self._reorder_cache = OperandCache(max_entries=8,
                                                        name="rcm")

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
        if _matrix_free(A):
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
        from tpu_sparse_torch.solvers import extended

        run = extended.runner(method, A, b, M, kw["tol"])
        if run is not None:
            out = implicit.implicit_solve(run, method, kw, A, b, x0, M)
            return out + (out[3] / _safe_norm(b.detach()),)
        out = getattr(implicit, f"{method}_diff")(A, b, x0, M=M, **kw)
        return out + (_relative_residual(A, b, out[0]),)

    def _solve_krylov_mixed(self, A, b, x0, method, kw, M):
        from tpu_sparse_torch.solvers import mixed

        out = getattr(mixed, f"{method}_refined")(A, b, x0, M=M, **kw)
        return out + (_relative_residual(A, b, out[0]),)

    def _solve_multirhs(self, A, B, X0, sel_backend, method, tol, atol,
                        maxiter, M, restart, solve_method, precision,
                        multi_rhs, amg_kwargs):
        """(n, k) right-hand sides (JAX ``_solve_multirhs``): block CG for
        CG and single-reduction CG with a preconditioner ('auto') or on
        request, batched CG for them otherwise, the batched solvers for the
        other methods; precision='mixed' runs the batched refinement.
        backend='amg' solves with CG and the V-cycle as M (its ``matmat``:
        one SpMM per level operator), maxiter 100 by default."""
        from tpu_sparse_torch.solvers import batched, batch_refined, block_cg

        if multi_rhs not in ("auto", "block", "batch"):
            raise ValueError(f"unknown multi_rhs '{multi_rhs}'; use "
                             "'auto', 'block', or 'batch'")
        if sel_backend == "direct":
            # every column at once: the factors' solve takes (n, k)
            # natively (K6/K7 on the card), the other systems one
            # ``batch_direct``
            from tpu_sparse_torch import direct

            lu = self._direct_factors(A, B)
            X = (batched.batch_direct(A, B) if lu is None
                 else direct.factored_solve(lu, A, B, refine=B.is_cuda))
            info, _, rel = direct.direct_residual_info(A, B, X)
            return X, SolverResult(x=X, converged=(info == 0),
                                   iterations=None, residual=rel,
                                   backend=sel_backend, method=method)
        report_method = method
        if sel_backend == "amg":
            M = self._amg_M(A, **amg_kwargs)
            maxiter = maxiter if maxiter is not None else 100
            method = "cg"
        kw = dict(tol=tol, atol=atol, maxiter=maxiter, M=M)
        if method == "gmres":
            kw.update(restart=restart, solve_method=solve_method)
        elif method == "fgmres":
            kw.update(restart=restart)
        if precision == "mixed":
            if multi_rhs == "block":
                warnings.warn(
                    "multi_rhs='block' is unavailable with "
                    "precision='mixed'; using the batched refinement "
                    "instead.", stacklevel=3)
            X, infos, iters, res = batch_refined(method, A, B, X0, **kw)
            iters = iters.max()
        elif method in ("cg", "cg_sr") and (multi_rhs == "block" or (
                multi_rhs == "auto" and M is not None)):
            # measured in the JAX package: for independent right-hand sides
            # batched CG beats block CG; a preconditioned solve keeps it.
            # Block CG already fuses its reductions across the block, so
            # the single-reduction form adds nothing (JAX router :756-779)
            X, infos, iters, res = block_cg(A, B, X0, **kw)
        else:
            fn = getattr(batched, "batch_cg" if method == "cg_sr"
                         else f"batch_{method}")
            X, infos, iters, res = fn(A, B, X0, **kw)
            iters = iters.max()
        with torch.no_grad():
            bn = torch.linalg.vector_norm(B, dim=0)
            rel = torch.max(res / torch.where(bn > 0, bn,
                                              torch.ones_like(bn)))
        result = SolverResult(x=X, converged=torch.all(infos == 0),
                              iterations=iters, residual=rel,
                              backend=sel_backend, method=report_method)
        return X, result

    def cg(self, A, b, **kw):
        return self.solve(A, b, method="cg", **kw)

    def bicgstab(self, A, b, **kw):
        return self.solve(A, b, method="bicgstab", **kw)

    def gmres(self, A, b, **kw):
        return self.solve(A, b, method="gmres", **kw)

    def amg(self, A, b, **kw):
        return self.solve(A, b, method="amg", **kw)

    def direct(self, A, b, **kw):
        return self.solve(A, b, method="direct", **kw)

    @contextmanager
    def session(self):
        """Batch-solving context (reference solver.py:102-106): ``with
        solver.session() as s: s.solve(...)``; probes the backends once up
        front and yields this solver."""
        _ = self.available_backends
        yield self


def _matrix_free(A) -> bool:
    """A matrix-free callable operator (not a container or a tensor)."""
    return callable(A) and not is_sparse(A) \
        and not isinstance(A, torch.Tensor)


def _tensors(A, b, x0, M) -> list:
    out = [b, x0, A if isinstance(A, torch.Tensor)
           else values(A) if is_sparse(A) else None]
    if isinstance(M, DiagonalPreconditioner):
        out.append(M.dinv)
    return [t for t in out if isinstance(t, torch.Tensor)]


def _promote_rhs(A, b, x0):
    """b and x0 in the common dtype of a matrix operand's values and b
    (a matrix-free operator leaves them as they are)."""
    if _matrix_free(A) or not isinstance(b, torch.Tensor):
        return b, x0
    dt = torch.result_type(A if isinstance(A, torch.Tensor) else values(A),
                           b)
    return b.to(dt), None if x0 is None else x0.to(dt)


def _requires_grad(A, b, x0, M) -> bool:
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in _tensors(A, b, x0, M))


def _index_key(A) -> tuple:
    """The index tensors of a container with their in-place versions: the
    extra key of a cache held on its values tensor."""
    v = values(A)
    return tuple((id(t), t._version) for t in _leaves(A) if t is not v)


def _safe_norm(b) -> torch.Tensor:
    bn = tree_norm(b)
    return torch.where(bn > 0, bn, torch.ones_like(bn))


def _relative_residual(A, b, x) -> torch.Tensor:
    """||b - A x|| / ||b||, off the autograd graph (a report)."""
    with torch.no_grad():
        return tree_norm(tree_sub(b, as_matvec(A)(x))) / _safe_norm(b)


def _auto_mixed_ok(A, b, tol: float, sel_backend: str) -> bool:
    """precision='auto': real-float64 Krylov solves with a matrix operand
    and a reachable tolerance run defect correction; complex solves run
    in full precision, as the JAX router runs them."""
    if sel_backend != "krylov" or tol < 1e-12:
        return False
    if _matrix_free(A):
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


def amg(A, b, **kwargs):
    return solve(A, b, method="amg", **kwargs)


def direct_solve(A, b, **kwargs):
    return solve(A, b, method="direct", **kwargs)
