"""Batched multi-RHS solves: each column of an (n, k) block B solved on
its own.

Counterpart of ``tpu_sparse/solvers/batched.py``. The JAX package
``vmap``s ``cg_full`` / ``bicgstab_full`` / ``gmres_full`` over the columns
and routes the batched matvec to one SpMM. The port writes the batch
dimension out: the loops run on (n, k) blocks with (k,) scalars and a (k,)
``active`` mask, every matvec is one ``spmm`` (``kernels.as_matmat``: K6/K7
on a CWELL, K8 on a BELL on the card), and each column follows exactly the
recurrence of the single-RHS solver (CG and BiCGStab share its loop, given
column dot products; GMRES mirrors ``gmres_full`` with a leading column
axis). A loop reads the host once per ``CHECK_EVERY`` iterations on
``active.any()`` (GMRES once per restart cycle), as the single-RHS loops
do on ``active``.

Every solver returns ``(X, infos (k,), iterations (k,), res_norms (k,))``.
``batch_fcg``, ``batch_minres`` and ``batch_cg_sr`` share the loops of
``fcg_full``, ``minres_full`` and ``cg_sr_full`` the same way, and
``batch_fgmres`` mirrors ``fgmres_full`` as ``batch_gmres`` mirrors
``gmres_full``. ``batch_direct`` solves every column directly at once.
``batch_cg_sr`` has no JAX name: it is the column-batched
``cg_sr_full`` that the JAX ``batch_refined`` reaches by ``vmap``.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch

from tpu_sparse_torch.kernels import as_matmat
from tpu_sparse_torch.solvers.fcg import _fcg_loop
from tpu_sparse_torch.solvers.krylov import (EXIT_CHECK, _WIDE,
                                             _apply_givens, _bicgstab_loop,
                                             _cg_loop,
                                             _final_check_relax, _real_dtype,
                                             _upper_triangular_solve)
from tpu_sparse_torch.solvers.minres import _minres_loop
from tpu_sparse_torch.solvers.pipelined import _cg_sr_loop


def cols_vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a[:, j], b[:, j]> for every column j (conjugate-linear in a). A
    bf16 column dot takes exact products and sums them in float32, then
    rounds once, as ``torch.vdot`` (the single-RHS loops' dot) and the JAX
    dot of the ``vmap``-ed ``batch_cg`` do; products rounded to bf16 first
    took other iterations than the single solves."""
    if a.dtype in _WIDE:
        wide = _WIDE[a.dtype]
        return torch.sum(a.to(wide) * b.to(wide), dim=0).to(a.dtype)
    return torch.sum(a.conj() * b, dim=0)


def cols_vdot_real(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    out = cols_vdot(a, b)
    return out.real if out.is_complex() else out


def cols_norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(cols_vdot_real(a, a))


def _start(B, X0):
    if not isinstance(B, torch.Tensor) or B.dim() != 2:
        raise ValueError("multi-RHS solvers expect B of shape (n, k)")
    if X0 is None:
        return torch.zeros_like(B)
    if X0.shape != B.shape:
        raise ValueError(f"X0 has shape {tuple(X0.shape)}, B "
                         f"{tuple(B.shape)}")
    return X0


def _per_column(k: torch.Tensor, ncols: int) -> torch.Tensor:
    """A loop counter as a (k,) vector (0-d when no column ever ran)."""
    return torch.broadcast_to(k, (ncols,)).clone()


def _thresholds(B, tol, atol):
    """(||b_j||^2, atol as a tensor, the loop's squared thresholds)."""
    bs = cols_vdot_real(B, B)
    atol_t = torch.as_tensor(atol, dtype=bs.dtype, device=bs.device)
    return bs, atol_t, torch.maximum((tol * tol) * bs, atol_t * atol_t)


def _final(A_mm, B, X, bs, atol_t, tol):
    """Per-column true residual and the failure mask of ``cg_full``."""
    res = cols_norm(B - A_mm(X))
    thresh = torch.maximum(tol * torch.sqrt(bs), atol_t) * _final_check_relax(
        _real_dtype(B.dtype))
    failed = (~torch.isfinite(cols_norm(X))) | (~torch.isfinite(res)) \
        | (res > thresh)
    return res, failed


def batch_cg(A, B: torch.Tensor, X0=None, *, tol: float = 1e-5,
             atol=0.0, maxiter: Optional[int] = None, M=None):
    """CG over each column of B. ``atol`` may be a (k,) tensor. Returns
    (X, infos, iterations, res_norms)."""
    X0 = _start(B, X0)
    maxiter = 10 * B.shape[0] if maxiter is None else int(maxiter)
    A_mm = as_matmat(A)
    bs, atol_t, atol2 = _thresholds(B, tol, atol)
    X, k = _cg_loop(A_mm, as_matmat(M), B, X0, atol2, maxiter, M is None,
                    vdot_real=cols_vdot_real)
    res, failed = _final(A_mm, B, X, bs, atol_t, tol)
    info = torch.where(failed, -1, 0).to(torch.int32)
    return X, info, _per_column(k, B.shape[1]), res


def batch_cg_sr(A, B: torch.Tensor, X0=None, *, tol: float = 1e-5,
                atol=0.0, maxiter: Optional[int] = None, M=None):
    """Single-reduction CG over each column of B (``cg_sr_full`` per
    column)."""
    X0 = _start(B, X0)
    maxiter = 10 * B.shape[0] if maxiter is None else int(maxiter)
    A_mm = as_matmat(A)
    bs, atol_t, atol2 = _thresholds(B, tol, atol)
    X, k = _cg_sr_loop(A_mm, as_matmat(M), B, X0, atol2, maxiter, M is None,
                       vdot_real=cols_vdot_real)
    res, failed = _final(A_mm, B, X, bs, atol_t, tol)
    info = torch.where(failed, -1, 0).to(torch.int32)
    return X, info, _per_column(k, B.shape[1]), res


def batch_fcg(A, B: torch.Tensor, X0=None, *, tol: float = 1e-5,
              atol=0.0, maxiter: Optional[int] = None, M=None):
    """Flexible CG over each column of B (``fcg_full`` per column)."""
    X0 = _start(B, X0)
    maxiter = 10 * B.shape[0] if maxiter is None else int(maxiter)
    A_mm = as_matmat(A)
    bs, atol_t, atol2 = _thresholds(B, tol, atol)
    X, k = _fcg_loop(A_mm, as_matmat(M), B, X0, atol2, maxiter,
                     vdot_real=cols_vdot_real)
    res, failed = _final(A_mm, B, X, bs, atol_t, tol)
    info = torch.where(failed, -1, 0).to(torch.int32)
    return X, info, _per_column(k, B.shape[1]), res


def batch_minres(A, B: torch.Tensor, X0=None, *, tol: float = 1e-5,
                 atol=0.0, maxiter: Optional[int] = None, M=None):
    """MINRES over each column of B (``minres_full`` per column)."""
    X0 = _start(B, X0)
    maxiter = 10 * B.shape[0] if maxiter is None else int(maxiter)
    A_mm = as_matmat(A)
    bs, atol_t, _ = _thresholds(B, tol, atol)
    atol_norm = torch.maximum(tol * torch.sqrt(bs), atol_t)
    X, k = _minres_loop(A_mm, as_matmat(M), B, X0, atol_norm, maxiter,
                        vdot_real=cols_vdot_real)
    res, failed = _final(A_mm, B, X, bs, atol_t, tol)
    info = torch.where(failed, -1, 0).to(torch.int32)
    return X, info, _per_column(k, B.shape[1]), res


def batch_bicgstab(A, B: torch.Tensor, X0=None, *, tol: float = 1e-5,
                   atol=0.0, maxiter: Optional[int] = None, M=None):
    """BiCGStab over each column of B; a column's iteration count is its
    breakdown code (-10 / -11) after a breakdown, as in ``bicgstab_full``."""
    X0 = _start(B, X0)
    maxiter = 10 * B.shape[0] if maxiter is None else int(maxiter)
    A_mm = as_matmat(A)
    bs, atol_t, atol2 = _thresholds(B, tol, atol)
    X, k = _bicgstab_loop(A_mm, as_matmat(M), B, X0, atol2, maxiter,
                          vdot=cols_vdot, vdot_real=cols_vdot_real)
    k = _per_column(k, B.shape[1])
    res, failed = _final(A_mm, B, X, bs, atol_t, tol)
    info = torch.where(k < 0, k, torch.where(failed, -1, 0)).to(torch.int32)
    return X, info, k, res


# ---------------------------------------------------------------------------
# GMRES. Inside the cycles the k right-hand sides are the rows of (k, n)
# tensors (the basis is (k, restart + 1, n)), so that the projections are
# batched matrix products on contiguous rows; the operator sees (n, k)
# blocks.
# ---------------------------------------------------------------------------


def _rows_norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1)


def _safe_normalize_rows(x: torch.Tensor, thresh=None):
    """Each row as in ``krylov._safe_normalize``: (x / ||x||, ||x||), or
    zeros and 0 where ||x|| <= thresh (default the dtype's eps)."""
    norm = _rows_norm(x)
    if thresh is None:
        thresh = torch.finfo(_real_dtype(x.dtype)).eps
    use = norm > thresh
    denom = torch.where(use, norm, torch.ones_like(norm))
    normalized = torch.where(use[:, None], x / denom[:, None].to(x.dtype),
                             torch.zeros_like(x))
    return normalized, torch.where(use, norm, torch.zeros_like(norm))


def _bmv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.bmm(M, v[:, :, None])[:, :, 0]


def _cgs2_rows(V: torch.Tensor, x: torch.Tensor, kplus: int,
               x_norm: torch.Tensor):
    """``krylov._iterative_classical_gram_schmidt`` for every row: the
    second pass kept where ||q|| < ||x|| / sqrt(2)."""
    Vk = V[:, :kplus]
    h = _bmv(Vk.conj(), x)
    q = x - _bmv(Vk.transpose(1, 2), h)
    need = (_rows_norm(q) * 1.4142135623730951 < x_norm)[:, None]
    dh = _bmv(Vk.conj(), q)
    q = torch.where(need, q - _bmv(Vk.transpose(1, 2), dh), q)
    h = torch.where(need, h + dh, h)
    return q, h


def _arnoldi_rows(k: int, A, M, V: torch.Tensor, restart: int):
    return _arnoldi_step_rows(k, M(A(V[:, k])), V, restart)


def _arnoldi_step_rows(k: int, w: torch.Tensor, V: torch.Tensor,
                       restart: int):
    """``krylov._arnoldi_step`` for every row."""
    eps = torch.finfo(_real_dtype(V.dtype)).eps
    w_pre = _rows_norm(w)
    w, h = _cgs2_rows(V, w, k + 1, w_pre)
    unit_w, w_norm = _safe_normalize_rows(w, thresh=eps * w_pre)
    row = V.new_zeros((V.shape[0], restart + 1))
    row[:, :k + 1] = h
    row[:, k + 1] = w_norm.to(V.dtype)
    return unit_w, row, w_norm == 0.0


def batch_direct(A, B: torch.Tensor) -> torch.Tensor:
    """Direct solve of every column of B (n, k): one
    ``direct.direct_solve`` of the whole block, whose solvers take (n, k)
    natively (the JAX package ``vmap``s the single solve)."""
    from tpu_sparse_torch.direct import direct_solve

    _start(B, None)
    return direct_solve(A, B)


def gj_solve_batched(D: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """D X = B for (m, s, s) D and (m, s, t) B by Gauss-Jordan elimination
    without pivoting, zero pivots guarded: the JAX package's
    ``direct/banded.py::_gj_solve_batched``, kept so that block CG and the
    GMRES least squares match it in float64."""
    s = D.shape[-1]
    aug = torch.cat([D, B], dim=-1)
    for j in range(s):
        pivot = aug[:, j, j][:, None]
        safe = torch.where(pivot != 0, pivot, torch.ones_like(pivot))
        row = aug[:, j, :] / safe
        col = aug[:, :, j].clone()
        col[:, j] = 0.0
        aug = aug - col[:, :, None] * row[:, None, :]
        aug[:, j, :] = row
    return aug[:, :, s:]


def _lstsq_rows(H: torch.Tensor, beta: torch.Tensor, restart: int):
    """min_y ||beta e1 - H^T y|| per row: the normal equations for 64-bit
    and complex cycles, Householder QR for 32-bit ones (``krylov``'s
    ``_lstsq_normal`` / ``_lstsq_qr``). H is (k, restart, restart + 1)."""
    Hm = H.transpose(1, 2)
    rhs = H.new_zeros((H.shape[0], restart + 1))
    rhs[:, 0] = beta
    if H.dtype.is_complex or torch.finfo(H.dtype).bits > 32:
        Hh = Hm.conj().transpose(1, 2)
        G = Hh @ Hm
        eps = torch.finfo(_real_dtype(H.dtype)).eps
        trace = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1).real
        G = G + torch.eye(restart, dtype=G.dtype, device=G.device) * (
            eps * trace)[:, None, None]
        return gj_solve_batched(G, _bmv(Hh, rhs)[:, :, None])[:, :, 0]
    wide = _WIDE.get(H.dtype, H.dtype)  # torch has no bf16 QR
    Q, R = torch.linalg.qr(Hm.to(wide), mode="reduced")
    return _upper_triangular_solve(
        R, _bmv(Q.conj().transpose(1, 2), rhs.to(wide))).to(H.dtype)


def _new_basis_rows(unit_residual: torch.Tensor, restart: int):
    V = unit_residual.new_zeros((unit_residual.shape[0], restart + 1,
                                 unit_residual.shape[1]))
    V[:, 0] = unit_residual
    return V


def _gmres_batched_rows(A, b, x0, unit_residual, residual_norm, ptol,
                        restart, M):
    """One restart cycle of ``krylov._gmres_batched`` for every row."""
    V = _new_basis_rows(unit_residual, restart)
    H = b.new_zeros((b.shape[0], restart, restart + 1))
    breakdown = torch.zeros(b.shape[0], dtype=torch.bool, device=b.device)
    for k in range(restart):
        active = ~breakdown
        unit_w, row, brk = _arnoldi_rows(k, A, M, V, restart)
        V[:, k + 1] = torch.where(active[:, None], unit_w, V[:, k + 1])
        H[:, k] = torch.where(active[:, None], row, H[:, k])
        breakdown = torch.where(active, brk, breakdown)
    y = _lstsq_rows(H, residual_norm.to(b.dtype), restart)
    x = x0 + _bmv(V[:, :restart].transpose(1, 2), y)
    unit_residual, residual_norm = _safe_normalize_rows(M(b - A(x)))
    return x, unit_residual, residual_norm


def _gmres_incremental_rows(A, b, x0, unit_residual, residual_norm, ptol,
                            restart, M, flexible: bool = False):
    """One restart cycle of ``krylov._gmres_incremental`` for every row:
    ``krylov._apply_givens`` on a (k, restart + 1, restart + 1) stack of
    rotation products. ``flexible``: the FGMRES cycle, as there."""
    dtype, dev, nrhs = b.dtype, b.device, b.shape[0]
    V = _new_basis_rows(unit_residual, restart)
    Z = torch.zeros_like(V[:, :restart]) if flexible else None
    R = torch.zeros((nrhs, restart, restart), dtype=dtype, device=dev)
    beta = residual_norm.to(dtype)
    G = torch.eye(restart + 1, dtype=dtype, device=dev).repeat(nrhs, 1, 1)
    err = beta.abs()
    breakdown = torch.zeros(nrhs, dtype=torch.bool, device=dev)
    k_done = torch.zeros(nrhs, dtype=torch.int64, device=dev)
    for k in range(restart):
        active = (err > ptol) & ~breakdown
        if flexible:
            z = M(V[:, k])
            Z[:, k] = torch.where(active[:, None], z, Z[:, k])
            unit_w, row, brk = _arnoldi_step_rows(k, A(z), V, restart)
        else:
            unit_w, row, brk = _arnoldi_rows(k, A, M, V, restart)
        col, G_new = _apply_givens(G, row, k)
        V[:, k + 1] = torch.where(active[:, None], unit_w, V[:, k + 1])
        R[:, :, k] = torch.where(active[:, None], col[:, :restart], R[:, :, k])
        G = torch.where(active[:, None, None], G_new, G)
        err = torch.where(active, (beta * G_new[:, k + 1, 0]).abs(), err)
        breakdown = torch.where(active, brk, breakdown)
        k_done = k_done + active.to(torch.int64)
        if k % EXIT_CHECK == EXIT_CHECK - 1 and not bool(
                ((err > ptol) & ~breakdown).any()):
            break  # the later steps would all be masked
    # identity on R's unused tail: one triangular solve gives y = 0 past k
    idx = torch.arange(restart, device=dev)
    unused = idx[None, :] >= k_done[:, None]
    R = R + torch.diag_embed(unused.to(dtype))
    rhs = torch.where(unused, torch.zeros((), dtype=dtype, device=dev),
                      beta[:, None] * G[:, :restart, 0])
    y = _upper_triangular_solve(R, rhs)
    if flexible:
        x = x0 + _bmv(Z.transpose(1, 2), y)
        return (x,) + _safe_normalize_rows(b - A(x))
    x = x0 + _bmv(V[:, :restart].transpose(1, 2), y)
    unit_residual, residual_norm = _safe_normalize_rows(M(b - A(x)))
    return x, unit_residual, residual_norm


def _rows_operator(A):
    """A as a map of (k, n) rows to (k, n) rows through one (n, k) product
    (``as_matmat``)."""
    A_mm = as_matmat(A)
    return lambda v: A_mm(v.T).T.contiguous()


def _batch_gmres_restarts(A, B, X0, tol, atol, restart, maxiter, M,
                          cycle_fn, *, left: bool):
    """``krylov._gmres_restarts`` per row: one host read per restart cycle,
    on whether any column is active."""
    X0 = _start(B, X0)
    n = B.shape[0]
    restart = min(restart, n)
    maxiter = 10 * n if maxiter is None else int(maxiter)
    A_run, M_run = _rows_operator(A), _rows_operator(M)
    P = M_run if left else (lambda v: v)  # the residual the loop monitors
    b = B.T.contiguous()
    b_norm = _rows_norm(b)
    atol_ = torch.maximum(tol * b_norm, torch.as_tensor(
        atol, dtype=b_norm.dtype, device=b_norm.device))
    ptol = atol_
    if left:
        ptol = _rows_norm(M_run(b)) * torch.clamp_max(atol_ / torch.where(
            b_norm > 0, b_norm, torch.ones_like(b_norm)), 1.0)

    x = X0.T.contiguous()
    unit_residual, residual_norm = _safe_normalize_rows(P(b - A_run(x)))
    k = torch.zeros(b.shape[0], dtype=torch.int32, device=b.device)
    active = (k < maxiter) & (residual_norm > atol_)
    while bool(active.any()):  # one host read per restart cycle
        x_n, u_n, r_n = cycle_fn(A_run, b, x, unit_residual, residual_norm,
                                 ptol, restart, M_run)
        x = torch.where(active[:, None], x_n, x)
        unit_residual = torch.where(active[:, None], u_n, unit_residual)
        residual_norm = torch.where(active, r_n, residual_norm)
        k = k + active.to(torch.int32)
        active = (k < maxiter) & (residual_norm > atol_)

    res_norm = _rows_norm(P(b - A_run(x)))
    relaxed = atol_ * _final_check_relax(_real_dtype(b.dtype))
    failed = (~torch.isfinite(_rows_norm(x))) | (~torch.isfinite(res_norm)) \
        | (res_norm > relaxed)
    info = torch.where(failed, -1, 0).to(torch.int32)
    return x.T.contiguous(), info, k, res_norm


def batch_gmres(A, B: torch.Tensor, X0=None, *, tol: float = 1e-5,
                atol=0.0, restart: int = 20, maxiter: Optional[int] = None,
                M=None, solve_method: str = "batched"):
    """GMRES(restart) over each column of B (``gmres_full`` per column):
    iterations are restart cycles and the residual is the preconditioned
    one. One host read per cycle, on whether any column is active."""
    if solve_method == "batched":
        cycle_fn = _gmres_batched_rows
    elif solve_method == "incremental":
        cycle_fn = _gmres_incremental_rows
    else:
        raise ValueError(f"unsupported solve_method: {solve_method}")
    return _batch_gmres_restarts(A, B, X0, tol, atol, restart, maxiter, M,
                                 cycle_fn, left=True)


def batch_fgmres(A, B: torch.Tensor, X0=None, *, tol: float = 1e-5,
                 atol=0.0, restart: int = 20, maxiter: Optional[int] = None,
                 M=None):
    """FGMRES(restart) over each column of B (``fgmres_full`` per column):
    iterations are restart cycles and the residual is the true one. One
    host read per cycle, on whether any column is active."""
    return _batch_gmres_restarts(
        A, B, X0, tol, atol, restart, maxiter, M,
        partial(_gmres_incremental_rows, flexible=True), left=False)


# the column-batched refinement lives beside the single-RHS one; the JAX
# package defines it here
from tpu_sparse_torch.solvers.mixed import batch_refined  # noqa: E402,F401
