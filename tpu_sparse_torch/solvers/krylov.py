"""Krylov solvers: CG, BiCGStab, GMRES(restart).

Counterpart of ``tpu_sparse/solvers/krylov.py`` (reference
module_a/torch_sparse_linalg.py: ``cg`` :1019-1088, ``bicgstab``
:1091-1158 with breakdown codes -10/-11, ``gmres`` :641-784).

Tolerance contract (reference / non-legacy scipy): converged iff
``norm(residual) <= max(tol * norm(b), atol)``. ``info``: 0 converged,
-1 not converged / non-finite, -10 rho breakdown, -11 alpha/omega
breakdown (BiCGStab only).

The JAX loops are ``lax.while_loop``s. Here they run eagerly without
reading the device every iteration. CG and BiCGStab check their loop
condition once every ``CHECK_EVERY`` iterations, and between checks each
iteration is masked by an on-device ``active`` flag, so the state freezes
exactly at the iteration where the per-iteration loop would have stopped
and ``k`` counts the same iterations. GMRES reads its condition once per
restart cycle; inside a cycle a breakdown (or the incremental method's
``err <= ptol`` early exit) masks the later steps on the device, and the
incremental cycle (also FGMRES's) reads the host every ``EXIT_CHECK``
steps to stop once all later steps would be masked.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional, Union

import torch

from torch.utils import _pytree as pytree

from tpu_sparse_torch import tracing
from tpu_sparse_torch.kernels import as_matvec
from tpu_sparse_torch.utils.tree import (
    _final_check_relax,
    tree_axpy,
    tree_leaves,
    tree_norm,
    tree_size,
    tree_sub,
    tree_vdot,
    tree_vdot_real,
    tree_where,
    tree_zeros_like,
)

Operator = Union[Any, Callable]

CHECK_EVERY = 16  # iterations between host reads of the loop condition
# Arnoldi steps between host reads of the incremental cycle's early exit
EXIT_CHECK = 4


def _identity(x):
    return x


def _float_dtype(tree) -> torch.dtype:
    return tree_leaves(tree)[0].dtype


def _real_dtype(dtype: torch.dtype) -> torch.dtype:
    return dtype.to_real() if dtype.is_complex else dtype


def _default_maxiter(b, maxiter: Optional[int]) -> int:
    if maxiter is not None:
        return int(maxiter)
    return 10 * tree_size(b)  # same default as reference/scipy (:982-984)


def _check_tree_compat(x0, b):
    lx, lb = tree_leaves(x0), tree_leaves(b)
    if len(lx) != len(lb):
        raise ValueError("x0 and b must have matching tree structure")
    for a, c in zip(lx, lb):
        if a.shape != c.shape:
            raise ValueError(f"arrays in x0 and b must have matching shapes: "
                             f"{tuple(a.shape)} vs {tuple(c.shape)}")


def _thresholds(b, tol: float, atol, vdot_real: Callable = tree_vdot_real):
    """(<b, b>, atol as a tensor, the squared stopping threshold
    max(tol^2 <b, b>, atol^2)). ``vdot_real`` is the dot product (the
    distributed solvers pass an all-reduced one)."""
    bs = vdot_real(b, b)
    # a fill, not a copy from the host: that would wait for the queue
    atol_t = torch.full((), atol, dtype=bs.dtype, device=bs.device)
    return bs, atol_t, torch.maximum((tol * tol) * bs, atol_t * atol_t)


def _final_check(A_fn: Callable, b, x, bs: torch.Tensor,
                 atol_t: torch.Tensor, tol: float,
                 norm: Callable = tree_norm):
    """(info, ||b - A x||). The residual is the unpreconditioned one: the
    loops stop on <r, r> without M, and a strong M can inflate ||M r|| and
    flag a false pass. info is -1 when x or the residual is not finite or
    the residual exceeds max(tol ||b||, atol) (relaxed in 32-bit), else 0.
    ``norm`` is the 2-norm (the distributed solvers pass an all-reduced
    one).
    """
    res_norm = norm(tree_sub(b, A_fn(x)))
    thresh = torch.maximum(tol * torch.sqrt(bs), atol_t) * _final_check_relax(
        _real_dtype(_float_dtype(b)))
    failed = (~torch.isfinite(norm(x))) | (~torch.isfinite(res_norm)) \
        | (res_norm > thresh)
    return torch.where(failed, -1, 0).to(torch.int32), res_norm


def _cg_loop(A: Callable, M: Callable, b, x0, atol2: torch.Tensor,
             maxiter: int, precond_is_identity: bool,
             vdot_real: Callable = tree_vdot_real):
    """The CG recurrence. With the default ``vdot_real`` the scalars are
    0-d; the batched solvers pass column dot products, so that on an
    (n, k) block every scalar is a (k,) vector and each column runs this
    recurrence with its own mask (``solvers.batched``)."""
    r = tree_sub(b, A(x0))
    z = M(r)
    p = z
    dtype = _float_dtype(p)
    gamma = vdot_real(r, z).to(_real_dtype(dtype))
    x = x0
    k = torch.zeros((), dtype=torch.int32, device=gamma.device)

    def active_now():
        rs = gamma if precond_is_identity else vdot_real(r, r)
        return (k < maxiter) & (rs > atol2)

    active = active_now()
    # one host read per CHECK_EVERY iterations
    while bool(tracing.host_read(active.any())):
        for _ in range(CHECK_EVERY):
            with tracing.span("tsp.solver.iter"):
                Ap = A(p)
                alpha = (gamma / vdot_real(p, Ap)).to(dtype)
                x_new = tree_axpy(alpha, p, x)
                r_new = tree_axpy(-alpha, Ap, r)
                z = M(r_new)
                gamma_new = vdot_real(r_new, z).to(_real_dtype(dtype))
                beta = (gamma_new / gamma).to(dtype)
                p_new = tree_axpy(beta, p, z)
                x = tree_where(active, x_new, x)
                r = tree_where(active, r_new, r)
                p = tree_where(active, p_new, p)
                gamma = torch.where(active, gamma_new, gamma)
                k = k + active.to(torch.int32)
                active = active_now()
            tracing.SOLVER["iterations_run"] += 1
    return x, k


def cg(A: Operator, b: Any, x0: Optional[Any] = None, *, tol: float = 1e-5,
       atol: float = 0.0, maxiter: Optional[int] = None,
       M: Optional[Operator] = None):
    """Conjugate-gradient solve of Ax = b (A hermitian positive definite).

    Returns ``(x, info)`` with info 0 on convergence, -1 otherwise
    (reference ``cg``, torch_sparse_linalg.py:1019-1088)."""
    x, info, _, _ = cg_full(A, b, x0, tol=tol, atol=atol, maxiter=maxiter,
                            M=M)
    return x, info


@tracing.traced("tsp.solver.cg")
def cg_full(A: Operator, b: Any, x0: Optional[Any] = None, *,
            tol: float = 1e-5, atol=0.0, maxiter: Optional[int] = None,
            M: Optional[Operator] = None):
    """CG returning (x, info, iterations, final_residual_norm)."""
    if x0 is None:
        x0 = tree_zeros_like(b)
    _check_tree_compat(x0, b)
    maxiter = _default_maxiter(b, maxiter)
    A_fn = as_matvec(A)
    precond_identity = M is None
    M_fn = _identity if M is None else as_matvec(M)

    bs, atol_t, atol2 = _thresholds(b, tol, atol)
    x, k = _cg_loop(A_fn, M_fn, b, x0, atol2, maxiter, precond_identity)
    info, res_norm = _final_check(A_fn, b, x, bs, atol_t, tol)
    return x, info, k, res_norm


# ---------------------------------------------------------------------------
# BiCGStab
# ---------------------------------------------------------------------------


def _bicgstab_loop(A: Callable, M: Callable, b, x0, atol2: torch.Tensor,
                   maxiter: int, vdot: Callable = tree_vdot,
                   vdot_real: Callable = tree_vdot_real):
    """The BiCGStab recurrence; batched like ``_cg_loop`` through its dot
    products."""
    r = tree_sub(b, A(x0))
    rhat = r
    dtype = _float_dtype(r)
    dev = tree_leaves(r)[0].device
    one = torch.ones((), dtype=dtype, device=dev)
    eps = torch.finfo(_real_dtype(dtype)).eps
    x, alpha, omega, rho, p, q = x0, one, one, one, r, r
    k = torch.zeros((), dtype=torch.int32, device=dev)

    def active_now():
        rs = vdot_real(r, r)
        return (rs > atol2) & (k < maxiter) & (k >= 0)

    active = active_now()
    # one host read per CHECK_EVERY iterations
    while bool(tracing.host_read(active.any())):
        for _ in range(CHECK_EVERY):
            with tracing.span("tsp.solver.iter"):
                rho_new = vdot(rhat, r)
                beta = rho_new / rho * alpha / omega
                p_new = tree_axpy(beta, tree_axpy(-omega, q, p), r)
                phat = M(p_new)
                q_new = A(phat)
                alpha_new = rho_new / vdot(rhat, q_new)
                s = tree_axpy(-alpha_new, q_new, r)
                exit_early = vdot_real(s, s) < atol2
                shat = M(s)
                t = A(shat)
                tt = vdot(t, t)
                omega_new = torch.where(
                    tt.abs() > 0, vdot(t, s) / tt,
                    torch.zeros((), dtype=dtype, device=dev))
                x_half = tree_axpy(alpha_new, phat, x)
                x_new = tree_where(exit_early, x_half,
                                   tree_axpy(omega_new, shat, x_half))
                r_new = tree_where(exit_early, s, tree_axpy(-omega_new, t, s))
                # breakdown codes of the reference (:902 rho, :913/:934
                # alpha/omega)
                k_next = torch.where(
                    rho_new.abs() < eps * rho.abs(), -10,
                    torch.where((alpha_new.abs() < eps)
                                | ((omega_new.abs() < eps) & ~exit_early),
                                -11, k + 1)).to(torch.int32)
                x = tree_where(active, x_new, x)
                r = tree_where(active, r_new, r)
                p = tree_where(active, p_new, p)
                q = tree_where(active, q_new, q)
                alpha = torch.where(active, alpha_new, alpha)
                omega = torch.where(active, omega_new, omega)
                rho = torch.where(active, rho_new, rho)
                k = torch.where(active, k_next, k)
                active = active_now()
            tracing.SOLVER["iterations_run"] += 1
    return x, k


def bicgstab(A: Operator, b: Any, x0: Optional[Any] = None, *,
             tol: float = 1e-5, atol: float = 0.0,
             maxiter: Optional[int] = None, M: Optional[Operator] = None):
    """BiCGStab solve of Ax = b (A need not be symmetric).

    Returns ``(x, info)``: 0 converged, -1 no convergence, -10/-11
    breakdown (reference ``bicgstab``, torch_sparse_linalg.py:1091-1158)."""
    x, info, _, _ = bicgstab_full(A, b, x0, tol=tol, atol=atol,
                                  maxiter=maxiter, M=M)
    return x, info


@tracing.traced("tsp.solver.bicgstab")
def bicgstab_full(A: Operator, b: Any, x0: Optional[Any] = None, *,
                  tol: float = 1e-5, atol: float = 0.0,
                  maxiter: Optional[int] = None,
                  M: Optional[Operator] = None):
    """BiCGStab returning (x, info, iterations, final_residual_norm); the
    iteration count is the breakdown code after a breakdown."""
    if x0 is None:
        x0 = tree_zeros_like(b)
    _check_tree_compat(x0, b)
    maxiter = _default_maxiter(b, maxiter)
    A_fn = as_matvec(A)
    M_fn = _identity if M is None else as_matvec(M)

    bs, atol_t, atol2 = _thresholds(b, tol, atol)
    x, k = _bicgstab_loop(A_fn, M_fn, b, x0, atol2, maxiter)
    info, res_norm = _final_check(A_fn, b, x, bs, atol_t, tol)
    info = torch.where(k < 0, k, info).to(torch.int32)
    return x, info, k, res_norm


# ---------------------------------------------------------------------------
# GMRES
# ---------------------------------------------------------------------------
#
# The basis V is one (restart + 1, n) tensor whose rows are the basis
# vectors; pytree operands are flattened into one vector at the entry of
# gmres_full. The JAX package pads V to blocks of _PROJ_BLOCK rows for
# XLA's static shapes; plain slicing V[:k + 1] takes its place here.


def _vnorm(x: torch.Tensor, allreduce: Optional[Callable] = None):
    """||x||: ``vector_norm``, or with an ``allreduce`` (the distributed
    solvers' sum over ranks) the root of the all-reduced local <x, x>."""
    if allreduce is None:
        return torch.linalg.vector_norm(x)
    return torch.sqrt(allreduce(torch.vdot(x, x).real))


def _safe_normalize(x: torch.Tensor, thresh=None,
                    allreduce: Optional[Callable] = None):
    """(x / ||x||, ||x||), or zeros and 0 when ||x|| <= thresh (default
    the dtype's eps); reference ``_safe_normalize`` (:217-273)."""
    norm = _vnorm(x, allreduce)
    if thresh is None:
        thresh = torch.finfo(_real_dtype(x.dtype)).eps
    use = norm > thresh
    denom = torch.where(use, norm, torch.ones_like(norm))
    normalized = torch.where(use, x / denom.to(x.dtype), torch.zeros_like(x))
    return normalized, torch.where(use, norm, torch.zeros_like(norm))


def _iterative_classical_gram_schmidt(V: torch.Tensor, x: torch.Tensor,
                                      kplus: int, x_norm: torch.Tensor,
                                      allreduce: Optional[Callable] = None):
    """Classical Gram-Schmidt of x against V[:kplus], with the second pass
    (CGS2) kept where the first cancelled more than half the norm:
    ``||q|| < ||x|| / sqrt(2)``. That is the JAX package's rule (its
    docstring says it matches the PyTorch origin, which tests another
    quantity; ROADMAP queue 3, R2), kept here so the two packages agree.
    The JAX ``lax.cond`` reads no host value; here both passes run and the
    second is selected on the device, so no Arnoldi step waits for the
    host. With an ``allreduce`` (rows of V and x split over ranks) each
    pass all-reduces its projection h = Vk^H x, one (kplus,) vector, and
    the norm its local <q, q>."""
    red = _identity if allreduce is None else allreduce
    Vk = V[:kplus]
    h = red(torch.mv(Vk.conj(), x))
    q = x - torch.mv(Vk.T, h)
    need = _vnorm(q, allreduce) * 1.4142135623730951 < x_norm
    dh = red(torch.mv(Vk.conj(), q))
    q = torch.where(need, q - torch.mv(Vk.T, dh), q)
    h = torch.where(need, h + dh, h)
    return q, h


def _kth_arnoldi_iteration(k: int, A: Callable, M: Callable,
                           V: torch.Tensor, restart: int,
                           allreduce: Optional[Callable] = None):
    """One Arnoldi step (reference :331-388): returns the new basis vector
    V[k+1], the row k of H (length restart + 1) and the breakdown flag."""
    return _arnoldi_step(k, M(A(V[k])), V, restart, allreduce)


def _arnoldi_step(k: int, w: torch.Tensor, V: torch.Tensor, restart: int,
                  allreduce: Optional[Callable] = None):
    """``_kth_arnoldi_iteration`` given the product w of step k."""
    eps = torch.finfo(_real_dtype(V.dtype)).eps
    w_pre = _vnorm(w, allreduce)
    w, h = _iterative_classical_gram_schmidt(V, w, k + 1, w_pre, allreduce)
    unit_w, w_norm = _safe_normalize(w, thresh=eps * w_pre,
                                     allreduce=allreduce)
    row = torch.zeros(restart + 1, dtype=V.dtype, device=V.device)
    row[:k + 1] = h
    row[k + 1] = w_norm.to(V.dtype)
    return unit_w, row, w_norm == 0.0


def _gauss_jordan_solve(G: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """G y = c by Gauss-Jordan elimination without pivoting, zero pivots
    guarded (the JAX package's TPU-safe solve, kept for f64 parity)."""
    m = G.shape[0]
    aug = torch.cat([G, c[:, None]], dim=1)
    for i in range(m):
        pivot = aug[i, i]
        safe = torch.where(pivot != 0, pivot, torch.ones_like(pivot))
        row = aug[i] / safe
        factors = aug[:, i].clone()
        factors[i] = 0.0
        aug = aug - factors[:, None] * row[None, :]
        aug[i] = row
    return aug[:, m]


# The dtype a bf16 (or float16) computation runs in where torch has no
# build for it: torch has no bf16 QR or triangular solve, on the CPU or on
# CUDA, so a cycle in those dtypes solves its small (restart + 1) x restart
# least-squares problem in float32 and rounds y to its own dtype.
_WIDE = {torch.bfloat16: torch.float32, torch.float16: torch.float32}


def _upper_triangular_solve(R: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Back-substitution for upper-triangular R; leading dimensions batch.
    A zero pivot divides by 1, as the JAX package's loop does; one
    triangular solve instead of its loop over the rows (in float32 for a
    bf16 R, rounded back)."""
    dtype = R.dtype
    wide = _WIDE.get(dtype, dtype)
    R, c = R.to(wide), c.to(wide)
    d = torch.diagonal(R, dim1=-2, dim2=-1)
    R = R + torch.diag_embed((d == 0).to(R.dtype))
    return torch.linalg.solve_triangular(R, c.unsqueeze(-1),
                                         upper=True).squeeze(-1).to(dtype)


def _lstsq_normal(H: torch.Tensor, beta: torch.Tensor, restart: int):
    """min_y ||beta e1 - H^T y|| by the normal equations (reference
    ``_lstsq``, :391-428); H is (restart, restart + 1) holding H^T."""
    Hm = H.T
    rhs = torch.zeros(restart + 1, dtype=Hm.dtype, device=Hm.device)
    rhs[0] = beta
    G = Hm.conj().T @ Hm
    eps = torch.finfo(_real_dtype(Hm.dtype)).eps
    G = G + torch.eye(restart, dtype=G.dtype, device=G.device) * (
        eps * torch.trace(G).real)
    return _gauss_jordan_solve(G, Hm.conj().T @ rhs)


def _lstsq_qr(H: torch.Tensor, beta: torch.Tensor, restart: int):
    """Backward-stable lstsq by Householder QR, for 32-bit cycles (the
    normal equations square cond(H), which f32 cannot carry)."""
    dtype = H.dtype
    Hm = H.T.to(_WIDE.get(dtype, dtype))
    rhs = torch.zeros(restart + 1, dtype=Hm.dtype, device=Hm.device)
    rhs[0] = beta
    Q, R = torch.linalg.qr(Hm, mode="reduced")
    return _upper_triangular_solve(R, Q.conj().T @ rhs).to(dtype)


def _new_basis(unit_residual: torch.Tensor, restart: int) -> torch.Tensor:
    V = unit_residual.new_zeros((restart + 1, unit_residual.shape[0]))
    V[0] = unit_residual
    return V


def _gmres_batched(A, b, x0, unit_residual, residual_norm, ptol, restart, M,
                   allreduce: Optional[Callable] = None):
    """One restart cycle, batched solve method (reference :431-493): the
    full Arnoldi sweep, then one least-squares problem."""
    dtype = b.dtype
    V = _new_basis(unit_residual, restart)
    H = torch.zeros((restart, restart + 1), dtype=dtype, device=b.device)
    breakdown = torch.zeros((), dtype=torch.bool, device=b.device)
    for k in range(restart):
        active = ~breakdown
        unit_w, row, brk = _kth_arnoldi_iteration(k, A, M, V, restart,
                                                  allreduce)
        V[k + 1] = torch.where(active, unit_w, V[k + 1])
        H[k] = torch.where(active, row, H[k])
        breakdown = torch.where(active, brk, breakdown)
    if dtype.is_complex or torch.finfo(dtype).bits > 32:
        y = _lstsq_normal(H, residual_norm.to(dtype), restart)
    else:
        y = _lstsq_qr(H, residual_norm.to(dtype), restart)
    x = x0 + torch.mv(V[:restart].T, y)
    unit_residual, residual_norm = _safe_normalize(M(b - A(x)),
                                                   allreduce=allreduce)
    return x, unit_residual, residual_norm


def _givens_rotation(a, b):
    """cs, sn zeroing b (reference ``_givens_rotation``, :508-518)."""
    denom = torch.hypot(a.abs(), b.abs())
    safe = denom > 0
    denom_ = torch.where(safe, denom, 1.0)
    return (torch.where(safe, a / denom_, 1.0),
            torch.where(safe, -b / denom_, 0.0))


def _apply_givens(G: torch.Tensor, row: torch.Tensor, k: int):
    """The rotations 0..k-1 on the new Hessenberg column ``row``, then the
    k-th rotation, which zeroes its entry k + 1 (reference :521-554 /
    :599-623). The rotations so far are held as their product G, (m, m)
    with m = restart + 1, so that applying them is one matrix-vector
    product, not k launches of scalar work; the rotated right-hand side
    beta e1 is beta G[:, 0]. Leading dimensions of G and row batch.
    Returns (rotated column, G with the k-th rotation)."""
    col = torch.matmul(G, row.unsqueeze(-1)).squeeze(-1)
    a, b = col[..., k], col[..., k + 1]
    cs, sn = _givens_rotation(a, b)
    col[..., k] = cs.conj() * a - sn.conj() * b
    col[..., k + 1] = 0.0
    gk, gk1 = G[..., k, :], G[..., k + 1, :]
    c_, s_ = cs.unsqueeze(-1), sn.unsqueeze(-1)
    G = G.clone()
    G[..., k, :] = c_.conj() * gk - s_.conj() * gk1
    G[..., k + 1, :] = s_ * gk + c_ * gk1
    return col, G


def _gmres_incremental(A, b, x0, unit_residual, residual_norm, ptol,
                       restart, M, flexible: bool = False,
                       allreduce: Optional[Callable] = None):
    """One restart cycle, incremental (Givens QR) method (reference
    :557-638), with the in-cycle early exit ``err <= ptol`` as a mask;
    every ``EXIT_CHECK`` steps one host read ends the cycle once every
    later step would be masked, so no matvec or preconditioner runs past
    the exit by more than ``EXIT_CHECK - 1`` steps.

    ``flexible`` makes it the FGMRES cycle (``solvers.fgmres``): M on the
    right, w = A(M(v_k)), the preconditioned vectors z_k kept in Z and x
    updated from Z, and the new residual the true b - A x."""
    dtype, dev = b.dtype, b.device
    V = _new_basis(unit_residual, restart)
    Z = torch.zeros_like(V[:restart]) if flexible else None
    R = torch.zeros((restart, restart), dtype=dtype, device=dev)
    beta = residual_norm.to(dtype)
    G = torch.eye(restart + 1, dtype=dtype, device=dev)
    err = beta.abs()
    breakdown = torch.zeros((), dtype=torch.bool, device=dev)
    k_done = torch.zeros((), dtype=torch.int64, device=dev)
    for k in range(restart):
        active = (err > ptol) & ~breakdown
        if flexible:
            z = M(V[k])
            Z[k] = torch.where(active, z, Z[k])
            unit_w, row, brk = _arnoldi_step(k, A(z), V, restart, allreduce)
        else:
            unit_w, row, brk = _kth_arnoldi_iteration(k, A, M, V, restart,
                                                      allreduce)
        col, G_new = _apply_givens(G, row, k)
        V[k + 1] = torch.where(active, unit_w, V[k + 1])
        R[:, k] = torch.where(active, col[:restart], R[:, k])
        G = torch.where(active, G_new, G)
        err = torch.where(active, (beta * G_new[k + 1, 0]).abs(), err)
        breakdown = torch.where(active, brk, breakdown)
        k_done = k_done + active.to(torch.int64)
        if k % EXIT_CHECK == EXIT_CHECK - 1 and not bool(
                tracing.host_read((err > ptol) & ~breakdown)):
            break  # the later steps would all be masked
    # identity on R's unused tail: one triangular solve gives y = 0 past k
    idx = torch.arange(restart, device=dev)
    R = R + torch.diag((idx >= k_done).to(dtype))
    rhs = torch.where(idx < k_done, beta * G[:restart, 0],
                      torch.zeros((), dtype=dtype, device=dev))
    y = _upper_triangular_solve(R, rhs)
    if flexible:
        x = x0 + torch.mv(Z.T, y)
        return (x,) + _safe_normalize(b - A(x), allreduce=allreduce)
    x = x0 + torch.mv(V[:restart].T, y)
    unit_residual, residual_norm = _safe_normalize(M(b - A(x)),
                                                   allreduce=allreduce)
    return x, unit_residual, residual_norm


def _flat_operands(A_fn: Callable, M_fn: Callable, b, x0):
    """The restart cycles work on one flat vector: (A, M, b, x0) on that
    vector and the map of a flat result back to b's structure. A single
    1-D tensor passes through unchanged; other pytree operands are
    flattened and concatenated."""
    leaves, spec = pytree.tree_flatten(b)
    if len(leaves) == 1 and leaves[0].dim() == 1:
        return A_fn, M_fn, leaves[0], tree_leaves(x0)[0], _identity

    def unflatten(v):
        out, at = [], 0
        for leaf in leaves:
            out.append(v[at:at + leaf.numel()].reshape(leaf.shape))
            at += leaf.numel()
        return pytree.tree_unflatten(out, spec)

    def flatten(tree):
        return torch.cat([leaf.reshape(-1) for leaf in tree_leaves(tree)])

    return (lambda v: flatten(A_fn(unflatten(v))),
            lambda v: flatten(M_fn(unflatten(v))),
            flatten(b), flatten(x0), unflatten)


def _gmres_restarts(A: Operator, b: Any, x0: Optional[Any], tol: float,
                    atol: float, restart: int, maxiter: Optional[int],
                    M: Optional[Operator], cycle_fn: Callable, *,
                    left: bool, allreduce: Optional[Callable] = None):
    """The restart loop of GMRES and FGMRES (reference
    ``_gmres_solve_with_method``, :787-803), one host read of its condition
    per cycle, and the final check. ``left``: M preconditions on the left
    and the loop monitors the preconditioned residual (GMRES); else M is
    applied inside ``cycle_fn`` on the right and the loop monitors the true
    residual (FGMRES). Returns (x, info, restart_cycles, residual_norm).
    ``allreduce`` (the distributed solvers' sum over ranks, which hold
    rows of every vector) reduces every inner product and norm; the caller
    then clips ``restart`` to the global size and passes ``maxiter``."""
    if x0 is None:
        x0 = tree_zeros_like(b)
    _check_tree_compat(x0, b)
    if allreduce is None:
        restart = min(restart, tree_size(b))
    else:
        cycle_fn = functools.partial(cycle_fn, allreduce=allreduce)
    maxiter = _default_maxiter(b, maxiter)
    A_run, M_run, b_run, x, unflatten = _flat_operands(
        as_matvec(A), _identity if M is None else as_matvec(M), b, x0)
    P = M_run if left else _identity  # the residual the loop monitors

    b_norm = _vnorm(b_run, allreduce)
    atol_ = torch.clamp_min(tol * b_norm, atol)
    ptol = atol_
    if left:
        Mb_norm = _vnorm(M_run(b_run), allreduce)
        ptol = Mb_norm * torch.clamp_max(atol_ / torch.where(
            b_norm > 0, b_norm, torch.ones_like(b_norm)), 1.0)

    unit_residual, residual_norm = _safe_normalize(P(b_run - A_run(x)),
                                                   allreduce=allreduce)
    k = 0
    while k < maxiter and bool(tracing.host_read(residual_norm > atol_)):
        with tracing.span("tsp.solver.block"):
            x, unit_residual, residual_norm = cycle_fn(
                A_run, b_run, x, unit_residual, residual_norm, ptol, restart,
                M_run)
        tracing.SOLVER["iterations_run"] += 1
        k += 1

    res_norm = _vnorm(P(b_run - A_run(x)), allreduce)
    relaxed_atol = atol_ * _final_check_relax(_real_dtype(b_run.dtype))
    failed = (~torch.isfinite(_vnorm(x, allreduce))) \
        | (~torch.isfinite(res_norm)) | (res_norm > relaxed_atol)
    info = torch.where(failed, -1, 0).to(torch.int32)
    k_t = torch.full((), k, dtype=torch.int32, device=b_norm.device)
    return unflatten(x), info, k_t, res_norm


def gmres(A: Operator, b: Any, x0: Optional[Any] = None, *,
          tol: float = 1e-5, atol: float = 0.0, restart: int = 20,
          maxiter: Optional[int] = None, M: Optional[Operator] = None,
          solve_method: str = "batched"):
    """GMRES with restarts (reference ``gmres``, :641-784).

    solve_method: 'batched' (one least-squares per cycle) or 'incremental'
    (Givens QR with in-cycle early exit). Returns ``(x, info)``."""
    x, info, _, _ = gmres_full(A, b, x0, tol=tol, atol=atol, restart=restart,
                               maxiter=maxiter, M=M,
                               solve_method=solve_method)
    return x, info


@tracing.traced("tsp.solver.gmres")
def gmres_full(A: Operator, b: Any, x0: Optional[Any] = None, *,
               tol: float = 1e-5, atol: float = 0.0, restart: int = 20,
               maxiter: Optional[int] = None, M: Optional[Operator] = None,
               solve_method: str = "batched"):
    """GMRES returning (x, info, restart_cycles, final_residual_norm); the
    residual is the preconditioned one, as in the reference."""
    if solve_method == "batched":
        cycle_fn = _gmres_batched
    elif solve_method == "incremental":
        cycle_fn = _gmres_incremental
    else:
        raise ValueError(f"unsupported solve_method: {solve_method}")
    return _gmres_restarts(A, b, x0, tol, atol, restart, maxiter, M,
                           cycle_fn, left=True)
