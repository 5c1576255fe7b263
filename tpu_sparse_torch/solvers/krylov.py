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
restart cycle; inside a cycle every Arnoldi step runs, and a breakdown (or
the incremental method's ``err <= ptol`` early exit) masks the later steps
on the device.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Union

import torch

from torch.utils import _pytree as pytree

from tpu_sparse_torch.kernels import as_matvec
from tpu_sparse_torch.utils.tree import (
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


def _final_check_relax(dtype: torch.dtype) -> float:
    """Residual-recheck relaxation: the loop stops on the recurrence
    residual, and in 32-bit arithmetic the recomputed true residual drifts
    slightly above it. The reference relaxes its final check 10x for this
    (torch_sparse_linalg.py:765-771); 64-bit stays strict."""
    return 10.0 if torch.finfo(dtype).bits <= 32 else 1.0


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
    while bool(active.any()):  # one host read per CHECK_EVERY iterations
        for _ in range(CHECK_EVERY):
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

    bs = tree_vdot_real(b, b)
    atol_t = torch.as_tensor(atol, dtype=bs.dtype, device=bs.device)
    atol2 = torch.maximum((tol * tol) * bs, atol_t * atol_t)

    x, k = _cg_loop(A_fn, M_fn, b, x0, atol2, maxiter, precond_identity)

    # Unpreconditioned residual: the loop's stopping rule uses <r, r>
    # without M, and a strong M can inflate ||M r|| and flag a false pass.
    res_norm = tree_norm(tree_sub(b, A_fn(x)))
    b_norm = torch.sqrt(bs)
    thresh = torch.maximum(tol * b_norm, atol_t) * _final_check_relax(
        _real_dtype(_float_dtype(b)))
    failed = (~torch.isfinite(tree_norm(x))) | (~torch.isfinite(res_norm)) \
        | (res_norm > thresh)
    info = torch.where(failed, -1, 0).to(torch.int32)
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
    while bool(active.any()):  # one host read per CHECK_EVERY iterations
        for _ in range(CHECK_EVERY):
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
            omega_new = torch.where(tt.abs() > 0, vdot(t, s) / tt,
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

    bs = tree_vdot_real(b, b)
    atol_t = torch.as_tensor(atol, dtype=bs.dtype, device=bs.device)
    atol2 = torch.maximum((tol * tol) * bs, atol_t * atol_t)

    x, k = _bicgstab_loop(A_fn, M_fn, b, x0, atol2, maxiter)

    # unpreconditioned residual, as in cg_full
    res_norm = tree_norm(tree_sub(b, A_fn(x)))
    thresh = torch.maximum(tol * torch.sqrt(bs), atol_t) * _final_check_relax(
        _real_dtype(_float_dtype(b)))
    failed = (~torch.isfinite(tree_norm(x))) | (~torch.isfinite(res_norm)) \
        | (res_norm > thresh)
    info = torch.where(k < 0, k, torch.where(failed, -1, 0)).to(torch.int32)
    return x, info, k, res_norm


# ---------------------------------------------------------------------------
# GMRES
# ---------------------------------------------------------------------------
#
# The basis V is one (restart + 1, n) tensor whose rows are the basis
# vectors; pytree operands are flattened into one vector at the entry of
# gmres_full. The JAX package pads V to blocks of _PROJ_BLOCK rows for
# XLA's static shapes; plain slicing V[:k + 1] takes its place here.


def _safe_normalize(x: torch.Tensor, thresh=None):
    """(x / ||x||, ||x||), or zeros and 0 when ||x|| <= thresh (default
    the dtype's eps); reference ``_safe_normalize`` (:217-273)."""
    norm = torch.linalg.vector_norm(x)
    if thresh is None:
        thresh = torch.finfo(_real_dtype(x.dtype)).eps
    use = norm > thresh
    denom = torch.where(use, norm, torch.ones_like(norm))
    normalized = torch.where(use, x / denom.to(x.dtype), torch.zeros_like(x))
    return normalized, torch.where(use, norm, torch.zeros_like(norm))


def _iterative_classical_gram_schmidt(V: torch.Tensor, x: torch.Tensor,
                                      kplus: int, x_norm: torch.Tensor):
    """Classical Gram-Schmidt of x against V[:kplus], with the second pass
    (CGS2) kept where the first cancelled more than half the norm:
    ``||q|| < ||x|| / sqrt(2)``. That is the JAX package's rule (its
    docstring says it matches the PyTorch origin, which tests another
    quantity; ROADMAP queue 3, R2), kept here so the two packages agree.
    The JAX ``lax.cond`` reads no host value; here both passes run and the
    second is selected on the device, so no Arnoldi step waits for the
    host."""
    Vk = V[:kplus]
    h = torch.mv(Vk.conj(), x)
    q = x - torch.mv(Vk.T, h)
    need = torch.linalg.vector_norm(q) * 1.4142135623730951 < x_norm
    dh = torch.mv(Vk.conj(), q)
    q = torch.where(need, q - torch.mv(Vk.T, dh), q)
    h = torch.where(need, h + dh, h)
    return q, h


def _kth_arnoldi_iteration(k: int, A: Callable, M: Callable,
                           V: torch.Tensor, restart: int):
    """One Arnoldi step (reference :331-388): returns the new basis vector
    V[k+1], the row k of H (length restart + 1) and the breakdown flag."""
    eps = torch.finfo(_real_dtype(V.dtype)).eps
    w = M(A(V[k]))
    w_pre = torch.linalg.vector_norm(w)
    w, h = _iterative_classical_gram_schmidt(V, w, k + 1, w_pre)
    unit_w, w_norm = _safe_normalize(w, thresh=eps * w_pre)
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


def _upper_triangular_solve(R: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Back-substitution for upper-triangular R; a zero pivot gives 0."""
    m = R.shape[0]
    y = torch.zeros_like(c)
    for k in range(m):
        i = m - 1 - k
        num = c[i] - torch.dot(R[i], y)
        piv = R[i, i]
        y[i] = num / torch.where(piv != 0, piv, torch.ones_like(piv))
    return y


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
    Hm = H.T
    rhs = torch.zeros(restart + 1, dtype=Hm.dtype, device=Hm.device)
    rhs[0] = beta
    Q, R = torch.linalg.qr(Hm, mode="reduced")
    return _upper_triangular_solve(R, Q.conj().T @ rhs)


def _new_basis(unit_residual: torch.Tensor, restart: int) -> torch.Tensor:
    V = unit_residual.new_zeros((restart + 1, unit_residual.shape[0]))
    V[0] = unit_residual
    return V


def _gmres_batched(A, b, x0, unit_residual, residual_norm, ptol, restart, M):
    """One restart cycle, batched solve method (reference :431-493): the
    full Arnoldi sweep, then one least-squares problem."""
    dtype = b.dtype
    V = _new_basis(unit_residual, restart)
    H = torch.zeros((restart, restart + 1), dtype=dtype, device=b.device)
    breakdown = torch.zeros((), dtype=torch.bool, device=b.device)
    for k in range(restart):
        active = ~breakdown
        unit_w, row, brk = _kth_arnoldi_iteration(k, A, M, V, restart)
        V[k + 1] = torch.where(active, unit_w, V[k + 1])
        H[k] = torch.where(active, row, H[k])
        breakdown = torch.where(active, brk, breakdown)
    if dtype.is_complex or torch.finfo(dtype).bits > 32:
        y = _lstsq_normal(H, residual_norm.to(dtype), restart)
    else:
        y = _lstsq_qr(H, residual_norm.to(dtype), restart)
    x = x0 + torch.mv(V[:restart].T, y)
    unit_residual, residual_norm = _safe_normalize(M(b - A(x)))
    return x, unit_residual, residual_norm


def _givens_rotation(a, b):
    """cs, sn zeroing b (reference ``_givens_rotation``, :508-518)."""
    denom = torch.sqrt(a.abs() ** 2 + b.abs() ** 2)
    safe = denom > 0
    denom_ = torch.where(safe, denom, torch.ones_like(denom))
    cs = torch.where(safe, a / denom_, torch.ones_like(a))
    sn = torch.where(safe, -b / denom_, torch.zeros_like(b))
    return cs, sn


def _apply_givens_rotations(col: torch.Tensor, givens: torch.Tensor, k: int):
    """Rotations 0..k-1 on the new column, then the k-th rotation
    (reference :521-554 / :599-623)."""
    col = col.clone()
    for i in range(k):
        cs, sn = givens[i, 0], givens[i, 1]
        hi = cs.conj() * col[i] - sn.conj() * col[i + 1]
        hip1 = sn * col[i] + cs * col[i + 1]
        col[i] = hi
        col[i + 1] = hip1
    cs_k, sn_k = _givens_rotation(col[k], col[k + 1])
    col[k] = cs_k.conj() * col[k] - sn_k.conj() * col[k + 1]
    col[k + 1] = 0.0
    return col, cs_k, sn_k


def _gmres_incremental(A, b, x0, unit_residual, residual_norm, ptol,
                       restart, M):
    """One restart cycle, incremental (Givens QR) method (reference
    :557-638), with the in-cycle early exit ``err <= ptol`` as a mask."""
    dtype, dev = b.dtype, b.device
    V = _new_basis(unit_residual, restart)
    R = torch.zeros((restart, restart), dtype=dtype, device=dev)
    beta_vec = torch.zeros(restart + 1, dtype=dtype, device=dev)
    beta_vec[0] = residual_norm.to(dtype)
    givens = torch.zeros((restart, 2), dtype=dtype, device=dev)
    err = beta_vec[0].abs()
    breakdown = torch.zeros((), dtype=torch.bool, device=dev)
    k_done = torch.zeros((), dtype=torch.int64, device=dev)
    for k in range(restart):
        active = (err > ptol) & ~breakdown
        unit_w, row, brk = _kth_arnoldi_iteration(k, A, M, V, restart)
        col, cs_k, sn_k = _apply_givens_rotations(row, givens, k)
        bk = cs_k.conj() * beta_vec[k] - sn_k.conj() * beta_vec[k + 1]
        bk1 = sn_k * beta_vec[k] + cs_k * beta_vec[k + 1]
        V[k + 1] = torch.where(active, unit_w, V[k + 1])
        R[:, k] = torch.where(active, col[:restart], R[:, k])
        givens[k] = torch.where(active, torch.stack([cs_k, sn_k]), givens[k])
        beta_vec[k] = torch.where(active, bk, beta_vec[k])
        beta_vec[k + 1] = torch.where(active, bk1, beta_vec[k + 1])
        err = torch.where(active, bk1.abs(), err)
        breakdown = torch.where(active, brk, breakdown)
        k_done = k_done + active.to(torch.int64)
    # identity on R's unused tail: one triangular solve gives y = 0 past k
    idx = torch.arange(restart, device=dev)
    R = R + torch.diag((idx >= k_done).to(dtype))
    rhs = torch.where(idx < k_done, beta_vec[:restart],
                      torch.zeros((), dtype=dtype, device=dev))
    y = _upper_triangular_solve(R, rhs)
    x = x0 + torch.mv(V[:restart].T, y)
    unit_residual, residual_norm = _safe_normalize(M(b - A(x)))
    return x, unit_residual, residual_norm


def _gmres_solve(A, b, x0, atol_, ptol, restart, maxiter, M, cycle_fn):
    """Restart loop (reference ``_gmres_solve_with_method``, :787-803):
    one host read of the loop condition per cycle."""
    unit_residual, residual_norm = _safe_normalize(M(b - A(x0)))
    x, k = x0, 0
    while k < maxiter and bool(residual_norm > atol_):
        x, unit_residual, residual_norm = cycle_fn(
            A, b, x, unit_residual, residual_norm, ptol, restart, M)
        k += 1
    return x, k


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
    if x0 is None:
        x0 = tree_zeros_like(b)
    _check_tree_compat(x0, b)
    size = tree_size(b)
    restart = min(restart, size)
    if maxiter is None:
        maxiter = 10 * size  # same default as reference (:719-721)
    A_fn = as_matvec(A)
    M_fn = _identity if M is None else as_matvec(M)

    # the cycles work on one flat vector; pytree operands are flattened
    leaves, spec = pytree.tree_flatten(b)
    flat = not (len(leaves) == 1 and leaves[0].dim() == 1)

    def unflatten(v):
        out, at = [], 0
        for leaf in leaves:
            out.append(v[at:at + leaf.numel()].reshape(leaf.shape))
            at += leaf.numel()
        return pytree.tree_unflatten(out, spec)

    def flatten(tree):
        return torch.cat([leaf.reshape(-1) for leaf in tree_leaves(tree)])

    if flat:
        A_run = lambda v: flatten(A_fn(unflatten(v)))  # noqa: E731
        M_run = lambda v: flatten(M_fn(unflatten(v)))  # noqa: E731
        b_run, x0_run = flatten(b), flatten(x0)
    else:
        A_run, M_run, b_run, x0_run = A_fn, M_fn, leaves[0], \
            tree_leaves(x0)[0]

    b_norm = torch.linalg.vector_norm(b_run)
    atol_ = torch.clamp_min(tol * b_norm, atol)
    Mb_norm = torch.linalg.vector_norm(M_run(b_run))
    ptol = Mb_norm * torch.clamp_max(
        atol_ / torch.where(b_norm > 0, b_norm, torch.ones_like(b_norm)), 1.0)

    x, k = _gmres_solve(A_run, b_run, x0_run, atol_, ptol, restart, maxiter,
                        M_run, cycle_fn)

    res_norm = torch.linalg.vector_norm(M_run(b_run - A_run(x)))
    relaxed_atol = atol_ * _final_check_relax(_real_dtype(b_run.dtype))
    failed = (~torch.isfinite(torch.linalg.vector_norm(x))) \
        | (~torch.isfinite(res_norm)) | (res_norm > relaxed_atol)
    info = torch.where(failed, -1, 0).to(torch.int32)
    k_t = torch.tensor(k, dtype=torch.int32, device=b_norm.device)
    return (unflatten(x) if flat else x), info, k_t, res_norm
