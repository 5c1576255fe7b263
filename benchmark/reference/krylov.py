"""Plain PyTorch references for the nonsymmetric solves: BiCGStab and
GMRES(restart) from x0 = 0, on the benchmark's own diagonals.

It imports torch alone: nothing of the program under test, no JAX. Every
product is ``hpcg.matvec`` and every vector operation runs in ``dtype``,
so that a lower dtype (the control) computes every product and sum in
that dtype; GMRES's small Hessenberg problem runs on the host in the same
dtype. Both stop where the library's solvers stop, against tol ||b||:

* BiCGStab after the half step when ||s|| < tol ||b|| and after the full
  step when ||r|| <= tol ||b||, both the recurrence's vectors; each counts
  one iteration. A breakdown (|rho| below eps times the last rho, |alpha|
  below eps, or |omega| below eps on a full step; eps the dtype's) ends
  the solve as not converged.
* GMRES inside a cycle when the Givens-rotated residual estimate falls to
  tol ||b|| (or the Arnoldi vector vanishes), and at each restart on the
  true residual ||b - A x|| <= tol ||b||. The iterations are the restart
  cycles run, as the library reports them. The library's default cycle
  runs all ``restart`` steps and solves the least-squares problem once;
  it stops after the same cycle, a little further converged.

Both return (x, iterations, converged), as ``hpcg.cg`` does, for b of
shape (n,).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.hpcg import matvec


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)


def bicgstab(data: torch.Tensor, offsets, b: torch.Tensor, tol: float,
             maxiter: int, dtype: torch.dtype = torch.float64):
    """Unpreconditioned BiCGStab (van der Vorst) from x0 = 0 in ``dtype``,
    with r-hat = r0 = b; its scalars are 0-d tensors of ``dtype``. Returns
    (x, iterations, converged)."""
    data = data.to(dtype)
    b = b.to(dtype)
    eps = torch.finfo(dtype).eps
    x = torch.zeros_like(b)
    r = b.clone()
    rhat = b.clone()
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    rho = alpha = omega = torch.ones((), dtype=dtype, device=b.device)
    thresh2 = float(tol) ** 2 * float(_dot(b, b))
    if not float(_dot(r, r)) > thresh2:
        return x, 0, True
    for k in range(1, int(maxiter) + 1):
        rho_new = _dot(rhat, r)
        if abs(float(rho_new)) < eps * abs(float(rho)):
            return x, k, False
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        v = matvec(data, offsets, p, dtype)
        alpha = rho_new / _dot(rhat, v)
        s = r - alpha * v
        if float(_dot(s, s)) < thresh2:      # the half step converged
            return x + alpha * p, k, abs(float(alpha)) >= eps
        t = matvec(data, offsets, s, dtype)
        tt = _dot(t, t)
        omega = _dot(t, s) / tt if float(tt) != 0.0 else torch.zeros_like(tt)
        x = x + alpha * p + omega * s
        r = s - omega * t
        rho = rho_new
        if abs(float(alpha)) < eps or abs(float(omega)) < eps:
            return x, k, False
        rr = float(_dot(r, r))
        if not math.isfinite(rr):
            return x, k, False
        if rr <= thresh2:
            return x, k, True
    return x, int(maxiter), False


def _rotate(c, s, a, b):
    return c * a - s * b, s * a + c * b


def gmres(data: torch.Tensor, offsets, b: torch.Tensor, tol: float,
          maxiter: int, restart: int, dtype: torch.dtype = torch.float64):
    """Unpreconditioned GMRES(restart) from x0 = 0 in ``dtype``: Arnoldi
    by classical Gram-Schmidt applied twice, the Hessenberg matrix reduced
    by Givens rotations as it grows, at most ``maxiter`` restart cycles.
    Returns (x, cycles, converged)."""
    data = data.to(dtype)
    b = b.to(dtype)
    n = b.shape[0]
    m = min(int(restart), n)
    eps = torch.finfo(dtype).eps
    target = float(tol) * math.sqrt(float(_dot(b, b)))
    host = {"dtype": dtype, "device": "cpu"}
    x = torch.zeros_like(b)
    r = b.clone()
    beta = torch.sqrt(_dot(r, r))
    V = torch.empty((m + 1, n), dtype=dtype, device=b.device)
    cycles = 0
    while not float(beta) <= target and cycles < int(maxiter):
        if not math.isfinite(float(beta)):
            return x, cycles, False
        cycles += 1
        V[0] = r / beta
        H = torch.zeros((m + 1, m), **host)   # rotated in place: R on top
        g = torch.zeros(m + 1, **host)
        g[0] = beta.cpu()
        cs, sn = [], []
        k = 0
        while k < m:
            w = matvec(data, offsets, V[k], dtype)
            w_pre = torch.sqrt(_dot(w, w))
            for _ in range(2):
                h = torch.mv(V[:k + 1], w)
                w = w - torch.mv(V[:k + 1].T, h)
                H[:k + 1, k] += h.cpu()
            w_norm = torch.sqrt(_dot(w, w))
            H[k + 1, k] = w_norm.cpu()
            for i in range(k):
                H[i, k], H[i + 1, k] = _rotate(cs[i], sn[i], H[i, k],
                                               H[i + 1, k])
            a, c = H[k, k], H[k + 1, k]
            d = torch.sqrt(a * a + c * c)
            cs.append(a / d if float(d) != 0.0 else torch.ones((), **host))
            sn.append(-c / d if float(d) != 0.0 else torch.zeros((), **host))
            H[k, k], H[k + 1, k] = _rotate(cs[k], sn[k], a, c)
            g[k], g[k + 1] = _rotate(cs[k], sn[k], g[k], g[k + 1])
            k += 1
            if float(w_norm) <= eps * float(w_pre) \
                    or abs(float(g[k])) <= target:
                break
            V[k] = w / w_norm
        y = torch.zeros(k, **host)
        for i in range(k - 1, -1, -1):
            y[i] = (g[i] - torch.dot(H[i, i + 1:k], y[i + 1:k])) / H[i, i]
        x = x + torch.mv(V[:k].T, y.to(b.device))
        r = b - matvec(data, offsets, x, dtype)
        beta = torch.sqrt(_dot(r, r))
    return x, cycles, float(beta) <= target
