"""Banded and dense direct solvers, the port of
``tpu_sparse/direct/banded.py``.

* ``thomas_solve``: tridiagonal LU (the Thomas algorithm), and
  ``banded_lu_factor`` / ``banded_lu_solve``: banded LU without pivoting
  and its two substitutions. Each is a loop of n dependent steps, so it
  runs on the host (numpy, in the operands' dtype) and returns on the
  operands' device; the router sends only CPU systems and small card
  systems here (``direct.banded_solve``).
* ``pcr_solve``: tridiagonal parallel cyclic reduction, log2(n) passes of
  vector operations; ``block_pcr_solve``: banded systems as block
  tridiagonal with block size s >= bandwidth, log2(n / s) passes of
  batched (m, s, s) solves and products. Both run as torch ops on the
  operands' device: the card's path for large banded systems.
* ``dense_solve``: ``torch.linalg.solve`` of the densified matrix, in the
  operands' dtype (the card has native float64, so the TPU's float32 LU
  with 40 float64 refinement sweeps is gone).

Every solver takes b of shape (n,) or (n, k). No pivoting in the banded
LU, Thomas and (block) PCR: they are for the diagonally dominant or SPD
systems the JAX package documents them for. Float32 products on the card
run in full float32, never TF32 (``full_fp32_matmul``).
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Tuple

import numpy as np
import torch

from tpu_sparse_torch.sparse.containers import DIA


@contextmanager
def full_fp32_matmul():
    """Float32 matmuls on the card in full float32 (no TF32) inside the
    block, whatever the caller set; the JAX package asks
    ``Precision.HIGHEST``. The flag is set and restored through the API
    the caller used: ``allow_tf32`` (also what
    ``set_float32_matmul_precision`` sets), or ``fp32_precision``, after
    which torch refuses to read ``allow_tf32``."""
    m = torch.backends.cuda.matmul
    try:
        attr, prev, off = "allow_tf32", m.allow_tf32, False
    except RuntimeError:  # the caller used the newer fp32_precision API
        attr, prev, off = "fp32_precision", m.fp32_precision, "ieee"
    setattr(m, attr, off)
    try:
        yield
    finally:
        setattr(m, attr, prev)


def _dia_band(A: DIA, w: int) -> torch.Tensor:
    """band[i, w + o] = A[i, i + o], on A's device (entries of columns
    outside the matrix kept as stored, as in JAX)."""
    n = A.shape[0]
    band = A.data.new_zeros((n, 2 * w + 1))
    for d, o in enumerate(A.offsets):
        band[:, w + o] = A.data[d, :n]
    return band


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host array; numpy has no bf16, so a bf16 tensor
    crosses as float32 (exact) and the host loops run in float32."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _back(a: np.ndarray, like: torch.Tensor,
          dtype: "torch.dtype | None" = None) -> torch.Tensor:
    """A host array on ``like``'s device, cast to ``dtype`` (a bf16 result
    comes back from the host as float32)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(like.device, dtype or t.dtype)


def _lu_dtype(dt: torch.dtype) -> torch.dtype:
    """The dtype torch's dense solves run a ``dt`` system in: float32 for
    bf16, which ``torch.linalg.solve`` does not take (on the CPU or on
    CUDA); the result is rounded back to ``dt``."""
    return torch.float32 if dt == torch.bfloat16 else dt


def _rhs_dtype(A, b: torch.Tensor) -> torch.dtype:
    return torch.promote_types(A.dtype, b.dtype)


def thomas_solve(A: DIA, b: torch.Tensor) -> torch.Tensor:
    """Tridiagonal solve by the Thomas algorithm (a forward sweep and a
    back substitution, n steps each, on the host)."""
    if A.bandwidth > 1:
        raise ValueError("thomas_solve requires a tridiagonal matrix")
    dt = _rhs_dtype(A, b)
    band = _host(_dia_band(A, 1).to(dt))
    sub, diag, sup = band[:, 0], band[:, 1], band[:, 2]
    bb = _host(b.to(dt))
    n = bb.shape[0]
    cs = np.empty(n, band.dtype)
    ds = np.empty_like(bb)
    c_prev = band.dtype.type(0)
    d_prev = np.zeros_like(bb[0])
    for i in range(n):
        denom = diag[i] - sub[i] * c_prev
        c_prev = sup[i] / denom
        d_prev = (bb[i] - sub[i] * d_prev) / denom
        cs[i], ds[i] = c_prev, d_prev
    x = np.empty_like(bb)
    x_next = np.zeros_like(bb[0])
    for i in range(n - 1, -1, -1):
        x_next = ds[i] - cs[i] * x_next
        x[i] = x_next
    return _back(x, b, dt)


def _shift(v: torch.Tensor, k: int) -> torch.Tensor:
    """w[i] = v[i + k] along dim 0, zeros outside."""
    out = torch.zeros_like(v)
    if abs(k) >= v.shape[0]:
        return out
    if k > 0:
        out[:-k] = v[k:]
    else:
        out[-k:] = v[:k]
    return out


def pcr_solve(A: DIA, b: torch.Tensor) -> torch.Tensor:
    """Tridiagonal solve by parallel cyclic reduction: ceil(log2 n)
    vectorised passes, each combining every row with its +-2^k
    neighbours, on the operands' device."""
    n = A.shape[0]
    if A.bandwidth > 1:
        raise ValueError("pcr_solve requires a tridiagonal matrix")
    dt = _rhs_dtype(A, b)
    band = _dia_band(A, 1).to(dt)
    if b.dim() == 2:
        band = band[:, :, None]
    a, d, c = band[:, 0], band[:, 1], band[:, 2]
    rhs = b.to(dt)
    one = torch.ones((), dtype=dt, device=b.device)
    for s in range(max(1, int(math.ceil(math.log2(max(n, 2)))))):
        k = 1 << s
        d_m, d_p = _shift(d, -k), _shift(d, k)
        alpha = -a / torch.where(d_m != 0, d_m, one)
        beta = -c / torch.where(d_p != 0, d_p, one)
        d = d + alpha * _shift(c, -k) + beta * _shift(a, k)
        rhs = rhs + alpha * _shift(rhs, -k) + beta * _shift(rhs, k)
        a = alpha * _shift(a, -k)
        c = beta * _shift(c, k)
    return rhs / torch.where(d != 0, d, one)


def _band_blocks(A: DIA, s: int):
    """A banded matrix as block tridiagonal with block size s >= bandwidth:
    (D, L, U, m, N) with (m, s, s) blocks, D[k] = A[ks:(k+1)s, ks:(k+1)s],
    L[k] the coupling to block k-1, U[k] to block k+1; rows n..N-1 are
    identity padding. One scatter places every diagonal's entries."""
    n = A.shape[0]
    m = (n + s - 1) // s
    N = m * s
    dev = A.data.device
    offs = torch.tensor(A.offsets, device=dev)
    rows = torch.arange(N, device=dev)
    cols = rows[None, :] + offs[:, None]                 # (ndiag, N)
    vals = A.data.new_zeros((len(A.offsets), N))
    vals[:, :n] = A.data[:, :n]
    vals = torch.where((rows < n) & (cols >= 0) & (cols < n), vals, 0)
    if 0 in A.offsets:  # identity on the padding rows
        vals[A.offsets.index(0), n:] = 1
    p = rows % s                      # row in its block
    q = p[None, :] + offs[:, None]    # column relative to the block
    which = torch.where(q >= s, 2, torch.where(q < 0, 1, 0))  # D, L, U
    blocks = A.data.new_zeros((3, m, s, s))
    blocks[which, (rows // s)[None, :].expand_as(q), p[None, :].expand_as(q),
           torch.remainder(q, s)] = vals
    return blocks[0], blocks[1], blocks[2], m, N


def block_pcr_solve(A: DIA, b: torch.Tensor,
                    block_size: "int | None" = None) -> torch.Tensor:
    """Banded solve by block parallel cyclic reduction: the matrix as
    block tridiagonal with block size s >= bandwidth (default max(w, 8)),
    ceil(log2 m) passes of batched (m, s, s) solves and products couple
    every block row with its +-2^k neighbours, on the operands' device.
    O(n s^2 log m) operations in place of the banded LU's n dependent
    steps."""
    n = A.shape[0]
    w = A.bandwidth
    if w < 1:
        raise ValueError("block_pcr_solve requires a banded matrix")
    s = int(block_size) if block_size is not None else max(w, 8)
    if s < w:
        raise ValueError("block size must cover the bandwidth")
    out = _rhs_dtype(A, b)
    dt = _lu_dtype(out)
    D, L, U, m, N = _band_blocks(A.with_data(A.data.to(dt)), s)
    kk = 1 if b.dim() == 1 else b.shape[1]
    r = b.to(dt).new_zeros((N, kk))
    r[:n] = b.to(dt).reshape(n, kk)
    r = r.reshape(m, s, kk)

    with full_fp32_matmul():
        for sidx in range(max(1, int(math.ceil(math.log2(max(m, 2)))))):
            k = 1 << sidx
            sol = torch.linalg.solve(D, torch.cat([L, U, r], dim=-1))
            DL, DU, Dr = sol[..., :s], sol[..., s:2 * s], sol[..., 2 * s:]
            DL_m, DU_m, Dr_m = _shift(DL, -k), _shift(DU, -k), _shift(Dr, -k)
            DL_p, DU_p, Dr_p = _shift(DL, k), _shift(DU, k), _shift(Dr, k)
            D = D - L @ DU_m - U @ DL_p
            r = r - L @ Dr_m - U @ Dr_p
            L = -(L @ DL_m)
            U = -(U @ DU_p)
        x = torch.linalg.solve(D, r).reshape(N, kk)[:n]
    return x.reshape(b.shape).to(out)


def banded_lu_factor(A: DIA) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """LU factors of a banded matrix without pivoting, on the host:
    (L_band, U_band, w) on A's device, with L_band[i, k-1] the multiplier
    of row i against pivot row i-k (k = 1..w) and U_band[i, j] = U[i, i+j]
    (j = 0..w). The same sliding-window elimination as JAX's scan."""
    n = A.shape[0]
    w = A.bandwidth
    band = _host(_dia_band(A, w))
    dt = band.dtype
    rows = np.concatenate([band, np.zeros((w + 1, 2 * w + 1), dt)])
    window = rows[:w + 1].copy()
    ks = np.arange(1, w + 1)
    # shifted[k-1] = the pivot row moved left by k in row (i+k)'s band
    # coordinates: the padded pivot row's entries [k, k + 2w + 1)
    padded = np.zeros(3 * w + 1, dt)
    shifted = np.lib.stride_tricks.sliding_window_view(
        padded, 2 * w + 1)[1:w + 1]
    Ls = np.zeros((n, w), dt)
    Us = np.zeros((n, w + 1), dt)
    one = dt.type(1)
    for i in range(n):
        pivot_row = window[0]
        pivot = pivot_row[w]
        mults = window[ks, w - ks] / (pivot if pivot != 0 else one)
        padded[:2 * w + 1] = pivot_row
        Ls[i] = mults
        Us[i] = pivot_row[w:]
        window[:-1] = window[1:] - mults[:, None] * shifted
        window[-1] = rows[i + w + 1]
    # Ls[i, k-1] eliminates row i+k against pivot i; L_band[i, k-1] is the
    # multiplier of row i against pivot i-k
    L_rows = np.zeros((n, w), dt)
    for k in range(1, w + 1):
        L_rows[k:, k - 1] = Ls[:n - k, k - 1]
    return _back(L_rows, A.data, A.data.dtype), \
        _back(Us, A.data, A.data.dtype), w


def banded_lu_solve(A: DIA, b: torch.Tensor) -> torch.Tensor:
    """Banded A x = b by ``banded_lu_factor`` and a forward and a back
    substitution, n steps each, on the host."""
    L_rows, U_rows, w = banded_lu_factor(A)
    dt = _rhs_dtype(A, b)
    L, U = _host(L_rows.to(dt)), _host(U_rows.to(dt))
    bb = _host(b.to(dt))
    n = bb.shape[0]
    tail = bb.shape[1:]
    # y[i] = b[i] - sum_k L[i, k-1] y[i-k]; ypad[w + i] = y[i]
    ypad = np.zeros((n + w,) + tail, bb.dtype)
    for i in range(n):
        ypad[w + i] = bb[i] - L[i] @ ypad[i:i + w][::-1]
    # x[i] = (y[i] - sum_j U[i, j] x[i+j]) / U[i, 0]; xpad[i] = x[i]
    xpad = np.zeros((n + w,) + tail, bb.dtype)
    for i in range(n - 1, -1, -1):
        xpad[i] = (ypad[w + i] - U[i, 1:] @ xpad[i + 1:i + 1 + w]) / U[i, 0]
    return _back(xpad[:n], b, dt)


def dense_solve(A, b: torch.Tensor) -> torch.Tensor:
    """Dense LU solve (``torch.linalg.solve``, partial pivoting) of a
    container or dense matrix, in the common dtype of A and b."""
    Ad = A.todense() if hasattr(A, "todense") else torch.as_tensor(A)
    out = torch.promote_types(Ad.dtype, b.dtype)
    dt = _lu_dtype(out)
    return torch.linalg.solve(Ad.to(dt), b.to(dt)).to(out)
