"""Deterministic test-matrix generators.

Counterpart of ``tpu_sparse/sparse/generators.py``: the same numpy
construction, offsets and default dtypes, so both packages give byte-equal
arrays. Matrices come back on ``device`` (DIA, except the dense
``random_spd_dense`` and the ``random_csr`` CSR): the card unless the
caller asks for ``device="cpu"`` (with no card the default fails with
torch's own error).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_sparse_torch.sparse.containers import COO, CSR, DIA
from tpu_sparse_torch.sparse.convert import (coo_to_csr, dense_to_csr,
                                             dia_from_offsets)


def tridiagonal(n: int, main: float = 2.0, off: float = -1.0,
                dtype=np.float64, device="cuda") -> DIA:
    """Tridiagonal Toeplitz matrix (reference: matrix_utils.py:143-190)."""
    data = np.zeros((3, n), dtype=dtype)
    data[0, :] = off  # offset -1: A[i, i-1], valid for i >= 1
    data[1, :] = main
    data[2, :] = off  # offset +1: A[i, i+1], valid for i <= n-2
    data[0, 0] = 0.0
    data[2, n - 1] = 0.0
    return dia_from_offsets((-1, 0, 1), data, (n, n), device)


def poisson2d(nx: int, ny: "int | None" = None, dtype=np.float64,
              device="cuda") -> DIA:
    """2-D 5-point Poisson (Dirichlet), row-major grid ordering
    (reference: matrix_utils.py:193-257)."""
    if ny is None:
        ny = nx
    n = nx * ny
    data = np.zeros((5, n), dtype=dtype)
    ix = np.arange(n) % nx
    data[2, :] = 4.0
    data[1, :] = np.where(ix > 0, -1.0, 0.0)          # west
    data[3, :] = np.where(ix < nx - 1, -1.0, 0.0)     # east
    data[0, :] = -1.0                                 # south
    data[0, :nx] = 0.0
    data[4, :] = -1.0                                 # north
    data[4, n - nx:] = 0.0
    return dia_from_offsets((-nx, -1, 0, 1, nx), data, (n, n), device)


def poisson3d_27pt(nx: int, ny: "int | None" = None, nz: "int | None" = None,
                   dtype=np.float32, device="cuda") -> DIA:
    """3-D 27-point Poisson-like stencil (BASELINE.json configs[4]):
    center 26, all 26 neighbors -1 (zeroed outside the grid), offsets
    sorted."""
    if ny is None:
        ny = nx
    if nz is None:
        nz = nx
    n = nx * ny * nz
    i = np.arange(n)
    ix = i % nx
    iy = (i // nx) % ny
    iz = i // (nx * ny)
    offsets, masks = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dx == 0 and dy == 0 and dz == 0:
                    continue
                offsets.append(dx + nx * dy + nx * ny * dz)
                masks.append((ix + dx >= 0) & (ix + dx < nx)
                             & (iy + dy >= 0) & (iy + dy < ny)
                             & (iz + dz >= 0) & (iz + dz < nz))
    offsets.append(0)
    masks.append(np.ones(n, dtype=bool))
    order = np.argsort(offsets)
    data = np.zeros((len(offsets), n), dtype=dtype)
    out_offsets = []
    for d, k in enumerate(order):
        o = offsets[k]
        out_offsets.append(o)
        if o == 0:
            data[d, :] = 26.0
        else:
            data[d, :] = np.where(masks[k], -1.0, 0.0)
    return dia_from_offsets(out_offsets, data, (n, n), device)


def convection_diffusion(n: int, beta: float = 0.5, dtype=np.float64,
                         device="cuda") -> DIA:
    """Nonsymmetric diagonally dominant tridiagonal (upwind)
    convection-diffusion operator."""
    data = np.zeros((3, n), dtype=dtype)
    data[0, :] = -1.0 - beta
    data[1, :] = 2.0 + 2.0 * beta + 1.0
    data[2, :] = -1.0 + beta
    data[0, 0] = 0.0
    data[2, n - 1] = 0.0
    return dia_from_offsets((-1, 0, 1), data, (n, n), device)


def poisson2d_anisotropic(nx: int, eps: float = 100.0, dtype=np.float64,
                          device="cuda") -> DIA:
    """2-D 5-point Poisson with anisotropic coefficients: -u_xx - eps u_yy."""
    n = nx * nx
    i = np.arange(n)
    ix = i % nx
    iy = i // nx
    data = np.zeros((5, n), dtype=dtype)
    data[0] = np.where(iy > 0, -eps, 0.0)
    data[1] = np.where(ix > 0, -1.0, 0.0)
    data[2] = 2.0 + 2.0 * eps
    data[3] = np.where(ix < nx - 1, -1.0, 0.0)
    data[4] = np.where(iy < nx - 1, -eps, 0.0)
    return dia_from_offsets((-nx, -1, 0, 1, nx), data, (n, n), device)


def convection_diffusion_3d_27pt(nx: int, beta: float = 0.3,
                                 dtype=np.float32, device="cuda") -> DIA:
    """Nonsymmetric 3-D 27-point convection-diffusion: the 27-point Poisson
    stencil with upwind-skewed +-x couplings (-(1+beta) upstream, -(1-beta)
    downstream); row sums stay diagonally dominant, so BiCGStab and GMRES
    converge unpreconditioned (the at-scale nonsymmetric system)."""
    A = poisson3d_27pt(nx, dtype=dtype, device="cpu")
    data = A.data.numpy().copy()
    offs = list(A.offsets)
    data[offs.index(-1)] *= dtype(1.0 + beta)
    data[offs.index(1)] *= dtype(1.0 - beta)
    return dia_from_offsets(tuple(offs), data, A.shape, device)


def random_spd_dense(n: int, seed: int = 0, dtype=np.float64,
                     device="cuda") -> torch.Tensor:
    """Dense SPD matrix B B^T + n I (reference test_gpu_validation.py:72-76)
    from ``default_rng(seed)``, as a tensor on ``device``."""
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, n)).astype(dtype)
    return torch.from_numpy(B @ B.T + n * np.eye(n, dtype=dtype)).to(device)


def random_csr(n: int, m: int, density: float = 0.01, seed: int = 0,
               dtype=np.float64, dominant: bool = True,
               device="cuda") -> CSR:
    """Random sparse CSR from ``default_rng(seed)`` (duplicates summed),
    made diagonally dominant when square and ``dominant``; on
    ``device``."""
    rng = np.random.default_rng(seed)
    nnz = max(1, int(n * m * density))
    row = rng.integers(0, n, nnz).astype(np.int32)
    col = rng.integers(0, m, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(dtype)
    A = coo_to_csr(COO(torch.from_numpy(vals), torch.from_numpy(row),
                       torch.from_numpy(col), (n, m)))
    if dominant and n == m:
        dense = A.todense().numpy()
        dense[np.arange(n), np.arange(n)] += np.abs(dense).sum(axis=1) + 1.0
        return dense_to_csr(torch.from_numpy(dense).to(device))
    return A.to(device)
