"""Polynomial preconditioners: the port of ``tpu_sparse/precond/poly.py``.

* ``chebyshev_preconditioner``: a degree-k Chebyshev polynomial in the
  L1-scaled operator (the AMG Chebyshev smoother's recurrence from x0 = 0):
  SpMVs and axpys, no inner products.
* ``neumann_preconditioner``: the truncated Neumann series
  sum_{k < terms} (I - D^-1 A)^k D^-1.

Each is an object with ``__call__`` (a vector), ``matmat`` (an (n, k)
block: one SpMM per product) and ``.to(device or dtype)``.

``ilu0_factor`` and ``ilu0_preconditioner`` (JAX's ILU(0) of a DIA
matrix) live in ``precond/ilu.py``: a host factor and level-scheduled
substitutions on the card. They are re-exported here, where the JAX
package has them.
"""

from __future__ import annotations

import torch

from tpu_sparse_torch.precond.amg import (_chebyshev_smooth, _op_to,
                                          _product, _scale)
from tpu_sparse_torch.precond.ilu import (ILU0Preconditioner,  # noqa: F401
                                          ilu0_factor, ilu0_preconditioner)
from tpu_sparse_torch.precond.jacobi import diagonal, l1_jacobi_diag


class ChebyshevPreconditioner:
    """M v = p(D^-1 A) D^-1 v, the Chebyshev polynomial of degree
    ``degree`` on the interval [1 / lam_ratio, 1] of the L1-scaled
    spectrum."""

    def __init__(self, A, dinv: torch.Tensor, degree: int,
                 lam_ratio: float):
        self.A = A
        self.dinv = dinv
        self.degree = int(degree)
        self.lam_ratio = float(lam_ratio)

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return _chebyshev_smooth(self.A, self.dinv, torch.zeros_like(v), v,
                                 degree=self.degree, lam_max=1.0,
                                 lam_ratio=self.lam_ratio)

    matmat = __call__

    def to(self, target) -> "ChebyshevPreconditioner":
        return ChebyshevPreconditioner(_op_to(self.A, target),
                                       self.dinv.to(target), self.degree,
                                       self.lam_ratio)


class NeumannPreconditioner:
    """M v = sum_{k < terms} (I - D^-1 A)^k D^-1 v."""

    def __init__(self, A, dinv: torch.Tensor, terms: int):
        self.A = A
        self.dinv = dinv
        self.terms = int(terms)

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        x = _scale(self.dinv, v)
        acc = x
        for _ in range(self.terms - 1):
            x = x - _scale(self.dinv, _product(self.A, x))
            acc = acc + x
        return acc

    matmat = __call__

    def to(self, target) -> "NeumannPreconditioner":
        return NeumannPreconditioner(_op_to(self.A, target),
                                     self.dinv.to(target), self.terms)


def chebyshev_preconditioner(A, degree: int = 4,
                             lam_ratio: float = 30.0
                             ) -> ChebyshevPreconditioner:
    """M ~ A^-1 as a degree-``degree`` Chebyshev polynomial in A (SPD)."""
    return ChebyshevPreconditioner(A, 1.0 / l1_jacobi_diag(A), degree,
                                   lam_ratio)


def neumann_preconditioner(A, terms: int = 3) -> NeumannPreconditioner:
    """M = sum_{k < terms} (I - D^-1 A)^k D^-1 (truncated Neumann series);
    zero diagonal entries scale by 1."""
    d = diagonal(A)
    nz = d != 0
    dinv = torch.where(nz, 1.0 / torch.where(nz, d, torch.ones_like(d)),
                       torch.ones_like(d))
    return NeumannPreconditioner(A, dinv, terms)

