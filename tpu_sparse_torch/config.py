"""Global configuration for tpu_sparse_torch.

Counterpart of ``tpu_sparse/config.py``. PyTorch has no 64-bit switch:
float64 is always available, so the x64 toggle is gone and the default
float is float64, the reference library's default
(torch_sparse_linalg.py:57-58).
"""

from __future__ import annotations

import dataclasses

import torch


def default_float() -> torch.dtype:
    """The widest real float: float64."""
    return torch.float64


def default_index() -> torch.dtype:
    return torch.int32


@dataclasses.dataclass(frozen=True)
class SolveOptions:
    """Options shared by the iterative solvers (reference keyword surface,
    torch_sparse_linalg.py:1019-1088)."""

    tol: float = 1e-5
    atol: float = 0.0
    maxiter: "int | None" = None
    restart: int = 20  # GMRES only
    solve_method: str = "batched"  # GMRES only: 'batched' | 'incremental'
