"""Pytree helpers, residuals, timing, checkpoints and the per-matrix
operand cache."""

from tpu_sparse_torch.utils import opcache, tree
from tpu_sparse_torch.utils.tree import (tree_add, tree_axpy, tree_norm,
                                         tree_scalar_mul, tree_size, tree_sub,
                                         tree_vdot, tree_vdot_real,
                                         tree_where, tree_zeros_like)

__all__ = [
    "checkpoint", "opcache", "timing", "tree", "compute_residual",
    "relative_residual", "tree_add", "tree_axpy", "tree_norm",
    "tree_scalar_mul", "tree_size", "tree_sub", "tree_vdot",
    "tree_vdot_real", "tree_where", "tree_zeros_like",
]

from tpu_sparse_torch.utils import checkpoint, timing  # noqa: E402


def compute_residual(A, x, b):
    """r = b - A x (reference matrix_utils.py:260-279)."""
    from tpu_sparse_torch.kernels import as_matvec

    return tree_sub(b, as_matvec(A)(x))


def relative_residual(A, x, b):
    """||b - A x|| / ||b|| (reference matrix_utils.py:281-303); a zero b
    divides by 1."""
    import torch

    r = tree_norm(compute_residual(A, x, b))
    bn = tree_norm(b)
    return r / torch.where(bn > 0, bn, torch.ones_like(bn))
