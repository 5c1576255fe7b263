"""Pytree vector-space helpers for the Krylov solvers.

Counterpart of ``tpu_sparse/utils/tree.py``. Operands are tensors or
nested tuples/lists/dicts of tensors, traversed with
``torch.utils._pytree``. JAX's ``tree_util.Partial`` (a partial that is a
pytree, for ``jit``) has no counterpart: nothing is traced here, and
``functools.partial`` serves.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

tree_map = pytree.tree_map
tree_leaves = pytree.tree_leaves
tree_flatten = pytree.tree_flatten
tree_unflatten = pytree.tree_unflatten
tree_structure = pytree.tree_structure


def tree_reduce(fn: Callable, tree: Any, *initializer) -> Any:
    """``functools.reduce`` of ``fn`` over the leaves of ``tree``."""
    return functools.reduce(fn, tree_leaves(tree), *initializer)


def _map2(fn, a: Any, b: Any) -> Any:
    leaves_a, spec = pytree.tree_flatten(a)
    leaves_b = pytree.tree_leaves(b)
    return pytree.tree_unflatten([fn(x, y) for x, y in zip(leaves_a, leaves_b)],
                                 spec)


def tree_vdot(a: Any, b: Any) -> torch.Tensor:
    """<a, b> summed over every leaf (conjugate-linear in ``a``)."""
    return sum(torch.vdot(la.reshape(-1), lb.reshape(-1))
               for la, lb in zip(tree_leaves(a), tree_leaves(b)))


def tree_vdot_real(a: Any, b: Any) -> torch.Tensor:
    """Real part of <a, b>."""
    out = tree_vdot(a, b)
    return out.real if out.is_complex() else out


def tree_norm(x: Any) -> torch.Tensor:
    """Global 2-norm over all leaves."""
    return torch.sqrt(tree_vdot_real(x, x))


def tree_add(a: Any, b: Any) -> Any:
    return _map2(torch.add, a, b)


def tree_sub(a: Any, b: Any) -> Any:
    return _map2(torch.sub, a, b)


def tree_scalar_mul(s, x: Any) -> Any:
    return tree_map(lambda leaf: s * leaf, x)


def tree_axpy(a, x: Any, y: Any) -> Any:
    """a*x + y, leafwise."""
    return _map2(lambda xl, yl: a * xl + yl, x, y)


def tree_zeros_like(x: Any) -> Any:
    return tree_map(torch.zeros_like, x)


def tree_where(pred: torch.Tensor, a: Any, b: Any) -> Any:
    return _map2(lambda al, bl: torch.where(pred, al, bl), a, b)


def tree_size(x: Any) -> int:
    """Total number of elements across all leaves."""
    return sum(leaf.numel() for leaf in tree_leaves(x))
