"""Pytree helpers and device timing."""

from tpu_sparse_torch.utils import timing, tree

__all__ = ["timing", "tree"]
