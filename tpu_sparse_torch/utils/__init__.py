"""Pytree helpers, device timing and the per-matrix operand cache."""

from tpu_sparse_torch.utils import opcache, timing, tree

__all__ = ["opcache", "timing", "tree"]
